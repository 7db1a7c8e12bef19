"""Parameter spill tier — ZeRO-Infinity params and ZeRO-Inference
(counterpart of `deepspeed_tpu/runtime/param_swap.py`).

Model weights live in host RAM or on NVMe and stream through device memory
layer by layer, so the model's size is bounded by the host, not by HBM.

  * `LayerParamStore` owns the per-layer host copies: the "cpu" tier keeps
    them as CPU tensors (pinned when the engine's device is CUDA), the
    "nvme" tier on disk through the AIO library, read through a ring of
    staging slots, each with its own AIO handle (waiting for one layer's
    read never waits for the read-ahead queued on the other slots) and its
    own reusable 4 KiB-aligned buffers.
  * `LayerStreamer` uploads ahead of compute: while layer i computes,
    layers i+1..i+lookahead are already being copied on a dedicated copy
    stream and the NVMe read of the next one is queued. The device holds
    at most `lookahead + 1` layers of weights besides the resident leaves.

Three orderings keep the copy stream from racing the compute stream (each
fails silently, as wrong numbers, if it is missed):
  * the device copies live in a ring of `lookahead + 1` buffer sets the
    streamer owns, never handed back to the caching allocator: the compute
    stream waits on an upload's event before it reads the layer, and an
    evicted layer's buffers get an event on the compute stream, which the
    copy stream waits on before it writes the next layer into them. A
    fresh block per upload, `record_stream`'d and freed on eviction, is
    reusable only once the card has run past its last reader; a host
    running a walk ahead of the card would have the allocator reserve new
    blocks meanwhile, up to a walk's worth;
  * an NVMe staging slot records the event of the copy that reads its
    buffers, and is not refilled by an AIO read before that event;
  * `put` on the cpu tier replaces a layer's tensors rather than writing
    into them (a pinned block in flight is held by the host allocator
    until its copy ends); on the nvme tier it writes through a separate
    AIO handle from the caller's tensors, never from a slot's buffers.

The streamer measures what the JAX package measures: host time spent
making a layer live (`stall_ms_total`, `offload/stage_wait_ms`). With
asynchronous copies a late cpu-tier upload shows as the device waiting,
not the host; the host figure still catches NVMe reads and slot waits,
and the device's busy share is read from the profiler beside it.
"""

import pathlib
import time

import torch

from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_unflatten


def _host_copy(t, dtype=None, pin=False):
    """A contiguous CPU copy of `t` (cast to `dtype`), pinned if `pin`."""
    dtype = t.dtype if dtype is None else dtype
    out = torch.empty(t.shape, dtype=dtype, pin_memory=bool(pin))
    out.copy_(t)
    return out


class _StageSlot:
    """One ring slot of the NVMe staging pool: its own AIO handle, the
    layer it holds, its aligned buffers and the event of the last copy
    that reads them."""

    __slots__ = ("swapper", "layer", "bufs", "inflight", "event")

    def __init__(self, swap_folder, threads):
        from deepspeed_tpu_torch.runtime.swap_tensor import AsyncTensorSwapper
        self.swapper = AsyncTensorSwapper(swap_folder, num_threads=threads)
        self.layer = None
        self.bufs = None
        self.inflight = False
        self.event = None

    def wait(self):
        if self.inflight:
            self.swapper.wait()
            self.inflight = False

    def release(self):
        self.swapper.release()


class LayerParamStore:
    """Host / NVMe store of L structurally identical per-layer trees.

    `stacked` is a tree whose leaves carry a leading layer dimension L (the
    zoo's `params["blocks"]`). `pin` pins the host copies and the staging
    buffers (a CUDA engine asks for it). `max_write_bytes` bounds the
    asynchronous write-back queue of `put(blocking=False)`: past it the put
    flushes. None = 8 layers' worth; 0 = unbounded (`flush_writes` a
    step)."""

    def __init__(self, stacked, device="cpu", swap_folder=None, staging=3,
                 aio_threads=4, dtype=None, max_write_bytes=None, pin=False):
        self.tree = stacked
        leaves = tree_leaves(stacked)
        self.num_layers = int(leaves[0].shape[0])
        if any(int(leaf.shape[0]) != self.num_layers for leaf in leaves):
            raise ValueError("every stacked leaf must share the leading "
                             "layer dimension")
        self.device = device
        self.pin = bool(pin)
        self.telemetry = None
        self.leaf_meta = [(tuple(leaf.shape[1:]),
                           leaf.dtype if dtype is None else dtype)
                          for leaf in leaves]
        self.layer_bytes = sum(
            int(torch.Size(s).numel()) * torch.empty((), dtype=d).itemsize
            for s, d in self.leaf_meta)
        self.pending_write_bytes = 0
        self.inflight_read_bytes = 0
        self.write_flushes = 0
        if max_write_bytes is None:
            max_write_bytes = 8 * self.layer_bytes
        self.max_write_bytes = int(max_write_bytes)
        self._wswapper = None

        def layer(i):
            return [_host_copy(leaf[i], d, self.pin)
                    for leaf, (_, d) in zip(leaves, self.leaf_meta)]

        if device == "cpu":
            self._layers = [layer(i) for i in range(self.num_layers)]
            self._ring = None
        elif device == "nvme":
            from deepspeed_tpu_torch.runtime.swap_tensor import \
                AsyncTensorSwapper
            if swap_folder is None:
                raise ValueError("nvme offload needs a swap_folder "
                                 "(offload_param.nvme_path)")
            self._swap_folder = swap_folder
            spill = AsyncTensorSwapper(swap_folder, num_threads=aio_threads)
            for i in range(self.num_layers):
                # one layer's host copies at a time, alive until its wait
                for j, (leaf, (_, d)) in enumerate(zip(leaves,
                                                       self.leaf_meta)):
                    spill.swap_out(f"layer{i}_leaf{j}", _host_copy(leaf[i], d))
                spill.wait()
            spill.release()
            self._layers = None
            n_slots = max(2, int(staging))
            per_slot = max(1, aio_threads // n_slots)
            self._ring = [_StageSlot(swap_folder, per_slot)
                          for _ in range(n_slots)]
            logger.info(f"LayerParamStore: {self.num_layers} layers x "
                        f"{self.layer_bytes / 1e6:.1f} MB spilled to "
                        f"{pathlib.Path(swap_folder)} ({n_slots} staging "
                        f"slots)")
        else:
            raise ValueError(f"unknown spill device {device!r} (cpu|nvme)")

    @property
    def host_bytes(self):
        return self.layer_bytes * self.num_layers

    @property
    def inflight_bytes(self):
        return self.inflight_read_bytes + self.pending_write_bytes

    # ---- nvme staging ----

    def _slot_for(self, i):
        return self._ring[i % len(self._ring)]

    def _settle(self, slot):
        if slot.inflight:
            slot.wait()
            self.inflight_read_bytes = max(
                0, self.inflight_read_bytes - self.layer_bytes)

    def prefetch(self, i):
        """Queue the NVMe read of layer i into its slot (a no-op on the cpu
        tier or when the slot holds it). Waits only for that slot: its
        previous read, and the copy reading its buffers."""
        if self._ring is None or not 0 <= i < self.num_layers:
            return
        slot = self._slot_for(i)
        if slot.layer == i:
            return
        self._settle(slot)
        if slot.event is not None:
            slot.event.synchronize()
            slot.event = None
        if slot.bufs is None:
            from deepspeed_tpu_torch.runtime.swap_tensor import aligned_empty
            slot.bufs = [aligned_empty(s, d, pin=self.pin)
                         for s, d in self.leaf_meta]
        for j, buf in enumerate(slot.bufs):
            slot.swapper.swap_in(f"layer{i}_leaf{j}", buf.shape, buf.dtype,
                                 out=buf)
        slot.layer = i
        slot.inflight = True
        self.inflight_read_bytes += self.layer_bytes

    def get(self, i):
        """Host leaf list of layer i; on the nvme tier it blocks on layer
        i's own slot only."""
        if self._layers is not None:
            return self._layers[i]
        slot = self._slot_for(i)
        if slot.layer != i:
            self.prefetch(i)
        self._settle(slot)
        return slot.bufs

    def mark_read(self, i, event):
        """Record `event` as the end of the copy that reads layer i's host
        buffers: its slot is not refilled before it."""
        if self._ring is not None:
            slot = self._slot_for(i)
            if slot.layer == i:
                slot.event = event

    def get_tree(self, i):
        return tree_unflatten(self.tree, self.get(i))

    def put(self, i, leaves, blocking=False):
        """Write layer i's updated host leaves back (the training swap-out).
        The cpu tier keeps the given tensors; the nvme tier writes them
        through a separate AIO handle (read-ahead stays in flight) as one
        batch against `max_write_bytes`. Call `flush_writes()` before the
        next read of this layer."""
        if self._layers is not None:
            self._layers[i] = list(leaves)
            return
        slot = self._slot_for(i)
        if slot.layer == i:
            self._settle(slot)
            slot.layer = None               # the staged copy is stale
        if self._wswapper is None:
            from deepspeed_tpu_torch.runtime.swap_tensor import \
                AsyncTensorSwapper
            self._wswapper = AsyncTensorSwapper(self._swap_folder)
        for j, t in enumerate(leaves):
            self._wswapper.swap_out(f"layer{i}_leaf{j}", t)
        self.pending_write_bytes += self.layer_bytes
        if blocking or (self.max_write_bytes and
                        self.pending_write_bytes > self.max_write_bytes):
            self.flush_writes()

    def flush_writes(self):
        """Barrier on outstanding put() writes (reads are unaffected)."""
        if self._wswapper is not None and self.pending_write_bytes:
            t0 = time.perf_counter()
            self._wswapper.wait()
            self.pending_write_bytes = 0
            self.write_flushes += 1
            tel = self.telemetry
            if tel is not None and getattr(tel, "enabled", False):
                tel.observe("offload/write_flush_ms",
                            (time.perf_counter() - t0) * 1e3)

    def release(self):
        if self._ring is not None:
            for slot in self._ring:
                slot.release()
        if self._wswapper is not None:
            self._wswapper.release()


class LayerStreamer:
    """Look-ahead staging of `LayerParamStore` layers on `device`.

    `layer(i)` returns layer i's tensors on the device, having started the
    uploads of layers i+1..i+lookahead and queued the NVMe read one deeper.
    `lookahead=0` is the blocking baseline (every acquisition uploads).
    `cyclic=True` pins the look-ahead to a repeating walk (decode: L-1
    wraps to 0). `direction=-1` walks backward (the Infinity backward).

    The returned tensors are views of the streamer's ring of `lookahead +
    1` buffer sets: they hold layer i until it leaves the window, so a
    caller uses them before its next acquisitions, as every walk does."""

    def __init__(self, store: LayerParamStore, lookahead=1, cyclic=False,
                 telemetry=None, clock=None, device="cpu"):
        self.store = store
        self.lookahead = max(0, int(lookahead))
        self.cyclic = bool(cyclic)
        self.telemetry = telemetry
        self.device = torch.device(device)
        self._clock = clock if clock is not None else time.perf_counter
        self._copy_stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self._ring = None        # [lookahead + 1] of (leaves, free event)
        self._live = {}          # layer idx -> (ring index, upload event)
        self.peak_live_layers = 0
        self.uploads = 0
        self.acquires = 0
        self.hits = 0
        self.stall_ms_total = 0.0

    @property
    def device_bytes(self):
        """Bytes of the ring: the streamed weights the device holds."""
        return (self.lookahead + 1) * self.store.layer_bytes \
            if self._ring is not None else 0

    def _wrap(self, i):
        return i % self.store.num_layers if self.cyclic else i

    def _evict(self, j):
        """Layer j leaves the window: its buffers are free once the work
        enqueued on the compute stream so far (its readers) is done."""
        k, _ = self._live.pop(j)
        if self._copy_stream is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self._ring[k] = (self._ring[k][0], event)

    def _upload(self, i):
        if i in self._live or not 0 <= i < self.store.num_layers:
            return
        if self._ring is None:
            self._ring = [([torch.empty(s, dtype=d, device=self.device)
                            for s, d in self.store.leaf_meta], None)
                          for _ in range(self.lookahead + 1)]
        held = {k for k, _ in self._live.values()}
        k = next(k for k in range(len(self._ring)) if k not in held)
        dev, freed = self._ring[k]
        host = self.store.get(i)
        event = None
        if self._copy_stream is None:
            for d, h in zip(dev, host):
                d.copy_(h)
        else:
            with torch.cuda.stream(self._copy_stream):
                if freed is not None:
                    self._copy_stream.wait_event(freed)
                for d, h in zip(dev, host):
                    d.copy_(h, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._copy_stream)
            self.store.mark_read(i, event)
        self._live[i] = (k, event)
        self.uploads += 1
        self.peak_live_layers = max(self.peak_live_layers, len(self._live))

    def layer(self, i, direction=1):
        """Layer i's tree on the device (see the class docstring). The
        stall covers only making layer i itself live."""
        self.acquires += 1
        step = 1 if direction >= 0 else -1
        window = {self._wrap(i + d * step) for d in range(self.lookahead + 1)}
        for j in list(self._live):
            if j not in window:
                self._evict(j)
        if i in self._live:
            self.hits += 1
            wait_ms = 0.0
        else:
            t0 = self._clock()
            self._upload(i)
            wait_ms = (self._clock() - t0) * 1e3
            self.stall_ms_total += wait_ms
        k, event = self._live[i]
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)
        for d in range(1, self.lookahead + 1):
            self._upload(self._wrap(i + d * step))
        self.store.prefetch(self._wrap(i + (self.lookahead + 1) * step))
        tel = self.telemetry
        if tel is not None and getattr(tel, "enabled", False):
            tel.observe("offload/stage_wait_ms", wait_ms)
            tel.set_gauge("offload/staging_occupancy", len(self._live))
            tel.set_gauge("offload/inflight_bytes", self.store.inflight_bytes)
        return tree_unflatten(self.store.tree, self._ring[k][0])

    def stats(self):
        return {"acquires": self.acquires, "hits": self.hits,
                "uploads": self.uploads,
                "hit_rate": self.hits / max(1, self.acquires),
                "stall_ms_total": round(self.stall_ms_total, 3),
                "peak_live_layers": self.peak_live_layers}

    def reset(self):
        """Forget the device copies (the store's layers changed); the ring
        stays, each set free after the compute enqueued so far."""
        for j in list(self._live):
            self._evict(j)

    def release(self):
        """Drop the ring, once the compute stream is ordered after every
        copy into it (the allocator may hand its blocks to compute next)."""
        self.reset()
        if self._copy_stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(
                self._copy_stream)
        self._ring = None
