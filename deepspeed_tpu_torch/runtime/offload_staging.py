"""Host-ward half of the offload staging pipeline (counterpart of
`deepspeed_tpu/runtime/offload_staging.py`).

The device-ward half is `runtime/param_swap.py`'s `LayerStreamer`. This
module carries gradients the other way, to the host optimizer of the
ZeRO-Offload / Infinity tier.

`HostwardPipe.submit()` lands a card tensor in a fresh pinned buffer on a
side stream: the side stream waits for the compute stream (the producing
backward), the copy is non-blocking and an event is recorded after it. The
queue keeps the source tensors until that event has passed, so the
caching allocator does not hand their blocks to the next layer's backward
before the copy has read them (and counts them as allocated exactly as
long). Up to `depth` trees are in flight; the oldest past the window is
landed: the host waits on its event (measured into
`offload/hostward_wait_ms`), drops the sources and gets the pinned
buffer, which it owns from then on (a landing buffer is never reused
while the host step reads it).
On a CPU tensor (the caller's choice of device) the landing is a copy.
"""

import collections
import time

import torch

from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_unflatten


def _leaf_bytes(leaves):
    return sum(t.numel() * t.element_size() for t in leaves)


class HostwardPipe:
    """Bounded asynchronous device-to-host landing queue.

    `submit(key, value)` starts the copies of every tensor of `value` (a
    tensor or a tree of tensors) and returns the entries that fell out of
    the `depth` window, each landed on the host, oldest first. `depth` 0 is
    the blocking path (submit lands its own entry at once)."""

    def __init__(self, depth=1, telemetry=None, clock=None):
        self.depth = max(0, int(depth))
        self.telemetry = telemetry
        self._clock = clock if clock is not None else time.perf_counter
        # (key, host leaves, the source tree, event): an entry keeps its
        # card tensors alive until it lands
        self._q = collections.deque()
        self._stream = None
        self.bytes_in_flight = 0
        self.bytes_total = 0
        self.landings = 0
        self.wait_ms_total = 0.0

    def __len__(self):
        return len(self._q)

    def _side_stream(self, device):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def submit(self, key, value):
        leaves = tree_leaves(value)
        event = None
        if leaves and leaves[0].is_cuda:
            compute = torch.cuda.current_stream(leaves[0].device)
            side = self._side_stream(leaves[0].device)
            side.wait_stream(compute)
            with torch.cuda.stream(side):
                host = []
                for t in leaves:
                    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    h.copy_(t, non_blocking=True)
                    host.append(h)
                event = torch.cuda.Event()
                event.record(side)
        else:
            host = [t.detach().clone() for t in leaves]
        self._q.append((key, host, value, event))
        self.bytes_in_flight += _leaf_bytes(host)
        out = []
        while len(self._q) > self.depth:
            out.append(self._land(*self._q.popleft()))
        return out

    def _land(self, key, host, tree, event):
        t0 = self._clock()
        if event is not None:
            event.synchronize()
        wait_ms = (self._clock() - t0) * 1e3
        nbytes = _leaf_bytes(host)
        self.bytes_in_flight = max(0, self.bytes_in_flight - nbytes)
        self.bytes_total += nbytes
        self.landings += 1
        self.wait_ms_total += wait_ms
        tel = self.telemetry
        if tel is not None and getattr(tel, "enabled", False):
            tel.observe("offload/hostward_wait_ms", wait_ms)
            tel.inc("offload/bytes_to_host", nbytes)
        if isinstance(tree, torch.Tensor):
            return key, host[0]
        return key, tree_unflatten(tree, host)

    def drain(self):
        """Land every remaining entry, oldest first."""
        out = []
        while self._q:
            out.append(self._land(*self._q.popleft()))
        return out

    def stats(self):
        return {"landings": self.landings,
                "bytes_total": self.bytes_total,
                "wait_ms_total": round(self.wait_ms_total, 3),
                "in_flight": len(self._q)}
