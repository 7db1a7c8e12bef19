"""ZeRO-Infinity training: train models whose parameters exceed HBM
(counterpart of `deepspeed_tpu/runtime/infinity.py`).

  * The compute-dtype weights live in a `LayerParamStore` (host or NVMe);
    `LayerStreamer` uploads them ahead of use through the forward and
    again, reversed, through the backward.
  * The device holds the resident leaves (embeddings, norms, head),
    `lookahead + 1` layers and the layer-boundary activations, not the
    model.
  * The forward runs without autograd and keeps each layer's input. The
    backward recomputes one layer at a time under autograd and takes
    `torch.autograd.grad` of it against the incoming cotangent: the JAX
    package's `block_vjp`, full remat by layer.
  * Each layer's gradient leaves as one fp32 flat through a
    `HostwardPipe` (pinned landing, `landing_depth` in flight) and steps a
    per-layer `HostOffloadOptimizer` (the C++ Adam of `csrc/cpu_optim`)
    whose fp32 master and moments never touch the device. The updated
    layer is written back to the store. Layer i-1's backward is enqueued
    before layer i lands and steps, so the host step runs while the device
    computes.

Gradient clipping and fp16 loss scaling need a whole-model property of
the gradients before any layer may step, so they take the two-phase
schedule (accumulate every layer on the host, then step), as in the JAX
package. The loss scaler is `runtime/precision.py`'s, driven on host
scalars.

Checkpoints (`save_checkpoint` / `load_checkpoint`) go through
`checkpoint/saver.py`'s commit protocol under the config's `checkpoint`
block (`initialize` passes it; an engine built without one takes the
numpy engine, as the JAX package's tier falls back to): the state is the
host masters, moments and loss-scale bookkeeping; the 16-bit store is
rebuilt from the masters on load. `memory_plan()` prices the live tier
(`telemetry/memscope.py`).

The engine runs on `cuda` unless the caller passes `device="cpu"`.
"""

import types

import numpy as np
import torch

from deepspeed_tpu_torch.inference.engine import params_to, resolve_device
from deepspeed_tpu_torch.runtime.cpu_optimizer import HostOffloadOptimizer
from deepspeed_tpu_torch.runtime.offload_staging import HostwardPipe
from deepspeed_tpu_torch.runtime.param_swap import (LayerParamStore,
                                                    LayerStreamer,
                                                    _host_copy)
from deepspeed_tpu_torch.runtime.precision import LossScaler
from deepspeed_tpu_torch.telemetry import Telemetry
from deepspeed_tpu_torch.utils.logging import log_dist
from deepspeed_tpu_torch.utils.tree import (tree_cast, tree_leaves,
                                            tree_map, tree_unflatten)


def _grad_leaves(tree):
    """Leaves of `tree` as fresh autograd leaves (the same storage)."""
    return [t.detach().requires_grad_() for t in tree_leaves(tree)]


def _flat(grads):
    return torch.cat([g.reshape(-1).float() for g in grads])


def _split(flat, shapes):
    out, off = [], 0
    for shape in shapes:
        n = int(torch.Size(shape).numel())
        out.append(flat[off:off + n].view(shape))
        off += n
    return out


class InfinityEngine:
    """Layer-streaming trainer over a LayeredModelSpec with train fns.

    `offload_device`: "cpu" | "nvme" for the compute-dtype weights;
    `optimizer_nvme_path`: the per-layer moments on NVMe too;
    `lookahead`: upload depth (0 = the blocking baseline);
    `landing_depth`: layers' gradient flats in device-to-host flight."""

    def __init__(self, spec, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, dtype=torch.bfloat16, offload_device="cpu",
                 nvme_path=None, optimizer_nvme_path=None, lookahead=1,
                 optimizer="adam", adamw_mode=True, lr_schedule=None,
                 micro_batch_size=None, gradient_accumulation_steps=1,
                 gradient_clipping=0.0, training_data=None, collate_fn=None,
                 seed=1234, fp16=False, static_loss_scale=None,
                 initial_scale_power=16, loss_scale_window=1000,
                 min_loss_scale=1.0, hysteresis=2,
                 consecutive_hysteresis=False, landing_depth=None,
                 max_write_bytes=None, telemetry=None, checkpoint=None,
                 device=None):
        if spec.layer_train_fn is None or spec.train_loss_fn is None:
            raise ValueError(
                "InfinityEngine needs a LayeredModelSpec with train fns "
                "(models.gpt.make_gpt_layered_model provides them)")
        self.spec = spec
        self.device = resolve_device(device)
        self.micro_batch_size = micro_batch_size
        self.gas = max(1, int(gradient_accumulation_steps))
        self.dtype = dtype
        self.telemetry = Telemetry(telemetry, subsystem="infinity")
        # the config surface checkpoint/saver.py reads: the checkpoint
        # engine (numpy by default: this tier's state lives on the host)
        self.config = types.SimpleNamespace(
            checkpoint=(checkpoint if checkpoint is not None else
                        types.SimpleNamespace(engine="numpy",
                                              async_save=False)),
            telemetry=telemetry)
        self.monitor = None
        self.resident = params_to(spec.resident, self.device, dtype)
        if self.device.type == "cpu":     # .to() may return the spec's own
            self.resident = tree_map(torch.clone, self.resident)
        pin = self.device.type == "cuda"
        self.store = LayerParamStore(spec.blocks, device=offload_device,
                                     swap_folder=nvme_path, dtype=dtype,
                                     max_write_bytes=max_write_bytes, pin=pin)
        self.store.telemetry = self.telemetry
        self._pin_puts = pin and offload_device == "cpu"
        self.streamer = LayerStreamer(self.store, lookahead=lookahead,
                                      telemetry=self.telemetry,
                                      device=self.device)
        self.landing_depth = max(1, int(landing_depth
                                        if landing_depth is not None
                                        else max(1, lookahead)))
        self.hostward_wait_ms_total = 0.0
        self.hostward_bytes_total = 0
        self.L = self.store.num_layers

        # fp32 masters and moments on the host, one optimizer per layer and
        # one for the resident leaves, from the spec's full-precision
        # weights (a layer's fp32 slice exists only while its optimizer is
        # built)
        opt_kw = dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                      optimizer=optimizer, adamw_mode=adamw_mode,
                      lr_schedule=lr_schedule)
        blocks = spec.blocks
        self.layer_opts = []
        for i in range(self.L):
            layer_i = {k: v[i] for k, v in blocks.items()}
            self.layer_opts.append(HostOffloadOptimizer(
                layer_i, nvme_folder=(f"{optimizer_nvme_path}/layer{i}"
                                      if optimizer_nvme_path else None),
                **opt_kw))
        self.resident_opt = HostOffloadOptimizer(
            tree_cast(spec.resident, torch.float32),
            nvme_folder=(f"{optimizer_nvme_path}/resident"
                         if optimizer_nvme_path else None), **opt_kw)

        # fp16: the scale rides the head's cotangent seed, the host divides
        # it out of the flats and checks them all finite before any layer
        # steps (the two-phase schedule)
        self.fp16 = bool(fp16)
        self._scaler = LossScaler(static_scale=static_loss_scale,
                                  initial_scale_power=initial_scale_power,
                                  loss_scale_window=loss_scale_window,
                                  hysteresis=hysteresis,
                                  consecutive_hysteresis=consecutive_hysteresis,
                                  min_loss_scale=min_loss_scale,
                                  enabled=self.fp16)
        self._scale_state = self._scaler.init("cpu")
        self.gradient_clipping = float(gradient_clipping or 0.0)
        self.last_grad_norm = None
        self.training_dataloader = None
        self._data_iterator = None
        if training_data is not None:
            from deepspeed_tpu_torch.runtime.dataloader import TpuDataLoader
            self.training_dataloader = TpuDataLoader(
                training_data, (micro_batch_size or 1) * self.gas,
                collate_fn=collate_fn, shuffle=True, seed=seed)
        self.step_count = 0
        log_dist(f"infinity engine: {spec.name} L={self.L} "
                 f"layer_mb={self.store.layer_bytes / 1e6:.1f} "
                 f"weights={offload_device} "
                 f"opt={'nvme' if optimizer_nvme_path else 'host'} "
                 f"device={self.device}", ranks=[0])

    @property
    def cur_scale(self):
        return float(self._scale_state.scale)

    @cur_scale.setter
    def cur_scale(self, value):
        self._scale_state = self._scale_state._replace(
            scale=torch.tensor(float(value), dtype=torch.float32))

    @property
    def skipped_steps(self):
        return int(self._scale_state.overflows)

    def _layer_step_host(self, i, flat):
        """Host optimizer step of layer i from its fp32 grad flat, and the
        compute-dtype write-back to the store (asynchronous on the nvme
        tier, under the store's write budget)."""
        opt = self.layer_opts[i]
        grads = _split(flat, [s for s, _ in self.store.leaf_meta])
        opt.step(tree_unflatten(opt.tree, grads))
        self.store.put(i, [_host_copy(m, d, self._pin_puts) for m, (_, d)
                           in zip(opt.master, self.store.leaf_meta)])

    def _micro_pass(self, inputs, labels, acc, res_acc, mode):
        """One micro-batch forward and backward. `mode`: "apply" (gas 1:
        each layer steps inside the backward), "accumulate" (the flats add
        into `acc` / `res_acc`) or "finalize" (the last micro-batch of gas:
        each layer steps on (acc[i] + flat) / gas as it lands)."""
        spec = self.spec
        B, T = inputs.shape
        positions = torch.arange(T, device=self.device).expand(B, T)
        boundaries = []
        with torch.no_grad():
            x = spec.embed_fn(self.resident, inputs, positions)
            for i in range(self.L):
                boundaries.append(x)
                x = spec.layer_train_fn(self.streamer.layer(i), x, positions)

        with torch.enable_grad():
            res = _grad_leaves(self.resident)
            x_h = x.detach().requires_grad_()
            loss = spec.train_loss_fn(tree_unflatten(self.resident, res),
                                      x_h, labels)
            seed = torch.full((), self.cur_scale, dtype=loss.dtype,
                              device=loss.device)
            *g_res, g_x = torch.autograd.grad(
                loss, res + [x_h], seed, allow_unused=True,
                materialize_grads=True)

        # backward in reverse: layer L-1's forward copy is what the backward
        # needs first; layer i's flat goes to the pipe as soon as its
        # backward is enqueued and lands `landing_depth` layers later
        pipe = HostwardPipe(depth=self.landing_depth,
                            telemetry=self.telemetry)
        for i in reversed(range(self.L)):
            p = self.streamer.layer(i, direction=-1)
            with torch.enable_grad():
                leaves = _grad_leaves(p)
                x_in = boundaries[i].detach().requires_grad_()
                out = spec.layer_train_fn(tree_unflatten(p, leaves), x_in,
                                          positions)
                *g_p, g_x = torch.autograd.grad(
                    out, leaves + [x_in], g_x, allow_unused=True,
                    materialize_grads=True)
            boundaries[i] = None
            for k, flat in pipe.submit(i, _flat(g_p)):
                self._consume(acc, mode, k, flat)
        for k, flat in pipe.drain():
            self._consume(acc, mode, k, flat)
        self.hostward_wait_ms_total += pipe.wait_ms_total
        self.hostward_bytes_total += pipe.bytes_total

        with torch.enable_grad():
            res = _grad_leaves(self.resident)
            x0 = spec.embed_fn(tree_unflatten(self.resident, res), inputs,
                               positions)
            g_emb = torch.autograd.grad(x0, res, g_x, allow_unused=True,
                                        materialize_grads=True)
        res_flat = _flat([a + b for a, b in zip(g_res, g_emb)]).cpu()
        if res_acc is None:
            res_acc = res_flat
        else:
            res_acc += res_flat
        return loss.detach(), res_acc

    def _consume(self, acc, mode, i, flat):
        """Layer i's landed host flat (a pinned buffer the pipe handed
        over: the host owns it)."""
        if mode == "apply":
            self._layer_step_host(i, flat)
        elif mode == "finalize":
            mean = (acc[i] + flat) / self.gas
            acc[i] = None
            self._layer_step_host(i, mean)
        elif acc[i] is None:
            acc[i] = flat
        else:
            acc[i] += flat

    def _next_batch(self, data_iter):
        it = data_iter
        if it is None and self.training_dataloader is not None:
            if self._data_iterator is None:
                from deepspeed_tpu_torch.runtime.dataloader import \
                    RepeatingLoader
                self._data_iterator = iter(
                    RepeatingLoader(self.training_dataloader))
            it = self._data_iterator
        if it is None:
            raise ValueError("train_batch needs a batch or "
                             "data_iter/training_data")
        return next(it)

    def _as_tokens(self, a):
        a = a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.asarray(a))
        return a.to(self.device, torch.long)

    def train_batch(self, batch=None, data_iter=None):
        """One step over the global batch (micro-batch x gas rows): the
        streamed forward and backward a micro-batch, host steps on the mean
        gradient, the write-back, the resident step last. Returns the mean
        loss. With clipping or fp16 the step is two-phase: the flats
        accumulate through every micro-batch, then the global norm (or the
        finite check) decides, then every layer steps."""
        if batch is None:
            batch = self._next_batch(data_iter)
        tokens = batch.get("tokens", batch.get("input_ids"))
        labels = batch.get("labels")
        if labels is None:
            inputs, labels = tokens[:, :-1], tokens[:, 1:]
        else:
            inputs = tokens
        inputs, labels = self._as_tokens(inputs), self._as_tokens(labels)
        B = inputs.shape[0]
        if B % self.gas:
            raise ValueError(f"global batch {B} not divisible by "
                             f"gradient_accumulation_steps={self.gas}")
        mbs = B // self.gas
        if self.micro_batch_size is not None and \
                mbs != self.micro_batch_size:
            raise ValueError(
                f"global batch of {B} with gas={self.gas} implies micro "
                f"batch {mbs}, engine configured for "
                f"{self.micro_batch_size}")

        clip = self.gradient_clipping
        two_phase = clip > 0 or self.fp16
        acc = [None] * self.L
        res_acc = None
        losses = []
        for m in range(self.gas):
            sl = slice(m * mbs, (m + 1) * mbs)
            if two_phase:
                mode = "accumulate"
            elif self.gas == 1:
                mode = "apply"
            else:
                mode = "finalize" if m == self.gas - 1 else "accumulate"
            loss, res_acc = self._micro_pass(inputs[sl], labels[sl], acc,
                                             res_acc, mode)
            losses.append(loss)
        loss = float(np.mean([float(v) for v in losses]))

        # the scale the micro-passes seeded with, before the update moves it
        used_scale = self.cur_scale
        if self.fp16:
            finite = bool(torch.isfinite(res_acc).all()) and all(
                bool(torch.isfinite(a).all()) for a in acc)
            self._scale_state = self._scaler.update(
                self._scale_state, torch.tensor(finite))
            if not finite:
                log_dist(f"fp16 overflow: step skipped, loss scale -> "
                         f"{self.cur_scale:.1f}", ranks=[0])
                self.streamer.reset()
                return loss

        denom = self.gas * used_scale
        g_res_flat = res_acc / denom
        if two_phase:
            scale = 1.0
            if clip > 0:
                sq = float(torch.dot(g_res_flat, g_res_flat))
                for i in range(self.L):
                    mean_i = acc[i] / denom
                    sq += float(torch.dot(mean_i, mean_i))
                total_norm = float(np.sqrt(sq))
                self.last_grad_norm = total_norm
                scale = min(1.0, clip / max(total_norm, 1e-12))
            for i in range(self.L):
                self._layer_step_host(i, acc[i] * (scale / denom))
                acc[i] = None
            g_res_flat = g_res_flat * scale

        self.streamer.reset()          # the device copies are stale
        self.store.flush_writes()      # one barrier a step
        opt = self.resident_opt
        opt.step(tree_unflatten(opt.tree, _split(
            g_res_flat, [m.shape for m in opt.master])))
        opt.push(tree_leaves(self.resident))
        self.step_count += 1
        self.telemetry.maybe_export(self.step_count)
        return loss

    @property
    def peak_param_hbm_bytes(self):
        return self.streamer.peak_live_layers * self.store.layer_bytes

    def offload_stats(self):
        """Host-side overlap counters, with telemetry off too. The
        device-ward stall (`staging.stall_ms_total`) and the host-ward
        landing wait are apart on purpose: the landing waits on the
        producing backward's compute as well as the copy."""
        return {"staging": self.streamer.stats(),
                "hostward_wait_ms_total": round(self.hostward_wait_ms_total,
                                                3),
                "hostward_bytes_total": self.hostward_bytes_total,
                "write_flushes": self.store.write_flushes,
                "landing_depth": self.landing_depth,
                "lookahead": self.streamer.lookahead}

    def memory_plan(self, capacity_bytes=0):
        """The memscope training plan priced from the live tier: the host
        params column is byte-identical to the `LayerParamStore`, the
        device staging column to the streamer's lookahead+1 ring."""
        from deepspeed_tpu_torch.telemetry.memscope import \
            plan_training_from_infinity
        return plan_training_from_infinity(self,
                                           capacity_bytes=capacity_bytes)

    @property
    def state(self):
        """Host snapshot: fp32 masters, moments and the loss-scale
        bookkeeping. The store is derived (the masters rounded)."""
        st = self._scale_state
        return {"layer_opts": [o.state_dict() for o in self.layer_opts],
                "resident_opt": self.resident_opt.state_dict(),
                "step": int(self.step_count),
                "scale": float(st.scale),
                "good_steps": int(st.good_steps),
                "overflows": int(st.overflows),
                "hysteresis_left": int(st.hysteresis_left)}

    @state.setter
    def state(self, s):
        for i, sd in enumerate(s["layer_opts"]):
            opt = self.layer_opts[i]
            opt.load_state_dict(sd)
            self.store.put(i, [_host_copy(m, d, self._pin_puts)
                               for m, (_, d) in zip(opt.master,
                                                    self.store.leaf_meta)])
        self.store.flush_writes()
        self.resident_opt.load_state_dict(s["resident_opt"])
        self.resident_opt.push(tree_leaves(self.resident))
        self.streamer.reset()
        self.step_count = int(s["step"])
        self._scale_state = type(self._scale_state)(
            scale=torch.tensor(float(s["scale"]), dtype=torch.float32),
            good_steps=torch.tensor(int(s["good_steps"]), dtype=torch.int32),
            overflows=torch.tensor(int(s["overflows"]), dtype=torch.int32),
            hysteresis_left=torch.tensor(int(s["hysteresis_left"]),
                                         dtype=torch.int32))

    # ---- checkpointing (checkpoint/saver.py: the commit protocol, the
    # validated rollback-walking loads, retention and the fault hooks; this
    # tier only says what its state is) --

    @property
    def global_steps(self):
        return self.step_count

    @property
    def checkpoint_device(self):
        return torch.device("cpu")

    def checkpoint_leaves(self):
        from deepspeed_tpu_torch.checkpoint.saver import named_leaves
        return named_leaves(self.state)

    def restore_checkpoint_leaves(self, named, prefixes=None):
        """Full-state loads only: this tier's masters and moments are the
        model, a partial load has nothing to stand on."""
        from deepspeed_tpu_torch.checkpoint.saver import unflatten_named

        def host(v):
            if isinstance(v, torch.Tensor) or not isinstance(v, np.ndarray):
                return v
            return torch.from_numpy(np.array(v)) if v.ndim else v.item()

        self.state = unflatten_named(self.state, {k: host(v)
                                                  for k, v in named.items()})

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True):
        """Atomic-commit checkpoint of the tier's host state. The
        write-back queue is flushed first: the manifest only ever
        describes a quiesced store."""
        self.store.flush_writes()
        from deepspeed_tpu_torch.checkpoint import saver
        client = dict(client_state or {})
        client.setdefault("global_steps", int(self.step_count))
        return saver.save_checkpoint(self, save_dir, tag=tag,
                                     client_state=client,
                                     save_latest=save_latest)

    def load_checkpoint(self, load_dir, tag=None):
        """Validated restore with the corruption walk-back
        (checkpoint/saver.py): the newest good tag wins."""
        from deepspeed_tpu_torch.checkpoint import saver
        return saver.load_checkpoint(self, load_dir, tag=tag)

    def release(self):
        self.telemetry.close()
        self.streamer.release()
        self.store.release()
