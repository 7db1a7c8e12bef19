"""Training engine (counterpart of `deepspeed_tpu/runtime/engine.py`).

`initialize(model=..., config=...)` returns `(engine, optimizer,
dataloader, lr_scheduler)`; `engine.train_batch(batch)` runs one optimizer
step: a loop over the gradient-accumulation micro-batches (scaled loss,
`torch.autograd.grad`, accumulation in `data_types.grad_accum_dtype`), then
the JAX engine's `_apply_grads_fn` sequence in its order — unscale, finite
check, fp32 global norm, clip, optimizer update of the fp32 master (or of
the params when `bf16.master_weights` is false), masked skip, cast to the
compute dtype, loss-scaler update, step + 1 only when finite. The step's
metrics (`engine._last_metrics`) also carry the slash-keyed scalar entries
of the loss's aux dict (`moe/aux_loss`, ...), averaged over the
micro-batches, as the JAX engine's do.

The optimizer steps the params, the fp32 master and its own state in
place (`ops/optim.py`); the scaler state and the step counter are 0-d
tensors replaced each step. Everything stays on the engine's device. The
host waits for the card once per step: `ThroughputTimer` reads a CUDA
event at the end of `train_batch`, as the JAX engine's timers fence. It
waits more only when asked to report: the `train_batch` timer's event
with `wall_clock_breakdown` or telemetry, and, with fp16 loss scaling, the
overflow flag that `_after_step` logs.

Telemetry (the `telemetry` config block, off by default): the
`train_batch` timer's interval, which ends with a wait for the card, is the
step time of `train/step_time_ms`; `train/tokens_per_sec`,
`train/tflops_per_chip` (the analytic 6 x params x tokens: there is no
compiled program to cost-analyze), `train/mfu` (over the card's peak, left
unset on a device `telemetry.PEAK_FLOPS` does not know and no
`peak_tflops` override), the allocator's `train/hbm_bytes_in_use` /
`train/hbm_peak_bytes` on CUDA, and every slash-keyed step metric
(`moe/aux_loss`, ...) as a gauge. The monitors (`tensorboard`,
`csv_monitor`, `wandb`) get `Train/loss`, `Train/lr`, `Train/loss_scale`
and `Train/grad_norm` every `steps_per_print` steps. With both off, a step
reads nothing more from the card.

One rank: ZeRO stages 0-3 are accepted and are one computation, as on the
JAX package's one-device mesh; more than one rank raises. The engine runs
on `cuda` unless the caller passes `device="cpu"`, and raises without a GPU.
"""

import dataclasses
import inspect
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.config.core import TpuTrainConfig, not_ported
from deepspeed_tpu_torch.inference.engine import resolve_device
from deepspeed_tpu_torch.ops.optim import build_optimizer
from deepspeed_tpu_torch.runtime import lr_schedules
from deepspeed_tpu_torch.runtime.dataloader import (RepeatingLoader,
                                                    TpuDataLoader)
from deepspeed_tpu_torch.runtime.precision import LossScaler, LossScaleState
from deepspeed_tpu_torch.telemetry import Telemetry
from deepspeed_tpu_torch.utils.logging import log_dist, logger
from deepspeed_tpu_torch.utils.timer import (TRAIN_BATCH_TIMER,
                                             SynchronizedWallClockTimer,
                                             ThroughputTimer)
from deepspeed_tpu_torch.utils.tree import (tree_cast, tree_global_norm,
                                            tree_leaves, tree_map,
                                            tree_num_params, tree_unflatten)


@dataclasses.dataclass
class ModelSpec:
    """What the engine needs from a model: `loss_fn(params, batch[, rng])
    -> loss` or `(loss, aux)` over a tree of tensors, and the params."""
    loss_fn: Callable
    params: Any = None
    apply_fn: Optional[Callable] = None   # raw forward, for evaluation
    has_aux: bool = False
    arch_cfg: Any = None                  # e.g. the GPTConfig
    name: str = "model"


class TrainState(NamedTuple):
    params: Any                  # compute-dtype parameters
    master: Any                  # fp32 master copy (None if not kept)
    opt_state: Any
    scaler: LossScaleState
    step: torch.Tensor           # i32: optimizer steps taken (not skipped)


def _wrap_loss_fn(loss_fn, has_aux):
    """Normalize to loss_fn(params, batch, rng) -> (loss, aux)."""
    try:
        takes_rng = len(inspect.signature(loss_fn).parameters) >= 3
    except (TypeError, ValueError):
        takes_rng = True

    def wrapped(params, batch, rng):
        out = loss_fn(params, batch, rng) if takes_rng \
            else loss_fn(params, batch)
        if has_aux:
            return out[0], out[1]
        if isinstance(out, tuple):
            return out[0], (out[1] if len(out) > 1 else None)
        return out, None

    return wrapped


def _to_device(batch, device):
    return tree_map(lambda x: (x if isinstance(x, torch.Tensor)
                               else torch.as_tensor(np.asarray(x))).to(device),
                    batch)


class Engine:
    """See the module docstring. Built by `initialize()`."""

    def __init__(self, model: ModelSpec, config, optimizer=None,
                 lr_scheduler=None, training_data=None, collate_fn=None,
                 device=None):
        config = TpuTrainConfig.load(config)
        self.config = config
        self.model_spec = model
        self.device = resolve_device(device)
        if torch.distributed.is_available() and \
                torch.distributed.is_initialized() and \
                torch.distributed.get_world_size() > 1:
            not_ported("training across more than one rank")

        (self.train_batch_size_value, self.micro_batch_size,
         self.gradient_accumulation_steps_value) = \
            config.resolve_batch_sizes(1)

        self.compute_dtype = config.compute_dtype()
        self.fp16_enabled = config.fp16_enabled
        self.bf16_enabled = config.bf16_enabled
        self.keep_master = self.compute_dtype != torch.float32 and (
            not self.bf16_enabled or config.bf16.master_weights)
        self.scaler = LossScaler(
            static_scale=None if config.fp16.dynamic else config.fp16.loss_scale,
            initial_scale_power=config.fp16.initial_scale_power,
            loss_scale_window=config.fp16.loss_scale_window,
            hysteresis=config.fp16.hysteresis,
            consecutive_hysteresis=config.fp16.consecutive_hysteresis,
            min_loss_scale=config.fp16.min_loss_scale,
            enabled=self.fp16_enabled)
        self.zero_stage = config.zero_optimization.stage

        self.schedule_fn = None
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is None:
            self.schedule_fn = lr_schedules.build_schedule(config.scheduler)
            if self.schedule_fn is not None:
                self.lr_scheduler = lr_schedules.LRScheduler(self.schedule_fn)
        elif isinstance(lr_scheduler, lr_schedules.LRScheduler):
            self.schedule_fn = lr_scheduler.schedule_fn
        if optimizer is None:
            if config.optimizer is None:
                raise ValueError("No optimizer: pass one to initialize() or "
                                 "set the 'optimizer' config block")
            optimizer = build_optimizer(config.optimizer, self.schedule_fn)
        self.optimizer = optimizer

        self._loss_fn = _wrap_loss_fn(model.loss_fn, model.has_aux)
        self.generator = torch.Generator(self.device).manual_seed(config.seed)
        self.state = self._init_state(model.params)
        log_dist(f"engine: {model.name} | params="
                 f"{tree_num_params(self.state.params) / 1e6:.2f}M | "
                 f"dtype={self.compute_dtype} | zero_stage={self.zero_stage} "
                 f"| device={self.device} | micro_bs={self.micro_batch_size} "
                 f"| gas={self.gradient_accumulation_steps_value} | "
                 f"global_bs={self.train_batch_size_value}", ranks=[0])

        self._pending = 0            # micro-batches since the last step()
        self._grad_acc = self._loss_acc = self._forward_cache = None
        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(
                training_data, collate_fn=collate_fn)
        self._data_iterator = None

        self.global_steps = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self.timers = SynchronizedWallClockTimer(self.device)
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_batch_size_value,
            steps_per_output=config.steps_per_print, device=self.device)
        self.monitor = self._build_monitor()
        self._last_metrics = {}
        # unified telemetry (`telemetry` config block): opt-in; the
        # default-disabled object costs one attribute check per step and
        # writes nothing
        self.telemetry = Telemetry(config.telemetry, subsystem="train",
                                   monitor=self.monitor)
        self._program_flops = None   # per-train_batch flops, computed once

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def _init_state(self, params):
        if params is None:
            raise ValueError("ModelSpec needs params (construction-time "
                             "partitioning through init_fn is not ported)")
        # the engine's own copy: the optimizer steps it in place
        params_c = tree_map(torch.clone, tree_cast(
            _to_device(params, self.device), self.compute_dtype))
        # the master starts from the compute-dtype params, as in the JAX
        # engine
        master = tree_cast(params_c, torch.float32) if self.keep_master \
            else None
        target = master if master is not None else params_c
        return TrainState(params=params_c, master=master,
                          opt_state=self.optimizer.init(target),
                          scaler=self.scaler.init(self.device),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=self.device))

    def state_to_numpy(self):
        """The whole TrainState as numpy trees (fp32 for floating leaves),
        for comparing with the JAX engine leaf by leaf."""
        def npy(t):     # a copy: the state is stepped in place
            t = t.detach().cpu()
            return (t.float() if t.is_floating_point() else t).numpy().copy()
        st = self.state
        return {"params": tree_map(npy, st.params),
                "master": None if st.master is None
                else tree_map(npy, st.master),
                "opt_state": tree_map(npy, st.opt_state),
                "scaler": {k: npy(v) for k, v in st.scaler._asdict().items()},
                "step": npy(st.step)}

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------

    def _micro_grads(self, params, micro_batch):
        """(grads in the params' dtype, loss, extras) of one micro-batch;
        the loss is scaled for the backward (fp16) and returned unscaled.
        `extras` are the slash-keyed scalar entries of the loss's aux dict
        (`moe/aux_loss`, ...) as fp32, the JAX engine's aux-metrics
        channel."""
        leaves = [p.detach().requires_grad_(p.is_floating_point())
                  for p in tree_leaves(params)]
        loss, aux = self._loss_fn(tree_unflatten(params, leaves), micro_batch,
                                  self.generator)
        wrt = [leaf for leaf in leaves if leaf.requires_grad]
        grads = iter(torch.autograd.grad(
            self.scaler.scale_loss(loss, self.state.scaler), wrt,
            allow_unused=True, materialize_grads=True))
        extras = {}
        if isinstance(aux, dict):
            extras = {k: torch.as_tensor(v).detach().float()
                      for k, v in aux.items()
                      if "/" in k and torch.as_tensor(v).dim() == 0}
        return tree_unflatten(params, [next(grads) if leaf.requires_grad
                                       else torch.zeros_like(leaf)
                                       for leaf in leaves]), loss.detach(), \
            extras

    def _grads(self, params, batch):
        """The gas loop: (grads, mean loss, extras). At gas > 1 grads
        accumulate in `grad_accum_dtype` (fp32 by default), each divided by
        the predivide factor, and the sum is scaled by predivide / gas; at
        gas == 1 they stay in the compute dtype (the optimizer widens them
        exactly). The extras are the micro-batches' mean."""
        gas = self.gradient_accumulation_steps_value
        batch = _to_device(batch, self.device)
        if gas == 1:
            return self._micro_grads(params, batch)
        for leaf in tree_leaves(batch):
            if leaf.shape[0] % gas:
                raise ValueError(f"batch dim {leaf.shape[0]} not divisible "
                                 f"by gradient_accumulation_steps={gas}")
        split = tree_map(lambda x: x.reshape(gas, x.shape[0] // gas,
                                             *x.shape[1:]), batch)
        acc_dtype = self.config.data_types.accum_dtype()
        predivide = self.config.gradient_predivide_factor or 1.0
        acc = loss_sum = extras = None
        for i in range(gas):
            g, loss, ex = self._micro_grads(params, tree_map(lambda x: x[i],
                                                             split))
            g = [x.to(acc_dtype) / predivide for x in tree_leaves(g)]
            acc = g if acc is None else [a + x for a, x in zip(acc, g)]
            loss = loss.float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            extras = ex if extras is None else {k: extras[k] + v
                                                for k, v in ex.items()}
        grads = tree_unflatten(params, [a * (predivide / gas) for a in acc])
        return grads, loss_sum / gas, {k: v / gas for k, v in extras.items()}

    def _apply_grads(self, state, grads, loss):
        """(state, grads, mean loss) -> (state, metrics). The grads are
        this step's own and are clipped in place; the params, master and
        optimizer state are stepped in place."""
        scaler = self.scaler
        grads = scaler.unscale_grads(grads, state.scaler)
        finite = scaler.check_overflow(grads)
        grad_norm = tree_global_norm(grads)
        clip = self.config.gradient_clipping
        if clip and clip > 0:
            factor = (clip / (grad_norm + 1e-6)).clamp_max(1.0)
            for g in tree_leaves(grads):
                g.mul_(factor.to(g.dtype))
        target = state.master if self.keep_master else state.params
        # the skip-step: under fp16 loss scaling an overflow leaves every
        # stored leaf as it was (a masked update, no host branch); without
        # the scaler the mask is the JAX engine's constant true
        self.optimizer.update(grads, state.opt_state, target,
                              finite if scaler.enabled else None)
        if self.keep_master:
            for p, m in zip(tree_leaves(state.params), tree_leaves(target)):
                p.copy_(m)
        lr = self.schedule_fn(state.step) if self.schedule_fn is not None \
            else 0.0
        metrics = {"loss": loss.float(), "grad_norm": grad_norm.float(),
                   "overflow": ~finite, "loss_scale": state.scaler.scale,
                   "lr": torch.as_tensor(lr, dtype=torch.float32,
                                         device=self.device)}
        return state._replace(scaler=scaler.update(state.scaler, finite),
                              step=state.step + finite.to(torch.int32)), \
            metrics

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def train_batch(self, batch=None, data_iter=None):
        """One optimizer step over `batch` (leading dim gas x micro-batch),
        or the next batch of `data_iter` / the training dataloader. Returns
        the mean loss (a 0-d tensor on the device)."""
        if batch is None:
            it = data_iter
            if it is None and self.training_dataloader is not None:
                if self._data_iterator is None:
                    self._data_iterator = iter(
                        RepeatingLoader(self.training_dataloader))
                it = self._data_iterator
            if it is None:
                raise ValueError("train_batch needs a batch, a data_iter or "
                                 "training_data")
            batch = next(it)
        # the train_batch timer's readers: the breakdown log and telemetry
        timed = self.config.wall_clock_breakdown or self.telemetry.enabled
        self.tput_timer.start()
        if timed:
            self.timers(TRAIN_BATCH_TIMER).start()
        grads, loss, extras = self._grads(self.state.params, batch)
        self.state, metrics = self._apply_grads(self.state, grads, loss)
        metrics.update(extras)
        if timed:
            self.timers(TRAIN_BATCH_TIMER).stop()   # waits for the card
        self.tput_timer.stop(global_step=True)
        self._after_step(metrics, count_micro=True)
        if self.telemetry.enabled:
            self._record_step_telemetry(batch,
                                        self.timers(TRAIN_BATCH_TIMER).last)
        return metrics["loss"]

    def eval_batch(self, batch, rng=None):
        with torch.no_grad():
            loss, _ = self._loss_fn(self.state.params,
                                    _to_device(batch, self.device),
                                    rng if rng is not None else self.generator)
        return loss

    # --- forward/backward/step: the reference engine's triplet. forward
    # computes the loss AND the micro-batch grads (fp32), backward
    # accumulates them, step applies their mean at the gas boundary.

    def forward(self, batch):
        grads, loss, _ = self._micro_grads(self.state.params,
                                           _to_device(batch, self.device))
        self._forward_cache = (tree_cast(grads, torch.float32), loss)
        return loss

    def backward(self, loss=None, allreduce_gradients=True):
        if self._forward_cache is None:
            raise RuntimeError("backward() must follow forward()")
        grads, loss_v = self._forward_cache
        self._forward_cache = None
        if not self._pending:
            self._grad_acc, self._loss_acc = grads, loss_v
        else:
            self._grad_acc = tree_unflatten(grads, [
                a + g for a, g in zip(tree_leaves(self._grad_acc),
                                      tree_leaves(grads))])
            self._loss_acc = self._loss_acc + loss_v
        self._pending += 1
        self.micro_steps += 1
        return loss_v

    def step(self):
        if not self._pending:
            raise RuntimeError("step() must follow backward()")
        n = float(self._pending)
        grads = tree_map(lambda g: g / n, self._grad_acc)
        self.state, metrics = self._apply_grads(self.state, grads,
                                                self._loss_acc / n)
        self._pending, self._grad_acc = 0, None
        self._after_step(metrics)
        return metrics

    def _after_step(self, metrics, count_micro=False):
        self.global_steps += 1
        if count_micro:
            self.micro_steps += self.gradient_accumulation_steps_value
        self._last_metrics = metrics
        if self.telemetry.enabled:
            # slash-namespaced metrics (moe/aux_loss, moe/overflow_tokens,
            # ...) are model-emitted gauges; the fixed train/* set is
            # _record_step_telemetry's
            reg = self.telemetry.registry
            for k, v in metrics.items():
                if "/" in k:
                    reg.gauge(k).set(float(v))
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
        # overflow can only occur under fp16: the one host read of a step,
        # and only then
        if self.fp16_enabled and bool(metrics["overflow"]):
            self.skipped_steps += 1
            log_dist(f"step {self.global_steps}: grad overflow — step "
                     f"skipped (loss scale -> "
                     f"{float(self.state.scaler.scale):.1f})", ranks=[0])
        if self.monitor is not None and self.monitor.enabled and \
                self.global_steps % self.config.steps_per_print == 0:
            self.monitor.write_events([
                ("Train/loss", float(metrics["loss"]), self.global_steps),
                ("Train/lr", float(metrics["lr"]), self.global_steps),
                ("Train/loss_scale", float(metrics["loss_scale"]),
                 self.global_steps),
                ("Train/grad_norm", float(metrics["grad_norm"]),
                 self.global_steps)])
        if self.config.wall_clock_breakdown and \
                self.global_steps % self.config.steps_per_print == 0:
            self.timers.log([TRAIN_BATCH_TIMER])

    # ------------------------------------------------------------------
    # telemetry (`telemetry` config block) and the monitors
    # ------------------------------------------------------------------

    def _record_step_telemetry(self, batch, step_seconds):
        """Per-step observability: the step-time histogram, tokens/s, and
        achieved TFLOP/s and MFU = model flops / (step time x the card's
        peak). `step_seconds` is the train_batch timer's interval, which
        ended with a wait for the card."""
        reg = self.telemetry.registry
        reg.histogram("train/step_time_ms").observe(step_seconds * 1e3)
        tokens = None
        if isinstance(batch, dict):
            t = batch.get("tokens", batch.get("input_ids"))
            if t is not None:
                tokens = int(t.numel() if isinstance(t, torch.Tensor)
                             else np.asarray(t).size)
        if tokens:
            reg.gauge("train/tokens_per_sec").set(tokens / step_seconds)
        if self._program_flops is None:
            # the analytic 6N model flops a step (the PaLM MFU convention):
            # the kernels launched through ctypes are invisible to a flop
            # counter of the dispatcher
            self._program_flops = 6.0 * tree_num_params(self.state.params) \
                * tokens if tokens else 0.0
        if self._program_flops > 0:
            achieved = self._program_flops / step_seconds
            reg.gauge("train/tflops_per_chip").set(achieved / 1e12)
            peak = self.telemetry.peak_flops(self.device)
            if peak:
                reg.gauge("train/mfu").set(achieved / peak)
        if self.device.type == "cuda":
            stats = torch.cuda.memory_stats(self.device)
            for src, dst in (("allocated_bytes.all.current",
                              "train/hbm_bytes_in_use"),
                             ("allocated_bytes.all.peak",
                              "train/hbm_peak_bytes")):
                if src in stats:
                    reg.gauge(dst).set(float(stats[src]))
        self.telemetry.maybe_export(self.global_steps)

    def _build_monitor(self):
        try:
            from deepspeed_tpu_torch.monitor.monitor import MonitorMaster
            return MonitorMaster(self.config)
        except Exception as e:
            logger.warning(f"monitor unavailable: {e}")
            return None

    def deepspeed_io(self, dataset, batch_size=None, collate_fn=None,
                     shuffle=True):
        """The training dataloader: one global batch (micro x gas) per
        train_batch call."""
        return TpuDataLoader(dataset, batch_size or self.train_batch_size_value,
                             collate_fn=collate_fn, shuffle=shuffle,
                             seed=self.config.seed)

    # ------------------------------------------------------------------
    # properties / getters (the reference engine's surface)
    # ------------------------------------------------------------------

    @property
    def module(self):
        return self.model_spec

    @property
    def params(self):
        return self.state.params

    def get_lr(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler.get_lr()
        lr = self.config.optimizer.params.get("lr", 0.0) \
            if self.config.optimizer else 0.0
        return [lr]

    @property
    def cur_scale(self):
        return float(self.state.scaler.scale)

    def loss_scale(self):
        return self.cur_scale

    @property
    def global_step(self):
        return int(self.state.step)

    def gradient_accumulation_steps(self):
        return self.gradient_accumulation_steps_value

    def train_micro_batch_size_per_gpu(self):
        return self.micro_batch_size

    def train_batch_size(self):
        return self.train_batch_size_value

    def zero_optimization_stage(self):
        return self.zero_stage

    def get_global_grad_norm(self):
        m = self._last_metrics
        return float(m["grad_norm"]) if "grad_norm" in m else None


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, collate_fn=None,
               config=None, config_params=None, device=None):
    """Returns (engine, optimizer, training_dataloader, lr_scheduler), the
    reference's tuple. `model`: a ModelSpec, or a loss callable with
    `model_parameters` (the params tree). `config`: a dict, a JSON path or
    a TpuTrainConfig (else `args.deepspeed_config`). `device`: `cuda` by
    default; pass "cpu" to train on the CPU."""
    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize: model is required")
    if config is None and config_params is not None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None) \
            or getattr(args, "deepscale_config", None)
    if not isinstance(model, ModelSpec):
        if not callable(model):
            raise TypeError("model must be a ModelSpec or a loss callable")
        if model_parameters is None or callable(model_parameters):
            raise ValueError("when model is a callable, pass "
                             "model_parameters (the params tree; an init_fn "
                             "is not ported)")
        model = ModelSpec(loss_fn=model, params=model_parameters)
    engine = Engine(model=model, config=config, optimizer=optimizer,
                    lr_scheduler=lr_scheduler, training_data=training_data,
                    collate_fn=collate_fn, device=device)
    return engine, engine.optimizer, engine.training_dataloader, \
        engine.lr_scheduler
