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

The data-efficiency schedules run on the host before each step, as the
JAX engine's do: the legacy seqlen curriculum
(`data_efficiency.data_sampling.curriculum_learning`) cuts the batch to the
step's difficulty (with random-LTD on, masks its labels past it as JAX
does), then progressive layer drop and random-LTD draw their
kept layers and kept tokens from numpy generators seeded as the JAX
engine's and add them to the batch as leaves (`_inject_routing_directives`),
which split by micro-batch like the data and which `models/gpt.gpt_loss`
reads.

Telemetry (the `telemetry` config block, off by default): the
`train_batch` timer's interval, which ends with a wait for the card, is the
step time of `train/step_time_ms`; `train/tokens_per_sec`,
`train/tflops_per_chip` (the analytic 6 x params x tokens: there is no
compiled program to cost-analyze), `train/mfu` (over the card's peak, left
unset on a device `telemetry.PEAK_FLOPS` does not know and no
`peak_tflops` override), the allocator's `train/hbm_bytes_in_use` /
`train/hbm_peak_bytes` on CUDA (the run's peak; with `telemetry.memscope`
on, the ledger resets the allocator's peak at every step to measure the
step's temp, for every reader in the process, and keeps the run's peak
for this gauge), and every slash-keyed step metric
(`moe/aux_loss`, ...) as a gauge. The monitors (`tensorboard`,
`csv_monitor`, `wandb`) get `Train/loss`, `Train/lr`, `Train/loss_scale`
and `Train/grad_norm` every `steps_per_print` steps. With both off, a step
reads nothing more from the card.

ZeRO-Offload (`zero_optimization.offload_optimizer`), by the JAX engine's
rule: `cpu` keeps the fp32 master and the optimizer state in pinned host
memory and moves them through HBM for each step's update (the copy in
starts on a side stream before the micro-batches, so it runs beside them;
the copy out is enqueued after the update and the next step's copy in
waits for it), unless that state, about 14 bytes a parameter, exceeds 0.6
of the card's memory (`device_memory_bytes`). Then, and for `nvme`, a
`DeepSpeedCPU*` optimizer or `zero_force_ds_cpu_optimizer`, the step runs
on the host: `runtime/cpu_optimizer.HostOffloadOptimizer` owns the fp32
master and moments (the moments on NVMe for `nvme`), the card computes
the gradients, and the compute-dtype params are pushed back into the
device tensors. As in the JAX engine, the host step clips nothing and
checks no overflow.

Checkpoints (`save_checkpoint` / `load_checkpoint`, `checkpoint/saver.py`)
take the JAX package's commit protocol and on-disk names: the params, the
fp32 master and the optimizer state under optax's names (the host step's
C++ masters and moments too), the loss scaler and the step; `client_state`
carries `global_steps`, `skipped_steps` and the lr scheduler. A load
copies each leaf into the engine's own tensor, so the state stays where it
lives (the card, or the streamed tier's pinned host home). With
`fault_tolerance` on, the bad-state sentinel (`runtime/sentinel.py`) reads
each step's loss and, past its budget, rolls the engine back to the last
checkpoint (a flight-recorder dump first, `Recovery/*` events after) or
raises `BadStateError`. `telemetry.memscope` builds the memory ledger
(`telemetry/memscope.TrainMemScope`): a pre-flight plan at build, `mem/*`
gauges every telemetry step, the step's measured temp, and an OOM dump at
the step's boundary.

`initialize` routes a `LayeredModelSpec` to the layer-streaming
`runtime/infinity.InfinityEngine`, built from the config.

Across ranks (an initialized `torch.distributed` process group: NCCL on
the card, gloo on the CPU; a backend that does not drive the engine's
device raises), the engine trains data-parallel over the mesh's `data`
axis at ZeRO stages 0-3 through the comm facade, with the shard of each
leaf `runtime/zero.ZeroShardingPolicy` gives (JAX's dimensions). Every rank
is handed the same global batch (gas x micro x dp rows) and takes the rows
the JAX engine puts on its data shard: after the [gas, micro x dp] split,
rank r's rows r x micro ... (r + 1) x micro. Each rank's grads are of its
own rows' mean loss; they are summed across ranks and divided by dp (stage
0 / 1 once a step; stage 2 reduce-scatters each micro-batch's into the
rank's shard; stage 3's gathers and reduce-scatters run inside the model's
forward and backward, `runtime/zero.ZeroParamView`). The global grad norm,
the fp16 overflow check and the reported loss (which the sentinel reads)
are reduced across the ranks before anything decides on them, so every
rank takes the same branch. A checkpoint holds the whole tree, gathered
leaf by leaf into rank 0's host memory and written by rank 0 in the
one-rank layout; each rank loads its shards, at any world size. One step
serves every world size: at one rank (no process group, where the mesh
must be one rank and a larger `mesh` raises, or a group of one) nothing is
sharded, as in JAX, and the step issues no collective. The engine runs on `cuda` unless the caller passes
`device="cpu"`, and raises without a GPU.
"""

import dataclasses
import inspect
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.checkpoint.saver import (named_leaves, optax_count,
                                                  optax_opt_leaves)
from deepspeed_tpu_torch.comm import collectives as coll
from deepspeed_tpu_torch.comm import mesh as mesh_mod
from deepspeed_tpu_torch.config.core import TpuTrainConfig, not_ported
from deepspeed_tpu_torch.inference.engine import resolve_device
from deepspeed_tpu_torch.ops.optim import OPTIMIZER_ALIASES, build_optimizer
from deepspeed_tpu_torch.runtime import lr_schedules
from deepspeed_tpu_torch.runtime.cpu_optimizer import (HOST_OPTIMIZER_NAMES,
                                                       host_optimizer_kind)
from deepspeed_tpu_torch.runtime.dataloader import (RepeatingLoader,
                                                    TpuDataLoader)
from deepspeed_tpu_torch.runtime.precision import LossScaler, LossScaleState
from deepspeed_tpu_torch.runtime.sentinel import BadStateError, BadStateSentinel
from deepspeed_tpu_torch.runtime.zero import (ZeroParamView,
                                              ZeroShardingPolicy, chunk_of,
                                              flat_all_gather,
                                              flat_all_reduce,
                                              flat_reduce_scatter,
                                              gather_to_host)
from deepspeed_tpu_torch.telemetry import Telemetry
from deepspeed_tpu_torch.utils.logging import log_dist, logger
from deepspeed_tpu_torch.utils.timer import (TRAIN_BATCH_TIMER,
                                             SynchronizedWallClockTimer,
                                             ThroughputTimer)
from deepspeed_tpu_torch.utils.tree import (tree_cast, tree_leaves,
                                            tree_map,
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


class HostArray(np.ndarray):
    """A batch leaf that `_to_device` leaves on the host, as a CPU tensor:
    one whose values the model reads as Python numbers, which on the card
    would be a wait for the device every micro-batch. Slices stay
    HostArrays."""


def device_memory_bytes(device):
    """The card's memory in bytes (what ZeRO-Offload's `cpu` rule compares
    the optimizer state with); 0 where it is not known (the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    return int(torch.cuda.get_device_properties(device).total_memory)


def _as_tensor(src, dst, name, n=1, rank=0):
    """A loaded checkpoint leaf as a tensor in `dst`'s dtype (the numpy
    engine widened bf16 to fp32: narrowing back is exact); where `dst` is
    a rank's shard of it (1/n of one dimension), this rank's chunk."""
    t = src if isinstance(src, torch.Tensor) \
        else torch.from_numpy(np.array(src))
    if tuple(t.shape) != tuple(dst.shape):
        diff = [d for d, (a, b) in enumerate(zip(t.shape, dst.shape))
                if a != b]
        if n == 1 or t.dim() != dst.dim() or len(diff) != 1 or \
                t.shape[diff[0]] != n * dst.shape[diff[0]]:
            raise ValueError(f"checkpoint leaf '{name}' has shape "
                             f"{tuple(t.shape)}, the engine's "
                             f"{tuple(dst.shape)}")
        t = chunk_of(t, diff[0], n, rank)
    return t.to(dtype=dst.dtype)


def _to_device(batch, device):
    def move(x):
        if isinstance(x, HostArray):
            return torch.from_numpy(np.asarray(x))
        return (x if isinstance(x, torch.Tensor)
                else torch.as_tensor(np.asarray(x))).to(device)
    return tree_map(move, batch)


class Engine:
    """See the module docstring. Built by `initialize()`."""

    def __init__(self, model: ModelSpec, config, optimizer=None,
                 lr_scheduler=None, training_data=None, collate_fn=None,
                 device=None):
        config = TpuTrainConfig.load(config)
        self.config = config
        self.model_spec = model
        self.device = resolve_device(device)
        self._init_data_parallel(config)
        (self.train_batch_size_value, self.micro_batch_size,
         self.gradient_accumulation_steps_value) = \
            config.resolve_batch_sizes(self.dp_world_size)

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
        self._init_offload(model)

        self._loss_fn = _wrap_loss_fn(model.loss_fn, model.has_aux)
        self.generator = torch.Generator(self.device).manual_seed(config.seed)
        # the whole model's count (a rank may hold shards); the model's
        # params may be numpy arrays
        self.num_params = sum(int(np.prod(np.shape(x)))
                              for x in tree_leaves(model.params))
        self.state = self._init_state(model.params)
        log_dist(f"engine: {model.name} | params="
                 f"{self.num_params / 1e6:.2f}M | dp={self.dp_world_size} | "
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
        self._init_data_efficiency()

        # the memory ledger (telemetry/memscope.py): byte attribution as
        # mem/* gauges, a pre-flight model-states verdict against the
        # card's memory, the step's measured temp and an OOM dump at the
        # step's boundary. Off by default: no object, no gauges, no files
        self.memscope = None
        if self.telemetry.enabled and config.telemetry.memscope:
            from deepspeed_tpu_torch.telemetry.memscope import TrainMemScope
            self.memscope = TrainMemScope(self)
            self.memscope.preflight(str(config.telemetry.memscope_preflight))

        # fault tolerance: the bad-state sentinel (opt-in; observing the
        # loss waits for the card once a step) and the rollback bookkeeping
        self._sentinel = BadStateSentinel(
            config.fault_tolerance,
            recorder=self.telemetry.flightrec
            if self.telemetry.flightrec.enabled else None)
        self._last_ckpt_dir = None    # newest save/load root: the rollback
        self.rollbacks = 0

    def _init_data_parallel(self, config):
        """The data-parallel world: with a process group, the mesh over it
        (its size must be the config's `mesh`; the backend must drive the
        device) and this rank's place in the ZeRO domain; without one, a
        one-rank mesh (a larger `mesh` raises)."""
        dist = torch.distributed
        self.sharded = dist.is_available() and dist.is_initialized()
        if self.sharded:
            from deepspeed_tpu_torch.comm.comm import check_backend
            check_backend(self.device)
            spec = mesh_mod.ensure_mesh(config.mesh)
            self.dp_rank = mesh_mod.axis_rank(mesh_mod.ZERO_AXES)
        else:
            spec = mesh_mod.MeshSpec.resolve(config.mesh, n_devices=1)
            self.dp_rank = 0
        self.dp_world_size = spec.data * spec.zero * spec.sequence
        self.zero_policy = ZeroShardingPolicy(config.zero_optimization, spec,
                                              self.dp_rank)

    def _init_data_efficiency(self):
        """The legacy seqlen curriculum, progressive layer drop and
        random-LTD from the config, with the JAX engine's init-time checks
        (as ValueError) and its generators' seeds, so that one seed draws
        the same kept layers and tokens in both packages."""
        config = self.config
        de = config.data_efficiency
        cl = (de.data_sampling or {}).get("curriculum_learning", {}) \
            if de.enabled else {}
        self.curriculum_scheduler = None
        if cl.get("enabled"):
            from deepspeed_tpu_torch.runtime.data_pipeline.curriculum import \
                CurriculumScheduler
            self.curriculum_scheduler = CurriculumScheduler(cl)
        pld_cfg = config.progressive_layer_drop
        rl = (de.data_routing or {}).get("random_ltd", {}) \
            if de.enabled else {}
        if pld_cfg.enabled or rl.get("enabled"):
            which = "progressive_layer_drop" if pld_cfg.enabled \
                else "random_ltd"
            if getattr(self.model_spec, "arch_cfg", None) is None:
                raise ValueError(
                    f"{which}: this model does not expose ModelSpec.arch_cfg, "
                    f"so the routing directives would be silently ignored — "
                    f"only the GPT loss (models/gpt.gpt_loss) consumes them")
            if getattr(self.model_spec, "grad_fn", None) is not None:
                raise ValueError(f"{which}: models with a custom grad_fn do "
                                 f"not consume routing directives")
        self.progressive_layer_drop = None
        if pld_cfg.enabled:
            from deepspeed_tpu_torch.runtime.progressive_layer_drop import \
                ProgressiveLayerDrop
            self.progressive_layer_drop = ProgressiveLayerDrop(
                theta=pld_cfg.theta, gamma=pld_cfg.gamma)
            self._pld_rng = np.random.default_rng(config.seed ^ 0x9E3779B9)
        self.random_ltd_scheduler = None
        if rl.get("enabled"):
            self.random_ltd_scheduler = self._random_ltd_scheduler(rl)
            self._ltd_rng = np.random.default_rng(config.seed ^ 0x51ED270B)

    def _random_ltd_scheduler(self, rl):
        """`data_routing.random_ltd` (the reference's schema) as a
        RandomLTDScheduler: a contiguous layer range within the model."""
        from deepspeed_tpu_torch.runtime.data_pipeline.random_ltd import \
            RandomLTDScheduler
        sched = rl.get("random_ltd_schedule", {})
        sched_cfg = sched.get("schedule_config", {})
        total_layers = int(rl.get("total_layer_num", 0))
        if total_layers <= 0:
            raise ValueError("data_routing.random_ltd needs total_layer_num "
                             "(reference schema)")
        layer_ids = rl.get("random_ltd_layer_id")
        if layer_ids:
            layer_ids = sorted(int(i) for i in layer_ids)
            if layer_ids != list(range(layer_ids[0], layer_ids[-1] + 1)):
                raise ValueError("random_ltd_layer_id must be a contiguous "
                                 "range (the model splits its layers into "
                                 "three runs)")
            start_layer, end_layer = layer_ids[0], layer_ids[-1]
        else:
            start_layer = int(rl.get("ltd_start_layer", 1))
            end_layer = rl.get("ltd_end_layer")
        model_layers = getattr(self.model_spec.arch_cfg, "n_layer", None)
        if model_layers is not None:
            if total_layers != model_layers:
                raise ValueError(
                    f"random_ltd total_layer_num={total_layers} does not "
                    f"match the model's n_layer={model_layers}")
            last = end_layer if end_layer is not None else model_layers - 1
            if not 0 <= start_layer <= last < model_layers:
                raise ValueError(
                    f"random_ltd layer range [{start_layer}, {last}] is out "
                    f"of bounds for an {model_layers}-layer model")
        return RandomLTDScheduler(
            total_layers=total_layers,
            start_ratio=float(sched.get("min_value", 0.5)),
            end_ratio=float(sched.get("max_value", 1.0)),
            total_steps=int(sched_cfg.get("require_steps", 10000)),
            ltd_start_layer=start_layer, ltd_end_layer=end_layer,
            bucket=int(sched_cfg.get("seq_per_step", 64)))

    def _init_offload(self, model):
        """ZeRO-Offload's tier from `offload_optimizer` (the JAX engine's
        rule; see the module docstring): sets `host_step` (the C++ host
        optimizer) and `offload_optimizer_states` (the streamed tier)."""
        config = self.config
        off = config.zero_optimization.offload_optimizer
        nvme = off is not None and off.device == "nvme"
        cpu_off = off is not None and off.device == "cpu"
        opt_name = config.optimizer.type.lower() if config.optimizer \
            else "adam"
        force_host_step = bool(config.zero_force_ds_cpu_optimizer
                               or opt_name.startswith("deepspeedcpu"))
        if cpu_off and not force_host_step and model.params is not None:
            hbm = device_memory_bytes(self.device)
            est = 14 * tree_num_params(model.params)
            if hbm and est > 0.6 * hbm:
                if opt_name in HOST_OPTIMIZER_NAMES:
                    log_dist(f"offload_optimizer(cpu): the fp32 state "
                             f"(~{est / 2**30:.1f}G) cannot stream through "
                             f"{hbm / 2**30:.1f}G of device memory — using "
                             f"the host (C++) optimizer step", ranks=[0])
                    force_host_step = True
                else:
                    logger.warning(
                        f"offload_optimizer(cpu): the fp32 state "
                        f"(~{est / 2**30:.1f}G) likely exceeds device memory "
                        f"during the streamed update, but optimizer "
                        f"'{opt_name}' has no host (C++) implementation — "
                        f"keeping the streamed step (may OOM); use "
                        f"adam/lion/adagrad for host offload")
        self.host_step = nvme or (cpu_off and force_host_step)
        self.offload_optimizer_states = cpu_off and not force_host_step
        if self.sharded and (self.host_step or self.offload_optimizer_states):
            not_ported("zero_optimization.offload_optimizer under a process "
                       "group (ZeRO-Offload across ranks)", item="9")
        self.host_optimizer = None
        self._state_copy_stream = None
        self._state_out_event = None

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def _init_host_optimizer(self, params):
        """The host step's optimizer: fp32 master from the model's params,
        moments in host RAM or (nvme) on disk."""
        from deepspeed_tpu_torch.runtime.cpu_optimizer import \
            HostOffloadOptimizer
        off = self.config.zero_optimization.offload_optimizer
        opt_cfg = self.config.optimizer
        opt_params = dict(opt_cfg.params if opt_cfg else {})
        kind, adamw_mode = host_optimizer_kind(
            opt_cfg.type if opt_cfg else "adam")
        self.host_optimizer = HostOffloadOptimizer(
            params, lr=opt_params.get("lr", 1e-3),
            betas=tuple(opt_params.get("betas", (0.9, 0.999))),
            eps=opt_params.get("eps", 1e-8),
            weight_decay=opt_params.get("weight_decay", 0.0),
            adamw_mode=adamw_mode, optimizer=kind,
            nvme_folder=off.nvme_path if off.device == "nvme" else None,
            lr_schedule=self.schedule_fn, aio_threads=off.buffer_count)

    def _init_state(self, params):
        if params is None:
            raise ValueError("ModelSpec needs params (construction-time "
                             "partitioning through init_fn is not ported)")
        # the engine's own copy: the optimizer steps it in place
        params_c = tree_map(torch.clone, tree_cast(
            _to_device(params, self.device), self.compute_dtype))
        # each leaf's shard dimension (None: held whole) in leaf order, for
        # its params (stage 3), its fp32 master and optimizer state (stages
        # 1-3) and its step's grads (stages 2-3); all None at one rank
        pol = self.zero_policy
        leaves = tree_leaves(params_c)
        self._pdims = [pol.param_dim(t) for t in leaves]
        self._sdims = [pol.state_dim(t) for t in leaves]
        self._gdims = [pol.grad_dim(t) for t in leaves]
        scaler = self.scaler.init(self.device)
        step = torch.zeros((), dtype=torch.int32, device=self.device)
        if self.host_step:
            self._init_host_optimizer(params)
            return TrainState(params=params_c, master=None, opt_state=None,
                              scaler=scaler, step=step)
        params_c = tree_unflatten(params_c, [
            pol.shard(t, d) for t, d in zip(leaves, self._pdims)])
        # the master starts from the compute-dtype params, as in the JAX
        # engine
        master = None
        if self.keep_master:
            master = tree_unflatten(params_c, [
                pol.shard(t.float(), d) for t, d in zip(leaves, self._sdims)])
        state = TrainState(params=params_c, master=master, opt_state=None,
                           scaler=scaler, step=step)
        opt_state = self.optimizer.init(self._update_target(state))
        if self.offload_optimizer_states and self.device.type == "cuda":
            # the streamed tier's home: pinned host memory
            def pinned(t):
                return torch.empty(t.shape, dtype=t.dtype,
                                   pin_memory=True).copy_(t)
            master = None if master is None else tree_map(pinned, master)
            opt_state = tree_map(pinned, opt_state)
            self._state_copy_stream = torch.cuda.Stream(self.device)
        return state._replace(master=master, opt_state=opt_state)

    # ------------------------------------------------------------------
    # the state across ranks (ZeRO shards)
    # ------------------------------------------------------------------

    def _update_target(self, state):
        """The tree the optimizer steps in place: the master's shards, or
        without a master the params' — a stage-3 shard itself, or a view of
        the rank's chunk of a whole param."""
        if self.keep_master:
            return state.master
        n, r = self.dp_world_size, self.dp_rank
        out = []
        for p, pd, sd in zip(tree_leaves(state.params), self._pdims,
                             self._sdims):
            if pd is None and sd is not None:
                s = p.shape[sd] // n
                p = p.narrow(sd, r * s, s)
            out.append(p)
        return tree_unflatten(state.params, out)

    @property
    def _gathers_params(self):
        """The rank holds params as shards (stage 3 across ranks): the
        model reads them through `_param_view`."""
        return any(d is not None for d in self._pdims)

    def _model_params(self):
        """The params as the model reads them: a gathering view of the
        shards at stage 3 across ranks, else the tensors."""
        if self._gathers_params:
            return self._param_view(self.state.params)
        return self.state.params

    def _param_view(self, params):
        return ZeroParamView(params, tree_unflatten(params, self._pdims),
                             self.dp_world_size)

    def _gather_tree(self, tree, dims, keep):
        """A tree of a rank's shards (`dims` in leaf order) -> the whole
        leaves, each gathered on its own into host memory (see
        `gather_to_host`); leaves held whole are the rank's own tensors.
        With `keep` false the rank takes part in each gather and keeps
        nothing."""
        out = [t if d is None else
               gather_to_host(t, d, self.dp_world_size, keep)
               for t, d in zip(tree_leaves(tree), dims)]
        return tree_unflatten(tree, out) if keep else None

    def _full_state(self, root=None):
        """The whole TrainState: each sharded leaf gathered from the ranks'
        shards leaf by leaf, straight into host memory, so the card holds
        one leaf's gather at a time; leaves held whole stay where they
        live. Every rank takes part; with `root` only that data rank keeps
        the gathered state (the others get None)."""
        st = self.state
        keep = root is None or self.dp_rank == root
        nleaves = len(self._sdims)
        opt = None
        if st.opt_state is not None:
            opt = {k: self._gather_tree(v, self._sdims, keep)
                   if len(tree_leaves(v)) == nleaves and not
                   isinstance(v, torch.Tensor) else v
                   for k, v in st.opt_state.items()}
        params = self._gather_tree(st.params, self._pdims, keep)
        master = None if st.master is None \
            else self._gather_tree(st.master, self._sdims, keep)
        if not keep:
            return None
        return st._replace(params=params, master=master, opt_state=opt)

    def state_to_numpy(self):
        """The whole TrainState as numpy trees (fp32 for floating leaves),
        for comparing with the JAX engine leaf by leaf. Across ranks every
        rank takes part and gets the whole (gathered) state."""
        def npy(t):     # a copy: the state is stepped in place
            t = t.detach().cpu()
            return (t.float() if t.is_floating_point() else t).numpy().copy()
        st = self._full_state()
        if self.host_step:
            opt = self.host_optimizer
            master = tree_unflatten(opt.tree, [m.numpy().copy()
                                               for m in opt.master])
            return {"params": tree_map(npy, st.params), "master": master,
                    "opt_state": None,
                    "scaler": {k: npy(v)
                               for k, v in st.scaler._asdict().items()},
                    "step": npy(st.step)}
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
        tree = tree_unflatten(params, leaves)
        if self._gathers_params:
            tree = self._param_view(tree)
        loss, aux = self._loss_fn(tree, micro_batch, self.generator)
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

    def _micro_batches(self, batch, gas):
        """This rank's rows of each of a global batch's `gas` micro-batches,
        as the JAX engine places them on its data shard: after the
        [gas, B / gas] split, chunk `rank` of dp of each micro-batch."""
        n, r = self.dp_world_size, self.dp_rank
        if gas == 1 and n == 1:
            return [batch]

        def take(x):
            if x.shape[0] % (gas * n):
                raise ValueError(
                    f"batch dim {x.shape[0]} not divisible by "
                    f"gradient_accumulation_steps={gas} x data-parallel "
                    f"ranks ({n}): every rank is handed the same global "
                    f"batch")
            m = x.shape[0] // (gas * n)
            return x.reshape(gas, m * n, *x.shape[1:])[:, r * m:(r + 1) * m]
        split = tree_map(take, batch)
        return [tree_map(lambda x: x[i], split) for i in range(gas)]

    def _micro_step_grads(self, params, micro_batch, acc_dtype=None,
                          predivide=1.0):
        """One micro-batch's grad leaves as the step accumulates them (cast
        to `acc_dtype` and divided by the predivide factor when given), the
        stage-2 ones reduce-scattered into the rank's shard; with its loss
        and extras."""
        g, loss, ex = self._micro_grads(params, micro_batch)
        g = tree_leaves(g)
        if acc_dtype is not None:
            g = [x.to(acc_dtype) / predivide for x in g]
        if self.zero_stage == 2:
            idx = [i for i, d in enumerate(self._gdims) if d is not None]
            shards = flat_reduce_scatter([g[i] for i in idx],
                                         [self._gdims[i] for i in idx],
                                         self.dp_world_size)
            for i, sh in zip(idx, shards):
                g[i] = sh
        return g, loss, ex

    def _reduce_across(self, params, acc, loss, extras):
        """Sum the whole grads across ranks (one all-reduce), divide every
        grad by dp, and average the loss and extras (one all-reduce); at
        one rank, the grads' tree as it is."""
        n = self.dp_world_size
        if n == 1:
            return tree_unflatten(params, acc), loss, extras
        idx = [i for i, (d, g) in enumerate(zip(self._gdims, acc))
               if d is None and g.is_floating_point()]
        for i, g in zip(idx, flat_all_reduce([acc[i] for i in idx])):
            acc[i] = g
        grads = tree_unflatten(params, [g / n for g in acc])
        names = sorted(extras)
        avg = coll.psum(torch.stack([loss.float()] + [extras[k].float()
                                                      for k in names]),
                        mesh_mod.ZERO_AXES) / n
        return grads, avg[0], {k: avg[1 + j] for j, k in enumerate(names)}

    def _grads(self, params, batch):
        """The gas loop over this rank's rows: (grads, mean loss, extras).
        At gas > 1 grads accumulate in `grad_accum_dtype` (fp32 by
        default), each divided by the predivide factor, and the sum is
        scaled by predivide / gas; at gas == 1 they stay in the compute
        dtype (the optimizer widens them exactly). The extras are the
        micro-batches' mean. Then `_reduce_across`."""
        gas = self.gradient_accumulation_steps_value
        micros = self._micro_batches(_to_device(batch, self.device), gas)
        if gas == 1:
            return self._reduce_across(
                params, *self._micro_step_grads(params, micros[0]))
        acc_dtype = self.config.data_types.accum_dtype()
        predivide = self.config.gradient_predivide_factor or 1.0
        acc = loss_sum = extras = None
        for micro in micros:
            g, loss, ex = self._micro_step_grads(params, micro, acc_dtype,
                                                 predivide)
            acc = g if acc is None else [a + x for a, x in zip(acc, g)]
            loss = loss.float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            extras = ex if extras is None else {k: extras[k] + v
                                                for k, v in ex.items()}
        acc = [a * (predivide / gas) for a in acc]
        return self._reduce_across(params, acc, loss_sum / gas,
                                   {k: v / gas for k, v in extras.items()})

    def _apply_grads(self, state, grads, loss):
        """(state, grads, mean loss) -> (state, metrics): unscale, the
        global norm and finite check, clip, the optimizer's update of the
        rank's state, the params after it. The grads are this step's own
        and are clipped in place; the params, master and optimizer state
        are stepped in place. Across ranks, the per-leaf squared norms of
        the sharded grads (and, under fp16, their non-finite count) are
        summed in one all-reduce before the clip and the skip decide, and
        the updated params the rank does not hold whole-sharded are
        all-gathered."""
        scaler = self.scaler
        pol, n = self.zero_policy, self.dp_world_size
        grads = scaler.unscale_grads(grads, state.scaler)
        g = tree_leaves(grads)
        sq = [x.float().square().sum() for x in g]
        bad = [(~torch.isfinite(x)).sum().float() for x in g] \
            if scaler.enabled else None
        idx = [i for i, d in enumerate(self._gdims) if d is not None]
        if idx:
            part = [sq[i] for i in idx]
            if bad is not None:
                part.append(sum(bad[i] for i in idx))
            red = coll.psum(torch.stack(part), mesh_mod.ZERO_AXES)
            for j, i in enumerate(idx):
                sq[i] = red[j]
            if bad is not None:
                whole = set(range(len(g))) - set(idx)
                bad = [red[-1]] + [bad[i] for i in sorted(whole)]
        grad_norm = torch.sqrt(sum(sq))
        finite = (sum(bad) == 0) if bad is not None else \
            torch.ones((), dtype=torch.bool, device=self.device)
        clip = self.config.gradient_clipping
        if clip and clip > 0:
            factor = (clip / (grad_norm + 1e-6)).clamp_max(1.0)
            for x in g:
                x.mul_(factor.to(x.dtype))
        upd = [x if gd == sd else pol.shard(x, sd)
               for x, gd, sd in zip(g, self._gdims, self._sdims)]
        target = self._update_target(state)
        kw = {}
        if getattr(self.optimizer, "leaf_norms", False):
            kw["leaf_norms"] = self._leaf_norms
        # the skip-step: under fp16 loss scaling an overflow leaves every
        # stored leaf as it was (a masked update, no host branch); without
        # the scaler the mask is the JAX engine's constant true
        self.optimizer.update(tree_unflatten(grads, upd), state.opt_state,
                              target, finite if scaler.enabled else None,
                              **kw)
        srcs, dims, dsts = [], [], []
        for p, t, pd, sd in zip(tree_leaves(state.params),
                                tree_leaves(target), self._pdims,
                                self._sdims):
            if pd is None and sd is not None:
                srcs.append(t.to(p.dtype).contiguous())
                dims.append(sd)
                dsts.append(p)
            elif self.keep_master:
                p.copy_(t)
        for p, f in zip(dsts, flat_all_gather(srcs, dims, n)):
            p.copy_(f)
        lr = self.schedule_fn(state.step) if self.schedule_fn is not None \
            else 0.0
        metrics = {"loss": loss.float(), "grad_norm": grad_norm.float(),
                   "overflow": ~finite, "loss_scale": state.scaler.scale,
                   "lr": torch.as_tensor(lr, dtype=torch.float32,
                                         device=self.device)}
        return state._replace(scaler=scaler.update(state.scaler, finite),
                              step=state.step + finite.to(torch.int32)), \
            metrics

    def _leaf_norms(self, leaves):
        """Per-leaf L2 norms of the optimizer's leaves (the rank's state
        shards) over the whole leaves: the sharded ones' squares summed
        across ranks (LAMB's trust ratio)."""
        if self.dp_world_size == 1:
            return torch._foreach_norm(leaves)
        sq = [x.float().square().sum() for x in leaves]
        idx = [i for i, d in enumerate(self._sdims) if d is not None]
        if idx:
            red = coll.psum(torch.stack([sq[i] for i in idx]),
                            mesh_mod.ZERO_AXES)
            for j, i in enumerate(idx):
                sq[i] = red[j]
        return [torch.sqrt(x) for x in sq]

    def _state_in(self):
        """The streamed tier: start the copy of the fp32 master and the
        optimizer state from pinned host memory to the card on a side
        stream (after the previous step's copy out). Returns (device
        leaves, event); None when the tier is off or on the CPU.

        The device leaves are allocated on the compute stream, which
        reads them after the copy's event and frees them after the copy
        back, so their blocks go back to the allocator in stream order,
        reusable at once (a side-stream block `record_stream`'d to the
        compute stream is reusable only once the allocator has seen its
        event complete)."""
        if self._state_copy_stream is None:
            return None
        cs = self._state_copy_stream
        host = tree_leaves((self.state.master, self.state.opt_state))
        dev = [torch.empty(h.shape, dtype=h.dtype, device=self.device)
               for h in host]
        cs.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(cs):
            if self._state_out_event is not None:
                cs.wait_event(self._state_out_event)
            for d, h in zip(dev, host):
                d.copy_(h, non_blocking=True)
            event = torch.cuda.Event()
            event.record(cs)
        return dev, event

    def _streamed_apply(self, state, grads, loss, fetched):
        """`_apply_grads` on device copies of the host-resident master and
        optimizer state, then their copy back out, enqueued after the
        update; nothing here waits for the card."""
        dev, event = fetched if fetched is not None else self._state_in()
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(event)
        host = (state.master, state.opt_state)
        dev_master, dev_opt = tree_unflatten(host, dev)
        new, metrics = self._apply_grads(
            state._replace(master=dev_master, opt_state=dev_opt), grads, loss)
        host_leaves = tree_leaves(host)
        for h, d in zip(host_leaves, tree_leaves((new.master,
                                                   new.opt_state))):
            h.copy_(d, non_blocking=True)
        self._state_out_event = torch.cuda.Event()
        self._state_out_event.record(compute)
        return new._replace(master=state.master,
                            opt_state=state.opt_state), metrics

    def _host_apply(self, state, grads, loss):
        """The host step: the card's grads land in one pinned flat, the
        C++ optimizer steps the fp32 master, the params are pushed back."""
        opt = self.host_optimizer
        opt.step(grads)
        opt.push(tree_leaves(state.params))
        metrics = {"loss": loss.float(),
                   "grad_norm": torch.zeros((), device=self.device),
                   "overflow": torch.zeros((), dtype=torch.bool,
                                           device=self.device),
                   "loss_scale": state.scaler.scale,
                   "lr": torch.as_tensor(opt._current_lr(),
                                         dtype=torch.float32,
                                         device=self.device)}
        return state._replace(step=state.step + 1), metrics

    def _step(self, state, grads, loss, fetched=None):
        """The optimizer step of the engine's tier."""
        if self.host_step:
            return self._host_apply(state, grads, loss)
        if self._state_copy_stream is not None:
            return self._streamed_apply(state, grads, loss, fetched)
        return self._apply_grads(state, grads, loss)

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
        batch = self._data_efficiency(batch)
        # the train_batch timer's readers: the breakdown log and telemetry
        timed = self.config.wall_clock_breakdown or self.telemetry.enabled
        self.tput_timer.start()
        if timed:
            self.timers(TRAIN_BATCH_TIMER).start()
        ms = self.memscope
        try:
            if ms is not None:
                ms.begin_step()
            fetched = self._state_in()     # runs beside the micro-batches
            grads, loss, extras = self._grads(self.state.params, batch)
            self.state, metrics = self._step(self.state, grads, loss, fetched)
            if ms is not None:
                ms.end_step()
        except Exception as e:
            # the OOM-forensics boundary: an allocator failure dumps the
            # ledger, the planner delta and the flight ring; the error
            # itself is re-raised
            if ms is not None:
                ms.on_step_error(e)
            raise
        metrics.update(extras)
        if timed:
            self.timers(TRAIN_BATCH_TIMER).stop()   # waits for the card
        self.tput_timer.stop(global_step=True)
        self._after_step(metrics, count_micro=True)
        if self.telemetry.enabled:
            self._record_step_telemetry(batch,
                                        self.timers(TRAIN_BATCH_TIMER).last)
        return metrics["loss"]

    def _data_efficiency(self, batch):
        """The step's seqlen curriculum, then its routing directives, as
        the JAX engine's `train_batch` applies them. Alone, the curriculum
        cuts the batch to the difficulty (`bucketize=(difficulty,)`) where
        the JAX engine masks the labels past it: causal attention makes
        the loss and gradients the same, and the kept T is what the card
        runs. With random-LTD on it masks the labels as JAX does, so that
        the keep count and the kept positions are drawn over the same T."""
        if not isinstance(batch, dict):
            return batch
        if self.curriculum_scheduler is not None and \
                ("tokens" in batch or "input_ids" in batch):
            from deepspeed_tpu_torch.runtime.data_pipeline.curriculum import \
                apply_seqlen_curriculum
            difficulty = self.curriculum_scheduler.update_difficulty(
                self.global_steps)
            cut = None if self.random_ltd_scheduler is not None \
                else (difficulty,)
            batch = apply_seqlen_curriculum(batch, difficulty, bucketize=cut)
        if self.progressive_layer_drop is not None or \
                self.random_ltd_scheduler is not None:
            batch = self._inject_routing_directives(batch)
        return batch

    def _inject_routing_directives(self, batch):
        """Host-side draws for PLD / random-LTD, added to the batch as
        leaves broadcast over its rows (the JAX engine's leaves, shapes,
        dtypes and draw order; their shapes carry the counts):

          pld_keep_idx [B, n_keep] int32 — kept layer ids (the same in
              every row), drawn as rng.random(n_layer) < theta, at least
              one; a HostArray, which stays on the host
          pld_theta    [B] float32       — the step's keep probability
          ltd_keep_idx [B, n_ltd, K] int32 — each row's sorted kept
              positions for each routed layer (the top K of uniform keys)
          ltd_start    [B, start_layer] int8 zeros — the first routed layer,
              carried in the shape
        """
        tokens = batch.get("tokens", batch.get("input_ids"))
        if tokens is None:
            return batch
        B0, width = tokens.shape[0], tokens.shape[1]
        out = dict(batch)
        pld = self.progressive_layer_drop
        if pld is not None:
            pld.update_state(self.global_steps)
            theta = pld.get_theta()
            n_layer = getattr(self.model_spec.arch_cfg, "n_layer", None)
            if not n_layer:
                raise ValueError("progressive_layer_drop needs the model's "
                                 "layer count (ModelSpec.arch_cfg.n_layer)")
            keep = self._pld_rng.random(n_layer) < theta
            if not keep.any():
                keep[self._pld_rng.integers(n_layer)] = True
            idx = np.flatnonzero(keep).astype(np.int32)
            out["pld_keep_idx"] = np.broadcast_to(
                idx[None], (B0, idx.size)).copy().view(HostArray)
            out["pld_theta"] = np.full((B0,), theta, np.float32)
        sched = self.random_ltd_scheduler
        if sched is not None:
            T_in = width - (0 if batch.get("labels") is not None else 1)
            K = sched.keep_count(self.global_steps, T_in)
            lo, hi = sched.start_layer, sched.end_layer
            n_ltd = hi - lo + 1
            if K < T_in and n_ltd > 0:
                r = self._ltd_rng.random((B0, n_ltd, T_in))
                out["ltd_keep_idx"] = np.sort(
                    np.argpartition(r, K - 1, axis=-1)[..., :K],
                    axis=-1).astype(np.int32)
                out["ltd_start"] = np.zeros((B0, lo), np.int8)
        return out

    def eval_batch(self, batch, rng=None):
        with torch.no_grad():
            loss, _ = self._loss_fn(self._model_params(),
                                    _to_device(batch, self.device),
                                    rng if rng is not None else self.generator)
        return loss

    # --- forward/backward/step: the reference engine's triplet. forward
    # computes the loss AND the micro-batch grads (fp32), backward
    # accumulates them, step applies their mean at the gas boundary.

    def forward(self, batch):
        # the rank's rows of the micro-batch (micro x dp rows)
        batch = self._micro_batches(_to_device(batch, self.device), 1)[0]
        g, loss, _ = self._micro_step_grads(self.state.params, batch,
                                            torch.float32)
        self._forward_cache = (tree_unflatten(self.state.params, g), loss)
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
        loss = self._loss_acc / n
        grads, loss, _ = self._reduce_across(
            self.state.params, tree_leaves(grads), loss, {})
        self.state, metrics = self._step(self.state, grads, loss)
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
        if self.config.memory_breakdown and \
                self.global_steps % self.config.steps_per_print == 0:
            # the reference's memory_breakdown knob: the allocator's
            # reading, routed through the registry too
            from deepspeed_tpu_torch.utils.memory import see_memory_usage
            see_memory_usage(f"step {self.global_steps}", force=True,
                             device=self.device, telemetry=self.telemetry)
        if self._sentinel.enabled:
            overflow = self.fp16_enabled and bool(metrics["overflow"])
            cause = self._sentinel.observe(float(metrics["loss"]), overflow)
            if cause is not None:
                self._recover_bad_state(cause)

    def _recover_bad_state(self, cause):
        """Persistent bad state past the masked skip-step: roll back to the
        last good checkpoint in-process when configured (and possible),
        else raise BadStateError for a supervisor to classify and restart
        on."""
        ft = self.config.fault_tolerance
        detail = self._sentinel.describe(cause)
        target = self._last_ckpt_dir
        # the black box first, while the bad state is still in place
        self.telemetry.flightrec.dump(
            f"bad-state sentinel: {cause}",
            state={"step": self.global_steps, "cause": cause,
                   "detail": detail, "rollbacks": self.rollbacks,
                   "rollback_target": str(target),
                   "watchdog": self.telemetry.watchdog.summary()})
        if ft.auto_rollback and target is not None \
                and self.rollbacks < ft.max_rollbacks:
            logger.warning(f"bad state at step {self.global_steps} "
                           f"({detail}); rolling back to the last good "
                           f"checkpoint in {target}")
            path, _client = self.load_checkpoint(target)
            if path is not None:
                self.rollbacks += 1
                self._sentinel.reset()
                self._fast_forward_data()
                events = [
                    ("Recovery/rollbacks_total", float(self.rollbacks),
                     self.global_steps),
                    ("Recovery/last_good_step", float(self.global_steps),
                     self.global_steps),
                ]
                self.telemetry.record_events(events)
                if self.monitor is not None and self.monitor.enabled:
                    from deepspeed_tpu_torch.monitor.monitor import \
                        write_recovery_events
                    write_recovery_events(self.monitor, events)
                log_dist(f"rollback #{self.rollbacks} complete: resumed at "
                         f"step {self.global_steps} (cause: {cause})",
                         ranks=[0])
                return
            logger.error(f"rollback target {target} had no loadable "
                         f"checkpoint")
        raise BadStateError(cause, f"unrecoverable training state: {detail} "
                                   f"(rollbacks used: {self.rollbacks})")

    def _fast_forward_data(self):
        """Re-align the training dataloader with the restored step after
        an in-process rollback: it shuffles per epoch from (seed + epoch),
        so rewinding its epoch to the restored step's and skipping
        `restored_step % len` batches replays the exact position."""
        if self.training_dataloader is None:
            return
        if hasattr(self.training_dataloader, "load_state_dict"):
            return  # position restored from client_state by load_checkpoint
        n = len(self.training_dataloader)
        if n > 0 and hasattr(self.training_dataloader, "epoch"):
            # set BEFORE iter(): __iter__ consumes-then-increments it
            self.training_dataloader.epoch = self.global_steps // n
        self._data_iterator = iter(RepeatingLoader(self.training_dataloader))
        if n > 0:
            for _ in range(self.global_steps % n):
                next(self._data_iterator)

    # ------------------------------------------------------------------
    # checkpointing (checkpoint/saver.py)
    # ------------------------------------------------------------------

    @property
    def checkpoint_device(self):
        return self.device

    def _optax_layout(self):
        """(optimizer, has_schedule) naming the optimizer state as the JAX
        package's optax tree, or None for an optimizer the config does not
        name (its own state names are kept)."""
        opt = self.config.optimizer
        if opt is None:
            return None
        name = opt.type.lower()
        return OPTIMIZER_ALIASES.get(name, name), self.schedule_fn is not None

    _HOST_MOMENTS = {"adam": (("exp_avg", "mu"), ("exp_avg_sq", "nu")),
                     "lion": (("exp_avg", "mu"),),
                     "adagrad": (("exp_avg", "sum_of_squares"),)}

    def _host_trees(self):
        """The host step's fp32 master and optimizer state as trees in
        the device tier's names (`count`, `mu`, `nu`, ...)."""
        opt = self.host_optimizer
        sd = opt.state_dict()
        state = {"count": torch.tensor(int(sd["step"]), dtype=torch.int32)}
        for src, dst in self._HOST_MOMENTS[opt.optimizer]:
            state[dst] = tree_unflatten(opt.tree, sd[src])
        return tree_unflatten(opt.tree, sd["master"]), state

    def checkpoint_leaves(self, root=None):
        """[(name, tensor)] of the whole training state under the JAX
        package's checkpoint names (the saver writes these). Across ranks
        every rank takes part in gathering the sharded leaves into host
        memory (`_full_state`); with `root` only that rank gets the leaves
        (the others None)."""
        if self.device.type == "cuda":
            # the streamed tier's copies out and the host step's pushes
            # land asynchronously
            torch.cuda.synchronize(self.device)
        st = self._full_state(root)
        return None if st is None else self._named_state(st)

    def _named_state(self, st):
        master, opt_state = self._host_trees() if self.host_step \
            else (st.master, st.opt_state)
        out = named_leaves(st.params, ("params",)) + \
            named_leaves(master, ("master",))
        layout = self._optax_layout()
        opt = named_leaves(opt_state)
        out += [("opt_state/" + n, v) for n, v in opt] if layout is None \
            else optax_opt_leaves(opt, *layout)
        return out + named_leaves(st.scaler, ("scaler",)) + \
            [("step", st.step)]

    def restore_checkpoint_leaves(self, named, prefixes=None):
        """Copy a loaded checkpoint ({name: tensor or array}) into the
        engine's own tensors, leaf by leaf; `prefixes` limits a partial
        load. An optimizer count the checkpoint lacks (optax keeps none
        for constant-rate SGD / Adagrad) is the step."""
        def wanted(name):
            return prefixes is None or any(
                name == p or name.startswith(p + "/") for p in prefixes)

        count = optax_count(named)
        if count is None:
            count = named.get("step")

        def source(name):
            if name in named:
                return named[name]
            if name.startswith("opt_state/") and name.endswith("count") \
                    and count is not None:
                return count
            raise KeyError(f"checkpoint has no leaf '{name}'")

        leaves = self._named_state(self.state)
        if self.host_step:
            self._restore_host_step(leaves, source, wanted)
            leaves = [(n, v) for n, v in leaves
                      if not n.startswith(("master/", "opt_state/"))]
        for name, dst in leaves:
            if wanted(name):
                dst.copy_(_as_tensor(source(name), dst, name,
                                     self.dp_world_size, self.dp_rank))

    def _restore_host_step(self, leaves, source, wanted):
        opt = self.host_optimizer
        if not wanted("master"):
            return
        masters = [_as_tensor(source(n), v, n) for n, v in leaves
                   if n.startswith("master/")]
        sd = {"step": opt.step_count, "master": masters}
        if wanted("opt_state"):
            sd["step"] = int(_as_tensor(
                source("opt_state/0/count"), torch.zeros((), dtype=torch.int32),
                "opt_state/0/count"))
            for src, dst in self._HOST_MOMENTS[opt.optimizer]:
                pre = f"opt_state/0/{dst}/"
                sd[src] = [_as_tensor(source(n), v, n) for n, v in leaves
                           if n.startswith(pre)]
        opt.load_state_dict(sd)

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True, exclude_frozen_parameters=False):
        from deepspeed_tpu_torch.checkpoint.saver import save_checkpoint
        client_state = dict(client_state or {})
        client_state.update({
            "global_steps": self.global_steps,
            "skipped_steps": self.skipped_steps,
            "lr_scheduler": self.lr_scheduler.state_dict()
            if self.lr_scheduler else None,
        })
        if hasattr(self.training_dataloader, "state_dict"):
            client_state["data_sampler"] = \
                self.training_dataloader.state_dict()
        return save_checkpoint(self, save_dir, tag=tag,
                               client_state=client_state,
                               save_latest=save_latest)

    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True,
                        load_module_only=False):
        from deepspeed_tpu_torch.checkpoint.saver import load_checkpoint
        path, client_state = load_checkpoint(
            self, load_dir, tag=tag,
            load_optimizer_states=load_optimizer_states,
            load_module_only=load_module_only)
        if client_state:
            self.global_steps = client_state.get("global_steps",
                                                 self.global_steps)
            self.skipped_steps = client_state.get("skipped_steps",
                                                  self.skipped_steps)
            sd = client_state.get("lr_scheduler")
            if sd and self.lr_scheduler is not None and \
                    load_lr_scheduler_states:
                self.lr_scheduler.load_state_dict(sd)
            dsd = client_state.get("data_sampler")
            if dsd and hasattr(self.training_dataloader, "load_state_dict"):
                self.training_dataloader.load_state_dict(dsd)
        if path is not None:
            self._sentinel.reset()   # restored state gets fresh budgets
        return path, client_state

    def get_fp32_state_dict(self):
        """The fp32 weights as a tree of host tensors (the master where
        one is kept — the host step's too — else the params), copies."""
        if self.host_step:
            opt = self.host_optimizer
            source = tree_unflatten(opt.tree, opt.master)
        else:
            st = self._full_state()
            source = st.master if self.keep_master else st.params
        return tree_map(lambda t: t.detach().to("cpu", torch.float32,
                                                copy=True), source)

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
            # the whole world's tokens over its ranks: per chip, as JAX's
            self._program_flops = 6.0 * self.num_params * tokens \
                / self.dp_world_size if tokens else 0.0
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
            if self.memscope is not None:
                # memscope resets the allocator's peak every step: the
                # run's peak is the ledger's
                reg.gauge("train/hbm_peak_bytes").set(
                    float(self.memscope.peak_bytes()))
        if self.memscope is not None:
            self.memscope.publish()     # the mem/* ledger gauges
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
    from deepspeed_tpu_torch.inference.zero_inference import LayeredModelSpec
    if isinstance(model, LayeredModelSpec):
        return _initialize_infinity(model, TpuTrainConfig.load(config),
                                    optimizer, lr_scheduler,
                                    model_parameters, training_data,
                                    collate_fn, device)
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


def _initialize_infinity(model, cfg, optimizer, lr_scheduler,
                         model_parameters, training_data, collate_fn, device):
    """ZeRO-Infinity parameter spill in training: a LayeredModelSpec trains
    on the layer-streaming InfinityEngine, built from the config. The JAX
    engine's asserts are ValueErrors here."""
    off = cfg.zero_optimization.offload_param
    if off is None or off.device not in ("cpu", "nvme"):
        raise ValueError("a LayeredModelSpec trains via the Infinity tier: "
                         "set zero_optimization.offload_param.device to "
                         "'cpu' or 'nvme'")
    if optimizer is not None or lr_scheduler is not None:
        raise ValueError("the Infinity tier builds its host optimizers from "
                         "the config (optimizer/scheduler blocks); passing "
                         "objects is not supported")
    if model_parameters is not None:
        raise ValueError("Infinity tier: the LayeredModelSpec carries its own "
                         "params (resident + blocks); model_parameters is not "
                         "honored")
    if mesh_mod.process_world_size() > 1:
        not_ported("the Infinity tier across ranks", item="9")
    _, mbs, gas = cfg.resolve_batch_sizes(1)
    from deepspeed_tpu_torch.runtime.infinity import InfinityEngine
    opt_off = cfg.zero_optimization.offload_optimizer
    host_opt, adamw_mode = host_optimizer_kind(
        cfg.optimizer.type if cfg.optimizer else "adamw")
    opt_cfg = cfg.optimizer.params if cfg.optimizer else {}
    fp16 = cfg.fp16
    engine = InfinityEngine(
        model, lr=opt_cfg.get("lr", 1e-3),
        betas=tuple(opt_cfg.get("betas", (0.9, 0.999))),
        eps=opt_cfg.get("eps", 1e-8),
        weight_decay=opt_cfg.get("weight_decay", 0.0),
        dtype=cfg.compute_dtype(), offload_device=off.device,
        nvme_path=off.nvme_path,
        optimizer_nvme_path=(opt_off.nvme_path if opt_off is not None
                             and opt_off.device == "nvme" else None),
        optimizer=host_opt, adamw_mode=adamw_mode,
        lr_schedule=lr_schedules.build_schedule(cfg.scheduler),
        micro_batch_size=mbs, gradient_accumulation_steps=gas,
        gradient_clipping=cfg.gradient_clipping,
        training_data=training_data, collate_fn=collate_fn, seed=cfg.seed,
        fp16=cfg.fp16_enabled,
        static_loss_scale=(None if fp16.dynamic else fp16.loss_scale)
        if cfg.fp16_enabled else None,
        initial_scale_power=fp16.initial_scale_power,
        loss_scale_window=fp16.loss_scale_window,
        min_loss_scale=fp16.min_loss_scale, hysteresis=fp16.hysteresis,
        consecutive_hysteresis=fp16.consecutive_hysteresis,
        lookahead=int(1 if off.lookahead is None else off.lookahead),
        telemetry=cfg.telemetry, checkpoint=cfg.checkpoint, device=device)
    return engine, None, engine.training_dataloader, None
