"""Typed configuration (counterpart of `deepspeed_tpu/config/core.py`).

`ConfigModel` builds dataclasses from dicts with unknown-key warnings and
recursive nesting. `TpuTrainConfig` is the training root config: the same
JSON as the JAX package's (the batch triad with "auto" resolution, fp16 /
bf16, optimizer, scheduler, ZeRO stage, gradient clipping, the gradient
accumulator dtype, activation checkpointing). A feature of that config the
port does not carry yet raises `NotImplementedError` when the config is
built: offload, ZeRO++ / compressed wires, a mesh of more than one rank,
pipeline, MoE, checkpointing and fault tolerance, curriculum and data
efficiency, compression, progressive layer drop and the profilers. The
`telemetry` block and the monitors (`tensorboard`, `wandb`, `csv_monitor`)
are ported; the telemetry block's request tracing, flight recorder and
memscope are not.
"""

import copy
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Union

import torch

from deepspeed_tpu_torch.utils.logging import logger

AUTO = "auto"


def _is_auto(v):
    return isinstance(v, str) and v == AUTO


def issubclass_safe(t, parent):
    try:
        return issubclass(t, parent)
    except TypeError:
        return False


class ConfigModel:
    """Base for config blocks, mirroring `DeepSpeedConfigModel`."""

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]], path=""):
        d = dict(d or {})
        kwargs = {}
        field_map = {f.name: f for f in dataclasses.fields(cls)}
        for key, value in d.items():
            if key not in field_map:
                logger.warning(f"Config: unknown key '{path}{key}' ignored")
                continue
            ftype = field_map[key].type
            if isinstance(value, dict) and isinstance(ftype, type) \
                    and issubclass_safe(ftype, ConfigModel):
                value = ftype.from_dict(value, path=f"{path}{key}.")
            kwargs[key] = value
        return cls(**kwargs)


def not_ported(what):
    raise NotImplementedError(
        f"{what} is not ported to deepspeed_tpu_torch yet (the JAX package "
        f"deepspeed_tpu serves it)")


def _as_block(value, cls):
    return cls.from_dict(value) if isinstance(value, dict) else value


@dataclass
class ZeroConfig(ConfigModel):
    """`zero_optimization`. At one rank stages 0-3 are one computation (as
    on the JAX package's one-device mesh); the knobs that only shape
    collectives are accepted and have nothing to act on."""
    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = 5 * 10**8
    allgather_partitions: bool = True
    allgather_bucket_size: int = 5 * 10**8
    overlap_comm: bool = True
    offload_param: Optional[Dict[str, Any]] = None
    offload_optimizer: Optional[Dict[str, Any]] = None
    sub_group_size: int = 10**9
    stage3_max_live_parameters: int = 10**9
    stage3_max_reuse_distance: int = 10**9
    stage3_prefetch_bucket_size: int = 5 * 10**7
    stage3_param_persistence_threshold: int = 10**5
    stage3_gather_16bit_weights_on_model_save: bool = False
    round_robin_gradients: bool = False
    zero_hpz_partition_size: int = 1
    zero_quantized_weights: bool = False
    zero_quantized_gradients: bool = False
    explicit_grad_reduce: bool = False
    onebit_gradients: bool = False
    compressed_comm_axis: Optional[str] = None
    mics_shard_size: int = -1
    mics_hierarchical_params_gather: bool = False
    ignore_unused_parameters: bool = True
    param_persistence_threshold: Optional[int] = None

    def __post_init__(self):
        if not 0 <= int(self.stage) <= 3:
            raise ValueError(f"zero_optimization.stage must be 0-3, got "
                             f"{self.stage}")
        for name in ("offload_param", "offload_optimizer"):
            block = getattr(self, name) or {}
            if str(block.get("device", "none")) != "none":
                not_ported(f"zero_optimization.{name}")
        for name in ("zero_quantized_weights", "zero_quantized_gradients",
                     "explicit_grad_reduce", "onebit_gradients"):
            if getattr(self, name):
                not_ported(f"zero_optimization.{name}")
        if int(self.mics_shard_size) > 0 or int(self.zero_hpz_partition_size) > 1:
            not_ported("zero_optimization MiCS / hpZ sub-group sharding")


@dataclass
class Fp16Config(ConfigModel):
    enabled: Union[bool, str] = False
    auto_cast: bool = False
    loss_scale: float = 0.0          # 0 => dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0

    @property
    def dynamic(self):
        return self.loss_scale == 0


@dataclass
class Bf16Config(ConfigModel):
    enabled: Union[bool, str] = False
    # fp32 master weights (False: the optimizer updates the bf16 params)
    master_weights: bool = True


@dataclass
class OptimizerConfig(ConfigModel):
    type: str = "AdamW"
    params: Dict[str, Any] = field(default_factory=dict)
    legacy_fusion: bool = False

    def __post_init__(self):
        if self.type.lower() in ("onebitadam", "zerooneadam", "onebitlamb"):
            not_ported(f"the {self.type} optimizer (compressed communication)")


@dataclass
class SchedulerConfig(ConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)


@dataclass
class MeshConfig(ConfigModel):
    """Logical mesh axis sizes. This port trains on one rank: every axis
    must be 1 (-1, "the remaining devices", is 1 here)."""
    data: int = -1
    zero: int = 1
    tensor: int = 1
    pipe: int = 1
    sequence: int = 1
    expert: int = 1
    devices: Optional[int] = None

    def __post_init__(self):
        sizes = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        big = {k: v for k, v in sizes.items() if v is not None and int(v) > 1}
        if big:
            not_ported(f"a mesh of more than one rank ({big})")


@dataclass
class ActivationCheckpointingConfig(ConfigModel):
    """Accepted for config compatibility; remat itself is the model's
    (`GPTConfig.remat`), as in the JAX package."""
    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False
    policy: str = "full"

    def __post_init__(self):
        for name in ("partition_activations", "cpu_checkpointing",
                     "contiguous_memory_optimization"):
            if getattr(self, name):
                not_ported(f"activation_checkpointing.{name}")


# dtype names of the config (grad_accum_dtype, param_dtype)
GRAD_ACCUM_DTYPES = {"fp32": torch.float32, "float32": torch.float32,
                     "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
                     "fp16": torch.float16, "float16": torch.float16}


@dataclass
class DataTypesConfig(ConfigModel):
    """The gradient accumulator dtype for gas > 1 (fp32 by default)."""
    grad_accum_dtype: Optional[str] = None

    def __post_init__(self):
        name = (self.grad_accum_dtype or "fp32").lower()
        if name not in GRAD_ACCUM_DTYPES:
            raise ValueError(f"unknown data_types.grad_accum_dtype "
                             f"{self.grad_accum_dtype!r}")

    def accum_dtype(self):
        return GRAD_ACCUM_DTYPES[(self.grad_accum_dtype or "fp32").lower()]


# telemetry features of the JAX package that this port does not carry yet
_UNPORTED_TELEMETRY = ("tracing", "flight_recorder", "memscope")


@dataclass
class TelemetryConfig(ConfigModel):
    """Unified telemetry (`telemetry/`): metrics registry + exporters +
    spans, the JAX package's fields and defaults. Opt-in: when disabled
    (default) the instrumented subsystems record nothing and no file is
    written. Shared by the train config and `TpuInferenceConfig`. There is
    no compiled program to cost-analyze: the MFU numerator is always the
    analytic 6N model flops, whatever `measure_program_flops` says.
    `tracing`, `flight_recorder` and `memscope` raise (ROADMAP queue 1
    item 10); their sizing fields are accepted and unused."""
    enabled: bool = False
    output_path: str = "telemetry"   # dir for <subsystem>.prom/.jsonl/.trace.json
    export_interval: int = 20        # steps between exports (scheduler
                                     # iterations for serving, optimizer steps
                                     # for training)
    prometheus: bool = True          # text-exposition file (atomic rewrite)
    jsonl: bool = True               # append-only log
    monitor_bridge: bool = True      # flatten snapshots into MonitorMaster
                                     # scalars so TB/WandB/CSV keep working
    chrome_trace: bool = False       # host-side span timeline (Perfetto)
    peak_tflops: float = 0.0         # per-device peak override for MFU
                                     # (TFLOPs); 0 = the NVIDIA table in
                                     # telemetry/__init__.py
    measure_program_flops: bool = True  # accepted; the numerator is 6N
    tracing: bool = False
    flight_recorder: bool = False
    flight_recorder_events: int = 256
    memscope: bool = False
    memscope_programs: bool = True
    memscope_capacity_bytes: int = 0
    memscope_preflight: str = "warn"

    def __post_init__(self):
        for name in _UNPORTED_TELEMETRY:
            if getattr(self, name):
                raise NotImplementedError(
                    f"telemetry.{name} is not ported to deepspeed_tpu_torch "
                    f"yet (ROADMAP queue 1 item 10; the JAX package "
                    f"deepspeed_tpu serves it)")


@dataclass
class TensorBoardConfig(ConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedTPUJob"


@dataclass
class WandbConfig(ConfigModel):
    enabled: bool = False
    group: Optional[str] = None
    team: Optional[str] = None
    project: str = "deepspeed_tpu"


@dataclass
class CsvConfig(ConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedTPUJob"


# blocks of the JAX config that this port refuses when they are switched
# on (an "enabled" flag), or given at all (the others)
_UNPORTED_ENABLED = ("fault_tolerance", "moe", "data_efficiency",
                     "progressive_layer_drop", "flops_profiler", "eigenvalue",
                     "comms_logger", "gradient_compression", "autotuning",
                     "elasticity", "curriculum_learning")
_UNPORTED_CONTENT = ("pipeline", "compression_training", "checkpoint")
_UNPORTED_FLAGS = ("sparse_gradients", "prescale_gradients",
                   "memory_breakdown", "dump_state",
                   "zero_force_ds_cpu_optimizer")


def _refuse_unported(d):
    """Raise for a switched-on unported feature; drop the switched-off
    blocks. Returns the remaining dict."""
    d = dict(d)
    for key in _UNPORTED_ENABLED:
        block = d.pop(key, None)
        if isinstance(block, dict) and block.get("enabled"):
            not_ported(f"the {key!r} block")
    for key in _UNPORTED_CONTENT:
        if d.pop(key, None):
            not_ported(f"the {key!r} block")
    for key in _UNPORTED_FLAGS:
        if d.pop(key, False):
            not_ported(key)
    return d


@dataclass
class TpuTrainConfig(ConfigModel):
    """Training root config (the JAX package's `TpuTrainConfig`, the
    reference's `DeepSpeedConfig`)."""

    train_batch_size: Union[int, str, None] = None
    train_micro_batch_size_per_gpu: Union[int, str, None] = None
    gradient_accumulation_steps: Union[int, str, None] = None

    optimizer: Optional[OptimizerConfig] = None
    scheduler: Optional[SchedulerConfig] = None

    fp16: Fp16Config = field(default_factory=Fp16Config)
    bf16: Bf16Config = field(default_factory=Bf16Config)
    zero_optimization: ZeroConfig = field(default_factory=ZeroConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    activation_checkpointing: ActivationCheckpointingConfig = field(
        default_factory=ActivationCheckpointingConfig)
    data_types: DataTypesConfig = field(default_factory=DataTypesConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    tensorboard: TensorBoardConfig = field(default_factory=TensorBoardConfig)
    wandb: WandbConfig = field(default_factory=WandbConfig)
    csv_monitor: CsvConfig = field(default_factory=CsvConfig)

    gradient_clipping: float = 0.0
    gradient_predivide_factor: float = 1.0
    steps_per_print: int = 10
    wall_clock_breakdown: bool = False
    seed: int = 1234
    param_dtype: str = AUTO          # resolved from the fp16/bf16 blocks

    def __post_init__(self):
        self.optimizer = _as_block(self.optimizer, OptimizerConfig)
        self.scheduler = _as_block(self.scheduler, SchedulerConfig)
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, dict) and issubclass_safe(f.type, ConfigModel):
                setattr(self, f.name, f.type.from_dict(v, path=f.name + "."))

    @classmethod
    def from_dict(cls, d, path=""):
        d = dict(d or {})
        if "dstpu_tune" in d:
            not_ported("loading a dstpu_tune artifact")
        return super().from_dict(_refuse_unported(d), path=path)

    @classmethod
    def load(cls, config):
        """A dict, a JSON file's path, or a TpuTrainConfig."""
        if config is None:
            config = {}
        if isinstance(config, TpuTrainConfig):
            return config
        if isinstance(config, str):
            with open(config) as f:
                config = json.load(f)
        if not isinstance(config, dict):
            raise TypeError(f"config must be a dict, a path or a "
                            f"TpuTrainConfig, got {type(config)}")
        return cls.from_dict(copy.deepcopy(config))

    def resolve_batch_sizes(self, dp_world_size: int):
        """Resolve the (global, micro, gas) triad for the data-parallel
        world size: any two determine the third; one given takes the others
        as 1; none given means micro 1, gas 1."""
        tb, mb, gas = (None if _is_auto(v) else v for v in (
            self.train_batch_size, self.train_micro_batch_size_per_gpu,
            self.gradient_accumulation_steps))
        if tb is not None and mb is not None and gas is not None:
            pass
        elif tb is not None and mb is not None:
            gas = tb // (mb * dp_world_size)
        elif tb is not None and gas is not None:
            mb = tb // (gas * dp_world_size)
        elif mb is not None and gas is not None:
            tb = mb * gas * dp_world_size
        elif tb is not None:
            gas, mb = 1, tb // dp_world_size
        elif mb is not None:
            gas, tb = 1, mb * dp_world_size
        else:
            mb, gas, tb = 1, 1, dp_world_size
        if tb != mb * gas * dp_world_size:
            raise ValueError(
                f"batch size triad inconsistent: train_batch_size={tb} != "
                f"micro({mb}) * gas({gas}) * dp_world({dp_world_size})")
        if not (tb > 0 and mb > 0 and gas > 0):
            raise ValueError(f"batch sizes must be positive, got "
                             f"({tb}, {mb}, {gas})")
        self.train_batch_size = int(tb)
        self.train_micro_batch_size_per_gpu = int(mb)
        self.gradient_accumulation_steps = int(gas)
        return self.train_batch_size, self.train_micro_batch_size_per_gpu, \
            self.gradient_accumulation_steps

    @property
    def fp16_enabled(self):
        return bool(self.fp16.enabled) and self.fp16.enabled != AUTO

    @property
    def bf16_enabled(self):
        return bool(self.bf16.enabled) and self.bf16.enabled != AUTO

    def compute_dtype(self):
        if self.fp16_enabled:
            return torch.float16
        if self.bf16_enabled:
            return torch.bfloat16
        if self.param_dtype not in (AUTO, None):
            return GRAD_ACCUM_DTYPES[str(self.param_dtype).lower()]
        return torch.float32
