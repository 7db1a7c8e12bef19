"""Inference config (counterpart of `deepspeed_tpu/inference/config.py`).

The JAX package's config dicts parse here. Keys of the fields its engine
never reads (`max_tokens`, `min_out_tokens`, `checkpoint`, ...) are logged
as unknown and dropped. A feature this port does not carry yet raises
`NotImplementedError` when the config is built — it is never silently
ignored. Those checks run in `__post_init__`, so they hold for
`from_dict`, direct construction and `dataclasses.replace` alike.
"""

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from deepspeed_tpu_torch.config.core import ConfigModel, TelemetryConfig
from deepspeed_tpu_torch.config.core import not_ported as _not_ported


def _as_block(value, cls):
    return cls.from_dict(value) if isinstance(value, dict) else value


@dataclass
class QuantConfig(ConfigModel):
    """Weight-only quantization at engine build (`enable_weight_quant`)."""
    enabled: bool = False
    bits: int = 8
    group_size: int = 64


@dataclass
class TensorParallelConfig(ConfigModel):
    tp_size: int = 1
    enabled: bool = True

    def __post_init__(self):
        if int(self.tp_size) > 1:
            _not_ported(f"tensor_parallel.tp_size={self.tp_size}")


@dataclass
class SpecDecodeConfig(ConfigModel):
    """Speculative decoding (`inference/spec_decode.py`): a drafter
    proposes `draft_k` tokens a slot, one verify call scores them for every
    slot, and the longest agreeing prefix plus one bonus token is emitted.
    Greedy output is token-identical to the decode step's."""
    drafter: str = "off"          # "off" | "ngram" (prompt lookup) |
                                  # "model" (a draft DecodeModelSpec passed
                                  # to `engine.serving(draft_spec=...)`)
    draft_k: int = 4              # drafts proposed and verified a step
    ngram_max: int = 4            # longest / shortest suffix n-gram the
    ngram_min: int = 1            # prompt-lookup drafter tries


@dataclass
class ServingQuantizationConfig(ConfigModel):
    """Quantized serving (validated by the serving engine when it builds)."""
    kv_cache_dtype: str = ""      # "" = inherit the engine's kv_cache_dtype;
                                  # "int8" = the quantized paged pool
    kv_group_size: int = 0        # int8 pool scale group; 0 = head_dim
    weights: str = "off"          # "off" | "int8" | "int4"
    weight_group_size: int = 64


@dataclass
class DegradationConfig(ConfigModel):
    """The graceful-degradation ladder (`serving/degradation.py`): every
    `eval_interval` syncs a `PressureController` reads the free-block
    fraction, the queue depth, (with telemetry) TTFT p99 and (with
    `headroom_low` and the memscope ledger) the device-memory headroom, and
    walks one rung a pressured evaluation — 1 cap the accepted draft to 1, 2 disable
    spec decode, 3 force the 1-step decode window, 4 flush the reclaimable
    prefix-cache blocks, 5 shed queued requests below
    `shed_below_priority` — and one rung down after `hold_steps`
    consecutive calm evaluations. Disabled, no controller is built."""
    enabled: bool = False
    eval_interval: int = 4        # scheduler syncs between evaluations
    free_block_low: float = 0.10  # available/capacity below this: pressure
    free_block_high: float = 0.30 # ... at/above this: calm
    queue_high: int = 16          # queue depth over this: pressure
    queue_low: int = 2            # ... at/below this: calm
    ttft_p99_ms: float = 0.0      # TTFT p99 over this: pressure (0 = off;
                                  # needs telemetry for the histogram)
    hold_steps: int = 3           # consecutive calm evals a rung down
    shed_below_priority: int = 0  # level 5 sheds queued requests with
                                  # Request.priority strictly below this
    headroom_low: float = 0.0     # mem/headroom_frac (telemetry/memscope.py
                                  # ledger) below this counts as pressure;
                                  # needs telemetry.memscope + a known
                                  # capacity (0 = off)
    headroom_high: float = 0.0    # ...and at/above this counts as calm
                                  # (clamped up to headroom_low)


@dataclass
class ServingConfig(ConfigModel):
    """Continuous-batching serving engine (`inference/scheduler.py`)."""
    max_slots: int = 8            # decode batch slots
    max_context: int = 0          # per-sequence cap (prompt + generated);
                                  # 0 = the engine's max_out_tokens
    num_kv_blocks: int = 0        # physical pool blocks incl. the trash
                                  # block; 0 = max_slots * nb + 1
    prefill_chunk: int = 0        # chunked-prefill width; 0 = kv_block_size
    prefill_chunks_per_step: int = 1
    decode_steps_per_sync: int = 1  # decode window: tokens per host sync
    enable_prefix_caching: bool = False  # automatic prefix caching
                                  # (inference/prefix_cache.py)
    spec_decode: SpecDecodeConfig = field(default_factory=SpecDecodeConfig)
                                  # replaces the decode window when on
    audit_interval: int = 0       # run the pool auditor (inference/
                                  # audit.py) every N syncs; 0 = on demand
                                  # and at close() only
    audit_action: str = "repair"  # on a failed audit: "repair" rebuilds
                                  # the bookkeeping from the slot tables;
                                  # "raise" raises PoolCorruptionError
    degradation: DegradationConfig = field(default_factory=DegradationConfig)
    quantization: ServingQuantizationConfig = field(
        default_factory=ServingQuantizationConfig)
    prefix_cache_policy: str = "lru"  # a cached block's last reader
                                  # retires: "lru" parks it on the
                                  # reclaimable list, "none" frees it

    def __post_init__(self):
        # `engine.serving(spec_decode={...})`-style overrides arrive as dicts
        self.spec_decode = _as_block(self.spec_decode, SpecDecodeConfig)
        self.degradation = _as_block(self.degradation, DegradationConfig)
        self.quantization = _as_block(self.quantization,
                                      ServingQuantizationConfig)


@dataclass
class TpuInferenceConfig(ConfigModel):
    dtype: str = "bfloat16"
    tensor_parallel: TensorParallelConfig = field(
        default_factory=TensorParallelConfig)
    max_out_tokens: int = 1024
    quant: QuantConfig = field(default_factory=QuantConfig)
    # decoding
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    greedy: bool = True
    eos_token_id: Optional[int] = None
    # kv cache: the port keeps K/V in the engine dtype, or "int8" for the
    # serving pool (see InferenceEngine)
    kv_cache_dtype: str = "bfloat16"
    # contiguous caches round up to whole kv_block_size blocks, and the
    # paged pool's physical block is this size. 512 is the JAX package's
    # TPU-measured default; the H100's best value is not measured yet
    kv_block_size: int = 512
    serving: ServingConfig = field(default_factory=ServingConfig)
    # unified telemetry (telemetry/): the serving engine's TTFT / TPOT /
    # queue-wait / e2e histograms, pool gauges and phase spans
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    zero: Dict[str, Any] = field(default_factory=dict)

    _LEGACY_DTYPES = {"fp16": "float16", "half": "float16", "bf16": "bfloat16",
                      "fp32": "float32", "float": "float32",
                      "torch.float16": "float16", "torch.bfloat16": "bfloat16",
                      "torch.float32": "float32"}

    def __post_init__(self):
        self.telemetry = _as_block(self.telemetry, TelemetryConfig)

    @classmethod
    def from_dict(cls, d, path=""):
        """Accept the reference's legacy kwargs: `mp_size` (the deprecated
        tensor-parallel degree), torch-style dtype spellings and the retired
        `replace_method` knob."""
        d = dict(d or {})
        if "dstpu_tune" in d:
            _not_ported("loading a dstpu_tune artifact")
        if "mp_size" in d:
            tp = d.pop("mp_size")
            tpc = d.setdefault("tensor_parallel", {})
            if isinstance(tpc, dict):
                tpc.setdefault("tp_size", int(tp))
        d.pop("replace_method", None)
        for key in ("dtype", "kv_cache_dtype"):
            dt = d.get(key)
            if dt is not None:
                d[key] = cls._LEGACY_DTYPES.get(str(dt), str(dt))
        return super().from_dict(d, path=path)
