"""Device-memory ledger, pre-flight capacity planner, and OOM forensics
(counterpart of `deepspeed_tpu/telemetry/memscope.py`).

Three coordinated faces, as in the JAX package:

  * **Live ledger** (`ServingMemScope` / `TrainMemScope`): per-subsystem
    attribution of the card's memory — params, KV block pool,
    prefix-cache-held blocks (a view), draft mirror, fp32 master and
    optimizer state, and a step's temporaries — published as ``mem/*``
    gauges through the telemetry registry, next to the caching
    allocator's watermarks (`torch.cuda.memory_stats`, capacity from
    `torch.cuda.mem_get_info`) and an honest *unattributed* residual. A
    serving router aggregates its replicas' ledgers into pool gauges.

  * **Pre-flight capacity planner** (`plan_training` / `plan_serving` —
    the `estimate_zero*_model_states_mem_needs` analog): predicts the
    resident bytes of a model x ZeRO stage x offload configuration, or a
    serving pool geometry, before anything is allocated; warns or refuses
    on a predicted OOM; answers the inverse question (`max_kv_blocks`).
    The numbers are the JAX planner's, byte for byte.

  * **OOM forensics**: the engine and scheduler dispatch boundaries catch
    an allocator failure (`torch.OutOfMemoryError`, or any error whose
    text names one), dump the ledger + the planner delta + the flight
    recorder's ring to ``<subsystem>.memscope.oom.NNN.json`` and re-raise.
    ``mem/headroom_frac`` also feeds the degradation ladder
    (`degradation.headroom_low`).

The JAX package costs its compiled XLA programs (`memory_analysis()`);
the port compiles none. Its temp term is measured instead: the
allocator's peak during a step (`torch.cuda.max_memory_allocated`) above
the bytes allocated when the step began, on the card, and 0 on the CPU.
`memscope_programs` is accepted and `program_memory()` is `{}`.

Disabled by default like every observability layer: without
``telemetry.memscope`` no scope object is built, no gauge exists and no
file is written. The planner half imports no torch at module level beyond
this package's logger, so the CLI runs anywhere:

    python -m deepspeed_tpu_torch.telemetry.memscope --plan train \
        --params 1.3e9 --zero 3 --dp 8 --capacity 80G
"""

import dataclasses
import json
import os
import pathlib
import time
from typing import Any, Dict, List, Optional, Tuple

from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.memory import device_memory_stats

__all__ = [
    "MemoryPlan", "PredictedOOMError", "ServingMemScope", "TrainMemScope",
    "plan_training", "plan_serving", "plan_training_from_engine",
    "plan_training_from_infinity",
    "plan_serving_prealloc", "serving_pool_bytes", "max_kv_blocks",
    "estimate_zero2_model_states_mem_needs",
    "estimate_zero3_model_states_mem_needs", "preflight_check",
    "is_resource_exhausted", "kv_cache_is_quantized",
    "tree_bytes", "dtype_bytes", "fmt_bytes", "LEDGER_GAUGES",
]

# every key the ledger may publish as a `mem/<key>` gauge (the JAX
# package's list)
LEDGER_GAUGES = (
    "params_bytes", "kv_pool_bytes", "kv_pool_per_chip_bytes",
    "prefix_cached_bytes",
    "draft_params_bytes", "draft_pool_bytes",
    "master_bytes", "opt_state_bytes",
    "offload_staged_bytes", "offload_host_bytes",
    "moe_expert_params_bytes",
    "program_temp_bytes", "bytes_in_use", "peak_bytes", "capacity_bytes",
    "attributed_bytes", "unattributed_bytes", "headroom_frac",
)


# ----------------------------------------------------------------------
# byte helpers
# ----------------------------------------------------------------------

_DTYPE_BYTES = {
    "float64": 8, "fp64": 8, "int64": 8, "uint64": 8,
    "float32": 4, "fp32": 4, "float": 4, "int32": 4, "uint32": 4,
    "bfloat16": 2, "bf16": 2, "float16": 2, "fp16": 2, "half": 2,
    "int16": 2, "uint16": 2,
    "int8": 1, "uint8": 1, "bool": 1,
}


def _dtype_name(dtype) -> str:
    """'float32' for "float32", torch.float32 or np.float32."""
    if isinstance(dtype, str):
        name = dtype
    else:
        name = getattr(dtype, "name", None)
        if not isinstance(name, str):
            name = str(dtype)
    return name.strip().lower().replace("torch.", "")


def dtype_bytes(dtype) -> int:
    """Itemsize of a dtype given as a string, a torch dtype or a numpy
    dtype / scalar type."""
    itemsize = getattr(dtype, "itemsize", None)
    if isinstance(itemsize, int) and not isinstance(dtype, str):
        return itemsize                          # torch.dtype
    name = _dtype_name(dtype)
    if name in _DTYPE_BYTES:
        return _DTYPE_BYTES[name]
    import numpy as np
    return int(np.dtype(name if isinstance(dtype, str) else dtype).itemsize)


def _tensor_leaves(tree):
    """Array leaves of a tree of dicts / lists / tuples; a quantized leaf
    (`inference/quantization.QuantizedTensor`) counts as its payload and
    its scales."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tensor_leaves(v)]
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        return [tree.q, tree.scale]
    return [tree]


def tree_bytes(tree) -> int:
    """Total bytes of a tree's tensor / array leaves (numel x itemsize)."""
    total = 0
    for leaf in _tensor_leaves(tree):
        dt = getattr(leaf, "dtype", None)
        if dt is None:
            continue
        total += _numel(leaf) * dtype_bytes(dt)
    return total


def _numel(leaf) -> int:
    numel = getattr(leaf, "numel", None)
    return int(numel()) if callable(numel) else int(leaf.size)


def fmt_bytes(n) -> str:
    """Human-readable bytes (KiB/MiB/GiB); exact integers below 1 KiB."""
    try:
        n = float(n)
    except (TypeError, ValueError):
        return str(n)
    sign = "-" if n < 0 else ""
    n = abs(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if n < 1024 or unit == "TiB":
            if unit == "B":
                return f"{sign}{n:.0f} B"
            return f"{sign}{n:.2f} {unit}"
        n /= 1024.0


# ----------------------------------------------------------------------
# the pre-flight capacity planner
# ----------------------------------------------------------------------


class PredictedOOMError(RuntimeError):
    """The planner predicts this configuration cannot fit device memory
    (raised only under ``memscope_preflight: "refuse"`` or an explicit
    ``preflight_check(..., refuse=True)``)."""


@dataclasses.dataclass
class MemoryPlan:
    """A capacity prediction: per-category device/host bytes plus optional
    measured-or-margin temp and a capacity to judge against. `fits` is
    None when no capacity is known (no GPU and no capacity override)."""
    kind: str                                   # "train" | "serving"
    device_bytes: Dict[str, int]
    host_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    temp_bytes: int = 0
    capacity_bytes: int = 0
    notes: List[str] = dataclasses.field(default_factory=list)

    @property
    def total_device_bytes(self) -> int:
        return int(sum(self.device_bytes.values()))

    @property
    def total_host_bytes(self) -> int:
        return int(sum(self.host_bytes.values()))

    @property
    def predicted_peak_bytes(self) -> int:
        return self.total_device_bytes + int(self.temp_bytes)

    @property
    def headroom_bytes(self) -> Optional[int]:
        if not self.capacity_bytes:
            return None
        return int(self.capacity_bytes) - self.predicted_peak_bytes

    @property
    def headroom_frac(self) -> Optional[float]:
        hb = self.headroom_bytes
        if hb is None:
            return None
        return hb / float(self.capacity_bytes)

    @property
    def fits(self) -> Optional[bool]:
        hb = self.headroom_bytes
        return None if hb is None else hb >= 0

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind,
                "device_bytes": dict(self.device_bytes),
                "host_bytes": dict(self.host_bytes),
                "temp_bytes": int(self.temp_bytes),
                "capacity_bytes": int(self.capacity_bytes),
                "total_device_bytes": self.total_device_bytes,
                "total_host_bytes": self.total_host_bytes,
                "predicted_peak_bytes": self.predicted_peak_bytes,
                "headroom_bytes": self.headroom_bytes,
                "headroom_frac": self.headroom_frac,
                "fits": self.fits,
                "notes": list(self.notes)}

    def render(self) -> str:
        lines = [f"memory plan ({self.kind})"]
        for name, b in self.device_bytes.items():
            lines.append(f"  device {name:<18} {fmt_bytes(b)}")
        if self.temp_bytes:
            lines.append(f"  device {'program_temp':<18} "
                         f"{fmt_bytes(self.temp_bytes)}")
        lines.append(f"  device TOTAL (peak)       "
                     f"{fmt_bytes(self.predicted_peak_bytes)}")
        for name, b in self.host_bytes.items():
            lines.append(f"  host   {name:<18} {fmt_bytes(b)}")
        if self.capacity_bytes:
            verdict = "FITS" if self.fits else "PREDICTED OOM"
            lines.append(f"  capacity {fmt_bytes(self.capacity_bytes)} -> "
                         f"headroom {fmt_bytes(self.headroom_bytes)} "
                         f"({self.headroom_frac:.1%}) [{verdict}]")
        for n in self.notes:
            lines.append(f"  note: {n}")
        return "\n".join(lines)


def plan_training(n_params, *, zero_stage=0, dp=1, tp=1, dtype="bfloat16",
                  master_weights=True, optimizer_moments=2,
                  grad_accum_dtype=None, offload_optimizer=False,
                  offload_param=False, offload_param_bytes=None,
                  offload_staging_layers=0, offload_layer_bytes=0,
                  num_experts=0, ep_size=1, n_expert_params=0,
                  temp_bytes=0, capacity_bytes=0) -> MemoryPlan:
    """Model-state memory prediction per device — the ZeRO estimator.

    Mirrors the reference's `estimate_zero*_model_states_mem_needs` math
    (the JAX package's planner, number for number): ZeRO stages are sharding
    denominators over the data domain — stage >= 1 shards optimizer state
    + fp32 master, stage >= 2 shards gradients, stage >= 3 shards the
    parameters themselves; TP divides everything. Offload flags move the
    corresponding states to the host column.

    Like the reference estimators this models MODEL STATES only:
    activations/workspace are temporaries, covered by `temp_bytes` (the
    port passes the allocator's measured peak of a step above its
    resident bytes, or a margin). Gradients live only inside the step
    too, but are listed per the reference's convention — `total - grads`
    is the resident state.

    Exact offload pricing (the Infinity tier; `plan_training_from_infinity`
    fills these from the live engine): `offload_param_bytes` overrides the
    host params column with a LIVE store's measured bytes — the prediction
    is then byte-identical to the `LayerParamStore`, not an n·dtype
    estimate — and `offload_staging_layers` × `offload_layer_bytes` prices
    the device-side async staging window (lookahead+1 layers of weights in
    rotation) that the offloaded params still occupy.

    MoE pricing: `n_expert_params` (of the `n_params` total, summed over
    all `num_experts` experts) shards over the EXPERT axis — per-chip
    expert bytes are `n_expert_params/ep_size` on top of whatever the
    ZeRO/TP denominators already divide (expert leading dims carry
    `P(expert, …)` specs — `models/moe_gpt.py` `moe_gpt_param_specs`).
    The expert slice is listed as its own `moe_expert_params` device
    category so the plan shows the sparse-capacity headroom directly.
    """
    # the plan's notes are the JAX planner's, word for word: the `--plan`
    # JSON of both CLIs is one document
    n = int(n_params)
    n_exp = min(int(n_expert_params), n)
    n -= n_exp                        # dense remainder below
    dp = max(1, int(dp))
    tp = max(1, int(tp))
    ep = max(1, int(ep_size))
    p_b = dtype_bytes(dtype)
    p_shard = tp * (dp if zero_stage >= 3 else 1)
    g_shard = tp * (dp if zero_stage >= 2 else 1)
    o_shard = tp * (dp if zero_stage >= 1 else 1)
    dev: Dict[str, int] = {}
    host: Dict[str, int] = {}
    notes: List[str] = []

    params = n * p_b // p_shard
    if offload_param:
        host["params"] = params if offload_param_bytes is None \
            else int(offload_param_bytes)
        dev["params"] = 0
        if offload_staging_layers and offload_layer_bytes:
            dev["param_staging"] = int(offload_staging_layers) * \
                int(offload_layer_bytes)
            notes.append(
                f"offload_param: async staging pool keeps "
                f"{int(offload_staging_layers)} layer(s) of weights "
                f"device-resident (lookahead+1 rotation)")
        notes.append("offload_param: bit16 params host-resident, "
                     "streamed/gathered through HBM per layer")
    else:
        dev["params"] = params

    g_b = dtype_bytes(grad_accum_dtype) if grad_accum_dtype else p_b
    dev["grads"] = n * g_b // g_shard

    master = n * 4 // o_shard if (master_weights and p_b < 4) else 0
    optim = n * 4 * max(0, int(optimizer_moments)) // o_shard

    if n_exp:
        # expert leaves shard their leading dim over the expert axis, on
        # top of the ZeRO/TP denominators (specs: P(expert, …))
        dev["moe_expert_params"] = n_exp * p_b // (p_shard * ep)
        dev["grads"] += n_exp * g_b // (g_shard * ep)
        if master_weights and p_b < 4:
            master += n_exp * 4 // (o_shard * ep)
        optim += n_exp * 4 * max(0, int(optimizer_moments)) // (o_shard * ep)
        notes.append(
            f"moe: {int(num_experts) or '?'} experts, "
            f"{fmt_bytes(n_exp * p_b)} of expert weights shard /ep_size="
            f"{ep} on the expert axis — per-chip expert params = "
            f"{fmt_bytes(n_exp * p_b // (p_shard * ep))}")
    if offload_optimizer:
        if master:
            host["master"] = master
        host["optim"] = optim
        dev["master"] = dev["optim"] = 0
        notes.append("offload_optimizer: fp32 master + moments host-"
                     "resident (streamed through HBM, or host-stepped)")
    else:
        if master:
            dev["master"] = master
        dev["optim"] = optim

    notes.append("model states only — activations/workspace live in "
                 "temp_bytes (measured or margin); grads are XLA "
                 "temporaries inside the fused step")
    return MemoryPlan("train", dev, host, int(temp_bytes),
                      int(capacity_bytes), notes)


def estimate_zero2_model_states_mem_needs(total_params, num_devices=1,
                                          cpu_offload=False,
                                          **kw) -> MemoryPlan:
    """Reference-API analog (`deepspeed.runtime.zero` estimators): ZeRO-2
    model-state needs for `total_params` over `num_devices`. Logs the
    verdict and returns the full `MemoryPlan`."""
    plan = plan_training(total_params, zero_stage=2, dp=num_devices,
                         offload_optimizer=cpu_offload, **kw)
    logger.info("estimate_zero2_model_states_mem_needs:\n" + plan.render())
    return plan


def estimate_zero3_model_states_mem_needs(total_params, num_devices=1,
                                          cpu_offload=False,
                                          cpu_offload_params=False,
                                          **kw) -> MemoryPlan:
    """Reference-API analog: ZeRO-3 model-state needs (optionally with
    optimizer and/or parameter offload)."""
    plan = plan_training(total_params, zero_stage=3, dp=num_devices,
                         offload_optimizer=cpu_offload,
                         offload_param=cpu_offload_params, **kw)
    logger.info("estimate_zero3_model_states_mem_needs:\n" + plan.render())
    return plan


def plan_training_from_engine(engine, capacity_bytes=0,
                              temp_bytes=0) -> MemoryPlan:
    """The training plan from a live engine's config — the preflight path
    and the OOM dump's planner-delta source. The model states are priced
    at the engine's data-parallel degree (the process group's `data`
    axis), as the JAX planner prices them from the mesh: per-rank shards
    of the master and moments, from stage 2 of the grads, at stage 3 of
    the params; tensor and expert degrees are 1. Pass the measured step
    temp (`program_temp_bytes`) when there is one: in training the
    activations are the temp, the dominant OOM term."""
    from deepspeed_tpu_torch.utils.tree import tree_num_params
    n = getattr(engine, "num_params", None) or \
        tree_num_params(engine.state.params)
    dp = int(getattr(engine, "dp_world_size", 1))
    cfg = engine.config
    z = cfg.zero_optimization
    off_o = z.offload_optimizer is not None and \
        z.offload_optimizer.device in ("cpu", "nvme")
    off_p = z.offload_param is not None and \
        z.offload_param.device in ("cpu", "nvme")
    return plan_training(
        n, zero_stage=int(z.stage), dp=dp, tp=1,
        dtype=getattr(engine, "compute_dtype", "float32"),
        master_weights=engine.state.master is not None,
        grad_accum_dtype=cfg.data_types.grad_accum_dtype,
        offload_optimizer=off_o, offload_param=off_p,
        temp_bytes=temp_bytes, capacity_bytes=capacity_bytes)


def plan_training_from_infinity(engine, capacity_bytes=0,
                                temp_bytes=0) -> MemoryPlan:
    """Training plan priced from a LIVE InfinityEngine — every model-state
    byte measured, none estimated:

      host   params  = the `LayerParamStore`'s exact bytes (layer_bytes x
                       num_layers);
      host   master  = the fp32 masters of the per-layer + resident
                       `HostOffloadOptimizer`s;
      host   optim   = their moments, whether RAM-held or NVMe-swapped;
      device params          = the resident leaves (embed/norms/head);
      device param_staging   = the staging ring — lookahead+1 layers of
                               16-bit weights in rotation.

    Boundary activations live in `temp_bytes` (measured or margin), as in
    the reference estimators' model-states-only convention."""
    host: Dict[str, int] = {}
    dev: Dict[str, int] = {}
    store = engine.store
    host["params"] = int(store.host_bytes)
    masters = 0
    optim = 0
    for opt in list(engine.layer_opts) + [engine.resident_opt]:
        masters += tree_bytes(opt.master)
        for moments in (opt.exp_avg, opt.exp_avg_sq):
            if moments:
                optim += tree_bytes(moments)
        if getattr(opt, "nvme", None) is not None:
            # NVMe-swapped moments: priced from the swapper's metadata —
            # they stream through host RAM per step
            for shape, dt in opt.nvme.meta.values():
                n = 1
                for d in shape:
                    n *= int(d)
                optim += n * dtype_bytes(dt)
    host["master"] = masters
    host["optim"] = optim
    dev["params"] = tree_bytes(engine.resident)
    dev["param_staging"] = (engine.streamer.lookahead + 1) * \
        store.layer_bytes
    notes = [
        "priced from the live tier: host params are byte-identical to the "
        "LayerParamStore; param_staging is the lookahead+1 async staging "
        "window (peak_live_layers bound)",
        "boundary activations / vjp workspace live in temp_bytes "
        "(measured or margin)"]
    return MemoryPlan("train", dev, host, int(temp_bytes),
                      int(capacity_bytes), notes)


def kv_cache_is_quantized(kv_cache_dtype) -> bool:
    """True for the int8 quantized pool layout (payload + f32 group
    scales). Name-matched (a string, a torch or numpy dtype); EXACT match
    — 'uint8' is a plain (scale-less) pool, not the quantized layout, and
    a substring test would make the planner price scales the scheduler
    never allocates."""
    return _dtype_name(kv_cache_dtype) == "int8"


def serving_pool_bytes(*, n_layer, n_kv_head, head_dim, kv_block_size,
                       num_kv_blocks, kv_cache_dtype="bfloat16",
                       kv_group_size=0) -> int:
    """Bytes of a paged KV pool: K and V, each
    ``[L, num_blocks, Hkv, block, hd]`` (the `init_paged_pool` layout) at
    the pool dtype's itemsize. The int8 quantized pool additionally
    carries K and V scale leaves ``[L, N, Hkv, block, hd//g]`` f32
    (`kv_group_size` g, 0 = head_dim) — the scales-overhead term is what
    keeps the planner's byte identity with `init_paged_kv_pool` exact, and
    what caps the capacity win below a clean 2x (4/g extra bytes per
    element: g=128 -> 1.94x, g=head_dim=64 -> 1.88x)."""
    cells = (2 * int(n_layer) * int(num_kv_blocks) * int(n_kv_head)
             * int(kv_block_size))
    total = cells * int(head_dim) * dtype_bytes(kv_cache_dtype)
    if kv_cache_is_quantized(kv_cache_dtype):
        g = int(kv_group_size) or int(head_dim)
        total += cells * (int(head_dim) // g) * 4
    return total


def plan_serving(*, n_layer, n_kv_head, head_dim, kv_block_size,
                 num_kv_blocks, kv_cache_dtype="bfloat16", kv_group_size=0,
                 n_params=0, param_dtype="bfloat16", params_bytes=None,
                 tp=1, sequence_parallel=1, draft=None, temp_bytes=0,
                 capacity_bytes=0) -> MemoryPlan:
    """Serving-resident memory prediction: weights + the paged KV pool
    (+ the spec-decode draft mirror, which shares num_kv_blocks/block_size
    with the target by construction). `draft` is a dict with the draft
    model's `n_layer`/`n_kv_head`/`head_dim` and `n_params` (or
    `params_bytes`). `temp_bytes` carries the compiled-step temp (measured
    via `aot_memory_analysis`, or a margin) — decode/prefill temps are
    small next to the pool, but headroom claims should include them.

    `sequence_parallel` > 1 prices the SEQUENCE-SHARDED pool
    (`inference/sequence_span.py`): `num_kv_blocks` stays the GLOBAL block
    count, the pool's physical-block axis spans sp chips, so the per-chip
    kv_pool claim — the number this per-device plan judges against
    capacity — is total/sp. Weights replicate across the sequence axis
    (only tp divides them), so `params` is unchanged."""
    tp = max(1, int(tp))
    sp = max(1, int(sequence_parallel))
    dev: Dict[str, int] = {}
    notes: List[str] = []
    if params_bytes is None:
        params_bytes = int(n_params) * dtype_bytes(param_dtype)
    dev["params"] = int(params_bytes) // tp
    dev["kv_pool"] = serving_pool_bytes(
        n_layer=n_layer, n_kv_head=n_kv_head, head_dim=head_dim,
        kv_block_size=kv_block_size, num_kv_blocks=num_kv_blocks,
        kv_cache_dtype=kv_cache_dtype, kv_group_size=kv_group_size) // sp
    if sp > 1:
        notes.append(f"sequence-sharded pool (sequence_parallel={sp}): "
                     f"block tables span the `sequence` axis — per-chip "
                     f"KV bytes are 1/{sp} of the global pool")
    if kv_cache_is_quantized(kv_cache_dtype):
        notes.append("int8 KV pool: payload bytes + f32 per-group scales "
                     f"(group {int(kv_group_size) or int(head_dim)})")
    if draft:
        dpb = draft.get("params_bytes")
        if dpb is None:
            dpb = int(draft.get("n_params", 0)) * \
                dtype_bytes(draft.get("param_dtype", param_dtype))
        dev["draft_params"] = int(dpb) // tp
        dev["draft_pool"] = serving_pool_bytes(
            n_layer=draft["n_layer"], n_kv_head=draft["n_kv_head"],
            head_dim=draft["head_dim"], kv_block_size=kv_block_size,
            num_kv_blocks=num_kv_blocks,
            kv_cache_dtype=draft.get("kv_cache_dtype", kv_cache_dtype),
            kv_group_size=draft.get("kv_group_size", 0)) // sp
        notes.append("draft mirror shares the target's num_kv_blocks/"
                     "block_size (indexed by the same block tables)")
    notes.append("prefix-cached blocks live INSIDE kv_pool (a view, "
                 "not additive)")
    return MemoryPlan("serving", dev, {}, int(temp_bytes),
                      int(capacity_bytes), notes)


def max_kv_blocks(capacity_bytes, *, n_layer, n_kv_head, head_dim,
                  kv_block_size, kv_cache_dtype="bfloat16", kv_group_size=0,
                  params_bytes=0, temp_bytes=0, sequence_parallel=1,
                  draft=None) -> int:
    """The inverse question serving deployment actually asks: the largest
    `num_kv_blocks` that fits `capacity_bytes` next to the weights (and
    the draft mirror, whose pool grows block-for-block with the target's).
    An int8 `kv_cache_dtype` prices each block at payload + scales
    (`serving_pool_bytes`), so the same budget answers ~2x the blocks —
    2/(1 + 4/g) of bf16's, exactly.
    `sequence_parallel` > 1: `capacity_bytes` is PER CHIP but the answer
    stays the GLOBAL block count of the sequence-sharded pool. Shards hold
    WHOLE blocks (the pool is sp equal shard ranges), so the answer is
    (blocks-per-shard that fit one chip) × sp — exactly sp× the flat
    answer, never overfilling a shard with a fractional-block credit.
    Remember per-shard local block 0 is reserved as trash: usable capacity
    is the returned value minus `sequence_parallel` blocks."""
    sp = max(1, int(sequence_parallel))
    per_block = serving_pool_bytes(
        n_layer=n_layer, n_kv_head=n_kv_head, head_dim=head_dim,
        kv_block_size=kv_block_size, num_kv_blocks=1,
        kv_cache_dtype=kv_cache_dtype, kv_group_size=kv_group_size)
    fixed = int(params_bytes) + int(temp_bytes)
    if draft:
        dpb = draft.get("params_bytes")
        if dpb is None:
            dpb = int(draft.get("n_params", 0)) * \
                dtype_bytes(draft.get("param_dtype", kv_cache_dtype))
        fixed += int(dpb)
        per_block += serving_pool_bytes(
            n_layer=draft["n_layer"], n_kv_head=draft["n_kv_head"],
            head_dim=draft["head_dim"], kv_block_size=kv_block_size,
            num_kv_blocks=1,
            kv_cache_dtype=draft.get("kv_cache_dtype", kv_cache_dtype),
            kv_group_size=draft.get("kv_group_size", 0))
    # shards hold WHOLE blocks: one chip fits free//per_block of them, and
    # the global sequence-sharded pool is sp such shard ranges (sp=1: flat)
    free = int(capacity_bytes) - fixed
    return max(0, (free // max(1, per_block)) * sp)


def _cast_bytes(tree, dtype) -> int:
    """Bytes of `tree` with its floating leaves cast to `dtype` (what the
    draft drafter holds after its cast to the engine's dtype)."""
    total = 0
    for leaf in _tensor_leaves(tree):
        dt = getattr(leaf, "dtype", None)
        if dt is None:
            continue
        n = _numel(leaf)
        floating = getattr(leaf, "is_floating_point", None)
        is_float = floating() if callable(floating) else \
            _dtype_name(dt).startswith(("float", "bfloat"))
        total += int(n) * dtype_bytes(dtype if is_float else dt)
    return total


def plan_serving_prealloc(spec, *, num_kv_blocks, kv_block_size,
                          kv_cache_dtype, kv_group_size=0, params=None,
                          draft_spec=None, param_dtype=None, temp_bytes=0,
                          capacity_bytes=0) -> MemoryPlan:
    """Serving plan BEFORE any pool allocation: the pool is built on the
    `meta` device (shapes and dtypes, no memory), so a predicted-OOM
    configuration can warn or refuse ahead of the allocation that would
    fail on the card. An int8 `kv_cache_dtype` threads `kv_group_size`
    through to the quantized-pool contract, so the scale leaves are in the
    prediction too. `param_dtype` mirrors the drafter's cast."""
    import torch

    def pool_shape_bytes(s):
        try:
            if kv_cache_is_quantized(kv_cache_dtype):
                pool = s.init_paged_pool(int(num_kv_blocks),
                                         int(kv_block_size), torch.int8,
                                         int(kv_group_size), device="meta")
            else:
                pool = s.init_paged_pool(int(num_kv_blocks),
                                         int(kv_block_size),
                                         kv_cache_dtype, device="meta")
        except TypeError as e:
            raise ValueError(
                f"init_paged_pool of spec "
                f"'{getattr(s, 'name', '?')}' does not implement the "
                f"quantized-pool contract (num_blocks, block_size, dtype, "
                f"kv_group_size, device=...; init_paged_kv_pool in "
                f"models/gpt.py is the reference): {e}") from e
        return tree_bytes(pool)

    dev = {"params": tree_bytes(params),
           "kv_pool": pool_shape_bytes(spec)}
    notes = ["pre-allocation plan: pool bytes from a meta-device pool — "
             "no device memory touched"]
    if draft_spec is not None:
        dparams = getattr(draft_spec, "params", None)
        dev["draft_params"] = _cast_bytes(dparams, param_dtype) \
            if param_dtype is not None else tree_bytes(dparams)
        dev["draft_pool"] = pool_shape_bytes(draft_spec)
        notes.append("draft mirror shares the target's num_kv_blocks/"
                     "block_size (indexed by the same block tables)")
    notes.append("prefix-cached blocks live INSIDE kv_pool (a view, "
                 "not additive)")
    return MemoryPlan("serving", dev, {}, int(temp_bytes),
                      int(capacity_bytes), notes)


def preflight_check(plan: MemoryPlan, refuse=False) -> MemoryPlan:
    """Judge a plan against its capacity: logs a warning on predicted OOM,
    or raises `PredictedOOMError` with the full plan table when `refuse`.
    A plan without a known capacity passes silently (nothing to judge)."""
    if plan.fits is False:
        msg = (f"memscope preflight: predicted OOM — "
               f"{fmt_bytes(plan.predicted_peak_bytes)} predicted vs "
               f"{fmt_bytes(plan.capacity_bytes)} capacity\n{plan.render()}")
        if refuse:
            raise PredictedOOMError(msg)
        logger.warning(msg)
    return plan


# ----------------------------------------------------------------------
# OOM detection
# ----------------------------------------------------------------------

_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Resource exhausted",
                "Out of memory", "out of memory",
                "Failed to allocate")


def is_resource_exhausted(exc) -> bool:
    """True when `exc` (or anything on its cause/context chain) is a
    device allocator failure: a `torch.OutOfMemoryError`, or an error
    whose text spells one (the JAX package's markers)."""
    oom_type = _oom_type()
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if oom_type is not None and isinstance(exc, oom_type):
            return True
        text = f"{type(exc).__name__}: {exc}"
        if any(m in text for m in _OOM_MARKERS):
            return True
        exc = exc.__cause__ or exc.__context__
    return False


def _oom_type():
    try:
        import torch
        return getattr(torch, "OutOfMemoryError", None) or \
            torch.cuda.OutOfMemoryError
    except Exception:
        return None


# ----------------------------------------------------------------------
# the live ledger
# ----------------------------------------------------------------------


class _MemScopeBase:
    """Shared ledger machinery: category attribution, the measured step
    temp, gauge publishing, preflight, and the OOM dump."""

    subsystem = "?"

    def __init__(self, telemetry, device=None, flightrec_fn=None):
        self.telemetry = telemetry
        self.device = device
        cfg = getattr(telemetry, "config", None)
        self.capacity_override = int(
            getattr(cfg, "memscope_capacity_bytes", 0) or 0)
        self._out_dir = str(getattr(cfg, "output_path", "telemetry")
                            or "telemetry")
        self._flightrec_fn = flightrec_fn or (lambda: None)
        self.temp_bytes = 0
        self._step_base = None
        # the allocator's peak over the run: each step resets the
        # allocator's own peak to measure its temp, so the ledger keeps
        # the largest peak seen before each reset
        self.run_peak_bytes = 0
        self.last_plan: Optional[MemoryPlan] = None
        self.oom_dumps = 0

    # -- subclass surface ----------------------------------------------

    def _categories(self) -> Tuple[Dict[str, int], Dict[str, int]]:
        """(attributed, informational) category dicts; informational
        entries (e.g. prefix_cached_bytes — a view of the pool) appear in
        the snapshot but never in the attribution sum."""
        raise NotImplementedError

    def plan(self) -> MemoryPlan:
        raise NotImplementedError

    # -- the step's temporaries ------------------------------------------

    def _on_cuda(self):
        import torch
        return self.device is not None and \
            torch.device(self.device).type == "cuda"

    def begin_step(self):
        """Mark a step's start: the allocator's peak restarts from here
        (for every reader of `torch.cuda.max_memory_allocated` in the
        process; `peak_bytes()` keeps the run's)."""
        if self._on_cuda():
            import torch
            self.run_peak_bytes = max(
                self.run_peak_bytes,
                int(torch.cuda.max_memory_allocated(self.device)))
            torch.cuda.reset_peak_memory_stats(self.device)
            self._step_base = torch.cuda.memory_allocated(self.device)

    def end_step(self):
        """The step's temp: its allocator peak above the bytes allocated
        when it began; the ledger keeps the largest seen."""
        if self._step_base is not None:
            import torch
            peak = torch.cuda.max_memory_allocated(self.device)
            self.temp_bytes = max(self.temp_bytes,
                                  int(peak) - int(self._step_base))
            self._step_base = None

    def peak_bytes(self) -> int:
        """The allocator's peak over the run, across the step resets (0
        on the CPU)."""
        if not self._on_cuda():
            return 0
        import torch
        return max(self.run_peak_bytes,
                   int(torch.cuda.max_memory_allocated(self.device)))

    def program_memory(self) -> Dict[str, Dict[str, int]]:
        """Per-program memory analysis: none — the port compiles no
        program (the JAX package's `memory_analysis()` has no
        counterpart)."""
        return {}

    def program_temp_bytes(self) -> int:
        """The live-at-once workspace claim: the largest measured step
        temp (0 on the CPU)."""
        return int(self.temp_bytes)

    # -- the ledger -----------------------------------------------------

    def capacity_bytes(self) -> int:
        if self.capacity_override:
            return self.capacity_override
        return int(device_memory_stats(self.device).get("bytes_limit", 0)
                   or 0) if self._on_cuda() else 0

    def snapshot(self) -> Dict[str, Any]:
        """The ledger: attributed categories, the step temp, allocator
        watermarks, capacity, and the unattributed residual."""
        cats, info = self._categories()
        temp = self.program_temp_bytes()
        stats = device_memory_stats(self.device) if self._on_cuda() else {}
        in_use = int(stats.get("bytes_in_use", 0) or 0)
        peak = max(int(stats.get("peak_bytes_in_use", 0) or 0),
                   self.run_peak_bytes)
        cap = self.capacity_override or \
            int(stats.get("bytes_limit", 0) or 0)
        attributed = int(sum(cats.values())) + temp
        out: Dict[str, Any] = {"subsystem": self.subsystem}
        out.update(cats)
        out.update(info)
        out["program_temp_bytes"] = temp
        out["bytes_in_use"] = in_use
        out["peak_bytes"] = peak
        out["capacity_bytes"] = cap
        out["attributed_bytes"] = attributed
        # honest residual: what the allocator holds that the ledger cannot
        # name (only computable where allocator stats exist)
        out["unattributed_bytes"] = max(0, in_use - attributed) if in_use \
            else 0
        if cap:
            resident = in_use if in_use else attributed
            out["headroom_frac"] = max(0.0, 1.0 - resident / cap)
        return out

    def headroom_frac(self) -> Optional[float]:
        """Fraction of capacity still free — the degradation ladder's
        optional signal. None when no capacity is known (the signal is
        omitted)."""
        return self.snapshot().get("headroom_frac")

    def publish(self):
        """Set the `mem/*` gauges from a fresh snapshot."""
        t = self.telemetry
        if t is None or not getattr(t, "enabled", False):
            return
        for k, v in self.snapshot().items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            t.set_gauge(f"mem/{k}", v)

    # -- preflight ------------------------------------------------------

    def preflight(self, mode="warn") -> Optional[MemoryPlan]:
        """Run the planner against this subsystem's live configuration.
        `mode`: "off" | "warn" | "refuse" (the `memscope_preflight`
        knob)."""
        if mode == "off":
            return None
        try:
            plan = dataclasses.replace(self.plan(),
                                       capacity_bytes=self.capacity_bytes())
        except Exception as e:
            logger.warning(f"memscope preflight unavailable: {e}")
            return None
        self.last_plan = plan
        return preflight_check(plan, refuse=(mode == "refuse"))

    # -- OOM forensics --------------------------------------------------

    def on_step_error(self, exc) -> Optional[str]:
        """Dispatch-boundary hook: dump forensics iff `exc` is a device
        allocator failure. Returns the dump path (None otherwise). Never
        raises — this runs inside an exception handler that must re-raise
        the ORIGINAL error."""
        self._step_base = None
        try:
            if is_resource_exhausted(exc):
                return self.oom_dump(exc)
        except Exception:
            pass
        return None

    def oom_dump(self, exc) -> Optional[str]:
        """The OOM black box: ledger + planner delta + flight-recorder
        ring to `<out>/<subsystem>.memscope.oom.NNN.json`. Also fires the
        flight recorder's own dump when it is enabled."""
        try:
            snap = self.snapshot()
            try:
                plan = dataclasses.replace(
                    self.plan(), capacity_bytes=self.capacity_bytes())
            except Exception:
                plan = self.last_plan
            delta = None
            if plan is not None:
                # the line that says whether this OOM was FORESEEABLE:
                # bytes the allocator holds beyond what the plan predicted
                observed = snap["bytes_in_use"] or snap["attributed_bytes"]
                delta = {"predicted_peak_bytes": plan.predicted_peak_bytes,
                         "observed_bytes": observed,
                         "unpredicted_bytes":
                             observed - plan.predicted_peak_bytes,
                         "fits_predicted": plan.fits}
            rec = self._flightrec_fn()
            events = rec.events() if rec is not None and \
                getattr(rec, "enabled", False) else []
            os.makedirs(self._out_dir, exist_ok=True)
            prefix = f"{self.subsystem}.memscope.oom."
            n = self.oom_dumps
            for name in os.listdir(self._out_dir):
                if name.startswith(prefix) and name.endswith(".json"):
                    try:
                        n = max(n, int(name[len(prefix):-5]) + 1)
                    except ValueError:
                        continue
            path = os.path.join(self._out_dir, f"{prefix}{n:03d}.json")
            self.oom_dumps = n + 1
            with open(path, "w") as f:
                json.dump({"reason": f"{type(exc).__name__}: {exc}",
                           "time": time.time(),
                           "subsystem": self.subsystem,
                           "ledger": snap,
                           "plan": plan.to_dict() if plan else None,
                           "plan_delta": delta,
                           "flight_events": events}, f, indent=1,
                          default=str)
            if rec is not None and getattr(rec, "enabled", False):
                rec.dump(f"RESOURCE_EXHAUSTED: {exc}",
                         state={"ledger": snap,
                                "plan_delta": delta})
            logger.warning(f"memscope: OOM forensics dumped to {path}")
            return path
        except Exception as e:
            logger.warning(f"memscope: OOM dump failed ({e})")
            return None


class ServingMemScope(_MemScopeBase):
    """The serving engine's ledger: weights, paged KV pool, prefix-cached
    carve-out, draft mirror, and the measured step temp."""

    subsystem = "serving"

    def __init__(self, serving):
        super().__init__(serving.telemetry, device=serving.engine.device,
                         flightrec_fn=lambda: serving.flightrec)
        self.serving = serving
        # static footprints, measured once from the live trees
        self.params_bytes = tree_bytes(serving.engine.params)
        self.pool_bytes = tree_bytes(serving.pool)
        self.block_bytes = self.pool_bytes // max(1,
                                                  serving.allocator.num_blocks)
        dr = serving.drafter
        self.draft_params_bytes = tree_bytes(getattr(dr, "params", None)) \
            if dr is not None else 0
        self.draft_pool_bytes = tree_bytes(getattr(dr, "pool", None)) \
            if dr is not None else 0
        # streamed (offloaded-weights) mode: params_bytes above priced only
        # the resident tree; the staged layer window is a live device claim
        # of its own, the host store an informational one
        self._streamed_engine = serving.engine \
            if getattr(serving, "streamed", False) else None

    def _categories(self):
        cats = {"params_bytes": self.params_bytes,
                "kv_pool_bytes": self.pool_bytes}
        if self.draft_params_bytes or self.draft_pool_bytes:
            cats["draft_params_bytes"] = self.draft_params_bytes
            cats["draft_pool_bytes"] = self.draft_pool_bytes
        eng = self._streamed_engine
        if eng is not None:
            cats["offload_staged_bytes"] = \
                len(eng.streamer._live) * eng.store.layer_bytes
        # the port has no sequence-spanning pool: a chip holds all of it
        info = {"kv_pool_per_chip_bytes": self.pool_bytes}
        if eng is not None:
            info["offload_host_bytes"] = eng.store.host_bytes
        pc = self.serving.prefix_cache
        if pc is not None:
            # a VIEW of kv_pool (blocks the cache holds matchable), never
            # added to the attribution sum
            info["prefix_cached_bytes"] = int(pc.num_cached) * \
                self.block_bytes
        return cats, info

    @staticmethod
    def _pool_geometry(pool):
        """(payload leaf, kv_group_size) of a pool tree: the k payload is
        ``[L, N, Hkv, block, hd]`` by the `init_paged_pool` contract, and
        the int8 layout's `k_scale` leaf reveals the scale group."""
        leaf = pool["k"] if isinstance(pool, dict) and "k" in pool \
            else _tensor_leaves(pool)[0]
        g = 0
        if isinstance(pool, dict) and "k_scale" in pool:
            g = int(leaf.shape[-1]) // int(pool["k_scale"].shape[-1])
        return leaf, g

    def plan(self) -> MemoryPlan:
        """Reconstruct the pre-flight prediction from the live pool
        geometry — the OOM dump's planner-delta source."""
        leaf, g = self._pool_geometry(self.serving.pool)
        L, N, Hkv, B, hd = leaf.shape
        draft = None
        if self.serving.drafter is not None and self.draft_pool_bytes:
            dleaf, dg = self._pool_geometry(self.serving.drafter.pool)
            draft = {"n_layer": dleaf.shape[0], "n_kv_head": dleaf.shape[2],
                     "head_dim": dleaf.shape[4],
                     "params_bytes": self.draft_params_bytes,
                     "kv_cache_dtype": dleaf.dtype, "kv_group_size": dg}
        params_bytes = self.params_bytes
        eng = self._streamed_engine
        if eng is not None:
            params_bytes += (eng.streamer.lookahead + 1) * \
                eng.store.layer_bytes
        return plan_serving(
            n_layer=L, n_kv_head=Hkv, head_dim=hd, kv_block_size=B,
            num_kv_blocks=N, kv_cache_dtype=leaf.dtype, kv_group_size=g,
            params_bytes=params_bytes, draft=draft,
            temp_bytes=self.program_temp_bytes(),
            capacity_bytes=self.capacity_bytes())


class TrainMemScope(_MemScopeBase):
    """The training engine's ledger: compute params, fp32 master,
    optimizer state, and the measured step temp (the activations' home).
    The host step's masters and moments are host memory: not on it."""

    subsystem = "train"

    def __init__(self, engine):
        super().__init__(engine.telemetry, device=engine.device,
                         flightrec_fn=lambda: engine.telemetry.flightrec)
        self.engine = engine

    def _categories(self):
        st = self.engine.state
        info = {}
        if isinstance(st.params, dict) and "moe" in st.params:
            # a VIEW of params_bytes, never added to the attribution sum
            info["moe_expert_params_bytes"] = tree_bytes(st.params["moe"])
        return ({"params_bytes": tree_bytes(st.params),
                 "master_bytes": tree_bytes(st.master),
                 "opt_state_bytes": tree_bytes(st.opt_state)}, info)

    def plan(self) -> MemoryPlan:
        return plan_training_from_engine(self.engine,
                                         capacity_bytes=self.capacity_bytes(),
                                         temp_bytes=self.program_temp_bytes())


# ----------------------------------------------------------------------
# CLI: python -m deepspeed_tpu_torch.telemetry.memscope
# ----------------------------------------------------------------------


def load_latest(path):
    """The last valid JSON record of a telemetry `.jsonl` log (a file, or
    the newest `*.jsonl` of a directory); None when there is none. A torn
    final line falls back to the previous record."""
    p = pathlib.Path(path)
    log = None
    if p.is_file():
        log = p
    elif p.is_dir():
        logs = sorted(p.glob("*.jsonl"), key=lambda f: f.stat().st_mtime)
        log = logs[-1] if logs else None
    if log is None:
        return None
    record = None
    with open(log) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
            except json.JSONDecodeError:
                continue
    return record


def _parse_size(s) -> int:
    """'16G'/'16GiB'/'512M'/'512B'/'1.5e9'/'4096' -> bytes."""
    s = str(s).strip()
    units = {"k": 2**10, "m": 2**20, "g": 2**30, "t": 2**40}
    low = s.lower()
    for suffix in ("ib", "b", ""):
        for u, mult in units.items():
            if low.endswith(u + suffix) and low[:-len(u + suffix) or None]:
                try:
                    return int(float(low[:-(len(u + suffix))]) * mult)
                except ValueError:
                    pass
    # a bare byte suffix ('512B') has no unit prefix to match above
    if low.endswith("b") and low[:-1]:
        low = low[:-1]
    return int(float(low))


def _render_live(record, mem_only=True) -> str:
    metrics = record.get("metrics", {})
    rows = [(name, m) for name, m in sorted(metrics.items())
            if name.startswith("mem/") or not mem_only]
    lines = [f"memory ledger @ step {record.get('step')}"]
    if not rows:
        lines.append("  (no mem/* gauges in this snapshot — was "
                     "telemetry.memscope enabled?)")
    for name, m in rows:
        val = m.get("value", 0)
        if name.endswith("_frac"):
            lines.append(f"  {name:<28} {val:.3f}")
        else:
            lines.append(f"  {name:<28} {fmt_bytes(val)}")
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.telemetry.memscope",
        description="device-memory ledger viewer + pre-flight capacity "
                    "planner (deepspeed_tpu_torch/telemetry/memscope.py).")
    ap.add_argument("path", nargs="?", default="telemetry",
                    help="telemetry dir or metrics .jsonl (live-ledger "
                         "mode; default ./telemetry)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--plan", choices=["train", "serving"],
                    help="run the pre-flight planner instead of reading "
                         "a live ledger")
    # shared planner knobs
    ap.add_argument("--params", type=float, default=0,
                    help="parameter count (e.g. 1.3e9)")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--capacity", default="0",
                    help="per-device memory (e.g. 80G); 0 = just report bytes")
    ap.add_argument("--tp", type=int, default=1)
    # train planner
    ap.add_argument("--zero", type=int, default=0)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--no-master", action="store_true")
    ap.add_argument("--offload-optimizer", action="store_true")
    ap.add_argument("--offload-param", action="store_true")
    ap.add_argument("--offload-param-bytes", type=float, default=0,
                    help="exact host bytes of a live LayerParamStore "
                         "(overrides the n-params estimate for the host "
                         "params column — byte-identical planning)")
    ap.add_argument("--staging-layers", type=int, default=0,
                    help="offload staging-pool depth (lookahead+1): prices "
                         "the device-resident weight window next to the "
                         "host column")
    ap.add_argument("--layer-bytes", type=float, default=0,
                    help="bit16 bytes of ONE layer's weights (with "
                         "--staging-layers: the staging window's unit)")
    ap.add_argument("--num-experts", type=int, default=0,
                    help="MoE: total expert count (informational in the "
                         "plan notes; pair with --expert-params/--ep-size)")
    ap.add_argument("--ep-size", type=int, default=1,
                    help="MoE: expert-parallel axis size — expert weights "
                         "shard /ep_size per chip on top of the ZeRO/TP "
                         "denominators")
    ap.add_argument("--expert-params", type=float, default=0,
                    help="MoE: parameter count of ALL expert weights "
                         "(a slice of --params; e.g. 8 experts x 50e6)")
    # serving planner
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--kv-heads", type=int, default=0)
    ap.add_argument("--head-dim", type=int, default=0)
    ap.add_argument("--block-size", type=int, default=512)
    ap.add_argument("--blocks", type=int, default=0,
                    help="num_kv_blocks (serving plan)")
    ap.add_argument("--kv-dtype", default="bfloat16")
    ap.add_argument("--kv-group", type=int, default=0,
                    help="int8 pool scale-group size (0 = head_dim); "
                         "prices the f32 scales next to the payload")
    ap.add_argument("--fit", action="store_true",
                    help="serving: report the LARGEST num_kv_blocks that "
                         "fits --capacity instead of judging --blocks")
    ap.add_argument("--sp", type=int, default=1,
                    help="serving: sequence_parallel — price the sequence-"
                         "sharded pool (inference/sequence_span.py): "
                         "per-chip KV bytes are 1/sp of the global pool; "
                         "--fit answers the GLOBAL block count ~sp times "
                         "a single chip's")
    args = ap.parse_args(argv)
    try:
        capacity = _parse_size(args.capacity)
    except ValueError:
        print(f"memscope: cannot parse --capacity {args.capacity!r} "
              f"(try '16G', '512MiB', or plain bytes)", file=sys.stderr)
        return 1

    if args.plan == "train":
        plan = plan_training(int(args.params), zero_stage=args.zero,
                             dp=args.dp, tp=args.tp, dtype=args.dtype,
                             master_weights=not args.no_master,
                             offload_optimizer=args.offload_optimizer,
                             offload_param=args.offload_param,
                             offload_param_bytes=(int(args.offload_param_bytes)
                                                  or None),
                             offload_staging_layers=args.staging_layers,
                             offload_layer_bytes=int(args.layer_bytes),
                             num_experts=args.num_experts,
                             ep_size=args.ep_size,
                             n_expert_params=int(args.expert_params),
                             capacity_bytes=capacity)
        print(json.dumps(plan.to_dict()) if args.json else plan.render())
        return 0 if plan.fits is not False else 2

    if args.plan == "serving":
        if not (args.layers and args.kv_heads and args.head_dim):
            print("memscope: --plan serving needs --layers, "
                  "--kv-heads, --head-dim", file=sys.stderr)
            return 1
        if not args.fit and args.blocks <= 0:
            # without this a forgotten --blocks plans a zero-byte pool and
            # exits 0 with a FITS verdict — a trap for scripted gates
            print("memscope: --plan serving needs --blocks "
                  "(num_kv_blocks), or --fit to solve for it",
                  file=sys.stderr)
            return 1
        params_bytes = int(args.params * dtype_bytes(args.dtype))
        if args.fit:
            if not capacity:
                print("memscope: --fit needs --capacity",
                      file=sys.stderr)
                return 1
            per_dev_params = params_bytes // max(1, args.tp)
            blocks = max_kv_blocks(
                capacity, n_layer=args.layers, n_kv_head=args.kv_heads,
                head_dim=args.head_dim, kv_block_size=args.block_size,
                kv_cache_dtype=args.kv_dtype, kv_group_size=args.kv_group,
                params_bytes=per_dev_params,
                sequence_parallel=args.sp)
            # one trash block is reserved PER SHARD (the flat pool's
            # block 0; every sequence shard's local block 0 under --sp)
            sp = max(1, args.sp)
            usable = max(0, blocks - sp)
            out = {"max_kv_blocks": blocks,
                   "usable_blocks": usable,
                   "capacity_bytes": capacity,
                   "params_bytes": per_dev_params}
            print(json.dumps(out) if args.json else
                  f"largest num_kv_blocks that fits "
                  f"{fmt_bytes(capacity)}: {blocks} "
                  f"({usable} usable past the trash "
                  f"block{'s' if sp > 1 else ''})")
            return 0
        plan = plan_serving(
            n_layer=args.layers, n_kv_head=args.kv_heads,
            head_dim=args.head_dim, kv_block_size=args.block_size,
            num_kv_blocks=args.blocks, kv_cache_dtype=args.kv_dtype,
            kv_group_size=args.kv_group,
            params_bytes=params_bytes, tp=args.tp,
            sequence_parallel=args.sp, capacity_bytes=capacity)
        print(json.dumps(plan.to_dict()) if args.json else plan.render())
        return 0 if plan.fits is not False else 2

    # live-ledger mode: latest snapshot from the telemetry JSONL log
    record = load_latest(args.path)
    if record is None:
        print(f"memscope: no metrics log at {args.path!r}",
              file=sys.stderr)
        return 1
    if args.json:
        mem = {k: v for k, v in record.get("metrics", {}).items()
               if k.startswith("mem/")}
        print(json.dumps({"step": record.get("step"),
                          "time": record.get("time"), "metrics": mem}))
    else:
        print(_render_live(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
