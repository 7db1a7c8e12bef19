"""The port's memory ledger and capacity planner (`telemetry/memscope.py`)
held to the JAX package's: the planner's numbers and the CLI's `--plan`
JSON on the same inputs, the serving ledger's static fields and snapshot
on the same tiny serve configuration (the CPU has no allocator stats, so
both snapshots are attribution only), the router's pool aggregation, the
pre-flight refusal before any pool allocation, the headroom signal's
ladder levels on a scripted sequence, OOM matching and forensics, and
the training ledger and plan against the JAX engine's.

Every comparison is exact: the planner is integer arithmetic on the same
shapes, and the ledger counts the same tensors' bytes.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.serving import ServingRouter as JRouter
from deepspeed_tpu.serving.replica import InProcessReplica as JReplica
from deepspeed_tpu.telemetry import memscope as jms
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.inference.scheduler import Request
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.serving import ServingRouter as TRouter
from deepspeed_tpu_torch.serving.replica import InProcessReplica as TReplica
from deepspeed_tpu_torch.telemetry import memscope as tms
from tests.torch_serving_twins import (TELEMETRY, TINY, port_cfg,
                                       reset_mesh, twin_engines)

DRAFT = jgpt.GPTConfig(n_layer=1, n_head=2, d_model=32, max_seq_len=256,
                       vocab_size=256, dtype=jnp.float32, remat=False,
                       tie_embeddings=False)
CAP = 64 * 2**20


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tel(path, **over):
    return {"telemetry": {**TELEMETRY, "output_path": str(path),
                          "memscope": True, "memscope_programs": False,
                          "memscope_capacity_bytes": CAP, **over}}


# ----------------------------------------------------------------------
# the planner
# ----------------------------------------------------------------------

_PLANS = [
    ("plan_training", dict(n_params=1.3e9, zero_stage=3, dp=8,
                           capacity_bytes=16 * 2**30)),
    ("plan_training", dict(n_params=7e8, zero_stage=1, tp=2,
                           dtype="float16", grad_accum_dtype="fp32")),
    ("plan_training", dict(n_params=1e8, master_weights=False,
                           optimizer_moments=1, offload_optimizer=True)),
    ("plan_training", dict(n_params=4e9, zero_stage=3, dp=4,
                           offload_param=True, offload_param_bytes=12345678,
                           offload_staging_layers=3,
                           offload_layer_bytes=1 << 20, temp_bytes=1 << 28,
                           capacity_bytes=8 * 2**30)),
    ("plan_training", dict(n_params=2e9, zero_stage=2, dp=2, num_experts=8,
                           ep_size=4, n_expert_params=1.5e9)),
    ("plan_serving", dict(n_layer=12, n_kv_head=12, head_dim=64,
                          kv_block_size=16, num_kv_blocks=513,
                          n_params=1.24e8, capacity_bytes=2**30)),
    ("plan_serving", dict(n_layer=24, n_kv_head=8, head_dim=128,
                          kv_block_size=64, num_kv_blocks=1000,
                          kv_cache_dtype="int8", kv_group_size=64,
                          params_bytes=3 << 30, tp=2, sequence_parallel=2)),
    ("plan_serving", dict(n_layer=4, n_kv_head=4, head_dim=32,
                          kv_block_size=16, num_kv_blocks=65,
                          draft={"n_layer": 1, "n_kv_head": 2,
                                 "head_dim": 16, "n_params": 1e6},
                          temp_bytes=4096)),
    ("max_kv_blocks", dict(capacity_bytes=80 * 2**30, n_layer=12,
                           n_kv_head=12, head_dim=64, kv_block_size=16,
                           params_bytes=250 << 20)),
    ("max_kv_blocks", dict(capacity_bytes=16 * 2**30, n_layer=24,
                           n_kv_head=8, head_dim=128, kv_block_size=64,
                           kv_cache_dtype="int8", kv_group_size=128,
                           sequence_parallel=4,
                           draft={"n_layer": 2, "n_kv_head": 2,
                                  "head_dim": 64, "params_bytes": 1 << 20})),
    ("serving_pool_bytes", dict(n_layer=12, n_kv_head=12, head_dim=64,
                                kv_block_size=16, num_kv_blocks=100)),
    ("serving_pool_bytes", dict(n_layer=12, n_kv_head=12, head_dim=64,
                                kv_block_size=16, num_kv_blocks=100,
                                kv_cache_dtype="int8")),
    ("serving_pool_bytes", dict(n_layer=2, n_kv_head=3, head_dim=64,
                                kv_block_size=8, num_kv_blocks=9,
                                kv_cache_dtype="uint8")),
    ("estimate_zero2_model_states_mem_needs",
     dict(total_params=1.5e9, num_devices=8, cpu_offload=True)),
    ("estimate_zero3_model_states_mem_needs",
     dict(total_params=6.7e9, num_devices=16, cpu_offload=True,
          cpu_offload_params=True)),
]


@pytest.mark.parametrize("fn,kw", _PLANS,
                         ids=[f"{f}-{i}" for i, (f, _) in enumerate(_PLANS)])
def test_planner_numbers_are_jax(fn, kw):
    j, t = getattr(jms, fn)(**kw), getattr(tms, fn)(**kw)
    if fn.startswith(("plan_", "estimate_")):
        assert t.to_dict() == j.to_dict()
        assert t.render() == j.render()
    else:
        assert t == j


def test_dtype_and_size_helpers_match_jax():
    for d in ("bfloat16", "bf16", "float32", "int8", "uint8", "float16",
              np.float32, np.dtype("int32")):
        assert tms.dtype_bytes(d) == jms.dtype_bytes(d)
    assert tms.dtype_bytes(torch.bfloat16) == jms.dtype_bytes(jnp.bfloat16)
    for n in (0, 1023, 1024, 5 * 2**20 + 7, -3 * 2**30):
        assert tms.fmt_bytes(n) == jms.fmt_bytes(n)
    for s in ("16G", "16GiB", "512M", "512B", "1.5e9", "4096", "80g"):
        assert tms._parse_size(s) == jms._parse_size(s)
    for d in ("int8", "uint8", "bfloat16"):
        assert tms.kv_cache_is_quantized(d) == jms.kv_cache_is_quantized(d)
    assert tms.kv_cache_is_quantized(torch.int8)
    assert not tms.kv_cache_is_quantized(torch.uint8)


_CLI = [
    ["--plan", "train", "--params", "1.3e9", "--zero", "3", "--dp", "8",
     "--capacity", "16G", "--json"],
    ["--plan", "train", "--params", "7e9", "--capacity", "16G", "--json"],
    ["--plan", "train", "--params", "4e9", "--offload-param",
     "--offload-param-bytes", "8e9", "--staging-layers", "3",
     "--layer-bytes", "2e8", "--num-experts", "8", "--ep-size", "2",
     "--expert-params", "1e9", "--json"],
    ["--plan", "serving", "--params", "1.24e8", "--layers", "12",
     "--kv-heads", "12", "--head-dim", "64", "--block-size", "16",
     "--blocks", "4096", "--capacity", "80G", "--json"],
    ["--plan", "serving", "--params", "1.24e8", "--layers", "12",
     "--kv-heads", "12", "--head-dim", "64", "--kv-dtype", "int8",
     "--kv-group", "32", "--capacity", "80G", "--fit", "--sp", "2", "--json"],
    ["--plan", "serving", "--layers", "12", "--kv-heads", "12",
     "--head-dim", "64", "--json"],
    ["--plan", "serving", "--layers", "12", "--kv-heads", "12",
     "--head-dim", "64", "--fit", "--json"],
    ["--plan", "train", "--params", "1e9", "--capacity", "lots"],
]


@pytest.mark.parametrize("argv", _CLI, ids=range(len(_CLI)))
def test_cli_plan_json_is_jax(argv, capsys):
    rc_t = tms.main(argv)
    out_t = capsys.readouterr().out
    rc_j = jms.main(argv)
    out_j = capsys.readouterr().out
    assert rc_t == rc_j
    assert (json.loads(out_t) if out_t else None) == \
        (json.loads(out_j) if out_j else None)


def test_cli_live_mode_reads_the_ledger_gauges(tmp_path, capsys):
    log = tmp_path / "serving.jsonl"
    rec = {"step": 3, "time": 1.0, "metrics": {
        "mem/kv_pool_bytes": {"type": "gauge", "value": 2**20},
        "mem/headroom_frac": {"type": "gauge", "value": 0.25},
        "serving/queue_depth": {"type": "gauge", "value": 1}}}
    log.write_text(json.dumps(rec) + "\n{torn")
    for argv in ([str(tmp_path), "--json"], [str(log)]):
        assert tms.main(argv) == jms.main(argv) == 0
        out = capsys.readouterr().out.strip().split("\n")
        half = len(out) // 2
        assert out[:half] == out[half:]
    assert tms.main([str(tmp_path / "none")]) == 1


def test_resource_exhausted_matching():
    errors = [RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating"),
              RuntimeError("CUDA out of memory. Tried to allocate 2 GiB"),
              ValueError("bad shape"), KeyError("Failed to allocate")]
    for e in errors:
        assert tms.is_resource_exhausted(e) == jms.is_resource_exhausted(e)
    assert tms.is_resource_exhausted(torch.OutOfMemoryError("no text"))
    try:
        try:
            raise torch.OutOfMemoryError("x")
        except torch.OutOfMemoryError as inner:
            raise ValueError("step failed") from inner
    except ValueError as outer:
        assert tms.is_resource_exhausted(outer)


# ----------------------------------------------------------------------
# the serving ledger
# ----------------------------------------------------------------------


def _draft_specs():
    reset_mesh()
    jd = jgpt.make_gpt_decode_model(cfg=DRAFT, name="draft")
    td = tgpt.make_gpt_decode_model(
        port_cfg(DRAFT), name="draft", params=tgpt.params_from_jax(
            jax.tree_util.tree_map(np.asarray, jd.params)))
    return jd, td


def _reqs(n, seed=0):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 256, (32,)).astype(np.int32)
    return [(f"r{i}", np.concatenate([prefix, rng.integers(
        0, 256, (5 + i,)).astype(np.int32)])) for i in range(n)]


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    out = twin_engines(**_tel(tmp_path_factory.mktemp("ms")))
    yield out
    mesh_mod.clear_mesh()


@pytest.mark.parametrize("case", ["prefix", "draft", "int8"])
def test_serving_ledger_is_jax(twins, case):
    """params / pool / block / draft-mirror bytes and the whole snapshot
    (the prefix view after a shared-prefix trace) equal JAX's; the ledger
    counts exactly the pool's and the params' tensor bytes."""
    jeng, teng = twins
    kw = dict(max_slots=2, max_context=96)
    if case == "prefix":
        kw["enable_prefix_caching"] = True
    if case == "int8":
        kw["quantization"] = {"kv_cache_dtype": "int8", "kv_group_size": 8}
    servings = []
    for eng, side in ((jeng, 0), (teng, 1)):
        skw = dict(kw)
        if case == "draft":
            skw.update(spec_decode={"drafter": "model", "draft_k": 2},
                       draft_spec=_draft_specs()[side])
        servings.append(eng.serving(**skw))
    js, ts = servings
    if case == "prefix":
        from deepspeed_tpu.inference.scheduler import Request as JRequest
        for serving, R in ((js, JRequest), (ts, Request)):
            for uid, p in _reqs(3):
                serving.run([R(uid=uid, tokens=p, max_new_tokens=3,
                               stop_on_eos=False)])
    jm, tm = js.memscope, ts.memscope
    for attr in ("params_bytes", "pool_bytes", "block_bytes",
                 "draft_params_bytes", "draft_pool_bytes"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    assert tm.pool_bytes == sum(t.nbytes for t in ts.pool.values())
    assert tm.params_bytes == tms.tree_bytes(teng.params) == sum(
        t.nbytes for t in jax.tree_util.tree_leaves(
            teng.params, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    snap = tm.snapshot()
    assert snap == jm.snapshot()
    assert ts.stats()["memory"] == snap
    if case == "prefix":
        assert snap["prefix_cached_bytes"] > 0
    if case == "draft":
        assert snap["draft_pool_bytes"] > 0
    assert tm.plan().to_dict() == jm.plan().to_dict()
    assert tm.program_memory() == {}


def test_router_aggregates_the_ledgers_as_jax_does(twins):
    jeng, teng = twins
    aggs = []
    for eng, Replica, Router in ((jeng, JReplica, JRouter),
                                 (teng, TReplica, TRouter)):
        reps = [Replica(engine=eng.serving(max_slots=2 + i, max_context=96),
                        replica_id=f"r{i}") for i in range(2)]
        router = Router(replicas=reps)
        aggs.append((router.memory_snapshot(),
                     router.stats().get("memory")))
    assert aggs[1] == aggs[0]
    agg = aggs[1][0]
    assert set(agg["replicas"]) == {"r0", "r1"}
    assert agg["kv_pool_bytes"] == sum(r["kv_pool_bytes"]
                                       for r in agg["replicas"].values())


def test_preflight_refuses_before_any_pool_allocation(twins, tmp_path):
    """capacity 1 KiB + "refuse": PredictedOOMError in both packages before
    the pool exists — the port's only pool built is the meta-device one;
    "warn" builds and keeps the failed verdict as last_plan."""
    jtw, ttw = twin_engines(**_tel(tmp_path, memscope_capacity_bytes=1024,
                                   memscope_preflight="refuse"))
    devices = []
    real = ttw.model_spec.init_paged_pool

    def recording(*a, **k):
        devices.append(str(k.get("device")))
        return real(*a, **k)

    ttw.model_spec.init_paged_pool = recording
    for eng in (jtw, ttw):
        with pytest.raises((jms.PredictedOOMError, tms.PredictedOOMError),
                           match="predicted OOM"):
            eng.serving(max_slots=2, max_context=96)
    assert devices == ["meta"]
    jw, tw = twin_engines(**_tel(tmp_path, memscope_capacity_bytes=1024))
    plans = [e.serving(max_slots=2, max_context=96).memscope.last_plan
             for e in (jw, tw)]
    assert plans[1].fits is False and plans[0].fits is False
    assert plans[1].device_bytes == plans[0].device_bytes
    mesh_mod.clear_mesh()


def test_headroom_drives_the_ladder_as_in_jax(twins):
    """A scripted headroom sequence, the pool and queue signals held calm:
    the ladder's level after every evaluation is JAX's."""
    script = [0.5, 0.1, 0.1, 0.25, 0.1, 0.4, 0.45, 0.4, 0.6, 0.6, 0.6, 0.6]
    levels = []
    for eng in twins:
        serving = eng.serving(
            max_slots=2, max_context=96,
            degradation={"enabled": True, "eval_interval": 1,
                         "free_block_low": -1.0, "free_block_high": -1.0,
                         "queue_high": 10**6, "queue_low": 10**6,
                         "hold_steps": 2, "headroom_low": 0.2,
                         "headroom_high": 0.35})
        it = iter(script)
        serving.memscope.headroom_frac = lambda: next(it)
        seen = []
        for _ in script:
            serving.pressure.update([])
            seen.append(serving.pressure.level)
        levels.append(seen)
    assert levels[1] == levels[0]
    assert max(levels[1]) >= 1 and levels[1][-1] == 0


def test_oom_in_a_step_dumps_the_ledger_and_reraises(tmp_path):
    _, teng = twin_engines(**_tel(tmp_path, flight_recorder=True))
    serving = teng.serving(max_slots=2, max_context=96)
    serving.run([Request(uid="w", tokens=np.arange(9, dtype=np.int32),
                         max_new_tokens=3, stop_on_eos=False)])

    def boom(*a, **k):
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                     "allocate 12345 bytes")

    serving._decode_step = boom
    serving.submit(Request(uid=99, tokens=np.arange(9, dtype=np.int32),
                           max_new_tokens=4, stop_on_eos=False))
    with pytest.raises(torch.OutOfMemoryError):
        while True:
            serving.step()
    dumps = sorted(tmp_path.glob("serving.memscope.oom.*.json"))
    assert len(dumps) == 1
    d = json.loads(dumps[0].read_text())
    assert "OutOfMemoryError" in d["reason"]
    assert d["ledger"]["kv_pool_bytes"] == tms.tree_bytes(serving.pool)
    assert d["plan_delta"]["predicted_peak_bytes"] > 0
    assert "admit" in {e["kind"] for e in d["flight_events"]}
    assert list(tmp_path.glob("serving.flightrec.*.json"))
    serving._decode_step = lambda *a, **k: (_ for _ in ()).throw(
        ValueError("not an OOM"))
    serving.submit(Request(uid=7, tokens=np.arange(9, dtype=np.int32),
                           max_new_tokens=4, stop_on_eos=False))
    with pytest.raises(ValueError):
        while True:
            serving.step()
    assert len(list(tmp_path.glob("*.oom.*.json"))) == 1
    mesh_mod.clear_mesh()


# ----------------------------------------------------------------------
# the training ledger
# ----------------------------------------------------------------------

TRAIN = {"train_micro_batch_size_per_gpu": 4,
         "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
         "bf16": {"enabled": True}, "zero_optimization": {"stage": 1}}


def test_train_ledger_and_plan_match_the_jax_engine(tmp_path):
    """The ledger's model-state bytes are the state tensors' bytes; the
    plan from the live engine is JAX's `plan_training_from_engine` of the
    JAX engine with the same config; total less grads is the ledger but
    the optimizer's 4-byte count."""
    spec = jgpt.make_gpt_model(cfg=TINY, name="tiny", seed=2)
    np_params = jax.tree_util.tree_map(np.asarray, spec.params)
    reset_mesh()
    jeng, *_ = deepspeed_tpu.initialize(
        model=spec, config={**TRAIN, "mesh": {"data": 1},
                            **_tel(tmp_path / "j")})
    cfg = dataclasses.replace(port_cfg(TINY), dtype=torch.bfloat16)
    teng, *_ = initialize(
        model=tgpt.make_gpt_model(cfg, name="tiny",
                                  params=tgpt.params_from_jax(np_params)),
        config={**TRAIN, "memory_breakdown": True, "steps_per_print": 1,
                **_tel(tmp_path / "t")}, device="cpu")
    ms = teng.memscope
    assert ms.last_plan is not None and ms.last_plan.fits
    tokens = np.random.default_rng(0).integers(0, 256, (4, 17))
    teng.train_batch({"tokens": tokens.astype(np.int32)})
    st = teng.state
    nbytes = {k: sum(t.nbytes for t in jax.tree_util.tree_leaves(
        v, is_leaf=lambda x: isinstance(x, torch.Tensor)))
        for k, v in (("params_bytes", st.params),
                     ("master_bytes", st.master),
                     ("opt_state_bytes", st.opt_state))}
    snap = ms.snapshot()
    assert {k: snap[k] for k in nbytes} == nbytes
    assert snap == jeng.memscope.snapshot(programs=False) | {
        "program_temp_bytes": 0, "attributed_bytes": sum(nbytes.values())}
    plan = ms.plan()
    assert plan.to_dict() == jms.plan_training_from_engine(
        jeng, capacity_bytes=CAP).to_dict()
    # the planner prices the moments, not the optimizer's count scalar
    assert sum(nbytes.values()) - (plan.total_device_bytes -
                                   plan.device_bytes["grads"]) == \
        st.opt_state["count"].nbytes
    gauges = teng.telemetry.registry.snapshot()
    assert gauges["mem/params_bytes"]["value"] == nbytes["params_bytes"]
    assert "mem/bytes_in_use" in gauges      # memory_breakdown's reading
    mesh_mod.clear_mesh()


def test_train_oom_dumps_and_disabled_default(tmp_path, monkeypatch):
    cfg = dataclasses.replace(port_cfg(TINY), dtype=torch.bfloat16)
    eng, *_ = initialize(model=tgpt.make_gpt_model(cfg, name="tiny"),
                         config={**TRAIN, **_tel(tmp_path)}, device="cpu")

    def boom(*a, **k):
        raise torch.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(eng, "_grads", boom)
    with pytest.raises(torch.OutOfMemoryError):
        eng.train_batch({"tokens": np.zeros((4, 9), np.int32)})
    d = json.loads((tmp_path / "train.memscope.oom.000.json").read_text())
    assert d["ledger"]["opt_state_bytes"] == tms.tree_bytes(
        eng.state.opt_state)
    plain, *_ = initialize(model=tgpt.make_gpt_model(cfg, name="tiny"),
                           config=TRAIN, device="cpu")
    assert plain.memscope is None
    serving = twin_engines()[1].serving(max_slots=2, max_context=96)
    assert serving.memscope is None and "memory" not in serving.stats()
    mesh_mod.clear_mesh()


def test_step_resets_keep_the_runs_peak(monkeypatch):
    """Each step resets the allocator's peak to measure its temp; the
    ledger keeps the run's peak across the resets (a scripted allocator:
    the card's is not here)."""
    alloc = {"now": 100, "peak": 100}

    def reset(device=None):
        alloc["peak"] = alloc["now"]

    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", reset)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: alloc["now"])
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda device=None: alloc["peak"])
    scope = tms._MemScopeBase(None, device="cuda")
    for transient in (900, 300):
        scope.begin_step()
        alloc["peak"] = alloc["now"] + transient
        scope.end_step()
    assert scope.temp_bytes == 900
    assert scope.peak_bytes() == 1000
    scope.begin_step()
    assert alloc["peak"] == 100 and scope.peak_bytes() == 1000
    assert tms._MemScopeBase(None, device="cpu").peak_bytes() == 0
