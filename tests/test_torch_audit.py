"""The port's pool auditor and degradation ladder held to the JAX
package's: the audit state of a live engine, each planted corruption
class (I1-I6) detected and repaired, the scheduled audit, the offline
form, and the ladder's hysteresis, engagement, shedding and recovery —
fp32 on the CPU with the same numpy-seeded weights.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.config.core import MeshConfig
from deepspeed_tpu.inference import audit as jaudit
from deepspeed_tpu.inference.config import DegradationConfig as JaxDegr
from deepspeed_tpu.inference.engine import init_inference as jax_init
from deepspeed_tpu.inference.scheduler import Request as JaxRequest
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.serving.degradation import \
    PressureController as JaxController
from deepspeed_tpu.testing.chaos import SAFE_CORRUPTIONS, corrupt_pool
from deepspeed_tpu_torch.inference import audit as taudit
from deepspeed_tpu_torch.inference.config import (DegradationConfig,
                                                  TpuInferenceConfig)
from deepspeed_tpu_torch.inference.engine import init_inference
from deepspeed_tpu_torch.inference.kv_cache import TRASH_BLOCK
from deepspeed_tpu_torch.inference.scheduler import Request
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.serving.degradation import (LEVEL_NAMES, MAX_LEVEL,
                                                     PressureController)

BS = 16
LIVELY = jgpt.GPTConfig(n_layer=2, n_head=4, d_model=64, max_seq_len=256,
                        vocab_size=256, dtype=jnp.float32, remat=False,
                        tie_embeddings=False)
CONF = {"dtype": "float32", "kv_cache_dtype": "float32", "greedy": True,
        "kv_block_size": BS, "max_out_tokens": 64}
TELEMETRY = {"enabled": True, "prometheus": False, "jsonl": False,
             "monitor_bridge": False}


def _port_cfg(jcfg):
    names = [f.name for f in dataclasses.fields(tgpt.GPTConfig)
             if f.name not in ("dtype", "softmax_dtype", "remat",
                               "remat_policy", "use_flash_attention")]
    return tgpt.GPTConfig(**{n: getattr(jcfg, n) for n in names
                             if hasattr(jcfg, n)}, dtype="float32")


def _twins(**conf):
    mesh_mod._CURRENT_MESH = None
    mesh_mod._CURRENT_SPEC = None
    mesh_mod.init_mesh(MeshConfig(data=1, tensor=1, sequence=1, expert=1,
                                  pipe=1))
    jspec = jgpt.make_gpt_decode_model(cfg=LIVELY, name="tiny")
    tspec = tgpt.make_gpt_decode_model(
        _port_cfg(LIVELY), name="tiny", params=tgpt.params_from_jax(
            jax.tree_util.tree_map(np.asarray, jspec.params)))
    return (jax_init(model=jspec, config={**CONF, **conf}),
            init_inference(tspec, config={**CONF, **conf}, device="cpu"))


@pytest.fixture(scope="module")
def twins():
    return _twins()


def _replica(engine, **over):
    kw = dict(max_slots=2, max_context=96, prefill_chunk=BS,
              enable_prefix_caching=True)
    kw.update(over)
    return engine.serving(**kw)


def _busy(engine, cls, n_active=2, **over):
    """A serving engine with `n_active` slots mid-generation."""
    rng = np.random.default_rng(20)
    serving = _replica(engine, max_slots=max(2, n_active), **over)
    for i in range(n_active):
        p = rng.integers(0, 256, (5 + 3 * i,)).astype(np.int32)
        serving.submit(cls(uid=f"busy{i}", tokens=p, max_new_tokens=24,
                           stop_on_eos=False))
    for _ in range(3):
        serving.step()
    assert serving.num_active == n_active
    return serving


def _drain(serving):
    out = {}
    while serving.num_active or serving.queue_depth:
        for d in serving.step():
            out[d.uid] = d
    return out


def _shared_prefix(rng, n, blocks=2):
    prefix = rng.integers(0, 256, (blocks * BS,)).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(0, 256, (int(t),))
                            .astype(np.int32)])
            for t in rng.integers(2, 14, (n,))]


# ----------------------------------------------------------------------
# the auditor
# ----------------------------------------------------------------------


def test_audit_state_equals_jax_through_a_trace(twins):
    """Both engines stepped in lockstep over a shared-prefix trace: the
    portable audit state (free list, refcounts, reclaimable LRU, hash maps,
    slot blocks, tables) equals JAX's after every step, and every audit is
    clean."""
    je, te = twins
    prompts = _shared_prefix(np.random.default_rng(21), 5)
    js, ts = _replica(je, max_slots=3), _replica(te, max_slots=3)
    for i, p in enumerate(prompts):
        js.submit(JaxRequest(uid=i, tokens=p, max_new_tokens=4 + i,
                             stop_on_eos=False))
        ts.submit(Request(uid=i, tokens=p, max_new_tokens=4 + i,
                          stop_on_eos=False))
    steps = 0
    while ts.num_active or ts.queue_depth:
        js.step()
        ts.step()
        steps += 1
        assert ts.audit_state() == js.audit_state(), steps
        assert taudit.audit_state_dict(ts.audit_state()).ok
    assert not (js.num_active or js.queue_depth)
    assert ts.allocator.num_reclaimable > 0
    report = ts.close()
    assert report.ok and report.summary() == js.close().summary()
    assert ts.stats()["audit"] == js.stats()["audit"]


@pytest.mark.parametrize("kind,expect", [
    ("leak", "leak"),                            # I5
    ("refcount_over", "refcount_drift"),         # I2
    ("refcount_under", "refcount_drift"),        # I2
    ("double_ref", "free_referenced"),           # I1
    ("free_dup", "free_list_corrupt"),           # I1 structure
    ("stale_hash", "stale_hash"),                # I3
])
def test_each_corruption_class_detected_and_repaired(twins, kind, expect):
    """The same corruption planted in both packages' busy engines: the
    report buckets it alike, `repair()` reaches a clean state, and the
    repaired engine drains with every block home."""
    je, te = twins
    reports = []
    for engine, cls in ((je, JaxRequest), (te, Request)):
        serving = _busy(engine, cls)
        assert corrupt_pool(serving, kind, np.random.default_rng(7)) \
            is not None
        report = serving.audit()
        assert not report.ok and expect in report.by_kind(), report.summary()
        reports.append(report.to_dict())
        summary = serving._auditor.repair()
        assert summary["clean"], summary
        assert serving.audit().ok
        _drain(serving)
        alloc = serving.allocator
        assert alloc.num_free + alloc.num_reclaimable == alloc.capacity
    assert reports[1] == reports[0]


@pytest.mark.parametrize("invariant", ["I4_trash", "I6_table_row",
                                       "I6_free_slot", "I2_unparked"])
def test_trash_table_and_parking_invariants(twins, invariant):
    """The classes no corruption kind produces, planted in the audit
    state and checked by both packages' `audit_state_dict` alike; the
    live engine stays clean."""
    _, te = twins
    serving = _busy(te, Request)
    state = serving.audit_state()
    if invariant == "I4_trash":
        state["refs"][str(TRASH_BLOCK)] = 1
        want = "trash_referenced"
    elif invariant == "I6_table_row":
        state["tables"][serving.slots[0].idx][0] = 99
        want = "table_mismatch"
    elif invariant == "I6_free_slot":
        state["slots"] = state["slots"][:1]
        state["refs"] = {b: c for b, c in state["refs"].items()}
        want = "table_mismatch"
    else:
        b = state["slots"][0]["blocks"][0]
        state["refs"][str(b)] = 0
        want = "refcount_drift"
    port, ref = taudit.audit_state_dict(state), \
        jaudit.audit_state_dict(json.loads(json.dumps(state)))
    assert want in port.by_kind()
    assert port.to_dict() == ref.to_dict()
    assert serving.audit().ok
    for s in list(serving.slots):
        if s.uid is not None:
            serving.cancel(s.uid)
    assert serving.close().ok


def test_repair_keeps_the_prefix_cache_matchable(twins):
    """Retired shared blocks park refcount-0; a stale hash and a leak are
    repaired without wiping the cache, and a warm rerun still hits."""
    _, te = twins
    rng = np.random.default_rng(21)
    serving = _replica(te)
    prompts = _shared_prefix(rng, 3)
    out = serving.run([Request(uid=i, tokens=p, max_new_tokens=3,
                               stop_on_eos=False)
                       for i, p in enumerate(prompts)])
    assert sorted(out) == [0, 1, 2]
    assert serving.allocator.num_reclaimable > 0
    cached = serving.prefix_cache.num_cached
    assert corrupt_pool(serving, "stale_hash", rng) is not None
    assert corrupt_pool(serving, "leak", rng) is not None
    assert {"stale_hash", "leak"} <= set(serving.audit().by_kind())
    assert serving._auditor.repair()["clean"]
    assert serving.prefix_cache.num_cached >= cached
    warm = serving.run([Request(uid="warm", tokens=prompts[0],
                                max_new_tokens=3, stop_on_eos=False)])
    assert warm["warm"].cached_prefix_tokens > 0


def test_scheduled_audit_repairs_midtrace_like_jax(twins):
    """audit_interval 1, audit_action "repair": corruption planted between
    steps (the safe kinds, in turn) is repaired by the next sync's audit
    in both packages alike; tokens stay those of the clean run."""
    je, te = twins
    prompts = [np.random.default_rng(22).integers(0, 256, (n,))
               .astype(np.int32) for n in (5, 9, 21, 4)]
    outs, stats = [], []
    for engine, cls in ((je, JaxRequest), (te, Request)):
        serving = _replica(engine, audit_interval=1)
        rng = np.random.default_rng(22)
        for i, p in enumerate(prompts):
            serving.submit(cls(uid=i, tokens=p, max_new_tokens=6,
                               stop_on_eos=False))
        out, k = {}, 0
        while serving.num_active or serving.queue_depth:
            for d in serving.step():
                out[d.uid] = d
            if k % 3 == 1:
                corrupt_pool(serving, SAFE_CORRUPTIONS[
                    (k // 3) % len(SAFE_CORRUPTIONS)], rng)
            k += 1
        st = serving.stats()["audit"]
        assert st["runs"] >= k and st["repairs"] >= 1 and st["violations"]
        assert serving.audit().ok
        outs.append(out)
        stats.append(st)
    assert stats[1] == stats[0]
    clean = _replica(te).run([Request(uid=i, tokens=p, max_new_tokens=6,
                                      stop_on_eos=False)
                              for i, p in enumerate(prompts)])
    for i in range(len(prompts)):
        np.testing.assert_array_equal(outs[1][i].tokens, outs[0][i].tokens)
        np.testing.assert_array_equal(outs[1][i].tokens, clean[i].tokens)


def test_audit_action_raise_and_unknown_action(twins):
    _, te = twins
    serving = _busy(te, Request, audit_interval=1, audit_action="raise")
    corrupt_pool(serving, "leak", np.random.default_rng(3))
    with pytest.raises(taudit.PoolCorruptionError, match="leak"):
        for _ in range(2):
            serving.step()
    assert serving._auditor.repair()["clean"]
    with pytest.raises(ValueError, match="audit_action"):
        _replica(te, audit_action="ignore")


def test_audit_telemetry_counters():
    _, te = _twins(telemetry=TELEMETRY)
    serving = _busy(te, Request)
    corrupt_pool(serving, "leak", np.random.default_rng(4))
    serving.audit(repair=True)
    snap = serving.telemetry.registry.snapshot()
    assert snap["serving/audit_violations"]["value"] == 1
    assert snap["serving/audit_repairs"]["value"] == 1
    assert serving.stats()["audit"] == {"runs": 1, "violations": 1,
                                        "repairs": 1}


def test_audit_main_offline(twins, tmp_path, capsys):
    """`audit_main` reads a dumped state (raw, or nested in a dump-shaped
    document): exit 0 clean, 1 violations, 2 no state — as the JAX CLI."""
    _, te = twins
    serving = _busy(te, Request)
    clean = tmp_path / "clean.json"
    clean.write_text(json.dumps(serving.audit_state()))
    assert taudit.audit_main([str(clean)]) == 0
    assert "clean" in capsys.readouterr().out
    corrupt_pool(serving, "double_ref", np.random.default_rng(5))
    dirty = tmp_path / "dirty.json"
    dirty.write_text(json.dumps(
        {"reason": "test", "state": {"audit_state": serving.audit_state()}}))
    assert taudit.audit_main([str(dirty)]) == 1
    assert "free_referenced" in capsys.readouterr().out
    assert taudit.audit_main([str(dirty), "--json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["states"][0]["by_kind"]["free_referenced"] == 1
    assert jaudit.audit_main([str(dirty), "--json"]) == 1
    assert json.loads(capsys.readouterr().out) == doc
    junk = tmp_path / "junk.json"
    junk.write_text(json.dumps({"not": "an audit state"}))
    assert taudit.audit_main([str(junk)]) == 2
    serving._auditor.repair()


# ----------------------------------------------------------------------
# the degradation ladder
# ----------------------------------------------------------------------


class _FakeAlloc:
    def __init__(self):
        self.capacity = 100
        self.available = 100

    def flush_reclaimable(self, keep=0):
        return 0


class _FakeEngine:
    """Just enough engine for a controller: the test drives the signals."""

    def __init__(self):
        self.allocator = _FakeAlloc()
        self.queue = []
        self.degradation_sheds = 0

        class _Off:
            enabled = False
        self.telemetry = _Off()
        self.flightrec = _Off()

    def shed_queued_below_priority(self, pr):
        return []


def test_ladder_hysteresis_equals_jax():
    """One rung a pressured evaluation, the band holds the level and
    resets the calm streak, hold_steps calm evaluations a rung down, an
    oscillating signal cannot flap: both controllers walk the same levels
    and report the same stats on the same signal sequence."""
    kw = dict(enabled=True, eval_interval=1, queue_high=10, queue_low=2,
              free_block_low=0.0, free_block_high=0.0, hold_steps=2)
    pcs = [(PressureController(_FakeEngine(), DegradationConfig(**kw))),
           (JaxController(_FakeEngine(), JaxDegr(**kw)))]
    queues = [20] * 3 + [5] * 5 + [0] * 2 + [5, 0] * 6 + [0] * 6
    levels = [[], []]
    for q in queues:
        for i, pc in enumerate(pcs):
            pc.engine.queue = [None] * q
            pc.update([])
            levels[i].append(pc.level)
    assert levels[0] == levels[1]
    assert max(levels[0]) == 3 and levels[0][-1] == 0
    assert levels[0][:3] == [1, 2, 3] and levels[0][8] == 3
    assert pcs[0].stats() == pcs[1].stats()
    assert pcs[0].stats()["escalations"] == 3
    assert (LEVEL_NAMES, MAX_LEVEL) == (("normal", "cap_draft", "no_spec",
                                         "window_1", "flush_cache",
                                         "shed"), 5)


def test_ladder_flags_follow_the_level():
    pc = PressureController(_FakeEngine(), DegradationConfig(
        enabled=True, eval_interval=2, queue_high=1, free_block_low=0.0,
        free_block_high=0.0))
    pc.engine.queue = [None] * 3
    flags = []
    for _ in range(6):
        pc.update([])
        flags.append((pc.level, pc.draft_cap, pc.spec_disabled,
                      pc.force_window_1))
    assert flags == [(0, None, False, False), (1, 1, False, False),
                     (1, 1, False, False), (2, 1, True, False),
                     (2, 1, True, False), (3, 1, True, True)]


def _ladder_trace(engine, cls, **spec):
    serving = engine.serving(
        max_slots=1, max_context=96, prefill_chunk=BS,
        enable_prefix_caching=True, **spec,
        degradation={"enabled": True, "eval_interval": 1, "queue_high": 4,
                     "queue_low": 1, "free_block_low": 0.0,
                     "free_block_high": 0.0, "hold_steps": 2,
                     "shed_below_priority": 1})
    p = np.random.default_rng(50).integers(0, 256, (6,)).astype(np.int32)
    reqs = [cls(uid=i, tokens=p, max_new_tokens=8, stop_on_eos=False,
                priority=1) for i in range(10)]
    reqs += [cls(uid=f"low{i}", tokens=p, max_new_tokens=8,
                 stop_on_eos=False, priority=0) for i in range(2)]
    for r in reqs:
        serving.submit(r)
    done, levels = {}, []
    while serving.num_active or serving.queue_depth:
        for d in serving.step():
            done[d.uid] = d
        levels.append(serving.pressure.level)
    return serving, done, levels


@pytest.mark.parametrize("spec", ["off", "ngram"])
def test_ladder_engages_sheds_and_recovers_like_jax(spec):
    """Queue pressure on a real engine walks the ladder to the top, sheds
    exactly the priority-0 queued requests, never rises again after its
    peak and ends at level 0; levels, tokens and the degradation block
    equal JAX's; the `serving/degradation_level` gauge reads the level."""
    je, te = _twins(telemetry=TELEMETRY)
    kw = {} if spec == "off" else {
        "spec_decode": {"drafter": "ngram", "draft_k": 3}}
    js, jdone, jlevels = _ladder_trace(je, JaxRequest, **kw)
    ts, tdone, tlevels = _ladder_trace(te, Request, **kw)
    assert tlevels == jlevels
    assert max(tlevels) == MAX_LEVEL and tlevels[-1] == 0
    peak = tlevels.index(max(tlevels))
    assert all(a >= b for a, b in zip(tlevels[peak:], tlevels[peak + 1:]))
    assert sorted(u for u, d in tdone.items()
                  if d.finish_reason == "cancelled") == ["low0", "low1"]
    assert sorted(tdone, key=str) == sorted(jdone, key=str)
    for uid in tdone:
        np.testing.assert_array_equal(tdone[uid].tokens, jdone[uid].tokens)
    st = ts.stats()["degradation"]
    assert st == js.stats()["degradation"]
    assert st["level"] == 0 and st["sheds"] == 2
    snap = ts.telemetry.registry.snapshot()
    assert snap["serving/degradation_level"]["value"] == 0
    assert snap["serving/degradation_sheds"]["value"] == 2
    if spec == "ngram":
        assert ts.stats()["spec_decode"] == js.stats()["spec_decode"]
    assert ts.close().ok


def test_ladder_disabled_builds_nothing(twins):
    _, te = twins
    serving = _replica(te, enable_prefix_caching=False,
                       decode_steps_per_sync=4)
    assert serving.pressure is None
    p = np.random.default_rng(51).integers(0, 256, (6,)).astype(np.int32)
    out = serving.run([Request(uid="x", tokens=p, max_new_tokens=8,
                               stop_on_eos=False)])
    ref = te.generate(p[None], max_new_tokens=8, stop_on_eos=False)[0]
    np.testing.assert_array_equal(out["x"].tokens, ref)
    st = serving.stats()
    assert "degradation" not in st and "audit" not in st
    assert "prefix_cache" not in st and "spec_decode" not in st


def test_headroom_signal_refuses():
    """The memory-headroom signal no longer refuses: it reads the memscope
    ledger, which the port has now. The block takes JAX's fields and
    defaults, and the ladder classifies a headroom reading as JAX's does
    (pressured below headroom_low, calm at or above headroom_high)."""
    mine = DegradationConfig(enabled=True, headroom_low=0.1,
                             headroom_high=0.3)
    theirs = JaxDegr(enabled=True, headroom_low=0.1, headroom_high=0.3)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    cfg = TpuInferenceConfig.from_dict(
        {"serving": {"degradation": {"headroom_low": 0.2}}})
    assert cfg.serving.degradation.headroom_low == 0.2
    cfg = TpuInferenceConfig.from_dict(
        {"serving": {"degradation": {"enabled": True, "queue_high": 3}}})
    assert cfg.serving.degradation.queue_high == 3
    calm = {"free_frac": 1.0, "queue": 0.0}
    for hf in (0.05, 0.2, 0.5, None):
        sig = dict(calm) if hf is None else dict(calm, headroom_frac=hf)
        got = PressureController._classify(
            types.SimpleNamespace(config=mine), sig)
        want = JaxController._classify(types.SimpleNamespace(config=theirs),
                                     sig)
        assert got == want, (hf, got, want)
