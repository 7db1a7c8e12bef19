"""The port's serving router held to the JAX package's: the restart
budget, the engine's cancel / submit-time rejection, greedy parity of a
2-replica pool on a ragged trace, affinity against round-robin, the load
spill, TTL, bounded-admission shedding, failure reroute, the restart budget
in the pool, the disaggregated prefill/decode handoff across chunk grids and
over the int8 pool, and `transplant_blocks` itself. fp32 on the CPU, same
numpy-seeded weights in both packages: tokens, finish reasons and router
counters are EQUAL."""

import numpy as np
import pytest
import torch

from deepspeed_tpu.elasticity import restart_policy as jrp
from deepspeed_tpu.inference import kv_cache as jkv
from deepspeed_tpu_torch.elasticity import restart_policy as trp
from deepspeed_tpu_torch.inference import kv_cache as tkv
from tests.torch_serving_twins import (BS, TINY, outcome, package,
                                       shared_prefix_trace, twin_engines)


@pytest.fixture(scope="module")
def twins():
    jeng, teng = twin_engines()
    return package(jeng, True), package(teng, False)


def _both(twins, scenario):
    """Run `scenario(P)` against both packages; return (jax, port)."""
    J, T = twins
    return scenario(J), scenario(T)


def _refs(P, prompts, news):
    return [P.engine.generate(p[None], max_new_tokens=n,
                              stop_on_eos=False)[0].tolist()
            for p, n in zip(prompts, news)]


# ----------------------------------------------------------------------
# restart budget
# ----------------------------------------------------------------------


def test_restart_budget_exhaustion_global_and_per_cause():
    def walk(rp):
        b = rp.RestartBudget(rp.RestartPolicy(max_restarts=3,
                                              per_cause={"bad_state": 1}))
        seq = [b.consume("crash"), b.consume("bad_state"), b.exhausted,
               b.consume("crash"), b.consume("crash"), b.exhausted,
               b.restarts]
        b2 = rp.RestartBudget(rp.RestartPolicy(max_restarts=10,
                                               per_cause={"bad_state": 1}))
        seq += [b2.consume("bad_state"), b2.consume("bad_state"),
                b2.causes, b2.last_cause]
        return seq

    out = walk(trp)
    assert out == walk(jrp)
    assert out == [True, True, False, True, False, True, 4, True, False,
                   {"bad_state": 2}, "bad_state"]


def test_restart_backoff_monotone_and_capped():
    def delays(rp, jitter, draw):
        b = rp.RestartBudget(rp.RestartPolicy(base_backoff_s=1.0,
                                              backoff_factor=2.0,
                                              max_backoff_s=5.0,
                                              jitter=jitter),
                             rng=lambda: draw)
        out = []
        for r in (1, 2, 3, 4, 5):
            b.restarts = r
            out.append(b.next_delay())
        return out

    d = delays(trp, 0.0, 0.7)
    assert d == delays(jrp, 0.0, 0.7) == [1.0, 2.0, 4.0, 5.0, 5.0]
    # jitter only ever adds, proportionally
    assert delays(trp, 0.5, 0.7) == delays(jrp, 0.5, 0.7)
    assert all(1.0 <= a / b <= 1.5
               for a, b in zip(delays(trp, 0.5, 0.7), d))
    assert trp.RestartBudget(trp.RestartPolicy(
        base_backoff_s=0.0)).next_delay() == 0.0


# ----------------------------------------------------------------------
# engine satellites: cancel() + submit-time rejection
# ----------------------------------------------------------------------


def test_engine_cancel_queued_and_active(twins):
    rng = np.random.default_rng(0)
    p = rng.integers(0, TINY.vocab_size, (6,)).astype(np.int32)

    def scenario(P):
        serving = P.replica(max_slots=1, enable_prefix_caching=False)
        serving.submit(P.Request(uid="a", tokens=p, max_new_tokens=20,
                                 stop_on_eos=False))
        serving.submit(P.Request(uid="b", tokens=p, max_new_tokens=4,
                                 stop_on_eos=False))
        serving.step()
        done_b = serving.cancel("b")
        assert serving.queue_depth == 0
        assert serving.cancel("a", queued_only=True) is None
        done_a = serving.cancel("a")
        assert serving.allocator.num_free == serving.allocator.capacity
        assert serving.cancel("nope") is None
        out = serving.run([P.Request(uid="c", tokens=p, max_new_tokens=3,
                                     stop_on_eos=False)])
        return (outcome({"a": done_a, "b": done_b, "c": out["c"]}),
                serving.stats()["cancelled"])

    jout, tout = _both(twins, scenario)
    assert tout == jout
    (res, cancelled) = tout
    assert res["b"] == ([], "cancelled") and cancelled == 2
    assert res["a"][1] == "cancelled" and 0 < len(res["a"][0]) < 20


def test_submit_rejects_impossible_requests_incl_window_rounding(twins):
    _, T = twins
    rng = np.random.default_rng(1)
    p = rng.integers(0, TINY.vocab_size, (20,)).astype(np.int32)
    T.replica(max_context=32, enable_prefix_caching=False).submit(
        T.Request(uid=0, tokens=p, max_new_tokens=6))
    windowed = T.replica(max_context=32, decode_steps_per_sync=16,
                         enable_prefix_caching=False)
    with pytest.raises(T.Inadmissible, match="max_context"):
        windowed.submit(T.Request(uid=1, tokens=p, max_new_tokens=6))
    small = T.replica(max_slots=1, num_kv_blocks=2,
                      enable_prefix_caching=False)
    with pytest.raises(T.Inadmissible, match="KV blocks"):
        small.submit(T.Request(uid=2, tokens=list(range(40)),
                               max_new_tokens=8))
    # a prefill-only request sizes the padded prompt only
    assert windowed.check_admissible(20, 30, prefill_only=True) == 2
    assert issubclass(T.Inadmissible, ValueError)


# ----------------------------------------------------------------------
# router: parity, affinity, spill, TTL, shed, failover
# ----------------------------------------------------------------------


def test_router_greedy_parity_on_ragged_trace(twins):
    """Pool tokens equal to the JAX router's AND to the port's single
    engine; the router counters equal."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, TINY.vocab_size, (L,)).astype(np.int32)
               for L in (5, 11, 3, 8, 30, 2, 17)]
    news = [3 + i % 5 for i in range(len(prompts))]

    def scenario(P):
        router = P.ServingRouter(replicas=[P.replica(), P.replica()])
        res = router.run([P.Request(uid=i, tokens=p, max_new_tokens=n,
                                    stop_on_eos=False)
                          for i, (p, n) in enumerate(zip(prompts, news))])
        return outcome(res), dict(router.counters), router.total_prefill_chunks()

    jout, tout = _both(twins, scenario)
    assert tout == jout
    _, T = twins
    single = T.replica().run([T.Request(uid=i, tokens=p, max_new_tokens=n,
                                        stop_on_eos=False)
                              for i, (p, n) in enumerate(zip(prompts,
                                                             news))])
    assert outcome(single) == tout[0]
    assert [tout[0][i][0] for i in range(len(prompts))] == \
        _refs(T, prompts, news)
    assert tout[1]["completed"] == len(prompts)


@pytest.mark.parametrize("policy", ["affinity", "round_robin"])
def test_router_affinity_beats_round_robin_on_shared_prefix(twins, policy):
    """Affinity prefills the shared prefix once a POOL: strictly fewer
    chunks than round-robin, the same tokens; each policy's chunks and
    counters equal JAX's."""
    rng = np.random.default_rng(3)
    prompts = shared_prefix_trace(rng, 6)

    def scenario(P, pol=policy):
        router = P.ServingRouter(replicas=[P.replica(), P.replica()],
                                 routing_policy=pol)
        res = router.run([P.Request(uid=i, tokens=p, max_new_tokens=4,
                                    stop_on_eos=False)
                          for i, p in enumerate(prompts)])
        return outcome(res), dict(router.counters), router.total_prefill_chunks()

    jout, tout = _both(twins, scenario)
    assert tout == jout
    _, T = twins
    assert [tout[0][i][0] for i in range(len(prompts))] == \
        _refs(T, prompts, [4] * len(prompts))
    other = scenario(T, "round_robin" if policy == "affinity"
                     else "affinity")
    aff, rr = (tout, other) if policy == "affinity" else (other, tout)
    assert aff[2] < rr[2], (aff[2], rr[2])
    assert aff[1]["affinity_hits"] > 0


def test_router_load_spill_under_saturated_replica(twins):
    rng = np.random.default_rng(4)
    prompts = shared_prefix_trace(rng, 5)

    def scenario(P):
        router = P.ServingRouter(replicas=[P.replica(max_slots=1),
                                           P.replica(max_slots=1)],
                                 max_replica_queue=1)
        res = router.run([P.Request(uid=i, tokens=p, max_new_tokens=4,
                                    stop_on_eos=False)
                          for i, p in enumerate(prompts)])
        return (outcome(res), dict(router.counters),
                [rep.stats()["prefill_chunks"]
                 for rep in router.replicas.values()])

    jout, tout = _both(twins, scenario)
    assert tout == jout
    assert tout[1]["load_spills"] > 0 and all(c > 0 for c in tout[2])


def test_router_ttl_cancels_queued_requests(twins):
    rng = np.random.default_rng(5)
    p = rng.integers(0, TINY.vocab_size, (6,)).astype(np.int32)

    def scenario(P):
        t = {"now": 0.0}
        router = P.ServingRouter(
            replicas=[P.replica(max_slots=1, enable_prefix_caching=False)],
            max_replica_queue=1, default_ttl_s=5.0, clock=lambda: t["now"])
        for uid in ("gen", "engine_queued", "router_queued"):
            router.submit(P.Request(uid=uid, tokens=p, max_new_tokens=24,
                                    stop_on_eos=False))
        done = {}
        for _ in range(2):
            for d in router.step():
                done[d.uid] = d
        placed = (router._pending["engine_queued"].replica is not None,
                  router._pending["router_queued"].replica is None)
        t["now"] = 6.0
        while router.in_flight:
            for d in router.step():
                done[d.uid] = d
        return outcome(done), dict(router.counters), placed

    jout, tout = _both(twins, scenario)
    assert tout == jout
    res, ctr, placed = tout
    assert placed == (True, True) and ctr["ttl_cancelled"] == 2
    assert res["engine_queued"][1] == res["router_queued"][1] == "cancelled"
    assert res["gen"][1] == "length"


def test_router_bounded_admission_shed(twins):
    rng = np.random.default_rng(6)
    p = rng.integers(0, TINY.vocab_size, (6,)).astype(np.int32)

    def scenario(P):
        router = P.ServingRouter(
            replicas=[P.replica(max_slots=1, enable_prefix_caching=False)],
            max_replica_queue=1, max_pending=2, admission_policy="shed")
        shed = {}
        for i in range(6):
            out = router.submit(P.Request(uid=i, tokens=p, max_new_tokens=8,
                                          stop_on_eos=False))
            if out is not None:
                shed[out.uid] = out
        res = {}
        while router.in_flight:
            for d in router.step():
                res[d.uid] = d
        with pytest.raises(ValueError, match="duplicate"):
            router.submit(P.Request(uid=0, tokens=p, max_new_tokens=2))
        return outcome(shed), outcome(res), dict(router.counters)

    jout, tout = _both(twins, scenario)
    assert tout == jout
    shed, res, ctr = tout
    assert shed and all(r == "cancelled" for _, r in shed.values())
    assert ctr["shed"] == len(shed)
    assert sorted(list(res) + list(shed)) == list(range(6))


def test_router_replica_failure_reroutes_and_completes(twins):
    rng = np.random.default_rng(7)
    prompts = shared_prefix_trace(rng, 6)

    def scenario(P):
        router = P.ServingRouter(replicas=[P.replica(), P.replica()])
        for i, p in enumerate(prompts):
            router.submit(P.Request(uid=i, tokens=p, max_new_tokens=6,
                                    stop_on_eos=False))
        res = {}
        for _ in range(2):
            for d in router.step():
                res[d.uid] = d
        victim = next(rec.replica for rec in router._pending.values()
                      if rec.replica is not None)
        router.kill_replica(victim)
        while router.in_flight:
            for d in router.step():
                res[d.uid] = d
        return (outcome(res), dict(router.counters),
                router.stats()["replicas"][victim]["health"])

    jout, tout = _both(twins, scenario)
    assert tout == jout
    res, ctr, health = tout
    assert sorted(res) == list(range(len(prompts))) and health == "dead"
    assert ctr["completed"] == len(prompts) and ctr["replica_failures"] == 1
    assert ctr["reroutes"] > 0
    _, T = twins
    assert [res[i][0] for i in range(len(prompts))] == \
        _refs(T, prompts, [6] * len(prompts))


def test_router_replica_restart_budget(twins):
    rng = np.random.default_rng(8)
    p = rng.integers(0, TINY.vocab_size, (5,)).astype(np.int32)

    def scenario(P):
        router = P.ServingRouter(max_replica_restarts=1,
                                 restart_backoff_s=0.0)
        router.add_replica(P.InProcessReplica(
            factory=lambda: P.replica(enable_prefix_caching=False),
            replica_id="r0"))
        router.kill_replica("r0")
        router.step()
        health = [router.stats()["replicas"]["r0"]["health"]]
        res = router.run([P.Request(uid="x", tokens=p, max_new_tokens=3,
                                    stop_on_eos=False)])
        router.kill_replica("r0")
        router.step()
        health.append(router.stats()["replicas"]["r0"]["health"])
        with pytest.raises(RuntimeError, match="no healthy replica"):
            router.submit(P.Request(uid="y", tokens=p, max_new_tokens=2))
        return outcome(res), dict(router.counters), health

    jout, tout = _both(twins, scenario)
    assert tout == jout
    assert tout[2] == ["up", "dead"] and tout[1]["replica_restarts"] == 1


def test_router_rejects_impossible_request_across_pool(twins):
    _, T = twins
    router = T.ServingRouter(replicas=[
        T.replica(max_context=32, enable_prefix_caching=False)])
    with pytest.raises(T.Inadmissible, match="max_context"):
        router.submit(T.Request(uid=0, tokens=list(range(30)),
                                max_new_tokens=16))
    assert router.in_flight == 0


# ----------------------------------------------------------------------
# disaggregated prefill/decode
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_disaggregated_prefill_decode_handoff_parity(twins, kv):
    """Prefill replicas prefill only; their slots' blocks transplant into
    the decode replica's pool and decode continues there. Tokens equal
    JAX's (and, for the fp32 pool, the single engine's); over the int8 pool
    the transplanted scales are bit-equal to the source's."""
    rng = np.random.default_rng(9)
    prompts = shared_prefix_trace(rng, 4)
    q = {"quantization": {"kv_cache_dtype": "int8"}} if kv == "int8" else {}

    def scenario(P):
        pre = P.replica(enable_prefix_caching=True, **q)
        dec = P.replica(enable_prefix_caching=False, **q)
        router = P.ServingRouter()
        router.add_replica(pre, role="prefill")
        router.add_replica(dec, role="decode")
        assert router.disaggregated
        moved = []
        adopt = dec.adopt_handoff

        def spy(state, src_pool):
            ok = adopt(state, src_pool)
            if ok:
                slot = next(s for s in dec.slots if s.uid == state["uid"])
                n = len(state["blocks"])
                for name in sorted(src_pool):
                    src = np.asarray(src_pool[name])[:, state["blocks"]]
                    dst = np.asarray(dec.pool[name])[:, slot.blocks[:n]]
                    moved.append(bool(np.array_equal(src, dst)))
            return ok

        dec.adopt_handoff = spy
        res = router.run([P.Request(uid=i, tokens=p, max_new_tokens=5,
                                    stop_on_eos=False)
                          for i, p in enumerate(prompts)])
        st_pre, st_dec = pre.stats(), dec.stats()
        clean = (pre.allocator.num_free + pre.allocator.num_reclaimable
                 == pre.allocator.capacity,
                 dec.allocator.num_free == dec.allocator.capacity,
                 pre.audit().ok, dec.audit().ok)
        return (outcome(res), dict(router.counters), moved,
                (st_dec["prefill_chunks"], st_pre["decode_steps"],
                 st_pre["handoffs_out"], st_dec["handoffs_in"]), clean)

    jout, tout = _both(twins, scenario)
    assert tout == jout
    res, ctr, moved, split, clean = tout
    n = len(prompts)
    assert ctr["handoffs"] == n and split == (0, 0, n, n)
    assert moved and all(moved) and all(clean)
    assert len(moved) == n * (4 if kv == "int8" else 2)
    if kv == "float32":
        _, T = twins
        assert [res[i][0] for i in range(n)] == \
            _refs(T, prompts, [5] * n)


def test_disaggregated_handoff_across_chunk_grids(twins):
    rng = np.random.default_rng(10)
    p = rng.integers(0, TINY.vocab_size, (17,)).astype(np.int32)

    def scenario(P):
        def build(decode_ctx):
            router = P.ServingRouter()
            router.add_replica(P.replica(prefill_chunk=64, max_context=96,
                                         enable_prefix_caching=False),
                               role="prefill")
            router.add_replica(P.replica(prefill_chunk=BS,
                                         max_context=decode_ctx,
                                         enable_prefix_caching=False),
                               role="decode")
            return router

        with pytest.raises(P.Inadmissible, match="max_context"):
            build(48).submit(P.Request(uid=0, tokens=p, max_new_tokens=4,
                                       stop_on_eos=False))
        return outcome(build(96).run([P.Request(
            uid=0, tokens=p, max_new_tokens=4, stop_on_eos=False)]))

    jout, tout = _both(twins, scenario)
    assert tout == jout
    _, T = twins
    assert tout[0][0] == _refs(T, [p], [4])[0]


def test_pool_compat_refuses_mixed_kv_dtypes(twins):
    """`_check_pool_compat`: an int8 pool next to a fp32 one cannot take
    transplanted blocks, so the join refuses, as in JAX."""
    J, T = twins
    for P in (J, T):
        router = P.ServingRouter(replicas=[P.replica()])
        with pytest.raises(ValueError, match="kv_cache_dtype"):
            router.add_replica(P.replica(
                quantization={"kv_cache_dtype": "int8"}))


# ----------------------------------------------------------------------
# transplant_blocks
# ----------------------------------------------------------------------


def _pools(rng, int8):
    def leaf(shape, dtype):
        if dtype == np.int8:
            return rng.integers(-127, 128, shape).astype(np.int8)
        return rng.normal(0, 1, shape).astype(np.float32)

    shape = (2, 6, 2, 4, 8)
    names = {"k": np.int8 if int8 else np.float32,
             "v": np.int8 if int8 else np.float32}
    if int8:
        names.update(k_scale=np.float32, v_scale=np.float32)
    return [{n: leaf(shape[:-1] + (2,) if "scale" in n else shape, d)
             for n, d in names.items()} for _ in range(2)]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("pad_to", [None, 5])
def test_transplant_blocks_matches_jax(int8, pad_to):
    import jax.numpy as jnp
    src, dst = _pools(np.random.default_rng(11), int8)
    jout = jkv.transplant_blocks({k: jnp.asarray(v) for k, v in src.items()},
                                 [3, 1], {k: jnp.asarray(v)
                                          for k, v in dst.items()},
                                 [2, 5], pad_to=pad_to)
    tdst = {k: torch.from_numpy(v.copy()) for k, v in dst.items()}
    tout = tkv.transplant_blocks({k: torch.from_numpy(v)
                                  for k, v in src.items()}, [3, 1], tdst,
                                 [2, 5], pad_to=pad_to)
    assert tout is tdst                         # in place on the destination
    for name in src:
        got, want = tout[name].numpy(), np.asarray(jout[name])
        # real entries bit-equal; the trash block (0) is garbage by contract
        np.testing.assert_array_equal(got[:, 1:], want[:, 1:])
        np.testing.assert_array_equal(got[:, [2, 5]], src[name][:, [3, 1]])
        np.testing.assert_array_equal(got[:, [1, 3, 4]],
                                      dst[name][:, [1, 3, 4]])


def test_transplant_blocks_checks_raise_value_error():
    src, dst = _pools(np.random.default_rng(12), False)
    t = {k: torch.from_numpy(v) for k, v in src.items()}
    d = {k: torch.from_numpy(v.copy()) for k, v in dst.items()}
    with pytest.raises(ValueError, match="width"):
        tkv.transplant_blocks(t, [1, 2], d, [3])
    with pytest.raises(ValueError, match="trash"):
        tkv.transplant_blocks(t, [0], d, [3])
    with pytest.raises(ValueError, match="trash"):
        tkv.transplant_blocks(t, [1], d, [tkv.TRASH_BLOCK])
    with pytest.raises(ValueError, match="dtype"):
        tkv.transplant_blocks({**t, "k": t["k"].double()}, [1], d, [2])
    assert tkv.transplant_blocks(t, [], d, []) is d
