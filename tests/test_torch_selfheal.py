"""The port's self-healing serving layer held to the JAX package's: hard
deadlines mid-generation and in the queue, the router deadline surviving a
re-dispatch, the hung-replica watchdog (a slow replica tolerated, a hung one
quarantined), hedged dispatch, a parked handoff cancelled with both pools'
audits clean, the one injected clock surviving a restart, the chaos
schedules, and a chaos soak on a ticking clock. fp32 on the CPU, same
numpy-seeded weights: tokens, finish reasons, router counters and the
simulated-clock timings are EQUAL."""

import numpy as np
import pytest

from deepspeed_tpu.testing import chaos as jchaos
from deepspeed_tpu_torch.testing import chaos as tchaos
from tests.torch_serving_twins import (TELEMETRY, TINY, outcome, package,
                                       shared_prefix_trace, twin_engines)


@pytest.fixture(scope="module")
def twins():
    jeng, teng = twin_engines()
    return package(jeng, True), package(teng, False)


@pytest.fixture(scope="module")
def timed_twins():
    """Engines with telemetry on: the scheduler stamps first-token and
    finish times on the injected clock."""
    jeng, teng = twin_engines(telemetry=TELEMETRY)
    return package(jeng, True), package(teng, False)


def _both(twins, scenario):
    J, T = twins
    return scenario(J), scenario(T)


def _refs(P, prompts, news):
    return [P.engine.generate(p[None], max_new_tokens=n,
                              stop_on_eos=False)[0].tolist()
            for p, n in zip(prompts, news)]


def _prompt(seed, n=6):
    return np.random.default_rng(seed).integers(
        0, TINY.vocab_size, (n,)).astype(np.int32)


def _drain(router, res, counts=None):
    while router.in_flight:
        for d in router.step():
            res[d.uid] = d
            if counts is not None:
                counts[d.uid] = counts.get(d.uid, 0) + 1
    return res


# ----------------------------------------------------------------------
# hard deadlines
# ----------------------------------------------------------------------


def test_engine_deadline_mid_generation(twins):
    p = _prompt(30)

    def scenario(P):
        clock = P.chaos.ChaosClock()
        serving = P.replica(enable_prefix_caching=False, clock=clock)
        serving.submit(P.Request(uid="free", tokens=p, max_new_tokens=10,
                                 stop_on_eos=False))
        serving.submit(P.Request(uid="dl", tokens=p, max_new_tokens=10,
                                 stop_on_eos=False, deadline_ms=100.0))
        done = {}
        for _ in range(4):
            for d in serving.step():
                done[d.uid] = d
        alive = not done
        clock.advance(0.2)
        while serving.num_active or serving.queue_depth:
            for d in serving.step():
                done[d.uid] = d
        return (outcome(done), alive, serving.stats()["deadline_cancelled"],
                serving.allocator.num_free == serving.allocator.capacity,
                serving.audit().ok)

    jout, tout = _both(twins, scenario)
    assert tout == jout
    res, alive, n_dl, freed, ok = tout
    assert alive and n_dl == 1 and freed and ok
    assert res["dl"][1] == "deadline" and res["free"][1] == "length"
    ref = _refs(twins[1], [p], [10])[0]
    assert 0 < len(res["dl"][0]) < 10 and res["dl"][0] == \
        ref[:len(res["dl"][0])]
    assert res["free"][0] == ref


def test_engine_deadline_expires_in_queue(twins):
    p = _prompt(31)

    def scenario(P):
        clock = P.chaos.ChaosClock()
        serving = P.replica(max_slots=1, enable_prefix_caching=False,
                            clock=clock)
        serving.submit(P.Request(uid="hog", tokens=p, max_new_tokens=16,
                                 stop_on_eos=False))
        serving.step()
        serving.submit(P.Request(uid="q", tokens=p, max_new_tokens=4,
                                 stop_on_eos=False, deadline_ms=50.0))
        clock.advance(0.1)
        done = {}
        while serving.num_active or serving.queue_depth:
            for d in serving.step():
                done[d.uid] = d
        return outcome(done), serving.stats()["prefill_chunks"]

    jout, tout = _both(twins, scenario)
    assert tout == jout
    assert tout[0]["q"] == ([], "deadline") and tout[0]["hog"][1] == "length"
    assert tout[1] == 1, "an expired queued request burned prefill"


def test_router_deadline_survives_redispatch(twins):
    p = _prompt(32)

    def scenario(P):
        clock = P.chaos.ChaosClock()
        reps = [P.InProcessReplica(P.replica(enable_prefix_caching=False),
                                   replica_id=f"r{i}") for i in range(2)]
        router = P.ServingRouter(replicas=reps, clock=clock)
        router.submit(P.Request(uid="x", tokens=p, max_new_tokens=40,
                                stop_on_eos=False, deadline_ms=1000.0))
        res = {}
        for _ in range(3):
            for d in router.step():
                res[d.uid] = d
        victim = router._pending["x"].replica
        clock.advance(0.9)
        router.kill_replica(victim)
        clock.advance(0.2)
        return outcome(_drain(router, res)), dict(router.counters)

    jout, tout = _both(twins, scenario)
    assert tout == jout
    assert tout[0]["x"][1] == "deadline" and tout[1]["completed"] == 1


# ----------------------------------------------------------------------
# the hung-replica watchdog
# ----------------------------------------------------------------------


def test_watchdog_tolerates_slow_but_alive_replica(twins):
    rng = np.random.default_rng(40)
    prompts = [rng.integers(0, TINY.vocab_size, (L,)).astype(np.int32)
               for L in (5, 9)]

    def scenario(P):
        clock = P.chaos.ChaosClock()
        slow = P.chaos.ChaosReplica(
            P.InProcessReplica(P.replica(enable_prefix_caching=False),
                               replica_id="slow"),
            P.chaos.ChaosSchedule([P.chaos.ChaosEvent(s, "delay", 0.5)
                                   for s in range(40)]), clock=clock)
        router = P.ServingRouter(replicas=[slow], clock=clock,
                                 step_deadline_ms=100.0,
                                 step_strike_budget=2)
        res = router.run([P.Request(uid=i, tokens=p, max_new_tokens=4,
                                    stop_on_eos=False)
                          for i, p in enumerate(prompts)])
        return (outcome(res), dict(router.counters),
                router.stats()["replicas"]["slow"]["health"])

    jout, tout = _both(twins, scenario)
    assert tout == jout
    res, ctr, health = tout
    assert ctr["watchdog_strikes"] >= 2 and ctr["watchdog_quarantines"] == 0
    assert health == "up"
    assert [res[i][0] for i in range(2)] == _refs(twins[1], prompts, [4, 4])


def test_watchdog_quarantines_hung_replica_and_reroutes(twins):
    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, TINY.vocab_size, (L,)).astype(np.int32)
               for L in (5, 9, 3, 12)]

    def scenario(P):
        clock = P.chaos.ChaosClock()
        hung = P.chaos.ChaosReplica(
            P.InProcessReplica(P.replica(enable_prefix_caching=False),
                               replica_id="hung"),
            P.chaos.ChaosSchedule([P.chaos.ChaosEvent(2, "hang", 0.5)]),
            clock=clock)
        ok = P.InProcessReplica(P.replica(enable_prefix_caching=False),
                                replica_id="ok")
        router = P.ServingRouter(replicas=[hung, ok], clock=clock,
                                 step_deadline_ms=100.0,
                                 step_strike_budget=2)
        for i, p in enumerate(prompts):
            router.submit(P.Request(uid=i, tokens=p, max_new_tokens=4,
                                    stop_on_eos=False))
        res, counts = {}, {}
        _drain(router, res, counts)
        reports = router.audit_pool()
        return (outcome(res), counts, dict(router.counters),
                router.stats()["replicas"]["hung"]["health"],
                {rid: r.ok for rid, r in reports.items()})

    jout, tout = _both(twins, scenario)
    assert tout == jout
    res, counts, ctr, health, audits = tout
    assert sorted(res) == list(range(4)) and set(counts.values()) == {1}
    assert ctr["watchdog_quarantines"] == 1 and ctr["reroutes"] > 0
    assert health == "dead" and audits == {"ok": True}
    assert [res[i][0] for i in range(4)] == _refs(twins[1], prompts, [4] * 4)


# ----------------------------------------------------------------------
# hedged dispatch
# ----------------------------------------------------------------------


def test_hedged_dispatch_first_completion_wins(twins):
    p = _prompt(42)

    def scenario(P):
        clock = P.chaos.ChaosClock()
        hung = P.chaos.ChaosReplica(
            P.InProcessReplica(P.replica(enable_prefix_caching=False),
                               replica_id="hung"),
            P.chaos.ChaosSchedule([P.chaos.ChaosEvent(0, "hang", 0.3)]),
            clock=clock)
        ok = P.InProcessReplica(P.replica(enable_prefix_caching=False),
                                replica_id="ok")
        router = P.ServingRouter(replicas=[hung, ok], clock=clock,
                                 hedge_after_ms=200.0)
        router.submit(P.Request(uid="x", tokens=p, max_new_tokens=4,
                                stop_on_eos=False))
        res, counts = {}, {}
        for d in router.step():
            res[d.uid] = d
            counts[d.uid] = counts.get(d.uid, 0) + 1
        first = router._pending["x"].replica
        _drain(router, res, counts)
        return (outcome(res), counts, dict(router.counters), first,
                hung.engine.stats()["cancelled"],
                ok.engine.allocator.num_free == ok.engine.allocator.capacity)

    jout, tout = _both(twins, scenario)
    assert tout == jout
    res, counts, ctr, first, loser_cancelled, freed = tout
    assert first == "hung" and counts == {"x": 1}
    assert (ctr["hedges"], ctr["hedge_wins"], ctr["completed"]) == (1, 1, 1)
    assert loser_cancelled == 1 and freed
    assert res["x"] == (_refs(twins[1], [p], [4])[0], "length")


def test_hedging_only_recovery_through_run(twins):
    p = _prompt(44)

    def scenario(P):
        clock = P.chaos.ChaosClock(tick=0.001)
        hung = P.chaos.ChaosReplica(
            P.InProcessReplica(P.replica(enable_prefix_caching=False),
                               replica_id="hung"),
            P.chaos.ChaosSchedule([P.chaos.ChaosEvent(0, "hang", 0.3)]),
            clock=clock)
        ok = P.InProcessReplica(P.replica(enable_prefix_caching=False),
                                replica_id="ok")
        router = P.ServingRouter(replicas=[hung, ok], clock=clock,
                                 hedge_after_ms=200.0)
        res = router.run([P.Request(uid="x", tokens=p, max_new_tokens=4,
                                    stop_on_eos=False)])
        return outcome(res), dict(router.counters), clock.now

    jout, tout = _both(twins, scenario)
    assert tout == jout
    assert tout[1]["hedges"] == tout[1]["hedge_wins"] == 1


def test_hedge_not_fired_when_first_token_arrives(twins):
    p = _prompt(43)

    def scenario(P):
        clock = P.chaos.ChaosClock(tick=0.001)
        reps = [P.InProcessReplica(P.replica(enable_prefix_caching=False),
                                   replica_id=f"r{i}") for i in range(2)]
        router = P.ServingRouter(replicas=reps, clock=clock,
                                 hedge_after_ms=10_000.0)
        res = router.run([P.Request(uid="x", tokens=p, max_new_tokens=6,
                                    stop_on_eos=False)])
        return outcome(res), dict(router.counters), clock.now

    jout, tout = _both(twins, scenario)
    assert tout == jout
    assert tout[1]["hedges"] == 0 and tout[0]["x"][1] == "length"


# ----------------------------------------------------------------------
# the handoff under cancellation, the audit, the clock
# ----------------------------------------------------------------------


def test_cancel_parked_handoff_releases_source_blocks(twins):
    p = _prompt(60)

    def scenario(P):
        serving = P.replica(enable_prefix_caching=False)
        serving.submit(P.Request(uid="h", tokens=p, max_new_tokens=8,
                                 stop_on_eos=False), prefill_only=True)
        while not serving.handoff_ready():
            serving.step()
        done = serving.cancel("h", queued_only=True)
        return (outcome({"h": done}),
                serving.allocator.num_free == serving.allocator.capacity,
                serving.audit().ok)

    jout, tout = _both(twins, scenario)
    assert tout == jout
    assert tout[0]["h"][1] == "cancelled" and len(tout[0]["h"][0]) == 1
    assert tout[1] and tout[2]


def test_router_ttl_cancels_parked_handoff_both_pools_clean(twins):
    p = _prompt(61)

    def scenario(P):
        t = P.chaos.ChaosClock()
        pre = P.InProcessReplica(P.replica(enable_prefix_caching=False),
                                 replica_id="pre")
        dec = P.InProcessReplica(P.replica(max_slots=1, num_kv_blocks=7,
                                           enable_prefix_caching=False),
                                 replica_id="dec")
        router = P.ServingRouter(default_ttl_s=5.0, clock=t)
        router.add_replica(pre, role="prefill")
        router.add_replica(dec, role="decode")
        router.submit(P.Request(uid="hog", tokens=p, max_new_tokens=24,
                                stop_on_eos=False))
        res = {}
        while not dec.num_active:
            for d in router.step():
                res[d.uid] = d
        router.submit(P.Request(uid="parked", tokens=p, max_new_tokens=24,
                                stop_on_eos=False))
        for _ in range(4):
            for d in router.step():
                res[d.uid] = d
        parked = pre.engine.handoff_ready()
        t.advance(6.0)
        _drain(router, res)
        freed = [rep.engine.allocator.num_free
                 == rep.engine.allocator.capacity for rep in (pre, dec)]
        return (outcome(res), dict(router.counters), parked, freed,
                {rid: r.ok for rid, r in router.audit_pool().items()})

    jout, tout = _both(twins, scenario)
    assert tout == jout
    res, ctr, parked, freed, audits = tout
    assert parked == ["parked"] and res["parked"][1] == "cancelled"
    assert res["hog"][1] == "length" and ctr["ttl_cancelled"] == 1
    assert all(freed) and all(audits.values())


def test_router_quarantines_replica_on_audit_raise(twins):
    rng_p = np.random.default_rng(23)
    prompts = shared_prefix_trace(rng_p, 5)

    def scenario(P):
        rng = np.random.default_rng(230)
        bad = P.InProcessReplica(P.replica(audit_interval=1,
                                           audit_action="raise"),
                                 replica_id="bad")
        good = P.InProcessReplica(P.replica(), replica_id="good")
        router = P.ServingRouter(replicas=[bad, good])
        for i, p in enumerate(prompts):
            router.submit(P.Request(uid=i, tokens=p, max_new_tokens=5,
                                    stop_on_eos=False))
        res = {}
        for _ in range(2):
            for d in router.step():
                res[d.uid] = d
        P.chaos.corrupt_pool(bad.engine, "leak", rng)
        _drain(router, res)
        return (outcome(res), dict(router.counters),
                router.stats()["replicas"]["bad"]["health"],
                {rid: r.ok for rid, r in router.audit_pool().items()})

    jout, tout = _both(twins, scenario)
    assert tout == jout
    res, ctr, health, audits = tout
    assert health == "dead" and ctr["replica_failures"] == 1
    assert sorted(res) == list(range(5)) and all(audits.values())


def test_unified_clock_reaches_every_replica_and_survives_restart(twins):
    _, T = twins
    clock = T.chaos.ChaosClock()
    router = T.ServingRouter(clock=clock, restart_backoff_s=0.0)
    router.add_replica(T.InProcessReplica(
        factory=lambda: T.replica(enable_prefix_caching=False),
        replica_id="r0"))
    router.add_replica(T.InProcessReplica(T.replica(), replica_id="r1"))
    assert all(rep.engine._clock is clock
               for rep in router.replicas.values())
    router.kill_replica("r0")
    router.step()
    assert router.stats()["replicas"]["r0"]["health"] == "up"
    assert router.replicas["r0"].engine._clock is clock


# ----------------------------------------------------------------------
# chaos schedules and the soak
# ----------------------------------------------------------------------


@pytest.mark.parametrize("seed", [7, 9, 70])
def test_chaos_schedule_seeded_equals_jax(seed):
    kw = dict(delay_rate=0.3, delay_s=0.1, corrupt_rate=0.3,
              crash_at=(3,), hang_at=5, hang_s=0.4)
    a = tchaos.ChaosSchedule.seeded(seed, 64, **kw)
    assert repr(a) == repr(jchaos.ChaosSchedule.seeded(seed, 64, **kw))
    assert repr(a) == repr(tchaos.ChaosSchedule.seeded(seed, 64, **kw))
    assert repr(a) != repr(tchaos.ChaosSchedule.seeded(seed + 1, 64, **kw))
    assert tchaos.SAFE_CORRUPTIONS == jchaos.SAFE_CORRUPTIONS
    assert tchaos.UNSAFE_CORRUPTIONS == jchaos.UNSAFE_CORRUPTIONS


def test_chaos_soak_exactly_once_clean_audit_counters_equal_jax(timed_twins):
    """A ragged trace over three replicas under one seeded schedule — a
    restart-backed crash, a permanent hang (watchdog quarantine), slow
    steps, safe pool corruptions (the scheduled audit repairs) — on a clock
    that advances 0.5 ms a read, as the robustness lane's does. Every
    request completes exactly once with the single engine's tokens; the
    router counters, the schedules fired and every request's first-token
    and finish stamps equal JAX's, so the port reads the clock as often
    and in the same order."""
    rng = np.random.default_rng(70)
    prompts = shared_prefix_trace(rng, 10)
    news = [3 + i % 4 for i in range(len(prompts))]

    def scenario(P):
        clock = P.chaos.ChaosClock(tick=0.0005)
        ch = P.chaos

        def rep(**kw):
            return P.replica(audit_interval=1, **kw)

        crashy = ch.ChaosReplica(
            P.InProcessReplica(factory=rep, replica_id="crashy"),
            ch.ChaosSchedule.seeded(70, 40, delay_rate=0.2, delay_s=0.3,
                                    crash_at=(4,)), clock=clock, seed=700)
        hangy = ch.ChaosReplica(
            P.InProcessReplica(rep(), replica_id="hangy"),
            ch.ChaosSchedule.seeded(71, 40, hang_at=7, hang_s=0.4),
            clock=clock, seed=701)
        dirty = ch.ChaosReplica(
            P.InProcessReplica(rep(), replica_id="dirty"),
            ch.ChaosSchedule.seeded(72, 40, corrupt_rate=0.5,
                                    corruptions=ch.SAFE_CORRUPTIONS),
            clock=clock, seed=702)
        router = P.ServingRouter(replicas=[crashy, hangy, dirty],
                                 clock=clock, step_deadline_ms=150.0,
                                 step_strike_budget=2,
                                 restart_backoff_s=0.0,
                                 max_replica_restarts=2)
        for i, p in enumerate(prompts):
            router.submit(P.Request(uid=i, tokens=p, max_new_tokens=news[i],
                                    stop_on_eos=False))
        res, counts = {}, {}
        _drain(router, res, counts)
        injected = {r.replica_id: [(s, k, str(a)) for s, k, a in r.injected]
                    for r in (crashy, hangy, dirty)}
        timing = {uid: (d.timing or {}) for uid, d in res.items()}
        repaired = dirty.engine.stats().get("audit", {}).get("repairs", 0)
        router.audit_pool(repair=True)
        clean = {rid: r.ok for rid, r in router.audit_pool().items()}
        return (outcome(res), counts, dict(router.counters), injected, timing,
                repaired, clean)

    jout, tout = _both(timed_twins, scenario)
    res, counts, ctr, injected, timing, repaired, clean = tout
    assert ctr == jout[2]
    assert injected == jout[3]
    assert timing == jout[4]
    assert (res, counts, repaired, clean) == (jout[0], jout[1], jout[5],
                                              jout[6])
    assert any(k == "crash" for _, k, _ in injected["crashy"])
    assert any(k == "hang" for _, k, _ in injected["hangy"])
    assert sum(k == "corrupt" for _, k, _ in injected["dirty"]) >= 3
    assert ctr["replica_failures"] >= 2 and ctr["watchdog_quarantines"] >= 1
    assert sorted(res) == list(range(len(prompts)))
    assert set(counts.values()) == {1} and ctr["completed"] == len(prompts)
    assert [res[i][0] for i in range(len(prompts))] == \
        _refs(timed_twins[1], prompts, news)
    assert repaired >= 1 and clean and all(clean.values())
    assert all(t.get("first_token") is not None for t in timing.values())
