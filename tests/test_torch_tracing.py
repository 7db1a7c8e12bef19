"""The port's request tracer and flight recorder held to the JAX package's:
the span trees of a 2-replica spec-decode trace (names, parents, attributes,
tracks and times, on one injected clock), trace continuity under failover
with the quarantine in the flight dump, a standalone engine owning its
traces with a bounded flight ring, the disabled default, and the tracer's
units. fp32 on the CPU, same numpy-seeded weights in both packages."""

import json
import pathlib

import numpy as np
import pytest

from deepspeed_tpu.telemetry.tracing import load_spans as jload_spans
from deepspeed_tpu_torch.telemetry import Telemetry
from deepspeed_tpu_torch.telemetry.flight_recorder import (NULL_RECORDER,
                                                           FlightRecorder)
from deepspeed_tpu_torch.telemetry.tracing import (NULL_TRACER, Tracer,
                                                   load_spans)
from tests.torch_serving_twins import (BS, package, shared_prefix_trace,
                                       twin_engines)


@pytest.fixture(scope="module")
def twins():
    jeng, teng = twin_engines()
    return package(jeng, True), package(teng, False)


def _traced_router(P, out, clock, n=2, **rover):
    tcfg = P.TelemetryConfig(enabled=True, output_path=str(out),
                             prometheus=False, jsonl=False, tracing=True,
                             flight_recorder=True)
    reps = [P.replica(spec_decode={"drafter": "ngram", "draft_k": 3})
            for _ in range(n)]
    return P.ServingRouter(replicas=reps, telemetry_config=tcfg,
                           clock=clock, **rover)


def _chrome_events(path):
    body = pathlib.Path(path).read_text()
    assert body.startswith("[")
    return [json.loads(ln.rstrip(",")) for ln in
            body.strip().splitlines()[1:]]


def _marks(path):
    """The chrome view's deterministic part: track names and the flow
    arrows (phase spans carry host times)."""
    out = []
    for e in _chrome_events(path):
        if e["ph"] == "M":
            out.append(("M", e["name"], e.get("tid"), e["args"]["name"]))
        elif e["ph"] in ("s", "f"):
            out.append((e["ph"], e["id"], e["tid"]))
    return out


def _untimed(events):
    """Flight events without their host stamps (the recorder reads its own
    monotonic clock)."""
    return [{k: v for k, v in e.items() if k != "t"} for e in events]


def test_router_trace_trees_equal_jax(twins, tmp_path):
    rng = np.random.default_rng(3)
    prompts = shared_prefix_trace(rng, 5)

    def scenario(P):
        out = tmp_path / ("jax" if P.jax else "port")
        router = _traced_router(P, out, P.chaos.ChaosClock(tick=0.001),
                                routing_policy="round_robin")
        res = router.run([P.Request(uid=i, tokens=p, max_new_tokens=5,
                                    stop_on_eos=False)
                          for i, p in enumerate(prompts)])
        router.telemetry.close()
        return ({uid: d.tokens.tolist() for uid, d in res.items()},
                jload_spans(out / "router.trace.jsonl"),
                _marks(out / "router.trace.json"))

    J, T = twins
    jres, jspans, jmarks = scenario(J)
    tres, tspans, tmarks = scenario(T)
    assert tres == jres
    # every span record equal: trace/span ids, parents, names, uids,
    # tracks, injected-clock times and attributes
    assert tspans == jspans
    assert tmarks == jmarks
    traces = {}
    for s in tspans:
        traces.setdefault(s["trace"], []).append(s)
    assert len(traces) == len(prompts)
    for tr in traces.values():
        by_id = {s["span"]: s for s in tr}
        roots = [s for s in tr if s["parent"] == 0]
        assert len(roots) == 1 and roots[0]["name"] == "request"
        assert all(s["parent"] in by_id for s in tr if s["parent"])
        assert {"dispatch", "submit", "admit", "prefill_chunk", "verify",
                "retire"} <= {s["name"] for s in tr}
        disp = next(s for s in tr if s["name"] == "dispatch")
        pf = next(s for s in tr if s["name"] == "prefill_chunk")
        assert pf["parent"] == disp["span"] and disp["tid"] == 0
        assert pf["tid"] in (1, 2)
    assert ("M", "thread_name", 1, "replica r0") in tmarks
    assert sum(m[0] == "s" for m in tmarks) == len(prompts)


def test_trace_continuity_under_failover(twins, tmp_path):
    rng = np.random.default_rng(7)
    prompts = shared_prefix_trace(rng, 6)

    def scenario(P):
        out = tmp_path / ("jax" if P.jax else "port")
        router = _traced_router(P, out, P.chaos.ChaosClock(tick=0.001))
        for i, p in enumerate(prompts):
            router.submit(P.Request(uid=i, tokens=p, max_new_tokens=5,
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
        router.telemetry.close()
        dumps = sorted(out.glob("router.flightrec.*.json"))
        dump = json.loads(dumps[0].read_text())
        return (victim, sorted(res), jload_spans(out / "router.trace.jsonl"),
                len(dumps), dump["reason"], _untimed(dump["events"]),
                dump["state"]["counters"])

    J, T = twins
    jout, tout = scenario(J), scenario(T)
    assert tout == jout
    victim, done, spans, n_dumps, reason, events, ctr = tout
    assert done == list(range(len(prompts))) and n_dumps == 1
    rerouted = {s["uid"] for s in spans if s["name"] == "reroute"}
    assert rerouted
    for uid in rerouted:
        mine = [s for s in spans if s["uid"] == uid]
        assert len({s["trace"] for s in mine}) == 1
        assert [s["name"] for s in mine].count("dispatch") == 2
        root = next(s for s in mine if s["parent"] == 0)
        assert all(d["parent"] == root["span"] for d in mine
                   if d["name"] == "dispatch")
    assert f"replica {victim} failed" in reason
    kinds = [e["kind"] for e in events]
    assert "quarantine" in kinds and "dispatch" in kinds
    assert ctr["replica_failures"] == 1


def test_standalone_engine_trace_and_flight_recorder(tmp_path):
    def scenario(jax_side):
        out = tmp_path / ("jax" if jax_side else "port")
        engines = twin_engines(telemetry={
            "enabled": True, "output_path": str(out), "prometheus": False,
            "jsonl": False, "tracing": True, "flight_recorder": True,
            "flight_recorder_events": 4})
        P = package(engines[0 if jax_side else 1], jax_side)
        serving = P.engine.serving(max_slots=2, max_context=128,
                                   clock=P.chaos.ChaosClock(tick=0.001))
        rng = np.random.default_rng(0)
        res = serving.run([P.Request(uid=i, tokens=rng.integers(
            0, 256, (9 + i,)).astype(np.int32), max_new_tokens=4,
            stop_on_eos=False) for i in range(3)])
        events = serving.flightrec.events()
        path = serving.flightrec.dump("operator dump", state=serving.stats())
        path2 = serving.flightrec.dump("again")
        serving.telemetry.close()
        return ({u: d.tokens.tolist() for u, d in res.items()},
                jload_spans(out / "serving.trace.jsonl"), _untimed(events),
                json.loads(pathlib.Path(path).read_text()),
                pathlib.Path(path).name, pathlib.Path(path2).name, out)

    jout, tout = scenario(True), scenario(False)
    assert tout[:3] == jout[:3]
    res, spans, events, dump, name, name2, out = tout
    traces = {}
    for s in spans:
        traces.setdefault(s["trace"], []).append(s)
    assert len(traces) == 3
    for tr in traces.values():
        roots = [s for s in tr if s["parent"] == 0]
        assert len(roots) == 1 and roots[0]["dur"] > 0
        assert {"submit", "queued", "admit", "prefill_chunk",
                "decode_window", "retire"} <= {s["name"] for s in tr}
    # the ring is bounded to flight_recorder_events, newest kept
    assert len(events) == 4 and [e["seq"] for e in events][-1] > 4
    assert dump["reason"] == "operator dump" and len(dump["events"]) == 4
    assert dump["state"]["tokens_generated"] == 12
    assert _untimed(dump["events"]) == _untimed(jout[3]["events"])
    assert (name, name2) == (jout[4], jout[5]) == \
        ("serving.flightrec.000.json", "serving.flightrec.001.json")
    # a new recorder in the same folder resumes the numbering
    fresh = FlightRecorder(out_dir=str(out), subsystem="serving")
    fresh.record("post-restart")
    assert pathlib.Path(fresh.dump("after restart")).name == \
        "serving.flightrec.002.json"


def test_disabled_default_no_tracing_work(twins, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _, T = twins
    serving = T.replica()
    assert serving.tracer is NULL_TRACER and serving.flightrec is \
        NULL_RECORDER
    serving.submit(T.Request(uid=0, tokens=np.arange(9, dtype=np.int32),
                             max_new_tokens=3, stop_on_eos=False))
    assert serving.queue[0][8] is None          # no TraceContext minted
    assert serving.run([])[0].finish_reason == "length"
    assert serving.flightrec.events() == []
    assert list(tmp_path.iterdir()) == []
    NULL_TRACER.record(None, "x", 0.0)
    NULL_TRACER.finish(None, 1.0)
    assert NULL_TRACER.start(0) is None
    assert serving.flightrec.dump("x") is None
    tel = Telemetry(T.TelemetryConfig(enabled=True, prometheus=False,
                                      jsonl=False))
    assert not (tel.tracer.enabled or tel.flightrec.enabled)


def test_tracer_units_parenting_and_torn_line(tmp_path):
    t = Tracer(tmp_path / "u.trace.jsonl")
    ctx = t.start("req", t0=10.0, owner="router")
    assert ctx.parent_id == ctx.root_id
    sid = t.record(ctx, "dispatch", 10.5, 0.0, parent=ctx.root_id)
    ctx.parent_id = sid
    t.record(ctx, "prefill", 10.6, 0.1, tid=1)
    t.event(ctx, "mark", 10.7, tid=1)
    t.finish(ctx, 11.0)
    t.close()
    with open(tmp_path / "u.trace.jsonl", "a") as f:
        f.write('{"trace": "t9", "span"')
    spans = load_spans(tmp_path / "u.trace.jsonl")
    assert spans == jload_spans(tmp_path / "u.trace.jsonl")
    assert len(spans) == 4
    root = next(s for s in spans if s["parent"] == 0)
    assert root["name"] == "request" and root["dur"] == pytest.approx(1.0)
    pf = next(s for s in spans if s["name"] == "prefill")
    assert pf["parent"] == sid and pf["tid"] == 1
    assert BS == 16
