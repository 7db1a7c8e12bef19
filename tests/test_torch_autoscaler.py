"""The port's autoscaler and operator CLIs held to the JAX package's: the
same tick sequence over scripted signals gives the same actions, counters,
telemetry, flight events and `stats()` in both packages' `Autoscaler`;
end to end over the tiny twin engines, scale-up under queue pressure, the
join warmup's affinity, drain and reap when idle and a refused divergent
spawn give equal actions, counters and tokens; and the same snapshot,
JSONL or span file renders the same text and JSON through `dstpu_top`,
`dstpu_pool`'s helpers, `dstpu_metrics` and `dstpu_trace`, with the same
exit codes."""

import json

import numpy as np
import pytest

from deepspeed_tpu.serving import autoscaler as jas
from deepspeed_tpu.serving import pool_cli as jpool
from deepspeed_tpu.serving import top_cli as jtop
from deepspeed_tpu.telemetry import cli as jcli
from deepspeed_tpu.telemetry import tracing as jtr
from deepspeed_tpu_torch.serving import autoscaler as tas
from deepspeed_tpu_torch.serving import pool_cli as tpool
from deepspeed_tpu_torch.serving import top_cli as ttop
from deepspeed_tpu_torch.telemetry import cli as tcli
from deepspeed_tpu_torch.telemetry import tracing as ttr
from tests.torch_serving_twins import BS, TINY, package, twin_engines


def test_names_resolve_to_the_ported_classes():
    from deepspeed_tpu_torch import serving
    assert serving.Autoscaler is tas.Autoscaler
    assert serving.AutoscalerConfig is tas.AutoscalerConfig
    assert {"Autoscaler", "AutoscalerConfig"} <= set(serving.__all__)
    import dataclasses
    assert dataclasses.asdict(tas.AutoscalerConfig()) == \
        dataclasses.asdict(jas.AutoscalerConfig())


# ----------------------------------------------------------------------
# the control loop over scripted signals
# ----------------------------------------------------------------------


class _Tel:
    def __init__(self):
        self.counters, self.gauges = {}, {}

    def inc(self, name, n=1):
        self.counters[name] = self.counters.get(name, 0) + n

    def set_gauge(self, name, v):
        self.gauges[name] = v


class _Rec:
    enabled = True

    def __init__(self):
        self.events = []

    def record(self, kind, **kw):
        self.events.append((kind, kw))


class _Rep:
    def __init__(self, rid, active=0, queue=0, level=0):
        self.replica_id = rid
        self.num_active, self.queue_depth, self.level = active, queue, level
        self.closed = False

    def stats(self):
        return {"degradation": {"level": self.level}}

    def close(self):
        self.closed = True


class _StubRouter:
    """The router surface the autoscaler reads and drives, scripted: each
    tick's queue depth, headroom and busy state come from `script`."""

    def __init__(self, n):
        self.replicas = {f"r{i}": _Rep(f"r{i}") for i in range(n)}
        self.queue = []
        self.telemetry = _Tel()
        self.flightrec = _Rec()
        self.headroom = None
        self.draining = set()
        self.busy = set()
        self.refuse = False

    def _healthy(self):
        return [r for rid, r in self.replicas.items()
                if rid not in self.draining]

    def memory_snapshot(self):
        return {} if self.headroom is None \
            else {"headroom_frac": self.headroom}

    def add_replica(self, handle):
        if self.refuse:
            raise ValueError("different model fingerprint")
        self.replicas[handle.replica_id] = handle

    def drain_replica(self, rid):
        self.draining.add(rid)

    def replica_idle(self, rid):
        return rid not in self.busy

    def remove_replica(self, rid):
        self.draining.discard(rid)
        self.replicas.pop(rid).close()


# (queue depth, headroom, busy drainers, degradation level of r0,
#  refuse joins) per tick
_SCRIPT = ([(9, None, (), 0, False)] * 3 + [(0, None, (), 0, False)] * 4
           + [(0, 0.02, (), 0, False)] * 3 + [(0, None, (), 3, False)] * 3
           + [(0, None, (), 0, False)] * 12
           + [(0, None, ("spawn0", "spawn1", "r0"), 0, False)] * 3
           + [(0, None, (), 0, False)] * 10
           + [(20, None, (), 0, True)] * 4 + [(0, None, (), 0, False)] * 6)


def _control_walk(mod):
    router = _StubRouter(1)
    spawned = []

    def spawn(i):
        rep = _Rep(f"spawn{i}")
        rep.submitted = []
        rep.submit = rep.submitted.append
        rep.step = lambda: None
        spawned.append(rep)
        return rep

    scaler = mod.Autoscaler(router, spawn=spawn, min_replicas=1,
                            max_replicas=3, sustain_up=2, sustain_down=4,
                            cooldown_ticks=2, warmup_prompts=1)
    scaler.note_prompt(np.arange(8, dtype=np.int32))
    actions, stats = [], []
    for depth, head, busy, level, refuse in _SCRIPT:
        router.queue = list(range(depth))
        router.headroom = head
        router.busy = set(busy)
        router.refuse = refuse
        router.replicas.get("r0", _Rep("x")).level = level
        actions.append(scaler.tick())
        stats.append(scaler.stats())
    warm = [[(r.uid, np.asarray(r.tokens).tolist(), r.max_new_tokens)
             for r in rep.submitted] for rep in spawned]
    return (actions, stats, scaler.counters, router.telemetry.counters,
            router.telemetry.gauges, router.flightrec.events, warm,
            [rep.closed for rep in spawned], sorted(router.replicas))


def test_tick_sequence_equals_jax_over_scripted_signals():
    port, ref = _control_walk(tas), _control_walk(jas)
    assert port == ref
    actions = port[0]
    # every branch of the loop is on the script
    assert {"scale_up", "scale_down", "reap", None} <= set(actions)
    assert port[2]["join_refused"] >= 1 and port[2]["warmup_prompts"] >= 1


def test_config_validation_raises():
    with pytest.raises(ValueError, match="at least one replica"):
        tas.Autoscaler(_StubRouter(1), spawn=None, min_replicas=0)
    with pytest.raises(ValueError, match="max_replicas"):
        tas.Autoscaler(_StubRouter(1), spawn=None, min_replicas=3,
                       max_replicas=2)


# ----------------------------------------------------------------------
# end to end over the tiny twin engines (test_fabric.py's scenarios)
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def twins():
    jeng, teng = twin_engines()
    return package(jeng, True), package(teng, False)


def _mods(P):
    return jas if P.jax else tas


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY.vocab_size, (int(rng.integers(5, 20)),))
            .astype(np.int32) for _ in range(n)]


def _spawner(P, prefix):
    def spawn(i):
        return P.InProcessReplica(engine=P.replica(),
                                  replica_id=f"{prefix}{i}")
    return spawn


def _tokens(done):
    return {uid: np.asarray(d.tokens).tolist() for uid, d in done.items()}


def _scale_up(P):
    router = P.ServingRouter(replicas=[P.replica()])
    scaler = _mods(P).Autoscaler(
        router, spawn=_spawner(P, "up"), min_replicas=1, max_replicas=2,
        scale_up_queue_per_replica=4.0, sustain_up=2, cooldown_ticks=0,
        warmup_prompts=0)
    for i, p in enumerate(_prompts(10, seed=5)):
        router.submit(P.Request(uid=i, tokens=p, max_new_tokens=4,
                                stop_on_eos=False))
    actions = [scaler.tick(), scaler.tick()]
    done = router.run([])
    actions.append(scaler.tick())
    return (actions, dict(scaler.counters), sorted(router.replicas),
            router.counters["completed"], _tokens(done))


def _warmup(P):
    prefix = np.random.default_rng(9).integers(
        0, TINY.vocab_size, (2 * BS,)).astype(np.int32)
    router = P.ServingRouter(replicas=[P.replica()])
    scaler = _mods(P).Autoscaler(
        router, spawn=_spawner(P, "warm"), min_replicas=1, max_replicas=2,
        scale_up_queue_per_replica=1.0, sustain_up=1, cooldown_ticks=0,
        warmup_prompts=1)
    scaler.note_prompt(prefix)
    for i in range(4):
        router.submit(P.Request(uid=f"w{i}", tokens=prefix,
                                max_new_tokens=2, stop_on_eos=False))
    action = scaler.tick()
    joined = router.replicas["warm0"]
    hit = joined.affinity(joined.hash_chain(prefix))
    done = router.run([])
    return action, dict(scaler.counters), hit, _tokens(done)


def _drain(P):
    router = P.ServingRouter(replicas=[P.replica(), P.replica()])
    scaler = _mods(P).Autoscaler(router, spawn=_spawner(P, "dn"),
                                 min_replicas=1, max_replicas=3,
                                 sustain_down=3, cooldown_ticks=0)
    done = router.run([P.Request(uid=i, tokens=p, max_new_tokens=3,
                                 stop_on_eos=False)
                       for i, p in enumerate(_prompts(4, seed=6))])
    actions = [scaler.tick() for _ in range(5)]
    for _ in range(20):
        actions.append(scaler.tick())
    return (actions, dict(scaler.counters), sorted(router.replicas),
            router.counters["drains"], router.counters["removed"],
            _tokens(done))


def _refused(P):
    from deepspeed_tpu_torch.serving import ReplicaHandle as TH
    from deepspeed_tpu.serving.replica import ReplicaHandle as JH
    base = JH if P.jax else TH
    desc = dict(P.InProcessReplica(engine=P.replica(), replica_id="x")
                .compat_descriptor(), fingerprint="X")

    class Divergent(base):
        def __init__(self, rid):
            self.replica_id = rid
            self.closed = False

        def compat_descriptor(self):
            return desc

        def close(self):
            self.closed = True

    spawned = []

    def spawn(i):
        spawned.append(Divergent(f"bad{i}"))
        return spawned[-1]

    router = P.ServingRouter(replicas=[P.replica()])
    scaler = _mods(P).Autoscaler(
        router, spawn=spawn, min_replicas=1, max_replicas=2,
        scale_up_queue_per_replica=1.0, sustain_up=1, cooldown_ticks=0,
        warmup_prompts=0)
    for i, p in enumerate(_prompts(4, seed=7)):
        router.submit(P.Request(uid=i, tokens=p, max_new_tokens=2,
                                stop_on_eos=False))
    action = scaler.tick()
    done = router.run([])
    return (action, dict(scaler.counters), sorted(router.replicas),
            [s.closed for s in spawned], _tokens(done))


@pytest.mark.parametrize("scenario", [_scale_up, _warmup, _drain, _refused],
                         ids=["scale_up", "warmup", "drain_reap",
                              "join_refused"])
def test_end_to_end_equals_jax(twins, scenario):
    J, T = twins
    port, ref = scenario(T), scenario(J)
    assert port == ref
    if scenario is _scale_up:
        assert port[0] == [None, "scale_up", None]
        assert port[2] == ["r0", "up0"] and port[3] == 10
    elif scenario is _warmup:
        assert port[0] == "scale_up" and port[1]["warmup_prompts"] == 1
        assert port[2] > 0              # warm blocks before any request
    elif scenario is _drain:
        assert "scale_down" in port[0] and "reap" in port[0]
        assert port[2] == ["r0"] or len(port[2]) == 1
        assert port[3] == 1 and port[4] == 1 and port[1]["reaps"] == 1
    else:
        assert port[0] is None and port[1]["join_refused"] == 1
        assert len(port[2]) == 1 and port[3] == [True]


# ----------------------------------------------------------------------
# the CLIs: same input file, same text, JSON and exit codes
# ----------------------------------------------------------------------


_SNAP = {"steps": 41, "queue_depth": 2, "in_flight": 3, "live_replicas": 2,
         "counters": {"completed": 9, "reroutes": 0},
         "pool_latency": {"serving/ttft_ms": {
             "count": 9, "mean": 12.5, "p50": 11.0, "p90": 30.0,
             "p99": 44.0}},
         "pool_metrics": {},
         "replicas": {
             "r0": {"role": "mixed", "health": "up", "restarts": 0,
                    "queue": 1, "active": 2, "available_blocks": 7,
                    "degradation_level": 1, "headroom_frac": 0.125,
                    "obs": {"pid": 4242, "dropped": 3}},
             "r1": {"role": "mixed", "health": "quarantined",
                    "restarts": 1}},
         "flight_events": [{"seq": 7, "t": 1.0, "kind": "scale_up",
                            "replica": "auto0"}]}


def _run(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err.replace("dstpu_", "")


def test_top_cli_equals_jax(tmp_path, capsys):
    assert ttop.render_top(_SNAP) == jtop.render_top(_SNAP)
    assert "[7] scale_up replica=auto0" in ttop.render_top(_SNAP)
    assert ttop.render_top({}) == jtop.render_top({})
    p = tmp_path / "pool_snapshot.json"
    p.write_text(json.dumps(_SNAP))
    for argv in ([str(p)], [str(p), "--json"],
                 [str(tmp_path / "nope.json")]):
        assert _run(ttop.main, argv, capsys) == _run(jtop.main, argv, capsys)
    assert _run(ttop.main, [str(p)], capsys)[0] == 0
    assert _run(ttop.main, [str(tmp_path / "nope.json")], capsys)[0] == 1


def test_pool_cli_config_and_status_table_equal_jax(tmp_path):
    for text in ('{"factory": "m:f", "replicas": 3}', '{"factory": "m:f"}'):
        assert tpool.load_config(text) == jpool.load_config(text)
    p = tmp_path / "pool.json"
    p.write_text('{"factory": "m:f", "kwargs": {"device": "cpu"}}')
    assert tpool.load_config(str(p)) == jpool.load_config(str(p))
    for bad, match in (('{"replicas": 2}', "factory"),
                       ('{"factory": "m:f", "replicas": 0}', "replicas")):
        for mod in (tpool, jpool):
            with pytest.raises(ValueError, match=match):
                mod.load_config(bad)
    rows = [{"id": "cli0", "role": "mixed", "alive": True, "queue": 0,
             "active": 2, "free_blocks": 11, "headroom_frac": 0.25},
            {"id": "cli1", "role": "mixed", "alive": False, "pid": 77}]
    assert tpool.status_table(rows) == jpool.status_table(rows)
    assert tpool.status_table(rows[1:]) == jpool.status_table(rows[1:])


def test_pool_cli_replica_row_equals_jax(twins):
    J, T = twins
    rows = []
    for P, mod in ((T, tpool), (J, jpool)):
        rep = P.InProcessReplica(engine=P.replica(), replica_id="cli0")
        rows.append(mod.replica_row(rep))
    assert rows[0] == rows[1]
    assert rows[0]["alive"] is True and rows[0]["queue"] == 0


def _metric_records():
    def rec(t, tokens, depth):
        return {"step": 1, "time": t, "metrics": {
            "serving/tokens": {"type": "counter", "value": tokens},
            "mem/params_bytes": {"type": "gauge", "value": 3 * 2 ** 20},
            "serving/queue_depth": {"type": "gauge", "value": depth},
            "serving/ttft_ms": {"type": "histogram", "count": 3,
                                "sum": 30.0, "mean": 10.0, "min": 1.0,
                                "max": 20.0, "p50": 10.0, "p90": 19.0,
                                "p99": 20.0}}}
    return rec(100.0, 1000.0, 2.0), rec(104.0, 1600.0, 3.0), \
        rec(108.0, 5.0, 1.0)


def test_metrics_render_and_rate_equal_jax():
    r0, r1, reset = _metric_records()
    for cur, prev in ((r1, r0), (r1, None), (r0, r1), (reset, r1)):
        for name in ("serving/tokens", "serving/queue_depth"):
            assert tcli.counter_rate(name, cur, prev) == \
                jcli.counter_rate(name, cur, prev)
        assert tcli.render(cur, prev=prev) == jcli.render(cur, prev=prev)
    assert tcli.counter_rate("serving/tokens", r1, r0) == \
        pytest.approx(150.0)
    assert "150/s" in tcli.render(r1, prev=r0)
    assert "3.00 MiB" in tcli.render(r1) or "MiB" in tcli.render(r1)


def test_metrics_cli_over_the_ports_jsonl_equals_jax(tmp_path, capsys):
    from deepspeed_tpu_torch.telemetry.exporters import JsonlExporter
    from deepspeed_tpu_torch.telemetry.registry import MetricsRegistry
    reg = MetricsRegistry()
    reg.counter("serving/tokens").inc(640)
    reg.gauge("serving/queue_depth").set(3)
    for v in (4.0, 9.0, 31.0):
        reg.histogram("serving/ttft_ms").observe(v)
    JsonlExporter(tmp_path / "serving.jsonl").export(reg, step=11)
    (tmp_path / "r1.jsonl").write_text(
        (tmp_path / "serving.jsonl").read_text() + '{"torn')
    for argv in ([str(tmp_path / "serving.jsonl"), "--json"],
                 [str(tmp_path / "serving.jsonl")],
                 [str(tmp_path), "--pool", "--json"],
                 [str(tmp_path / "nope")]):
        assert _run(tcli.main, argv, capsys) == _run(jcli.main, argv, capsys)
    rc, out, _ = _run(tcli.main, [str(tmp_path / "serving.jsonl"),
                                  "--json"], capsys)
    assert rc == 0 and json.loads(out)["metrics"] == reg.snapshot()
    assert tcli.load_pool(tmp_path)["sources"] == ["r1", "serving"]
    assert _run(tcli.main, [str(tmp_path / "nope")], capsys)[0] == 1


def _span_log(path, tracer_cls):
    t = tracer_cls(path)
    for uid, (t0, dur) in enumerate(((0.0, 0.5), (0.1, 1.5), (0.2, 0.9))):
        ctx = t.start(uid, t0=t0)
        t.record(ctx, "dispatch", t0, 0.01)
        t.record(ctx, "prefill_chunk", t0 + 0.01, dur / 3)
        t.record(ctx, "decode", t0 + 0.02 + dur / 3, dur / 2)
        t.finish(ctx, t0 + dur)
    t.close()


def test_trace_cli_equals_jax(tmp_path, capsys):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    _span_log(tmp_path / "port" / "router.trace.jsonl", ttr.Tracer)
    _span_log(tmp_path / "jax" / "router.trace.jsonl", jtr.Tracer)
    assert (tmp_path / "port" / "router.trace.jsonl").read_text() == \
        (tmp_path / "jax" / "router.trace.jsonl").read_text()
    for extra in ([], ["--uid", "1"], ["--slowest", "2"], ["--uid", "nope"]):
        got = _run(ttr.trace_main, [str(tmp_path / "port")] + extra, capsys)
        ref = _run(jtr.trace_main, [str(tmp_path / "jax")] + extra, capsys)
        assert got == (ref[0], ref[1], ref[2].replace(
            str(tmp_path / "jax"), str(tmp_path / "port")))
    rc, out, _ = _run(ttr.trace_main, [str(tmp_path / "port"),
                                       "--slowest", "2"], capsys)
    assert rc == 0 and "e2e_ms" in out and "decode" in out
    assert _run(ttr.trace_main, [str(tmp_path / "nope")], capsys)[0] == 1
    (tmp_path / "empty").mkdir()
    (tmp_path / "empty" / "x.trace.jsonl").write_text("")
    assert _run(ttr.trace_main, [str(tmp_path / "empty")], capsys) == \
        _run(jtr.trace_main, [str(tmp_path / "empty")], capsys)


_CLI_MODULES = ("deepspeed_tpu_torch.serving.top_cli",
                "deepspeed_tpu_torch.serving.pool_cli",
                "deepspeed_tpu_torch.telemetry.cli",
                "deepspeed_tpu_torch.telemetry.tracing")


@pytest.fixture(scope="module")
def cli_help():
    """Each CLI's `--help` run as `python -m <module>` runs it (runpy under
    `__main__`, the module's own argv): {module: (exit code, stdout)}."""
    import contextlib
    import io
    import runpy
    import sys
    import warnings
    out, argv = {}, sys.argv
    try:
        for m in _CLI_MODULES:
            sys.argv = [m, "--help"]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), warnings.catch_warnings():
                # the modules are imported already: runpy says so
                warnings.simplefilter("ignore", RuntimeWarning)
                try:
                    runpy.run_module(m, run_name="__main__")
                    code = 0
                except SystemExit as e:
                    code = e.code or 0
            out[m] = (code, buf.getvalue())
    finally:
        sys.argv = argv
    return out


@pytest.mark.parametrize("module", _CLI_MODULES)
def test_clis_run_as_modules(module, cli_help):
    code, out = cli_help[module]
    assert code == 0
    assert "usage:" in out
