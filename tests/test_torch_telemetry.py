"""The PyTorch port's telemetry core held to the JAX package's: the
registry (buckets, quantiles, snapshots, merges), the exporters
(Prometheus text byte for byte, JSONL records, the metrics CLI reading the
port's log), the chrome-trace spans, the monitors, the serving engine's
TTFT / TPOT / queue-wait / e2e histograms on the same trace and clock, and
the train engine's `train/*` and `moe/*` gauges.

Tolerances: registry, exporter and latency outputs are equal (the same
float expressions in both packages); `moe/*` gauges of the tiny fp32
MoE-GPT atol 1e-5, the CSV monitor's Train/loss rows rtol 1e-4 (the two
engines' losses, as tests/test_torch_moe.py holds them).
"""

import json
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import deepspeed_tpu
from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.config.core import MeshConfig
from deepspeed_tpu.config.core import TelemetryConfig as JTelemetryConfig
from deepspeed_tpu.inference.engine import init_inference as jax_init
from deepspeed_tpu.inference.scheduler import Request as JaxRequest
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.models import moe_gpt as jmoe_gpt
from deepspeed_tpu.monitor.monitor import CsvMonitor as JCsvMonitor
from deepspeed_tpu.telemetry import Histogram as JHistogram
from deepspeed_tpu.telemetry import JsonlExporter as JJsonlExporter
from deepspeed_tpu.telemetry import MetricsRegistry as JRegistry
from deepspeed_tpu.telemetry import Telemetry as JTelemetry
from deepspeed_tpu.telemetry import merge_snapshots as jmerge
from deepspeed_tpu.telemetry import prometheus_text as jprom
from deepspeed_tpu.telemetry.cli import load_latest, main as metrics_main
from deepspeed_tpu_torch import initialize, init_inference
from deepspeed_tpu_torch.config.core import CsvConfig, TelemetryConfig
from deepspeed_tpu_torch.inference.scheduler import Request
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models import moe_gpt as tmoe_gpt
from deepspeed_tpu_torch.models.gpt import params_from_jax
from deepspeed_tpu_torch.monitor import monitor as tmonitor
from deepspeed_tpu_torch.telemetry import (Histogram, JsonlExporter,
                                           MetricsRegistry, MonitorBridge,
                                           PrometheusFileExporter, Telemetry,
                                           merge_snapshots, prometheus_text)
from deepspeed_tpu_torch.telemetry.spans import ChromeTraceSink, span
from deepspeed_tpu_torch.utils import nvtx

REPO = Path(__file__).resolve().parents[1]
REGISTRY_ONLY = {"enabled": True, "prometheus": False, "jsonl": False,
                 "monitor_bridge": False}


def _observations(seed, n, lo=1e-3, hi=1e7):
    """Log-uniform values across and past the default 0.1 .. 1e6 edges."""
    rng = np.random.default_rng(seed)
    return [float(v) for v in np.exp(rng.uniform(np.log(lo), np.log(hi), n))]


# ----------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------

HIST_KW = [{}, {"lo": 1.0, "hi": 1e4, "buckets_per_decade": 3},
           {"lo": 0.01, "hi": 10.0, "buckets_per_decade": 10},
           {"bounds": [0.5, 1.0, 2.0, 8.0, 64.0]}]


@pytest.mark.parametrize("kw", HIST_KW, ids=lambda k: str(k))
@pytest.mark.parametrize("n", [0, 1, 2, 37, 500])
def test_histogram_buckets_and_quantiles_equal_jax(kw, n):
    """The same observations give the same bucket edges, bucket counts,
    quantiles at 21 levels and cumulative series, empty and single-
    observation histograms included."""
    ours, ref = Histogram("h", **kw), JHistogram("h", **kw)
    for v in _observations(n, n):
        ours.observe(v)
        ref.observe(v)
    assert ours.bounds == ref.bounds
    assert ours.counts == ref.counts
    for q in np.linspace(0.0, 1.0, 21):
        assert ours.quantile(float(q)) == ref.quantile(float(q))
    assert ours.cumulative_buckets() == ref.cumulative_buckets()
    assert ours.snapshot() == ref.snapshot()


def _registries(seed):
    """(port registry, JAX registry) with the same contents."""
    out = []
    for cls in (MetricsRegistry, JRegistry):
        r = cls()
        r.counter("serving/requests").inc(3)
        r.counter("router/completed").inc(seed + 1)
        r.gauge("serving/queue_depth").set(2.5 + seed)
        for v in _observations(seed, 40):
            r.histogram("serving/ttft_ms").observe(v)
        for v in _observations(seed + 9, 7, lo=0.5, hi=50.0):
            r.histogram("serving/tpot_ms", bounds=[1.0, 10.0, 100.0]) \
                .observe(v)
        out.append(r)
    return out


def test_snapshots_and_merges_equal_jax():
    ours, ref = {}, {}
    for i, src in enumerate(("r0", "r1", "r2")):
        a, b = _registries(i)
        assert a.snapshot() == b.snapshot()
        assert [n for n, _ in a.metrics()] == [n for n, _ in b.metrics()]
        ours[src], ref[src] = a.snapshot(), b.snapshot()
    merged = merge_snapshots(ours)
    assert merged == jmerge(ref)
    again = merge_snapshots({"pool": merged, "r3": ours["r0"]})
    assert again == jmerge({"pool": jmerge(ref), "r3": ref["r0"]})
    h = Histogram.from_state("serving/ttft_ms", merged["serving/ttft_ms"])
    assert h.snapshot() == JHistogram.from_state(
        "serving/ttft_ms", merged["serving/ttft_ms"]).snapshot()


@pytest.mark.parametrize("sources,match", [
    ({"a": {"x": {"type": "counter", "value": 1.0}},
      "b": {"x": {"type": "gauge", "value": 1.0}}}, "type conflict"),
    ({"a": {"x": {"type": "nope"}}}, "unknown snapshot type"),
    ({"a": {"h": Histogram("h", bounds=[1.0, 2.0]).snapshot()},
      "b": {"h": Histogram("h", bounds=[1.0, 2.0, 4.0]).snapshot()}},
     "mismatched bucket"),
], ids=["type", "unknown", "bounds"])
def test_merge_conflicts_raise_as_jax(sources, match):
    with pytest.raises(ValueError, match=match):
        merge_snapshots(sources)
    with pytest.raises(ValueError, match=match):
        jmerge(sources)


def test_registry_type_conflict_raises():
    r = MetricsRegistry()
    r.gauge("g")
    with pytest.raises(TypeError):
        r.counter("g")
    assert r.histogram("h") is r.histogram("h")


# ----------------------------------------------------------------------
# exporters
# ----------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_prometheus_text_byte_equal_to_jax(seed, tmp_path):
    ours, ref = _registries(seed)
    for r in (ours, ref):       # every escaping hazard of the name grammar
        r.counter("1weird/name-with.dots").inc()
        r.gauge("mem/bytes").set(1.5e12)
    help_map = {"serving/ttft_ms": 'line1\nline2 "q" \\backslash'}
    assert prometheus_text(ours) == jprom(ref)
    assert prometheus_text(ours, help_map) == jprom(ref, help_map)
    PrometheusFileExporter(tmp_path / "m.prom").export(ours)
    assert (tmp_path / "m.prom").read_bytes() == jprom(ref).encode()
    assert not (tmp_path / "m.prom.tmp").exists()


def test_jsonl_records_equal_jax_and_the_jax_cli_reads_them(tmp_path,
                                                            capsys):
    ours, ref = _registries(3)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    for d, r, cls in (("port", ours, JsonlExporter),
                      ("jax", ref, JJsonlExporter)):
        exp = cls(tmp_path / d / "serving.jsonl")
        exp.export(r, step=7)
        exp.export(r, step=8)
        exp.close()
    recs = {d: [json.loads(ln) for ln in
                (tmp_path / d / "serving.jsonl").read_text().splitlines()]
            for d in ("port", "jax")}
    for rec in recs["port"] + recs["jax"]:
        assert isinstance(rec.pop("time"), float)
    assert recs["port"] == recs["jax"]
    latest = load_latest(tmp_path / "port")
    assert latest["step"] == 8 and latest["metrics"] == ours.snapshot()
    assert metrics_main([str(tmp_path / "port"), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["metrics"] == ref.snapshot()
    assert metrics_main([str(tmp_path / "port")]) == 0
    assert "serving/ttft_ms" in capsys.readouterr().out


def test_monitor_bridge_and_csv_monitor_equal_jax(tmp_path):
    """The bridge's flattened events, and the CSV files they become, equal
    the JAX bridge's and JAX CsvMonitor's; a throwing monitor never
    raises."""
    ours, ref = _registries(5)
    got = {}
    for key, reg, bridge in (("port", ours, MonitorBridge),
                             ("jax", ref, deepspeed_tpu.telemetry
                              .MonitorBridge)):
        events = []
        sink = types.SimpleNamespace(enabled=True,
                                     write_events=events.extend)
        bridge(sink).export(reg, step=5)
        got[key] = events
    assert got["port"] == got["jax"]
    for key, cls in (("port", tmonitor.CsvMonitor), ("jax", JCsvMonitor)):
        cfg = types.SimpleNamespace(enabled=True,
                                    output_path=str(tmp_path / key),
                                    job_name="job")
        m = cls(cfg)
        m.write_events(got[key])
        m.write_events([("Train/loss", 0.25, 6), ("Train/loss", 0.125, 7)])
        m.close()
    files = {key: sorted(p.name for p in (tmp_path / key / "job").iterdir())
             for key in ("port", "jax")}
    assert files["port"] == files["jax"] and "Train_loss.csv" in files["port"]
    for name in files["port"]:
        assert (tmp_path / "port" / "job" / name).read_bytes() == \
            (tmp_path / "jax" / "job" / name).read_bytes()

    def boom(_events):
        raise OSError("network down")
    MonitorBridge(types.SimpleNamespace(enabled=True, write_events=boom)) \
        .export(ours, step=6)
    tmonitor.write_events_safe(None, [("a", 1.0, 0)])


def test_monitor_master_rank_and_lazy_backends(tmp_path, monkeypatch):
    """MonitorMaster writes from rank 0 only; a missing wandb warns and
    disables its monitor; TensorBoard is imported only when enabled."""
    cfg = types.SimpleNamespace(
        tensorboard=types.SimpleNamespace(enabled=False),
        wandb=types.SimpleNamespace(enabled=True, project="p", group=None,
                                    team=None),
        csv_monitor=CsvConfig(enabled=True, output_path=str(tmp_path),
                              job_name="j"))
    monkeypatch.setitem(sys.modules, "wandb", None)    # import fails
    m = tmonitor.MonitorMaster(cfg)
    assert m.enabled and not m.wandb_monitor.enabled
    assert m.tb_monitor.summary_writer is None
    m.write_events([("Train/loss", 1.0, 1)])
    monkeypatch.setattr(tmonitor, "_rank", lambda: 1)
    m.write_events([("Train/loss", 2.0, 2)])
    m.close()
    rows = (tmp_path / "j" / "Train_loss.csv").read_text().splitlines()
    assert rows == ["step,Train/loss", "1,1.0"]


def test_import_loads_no_tensorboard_and_no_jax():
    code = ("import sys, deepspeed_tpu_torch, deepspeed_tpu_torch.monitor, "
            "deepspeed_tpu_torch.telemetry, deepspeed_tpu_torch.runtime."
            "engine, deepspeed_tpu_torch.inference.scheduler\n"
            "bad = [m for m in sys.modules if 'tensorboard' in m or "
            "m.split('.')[0] in ('jax', 'jaxlib', 'deepspeed_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)


# ----------------------------------------------------------------------
# spans, files, the facade
# ----------------------------------------------------------------------


def _trace_events(path):
    return [json.loads(ln.rstrip(",")) for ln in
            Path(path).read_text().strip().splitlines()[1:]]


def test_chrome_trace_events_match_jax(tmp_path):
    from deepspeed_tpu.telemetry.spans import ChromeTraceSink as JSink
    from deepspeed_tpu.telemetry.spans import span as jspan
    events = {}
    for key, sink_cls, span_fn in (("port", ChromeTraceSink, span),
                                   ("jax", JSink, jspan)):
        sink = sink_cls(tmp_path / f"{key}.trace.json")
        sink.add_meta("process_name", "serving pool")
        sink.add_meta("thread_name", "replica 1", tid=1)
        with span_fn("serving/admit", sink=sink):
            pass
        with span_fn("serving/decode_window", sink=sink, tid=1):
            pass
        sink.close()
        events[key] = _trace_events(tmp_path / f"{key}.trace.json")
    for a, b in zip(events["port"], events["jax"], strict=True):
        assert a["dur"] >= 0 if a["ph"] == "X" else True
        drop = ("ts", "dur")
        assert {k: v for k, v in a.items() if k not in drop} == \
            {k: v for k, v in b.items() if k not in drop}
    # one sink, one run: a second sink on the same path truncates
    sink = ChromeTraceSink(tmp_path / "port.trace.json")
    with span("run1", sink=sink):
        pass
    sink.close()
    assert [e["name"] for e in _trace_events(tmp_path / "port.trace.json")] \
        == ["run1"]


def test_facade_span_files_layout(tmp_path):
    t = Telemetry(TelemetryConfig(enabled=True, output_path=str(tmp_path),
                                  chrome_trace=True, export_interval=2),
                  subsystem="sched")
    with t.span("serving/admit"):
        t.observe("serving/ttft_ms", 5.0)
    with t.span("serving/decode_window", tid=3):
        t.inc("serving/requests")
        t.set_gauge("serving/queue_depth", 1.0)
    t.maybe_export(1)                   # 1 % 2: nothing yet
    assert not (tmp_path / "sched.jsonl").exists()
    t.maybe_export(2)
    t.close()
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["sched.jsonl", "sched.prom", "sched.trace.json"]
    ev = _trace_events(tmp_path / "sched.trace.json")
    assert [(e["name"], e["tid"], e["ph"]) for e in ev] == \
        [("serving/admit", 0, "X"), ("serving/decode_window", 3, "X")]
    assert load_latest(tmp_path / "sched.jsonl")["metrics"] == \
        t.registry.snapshot()


def test_disabled_and_registry_only_telemetry_write_nothing(tmp_path,
                                                            monkeypatch):
    monkeypatch.chdir(tmp_path)
    for cfg in (None, TelemetryConfig(),
                TelemetryConfig(**REGISTRY_ONLY, output_path="tel")):
        t = Telemetry(cfg)
        t.observe("x_ms", 1.0)
        t.inc("c")
        t.set_gauge("g", 1.0)
        t.record_events([("a_ms", 1.0, 0), ("b", 2.0, 0)])
        with t.span("region"):
            pass
        t.maybe_export(1)
        t.export(2)
        t.close()
        assert (t.registry.snapshot() != {}) == t.enabled
    assert list(tmp_path.iterdir()) == []


def test_record_events_routes_like_jax():
    ours = Telemetry(TelemetryConfig(**REGISTRY_ONLY))
    ref = JTelemetry(JTelemetryConfig(**REGISTRY_ONLY))
    for t in (ours, ref):
        for ms in (10.0, 20.0, 40.0):
            t.record_events([("Checkpoint/save_ms", ms, 1),
                             ("Checkpoint/bytes", 1024.0, 1)])
    assert ours.registry.snapshot() == ref.registry.snapshot()


def test_close_flushes_the_final_export(tmp_path):
    t = Telemetry(TelemetryConfig(enabled=True, output_path=str(tmp_path),
                                  export_interval=1000), subsystem="m")
    t.observe("lat_ms", 5.0)
    t.maybe_export(3)
    assert not (tmp_path / "m.jsonl").exists()
    t.close()
    assert load_latest(tmp_path / "m.jsonl")["metrics"]["lat_ms"]["count"] \
        == 1
    t.close()                           # idempotent


def test_peak_flops_override_and_nvidia_table():
    t = Telemetry(TelemetryConfig(**REGISTRY_ONLY, peak_tflops=100.0))
    assert t.peak_flops("cpu") == pytest.approx(100e12)
    # no TPU figure, and no guess: the CPU is not in the table
    assert Telemetry(TelemetryConfig(**REGISTRY_ONLY)).peak_flops("cpu") \
        is None
    from deepspeed_tpu_torch.telemetry import PEAK_FLOPS
    assert PEAK_FLOPS == {"NVIDIA H100 80GB HBM3": 989e12}


@pytest.mark.parametrize("flag", ["tracing", "flight_recorder", "memscope"])
def test_unported_telemetry_features_refuse(flag):
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        TelemetryConfig(enabled=True, **{flag: True})
    t = Telemetry(TelemetryConfig(**REGISTRY_ONLY))
    assert not (t.tracer.enabled or t.flightrec.enabled or
                t.watchdog.enabled)
    assert t.watchdog.wrap("f", len) is len


def test_nvtx_is_a_hard_noop_without_a_profiler(monkeypatch):
    assert nvtx.range_push("r") is None
    nvtx.range_pop()                                # empty stack: no-op
    with nvtx.annotate("region"):
        pass

    @nvtx.instrument_w_nvtx
    def f(x):
        return x + 1

    assert f(1) == 2
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with nvtx.annotate("dstt/region"):
            torch.ones(4).sum()
        h = nvtx.range_push("dstt/pushed")
        nvtx.range_pop()
        assert f(2) == 3
    names = {e.key for e in prof.key_averages()}
    assert {"dstt/region", "dstt/pushed", f.__qualname__} <= names
    assert h is not None
    monkeypatch.setattr(nvtx, "_Annotation", None)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        assert nvtx.range_push("r") is None
        with nvtx.annotate("region"):
            pass


# ----------------------------------------------------------------------
# serving: TTFT / TPOT on the mixed trace of tests/test_telemetry.py
# ----------------------------------------------------------------------

TINY = jgpt.GPTConfig(n_layer=2, n_head=4, d_model=64, max_seq_len=256,
                      vocab_size=256, dtype=jnp.float32, remat=False)
SERVE_CONF = {"dtype": "float32", "kv_cache_dtype": "float32",
              "greedy": True, "kv_block_size": 16, "max_out_tokens": 64}
SHAPES = [(5, 4), (30, 8), (17, 3), (50, 6), (9, 5), (23, 7)]
TICK = 0.0137           # seconds the injected clock moves a step() call


def _mk_mesh():
    mesh_mod._CURRENT_MESH = None
    mesh_mod._CURRENT_SPEC = None
    mesh_mod.init_mesh(MeshConfig(data=1, tensor=1, sequence=1, expert=1,
                                  pipe=1))


def _serve_engines(telemetry):
    """(JAX engine, port engine) over the same weights."""
    _mk_mesh()
    jspec = jgpt.make_gpt_decode_model(cfg=TINY, name="tiny")
    conf = dict(SERVE_CONF)
    if telemetry is not None:
        conf["telemetry"] = dict(telemetry)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    jspec.params))
    pspec = tgpt.make_gpt_decode_model(
        tgpt.GPTConfig(n_layer=2, n_head=4, d_model=64, max_seq_len=256,
                       vocab_size=256, dtype="float32"), name="tiny",
        params=params)
    return (jax_init(model=jspec, config=dict(conf)),
            init_inference(pspec, config=conf, device="cpu"))


def _trace(cls):
    rng = np.random.default_rng(0)
    return [cls(uid=i, tokens=rng.integers(0, 256, (L,)).astype(np.int32),
                max_new_tokens=n, stop_on_eos=False)
            for i, (L, n) in enumerate(SHAPES)]


def _ticking(serving):
    """Inject a clock that moves TICK seconds at every step() call."""
    now = {"t": 0.0}
    serving.set_clock(lambda: now["t"])
    step = serving.step

    def ticked():
        now["t"] += TICK
        return step()
    serving.step = ticked
    return serving


def test_serving_latency_snapshots_equal_jax_bucket_for_bucket():
    je, te = _serve_engines(REGISTRY_ONLY)
    kw = dict(max_slots=4, max_context=128)
    jserving = _ticking(je.serving(**kw))
    tserving = _ticking(te.serving(**kw))
    jres = jserving.run(_trace(JaxRequest))
    tres = tserving.run(_trace(Request))
    jlat, tlat = jserving.latency_snapshot(), tserving.latency_snapshot()
    assert set(tlat) == {"ttft_ms", "tpot_ms", "queue_wait_ms", "e2e_ms"}
    n = len(SHAPES)
    assert tlat["ttft_ms"]["count"] == tlat["e2e_ms"]["count"] == \
        tlat["queue_wait_ms"]["count"] == n
    assert tlat["tpot_ms"]["count"] == sum(m for _, m in SHAPES) - n
    assert tlat == jlat
    assert 0 < tlat["ttft_ms"]["p50"] <= tlat["ttft_ms"]["p99"]
    for uid, r in tres.items():
        t, jt = r.timing, jres[uid].timing
        assert t == jt
        # the clock moves only between steps: a request admitted and
        # prefilled in one step has admit == first_token
        assert t["arrival"] <= t["admit"] <= t["first_token"] <= t["finish"]
        np.testing.assert_array_equal(r.tokens, jres[uid].tokens)
    stats = tserving.stats()
    assert stats["latency"] == tlat
    snap = tserving.telemetry.registry.snapshot()
    for gauge, value in (("serving/queue_depth", 0.0),
                         ("serving/active_slots", 0.0),
                         ("serving/free_blocks",
                          float(tserving.allocator.capacity))):
        assert snap[gauge] == {"type": "gauge", "value": value}
        assert jserving.telemetry.registry.snapshot()[gauge] == snap[gauge]


@pytest.mark.parametrize("window", [1, 4])
def test_serving_files_and_decode_window_tpot(tmp_path, window):
    """With file sinks on: serving.prom / .jsonl / .trace.json under the
    output path, the phase spans in the trace; a K-token decode window
    gives K TPOT samples, as in JAX."""
    tel = {"enabled": True, "output_path": str(tmp_path),
           "export_interval": 4, "chrome_trace": True}
    je, te = _serve_engines(tel)
    jserving = _ticking(je.serving(max_slots=4, max_context=128,
                                   decode_steps_per_sync=window))
    tserving = _ticking(te.serving(max_slots=4, max_context=128,
                                   decode_steps_per_sync=window))
    jserving.run(_trace(JaxRequest))
    tserving.run(_trace(Request))
    assert tserving.latency_snapshot() == jserving.latency_snapshot()
    tserving.close()
    names = {e["name"] for e in _trace_events(tmp_path /
                                              "serving.trace.json")}
    assert {"serving/admit", "serving/prefill_chunk",
            "serving/decode_window"} <= names
    assert load_latest(tmp_path)["metrics"] == \
        tserving.telemetry.registry.snapshot()
    prom = (tmp_path / "serving.prom").read_text()
    assert "serving_ttft_ms_count 6" in prom


class _OpLog(TorchDispatchMode):
    """Every aten op dispatched, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_serving_telemetry_off_is_unchanged_and_adds_no_device_op(
        tmp_path, monkeypatch):
    """Telemetry off: no timing, no latency block, an empty snapshot, no
    file anywhere. On or off, the served tokens and the dispatched ops
    (every device computation and read) are the same: the stamps are host
    clock reads."""
    monkeypatch.chdir(tmp_path)
    runs = {}
    for on in (False, True):
        _, te = _serve_engines(REGISTRY_ONLY if on else None)
        serving = te.serving(max_slots=4, max_context=128)
        log = _OpLog()
        with log:
            res = serving.run(_trace(Request))
        runs[on] = (res, log.ops, serving)
    res, ops, serving = runs[False]
    assert all(r.timing is None for r in res.values())
    assert "latency" not in serving.stats()
    assert serving.latency_snapshot() == {}
    assert serving.telemetry.registry.snapshot() == {}
    assert list(tmp_path.iterdir()) == []
    res_on, ops_on, _ = runs[True]
    assert len(ops) > 100 and ops_on == ops
    for uid in res:
        np.testing.assert_array_equal(res[uid].tokens, res_on[uid].tokens)


# ----------------------------------------------------------------------
# training: train/* and moe/* gauges, the CSV monitor
# ----------------------------------------------------------------------

TRAIN_CFG = tgpt.GPTConfig(n_layer=2, n_head=4, d_model=64, max_seq_len=64,
                           vocab_size=256, dtype="float32")


def _train_config(**over):
    return {"train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
            "zero_optimization": {"stage": 1},
            "steps_per_print": 10**9, **over}


def _train_batch(seed, rows=4, T=33):
    return {"tokens": np.random.default_rng(seed).integers(0, 256, (rows, T))
            .astype(np.int64)}


def test_train_gauges_and_mfu_under_an_override():
    steps = 3
    engine, *_ = initialize(
        model=tgpt.make_gpt_model(TRAIN_CFG, name="tiny"),
        config=_train_config(telemetry={**REGISTRY_ONLY,
                                        "peak_tflops": 100.0}),
        device="cpu")
    for i in range(steps):
        engine.train_batch(_train_batch(i))
    snap = engine.telemetry.registry.snapshot()
    assert snap["train/step_time_ms"]["count"] == steps
    assert snap["train/step_time_ms"]["p50"] > 0
    assert snap["train/tokens_per_sec"]["value"] > 0
    tflops = snap["train/tflops_per_chip"]["value"]
    assert tflops > 0
    assert 0.0 < snap["train/mfu"]["value"] <= 1.0
    assert snap["train/mfu"]["value"] == pytest.approx(tflops / 100.0)
    # the analytic 6N numerator over this run's tokens (tokens.size, as
    # the JAX engine counts them)
    n = sum(p.numel() for p in engine.state.params["blocks"].values()) + \
        sum(v.numel() for k, v in engine.state.params.items()
            if k != "blocks")
    assert engine._program_flops == 6.0 * n * 4 * 33
    assert "train/hbm_bytes_in_use" not in snap         # CUDA only


def test_train_mfu_unset_off_the_nvidia_table():
    engine, *_ = initialize(
        model=tgpt.make_gpt_model(TRAIN_CFG, name="tiny"),
        config=_train_config(telemetry=REGISTRY_ONLY), device="cpu")
    engine.train_batch(_train_batch(0))
    snap = engine.telemetry.registry.snapshot()
    assert snap["train/tflops_per_chip"]["value"] > 0
    assert "train/mfu" not in snap


def test_train_telemetry_off_adds_no_read_and_no_file(tmp_path, monkeypatch):
    """Off: the step dispatches the same ops as with telemetry on (no host
    read of a device value: no `_local_scalar_dense`), records nothing,
    and writes no file."""
    monkeypatch.chdir(tmp_path)
    logs = {}
    for on in (False, True):
        engine, *_ = initialize(
            model=tgpt.make_gpt_model(TRAIN_CFG, name="tiny"),
            config=_train_config(**({"telemetry": REGISTRY_ONLY} if on
                                    else {})), device="cpu")
        log = _OpLog()
        with log:
            for i in range(2):
                engine.train_batch(_train_batch(i))
        logs[on] = log.ops
        assert (engine.telemetry.registry.snapshot() != {}) == on
    assert "aten._local_scalar_dense.default" not in logs[False]
    assert logs[True] == logs[False]
    assert list(tmp_path.iterdir()) == []


def _moe_jax_cfg():
    return jmoe_gpt.MoEGPTConfig(n_layer=2, n_head=4, d_model=64, d_ff=128,
                                 max_seq_len=64, vocab_size=256,
                                 dtype=jnp.float32, remat=False,
                                 num_experts=4, moe_freq=2)


def test_moe_gauges_and_csv_monitor_match_jax_engine(tmp_path):
    """Three train_batch steps of the tiny MoE-GPT from the same weights
    and batches (the JAX engine on conftest's 8 virtual CPU devices, data
    only, at micro-batch 1; the port at micro-batch 8 — the same
    micro-batches): the `moe/*` gauges equal JAX's after every step, and
    the CSV monitors write the same files with the same Train/loss rows."""
    import dataclasses
    jcfg = _moe_jax_cfg()
    jspec = jmoe_gpt.make_moe_gpt_model(jcfg, name="moe-tiny", seed=7)
    np_params = jax.tree_util.tree_map(np.asarray, jspec.params)
    names = [f.name for f in dataclasses.fields(tmoe_gpt.MoEGPTConfig)
             if f.name != "dtype"]
    pcfg = tmoe_gpt.MoEGPTConfig(**{n: getattr(jcfg, n) for n in names},
                                 dtype="float32")
    base = {"gradient_accumulation_steps": 2,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
            "gradient_clipping": 1.0, "zero_optimization": {"stage": 1},
            "steps_per_print": 1}

    def extra(key):
        return {"telemetry": {**REGISTRY_ONLY,
                              "measure_program_flops": False},
                "csv_monitor": {"enabled": True,
                                "output_path": str(tmp_path / key),
                                "job_name": "job"}}
    jeng, *_ = deepspeed_tpu.initialize(
        model=jspec, config={**base, **extra("jax"),
                             "train_micro_batch_size_per_gpu": 1,
                             "mesh": {"data": 8}})
    teng, *_ = initialize(
        model=tmoe_gpt.make_moe_gpt_model(pcfg, name="moe-tiny",
                                          params=params_from_jax(np_params)),
        config={**base, **extra("port"), "train_micro_batch_size_per_gpu": 8},
        device="cpu")
    keys = ("moe/aux_loss", "moe/overflow_tokens", "moe/dropped_frac")
    for i in range(3):
        batch = {"tokens": np.random.default_rng(10 + i).integers(
            0, 256, (16, 33)).astype(np.int32)}
        jeng.train_batch(batch)
        teng.train_batch(batch)
        tsnap = teng.telemetry.registry.snapshot()
        jsnap = jeng.telemetry.registry.snapshot()
        for key in keys:
            assert tsnap[key]["type"] == "gauge"
            np.testing.assert_allclose(tsnap[key]["value"],
                                       jsnap[key]["value"], atol=1e-5)
    assert tsnap["train/step_time_ms"]["count"] == 3
    files = {k: sorted(p.name for p in (tmp_path / k / "job").iterdir())
             for k in ("port", "jax")}
    assert files["port"] == files["jax"] == [
        "Train_grad_norm.csv", "Train_loss.csv", "Train_loss_scale.csv",
        "Train_lr.csv"]
    rows = {k: [ln.split(",") for ln in (tmp_path / k / "job" /
                                         "Train_loss.csv")
                .read_text().splitlines()] for k in ("port", "jax")}
    assert rows["port"][0] == rows["jax"][0] == ["step", "Train/loss"]
    assert [r[0] for r in rows["port"]] == [r[0] for r in rows["jax"]]
    np.testing.assert_allclose([float(r[1]) for r in rows["port"][1:]],
                               [float(r[1]) for r in rows["jax"][1:]],
                               rtol=1e-4)
