"""Unified telemetry: one registry, many sinks (counterpart of
`deepspeed_tpu/telemetry/__init__.py`).

`Telemetry` is the object the instrumented subsystems hold: it owns a
`MetricsRegistry` (`registry.py`), the configured exporters
(`exporters.py` — Prometheus textfile, JSONL log, monitor bridge) and an
optional chrome-trace span sink (`spans.py`). Construction from a
`TelemetryConfig` (config/core.py) with `enabled=False` — the default — is a
complete no-op: no directory is created, no file is written, `span()`
returns a shared null context and every record method returns immediately,
so the serving scheduler and the train loop can instrument unconditionally.
An enabled block with every file sink off (registry only) creates no
directory either.

Wiring (all opt-in via the `telemetry` config block):

  * ServingEngine (`inference/scheduler.py`): per-request
    `serving/ttft_ms` / `serving/tpot_ms` / `serving/queue_wait_ms` /
    `serving/e2e_ms` histograms, queue/slot/pool gauges, per-phase spans;
  * training Engine (`runtime/engine.py`): `train/step_time_ms` histogram,
    tokens/s, TFLOP/s and MFU gauges, device-memory watermarks, and the
    model's slash-keyed step metrics (`moe/*`) as gauges.

Two per-request diagnostics ride on the same config block and the same
disabled-by-default contract:

  * `tracer` (`tracing.py`, `telemetry.tracing`) — request-scoped span
    trees (`<subsystem>.trace.jsonl` + a flow-linked chrome trace);
  * `flightrec` (`flight_recorder.py`, `telemetry.flight_recorder`) — a
    bounded ring of scheduling events, dumped on failure.

`telemetry.memscope` builds the engines' memory ledgers (`memscope.py`).
The compile watchdog is a null object with its surface (the port compiles
no programs).

`peak_flops()` knows NVIDIA cards only (`PEAK_FLOPS`); on any other device,
with no `peak_tflops` override, it returns None and the train engine leaves
`train/mfu` unset.
"""

import contextlib
import pathlib

from deepspeed_tpu_torch.telemetry.registry import (Counter, Gauge, Histogram,
                                                    MetricsRegistry,
                                                    merge_snapshots)
from deepspeed_tpu_torch.telemetry.exporters import (JsonlExporter,
                                                     MonitorBridge,
                                                     PrometheusFileExporter,
                                                     prometheus_text)
from deepspeed_tpu_torch.telemetry import spans
from deepspeed_tpu_torch.telemetry.spans import ChromeTraceSink, Span
from deepspeed_tpu_torch.telemetry.tracing import (NULL_TRACER, TraceContext,
                                                   Tracer)
from deepspeed_tpu_torch.telemetry.flight_recorder import (NULL_RECORDER,
                                                           FlightRecorder)

__all__ = ["Telemetry", "MetricsRegistry", "Counter", "Gauge", "Histogram",
           "merge_snapshots", "PrometheusFileExporter", "JsonlExporter",
           "MonitorBridge", "prometheus_text", "ChromeTraceSink", "Span",
           "Tracer", "TraceContext", "FlightRecorder", "PEAK_FLOPS",
           "device_peak_flops"]

_NULL_SPAN = contextlib.nullcontext()

# Dense bf16 tensor-core peak per device, from NVIDIA's data sheets, keyed by
# the name `torch.cuda.get_device_name` gives. The H100 SXM (80 GB HBM3) is
# the card this package is measured on.
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}


def device_peak_flops(device=None):
    """The table's peak for `device` (default: the current CUDA device), or
    None for a device the table does not know (any CPU, any other card)."""
    import torch
    device = torch.device(device) if device is not None else None
    if device is not None and device.type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    return PEAK_FLOPS.get(torch.cuda.get_device_name(device))


class _NullWatchdog:
    """The compile watchdog's surface: this package compiles no programs,
    so there is nothing to watch."""
    enabled = False
    recompiles = 0

    def wrap(self, name, fn):
        return fn

    def summary(self):
        return {"recompiles": 0, "programs": {}}


NULL_WATCHDOG = _NullWatchdog()


class Telemetry:
    """Registry + exporters behind enable flags. See module docstring."""

    def __init__(self, config=None, subsystem="metrics", monitor=None,
                 registry=None):
        self.config = config
        self.subsystem = subsystem
        self.enabled = bool(config is not None and
                            getattr(config, "enabled", False))
        self.registry = registry if registry is not None else MetricsRegistry()
        self._exporters = []
        self._trace = None
        self._closed = False
        self.tracer = NULL_TRACER
        self.flightrec = NULL_RECORDER
        self.watchdog = NULL_WATCHDOG
        if not self.enabled:
            return
        out = pathlib.Path(config.output_path or "telemetry")
        tracing = bool(getattr(config, "tracing", False))
        flight = bool(getattr(config, "flight_recorder", False))
        if config.prometheus or config.jsonl or config.chrome_trace \
                or tracing or flight:
            # registry-only configurations (all file sinks off) must not
            # litter an empty directory
            out.mkdir(parents=True, exist_ok=True)
        if config.prometheus:
            self._exporters.append(
                PrometheusFileExporter(out / f"{subsystem}.prom"))
        if config.jsonl:
            self._exporters.append(JsonlExporter(out / f"{subsystem}.jsonl"))
        if config.monitor_bridge and monitor is not None and \
                getattr(monitor, "enabled", False):
            self._exporters.append(MonitorBridge(monitor))
        if config.chrome_trace or tracing:
            # one shared chrome sink: phase spans (span()) and request
            # traces (tracer) land on one Perfetto timeline
            self._trace = ChromeTraceSink(out / f"{subsystem}.trace.json")
        if tracing:
            self.tracer = Tracer(out / f"{subsystem}.trace.jsonl",
                                 chrome=self._trace)
        if flight:
            self.flightrec = FlightRecorder(
                out, subsystem=subsystem,
                capacity=int(getattr(config, "flight_recorder_events", 256)))

    # ---- recording ---------------------------------------------------

    def observe(self, name, value):
        if self.enabled:
            self.registry.histogram(name).observe(value)

    def set_gauge(self, name, value):
        if self.enabled:
            self.registry.gauge(name).set(value)

    def inc(self, name, n=1.0):
        if self.enabled:
            self.registry.counter(name).inc(n)

    def record_events(self, event_list):
        """Route monitor-style `(tag, value, step)` events into the registry:
        `*_ms` / `*_seconds` tags become histogram observations, everything
        else a gauge."""
        if not self.enabled:
            return
        for tag, value, _step in event_list:
            if tag.endswith(("_ms", "_seconds")):
                self.registry.histogram(tag).observe(value)
            else:
                self.registry.gauge(tag).set(value)

    def span(self, name, tid=0):
        """Timed/annotated host region (`spans.Span`); a shared null context
        when disabled. `tid` selects the chrome-trace track."""
        if not self.enabled:
            return _NULL_SPAN
        return spans.span(name, sink=self._trace, tid=tid)

    # ---- export ------------------------------------------------------

    def maybe_export(self, step):
        """Export every `export_interval`-th step (cheap modulo when idle)."""
        if not self.enabled:
            return
        interval = max(1, int(getattr(self.config, "export_interval", 1)))
        if step % interval == 0:
            self.export(step)

    def export(self, step=None):
        if not self.enabled:
            return
        snap = self.registry.snapshot()
        for e in self._exporters:
            e.export(self.registry, step=step, snapshot=snap)

    def peak_flops(self, device=None):
        """Per-device peak FLOPs/s: the config override (TFLOPs) when set,
        else `PEAK_FLOPS` for the card; None when neither knows it."""
        override = float(getattr(self.config, "peak_tflops", 0.0) or 0.0)
        if override > 0:
            return override * 1e12
        return device_peak_flops(device)

    def close(self):
        if self._closed:
            return
        self._closed = True
        # final export so runs shorter than export_interval (and the tail of
        # longer ones) still land in the files; guarded — close() also runs
        # from __del__ during interpreter teardown
        try:
            if self.enabled and self.registry.metrics():
                self.export()
        except Exception:
            pass
        for e in self._exporters:
            try:
                e.close()
            except Exception:
                pass
        if self._trace is not None:
            try:
                self._trace.close()
            except Exception:
                pass
        try:
            self.tracer.close()
        except Exception:
            pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
