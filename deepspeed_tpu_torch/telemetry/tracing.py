"""Request-scoped tracing: one connected timeline per serving request
(counterpart of `deepspeed_tpu/telemetry/tracing.py`, stdlib only).

A `TraceContext` (trace id + span ids) is minted once per request — by the
`ServingRouter` at submit, or by a standalone `ServingEngine` — and rides
the request through every hop: router queue, dispatch, replica admission,
each prefill chunk, every decode window or verify step, KV handoff,
failover re-route, completion. Each hop records a span into the shared
`Tracer`, which writes two views of the same tree:

  * JSONL (`<subsystem>.trace.jsonl`) — one span a line
    (`trace`/`span`/`parent`/`name`/`uid`/`tid`/`ts`/`dur`/`attrs`, the
    reference's keys, so its `dstpu_trace` reads the port's logs);
  * chrome trace (`<subsystem>.trace.json`) — the same spans as "X"
    events on per-replica tids, plus flow events ("s"/"f") linking
    cross-replica hops (a handoff or a re-route is one arrow in Perfetto).

Disabled by default: a disabled tracer records nothing and writes no
file. Clockless: every span's `t0`/`dur` comes from the caller's clock
(the engine's and router's injected clocks), so traces of injected-clock
runs are deterministic. One tracer a pool: the router injects its tracer
into every in-process replica.

The timeline renderers of the reference's trace CLI wait for the port's
CLI slice; `load_spans` reads a log back.
"""

import dataclasses
import itertools
import json
import os
import threading
from typing import Any, Dict, List, Optional

__all__ = ["TraceContext", "Tracer", "NULL_TRACER", "load_spans"]


@dataclasses.dataclass
class TraceContext:
    """One request's place in a trace: carried through submit/dispatch/
    admission instead of thread-locals (the serving stack is an explicit
    host-side state machine — context travels with the request record).

    `parent_id` is the span new child spans attach under; the router moves
    it to each dispatch span so a re-routed request's second attempt nests
    under the re-route, not interleaved with the first. `flow_id` is a
    pending chrome flow arrow: set at the sending hop, consumed (and the
    "f" event emitted) by the receiving hop."""

    trace_id: str
    root_id: int
    uid: Any = None
    owner: str = "engine"          # who closes the root span at completion
    parent_id: int = 0             # current parent for new child spans
    flow_id: Optional[int] = None  # pending cross-track flow arrow
    t0: float = 0.0                # submit time on the owner's clock

    def __post_init__(self):
        if not self.parent_id:
            self.parent_id = self.root_id


class Tracer:
    """Span recorder behind an enabled flag. All methods are no-ops when
    disabled; when enabled they append one JSONL line (and mirror into the
    chrome sink when one is attached) per span, under a lock — cheap, and
    the serving stack records a handful of spans per scheduler step."""

    def __init__(self, path=None, chrome=None, enabled=True):
        self.enabled = bool(enabled) and path is not None
        self.path = str(path) if path is not None else None
        self.chrome = chrome if self.enabled else None
        self._f = None
        self._ids = itertools.count(1)     # span AND trace sequence numbers
        self._t0 = None                    # chrome ts baseline (first stamp)
        self._lock = threading.Lock()
        self._named_tids = set()
        # completed-span tap: the replica server's observability spool
        # subscribes here so finished spans can ship over the wire to the
        # router. None (the default) costs one attribute read per record.
        self.on_record = None

    # ---- context lifecycle -------------------------------------------

    def start(self, uid, t0=0.0, owner="engine") -> Optional[TraceContext]:
        """Mint a trace for one request (None when disabled — the request
        records carry None and every record site skips on it)."""
        if not self.enabled:
            return None
        n = next(self._ids)
        return TraceContext(trace_id=f"t{n:06d}", root_id=next(self._ids),
                            uid=uid, owner=owner, t0=t0)

    # ---- recording ----------------------------------------------------

    def record(self, ctx, name, t0, dur=0.0, tid=0, attrs=None,
               parent=None, span_id=None) -> int:
        """Record one complete span under `ctx`. Times are seconds on the
        caller's clock. Returns the span id (callers that re-parent — the
        router's dispatch span — keep it)."""
        if not self.enabled or ctx is None:
            return 0
        sid = span_id if span_id is not None else next(self._ids)
        rec = {"trace": ctx.trace_id, "span": sid,
               "parent": ctx.parent_id if parent is None else parent,
               "name": name, "uid": ctx.uid, "tid": tid,
               "ts": round(float(t0), 9), "dur": round(float(dur), 9)}
        if attrs:
            rec["attrs"] = attrs
        self._write(rec)
        if self.chrome is not None:
            self.chrome.write({"name": name, "ph": "X", "pid": os.getpid(),
                               "tid": tid, "ts": self._chrome_ts(t0),
                               "dur": round(dur * 1e6, 3),
                               "args": dict(attrs or {}, uid=str(ctx.uid),
                                            trace=ctx.trace_id)})
        return sid

    def event(self, ctx, name, t, tid=0, attrs=None) -> int:
        """Instant event (a zero-duration span in the JSONL tree, an "i"
        mark in the chrome view)."""
        if not self.enabled or ctx is None:
            return 0
        sid = next(self._ids)
        rec = {"trace": ctx.trace_id, "span": sid, "parent": ctx.parent_id,
               "name": name, "uid": ctx.uid, "tid": tid,
               "ts": round(float(t), 9), "dur": 0.0}
        if attrs:
            rec["attrs"] = attrs
        self._write(rec)
        if self.chrome is not None:
            self.chrome.write({"name": name, "ph": "i", "s": "t",
                               "pid": os.getpid(), "tid": tid,
                               "ts": self._chrome_ts(t),
                               "args": dict(attrs or {}, uid=str(ctx.uid),
                                            trace=ctx.trace_id)})
        return sid

    def finish(self, ctx, t_end, name="request", tid=0, attrs=None):
        """Close the root span (whole-request e2e). Called once, by the
        context's owner (router `_complete`, or a standalone engine's
        retirement path)."""
        if not self.enabled or ctx is None:
            return
        self.record(ctx, name, ctx.t0, max(0.0, t_end - ctx.t0), tid=tid,
                    attrs=attrs, parent=0, span_id=ctx.root_id)

    # ---- cross-track flow arrows (chrome-only linking) ------------------

    def flow_begin(self, ctx, t, tid=0):
        """Open a flow arrow at the sending hop (dispatch, re-route,
        handoff); the receiving hop calls `flow_end` and Perfetto draws the
        connecting arrow between the two tracks."""
        if not self.enabled or ctx is None:
            return
        fid = next(self._ids)
        ctx.flow_id = fid
        if self.chrome is not None:
            self.chrome.write({"name": "request-flow", "cat": "flow",
                               "ph": "s", "id": fid, "pid": os.getpid(),
                               "tid": tid, "ts": self._chrome_ts(t)})

    def flow_end(self, ctx, t, tid=0):
        if not self.enabled or ctx is None or ctx.flow_id is None:
            return
        fid, ctx.flow_id = ctx.flow_id, None
        if self.chrome is not None:
            self.chrome.write({"name": "request-flow", "cat": "flow",
                               "ph": "f", "bp": "e", "id": fid,
                               "pid": os.getpid(), "tid": tid,
                               "ts": self._chrome_ts(t)})

    # ---- track naming ---------------------------------------------------

    def name_process(self, name):
        if self.enabled and self.chrome is not None:
            self.chrome.add_meta("process_name", name)

    def name_track(self, tid, name):
        """Label a Perfetto track (idempotent per tid) — the router names
        tid 0 after itself and one tid per replica."""
        if not self.enabled or self.chrome is None or tid in self._named_tids:
            return
        self._named_tids.add(tid)
        self.chrome.add_meta("thread_name", name, tid=tid)

    # ---- plumbing -------------------------------------------------------

    def _chrome_ts(self, t):
        # share the chrome sink's perf_counter baseline when one is
        # attached: the default tracer clock (time.monotonic) reads the
        # same Linux CLOCK_MONOTONIC, so phase spans (Span/telemetry.span)
        # and request-trace events align on ONE Perfetto timeline instead
        # of drifting apart by the init-to-first-request offset. Injected
        # test clocks fall back to a first-stamp baseline (chrome ts is
        # cosmetic; the JSONL record keeps the caller's raw stamps).
        if self._t0 is None:
            sink_t0 = getattr(self.chrome, "_t0", None)
            self._t0 = sink_t0 if sink_t0 is not None \
                and abs(t - sink_t0) < 3600.0 else t
        return round((t - self._t0) * 1e6, 3)

    def _write(self, rec):
        with self._lock:
            if self._f is None:
                self._f = open(self.path, "a")
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        cb = self.on_record
        if cb is not None:
            cb(rec)

    def close(self):
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                finally:
                    self._f = None


NULL_TRACER = Tracer(path=None, enabled=False)


# ----------------------------------------------------------------------
# reading a JSONL span log back
# ----------------------------------------------------------------------


def load_spans(path) -> List[Dict[str, Any]]:
    """All span records of a trace log (a torn final line — crash
    mid-append — is skipped, like the metrics CLI)."""
    spans = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                spans.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return spans
