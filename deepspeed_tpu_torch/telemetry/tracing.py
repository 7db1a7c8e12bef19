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

`load_spans` reads a log back, and `trace_main` is the reference's
`dstpu_trace` CLI over it (`python -m deepspeed_tpu_torch.telemetry.tracing
[path] [--uid UID | --slowest N]`): the trace list, one request's
timeline (`render_timeline`) or the slowest requests with their per-phase
breakdown (`render_slowest`).
"""

import dataclasses
import itertools
import json
import os
import threading
from typing import Any, Dict, List, Optional

__all__ = ["TraceContext", "Tracer", "NULL_TRACER", "load_spans",
           "render_timeline", "render_slowest", "trace_main"]


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


def _group_traces(spans):
    traces: Dict[str, List[Dict[str, Any]]] = {}
    for s in spans:
        traces.setdefault(s["trace"], []).append(s)
    for tr in traces.values():
        tr.sort(key=lambda s: (s["ts"], s["span"]))
    return traces


def _root(tr):
    for s in tr:
        if s.get("parent") == 0:
            return s
    return None


def _fmt_table(rows):
    widths = [max(len(str(r[i])) for r in rows) for i in range(len(rows[0]))]
    return "\n".join("  ".join(str(c).ljust(w)
                               for c, w in zip(r, widths)).rstrip()
                     for r in rows)


def render_timeline(tr) -> str:
    """One request's spans as a table: offset/duration relative to the
    trace start, depth-indented by parent links."""
    t0 = min(s["ts"] for s in tr)
    by_id = {s["span"]: s for s in tr}

    def depth(s):
        d, seen = 0, set()
        while s["parent"] in by_id and s["span"] not in seen:
            seen.add(s["span"])
            s = by_id[s["parent"]]
            d += 1
        return d

    rows = [("at_ms", "dur_ms", "tid", "span", "attrs")]
    for s in tr:
        attrs = s.get("attrs") or {}
        a = " ".join(f"{k}={v}" for k, v in attrs.items())
        rows.append((f"{(s['ts'] - t0) * 1e3:10.3f}",
                     f"{s['dur'] * 1e3:9.3f}", s["tid"],
                     "  " * depth(s) + s["name"], a))
    return _fmt_table(rows)


def _phase_breakdown(tr) -> Dict[str, float]:
    """dur-ms summed per span name, root excluded — the per-phase view
    `--slowest` ranks with."""
    out: Dict[str, float] = {}
    for s in tr:
        if s.get("parent") == 0:
            continue
        out[s["name"]] = out.get(s["name"], 0.0) + s["dur"] * 1e3
    return out


def render_slowest(traces, n) -> str:
    """Top-n traces by root (e2e) duration with per-phase dur-ms columns."""
    roots = [(tr, _root(tr)) for tr in traces.values()]
    roots = [(tr, r) for tr, r in roots if r is not None]
    roots.sort(key=lambda x: -x[1]["dur"])
    roots = roots[:n]
    phases = sorted({name for tr, _ in roots
                     for name in _phase_breakdown(tr)})
    rows = [("uid", "trace", "e2e_ms", *phases)]
    for tr, r in roots:
        br = _phase_breakdown(tr)
        rows.append((str(r.get("uid")), r["trace"], f"{r['dur'] * 1e3:.3f}",
                     *(f"{br.get(p, 0.0):.3f}" for p in phases)))
    return _fmt_table(rows)


def trace_main(argv=None):
    """`dstpu_trace` — reconstruct request timelines from a trace JSONL."""
    import argparse
    import pathlib
    import sys

    ap = argparse.ArgumentParser(
        prog="dstpu_trace",
        description="Reconstruct per-request timelines from a deepspeed-tpu "
                    "trace log (<subsystem>.trace.jsonl).")
    ap.add_argument("path", nargs="?", default="telemetry",
                    help="trace .jsonl file or telemetry output dir "
                         "(default: ./telemetry)")
    ap.add_argument("--uid", default=None,
                    help="print one request's span timeline (by request uid)")
    ap.add_argument("--slowest", type=int, default=None, metavar="N",
                    help="rank the N slowest requests by e2e with a "
                         "per-phase duration breakdown")
    args = ap.parse_args(argv)

    p = pathlib.Path(args.path)
    if p.is_dir():
        logs = sorted(p.glob("*.trace.jsonl"), key=lambda f: f.stat().st_mtime)
        p = logs[-1] if logs else p
    if not p.is_file():
        print(f"dstpu_trace: no trace log at {args.path!r}", file=sys.stderr)
        return 1
    traces = _group_traces(load_spans(p))
    if not traces:
        print(f"dstpu_trace: {p} holds no spans", file=sys.stderr)
        return 1

    if args.uid is not None:
        matches = [tr for tr in traces.values()
                   if any(str(s.get("uid")) == args.uid for s in tr)]
        if not matches:
            print(f"dstpu_trace: no trace for uid {args.uid!r}",
                  file=sys.stderr)
            return 1
        for tr in matches:
            print(f"trace {tr[0]['trace']} uid={args.uid} "
                  f"({len(tr)} spans)")
            print(render_timeline(tr))
        return 0

    if args.slowest is not None:
        print(render_slowest(traces, args.slowest))
        return 0

    rows = [("trace", "uid", "spans", "e2e_ms")]
    for tid_, tr in sorted(traces.items()):
        r = _root(tr)
        rows.append((tid_, str(r.get("uid")) if r else "?", len(tr),
                     f"{r['dur'] * 1e3:.3f}" if r else "?"))
    print(_fmt_table(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(trace_main())
