"""`dstpu_top` — live pool dashboard over `router.observability_snapshot()`
(counterpart of `deepspeed_tpu/serving/top_cli.py`; run it as `python -m
deepspeed_tpu_torch.serving.top_cli`).

Two sources for the snapshot:

  * `--attach HOST:PORT ...` — build throwaway `RemoteReplica` handles
    around already-running replica servers, pull each one's observability
    state over the idempotent `observability_pull` verb, and render the
    merged pool view. Pulls never consume spool items, so an observer
    attaching to a pool a real router is also pulling cannot steal its
    data;
  * a positional `snapshot.json` — render a previously dumped
    `observability_snapshot()` (post-mortem / scripting round-trip).

`--json` emits the snapshot raw; `--watch` re-renders every `--interval`
seconds. The dashboard shows the pool story: merged
latency percentiles (exact, from bucket-wise-merged histograms), one row
per replica (health / queue / active / blocks / degradation rung /
headroom / spool drops), the fabric + router counters, and the most
recent flight events.
"""

import argparse
import json
import sys
import time
from typing import Any, Dict, List

_LAT_COLS = ("count", "mean", "p50", "p90", "p99")
_REP_COLS = ("id", "role", "health", "queue", "active", "blocks",
             "degrade", "headroom", "restarts", "dropped", "pid")


def _table(rows: List[tuple]) -> List[str]:
    widths = [max(len(str(r[i])) for r in rows) for i in range(len(rows[0]))]
    return ["  ".join(str(c).ljust(w) for c, w in zip(r, widths)).rstrip()
            for r in rows]


def _fmt(v, nd=1):
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def render_top(snap: Dict[str, Any]) -> str:
    """Pure snapshot -> dashboard text (what the tests drive)."""
    lines = [f"pool: steps={snap.get('steps', 0)} "
             f"queue={snap.get('queue_depth', 0)} "
             f"in_flight={snap.get('in_flight', 0)} "
             f"live={snap.get('live_replicas', 0)}/"
             f"{len(snap.get('replicas', {}))}"]

    lat = snap.get("pool_latency") or {}
    if lat:
        lines += ["", "pool latency (merged histograms):"]
        rows = [("metric",) + _LAT_COLS]
        for name in sorted(lat):
            m = lat[name]
            rows.append((name, str(int(m.get("count", 0))),
                         _fmt(m.get("mean")), _fmt(m.get("p50")),
                         _fmt(m.get("p90")), _fmt(m.get("p99"))))
        lines += _table(rows)

    reps = snap.get("replicas") or {}
    if reps:
        lines += ["", "replicas:"]
        rows = [_REP_COLS]
        for rid in sorted(reps):
            r = reps[rid]
            obs = r.get("obs") or {}
            rows.append((rid, r.get("role", "?"), r.get("health", "?"),
                         _fmt(r.get("queue")), _fmt(r.get("active")),
                         _fmt(r.get("available_blocks")),
                         _fmt(r.get("degradation_level")),
                         _fmt(r.get("headroom_frac"), nd=3),
                         _fmt(r.get("restarts")),
                         _fmt(obs.get("dropped")), _fmt(obs.get("pid"))))
        lines += _table(rows)

    counters = {k: v for k, v in (snap.get("counters") or {}).items() if v}
    if counters:
        lines += ["", "counters: " + "  ".join(
            f"{k}={counters[k]:g}" for k in sorted(counters))]

    events = snap.get("flight_events") or []
    if events:
        lines += ["", f"flight events (last {len(events)}):"]
        for ev in events:
            ev = dict(ev)
            seq, kind = ev.pop("seq", "?"), ev.pop("kind", "?")
            ev.pop("t", None)
            detail = " ".join(f"{k}={ev[k]}" for k in sorted(ev))[:100]
            lines.append(f"  [{seq}] {kind} {detail}".rstrip())
    return "\n".join(lines)


def _attach_snapshot(addrs: List[str]) -> Dict[str, Any]:
    """Ephemeral router over running replica servers -> one snapshot."""
    from deepspeed_tpu_torch.serving.remote_replica import RemoteReplica
    from deepspeed_tpu_torch.serving.router import ServingRouter
    reps = []
    for i, addr in enumerate(addrs):
        host, port = addr.rsplit(":", 1)
        reps.append(RemoteReplica(host=host, port=int(port),
                                  replica_id=f"r{i}"))
    router = ServingRouter(replicas=reps)
    try:
        return router.observability_snapshot(refresh=True)
    finally:
        for r in reps:
            try:
                r.close_transport()
            except Exception:
                pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dstpu_top",
        description="live serving-pool dashboard (merged latency, "
                    "per-replica health, flight events)")
    ap.add_argument("snapshot", nargs="?",
                    help="a dumped observability_snapshot() JSON file")
    ap.add_argument("--attach", nargs="*", metavar="HOST:PORT",
                    help="pull live state from running replica servers")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the snapshot raw instead of the dashboard")
    ap.add_argument("--watch", action="store_true",
                    help="re-render every --interval seconds")
    ap.add_argument("--interval", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not args.attach and not args.snapshot:
        ap.error("a snapshot file or --attach HOST:PORT is required")

    def emit() -> int:
        if args.attach:
            snap = _attach_snapshot(args.attach)
        else:
            try:
                with open(args.snapshot) as f:
                    snap = json.load(f)
            except (OSError, json.JSONDecodeError) as e:
                print(f"dstpu_top: cannot read {args.snapshot!r}: {e}",
                      file=sys.stderr)
                return 1
        print(json.dumps(snap, indent=2, default=str) if args.as_json
              else render_top(snap))
        return 0

    if not args.watch:
        return emit()
    try:
        while True:
            sys.stdout.write("\x1b[2J\x1b[H")
            emit()
            time.sleep(max(args.interval, 0.2))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
