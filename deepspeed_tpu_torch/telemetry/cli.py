"""`dstpu_metrics` — render the latest snapshot from a telemetry JSONL log
(counterpart of `deepspeed_tpu/telemetry/cli.py`; run it as `python -m
deepspeed_tpu_torch.telemetry.cli`).

The JSONL exporter appends one `{"step", "time", "metrics"}` object per
export interval; this CLI tails that file (or the newest `*.jsonl` in a
telemetry directory) and prints the latest snapshot as a table, as raw JSON
(`--json`, for scripting / the golden round-trip test), or continuously
(`--watch`).
"""

import argparse
import json
import pathlib
import sys
import time


def find_log(path):
    """Resolve a metrics log: a .jsonl file as-is, a directory to its newest
    `*.jsonl` by mtime. Returns None when nothing is there."""
    p = pathlib.Path(path)
    if p.is_file():
        return p
    if p.is_dir():
        logs = sorted(p.glob("*.jsonl"), key=lambda f: f.stat().st_mtime)
        if logs:
            return logs[-1]
    return None


def load_latest(path):
    """Last valid JSON record of the log (None when empty/absent). A torn
    final line — the exporter crashed mid-append — falls back to the
    previous record instead of erroring."""
    log = find_log(path)
    if log is None:
        return None
    record = None
    with open(log) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
            except json.JSONDecodeError:
                continue
    return record


def load_pool(path):
    """`--pool`: the latest record from EVERY `*.jsonl` metrics log under
    the directory, merged into ONE pool snapshot (`merge_snapshots`:
    counters sum, gauges keep a per-source map, histograms merge
    bucket-wise exactly) keyed by file stem. Non-metrics JSONL files in
    the same dir (trace/spool logs) are skipped — their records carry no
    `metrics` field."""
    p = pathlib.Path(path)
    if p.is_file():
        logs = [p]
    elif p.is_dir():
        logs = sorted(p.glob("*.jsonl"))
    else:
        logs = []
    per, step, when = {}, 0, 0
    for log in logs:
        rec = load_latest(log)
        if rec and rec.get("metrics"):
            per[log.stem] = rec["metrics"]
            step = max(step, int(rec.get("step", 0) or 0))
            when = max(when, rec.get("time", 0) or 0)
    if not per:
        return None
    from deepspeed_tpu_torch.telemetry.registry import merge_snapshots
    return {"step": step, "time": when, "sources": sorted(per),
            "metrics": merge_snapshots(per)}


def counter_rate(name, cur, prev):
    """Per-second rate of a counter between two snapshot records, or None
    when it cannot be computed (no previous record, metric absent/not a
    counter there, no wall-time delta, or a reset — the counter going
    BACKWARD between snapshots, e.g. a restarted process)."""
    if prev is None:
        return None
    pm = prev.get("metrics", {}).get(name)
    if pm is None or pm.get("type") != "counter":
        return None
    dt = cur.get("time", 0) - prev.get("time", 0)
    if dt <= 0:
        return None
    delta = cur["metrics"][name]["value"] - pm["value"]
    if delta < 0:
        return None
    return delta / dt


def render(record, prev=None):
    """Human table for one snapshot record. With `prev` (the previously
    rendered record — `--watch` threads it through), counters grow a
    per-interval rate column: the thing you actually watch is tokens/s or
    requests/s, not a raw monotonic total."""
    metrics = record.get("metrics", {})
    when = time.strftime("%Y-%m-%d %H:%M:%S",
                         time.localtime(record.get("time", 0)))
    lines = [f"step {record.get('step')} @ {when}", ""]
    rows = [("metric", "type", "value / count", "rate/s", "mean", "p50",
             "p90", "p99")]
    for name in sorted(metrics):
        m = metrics[name]
        if m.get("type") == "histogram":
            rows.append((name, "hist", str(m["count"]), "",
                         f"{m['mean']:.3f}", f"{m['p50']:.3f}",
                         f"{m['p90']:.3f}", f"{m['p99']:.3f}"))
        else:
            rate = counter_rate(name, record, prev) \
                if m.get("type") == "counter" else None
            val = m.get("value", 0)
            if "bytes" in name.replace("/", "_").split("_"):
                # byte-valued gauges/counters (the memscope ledger, HBM
                # watermarks) render human-readably in the table; --json
                # keeps the raw integer untouched
                from deepspeed_tpu_torch.telemetry.memscope import fmt_bytes
                shown = fmt_bytes(val)
            else:
                shown = f"{val:g}"
            rows.append((name, m.get("type", "?"), shown,
                         "" if rate is None else f"{rate:.3g}/s",
                         "", "", "", ""))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    for r in rows:
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="dstpu_metrics",
        description="Summarize a deepspeed-tpu telemetry JSONL metrics log.")
    ap.add_argument("path", nargs="?", default="telemetry",
                    help="metrics .jsonl file or telemetry output dir "
                         "(default: ./telemetry)")
    ap.add_argument("--json", action="store_true",
                    help="print the latest snapshot record as raw JSON")
    ap.add_argument("--pool", action="store_true",
                    help="merge the latest snapshot of EVERY *.jsonl in the "
                         "dir into one pool view (counters sum, histograms "
                         "merge bucket-wise — pool-exact percentiles)")
    ap.add_argument("--watch", action="store_true",
                    help="re-render every --interval seconds")
    ap.add_argument("--interval", type=float, default=2.0)
    args = ap.parse_args(argv)

    def emit(prev=None):
        record = (load_pool(args.path) if args.pool
                  else load_latest(args.path))
        if record is None:
            print(f"dstpu_metrics: no metrics log at {args.path!r}",
                  file=sys.stderr)
            return 1, prev
        print(json.dumps(record) if args.json
              else render(record, prev=prev))
        return 0, record

    if not args.watch:
        return emit()[0]
    prev = None
    try:
        while True:
            sys.stdout.write("\x1b[2J\x1b[H")
            # thread the previous snapshot through so counters render
            # per-interval rates, not just monotonic totals
            _, prev = emit(prev)
            time.sleep(max(args.interval, 0.2))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
