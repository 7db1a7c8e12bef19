"""`dstpu_pool`: operate a multi-process serving pool from a config file
(counterpart of `deepspeed_tpu/serving/pool_cli.py`; run it as `python -m
deepspeed_tpu_torch.serving.pool_cli`).

Config (JSON)::

    {
      "factory": "deepspeed_tpu_torch.testing.fabric:tiny_serving_engine",
      "kwargs": {"max_slots": 2},
      "replicas": 2,
      "heartbeat_interval_s": 0.5,
      "router": {"max_replica_restarts": 1}
    }

`kwargs` reach the factory as they are: the tiny engine runs on the card
unless they hold `"device": "cpu"`.

Modes:

  * (default) launch `replicas` replica processes + a router, print the
    status table, serve an optional `--demo N` trace through the pool
    (smoke-proof: N requests, exactly-once, completion report), then shut
    everything down;
  * `--status` with `--attach host:port ...` — don't spawn anything; probe
    already-running replica servers and print the liveness table;
  * `--drain <id>` — in launch mode, drain that replica gracefully before
    the demo runs (the scale-down path, operable by hand);
  * `--json` — machine-readable output instead of the table.

The status table is built from each replica's OWN wire verbs (signals +
stats + heartbeat), so "what the operator sees" and "what the router acts
on" are the same numbers.
"""

import argparse
import json
import sys
from typing import Any, Dict, List, Optional


def load_config(path_or_json: str) -> Dict[str, Any]:
    """Accept a filename or an inline JSON object (starts with '{')."""
    text = path_or_json
    if not path_or_json.lstrip().startswith("{"):
        with open(path_or_json) as f:
            text = f.read()
    cfg = json.loads(text)
    if "factory" not in cfg:
        raise ValueError("pool config needs a 'factory' (module:function)")
    cfg.setdefault("kwargs", {})
    cfg.setdefault("replicas", 2)
    cfg.setdefault("heartbeat_interval_s", 0.5)
    cfg.setdefault("router", {})
    if int(cfg["replicas"]) < 1:
        raise ValueError("pool config needs replicas >= 1")
    return cfg


def replica_row(rep) -> Dict[str, Any]:
    """One status row from a live handle's wire verbs; degrades gracefully
    per-column on a dead replica (liveness is itself a column)."""
    from deepspeed_tpu_torch.serving.replica import ReplicaUnavailableError
    row: Dict[str, Any] = {"id": rep.replica_id, "role": rep.role}
    alive = rep.heartbeat_alive() if hasattr(rep, "heartbeat_alive") else True
    row["alive"] = alive
    pid = getattr(getattr(rep, "process", None), "pid", None)
    if pid is not None:
        row["pid"] = pid
    if not alive:
        return row
    try:
        row["queue"] = rep.queue_depth
        row["active"] = rep.num_active
        row["free_blocks"] = rep.available_blocks
        snap = rep.memory_snapshot()
        if snap and snap.get("headroom_frac") is not None:
            row["headroom_frac"] = round(float(snap["headroom_frac"]), 4)
    except ReplicaUnavailableError as e:
        row["alive"] = False
        row["error"] = str(e)[:120]
    return row


def status_table(rows: List[Dict[str, Any]]) -> str:
    """Fixed-order text table (the --status human view)."""
    cols = ["id", "role", "alive", "pid", "queue", "active", "free_blocks",
            "headroom_frac"]
    used = [c for c in cols if any(c in r for r in rows)] or cols[:3]
    widths = {c: max(len(c), *(len(str(r.get(c, "-"))) for r in rows))
              for c in used}
    lines = ["  ".join(c.ljust(widths[c]) for c in used),
             "  ".join("-" * widths[c] for c in used)]
    for r in rows:
        lines.append("  ".join(str(r.get(c, "-")).ljust(widths[c])
                               for c in used))
    return "\n".join(lines)


def _build_pool(cfg, drain: Optional[str]):
    from deepspeed_tpu_torch.serving.remote_replica import (RemoteConfig,
                                                      RemoteReplica,
                                                      ReplicaProcess)
    from deepspeed_tpu_torch.serving.router import ServingRouter
    rcfg = RemoteConfig(
        heartbeat_interval_s=float(cfg["heartbeat_interval_s"]))
    reps = []
    for i in range(int(cfg["replicas"])):
        proc = ReplicaProcess(
            factory=cfg["factory"], factory_kwargs=cfg["kwargs"],
            heartbeat_interval_s=rcfg.heartbeat_interval_s,
            replica_id=f"r{i}").spawn()
        proc.wait_ready(rcfg.ready_timeout_s)
        reps.append(RemoteReplica(process=proc, replica_id=f"r{i}",
                                  config=rcfg))
    router = ServingRouter(replicas=reps, **cfg["router"])
    if drain is not None:
        router.drain_replica(drain)
    return router, reps


def _demo(router, n: int) -> Dict[str, Any]:
    import numpy as np

    from deepspeed_tpu_torch.inference.scheduler import Request
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 200, (int(rng.integers(4, 24)),))
               .astype(np.int32) for _ in range(n)]
    done = router.run([Request(uid=i, tokens=p, max_new_tokens=8,
                               stop_on_eos=False)
                       for i, p in enumerate(prompts)])
    reasons: Dict[str, int] = {}
    for d in done.values():
        reasons[d.finish_reason] = reasons.get(d.finish_reason, 0) + 1
    return {"submitted": n, "completed": len(done), "reasons": reasons,
            "exactly_once": len(done) == n
            and sorted(done) == list(range(n))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dstpu_pool",
        description="launch/inspect a multi-process serving pool")
    ap.add_argument("config", nargs="?",
                    help="pool config: a JSON file or an inline JSON object")
    ap.add_argument("--status", action="store_true",
                    help="print the per-replica liveness/queue/headroom "
                         "table (with --attach: probe running servers)")
    ap.add_argument("--attach", nargs="*", metavar="HOST:PORT",
                    help="existing replica servers instead of spawning")
    ap.add_argument("--drain", metavar="ID",
                    help="gracefully drain this replica after launch")
    ap.add_argument("--demo", type=int, default=0, metavar="N",
                    help="serve N random requests through the pool")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    args = ap.parse_args(argv)

    if args.attach:
        from deepspeed_tpu_torch.serving.remote_replica import RemoteReplica
        reps = []
        for i, addr in enumerate(args.attach):
            host, port = addr.rsplit(":", 1)
            reps.append(RemoteReplica(host=host, port=int(port),
                                      replica_id=f"r{i}"))
        rows = [replica_row(r) for r in reps]
        print(json.dumps(rows, indent=2) if args.as_json
              else status_table(rows))
        for r in reps:
            r.close_transport()
        return 0 if all(r.get("alive") for r in rows) else 1

    if not args.config:
        ap.error("a pool config (or --attach) is required")
    cfg = load_config(args.config)
    router, reps = _build_pool(cfg, args.drain)
    rc = 0
    try:
        out: Dict[str, Any] = {"pool": [replica_row(r) for r in reps]}
        if args.demo:
            out["demo"] = _demo(router, args.demo)
            rc = 0 if out["demo"]["exactly_once"] else 1
        if args.as_json:
            out["router"] = {"counters": dict(router.counters)}
            print(json.dumps(out, indent=2))
        else:
            print(status_table(out["pool"]))
            if "demo" in out:
                print(f"\ndemo: {out['demo']}")
    finally:
        for rid in list(router.replicas):
            try:
                router.replicas[rid].close()
            except Exception:
                pass
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
