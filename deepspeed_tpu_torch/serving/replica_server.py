"""Replica-server entrypoint: one ServingEngine behind the fabric wire
(counterpart of `deepspeed_tpu/serving/replica_server.py`, with its verb
names).

Run as::

    python -m deepspeed_tpu_torch.serving.replica_server \
        --factory deepspeed_tpu_torch.testing.fabric:tiny_serving_engine \
        --kwargs '{"max_slots": 2}' --port 0 \
        --heartbeat-interval 0.5 --ready-file r0.ready

`--factory module:function` names a zero-or-kwargs callable returning a
`ServingEngine` (the child process builds its OWN engine — params, CUDA
context, kernel libraries loaded from `build/`; nothing crosses the process
boundary but the wire). The engine is built, then the server binds and
writes ``host port`` to the ready-file — readiness means "serving".

The verb table is a straight projection of `InProcessReplica`: the same
handle the router drives in-process answers each RPC here, so the two
backends cannot drift. Engine verbs run under the transport's lock (one
engine, many connections). `stats` adds the process's `device` (type and
card name) and its kernel launch counts. A received deadline is a
REMAINING budget in seconds, re-anchored on this process's own clock (see
remote_replica.py for the clock protocol).
"""

import argparse
import importlib
import json
import os
import sys
import time


def load_factory(spec: str):
    """Resolve "pkg.module:function" to the callable."""
    if ":" not in spec:
        raise SystemExit(f"--factory must be 'module:function', got {spec!r}")
    mod_name, fn_name = spec.split(":", 1)
    mod = importlib.import_module(mod_name)
    fn = getattr(mod, fn_name, None)
    if fn is None:
        raise SystemExit(f"{mod_name} has no attribute {fn_name!r}")
    return fn


class ReplicaServerApp:
    """The verb table + lifecycle around one engine and one RpcServer."""

    def __init__(self, engine, host="127.0.0.1", port=0,
                 heartbeat_interval_s=0.5, clock=None, spool_capacity=1024):
        from deepspeed_tpu_torch.serving.replica import InProcessReplica
        from deepspeed_tpu_torch.serving.transport import RpcServer
        self.handle = InProcessReplica(engine=engine, replica_id="remote")
        self._clock = clock if clock is not None else time.monotonic
        self.telemetry = getattr(engine, "telemetry", None)
        self.spool = self._build_spool(spool_capacity)
        self.server = RpcServer(self.verb_table(), host=host, port=port,
                                heartbeat_interval_s=heartbeat_interval_s)

    def _build_spool(self, capacity):
        """Tap this process's tracer/flight-recorder into a bounded spool
        the router can pull over the wire (`observability_pull`). Only when
        a diagnostic is actually enabled — the observability-off default
        stays zero-overhead and writes no spool file."""
        tel = self.telemetry
        if tel is None or not getattr(tel, "enabled", False):
            return None
        tracer = getattr(tel, "tracer", None)
        flightrec = getattr(tel, "flightrec", None)
        traced = bool(getattr(tracer, "enabled", False))
        flight = bool(getattr(flightrec, "enabled", False))
        if not (traced or flight):
            return None
        import pathlib

        from deepspeed_tpu_torch.serving.observability import ObservabilitySpool
        out = pathlib.Path(getattr(tel.config, "output_path", None)
                           or "telemetry")
        spool = ObservabilitySpool(
            path=out / f"{tel.subsystem}.obs.spool.jsonl",
            capacity=capacity, telemetry=tel)
        if traced:
            tracer.on_record = spool.span_hook
        if flight:
            flightrec.on_record = spool.flight_hook
        return spool

    def _observability_pull(self, p):
        """Idempotent, cursor-based pull of spooled spans/flight events plus
        the current registry snapshot. Items are never consumed by a pull
        (only by ring overflow), so a retried pull at the same cursor
        returns identical data and can never double-count."""
        if self.spool is None:
            return {"enabled": False}
        out = self.spool.pull(p.get("cursor", 0))
        return {"enabled": True,
                "cursor": out["cursor"],
                "items": out["items"],
                "dropped": out["dropped"],
                "spool_path": self.spool.path,
                "pid": os.getpid(),
                "metrics": self.telemetry.registry.snapshot()}

    def verb_table(self):
        h = self.handle
        return {
            "ping": lambda p: True,
            "submit": self._submit,
            "step": lambda p: h.step(),
            "cancel": lambda p: h.cancel(p["uid"],
                                         queued_only=p.get("queued_only",
                                                           False)),
            "drain_queued": lambda p: h.drain_queued(),
            "check_admissible": lambda p: h.check_admissible(
                p["prompt_len"], p["max_new"],
                prefill_only=p.get("prefill_only", False),
                uid=p.get("uid", "?"),
                padded_prompt=p.get("padded_prompt")),
            "signals": lambda p: {
                "queue_depth": h.queue_depth,
                "num_active": h.num_active,
                "available_blocks": h.available_blocks,
                "has_free_slot": h.has_free_slot,
                "prefill_chunk": h.prefill_chunk,
                "progress": h.progress(),
            },
            "affinity": lambda p: h.affinity(
                [bytes(x) for x in p["hashes"]]),
            "hash_chain": lambda p: h.hash_chain(p["prompt"]),
            "has_output": lambda p: h.has_output(p["uid"]),
            "audit_state": lambda p: h.audit_state(),
            "memory_snapshot": lambda p: h.memory_snapshot(),
            "stats": self._stats,
            "compile_stats": lambda p: h.compile_stats(),
            "compat": lambda p: h.compat_descriptor(),
            "observability_pull": self._observability_pull,
            "shutdown": lambda p: True,   # RpcServer stops after the reply
        }

    def _stats(self, p):
        """The engine's stats plus the device it runs on and this
        process's kernel launch counts since it started (`op_builder.
        LAUNCHES`): a fabric check that every child runs on the card it
        was meant for, through the kernels."""
        import torch
        from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
        dev = torch.device(getattr(self.handle.engine.engine, "device",
                                   "cpu"))
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
            else "cpu"
        return {**self.handle.stats(),
                "device": {"type": dev.type, "name": name},
                "launches": dict(LAUNCHES)}

    def _submit(self, p):
        deadline_at = None
        if p.get("deadline_in_s") is not None:
            # remaining budget -> absolute on THIS process's clock
            deadline_at = self._clock() + float(p["deadline_in_s"])
        hashes = p.get("hashes")
        if hashes is not None:
            hashes = [bytes(x) for x in hashes]
        self.handle.submit(p["request"],
                           prefill_only=p.get("prefill_only", False),
                           hashes=hashes, deadline_at=deadline_at)
        return None

    def serve(self, ready_file=None):
        if ready_file is not None:
            tmp = ready_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(f"{self.server.host} {self.server.port}\n")
            os.replace(tmp, ready_file)   # atomic: never read half-written
        try:
            self.server.serve_forever()
        finally:
            try:
                self.handle.close()       # final audit + telemetry flush
            except Exception:
                pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="replica_server",
        description="serve one engine replica over the fabric wire")
    ap.add_argument("--factory", required=True,
                    help="module:function returning a ServingEngine")
    ap.add_argument("--kwargs", default="{}",
                    help="JSON kwargs for the factory")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral (read the bound port from the "
                         "ready-file)")
    ap.add_argument("--heartbeat-interval", type=float, default=0.5)
    ap.add_argument("--ready-file", default=None,
                    help="write 'host port' here once serving")
    ap.add_argument("--spool-capacity", type=int, default=1024,
                    help="observability spool ring size (spans + flight "
                         "events retained for the router to pull)")
    args = ap.parse_args(argv)

    factory = load_factory(args.factory)
    engine = factory(**json.loads(args.kwargs))
    app = ReplicaServerApp(engine, host=args.host, port=args.port,
                           heartbeat_interval_s=args.heartbeat_interval,
                           spool_capacity=args.spool_capacity)
    print(f"replica_server: serving on {app.server.host}:{app.server.port} "
          f"(pid {os.getpid()})", file=sys.stderr, flush=True)
    app.serve(ready_file=args.ready_file)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
