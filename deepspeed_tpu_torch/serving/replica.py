"""Replica handles: the protocol the serving router drives (counterpart of
`deepspeed_tpu/serving/replica.py`).

The router never touches a `ServingEngine` directly — it speaks this small
surface, so an in-process pool (N engines in one process, sharing one
card) and a process-separated one (`remote_replica.py`) are driven by the
same routing logic. Everything the router needs is here: submit/step/
cancel, queue extraction for failover, the read-only affinity probe, load
signals (queue depth / active slots / available blocks — the quantities
the serving gauges export), and the prefill->decode handoff verbs.

`memory_snapshot()` is the engine's memscope ledger (`telemetry.memscope`),
or None without one. Divergence from the reference: `compile_stats()` is
`{}` (the port compiles no programs).
"""

from typing import Any, Dict, List, Optional

from deepspeed_tpu_torch.inference.scheduler import (CompletedRequest, Request,
                                                     ServingEngine)


class ReplicaUnavailableError(RuntimeError):
    """A replica could not be reached AT ALL — the process died, the wire
    broke, the call timed out. Distinct from a verb that ran and raised:
    the router treats this as "quarantine + reroute" at EVERY call site
    (probes, submit, properties), not just inside step(). Transport errors
    (serving/transport.py) subclass this."""


class ReplicaHandle:
    """Abstract replica surface. Implementations wrap one serving engine
    (or a remote proxy to one). `replica_id` must be unique in a pool;
    `role` is "mixed" (prefill+decode, the default), "prefill" or
    "decode" (disaggregated serving)."""

    replica_id: str = "?"
    role: str = "mixed"

    # -- request lifecycle ------------------------------------------------
    def submit(self, request: Request, prefill_only: bool = False,
               hashes=None, trace=None, deadline_at=None):
        raise NotImplementedError

    def step(self) -> List[CompletedRequest]:
        raise NotImplementedError

    # -- observability ----------------------------------------------------
    def attach_observability(self, tracer=None, flightrec=None, tid=None):
        """Share the router's request tracer / flight recorder with this
        replica (and hand it its Perfetto track id), so a pool's spans land
        in ONE trace file and one black box. Default no-op: a remote
        backend records on its own side and ships spans home out of band."""

    def set_clock(self, clock):
        """Unified clock injection: the router hands every replica ITS
        clock so TTL checks, engine TTFT/TPOT stamps, hard deadlines, and
        the watchdog/hedging timers all read one time source — chaos tests
        drive the whole pool's time deterministically through it. Default
        no-op: a remote backend keeps its own wall clock and the router's
        absolute deadlines are re-anchored at its boundary."""

    def cancel(self, uid, queued_only: bool = False) -> Optional[CompletedRequest]:
        raise NotImplementedError

    def drain_queued(self) -> List[Request]:
        raise NotImplementedError

    # -- routing signals --------------------------------------------------
    def check_admissible(self, prompt_len: int, max_new: int,
                         prefill_only: bool = False, uid: Any = "?",
                         padded_prompt: int = None) -> int:
        raise NotImplementedError

    def progress(self) -> int:
        """Monotone work counter (tokens + chunks + adoptions): the router's
        cheap liveness probe — must not build a full stats()/telemetry
        snapshot."""
        raise NotImplementedError

    @property
    def prefill_chunk(self) -> int:
        raise NotImplementedError

    def affinity(self, hashes) -> int:
        raise NotImplementedError

    def hash_chain(self, prompt) -> Optional[List[bytes]]:
        raise NotImplementedError

    @property
    def queue_depth(self) -> int:
        raise NotImplementedError

    @property
    def num_active(self) -> int:
        raise NotImplementedError

    @property
    def available_blocks(self) -> int:
        raise NotImplementedError

    @property
    def has_free_slot(self) -> bool:
        raise NotImplementedError

    # -- disaggregated handoff -------------------------------------------
    def handoff_ready(self) -> List[Any]:
        raise NotImplementedError

    def export_handoff(self, uid) -> Dict[str, Any]:
        raise NotImplementedError

    def receive_handoff(self, state: Dict[str, Any], src_pool) -> bool:
        raise NotImplementedError

    def release_handoff(self, uid):
        raise NotImplementedError

    # -- health -----------------------------------------------------------
    def restart(self):
        raise NotImplementedError

    @property
    def can_restart(self) -> bool:
        raise NotImplementedError

    def health_probe(self) -> bool:
        """The hung-replica watchdog's liveness check, asked only after a
        replica exhausts its slow-step strike budget: True = slow but
        alive (strikes reset), False = presumed hung (quarantined through
        the same failover path a crash takes). Default True — an
        in-process replica that returned from step() at all is alive; a
        remote backend overrides this with a real ping."""
        return True

    def has_output(self, uid) -> bool:
        """True once `uid` has emitted its first token on this replica —
        the hedging probe: a dispatched request still silent past
        `hedge_after_ms` earns a speculative duplicate elsewhere. Default
        True (= never hedge) so a backend that cannot answer cheaply is
        never double-dispatched by mistake."""
        return True

    def audit(self, repair: bool = False):
        """Run the KV-pool invariant auditor (inference/audit.py) on this
        replica's pool now; returns the `AuditReport` (pre-repair) or None
        for a backend with no in-process pool to audit (a remote replica
        audits on its own side at its scheduled interval)."""
        return None

    def observability_pull(self, cursor: int = 0) -> Optional[Dict[str, Any]]:
        """Pull this replica's observability state for pool aggregation:
        `{"enabled", "cursor", "items", "dropped", "metrics", ...}` —
        spooled spans/flight events after `cursor` plus the current
        registry snapshot (see serving/observability.py for the cursor
        contract). None means "no plane here" (the default): the router
        skips this replica when merging. An in-process replica has no
        spool (its spans already land in the router's own tracer) but
        does expose its registry for merged pool percentiles."""
        return None

    def audit_state(self) -> Optional[Dict[str, Any]]:
        """Portable JSON snapshot of the pool bookkeeping (what
        `audit.audit_main` reads), or None for a remote backend."""
        return None

    def memory_snapshot(self) -> Optional[Dict[str, Any]]:
        """The replica's device-memory ledger (telemetry/memscope.py
        snapshot), or None when the engine runs without
        `telemetry.memscope` — the router aggregates these into pool-level
        `mem/*` gauges."""
        return None

    def compat_descriptor(self) -> Optional[Dict[str, Any]]:
        """Portable pool-compatibility fingerprint: model cache fingerprint,
        kv block size, serving-effective kv dtype and int8 scale group —
        everything `_check_pool_compat` must agree on before blocks can
        move between pools. JSON-safe so a remote replica can ship it over
        the wire; None means "unknown" and the join-time gate skips this
        replica (handoff into it will still fail loudly)."""
        return None

    def close(self):
        """Release the replica's resources (final audit + telemetry close
        for a local engine; shutdown RPC + process reap for a remote one).
        Default no-op. Idempotent."""

    def stats(self) -> Dict[str, Any]:
        raise NotImplementedError

    def compile_stats(self) -> Dict[str, int]:
        raise NotImplementedError


class InProcessReplica(ReplicaHandle):
    """A `ServingEngine` living in this process.

    `engine` is the live engine; `factory` (optional, a zero-arg callable
    returning a fresh `ServingEngine`) is what `restart()` uses to rebuild
    after a quarantine — without one, a failed replica stays dead and the
    pool shrinks (the router's restart budget then never fires for it). A
    rebuilt engine starts with a cold pool and prefix cache; affinity
    re-warms organically.
    """

    def __init__(self, engine: ServingEngine = None, factory=None,
                 replica_id: str = "r0", role: str = "mixed"):
        assert role in ("mixed", "prefill", "decode"), \
            f"unknown replica role {role!r}"
        if engine is None:
            if factory is None:
                raise ValueError("InProcessReplica needs an engine or a factory")
            engine = factory()
        self.engine = engine
        self._factory = factory
        self.replica_id = str(replica_id)
        self.role = role

    # -- request lifecycle ------------------------------------------------
    def submit(self, request, prefill_only=False, hashes=None, trace=None,
               deadline_at=None):
        self.engine.submit(request, prefill_only=prefill_only, hashes=hashes,
                           trace=trace, deadline_at=deadline_at)

    def step(self):
        return self.engine.step()

    # -- observability ----------------------------------------------------
    def attach_observability(self, tracer=None, flightrec=None, tid=None):
        self.engine.attach_observability(tracer=tracer, flightrec=flightrec,
                                         tid=tid)

    def set_clock(self, clock):
        self.engine.set_clock(clock)

    def memory_snapshot(self):
        ms = getattr(self.engine, "memscope", None)
        return ms.snapshot() if ms is not None else None

    def observability_pull(self, cursor=0):
        # no spool: an in-process engine's spans/flight events already land
        # in the router's attached tracer/recorder. What pool aggregation
        # needs from here is the registry (per-engine TTFT/TPOT histograms
        # for the exact bucket-wise merge).
        tel = getattr(self.engine, "telemetry", None)
        if tel is None or not getattr(tel, "enabled", False):
            return None
        return {"enabled": True, "cursor": int(cursor), "items": [],
                "dropped": 0, "metrics": tel.registry.snapshot()}

    def cancel(self, uid, queued_only=False):
        return self.engine.cancel(uid, queued_only=queued_only)

    def drain_queued(self):
        return self.engine.drain_queued()

    # -- routing signals --------------------------------------------------
    def check_admissible(self, prompt_len, max_new, prefill_only=False,
                         uid="?", padded_prompt=None):
        return self.engine.check_admissible(prompt_len, max_new,
                                            prefill_only=prefill_only,
                                            uid=uid,
                                            padded_prompt=padded_prompt)

    def progress(self):
        e = self.engine
        return e.tokens_generated + e.prefill_chunks + e.handoffs_in

    @property
    def prefill_chunk(self):
        return self.engine.chunk

    def affinity(self, hashes):
        return self.engine.prefix_affinity(hashes)

    def hash_chain(self, prompt):
        return self.engine.hash_chain(prompt)

    @property
    def queue_depth(self):
        return self.engine.queue_depth

    @property
    def num_active(self):
        return self.engine.num_active

    @property
    def available_blocks(self):
        return self.engine.allocator.available

    @property
    def has_free_slot(self):
        return self.engine.has_free_slot

    # -- disaggregated handoff -------------------------------------------
    def handoff_ready(self):
        return self.engine.handoff_ready()

    def export_handoff(self, uid):
        return self.engine.export_handoff(uid)

    def receive_handoff(self, state, src_pool):
        return self.engine.adopt_handoff(state, src_pool)

    def release_handoff(self, uid):
        self.engine.release_handoff(uid)

    @property
    def pool(self):
        """The engine's paged KV pool — the handoff source buffer."""
        return self.engine.pool

    # -- health -----------------------------------------------------------
    def restart(self):
        if self._factory is None:
            raise RuntimeError(
                f"replica {self.replica_id}: no factory to rebuild from")
        self.engine = self._factory()

    @property
    def can_restart(self):
        return self._factory is not None

    def health_probe(self):
        # answering a host-side attribute read is all "alive" means for an
        # in-process engine; a wedged backend surfaces as an exception here
        try:
            return self.engine.num_active >= 0
        except Exception:
            return False

    def has_output(self, uid):
        return self.engine.has_output(uid)

    def audit(self, repair=False):
        return self.engine.audit(repair=repair)

    def audit_state(self):
        return self.engine.audit_state()

    def compat_descriptor(self):
        e = self.engine
        spec = e.engine.model_spec
        return {
            "fingerprint": spec.cache_fingerprint or spec.name,
            "kv_block_size": int(e.block_size),
            "kv_cache_dtype": str(getattr(e, "kv_cache_dtype",
                                          e.config.kv_cache_dtype)),
            "kv_group_size": int(getattr(e, "kv_group_size", 0)),
        }

    def close(self):
        self.engine.close()

    def stats(self):
        return self.engine.stats()

    def compile_stats(self):
        return self.engine.compile_stats()
