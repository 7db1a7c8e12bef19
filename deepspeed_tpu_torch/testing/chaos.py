"""Chaos harness for the self-healing serving pool (counterpart of
`deepspeed_tpu/testing/chaos.py`: the same schedules from the same seeds).

The self-healing layer (PoolAuditor, the hung-replica watchdog, hard
deadlines + hedged dispatch, the degradation ladder) defends against
failures that never raise: replicas that hang instead of crash, host-side
pool bookkeeping that drifts one refcount at a time, steps that silently
slow down. None of those appear in a normal test run, so this module
manufactures them — deterministically, so a soak failure replays
bit-for-bit from its seed:

  * `ChaosClock` — a manually-driven monotonic clock injected into the
    router (which fans it out to every replica via `set_clock`), so step
    delays, deadlines, TTLs, watchdog strikes and hedge timers are all
    driven by the schedule, not by wall time;
  * `corrupt_pool(engine, kind, rng)` — reach into a live engine's
    allocator / prefix-cache bookkeeping and break ONE invariant the
    auditor checks (leak, refcount drift, double-reference, free-list
    duplicate, stale hash entry);
  * `ChaosReplica` — a transparent `ReplicaHandle` wrapper whose `step()`
    fires a `ChaosSchedule` of injections keyed by step count: clock
    delays (slow steps the watchdog must tolerate), hangs (no progress +
    failing health probe — the watchdog must quarantine), crashes
    (exception out of step() — the failover path), and pool
    corruptions (the scheduled audit must catch + repair);
  * `ChaosSchedule.seeded(...)` — a reproducible random schedule over
    those event kinds for the soak test.

Corruption kinds are split into SAFE and UNSAFE sets. Safe kinds (leak,
refcount over-count, stale hash) degrade capacity or bookkeeping but can
never make the engine emit wrong tokens before the next scheduled audit
repairs them — they are what the soak test injects while asserting greedy
parity. Unsafe kinds (refcount under-count, double-reference, free-list
duplicate) can hand one physical block to two writers if the engine keeps
admitting before an audit runs; unit tests inject them quiesced, audit,
and assert the repair — the offline forensics workflow `audit.audit_main`
supports.
"""

import dataclasses
import os
import signal
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepspeed_tpu_torch.serving.replica import ReplicaHandle

__all__ = ["ChaosClock", "ChaosInjected", "ChaosReplica", "ChaosSchedule",
           "CORRUPTION_KINDS", "SAFE_CORRUPTIONS", "corrupt_pool",
           "kill_replica_process"]


def kill_replica_process(handle, sig: int = signal.SIGKILL) -> int:
    """The PROCESS-level chaos fault: deliver `sig` (default `kill -9`) to
    a `RemoteReplica`'s OS process and return the pid. This is the real
    thing the in-process `crash` event simulates — the multi-process soak
    uses it to prove the heartbeat/quarantine/respawn path against an
    actual dead process. SIGSTOP makes a hung-not-dead replica (heartbeats
    stop, process survives) — the detection-latency arm of the fabric
    bench."""
    proc = getattr(handle, "process", None)
    if proc is None or proc.pid is None:
        raise ValueError(f"handle {handle!r} has no OS process to kill")
    os.kill(proc.pid, sig)
    return proc.pid


class ChaosInjected(RuntimeError):
    """The simulated replica crash raised out of `ChaosReplica.step()`."""


class ChaosClock:
    """Deterministic injectable monotonic clock.

    `now` only moves when the harness moves it: `advance(dt)` explicitly,
    or `tick` seconds automatically per reading (so code that measures a
    duration by calling the clock twice sees time pass). Inject one
    instance into `ServingRouter(clock=...)` and the router propagates it
    to every replica — TTL, deadlines, TTFT/TPOT stamps, watchdog and
    hedge timers then share this single schedule-driven time source.
    """

    def __init__(self, start: float = 0.0, tick: float = 0.0):
        self.now = float(start)
        self.tick = float(tick)

    def __call__(self) -> float:
        t = self.now
        self.now += self.tick
        return t

    def advance(self, dt: float) -> float:
        self.now += float(dt)
        return self.now


# ----------------------------------------------------------------------
# pool corruption — break exactly one audited invariant
# ----------------------------------------------------------------------

# kinds that cannot produce wrong tokens before the next audit repairs them
SAFE_CORRUPTIONS = ("leak", "refcount_over", "stale_hash")
# kinds that can alias one block to two writers if admission keeps running
UNSAFE_CORRUPTIONS = ("refcount_under", "double_ref", "free_dup")
CORRUPTION_KINDS = SAFE_CORRUPTIONS + UNSAFE_CORRUPTIONS


def corrupt_pool(engine, kind: str, rng: np.random.Generator
                 ) -> Optional[Dict[str, Any]]:
    """Inject one bookkeeping corruption into a live `ServingEngine`'s
    pool. Returns a description of what was broken (for assertions), or
    None when the pool has no state the kind applies to right now (e.g.
    no refcounted blocks yet) — the caller treats that as a no-op.

      leak            drop a block from the free list (and shadow set):
                      it is now neither free nor tracked (audit I5)
      refcount_over   +1 a live block's refcount: a retire will leave it
                      pinned forever (audit I2)
      refcount_under  -1 a shared block's refcount: its KV can be freed
                      under a live reader (audit I2)
      double_ref      push a slot-referenced block onto the free list:
                      the next alloc hands it to a second writer (audit I1)
      free_dup        duplicate a free-list entry (list only, not the
                      shadow set): one block, two future owners (audit I1
                      structure + shadow-set drift)
      stale_hash      register a fabricated hash -> block entry with no
                      reverse mapping (audit I3)
    """
    alloc = engine.allocator
    if kind == "leak":
        if not alloc._free:
            return None
        b = alloc._free.pop(int(rng.integers(len(alloc._free))))
        alloc._free_set.discard(b)
        return {"kind": kind, "block": b}
    if kind in ("refcount_over", "refcount_under"):
        live = sorted(b for b, c in alloc._refs.items() if c >= 1)
        if not live:
            return None
        b = live[int(rng.integers(len(live)))]
        alloc._refs[b] += 1 if kind == "refcount_over" else -1
        return {"kind": kind, "block": b}
    if kind == "double_ref":
        live = sorted(b for b, c in alloc._refs.items() if c >= 1)
        if not live:
            return None
        b = live[int(rng.integers(len(live)))]
        alloc._free.append(b)
        alloc._free_set.add(b)
        return {"kind": kind, "block": b}
    if kind == "free_dup":
        if not alloc._free:
            return None
        b = alloc._free[int(rng.integers(len(alloc._free)))]
        alloc._free.append(b)
        return {"kind": kind, "block": b}
    if kind == "stale_hash":
        if engine.prefix_cache is None:
            return None
        # a fabricated digest that can never match a real chained hash —
        # deterministic from the rng, no os.urandom
        fake = bytes(rng.integers(0, 256, (32,), dtype=np.uint8))
        b = int(rng.integers(1, alloc.num_blocks))
        engine.prefix_cache._by_hash[fake] = b
        return {"kind": kind, "block": b, "hash": fake.hex()}
    raise ValueError(f"unknown corruption kind {kind!r} "
                     f"(expected one of {CORRUPTION_KINDS})")


# ----------------------------------------------------------------------
# the schedule + the wrapper replica
# ----------------------------------------------------------------------


@dataclasses.dataclass
class ChaosEvent:
    step: int        # ChaosReplica step() count at which the event fires
    kind: str        # "delay" | "hang" | "crash" | "corrupt"
    arg: Any = None  # delay: seconds · corrupt: corruption kind ·
                     # hang: seconds the fake stuck step appears to take


class ChaosSchedule:
    """An ordered set of `ChaosEvent`s for ONE replica, keyed by that
    replica's step count. Build explicitly for unit tests, or with
    `seeded()` for the soak — either way the schedule is a plain list the
    failing run prints, so any soak failure is replayable."""

    def __init__(self, events: Sequence[ChaosEvent] = ()):
        self.events: Dict[int, List[ChaosEvent]] = {}
        for ev in events:
            self.events.setdefault(int(ev.step), []).append(ev)

    @classmethod
    def seeded(cls, seed: int, steps: int, delay_rate: float = 0.0,
               delay_s: float = 0.0, corrupt_rate: float = 0.0,
               corruptions: Sequence[str] = SAFE_CORRUPTIONS,
               crash_at: Sequence[int] = (), hang_at: Optional[int] = None,
               hang_s: float = 0.0) -> "ChaosSchedule":
        """Deterministic random schedule over `steps` replica steps:
        per-step Bernoulli delays and corruptions (kinds drawn from
        `corruptions`), plus explicit crash steps and at most one hang."""
        rng = np.random.default_rng(seed)
        events: List[ChaosEvent] = []
        for s in range(steps):
            if delay_rate and rng.random() < delay_rate:
                events.append(ChaosEvent(s, "delay", delay_s))
            if corrupt_rate and rng.random() < corrupt_rate:
                kind = corruptions[int(rng.integers(len(corruptions)))]
                events.append(ChaosEvent(s, "corrupt", kind))
        events.extend(ChaosEvent(int(s), "crash") for s in crash_at)
        if hang_at is not None:
            events.append(ChaosEvent(int(hang_at), "hang", hang_s))
        return cls(events)

    def at(self, step: int) -> List[ChaosEvent]:
        return self.events.get(step, [])

    def __repr__(self):
        flat = [ev for evs in sorted(self.events.items())
                for ev in evs[1]]
        return f"ChaosSchedule({flat!r})"


class ChaosReplica(ReplicaHandle):
    """Transparent `ReplicaHandle` wrapper that fires a `ChaosSchedule`.

    Every protocol verb forwards to the wrapped handle (an
    `InProcessReplica`, normally), so the router cannot tell the
    difference — which is the point: every recovery path is exercised
    through the exact interfaces production uses.

    Event semantics, applied at the step count where they fire:

      delay    advance the injected clock by `arg` seconds BEFORE the real
               step runs — the router's watchdog sees one slow step() that
               still made progress (a strike that must NOT kill a replica
               whose health probe answers);
      hang     permanent until `restart()`: step() advances the clock by
               `arg` and returns NO completions, the health probe answers
               False — the watchdog must converge this onto the
               quarantine/reroute path a crash takes;
      crash    raise `ChaosInjected` out of step() — the failover
               path, for calibrating that hangs and crashes land in the
               same place;
      corrupt  run `corrupt_pool(engine, arg, rng)` AFTER the real step
               returns, so the injected damage sits in the bookkeeping
               until the engine's own scheduled audit catches it.

    The corruption rng is seeded per-replica (`seed`), so block choices
    inside events replay too.
    """

    def __init__(self, inner, schedule: ChaosSchedule,
                 clock: Optional[ChaosClock] = None, seed: int = 0):
        self._inner = inner
        self._schedule = schedule
        self._clock = clock
        self._rng = np.random.default_rng(seed)
        self._steps = 0
        self._hung = False
        self._hang_s = 0.0
        self.injected: List[Tuple[int, str, Any]] = []   # fired-event log
        self.replica_id = inner.replica_id
        self.role = inner.role

    # -- chaos-bearing surface -----------------------------------------

    def step(self):
        step = self._steps
        self._steps += 1
        if self._hung:
            # a hung backend: time passes, nothing returns
            if self._clock is not None and self._hang_s:
                self._clock.advance(self._hang_s)
            return []
        fired = self._schedule.at(step)
        for ev in fired:
            if ev.kind == "delay" and self._clock is not None:
                self._clock.advance(float(ev.arg or 0.0))
            elif ev.kind == "hang":
                self._hung = True
                self._hang_s = float(ev.arg or 0.0)
                self.injected.append((step, "hang", ev.arg))
                if self._clock is not None and self._hang_s:
                    self._clock.advance(self._hang_s)
                return []
            elif ev.kind == "crash":
                self.injected.append((step, "crash", None))
                raise ChaosInjected(
                    f"replica {self.replica_id}: injected crash at "
                    f"step {step}")
        out = self._inner.step()
        for ev in fired:
            if ev.kind == "delay":
                self.injected.append((step, "delay", ev.arg))
            elif ev.kind == "corrupt":
                done = corrupt_pool(self._inner.engine, str(ev.arg),
                                    self._rng)
                if done is not None:
                    self.injected.append((step, "corrupt", done))
        return out

    def health_probe(self):
        if self._hung:
            return False
        return self._inner.health_probe()

    def restart(self):
        self._inner.restart()
        self._hung = False
        self._hang_s = 0.0

    # -- everything else is the wrapped replica (the base class defines
    # the protocol with raising stubs, so each verb forwards explicitly;
    # __getattr__ backstops non-protocol attrs like `.engine`) ----------

    def submit(self, request, prefill_only=False, hashes=None, trace=None,
               deadline_at=None):
        self._inner.submit(request, prefill_only=prefill_only, hashes=hashes,
                           trace=trace, deadline_at=deadline_at)

    def attach_observability(self, tracer=None, flightrec=None, tid=None):
        self._inner.attach_observability(tracer=tracer, flightrec=flightrec,
                                         tid=tid)

    def set_clock(self, clock):
        self._inner.set_clock(clock)

    def cancel(self, uid, queued_only=False):
        return self._inner.cancel(uid, queued_only=queued_only)

    def drain_queued(self):
        return self._inner.drain_queued()

    def check_admissible(self, prompt_len, max_new, prefill_only=False,
                         uid="?", padded_prompt=None):
        return self._inner.check_admissible(prompt_len, max_new,
                                            prefill_only=prefill_only,
                                            uid=uid,
                                            padded_prompt=padded_prompt)

    def progress(self):
        return self._inner.progress()

    @property
    def prefill_chunk(self):
        return self._inner.prefill_chunk

    def affinity(self, hashes):
        return self._inner.affinity(hashes)

    def hash_chain(self, prompt):
        return self._inner.hash_chain(prompt)

    @property
    def queue_depth(self):
        return self._inner.queue_depth

    @property
    def num_active(self):
        return self._inner.num_active

    @property
    def available_blocks(self):
        return self._inner.available_blocks

    @property
    def has_free_slot(self):
        return self._inner.has_free_slot

    def handoff_ready(self):
        return self._inner.handoff_ready()

    def export_handoff(self, uid):
        return self._inner.export_handoff(uid)

    def receive_handoff(self, state, src_pool):
        return self._inner.receive_handoff(state, src_pool)

    def release_handoff(self, uid):
        return self._inner.release_handoff(uid)

    @property
    def can_restart(self):
        return self._inner.can_restart

    def has_output(self, uid):
        return self._inner.has_output(uid)

    def audit(self, repair=False):
        return self._inner.audit(repair=repair)

    def audit_state(self):
        return self._inner.audit_state()

    def stats(self):
        return self._inner.stats()

    def compile_stats(self):
        return self._inner.compile_stats()

    # base-class DEFAULTS (not raising stubs) — these must forward
    # explicitly too, or Python resolves them on ReplicaHandle and the
    # wrapped replica's real answer never surfaces

    def memory_snapshot(self):
        return self._inner.memory_snapshot()

    def compat_descriptor(self):
        return self._inner.compat_descriptor()

    def close(self):
        return self._inner.close()

    def __getattr__(self, name):
        return getattr(self._inner, name)
