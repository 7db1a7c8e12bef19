"""Elastic pool autoscaler: spawn under pressure, drain gracefully when idle
(counterpart of `deepspeed_tpu/serving/autoscaler.py`).

The controller is deliberately dumb-simple — a sustain/cooldown hysteresis
loop over signals the stack ALREADY exports, so there is nothing new to
instrument and nothing to tune twice:

  * router queue depth per live replica (the primary pressure signal);
  * `mem/pool_headroom_frac` from the router's aggregated memscope
    snapshot (a pool near OOM scales OUT, not up — more replicas, each
    with its own HBM budget);
  * `serving/degradation_level` from replica stats (the pressure
    ladder): replicas already shedding quality is late-stage pressure.

Scale-up path: `spawn()` (user-supplied: returns a fresh `ReplicaHandle` —
an `InProcessReplica` in tests, a `RemoteReplica` around a spawned process
in production) → prefix-cache **warmup** (replay the router's hottest
prompt prefixes through the new replica so it joins with affinity instead
of stealing cold-prefill latency from live traffic) → `router.add_replica`,
which gates the join through `_check_pool_compat` — a divergent replica is
refused at join time, never at first transplant.

Scale-down path: pick the least-loaded replica above `min_replicas`,
`router.drain_replica` it (admission stops, queued work re-queues at the
router, active slots run to completion), then poll `router.replica_idle`
and reap via `router.remove_replica` (which closes the handle — engine
close in-process, shutdown RPC + process reap remotely). A drain in flight
blocks further scale decisions: one pool mutation at a time.

Every decision lands in `fabric/*` telemetry counters and the flight
recorder, so a scaling flap is diagnosable from the black box alone.
"""

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

from deepspeed_tpu_torch.serving.replica import ReplicaUnavailableError
from deepspeed_tpu_torch.serving.router import ServingRouter
from deepspeed_tpu_torch.utils.logging import log_dist, logger


@dataclasses.dataclass
class AutoscalerConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    # -- scale-up triggers (any one fires) -------------------------------
    scale_up_queue_per_replica: float = 4.0   # router queue depth / live
    scale_up_headroom_frac: float = 0.08      # pool headroom below this
    scale_up_degradation_level: int = 2       # any replica at/above this
    # -- scale-down trigger (all must hold) ------------------------------
    scale_down_queue_per_replica: float = 0.5
    scale_down_idle_active: int = 0           # max total active slots that
                                              # still counts as "idle"
    # -- hysteresis ------------------------------------------------------
    sustain_up: int = 2        # consecutive pressured ticks before spawn
    sustain_down: int = 8      # consecutive idle ticks before drain
    cooldown_ticks: int = 8    # ticks after any action before the next
    # -- join warmup -----------------------------------------------------
    warmup_prompts: int = 2    # hottest shared prefixes replayed through a
                               # joining replica (0 disables)


class Autoscaler:
    """Drive with one `tick()` per router step (or per poll interval):

        scaler = Autoscaler(router, spawn=lambda i: make_replica(i))
        while serving:
            router.step()
            scaler.tick()

    `spawn(index)` returns a ready `ReplicaHandle`; `clock` is injectable
    (tests drive hysteresis deterministically). Warmup prompts are sampled
    from the router's hottest observed prefixes — callers can also seed
    `note_prompt()` with representative traffic."""

    def __init__(self, router: ServingRouter, spawn: Callable[[int], Any],
                 config: AutoscalerConfig = None,
                 clock: Callable[[], float] = None, **overrides):
        if config is None:
            config = AutoscalerConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        if config.min_replicas < 1:
            raise ValueError("a pool needs at least one replica")
        if config.max_replicas < config.min_replicas:
            raise ValueError(f"max_replicas {config.max_replicas} < "
                             f"min_replicas {config.min_replicas}")
        self.router = router
        self.config = config
        self.spawn = spawn
        self._clock = clock if clock is not None else time.monotonic
        self.ticks = 0
        self._pressured = 0          # consecutive pressured ticks
        self._idle = 0               # consecutive idle ticks
        self._cooldown = 0           # ticks until the next action allowed
        self._spawned = 0            # monotone spawn index
        self._draining_rid: Optional[str] = None
        self._warmup_pool: List[Any] = []   # recent prompts for join warmup
        self._warmup_cap = 8
        self.counters = {k: 0 for k in (
            "scale_up", "scale_down", "joins", "join_refused", "reaps",
            "warmup_prompts")}

    # ------------------------------------------------------------------
    # signals
    # ------------------------------------------------------------------

    def note_prompt(self, tokens):
        """Remember a representative prompt for join warmup (bounded ring;
        callers feed real traffic, tests feed the shared prefix)."""
        self._warmup_pool.append(tokens)
        if len(self._warmup_pool) > self._warmup_cap:
            self._warmup_pool.pop(0)

    def signals(self) -> Dict[str, Any]:
        r = self.router
        live = r._healthy()
        n = max(1, len(live))
        queue_per = len(r.queue) / n
        active = 0
        degradation = 0
        for rep in live:
            try:
                active += rep.num_active
                lvl = rep.stats().get("degradation", {}).get("level", 0)
                degradation = max(degradation, int(lvl))
            except Exception:
                continue    # a dying replica is the router's problem
        mem = {}
        try:
            mem = r.memory_snapshot()
        except Exception:
            pass
        return {"live": len(live), "queue_depth": len(r.queue),
                "queue_per_replica": queue_per, "active": active,
                "headroom_frac": mem.get("headroom_frac"),
                "degradation_level": degradation,
                "draining": self._draining_rid}

    def _pressure(self, sig) -> Optional[str]:
        cfg = self.config
        if sig["queue_per_replica"] >= cfg.scale_up_queue_per_replica:
            return f"queue_per_replica={sig['queue_per_replica']:.1f}"
        hr = sig["headroom_frac"]
        if hr is not None and hr < cfg.scale_up_headroom_frac:
            return f"headroom_frac={hr:.3f}"
        if sig["degradation_level"] >= cfg.scale_up_degradation_level:
            return f"degradation_level={sig['degradation_level']}"
        return None

    def _is_idle(self, sig) -> bool:
        cfg = self.config
        return (sig["queue_per_replica"] <= cfg.scale_down_queue_per_replica
                and sig["active"] <= cfg.scale_down_idle_active)

    # ------------------------------------------------------------------
    # the control loop
    # ------------------------------------------------------------------

    def tick(self) -> Optional[str]:
        """One control decision. Returns "scale_up", "scale_down", "reap",
        or None (no action)."""
        self.ticks += 1
        tel = self.router.telemetry
        # finish an in-flight drain before anything else
        if self._draining_rid is not None:
            rid = self._draining_rid
            if rid not in self.router.replicas:
                self._draining_rid = None       # quarantined+removed under us
            elif self.router.replica_idle(rid):
                self.router.remove_replica(rid)
                self._draining_rid = None
                self._count("reaps")
                if self.router.flightrec.enabled:
                    self.router.flightrec.record(
                        "reap", replica=rid,
                        pool=len(self.router.replicas))
                self._gauge_pool(tel)
                return "reap"
            else:
                return None                     # still finishing its slots
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        sig = self.signals()
        why = self._pressure(sig)
        if why is not None:
            self._pressured += 1
            self._idle = 0
        elif self._is_idle(sig):
            self._idle += 1
            self._pressured = 0
        else:
            self._pressured = self._idle = 0
        cfg = self.config
        if (why is not None and self._pressured >= cfg.sustain_up
                and sig["live"] < cfg.max_replicas):
            return self._scale_up(sig, why, tel)
        if (self._idle >= cfg.sustain_down
                and sig["live"] > cfg.min_replicas):
            return self._scale_down(sig, tel)
        return None

    def _scale_up(self, sig, why, tel):
        idx = self._spawned
        self._spawned += 1
        try:
            handle = self.spawn(idx)
        except Exception as e:
            logger.warning(f"autoscaler: spawn #{idx} failed: {e}")
            self._after_action(tel)
            return None
        warmed = self._warmup(handle)
        try:
            self.router.add_replica(handle)
        except ValueError as e:
            # _check_pool_compat refused the join — an incompatible spawn
            # recipe is a config bug; count it, close the orphan, carry on
            self._count("join_refused")
            logger.error(f"autoscaler: join refused for spawn #{idx}: {e}")
            if self.router.flightrec.enabled:
                self.router.flightrec.record(
                    "join_refused", replica=getattr(handle, "replica_id", "?"),
                    reason=str(e), pool=len(self.router.replicas))
            try:
                handle.close()
            except Exception:
                pass
            self._after_action(tel)
            return None
        self._count("scale_up")
        self._count("joins")
        if warmed:
            self._count("warmup_prompts", warmed)
        log_dist(f"autoscaler: +replica {handle.replica_id} ({why}, "
                 f"warmed {warmed} prompts, pool="
                 f"{len(self.router.replicas)})", ranks=[0])
        if self.router.flightrec.enabled:
            self.router.flightrec.record(
                "scale_up", replica=handle.replica_id, reason=why,
                warmed=warmed, pool=len(self.router.replicas))
        self._after_action(tel)
        return "scale_up"

    def _warmup(self, handle) -> int:
        """Replay remembered prompts through the joining replica BEFORE it
        takes traffic: its prefix cache registers the hot prefixes, so its
        first routed requests hit warm blocks (affinity > 0) instead of
        paying cold prefill. Runs directly on the handle — the replica is
        not in the pool yet, so live traffic never waits on warmup."""
        n = 0
        from deepspeed_tpu_torch.inference.scheduler import Request
        for i, tokens in enumerate(self._warmup_pool[:self.config
                                                     .warmup_prompts]):
            try:
                handle.submit(Request(uid=f"__warmup_{self._spawned}_{i}",
                                      tokens=tokens, max_new_tokens=1,
                                      stop_on_eos=False))
                while handle.num_active or handle.queue_depth:
                    handle.step()
                n += 1
            except Exception as e:
                logger.warning(f"autoscaler: warmup prompt {i} failed: {e}")
                break
        return n

    def _scale_down(self, sig, tel):
        victim = self._pick_victim()
        if victim is None:
            return None
        self.router.drain_replica(victim)
        self._draining_rid = victim
        self._count("scale_down")
        if self.router.flightrec.enabled:
            self.router.flightrec.record(
                "scale_down", replica=victim,
                pool=len(self.router.replicas))
        log_dist(f"autoscaler: draining {victim} "
                 f"(queue_per={sig['queue_per_replica']:.2f})", ranks=[0])
        self._after_action(tel)
        return "scale_down"

    def _pick_victim(self) -> Optional[str]:
        """Least-loaded live replica (prefer zero active slots — its drain
        reaps immediately)."""
        best, best_key = None, None
        for rep in self.router._healthy():
            try:
                key = (rep.num_active, rep.queue_depth)
            except ReplicaUnavailableError:
                continue
            if best_key is None or key < best_key:
                best, best_key = rep.replica_id, key
        return best

    def _after_action(self, tel):
        self._cooldown = self.config.cooldown_ticks
        self._pressured = self._idle = 0
        self._gauge_pool(tel)

    def _count(self, name, n=1):
        self.counters[name] += n
        self.router.telemetry.inc(f"fabric/{name}", n)

    def _gauge_pool(self, tel):
        tel.set_gauge("fabric/pool_size", len(self.router.replicas))

    def stats(self) -> Dict[str, Any]:
        return {"ticks": self.ticks, "counters": dict(self.counters),
                "cooldown": self._cooldown, "draining": self._draining_rid,
                "pool_size": len(self.router.replicas)}
