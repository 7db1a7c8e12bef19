"""PressureController: the serving pool's graceful-degradation ladder
(counterpart of `deepspeed_tpu/serving/degradation.py`).

Under sustained overload the ladder sheds service on purpose, cheapest
reversible lever first, reading the free-block fraction, the engine's
queue depth, (with telemetry on) TTFT p99 from `latency_snapshot()` and
(optionally) the memory headroom:

  level 0  normal service
  level 1  cap the accepted draft length to 1 (the verify keeps its
           [S, k+1] shape; drafts past the cap land past the cursor)
  level 2  disable speculative decoding (the 1-step decode: blocks sized
           for the k-draft overhang make it the only safe fallback)
  level 3  force the 1-step decode window (blocks and slots turn over
           sooner)
  level 4  flush the reclaimable prefix-cache blocks to the free list
           (zeroes this replica's prefix-affinity pull and moves eviction
           work off the admission path)
  level 5  shed queued requests below `shed_below_priority`

One rung up per pressured evaluation; one rung down after `hold_steps`
consecutive calm evaluations (every signal under its low watermark). The
gap between the watermarks and the hold count keep the level from
flapping. With `headroom_low` > 0 and the memscope ledger on
(`telemetry.memscope`, a known capacity), the device-memory headroom
(`memscope.headroom_frac()`) is one more signal; without the ledger it is
left out, as in the JAX package.

Host-side control flow at scheduler-sync granularity only; with
`serving.degradation.enabled` false no controller is built.
"""

from typing import Dict, List, Optional

from deepspeed_tpu_torch.utils.logging import log_dist

__all__ = ["PressureController", "LEVEL_NAMES", "MAX_LEVEL"]

LEVEL_NAMES = ("normal", "cap_draft", "no_spec", "window_1",
               "flush_cache", "shed")
MAX_LEVEL = len(LEVEL_NAMES) - 1


class PressureController:
    """The ladder, bound to one `ServingEngine`.

    The scheduler calls `update(finished)` once per sync (after decode,
    before its gauge export); the controller evaluates pressure every
    `eval_interval` syncs and exposes its decisions as three cheap
    attributes the scheduler reads inline:

      * `draft_cap`     — None, or the max accepted draft length (level 1)
      * `spec_disabled` — verify step replaced by 1-step decode (level 2+)
      * `force_window_1`— decode window forced to 1 (level 3+)

    Levels 4 and 5 act at evaluation time (cache flush / priority shed)
    rather than through a flag. Telemetry surface: the
    `serving/degradation_level` gauge, escalation/de-escalation counters,
    a flight-recorder event per level CHANGE, and per-level sync occupancy
    in `stats()["level_occupancy"]`.
    """

    def __init__(self, engine, config):
        self.engine = engine
        self.config = config
        self.level = 0
        self.calm_streak = 0
        self.evals = 0
        self.escalations = 0
        self.deescalations = 0
        self.flushed_blocks = 0
        self.occupancy = [0] * (MAX_LEVEL + 1)   # syncs spent at each level
        self._syncs = 0
        self._interval = max(1, int(config.eval_interval))

    # -- the flags the scheduler reads inline --------------------------

    @property
    def draft_cap(self) -> Optional[int]:
        return 1 if self.level >= 1 else None

    @property
    def spec_disabled(self) -> bool:
        return self.level >= 2

    @property
    def force_window_1(self) -> bool:
        return self.level >= 3

    # -- pressure signals ----------------------------------------------

    def _signals(self) -> Dict[str, float]:
        eng = self.engine
        alloc = eng.allocator
        out = {"free_frac": alloc.available / max(1, alloc.capacity),
               "queue": float(len(eng.queue))}
        if self.config.ttft_p99_ms > 0 and eng.telemetry.enabled:
            p99 = eng.latency_snapshot().get("ttft_ms", {}).get("p99")
            if p99 is not None:
                out["ttft_p99_ms"] = float(p99)
        # optional device-memory headroom signal from the memscope ledger
        # (needs telemetry.memscope AND a known capacity; omitted otherwise
        # so the ladder falls back to its pool/queue/TTFT signals)
        ms = getattr(eng, "memscope", None)
        if self.config.headroom_low > 0 and ms is not None:
            hf = ms.headroom_frac()
            if hf is not None:
                out["headroom_frac"] = float(hf)
        return out

    def _classify(self, sig) -> str:
        """One of "pressured" (some signal over its high watermark),
        "calm" (every signal under its low watermark), or "hold" (inside
        the hysteresis band — neither escalate nor count toward
        de-escalation)."""
        cfg = self.config
        # the headroom band mirrors the others (an absent signal reads as
        # fully calm: sig only carries it when the ledger can compute it)
        hr_high = max(cfg.headroom_high, cfg.headroom_low)
        if (sig["free_frac"] < cfg.free_block_low
                or sig["queue"] > cfg.queue_high
                or sig.get("ttft_p99_ms", 0.0) > cfg.ttft_p99_ms > 0
                or sig.get("headroom_frac", 1.0) < cfg.headroom_low):
            return "pressured"
        if (sig["free_frac"] >= cfg.free_block_high
                and sig["queue"] <= cfg.queue_low
                and not sig.get("ttft_p99_ms", 0.0) > cfg.ttft_p99_ms > 0
                and sig.get("headroom_frac", 1.0) >= hr_high):
            return "calm"
        return "hold"

    # -- the ladder -----------------------------------------------------

    def update(self, finished: List) -> None:
        """Once per scheduler sync. Evaluates every `eval_interval` syncs;
        level-5 sheds complete into `finished` (the caller's per-step
        completion list), exactly like a retirement."""
        self.occupancy[self.level] += 1
        self._syncs += 1
        if self._syncs % self._interval:
            return
        self.evals += 1
        sig = self._signals()
        verdict = self._classify(sig)
        if verdict == "pressured":
            self.calm_streak = 0
            if self.level < MAX_LEVEL:
                self._change_level(self.level + 1, sig)
                self.escalations += 1
        elif verdict == "calm":
            self.calm_streak += 1
            if self.level > 0 and self.calm_streak >= self.config.hold_steps:
                self._change_level(self.level - 1, sig)
                self.deescalations += 1
                self.calm_streak = 0
        else:                                    # hysteresis band: sit still
            self.calm_streak = 0

        # the action rungs re-apply every evaluation while engaged: new
        # reclaimable blocks keep appearing (retirements) and new low-
        # priority requests keep arriving while the pressure persists
        eng = self.engine
        if self.level >= 4:
            n = eng.allocator.flush_reclaimable()
            if n:
                self.flushed_blocks += n
                if eng.telemetry.enabled:
                    eng.telemetry.inc("serving/degradation_flushed_blocks", n)
        if self.level >= 5:
            finished.extend(eng.shed_queued_below_priority(
                int(self.config.shed_below_priority)))
        if eng.telemetry.enabled:
            eng.telemetry.set_gauge("serving/degradation_level", self.level)

    def _change_level(self, new: int, sig) -> None:
        old, self.level = self.level, new
        eng = self.engine
        if eng.telemetry.enabled:
            if new > old:
                eng.telemetry.inc("serving/degradation_escalations")
            else:
                eng.telemetry.inc("serving/degradation_deescalations")
        if eng.flightrec.enabled:
            eng.flightrec.record(
                "degrade", level=new, name=LEVEL_NAMES[new],
                **{k: round(v, 4) for k, v in sig.items()})
        log_dist(f"serving degradation: level {old} -> {new} "
                 f"({LEVEL_NAMES[new]}; free_frac={sig['free_frac']:.2f} "
                 f"queue={int(sig['queue'])})", ranks=[0])

    def stats(self) -> Dict:
        return {"level": self.level,
                "level_name": LEVEL_NAMES[self.level],
                "evals": self.evals,
                "escalations": self.escalations,
                "deescalations": self.deescalations,
                "flushed_blocks": self.flushed_blocks,
                "sheds": self.engine.degradation_sheds,
                "level_occupancy": {LEVEL_NAMES[i]: n for i, n
                                    in enumerate(self.occupancy)}}
