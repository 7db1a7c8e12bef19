"""Training-loop bad-state sentinels (counterpart of
`deepspeed_tpu/runtime/sentinel.py`, the same budgets and causes).

The fp16 path already masks a single overflowing step (skip-step + loss-scale
backoff); what it cannot express is *persistent* bad state — NaN/Inf loss that
keeps coming back under bf16/fp32 (no scaler to mask it), an overflow streak
that outlives every loss-scale halving, or a loss spike that signals silently
corrupted params. `BadStateSentinel` watches the per-step metrics host-side
and reports a cause once a budget is exhausted; the engine then either rolls
back in-process to the last good checkpoint (`fault_tolerance.auto_rollback`)
or raises `BadStateError` for the elastic agent to classify and restart on.

Deliberately stdlib-only: a supervisor can import `BadStateError` for
its restart-cause taxonomy without pulling in torch.
"""

import math
from collections import deque


class BadStateError(RuntimeError):
    """Training state is unrecoverable in place (persistent non-finite loss,
    overflow streak, loss spike). Carries `cause` for the elastic agent's
    restart taxonomy."""

    def __init__(self, cause, message):
        super().__init__(message)
        self.cause = cause


CAUSE_NONFINITE = "nonfinite_loss"
CAUSE_OVERFLOW = "overflow_streak"
CAUSE_LOSS_SPIKE = "loss_spike"


class BadStateSentinel:
    """Consecutive-budget tracker over (loss, overflow) observations.

    * `nonfinite_budget`: consecutive non-finite losses tolerated past the
      masked skip-step (fp16 overflow steps count separately).
    * `overflow_budget`: consecutive fp16 overflow skip-steps tolerated —
      a healthy dynamic scaler recovers in a handful; a streak this long
      means the state itself is bad.
    * `loss_spike_window`/`loss_spike_factor`: a finite loss above
      factor × (rolling median over the window) for `loss_spike_patience`
      consecutive steps trips the spike cause. window=0 disables.
    """

    def __init__(self, config=None, *, enabled=None, recorder=None):
        cfg = config
        g = (lambda name, d: getattr(cfg, name, d)) if cfg is not None \
            else (lambda name, d: d)
        self.enabled = bool(g("enabled", False) if enabled is None else enabled)
        # optional telemetry FlightRecorder: every trip becomes a black-box
        # event (duck-typed `.record(kind, **fields)`; None = no recording,
        # keeping this module stdlib-only and telemetry-agnostic)
        self.recorder = recorder
        self.nonfinite_budget = int(g("nonfinite_budget", 3))
        self.overflow_budget = int(g("overflow_budget", 50))
        self.loss_spike_window = int(g("loss_spike_window", 0))
        self.loss_spike_factor = float(g("loss_spike_factor", 10.0))
        self.loss_spike_patience = int(g("loss_spike_patience", 3))
        self.reset()

    def reset(self):
        """Clear all streaks — called after a rollback/restore so the restored
        state gets a fresh budget."""
        self._nonfinite = 0
        self._overflows = 0
        self._spikes = 0
        self._history = deque(maxlen=max(self.loss_spike_window, 1))

    def observe(self, loss, overflow=False):
        """Feed one optimizer step's (host) loss and overflow flag. Returns a
        cause string once a budget is exhausted, else None."""
        if not self.enabled:
            return None
        if overflow:
            # masked skip-step: params untouched, scaler backing off — only a
            # *streak* is pathological
            self._overflows += 1
            if self.overflow_budget > 0 and self._overflows >= self.overflow_budget:
                return self._trip(CAUSE_OVERFLOW, loss)
            return None
        self._overflows = 0
        if loss is None or not math.isfinite(loss):
            self._nonfinite += 1
            if self.nonfinite_budget > 0 and self._nonfinite >= self.nonfinite_budget:
                return self._trip(CAUSE_NONFINITE, loss)
            return None
        self._nonfinite = 0
        if self.loss_spike_window > 0:
            if len(self._history) >= self.loss_spike_window:
                med = sorted(self._history)[len(self._history) // 2]
                if med > 0 and loss > self.loss_spike_factor * med:
                    self._spikes += 1
                    if self._spikes >= self.loss_spike_patience:
                        return self._trip(CAUSE_LOSS_SPIKE, loss)
                    return None  # spike suspects stay out of the baseline
                self._spikes = 0
            self._history.append(loss)
        return None

    def _trip(self, cause, loss):
        """A budget just exhausted: file the black-box event (best-effort —
        a broken recorder must never mask the cause) and hand the cause up
        for the engine's rollback/restart decision."""
        if self.recorder is not None:
            try:
                self.recorder.record("sentinel_trip", cause=cause,
                                     loss=None if loss is None else float(loss),
                                     detail=self.describe(cause))
            except Exception:
                pass
        return cause

    def describe(self, cause):
        return {
            CAUSE_NONFINITE: (f"loss non-finite for {self._nonfinite} "
                              f"consecutive steps (budget "
                              f"{self.nonfinite_budget})"),
            CAUSE_OVERFLOW: (f"{self._overflows} consecutive fp16 overflow "
                             f"skip-steps (budget {self.overflow_budget})"),
            CAUSE_LOSS_SPIKE: (f"loss > {self.loss_spike_factor}x rolling "
                               f"median for {self._spikes} steps"),
        }.get(cause, cause)
