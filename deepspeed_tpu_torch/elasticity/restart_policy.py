"""Reusable restart budget: exponential backoff + jitter + per-cause caps
(counterpart of `deepspeed_tpu/elasticity/restart_policy.py`, stdlib only).

The serving router (`serving/router.py`) keeps a per-replica budget to
decide whether a quarantined replica is rebuilt or stays dead: N restarts
in all, optionally fewer for specific causes, and a growing but capped
delay between attempts so a flapping resource is not hammered in a tight
loop.

`RestartPolicy` is the immutable description; `RestartBudget` is the
mutable account. One policy can be shared by many budgets (the router
hands the same policy to every replica's budget).
"""

import random
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional


@dataclass(frozen=True)
class RestartPolicy:
    """How many restarts are allowed and how long to wait between them.

    `max_restarts` is the global cap; `per_cause` overrides it for specific
    cause strings (unlisted causes fall back to the global cap). Backoff for
    restart #n is ``min(base_backoff_s * backoff_factor**(n-1),
    max_backoff_s)``, scaled by ``1 + jitter * U[0,1)`` so a fleet of
    supervisors doesn't stampede a shared scheduler in lockstep.
    """
    max_restarts: int = 100
    base_backoff_s: float = 5.0
    backoff_factor: float = 2.0
    max_backoff_s: float = 300.0
    jitter: float = 0.1
    per_cause: Dict[str, int] = field(default_factory=dict)


class RestartBudget:
    """Mutable restart account against a `RestartPolicy`.

    `consume(cause)` records one restart and returns False the moment any
    budget (per-cause or global) is exhausted — the caller then stops
    restarting. `next_delay()` is the backoff for the restart just consumed
    (it reads the CURRENT restart count, so call it after `consume`).
    """

    def __init__(self, policy: RestartPolicy,
                 rng: Optional[Callable[[], float]] = None):
        self.policy = policy
        self.restarts = 0
        self.causes: Dict[str, int] = {}
        self.last_cause: Optional[str] = None
        self._rng = rng if rng is not None else random.random

    def consume(self, cause: str) -> bool:
        """Account one restart against `cause`; False = budget exhausted."""
        self.restarts += 1
        self.last_cause = cause
        self.causes[cause] = self.causes.get(cause, 0) + 1
        cap = self.policy.per_cause.get(cause)
        if cap is not None and self.causes[cause] > cap:
            return False
        return self.restarts <= self.policy.max_restarts

    @property
    def exhausted(self) -> bool:
        """True once a consume() has failed (or would fail globally)."""
        if self.restarts > self.policy.max_restarts:
            return True
        return any(self.causes.get(c, 0) > cap
                   for c, cap in self.policy.per_cause.items())

    def next_delay(self) -> float:
        """Backoff (seconds) before the restart the budget just consumed:
        exponential in the restart count, capped, with proportional jitter.
        Monotone nondecreasing in `restarts` at jitter=0."""
        p = self.policy
        if p.base_backoff_s <= 0:
            return 0.0
        delay = min(p.base_backoff_s *
                    (p.backoff_factor ** max(self.restarts - 1, 0)),
                    p.max_backoff_s)
        return delay * (1.0 + p.jitter * self._rng())
