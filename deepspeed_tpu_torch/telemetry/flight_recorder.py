"""Failure flight recorder: the serving black box (counterpart of
`deepspeed_tpu/telemetry/flight_recorder.py`, stdlib only).

A bounded ring of recent structured scheduling events (admissions,
evictions, re-routes, rollbacks, quarantines, deadlines) that costs one
deque append an event while everything is healthy, and dumps to disk —
with whatever state snapshot the caller hands it (`engine.stats()`,
`router.stats()`) — the moment something goes wrong: a replica throws, a
pool audit fails, or an operator asks for a dump.

Disabled by default and free when disabled: `record` is one flag check.
The reference's compile watchdog has no counterpart here: the port
compiles no programs (`telemetry.NULL_WATCHDOG`).
"""

import collections
import json
import os
import time
from typing import Optional

__all__ = ["FlightRecorder", "NULL_RECORDER"]


class FlightRecorder:
    """Bounded ring of structured events + dump-on-failure.

    `record(kind, **fields)` appends `{"seq", "t", "kind", **fields}`;
    `dump(reason, state=...)` writes the ring plus the state snapshot to
    `<out_dir>/<subsystem>.flightrec.<n>.json` and returns the path. The
    ring keeps only the last `capacity` events — post-mortems need the
    recent past, not the whole run — and survives any number of dumps
    (each dump gets a fresh numbered file; the ring keeps rolling)."""

    def __init__(self, out_dir=None, subsystem="serving", capacity=256,
                 enabled=True, clock=None):
        self.enabled = bool(enabled) and out_dir is not None
        self.out_dir = str(out_dir) if out_dir is not None else None
        self.subsystem = subsystem
        self._clock = clock if clock is not None else time.monotonic
        self._ring = collections.deque(maxlen=max(1, int(capacity)))
        self._seq = 0
        self._dumps = 0
        # event tap: the replica server's observability spool subscribes
        # here so flight events can ship over the wire to the router. None
        # (the default) costs one attribute read per record.
        self.on_record = None

    def record(self, kind, **fields):
        if not self.enabled:
            return
        self._seq += 1
        ev = {"seq": self._seq, "t": self._clock(), "kind": kind, **fields}
        self._ring.append(ev)
        cb = self.on_record
        if cb is not None:
            cb(ev)

    def events(self):
        return list(self._ring)

    def dump(self, reason, state=None) -> Optional[str]:
        """Write the black box: last-N events + a state snapshot. Returns
        the dump path (None when disabled). Never raises — the dump runs
        inside failure paths that must keep failing over."""
        if not self.enabled:
            return None
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            if self._dumps == 0:
                # resume numbering past dumps left by a previous process in
                # the same output dir — a restart after a crash is exactly
                # when the PREVIOUS black box must survive, not be clobbered
                prefix = f"{self.subsystem}.flightrec."
                for name in os.listdir(self.out_dir):
                    if name.startswith(prefix) and name.endswith(".json"):
                        try:
                            n = int(name[len(prefix):-len(".json")])
                        except ValueError:
                            continue
                        self._dumps = max(self._dumps, n + 1)
            path = os.path.join(
                self.out_dir,
                f"{self.subsystem}.flightrec.{self._dumps:03d}.json")
            self._dumps += 1
            with open(path, "w") as f:
                json.dump({"reason": str(reason), "time": time.time(),
                           "clock": self._clock(),
                           "events": self.events(),
                           "state": _jsonable(state)}, f, indent=1,
                          default=str)
            return path
        except Exception:
            return None


def _jsonable(obj):
    """Best-effort JSON coercion for state snapshots (stats() dicts carry
    numpy scalars); anything stubborn stringifies via `default=str`."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if hasattr(obj, "item") and not isinstance(obj, (str, bytes)):
        try:
            return obj.item()
        except Exception:
            return str(obj)
    return obj


NULL_RECORDER = FlightRecorder(out_dir=None, enabled=False)
