"""Replica-side observability spool: the wire buffer of the pod plane.

A `RemoteReplica` pool runs each engine in its own process, so the
tracer/flight-recorder objects cannot be injected across the boundary —
each process records into its OWN telemetry dir. The pod observability
plane ships those records home instead: the replica server taps its
tracer (`Tracer.on_record`) and flight recorder (`FlightRecorder
.on_record`) into an `ObservabilitySpool`, and the router pulls the spool
over the idempotent `observability_pull` verb on its sync cadence.

Spool contract:

  * **bounded** — a ring of the last `capacity` items. A router that
    stops pulling (network partition, hung router) costs the replica a
    fixed amount of memory, never unbounded growth; overflow drops
    OLDEST-first and counts every drop into `obs/spool_dropped`.
  * **cursor-addressed** — every item carries a monotonically increasing
    cursor. A pull asks "everything after cursor C"; items are never
    consumed by a pull (only by ring overflow), so a retried pull returns
    byte-identical data and the router advances its cursor only after a
    successful ingest — re-pulls can never double-count.
  * **crash-durable** — every item is also appended (and flushed) to an
    on-disk JSONL spool file. When the process dies to `kill -9` the
    router drains the victim's tail directly from that file for the
    post-mortem dump; the file is compacted back to the live ring
    whenever it grows past ~4x capacity, so disk stays bounded too.
  * **clockless** — the spool never reads a wall clock; item timestamps
    are whatever the (injectable-clock) tracer/recorder stamped.
"""

import json
import os
import threading
from typing import Any, Dict, List

__all__ = ["ObservabilitySpool", "read_spool_file"]


class ObservabilitySpool:
    """Bounded, cursor-addressed ring of observability items with an
    on-disk JSONL mirror. Items are `{"cursor", "kind", "rec"}` where
    `kind` is `"span"` (a tracer JSONL record) or `"flight"` (a flight-
    recorder event)."""

    def __init__(self, path=None, capacity=1024, telemetry=None):
        self.path = str(path) if path is not None else None
        self.capacity = max(1, int(capacity))
        self.telemetry = telemetry
        self.dropped = 0
        self._items: List[Dict[str, Any]] = []
        self._cursor = 0
        self._file_items = 0
        self._lock = threading.Lock()

    # ---- producer side (tracer / flight-recorder taps) ----------------

    def append(self, kind, rec):
        with self._lock:
            self._cursor += 1
            item = {"cursor": self._cursor, "kind": kind, "rec": rec}
            self._items.append(item)
            if len(self._items) > self.capacity:
                # oldest-first drop: the tail (most recent past) is what a
                # post-mortem needs
                over = len(self._items) - self.capacity
                del self._items[:over]
                self.dropped += over
                if self.telemetry is not None:
                    self.telemetry.inc("obs/spool_dropped", over)
            self._append_file(item)

    def span_hook(self, rec):
        """`Tracer.on_record` adapter."""
        self.append("span", rec)

    def flight_hook(self, ev):
        """`FlightRecorder.on_record` adapter."""
        self.append("flight", ev)

    # ---- consumer side (the observability_pull verb) -------------------

    def pull(self, cursor=0) -> Dict[str, Any]:
        """Everything after `cursor`, oldest first. Pure read: the same
        cursor always returns the same items (until ring overflow claims
        them), which is what makes the wire verb idempotent."""
        with self._lock:
            items = [it for it in self._items if it["cursor"] > int(cursor)]
            return {"cursor": self._cursor, "items": items,
                    "dropped": self.dropped}

    # ---- on-disk mirror -------------------------------------------------

    def _append_file(self, item):
        if self.path is None:
            return
        try:
            if self._file_items >= 4 * self.capacity:
                self._compact()
            with open(self.path, "a") as f:
                f.write(json.dumps(item, default=str) + "\n")
                f.flush()
                os.fsync(f.fileno())
            self._file_items += 1
        except Exception:
            # the mirror is best-effort forensics; never let disk trouble
            # take down the serving hot path
            pass

    def _compact(self):
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            for it in self._items:
                f.write(json.dumps(it, default=str) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._file_items = len(self._items)


def read_spool_file(path, after_cursor=0) -> List[Dict[str, Any]]:
    """Post-mortem read of a dead replica's on-disk spool: items with
    cursor > `after_cursor`, oldest first, deduplicated by cursor (the
    file may hold pre-compaction duplicates). A torn final line — the
    `kill -9` landing mid-append — is skipped."""
    items: Dict[int, Dict[str, Any]] = {}
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    it = json.loads(line)
                except json.JSONDecodeError:
                    continue
                cur = it.get("cursor")
                if isinstance(cur, int) and cur > int(after_cursor):
                    items[cur] = it
    except OSError:
        return []
    return [items[c] for c in sorted(items)]
