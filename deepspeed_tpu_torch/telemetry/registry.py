"""Metrics core: named Counters, Gauges, and log-scale Histograms
(counterpart of `deepspeed_tpu/telemetry/registry.py`; this package keeps
its own copy, so the same observations give the same buckets, quantiles
and snapshots in both packages).

Stdlib-only by design — the registry updates on every scheduler step and every
train step, so a metric update must cost no more than a dict lookup plus a
bisect (no locks on the hot path, no numpy, no allocation). p50/p99 TTFT
under a mixed trace is a property of a histogram, not of any single event.

Histograms use FIXED log-scale buckets (vLLM/Prometheus style): bucket edges
are precomputed at construction as `lo * 10^(i/buckets_per_decade)`, so an
observation is one bisect into a ~40-entry list. Quantiles interpolate
linearly inside the winning bucket and clamp to the exact observed min/max —
at 5 buckets per decade the relative error is bounded by the bucket ratio
(~58% worst case, far tighter in practice since min/max clamp the tails),
which is the standard latency-histogram trade: O(1) memory, mergeable,
monotone-correct percentiles.
"""

import bisect
import math
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "merge_snapshots"]


class Counter:
    """Monotonically increasing value (requests served, tokens generated)."""

    kind = "counter"
    __slots__ = ("name", "value")

    def __init__(self, name):
        self.name = name
        self.value = 0.0

    def inc(self, n=1.0):
        self.value += n

    def snapshot(self):
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins value (queue depth, free blocks, MFU)."""

    kind = "gauge"
    __slots__ = ("name", "value")

    def __init__(self, name):
        self.name = name
        self.value = 0.0

    def set(self, v):
        self.value = float(v)

    def snapshot(self):
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket log-scale histogram with p50/p90/p99/mean snapshots.

    Default edges cover 0.1 .. 1e6 (in whatever unit the caller observes —
    the serving layer uses milliseconds, so the range spans 100us noise to a
    ~17-minute outlier) at 5 buckets per decade. Pass explicit `bounds`
    (sorted upper edges) for deterministic golden-output tests or odd units.
    Values below the first edge land in bucket 0, values above the last in
    the overflow bucket; exact min/max/sum/count ride alongside so the mean
    is exact and quantiles clamp to the true observed range.
    """

    kind = "histogram"
    __slots__ = ("name", "bounds", "counts", "count", "sum", "min", "max")

    def __init__(self, name, lo=0.1, hi=1e6, buckets_per_decade=5,
                 bounds=None):
        self.name = name
        if bounds is not None:
            self.bounds = sorted(float(b) for b in bounds)
        else:
            n = int(math.ceil(math.log10(hi / lo) * buckets_per_decade))
            step = 1.0 / buckets_per_decade
            self.bounds = [lo * 10.0 ** (i * step) for i in range(n + 1)]
        self.counts = [0] * (len(self.bounds) + 1)   # +1 = overflow (+Inf)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v):
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def quantile(self, q):
        """Linear interpolation inside the winning bucket, clamped to the
        exact observed [min, max]."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        lower = 0.0
        for i, c in enumerate(self.counts):
            if c and cum + c >= target:
                upper = self.bounds[i] if i < len(self.bounds) else self.max
                v = lower + (upper - lower) * (target - cum) / c
                return min(max(v, self.min), self.max)
            cum += c
            if i < len(self.bounds):
                lower = self.bounds[i]
        return self.max

    def cumulative_buckets(self):
        """[(upper_edge, cumulative_count), ...] ending with (inf, count) —
        the Prometheus `_bucket{le=...}` series."""
        out, cum = [], 0
        for edge, c in zip(self.bounds, self.counts):
            cum += c
            out.append((edge, cum))
        out.append((math.inf, self.count))
        return out

    def snapshot(self):
        empty = self.count == 0
        return {
            "type": "histogram",
            "count": self.count,
            "sum": self.sum,
            "mean": 0.0 if empty else self.sum / self.count,
            "min": 0.0 if empty else self.min,
            "max": 0.0 if empty else self.max,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
            # full bucket state: a snapshot is MERGEABLE (bucket-wise, and
            # exact because every process builds the same log-scale edges),
            # so pool-level percentiles come from merged buckets instead of
            # averaging per-replica p99s
            "bounds": list(self.bounds),
            "counts": list(self.counts),
        }

    @classmethod
    def from_state(cls, name, snap):
        """Rebuild a histogram from a `snapshot()` dict (the wire/JSONL
        form) so quantiles can be recomputed on the restored — or merged —
        bucket state."""
        h = cls(name, bounds=snap["bounds"])
        h.counts = [int(c) for c in snap["counts"]]
        h.count = int(snap["count"])
        h.sum = float(snap["sum"])
        if h.count:
            h.min = float(snap["min"])
            h.max = float(snap["max"])
        return h

    def merge(self, other):
        """Accumulate another histogram bucket-wise (exact: identical
        bounds required — the pool shares one bucket layout by
        construction)."""
        if self.bounds != other.bounds:
            raise ValueError(
                f"histogram {self.name!r}: cannot merge mismatched bucket "
                f"bounds ({len(self.bounds)} vs {len(other.bounds)} edges)")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        if other.min < self.min:
            self.min = other.min
        if other.max > self.max:
            self.max = other.max


class MetricsRegistry:
    """Named metrics with get-or-create access and deterministic snapshots.

    Creation takes a lock (checkpoint finalizer threads record events too);
    updates on an existing metric are lock-free — a torn float add is an
    acceptable failure mode for telemetry, a hot-path mutex is not.
    """

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()

    def _get(self, name, cls, **kwargs):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name, **kwargs)
                    self._metrics[name] = m
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is a {m.kind}, not a "
                            f"{cls.kind}")
        return m

    def counter(self, name) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name, **kwargs) -> Histogram:
        """Get-or-create; bucket kwargs apply on first creation only."""
        return self._get(name, Histogram, **kwargs)

    def metrics(self):
        """(name, metric) pairs in name order — the one iteration order every
        exporter uses, so Prometheus/JSONL/bridge output is deterministic."""
        return [(n, self._metrics[n]) for n in sorted(self._metrics)]

    def snapshot(self):
        return {n: m.snapshot() for n, m in self.metrics()}

    def clear(self):
        with self._lock:
            self._metrics = {}


def merge_snapshots(per_source):
    """Merge per-source registry snapshots into one pool-level snapshot.

    `per_source` maps a source tag (replica id) to that source's
    `MetricsRegistry.snapshot()` dict. Merge semantics, per metric type:

      * **counters** sum across sources;
      * **gauges** are NEVER summed blindly — the merged entry keeps a
        per-source map (`"sources"`) as the authoritative record, with
        `"value"` set to the across-source sum for the common pool-additive
        gauges (queue depth, active slots); readers that need a different
        aggregation (max degradation rung, min headroom) take it from
        `"sources"`;
      * **histograms** merge bucket-wise via the full bucket state the
        snapshot carries — exact, because every process builds identical
        log-scale edges — and percentiles are recomputed from the merged
        buckets. The merged count equals the sum of per-source counts by
        construction.

    A type mismatch for one name across sources is a caller bug and raises;
    the output dict is itself a valid snapshot (merged histograms carry
    bounds/counts), so merges compose.
    """
    merged = {}
    hists = {}
    for src in sorted(per_source):
        for name, snap in per_source[src].items():
            kind = snap.get("type")
            cur = merged.get(name)
            if cur is not None and cur.get("type") != kind:
                raise ValueError(
                    f"metric {name!r}: type conflict across sources "
                    f"({cur.get('type')} vs {kind} from {src!r})")
            if kind == "counter":
                if cur is None:
                    merged[name] = {"type": "counter", "value": 0.0}
                merged[name]["value"] += snap["value"]
            elif kind == "gauge":
                if cur is None:
                    merged[name] = {"type": "gauge", "value": 0.0,
                                    "sources": {}}
                merged[name]["value"] += snap["value"]
                merged[name]["sources"][src] = snap["value"]
            elif kind == "histogram":
                h = hists.get(name)
                if h is None:
                    hists[name] = Histogram.from_state(name, snap)
                    merged[name] = {"type": "histogram"}  # placeholder
                else:
                    h.merge(Histogram.from_state(name, snap))
            else:
                raise ValueError(f"metric {name!r}: unknown snapshot type "
                                 f"{kind!r} from {src!r}")
    for name, h in hists.items():
        merged[name] = h.snapshot()
    return merged
