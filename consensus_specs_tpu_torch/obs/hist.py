"""Mergeable log-bucketed latency histograms: the port's copy of
consensus_specs_tpu/obs/hist.py, the same bounds and the same reads.

Bucket bounds are a FIXED function of the bucket index: bucket ``i``
covers ``(2^(i/8), 2^((i+1)/8)]`` seconds (base 2, 8 sub-buckets an
octave, ~9.05% relative width), so two histograms built anywhere, over
any split of a stream, have identical bounds and merge by adding counts.
Merge is exact, associative and commutative.

Percentiles come from linear interpolation inside the (log-scaled)
bucket that crosses the rank, clamped to the observed min/max: within one
bucket width (factor ``2^(1/8)``) of the exact nearest-rank statistic.
``count_over(threshold)`` reads the mass above a threshold from the
bucket counts, and ``buckets()`` feeds the Prometheus ``_bucket`` /
``_sum`` / ``_count`` exposition in ``obs/registry.py``.

Thread safety: every method takes the instance lock; ``snapshot()``
returns a detached copy so readers never hold a writer's lock.
"""
import math
import threading
from typing import Dict, Iterator, List, Optional, Tuple

# 8 sub-buckets per base-2 octave: bucket i covers (2^(i/8), 2^((i+1)/8)]
SUB_BUCKETS = 8
# index clamp: ~2^-30 s (≈ 1 ns) .. 2^20 s (≈ 12 days); anything outside
# lands in the edge bucket, never a new one — the label set stays bounded
MIN_INDEX = -30 * SUB_BUCKETS
MAX_INDEX = 20 * SUB_BUCKETS


def bucket_index(value: float) -> int:
    """The fixed value -> bucket-index map (same everywhere, by design:
    exact cross-process mergeability IS this function's determinism).
    Non-positive values get the dedicated zero bucket (``MIN_INDEX - 1``)."""
    if value <= 0.0:
        return MIN_INDEX - 1
    i = math.floor(math.log2(value) * SUB_BUCKETS)
    return min(MAX_INDEX, max(MIN_INDEX, i))


def bucket_lower(index: int) -> float:
    return 0.0 if index <= MIN_INDEX else 2.0 ** (index / SUB_BUCKETS)


def bucket_upper(index: int) -> float:
    if index < MIN_INDEX:
        return 0.0  # the zero bucket
    return 2.0 ** ((index + 1) / SUB_BUCKETS)


# one bucket's relative width — the percentile-agreement bound
WIDTH_FACTOR = 2.0 ** (1.0 / SUB_BUCKETS)


class Histogram:
    """One mergeable log-bucketed distribution (sparse bucket storage)."""

    __slots__ = ("_lock", "_counts", "count", "sum", "min", "max")

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    # -- writing -------------------------------------------------------------

    def observe(self, value: float) -> None:
        value = float(value)
        idx = bucket_index(value)
        with self._lock:
            self._counts[idx] = self._counts.get(idx, 0) + 1
            self.count += 1
            self.sum += value
            if self.min is None or value < self.min:
                self.min = value
            if self.max is None or value > self.max:
                self.max = value

    def merge(self, other: "Histogram") -> "Histogram":
        """Exact aggregation: identical fixed bounds mean bucket counts
        simply add. Returns a NEW histogram; neither input is mutated."""
        out = Histogram()
        for h in (self, other):
            with h._lock:
                for idx, n in h._counts.items():
                    out._counts[idx] = out._counts.get(idx, 0) + n
                out.count += h.count
                out.sum += h.sum
                for bound, pick in (("min", min), ("max", max)):
                    v = getattr(h, bound)
                    cur = getattr(out, bound)
                    if v is not None:
                        setattr(out, bound, v if cur is None else pick(cur, v))
        return out

    # -- reading -------------------------------------------------------------

    def snapshot(self) -> "Histogram":
        """Detached copy (safe to read/render without this lock)."""
        out = Histogram()
        with self._lock:
            out._counts = dict(self._counts)
            out.count = self.count
            out.sum = self.sum
            out.min = self.min
            out.max = self.max
        return out

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile, linearly interpolated inside the
        crossing bucket and clamped to the observed [min, max] (exact for
        the extremes; within one bucket width everywhere else)."""
        with self._lock:
            if self.count == 0:
                return 0.0
            rank = max(1, math.ceil(q * self.count / 100.0))
            rank = min(rank, self.count)
            cum = 0
            for idx in sorted(self._counts):
                n = self._counts[idx]
                if cum + n >= rank:
                    lo, hi = bucket_lower(idx), bucket_upper(idx)
                    frac = (rank - cum) / n
                    value = lo + (hi - lo) * frac
                    if self.min is not None:
                        value = max(value, self.min)
                    if self.max is not None:
                        value = min(value, self.max)
                    return value
                cum += n
            return self.max or 0.0  # unreachable when counts are consistent

    def count_over(self, threshold: float) -> int:
        """Observations strictly above ``threshold`` (conservative at the
        boundary bucket: its whole count stays BELOW the threshold when the
        threshold sits inside it, matching the one-bucket error bar every
        other read here carries). The SLO burn-rate numerator."""
        cut = bucket_index(threshold)
        with self._lock:
            return sum(n for idx, n in self._counts.items() if idx > cut)

    def buckets(self) -> Iterator[Tuple[float, int]]:
        """Cumulative (upper_bound_seconds, count) pairs ascending — the
        Prometheus ``_bucket``/``le`` series (``+Inf`` is the caller's,
        rendered as the total count)."""
        with self._lock:
            items = sorted(self._counts.items())
        cum = 0
        for idx, n in items:
            cum += n
            yield bucket_upper(idx), cum

    def state(self) -> Dict:
        """Comparable value state (the merge property tests diff these)."""
        with self._lock:
            return {
                "counts": dict(self._counts),
                "count": self.count,
                "sum": self.sum,
                "min": self.min,
                "max": self.max,
            }

    def summary(self, quantiles: List[float] = (50.0, 95.0, 99.0)) -> Dict:
        """The latency-family dict shape ``ops/profiling.latency_summary``
        publishes (count/mean/max + the percentile points, milliseconds)."""
        snap = self.snapshot()  # consistent reads without re-locking per q
        out = {
            "count": snap.count,
            # `n` duplicates `count` under the fleet-wide naming rule:
            # every percentile family carries its observation count
            "n": snap.count,
            "mean_ms": round(snap.sum / max(1, snap.count) * 1e3, 3),
            "max_ms": round((snap.max or 0.0) * 1e3, 3),
        }
        for q in quantiles:
            out[f"p{q:g}_ms"] = round(snap.percentile(q) * 1e3, 3)
        return out
