"""Allocation-cheap serving metrics: counters, gauges, and fixed-bucket
histograms with interpolated percentiles.

The serving hot path records one histogram sample per token and a handful
per tick, so every ``record()`` must stay O(log buckets) with zero
allocation: a histogram is a fixed list of geometric bucket edges plus an
int count per bucket — no per-sample storage, percentiles estimated by
linear interpolation inside the winning bucket (error bounded by the
bucket ratio, ~21% with the default 12-buckets-per-decade edges; see
``tests/test_obs.py`` for the numpy cross-check).

Counts only ever grow, so percentiles — like the scheduler's running
``mean_*`` aggregates — survive ``forget()``/``clear_finished()``: a
long-lived engine's p99 keeps meaning "over everything served so far".
"""
from __future__ import annotations

import math
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Union

Number = Union[int, float]


def log_bucket_edges(lo: float = 1e-6, hi: float = 1e3,
                     per_decade: int = 12) -> List[float]:
    """Geometric bucket upper edges spanning [lo, hi].

    The default covers 1 microsecond to ~17 minutes — every latency the
    serving path can plausibly record — at a ~1.21 ratio per bucket
    (12 buckets per decade), which bounds the percentile interpolation
    error to about one bucket width.
    """
    assert 0 < lo < hi and per_decade >= 1
    n = int(math.ceil(math.log10(hi / lo) * per_decade))
    return [lo * 10 ** (k / per_decade) for k in range(n + 1)]


class Counter:
    """Monotonic accumulator (ints or seconds — ``inc`` takes floats)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Number = 0

    def inc(self, n: Number = 1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value (last write wins)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Number = 0

    def set(self, v: Number) -> None:
        self.value = v


class Histogram:
    """Fixed-bucket histogram: geometric edges, ints per bucket.

    Bucket ``i`` holds samples in ``(edges[i-1], edges[i]]`` (bucket 0:
    ``<= edges[0]``); one extra overflow bucket catches samples beyond
    the last edge.  Observed min/max are tracked exactly, so percentile
    interpolation is clamped to the true sample range — a single-sample
    histogram reports that sample at every quantile.
    """

    __slots__ = ("name", "edges", "counts", "count", "total", "_min", "_max")

    def __init__(self, name: str, edges: Optional[Sequence[float]] = None):
        self.name = name
        self.edges = list(edges) if edges is not None else log_bucket_edges()
        assert all(a < b for a, b in zip(self.edges, self.edges[1:])), \
            "histogram edges must be strictly increasing"
        self.counts = [0] * (len(self.edges) + 1)
        self.count = 0
        self.total = 0.0
        self._min = math.inf
        self._max = -math.inf

    def record(self, value: Number) -> None:
        v = float(value)
        self.counts[bisect_left(self.edges, v)] += 1
        self.count += 1
        self.total += v
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    def percentile(self, q: float) -> Optional[float]:
        """Interpolated q-th percentile (None when empty).

        Finds the bucket holding the q-th sample and interpolates
        linearly between its edges, clamped to the observed min/max —
        accurate to within one bucket ratio of the exact order statistic.
        """
        if not self.count:
            return None
        target = max(1.0, q / 100.0 * self.count)
        cum = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            cum += c
            if cum >= target:
                lo = self.edges[i - 1] if i > 0 else 0.0
                hi = self.edges[i] if i < len(self.edges) else self._max
                lo = max(lo, self._min)
                hi = max(lo, min(hi, self._max))
                frac = (target - (cum - c)) / c
                return lo + frac * (hi - lo)
        return self._max  # unreachable unless float dust; be safe

    def snapshot(self) -> Dict[str, Optional[float]]:
        """Compact JSON-friendly view: count/mean/min/max + p50/p90/p99."""
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self._min if self.count else None,
            "max": self._max if self.count else None,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Name -> metric store with get-or-create accessors.

    One registry per telemetry instance; the serving engine's counters
    (packed/padded token totals) and the scheduler's latency histograms
    all live here, so ``snapshot()`` is the single flat export the trace
    dump and ``engine.metrics()`` read from.
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, *args)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  edges: Optional[Sequence[float]] = None) -> Histogram:
        return self._get(name, Histogram, edges)

    def snapshot(self) -> Dict[str, object]:
        """Flat dict: counters/gauges -> value, histograms -> snapshot()."""
        out: Dict[str, object] = {}
        for name, m in sorted(self._metrics.items()):
            out[name] = m.snapshot() if isinstance(m, Histogram) else m.value
        return out
