"""Streaming counters + fixed-bucket histograms (DESIGN.md §11).

The metrics layer on top of the span/record stream: O(1)-memory running
counters (requests served, bytes moved, per-stage seconds, queue depth) and
**fixed-bucket histograms** whose percentiles (p50/p90/p99) feed the
upgraded ``session.stats()`` — the distributional view the paper's
mean-only tables lack, and what multi-tenant serving (ROADMAP item 2) and
cycle-model validation (item 3) both need.

Histograms use geometric (log-spaced) bucket bounds: relative resolution is
constant across the many-decade latency range (µs-scale chunk dispatch to
second-scale cold compiles), and observation is one bisect + one increment —
cheap enough for the scheduler's hot path.  Percentiles interpolate linearly
inside the landing bucket, with the tracked exact min/max tightening the
open-ended under/overflow buckets, so the error is bounded by the bucket
ratio (~19% with the default √2 spacing) — the classic Prometheus/HDR
trade: bounded memory, bounded error, mergeable.

Everything is guarded by one lock per :class:`Metrics` registry; the
scheduler worker thread observes while ``session.stats()`` snapshots.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Mapping, Sequence

#: default histogram bounds: 1e-7 s .. ~128 s, √2 spacing (~62 buckets) —
#: covers chunk-level dispatch (µs) through cold-compile requests (tens of s)
DEFAULT_BOUNDS: tuple = tuple(
    1e-7 * math.sqrt(2.0) ** i
    for i in range(int(math.log(128.0 / 1e-7, math.sqrt(2.0))) + 1))

_PCTS = (50.0, 90.0, 99.0)


class Histogram:
    """Fixed-bucket streaming histogram with interpolated percentiles."""

    __slots__ = ("bounds", "counts", "count", "total", "vmin", "vmax")

    def __init__(self, bounds: Sequence[float] | None = None):
        self.bounds = tuple(bounds) if bounds is not None else DEFAULT_BOUNDS
        if not self.bounds or list(self.bounds) != sorted(self.bounds):
            raise ValueError("histogram bounds must be a sorted, "
                             "non-empty sequence")
        # counts[i] = observations in (bounds[i-1], bounds[i]];
        # counts[len(bounds)] = overflow (> bounds[-1])
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.count += 1
        self.total += value
        if value < self.vmin:
            self.vmin = value
        if value > self.vmax:
            self.vmax = value

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """Interpolated percentile (``p`` in [0, 100]).  The rank is walked
        through the cumulative bucket counts; within the landing bucket the
        value interpolates linearly between the bucket edges, clamped to the
        exact observed min/max (which also closes the under/overflow
        buckets)."""
        if not self.count:
            return 0.0
        if not 0.0 <= p <= 100.0:
            raise ValueError(f"percentile must be in [0, 100], got {p}")
        rank = p / 100.0 * self.count
        cum = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else self.vmin
                hi = self.bounds[i] if i < len(self.bounds) else self.vmax
                lo = max(lo, self.vmin)
                hi = min(hi, self.vmax)
                if hi <= lo:
                    return lo
                frac = (rank - cum) / c
                return lo + frac * (hi - lo)
            cum += c
        return self.vmax

    def snapshot(self) -> dict:
        out = {"count": self.count, "mean": self.mean,
               "min": self.vmin if self.count else 0.0,
               "max": self.vmax if self.count else 0.0}
        out.update({f"p{p:g}": self.percentile(p) for p in _PCTS})
        return out


class Metrics:
    """One named registry of counters + histograms behind one lock —
    the live counters surface a serving session exposes while requests are
    still in flight (``session.stats()`` merges a snapshot of this with the
    telemetry aggregates)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._histograms: dict[str, Histogram] = {}

    # -- writes (hot path) ---------------------------------------------------

    def inc(self, name: str, value: float = 1.0) -> None:
        """Add ``value`` to counter ``name`` (negative values allowed —
        queue depth uses this as a gauge)."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def set_gauge(self, name: str, value: float) -> None:
        """Overwrite counter ``name`` with an absolute level (gauge
        semantics — the resident cache publishes resident_bytes this way)."""
        with self._lock:
            self._counters[name] = value

    def observe(self, name: str, value: float,
                bounds: Sequence[float] | None = None) -> None:
        """Record one observation into histogram ``name`` (created on first
        use with ``bounds`` or the defaults)."""
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(bounds)
            h.observe(value)

    # -- reads ---------------------------------------------------------------

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def histogram(self, name: str) -> Histogram | None:
        with self._lock:
            return self._histograms.get(name)

    def percentiles(self, name: str,
                    pcts: Sequence[float] = _PCTS) -> dict:
        """{"p50": ..., ...} for histogram ``name`` ({} when unobserved)."""
        with self._lock:
            h = self._histograms.get(name)
            if h is None or not h.count:
                return {}
            return {f"p{p:g}": h.percentile(p) for p in pcts}

    def snapshot(self) -> dict:
        """Point-in-time view: every counter value and histogram summary."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "histograms": {k: h.snapshot()
                               for k, h in self._histograms.items()},
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._histograms.clear()


def merge_snapshots(snaps: Sequence[Mapping]) -> dict:
    """Sum counters across snapshots (histogram summaries are per-source;
    they do not merge losslessly and are kept keyed by index)."""
    counters: dict[str, float] = {}
    for s in snaps:
        for k, v in s.get("counters", {}).items():
            counters[k] = counters.get(k, 0.0) + v
    return {"counters": counters,
            "histograms": {str(i): s.get("histograms", {})
                           for i, s in enumerate(snaps)}}
