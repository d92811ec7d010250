"""Latency measurement primitives: reservoirs and threshold bands.

Reference: fdbserver/LatencyBandConfig.{h,cpp} + the `LatencyBands`
counters folded into status, and fdbrpc/Stats.h `LatencySample` (a
sketch of recent request latencies served as percentiles). Every
request-serving role keeps one of each per request class; the cluster
controller folds their snapshots into the status document and the
periodic counter rollup, so a regression shows up per pipeline stage
instead of as one end-to-end number.
"""

from __future__ import annotations

from bisect import bisect_left, insort
from math import ceil
from typing import Tuple

# thresholds in seconds (ref: LatencyBandConfig's default band edges —
# status reports how many requests finished within each band)
DEFAULT_BANDS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                 0.25, 0.5, 1.0)


class LatencySample:
    """Sliding reservoir of the most recent latencies (ref: fdbrpc
    Stats.h LatencySample — the reference keeps a DDSketch; a bounded
    ring of raw samples gives the same p50/p90/p99/max surface at sim
    scale). `record` is O(1); percentiles sort on demand."""

    __slots__ = ("name", "size", "count", "max_seen", "_buf", "_next")

    def __init__(self, name: str, size: int = 512):
        self.name = name
        self.size = int(size)
        self.count = 0          # total recorded, beyond the reservoir
        self.max_seen = 0.0
        self._buf: list[float] = []
        self._next = 0          # ring cursor once the reservoir is full

    def record(self, seconds: float) -> None:
        self.count += 1
        if seconds > self.max_seen:
            self.max_seen = seconds
        if len(self._buf) < self.size:
            self._buf.append(seconds)
        else:
            self._buf[self._next] = seconds
            self._next = (self._next + 1) % self.size

    @staticmethod
    def _pick(s: list, p: float) -> float:
        # nearest-rank (ceil(p*n) - 1): int(p*n) would sit one rank
        # high and collapse p90/p99 to the max on small reservoirs
        if not s:
            return 0.0
        return s[min(len(s) - 1, max(0, ceil(p * len(s)) - 1))]

    def percentile(self, p: float) -> float:
        """p in [0, 1] over the reservoir (recent history)."""
        return self._pick(sorted(self._buf), p)

    def snapshot(self) -> dict:
        s = sorted(self._buf)   # one sort serves all three percentiles
        return {"count": self.count,
                "p50": round(self._pick(s, 0.50), 6),
                "p90": round(self._pick(s, 0.90), 6),
                "p99": round(self._pick(s, 0.99), 6),
                "max_seconds": round(self.max_seen, 6)}


class LatencyBands:
    """Banded latency histogram (ref: fdbserver/LatencyBandConfig.cpp +
    the latency_band_included counters in status): each recorded
    latency increments every band whose threshold it fits under, plus
    a total — so a consumer reads "fraction under X seconds" directly.
    Thresholds are configurable; adding one resets the counts, exactly
    like the reference reacting to a LatencyBandConfig change."""

    __slots__ = ("name", "bands", "counts", "total", "max_seen",
                 "sum_seconds")

    def __init__(self, name: str, bands: Tuple[float, ...] = DEFAULT_BANDS):
        self.name = name
        self.bands = tuple(sorted(bands))
        self.counts = [0] * len(self.bands)
        self.total = 0
        self.max_seen = 0.0
        self.sum_seconds = 0.0

    def add_threshold(self, seconds: float) -> None:
        """(ref: LatencyBands::addThreshold — reconfiguring the band
        edges resets the histogram: mixed-edge counts are meaningless)"""
        if seconds in self.bands:
            return
        bands = list(self.bands)
        insort(bands, seconds)
        self.bands = tuple(bands)
        self.clear()

    def clear(self) -> None:
        self.counts = [0] * len(self.bands)
        self.total = 0
        self.max_seen = 0.0
        self.sum_seconds = 0.0

    def record(self, seconds: float) -> None:
        self.total += 1
        self.sum_seconds += seconds   # the histogram's _sum sample
        if seconds > self.max_seen:
            self.max_seen = seconds
        for i in range(bisect_left(self.bands, seconds),
                       len(self.bands)):
            self.counts[i] += 1

    def snapshot(self) -> dict:
        return {"total": self.total,
                "max_seconds": round(self.max_seen, 6),
                "sum_seconds": round(self.sum_seconds, 6),
                "bands": {f"<={t:g}s": c
                          for t, c in zip(self.bands, self.counts)}}


class RequestLatency:
    """One request class's full latency surface: bands + reservoir with
    a single `record`. Roles keep one per request kind (grv, commit,
    resolve, read, log-commit); status folds both snapshots."""

    __slots__ = ("name", "bands", "sample")

    def __init__(self, name: str, bands: Tuple[float, ...] = DEFAULT_BANDS,
                 sample_size: int = 512):
        self.name = name
        self.bands = LatencyBands(name, bands)
        self.sample = LatencySample(name, sample_size)

    def record(self, seconds: float) -> None:
        self.bands.record(seconds)
        self.sample.record(seconds)

    def snapshot(self) -> dict:
        # one count ("total") and one max (the bands'): the sample's
        # duplicates are derivable and would silently shadow on merge
        d = self.bands.snapshot()
        s = self.sample.snapshot()
        for k in ("p50", "p90", "p99"):
            d[k] = s[k]
        return d
