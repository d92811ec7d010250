"""Counters: rate-tracked event counters per role.

Reference: flow/Stats.actor.cpp — `Counter` (value + rolling rate +
roughness) grouped in a `CounterCollection`, traced periodically via
`traceCounters` and folded into the status document. The sim reads
them directly for status; the cluster controller's trace-counters loop
rolls every role's collection into periodic `*Metrics` TraceEvents
with per-interval rates (see CounterCollection.trace).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional

class Counter:
    __slots__ = ("name", "value", "gauge")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self.gauge = False

    def add(self, n: int = 1) -> None:
        self.value += n

    def set(self, n: int) -> None:
        """Gauge semantics (ref: TDMetric gauges beside counters).
        Marks the counter as a gauge: a level, not a flow — the
        trace-counters rollup must not derive a *_per_sec from it."""
        self.gauge = True
        self.value = n


class CounterCollection:
    """(ref: CounterCollection — named counters for one role)"""

    def __init__(self, role: str):
        self.role = role
        self.counters: Dict[str, Counter] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def snapshot(self) -> Dict[str, int]:
        return {n: c.value for n, c in self.counters.items()}

    def trace(self, id: str = "", elapsed: Optional[float] = None,
              prev: Optional[Dict[str, int]] = None) -> Dict[str, int]:
        """Roll this collection into one TraceEvent (ref: traceCounters,
        flow/Stats.actor.cpp — "ProxyMetrics"/"TLogMetrics"/... events
        carrying every counter plus its per-interval rate). `prev` is
        the previous interval's snapshot and `elapsed` the seconds since
        it was taken; returns the fresh snapshot for the caller's next
        round, so rates need no state inside the counters themselves."""
        from .trace import TraceEvent
        snap = self.snapshot()
        # role -> event prefix; "tlog".capitalize() would diverge from
        # the reference's TLogMetrics spelling
        prefix = {"tlog": "TLog"}.get(self.role, self.role.capitalize())
        ev = TraceEvent(f"{prefix}Metrics", id)
        details = dict(snap)
        if prev is not None and elapsed:
            for n, v in snap.items():
                # gauges are levels, not flows: no rate. For true
                # counters, a value below its baseline means a reset
                # (role restarted under the same name): emit no rate
                # this interval and let the fresh snapshot re-baseline,
                # instead of a large negative rate
                if self.counters[n].gauge:
                    continue
                p = prev.get(n, 0)
                if v >= p:
                    details[f"{n}_per_sec"] = round((v - p) / elapsed, 3)
        ev.detail(**details).log()
        return snap


class TimeSeries:
    """Multi-resolution time series (ref: flow/TDMetric.actor.h — a
    metric keeps LEVELS of samples, each level 4x coarser than the one
    below, so recent history is fine-grained and old history cheap).
    Level 0 holds the newest `samples_per_level` raw samples; every
    CASCADE-th append to a level emits one aggregated sample (the mean
    of the cascade window) to the level above."""

    CASCADE = 4

    __slots__ = ("samples_per_level", "levels", "_carry")

    def __init__(self, samples_per_level: int = 64, n_levels: int = 4):
        self.samples_per_level = samples_per_level
        self.levels = [deque(maxlen=samples_per_level)
                       for _ in range(n_levels)]
        self._carry = [[] for _ in range(n_levels)]

    def append(self, t: float, value: float) -> None:
        self._append_level(0, t, value)

    def _append_level(self, lvl: int, t: float, value: float) -> None:
        self.levels[lvl].append((t, value))
        if lvl + 1 >= len(self.levels):
            return
        carry = self._carry[lvl]
        carry.append((t, value))
        if len(carry) >= self.CASCADE:
            mean = sum(v for _t, v in carry) / len(carry)
            self._append_level(lvl + 1, carry[-1][0], mean)
            carry.clear()

    def series(self, level: int = 0):
        return list(self.levels[level])

    def latest(self):
        return self.levels[0][-1] if self.levels[0] else None
