"""Exponential smoothing primitives for saturation telemetry.

Reference: fdbrpc/Smoother.h — the `Smoother` every Ratekeeper input
rides through (storage queue bytes, tlog queue bytes, durability lag),
and its `SmoothedRate` cousin that turns a monotone total into a
smoothed derivative. Promoted out of server/ratekeeper.py so every
role can publish smoothed QoS signals through the same math the
control loop consumes — a signal smoothed two different ways would
make the Ratekeeper argue with its own telemetry.

Time never runs backwards here: a non-increasing `now` (sim clock
replay, a duplicate tick after checkpoint restore) clamps the delta to
zero instead of amplifying the old value through a positive exponent.
"""

from __future__ import annotations

import math
from typing import Optional


def _default_tau() -> float:
    from .knobs import SERVER_KNOBS
    return float(SERVER_KNOBS.qos_smoothing_tau)


class Smoother:
    """Exponential smoothing toward the newest sample with time
    constant `tau` seconds (ref: fdbrpc/Smoother.h)."""

    __slots__ = ("_t", "value")

    def __init__(self):
        self._t = None
        self.value = 0.0

    def sample(self, x: float, now: float, tau: float) -> float:
        # tau comes in per sample so a live knob change applies to
        # existing smoothers (a frozen tau would make the knob a no-op)
        if self._t is None or tau <= 0:
            self.value = x
        else:
            # clamp dt >= 0: a non-increasing clock (sim replay /
            # duplicate tick) must decay nothing, not explode the old
            # value through exp(+dt/tau)
            dt = now - self._t
            if dt < 0.0:
                dt = 0.0
            a = math.exp(-dt / tau)
            self.value = x + (self.value - x) * a
        self._t = now
        return self.value


class SmoothedQueue:
    """A smoothed level gauge (queue bytes, lag versions, queue depth):
    `sample(value, now)` folds the newest reading through a Smoother at
    the QOS_SMOOTHING_TAU knob (or an explicit tau) and keeps the
    smoothed level in `.value`."""

    __slots__ = ("_sm", "_tau")

    def __init__(self, tau: Optional[float] = None):
        self._sm = Smoother()
        self._tau = tau  # None: read the knob per sample (live-tunable)

    @property
    def value(self) -> float:
        return self._sm.value

    def sample(self, x: float, now: float) -> float:
        return self._sm.sample(
            x, now, self._tau if self._tau is not None else _default_tau())


class SmoothedRate:
    """A smoothed derivative of a monotone counter (ref: Smoother's
    smoothRate applied to totals): feed the cumulative total at each
    sample time and read `.rate` in units/sec. A total below its
    baseline means the role restarted — the rate re-baselines instead
    of going hugely negative (the same reset rule the trace-counters
    rollup applies)."""

    __slots__ = ("_sm", "_tau", "_last_total", "_last_t")

    def __init__(self, tau: Optional[float] = None):
        self._sm = Smoother()
        self._tau = tau
        self._last_total: Optional[float] = None
        self._last_t: Optional[float] = None

    @property
    def rate(self) -> float:
        return self._sm.value

    def sample_total(self, total: float, now: float,
                     tau: Optional[float] = None) -> float:
        # per-call tau wins so callers smoothing under a different knob
        # (ratekeeper's rk_smoothing_seconds) stay live-tunable
        if tau is None:
            tau = self._tau if self._tau is not None else _default_tau()
        if self._last_total is None or total < self._last_total or \
                self._last_t is None or now <= self._last_t:
            # first sample, a counter reset, or a non-advancing clock:
            # re-baseline without fabricating a rate
            self._last_total = total
            self._last_t = now
            return self._sm.value
        inst = (total - self._last_total) / (now - self._last_t)
        self._last_total = total
        self._last_t = now
        return self._sm.sample(inst, now, tau)
