"""The slice of the flow runtime the conflict-resolver data plane needs:
seeded randomness, knobs, counters, latency bands, trace events and
the flight recorder. The scheduler, futures and actors come with the
slice that ports the server roles."""

from .rng import DeterministicRandom, buggify, g_random, set_seed
from .knobs import SERVER_KNOBS, Knobs, make_server_knobs, reset_server_knobs
from .stats import Counter, CounterCollection, TimeSeries
from .latency import (DEFAULT_BANDS, LatencyBands, LatencySample,
                      RequestLatency)
from .trace import Span, g_trace_batch
from .trace import TraceEvent, g_trace, reset_trace
from .flightrec import FlightRecorder, g_flightrec
from . import trace

__all__ = [
    "DeterministicRandom", "buggify", "g_random", "set_seed",
    "SERVER_KNOBS", "Knobs", "make_server_knobs", "reset_server_knobs",
    "TraceEvent", "g_trace", "reset_trace",
    "Counter", "CounterCollection", "TimeSeries",
    "DEFAULT_BANDS", "LatencyBands", "LatencySample", "RequestLatency",
    "Span", "g_trace_batch",
    "FlightRecorder", "g_flightrec",
]
