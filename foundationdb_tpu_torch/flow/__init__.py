"""Deterministic actor runtime of the port (ref: flow/ — Promise/Future,
Net2, knobs, trace): the same scheduler, futures and actors as the
reference, with its own knob table and trace collector."""

from .error import ActorCancelled, FdbError, error, internal_error
from .future import Future, Promise, Task, error_future, ready_future
from .scheduler import (Scheduler, TaskPriority, WakeSignal, delay, g,
                        get_scheduler, now, set_scheduler, spawn)
from .actors import (
    ActorCollection,
    AsyncTrigger,
    AsyncVar,
    FlowLock,
    FutureStream,
    NotifiedVersion,
    PromiseStream,
    all_of,
    catch_errors,
    first_of,
    timeout,
    timeout_error,
    wait_for_all,
)
from .rng import DeterministicRandom, buggify, g_random, set_seed
from .knobs import SERVER_KNOBS, Knobs, make_server_knobs, reset_server_knobs
from .stats import Counter, CounterCollection, TimeSeries
from .smoother import Smoother, SmoothedQueue, SmoothedRate
from .latency import (DEFAULT_BANDS, LatencyBands, LatencySample,
                      RequestLatency)
from .trace import Span, g_trace_batch
from .trace import TraceEvent, g_trace, reset_trace
from .flightrec import FlightRecorder, g_flightrec
from .coverage import cover, declare
from . import coverage, trace

__all__ = [
    "ActorCancelled", "FdbError", "error", "internal_error",
    "Future", "Promise", "Task", "error_future", "ready_future",
    "Scheduler", "TaskPriority", "WakeSignal", "delay", "g",
    "get_scheduler", "now", "set_scheduler", "spawn",
    "ActorCollection", "AsyncTrigger", "AsyncVar", "FlowLock", "FutureStream",
    "NotifiedVersion", "PromiseStream", "all_of", "catch_errors",
    "first_of", "timeout",
    "timeout_error", "wait_for_all",
    "DeterministicRandom", "buggify", "g_random", "set_seed",
    "SERVER_KNOBS", "Knobs", "make_server_knobs", "reset_server_knobs",
    "TraceEvent", "g_trace", "reset_trace",
    "Counter", "CounterCollection", "TimeSeries",
    "Smoother", "SmoothedQueue", "SmoothedRate",
    "DEFAULT_BANDS", "LatencyBands", "LatencySample", "RequestLatency",
    "Span", "g_trace_batch",
    "FlightRecorder", "g_flightrec",
]
