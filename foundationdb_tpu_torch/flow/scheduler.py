"""Deterministic event loop with task priorities and virtual time.

Reference: flow/Net2.actor.cpp (`Net2::run` :558, ready/timer queues
:183-191) and flow/network.h:33-76 (numeric task priorities). Unlike the
reference, virtual time is the *default* — the deterministic simulator is
the primary runtime (ref: fdbrpc/sim2.actor.cpp), and wall-clock execution
is a mode layered on top.

Determinism contract: given the same seed and the same spawn/send sequence,
the loop executes steps in an identical order. Ready tasks run
highest-priority first, FIFO within a priority; timers fire in (time, seq)
order; time advances only when no task is ready.
"""

from __future__ import annotations

import heapq
import time as _time
from bisect import bisect_right
from typing import Any, Coroutine, Optional

from .error import FdbError, error
from .future import Future, Task

# Task priorities (ref: flow/network.h:33-76). Higher runs first.
class TaskPriority:
    MAX = 1000000
    RUN_LOOP = 30000
    WRITE_SOCKET = 10000
    READ_SOCKET = 9000
    COORDINATION_REPLY = 8810
    COORDINATION = 8800
    FAILURE_MONITOR = 8700
    RESOLUTION_METRICS = 8700
    CLUSTER_CONTROLLER = 8650
    PROXY_COMMIT_DISPATCH = 8640
    TLOG_QUEUING_METRICS = 8620
    TLOG_POP = 8610
    TLOG_PEEK_REPLY = 8600
    TLOG_PEEK = 8590
    TLOG_COMMIT_REPLY = 8580
    TLOG_COMMIT = 8570
    PROXY_GET_RAW_COMMITTED_VERSION = 8565
    PROXY_RESOLVER_REPLY = 8560
    PROXY_COMMIT_BATCHER = 8550
    PROXY_COMMIT = 8540
    TLOG_CONFIRM_RUNNING_REPLY = 8530
    TLOG_CONFIRM_RUNNING = 8520
    PROXY_GRV_TIMER = 8510
    PROXY_GET_CONSISTENT_READ_VERSION = 8500
    DISK_IO_LATENCY = 8100
    DEFAULT_PROMISE_ENDPOINT = 8000
    DEFAULT_ON_MAIN_THREAD = 7500
    DEFAULT_ENDPOINT = 7000
    UNKNOWN_ENDPOINT = 6000
    MOVE_KEYS = 3550
    DATA_DISTRIBUTION_LAUNCH = 3530
    RATEKEEPER = 3510
    DATA_DISTRIBUTION = 3500
    STORAGE = 3000
    UPDATE_STORAGE = 3000
    LOW_PRIORITY = 2000
    ZERO = 0


# Priority bands for the task-stats rollup: every named TaskPriority
# level, deduplicated (first name wins for aliases like
# STORAGE/UPDATE_STORAGE) and sorted ascending. A step's band is the
# highest named level at or below its popped priority, so custom
# priorities between levels fold into the level they outrank.
def _build_priority_bands():
    seen: dict = {}
    for n, v in vars(TaskPriority).items():
        if not n.startswith("_") and isinstance(v, int):
            seen.setdefault(v, n.lower())
    return sorted(seen.items())


_PRIORITY_BANDS = _build_priority_bands()
_PRIORITY_BAND_KEYS = [v for v, _n in _PRIORITY_BANDS]


def priority_band(priority: int) -> str:
    """The named TaskPriority band a numeric priority rolls up into."""
    i = bisect_right(_PRIORITY_BAND_KEYS, priority) - 1
    return _PRIORITY_BANDS[max(i, 0)][1]


# steps per coarse busy-accounting window (see Scheduler._flush_coarse)
_COARSE_WINDOW = 4096


class WakeSignal:
    """Coalesced-timer helper for periodic run loops (the sim-perf
    plane's top band was fixed-interval polling loops ticking through
    empty queues). A loop that would otherwise poll
    every interval parks on the signal while its queues are empty and
    is resumed by the producer's ``touch()``:

        while True:
            if queue_empty:
                await signal.wait_beyond(signal.count)
            await flow.delay(interval, prio)
            ... drain ...

    ``touch()`` is O(1) and allocation-free when nothing is parked (the
    hot producer path pays a counter bump and an empty-list check);
    parking allocates one Future per idle period, not per interval.
    Waiters resume through the ordinary ready queue at their task
    priority, so adopting the helper never reorders a loop relative to
    the priority band it already ran in."""

    __slots__ = ("_count", "_waiters")

    def __init__(self):
        self._count = 0
        self._waiters: list = []

    @property
    def count(self) -> int:
        """Monotone touch counter — snapshot before parking."""
        return self._count

    def touch(self) -> None:
        """Record one producer event and wake every parked waiter."""
        self._count += 1
        if self._waiters:
            waiters, self._waiters = self._waiters, []
            for f in waiters:
                if not f.is_ready:
                    f.send(None)

    def wait_beyond(self, seen: int) -> Future:
        """Future that is ready once ``count`` exceeds `seen` (already
        ready if it has). The caller re-checks its own queues after the
        wait — a wake is a hint, not a handoff."""
        if self._count > seen:
            f = Future()
            f.send(None)
            return f
        f = Future()
        self._waiters.append(f)
        return f


class _TimerCall:
    """A heap entry that runs a plain callback when its deadline fires
    — the allocation-lean alternative to a _TimerFuture + on_ready
    closure for fire-and-forget deadlines (the sim network's delivery
    timers). Quacks like an unready Future so the timer pump needs no
    extra branch."""

    __slots__ = ("fn", "args")
    is_ready = False

    def __init__(self, fn, args):
        self.fn = fn
        self.args = args

    def send(self, _value) -> None:
        self.fn(*self.args)


_knobs = None    # cached handle: the slow-task threshold is read per
                 # step and must not pay the import machinery each time


def _slow_task_threshold_knob() -> float:
    """The SLOW_TASK_THRESHOLD knob, read live (operators flip it at
    runtime); only the module lookup is cached — same idiom as the
    trace severity floor."""
    global _knobs
    if _knobs is None:
        try:
            from .knobs import SERVER_KNOBS
        except Exception:
            return 0.05
        _knobs = SERVER_KNOBS
    return float(_knobs.slow_task_threshold)


class Scheduler:
    """Single-threaded deterministic run loop (Net2 + sim2 in one).

    ``virtual=True`` (default): time advances instantly to the next timer —
    whole-system simulation. ``virtual=False``: timers wait on the wall
    clock (for real deployments/benchmarks).
    """

    def __init__(self, start_time: float = 0.0, virtual: bool = True):
        self._now = start_time
        self.virtual = virtual
        # Maps the virtual timeline onto the wall clock for virtual=False:
        # wall_time_of(t) = _wall_anchor + t.
        self._wall_anchor = _time.monotonic() - start_time
        self._ready: list = []  # heap of (-priority, seq, fn, args)
        self._timers: list = []  # heap of (time, seq, promise)
        self._seq = 0
        self._current_task: Optional[Task] = None
        self._stopped = False
        self.tasks_run = 0
        # run-loop profiler (ref: flow/Profiler.actor.cpp + Net2's slow-
        # task sampling): wall seconds spent executing steps, and the
        # worst offenders over the threshold. None follows the
        # SLOW_TASK_THRESHOLD knob live; an explicit value (tests, the
        # cli) pins it for this scheduler. A threshold of 0 disables
        # slow-task sampling entirely (it used to flag EVERY step).
        self._busy_accum = 0.0
        self.slow_task_threshold: Optional[float] = None
        self.slow_task_count = 0       # total steps over the threshold
        self.slow_tasks: list = []     # (name, seconds, suspension
        #                                stack), worst kept
        # coarse busy accounting: with every profiling consumer off
        # (no task stats, threshold 0) the loop skips the per-step
        # monotonic() pair and instead times windows of up to
        # _COARSE_WINDOW steps — two clock reads per window instead of
        # two per step — flushed whenever busy_seconds is read, the
        # loop idles/sleeps, or run() exits (so wall time spent OUTSIDE
        # the loop never counts as busy)
        self._coarse_anchor: Optional[float] = None
        self._coarse_steps = 0
        # on-demand sampling profiler (ref: flow/Profiler.actor.cpp —
        # the SIGPROF stack sampler, expressed cooperatively: every
        # Nth task step records the task's coroutine suspension stack)
        self._profile_every = 0        # 0 = off
        self._profile_samples: dict = {}
        self._profile_countdown = 0
        # per-task attribution plane (SIM_TASK_STATS: profile the run
        # loop before refactoring it): armed via
        # start_task_stats(), each step folds its wall µs into a
        # BOUNDED per-task-name table plus a per-TaskPriority-band
        # rollup. None = off (the default posture pays nothing here).
        self._task_stats: Optional[dict] = None  # name -> [steps, µs, max µs]
        self._task_stats_max = 256
        self._band_stats: dict = {}    # band -> [steps, µs]
        self._band_cache: dict = {}    # priority int -> band name
        self.task_stats_dropped = 0    # folds routed to "(other)"
        self._fold_cache: dict = {}    # raw task name -> folded family
        self._frame_cache: dict = {}   # code object @ lineno -> frame str

    # -- time ---------------------------------------------------------------
    def now(self) -> float:
        return self._now

    # -- busy accounting -----------------------------------------------------
    @property
    def busy_seconds(self) -> float:
        """Wall seconds the loop spent executing steps. Fine-grained
        (per step) while a profiling consumer is armed; coarse
        (windowed) otherwise — reading it flushes any open window."""
        if self._coarse_anchor is not None:
            self._flush_coarse()
        return self._busy_accum

    @busy_seconds.setter
    def busy_seconds(self, value: float) -> None:
        self._coarse_anchor = None
        self._coarse_steps = 0
        self._busy_accum = value

    def _flush_coarse(self) -> None:
        a = self._coarse_anchor
        if a is not None:
            self._busy_accum += _time.monotonic() - a
            self._coarse_anchor = None
            self._coarse_steps = 0

    # -- spawning -----------------------------------------------------------
    def spawn(self, coro: Coroutine, priority: int = TaskPriority.DEFAULT_ENDPOINT,
              name: str = "") -> Task:
        """Start an actor; returns its Task (a Future of the return value)."""
        t = Task(coro, self, priority, name)
        self._schedule_step(t, None, None)
        return t

    def _schedule_step(self, task: Task, value, exc, priority: Optional[int] = None) -> None:
        self._seq += 1
        if priority is None:
            priority = task.priority
        heapq.heappush(self._ready, (-priority, self._seq, task, value, exc))

    def call_at_priority(self, priority: int, fn, *args) -> None:
        """Run a plain callable from the loop at the given priority."""
        async def _runner():
            fn(*args)
        self.spawn(_runner(), priority, name=getattr(fn, "__name__", "call"))

    # -- timers -------------------------------------------------------------
    def delay(self, seconds: float, priority: int = TaskPriority.DEFAULT_ENDPOINT) -> Future:
        """Future that becomes ready `seconds` from now (ref: flow delay())."""
        if seconds < 0:
            seconds = 0.0
        f = _TimerFuture(self, priority)
        f.resume_priority = priority  # waiter resumes at the delay's priority
        self._seq += 1
        entry = (self._now + seconds, self._seq, f)
        f._entry = entry
        heapq.heappush(self._timers, entry)
        return f

    def yield_now(self, priority: int = TaskPriority.DEFAULT_ENDPOINT) -> Future:
        return self.delay(0.0, priority)

    def call_at(self, seconds: float, fn, *args) -> None:
        """Run `fn(*args)` when the deadline fires, straight from the
        timer pump — no Future, no waiter, no closure. The lean path
        for fire-and-forget deadlines (per-message delivery timers):
        ordering relative to delay() timers is identical (one shared
        (time, seq) heap), and the callback runs at the same point the
        equivalent _TimerFuture's on_ready callbacks would have."""
        if seconds < 0:
            seconds = 0.0
        self._seq += 1
        heapq.heappush(self._timers,
                       (self._now + seconds, self._seq, _TimerCall(fn, args)))

    # -- run loop -----------------------------------------------------------
    def _run_one(self, max_time: Optional[float] = None) -> bool:
        """Execute one step. Returns False when no work remains (or none
        before `max_time` — virtual time then rests at `max_time`)."""
        # Fire all timers due at or before now.
        while self._timers and (self._timers[0][0] <= self._now or not self._ready):
            if self._timers[0][0] > self._now:
                if self._ready:
                    break
                # advance time
                t = self._timers[0][0]
                if max_time is not None and t > max_time:
                    if not self.virtual:
                        self._flush_coarse()
                        _time.sleep(max(
                            0.0, (self._wall_anchor + max_time) - _time.monotonic()))
                    self._now = max_time  # deadline reached before any work
                    return False
                if not self.virtual:
                    self._flush_coarse()  # sleeping is not busy time
                    _time.sleep(max(0.0, (self._wall_anchor + t) - _time.monotonic()))
                self._now = t
            _, _, fut = heapq.heappop(self._timers)
            if not fut.is_ready:
                fut.send(None)
        if not self._ready:
            self._flush_coarse()   # the loop is about to go idle
            return False
        neg_prio, _, task, value, exc = heapq.heappop(self._ready)
        self.tasks_run += 1
        if self._profile_every:
            self._profile_countdown -= 1
            if self._profile_countdown <= 0:
                self._profile_countdown = self._profile_every
                self._profile_sample(task)
        stats = self._task_stats
        thr = self.slow_task_threshold
        if thr is None:
            thr = _slow_task_threshold_knob()
        if stats is None and thr <= 0.0:
            # every profiling consumer is off: skip the per-step
            # monotonic() pair — busy time accrues through the coarse
            # window (two clock reads per _COARSE_WINDOW steps)
            if self._coarse_anchor is None:
                self._coarse_anchor = _time.monotonic()
            task._step(value, exc)
            self._coarse_steps += 1
            if self._coarse_steps >= _COARSE_WINDOW:
                self._flush_coarse()
            return True
        self._flush_coarse()   # a mid-window arm must not double-count
        t0 = _time.monotonic()
        task._step(value, exc)
        dt = _time.monotonic() - t0
        self._busy_accum += dt
        if stats is not None:
            self._fold_task_stat(task, -neg_prio, dt)
        if thr > 0.0 and dt >= thr:
            # a step that hogs the loop starves every other actor — the
            # reference's slow-task profiler samples exactly this
            name = getattr(task, "name", "") or "?"
            # the coroutine is suspended at its next await (or done):
            # the suspension stack names the code location of the hog,
            # not just the actor label
            stack = self._suspension_stack(task)
            self.slow_task_count += 1
            self.slow_tasks.append((name, dt, stack))
            if len(self.slow_tasks) > 32:
                self.slow_tasks = sorted(
                    self.slow_tasks, key=lambda s: -s[1])[:16]
            from .trace import SevWarn
            from . import trace as _trace
            _trace.g_trace.emit({
                "Type": "SlowTask", "Severity": SevWarn,
                "Machine": "runloop", "TaskName": name,
                "Seconds": round(dt, 4),
                "ElapsedUs": int(dt * 1e6),
                "Stack": stack})
        return True

    def run(self, until: Optional[Future] = None, timeout_time: Optional[float] = None) -> Any:
        """Run until `until` is ready (returning its value), or until idle.

        Raises ``timed_out`` if virtual time passes `timeout_time` first, and
        ``operation_failed`` on deadlock (until-future pending but no work).
        """
        try:
            while not self._stopped:
                if until is not None and until.is_ready:
                    return until.get()
                if timeout_time is not None and self._now >= timeout_time:
                    raise error("timed_out")
                if not self._run_one(max_time=timeout_time):
                    if timeout_time is not None and \
                            self._now >= timeout_time:
                        raise error("timed_out")
                    break
        finally:
            # close any open coarse window: wall time between run()
            # calls must never read as loop busy time
            self._flush_coarse()
        if until is not None:
            if until.is_ready:
                return until.get()
            raise FdbError("operation_failed", 1000,
                           "simulation deadlock: awaited future never became ready")
        return None

    def stop(self) -> None:
        self._stopped = True

    # -- per-task attribution (SIM_TASK_STATS) ------------------------------
    def start_task_stats(self, max_names: Optional[int] = None) -> None:
        """Arm per-task run-loop accounting: every step folds its wall
        µs into a bounded per-task-name table (trailing digits collapse
        — `storm-txn-17` folds into `storm-txn-*`) and a per-
        TaskPriority-band rollup. Costless until armed."""
        if max_names is None:
            try:
                from .knobs import SERVER_KNOBS
                max_names = int(SERVER_KNOBS.sim_task_stats_max_names)
            except Exception:
                max_names = 256
        self._task_stats_max = max(1, max_names)
        self._task_stats = {}
        self._band_stats = {}
        self._band_cache = {}
        self.task_stats_dropped = 0

    @property
    def task_stats_armed(self) -> bool:
        return self._task_stats is not None

    def stop_task_stats(self) -> dict:
        """Disarm and return the final report."""
        report = self.task_stats_report()
        self._task_stats = None
        return report

    def _fold_task_stat(self, task, priority: int, dt: float) -> None:
        st = self._task_stats
        raw = getattr(task, "name", "") or "?"
        # the rstrip + compare per step adds up at 10^5 steps/sec; raw
        # names repeat heavily (pooled actors, role loops), so the
        # folded family is memoized (bounded: one-shot names fold to a
        # small family set, but a pathological namer must not grow it)
        name = self._fold_cache.get(raw)
        if name is None:
            base = raw.rstrip("0123456789")
            # indexed spawns fold into one family
            name = base + "*" if base != raw else raw
            if len(self._fold_cache) >= 4096:
                self._fold_cache.clear()
            self._fold_cache[raw] = name
        rec = st.get(name)
        if rec is None:
            if len(st) >= self._task_stats_max:
                # bounded table: late-arriving names share one bucket
                self.task_stats_dropped += 1
                name = "(other)"
                rec = st.get(name)
            if rec is None:
                st[name] = rec = [0, 0.0, 0.0]
        us = dt * 1e6
        rec[0] += 1
        rec[1] += us
        if us > rec[2]:
            rec[2] = us
        band = self._band_cache.get(priority)
        if band is None:
            band = self._band_cache[priority] = priority_band(priority)
        brec = self._band_stats.get(band)
        if brec is None:
            self._band_stats[band] = brec = [0, 0.0]
        brec[0] += 1
        brec[1] += us

    def task_stats_report(self, top_k: Optional[int] = None) -> dict:
        """-> {armed, tasks: [{task, steps, busy_us, max_us}] (busiest
        first), bands: [{band, steps, busy_us}], dropped_names}."""
        tasks = [{"task": n, "steps": r[0], "busy_us": round(r[1], 1),
                  "max_us": round(r[2], 1)}
                 for n, r in (self._task_stats or {}).items()]
        tasks.sort(key=lambda row: (-row["busy_us"], row["task"]))
        if top_k is not None:
            tasks = tasks[:top_k]
        bands = [{"band": b, "steps": r[0], "busy_us": round(r[1], 1)}
                 for b, r in sorted(self._band_stats.items(),
                                    key=lambda kv: (-kv[1][1], kv[0]))]
        return {"armed": int(self._task_stats is not None),
                "tasks": tasks, "bands": bands,
                "dropped_names": self.task_stats_dropped}

    # -- sampling profiler --------------------------------------------------
    def _frame_walk(self, task) -> list:
        """The coroutine suspension stack, innermost last — shared by
        the sampling profiler and the SlowTask capture."""
        frames = []
        coro = getattr(task, "_coro", None)
        depth = 0
        cache = self._frame_cache
        while coro is not None and depth < 32:
            frame = getattr(coro, "cr_frame", None)
            if frame is None:
                break
            code = frame.f_code
            # suspension points repeat across samples: memoize the
            # formatted frame per (code, lineno) so the sampling
            # profiler stops re-rendering the same few hot locations
            key = (code, frame.f_lineno)
            s = cache.get(key)
            if s is None:
                if len(cache) >= 4096:
                    cache.clear()
                s = cache[key] = (
                    f"{code.co_name} "
                    f"({code.co_filename.rsplit('/', 1)[-1]}"
                    f":{frame.f_lineno})")
            frames.append(s)
            coro = getattr(coro, "cr_await", None)
            depth += 1
        return frames

    def _suspension_stack(self, task) -> str:
        return " <- ".join(reversed(self._frame_walk(task))) or "?"

    def _profile_sample(self, task) -> None:
        key = (getattr(task, "name", "") or "?",
               self._suspension_stack(task))
        self._profile_samples[key] = self._profile_samples.get(key, 0) + 1

    def start_profiler(self, sample_every: int = 16) -> None:
        """Sample every Nth task step until stop_profiler() (ref: the
        on-demand ProfilerRequest turning SIGPROF sampling on)."""
        self._profile_every = max(1, sample_every)
        self._profile_countdown = 1
        self._profile_samples = {}

    def stop_profiler(self) -> list:
        """-> [{task, stack, samples}] sorted by sample count."""
        self._profile_every = 0
        out = [{"task": t, "stack": st, "samples": n}
               for (t, st), n in self._profile_samples.items()]
        out.sort(key=lambda e: -e["samples"])
        return out

    def profile_folded(self) -> str:
        """The sampling profiler's stacks in collapsed/folded format
        (`frame;frame;frame count`, root first — flamegraph.pl /
        speedscope ready). The display stacks read leaf-first
        ("inner <- outer"), so they re-reverse here. Frames are
        space-stripped: the folded format splits the trailing count
        on whitespace."""
        lines = []
        for (t, st), n in sorted(self._profile_samples.items()):
            frames = [t.replace(" ", "").replace(";", ":") or "?"]
            if st != "?":
                frames.extend(f.strip().replace(" ", "")
                              .replace(";", ":")
                              for f in reversed(st.split(" <- ")))
            lines.append(";".join(frames) + f" {n}")
        return "\n".join(lines)


class _TimerFuture(Future):
    __slots__ = ("_sched", "_entry", "resume_priority")

    def __init__(self, sched: Scheduler, priority: int):
        super().__init__()
        self._sched = sched
        self._entry = None
        self.resume_priority = priority

    def cancel(self) -> None:
        if not self.is_ready:
            self.send_error(FdbError("operation_cancelled", 1101))


# --- ambient scheduler -----------------------------------------------------
# One active scheduler per THREAD (like g_network): the simulator owns
# its thread's loop, while an out-of-process client (client/remote.py)
# may host a second wall-clock loop on its own thread in the same
# process without clobbering the sim's.
import threading as _threading


class _Ambient(_threading.local):
    current: Optional[Scheduler] = None


_tls = _Ambient()


def set_scheduler(s: Optional[Scheduler]) -> None:
    _tls.current = s


def get_scheduler() -> Optional[Scheduler]:
    """The thread's ambient scheduler, or None — the save half of the
    save/restore discipline tools hosting their OWN loop must follow
    (tools/networktest.py, tools/clusterbench.py): a tool that leaves
    its private scheduler installed corrupts whatever flow-driven
    caller invoked it."""
    return _tls.current


def g() -> Scheduler:
    if _tls.current is None:
        raise error("internal_error")
    return _tls.current


def now() -> float:
    return g().now()


def delay(seconds: float, priority: int = TaskPriority.DEFAULT_ENDPOINT) -> Future:
    return g().delay(seconds, priority)


def spawn(coro, priority: int = TaskPriority.DEFAULT_ENDPOINT, name: str = "") -> Task:
    return g().spawn(coro, priority, name)
