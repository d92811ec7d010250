"""Generic actor combinators and async containers.

Reference: flow/genericactors.actor.h (delay/timeout/getAll/AsyncVar/
AsyncTrigger), flow/flow.h:766,843 (PromiseStream/FutureStream),
fdbclient/Notified.h (NotifiedVersion), flow/ActorCollection.h.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Iterable, Optional

from .error import ActorCancelled, FdbError, error
from .future import Future, Promise, Task, error_future, ready_future
from .scheduler import TaskPriority, delay, g, spawn


def all_of(futures: Iterable[Future]) -> Future:
    """Future of list of results; errors propagate (ref: getAll)."""
    futures = list(futures)
    out = Future()
    n = len(futures)
    if n == 0:
        out.send([])
        return out
    remaining = [n]

    def on_one(f: Future):
        if out.is_ready:
            return
        if f.is_error:
            out.send_error(f.exception())
            return
        remaining[0] -= 1
        if remaining[0] == 0:
            out.send([fu.get() for fu in futures])

    for f in futures:
        f.on_ready(on_one)
    return out


def wait_for_all(futures: Iterable[Future]) -> Future:
    return all_of(futures)


def first_of(*futures: Future) -> Future:
    """Future of (index, value) of the first ready input (ref: choose/when).

    Losing inputs still pending when one wins are marked abandoned so
    a FutureStream waiter among them re-queues later deliveries instead
    of losing them (see Future.abandon)."""
    out = Future()

    def make(i):
        def cb(f: Future):
            if out.is_ready:
                return
            if f.is_error:
                out.send_error(f.exception())
            else:
                out.send((i, f.get()))
            for other in futures:
                if not other.is_ready:
                    other.abandon()
        return cb

    for i, f in enumerate(futures):
        f.on_ready(make(i))
    return out


def catch_errors(fut: Future) -> Future:
    """Future of the input future itself once settled — never errors
    (ref: genericactors errorOr / waitForAllReady): callers inspect
    is_error/get on the settled inner future."""
    out = Future()

    def on_ready(f: Future):
        if not out.is_ready:
            out.send(f)

    fut.on_ready(on_ready)
    return out


def timeout(fut: Future, seconds: float, default: Any = None,
            priority: int = TaskPriority.DEFAULT_ENDPOINT) -> Future:
    """Value of `fut`, or `default` after `seconds` (ref: genericactors timeout)."""
    out = Future()
    timer = delay(seconds, priority)

    def on_fut(f: Future):
        if out.is_ready:
            return
        timer.cancel()
        if f.is_error:
            out.send_error(f.exception())
        else:
            out.send(f.get())

    def on_timer(t: Future):
        if out.is_ready or t.is_error:
            return
        out.send(default)
        fut.abandon()  # a stream waiter must re-queue later deliveries

    fut.on_ready(on_fut)
    timer.on_ready(on_timer)
    return out


def timeout_error(fut: Future, seconds: float,
                  err_name: str = "timed_out") -> Future:
    out = Future()
    timer = delay(seconds)

    def on_fut(f: Future):
        if out.is_ready:
            return
        timer.cancel()
        if f.is_error:
            out.send_error(f.exception())
        else:
            out.send(f.get())

    def on_timer(t: Future):
        if not out.is_ready and not t.is_error:
            out.send_error(error(err_name))
            fut.abandon()

    fut.on_ready(on_fut)
    timer.on_ready(on_timer)
    return out


class AsyncVar:
    """A mutable value with change notification (ref: genericactors AsyncVar)."""

    def __init__(self, value: Any = None):
        self._value = value
        self._on_change = Promise()

    def get(self) -> Any:
        return self._value

    def set(self, value: Any) -> None:
        if value != self._value:
            self._value = value
            self.trigger()

    def trigger(self) -> None:
        p, self._on_change = self._on_change, Promise()
        p.send(None)

    def on_change(self) -> Future:
        return self._on_change.future


class AsyncTrigger:
    def __init__(self):
        self._p = Promise()

    def trigger(self) -> None:
        p, self._p = self._p, Promise()
        p.send(None)

    def on_trigger(self) -> Future:
        return self._p.future


class NotifiedVersion:
    """Versioned wait queue: when_at_least(v) (ref: fdbclient/Notified.h:28)."""

    def __init__(self, version: int = 0):
        self._version = version
        self._waiters: list[tuple[int, Future]] = []  # kept sorted by version

    def get(self) -> int:
        return self._version

    def set(self, version: int) -> None:
        if version < self._version:
            raise error("internal_error")
        self._version = version
        if self._waiters:
            still = []
            for v, f in self._waiters:
                if v <= version:
                    if not f.is_ready:
                        f.send(version)
                else:
                    still.append((v, f))
            self._waiters = still

    def when_at_least(self, version: int) -> Future:
        if self._version >= version:
            return ready_future(self._version)
        f = Future()
        self._waiters.append((version, f))
        return f

    def rollback(self, version: int) -> None:
        """Epoch recovery rewound this counter: waiters at or below the
        new value fire; higher waiters came from requests whose read
        versions the recovery invalidated — they error with
        transaction_too_old so their clients retry with a fresh snapshot
        (ref: storageserver rollback semantics)."""
        self._version = version
        waiters, self._waiters = self._waiters, []
        for v, f in waiters:
            if f.is_ready:
                continue
            if v <= version:
                f.send(version)
            else:
                f.send_error(error("transaction_too_old"))


class FutureStream:
    """Multi-value async queue, read side (ref: flow/flow.h:766)."""

    def __init__(self):
        self._queue: deque = deque()
        self._waiter: Optional[Future] = None
        self._closed: Optional[BaseException] = None

    def _push(self, value: Any) -> None:
        if (self._waiter is not None and not self._waiter.is_ready
                and not self._waiter.is_abandoned):
            w, self._waiter = self._waiter, None
            w.send(value)
        else:
            # no live waiter (none, already delivered, or abandoned by a
            # losing choose/when branch): queue, never lose the value
            if self._waiter is not None and self._waiter.is_abandoned:
                self._waiter = None
            self._queue.append(value)

    def _close(self, err: BaseException) -> None:
        self._closed = err
        if self._waiter is not None and not self._waiter.is_ready:
            w, self._waiter = self._waiter, None
            if not w.is_abandoned:
                w.send_error(err)

    def pop(self) -> Future:
        """Future of the next value (ref: waitNext)."""
        if self._queue:
            return ready_future(self._queue.popleft())
        if self._closed is not None:
            return error_future(self._closed)
        if self._waiter is None or self._waiter.is_ready:
            self._waiter = Future()
        else:
            # a new pop re-adopts a previously abandoned pending waiter
            self._waiter._abandoned = False
        return self._waiter

    def is_empty(self) -> bool:
        return not self._queue


class PromiseStream:
    """Write side (ref: flow/flow.h:843)."""

    def __init__(self):
        self.stream = FutureStream()

    def send(self, value: Any = None) -> None:
        self.stream._push(value)

    def send_error(self, err: BaseException) -> None:
        self.stream._close(err)

    def close(self) -> None:
        self.stream._close(error("end_of_stream"))


class _LockWaiter(Future):
    """Waiter future that removes itself from the lock queue when cancelled,
    so a cancelled taker cannot be granted (and leak) permits."""

    __slots__ = ("_lock", "_amount")

    def __init__(self, lock: "FlowLock", amount: int):
        super().__init__()
        self._lock = lock
        self._amount = amount

    def cancel(self) -> None:
        if not self.is_ready:
            try:
                self._lock._waiters.remove((self._amount, self))
            except ValueError:
                pass
            self.send_error(ActorCancelled())


class FlowLock:
    """Async counting semaphore (ref: flow/genericactors FlowLock)."""

    def __init__(self, permits: int = 1):
        self.permits = permits
        self.active = 0
        self._waiters: deque[tuple[int, _LockWaiter]] = deque()

    def take(self, amount: int = 1) -> Future:
        if self.active + amount <= self.permits and not self._waiters:
            self.active += amount
            return ready_future(None)
        f = _LockWaiter(self, amount)
        self._waiters.append((amount, f))
        return f

    def release(self, amount: int = 1) -> None:
        self.active -= amount
        while self._waiters:
            amt, f = self._waiters[0]
            if self.active + amt <= self.permits:
                self._waiters.popleft()
                self.active += amt
                if not f.is_ready:
                    f.send(None)
            else:
                break


class ActorCollection:
    """Holds running actors; propagates their errors (ref: flow/ActorCollection.h)."""

    def __init__(self):
        self.tasks: list[Task] = []
        self._error = Future()

    def add(self, task: Task) -> None:
        self.tasks.append(task)

        def on_done(f: Future):
            try:
                self.tasks.remove(f)
            except ValueError:
                pass
            if f.is_error and not isinstance(f.exception(), ActorCancelled) \
                    and not self._error.is_ready:
                self._error.send_error(f.exception())
        task.on_ready(on_done)

    def get_result(self) -> Future:
        """Never-ready future that errors if any member errors."""
        return self._error

    def cancel_all(self) -> None:
        # cancel() fires on_done synchronously, which mutates self.tasks —
        # iterate a snapshot.
        for t in list(self.tasks):
            t.cancel()
        self.tasks.clear()
