"""Single-assignment async values and actor tasks.

Reference: flow/flow.h — `SAV<T>` (:352), `Future<T>` (:596), `Promise<T>`
(:715), `Actor<T>` (:920). Re-designed for Python: actors are ``async def``
coroutines awaiting :class:`Future` objects; a :class:`Task` drives a
coroutine and is itself a Future of the actor's return value.

Unlike asyncio, everything here is deterministic: continuations are resumed
through the scheduler's priority queues in a fixed order, and time is
virtual by default (the simulator *is* the runtime, as in the reference's
sim2 design).
"""

from __future__ import annotations

from typing import Any, Callable, Generator, Optional

from .error import ActorCancelled, FdbError, error

_PENDING = 0
_VALUE = 1
_ERROR = 2


class Future:
    """A single-assignment asynchronous value (ref: flow/flow.h:352 SAV).

    Becomes ready exactly once, with either a value or an error. Callbacks
    registered via :meth:`on_ready` fire when the future becomes ready (in
    registration order, synchronously from :meth:`send`).
    """

    __slots__ = ("_state", "_result", "_callbacks", "_abandoned")

    def __init__(self):
        self._state = _PENDING
        self._result: Any = None
        self._callbacks: Optional[list] = None
        self._abandoned = False

    # -- inspection ---------------------------------------------------------
    @property
    def is_ready(self) -> bool:
        return self._state != _PENDING

    @property
    def is_error(self) -> bool:
        return self._state == _ERROR

    def get(self) -> Any:
        """Return the value; raises if not ready or completed with an error."""
        if self._state == _VALUE:
            return self._result
        if self._state == _ERROR:
            raise self._result
        raise error("future_released")

    def exception(self) -> Optional[BaseException]:
        return self._result if self._state == _ERROR else None

    # -- completion ---------------------------------------------------------
    def send(self, value: Any = None) -> None:
        if self._state != _PENDING:
            raise error("internal_error")
        self._state = _VALUE
        self._result = value
        self._fire()

    def send_error(self, err: BaseException) -> None:
        if self._state != _PENDING:
            raise error("internal_error")
        self._state = _ERROR
        self._result = err
        self._fire()

    def _fire(self) -> None:
        cbs, self._callbacks = self._callbacks, None
        if cbs:
            for cb in cbs:
                cb(self)

    def on_ready(self, cb: Callable[["Future"], None]) -> None:
        if self._state != _PENDING:
            cb(self)
        elif self._callbacks is None:
            self._callbacks = [cb]
        else:
            self._callbacks.append(cb)

    def remove_callback(self, cb) -> None:
        if self._callbacks is not None:
            try:
                self._callbacks.remove(cb)
            except ValueError:
                pass

    # -- awaiting -----------------------------------------------------------
    def __await__(self) -> Generator["Future", None, Any]:
        if self._state == _PENDING:
            yield self  # Task picks this up and subscribes
        if self._state == _ERROR:
            raise self._result
        return self._result

    def cancel(self) -> None:
        """Cancel the computation producing this future (no-op for plain futures)."""

    # -- abandonment ---------------------------------------------------------
    # The reference's choose/when unhooks losing callbacks from a stream
    # before any value can be delivered into them; combinators here mark
    # losing branches "abandoned" instead, and FutureStream re-queues a
    # value rather than deliver it into an abandoned waiter (otherwise a
    # commit request racing a batch deadline is silently lost).
    def abandon(self) -> None:
        """Declare that no one will consume this future's value."""
        self._abandoned = True

    @property
    def is_abandoned(self) -> bool:
        return self._abandoned


def ready_future(value: Any = None) -> Future:
    f = Future()
    f.send(value)
    return f


def error_future(err: BaseException) -> Future:
    f = Future()
    f.send_error(err)
    return f


class Promise:
    """The write side of a Future (ref: flow/flow.h:715).

    Dropping a Promise without sending breaks the future with
    ``broken_promise``; call :meth:`drop` explicitly for that behavior.
    """

    __slots__ = ("future",)

    def __init__(self):
        self.future = Future()

    def send(self, value: Any = None) -> None:
        self.future.send(value)

    def send_error(self, err: BaseException) -> None:
        self.future.send_error(err)

    @property
    def is_set(self) -> bool:
        return self.future.is_ready

    def drop(self) -> None:
        if not self.future.is_ready:
            self.future.send_error(error("broken_promise"))


class Task(Future):
    """Drives an actor coroutine; IS the future of its return value.

    Ref: flow/flow.h:920 `Actor<ReturnValue> : SAV<ReturnValue>` — the
    compiled actor object is both the state machine and the result.
    """

    __slots__ = ("_coro", "_sched", "priority", "_waiting_on", "_resume_cb", "name")

    def __init__(self, coro, scheduler, priority: int, name: str = ""):
        super().__init__()
        self._coro = coro
        self._sched = scheduler
        self.priority = priority
        self._waiting_on: Optional[Future] = None
        self._resume_cb = None
        self.name = name or getattr(coro, "__name__", "actor")

    def _step(self, value: Any = None, exc: Optional[BaseException] = None) -> None:
        self._waiting_on = None
        self._resume_cb = None
        if self.is_ready:  # cancelled while queued
            self._coro.close()
            return
        prev = self._sched._current_task
        self._sched._current_task = self
        try:
            if exc is not None:
                waiting = self._coro.throw(exc)
            else:
                waiting = self._coro.send(value)
        except StopIteration as e:
            if not self.is_ready:
                self.send(e.value)
            return
        except ActorCancelled as e:
            if not self.is_ready:
                self.send_error(e)
            return
        except BaseException as e:  # noqa: BLE001 - actor errors flow into the future
            if not self.is_ready:
                self.send_error(e)
            return
        finally:
            self._sched._current_task = prev
        # The coroutine yielded a Future it is waiting on.
        self._waiting_on = waiting
        self._resume_cb = cb = self._make_resume(waiting)
        waiting.on_ready(cb)

    def _make_resume(self, fut: Future):
        def cb(f: Future, self=self):
            # Resume through the scheduler ready queue (deterministic order,
            # bounded stack depth). A delay() future carries the priority its
            # waiter should resume at (ref: delay(t, taskID) semantics);
            # otherwise the task's own priority applies.
            self._waiting_on = None  # now queued, not waiting: see cancel()
            self._resume_cb = None
            prio = getattr(f, "resume_priority", None)
            if prio is None:
                prio = self.priority
            if f._state == _ERROR:
                self._sched._schedule_step(self, None, f._result, prio)
            else:
                self._sched._schedule_step(self, f._result, None, prio)
        return cb

    def cancel(self) -> None:
        """Cancel the actor (ref: Actor::cancel — actor_cancelled is thrown at the wait point)."""
        if self.is_ready:
            return
        if self._waiting_on is not None:
            w, cb = self._waiting_on, self._resume_cb
            self._waiting_on = None
            self._resume_cb = None
            w.remove_callback(cb)
            # Cancel downstream only if nobody else is waiting on it (ref:
            # flow cancels an actor when the *last* Future reference drops).
            if not w._callbacks:
                w.cancel()
            self._step(exc=ActorCancelled())
        else:
            # Running or queued: mark done; _step will close the coroutine.
            self.send_error(ActorCancelled())
