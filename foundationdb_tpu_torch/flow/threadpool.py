"""IThreadPool: blocking-work offload for REAL deployments.

Reference: flow/IThreadPool.h + the EIO thread pool behind AsyncFileEIO
(fdbrpc/AsyncFileEIO.actor.h) — the reference never lets a blocking
syscall run on the Net2 loop; work ships to pool threads and ONLY a
completion record crosses back, drained by the main loop. Same shape
here: worker threads pull (fn, args) off a queue, post (future, result)
into a locked completion deque, and a reactor actor running on the flow
scheduler delivers them — futures are touched exclusively on the
scheduler thread, preserving the single-threaded actor model.

Wall-clock deployments only (tools/server --data-dir): the simulator
keeps its deterministic single thread and simulated disks.
"""

from __future__ import annotations

import threading
from collections import deque
from queue import Queue

from .future import Future
from .scheduler import TaskPriority, delay, spawn


class ThreadPool:
    """`run(fn, *args) -> Future` executing fn on a worker thread."""

    def __init__(self, n_threads: int = 4, name: str = "iopool"):
        self.name = name
        self._work: Queue = Queue()
        self._done: deque = deque()
        self._lock = threading.Lock()
        self._closing = False
        self._reactor_task = None
        #: futures handed out by run() and not yet delivered — close()
        #: resolves every one of them with io_error so no actor can
        #: wedge on a pool that has shut down
        self._outstanding: set = set()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"{name}-{i}")
            for i in range(n_threads)]

    def start(self) -> None:
        for t in self._threads:
            t.start()
        self._reactor_task = spawn(self._reactor(),
                                   TaskPriority.READ_SOCKET,
                                   name=f"{self.name}.reactor")

    def close(self) -> None:
        """Shut down; MUST run on the scheduler thread (it resolves
        futures). Every future run() ever handed out that has not been
        delivered — queued, mid-flight on a worker, or sitting in the
        completion queue — resolves with io_error rather than wedging
        its awaiting actor."""
        from .error import error
        self._closing = True
        for _ in self._threads:
            self._work.put(None)
        if self._reactor_task is not None:
            self._reactor_task.cancel()
        with self._lock:
            pending = list(self._outstanding)
            self._outstanding.clear()
            self._done.clear()
        for fut in pending:
            if not fut.is_ready:
                fut.send_error(error("io_error"))

    def run(self, fn, *args) -> Future:
        """Execute `fn(*args)` in the pool; the returned Future resolves
        on the scheduler thread (exceptions arrive as io_error with the
        original in the trace)."""
        fut = Future()
        if self._closing:
            from .error import error
            fut.send_error(error("io_error"))
            return fut
        with self._lock:
            self._outstanding.add(fut)
        self._work.put((fn, args, fut))
        return fut

    # -- worker threads ---------------------------------------------------
    def _worker(self) -> None:
        while True:
            item = self._work.get()
            if item is None:
                return
            fn, args, fut = item
            try:
                result = (True, fn(*args))
            except BaseException as e:  # noqa: BLE001 — ships to caller
                result = (False, e)
            with self._lock:
                self._done.append((fut, result))

    # -- scheduler-side delivery -----------------------------------------
    async def _reactor(self) -> None:
        from .error import error
        from .knobs import SERVER_KNOBS
        from .trace import SevWarnAlways, TraceEvent
        while not self._closing:
            while True:
                with self._lock:
                    item = self._done.popleft() if self._done else None
                if item is None:
                    break
                fut, (ok, value) = item
                with self._lock:
                    self._outstanding.discard(fut)
                if fut.is_ready:
                    continue   # close() already errored it
                if ok:
                    fut.send(value)
                else:
                    TraceEvent("ThreadPoolTaskError", self.name,
                               severity=SevWarnAlways).detail(
                        Error=repr(value)).log()
                    fut.send_error(error("io_error"))
            await delay(SERVER_KNOBS.tcp_reactor_poll_delay,
                        TaskPriority.READ_SOCKET)
