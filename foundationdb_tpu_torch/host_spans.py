"""Host spans of the resolvers' batch path: the phases and waits inside
one `submit_arrays` (or `submit`) call, on `time.perf_counter_ns`, the
clock a device trace's marker kernels map onto the card's.

A batch is one `submit` span, begun at the clock read the call already
takes for the pipeline's submit latency. `switch(name)` ends the
current phase and starts the next at ONE clock read, so the phases tile
`submit` with no gap and no overlap (a name may recur); `switch_at`
does so at a clock read native code took on the same clock. A wait is a
child span of the phase that blocks in it; the code that blocks asks
for one only when it really waits (an event queried first). A phase's
self time is its span less the waits inside it.

Totals (ns and calls a phase, ns and count a wait) are always kept, in
lists indexed by a fixed name code. Single spans go to a preallocated
ring of `RING` slots only while `trace(True)`: (batch seq, span id,
parent id, name code, start ns, end ns), the newest kept.

Code that does not hold the resolver (the kernel profile's fence, the
pipeline's forced drains) is handed its spans, and times a wait with
`wait(spans, name)`, which times nothing where it was handed None.
"""

from __future__ import annotations

import time

PHASES = ("submit", "check", "versions", "audit", "stage", "feed", "launch",
          "readback")
WAITS = ("wait.count", "wait.sync", "wait.grow", "wait.staging",
         "wait.fence", "wait.forced_drain", "wait.readback")
NAMES = PHASES + WAITS
CODE = {n: i for i, n in enumerate(NAMES)}
SUBMIT = CODE["submit"]
# ring rows: about 10 spans a batch, so some 13,000 batches
RING = 1 << 17

_clock = time.perf_counter_ns


class _Wait:
    """One wait as a context manager: its clock reads on entry and exit."""

    __slots__ = ("spans", "code", "start")

    def __init__(self, spans: "HostSpans", code: int):
        self.spans = spans
        self.code = code

    def __enter__(self):
        self.start = self.spans._wait_start()
        return self

    def __exit__(self, *exc):
        self.spans._wait_end(self.code, self.start)


class _NoWait:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NO_WAIT = _NoWait()


def wait(spans: "HostSpans | None", name: str):
    """`spans.wait(name)`, or a context that times nothing."""
    return _NO_WAIT if spans is None else spans.wait(name)


class HostSpans:
    """One resolver's phase and wait totals, and its ring of spans."""

    __slots__ = ("ns", "calls", "wait_ns", "grows", "seq", "ring", "_n",
                 "_open", "_t0", "_sid", "_cur", "_cur_t", "_cur_id",
                 "_next_id", "_waits_open")

    def __init__(self):
        k = len(NAMES)
        self.ns = [0] * k          # a phase's span, a wait's span
        self.calls = [0] * k       # a phase's spans, a wait's count
        self.wait_ns = [0] * k     # a phase's ns spent in waits
        self.grows = 0
        self.seq = 0               # the batch seq of the last submit
        self.ring = None           # RING slots while tracing
        self._n = 0                # rows ever written to the ring
        self._open = False
        self._t0 = self._sid = self._cur = self._cur_t = self._cur_id = 0
        self._next_id = 0
        self._waits_open = []      # (span id) of the waits now open

    # -- the ring ---------------------------------------------------------
    def trace(self, on: bool = True) -> None:
        """Start (and empty) or stop the ring of single spans."""
        self.ring = [None] * RING if on else None
        self._n = 0

    def spans(self) -> list:
        """The ring's spans, oldest first: (batch seq, span id, parent id
        (-1 for none), name, start ns, end ns)."""
        if self.ring is None:
            return []
        at = self._n % RING
        rows = (self.ring[at:] + self.ring[:at] if self._n > RING
                else self.ring[:self._n])
        return [(s, i, p, NAMES[c], a, b) for s, i, p, c, a, b in rows]

    def _put(self, sid: int, parent: int, code: int, start: int,
             end: int) -> None:
        self.ring[self._n % RING] = (self.seq, sid, parent, code, start,
                                     end)
        self._n += 1

    # -- a batch ------------------------------------------------------------
    def begin(self, t0: int, seq: int, phase: str = "check") -> None:
        """Open batch `seq`'s `submit` span at `t0` (perf_counter_ns) and
        its first phase at the same instant."""
        self.seq = seq
        self._t0 = t0
        self._sid = self._next_id
        self._cur = CODE[phase]
        self._cur_t = t0
        self._cur_id = self._next_id + 1
        self._next_id += 2
        self._open = True

    def switch(self, phase: str) -> None:
        """End the current phase and start `phase` at one clock read (a
        no-op outside a batch)."""
        if self._open:
            self.switch_at(phase, _clock())

    def switch_at(self, phase: str, t: int) -> None:
        """`switch` at `t`, a perf_counter_ns reading taken since the
        current phase began (by native code: CLOCK_MONOTONIC)."""
        if self._open:
            c = self._cur
            self.ns[c] += t - self._cur_t
            self.calls[c] += 1
            if self.ring is not None:
                self._put(self._cur_id, self._sid, c, self._cur_t, t)
            self._cur = CODE[phase]
            self._cur_t = t
            self._cur_id = self._next_id
            self._next_id += 1

    def _close(self, t: int) -> None:
        c = self._cur
        self.ns[c] += t - self._cur_t
        self.calls[c] += 1
        if self.ring is not None:
            self._put(self._cur_id, self._sid, c, self._cur_t, t)

    def end(self) -> None:
        """Close the current phase and the `submit` span."""
        t = _clock()
        self._close(t)
        self.ns[SUBMIT] += t - self._t0
        self.calls[SUBMIT] += 1
        if self.ring is not None:
            self._put(self._sid, -1, SUBMIT, self._t0, t)
        self._leave()

    def abort(self) -> None:
        """Drop the open batch (its call raised): nothing of it counts."""
        self._leave()

    def _leave(self) -> None:
        self._open = False
        self._waits_open.clear()

    # -- waits --------------------------------------------------------------
    def wait(self, name: str) -> _Wait:
        return _Wait(self, CODE[name])

    def _wait_start(self) -> int:
        self._waits_open.append(self._next_id)
        self._next_id += 1
        return _clock()

    def _wait_end(self, code: int, start: int) -> None:
        t = _clock()
        dt = t - start
        sid = self._waits_open.pop() if self._waits_open else -1
        self.ns[code] += dt
        self.calls[code] += 1
        if code == CODE["wait.grow"]:
            self.grows += 1
        if self._open:
            if self._waits_open:            # inside another wait
                parent = self._waits_open[-1]
            else:
                parent = self._cur_id
                self.wait_ns[self._cur] += dt
                self.wait_ns[SUBMIT] += dt
        else:
            parent = -1
        if self.ring is not None:
            self._put(sid, parent, code, start, t)

    # -- totals -------------------------------------------------------------
    def stats(self) -> dict:
        """Totals for `kernel_stats()["host"]`: each phase's ns, calls
        and ns in waits (`submit`'s: every wait inside it), each wait's
        ns and count, and the growths."""
        return {"phases": {n: {"ns": self.ns[i], "calls": self.calls[i],
                               "wait_ns": self.wait_ns[i]}
                           for i, n in enumerate(PHASES)},
                "waits": {n: {"ns": self.ns[CODE[n]],
                              "count": self.calls[CODE[n]]}
                          for n in WAITS},
                "grows": self.grows}
