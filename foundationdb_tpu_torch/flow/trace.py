"""Structured trace events.

Reference: flow/Trace.h:140 (`TraceEvent(severity, name, id).detail(...)`),
FileTraceLogWriter / JsonTraceLogFormatter. Events are structured dicts
collected in-memory (for tests/simulation) and optionally streamed to a
JSON-lines file (the reference's JSON trace format). `TraceBatch` keeps
the cross-role commit-debug stitching for sampled transactions, and the
span layer on top of it (`Span` / `begin_span`) reassembles one sampled
commit's full proxy -> resolver -> tlog path as a parented tree (ref:
flow/Tracing.h Span + the g_traceBatch commit-debug locations).
"""

from __future__ import annotations

import atexit
import json
from typing import Any, Optional

from .flightrec import g_flightrec as _flightrec

SevDebug = 5
SevInfo = 10
SevWarn = 20
SevWarnAlways = 30
SevError = 40


def _now() -> float:
    """Event timestamp. The reference stamps the flow scheduler's
    virtual clock; the port has no scheduler yet, so every event is
    stamped 0.0 (the reference's value when no scheduler runs)."""
    return 0.0


_knobs = None    # cached knobs handle: suppression must not pay the
                 # import machinery per event in hot loops


def _severity_floor() -> int:
    """Events below this severity are dropped at construction — the
    cheap filter hot loops rely on (ref: the trace file's minimum
    severity, flow/Trace.cpp suppression). The knob is read live (tests
    and operators flip it at runtime); only the module lookup is
    cached."""
    global _knobs
    if _knobs is None:
        try:
            from .knobs import SERVER_KNOBS
        except Exception:
            return 0
        _knobs = SERVER_KNOBS
    return int(_knobs.trace_severity_min)


def _roll_size_knob() -> int:
    """Max trace-file bytes before a roll (ref: FDB's trace_roll_size,
    10 MB by default — FileTraceLogWriter renames the full file and
    starts a fresh one). Same cached-handle live read as the severity
    floor; 0 disables rolling."""
    global _knobs
    if _knobs is None:
        try:
            from .knobs import SERVER_KNOBS
        except Exception:
            return 0
        _knobs = SERVER_KNOBS
    return int(_knobs.trace_roll_size)


def trace_json_escape(value):
    """``json.dumps`` fallback for TraceEvent fields that are not JSON
    types. Detail values routinely carry raw KEYS — arbitrary bytes,
    not UTF-8 — and an event line that fails to serialize (or writes a
    broken line) poisons the whole JSON-lines stream for every
    downstream parser. Bytes render with the \\xNN convention the cli
    uses for keys (printable ASCII stays readable); anything else
    falls back to repr. Always returns a str, so every event line is
    valid JSON no matter what a detail() call was handed."""
    if isinstance(value, (bytes, bytearray)):
        return "".join(chr(c) if 32 <= c < 127 and c != 0x5C
                       else f"\\x{c:02x}" for c in bytes(value))
    return repr(value)


class TraceCollector:
    def __init__(self, path: Optional[str] = None, keep_in_memory: int = 10000,
                 roll_size: Optional[int] = None):
        self.events: list[dict] = []
        self.keep = keep_in_memory
        self.counts: dict[str, int] = {}
        #: None = follow the trace_roll_size knob; explicit value wins
        self.roll_size = roll_size
        self.rolled_files: list[str] = []
        self._fh = None
        self._path: Optional[str] = None
        self._bytes = 0
        self._rolls = 0
        self._roll_broken = False   # a failed rename disables rolling
        self._set_file(path)

    def _set_file(self, path: Optional[str]) -> None:
        # line-buffered: every emitted event line reaches the OS without
        # waiting for a close that __del__-era code never guaranteed.
        # The atexit hook (registered only while a file is open, and
        # unregistered on close so short-lived collectors aren't pinned
        # for process lifetime) covers whatever the OS still buffers
        # when the interpreter goes down.
        self._path = path
        self._bytes = 0
        if path:
            self._fh = open(path, "a", buffering=1)
            try:
                import os
                self._bytes = os.fstat(self._fh.fileno()).st_size
            except OSError:
                pass   # appending to an unstattable stream: size 0
            atexit.register(self.close)

    def _roll(self) -> None:
        """Rotate the full trace file aside and start a fresh one,
        keeping the flush/atexit semantics (the atexit hook stays
        registered — it closes whichever file is current at exit)."""
        import os
        self._rolls += 1
        rolled = f"{self._path}.{self._rolls}"
        self._fh.flush()
        self._fh.close()
        atexit.unregister(self.close)   # _set_file re-registers
        try:
            os.replace(self._path, rolled)
            self.rolled_files.append(rolled)
        except OSError:
            # un-renamable target (directory went read-only, file held
            # elsewhere): stop trying — retrying would turn EVERY emit
            # into open/close/failed-rename churn against the same
            # over-limit file
            self._roll_broken = True
        self._set_file(self._path)
        if _process_identity is not None and self._fh:
            # the rolled-away segment carried the ProcessIdentity
            # header; re-stamp the fresh file so every segment is
            # self-describing (tracemerge attributes spans per segment
            # group, and a headerless segment would fall back to the
            # local-process bucket)
            self.emit({"Severity": SevInfo, "Time": _now(),
                       "Type": "ProcessIdentity", "ID": process_name(),
                       "Role": _process_identity["role"],
                       "Pid": _process_identity["pid"],
                       "Addr": _process_identity["addr"]})

    def emit(self, ev: dict) -> None:
        self.counts[ev["Type"]] = self.counts.get(ev["Type"], 0) + 1
        if _flightrec.armed:   # one attribute check while disarmed
            _flightrec.note(ev)
        if self.keep:
            self.events.append(ev)
            if len(self.events) > self.keep:
                del self.events[: self.keep // 2]
        if self._fh:
            # ensure_ascii (the default) keeps lone surrogates and
            # control characters escaped, so the line is pure ASCII;
            # the default= hook covers bytes and foreign objects
            line = json.dumps(ev, default=trace_json_escape) + "\n"
            self._fh.write(line)
            self._bytes += len(line)
            limit = (self.roll_size if self.roll_size is not None
                     else _roll_size_knob())
            if limit and self._bytes >= limit and not self._roll_broken:
                self._roll()

    @property
    def path(self) -> Optional[str]:
        """Current output file path (None while memory-only) — callers
        that retarget the shared collector save this to restore it."""
        return self._path

    def flush(self) -> None:
        if self._fh:
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.flush()
            self._fh.close()
            self._fh = None
            atexit.unregister(self.close)

    def __enter__(self) -> "TraceCollector":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def reset(self, path: Optional[str] = None) -> None:
        """Clear state and retarget the output file, in place (the ambient
        g_trace is shared by reference across modules)."""
        self.close()
        self.events.clear()
        self.counts.clear()
        self.rolled_files.clear()
        self._rolls = 0
        self._roll_broken = False
        self._set_file(path)


g_trace = TraceCollector()


def reset_trace(path: Optional[str] = None) -> TraceCollector:
    g_trace_batch.dump()   # sampled events survive into the stream
    g_trace.reset(path)
    return g_trace


# -- process identity -------------------------------------------------------
# One flow scheduler == one "process" for cross-process tracing. Span ids
# are per-process sequential, so a span is only globally unique as
# (process, span_id); roles stamp their identity here once and every
# span dump / wire hop carries it. None (the default) keeps span dump
# lines byte-identical to the pre-identity format — in-sim tests and
# same-seed replay baselines never see the new fields unless a tool
# opted in.
_process_identity: Optional[dict] = None


def set_process_identity(role: str, pid: Optional[int] = None,
                         addr: str = "") -> dict:
    """Stamp this OS process for cross-process trace reassembly: role
    name, pid, and (optionally) the gateway address it talks to. Emits
    a ProcessIdentity header event so a trace file is self-describing
    even before its first span."""
    global _process_identity
    if pid is None:
        import os
        pid = os.getpid()
    _process_identity = {"role": role, "pid": int(pid), "addr": addr}
    TraceEvent("ProcessIdentity", process_name()).detail(
        Role=role, Pid=int(pid), Addr=addr).log()
    return _process_identity


def clear_process_identity() -> None:
    global _process_identity
    _process_identity = None


def process_name() -> str:
    """The compact `role:pid` token spans and wire hops are stamped
    with ("" while no identity is set)."""
    if _process_identity is None:
        return ""
    return f"{_process_identity['role']}:{_process_identity['pid']}"


class TraceEvent:
    """``TraceEvent("Name", id).detail(Key=value)...`` — emits on
    ``.log()``, on ``__del__``, or at ``with`` exit. Events below the
    ``trace_severity_min`` knob are dropped at construction: ``detail``
    and ``log`` become no-ops, so a SevDebug event in a hot loop costs
    one knob read and a compare — no timestamp, no dict work."""

    __slots__ = ("_ev", "_logged")

    def __init__(self, name: str, id: str = "", severity: int = SevInfo):
        if severity < _severity_floor():
            self._ev = None
            self._logged = True   # suppressed: nothing to emit, ever
            return
        self._ev = {"Severity": severity, "Time": _now(),
                    "Type": name, "ID": id}
        self._logged = False

    def detail(self, **kwargs: Any) -> "TraceEvent":
        if self._ev is not None:
            self._ev.update(kwargs)
        return self

    def log(self) -> None:
        if not self._logged:
            self._logged = True
            g_trace.emit(self._ev)

    def __enter__(self) -> "TraceEvent":
        return self

    def __exit__(self, exc_type, exc, _tb) -> None:
        # the explicit form the __del__ fallback can't guarantee: emit
        # deterministically at scope exit, recording a failure if one
        # ended the scope (ref: TraceEvent::~TraceEvent logging errors).
        # An event already emitted inside the block is left untouched —
        # mutating it would diverge the in-memory copy from the file
        if exc is not None and self._ev is not None and not self._logged:
            self._ev.setdefault("Error", repr(exc))
        self.log()

    def __del__(self):
        try:
            self.log()
        except Exception:
            pass


class Span:
    """One timed leg of a sampled transaction's path (ref: flow/Tracing.h
    `Span` — begin/end timestamps plus a parent link; the commit-debug
    locations mark instants, spans mark extents). Created through
    ``TraceBatch.begin_span``; ``finish()`` (or ``with``) stamps the end
    time and files the span for ``span_chain`` reassembly."""

    __slots__ = ("batch", "debug_id", "location", "span_id", "parent_id",
                 "begin", "end", "remote_parent")

    def __init__(self, batch: "TraceBatch", debug_id, location: str,
                 span_id: int, parent_id: Optional[int],
                 remote_parent=None):
        self.batch = batch
        self.debug_id = debug_id
        self.location = location
        self.span_id = span_id
        self.parent_id = parent_id
        #: (process_name, span_id) in ANOTHER process, when this leg's
        #: parent arrived over a traced TCP frame
        self.remote_parent = remote_parent
        self.begin = _now()
        self.end: Optional[float] = None

    def finish(self) -> None:
        if self.end is not None:
            return
        self.end = _now()
        self.batch._finish_span(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()


class TraceBatch:
    """Cross-role latency stitching for SAMPLED transactions (ref:
    g_traceBatch, flow/Trace.h:107 — attach/event pairs with a shared
    debug id let a tool reassemble one transaction's path across the
    client, proxy, resolver, and log). Events buffer here (bounded —
    the oldest spill into the trace stream, like the reference's
    periodic dump) and can be flushed or queried by id. Spans ride the
    same buffer discipline: roles open parented spans around their leg
    of a commit, and `span_chain` rebuilds the tree."""

    MAX_BUFFERED = 4096
    MAX_REMOTE_PARENTS = 4096

    def __init__(self):
        self._events: list = []
        self._seq = 0   # insertion order: same-tick events must stitch
                        # causally, not alphabetically by location
        self._spans: list = []            # finished spans
        self._open: dict = {}             # debug_id -> stack of open Spans
        self._span_seq = 0
        #: debug_id -> (process_name, span_id): the still-open parent
        #: span in the SENDING process, delivered by a traced TCP frame
        #: (rpc/tcp.py) just before the request dispatches locally.
        #: Bounded: sampled ids are rare, but a long soak must not grow
        #: this without bound — oldest entries evict first
        self._remote_parents: dict = {}

    def add_event(self, event_type: str, debug_id, location: str) -> None:
        self._seq += 1
        self._events.append((_now(), self._seq, event_type, debug_id,
                             location))
        if len(self._events) > self.MAX_BUFFERED:
            # spill the OLDEST half only: in-flight stitches keep their
            # recent legs queryable in memory
            self.dump(self._events[:self.MAX_BUFFERED // 2])
            del self._events[:self.MAX_BUFFERED // 2]

    def add_events(self, debug_ids, event_type: str, location: str) -> None:
        for d in debug_ids:
            self.add_event(event_type, d, location)

    def events(self, debug_id) -> list:
        """Causally-ordered (time, type, location) for one debug id."""
        return [(t, et, loc) for t, seq, et, d, loc
                in sorted(e for e in self._events if e[3] == debug_id)]

    # -- spans ----------------------------------------------------------
    def begin_span(self, debug_id, location: str,
                   parent: Optional["Span"] = None) -> Span:
        """Open a parented span for one debug id. With no explicit
        parent, the innermost still-open span of the same debug id is
        the parent — in the deterministic sim a commit's legs nest
        (client > proxy > {resolver, tlog}), so auto-parenting rebuilds
        the reference's trace tree without threading span tokens
        through every RPC type. Same-location open spans are SIBLINGS,
        not ancestors: with two tlogs (or a txn split across
        resolvers), leg B begins while leg A's identical-location span
        is still open, and both must parent onto the proxy span.

        With NO local parent at all, a remote parent noted for this
        debug id (the sending process's open span, carried by
        a traced TCP frame) attaches instead, so a cross-process leg
        still joins the same commit tree when tracemerge reassembles
        the per-process files."""
        self._span_seq += 1
        stack = self._open.setdefault(debug_id, [])
        remote = None
        if parent is not None:
            pid = parent.span_id
        else:
            pid = None
            for s in reversed(stack):
                if s.location != location:
                    pid = s.span_id
                    break
            if pid is None:
                remote = self._remote_parents.get(debug_id)
        span = Span(self, debug_id, location, self._span_seq, pid,
                    remote_parent=remote)
        stack.append(span)
        return span

    def note_remote_parent(self, debug_id, process: str,
                           span_id: int) -> None:
        """Record that `debug_id`'s innermost open span lives in
        another process — called by the TCP transport when a traced
        request frame arrives, BEFORE the request dispatches into the
        local role (so the role's begin_span sees it)."""
        if len(self._remote_parents) >= self.MAX_REMOTE_PARENTS and \
                debug_id not in self._remote_parents:
            # evict the oldest noted id (insertion order)
            self._remote_parents.pop(next(iter(self._remote_parents)))
        self._remote_parents[debug_id] = (process, span_id)

    def open_span_id(self, debug_id) -> Optional[int]:
        """The innermost still-open span id for one debug id (None when
        no span is open) — what a traced TCP request carries as the
        receiving process's remote parent."""
        stack = self._open.get(debug_id)
        return stack[-1].span_id if stack else None

    def begin_spans(self, debug_ids, location: str) -> list:
        return [self.begin_span(d, location) for d in debug_ids]

    @staticmethod
    def finish_spans(spans) -> None:
        for s in spans:
            s.finish()

    def _finish_span(self, span: Span) -> None:
        stack = self._open.get(span.debug_id)
        if stack and span in stack:
            stack.remove(span)
            if not stack:
                del self._open[span.debug_id]
        self._spans.append(span)
        if len(self._spans) > self.MAX_BUFFERED:
            self._dump_spans(self._spans[:self.MAX_BUFFERED // 2])
            del self._spans[:self.MAX_BUFFERED // 2]

    def spans(self, debug_id) -> list:
        """Finished spans for one debug id, ordered by (begin, open
        order) — the monotonic virtual clock makes this the causal
        order of the legs."""
        return sorted((s for s in self._spans if s.debug_id == debug_id),
                      key=lambda s: (s.begin, s.span_id))

    def span_chain(self, debug_id) -> list:
        """The reassembled tree for one sampled transaction: dicts with
        location/begin/end/parent/depth in causal order. `parent` is
        the parent span's location (None at the root); `depth` is the
        distance to the root, so a test can assert the exact
        client->proxy->resolver/tlog shape."""
        spans = self.spans(debug_id)
        by_id = {s.span_id: s for s in spans}
        out = []
        for s in spans:
            depth = 0
            p = s.parent_id
            while p is not None and p in by_id:
                depth += 1
                p = by_id[p].parent_id
            parent = by_id.get(s.parent_id)
            out.append({"location": s.location,
                        "begin": s.begin, "end": s.end,
                        "parent": parent.location if parent else None,
                        "depth": depth})
        return out

    def clear(self) -> None:
        self._events.clear()
        self._spans.clear()
        self._open.clear()
        self._remote_parents.clear()

    def dump(self, events=None) -> None:
        """Flush events as TraceEvents (ref: TraceBatch::dump); with no
        argument, flushes and clears the whole buffer (finished spans
        included)."""
        batch = self._events if events is None else events
        for t, _seq, et, d, loc in batch:
            ev = TraceEvent(et, str(d))
            if ev._ev is not None:
                ev._ev["Time"] = t
            ev.detail(Location=loc).log()
        if events is None:
            self._dump_spans(self._spans)
            self._spans.clear()
            self._events.clear()

    def _dump_spans(self, spans) -> None:
        proc = process_name()
        for s in spans:
            ev = TraceEvent("Span", str(s.debug_id))
            if ev._ev is not None:
                ev._ev["Time"] = s.begin
            ev.detail(Location=s.location, Begin=s.begin, End=s.end,
                      SpanID=s.span_id, ParentID=s.parent_id)
            # identity-less processes keep the original line format
            # byte-for-byte (pinned by the same-seed merge test)
            if proc:
                ev.detail(Process=proc)
            if s.remote_parent is not None:
                ev.detail(RemoteParentProcess=s.remote_parent[0],
                          RemoteParentID=s.remote_parent[1])
            ev.log()


g_trace_batch = TraceBatch()
