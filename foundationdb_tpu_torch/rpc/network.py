"""Deterministic simulated network: processes, endpoints, kills, clogs,
partitions, and swizzled links.

Reference behaviors re-implemented (not ported):
  - token-addressed delivery to typed request streams
    (fdbrpc/FlowTransport.actor.cpp:48-113 EndpointMap, :517 deliver)
  - request/reply as paired endpoints: the reply rides back through the
    network with its own latency (fdbrpc/fdbrpc.h ReplyPromise /
    networksender.actor.h)
  - simulated latency per message and clogged links
    (fdbrpc/sim2.actor.cpp:127-160 SimClogging, :176 Sim2Conn), plus
    one-sided send/recv clogs (clogSendFor/clogRecvFor) that apply to
    in-flight REPLIES too — a reply's latency is drawn at reply time,
    so clogging after the request went out still delays the answer
  - bidirectional machine-set partitions with healing: while
    partitioned, a crossing message never arrives and its reply breaks
    after the wire latency, exactly like a connection reset — failure
    detection (which pings over this network) therefore sees a
    partitioned machine as down (ref: sim2's connection-failure
    injection + the partition workloads)
  - per-link "swizzle": a window during which messages on the link draw
    pathological extra latency (aggressive reordering) and one-way
    datagrams may be delivered twice (ref: the swizzled-clogging
    workloads, sim2.actor.cpp)
  - process kill semantics: in-flight requests and replies owned by the
    dead process break; new sends to it hang until failure detection or
    break immediately, per knob (fdbrpc/sim2.actor.cpp:1222
    killProcess_internal; broken_promise surfaces to callers the way a
    closed connection does)
  - machine model grouping processes (fdbrpc/simulator.h:47-147)

Everything randomized draws from the flow deterministic RNG, so a seed
replays the identical message schedule. Every injected fault is
recorded in `chaos_log`/`chaos_counters` (see `chaos_note`): the same
seed must produce the identical fault schedule, and the chaos tests pin
that by comparing the logs of two runs.
"""

from __future__ import annotations

from collections import deque as _deque
from typing import Any, Callable, Dict, Optional, Tuple

from ..flow import error
from ..flow.actors import PromiseStream
from ..flow.future import Future, Promise
from ..flow.rng import buggify
from ..flow.scheduler import Scheduler


class Endpoint:
    """A delivery token: (process, stream id)."""

    __slots__ = ("process", "token")

    def __init__(self, process: "SimProcess", token: int):
        self.process = process
        self.token = token

    def __repr__(self):
        return f"Endpoint({self.process.name}:{self.token})"


class SimProcess:
    """A simulated process hosting request streams (ref: simulator.h
    ProcessInfo). Kill breaks everything it owns."""

    def __init__(self, net: "SimNetwork", name: str, machine: str = "",
                 zone: str = "", dc: str = ""):
        self.net = net
        self.name = name
        self.machine = machine or name
        # failure-domain locality (ref: flow/Locality.h LocalityData —
        # machineid ⊂ zoneid ⊂ dcid). Defaults collapse to the legacy
        # one-process-per-machine model: zone == machine, one dc.
        self.zone = zone or self.machine
        self.dc = dc or "dc0"
        self.alive = True
        self._streams: Dict[int, PromiseStream] = {}
        self._pending_replies: "_deque[Promise]" = _deque()
        self._on_kill: list[Callable[[], None]] = []

    def register(self, stream: PromiseStream) -> Endpoint:
        token = self.net._next_token()
        self._streams[token] = stream
        return Endpoint(self, token)

    def on_kill(self, fn: Callable[[], None]) -> None:
        self._on_kill.append(fn)

    def _track_reply(self, p: Promise) -> None:
        pr = self._pending_replies
        pr.append(p)
        # drop settled entries from the FRONT (replies settle roughly
        # in send order, so popleft is O(1) — the old periodic
        # full-list rebuild re-scanned 64 entries on every 65th send);
        # a long-pending head falls back to the bounded full sweep
        while pr and pr[0].is_set:
            pr.popleft()
        if len(pr) > 4096:
            self._pending_replies = _deque(
                q for q in pr if not q.is_set)

    def __repr__(self):
        return f"SimProcess({self.name}, alive={self.alive})"


class RequestStream:
    """Server side of a typed endpoint: a PromiseStream of envelopes.

    Each received item is ``(request, reply)`` where ``reply`` is a
    Promise whose send travels back through the network."""

    def __init__(self, process: SimProcess):
        self.stream = PromiseStream()
        self.endpoint = process.register(self.stream)

    def ref(self) -> "NetworkRef":
        return NetworkRef(self.endpoint)

    def pop(self) -> Future:
        """Future of the next (request, reply) pair (ref: waitNext)."""
        return self.stream.stream.pop()

    def close(self) -> None:
        """Deregister the endpoint: later requests break with
        broken_promise, exactly like a closed connection, and requests
        already queued but never popped break too (ref: endpoint removal
        from the EndpointMap when a role's actors die)."""
        self.endpoint.process._streams.pop(self.endpoint.token, None)
        q = self.stream.stream._queue
        while q:
            item = q.popleft()
            if isinstance(item, tuple) and len(item) == 2 and \
                    item[1] is not None:
                item[1].send_error(error("broken_promise"))


class NetworkRef:
    """Client handle to a remote RequestStream (ref: RequestStream<T> as
    carried inside interface structs)."""

    __slots__ = ("endpoint",)

    def __init__(self, endpoint: Endpoint):
        self.endpoint = endpoint

    def get_reply(self, request: Any, src: SimProcess) -> Future:
        """Send and return a Future of the reply (ref: getReply pattern,
        fdbrpc/fdbrpc.h)."""
        return self.endpoint.process.net.send_request(
            src, self.endpoint, request)

    def send(self, request: Any, src: SimProcess) -> None:
        """Fire-and-forget (best-effort datagram semantics)."""
        self.endpoint.process.net.send_oneway(src, self.endpoint, request)


class SimNetwork:
    """The simulated transport + fault API (ref: sim2.actor.cpp)."""

    def __init__(self, sched: Scheduler, rng,
                 min_latency: float = None,
                 max_latency: float = None, serialize: bool = True):
        from ..flow import SERVER_KNOBS
        if min_latency is None:
            min_latency = SERVER_KNOBS.sim_latency_min
        if max_latency is None:
            max_latency = SERVER_KNOBS.sim_latency_max
        self.sched = sched
        self.rng = rng
        self.min_latency = min_latency
        self.max_latency = max_latency
        # every delivered message round-trips through the wire format,
        # so serialization bugs surface in ordinary sim runs exactly as
        # the reference's real-FlowTransport-over-sim-connections does
        # (flow/serialize.h; SURVEY §4 "no mock-RPC layer")
        self.serialize = serialize
        self.processes: Dict[str, SimProcess] = {}
        self._tombstones: Dict[str, SimProcess] = {}
        self._token = 0
        #: machine -> disk namespace factory; None = in-memory SimDisk.
        #: A cluster on REAL storage installs RealDisk here.
        self.disk_factory = None
        # (src_machine, dst_machine) -> unclog time
        self._clogged: Dict[Tuple[str, str], float] = {}
        # one-sided clogs: machine -> unclog time (ref: clogSendFor /
        # clogRecvFor, sim2.actor.cpp)
        self._clog_send: Dict[str, float] = {}
        self._clog_recv: Dict[str, float] = {}
        # (src_machine, dst_machine) -> swizzle-window end time
        self._swizzled: Dict[Tuple[str, str], float] = {}
        # partition id -> (machine set A, machine set B); messages
        # crossing any live partition never arrive
        self._partitions: Dict[int, Tuple[frozenset, frozenset]] = {}
        self._next_partition = 0
        self.messages_sent = 0
        self.messages_dropped = 0
        self.messages_duplicated = 0
        # the chaos plane's deterministic fault record: every injected
        # fault appends (sim_time, kind, detail) here and bumps a
        # counter — the seed-replay tests compare two runs' logs, and
        # status.cluster.chaos surfaces the counters (bounded so a long
        # attrition run cannot grow memory without bound)
        self.chaos_log: list = []
        self.chaos_counters: Dict[str, int] = {}
        self.chaos_scenarios: Dict[str, int] = {}
        self.chaos_log_max = 4096
        self.chaos_log_dropped = 0
        self.disks: Dict[str, "SimDisk"] = {}
        # sim-perf message accounting (the SIM_TASK_STATS plane's
        # network half: per-message allocation is a run-loop hot
        # path): armed via arm_message_stats(), each
        # delivery bumps a bounded per-request-type counter. None =
        # off, zero hot-path cost; the delivery-timer / ready-backlog
        # population gauges are pull-computed from the scheduler's
        # heaps at report time, never maintained per message.
        self.msg_stats: Optional[Dict[str, int]] = None
        self._msg_stats_max = 128
        self.msg_stats_dropped = 0
        # wire-path fast paths (the allocation-lean wire front):
        # the knobs object is reset in place, so binding it once is
        # safe and saves a module import per delivery; the wire cache
        # holds the canonical decoded instance per FIELD-LESS message
        # type (typed polls/pings round-trip to an equal instance)
        self._knobs = SERVER_KNOBS
        self._wire_cache: Dict[type, object] = {}

    # -- sim-perf message accounting ------------------------------------
    def arm_message_stats(self, max_types: Optional[int] = None) -> None:
        """Arm per-request-type delivery counting (bounded table)."""
        if max_types is None:
            try:
                from ..flow import SERVER_KNOBS
                max_types = int(SERVER_KNOBS.sim_msg_stats_max_types)
            except Exception:
                max_types = 128
        self._msg_stats_max = max(1, max_types)
        self.msg_stats = {}
        self.msg_stats_dropped = 0

    def _count_msg(self, type_name: str) -> None:
        # lint-style oracle, armed mode only (this method never runs
        # with the plane off): a `NoneType` row means a bare-payload
        # request went out untyped — give it a typed envelope in
        # server/types.py instead of shipping None (the row
        # also defeats per-type attribution, folding every bare poll
        # into one anonymous bucket)
        assert type_name != "NoneType", (
            "untyped (None-payload) message delivery — wrap the request "
            "in a typed wire envelope (see server/types.py PingRequest "
            "and friends)")
        ms = self.msg_stats
        if type_name in ms:
            ms[type_name] += 1
        elif len(ms) < self._msg_stats_max:
            ms[type_name] = 1
        else:
            self.msg_stats_dropped += 1
            ms["(other)"] = ms.get("(other)", 0) + 1

    def message_stats_report(self, top_k: Optional[int] = None) -> dict:
        """-> {armed, types: [{type, count}] (busiest first),
        dropped_types, messages_*, timers_now, ready_now}. The gauges
        are read live from the scheduler heaps (every in-flight
        delivery rides a timer, so the timer heap IS the delivery
        queue plus role timers)."""
        types = sorted(((t, n) for t, n in (self.msg_stats or {}).items()),
                       key=lambda kv: (-kv[1], kv[0]))
        if top_k is not None:
            types = types[:top_k]
        return {
            "armed": int(self.msg_stats is not None),
            "types": [{"type": t, "count": n} for t, n in types],
            "dropped_types": self.msg_stats_dropped,
            "messages_sent": self.messages_sent,
            "messages_dropped": self.messages_dropped,
            "messages_duplicated": self.messages_duplicated,
            "timers_now": len(self.sched._timers),
            "ready_now": len(self.sched._ready),
        }

    def chaos_note(self, kind: str, **detail) -> None:
        """Record one injected fault (the shared chaos accounting every
        primitive feeds — see server/chaos.py for the merged schema)."""
        self.chaos_counters[kind] = self.chaos_counters.get(kind, 0) + 1
        if len(self.chaos_log) < self.chaos_log_max:
            self.chaos_log.append(
                (round(self.sched.now(), 6), kind, detail))
        else:
            self.chaos_log_dropped += 1
        from ..flow import trace
        trace.TraceEvent("ChaosEvent", severity=trace.SevWarnAlways) \
            .detail(Kind=kind, **{k.capitalize(): v
                                  for k, v in detail.items()}).log()

    # -- topology -------------------------------------------------------
    def new_process(self, name: str, machine: str = "", zone: str = "",
                    dc: str = "") -> SimProcess:
        p = SimProcess(self, name, machine, zone, dc)
        self.processes[name] = p
        return p

    def processes_on(self, machine: str) -> list:
        """Live processes sharing a machine (ref: simulator.h
        MachineInfo.processes — machines group processes so failures
        correlate)."""
        return [p for p in self.processes.values()
                if p.alive and p.machine == machine]

    def kill_machine(self, machine: str) -> list:
        """Correlated failure: kill every live process on the machine
        at once (ref: killMachine, sim2.actor.cpp:1717 — machine-level
        kills take out all co-located processes and their unsynced
        writes in one power-loss event). Returns the killed names."""
        victims = self.processes_on(machine)
        if victims:
            self.chaos_note("machine_power_loss", machine=machine,
                            victims=len(victims))
        for p in victims:
            self.kill(p)
        return [p.name for p in victims]

    def disk(self, machine: str) -> "SimDisk":
        """The machine's persistent file namespace (survives kills).
        `disk_factory` (set by a cluster running on REAL storage)
        swaps in on-disk namespaces behind the same seam."""
        d = self.disks.get(machine)
        if d is None:
            if self.disk_factory is not None:
                d = self.disk_factory(machine)
            else:
                from .disk import SimDisk
                d = SimDisk(self, machine)
            self.disks[machine] = d
        return d

    def _next_token(self) -> int:
        self._token += 1
        return self._token

    def resolve_ref(self, process_name: str, token: int) -> "NetworkRef":
        """Rebuild a NetworkRef from its wire form (process name +
        token — ref: FlowTransport's (address, token) endpoints). A
        name that no longer exists resolves to a dead tombstone so
        sends break the same way a closed connection would."""
        p = self.processes.get(process_name)
        if p is None:
            p = self._tombstones.get(process_name)
            if p is None:
                p = SimProcess(self, process_name, process_name)
                p.alive = False
                self._tombstones[process_name] = p
        return NetworkRef(Endpoint(p, token))

    def _wire(self, obj):
        if not self.serialize:
            return obj
        if obj is None:
            return None   # bare reply payloads: nothing to serialize
        # field-less registered messages (typed polls/pings) round-trip
        # to an equal instance every time: prove it once per type, then
        # serve the cached decoded instance — the serialization oracle
        # still holds (an unregistered type fails the first round trip)
        cached = self._wire_cache.get(type(obj))
        if cached is not None:
            return cached
        from . import wire
        if not wire.wire_safe(obj):
            return obj
        rt = wire.roundtrip(obj, self)
        t = type(obj)
        if getattr(t, "_fields", None) == () and type(rt) is t:
            self._wire_cache[t] = rt
        return rt

    # -- faults ---------------------------------------------------------
    def kill(self, process: SimProcess) -> None:
        """Kill a process: break its owned replies; its streams stop
        receiving; its open files lose unsynced writes
        (ref: killProcess_internal, sim2.actor.cpp:1222 +
        AsyncFileNonDurable power-loss semantics)."""
        if not process.alive:
            return
        self.chaos_note("kill", process=process.name,
                        machine=process.machine)
        process.alive = False
        for fn in process._on_kill:
            fn()
        for p in process._pending_replies:
            if not p.is_set:
                p.send_error(error("broken_promise"))
        process._pending_replies.clear()
        d = self.disks.get(process.machine)
        if d is not None:
            d.power_loss(self.rng, owner=process)

    def reboot(self, name: str) -> SimProcess:
        """Kill (if alive) and re-create a process of the same name on
        the same machine. The caller restarts role actors on the new
        process; they recover from the machine's surviving files
        (ref: simulatedFDBDRebooter, SimulatedCluster.actor.cpp:194)."""
        old = self.processes[name]
        self.kill(old)
        self.chaos_note("reboot", process=name, machine=old.machine)
        return self.new_process(name, old.machine, old.zone, old.dc)

    def clog_pair(self, a: str, b: str, seconds: float) -> None:
        """Delay all messages between two machines until now+seconds
        (ref: clogPair, sim2.actor.cpp:1532)."""
        until = self.sched.now() + seconds
        for k in ((a, b), (b, a)):
            self._clogged[k] = max(self._clogged.get(k, 0.0), until)
        self.chaos_note("clog_pair", a=a, b=b, seconds=round(seconds, 6))

    def clog_send(self, machine: str, seconds: float) -> None:
        """Delay everything the machine SENDS until now+seconds,
        replies included — a reply's latency is drawn at reply time, so
        an in-flight request's answer honors a clog installed after the
        request went out (ref: clogSendFor, sim2.actor.cpp)."""
        until = self.sched.now() + seconds
        self._clog_send[machine] = max(
            self._clog_send.get(machine, 0.0), until)
        self.chaos_note("clog_send", machine=machine,
                        seconds=round(seconds, 6))

    def clog_recv(self, machine: str, seconds: float) -> None:
        """Delay everything the machine RECEIVES until now+seconds
        (ref: clogRecvFor, sim2.actor.cpp)."""
        until = self.sched.now() + seconds
        self._clog_recv[machine] = max(
            self._clog_recv.get(machine, 0.0), until)
        self.chaos_note("clog_recv", machine=machine,
                        seconds=round(seconds, 6))

    def partition(self, machines, others=None) -> int:
        """Bidirectional partition: no message crosses between the two
        machine sets until heal(). `others` defaults to every machine
        not in `machines` — including coordinators, the CC, and
        clients, so isolating a minority really isolates it. Crossing
        requests break (broken_promise) after the wire latency, like a
        reset connection, which is what failure detection keys on.
        Returns a partition id for heal()."""
        a = frozenset(machines)
        if others is None:
            others = {p.machine for p in self.processes.values()} - a
        b = frozenset(others) - a
        pid = self._next_partition
        self._next_partition += 1
        self._partitions[pid] = (a, b)
        self.chaos_note("partition", id=pid, minority=sorted(a),
                        majority_size=len(b))
        return pid

    def heal(self, pid: Optional[int] = None) -> None:
        """Remove one partition (or all of them)."""
        if pid is None:
            healed = sorted(self._partitions)
            self._partitions.clear()
        else:
            healed = [pid] if self._partitions.pop(pid, None) else []
        for h in healed:
            self.chaos_note("heal", id=h)

    def partitioned(self, m1: str, m2: str) -> bool:
        for a, b in self._partitions.values():
            if (m1 in a and m2 in b) or (m1 in b and m2 in a):
                return True
        return False

    def swizzle(self, a: str, b: str, seconds: float = None) -> None:
        """Open a swizzle window on the link: messages draw extra
        reorder latency (CHAOS_SWIZZLE_LATENCY spread) and one-way
        datagrams may deliver twice, until the window expires."""
        from ..flow import SERVER_KNOBS
        if seconds is None:
            seconds = SERVER_KNOBS.chaos_swizzle_seconds
        until = self.sched.now() + seconds
        for k in ((a, b), (b, a)):
            self._swizzled[k] = max(self._swizzled.get(k, 0.0), until)
        self.chaos_note("swizzle", a=a, b=b, seconds=round(seconds, 6))

    def _swizzled_now(self, src: SimProcess, dst: SimProcess) -> bool:
        until = self._swizzled.get((src.machine, dst.machine), 0.0)
        return until > self.sched.now()

    def _delivery_delay(self, src: SimProcess, dst: SimProcess) -> float:
        lat = self.min_latency + self.rng.random01() * (
            self.max_latency - self.min_latency)
        if buggify("net/extra_latency"):
            # occasional pathological latency: reorders far more
            # aggressively than the uniform draw (ref: sim2's BUGGIFY'd
            # connection delays)
            lat += self.rng.random01() * self._knobs.sim_clog_extra_latency
        if self._swizzled_now(src, dst):
            # swizzled link: a wide uniform draw scrambles delivery
            # order far beyond the base latency jitter
            lat += self.rng.random01() * self._knobs.chaos_swizzle_latency
        now = self.sched.now()
        unclog = max(self._clogged.get((src.machine, dst.machine), 0.0),
                     self._clog_send.get(src.machine, 0.0),
                     self._clog_recv.get(dst.machine, 0.0))
        if unclog > now:
            lat += unclog - now
        return lat

    # -- delivery -------------------------------------------------------
    def send_request(self, src: SimProcess, dst: Endpoint, request) -> Future:
        reply = Promise()
        dst.process._track_reply(reply)
        self._deliver(src, dst, (self._wire(request),
                                 _NetReply(self, dst.process, src, reply,
                                           type(request).__name__)),
                      reply)
        return reply.future

    def send_oneway(self, src: SimProcess, dst: Endpoint, request) -> None:
        request = self._wire(request)
        self._deliver(src, dst, (request, None), None)
        if buggify("net/duplicate_oneway"):
            # best-effort datagrams may be delivered twice (receivers
            # must be idempotent, e.g. TLog pops)
            self._deliver(src, dst, (request, None), None)
        elif self._swizzled_now(src, dst.process) and \
                self.rng.random01() < self._knobs.chaos_swizzle_dup_prob:
            # a swizzled link duplicates datagrams too — each copy
            # draws its own (scrambled) latency, so the duplicate may
            # arrive FIRST
            self.messages_duplicated += 1
            self._deliver(src, dst, (request, None), None)

    def _deliver(self, src: SimProcess, dst: Endpoint, item,
                 reply: Optional[Promise]) -> None:
        self.messages_sent += 1
        if self.msg_stats is not None:
            self._count_msg(type(item[0]).__name__)
        if not src.alive:
            return  # a dead process sends nothing
        delay = self._delivery_delay(src, dst.process)
        # delivery deadlines ride Scheduler.call_at: a plain (time,
        # seq, callback) heap entry instead of a _TimerFuture + closure
        # + on_ready chain per message (the wire-path diet —
        # same shared seq counter, so delivery order is unchanged)
        if self.partitioned(src.machine, dst.process.machine):
            # the message never crosses; the requester sees a reset
            # after the wire latency (ref: sim2 failing the connection —
            # NOT an instant error, or partitions would be cheaper than
            # real ones and failure detection would look too good)
            self.messages_dropped += 1
            if reply is not None:
                self.sched.call_at(delay, _break_reply, reply)
            return
        self.sched.call_at(delay, self._deliver_now, dst, item, reply)

    def _deliver_now(self, dst: Endpoint, item, reply) -> None:
        """The delivery deadline fired (runs from the timer pump)."""
        if not dst.process.alive:
            # connection failure surfaces as broken_promise to the
            # requester (after the latency, like a RST would)
            self.messages_dropped += 1
            if reply is not None and not reply.is_set:
                reply.send_error(error("broken_promise"))
            return
        stream = dst.process._streams.get(dst.token)
        if stream is None:
            if reply is not None and not reply.is_set:
                reply.send_error(error("broken_promise"))
            return
        stream.send(item)


class _NetReply:
    """Reply promise that routes back through the network with latency.

    Breaks (broken_promise) if the replying process dies first — tracked
    via SimProcess._pending_replies."""

    __slots__ = ("net", "owner", "dst", "promise", "rtype")

    def __init__(self, net: SimNetwork, owner: SimProcess, dst: SimProcess,
                 promise: Promise, rtype: str = "?"):
        self.net = net
        self.owner = owner  # the serving process
        self.dst = dst      # the original requester
        self.promise = promise
        self.rtype = rtype  # request type name (message accounting)

    def _partitioned(self) -> bool:
        """A reply crossing a live partition never lands: break the
        requester's promise after the wire latency instead (the same
        reset a dropped request sees — in-flight replies honor
        partitions and clogs installed after the request went out)."""
        return self.net.partitioned(self.owner.machine, self.dst.machine)

    def send(self, value=None) -> None:
        if self.promise.is_set:
            return
        if not self.owner.alive:
            return  # the kill path already broke the promise
        if self.net.msg_stats is not None:
            self.net._count_msg(self.rtype + ".reply")
        value = self.net._wire(value)
        delay = self.net._delivery_delay(self.owner, self.dst)
        if self._partitioned():
            self.net.messages_dropped += 1
            value = _PARTITION_RESET
        self.net.sched.call_at(delay, _reply_value, self.promise, value)

    def send_error(self, err) -> None:
        if self.promise.is_set:
            return
        if not self.owner.alive:
            return
        if self.net.msg_stats is not None:
            self.net._count_msg(self.rtype + ".reply")
        if self._partitioned():
            self.net.messages_dropped += 1
            err = error("broken_promise")
        delay = self.net._delivery_delay(self.owner, self.dst)
        self.net.sched.call_at(delay, _reply_error, self.promise, err)


_PARTITION_RESET = object()


# call_at callbacks for the reply wire path — module-level so a reply
# in flight costs one heap entry, not a closure per message
def _reply_value(p, value) -> None:
    if p.is_set:
        return
    if value is _PARTITION_RESET:
        p.send_error(error("broken_promise"))
    else:
        p.send(value)


def _reply_error(p, err) -> None:
    if not p.is_set:
        p.send_error(err)


def _break_reply(reply) -> None:
    if not reply.is_set:
        reply.send_error(error("broken_promise"))
