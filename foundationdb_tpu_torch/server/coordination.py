"""Coordination: generation registers, quorum coordinated state, and
leader election.

Reference: fdbserver/Coordination.actor.cpp (GenerationRegInterface —
a per-coordinator two-field generation register), CoordinatedState
.actor.cpp:60-197 (read / setExclusive with majority quorums: a reader
picks a fresh generation, performs a quorum read that also raises each
register's read-generation, then a quorum write commits at that
generation; a competing writer with a newer generation makes the older
one fail with coordinated_state_conflict), and LeaderElection.actor.cpp
:78 (candidacy polling with majority nomination).

The registers live in coordinator processes reached over the simulated
network, so partitions/kills exercise the quorum logic for real. State
is in-memory per coordinator process lifetime — the reference persists
it via an OnDemandStore; killing a majority of coordinators here is
cluster loss, same as the reference's guidance.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

from .. import flow
from ..flow import FlowLock, TaskPriority, error
from ..rpc import RequestStream, SimProcess


class UniqueGeneration(NamedTuple):
    """(ref: UniqueGeneration in CoordinationInterface.h — ordered by
    (generation, uid) so concurrent readers with the same count still
    totally order)."""

    gen: int
    uid: int


ZERO_GEN = UniqueGeneration(0, 0)


class GenRegReadRequest(NamedTuple):
    key: bytes
    gen: UniqueGeneration


class GenRegReadReply(NamedTuple):
    value: Optional[object]
    gen: UniqueGeneration        # generation the value was written at
    read_gen: UniqueGeneration   # the register's (raised) read generation


class GenRegWriteRequest(NamedTuple):
    key: bytes
    gen: UniqueGeneration
    value: object


class GenRegWriteReply(NamedTuple):
    gen: UniqueGeneration        # register's read gen (== req.gen on success)


class CandidacyRequest(NamedTuple):
    key: bytes
    candidate: object            # LeaderInfo (None = read-only poll)
    prev_change_id: int


class CandidacyReply(NamedTuple):
    leader: object
    change_id: int


class LeaderInfo(NamedTuple):
    """What the winning candidate publishes through the coordinators:
    enough for a CLIENT to (re)connect to the cluster controller (ref:
    LeaderInterface / ClientDBInfo reaching clients via MonitorLeader —
    the coordinators are how a client finds the CC after the one it
    knew died). Ordered by (priority, name): a lower priority value
    wins, so an explicitly promoted controller (region failover,
    forceRecovery) can take leadership over a dead incumbent the
    coordinators cannot themselves detect (ref: the bestPriority rules
    in LeaderElection.actor.cpp / ClusterController's leader fitness)."""

    priority: int
    name: str
    open_db: object = None       # NetworkRef: openDatabase endpoint
    status: object = None        # NetworkRef: status endpoint
    management: object = None    # NetworkRef: management endpoint


def _cand_key(c) -> tuple:
    """Election ordering/equality key (refs deserialize into fresh
    objects — never compare or hash them)."""
    if isinstance(c, LeaderInfo):
        return (c.priority, c.name)
    return (0, c)


class ForwardRequest(NamedTuple):
    """Decommission this coordinator: every further register/candidacy
    request is answered with the NEW coordinator set (ref:
    ForwardRequest, fdbserver/CoordinationInterface.h — the old quorum
    keeps redirecting clients after a coordinators change)."""

    coordinators: tuple          # ref 4-tuples (reads,writes,cand,fwd)


class Forwarded(NamedTuple):
    """Reply from a decommissioned coordinator."""

    coordinators: tuple


class MovedValue(NamedTuple):
    """Tombstone written EXCLUSIVELY into the old quorum when the
    coordinated state moves: readers that raced the forward requests
    still learn the new set, and the carried value keeps the state
    readable even if the mover crashed before the forwards landed
    (ref: MovableValue modes, CoordinatedState.actor.cpp:220)."""

    coordinators: tuple
    value: object


class Coordinator:
    """One coordination server (ref: coordinationServer,
    Coordination.actor.cpp). With a disk, the generation register
    persists through an OnDemandStore analogue (a DiskQueue holding the
    latest register image), so the coordinated state — and therefore
    the whole cluster — survives a full process restart."""

    def __init__(self, process: SimProcess, disk=None):
        self.process = process
        # generation register: key -> (value, write_gen, read_gen)
        self._reg: dict = {}
        # leader election register: key -> (leader, change_id) —
        # ephemeral by design: elections re-run on boot
        self._leader: dict = {}
        self.reads = RequestStream(process)
        self.writes = RequestStream(process)
        self.candidacies = RequestStream(process)
        self.forwards = RequestStream(process)
        # set after a coordinators change: all traffic redirects. Not
        # persisted — refs don't survive a process restart in sim, and
        # a moved-away quorum is decommissioned anyway (the reference
        # persists a connection STRING with an expiry instead).
        self._forward: Optional[tuple] = None
        if disk is not None:
            from .diskqueue import DiskQueue
            self._dq = DiskQueue(disk, f"{process.name}.reg", owner=process)
        else:
            self._dq = None
        # the DiskQueue is single-writer; reads raising read_gen and
        # writes both persist, so their pushes must serialize
        self._persist_lock = FlowLock()
        self._actors = flow.ActorCollection()

    def start(self) -> None:
        self._actors.add(flow.spawn(self._run(), TaskPriority.COORDINATION,
                                    name=f"{self.process.name}.run"))
        self.process.on_kill(self._actors.cancel_all)

    async def _run(self) -> None:
        if self._dq is not None:
            payloads = await self._dq.recover()
            if payloads:
                from ..rpc import wire
                self._reg = wire.from_bytes(payloads[-1], None)
                self._dq.pop(self._dq.next_seq - 2)
        for coro, name in ((self._read_loop(), "genReads"),
                           (self._write_loop(), "genWrites"),
                           (self._leader_loop(), "leader"),
                           (self._forward_loop(), "forward")):
            self._actors.add(flow.spawn(coro, TaskPriority.COORDINATION,
                                        name=f"{self.process.name}.{name}"))

    async def _forward_loop(self):
        while True:
            req, reply = await self.forwards.pop()
            if any(c[0].endpoint.process.name == self.process.name
                   for c in req.coordinators):
                # this coordinator is a MEMBER of the new set: it is
                # rejoining, not being decommissioned — clear any stale
                # forward so a change-back can reuse old hosts
                flow.cover("coordination.forward.rejoin")
                self._forward = None
            else:
                self._forward = tuple(req.coordinators)
            reply.send(None)

    async def _persist(self) -> None:
        """Fsync the register image BEFORE acking (ref: the reference's
        OnDemandStore commit before GenerationReg replies)."""
        if self._dq is None:
            return
        from ..rpc import wire
        payload = wire.to_bytes(self._reg)
        await self._persist_lock.take()
        try:
            seq = await self._dq.push(payload)
            await self._dq.commit()
            self._dq.pop(seq - 1)   # only the newest image matters
        finally:
            self._persist_lock.release()

    async def _read_loop(self):
        while True:
            req, reply = await self.reads.pop()
            if self._forward is not None:
                reply.send(Forwarded(self._forward))
                continue
            value, wgen, rgen = self._reg.get(req.key, (None, ZERO_GEN,
                                                        ZERO_GEN))
            if req.gen > rgen:
                rgen = req.gen
                self._reg[req.key] = (value, wgen, rgen)
                # the raised read generation must survive a crash, or a
                # pre-crash writer could still commit at an old gen
                await self._persist()
            reply.send(GenRegReadReply(value, wgen, rgen))

    async def _write_loop(self):
        while True:
            req, reply = await self.writes.pop()
            if self._forward is not None:
                reply.send(Forwarded(self._forward))
                continue
            value, wgen, rgen = self._reg.get(req.key, (None, ZERO_GEN,
                                                        ZERO_GEN))
            if req.gen >= rgen and req.gen >= wgen:
                self._reg[req.key] = (req.value, req.gen,
                                      max(rgen, req.gen))
                await self._persist()
                reply.send(GenRegWriteReply(req.gen))
            else:
                # a newer reader/writer got here first
                reply.send(GenRegWriteReply(max(rgen, wgen)))

    async def _leader_loop(self):
        while True:
            req, reply = await self.candidacies.pop()
            if self._forward is not None:
                reply.send(Forwarded(self._forward))
                continue
            cur, change = self._leader.get(req.key, (None, 0))
            if req.candidate is not None and (
                    cur is None
                    or _cand_key(req.candidate) < _cand_key(cur)):
                # smaller (priority, id) wins (deterministic; ref:
                # LeaderElection nominates the best candidate)
                cur, change = req.candidate, change + 1
                self._leader[req.key] = (cur, change)
            reply.send(CandidacyReply(cur, change))


class CoordinatedState:
    """Majority-quorum client over the coordinators' generation
    registers (ref: CoordinatedState.actor.cpp:60-197)."""

    def __init__(self, coordinators, process: SimProcess,
                 key: bytes = b"\xff/coordinatedState"):
        self.coordinators = list(coordinators)  # [(reads, writes) refs]
        self.process = process
        self.key = key
        self._gen = ZERO_GEN

    def _fresh_gen(self) -> UniqueGeneration:
        return UniqueGeneration(self._gen.gen + 1,
                                flow.g_random.random_int(0, 1 << 30))

    async def _quorum(self, futs):
        """Wait until every attempt settles (sends to dead coordinators
        error rather than hang in sim), then require a majority of
        successes (ref: replicatedRead/Write quorum checks)."""
        need = len(futs) // 2 + 1
        settled = await flow.all_of(futs)  # catch_errors wrappers
        oks = [f.get() for f in settled if not f.is_error]
        if len(oks) < need:
            raise error("coordinators_changed")
        return oks

    @staticmethod
    def _ref_id(r) -> tuple:
        return (r.endpoint.process.name, r.endpoint.token)

    def _is_current_set(self, coordinators: tuple) -> bool:
        """True iff `coordinators` names the set this client already
        targets (refs deserialize into fresh objects — compare
        process/token identity)."""
        mine = {(self._ref_id(r), self._ref_id(w))
                for r, w in self.coordinators}
        theirs = {(self._ref_id(c[0]), self._ref_id(c[1]))
                  for c in coordinators}
        return mine == theirs

    def _follow(self, coordinators: tuple) -> None:
        """Retarget at a forwarded-to coordinator set (ref:
        MovableCoordinatedState following a move)."""
        self.coordinators = [(c[0], c[1]) for c in coordinators]
        self._gen = ZERO_GEN

    async def read(self):
        """Quorum read, raising read generations so any older in-flight
        write can no longer succeed (ref: replicatedRead). Follows a
        moved quorum: Forwarded replies from decommissioned
        coordinators, or a MovedValue tombstone left by the mover."""
        for _hop in range(4):
            g = self._fresh_gen()
            futs = [flow.catch_errors(reads.get_reply(
                GenRegReadRequest(self.key, g), self.process))
                for reads, _w in self.coordinators]
            replies = await self._quorum(futs)
            fwd = next((r for r in replies if isinstance(r, Forwarded)),
                       None)
            if fwd is not None:
                self._follow(fwd.coordinators)
                continue
            best = max(replies, key=lambda r: r.gen)
            max_rgen = max(r.read_gen for r in replies)
            self._gen = max(g, max_rgen, best.gen)
            if isinstance(best.value, MovedValue):
                if self._is_current_set(best.value.coordinators):
                    # the move landed HERE: when old and new sets
                    # overlap, shared members hold the tombstone as
                    # their newest write — its carried value IS the
                    # state (following would loop into ourselves)
                    flow.cover("coordination.read.moved_self")
                    return best.value.value
                # mover may have crashed before the forwards landed:
                # the new quorum was seeded BEFORE this tombstone was
                # written, so following always finds the state
                flow.cover("coordination.read.moved_value")
                self._follow(best.value.coordinators)
                continue
            return best.value
        raise error("coordinators_changed")

    async def set_exclusive(self, value) -> None:
        """Quorum write at the generation observed by the last read;
        fails with coordinated_state_conflict if any newer reader or
        writer intervened (ref: replicatedWrite + seq checks). A
        forwarded coordinator means the quorum moved under us — the
        caller must re-read (which follows) before writing again."""
        g = self._gen
        futs = [flow.catch_errors(writes.get_reply(
            GenRegWriteRequest(self.key, g, value), self.process))
            for _r, writes in self.coordinators]
        replies = await self._quorum(futs)
        if any(isinstance(r, Forwarded) for r in replies):
            raise error("coordinated_state_conflict")
        if any(r.gen > g for r in replies):
            raise error("coordinated_state_conflict")


async def elect_leader(coordinators, key: bytes, candidate,
                       process: SimProcess):
    """Poll the coordinators until a majority nominate `candidate`
    (ref: tryBecomeLeaderInternal, LeaderElection.actor.cpp:78).
    `coordinators` is the ref-tuple list (candidacy endpoint at [2]).
    Returns the coordinator set the election concluded on — a
    forwarded (moved-away) quorum redirects the candidate to the new
    set. Raises operation_failed if a different candidate holds a
    majority."""
    hops = 0
    while True:
        futs = [flow.catch_errors(c[2].get_reply(
            CandidacyRequest(key, candidate, 0), process))
            for c in coordinators]
        settled = await flow.all_of(futs)
        replies = [f.get() for f in settled if not f.is_error]
        fwd = next((r for r in replies if isinstance(r, Forwarded)), None)
        if fwd is not None:
            # bounded: a forward CYCLE (only possible via operator
            # error) must surface as a failure, not an infinite chase
            hops += 1
            if hops > flow.SERVER_KNOBS.coordinator_forward_hops_max:
                raise error("coordinators_changed")
            coordinators = list(fwd.coordinators)
            continue
        hops = 0
        votes: dict = {}
        for r in replies:
            k = None if r.leader is None else _cand_key(r.leader)
            votes[k] = votes.get(k, 0) + 1
        need = len(coordinators) // 2 + 1
        if votes.get(_cand_key(candidate), 0) >= need:
            return coordinators
        for other, n in votes.items():
            if other is not None and other != _cand_key(candidate) \
                    and n >= need:
                raise error("operation_failed")
        await flow.delay(flow.SERVER_KNOBS.candidacy_poll_interval,
                         TaskPriority.COORDINATION)


async def get_leader(coordinators, key: bytes, process: SimProcess):
    """Read the current leader from a coordinator majority WITHOUT
    nominating (ref: MonitorLeader's getLeader — clients poll the
    coordinators to find the cluster controller; this is how a client
    survives the death of the CC it was handed at construction).
    Returns the nominated LeaderInfo, or None when no majority of
    coordinators agrees (election in progress / quorum loss)."""
    for _hop in range(flow.SERVER_KNOBS.coordinator_forward_hops_max + 1):
        futs = [flow.catch_errors(flow.timeout_error(
            c[2].get_reply(CandidacyRequest(key, None, 0), process),
            flow.SERVER_KNOBS.failure_monitor_ping_timeout))
            for c in coordinators]
        settled = await flow.all_of(futs)
        replies = [f.get() for f in settled if not f.is_error]
        fwd = next((r for r in replies if isinstance(r, Forwarded)), None)
        if fwd is not None:
            # bounded like elect_leader: a forward cycle (operator
            # error) must surface as "no leader", not unbounded chasing
            coordinators = list(fwd.coordinators)
            continue
        votes: dict = {}
        leaders: dict = {}
        for r in replies:
            if r.leader is None:
                continue
            k = _cand_key(r.leader)
            votes[k] = votes.get(k, 0) + 1
            leaders[k] = r.leader
        need = len(coordinators) // 2 + 1
        for k, n in votes.items():
            if n >= need:
                return leaders[k]
        return None
    return None

from ..rpc import wire as _wire

_wire.register_module(__name__)  # all NamedTuples here are RPC vocabulary
