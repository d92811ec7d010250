"""Server-side transaction repair: partial re-execution of invalidated
reads at the proxy, committing a conflicted transaction without a
client round trip.

Reference: *Transaction Repair: Full Serializability Without Locks*
(arXiv:1403.5645) and *Repairing Conflicts among MVCC Transactions*
(PAPERS.md) — when a conflict check can say WHICH reads were
invalidated, a transaction whose writes do not depend on the read
values need not abort: re-execute only the invalidated reads at a
newer snapshot and revalidate, instead of throwing the whole
transaction away.

The repairability contract (client-declared via
`set_option("automatic_repair")`, enforced server-side where
verifiable):

- declared read-set: every read records a read-conflict range (the
  default for non-snapshot reads), so the resolver's per-read-slot
  cause mask names exactly the invalidated reads;
- value-independent writes: the mutation list must not be a function
  of the read values (atomic ops, blind sets/clears, versionstamped
  ops). The server verifies the mutation TYPES are in
  REPAIRABLE_MUTATIONS; value-independence of SET operands is the
  client's declaration — a client that computes a set value from a
  read must not arm the option.

Why the repaired commit is bit-exact with a from-scratch re-execution:
a repairable transaction's effects are exactly its (value-independent)
mutation list, so re-executing it at ANY fresh snapshot produces the
identical mutations — repair resubmits those mutations through the
ORDINARY commit path at a refreshed snapshot (the proxy's committed
version, i.e. what a client retry's GRV would return), with the
invalidated ranges re-read at that version server-side (evidence
recorded in `repair_reread_rows`) standing in for the retry's reads.
The resolver revalidates the full read set over (new_snapshot,
new_commit], so serializability is enforced by the same machinery as
any fresh transaction (and stays pinned by check_consistency and
the failover wrapper's shadow validation under the new paths).

Repairs SERIALIZE per invalidated range (a FlowLock chain): when a
whole batch of rivals conflicts on one hot key, their repairs run one
at a time, each resubmitting only after its predecessor's outcome is
known and with a snapshot covering it — without this, the herd's
resubmissions land in one batch, re-race, and burn their attempt
budgets losing to each other (measured: 95% re-conflict).

Everything else — non-repairable transactions, missing attribution,
re-read failures, attempt/in-flight budget exhaustion — falls back to
the abort the client would have seen anyway. TXN_REPAIR=0 (default)
disables the whole plane.
"""

from __future__ import annotations

from .. import flow
from ..flow import SERVER_KNOBS, TaskPriority, error
from .types import (ATOMIC_OPS, CLEAR_RANGE, INERT_OPS, SET_VALUE,
                    SET_VERSIONSTAMPED_KEY, SET_VERSIONSTAMPED_VALUE,
                    CommitConflictReply, StorageGetRangeRequest)

# mutation types that cannot encode a read value the server can't see
# folded in is the CLIENT's promise; these are the types for which the
# promise is even coherent (versionstamped ops re-stamp at the new
# version exactly as a re-execution would)
REPAIRABLE_MUTATIONS = (ATOMIC_OPS | INERT_OPS
                        | frozenset({SET_VALUE, CLEAR_RANGE,
                                     SET_VERSIONSTAMPED_KEY,
                                     SET_VERSIONSTAMPED_VALUE}))


def repair_eligible(req, ranges) -> bool:
    """Can this conflicted transaction be repaired? Requires the client
    declaration, attribution naming the invalidated reads, a remaining
    attempt budget, and a verifiably value-independent mutation
    vocabulary."""
    if not getattr(req, "repairable", False):
        return False
    if getattr(req, "repair_attempt", 0) >= \
            int(SERVER_KNOBS.repair_max_attempts):
        return False
    if not ranges:
        return False     # no cause mask -> cause unknown -> abort
    if not req.mutations:
        return False
    return all(m.type in REPAIRABLE_MUTATIONS for m in req.mutations)


def _overlapping_shards(storages, begin: bytes, end: bytes):
    out = []
    for s in storages:
        if (s.end is None or begin < s.end) and s.begin < end:
            out.append(s)
    return out


class RepairManager:
    """The proxy's repair engine. `try_repair` captures a conflicted
    (req, reply) pair; the repair actor re-reads the invalidated
    ranges at the conflict version, bumps the read snapshot, and
    resubmits through the proxy's own commit stream — the client's
    reply future answers only with the FINAL outcome (a repaired
    CommitReply, or the abort it would have seen anyway). Counters
    live in the owning proxy's CounterCollection (`repair_*`)."""

    def __init__(self, process, dbinfo, commits, stats, actors,
                 committed_version=None, account=None):
        self.process = process
        self.dbinfo = dbinfo        # AsyncVar[ServerDBInfo] or None
        self._commits = commits     # the proxy's commit RequestStream
        self.stats = stats
        self._actors = actors       # the proxy's ActorCollection
        self._committed = committed_version   # proxy NotifiedVersion
        # conflict-accounting hook for terminal aborts WE deliver:
        # phase 5 skips accounting when it hands a conflict to repair,
        # so a fallback abort must restore it or QoS rates undercount
        self._account = account
        #: per-range repair chains: rivals conflicting on the same hot
        #: range repair ONE AT A TIME (see module docstring)
        self._locks: dict = {}
        self._in_flight = 0

    def try_repair(self, req, reply, version: int, ranges) -> bool:
        """True when the conflicted transaction was captured for
        repair (the caller must NOT answer the reply); False means
        fall back to the ordinary abort."""
        k = SERVER_KNOBS
        if not k.txn_repair:
            return False
        if not repair_eligible(req, ranges):
            return False
        if self._in_flight >= int(k.repair_max_inflight):
            flow.cover("repair.shed")
            self.stats.counter("repair_shed").add(1)
            return False
        flow.cover("repair.attempt")
        self._in_flight += 1
        self.stats.counter("repair_attempts").add(1)
        self.stats.counter("repair_in_flight").set(self._in_flight)
        self._actors.add(flow.spawn(
            self._repair(req, reply, version, tuple(ranges)),
            TaskPriority.PROXY_COMMIT,
            name=f"{self.process.name}.repair"))
        return True

    def _range_lock(self, key) -> "flow.FlowLock":
        lock = self._locks.get(key)
        if lock is None:
            lock = self._locks[key] = flow.FlowLock()
        return lock

    def _drop_lock_if_idle(self, key, lock) -> None:
        if lock.active == 0 and not lock._waiters:
            self._locks.pop(key, None)

    async def _repair(self, req, reply, version: int, ranges) -> None:
        submitted = False
        lock_key = None
        lock = None
        held = False
        try:
            budget = int(SERVER_KNOBS.repair_max_attempts)
            attempt = 0
            while True:
                attempt += 1
                # 0. serialize per hot range: resubmit only once the
                # predecessor's outcome is known (and below our
                # snapshot), or a conflicted batch's worth of rivals
                # re-races itself. THIS actor owns every retry round —
                # resubmissions are never re-captured by the proxy (a
                # nested repair would queue behind this very lock
                # while we await its outcome: deadlock until the
                # client timeout). A re-conflict on a DIFFERENT range
                # re-keys the chain (release-then-take, so there is no
                # hold-and-wait): serialization follows the range that
                # is actually aborting this round.
                if ranges[0] != lock_key:
                    if held:
                        lock.release()
                        self._drop_lock_if_idle(lock_key, lock)
                        held = False
                    lock_key = ranges[0]
                    lock = self._range_lock(lock_key)
                    await lock.take()
                    held = True
                # a client retry's GRV would return at least the
                # current committed version — the repaired
                # re-execution gets the same fresh snapshot (covers
                # every predecessor's commit)
                if self._committed is not None:
                    version = max(version, self._committed.get())
                # 1. partial re-execution: re-read ONLY the
                # invalidated ranges at the new snapshot (bounded; a
                # failure here is the designed fallback seam — nothing
                # was committed, so the ordinary abort is honest)
                try:
                    rows = await flow.timeout_error(
                        flow.spawn(self._reread(ranges, version),
                                   TaskPriority.PROXY_COMMIT),
                        float(SERVER_KNOBS.repair_read_timeout))
                except flow.FdbError as e:
                    if e.name == "operation_cancelled":
                        raise
                    flow.cover("repair.reread_failed")
                    self.stats.counter("repair_fallbacks").add(1)
                    self._send_abort(req, reply, ranges)
                    return
                self.stats.counter("repair_reread_rows").add(rows)
                # 2. revalidate + commit: resubmit at the fresh
                # snapshot. report_conflicting_keys is forced on so a
                # re-conflict comes back as a VALUE carrying the new
                # cause mask for the next round's re-read. The
                # resolver revalidates the whole read set past the new
                # snapshot — an ordinary commit of the equivalent
                # from-scratch re-execution.
                new_req = req._replace(
                    read_snapshot=version, repair_attempt=attempt,
                    report_conflicting_keys=True)
                submitted = True
                out = await flow.timeout_error(
                    self._commits.ref().get_reply(new_req, self.process),
                    float(SERVER_KNOBS.client_request_timeout))
                if not isinstance(out, CommitConflictReply):
                    flow.cover("repair.committed")
                    self.stats.counter("repair_committed").add(1)
                    reply.send(out)
                    return
                # conflicted again: next round re-reads the FRESH
                # attribution (falling back to the original mask when
                # the new one is empty), until the budget runs out
                flow.cover("repair.reconflicted")
                if attempt >= budget:
                    self.stats.counter("repair_conflicted").add(1)
                    if getattr(req, "report_conflicting_keys", False):
                        reply.send(out)
                    else:
                        reply.send_error(error("not_committed"))
                    return
                ranges = tuple(out.conflicting_ranges) or ranges
                submitted = False
        except flow.FdbError as e:
            if e.name == "operation_cancelled":
                # torn down mid-repair (epoch over): the client must
                # see a retryable failure, never our own cancellation
                self._fail(reply, submitted)
                raise
            if e.name in ("not_committed", "transaction_too_old"):
                # definite non-commits: forward as-is (both retryable;
                # masking a known outcome as commit_unknown_result
                # would force the client to settle a result we know)
                self.stats.counter("repair_conflicted").add(1)
                reply.send_error(e)
            elif submitted:
                # the resubmission's outcome is unknown (timeout /
                # broken downstream): the client must settle it, same
                # as any in-flight commit losing its proxy
                self.stats.counter("repair_failed").add(1)
                reply.send_error(error("commit_unknown_result"))
            else:
                self.stats.counter("repair_fallbacks").add(1)
                self._send_abort(req, reply, ranges)
        except BaseException:
            self._fail(reply, submitted)
            raise
        finally:
            if held:
                lock.release()
                self._drop_lock_if_idle(lock_key, lock)
            self._in_flight -= 1
            self.stats.counter("repair_in_flight").set(self._in_flight)

    def _send_abort(self, req, reply, ranges=()) -> None:
        """The abort the client would have seen without repair — a
        reporting client keeps the attributed ranges we already hold,
        and the conflict is accounted exactly as phase 5 would have."""
        if self._account is not None:
            self._account(req)
        try:
            if getattr(req, "report_conflicting_keys", False):
                reply.send(CommitConflictReply(tuple(ranges)))
            else:
                reply.send_error(error("not_committed"))
        except Exception:
            pass  # already answered

    @staticmethod
    def _fail(reply, submitted: bool) -> None:
        try:
            reply.send_error(error(
                "commit_unknown_result" if submitted
                else "broken_promise"))
        except Exception:
            pass

    async def _reread(self, ranges, version: int) -> int:
        """Re-read the invalidated read ranges at `version` straight
        from storage (bounded rows per range). The read waits for
        storage to reach the commit version, exactly like a client
        read at that snapshot. Returns the row count (the re-read is
        what makes the repaired commit a genuine partial re-execution
        rather than a blind resubmit; its failure path is the
        designed fall-back-to-abort seam)."""
        info = self.dbinfo.get() if self.dbinfo is not None else None
        if info is None or not info.storages:
            return 0
        limit = int(SERVER_KNOBS.repair_reread_rows)
        total = 0
        for b, e in ranges[:16]:    # bound work per repaired txn
            for s in _overlapping_shards(info.storages, b, e):
                b2 = max(b, s.begin)
                e2 = e if s.end is None else min(e, s.end)
                if b2 >= e2 or not s.replicas:
                    continue
                rep = s.replicas[0]
                rows = await rep.ranges.get_reply(
                    StorageGetRangeRequest(b2, e2, version, limit),
                    self.process)
                total += len(rows)
        return total

    def status(self) -> dict:
        snap = self.stats.snapshot()
        return {
            "enabled": int(bool(SERVER_KNOBS.txn_repair)),
            "attempts": snap.get("repair_attempts", 0),
            "committed": snap.get("repair_committed", 0),
            "conflicted": snap.get("repair_conflicted", 0),
            "failed": snap.get("repair_failed", 0),
            "fallbacks": snap.get("repair_fallbacks", 0),
            "shed": snap.get("repair_shed", 0),
            "reread_rows": snap.get("repair_reread_rows", 0),
            "in_flight": self._in_flight,
        }
