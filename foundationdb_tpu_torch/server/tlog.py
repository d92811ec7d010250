"""Transaction log role: tag-partitioned, durable over a DiskQueue,
lockable for epoch recovery.

Reference: fdbserver/TLogServer.actor.cpp — `tLogCommit` (:1468) appends
versioned tagged mutation sets in strict version order (commits carrying
prev_version sequence via NotifiedVersion) and acks after the queue
commit becomes durable (doQueueCommit :1382 — a DiskQueue push+sync on
the machine's simulated disk, or a plain fsync delay in memory mode);
`tLogPeekMessages` (:1138) long-polls readers *per tag* from a version;
`tLogPop` (:1050) discards a tag's acked prefix from memory and reclaims
DiskQueue space once every tag has popped past a record; `TLogLock`
(epochEnd, TagPartitionedLogSystem.actor.cpp:1265) stops the log — it
rejects further commits with tlog_stopped but keeps serving peeks so the
next generation and the storage servers can drain it. On reboot the log
recovers every acked entry from disk (ref: restorePersistentState).
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import Dict, List, Optional

from .. import flow
from ..flow import FlowLock, NotifiedVersion, TaskPriority, error
from ..rpc import RequestStream, SimProcess
from ..rpc.disk import SimDisk
from .chaos import fire_station
from .critical_path import RolePathRecorder
from .diskqueue import DiskQueue
from .types import (DurableFrontierRequest,
                    TLogCommitRequest, TLogLockReply, TLogLockRequest,
                    TLogPeekReply, TLogPeekRequest, TLogPopRequest,
                    mutation_bytes)
from .wire import decode_log_entry, encode_log_entry


def _tag_set(tagged) -> frozenset:
    tags = set()
    for tm in tagged:
        tags.update(tm.tags)
    return frozenset(tags)


def _payload_bytes(tagged) -> int:
    return sum(mutation_bytes(tm.mutation) for tm in tagged)


class TLog:
    def __init__(self, process: SimProcess, disk: Optional[SimDisk] = None,
                 name: str = "tlog", fsync_delay: Optional[float] = None,
                 recovery_version: int = 0):
        self.process = process
        self.name = name
        self.fsync_delay = (fsync_delay if fsync_delay is not None
                            else flow.SERVER_KNOBS.tlog_fsync_delay)
        self._dq = (DiskQueue(disk, name, owner=process)
                    if disk is not None else None)
        # [(version, tagged_mutations, seq)] sorted by version; a
        # SPILLED entry's tagged_mutations is None — its payload lives
        # only in the DiskQueue, re-read at peek (ref: TLog spill,
        # TLogServer.actor.cpp updatePersistentData — memory stays
        # bounded by TLOG_SPILL_THRESHOLD while a lagging reader can
        # still drain the log)
        self.entries: list = []
        self._versions: list = []  # parallel sorted version index
        self._entry_tags: list = []  # parallel per-record tag sets
        self._entry_bytes: list = []  # parallel payload-size estimates
        self.mem_bytes = 0            # total un-spilled payload bytes
        self._spill_floor = 0         # first possibly-unspilled index
        self.version = NotifiedVersion(recovery_version)  # highest durable
        self.queue_version = NotifiedVersion(recovery_version)  # accepted
        self.known_committed = recovery_version  # replicated log-set-wide
        # per-tag, per-replica popped versions; a tag's effective pop
        # is the min across its EXPECTED replicas — a replica that has
        # never popped holds the tag's records (a min over
        # seen-only would free data a clogged/rebooting replica needs)
        self.popped: Dict[int, Dict[str, int]] = {}
        self.expected_replicas: Dict[int, tuple] = {}
        self.stopped = False                     # locked by recovery
        self._stop_future = flow.Future()        # fires when locked
        self.commits = RequestStream(process)
        self.peeks = RequestStream(process)
        self.pops = RequestStream(process)
        self.locks = RequestStream(process)
        self._dq_lock = FlowLock()
        # (ref: TLogData counters: commits/bytes for status + ratekeeper)
        self.stats = flow.CounterCollection("tlog")
        # banded + sampled commit durability latency (accept -> fsync ack)
        self.commit_bands = flow.RequestLatency("commit")
        # critical-path split: version-ordering wait in
        # _handle_commit vs fsync service in _make_durable, bridged by
        # a per-request enter stamp; armed via CRITICAL_PATH only
        self.path = RolePathRecorder("tlog")
        # QoS saturation signals (ref: TLogQueuingMetricsReply — the
        # smoothed queue surface the Ratekeeper polls). Pull model:
        # qos_sample() reads raw state at the collection cadence; the
        # commit/peek hot paths never update these
        self._qos_queue = flow.SmoothedQueue()
        self._qos_backlog = flow.SmoothedQueue()
        self._qos_commit_rate = flow.SmoothedRate()
        self._recovered = flow.Future()
        self._actors = flow.ActorCollection()

    def start(self) -> None:
        self._actors.add(flow.spawn(self._run(), TaskPriority.TLOG_COMMIT,
                                    name=f"{self.process.name}.run"))
        self.process.on_kill(self._actors.cancel_all)

    async def _run(self) -> None:
        try:
            await self._recover()
        except flow.FdbError:
            return   # corrupt store: recovered() carries the error
        for coro, prio, name in (
                (self._commit_loop(), TaskPriority.TLOG_COMMIT, "commit"),
                (self._peek_loop(), TaskPriority.TLOG_PEEK, "peek"),
                (self._pop_loop(), TaskPriority.TLOG_POP, "pop"),
                (self._lock_loop(), TaskPriority.TLOG_COMMIT, "lock")):
            self._actors.add(flow.spawn(coro, prio,
                                        name=f"{self.process.name}.{name}"))

    async def _recover(self) -> None:
        """Rebuild the in-memory index from whatever the DiskQueue's
        committed prefix preserved; versions resume from the last
        durable entry."""
        if self._dq is not None:
            try:
                payloads = await self._dq.recover()
            except flow.FdbError as e:
                # detected on-disk corruption: this store is LOST — the
                # waiter (worker boot) learns through the recovered()
                # future and treats it as a dead store; the role's other
                # actors never start (ref: a tlog failing its recovery)
                if not self._recovered.is_ready:
                    self._recovered.send_error(e)
                raise
            seq0 = self._dq.next_seq - len(payloads)
            for i, payload in enumerate(payloads):
                version, tagged = decode_log_entry(payload)
                self.entries.append((version, tagged, seq0 + i))
                self._versions.append(version)
                self._entry_tags.append(_tag_set(tagged))
                nb = _payload_bytes(tagged)
                self._entry_bytes.append(nb)
                self.mem_bytes += nb
            if self.entries:
                last = self.entries[-1][0]
                self.version.set(last)
                self.queue_version.set(last)
        # re-apply the memory bound: recovery decoded the whole durable
        # queue into memory, which may far exceed the spill threshold
        self._maybe_spill()
        if not self._recovered.is_ready:
            self._recovered.send(None)

    def recovered(self) -> flow.Future:
        return self._recovered

    async def _commit_loop(self):
        # spawn per request: pushes from successive proxy batches are in
        # flight concurrently (the proxy releases its logging interlock at
        # push time) and the network can deliver them out of order; a
        # serial loop awaiting prev_version would wedge behind a
        # reordered pair (same per-request tolerance as the resolver).
        while True:
            req, reply = await self.commits.pop()
            if type(req) is DurableFrontierRequest:
                # durable-frontier probe (degraded GRV): every commit a
                # proxy has EVER acked is durable on all logs, so the
                # min of these frontiers across logs is a committed,
                # readable read-version floor. Answers even while
                # stopped — a locked log still knows what it holds.
                reply.send(self.version.get())
                continue
            assert isinstance(req, TLogCommitRequest)
            flow.spawn(self._handle_commit(req, reply),
                       TaskPriority.TLOG_COMMIT)

    async def _handle_commit(self, req: TLogCommitRequest, reply):
        path_armed = bool(flow.SERVER_KNOBS.critical_path)
        if path_armed:
            # queue-entry stamp: the gap to _make_durable's start is
            # this commit's version-ordering wait (popped by every
            # early-return path so the bounded map never leaks)
            self.path.note_enter(req, flow.now())
        if self.stopped:
            flow.cover("tlog.commit.stopped")
            reply.send_error(error("tlog_stopped"))
            self.path.take_enter(req, 0.0)
            return
        # strict version ordering (ref: tLogCommit waits for
        # logData->version == req.prevVersion). A lock wakes parked
        # waiters: their gap will never be filled by a dead proxy, so
        # they must fail out instead of wedging the batch forever.
        await flow.first_of(
            self.queue_version.when_at_least(req.prev_version),
            self._stop_future)
        if self.stopped and self.queue_version.get() < req.prev_version:
            reply.send_error(error("tlog_stopped"))
            self.path.take_enter(req, 0.0)
            return
        if req.known_committed > self.known_committed:
            self.known_committed = req.known_committed
        if self.queue_version.get() >= req.version:
            # duplicate delivery: the entry is already queued (possibly
            # not yet fsynced) — ack only once it IS durable, never
            # append twice (comparing against the durable
            # version would race the in-flight fsync)
            self.path.take_enter(req, 0.0)
            await self._ack_when_durable(req.version, reply)
            return
        if self.stopped:
            flow.cover("tlog.commit.stopped")
            reply.send_error(error("tlog_stopped"))
            self.path.take_enter(req, 0.0)
            return
        # the log-leg stations fire only on ACCEPTED first deliveries:
        # a stopped rejection or a duplicate proxy retry must not file
        # a phantom extra tlog leg into a sampled commit's stitching
        # (same invariant as the resolver's duplicate-delivery guard).
        # Named for where it actually sits — after the version-ordering
        # wait, before the fsync — so a stitched timeline attributes a
        # prev_version stall to the gap before this station, not to
        # the fsync leg
        flow.g_trace_batch.add_events(
            getattr(req, "debug_ids", ()), "CommitDebug",
            "TLog.tLogCommit.AfterWaitForVersion")
        fire_station("TLog.tLogCommit.AfterWaitForVersion")
        self.queue_version.set(req.version)
        self.stats.counter("commits").add(1)
        self.stats.counter("mutations").add(len(req.mutations))
        self.entries.append((req.version, req.mutations, -1))
        self._versions.append(req.version)
        self._entry_tags.append(_tag_set(req.mutations))
        nb = _payload_bytes(req.mutations)
        self._entry_bytes.append(nb)
        self.mem_bytes += nb
        flow.spawn(self._make_durable(req, reply),
                   TaskPriority.TLOG_COMMIT_REPLY)

    async def _make_durable(self, req: TLogCommitRequest, reply):
        t0 = flow.now()
        dbg = getattr(req, "debug_ids", ())
        # the log leg of the commit span tree: spans open at fsync
        # start and close at the durability ack, parented onto the
        # proxy's still-open commitBatch span for each sampled txn
        spans = flow.g_trace_batch.begin_spans(dbg, "TLog.tLogCommit")
        try:
            await self._do_durable(req)
        finally:
            flow.g_trace_batch.finish_spans(spans)
        version = req.version
        if self.version.get() < version:
            self.version.set(version)
        flow.g_trace_batch.add_events(
            dbg, "CommitDebug", "TLog.tLogCommit.AfterTLogCommit")
        fire_station("TLog.tLogCommit.AfterTLogCommit")
        done = flow.now()
        self.commit_bands.record(done - t0)
        if flow.SERVER_KNOBS.critical_path:
            enter = self.path.take_enter(req, t0)
            self.path.record(t0 - enter, done - t0)
        reply.send(version)

    async def _do_durable(self, req: TLogCommitRequest):
        """Durability: DiskQueue push+commit (ref: doQueueCommit), or the
        simulated fsync delay in memory mode. The FlowLock is FIFO and
        durable actors are spawned in version order, so log records land
        on disk in version order. The caller (_make_durable) advances
        the durable version and acks."""
        version = req.version
        if self._dq is None:
            if flow.buggify("tlog/slow_fsync"):
                await flow.delay(flow.g_random.random01()
                           * flow.SERVER_KNOBS.buggify_tlog_commit_delay_max,
                                 TaskPriority.TLOG_COMMIT_REPLY)
            await flow.delay(self.fsync_delay, TaskPriority.TLOG_COMMIT_REPLY)
            # directed fsync-stall injection: the tlog twin
            # of COMMIT_LATENCY_INJECTION — a path drill arms this to
            # prove tlog_fsync shows up dominant in the decomposition.
            # 0 (the default) is one knob read, no delay
            inj = flow.SERVER_KNOBS.tlog_fsync_injection
            if inj:
                await flow.delay(inj, TaskPriority.TLOG_COMMIT_REPLY)
            # variable delays must not reorder durability acks
            await self.version.when_at_least(req.prev_version)
        else:
            await self._dq_lock.take()
            try:
                if flow.buggify("tlog/slow_fsync"):
                    # a straggling disk: widens the accepted-but-not-
                    # durable window (stresses lock + recovery races).
                    # INSIDE the FIFO lock: records must still land on
                    # disk in version order
                    await flow.delay(flow.g_random.random01()
                           * flow.SERVER_KNOBS.buggify_tlog_commit_delay_max,
                                     TaskPriority.TLOG_COMMIT_REPLY)
                seq = await self._dq.push(
                    encode_log_entry(version, req.mutations))
                await self._dq.commit()
                # fsync-stall injection INSIDE the FIFO lock: a real
                # stalled disk serializes everything behind it, and the
                # drill must reproduce that shape
                inj = flow.SERVER_KNOBS.tlog_fsync_injection
                if inj:
                    await flow.delay(inj, TaskPriority.TLOG_COMMIT_REPLY)
            finally:
                self._dq_lock.release()
            i = bisect_left(self._versions, version)
            if i < len(self._versions) and self._versions[i] == version:
                e = self.entries[i]
                self.entries[i] = (e[0], e[1], seq)
            self._maybe_spill()

    def _maybe_spill(self) -> None:
        """Spill the oldest durable entries once in-memory payload bytes
        exceed TLOG_SPILL_THRESHOLD: memory keeps only the position; a
        peek re-reads the payload from the DiskQueue (ref:
        updatePersistentData's spill-by-reference)."""
        from ..flow import SERVER_KNOBS
        limit = SERVER_KNOBS.tlog_spill_threshold
        if self._dq is None or self.mem_bytes <= limit:
            return
        spilled_to = -1
        for i in range(self._spill_floor, len(self.entries)):
            if self.mem_bytes <= limit:
                break
            v, tagged, s = self.entries[i]
            if tagged is None:
                self._spill_floor = i + 1
                continue
            if s < 0:
                break   # not yet durable: spill is a strict prefix
            self.entries[i] = (v, None, s)
            self.mem_bytes -= self._entry_bytes[i]
            self._entry_bytes[i] = 0
            self._spill_floor = i + 1
            spilled_to = max(spilled_to, s)
        if spilled_to >= 0:
            flow.cover("tlog.spilled")
            self.stats.counter("spills").add(1)
            self._dq.spill(spilled_to)

    async def _ack_when_durable(self, version, reply):
        await self.version.when_at_least(version)
        reply.send(self.version.get())

    def qos_sample(self, now: float) -> "QosSample":
        """Saturation-signal snapshot (ref: TLogQueuingMetricsReply):
        smoothed unpopped queue bytes, the fsync backlog (accepted but
        not yet durable — versions still inside the durability window),
        queue length, and the commit rate."""
        from .types import QosSample
        backlog = max(0, self.queue_version.get() - self.version.get())
        return QosSample("tlog", self.name, now, {
            "queue_bytes": round(
                self._qos_queue.sample(self.mem_bytes, now), 1),
            "queue_entries": len(self.entries),
            "fsync_backlog_versions": round(
                self._qos_backlog.sample(backlog, now), 1),
            "commit_rate": round(self._qos_commit_rate.sample_total(
                self.stats.counter("commits").value, now), 2),
        })

    # -- lock (epoch end) ----------------------------------------------
    async def _lock_loop(self):
        while True:
            req, reply = await self.locks.pop()
            assert isinstance(req, TLogLockRequest)
            flow.spawn(self._serve_lock(reply), TaskPriority.TLOG_COMMIT)

    async def _serve_lock(self, reply):
        if not self.stopped:
            self.stopped = True
            self._stop_future.send(None)  # wake parked commit/peek waiters
        # accepted-but-unfsynced commits are still in flight; the end
        # version must cover them or a commit could be acked to a client
        # AFTER recovery chose a lower end (acked-data loss). Wait for
        # the fsyncs to drain (ref: TLogServer lock waits for the queue
        # to catch up before replying).
        await self.version.when_at_least(self.queue_version.get())
        reply.send(TLogLockReply(self.version.get(), self.known_committed))

    # -- peek / pop -----------------------------------------------------
    async def _peek_loop(self):
        while True:
            req, reply = await self.peeks.pop()
            assert isinstance(req, TLogPeekRequest)
            flow.spawn(self._serve_peek(req, reply),
                       TaskPriority.TLOG_PEEK_REPLY)

    async def _serve_peek(self, req: TLogPeekRequest, reply):
        # long-poll: wait until something at/after begin_version is
        # durable. A locked log replies immediately — there will never be
        # more (the reader fails over to the next generation) — and a
        # lock arriving mid-wait wakes the parked poll the same way.
        if not self.stopped:
            await flow.first_of(
                self.version.when_at_least(req.begin_version),
                self._stop_future)
        lo = bisect_left(self._versions, req.begin_version)
        durable = self.version.get()
        hi = bisect_right(self._versions, durable)
        # peeking at/below the tag's freed floor means pin bookkeeping
        # let records this reader still needs be discarded — scream and
        # stall the reader at the hole instead of silently losing data
        # (ref: the TLog's popped-version check in tLogPeekMessages)
        popped_floor = self._tag_popped(req.tag)
        if popped_floor >= req.begin_version:
            flow.TraceEvent("TLogPeekBelowPopped", self.name,
                            severity=flow.trace.SevError).detail(
                Tag=req.tag, Begin=req.begin_version,
                Popped=popped_floor).log()
            # throttle: the reader will re-peek the same version forever
            # (no progress is possible); don't let that become a hot
            # RPC loop that floods the scheduler and the trace file
            await flow.delay(flow.SERVER_KNOBS.tlog_stalled_peek_delay,
                             TaskPriority.LOW_PRIORITY)
            reply.send(TLogPeekReply((), req.begin_version - 1,
                                     self.known_committed))
            return
        out = []
        # snapshot: spilled reads await the disk, and a concurrent pop
        # may shift the live lists under us. The tag index answers
        # "does this record even carry my tag" without touching disk.
        # Replies are SIZE-BOUNDED (ref: DESIRED_TOTAL_BYTES chunking in
        # tLogPeekMessages) — a far-behind reader drains in chunks; its
        # next poll continues past the last delivered version, and the
        # reply's `durable` watermark is clamped to what was actually
        # delivered so the reader cannot skip the truncated remainder.
        snap = list(zip(self.entries[lo:hi], self._entry_tags[lo:hi]))
        limit_bytes = flow.SERVER_KNOBS.desired_total_bytes
        sent_bytes = 0
        truncated_at = None
        for (v, tagged, s), etags in snap:
            if req.tag not in etags:
                continue
            if sent_bytes >= limit_bytes:
                truncated_at = v
                break
            if tagged is None:
                payload = await self._dq.read(s)
                if payload is None:
                    # popped while we read: records this reader still
                    # needs were freed mid-peek. Scream, and clamp the
                    # watermark below v UNFLOORED so the reader cannot
                    # advance past the hole even when v == begin (the
                    # byte-limit floor would swallow exactly that case).
                    flow.TraceEvent("TLogPeekRecordFreed", self.name,
                                    severity=flow.trace.SevError).detail(
                        Tag=req.tag, Version=v).log()
                    await flow.delay(flow.SERVER_KNOBS.tlog_stalled_peek_delay,
                                     TaskPriority.LOW_PRIORITY)
                    reply.send(TLogPeekReply(
                        tuple(out), max(0, v - 1), self.known_committed))
                    return
                _v, tagged = decode_log_entry(payload)
            ms = tuple(tm for tm in tagged if req.tag in tm.tags)
            if ms:
                # with_tags keeps the full tag vectors (the region log
                # router re-partitions by them); plain peeks get bare
                # mutations
                out.append((v, ms if getattr(req, "with_tags", False)
                            else tuple(tm.mutation for tm in ms)))
                sent_bytes += sum(mutation_bytes(tm.mutation)
                                  for tm in ms)
        if truncated_at is not None:
            durable = min(durable, max(req.begin_version,
                                       truncated_at - 1))
        reply.send(TLogPeekReply(tuple(out), durable, self.known_committed))

    async def _pop_loop(self):
        while True:
            req, _reply = await self.pops.pop()
            assert isinstance(req, TLogPopRequest)
            self.pop(req.version, req.tag, getattr(req, "replica", ""))

    def set_expected_replicas(self, mapping: Dict[int, tuple]) -> None:
        """Tag -> replica names that must pop before records free (ref:
        the log system knowing each tag's team)."""
        self.expected_replicas = dict(mapping)

    def _tag_popped(self, tag: int) -> int:
        reps = self.popped.get(tag, {})
        expected = self.expected_replicas.get(tag)
        if expected:
            return min((reps.get(name, -1) for name in expected),
                       default=-1)
        if not reps:
            return -1
        return min(reps.values())

    def pop(self, version: int, tag: int = 0, replica: str = "") -> None:
        """Record that `replica` of `tag` no longer needs entries at or
        below `version`; free memory and disk once *every* tag with
        data in a record has popped past it on ALL its replicas
        (ref: tLogPop + popDiskQueue)."""
        reps = self.popped.setdefault(tag, {})
        if version <= reps.get(replica, -1):
            return
        reps[replica] = version
        # free the poppable prefix: walk until the first record some tag
        # still needs (per-record tag sets are precomputed at append, so
        # the scan costs O(records freed + 1))
        hi = 0
        for i, v in enumerate(self._versions):
            tags = self._entry_tags[i]
            if tags and any(self._tag_popped(t) < v for t in tags):
                break
            hi = i + 1
        if hi == 0:
            return
        max_seq = max((s for _v, _m, s in self.entries[:hi]), default=-1)
        self.mem_bytes -= sum(self._entry_bytes[:hi])
        del self.entries[:hi]
        del self._versions[:hi]
        del self._entry_tags[:hi]
        del self._entry_bytes[:hi]
        self._spill_floor = max(0, self._spill_floor - hi)
        if self._dq is not None and max_seq >= 0:
            self._dq.pop(max_seq)
