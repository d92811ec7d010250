"""Proxy role: GRV path + the pipelined commit batcher.

Reference: fdbserver/MasterProxyServer.actor.cpp —
  - commitBatcher (:344): group commit requests by time window / count;
  - commitBatch (:410), five phases kept as distinct awaits here:
      1 order via latestLocalCommitBatchResolving + master.getVersion
      2 resolver.resolve (key-range split when sharded — the CUDA
        sharded backend does that split on the card instead)
      3 verdict combine + mutation assembly
      4 log push, sequenced via latestLocalCommitBatchLogging
      5 per-txn replies: committed / not_committed / too_old
  - transactionStarter / getLiveCommittedVersion (:1102/:1019): GRV
    returns the proxy's committed version (single-proxy slice of the
    all-proxies confirmation).
Batches overlap: while one batch waits on the log fsync, the next can
already be resolving — the NotifiedVersion pair is the software
pipeline's interlock, exactly the reference's structure.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import List

from .. import flow
from ..flow import SERVER_KNOBS, NotifiedVersion, TaskPriority, error
from ..models import COMMITTED, CONFLICT, TOO_OLD
from ..rpc import NetworkRef, RequestStream, SimProcess
from .admission import GrvAdmissionQueues
from .chaos import fire_station
from .critical_path import ProxyPathRecorder
from .repair import RepairManager
from .scheduler import AdmissionScheduler
from .types import (ATOMIC_OPS, CLEAR_RANGE, INERT_OPS, PRIORITY_BATCH,
                    PRIORITY_DEFAULT, PRIORITY_IMMEDIATE, SET_VALUE,
                    SET_VERSIONSTAMPED_KEY, SET_VERSIONSTAMPED_VALUE,
                    CommitConflictReply, CommitReply, CommitRequest,
                    GetReadVersionReply, MetadataMutations, MutationRef,
                    DURABLE_FRONTIER_REQUEST, GET_RATE_REQUEST,
                    RAW_COMMITTED_REQUEST, ResolveReply, ResolveRequest,
                    TLogCommitRequest, TaggedMutation, mutation_bytes)

from .systemkeys import is_management_mutation as _is_management_mutation

# the mutation types a transaction may carry (ref: the commit path
# asserting isValidMutationType — AvailableForReuse and the
# LogProtocolMessage escape are never legal in a transaction)
LEGAL_MUTATIONS = (frozenset({SET_VALUE, CLEAR_RANGE,
                              SET_VERSIONSTAMPED_KEY,
                              SET_VERSIONSTAMPED_VALUE})
                   | ATOMIC_OPS | INERT_OPS)


def make_versionstamp(version: int, batch_index: int) -> bytes:
    """10-byte versionstamp: 8B big-endian commit version + 2B big-endian
    batch index (ref: Versionstamp encoding, CommitTransaction.h /
    design/tuple.md)."""
    return version.to_bytes(8, "big") + batch_index.to_bytes(2, "big")


def _apply_versionstamp(m: MutationRef, stamp: bytes) -> MutationRef:
    """Rewrite a versionstamped mutation into a plain set (ref:
    MasterProxyServer commitBatch applying transformations before
    logging). The operand's trailing 4 bytes are the little-endian
    offset of the 10-byte placeholder."""
    if m.type == SET_VERSIONSTAMPED_KEY:
        off = int.from_bytes(m.param1[-4:], "little")
        key = m.param1[:-4]
        return MutationRef(SET_VALUE, key[:off] + stamp + key[off + 10:],
                           m.param2)
    off = int.from_bytes(m.param2[-4:], "little")
    val = m.param2[:-4]
    return MutationRef(SET_VALUE, m.param1,
                       val[:off] + stamp + val[off + 10:])


MWTLV = 5_000_000  # fallback window (ref: MAX_WRITE_TRANSACTION_LIFE_VERSIONS)

# every mutation is ALSO routed here while a continuous backup is
# active (ref: the backup mutation-log tags — a single stream preserves
# exact intra-version mutation order for point-in-time restore)
BACKUP_TAG = 0xFFFF
# ...and here while a remote region is attached (ref: the log-router
# tags of a fearless configuration; see server/region.py)
REGION_TAG = 0xFFFE


class KeyResolverMap:
    """keyResolvers: key ranges -> resolver owner HISTORY (newest
    first). After a move, ranges keep routing to the former owner too
    until a full MVCC window has passed — both resolvers then hold
    complete write history for the range, so no conflict can be missed
    across the transition (ref: the keyResolvers
    KeyRangeMap<vector<pair<Version,int>>> in
    MasterProxyServer.actor.cpp:204 and its double-delivery window)."""

    def __init__(self, splits, n_resolvers: int, window: int = None):
        self.bounds = [b""] + list(splits)   # range i = [bounds[i], next)
        self.owners = [[(0, i)] for i in range(n_resolvers)]
        # retention window must track the resolvers' knob-configured
        # MVCC window or a move could drop a former owner while stale
        # snapshots are still resolvable
        self.window = (window if window is not None
                       else SERVER_KNOBS.max_write_transaction_life_versions)

    def _split_at(self, key: bytes) -> int:
        i = bisect_right(self.bounds, key) - 1
        if self.bounds[i] == key:
            return i
        self.bounds.insert(i + 1, key)
        self.owners.insert(i + 1, list(self.owners[i]))
        return i + 1

    def move(self, begin: bytes, end, to_idx: int, at_version: int) -> None:
        """Reassign [begin, end) to `to_idx` from `at_version` on; the
        former owners stay live for one MVCC window."""
        i = self._split_at(begin)
        j = self._split_at(end) if end is not None else len(self.bounds)
        for k in range(i, j):
            if self.owners[k][0][1] != to_idx:
                self.owners[k] = [(at_version, to_idx)] + self.owners[k]

    def expire(self, oldest_version: int) -> None:
        """Drop former owners whose move predates the MVCC window floor
        (the resolver GC watermark: any still-resolvable snapshot is
        >= oldest, so a range whose move landed before it has complete
        write history at the NEW owner). The canonical trim — `prune`
        derives its commit-version form from this — and explicitly
        invokable outside the commit path, so a long-idle map does not
        retain owner history forever (the GRV serve path calls this
        with the confirmed committed version's watermark)."""
        for ow in self.owners:
            while len(ow) > 1 and ow[-2][0] < oldest_version:
                ow.pop()

    def prune(self, commit_version: int) -> None:
        """Drop former owners once one full MVCC window has passed the
        move. No skew slack is needed: moves are versioned through the
        commit stream (Master.register_move), so every proxy applies a
        move at the same effective version."""
        self.expire(commit_version - self.window)

    def release(self, begin: bytes, end, idx: int) -> None:
        """Retire `idx` as a FORMER owner of [begin, end) ahead of the
        window — the live-handoff fast path: once the
        donor's clipped state is installed on the new owner, the master
        registers a release through the version chain and double
        delivery stops immediately instead of after a full MVCC window.
        The CURRENT owner is never dropped (a release racing a newer
        move must not orphan the range)."""
        i = self._split_at(begin)
        j = self._split_at(end) if end is not None else len(self.bounds)
        for k in range(i, j):
            ow = self.owners[k]
            if len(ow) > 1:
                kept = [ow[0]] + [t for t in ow[1:] if t[1] != idx]
                if len(kept) != len(ow):
                    self.owners[k] = kept

    def apply(self, entry) -> None:
        """Apply one version-stamped balance entry off the master's
        move log: 4-tuples are moves (the original vocabulary),
        5-tuples carry an op — "move" or "release"."""
        eff, mb, me, idx = entry[:4]
        if len(entry) > 4 and entry[4] == "release":
            self.release(mb, me, idx)
        else:
            self.move(mb, me, idx, eff)

    def live_owners(self, k: int):
        return [idx for _v, idx in self.owners[k]]

    def owner_of(self, key: bytes) -> int:
        """CURRENT owner of `key` (newest history entry)."""
        k = max(0, bisect_right(self.bounds, key) - 1)
        return self.owners[k][0][1]

    def owned_buckets(self, idx: int) -> list:
        """First-byte buckets whose bucket-start key `idx` currently
        owns — the balance loop's pick set (its moves are whole
        buckets, so bucket starts are ownership-representative)."""
        return [b for b in range(256)
                if self.owner_of(bytes([b])) == idx]

    def owned_ranges(self, n_resolvers: int) -> list:
        """Per-resolver count of ranges currently OWNED (newest entry)
        — the skew surface status/exporter/cli show before and after
        the balancer acts."""
        out = [0] * n_resolvers
        for ow in self.owners:
            if 0 <= ow[0][1] < n_resolvers:
                out[ow[0][1]] += 1
        return out

    def clip_per_resolver(self, txn_ranges, n_resolvers: int):
        """For each resolver, the pieces of `txn_ranges` it must see
        (current + windowed former owners). Bisects to the overlapped
        span — the map can grow toward 257 entries as balancing splits
        buckets, and this sits on the hot commit path."""
        out = [[] for _ in range(n_resolvers)]
        nb = len(self.bounds)
        for b, e in txn_ranges:
            k = max(0, bisect_right(self.bounds, b) - 1)
            while k < nb and self.bounds[k] < e:
                lo = self.bounds[k]
                hi = self.bounds[k + 1] if k + 1 < nb else None
                b2 = max(b, lo)
                e2 = e if hi is None else min(e, hi)
                if b2 < e2:
                    for idx in self.live_owners(k):
                        out[idx].append((b2, e2))
                k += 1
        return out


PRIORITY_NAMES = {PRIORITY_BATCH: "batch", PRIORITY_DEFAULT: "default",
                  PRIORITY_IMMEDIATE: "immediate"}


class TransactionTagCounter:
    """Bounded decaying table of per-tag transaction traffic (ref:
    fdbserver/TransactionTagCounter — the busiest-tag tracking behind
    tag throttling; same decay/eviction shape as ConflictHotSpots).

    Each client-supplied tag accumulates a busyness score that halves
    every QOS_TAG_HALF_LIFE seconds, plus raw started / committed /
    conflicted totals. Bounded at QOS_TAG_MAX_ENTRIES (lowest decayed
    score evicted); `top(k)` is the status/CLI/exporter surface, and
    tag throttling reads the same
    rows to pick which tags to push back on."""

    __slots__ = ("half_life", "max_entries", "_entries")

    def __init__(self, half_life: float = None, max_entries: int = None):
        self.half_life = (half_life if half_life is not None
                          else SERVER_KNOBS.qos_tag_half_life)
        self.max_entries = (max_entries if max_entries is not None
                            else int(SERVER_KNOBS.qos_tag_max_entries))
        # tag -> [decayed score, started, committed, conflicted, last t]
        self._entries: dict = {}

    def _decayed(self, score: float, since: float, now: float) -> float:
        if now <= since or self.half_life <= 0:
            return score
        return score * 0.5 ** ((now - since) / self.half_life)

    def record(self, tag: bytes, outcome: str, now: float,
               weight: float = 1.0) -> None:
        ent = self._entries.get(tag)
        if ent is None:
            ent = self._entries[tag] = [0.0, 0, 0, 0, now]
        ent[0] = self._decayed(ent[0], ent[4], now) + weight
        ent[4] = now
        if outcome == "started":
            ent[1] += 1
        elif outcome == "committed":
            ent[2] += 1
        elif outcome == "conflicted":
            ent[3] += 1
        if len(self._entries) > self.max_entries:
            worst = min(self._entries,
                        key=lambda k: self._decayed(
                            self._entries[k][0], self._entries[k][4], now))
            del self._entries[worst]

    def top(self, k: int = None) -> list:
        """Status-ready rows, busiest first: decayed rate score plus
        the raw per-outcome totals per tag."""
        if k is None:
            k = int(SERVER_KNOBS.qos_tag_top_k)
        now = flow.now()
        rows = [(self._decayed(s, t, now), st, cm, cf, tag)
                for tag, (s, st, cm, cf, t) in self._entries.items()]
        rows.sort(key=lambda r: (-r[0], r[4]))
        return [{"tag": tag.hex(), "busyness": round(score, 4),
                 "started": st, "committed": cm, "conflicted": cf}
                for score, st, cm, cf, tag in rows[:k]]


class Proxy:
    def __init__(self, process: SimProcess, master_ref: NetworkRef,
                 resolver_refs, tlog_refs,
                 resolver_splits=(), storage_splits=(), storage_tags=None,
                 recovery_version: int = 0,
                 batch_window: float = 0.001, max_batch: int = 512,
                 ratekeeper_ref: NetworkRef = None,
                 management_ref: NetworkRef = None,
                 dbinfo=None):
        if not isinstance(resolver_refs, (list, tuple)):
            resolver_refs = [resolver_refs]
        if not isinstance(tlog_refs, (list, tuple)):
            tlog_refs = [tlog_refs]
        assert len(resolver_splits) == len(resolver_refs) - 1
        self.process = process
        self.master_ref = master_ref
        self.resolver_refs = list(resolver_refs)
        # keyResolvers: versioned range -> owner-history map (rebalanced
        # at runtime by the master's resolutionBalancing)
        self.key_resolvers = KeyResolverMap(resolver_splits,
                                            len(resolver_refs))
        # keyServers boundaries: range i = [sbounds[i], sbounds[i+1]),
        # owned by storage tag _stags[i]. Tags are EXPLICIT, not
        # positional: shard splits mint fresh tags mid-keyspace (ref:
        # the keyServers map carrying Tag values, fdbclient/SystemData)
        self._sbounds = [b""] + list(storage_splits) + [None]
        if storage_tags is None:
            raise ValueError(
                "storage_tags is required: tags are not positional once "
                "splits mint fresh tags mid-keyspace")
        self._stags = list(storage_tags)
        assert len(self._stags) == len(self._sbounds) - 1
        self._moving: list = []   # (begin, end, extra_tag) dual-tag ranges
        self.backup_active = False
        self.region_active = False
        self.tlog_refs = list(tlog_refs)
        batch_window = min(
            max(batch_window,
                SERVER_KNOBS.commit_transaction_batch_interval_min),
            SERVER_KNOBS.max_commit_batch_interval)
        max_batch = min(max_batch,
                        SERVER_KNOBS.commit_transaction_batch_count_max)
        if flow.buggify("proxy/small_batch_window"):
            # shrink the batcher to one-or-two txn batches: stresses the
            # pipeline interlocks and resolver ordering under load
            batch_window, max_batch = 1e-5, 2
        self.batch_window = batch_window
        self.max_batch = max_batch
        self.committed_version = NotifiedVersion(recovery_version)
        # the epoch's version floor: batches chaining from it are the
        # resolvers' first, when their GC watermark is still 0 (the
        # split path's proxy-side tooOld decision needs this)
        self._recovery_version = recovery_version
        # pipeline interlocks sequence THIS proxy's batches by local
        # batch number (ref: localBatchNumber + latestLocalCommitBatch*
        # NotifiedVersions, MasterProxyServer.actor.cpp:453,:517); the
        # global version chain is enforced downstream by the resolver
        # and TLog, so local numbering keeps multiple proxies from
        # deadlocking on each other's versions.
        self.batch_resolving = NotifiedVersion(0)
        self.batch_logging = NotifiedVersion(0)
        # wall-clock deadline pacer for SIM_COMMIT_COST_PER_TXN (the
        # proxy-side modeled service time, role-per-process bench):
        # next-free instant of this proxy as a serial commit server
        self._pace_free = 0.0
        self._local_batch = 0
        self._peers = []               # other proxies' raw-committed refs
        self._ratekeeper_ref = ratekeeper_ref
        # CC management stream: committed \xff/conf//\xff/excluded
        # mutations are forwarded there (applyMetadataMutation seam)
        self._management_ref = management_ref
        self._rate = 1e9               # tps budget (ratekeeper-fed)
        self._batch_rate = 1e9         # batch-priority budget (<= _rate)
        self._grv_queue = []           # waiting GRV replies
        self._grv_queue_dirty = False  # new arrivals since last sort
        self._grv_inflight = []        # batch being confirmed right now
        self._admission_inflight = []  # ...and the admission loop's own
        self._suspect_peers = {}       # id(ref) -> suspect-until time
        # (ref: ProxyStats — txn admission/commit counters for status)
        self.stats = flow.CounterCollection("proxy")
        # batches between batch_resolving release and verdict arrival:
        # >1 means the resolver-side pipeline actually overlaps this
        # proxy's batches end to end (the whole point of the split
        # submit/drain resolve path)
        self._resolving_now = 0
        self._resolving_peak = 0
        # banded request latencies + recent-latency reservoirs (ref:
        # LatencyBandConfig applied to GRV and commit in status, plus
        # the LatencySample percentile surface)
        self.grv_bands = flow.RequestLatency("grv")
        self.commit_bands = flow.RequestLatency("commit")
        # commit critical-path decomposition: per-station
        # latency split for EVERY batch while CRITICAL_PATH is armed;
        # off, the commit path pays one knob read per batch
        self.path = ProxyPathRecorder()
        # per-tag / per-priority traffic accounting (ref:
        # TransactionTagCounter + the per-class started counters in
        # ProxyStats); gated by QOS_TAG_ACCOUNTING — off, the commit
        # path pays one knob read per batch and nothing else
        self.tag_counter = TransactionTagCounter()
        # QoS saturation signals (ref: GRV queue depth + batch
        # occupancy feeding the reference's GrvProxyMetrics). Pull
        # model: qos_sample() reads raw state at the collection cadence
        self._qos_grv_queue = flow.SmoothedQueue()
        self._qos_batch_rate = flow.SmoothedRate()
        self._qos_txn_rate = flow.SmoothedRate()
        self._qos_started_rate = flow.SmoothedRate()
        self.commits = RequestStream(process)
        self.grvs = RequestStream(process)
        self.raw_committed = RequestStream(process)
        # count of keyResolvers moves already applied; sent with every
        # version request so the master's reply carries only the tail
        self._moves_seen = 0
        self._actors = flow.ActorCollection()
        # conflict prediction & transaction repair (server/scheduler.py
        # + server/repair.py): the admission scheduler
        # defers predicted-conflict commits into per-hot-range queues
        # (released back through the commit stream), the repair manager
        # re-executes invalidated reads and resubmits instead of
        # aborting, and the CC-pushed hot rows double as the GRV
        # conflict-window piggyback. All knob-gated off by default.
        self.scheduler = AdmissionScheduler(process, self.stats,
                                            self._sched_release)
        self.repair = RepairManager(process, dbinfo, self.commits,
                                    self.stats, self._actors,
                                    committed_version=self.committed_version,
                                    account=self._repair_fallback_account)
        self._conflict_windows: tuple = ()
        # enforced admission control (server/admission.py):
        # per-priority GRV token buckets fed by the ratekeeper's
        # per-proxy budget share, per-tag throttle buckets fed by the
        # \xff\x02/throttledTags/ poll, bounded queues with retryable
        # rejection. Knob-gated off: with GRV_ADMISSION_CONTROL and
        # TAG_THROTTLING both 0 no request ever routes through it.
        self._dbinfo = dbinfo
        self.admission = GrvAdmissionQueues(process, self.stats)
        # timer-band diet: the GRV-side periodic loops —
        # batcher, admission ticker, rate poll, tag-throttle poll —
        # used to poll fixed intervals through empty queues, making
        # proxy_grv_timer the sim's top run-loop band. They now park on
        # these signals while idle: `_grv_wake` is touched by every GRV
        # arrival, `_admission_wake` by every admission submission, so
        # an idle proxy costs ZERO timer events and the first arrival
        # restores the exact old cadence.
        self._grv_wake = flow.WakeSignal()
        self._admission_wake = flow.WakeSignal()

    def set_peers(self, raw_refs) -> None:
        """Raw-committed-version endpoints of the OTHER proxies (ref:
        getLiveCommittedVersion asking all proxies)."""
        self._peers = list(raw_refs)
        self._suspect_peers.clear()

    def start(self) -> None:
        self._actors.add(flow.spawn(self._batcher(),
                                    TaskPriority.PROXY_COMMIT_BATCHER,
                                    name=f"{self.process.name}.batcher"))
        self._actors.add(flow.spawn(self._grv_loop(),
                                    TaskPriority.PROXY_GET_CONSISTENT_READ_VERSION,
                                    name=f"{self.process.name}.grv"))
        self._actors.add(flow.spawn(self._grv_batcher(),
                                    TaskPriority.PROXY_GRV_TIMER,
                                    name=f"{self.process.name}.grvBatcher"))
        self._actors.add(flow.spawn(self._admission_loop(),
                                    TaskPriority.PROXY_GRV_TIMER,
                                    name=f"{self.process.name}.admission"))
        self._actors.add(flow.spawn(self._tag_throttle_loop(),
                                    TaskPriority.PROXY_GRV_TIMER,
                                    name=f"{self.process.name}.tagThrottle"))
        self._actors.add(flow.spawn(self._raw_committed_loop(),
                                    TaskPriority.PROXY_GET_RAW_COMMITTED_VERSION,
                                    name=f"{self.process.name}.rawCommitted"))
        if self._ratekeeper_ref is not None:
            self._actors.add(flow.spawn(self._rate_loop(),
                                        TaskPriority.PROXY_GRV_TIMER,
                                        name=f"{self.process.name}.rate"))
        self.process.on_kill(self._actors.cancel_all)

    def stop(self) -> None:
        """Epoch over: stop serving and break queued/future requests so
        stale clients fail over instead of hanging (ref: the proxy's
        actors dying with the master's lifetime)."""
        self._actors.cancel_all()
        self.commits.close()
        self.grvs.close()
        self.raw_committed.close()
        # a stop mid-confirmation must fail the popped batch too, or
        # those clients wait out the full request timeout
        for entry in (self._grv_queue + self._grv_inflight
                      + self._admission_inflight):
            try:
                entry[0].send_error(error("broken_promise"))
            except Exception:
                pass  # already answered
        self._grv_queue = []
        self._grv_inflight = []
        self._admission_inflight = []
        # deferred commits held by the admission scheduler fail over
        # the same way (repair actors ride self._actors and answer
        # their replies from their cancellation path), and so do GRVs
        # queued in the enforced-admission plane
        self.scheduler.shutdown()
        self.admission.shutdown()

    # -- GRV ------------------------------------------------------------
    async def _grv_loop(self):
        """Queue GRV requests for the batcher (ref: transactionStarter
        :1102 — requests are batched on a timer and released at the
        ratekeeper's rate). Client-batched requests carry how many
        transactions they admit. With the enforced-admission plane
        armed (GRV_ADMISSION_CONTROL / TAG_THROTTLING), requests route
        through server/admission.py's bounded per-priority/per-tag
        queues instead of the legacy unbounded list."""
        while True:
            req, reply = await self.grvs.pop()
            count = getattr(req, "transaction_count", None) or 1
            prio = getattr(req, "priority", PRIORITY_DEFAULT)
            tags = tuple(getattr(req, "tags", ()) or ())
            self.stats.counter("grv_wire_requests").add(1)
            entry = (reply, count, prio, flow.now(), tags)
            k = SERVER_KNOBS
            if k.grv_admission_control or k.tag_throttling:
                self.admission.submit(entry, flow.now())
                self._admission_wake.touch()
            else:
                self._grv_queue.append(entry)
                self._grv_queue_dirty = True
            self._grv_wake.touch()   # unpark the idle GRV-side loops

    async def _grv_batcher(self):
        """Release queued GRVs in rate-gated batches; one causal
        confirmation round-trip serves the whole batch (ref:
        GRV batching in transactionStarter + getLiveCommittedVersion)."""
        interval = SERVER_KNOBS.grv_batch_interval
        tokens = 0.0
        btokens = 0.0     # batch-priority bucket (always <= the default)
        last = flow.now()
        wake = self._grv_wake
        while True:
            if not self._grv_queue:
                # timer diet: nothing queued — park until the next GRV
                # arrival instead of burning a timer event per interval
                # on an empty queue (token math is unaffected: refill
                # below is elapsed-time-based and burst-capped, exactly
                # what idle ticking converged to)
                await wake.wait_beyond(wake.count)
            await flow.delay(interval, TaskPriority.PROXY_GRV_TIMER)
            now = flow.now()
            # token buckets with a bounded burst allowance; a ZERO
            # rate is a full stop (emergency throttle), not a trickle
            if self._rate <= 0:
                tokens = 0.0
            else:
                tokens = min(
                    tokens + self._rate * (now - last),
                    max(1.0, self._rate
                        * SERVER_KNOBS.grv_burst_intervals * interval))
            if self._batch_rate <= 0:
                btokens = 0.0
            else:
                btokens = min(
                    btokens + self._batch_rate * (now - last),
                    max(1.0, self._batch_rate
                        * SERVER_KNOBS.grv_burst_intervals * interval))
            last = now
            if not self._grv_queue:
                continue
            # priority classes (ref: TransactionPriority): IMMEDIATE
            # bypasses the gate and pays no tokens; DEFAULT pays the
            # default bucket; BATCH sorts last and must afford BOTH
            # buckets, so batch traffic throttles first (ref: the
            # separate batchTransactions limit in GetRateInfoReply).
            # Sorted ONLY when arrivals were appended since the last
            # pass: the post-slice tail is already ordered, and under
            # a throttled backlog the former every-tick sort was
            # O(n log n) per 0.5ms on a queue that hadn't changed
            if self._grv_queue_dirty:
                self._grv_queue.sort(key=lambda e: -e[2])
                self._grv_queue_dirty = False
            take = 0
            charged = 0
            bcharged = 0
            while take < len(self._grv_queue):
                _r, cnt, prio, _t, _tags = self._grv_queue[take]
                if prio < PRIORITY_IMMEDIATE:
                    if charged + cnt > tokens:
                        break
                    if prio <= PRIORITY_BATCH:
                        if bcharged + cnt > btokens:
                            break
                        bcharged += cnt
                    charged += cnt
                take += 1
            if take == 0:
                if tokens < 1:
                    continue
                first = self._grv_queue[0]
                if first[2] <= PRIORITY_BATCH and btokens < 1:
                    continue   # batch head throttled; wait for budget
                # a batch bigger than the burst cap still admits by
                # running the bucket into debt, or it would starve
                charged = first[1]
                bcharged = first[1] if first[2] <= PRIORITY_BATCH else 0
                take = 1
            tokens -= charged
            btokens -= bcharged
            self._grv_inflight, self._grv_queue = (self._grv_queue[:take],
                                                   self._grv_queue[take:])
            try:
                await self._serve_grv_batch(self._grv_inflight)
            finally:
                self._grv_inflight = []

    async def _admission_loop(self):
        """The enforced-admission release ticker (ref: the
        transactionStarter loop of GrvProxyServer): one tick per
        GRV_BATCH_INTERVAL window refills the class buckets from this
        proxy's budget SHARE, releases tag-parked requests at their
        commanded pace, sheds wait-bound violations, and serves the
        whole admitted batch with ONE causal-confirmation round trip —
        the GRV batching coalesce (`grv_confirm_rounds` vs
        `transactions_started` is the measured request-rate drop).
        Costs one knob read per tick while the plane is off."""
        interval = SERVER_KNOBS.grv_batch_interval
        wake = self._admission_wake
        while True:
            if not self.admission.depth():
                # park until something is submitted: with the plane off
                # this loop costs nothing at all, and with it armed an
                # idle window (queues drained, no tag-parked requests)
                # skips straight to the next submission — bucket refill
                # is lazy/elapsed-time-based and row expiry is enforced
                # by the table on read, so skipped ticks change nothing
                await wake.wait_beyond(wake.count)
            await flow.delay(interval, TaskPriority.PROXY_GRV_TIMER)
            k = SERVER_KNOBS
            if not (k.grv_admission_control or k.tag_throttling) and \
                    not self.admission.depth():
                continue
            batch = self.admission.tick(flow.now(), self._rate,
                                        self._batch_rate, interval)
            if not batch:
                continue
            # a separate in-flight list: during a knob flip both
            # serving loops can be mid-confirmation at once, and
            # sharing the legacy list would let one finally clear the
            # other's entries out of the stop() drain set
            self._admission_inflight = batch
            try:
                await self._serve_grv_batch(batch)
            finally:
                self._admission_inflight = []

    async def _tag_throttle_loop(self):
        """Watch \\xff\\x02/throttledTags/ and install the rows into
        the admission plane's enforcement table (ref: the GRV proxies
        monitoring the tag-throttle keyspace). A failed read (storage
        mid-recovery) keeps the last installed rows and retries next
        poll; row expiry is enforced by the table itself, so a stale
        poll can never extend a throttle."""
        from .tag_throttler import read_throttle_rows
        wake = self._grv_wake
        seen = -1
        while True:
            if seen == wake.count and not self._grv_queue and \
                    not self.admission.depth():
                # no GRV traffic since the last poll: throttle rows
                # have nobody to apply to — park until a client shows
                # up (row expiry is enforced by the table on read, so
                # a stale poll can never extend a throttle)
                await wake.wait_beyond(wake.count)
            seen = wake.count
            interval = float(SERVER_KNOBS.tag_throttle_poll_interval)
            await flow.delay(interval if interval > 0 else 1.0,
                             TaskPriority.PROXY_GRV_TIMER)
            if not SERVER_KNOBS.tag_throttling:
                continue
            info = self._dbinfo.get() if self._dbinfo is not None else None
            try:
                rows = await flow.timeout_error(
                    flow.spawn(read_throttle_rows(
                        info, self.process, self.committed_version.get()),
                        TaskPriority.PROXY_GRV_TIMER), 1.0)
            except flow.FdbError as e:
                if e.name == "operation_cancelled":
                    raise
                continue
            now = flow.now()
            for entry in self.admission.tags.install(rows, now):
                # a vanished row (manual `throttle off`) frees its
                # parked requests into the ordinary class queues
                self.admission.submit(entry, now)
                self._admission_wake.touch()
            self.stats.counter("throttle_rows").set(
                len(self.admission.tags.rows))

    async def _serve_grv_batch(self, batch):
        """Causally-correct GRV with multiple proxies: the read version
        is the max committed version across ALL of them, so a client
        never reads below its own acknowledged commit through a
        different proxy (ref: getLiveCommittedVersion,
        MasterProxyServer.actor.cpp:1019 — asks all other proxies).

        A dead peer must NOT error the batch: the reference degrades by
        recruitment, not by failing clients. When a peer times out we
        mark it suspect (skipped for GRV_PEER_SUSPECT_DURATION) and fall
        back to the TLogs' durable frontier: a proxy only acks a commit
        once ALL logs hold it durably, so min(frontier) across logs is
        >= every acknowledged commit from every proxy — and, unlike the
        master's last-assigned version, it is a version the storage
        servers can actually reach (an assigned-but-never-pushed version
        would leave readers blocked for the rest of the epoch). Clients
        pay one frontier round-trip during the window until recovery
        rotates the peer set, instead of seeing errors."""
        try:
            # one confirmation round serves the whole batch: the GRV
            # coalescing factor is transactions_started / these rounds
            self.stats.counter("grv_confirm_rounds").add(1)
            version = self.committed_version.get()
            if self._peers:
                now = flow.now()
                live = [p for p in self._peers
                        if self._suspect_peers.get(id(p), 0.0) <= now]
                degraded = len(live) < len(self._peers)
                futs = [flow.timeout_error(
                    p.get_reply(RAW_COMMITTED_REQUEST, self.process),
                    SERVER_KNOBS.grv_confirm_timeout)
                        for p in live]
                for p, f in zip(live, futs):
                    try:
                        version = max(version, await f)
                    except flow.FdbError as e:
                        if e.name == "operation_cancelled":
                            raise
                        degraded = True
                        self._suspect_peers[id(p)] = (
                            flow.now()
                            + SERVER_KNOBS.grv_peer_suspect_duration)
                if degraded:
                    self.stats.counter("grv_degraded").add(1)
                    # individual probe failures are tolerated like
                    # suspect peers (one timed-out frontier
                    # — or an empty tlog_refs mid-recovery — used to
                    # fail the whole GRV batch the fallback exists to
                    # save). min() over the ANSWERED frontiers is still
                    # safe: a commit is acked only once ALL logs hold
                    # it durably, so every log's frontier bounds every
                    # acknowledged commit from below. At least one
                    # answer is required — with none, causality cannot
                    # be proven and clients must retry.
                    futs = [flow.timeout_error(
                        ref.get_reply(DURABLE_FRONTIER_REQUEST,
                                      self.process),
                        SERVER_KNOBS.grv_confirm_timeout)
                        for ref in self.tlog_refs]
                    frontiers = []
                    for f in futs:
                        try:
                            frontiers.append(await f)
                        except flow.FdbError as fe:
                            if fe.name == "operation_cancelled":
                                raise
                            flow.cover("proxy.grv.frontier_probe_failed")
                    if not frontiers:
                        flow.cover("proxy.grv.no_frontier")
                        raise error("broken_promise")
                    version = max(version, min(frontiers))
            self.stats.counter("transactions_started").add(
                sum(e[1] for e in batch))
            if SERVER_KNOBS.qos_tag_accounting:
                # per-priority admission accounting (ref: the per-class
                # txn counters in ProxyStats feeding GetRateInfo)
                for _r, cnt, prio, _t, _tags in batch:
                    self.stats.counter(
                        "transactions_started_"
                        + PRIORITY_NAMES.get(prio, "default")).add(cnt)
            now = flow.now()
            # keyResolvers retention: trim former
            # owners from the GC watermark here too, so a long-idle
            # commit path (moves applied, then traffic stopped) does
            # not retain owner history until the NEXT commit batch —
            # O(owned ranges), and a no-op on the single-resolver map
            self.key_resolvers.expire(version - self.key_resolvers.window)
            # chaos station: "GRV handed out" — the kill-mid-commit
            # scenarios arm role deaths here (server/chaos.py)
            fire_station("MasterProxyServer.GRV.AfterReply")
            # hot-key conflict windows ride the GRV reply into the
            # client-side early-abort cache (server/scheduler.py);
            # empty and free while CLIENT_CONFLICT_WINDOWS is off
            windows = (self._conflict_windows
                       if SERVER_KNOBS.client_conflict_windows else ())
            # tag-throttle info rides the reply per entry so throttled
            # clients back off locally (server/tag_throttler.py);
            # empty and free while TAG_THROTTLING is off
            throttling = bool(SERVER_KNOBS.tag_throttling)
            for entry in batch:
                self.grv_bands.record(now - entry[3])
                throttles = (self.admission.reply_throttles(entry[4], now)
                             if throttling and entry[4] else ())
                entry[0].send(GetReadVersionReply(version, windows,
                                                  throttles))
        except flow.FdbError as e:
            cancelled = e.name == "operation_cancelled"
            if cancelled:
                # cancelled mid-confirmation (the epoch ended): stale
                # clients must see a retryable failure and refresh —
                # never the server's own cancellation
                e = error("broken_promise")
            for entry in batch:
                try:
                    entry[0].send_error(e)
                except Exception:
                    pass  # already answered
            if cancelled:
                raise flow.ActorCancelled()
        except BaseException:
            for entry in batch:
                try:
                    entry[0].send_error(error("broken_promise"))
                except Exception:
                    pass
            raise

    async def _rate_loop(self):
        """(ref: proxies polling GetRateInfo from the ratekeeper).

        Event-driven: the budget only matters while GRV
        traffic flows, so an idle proxy parks instead of polling the
        ratekeeper every interval forever — the first arrival after an
        idle period triggers an immediate poll (fresher than the old
        fixed grid), and sustained traffic restores the old cadence.

        Known, accepted staleness window: the wake-up poll costs one
        network round trip while the batcher only waits one
        GRV_BATCH_INTERVAL, so the FIRST post-idle batch may be
        admitted against the pre-idle rate (the always-polling loop
        bounded staleness at one poll interval instead). One
        burst-capped batch per idle period is the worst case; the
        ratekeeper's next reply corrects the very next window, and
        armed-admission storms never park (traffic keeps the loop
        hot), so the enforcement measurements are unaffected."""
        wake = self._grv_wake
        seen = -1
        while True:
            if seen == wake.count and not self._grv_queue and \
                    not self.admission.depth():
                await wake.wait_beyond(wake.count)
            seen = wake.count
            try:
                r = await flow.timeout_error(
                    self._ratekeeper_ref.get_reply(GET_RATE_REQUEST,
                                                   self.process),
                    SERVER_KNOBS.ratekeeper_poll_timeout)
                self._rate = r.tps
                bt = getattr(r, "batch_tps", -1.0)
                self._batch_rate = r.tps if bt < 0 else min(bt, r.tps)
            except flow.FdbError:
                pass  # keep the last known rate
            await flow.delay(SERVER_KNOBS.grv_rate_poll_interval,
                             TaskPriority.PROXY_GRV_TIMER)

    async def _raw_committed_loop(self):
        while True:
            _req, reply = await self.raw_committed.pop()
            reply.send(self.committed_version.get())

    def _tags_for(self, m: MutationRef):
        """Destination storage tags for a mutation (ref: LogPushData tag
        routing via the keyServers map). A point mutation goes to its
        shard's tag(s); a clear goes to every shard it overlaps. A range
        being moved is DUAL-TAGGED so both source and destination logs
        see its mutations throughout the transition (ref: keyServers
        holding both teams during moveKeys); an active backup adds the
        backup tag to everything."""
        n = len(self._sbounds) - 1
        if n == 1 and not self._moving and not self.region_active:
            return ((self._stags[0], BACKUP_TAG) if self.backup_active
                    else (self._stags[0],))
        if m.type == CLEAR_RANGE:
            tags = set()
            for i in range(n):
                lo, hi = self._sbounds[i], self._sbounds[i + 1]
                if (hi is None or m.param1 < hi) and lo < m.param2:
                    tags.add(self._stags[i])
            for mb, me, extra in self._moving:
                if (me is None or m.param1 < me) and mb < m.param2:
                    tags.add(extra)
            if self.backup_active:
                tags.add(BACKUP_TAG)
            if self.region_active:
                tags.add(REGION_TAG)
            return tuple(sorted(tags))
        tags = {self._shard_of(m.param1)}
        for mb, me, extra in self._moving:
            if mb <= m.param1 and (me is None or m.param1 < me):
                tags.add(extra)
        if self.backup_active:
            tags.add(BACKUP_TAG)
        if self.region_active:
            tags.add(REGION_TAG)
        return tuple(sorted(tags))

    def _shard_of(self, key: bytes) -> int:
        n = len(self._sbounds) - 1
        for i in range(n - 1, -1, -1):
            if key >= self._sbounds[i]:
                return self._stags[i]
        return self._stags[0]

    def start_move(self, begin: bytes, end, extra_tag: int) -> None:
        """Dual-tag [begin, end) with `extra_tag` while a shard move is
        in flight (ref: moveKeys startMoveKeys)."""
        self._moving.append((begin, end, extra_tag))

    def finish_move(self, begin: bytes, end, extra_tag: int,
                    new_splits, new_tags) -> None:
        """Adopt the new shard boundaries/tags and drop the dual tag
        (ref: finishMoveKeys). Tags are explicit — a positional
        fallback would silently misroute after a split."""
        self._moving = [mv for mv in self._moving
                        if mv != (begin, end, extra_tag)]
        self._sbounds = [b""] + list(new_splits) + [None]
        self._stags = list(new_tags)
        assert len(self._stags) == len(self._sbounds) - 1

    # -- commit pipeline ------------------------------------------------
    @staticmethod
    def _req_bytes(req) -> int:
        """Mutations AND conflict ranges: both ship to the resolver/log,
        so both count toward the batch's byte budget."""
        return (sum(mutation_bytes(m) for m in req.mutations)
                + sum(len(b) + len(e) + 16
                      for b, e in (tuple(req.read_conflict_ranges)
                                   + tuple(req.write_conflict_ranges))))

    def _sched_release(self, req, reply) -> None:
        """A deferred commit re-enters the commit stream locally (no
        wire hop): the batcher picks it up like any fresh arrival, and
        the scheduler's released-marker keeps it from re-deferring."""
        self.commits.stream.send((req, reply))

    async def _batcher(self):
        """(ref: commitBatcher :344 — batch by window / count / BYTES:
        a batch closes early once its mutation payload reaches
        COMMIT_TRANSACTION_BATCH_BYTES_MAX, bounding resolver/log
        request sizes). Arrivals first pass the admission scheduler:
        a commit whose predicted conflict probability crosses the
        threshold is captured into a per-hot-range queue instead of
        racing this batch (server/scheduler.py; no-op while
        CONFLICT_SCHEDULING is off)."""
        bytes_max = SERVER_KNOBS.commit_transaction_batch_bytes_max
        while True:
            req, reply = await self.commits.pop()
            if SERVER_KNOBS.critical_path:
                # queue-entry stamp, keyed by the reply promise (it
                # survives scheduler deferral; setdefault keeps the
                # FIRST arrival so deferral time counts as batcher wait)
                self.path.note_arrival(reply, flow.now())
                if getattr(req, "debug_id", None) is not None:
                    # bare add_event: no fire_station — the armed-only
                    # extra station must not interact with chaos kills
                    flow.g_trace_batch.add_event(
                        "CommitDebug", req.debug_id,
                        "MasterProxyServer.batcher.Arrived")
            if self.scheduler.consider(req, reply):
                continue
            batch: List = [(req, reply)]
            nbytes = self._req_bytes(req)
            deadline = flow.delay(self.batch_window,
                                  TaskPriority.PROXY_COMMIT_BATCHER)
            while len(batch) < self.max_batch and nbytes < bytes_max:
                nxt = self.commits.pop()
                got = await flow.first_of(nxt, deadline)
                if got[0] == 1:  # window expired
                    break
                r2, p2 = got[1]
                if SERVER_KNOBS.critical_path:
                    self.path.note_arrival(p2, flow.now())
                    if getattr(r2, "debug_id", None) is not None:
                        flow.g_trace_batch.add_event(
                            "CommitDebug", r2.debug_id,
                            "MasterProxyServer.batcher.Arrived")
                if self.scheduler.consider(r2, p2):
                    continue
                batch.append((r2, p2))
                nbytes += self._req_bytes(r2)
            deadline.cancel()
            self._local_batch += 1
            flow.spawn(self._commit_batch(batch, self._local_batch),
                       TaskPriority.PROXY_COMMIT)

    @staticmethod
    def _debug_ids(reqs):
        return tuple(r.debug_id for r in reqs
                     if getattr(r, "debug_id", None) is not None)

    @staticmethod
    def _mark(ids, location):
        flow.g_trace_batch.add_events(ids, "CommitDebug", location)
        # the commit-debug stations double as chaos kill points: the
        # kill-mid-commit scenarios arm one-shot role deaths at exact
        # pipeline stations (server/chaos.py; no-op while unarmed)
        fire_station(location)

    async def _charge_commit_cost(self, amount: float):
        """Charge modeled commit service time. Wall-clock schedulers use
        a deadline pacer (the proxy as a serial server whose next-free
        instant advances by `amount` per batch — sleeping to the
        deadline absorbs per-sleep OS overshoot); virtual schedulers
        charge a plain delay. Knob default 0 means this never runs in
        the pinned posture."""
        sched = flow.get_scheduler()
        if sched is not None and not sched.virtual:
            now = flow.now()
            self._pace_free = max(self._pace_free, now) + amount
            wait = self._pace_free - now
            if wait > 0:
                await flow.delay(wait, TaskPriority.PROXY_COMMIT)
            return
        await flow.delay(amount, TaskPriority.PROXY_COMMIT)

    async def _commit_batch(self, batch, local: int):
        t0 = flow.now()
        reqs = [r for r, _ in batch]
        replies = [p for _, p in batch]
        # critical-path decomposition: consecutive clock
        # reads at the phase boundaries below telescope to the batch's
        # end-to-end latency, so per-station segments sum to the
        # measured total by construction
        path_armed = bool(SERVER_KNOBS.critical_path)
        t_ver = t_res = t_push = t0
        dbg = self._debug_ids(reqs)
        self._mark(dbg, "MasterProxyServer.commitBatch.Before")
        # span per sampled txn: the proxy leg of the commit tree; the
        # resolver/tlog legs opened downstream auto-parent onto it
        # while it stays open (ref: Span commit tracing, flow/Tracing.h)
        spans = flow.g_trace_batch.begin_spans(
            dbg, "MasterProxyServer.commitBatch")
        try:
            # phase 1: version assignment, ordered with this proxy's
            # earlier batches by local batch number (the finally below
            # always advances the interlocks so a failed batch can never
            # wedge its successors)
            await self.batch_resolving.when_at_least(local - 1)
            # reject illegal mutation types BEFORE resolution: an
            # illegal txn must not register write-conflict ranges the
            # pipeline will never log (phantom aborts for others)
            illegal = set()
            for idx, req in enumerate(reqs):
                if any(m.type not in LEGAL_MUTATIONS
                       for m in req.mutations):
                    flow.cover("proxy.commit.illegal_mutation")
                    illegal.add(idx)
            if illegal:
                reqs = [r._replace(read_conflict_ranges=(),
                                   write_conflict_ranges=(), mutations=())
                        if i in illegal else r
                        for i, r in enumerate(reqs)]
            ver = await self.master_ref.get_reply(self._moves_seen,
                                                  self.process)
            # apply version-stamped keyResolvers moves BEFORE routing:
            # this batch's version is at/above every carried move's
            # effective version, and every other proxy applies the same
            # move before ITS first batch at/above that version — the
            # apply point is a property of the version chain, not of
            # per-proxy delivery timing (ref: keyResolvers riding the
            # commit stream, MasterProxyServer.actor.cpp:204)
            for entry in ver.moves:
                self.key_resolvers.apply(entry)
            self._moves_seen += len(ver.moves)
            if path_armed:
                t_ver = flow.now()
            self._mark(dbg,
                       "MasterProxyServer.commitBatch.GotCommitVersion")

            # phase 2: conflict resolution — single resolver fast path, or
            # key-range split across resolvers with min-combined verdicts
            # (ref: ResolutionRequestBuilder :265-341, combine :585-592).
            # The interlock releases once the requests are IN FLIGHT, so
            # successive batches resolve concurrently and the resolver
            # orders them by the global version chain (ref: commitBatch
            # sets latestLocalCommitBatchResolving before awaiting).
            if len(self.resolver_refs) == 1:
                vf = self.resolver_refs[0].get_reply(
                    ResolveRequest(ver.prev_version, ver.version,
                                   tuple(reqs), debug_ids=dbg),
                    self.process)
            else:
                vf = flow.spawn(self._resolve_split(ver, reqs),
                                TaskPriority.PROXY_COMMIT)
            self._advance(self.batch_resolving, local)
            self._note_resolving(+1)
            try:
                verdicts, conflict_ranges = self._norm_verdicts(
                    await vf, len(reqs))
            finally:
                self._note_resolving(-1)
            if path_armed:
                t_res = flow.now()
            self._mark(dbg,
                       "MasterProxyServer.commitBatch.AfterResolution")
            # modeled proxy commit-pipeline service time
            # (SIM_COMMIT_COST_PER_TXN, default 0 = off): the proxy-side
            # twin of the resolver's modeled cost, charged per
            # transaction after resolution — mutation assembly + push
            # are the proxy's own CPU in the role-per-process capacity
            # model min(R/resolve_cost, P/commit_cost)
            ccost = float(SERVER_KNOBS.sim_commit_cost_per_txn)
            if ccost > 0 and reqs:
                await self._charge_commit_cost(ccost * len(reqs))

            # phase 3: assemble mutations of committed transactions with
            # their destination storage tags, resolving versionstamped
            # operations with the commit version (ref: commitBatch phase 3
            # — tag assignment per mutation via keyServers)
            mutations = []
            for idx, (req, verdict) in enumerate(zip(reqs, verdicts)):
                if verdict != COMMITTED or idx in illegal:
                    continue
                stamp = None
                for m in req.mutations:
                    if m.type in (SET_VERSIONSTAMPED_KEY,
                                  SET_VERSIONSTAMPED_VALUE):
                        if stamp is None:
                            stamp = make_versionstamp(ver.version, idx)
                        m = _apply_versionstamp(m, stamp)
                    mutations.append(TaggedMutation(self._tags_for(m), m))

            # phase 4: log push to the whole log set, ordered (ref:
            # latestLocalCommitBatchLogging + TagPartitionedLogSystem push
            # :404 — a commit is acked only when EVERY log in the set has
            # made it durable, so any single survivor carries all acked
            # data at recovery). The interlock is released at PUSH time,
            # not at fsync ack — the TLog itself sequences commits via
            # queue_version — so successive batches' fsyncs overlap (ref:
            # commitBatch releases logging order before waiting, :910-937).
            await self.batch_logging.when_at_least(local - 1)
            creq = TLogCommitRequest(ver.prev_version, ver.version,
                                     tuple(mutations),
                                     self.committed_version.get(),
                                     debug_ids=dbg)
            log_done = flow.all_of([ref.get_reply(creq, self.process)
                                    for ref in self.tlog_refs])
            self._advance(self.batch_logging, local)
            await log_done
            if path_armed:
                t_push = flow.now()
            self._mark(dbg, "MasterProxyServer.commitBatch.AfterLogPush")
            if self.committed_version.get() < ver.version:
                self.committed_version.set(ver.version)
            # applyMetadataMutation analogue: committed management-key
            # mutations are forwarded to the CC, which reacts (config
            # change -> epoch recovery, exclusion updates). One-way and
            # AFTER the log push: the keys are durable before anyone
            # acts on them (ref: ApplyMetadataMutation.h — the proxy is
            # where system mutations gain meaning)
            if self._management_ref is not None:
                meta = tuple(tm.mutation for tm in mutations
                             if _is_management_mutation(tm.mutation))
                if meta:
                    self._management_ref.send(
                        MetadataMutations(ver.version, meta), self.process)

            # breach-drill injection (COMMIT_LATENCY_INJECTION):
            # a directed soak arms this to prove the burn-rate SLO
            # pages — 0 (the default) is one knob read, no delay, no
            # schedule change
            inj = SERVER_KNOBS.commit_latency_injection
            if inj:
                await flow.delay(inj)

            # phase 5: per-transaction replies
            st = self.stats
            st.counter("commit_batches").add(1)
            st.counter("commit_batch_txns").add(len(reqs))
            account = bool(SERVER_KNOBS.qos_tag_accounting)
            now_acct = flow.now() if account else 0.0
            elapsed = flow.now() - t0
            t_end = t0 + elapsed
            for idx, (verdict, reply) in enumerate(zip(verdicts, replies)):
                self.commit_bands.record(elapsed)
                if path_armed:
                    # per-txn decomposition: batcher wait is THIS txn's
                    # (from its arrival stamp), the downstream segments
                    # are the batch's shared phase boundaries
                    arr = self.path.take_arrival(reply, t0)
                    self.path.record(
                        {"proxy_batcher": t0 - arr,
                         "commit_version": t_ver - t0,
                         "resolve": t_res - t_ver,
                         "tlog_fsync": t_push - t_res,
                         "reply": t_end - t_push},
                        t_end - arr)
                # server-side repair first (server/repair.py): a
                # conflicted-but-repairable transaction is re-executed
                # at THIS batch's version and resubmitted instead of
                # aborting — its reply (and its tag/priority
                # accounting) settles with the resubmission's outcome
                # only FIRST-attempt conflicts are captured: a repair
                # RESUBMISSION that conflicts again reports back to
                # the repair actor that owns it (which holds the
                # range's serialization lock and loops) — capturing it
                # here would nest a second actor behind that same lock
                attempt = getattr(reqs[idx], "repair_attempt", 0)
                repairing = (verdict not in (COMMITTED, TOO_OLD)
                             and idx not in illegal
                             and attempt == 0
                             and self.repair.try_repair(
                                 reqs[idx], reply, ver.version,
                                 conflict_ranges[idx]))
                # a resubmission that conflicts with budget left will
                # be retried by its repair actor — account only the
                # TERMINAL outcome, or one client txn counts N times
                interim = (attempt > 0
                           and verdict not in (COMMITTED, TOO_OLD)
                           and attempt < int(
                               SERVER_KNOBS.repair_max_attempts))
                if account and not repairing and not interim:
                    self._account(reqs[idx], verdict, idx in illegal,
                                  now_acct)
                if repairing:
                    flow.cover("proxy.commit.repair_pending")
                elif idx in illegal:
                    reply.send_error(error("client_invalid_operation"))
                elif verdict == COMMITTED:
                    st.counter("transactions_committed").add(1)
                    reply.send(CommitReply(ver.version, idx))
                elif verdict == TOO_OLD:
                    flow.cover("proxy.commit.too_old")
                    st.counter("transactions_too_old").add(1)
                    reply.send_error(error("transaction_too_old"))
                else:
                    flow.cover("proxy.commit.conflict")
                    if not interim:
                        # interim repair rounds must not inflate the
                        # conflict rate: one client txn, one terminal
                        # outcome (same invariant as _account above)
                        st.counter("transactions_conflicted").add(1)
                    if getattr(reqs[idx], "report_conflicting_keys",
                               False):
                        # a reporting client gets the attributed key
                        # ranges as a VALUE reply and raises
                        # not_committed itself (errors carry no payload
                        # across the wire)
                        flow.cover("proxy.commit.report_conflicting")
                        reply.send(CommitConflictReply(
                            tuple(conflict_ranges[idx])))
                    else:
                        reply.send_error(error("not_committed"))
        except flow.FdbError as e:
            # a dead or locked downstream role means this proxy's epoch
            # is over; the batch may or may not have reached a log, so
            # clients get commit_unknown_result and retry through a
            # refreshed proxy (ref: the proxy dying with its epoch and
            # NativeAPI mapping broken connections to
            # commit_unknown_result)
            if e.name in ("tlog_stopped", "broken_promise",
                          "operation_cancelled"):
                # operation_cancelled = this proxy's actors were torn
                # down mid-batch (epoch over): same unknown outcome as
                # a broken downstream
                e = error("commit_unknown_result")
            for reply in replies:
                reply.send_error(e)
        finally:
            flow.g_trace_batch.finish_spans(spans)
            self._advance(self.batch_resolving, local)
            self._advance(self.batch_logging, local)
            if path_armed:
                # error paths skip phase 5: drop their arrival stamps
                # so the bounded map never carries dead replies
                for reply in replies:
                    self.path.take_arrival(reply, 0.0)

    @staticmethod
    def _advance(nv: NotifiedVersion, to: int) -> None:
        if nv.get() < to:
            nv.set(to)

    def _account(self, req, verdict: int, illegal: bool,
                 now: float) -> None:
        """Per-priority / per-tag outcome accounting (QOS_TAG_ACCOUNTING
        gated at the caller): priority classes ride plain counters (the
        metric sampler and trace-counters rollup pick them up for
        free); client tags go through the bounded decaying table."""
        prio = PRIORITY_NAMES.get(
            getattr(req, "priority", PRIORITY_DEFAULT), "default")
        if illegal:
            outcome = "illegal"
        elif verdict == COMMITTED:
            outcome = "committed"
        elif verdict == TOO_OLD:
            outcome = "too_old"
        else:
            outcome = "conflicted"
        if outcome in ("committed", "conflicted"):
            self.stats.counter(
                f"transactions_{outcome}_{prio}").add(1)
        for tag in getattr(req, "tags", ()) or ():
            self.tag_counter.record(tag, "started", now)
            if outcome in ("committed", "conflicted"):
                self.tag_counter.record(tag, outcome, now, weight=0.0)

    def qos_sample(self, now: float) -> "QosSample":
        """Saturation-signal snapshot (ref: the GRV queue depth /
        batch-occupancy surface of GrvProxyMetrics): smoothed GRV queue
        depth, commit-batch occupancy (mean txns per batch over the
        window — a full batcher means the proxy, not the clients, sets
        the pace), resolve in-flight, and admission/commit rates."""
        from .types import QosSample
        snap = self.stats.snapshot()
        batch_rate = self._qos_batch_rate.sample_total(
            snap.get("commit_batches", 0), now)
        txn_rate = self._qos_txn_rate.sample_total(
            snap.get("commit_batch_txns", 0), now)
        return QosSample("proxy", self.process.name, now, {
            "grv_queue_depth": round(self._qos_grv_queue.sample(
                len(self._grv_queue) + self.admission.depth(), now), 2),
            "commit_batch_occupancy": round(
                txn_rate / batch_rate, 2) if batch_rate > 0 else 0.0,
            "resolve_in_flight": self._resolving_now,
            "grv_rate": round(self._qos_started_rate.sample_total(
                snap.get("transactions_started", 0), now), 2),
            "commit_rate": round(txn_rate, 2),
            "tps_budget": self._rate,
        })

    def _repair_fallback_account(self, req) -> None:
        """A terminal abort delivered by the repair engine itself
        (re-read failure and friends): restore the conflict accounting
        phase 5 skipped when it captured this transaction — the txn
        DID conflict, and tag/priority QoS rates must not undercount
        exactly when the cluster is degraded."""
        self.stats.counter("transactions_conflicted").add(1)
        if SERVER_KNOBS.qos_tag_accounting:
            self._account(req, CONFLICT, False, flow.now())

    def update_hot_spots(self, rows) -> None:
        """CC-pushed cluster-merged hot-spot rows -> the admission
        scheduler's predictor AND the GRV conflict-window piggyback
        (rows arrive hottest-first: (begin, end, score, total,
        last_conflict_version))."""
        self.scheduler.update_hot_spots(rows, flow.now())
        k = SERVER_KNOBS
        min_score = float(k.conflict_window_score_min)
        top = int(k.conflict_window_top_k)
        self._conflict_windows = tuple(
            (b, e, v) for b, e, s, _t, v in rows[:top] if s >= min_score)

    def scheduler_status(self) -> dict:
        """Admission-scheduler decision counters for status/cli/
        exporter."""
        return self.scheduler.status()

    def repair_status(self) -> dict:
        """Transaction-repair decision counters for status/cli/
        exporter."""
        return self.repair.status()

    def admission_status(self) -> dict:
        """Enforced-admission decision counters + the live tag-throttle
        rows this proxy enforces, for status/cli/exporter."""
        return self.admission.status()

    def _note_resolving(self, delta: int) -> None:
        """Concurrently-resolving batch gauge + high-water mark."""
        self._resolving_now += delta
        self.stats.counter("resolve_in_flight").set(self._resolving_now)
        if self._resolving_now > self._resolving_peak:
            self._resolving_peak = self._resolving_now
            self.stats.counter("resolve_in_flight_peak").set(
                self._resolving_peak)

    @staticmethod
    def _norm_verdicts(r, n):
        """Resolver replies are a bare verdict list on the common path,
        a ResolveReply (verdicts + attributed ranges) when some txn in
        the batch asked for report_conflicting_keys — normalize to
        (verdicts, ranges_per_txn)."""
        if isinstance(r, ResolveReply):
            return list(r.verdicts), list(r.conflicting_ranges)
        return list(r), [()] * n

    async def _resolve_split(self, ver, reqs):
        """Send each transaction's ranges clipped per resolver via the
        keyResolvers map (current + windowed former owners after a
        move); every resolver sees every batch version (possibly with
        no transactions) so its NotifiedVersion ordering advances; a
        transaction's verdict is the min over the resolvers that saw it
        (ref: ResolutionRequestBuilder :265-341, combine :585-592).

        tooOld is decided HERE, not per-slice: a resolver
        whose clip holds only a tooOld transaction's WRITES would see
        no read ranges, verdict it committed, and merge phantom writes
        into its history — writes the unsplit oracle never records (a
        tooOld txn contributes no ranges at all). The proxy can decide
        it exactly: resolvers process the gapless version chain in
        order, so at batch (prev -> v) every resolver's GC watermark is
        precisely max(0, prev - MWTLV) — or 0 before the epoch's first
        batch — and all resolvers agree. A tooOld transaction is
        withheld from every resolver and combined as TOO_OLD."""
        n_res = len(self.resolver_refs)
        self.key_resolvers.prune(ver.version)
        window = self.key_resolvers.window
        res_oldest = 0 if ver.prev_version <= self._recovery_version \
            else max(0, ver.prev_version - window)
        per = [[] for _ in range(n_res)]   # [(orig_idx, clipped_req)]
        too_old = set()
        for idx, req in enumerate(reqs):
            if req.read_conflict_ranges and \
                    req.read_snapshot < res_oldest:
                flow.cover("proxy.resolve_split.too_old_withheld")
                too_old.add(idx)
                continue
            rr_per = self.key_resolvers.clip_per_resolver(
                req.read_conflict_ranges, n_res)
            wr_per = self.key_resolvers.clip_per_resolver(
                req.write_conflict_ranges, n_res)
            placed = False
            for i in range(n_res):
                if rr_per[i] or wr_per[i]:
                    per[i].append((idx, req._replace(
                        read_conflict_ranges=tuple(rr_per[i]),
                        write_conflict_ranges=tuple(wr_per[i]),
                        mutations=())))
                    placed = True
            if not placed:  # no conflict ranges at all -> resolver 0
                per[0].append((idx, req._replace(mutations=())))
        futs = [ref.get_reply(
            ResolveRequest(ver.prev_version, ver.version,
                           tuple(r for _, r in plist),
                           debug_ids=self._debug_ids(
                               [r for _, r in plist])), self.process)
            for ref, plist in zip(self.resolver_refs, per)]
        results = await flow.all_of(futs)
        combined = [TOO_OLD if i in too_old else COMMITTED
                    for i in range(len(reqs))]
        ranges: list = [()] * len(reqs)
        for plist, result in zip(per, results):
            verdicts, rngs = self._norm_verdicts(result, len(plist))
            for (idx, _), v, rs in zip(plist, verdicts, rngs):
                combined[idx] = min(combined[idx], v)
                if rs:
                    # union of each resolver's attribution: the clipped
                    # pieces are disjoint per resolver, dedup only the
                    # double-delivery window after a move
                    seen = set(ranges[idx])
                    ranges[idx] = tuple(ranges[idx]) + tuple(
                        r for r in rs if r not in seen)
        return ResolveReply(tuple(combined), tuple(ranges))

