"""Client transactions: snapshot reads, read-your-writes, OCC commit.

Reference: fdbclient/NativeAPI.actor.cpp — GRV (:2854 readVersionBatcher,
lazily fetched on first read), reads through the location cache to
storage (:1273 getValue, :1712 getRange), commit (:2498 tryCommit: ship
read/write conflict ranges + mutations to a proxy), and the retry loop
(:2956 onError: backoff then reset). Read-your-writes semantics come
from overlaying the transaction's uncommitted writes on every read
(fdbclient/ReadYourWrites.actor.cpp WriteMap merge), and reads record
read-conflict ranges so the resolver can detect conflicts exactly.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right, insort
from typing import Dict, List, Optional, Tuple

from .. import flow
from ..flow import SERVER_KNOBS, Future, TaskPriority, error
from ..rpc import NetworkRef, SimProcess
from ..server import atomic as _atomic
from ..server.cluster_controller import \
    OpenDatabaseRequest as _OpenDatabaseRequest
from ..server.types import (ADD_VALUE, AND, AND_V2, APPEND_IF_FITS,
                            ATOMIC_OPS, BYTE_MAX, BYTE_MIN, CLEAR_RANGE,
                            COMPARE_AND_CLEAR, CommitRequest, KeySelector,
                            MAX, MIN, MIN_V2, MutationRef, OR, SET_VALUE,
                            SET_VERSIONSTAMPED_KEY, SET_VERSIONSTAMPED_VALUE,
                            StorageGetRangeRequest,
                            StorageGetRequest, StorageWatchRequest, XOR)

_ATOMIC_APPLY = {
    ADD_VALUE: _atomic.add, AND: _atomic.bit_and, OR: _atomic.bit_or,
    XOR: _atomic.bit_xor, APPEND_IF_FITS: _atomic.append_if_fits,
    MAX: _atomic.vmax, MIN: _atomic.vmin, BYTE_MIN: _atomic.byte_min,
    BYTE_MAX: _atomic.byte_max, COMPARE_AND_CLEAR: _atomic.compare_and_clear,
    MIN_V2: _atomic.vmin, AND_V2: _atomic.bit_and,
}

RETRYABLE = {"not_committed", "transaction_too_old", "future_version",
             "broken_promise", "commit_unknown_result", "timed_out",
             "tlog_stopped", "coordinators_changed", "wrong_shard_server",
             # the enforced-admission plane's designed overload
             # responses: a rejected GRV retries through the ordinary
             # backoff loop (ref: proxy_memory_limit_exceeded /
             # tag_throttled both retryable in NativeAPI onError)
             "proxy_memory_limit_exceeded", "tag_throttled"}

# errors that mean our picture of the cluster may be stale: re-fetch the
# ServerDBInfo before retrying (ref: the client reconnecting through
# MonitorLeader / refreshing the location cache on wrong_shard_server)
REFRESH_ERRORS = {"broken_promise", "commit_unknown_result", "tlog_stopped",
                  "coordinators_changed", "wrong_shard_server"}


# seconds before a hung role surfaces as retryable timed_out
# (ref: failure-monitored getReply); see CLIENT_REQUEST_TIMEOUT knob


def _request_timeout() -> float:
    return flow.SERVER_KNOBS.client_request_timeout

# "no limit" sentinel for range reads: the default get_range cap, the
# overlay full-fetch, and the parallel-fan-out threshold must agree
UNBOUNDED_ROW_LIMIT = 1 << 20

# The \xff system keyspace schema lives in server/systemkeys.py (one
# source of truth for client, proxy, CC, and tools): everything in
# [\xff\x02, \xff\xff) is REAL stored data committed through the
# ordinary pipeline except the materialized \xff/keyServers/ view, so
# `configure`/`exclude` are transactions the proxies interpret (ref:
# fdbclient/SystemData.cpp; ApplyMetadataMutation.h).
from ..server.systemkeys import (CONF_PREFIX, CONF_ROW_BY_FIELD,
                                 ENGINE_PREFIX, EXCLUDED_PREFIX,
                                 KEY_SERVERS_END, KEY_SERVERS_PREFIX,
                                 STORED_SYSTEM_PREFIX, SYSTEM_PREFIX,
                                 is_stored_system as _is_stored_system)


def _rpc(fut: Future) -> Future:
    return flow.timeout_error(fut, _request_timeout())


def _pick_live_proxy(info):
    """A random proxy, preferring ones the failure monitor has not
    pushed as down (all-failed falls back to any — they may be wrong)."""
    live = [p for p in info.proxies if p.name not in info.failed]
    cands = live or list(info.proxies)
    return cands[flow.g_random.random_int(0, len(cands))]


def _next_key(k: bytes) -> bytes:
    return k + b"\x00"


class Database:
    """Handle to the cluster (ref: Database/Cluster in NativeAPI). Holds
    a cached ServerDBInfo fetched from the ClusterController's
    openDatabase endpoint (ref: MonitorLeader + openDatabase handshake);
    reads route through the shard map, commits through the proxies."""

    def __init__(self, process: SimProcess, cluster_ref: NetworkRef,
                 status_ref: NetworkRef = None,
                 management_ref: NetworkRef = None,
                 coordinators=None):
        self.process = process
        self.cluster_ref = cluster_ref
        self.status_ref = status_ref
        self.management_ref = management_ref
        # coordinator ref 4-tuples: with these the client survives the
        # death of the controller it was handed — it re-finds the
        # current leader through the coordinators, exactly how the
        # reference's clients outlive any one CC (ref: MonitorLeader,
        # fdbclient/MonitorLeader.actor.cpp — the cluster file names
        # coordinators, never the CC)
        self.coordinators = coordinators
        self._leader_gen = 0       # bumped on every rediscovered leader
        self._info = None
        #: (priority, tags) -> extra logical-transaction weight beyond
        #: the waiter count (client multiplexing; see batched_grv)
        self._grv_extra: Dict = {}
        #: priority class -> waiting futures (batched per class so a
        #: BATCH rider can never borrow DEFAULT's admission)
        self._grv_waiters: Dict[int, List[Future]] = {}
        self._grv_timer_armed = False
        #: replica name -> latency EMA seconds (ref: LoadBalance's
        #: per-alternative latency model, fdbrpc/LoadBalance.actor.h)
        self._latency_ema: Dict[str, float] = {}
        self._watch_task = None   # standing dbinfo long-poll
        # sampled transaction profiling (client/profiling.py): the
        # per-database transaction ordinal the deterministic sampling
        # decision hashes, and its lazily-derived salt
        self._txn_seq = 0
        self._profile_salt: Optional[int] = None
        # hot-key conflict windows ridden in on GRV replies
        # (server/scheduler.py ConflictWindowCache): database-scoped so
        # every transaction — including every RETRY attempt — consults
        # the same picture; lazily created on the first window-carrying
        # reply, so the feature-off path allocates nothing
        self._conflict_cache = None
        # server-advertised tag throttles ridden in on GRV replies
        # (server/tag_throttler.py ClientTagThrottleCache): same
        # plumbing — database-scoped so retries honor the backoff too,
        # lazily created on the first throttle-carrying reply
        self._tag_throttle_cache = None

    def note_latency(self, replica: str, seconds: float) -> None:
        prev = self._latency_ema.get(replica)
        self._latency_ema[replica] = seconds if prev is None else \
            0.9 * prev + 0.1 * seconds

    async def get_status(self) -> dict:
        """The cluster status document (ref: StatusClient fetching the
        CC-assembled JSON, fdbclient/StatusClient.actor.cpp)."""
        if self.status_ref is None:
            raise error("client_invalid_operation")
        from ..server.types import STATUS_REQUEST
        return await _rpc(
            self.status_ref.get_reply(STATUS_REQUEST, self.process))

    async def _live_workers(self, without: str = "") -> int:
        """Alive, non-excluded workers per status — the client-side
        recruitability check (ref: ManagementAPI changeConfig /
        excludeServers sanity checks run CLIENT side; the committed
        system keys are authoritative afterwards)."""
        st = await self.get_status()
        cl = st.get("cluster", {})
        excluded = set(cl.get("configuration", {}).get("excluded", ()))
        return sum(1 for name, w in cl.get("workers", {}).items()
                   if w.get("alive") and name not in excluded
                   and name != without)

    async def configure(self, **kwargs) -> None:
        """Change the transaction-subsystem shape (n_proxies,
        n_resolvers, n_logs, conflict_backend) by COMMITTING the new
        values into \\xff/conf/ — the proxies interpret the metadata
        mutations and the CC reacts with an epoch recovery (ref:
        ManagementAPI changeConfig building a \\xff/conf/ transaction;
        ApplyMetadataMutation.h). Validation (recruitable shape, known
        backend) runs client-side, like the reference's changeConfig."""
        updates = {k: v for k, v in kwargs.items() if v is not None}
        names = {"n_proxies", "n_resolvers", "n_logs",
                 "conflict_backend", "usable_regions"}
        if not set(updates) <= names:
            raise error("invalid_option_value")
        ints = {k: v for k, v in updates.items() if k != "conflict_backend"}
        if any(not isinstance(v, int) or v < 1 for v in ints.values()):
            raise error("invalid_option_value")
        if updates.get("conflict_backend") is not None:
            from ..models.native_backend import CONFLICT_BACKENDS
            if updates["conflict_backend"] not in CONFLICT_BACKENDS:
                raise error("invalid_option_value")
        if updates.get("usable_regions") not in (None, 1, 2):
            raise error("invalid_option_value")
        role_counts = {k: v for k, v in ints.items()
                       if k != "usable_regions"}
        if role_counts:
            live = await self._live_workers()
            if any(v > live for v in role_counts.values()):
                raise error("invalid_option_value")
        if not updates:
            return

        async def body(tr):
            tr.set_option("access_system_keys")
            for k, v in updates.items():
                key = CONF_PREFIX + CONF_ROW_BY_FIELD[k].encode()
                tr.set(key, str(v).encode())
        await run_transaction(self, body, max_retries=200)

    async def exclude(self, worker: str, exclude: bool = True) -> None:
        """Bar a worker from hosting roles by committing
        \\xff/excluded/<worker> (ref: ManagementAPI excludeServers
        writing \\xff/conf/excluded/ keys; include again clears the
        row). The leaves-recruitable safety check runs client-side,
        as the reference's does."""
        if exclude:
            st = await self.get_status()
            cfg = st.get("cluster", {}).get("configuration", {})
            need = max(cfg.get("logs", 1), cfg.get("proxies", 1),
                       cfg.get("resolvers", 1), 1)
            if await self._live_workers(without=worker) < need:
                raise error("invalid_option_value")

        async def body(tr):
            tr.set_option("access_system_keys")
            key = EXCLUDED_PREFIX + worker.encode()
            if exclude:
                tr.set(key, b"")
            else:
                tr.clear(key)
        await run_transaction(self, body, max_retries=200)

    async def change_coordinators(self, coordinators) -> None:
        """Move the coordinated state to a new coordinator set; the
        old coordinators forward until decommissioned (ref:
        ManagementAPI changeQuorum / `coordinators` in fdbcli). The
        change is durable once this returns — the move has a longer
        quorum path than other management ops, hence the wider bound."""
        from ..server.cluster_controller import ChangeCoordinatorsRequest
        if self.management_ref is None:
            raise error("client_invalid_operation")
        await flow.timeout_error(self.management_ref.get_reply(
            ChangeCoordinatorsRequest(tuple(coordinators)), self.process),
            30.0)

    @staticmethod
    def _ref_endpoint(r) -> tuple:
        ep = getattr(r, "endpoint", None)
        if ep is None:
            return (id(r),)
        return (ep.process.name, ep.token)

    async def _try_rediscover(self) -> bool:
        """Re-find the cluster controller through the coordinators
        after the one we knew stopped answering (ref: MonitorLeader's
        standing coordinator poll). Returns True when the leader moved
        and the endpoints were swapped."""
        if not self.coordinators:
            return False
        from ..server.coordination import get_leader
        li = await get_leader(self.coordinators, b"\xff/clusterLeader",
                              self.process)
        if li is None or getattr(li, "open_db", None) is None:
            return False
        if self._ref_endpoint(li.open_db) == \
                self._ref_endpoint(self.cluster_ref):
            return False
        flow.cover("client.leader_rediscovered")
        self.cluster_ref = li.open_db
        self.status_ref = li.status or self.status_ref
        self.management_ref = li.management or self.management_ref
        # broadcast sequences are per-controller: start over (the gen
        # bump tells in-flight transactions their captured seq is from
        # the dead leader)
        self._leader_gen += 1
        self._info = None
        return True

    async def info(self):
        if self._info is None:
            while True:
                try:
                    self._info = await flow.timeout_error(
                        self.cluster_ref.get_reply(
                            _OpenDatabaseRequest(-1), self.process),
                        _request_timeout())
                    break
                except flow.FdbError as e:
                    if e.name == "operation_cancelled":
                        raise
                    if await self._try_rediscover():
                        continue
                    if e.name == "timed_out" or self.coordinators:
                        await flow.delay(
                            flow.SERVER_KNOBS.client_retry_backoff_min,
                            TaskPriority.DEFAULT_ENDPOINT)
                        continue
                    raise
            # keep the picture fresh from here on: long-poll the CC's
            # broadcast so PUSHED state (failure monitor, recoveries)
            # reaches a long-lived client before — not after — it burns
            # a timeout on a known-dead endpoint (ref: MonitorLeader's
            # standing connection + FailureMonitorClient)
            if self._watch_task is None:
                self._watch_task = flow.spawn(
                    self._watch_info(), TaskPriority.DEFAULT_ENDPOINT,
                    name="client.infoWatch")
        return self._info

    async def _watch_info(self) -> None:
        while True:
            try:
                seq = self._info.seq if self._info is not None else -1
                info = await self.cluster_ref.get_reply(
                    _OpenDatabaseRequest(seq), self.process)
                if self._info is None or info.seq > self._info.seq:
                    self._info = info
            except flow.FdbError as e:
                if e.name == "operation_cancelled":
                    raise  # teardown must actually tear this down
                try:
                    await self._try_rediscover()
                except flow.FdbError as e2:
                    if e2.name == "operation_cancelled":
                        raise
                await flow.delay(flow.SERVER_KNOBS.client_rediscover_delay,
                                 TaskPriority.DEFAULT_ENDPOINT)

    def close(self) -> None:
        """Stop the standing dbinfo watcher (sim Databases are
        otherwise scheduler-lifetime objects)."""
        if self._watch_task is not None:
            self._watch_task.cancel()
            self._watch_task = None

    async def refresh_past(self, used_seq: int) -> None:
        """Ensure the cached picture is newer than `used_seq` — the
        broadcast sequence the FAILED attempt actually used. Long-polls
        the CC only when the cache hasn't already moved past it: another
        transaction's retry may have refreshed first, and waiting for
        something newer than an already-current picture would deadlock
        a healthy cluster."""
        if self._info is not None and self._info.seq > used_seq:
            return
        while True:
            try:
                self._info = await flow.timeout_error(
                    self.cluster_ref.get_reply(
                        _OpenDatabaseRequest(used_seq), self.process),
                    _request_timeout())
                return
            except flow.FdbError as e:
                if e.name == "operation_cancelled":
                    raise
                if await self._try_rediscover():
                    # a NEW controller numbers its broadcasts from 1:
                    # any picture of it is newer than the dead one's
                    used_seq = -1
                    continue
                if e.name == "timed_out" or self.coordinators:
                    # CC alive but mid-recovery (keep long-polling), or
                    # dead with a successor still being elected (keep
                    # polling the coordinators) — both transient
                    await flow.delay(
                        flow.SERVER_KNOBS.client_retry_backoff_min,
                        TaskPriority.DEFAULT_ENDPOINT)
                    continue
                raise

    async def proxy(self):
        return _pick_live_proxy(await self.info())

    async def shard_for(self, key: bytes):
        info = await self.info()
        return info.storages[_shard_index(info.storages, key)]

    def batched_grv(self, priority: Optional[int] = None,
                    tags: Tuple[bytes, ...] = (),
                    weight: int = 1) -> Future:
        """Batch concurrent GRV REQUESTS into one proxy round trip PER
        PRIORITY CLASS (ref: readVersionBatcher,
        NativeAPI.actor.cpp:2854) — and per tag set, once tag
        throttling arms, so the proxy's per-tag admission gate sees the
        tags it must charge. Requests are collected for one batch
        interval and THEN fetched — a request must never join a fetch
        already in flight, or a client could receive a version
        predating its own acknowledged commit."""
        from ..server.types import PRIORITY_DEFAULT
        if priority is None:
            priority = PRIORITY_DEFAULT
        f = Future()
        key = (priority, tuple(tags))
        self._grv_waiters.setdefault(key, []).append(f)
        if weight > 1:
            # client-multiplexing: one wire GRV may stand in
            # for `weight` logical client transactions — the request's
            # transaction_count carries the full weight, so the proxy's
            # token buckets and the ratekeeper see the true offered
            # load even when a storm drives 10^6 simulated clients
            # through a handful of handles (ref: the batched
            # transaction_count in GetReadVersionRequest)
            self._grv_extra[key] = self._grv_extra.get(key, 0) \
                + (weight - 1)
        if not self._grv_timer_armed:
            self._grv_timer_armed = True
            flow.spawn(self._grv_batch_fire(),
                       TaskPriority.DEFAULT_ENDPOINT,
                       name="client.grvBatch")
        return f

    async def _grv_batch_fire(self) -> None:
        await flow.delay(SERVER_KNOBS.grv_batch_interval,
                         TaskPriority.DEFAULT_ENDPOINT)
        by_prio, self._grv_waiters = self._grv_waiters, {}
        extra, self._grv_extra = self._grv_extra, {}
        self._grv_timer_armed = False
        # classes fetch CONCURRENTLY: a throttled or dead-proxy fetch in
        # one class must not head-of-line block (or, on cancellation,
        # strand) another class's independent round trip
        for (priority, tags), waiters in by_prio.items():
            flow.spawn(self._grv_fetch_one(priority, tags, waiters,
                                           extra.get((priority, tags), 0)),
                       TaskPriority.DEFAULT_ENDPOINT,
                       name=f"client.grvFetch.p{priority}")

    async def _grv_fetch_one(self, priority: int, tags, waiters,
                             extra: int = 0) -> None:
        from ..server.types import GetReadVersionRequest
        info = None
        try:
            info = await self.info()
            proxy = await self.proxy()
            reply = await _rpc(proxy.grvs.get_reply(
                GetReadVersionRequest(len(waiters) + extra, priority, tags),
                self.process))
            windows = getattr(reply, "conflict_windows", ())
            if windows:
                if self._conflict_cache is None:
                    from ..server.scheduler import ConflictWindowCache
                    self._conflict_cache = ConflictWindowCache()
                self._conflict_cache.update(windows, flow.now())
            throttles = getattr(reply, "tag_throttles", ())
            if throttles:
                if self._tag_throttle_cache is None:
                    from ..server.tag_throttler import \
                        ClientTagThrottleCache
                    self._tag_throttle_cache = ClientTagThrottleCache()
                self._tag_throttle_cache.update(throttles, flow.now())
            for f in waiters:
                if not f.is_ready:
                    f.send((reply.version, info.seq))
        except flow.FdbError as e:
            # the batcher owns the seq its fetch used, so IT refreshes
            # the shared picture before failing the waiters — their
            # retries then run against the healed cluster (individual
            # transactions no longer see the seq on this path)
            if info is not None and e.name in REFRESH_ERRORS:
                try:
                    await self.refresh_past(info.seq)
                except flow.FdbError:
                    pass
            for f in waiters:
                if not f.is_ready:
                    f.send_error(e)
        except BaseException:
            # anything else (cancellation, internal error) must not
            # strand the swapped-out waiters in a silent deadlock
            for f in waiters:
                if not f.is_ready:
                    f.send_error(error("operation_failed"))
            raise

    async def honor_tag_throttles(self, tags,
                                  max_delay: Optional[float] = None) -> None:
        """Client-honored backoff (ref: the client-side tag-throttle
        delay in NativeAPI's readVersionBatcher): a tag the server
        advertised as throttled paces itself locally BEFORE the next
        GRV, so the shed work never reaches the proxy's queue at all.
        `max_delay` clips one wait (a transaction's TIMEOUT deadline
        must not be slept through before its own machinery can fire).
        Zero-cost until a throttle-carrying reply created the cache."""
        cache = self._tag_throttle_cache
        if cache is None:
            return
        d = cache.delay(tags, flow.now())
        if max_delay is not None:
            d = min(d, max(0.0, max_delay))
        if d > 0:
            from ..server.tag_throttler import note_backoff
            flow.cover("client.tag_backoff")
            note_backoff(d)
            await flow.delay(d, TaskPriority.DEFAULT_ENDPOINT)

    def create_transaction(self) -> "Transaction":
        return Transaction(self)

    def _maybe_sample(self):
        """The PROFILE_SAMPLE_RATE sampling decision for one fresh
        transaction (ref: NativeAPI's CSI sampling). Deterministic:
        hashes this database's transaction ordinal with a salt derived
        from the seeded RNG and the client's process name — no RNG
        state is consumed, so sampling never perturbs the simulation's
        event order. Only called when the rate knob is nonzero."""
        from . import profiling
        self._txn_seq += 1
        rate = float(flow.SERVER_KNOBS.profile_sample_rate)
        if self._profile_salt is None:
            import zlib
            # remote (TCP) clients have no sim process: a fixed name
            # keeps the decision well-defined there too
            name = (self.process.name if self.process is not None
                    else "remote-client")
            self._profile_salt = profiling._mix64(
                flow.g_random.seed ^ zlib.crc32(name.encode()))
        if not profiling.sample_decision(self._profile_salt,
                                         self._txn_seq, rate):
            return None
        profiling.note_sampled()
        rec_id = "%08x%016x" % (self._profile_salt & 0xFFFFFFFF,
                                self._txn_seq)
        return profiling.TransactionProfile(rec_id, flow.now())


def _shard_index(storages, key: bytes) -> int:
    """Last shard whose begin <= key (storages sorted by begin)."""
    for i in range(len(storages) - 1, -1, -1):
        if key >= storages[i].begin:
            return i
    return 0


def _overlapping_shards(storages, begin: bytes, end: bytes):
    out = []
    for s in storages:
        s_end = s.end
        if (s_end is None or begin < s_end) and s.begin < end:
            out.append(s)
    return out


class Transaction:
    def __init__(self, db: Database, sampled: bool = True):
        self.db = db
        # sampled=False marks internal transactions (the profile flush
        # writer) that must never themselves be profiled
        self.reset()
        # the sampling decision runs ONCE per logical transaction, at
        # creation: when the rate knob is 0 (the default) this is one
        # attribute read and a falsy test — the provably-zero-overhead
        # gate the bench relies on
        if sampled and flow.SERVER_KNOBS.profile_sample_rate:
            self._profile = db._maybe_sample()

    def set_option(self, option: str, value=None) -> None:
        """(ref: fdb_transaction_set_option — the subset with behavior
        here: ACCESS_SYSTEM_KEYS admits \\xff\\x02 writes; TIMEOUT
        bounds the transaction INCLUDING retries in seconds;
        RETRY_LIMIT caps on_error resets. Timeout/retry state survives
        reset() the way the reference's options do.)"""
        from ..server.types import PRIORITY_BATCH, PRIORITY_IMMEDIATE
        if option == "access_system_keys":
            self._access_system = True
            self._read_system = True
        elif option == "read_system_keys":
            # read-only admission to \xff (ref: READ_SYSTEM_KEYS)
            self._read_system = True
        elif option in ("timeout", "retry_limit"):
            try:
                value = float(value) if option == "timeout" else int(value)
            except (TypeError, ValueError):
                raise error("invalid_option_value") from None
            # fdb sentinels: 0 disables the timeout; a negative retry
            # limit means unlimited
            if option == "timeout":
                self._timeout_seconds = value if value > 0 else None
                self._timeout_deadline = (flow.now() + value
                                          if value > 0 else None)
            else:
                self._retry_limit = value if value >= 0 else None
        elif option == "debug_transaction_identifier":
            # sampled-transaction stitching (ref: the TransactionDebug
            # attach + per-station events through the commit path)
            self._debug_id = value
        elif option == "transaction_logging_enable":
            # force-sample THIS transaction regardless of the
            # database-level rate (ref: TRANSACTION_LOGGING_ENABLE with
            # an optional identifier). The identifier becomes the
            # record id in \xff\x02/fdbClientInfo/client_latency/, so
            # it may not contain the key schema's field separator.
            if self._profile is None:
                from . import profiling
                self.db._txn_seq += 1
                # the ordinal suffix keeps two transactions armed with
                # the SAME identifier in the same sim tick from
                # colliding on record keys (same start_ts + rec_id
                # would silently overwrite)
                ident = "%s-%08x" % (
                    str(value).replace("/", "_") if value else "opt",
                    self.db._txn_seq)
                profiling.note_sampled()
                self._profile = profiling.TransactionProfile(
                    ident, flow.now())
        elif option == "automatic_repair":
            # the transaction-repair contract (server/repair.py): the
            # client declares its read-set is fully recorded as read
            # conflicts and its writes do not depend on read VALUES
            # (atomic ops, blind sets/clears), so a conflicted commit
            # may be repaired server-side — invalidated reads
            # re-executed at the conflict version and the commit
            # revalidated — instead of aborting. The server verifies
            # what it can (mutation types) and falls back to the
            # ordinary abort otherwise; with TXN_REPAIR off the flag
            # rides the wire inert.
            self._repairable = True
        elif option == "report_conflicting_keys":
            # a conflicted commit surfaces WHICH read ranges aborted it
            # (ref: the REPORT_CONFLICTING_KEYS option + the
            # \xff\xff/transaction/conflicting_keys/ special keyspace);
            # read back via get_conflicting_ranges() after not_committed
            self._report_conflicting = True
        elif option == "priority_batch":
            self._grv_priority = PRIORITY_BATCH
        elif option == "priority_system_immediate":
            self._grv_priority = PRIORITY_IMMEDIATE
        elif option == "grv_batch_weight":
            # this transaction's GRV stands in for `value` logical
            # client transactions (storm client-multiplexing — the wire
            # request's transaction_count carries the full weight so
            # admission control charges the true offered load)
            try:
                weight = int(value)
            except (TypeError, ValueError):
                raise error("invalid_option_value")
            if weight < 1:
                raise error("invalid_option_value")
            self._grv_weight = weight
        elif option == "transaction_tag":
            # tag this transaction for the proxy's per-tag traffic
            # accounting (and the tag throttling that will ride it;
            # ref: the TAG transaction option / TagSet — bounded count
            # and length, duplicates collapse)
            if isinstance(value, str):
                value = value.encode()
            if not isinstance(value, bytes) or not value:
                raise error("invalid_option_value")
            if len(value) > int(
                    flow.SERVER_KNOBS.max_transaction_tag_length):
                raise error("tag_too_long")
            tags = getattr(self, "_tags", ())
            if value not in tags:
                if len(tags) >= int(
                        flow.SERVER_KNOBS.max_tags_per_transaction):
                    raise error("too_many_tags")
                self._tags = tags + (value,)
        else:
            raise error("invalid_option_value")

    def _rpc(self, fut: Future) -> Future:
        """Per-request timeout, clipped to the transaction's TIMEOUT
        deadline so an in-flight stall can't overshoot the configured
        bound by a whole request timeout."""
        deadline = getattr(self, "_timeout_deadline", None)
        if deadline is None:
            return _rpc(fut)
        remaining = deadline - flow.now()
        if remaining <= 0:
            fut.abandon()
            return flow.error_future(error("transaction_timed_out"))
        if remaining >= _request_timeout():
            return _rpc(fut)
        return flow.timeout_error(fut, remaining, "transaction_timed_out")

    def _check_writable(self, begin: bytes,
                        end: Optional[bytes] = None) -> None:
        """ACCESS_SYSTEM_KEYS admits the STORED system region
        [\\xff\\x02, \\xff\\xff) — conf/excluded/backup/latency-probe
        rows are real transactional data there — but never the
        materialized \\xff/keyServers/ view (a write there would commit
        into a space reads never consult, a silent black hole) and
        never \\xff\\xff engine metadata."""
        sys_ok = getattr(self, "_access_system", False)
        if end is None:  # point write
            if begin.startswith(SYSTEM_PREFIX) and not (
                    sys_ok and _is_stored_system(begin)):
                raise error("key_outside_legal_range")
        else:            # range [begin, end): end is exclusive
            if begin.startswith(SYSTEM_PREFIX) or end > SYSTEM_PREFIX:
                if not (sys_ok and STORED_SYSTEM_PREFIX <= begin
                        and end <= ENGINE_PREFIX
                        and not (begin < KEY_SERVERS_END
                                 and end > KEY_SERVERS_PREFIX)):
                    raise error("key_outside_legal_range")

    def reset(self) -> None:
        self._access_system = False   # options reset with the txn
        self._read_system = False
        self._debug_id = None
        self._profile = None          # re-armed by __init__/set_option
        self._grv_priority = None     # ...including the priority class
        self._grv_weight = 1          # ...and the multiplexing weight
        self._tags = ()               # ...and the transaction tags
        self._report_conflicting = False
        self._repairable = False      # automatic_repair declaration
        self._conflicting_ranges = None   # last conflicted commit's causes
        # timeout/retry OPTIONS survive an explicit reset, but their
        # spent budgets re-arm — a reused object starts a fresh logical
        # transaction (ref: fdb reset semantics)
        self._retries_used = 0
        if getattr(self, "_timeout_seconds", None) is not None:
            self._timeout_deadline = flow.now() + self._timeout_seconds
        self._used_seq: int = 0       # newest dbinfo seq this attempt saw
        # broadcast sequences are per-controller: remember WHICH leader
        # the seq came from, so a retry after a failover never long-polls
        # the new controller for the dead one's sequence numbers
        self._used_leader_gen: int = getattr(self.db, "_leader_gen", 0)
        self._read_version: Optional[int] = None
        self._writes: Dict[bytes, Optional[bytes]] = {}  # RYW write map
        self._write_order: List[bytes] = []              # sorted keys
        self._cleared: List[Tuple[bytes, bytes]] = []    # ordered clears
        self._ops: Dict[bytes, List[Tuple[int, bytes]]] = {}  # pending atomics
        self._mutations: List[MutationRef] = []
        self._read_conflicts: List[Tuple[bytes, bytes]] = []
        self._write_conflicts: List[Tuple[bytes, bytes]] = []
        self._watches: List[Tuple[bytes, Future]] = []
        self._txn_bytes = 0
        self.committed_version: Optional[int] = None
        self.committed_batch_index: Optional[int] = None

    async def _get_info(self):
        """Cluster picture for this attempt, recording the seq so
        on_error knows which picture actually failed."""
        info = await self.db.info()
        if info.seq > self._used_seq:
            self._used_seq = info.seq
        return info

    async def _proxy(self):
        return _pick_live_proxy(await self._get_info())

    async def _shard(self, key: bytes):
        info = await self._get_info()
        return info.storages[_shard_index(info.storages, key)]

    async def _storage_rpc(self, shard, fn):
        """Latency-modeled replica selection with backup requests (ref:
        fdbrpc/LoadBalance.actor.h — alternatives ordered by measured
        latency; a slow first choice gets a duplicate request to the
        next alternative and the first reply wins; connection-class
        failures penalize the replica's model and rotate on)."""
        db = self.db
        ema = db._latency_ema
        info = await self._get_info()
        down = set(info.failed)
        reps = list(shard.replicas)
        start = flow.g_random.random_int(0, len(reps))
        reps = reps[start:] + reps[:start]     # tie-break rotation
        # replicas the failure monitor pushed as DOWN sort last: they
        # stay reachable as a final fallback but never burn the first
        # attempt's latency (ref: FailureMonitorClient-informed
        # LoadBalance ordering)
        reps.sort(key=lambda r: (r.name in down,
                                 ema.get(r.name, 0.0)))  # stable sort
        inflight = []   # (replica, settled-wrapper, t0)
        last_err = None
        idx = 0
        while True:
            if not inflight:
                if idx >= len(reps):
                    raise last_err or error("all_alternatives_failed")
                rep = reps[idx]
                idx += 1
                inflight.append((rep, flow.catch_errors(self._rpc(fn(rep))),
                                 flow.now()))
            race = [w for _, w, _ in inflight]
            if idx < len(reps):
                race.append(flow.delay(
                    SERVER_KNOBS.load_balance_backup_delay))
            i, settled = await flow.first_of(*race)
            if i >= len(inflight):
                # backup window elapsed: duplicate to the next replica
                rep = reps[idx]
                idx += 1
                inflight.append((rep, flow.catch_errors(self._rpc(fn(rep))),
                                 flow.now()))
                continue
            rep, _w, t0 = inflight.pop(i)
            if not settled.is_error:
                db.note_latency(rep.name, flow.now() - t0)
                # abandoned rivals still pay: elapsed-so-far is a true
                # lower bound on their latency — without it a slow
                # replica never enters the model and (defaulting to 0)
                # would sort FIRST on every later read
                for lrep, _lw, lt0 in inflight:
                    db.note_latency(lrep.name, flow.now() - lt0)
                return settled.get()
            e = settled.exception()
            if e.name not in ("broken_promise", "timed_out"):
                raise e
            db.note_latency(rep.name, _request_timeout())  # penalty
            last_err = e

    # -- read version ---------------------------------------------------
    async def get_read_version(self) -> int:
        if self._read_version is None:
            prof = self._profile
            t0 = flow.now() if prof is not None else 0.0
            # tags ride the GRV request ONLY while tag throttling is
            # armed (one knob read) — the off-posture wire request is
            # byte-identical to the pre-subsystem one. A throttled tag
            # delays locally first; immediate-priority traffic is
            # never tag-throttled (matching the server's gate).
            grv_tags: tuple = ()
            if flow.SERVER_KNOBS.tag_throttling:
                grv_tags = tuple(getattr(self, "_tags", ()))
                if grv_tags:
                    from ..server.types import PRIORITY_IMMEDIATE
                    if getattr(self, "_grv_priority", None) != \
                            PRIORITY_IMMEDIATE:
                        # a TIMEOUT-bounded transaction never sleeps
                        # past its own deadline honoring a throttle
                        ddl = getattr(self, "_timeout_deadline", None)
                        await self.db.honor_tag_throttles(
                            grv_tags,
                            None if ddl is None else ddl - flow.now())
            fut = self.db.batched_grv(getattr(self, "_grv_priority", None),
                                      grv_tags,
                                      getattr(self, "_grv_weight", 1))
            deadline = getattr(self, "_timeout_deadline", None)
            if deadline is not None:
                # the shared class fetch continues for other waiters;
                # only THIS transaction's wait is deadline-bounded
                fut = flow.timeout_error(
                    fut, max(deadline - flow.now(), 0.001),
                    "transaction_timed_out")
            try:
                version, seq = await fut
            except flow.FdbError as e:
                if prof is not None:
                    from .profiling import ErrorEvent
                    prof.add(ErrorEvent(t0, "grv", e.name))
                raise
            if prof is not None:
                from .profiling import GetVersionEvent
                from ..server.types import PRIORITY_DEFAULT
                prio = getattr(self, "_grv_priority", None)
                # explicit None test: PRIORITY_BATCH is 0 and must not
                # fall through to the default label
                prof.add(GetVersionEvent(
                    t0, flow.now() - t0,
                    PRIORITY_DEFAULT if prio is None else prio))
            if seq > self._used_seq:
                self._used_seq = seq
            self._read_version = version
        return self._read_version

    # -- RYW overlay ----------------------------------------------------
    def _overlay_get(self, key: bytes):
        """(found, value) against uncommitted writes, newest-first."""
        if key in self._writes:
            return True, self._writes[key]
        for b, e in reversed(self._cleared):
            if b <= key < e:
                return True, None
        return False, None

    # -- system keyspace -------------------------------------------------
    async def _system_rows(self) -> List[Tuple[bytes, bytes]]:
        """The MATERIALIZED system rows, sorted: only the keyServers
        map is synthesized from the broadcast picture — conf/excluded
        are real stored rows committed through the pipeline (ref:
        SystemData.cpp: \\xff as the coordination medium, not a
        read-only view)."""
        info = await self._get_info()
        rows = [(KEY_SERVERS_PREFIX + s.begin,
                 b",".join(r.name.encode() for r in s.replicas))
                for s in info.storages]
        rows.sort()
        return rows

    async def _system_get(self, key: bytes) -> Optional[bytes]:
        if key.startswith(KEY_SERVERS_PREFIX):
            # the team owning an arbitrary key (ref: keyServers reads)
            k = key[len(KEY_SERVERS_PREFIX):]
            info = await self._get_info()
            s = info.storages[_shard_index(info.storages, k)]
            return b",".join(r.name.encode() for r in s.replicas)
        for rk, rv in await self._system_rows():
            if rk == key:
                return rv
        return None

    # -- reads ----------------------------------------------------------
    def _read_tags(self) -> tuple:
        """Transaction tags for the storage server's read-cost
        accounting — attached only while the storage heat plane is
        armed, so the read requests stay byte-identical to the
        pre-plane ones otherwise (the GRV-tag contract)."""
        if flow.SERVER_KNOBS.storage_heat_tracking:
            return tuple(getattr(self, "_tags", ()))
        return ()

    async def _base_get(self, key: bytes) -> Optional[bytes]:
        found, val = self._overlay_get(key)
        if found:
            return val
        version = await self.get_read_version()
        shard = await self._shard(key)
        debug_id = getattr(self, "_debug_id", None)
        if debug_id is not None:
            # sampled-read stitching (ref: the GetValueDebug stations,
            # NativeAPI getValue Before/After around the storage leg)
            flow.g_trace_batch.add_event("GetValueDebug", debug_id,
                                         "NativeAPI.getValue.Before")
        ok = False
        try:
            val = await self._storage_rpc(
                shard, lambda rep: rep.gets.get_reply(
                    StorageGetRequest(key, version, debug_id,
                                      self._read_tags()),
                    self.db.process))
            ok = True
        finally:
            if debug_id is not None:
                # every exit path — success, FdbError, cancellation —
                # closes the Before station: a duration-pairing
                # consumer must never see a dangling Before (ref: the
                # getValue error station)
                flow.g_trace_batch.add_event(
                    "GetValueDebug", debug_id,
                    "NativeAPI.getValue.After" if ok
                    else "NativeAPI.getValue.Error")
        return val

    async def get(self, key: bytes, snapshot: bool = False) -> Optional[bytes]:
        prof = self._profile
        if prof is None:
            return await self._get_impl(key, snapshot)
        from .profiling import ErrorEvent, GetEvent
        t0 = flow.now()
        try:
            val = await self._get_impl(key, snapshot)
        except flow.FdbError as e:
            prof.add(ErrorEvent(t0, "get", e.name))
            raise
        prof.add(GetEvent(t0, flow.now() - t0, key,
                          -1 if val is None else len(val)))
        return val

    async def _get_impl(self, key: bytes,
                        snapshot: bool = False) -> Optional[bytes]:
        if key.startswith(SYSTEM_PREFIX):
            # \xff reads need READ/ACCESS_SYSTEM_KEYS (ref: NativeAPI
            # validateKey — key_outside_legal_range without the option)
            if not getattr(self, "_read_system", False):
                raise error("key_outside_legal_range")
            if not _is_stored_system(key):
                return await self._system_get(key)
        if not snapshot:
            self._read_conflicts.append((key, _next_key(key)))
        val = await self._base_get(key)
        # pending atomic ops computed over the base (ref: RYW reads of
        # atomically-modified keys, ReadYourWrites.actor.cpp)
        for op, param in self._ops.get(key, ()):
            val = _ATOMIC_APPLY[op](val, param)
        return val

    async def get_key(self, selector: KeySelector,
                      snapshot: bool = False) -> bytes:
        """Resolve a key selector against the READ-YOUR-WRITES view —
        the merged stream of committed data, materialized system rows,
        and this transaction's uncommitted writes/clears (ref:
        ReadYourWrites getKey through RYWIterator; found as a
        divergence by the WriteDuringRead model checker: the old path
        resolved against storage alone). All anchors resolve via
        bounded merged scans over get_range, so get_key always agrees
        with what range reads enumerate; READ_SYSTEM_KEYS widens the
        walk to the system region."""
        # anchor == b"\xff" (allKeys.end) stays legal without the option
        # — last_less_than(\xff) is the canonical "last key" idiom, the
        # same exclusive-end convention the range gate honors
        read_sys = getattr(self, "_read_system", False)
        if selector.key.startswith(SYSTEM_PREFIX) and \
                selector.key != SYSTEM_PREFIX and not read_sys:
            raise error("key_outside_legal_range")
        hi_bound = ENGINE_PREFIX if read_sys else SYSTEM_PREFIX
        anchor = (selector.key + b"\x00" if selector.or_equal
                  else selector.key)
        if selector.offset >= 1:
            # the offset-th present merged key >= anchor
            b = min(anchor, hi_bound)
            rows = []
            if b < hi_bound:
                rows = await self._get_range_impl(b, hi_bound,
                                            limit=selector.offset,
                                            snapshot=True)
            resolved = (rows[selector.offset - 1][0]
                        if len(rows) >= selector.offset else hi_bound)
        else:
            # the (1-offset)-th present merged key < anchor
            needed = 1 - selector.offset
            e = min(anchor, hi_bound)
            rows = []
            if e > b"":
                rows = await self._get_range_impl(b"", e, limit=needed,
                                            snapshot=True, reverse=True)
            resolved = (rows[needed - 1][0] if len(rows) >= needed
                        else b"")
        # without READ_SYSTEM_KEYS a selector walking off the end of
        # user space clamps to maxKey instead of leaking stored \xff
        # rows (ref: getKey clamps at allKeys.end)
        if resolved > SYSTEM_PREFIX and not read_sys:
            resolved = SYSTEM_PREFIX
        if not snapshot:
            lo = min(resolved, selector.key)
            hi = max(resolved, selector.key)
            self._read_conflicts.append((lo, _next_key(hi)))
        return resolved

    async def get_range(self, begin, end, limit: int = UNBOUNDED_ROW_LIMIT,
                        snapshot: bool = False,
                        reverse: bool = False) -> List[Tuple[bytes, bytes]]:
        prof = self._profile
        if prof is None:
            return await self._get_range_impl(begin, end, limit,
                                              snapshot, reverse)
        from .profiling import ErrorEvent, GetRangeEvent
        t0 = flow.now()
        try:
            rows = await self._get_range_impl(begin, end, limit,
                                              snapshot, reverse)
        except flow.FdbError as e:
            prof.add(ErrorEvent(t0, "get_range", e.name))
            raise
        prof.add(GetRangeEvent(
            t0, flow.now() - t0,
            begin.key if isinstance(begin, KeySelector) else begin,
            end.key if isinstance(end, KeySelector) else end, len(rows)))
        return rows

    async def _get_range_impl(self, begin, end,
                              limit: int = UNBOUNDED_ROW_LIMIT,
                              snapshot: bool = False,
                              reverse: bool = False) -> List[Tuple[bytes, bytes]]:
        if isinstance(begin, KeySelector):
            begin = await self.get_key(begin, snapshot=snapshot)
        if isinstance(end, KeySelector):
            end = await self.get_key(end, snapshot=snapshot)
        if begin >= end:
            return []
        if not getattr(self, "_read_system", False):
            # [begin, end) must stay inside user space (ref: NativeAPI
            # validateKeyRange — key_outside_legal_range beyond \xff
            # without READ/ACCESS_SYSTEM_KEYS)
            if begin.startswith(SYSTEM_PREFIX) or end > SYSTEM_PREFIX:
                raise error("key_outside_legal_range")
        elif end > ENGINE_PREFIX:
            raise error("key_outside_legal_range")
        elif not begin.startswith(SYSTEM_PREFIX) and end > SYSTEM_PREFIX:
            # a scan crossing from user space into \xff must see the
            # SAME system rows an \xff-anchored scan serves (materialized
            # + stored) — split at the boundary and merge
            rows = await self._get_range_impl(begin, SYSTEM_PREFIX, limit=limit,
                                        snapshot=snapshot, reverse=reverse)
            rows += await self._get_range_impl(SYSTEM_PREFIX, end, limit=limit,
                                         snapshot=snapshot, reverse=reverse)
            return sorted(rows, reverse=reverse)[:limit]
        if begin.startswith(SYSTEM_PREFIX) and (
                not _is_stored_system(begin)
                or (begin < KEY_SERVERS_END and end > KEY_SERVERS_PREFIX)):
            # the range touches the materialized keyServers view (or
            # starts below the stored region): merge the synthesized
            # rows with the stored subranges around the keyServers hole
            rows = [(k, v) for k, v in await self._system_rows()
                    if begin <= k < end]
            lo = max(begin, STORED_SYSTEM_PREFIX)
            hi = min(end, ENGINE_PREFIX)
            for b2, e2 in ((lo, min(hi, KEY_SERVERS_PREFIX)),
                           (max(lo, KEY_SERVERS_END), hi)):
                if b2 < e2:
                    rows += await self._get_range_impl(b2, e2,
                                                 snapshot=snapshot)
            return sorted(rows, reverse=reverse)[:limit]
        version = await self.get_read_version()
        # With no RYW overlay in the range the storage servers honor the
        # caller's limit/reverse directly. Overlay writes/atomics remove
        # at most one base row each, so the base fetch stays BOUNDED at
        # limit + overlay count (in the requested direction — the
        # truncated prefix then provably contains the merged top-limit
        # rows). Only a clear intersecting the range can delete
        # unboundedly many base rows and forces the full fetch
        # (ref: RYWIterator reads through the WriteMap instead).
        lo = bisect_left(self._write_order, begin)
        hi = bisect_left(self._write_order, end)
        n_ops = sum(1 for k in self._ops if begin <= k < end)
        clear_in_range = any(b < end and e > begin
                             for b, e in self._cleared)
        has_overlay = bool(hi > lo or n_ops or clear_in_range)
        if clear_in_range:
            fetch_limit, fetch_rev = UNBOUNDED_ROW_LIMIT, False
        elif has_overlay:
            fetch_limit = min(limit + (hi - lo) + n_ops,
                              UNBOUNDED_ROW_LIMIT)
            fetch_rev = reverse
        else:
            fetch_limit, fetch_rev = limit, reverse
        base = await self._fetch_range(begin, end, version, fetch_limit,
                                       fetch_rev)
        # overlay uncommitted writes (ref: RYWIterator merge)
        merged: Dict[bytes, bytes] = {k: v for k, v in base}
        for b, e in self._cleared:
            for k in [k for k in merged if b <= k < e]:
                del merged[k]
        for k in self._write_order[lo:hi]:
            v = self._writes[k]
            if v is None:
                merged.pop(k, None)
            else:
                merged[k] = v
        # keys with pending atomic ops materialize from their base value
        for k, ops in self._ops.items():
            if begin <= k < end:
                val = merged.get(k)
                if val is None and k not in self._writes and \
                        not any(b <= k < e for b, e in self._cleared):
                    shard = await self._shard(k)
                    val = await self._storage_rpc(
                        shard, lambda rep, k=k: rep.gets.get_reply(
                            StorageGetRequest(k, version,
                                              tags=self._read_tags()),
                            self.db.process))
                for op, param in ops:
                    val = _ATOMIC_APPLY[op](val, param)
                if val is None:
                    merged.pop(k, None)
                else:
                    merged[k] = val
        out = sorted(merged.items(), reverse=reverse)[:limit]
        if not snapshot:
            # record only the observed portion: when the limit truncates,
            # keys past the last returned row were never promised to the
            # caller (ref: record-what-was-read conflict semantics,
            # NativeAPI getRange → tr.addReadConflictRange of the
            # readThrough bound)
            if len(out) == limit and out:
                if reverse:
                    self._read_conflicts.append((out[-1][0], end))
                else:
                    self._read_conflicts.append((begin, _next_key(out[-1][0])))
            else:
                self._read_conflicts.append((begin, end))
        return out

    async def _fetch_range(self, begin: bytes, end: bytes, version: int,
                           limit: int, reverse: bool):
        """Fan a range read across the shards it overlaps, honoring the
        limit shard by shard (ref: NativeAPI getRange iterating the
        location cache)."""
        info = await self._get_info()
        shards = _overlapping_shards(info.storages, begin, end)
        if reverse:
            shards = shards[::-1]
        # the piece of [begin, end) each shard owns
        clamped = [(s, max(begin, s.begin),
                    end if s.end is None else min(end, s.end))
                   for s in shards]
        if limit >= UNBOUNDED_ROW_LIMIT and len(shards) > 1:
            # effectively-unbounded scan: fan the shards out in
            # PARALLEL and concatenate in shard order — the limit can't
            # truncate, so per-shard requests are independent (ref:
            # NativeAPI getRange issuing parallel requests when limits
            # permit). The race settles on the FIRST error (the serial
            # path's prompt-retry behavior) and cancels the rest.
            rtags = self._read_tags()
            futs = [flow.spawn(self._storage_rpc(
                s, lambda rep, b=b, e=e: rep.ranges.get_reply(
                    StorageGetRangeRequest(b, e, version, limit, reverse,
                                           rtags),
                    self.db.process))) for s, b, e in clamped]
            wrappers = [flow.catch_errors(f) for f in futs]
            results: List = [None] * len(futs)
            pending = set(range(len(futs)))
            try:
                while pending:
                    order = sorted(pending)
                    i, settled = await flow.first_of(
                        *[wrappers[j] for j in order])
                    idx = order[i]
                    pending.discard(idx)
                    if settled.is_error:
                        raise settled.exception()
                    results[idx] = settled.get()
            finally:
                for f in futs:
                    if not f.is_ready:
                        f.cancel()
            out: List[Tuple[bytes, bytes]] = []
            for part in results:
                out.extend(part)
            return out
        out = []
        rtags = self._read_tags()
        for _s, b, e in clamped:
            part = await self._storage_rpc(
                _s, lambda rep, b=b, e=e: rep.ranges.get_reply(
                    StorageGetRangeRequest(b, e, version, limit - len(out),
                                           reverse, rtags),
                    self.db.process))
            out.extend(part)
            if len(out) >= limit:
                break
        return out

    # -- writes ---------------------------------------------------------
    def _check_sizes(self, key: bytes, value: bytes = b"",
                     slack: int = 0) -> None:
        """(ref: NativeAPI size checks — key_too_large /
        value_too_large raised client-side before anything ships).
        `slack` admits synthesized range-end bounds like keyAfter(k),
        which may run one byte past the user key limit."""
        if len(key) > SERVER_KNOBS.key_size_limit + slack:
            raise error("key_too_large")
        if len(value) > SERVER_KNOBS.value_size_limit:
            raise error("value_too_large")
        self._txn_bytes += len(key) + len(value)
        if self._txn_bytes > SERVER_KNOBS.transaction_size_limit:
            raise error("transaction_too_large")

    def _record_write(self, key: bytes, value: Optional[bytes]) -> None:
        if key not in self._writes:
            insort(self._write_order, key)
        self._writes[key] = value

    def set(self, key: bytes, value: bytes) -> None:
        self._check_writable(key)
        self._check_sizes(key, value)
        self._record_write(key, value)
        self._ops.pop(key, None)  # a set supersedes pending atomics
        self._mutations.append(MutationRef(SET_VALUE, key, value))
        self._write_conflicts.append((key, _next_key(key)))

    def clear(self, key: bytes) -> None:
        self.clear_range(key, _next_key(key))

    def clear_range(self, begin: bytes, end: bytes) -> None:
        if begin >= end:
            return
        self._check_writable(begin, end)
        self._check_sizes(begin)
        self._check_sizes(end, slack=1)  # keyAfter(max-size key) is legal
        self._cleared.append((begin, end))
        lo = bisect_left(self._write_order, begin)
        hi = bisect_left(self._write_order, end)
        for k in self._write_order[lo:hi]:
            self._writes[k] = None
        for k in [k for k in self._ops if begin <= k < end]:
            del self._ops[k]
        self._mutations.append(MutationRef(CLEAR_RANGE, begin, end))
        self._write_conflicts.append((begin, end))

    def atomic_op(self, key: bytes, param: bytes, op_type: int) -> None:
        """(ref: Transaction::atomicOp / fdbclient/Atomic.h op table)"""
        self._check_writable(key)
        self._check_sizes(key, param)
        if op_type in (SET_VERSIONSTAMPED_KEY, SET_VERSIONSTAMPED_VALUE):
            # transformed at the proxy with the commit version; the
            # operand's trailing 4 bytes are the placeholder offset
            self._mutations.append(MutationRef(op_type, key, param))
            wkey = key[:-4] if op_type == SET_VERSIONSTAMPED_KEY else key
            self._write_conflicts.append((wkey, _next_key(wkey)))
            return
        if op_type not in ATOMIC_OPS:
            raise error("client_invalid_operation")
        # a set/clear'd key has a known value: fold the op in directly
        found, cur = self._overlay_get(key)
        if found and key not in self._ops:
            result = _ATOMIC_APPLY[op_type](cur, param)
            if result is None:
                self._record_write(key, None)
                self._mutations.append(
                    MutationRef(CLEAR_RANGE, key, _next_key(key)))
            else:
                self._record_write(key, result)
                self._mutations.append(MutationRef(SET_VALUE, key, result))
        else:
            self._ops.setdefault(key, []).append((op_type, param))
            self._mutations.append(MutationRef(op_type, key, param))
        self._write_conflicts.append((key, _next_key(key)))

    def watch(self, key: bytes) -> Future:
        """Future that fires when the key's value changes after this
        transaction commits (ref: Transaction::watch / storage watches).
        Errors with transaction_cancelled if the commit fails."""
        # same gate as reads: only the stored system region is
        # watchable, and only with the system-keys option (the
        # materialized \xff ranges have no storage to watch)
        if key.startswith(SYSTEM_PREFIX) and not (
                getattr(self, "_read_system", False)
                and _is_stored_system(key)):
            raise error("key_outside_legal_range")
        f = Future()
        self._watches.append((key, f))
        return f

    # -- commit ---------------------------------------------------------
    async def commit(self) -> int:
        """(ref: Transaction::commit :2710 / tryCommit :2498)"""
        prof = self._profile
        if prof is None:
            return await self._commit_impl()
        # sampled: record the commit outcome — latency, payload size,
        # and the conflict verdict (reusing the resolver's attribution
        # when report_conflicting_keys is armed) — then drain the
        # event stream into the \xff\x02/fdbClientInfo/ keyspace in
        # the background (ref: the sampled-commit EventCommit /
        # EventCommitError records)
        from .profiling import (CommitEvent, ErrorEvent, flush_profile)
        t0 = flow.now()
        n_mut, n_bytes = len(self._mutations), self._txn_bytes
        writes = tuple(self._write_conflicts)
        try:
            version = await self._commit_impl()
        except flow.FdbError as e:
            if e.name == "not_committed":
                prof.add(CommitEvent(
                    t0, flow.now() - t0, n_mut, n_bytes, writes,
                    "conflicted", 0,
                    tuple(self._conflicting_ranges or ())))
            else:
                prof.add(ErrorEvent(t0, "commit", e.name))
            raise
        finally:
            flow.spawn(flush_profile(self.db, prof),
                       TaskPriority.LOW_PRIORITY,
                       name="client.profileFlush")
        prof.add(CommitEvent(t0, flow.now() - t0, n_mut, n_bytes,
                             writes, "committed", version, ()))
        return version

    async def _commit_impl(self) -> int:
        if not self._mutations:
            # read-only: succeeds at the read version without a round trip
            self.committed_version = self._read_version or 0
            self._arm_watches(self.committed_version)
            return self.committed_version
        snapshot = await self.get_read_version()
        self._conflicting_ranges = None   # a fresh attempt's outcome only
        debug_id = getattr(self, "_debug_id", None)
        span = None
        if debug_id is not None:
            flow.g_trace_batch.add_event("CommitDebug", debug_id,
                                         "NativeAPI.commit.Before")
            # root of the commit span tree: every server leg opened
            # while this is in flight parents (transitively) onto it
            span = flow.g_trace_batch.begin_span(debug_id,
                                                 "NativeAPI.commit")
        from ..server.types import PRIORITY_DEFAULT as _PRIO_DEFAULT
        prio = getattr(self, "_grv_priority", None)
        req = CommitRequest(snapshot, tuple(self._read_conflicts),
                            tuple(self._write_conflicts),
                            tuple(self._mutations), debug_id=debug_id,
                            report_conflicting_keys=getattr(
                                self, "_report_conflicting", False),
                            priority=(_PRIO_DEFAULT if prio is None
                                      else prio),
                            tags=tuple(getattr(self, "_tags", ())),
                            repairable=getattr(self, "_repairable",
                                               False))
        try:
            # client-side early abort (server/scheduler.py conflict
            # windows): raised INSIDE this try, so watches, trace
            # stations and profiling see exactly what a resolver abort
            # produces — indistinguishable to retry loops by design
            self._check_conflict_windows(snapshot)
            proxy = await self._proxy()
            reply = await self._rpc(
                proxy.commits.get_reply(req, self.db.process))
            from ..server.types import CommitConflictReply
            if isinstance(reply, CommitConflictReply):
                # a reported conflict arrives as a VALUE carrying the
                # attributed ranges; record them and raise the same
                # retryable error a non-reporting commit would see
                self._conflicting_ranges = tuple(reply.conflicting_ranges)
                raise error("not_committed")
        except flow.FdbError as e:
            for _k, f in self._watches:
                if not f.is_ready:
                    f.send_error(error("transaction_cancelled"))
            if debug_id is not None:
                # close the Before station on failure (conflict,
                # unknown result, ...): no dangling Before, same
                # invariant as every other leg
                flow.g_trace_batch.add_event("CommitDebug", debug_id,
                                             "NativeAPI.commit.Error")
            raise e
        finally:
            if span is not None:
                span.finish()
        self.committed_version = reply.version
        self.committed_batch_index = reply.batch_index
        if debug_id is not None:
            flow.g_trace_batch.add_event("CommitDebug", debug_id,
                                         "NativeAPI.commit.After")
        self._arm_watches(reply.version)
        return reply.version

    def _check_conflict_windows(self, snapshot: int) -> None:
        """Hot-key early abort (ref: *Early Detection for MVCC
        Conflicts in Hyperledger Fabric*): a commit whose read ranges
        overlap a cached, still-fresh conflict window NEWER than its
        snapshot is near-certain to abort at the resolver — fail it
        locally before it consumes a proxy round trip and a resolver
        slot. The retry then starts sooner AND with a fresh snapshot.
        Raises the same not_committed a resolver abort produces."""
        cache = self.db._conflict_cache
        if cache is None or \
                not flow.SERVER_KNOBS.client_conflict_windows:
            return
        if getattr(self, "_repairable", False):
            # a repairable transaction PROFITS from submitting: the
            # server repairs the predicted conflict into a commit,
            # which an early abort would forfeit — the two planes
            # compose instead of fighting
            return
        from ..server.types import PRIORITY_IMMEDIATE
        if getattr(self, "_grv_priority", None) == PRIORITY_IMMEDIATE:
            return   # immediate traffic bypasses the heuristic gate
        hit = cache.doomed(self._read_conflicts, snapshot, flow.now())
        if not hit:
            return
        flow.cover("client.window_early_abort")
        from ..server.scheduler import note_early_abort
        note_early_abort()
        if getattr(self, "_report_conflicting", False):
            # same surface as a reported resolver conflict
            self._conflicting_ranges = tuple(hit)
        raise error("not_committed")

    def get_conflicting_ranges(self):
        """The key ranges that aborted the last conflicted commit, or
        None when no reported conflict happened (requires the
        report_conflicting_keys option; ref: reading
        \\xff\\xff/transaction/conflicting_keys/ after not_committed).
        Survives on_error's reset so the retry attempt can inspect
        what went wrong."""
        return getattr(self, "_conflicting_ranges", None)

    def get_versionstamp(self) -> bytes:
        """The committed transaction's 10-byte versionstamp."""
        if self.committed_version is None:
            raise error("client_invalid_operation")
        from ..server.proxy import make_versionstamp
        return make_versionstamp(self.committed_version,
                                 self.committed_batch_index or 0)

    def _arm_watches(self, version: int) -> None:
        """Wire pending watches to their shards at the commit version."""
        watches, self._watches = self._watches, []
        if watches:
            flow.spawn(self._arm_watches_async(watches, version),
                       TaskPriority.DEFAULT_ENDPOINT)

    async def _arm_watches_async(self, watches, version: int) -> None:
        for key, f in watches:
            if f.is_ready:
                continue
            shard = await self.db.shard_for(key)
            rep = shard.replicas[flow.g_random.random_int(
                0, len(shard.replicas))]
            if rep.watches is None:
                # a seam without watch endpoints (older gateways, the C
                # binding's describe): fail the future cleanly instead
                # of crashing the actor
                f.send_error(error("client_invalid_operation"))
                continue
            storage_fut = rep.watches.get_reply(
                StorageWatchRequest(key, version), self.db.process)
            storage_fut.on_ready(
                lambda sf, f=f: (f.send(sf.get()) if not sf.is_error
                                 else f.send_error(sf.exception()))
                if not f.is_ready else None)

    # -- retry loop -----------------------------------------------------
    async def on_error(self, e: BaseException) -> None:
        """(ref: Transaction::onError :2956 — backoff and reset; a
        failure that implies a stale cluster picture re-fetches the
        ServerDBInfo first, which long-polls across an in-flight
        recovery; TIMEOUT/RETRY_LIMIT options bound the loop)"""
        if not (isinstance(e, flow.FdbError) and e.name in RETRYABLE):
            raise e
        deadline = getattr(self, "_timeout_deadline", None)
        if deadline is not None and flow.now() >= deadline:
            raise error("transaction_timed_out")
        limit = getattr(self, "_retry_limit", None)
        if limit is not None:
            self._retries_used = getattr(self, "_retries_used", 0) + 1
            if self._retries_used > limit:
                raise e
        flow.cover("client.retry.conflict", e.name == "not_committed")
        if e.name in REFRESH_ERRORS:
            flow.cover("client.refresh_stale_picture")
            used = self._used_seq \
                if self._used_leader_gen == self.db._leader_gen else -1
            await self.db.refresh_past(used)
        await flow.delay(
            flow.SERVER_KNOBS.client_retry_backoff_min
            + flow.g_random.random01()
            * flow.SERVER_KNOBS.client_retry_backoff_jitter,
                         TaskPriority.DEFAULT_ENDPOINT)
        # a RETRY reset keeps the logical transaction's spent budgets
        # and priority class — only an explicit user reset() re-arms
        retries = getattr(self, "_retries_used", 0)
        prio = getattr(self, "_grv_priority", None)
        tags = getattr(self, "_tags", ())
        repairable = getattr(self, "_repairable", False)
        debug_id = getattr(self, "_debug_id", None)
        profile = self._profile
        report = getattr(self, "_report_conflicting", False)
        conflicting = getattr(self, "_conflicting_ranges", None)
        self.reset()
        self._retries_used = retries
        self._grv_priority = prio
        self._tags = tags
        self._repairable = repairable
        # the RETRY attempt is usually the interesting one (it hit a
        # conflict/failure) — keep it sampled
        self._debug_id = debug_id
        self._profile = profile
        # keep reporting armed AND the failed attempt's attribution
        # readable (ref: the conflicting-keys special keys being read
        # in the retry loop's next attempt)
        self._report_conflicting = report
        self._conflicting_ranges = conflicting
        if deadline is not None:
            self._timeout_deadline = deadline


async def run_transaction(db: Database, body,
                          max_retries: Optional[int] = None,
                          tr: Optional["Transaction"] = None):
    """The standard retry loop (ref: the `doTransaction` idiom / python
    binding @fdb.transactional). Pass `tr` to loop over a specially
    constructed transaction (the profiling machinery's unsampled
    ones) instead of a fresh default."""
    if max_retries is None:
        max_retries = int(flow.SERVER_KNOBS.client_default_max_retries)
    if tr is None:
        tr = db.create_transaction()
    for _ in range(max_retries):
        try:
            result = await body(tr)
            await tr.commit()
            return result
        except flow.FdbError as e:
            await tr.on_error(e)
    raise error("transaction_timed_out")
