"""Master role: commit-version authority + the epoch recovery state
machine.

Reference: fdbserver/masterserver.actor.cpp —
  - `getVersion` (:875-940): versions advance with real time
    (`version += VERSIONS_PER_SECOND * dt`, capped per request) so a
    version is also a coarse clock; each batch receives
    (prev_version, version) so downstream stages sequence without gaps.
  - `masterCore` (:1212): the recovery phases — read the coordinated
    state, end the previous epoch by locking its logs
    (TagPartitionedLogSystem.actor.cpp:1265 epochEnd), recruit a new
    transaction subsystem (recruitEverything :537), commit the new core
    state exclusively (a competing newer master makes the write fail
    with coordinated_state_conflict), broadcast the new ServerDBInfo,
    and prove the pipeline live with a recovery transaction before
    declaring FULLY_RECOVERED.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

from .. import flow
from ..flow import TaskPriority, error
from ..rpc import RequestStream, SimProcess
from . import dbinfo as dbi
from .dbinfo import LogSetInfo, ServerDBInfo
from .types import (RESOLUTION_METRICS_REQUEST, CommitRequest,
                    ResolverCheckpointRequest, ResolverInstallRequest,
                    TLogLockRequest)



class GetCommitVersionReply(NamedTuple):
    prev_version: int
    version: int
    # keyResolvers moves this proxy has not yet applied, each
    # (effective_version, begin, end_or_None, to_idx) — moves ride the
    # version chain, so every proxy applies a move at the SAME version
    # (ref: the reference versioning keyResolvers through the commit
    # stream, MasterProxyServer.actor.cpp:204 + ApplyMetadataMutation)
    moves: tuple = ()


class CoreState(NamedTuple):
    """What survives in the coordinated state (ref: DBCoreState,
    fdbserver/DBCoreState.h — enough to find and lock the previous
    epoch's logs after any set of failures)."""

    epoch: int
    recovery_version: int                 # first version of this epoch
    logs: Tuple[Tuple[str, str], ...]     # (store name, machine)
    old_logs: Tuple[Tuple[int, int, int, Tuple[Tuple[str, str], ...]], ...]
    # ^ (epoch, begin_version, end_version, stores) still draining
    # the attached remote region's log store (store, machine) — what an
    # explicitly promoted controller locks when no primary log survives
    # a region blackout (ref: DBCoreState's remote/satellite tLog sets
    # enabling epochEnd with remote logs,
    # TagPartitionedLogSystem.actor.cpp:1265)
    region_logs: Tuple[Tuple[str, str], ...] = ()


def initial_resolver_splits(n_resolvers: int) -> Tuple[bytes, ...]:
    """The recruitment-time keyspace partition across resolvers: even
    first-byte buckets. THE formula — recruitment and the gateway's
    peer-describe document (whose out-of-process proxies rebuild the
    live keyResolvers map by replaying the move log onto these splits)
    must agree, or remote proxies would clip conflict ranges against a
    different base map than in-cluster ones."""
    return tuple(bytes([(i * 256) // n_resolvers])
                 for i in range(1, n_resolvers))


class Master:
    """The version authority (one per epoch)."""

    def __init__(self, process: SimProcess, recovery_version: int = 0):
        self.process = process
        self.version = recovery_version
        self._last_time = None
        # keyResolvers move log for this epoch: every version reply
        # piggybacks the tail a proxy has not seen yet
        self.resolver_moves: list = []
        self.version_requests = RequestStream(process)
        self._actors = flow.ActorCollection()

    def start(self) -> None:
        self._actors.add(flow.spawn(self._version_loop(),
                                    TaskPriority.PROXY_GET_CONSISTENT_READ_VERSION,
                                    name=f"{self.process.name}.getVersion"))
        self.process.on_kill(self._actors.cancel_all)

    def stop(self) -> None:
        self._actors.cancel_all()

    def _next_version(self) -> GetCommitVersionReply:
        t = flow.now()
        if self._last_time is None:
            advance = 1
        else:
            advance = max(1, min(
                flow.SERVER_KNOBS.max_version_advance,
                int(flow.SERVER_KNOBS.versions_per_second
                    * (t - self._last_time))))
        self._last_time = t
        prev = self.version
        self.version = prev + advance
        return GetCommitVersionReply(prev, self.version)

    def register_move(self, begin: bytes, end, to_idx: int) -> int:
        """Stamp a keyResolvers move with the version chain: effective
        from the NEXT version this authority hands out, so every batch
        either wholly precedes or wholly follows the move on every
        proxy — no cross-proxy apply skew by construction."""
        effective = self.version + 1
        self.resolver_moves.append((effective, begin, end, to_idx))
        return effective

    def register_release(self, begin: bytes, end, from_idx: int) -> int:
        """Stamp an early FORMER-OWNER release (the live
        handoff): once the donor's clipped state is installed on the
        new owner, the window's double delivery is redundant — every
        proxy drops `from_idx` from [begin, end)'s owner history for
        batches at/above the effective version. Safe because the
        effective version is > the donor version the piece was cut at
        (versions originate here, so the donor can never be ahead of
        this authority), and the recipient's grafted state is exact
        for every batch above that."""
        effective = self.version + 1
        self.resolver_moves.append((effective, begin, end, from_idx,
                                    "release"))
        return effective

    async def _version_loop(self):
        while True:
            req, reply = await self.version_requests.pop()
            # the request IS the caller's applied-move count; anything
            # else is protocol misuse and should fail loudly, not
            # silently re-deliver the whole move log
            assert isinstance(req, int), req
            seen = req
            ver = self._next_version()
            if len(self.resolver_moves) > seen:
                ver = ver._replace(
                    moves=tuple(self.resolver_moves[seen:]))
            reply.send(ver)


class MasterRecovery:
    """One epoch's recovery attempt + lifetime (ref: masterCore)."""

    def __init__(self, process: SimProcess, cc, cstate, config):
        self.process = process
        self.cc = cc                      # ClusterController (registry)
        self.cstate = cstate              # CoordinatedState client
        self.config = config
        self.master: Optional[Master] = None
        self.epoch = 0
        # processes whose death ends this epoch (ref: the master's
        # waitFailure clients on proxies/resolvers/tlogs)
        self.critical_procs: set = set()
        self.aux = flow.ActorCollection()  # epoch-lifetime helper actors

    def _trace(self, event: str, **details) -> None:
        flow.TraceEvent(event, self.process.name).detail(**details).log()

    async def run(self) -> None:
        """Drive recovery to FULLY_RECOVERED, then serve versions until
        cancelled (the CC cancels us and starts a successor on
        failure)."""
        cfg = self.config

        # Phase 1: read the coordinated state (ref: masterCore phase
        # READING_CSTATE via ReusableCoordinatedState)
        self._set_state(dbi.READING_CSTATE)
        prev: Optional[CoreState] = await self.cstate.read()

        # Phase 2: end the previous epoch — lock its logs and find the
        # recovery version (ref: epochEnd)
        recovery_version = 0
        old_log_sets: Tuple[LogSetInfo, ...] = ()
        if prev is not None and self.cc.takeover_from_region \
                and prev.region_logs:
            # explicit region failover (ref: forced recovery from the
            # remote log sets, TagPartitionedLogSystem.actor.cpp:1265 +
            # fdbcli force_recovery_with_data_loss): lock the REGION's
            # log instead of the (blacked-out) primary's. Everything the
            # router shipped recovers; the unshipped tail — bounded by
            # the advertised lag — is what an async region admits
            # losing. Older primary generations are abandoned with the
            # primary: their undrained remainder is part of that loss.
            self._set_state(dbi.LOCKING_CSTATE)
            recovery_version, locked = await self._epoch_end_region(prev)
            old_log_sets = (LogSetInfo(
                prev.epoch, 0, recovery_version, locked,
                stores=tuple(prev.region_logs) + tuple(prev.logs)),)
            # older generations may still matter: a router lagging
            # across an epoch boundary reads the gap from that epoch's
            # satellite replicas, which survive the blackout. A
            # generation with NO surviving store died whole with the
            # primary — in a takeover that is part of the admitted
            # loss, and carrying it would wedge every reader behind a
            # generation that can never answer (pre-attach data is
            # absent from the region by the attach contract anyway)
            for oe, ob, oend, stores in prev.old_logs:
                refs = tuple(r for r in (self.cc.log_stores.get(s)
                                         for s, _m in stores)
                             if r is not None)
                if not refs:
                    flow.TraceEvent(
                        "RegionTakeoverAbandonedGeneration",
                        self.process.name,
                        severity=flow.trace.SevWarnAlways).detail(
                        Epoch=oe, Begin=ob, End=oend,
                        Stores=",".join(s for s, _m in stores)).log()
                    continue
                old_log_sets += (LogSetInfo(oe, ob, oend, refs,
                                            stores=tuple(stores)),)
        elif prev is not None:
            self._set_state(dbi.LOCKING_CSTATE)
            recovery_version, locked = await self._epoch_end(prev)
            old_log_sets = (LogSetInfo(prev.epoch, prev.recovery_version,
                                       recovery_version, locked,
                                       stores=prev.logs),)
            # older generations still draining chain through. Store
            # NAMES are carried even when a store is unreachable right
            # now: its worker may still be rebooting, and dropping the
            # name would orphan the generation's records forever
            for oe, ob, oend, stores in prev.old_logs:
                refs = tuple(r for r in (self.cc.log_stores.get(s)
                                         for s, _m in stores)
                             if r is not None)
                old_log_sets += (LogSetInfo(oe, ob, oend, refs,
                                            stores=tuple(stores)),)
        self.epoch = (prev.epoch if prev is not None else 0) + 1

        # Phase 3: recruit the new transaction subsystem
        # (ref: recruitEverything :537)
        self._set_state(dbi.RECRUITING)
        self.master = Master(self.process, recovery_version=recovery_version)
        self.master.start()
        self.critical_procs = {self.process}
        # capture ONCE, before recruitment: the epoch is recruited
        # consistently even if the flags flip mid-recovery (the
        # config-dirty recovery after such a flip re-publishes)
        backup_on = self.cc.backup_active
        region = getattr(self.cc, "region", None)
        # the committed \xff/conf/usable_regions row is the operator
        # intent recruitment obeys: an attached region object with
        # usable_regions=1 is ignored (ref: DatabaseConfiguration
        # usable_regions gating the fearless log topology)
        if getattr(cfg, "usable_regions", 1) < 2:
            region = None
        # role-per-process deployment: a driver that
        # attached an ExternalRoles directory (tools/rolehost.py) hosts
        # resolvers/tlogs in their own OS processes — recruitment
        # becomes an init RPC and every ref below is a RetryingTcpRef.
        # With no directory attached (the default), this path adds
        # zero awaits and zero draws: the posture is byte-identical.
        ext = getattr(self.cc, "external_roles", None)
        new_logs = []
        new_log_stores = []
        log_recruits = []       # (worker, store) incl. satellites
        if ext is not None and ext.n_tlogs:
            assert region is None, \
                "external tlogs + region topologies are not supported"
            assert ext.n_tlogs == cfg.n_logs, (ext.n_tlogs, cfg.n_logs)
            for i in range(cfg.n_logs):
                store = f"tlog-e{self.epoch}-{i}"
                refs = await ext.recruit_tlog(i, store, recovery_version)
                self.cc.log_stores[store] = refs
                new_logs.append(refs)
                new_log_stores.append((store, refs.machine))
        else:
            log_workers = self.cc.pick_workers(cfg.n_logs, role="tlog")
            for i, w in enumerate(log_workers):
                store = f"tlog-e{self.epoch}-{i}"
                refs = w.recruit_tlog(store, recovery_version)
                self.cc.log_stores[store] = refs
                new_logs.append(refs)
                new_log_stores.append((store, w.process.machine))
                log_recruits.append((w, store))
                self.critical_procs.add(w.process)
        # satellite log replicas (ref: satelliteTagLocations — one more
        # full replica of the stream per satellite DC, so the acked
        # tail survives a primary-DC blackout). Full log-set members:
        # pushed to, locked, rotated onto, popped like any replica.
        if region is not None and region.satellite_workers:
            live_sats = [sw for sw in region.satellite_workers
                         if sw.process.alive]
            if not live_sats:
                flow.TraceEvent(
                    "RecoverySatellitesUnavailable", self.process.name,
                    severity=flow.trace.SevWarnAlways).detail(
                    Epoch=self.epoch).log()
            for i, sw in enumerate(region.satellite_workers):
                if not sw.process.alive:
                    continue
                store = f"tlog-e{self.epoch}-sat{i}"
                refs = sw.recruit_tlog(store, recovery_version)
                self.cc.log_stores[store] = refs
                new_logs.append(refs)
                new_log_stores.append((store, sw.process.machine))
                log_recruits.append((sw, store))
                self.critical_procs.add(sw.process)
        resolver_refs = []
        resolver_metrics = []
        resolver_handoffs = []
        if ext is not None and ext.n_resolvers:
            assert ext.n_resolvers == cfg.n_resolvers, \
                (ext.n_resolvers, cfg.n_resolvers)
            for i in range(cfg.n_resolvers):
                rref, mref, href = await ext.recruit_resolver(
                    i, f"resolver-e{self.epoch}-{i}", recovery_version,
                    cfg.conflict_backend)
                resolver_refs.append(rref)
                resolver_metrics.append(mref)
                resolver_handoffs.append(href)
        else:
            res_workers = self.cc.pick_workers(cfg.n_resolvers,
                                               role="resolver")
            for i, w in enumerate(res_workers):
                rref, mref, href = w.recruit_resolver(
                    f"resolver-e{self.epoch}-{i}", recovery_version,
                    backend=cfg.conflict_backend)
                resolver_refs.append(rref)
                resolver_metrics.append(mref)
                resolver_handoffs.append(href)
                self.critical_procs.add(w.process)
        # addr-carrying peer descriptors for the TcpGateway's PEER
        # describe: worker proxies connect DIRECTLY to external role
        # processes instead of trombone-ing through the gateway
        self.peer_resolvers = (ext.resolver_descriptors()
                               if ext is not None and ext.n_resolvers
                               else None)
        self.peer_tlogs = (ext.tlog_descriptors()
                           if ext is not None and ext.n_tlogs else None)
        resolver_splits = initial_resolver_splits(cfg.n_resolvers)
        self.cc.recruit_initial_storages()
        # every tag's records are held until ALL of its replicas pop
        expected = {}
        for name, (tag, _b, _e) in self.cc.shard_map.items():
            expected.setdefault(tag, []).append(name)
        expected = {t: tuple(ns) for t, ns in expected.items()}
        if backup_on:
            from .proxy import BACKUP_TAG
            from ..layers.backup_agent import AGENT_NAME
            expected[BACKUP_TAG] = (AGENT_NAME,)
        if region is not None:
            from .proxy import REGION_TAG
            expected[REGION_TAG] = (region.router_name,)
        if ext is not None and ext.n_tlogs:
            # external tlogs take the replica expectation over their
            # control token (in-process recruitment's direct method
            # call, made an RPC)
            for i in range(cfg.n_logs):
                await ext.set_expected_replicas(i, expected)
        for w, store in log_recruits:
            w.roles[store].set_expected_replicas(expected)
        storage_splits = self.cc.storage_splits()
        rk_worker = self.cc.pick_workers(1, role="ratekeeper")[0]
        rk_ref = rk_worker.recruit_ratekeeper(
            f"ratekeeper-e{self.epoch}", self.cc)
        proxy_workers = self.cc.pick_workers(cfg.n_proxies, role="proxy")
        proxies = []
        for i, w in enumerate(proxy_workers):
            proxies.append(w.recruit_proxy(
                f"proxy-e{self.epoch}-{i}",
                self.master.version_requests.ref(),
                resolver_refs, [r.commits for r in new_logs],
                resolver_splits, storage_splits,
                recovery_version, ratekeeper_ref=rk_ref,
                storage_tags=self.cc.storage_tags(),
                management_ref=self.cc.management.ref()))
            if backup_on:
                w.roles[f"proxy-e{self.epoch}-{i}"].backup_active = True
            if region is not None:
                w.roles[f"proxy-e{self.epoch}-{i}"].region_active = True
            self.critical_procs.add(w.process)
        proxies = tuple(proxies)
        # each proxy confirms GRVs with every other proxy (ref:
        # getLiveCommittedVersion)
        for i, w in enumerate(proxy_workers):
            w.roles[f"proxy-e{self.epoch}-{i}"].set_peers(
                [p.raw_committed for j, p in enumerate(proxies) if j != i])

        # Phase 4: commit the new core state; a conflict means a newer
        # master exists and this one must die (ref: trackTlogRecovery /
        # cstate.write exclusivity)
        # persist every member store's NAME, reachable or not — the
        # cstate must preserve the rejoin-by-name invariant across
        # back-to-back recoveries or a down store's generation would be
        # orphaned forever (readers would then wait on it forever)
        old_for_cstate = tuple(
            (ls.epoch, ls.begin_version, ls.end_version,
             ls.stores or tuple((r.store, r.machine) for r in ls.logs))
            for ls in old_log_sets)
        region_logs = region.log_stores() if region is not None else ()
        await self.cstate.set_exclusive(CoreState(
            self.epoch, recovery_version, tuple(new_log_stores),
            old_for_cstate, region_logs=region_logs))

        # Phase 5: broadcast the new picture; commits may now flow
        info = ServerDBInfo(
            self.epoch, dbi.ACCEPTING_COMMITS, recovery_version, proxies,
            LogSetInfo(self.epoch, recovery_version, -1, tuple(new_logs),
                       stores=tuple(new_log_stores)),
            old_log_sets, self.cc.dbinfo.get().storages,
            failed=self.cc.dbinfo.get().failed,
            backup_active=backup_on, region_attached=region is not None)
        self.cc.publish(info)
        self._trace("MasterRecoveryState", State=dbi.ACCEPTING_COMMITS,
                    Epoch=self.epoch, RecoveryVersion=recovery_version)

        # Phase 6: the recovery transaction proves the new pipeline live
        # end-to-end (ref: the recovery txn in masterCore phase 5)
        await proxies[0].commits.get_reply(
            CommitRequest(recovery_version, (), (), ()), self.process)
        # re-read at publish time: a worker that rebooted while we
        # awaited the recovery txn may have merged fresh storage
        # endpoints into the broadcast — never clobber them with the
        # snapshot captured above
        cur = self.cc.dbinfo.get()
        self.cc.publish(cur._replace(recovery_state=dbi.FULLY_RECOVERED))
        self._trace("MasterRecoveredFully", Epoch=self.epoch)

        # Lifetime: retire drained old generations + rebalance resolver
        # load; both die with this epoch (CC cancels aux on teardown)
        self.aux.add(flow.spawn(self._cleanup_old_logs(),
                                TaskPriority.CLUSTER_CONTROLLER,
                                name=f"master-e{self.epoch}.oldLogCleanup"))
        if cfg.n_resolvers > 1:
            self.aux.add(flow.spawn(
                self._resolution_balancing(resolver_metrics),
                TaskPriority.RESOLUTION_METRICS,
                name=f"master-e{self.epoch}.resolutionBalancing"))
            # load-driven split/merge with live state handoff —
            # spawned only when armed at recovery time, so the
            # RESOLVER_BALANCE=0 posture adds not a single timer event
            # to the sim schedule (byte-identical off, test-pinned)
            if flow.SERVER_KNOBS.resolver_balance:
                self.aux.add(flow.spawn(
                    self._resolver_balance_loop(
                        resolver_metrics, resolver_handoffs,
                        resolver_splits, cfg.n_resolvers),
                    TaskPriority.RESOLUTION_METRICS,
                    name=f"master-e{self.epoch}.resolverBalance"))
        await self.aux.get_result()

    def _set_state(self, state: str) -> None:
        cur = self.cc.dbinfo.get()
        self.cc.publish(cur._replace(recovery_state=state))
        self._trace("MasterRecoveryState", State=state)

    async def _epoch_end(self, prev: CoreState):
        """Lock the previous generation's logs; the recovery version is
        the max durable version across reachable replicas — the push
        path acks only when EVERY replica is durable, so any single
        survivor covers all acked commits (ref: epochEnd,
        TagPartitionedLogSystem.actor.cpp:1265)."""
        while True:
            refs = [self.cc.log_stores.get(store)
                    for store, _m in prev.logs]
            refs = [r for r in refs if r is not None]
            locked = []
            if refs:
                futs = [flow.catch_errors(flow.timeout_error(
                    r.locks.get_reply(TLogLockRequest(), self.process),
                    flow.SERVER_KNOBS.tlog_lock_timeout))
                    for r in refs]
                settled = await flow.all_of(futs)
                locked = [(r, f.get()) for r, f in zip(refs, settled)
                          if not f.is_error]
            if locked:
                recovery_version = max(rep.end_version for _r, rep in locked)
                return recovery_version, tuple(r for r, _rep in locked)
            # nothing reachable: wait for a worker reboot to re-register
            # a surviving store (ref: recovery waits for tlogs)
            self._trace("MasterRecoveryWaitingForLogs",
                        Stores=",".join(s for s, _m in prev.logs))
            await flow.delay(flow.SERVER_KNOBS.recovery_wait_for_logs_delay,
                             TaskPriority.CLUSTER_CONTROLLER)

    async def _epoch_end_region(self, prev: CoreState):
        """Explicit region takeover: lock the region's log store and
        recover at its durable frontier. The lock makes the takeover
        exact — after it, no in-flight router push can extend the
        remote log, so the reported end version is the last version the
        promoted epoch preserves (ref: epochEnd over the remote log
        set; the lock doubles as the fence the old promote() faked with
        a quiesce poll)."""
        grace = flow.now() + flow.SERVER_KNOBS.region_lock_grace
        while True:
            # the remote log PLUS whatever survives of the primary
            # epoch's log set — in a primary blackout that is exactly
            # the satellite replicas, which hold the complete acked
            # stream (push waits on every replica), so locking them
            # recovers to the acked frontier: zero data loss instead
            # of the router's shipped frontier (ref: epochEnd preferring
            # the satellite-backed recovery when remote logs lag)
            stores = tuple(prev.region_logs) + tuple(prev.logs)
            refs = {store: self.cc.log_stores.get(store)
                    for store, _m in stores}
            known = [(s, r) for s, r in refs.items() if r is not None]
            locked = []
            if known:
                futs = [flow.catch_errors(flow.timeout_error(
                    r.locks.get_reply(TLogLockRequest(), self.process),
                    flow.SERVER_KNOBS.tlog_lock_timeout))
                    for _s, r in known]
                settled = await flow.all_of(futs)
                locked = [(r, f.get()) for (_s, r), f in zip(known, settled)
                          if not f.is_error]
            # don't settle for the first lockable subset: worker
            # registrations with the freshly promoted controller race
            # this loop, and returning before the satellite stores land
            # would silently recover at the router's lagging frontier.
            # Proceed only once every store either has a locked ref or
            # the grace window for stragglers has passed (blacked-out
            # primary stores never register — they are what the grace
            # window exists to stop waiting for).
            unresolved = len(stores) - len(locked)
            if locked and (unresolved == 0 or flow.now() >= grace):
                if unresolved:
                    flow.TraceEvent(
                        "RegionTakeoverPartialLock", self.process.name,
                        severity=flow.trace.SevWarnAlways).detail(
                        Locked=len(locked), Total=len(stores)).log()
                flow.cover("master.region_takeover")
                recovery_version = max(rep.end_version
                                       for _r, rep in locked)
                return recovery_version, tuple(r for r, _ in locked)
            self._trace("MasterRecoveryWaitingForRegionLogs",
                        Stores=",".join(s for s, _m in stores))
            await flow.delay(flow.SERVER_KNOBS.recovery_wait_for_logs_delay,
                             TaskPriority.CLUSTER_CONTROLLER)

    async def _resolution_balancing(self, metric_refs) -> None:
        """Shift key-range ownership from the most- to the least-loaded
        resolver (ref: resolutionBalancing, masterserver.actor.cpp:1008
        + ResolutionSplitRequest). Per round: poll each resolver's
        cumulative work + first-byte key histogram, diff against the
        last round, and — when the spread is material — move the loaded
        resolver's hottest byte bucket, but only when the move reduces
        the maximum (a single-bucket hotspot never bounces)."""
        n = len(metric_refs)
        last_work = [0] * n
        last_hist = [[0] * 256 for _ in range(n)]
        while True:
            await flow.delay(flow.SERVER_KNOBS.resolution_balancing_interval,
                             TaskPriority.RESOLUTION_METRICS)
            if flow.SERVER_KNOBS.resolver_balance:
                # the split/merge balance loop is
                # authoritative while armed: two movers would bounce
                # ranges against each other
                continue
            settled = await flow.all_of([flow.catch_errors(
                flow.timeout_error(
                    ref.get_reply(RESOLUTION_METRICS_REQUEST,
                                  self.process),
                    flow.SERVER_KNOBS.resolution_metrics_timeout))
                for ref in metric_refs])
            if any(f.is_error for f in settled):
                continue
            replies = [f.get() for f in settled]
            dwork = [r.work_units - last_work[i]
                     for i, r in enumerate(replies)]
            dhist = [[r.key_hist[b] - last_hist[i][b] for b in range(256)]
                     for i, r in enumerate(replies)]
            last_work = [r.work_units for r in replies]
            last_hist = [list(r.key_hist) for r in replies]
            hi = max(range(n), key=lambda i: dwork[i])
            lo = min(range(n), key=lambda i: dwork[i])
            if dwork[hi] < flow.SERVER_KNOBS.resolution_balancing_min_work \
                    or dwork[hi] <= 2 * (dwork[lo] + 1):
                continue
            bucket = max(range(256), key=lambda b: dhist[hi][b])
            moved = dhist[hi][bucket]
            # only when it actually reduces the max load
            if moved <= 0 or dwork[lo] + moved >= dwork[hi]:
                continue
            begin = bytes([bucket])
            end = bytes([bucket + 1]) if bucket < 255 else None
            # the move rides the version chain: every proxy picks it up
            # with its next assigned batch version and applies it at the
            # same effective version — no per-proxy delivery, no skew
            effective = self.master.register_move(begin, end, lo)
            self._trace("ResolutionBalancingMove", Bucket=bucket,
                        From=hi, To=lo, EffectiveVersion=effective)

    async def _resolver_balance_loop(self, metric_refs, handoff_refs,
                                     init_splits, n_resolvers) -> None:
        """Load-driven resolver split/merge with LIVE state handoff
        (ref: resolutionBalancing + the keyResolvers history,
        masterserver.actor.cpp:1008 / MasterProxyServer.actor.cpp:204 —
        grown with the checkpoint/clip/install machinery).

        Per round: poll every resolver's cumulative work + first-byte
        key histogram, diff against the last round, and when the skew
        crosses the knob thresholds move the loaded resolver's hottest
        OWNED byte bucket to the least-loaded one — but through the
        full handoff protocol (`_handoff`), so the recipient votes
        bit-exactly from its first post-move batch and the donor
        retires early instead of double-delivering for a whole MVCC
        window. A previously-split bucket whose traffic has died is
        merged back to its original owner (the symmetric stitch).
        Counters land on the CC (`resolver_balance` in status)."""
        n = len(metric_refs)
        last_work = [0] * n
        last_hist = [[0] * 256 for _ in range(n)]
        # shadow of the proxies' keyResolvers CURRENT ownership: every
        # move goes through this loop, so applying our own moves keeps
        # it exact (releases don't change current ownership)
        from .proxy import KeyResolverMap
        owners = KeyResolverMap(init_splits, n_resolvers)
        splits_made: list = []   # (begin, end, from_idx, to_idx)
        force_spent = False      # one-shot FORCE consumed for good
        bal = self.cc.balance_stats
        while True:
            await flow.delay(flow.SERVER_KNOBS.resolver_balance_interval,
                             TaskPriority.RESOLUTION_METRICS)
            k = flow.SERVER_KNOBS
            if not k.resolver_balance:
                continue
            settled = await flow.all_of([flow.catch_errors(
                flow.timeout_error(
                    ref.get_reply(RESOLUTION_METRICS_REQUEST,
                                  self.process),
                    flow.SERVER_KNOBS.resolution_metrics_timeout))
                for ref in metric_refs])
            if any(f.is_error for f in settled):
                continue
            replies = [f.get() for f in settled]
            dwork = [r.work_units - last_work[i]
                     for i, r in enumerate(replies)]
            dhist = [[r.key_hist[b] - last_hist[i][b] for b in range(256)]
                     for i, r in enumerate(replies)]
            last_work = [r.work_units for r in replies]
            last_hist = [list(r.key_hist) for r in replies]

            # merge pass first: stitch back any split whose traffic
            # died, so a transient hot spot does not fragment the map
            # forever (the sharded backend's upper-bound-row dedup
            # makes the re-graft exact)
            merged = None
            for mv in splits_made:
                begin, end, src, dst = mv
                bucket = begin[0] if begin else 0
                if dhist[dst][bucket] <= int(k.resolver_balance_merge_work):
                    if await self._handoff(begin, end, dst, src,
                                           handoff_refs, owners):
                        bal.counter("merges").add(1)
                        self._trace("ResolverBalanceMerge",
                                    Bucket=bucket, From=dst, To=src)
                        merged = mv
                    break
            if merged is not None:
                splits_made.remove(merged)
                continue

            # FORCE is one-shot and STICKY: it exists so smoke/CI can
            # make the FIRST split deterministic under a small
            # workload; once consumed the real thresholds govern even
            # if that split later merges away (deriving spent-ness
            # from splits_made would re-arm after every merge and
            # churn split/merge forever)
            force = bool(k.resolver_balance_force) and not force_spent
            hi = max(range(n), key=lambda i: dwork[i])
            lo = min(range(n), key=lambda i: dwork[i])
            if hi == lo or dwork[hi] <= 0:
                continue
            if not force:
                if dwork[hi] < k.resolver_balance_min_work:
                    continue
                if dwork[hi] <= k.resolver_balance_skew * (dwork[lo] + 1):
                    continue
            # hottest byte bucket the donor CURRENTLY owns (the shadow
            # map keeps picks honest after earlier rounds moved ranges)
            owned = owners.owned_buckets(hi)
            if not owned:
                continue
            bucket = max(owned, key=lambda b: dhist[hi][b])
            moved = dhist[hi][bucket]
            if moved <= 0:
                continue
            if not force and dwork[lo] + moved >= dwork[hi]:
                continue   # a single-bucket hotspot never bounces
            begin = bytes([bucket])
            end = bytes([bucket + 1]) if bucket < 255 else None
            if await self._handoff(begin, end, hi, lo, handoff_refs,
                                   owners):
                if force:
                    force_spent = True
                bal.counter("splits").add(1)
                self.cc.balance_last = {
                    "begin": begin.hex(),
                    "end": end.hex() if end is not None else "",
                    "from": hi, "to": lo,
                    "work_moved": moved}
                self._trace("ResolverBalanceSplit", Bucket=bucket,
                            From=hi, To=lo, WorkMoved=moved)
                splits_made.append((begin, end, hi, lo))

    async def _handoff(self, begin, end, src: int, dst: int,
                       handoff_refs, owners) -> bool:
        """The live-handoff protocol for one range move:

          1. register the move (rides the version chain; proxies start
             double-delivering [begin, end) to src AND dst at E),
          2. checkpoint the donor AT/ABOVE E (the request's
             min_version parks on the donor's version chain, so the
             clipped piece provably holds every pre-move write),
          3. graft the piece into the recipient (pointwise max — exact
             whatever post-E writes it already recorded), and
          4. register the early release: proxies drop the donor from
             the range's owner history at the next version, ending
             double delivery a full MVCC window early.

        A checkpoint/install failure (partitioned resolver, timeout)
        leaves the move in the reference's window-only mode — the donor
        keeps voting with complete history until the window passes, so
        verdicts stay exact; only the early retirement is lost."""
        timeout_s = float(flow.SERVER_KNOBS.resolver_handoff_timeout)
        eff = self.master.register_move(begin, end, dst)
        owners.move(begin, end, dst, eff)
        bal = self.cc.balance_stats
        try:
            rep = await flow.timeout_error(
                handoff_refs[src].get_reply(
                    ResolverCheckpointRequest(begin, end, eff),
                    self.process), timeout_s)
            await flow.timeout_error(
                handoff_refs[dst].get_reply(
                    ResolverInstallRequest(begin, end, rep.piece),
                    self.process), timeout_s)
        except flow.FdbError as e:
            if e.name == "operation_cancelled":
                raise
            flow.cover("master.resolver_balance.handoff_failed")
            bal.counter("handoff_timeouts").add(1)
            flow.TraceEvent("ResolverHandoffTimeout", self.process.name,
                            severity=flow.trace.SevWarnAlways).detail(
                Begin=begin.hex(), From=src, To=dst,
                Error=e.name).log()
            return True   # the move stands; window semantics cover it
        rel = self.master.register_release(begin, end, src)
        bal.counter("releases").add(1)
        flow.cover("master.resolver_balance.handoff")
        self._trace("ResolverHandoffComplete", Begin=begin.hex(),
                    From=src, To=dst, CheckpointVersion=rep.version,
                    ReleaseVersion=rel)
        return True

    async def _cleanup_old_logs(self) -> None:
        """Drop a drained old generation from the broadcast picture once
        every storage server has pulled past its end (ref: the oldest
        log epoch retiring in TagPartitionedLogSystem)."""
        while True:
            await flow.delay(flow.SERVER_KNOBS.old_log_cleanup_interval,
                             TaskPriority.CLUSTER_CONTROLLER)
            info = self.cc.dbinfo.get()
            if not info.old_logs:
                continue
            floor = self.cc.min_storage_version()
            agent = getattr(self.cc, "backup_agent", None)
            if agent is not None:
                # an active backup tail must drain a generation before
                # it retires, or the mutation log gets a silent hole
                floor = min(floor, agent._tailed_to)
            region = getattr(self.cc, "region", None)
            if region is not None:
                # same rule for the region log router: retiring a
                # generation it has not shipped would stall it forever
                # under the strict source-coverage rule
                floor = min(floor, region._pushed_to)
            keep = tuple(ls for ls in info.old_logs
                         if ls.end_version > floor)
            if len(keep) != len(info.old_logs):
                self.cc.publish(info._replace(old_logs=keep))

from ..rpc import wire as _wire

_wire.register_module(__name__)  # all NamedTuples here are RPC vocabulary
