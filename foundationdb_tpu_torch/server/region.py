"""Multi-region: asynchronous log shipping to a remote DC + failover
THROUGH the recovery machinery.

Ref: fdbserver/LogRouter.actor.cpp (remote regions pull the primary's
log stream through log routers into remote TLogs), the region
configurations generated by SimulatedCluster.actor.cpp:790, the
TagPartitionedLogSystem's remote log sets (newEpoch with regions,
epochEnd recovering from them at :1265), and the explicit promotion
path (fdbcli force_recovery_with_data_loss).

Shape of the slice:

- The remote DC is built from real ``Worker`` processes (a log worker
  + one storage worker per primary shard), with their own
  ``ServerDBInfo`` broadcast var — the same seam the primary's roles
  follow. Remote storage mirrors the primary's shard layout: each
  remote server pulls ITS OWN primary storage tag from the remote
  TLog, so the promoted region is sharded exactly like the primary
  (ref: remote storage servers pulling their tags through log
  routers).
- Attaching/detaching the region is a CONFIGURATION CHANGE driven
  through an epoch recovery: the new epoch's proxies are recruited
  with region tagging on and its TLogs with the router in
  REGION_TAG's replica set — nothing pokes live roles (ref: region
  config changes recovering the transaction subsystem).
- While attached, every mutation is tagged REGION_TAG; the router
  tails that tag (with the original storage tags preserved —
  ``TLogPeekRequest.with_tags``) and pushes records, version numbers
  and tag vectors intact, into the remote TLog.
- ``promote()`` is a RECOVERY INVOCATION: it raises a new
  ClusterController in the remote DC over the surviving coordinator
  quorum; that CC's MasterRecovery reads the coordinated state, finds
  the region's log store recorded there (``CoreState.region_logs``),
  LOCKS the remote log (the epoch fence — after it no in-flight
  router push can land), and recruits the new transaction subsystem
  from the region's workers. Committed-but-unshipped versions — the
  advertised lag — are exactly what an async region admits losing.

Writes committed BEFORE the region attaches are not shipped — attach
to an empty (or snapshot-seeded) database, like the reference
configures regions up front. One attach per RemoteRegion instance.
"""

from __future__ import annotations

from typing import Optional

from .. import flow
from ..flow import AsyncVar, TaskPriority
from ..rpc import RequestStream  # noqa: F401  (re-export convenience)
from .cluster_controller import ClusterConfig, ClusterController
from .dbinfo import (EMPTY_DBINFO, FULLY_RECOVERED, UNINITIALIZED,
                     LogSetInfo, ServerDBInfo, StorageShard,
                     pick_log_source)
from .proxy import BACKUP_TAG, REGION_TAG
from .types import (TaggedMutation, TLogCommitRequest, TLogPeekRequest,
                    TLogPopRequest)
from .worker import RegisterWorkerRequest, Worker


class RemoteRegion:
    """One remote DC: a log worker + per-shard storage workers fed by
    a log router (ref: the remote side of a fearless configuration).

    With ``n_satellites > 0`` the region also provides satellite log
    workers — each its own machine/zone/DC near the primary (ref:
    satelliteTagLocations, TagPartitionedLogSystem.actor.cpp:156-220).
    Every epoch recruited while the region is attached places one
    additional log replica on each live satellite worker, full members
    of the log set: the proxies' push waits on them, storage readers
    rotate onto them, epochEnd locks them. Because a commit is acked
    only once EVERY log replica is durable, the satellites always hold
    the complete acked stream OUTSIDE the primary DC — so a primary
    blackout loses nothing: ``promote()`` locks the surviving satellite
    replicas and recovers at their frontier instead of the router's
    (possibly lagging) shipped frontier. Satellite redundancy is the
    satellite count, mirroring the reference's
    ``one_satellite_double``-style modes."""

    def __init__(self, cluster, name: str = "dc2", n_satellites: int = 0):
        self.cluster = cluster
        self.name = name
        net = cluster.net
        self.router_name = f"{name}-router"

        # the remote DC mirrors the primary's shard layout AT ATTACH
        # TIME (the reference's remote DD applies the same keyServers
        # moves; this slice pins the layout instead — primary shard
        # splits while a region is attached are out of scope)
        info = cluster.cc.dbinfo.get()
        if info.storages:
            self.shards = [(s.tag, s.begin, s.end) for s in info.storages]
        else:
            cfg = cluster.config
            splits = [b""] + [bytes([(i * 256) // cfg.n_storage])
                              for i in range(1, cfg.n_storage)] + [None]
            self.shards = [(i, splits[i], splits[i + 1])
                           for i in range(cfg.n_storage)]

        # the region's own broadcast seam: remote roles follow it now;
        # the promoted ClusterController adopts it at failover
        self.dbinfo = AsyncVar(EMPTY_DBINFO)

        self._workers: list = []
        log_worker = self._new_worker(net, f"{name}-log")
        self.log_store = f"region-{name}-log"
        self.log_refs = log_worker.recruit_tlog(self.log_store)
        self.tlog = log_worker.roles[self.log_store]
        self._log_machine = log_worker.process.machine

        expected: dict = {}
        self.storage_refs = []
        for tag, b, e in self.shards:
            sw = self._new_worker(net, f"{name}-s{tag}")
            sname = f"region-{name}-storage-{tag}"
            refs = sw.recruit_storage(sname, tag, b, e)
            self.storage_refs.append(refs)
            expected[tag] = (sname,)
        self.tlog.set_expected_replicas(expected)

        # initial region picture: the remote log is the open
        # generation, the remote shards are the storage set. NOT
        # fully_recovered — there is no transaction subsystem here
        # until a promotion recovers one.
        self.dbinfo.set(ServerDBInfo(
            0, UNINITIALIZED, 0, (),
            LogSetInfo(0, 0, -1, (self.log_refs,),
                       stores=((self.log_store, self._log_machine),)),
            (),
            tuple(StorageShard(t, b, e, (r,))
                  for (t, b, e), r in zip(self.shards,
                                          self.storage_refs)),
            0))

        # satellite log workers: primary-side (they follow the PRIMARY
        # broadcast, not the region's), each a distinct failure domain
        self.satellite_workers: list = []
        for i in range(n_satellites):
            sp = net.new_process(f"{name}-sat{i}", machine=f"{name}-sat{i}",
                                 zone=f"{name}-sat{i}")
            sp.dc = f"{name}-sat{i}"
            sw = Worker(sp, net, durable=cluster.durable,
                        dbinfo=cluster.cc.dbinfo,
                        conflict_backend=cluster.conflict_backend,
                        storage_lag_versions=cluster.storage_lag_versions,
                        storage_engine=cluster.config.storage_engine,
                        device=cluster.config.device,
                        on_fatal=cluster._on_fatal)
            sw.start()
            self.satellite_workers.append(sw)

        self.router_proc = net.new_process(self.router_name,
                                           machine=self.router_name)
        self.router_proc.dc = name
        self._router_task = None
        self._stop = False
        self._replica_rr = 0
        self._pushed_to = 0        # last version shipped into the remote log
        self._promoted: Optional[PromotedRegion] = None

    def _new_worker(self, net, name: str) -> Worker:
        proc = net.new_process(name, machine=name, zone=name)
        proc.dc = self.name
        w = Worker(proc, net, durable=self.cluster.durable,
                   dbinfo=self.dbinfo,
                   conflict_backend=self.cluster.conflict_backend,
                   storage_lag_versions=self.cluster.storage_lag_versions,
                   storage_engine=self.cluster.config.storage_engine,
                   # the cluster's card (or "cpu"), and its hook for a
                   # device fault past the retries: a promoted
                   # resolver's fault stops SimCluster.run like any other
                   device=self.cluster.config.device,
                   on_fatal=self.cluster._on_fatal)
        w.start()
        self._workers.append(w)
        return w

    def log_stores(self):
        """What the primary's coordinated state records about this
        region (ref: DBCoreState carrying the remote log set)."""
        return ((self.log_store, self._log_machine),)

    def storage_objs(self):
        """The remote StorageServer role objects, in shard order."""
        out = []
        for refs in self.storage_refs:
            for w in self._workers:
                obj = w.roles.get(refs.name)
                if obj is not None:
                    out.append(obj)
        return out

    def applied_version(self) -> int:
        """The slowest remote shard's applied version — what a
        failover is guaranteed to preserve right now."""
        return min((s.version.get() for s in self.storage_objs()),
                   default=0)

    # -- attach / detach -------------------------------------------------
    async def _recovery_settled(self, attached: bool) -> None:
        """Wait for a SETTLED epoch that advertises the desired region
        state — not merely the next epoch: a recovery already past
        recruitment when the flag flipped publishes the stale value,
        and the level-triggered config-dirty recovery after it
        publishes the corrected one."""
        var = self.cluster.cc.dbinfo
        while True:
            info = var.get()
            if info.region_attached == attached and \
                    info.recovery_state == FULLY_RECOVERED:
                return
            await flow.first_of(
                var.on_change(),
                flow.delay(flow.SERVER_KNOBS.region_settle_delay,
                           TaskPriority.DEFAULT_ENDPOINT))

    async def start(self) -> None:
        """Attach: commit ``usable_regions=2`` into \\xff/conf/ — the
        configuration-change recovery it triggers recruits the next
        epoch with region tagging on every proxy, the router in
        REGION_TAG's replica set, and a log replica on every satellite
        worker; the epoch's CoreState records the region's log store
        (ref: ManagementAPI changing the region configuration;
        DatabaseConfiguration usable_regions)."""
        cc = self.cluster.cc
        cc.region = self
        db = self.cluster.client(f"{self.name}-attach")
        try:
            await db.configure(usable_regions=2)
        finally:
            db.close()
        await self._recovery_settled(True)
        self._router_task = flow.spawn(
            self._route(), TaskPriority.DEFAULT_ENDPOINT,
            name=f"{self.router_name}.route")

    async def stop(self) -> None:
        """Detach through the same committed-configuration path."""
        self._stop = True
        db = self.cluster.client(f"{self.name}-detach")
        try:
            await db.configure(usable_regions=1)
        finally:
            db.close()
        await self._recovery_settled(False)
        self.cluster.cc.region = None
        if self._router_task is not None:
            await flow.catch_errors(self._router_task)

    # -- the log router --------------------------------------------------
    def lag(self) -> int:
        """Advertised replication lag in versions: what a failover may
        lose (ref: the remote region's versionLag in status)."""
        committed = max((p.committed_version.get()
                        for p in self.cluster.cc._current_proxies()),
                        default=0)
        return max(0, committed - self._pushed_to)

    async def _route(self) -> None:
        """Tail REGION_TAG from the primary log set and push each
        record into the remote TLog, version numbers AND storage-tag
        vectors preserved, so each remote shard can pull its own tag
        (ref: the log router's pullAsyncData -> remote tLogCommit
        path)."""
        version = 0
        while not self._stop:
            info = self.cluster.cc.dbinfo.get()
            src = self._pick_source(info, version + 1)
            if src is None:
                await flow.delay(flow.SERVER_KNOBS.log_router_idle_delay,
                                 TaskPriority.DEFAULT_ENDPOINT)
                continue
            gen, refs = src
            try:
                reply = await flow.timeout_error(refs.peeks.get_reply(
                    TLogPeekRequest(version + 1, REGION_TAG,
                                    with_tags=True),
                    self.router_proc),
                    flow.SERVER_KNOBS.log_router_peek_timeout)
            except flow.FdbError:
                self._replica_rr += 1
                await flow.delay(flow.SERVER_KNOBS.log_router_retry_delay,
                                 TaskPriority.DEFAULT_ENDPOINT)
                continue
            cap = gen.end_version if gen.end_version >= 0 else None
            # ship nothing beyond what the primary knows replicated: a
            # single log's tail can roll back in a recovery (same rule
            # as the backup tail and the storage pull)
            safe = reply.known_committed
            if cap is not None:
                safe = max(safe, cap)
            before = version
            shipped_all = True
            for v, tagged in reply.entries:
                if v <= version:
                    continue
                if cap is not None and v > cap:
                    break
                if v > safe:
                    break
                out = []
                for tm in tagged:
                    tags = tuple(t for t in tm.tags
                                 if t not in (REGION_TAG, BACKUP_TAG))
                    if tags:
                        out.append(TaggedMutation(tags, tm.mutation))
                try:
                    await self.tlog.commits.ref().get_reply(
                        TLogCommitRequest(version, v, tuple(out),
                                          version),
                        self.router_proc)
                except flow.FdbError:
                    # remote log unreachable: retry this record next
                    # round. The frontier must NOT advance past it —
                    # an empty advance here would pop the primary's
                    # copy and silently lose the record forever.
                    shipped_all = False
                    break
                version = v
            adv = min(reply.committed_version, safe)
            if cap is not None:
                adv = min(adv, cap)
            if shipped_all and adv > version:
                # versions with no region-tagged payload still advance
                # the remote frontier so lag stays honest
                try:
                    await self.tlog.commits.ref().get_reply(
                        TLogCommitRequest(version, adv, (), version),
                        self.router_proc)
                    version = adv
                except flow.FdbError:
                    pass
            self._pushed_to = version
            if version > before:
                refs.pops.send(TLogPopRequest(version, REGION_TAG,
                                              self.router_name),
                               self.router_proc)
            else:
                await flow.delay(flow.SERVER_KNOBS.log_router_retry_delay,
                                 TaskPriority.DEFAULT_ENDPOINT)

    def _pick_source(self, info, needed: int):
        return pick_log_source(info, needed, self._replica_rr)

    # -- failover --------------------------------------------------------
    async def promote(self, coordinators=None) -> "PromotedRegion":
        """Region B takes over after a primary blackout — BY RECOVERY:
        a new ClusterController rises in the remote DC over the
        surviving coordinator quorum, reads the coordinated state,
        locks the region's log (``MasterRecovery._epoch_end_region``
        — the fence after which no router push can land), and recruits
        master/resolvers/proxies/logs from the region's own workers.
        The promoted epoch is committed exclusively into the
        coordinated state, so a zombie primary master can never commit
        again (ref: epochEnd with remote log sets,
        TagPartitionedLogSystem.actor.cpp:1265; fdbcli
        force_recovery_with_data_loss)."""
        self._stop = True
        if self._router_task is not None:
            self._router_task.cancel()
        net = self.cluster.net
        if coordinators is None:
            coordinators = [self.cluster._coord_refs(c)
                            for c in self.cluster.coordinators]
        ccproc = net.new_process(f"{self.name}-cc",
                                 machine=f"{self.name}-cc")
        ccproc.dc = self.name
        pcfg = self.cluster.config
        cfg = ClusterConfig(
            n_proxies=pcfg.n_proxies, n_resolvers=pcfg.n_resolvers,
            n_logs=pcfg.n_logs, n_storage=len(self.shards),
            storage_replicas=1, conflict_backend=pcfg.conflict_backend,
            durable=pcfg.durable, storage_engine=pcfg.storage_engine,
            device=pcfg.device,
            # match the committed \xff/conf/ row (the LIVE adopted
            # config, not the construction-time snapshot) or the
            # promoted CC's conf sync would adopt it and force a
            # spurious recovery right after failover (cc.region is
            # None here, so no satellites are recruited either way)
            usable_regions=self.cluster.cc.config.usable_regions)
        cc = ClusterController(ccproc, coordinators, cfg,
                               dbinfo_var=self.dbinfo,
                               takeover_from_region=True,
                               leader_priority=-1)
        # seed the authoritative shard map with the region's shards so
        # recruitment builds the new logs' replica expectations over
        # them (the registration RPCs below fill in the role objects)
        for refs in self.storage_refs:
            cc.shard_map[refs.name] = (refs.tag, refs.begin, refs.end)
        cc._max_tag_ever = max(t for t, _b, _e in self.shards)
        cc.start()

        async def register(w: Worker):
            from .tlog import TLog
            logs = tuple(w._log_refs(s, w.roles[s]) for s in w.roles
                         if s == self.log_store
                         or isinstance(w.roles[s], TLog))
            storages = tuple(r for r in self.storage_refs
                             if r.name in w.roles)
            await cc.registrations.ref().get_reply(
                RegisterWorkerRequest(w.process.name, w.process.machine,
                                      w, logs, storages), w.process)

        # satellite workers register too: their per-epoch log replicas
        # are what _epoch_end_region locks to recover the acked tail
        # the router had not shipped (pick_workers' DC filter keeps
        # them out of the promoted region's role recruitment)
        for w in self._workers + self.satellite_workers:
            if not w.process.alive:
                continue
            flow.spawn(register(w), TaskPriority.CLUSTER_CONTROLLER,
                       name=f"{w.process.name}.registerWithPromotedCC")

        # recovery completes when the promoted epoch accepts commits
        while True:
            info = self.dbinfo.get()
            if info.recovery_state == FULLY_RECOVERED and info.epoch > 0:
                break
            await flow.first_of(
                self.dbinfo.on_change(),
                flow.delay(flow.SERVER_KNOBS.region_settle_delay,
                           TaskPriority.DEFAULT_ENDPOINT))
        self._promoted = PromotedRegion(self, cc, coordinators)
        return self._promoted


class PromotedRegion:
    """The promoted region: a full cluster — its ClusterController,
    recovered transaction subsystem, and client surface."""

    def __init__(self, region: RemoteRegion, cc: ClusterController,
                 coordinators):
        self.region = region
        self.cc = cc
        self.coordinators = coordinators
        self.recovery_version = cc.dbinfo.get().recovery_version

    def client(self, name: str = "dc2-client"):
        """A Database against the promoted controller (any client
        holding the coordinator set re-finds it on its own — see
        Database._try_rediscover)."""
        from ..client import Database
        proc = self.region.cluster.net.new_process(name, machine=name)
        return Database(proc, self.cc.open_db.ref(),
                        status_ref=self.cc.status_requests.ref(),
                        management_ref=self.cc.management.ref(),
                        coordinators=self.coordinators)
