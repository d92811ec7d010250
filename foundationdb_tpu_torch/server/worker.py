"""Worker: hosts role actors on a process, recovers disk stores on
reboot, registers with the ClusterController.

Reference: fdbserver/worker.actor.cpp — `workerServer` (:613) scans the
data folder on boot and re-creates roles from surviving disk stores
(tlog queues come back *stopped*, ready to be locked and drained by the
next recovery; storage servers rejoin and resume pulling), then
registers with the CC (registrationClient :347) and serves recruitment
requests. Role construction here is a direct method call guarded by a
liveness check — the simulated stand-in for the recruitment RPC; the
registration itself travels over the simulated network so a rebooted
worker re-appears the same way a real one would.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

from .. import flow
from ..device import NoCudaDeviceError
from ..flow import TaskPriority, error
from ..ops.fault_injection import DeviceFaultError
from ..rpc import RequestStream, SimProcess
from .dbinfo import LogRefs, ProxyRefs, StorageRefs
from .kvstore import EphemeralKeyValueStore, KeyValueStoreMemory
from .master import Master
from .proxy import Proxy
from .resolver_role import Resolver
from .storage import (SHARD_META_KEY, StorageServer,
                      decode_shard_meta)
from .tlog import TLog

class RegisterWorkerRequest(NamedTuple):
    name: str
    machine: str
    worker: object                      # the Worker (sim recruitment seam)
    recovered_logs: Tuple[LogRefs, ...]
    recovered_storages: Tuple[StorageRefs, ...] = ()


class Worker:
    def __init__(self, process: SimProcess, net, durable: bool = False,
                 dbinfo=None, conflict_backend: str = "python",
                 storage_lag_versions: Optional[int] = None,
                 storage_engine: str = "memory", device=None,
                 on_fatal=None):
        self.process = process
        self.net = net
        self.durable = durable
        self.dbinfo = dbinfo            # AsyncVar[ServerDBInfo]
        self.conflict_backend = conflict_backend
        # the cluster's device for the CUDA backends (ClusterConfig.
        # device), and the cluster's hook for an error no recovery can
        # mend: a missing card or a device fault past the retries
        self.device = device
        self.on_fatal = on_fatal
        self.storage_lag_versions = storage_lag_versions
        self.storage_engine = storage_engine
        self.roles: dict = {}           # name -> role object
        self.pings = RequestStream(process)
        self._actors = flow.ActorCollection()

    # -- liveness --------------------------------------------------------
    def _check_alive(self) -> None:
        if not self.process.alive:
            raise error("broken_promise")

    def start(self) -> None:
        self._actors.add(flow.spawn(self._ping_loop(), TaskPriority.CLUSTER_CONTROLLER,
                                    name=f"{self.process.name}.ping"))
        self.process.on_kill(self._actors.cancel_all)

    async def _ping_loop(self):
        while True:
            _req, reply = await self.pings.pop()
            reply.send(None)

    # -- boot-time disk-store recovery ----------------------------------
    async def recover_stores(self):
        """Re-create roles from surviving disk stores (ref: worker boot
        store scan). TLogs come back stopped; storage servers rejoin
        live. Returns (recovered_logs, recovered_storages).

        A store whose recovery DETECTS corruption (checksum_failed /
        io_error) is treated as lost, not fatal: the files are removed
        so the next reboot cannot trip on them again, and the worker
        registers without it — replication heals the hole (DD rebuilds
        the replica; a log generation recovers from its surviving
        peers). Detected corruption is thus a recoverable role death;
        UNDETECTED corruption is check_consistency's job."""
        recovered_logs = []
        recovered_storages = []
        if self.durable:
            disk = self.net.disk(self.process.machine)
            for store in sorted(disk.files):
                try:
                    if store.startswith("tlog-") and store.endswith(".dq0"):
                        name = store[:-4]
                        tlog = self._make_tlog(name)
                        tlog.stopped = True      # old-generation data only
                        tlog.start()
                        await tlog.recovered()
                        recovered_logs.append(self._log_refs(name, tlog))
                    elif store.startswith("storage-") and \
                            store.endswith(".dq0"):
                        refs = await self._recover_storage(store[:-4],
                                                           "memory")
                        if refs is not None:
                            recovered_storages.append(refs)
                    elif store.startswith("storage-") and \
                            store.endswith(".btree"):
                        refs = await self._recover_storage(store[:-6],
                                                           "btree")
                        if refs is not None:
                            recovered_storages.append(refs)
                except flow.FdbError as e:
                    if e.name not in ("checksum_failed", "io_error"):
                        raise
                    self._drop_corrupt_store(disk, store, e)
        return tuple(recovered_logs), tuple(recovered_storages)

    def _drop_corrupt_store(self, disk, store: str, e) -> None:
        """Detected on-disk corruption: destroy the store and carry on
        (the recoverable-role-death contract of the chaos plane)."""
        base = store.rsplit(".", 1)[0]
        flow.cover("worker.corrupt_store_dropped")
        flow.TraceEvent("WorkerCorruptStoreLost", self.process.name,
                        severity=flow.trace.SevWarnAlways).detail(
            Store=base, Error=e.name).log()
        self.net.chaos_note("corrupt_store_lost", store=base,
                            machine=self.process.machine)
        role = self.roles.pop(base, None)
        if role is not None:
            role._actors.cancel_all()
        for f in [f for f in disk.files if f.startswith(base + ".")]:
            disk.remove(f)

    async def _recover_storage(self, name: str, engine: str):
        kv = self._make_engine(name, engine)
        await kv.recover()
        meta = kv.get(SHARD_META_KEY)
        if meta is None:
            return None
        tag, begin, end, floors = decode_shard_meta(meta)
        return self.recruit_storage(name, tag, begin, end, kv=kv,
                                    floors=floors)

    # -- recruitment (CC-driven) ----------------------------------------
    def _make_tlog(self, store: str, recovery_version: int = 0) -> TLog:
        disk = self.net.disk(self.process.machine) if self.durable else None
        return TLog(self.process, disk=disk, name=store,
                    recovery_version=recovery_version)

    def _log_refs(self, store: str, tlog: TLog) -> LogRefs:
        return LogRefs(store, self.process.machine, tlog.commits.ref(),
                       tlog.peeks.ref(), tlog.pops.ref(), tlog.locks.ref())

    def recruit_tlog(self, store: str, recovery_version: int = 0) -> LogRefs:
        """(ref: InitializeTLogRequest handling in workerServer)"""
        self._check_alive()
        tlog = self._make_tlog(store, recovery_version)
        tlog.start()
        self.roles[store] = tlog
        return self._log_refs(store, tlog)

    def recruit_resolver(self, name: str, recovery_version: int,
                         backend: Optional[str] = None):
        """Returns (resolves_ref, metrics_ref, handoffs_ref)."""
        self._check_alive()
        try:
            r = Resolver(self.process,
                         backend=backend or self.conflict_backend,
                         recovery_version=recovery_version,
                         device=self.device, on_fatal=self.on_fatal)
        except (NoCudaDeviceError, DeviceFaultError) as e:
            # a recovery that retried this would retry it for ever
            if self.on_fatal is not None:
                self.on_fatal(e)
            raise
        r.start()
        self.roles[name] = r
        return r.resolves.ref(), r.metrics.ref(), r.handoffs.ref()

    def recruit_proxy(self, name: str, master_ref, resolver_refs, tlog_refs,
                      resolver_splits, storage_splits,
                      recovery_version: int,
                      ratekeeper_ref=None, storage_tags=None,
                      management_ref=None) -> ProxyRefs:
        self._check_alive()
        p = Proxy(self.process, master_ref, resolver_refs, tlog_refs,
                  resolver_splits=resolver_splits,
                  storage_splits=storage_splits,
                  storage_tags=storage_tags,
                  recovery_version=recovery_version,
                  ratekeeper_ref=ratekeeper_ref,
                  management_ref=management_ref,
                  # transaction repair re-reads invalidated ranges
                  # straight from storage via the broadcast shard map
                  dbinfo=self.dbinfo)
        p.start()
        self.roles[name] = p
        return ProxyRefs(name, p.grvs.ref(), p.commits.ref(),
                         p.raw_committed.ref())

    def recruit_ratekeeper(self, name: str, cc):
        """(ref: the CC recruiting the ratekeeper singleton)"""
        self._check_alive()
        from .ratekeeper import Ratekeeper
        rk = Ratekeeper(self.process, cc)
        rk.start()
        self.roles[name] = rk
        return rk.get_rate.ref()

    def recruit_master(self, name: str, recovery_version: int) -> Master:
        self._check_alive()
        m = Master(self.process, recovery_version=recovery_version)
        m.start()
        self.roles[name] = m
        return m

    def _make_engine(self, name: str, engine: Optional[str] = None):
        """(ref: the KeyValueStoreType choice in IKeyValueStore.h)"""
        engine = engine or self.storage_engine
        disk = self.net.disk(self.process.machine)
        if engine == "btree":
            from .btree import KeyValueStoreBTree
            return KeyValueStoreBTree(disk, name, owner=self.process)
        return KeyValueStoreMemory(disk, name, owner=self.process)

    def recruit_storage(self, name: str, tag: int, begin: bytes,
                        end: Optional[bytes], kv=None,
                        floors=()) -> StorageRefs:
        self._check_alive()
        if kv is None:
            if self.durable:
                kv = self._make_engine(name)
            else:
                kv = EphemeralKeyValueStore()
        s = StorageServer(self.process, None, kv=kv, tag=tag,
                          durability_lag_versions=self.storage_lag_versions,
                          dbinfo=self.dbinfo, shard_begin=begin,
                          shard_end=end, floors=floors, name=name)
        s.start()
        self.roles[name] = s
        refs = StorageRefs(name, tag, begin, end, s.gets.ref(),
                           s.ranges.ref(), s.get_keys.ref(), s.watches.ref())
        return refs

    def retire_storage(self, name: str) -> None:
        """Tear down a storage role whose data has been moved away
        (ref: the storage server removal path once DD vacates it —
        actors end and the store files are destroyed, so a reboot
        cannot resurrect the stale ownership)."""
        obj = self.roles.pop(name, None)
        if obj is not None:
            obj.retire()
        if self.durable:
            disk = self.net.disk(self.process.machine)
            for f in [f for f in disk.files
                      if f.startswith(name + ".")]:
                disk.remove(f)

from ..rpc import wire as _wire

_wire.register_module(__name__)  # all NamedTuples here are RPC vocabulary
RegisterWorkerRequest.__no_wire__ = True  # carries the recruitment seam
