"""SimCluster: the whole cluster on one deterministic loop — workers,
coordinators, ClusterController, recruitment, recovery, and faults.

Reference: fdbserver/SimulatedCluster.actor.cpp setupSimulatedSystem
(:1078) — build simulated machines with workers, start coordination and
the cluster controller, and let recruitment bring up the transaction
subsystem exactly the way a real cluster boots (§3.4 call stack: worker
registration -> leader election -> masterCore recovery). Kills go
through the sim network's process-kill semantics; killed workers
auto-reboot after a delay (ref: simulatedFDBDRebooter,
SimulatedCluster.actor.cpp:194) and recover their disk stores, so the
recovery state machine — not test scaffolding — heals the cluster.
"""

from __future__ import annotations

from typing import Optional

from .. import device as _device
from .. import flow
from ..models import DEVICE_BACKENDS
from ..rpc import SimNetwork
from .cluster_controller import ClusterConfig, ClusterController
from .coordination import Coordinator
from .worker import RegisterWorkerRequest, Worker

# seconds before a killed worker restarts: see SIM_REBOOT_DELAY knob

#: seed of the most recently constructed simulation — the test
#: harness's failure hook reads it to print a one-line seed-replay
#: repro for any red sim test (tests/conftest.py)
last_sim_seed: Optional[int] = None


class SimCluster:
    def __init__(self, seed: int = 0, conflict_backend: str = "python",
                 start_time: float = 0.0, n_resolvers: int = 1,
                 durable: bool = False,
                 storage_lag_versions: Optional[int] = None,
                 n_proxies: int = 1, n_logs: int = 1, n_storage: int = 1,
                 n_workers: Optional[int] = None, n_coordinators: int = 1,
                 auto_reboot: bool = True, buggify: bool = False,
                 storage_engine: str = "memory",
                 storage_replicas: int = 1,
                 share_with: "SimCluster" = None, name_prefix: str = "",
                 virtual: bool = True, data_dir: Optional[str] = None,
                 workers_per_machine: int = 1, n_zones: int = 0,
                 storage_policy=None, backup_driver: bool = False,
                 profile_janitor: bool = False,
                 metric_history: bool = False,
                 metrics_janitor: bool = False,
                 critical_path: bool = False, device=None):
        if conflict_backend in DEVICE_BACKENDS:
            # the card is asked for here, before anything is built: on
            # a host without one this raises NoCudaDeviceError at once
            # instead of failing every recovery's recruitment
            _device.resolve(device)
        if storage_policy is not None and \
                storage_policy.replica_count() != max(1, storage_replicas):
            raise ValueError(
                f"storage_policy places {storage_policy.replica_count()} "
                f"replicas but storage_replicas={storage_replicas}: the "
                "team size and the tag-pinning/naming machinery would "
                "silently diverge")
        self.prefix = name_prefix
        self._owns_scheduler = share_with is None
        # co-scheduled clusters (share_with): any of them may publish a
        # broken picture, and whichever cluster's run() drives the loop
        # must surface it — track the sharing group both ways
        self._share_src = share_with
        self._peer_clusters: list = []
        # the first error no recovery can mend (a device fault past the
        # retries, a missing card): it stops the loop and run raises it
        self._fatal: Optional[BaseException] = None
        if share_with is not None:
            if data_dir is not None:
                raise ValueError(
                    "data_dir on a share_with secondary is not supported: "
                    "it would silently run on the primary's sim disks")
            share_with._peer_clusters.append(self)
        self._io_pool = None   # IThreadPool for real-disk fsync offload
        if share_with is not None:
            # a second cluster INSIDE the same deterministic simulation
            # (multi-cluster tests: DR, cross-cluster tooling) — shares
            # the scheduler/network/RNG, distinct process namespace
            self.sched = share_with.sched
            self.net = share_with.net
        else:
            global last_sim_seed
            last_sim_seed = seed
            flow.set_seed(seed, buggify_enabled=buggify)
            # knob distortion rides the same switch as BUGGIFY (ref:
            # `if (randomize && BUGGIFY)` in Knobs.cpp); always re-init
            # so a prior run's distorted knobs never leak into this one
            flow.reset_server_knobs(randomize=buggify)
            # a previous simulation's armed chaos station hooks must
            # never leak into this one (process-global, like the knobs)
            from .chaos import clear_stations
            clear_stations()
            # the flight recorder is process-global like the stations:
            # a prior run's ring (and arming) must not leak in
            flow.g_flightrec.disarm()
            # virtual=False runs the same cluster on the wall clock so
            # real-socket peers (the TCP gateway + C binding) can attach
            self.sched = flow.Scheduler(start_time=start_time,
                                        virtual=virtual)
            flow.set_scheduler(self.sched)
            self.net = SimNetwork(self.sched, flow.g_random)
            # sim-perf attribution plane (SIM_TASK_STATS): armed at
            # boot so recovery, workload and quiesce windows are all
            # attributed. Profiling reads only the wall clock — the
            # sim timeline and every seeded draw are untouched, so the
            # armed run's event schedule is identical to the off run's
            # (test-pinned)
            if int(getattr(flow.SERVER_KNOBS, "sim_task_stats", 0)):
                self.sched.start_task_stats()
                self.net.arm_message_stats()
            if data_dir is not None:
                # REAL on-disk stores: durable state survives an actual
                # process restart (tools/server --data-dir)
                import os

                from ..rpc.disk import RealDisk
                if not virtual:
                    # wall-clock deployment: fsyncs run on an
                    # IThreadPool so a slow disk stalls one worker,
                    # never the whole event loop (ref: AsyncFileEIO's
                    # eio pool; flow/IThreadPool.h)
                    from ..flow.threadpool import ThreadPool
                    self._io_pool = ThreadPool(
                        n_threads=int(flow.SERVER_KNOBS.disk_io_threads),
                        name="diskio")
                    self._io_pool.start()
                self.net.disk_factory = lambda m: RealDisk(
                    os.path.join(data_dir, m), m, pool=self._io_pool)
        self.durable = durable
        self.auto_reboot = auto_reboot
        self.conflict_backend = conflict_backend
        self.storage_lag_versions = storage_lag_versions
        self.config = ClusterConfig(n_proxies=n_proxies,
                                    n_resolvers=n_resolvers,
                                    n_logs=n_logs, n_storage=n_storage,
                                    conflict_backend=conflict_backend,
                                    durable=durable,
                                    storage_engine=storage_engine,
                                    storage_replicas=storage_replicas,
                                    storage_policy=storage_policy,
                                    device=device)

        # coordinators (ref: coordinationServer)
        px = self.prefix
        self.coordinators = []
        for i in range(n_coordinators):
            cproc = self.net.new_process(f"{px}coord{i}",
                                         machine=f"{px}coord{i}")
            c = Coordinator(cproc, disk=(self.net.disk(f"{px}coord{i}")
                                         if durable else None))
            c.start()
            self.coordinators.append(c)

        # the longitudinal plane: must be armed BETWEEN the
        # knob reset above and CC construction — cc.start() decides at
        # spawn time whether the TimeKeeper/recorder/SLO loops exist at
        # all (the byte-identical off posture), so a post-construction
        # SERVER_KNOBS.set would be too late
        if metric_history:
            flow.SERVER_KNOBS.set("metric_history", 1)
        # latency forensics: same arming window as above —
        # cc.start() gates the fold loop at spawn time. The flight
        # recorder rides along: a forensics run wants the recent-event
        # ring available for `cli flightrec` / incident dumps
        if critical_path:
            flow.SERVER_KNOBS.set("critical_path", 1)
            flow.g_flightrec.arm()

        # the cluster controller (single candidate; contested elections
        # are exercised in the coordination unit tests)
        self.cc = ClusterController(
            self.net.new_process(f"{px}cc", machine=f"{px}cc"),
            [self._coord_refs(c) for c in self.coordinators],
            self.config)
        self.cc.start()

        # sim_validation: every simulation continuously re-checks the
        # published cluster picture's invariants (ref: sim_validation.cpp
        # debug hooks) — a broken shard map or regressed epoch fails the
        # test at its source, not where a workload later trips
        from .sim_validation import validator
        self.validator_state: dict = {}
        self._validator = flow.spawn(
            validator(self.cc.dbinfo, self.validator_state),
            name=f"{px}simValidator")

        # workers grouped onto machines and zones (ref: simulator.h
        # MachineInfo + SimulatedCluster setupSimulatedSystem building
        # machines across zones/DCs). Defaults keep the legacy model:
        # one worker per machine, each machine its own zone.
        if n_workers is None:
            n_workers = max(4, n_logs + 1, n_storage * storage_replicas,
                            n_resolvers, storage_replicas + 1)
        self.n_workers = n_workers
        self.workers_per_machine = max(1, workers_per_machine)
        self.n_zones = n_zones
        # the cluster-side backup runner (ref: `fdbbackup agent`
        # processes run alongside the cluster) — opt-in; the
        # fdbtpu-backup tool needs one watching the control rows
        self.backup_driver = None
        if backup_driver:
            from ..layers.backup_driver import BackupDriver
            self.backup_driver = BackupDriver(self)
            self.backup_driver.start()
        # retention trimming for the sampled-transaction profiling
        # keyspace (layers/clientlog.py) — opt-in, like the backup
        # driver: a cluster running PROFILE_SAMPLE_RATE > 0 for long
        # wants one
        self.client_log_janitor = None
        if profile_janitor:
            from ..layers.clientlog import ClientLogJanitor
            self.client_log_janitor = ClientLogJanitor(self)
            self.client_log_janitor.start()
        # retention trimming for the longitudinal keyspaces — the
        # metric history, the legacy counter series, AND the TimeKeeper
        # map through ONE bounded-scan janitor (layers/metrics.py);
        # opt-in like the two drivers above
        self.metrics_janitor = None
        if metrics_janitor:
            from ..layers.metrics import MetricsJanitor
            self.metrics_janitor = MetricsJanitor(self)
            self.metrics_janitor.start()
        self.workers: dict = {}
        for i in range(n_workers):
            if self.workers_per_machine > 1 or n_zones > 0:
                mi = i // self.workers_per_machine
                machine = f"{px}m{mi}"
                zone = f"{px}z{mi % n_zones}" if n_zones else machine
            else:
                machine, zone = f"{px}w{i}", ""
            self._start_worker(f"{px}worker{i}", machine, zone)

    @staticmethod
    def _coord_refs(c: Coordinator) -> tuple:
        return (c.reads.ref(), c.writes.ref(), c.candidacies.ref(),
                c.forwards.ref())

    def add_coordinators(self, n: int, tag: str = "new") -> list:
        """Start n fresh coordinator servers (for a coordinators
        change); returns their ref 4-tuples (ref: the operator standing
        up new coordination hosts before `coordinators ...`)."""
        out = []
        for i in range(n):
            name = f"{self.prefix}coord-{tag}{i}"
            cproc = self.net.new_process(name, machine=name)
            c = Coordinator(cproc, disk=(self.net.disk(name)
                                         if self.durable else None))
            c.start()
            self.coordinators.append(c)
            out.append(self._coord_refs(c))
        return out

    # -- worker lifecycle ------------------------------------------------
    def _start_worker(self, name: str, machine: str,
                      zone: str = "") -> Worker:
        proc = self.net.new_process(name, machine=machine, zone=zone)
        w = Worker(proc, self.net, durable=self.durable,
                   dbinfo=self.cc.dbinfo,
                   conflict_backend=self.conflict_backend,
                   storage_lag_versions=self.storage_lag_versions,
                   storage_engine=self.config.storage_engine,
                   device=self.config.device, on_fatal=self._on_fatal)
        w.start()
        self.workers[name] = w
        flow.spawn(self._register_worker(w), name=f"{name}.register")
        if self.auto_reboot:
            proc.on_kill(lambda: flow.spawn(
                self._reboot_worker(name, machine, zone),
                name=f"{name}.rebooter"))
        return w

    async def _register_worker(self, w: Worker) -> None:
        logs, storages = await w.recover_stores()
        await self.cc.registrations.ref().get_reply(
            RegisterWorkerRequest(w.process.name, w.process.machine, w,
                                  logs, storages), w.process)

    async def _reboot_worker(self, name: str, machine: str,
                             zone: str = "") -> None:
        """(ref: simulatedFDBDRebooter — the machine comes back after a
        delay and its worker recovers whatever the disk kept)"""
        await flow.delay(flow.SERVER_KNOBS.sim_reboot_delay)
        if name in self.net.processes and self.net.processes[name].alive:
            return
        self._start_worker(name, machine, zone)

    # -- faults ----------------------------------------------------------
    def kill_worker(self, name: str) -> None:
        self.net.kill(self.net.processes[name])

    def kill_machine(self, machine: str) -> list:
        """Correlated whole-machine failure: every co-located worker
        dies at once; auto-reboot (if on) brings each back onto the
        same machine/zone with its disks intact (ref: killMachine,
        sim2.actor.cpp:1717)."""
        return self.net.kill_machine(machine)

    def machine_of(self, worker_name: str) -> str:
        return self.net.processes[worker_name].machine

    def _find_worker_of(self, prefix: str) -> Optional[str]:
        """Name of a live worker hosting a role whose name starts with
        `prefix` in the CURRENT epoch."""
        epoch = self.cc.dbinfo.get().epoch
        for name, w in self.workers.items():
            if not w.process.alive:
                continue
            for role_name in w.roles:
                if role_name.startswith(prefix) and \
                        (f"-e{epoch}-" in role_name
                         or not role_name.startswith(("proxy", "resolver",
                                                      "tlog"))):
                    return name
        return None

    def kill_role(self, kind: str) -> str:
        """Kill the worker hosting a role of this kind ('tlog', 'proxy',
        'resolver', 'storage'); returns the worker name killed."""
        prefix = {"tlog": "tlog-e", "proxy": "proxy-e",
                  "resolver": "resolver-e", "storage": "storage-"}[kind]
        name = self._find_worker_of(prefix)
        if name is None:
            raise KeyError(f"no live worker hosts a {kind}")
        self.kill_worker(name)
        return name

    # -- clients ---------------------------------------------------------
    def client(self, name: str = "client", machine: str = ""):
        from ..client import Database  # avoid package-init cycle
        name = self.prefix + name
        proc = self.net.new_process(name, machine or name)
        return Database(proc, self.cc.open_db.ref(),
                        status_ref=self.cc.status_requests.ref(),
                        management_ref=self.cc.management.ref(),
                        coordinators=[self._coord_refs(c)
                                      for c in self.coordinators])

    async def quiet_database(self, max_wait: float = 60.0) -> None:
        """Wait until the cluster is quiescent: every storage replica
        has pulled to the log's committed frontier and the TLog backlog
        is fully popped (ref: fdbserver/QuietDatabase.actor.cpp — the
        post-workload settling tests rely on)."""
        # the latency probe's own writes would keep the log from ever
        # draining to zero — pause it while quiescing (the reference's
        # quiet database similarly suppresses background traffic)
        self.cc.probe_paused = True
        try:
            return await self._quiet_inner(max_wait)
        finally:
            self.cc.probe_paused = False

    async def _quiet_inner(self, max_wait: float) -> None:
        deadline = flow.now() + max_wait
        while flow.now() < deadline:
            info = self.cc.dbinfo.get()
            logs = self.cc.tlog_objs()
            storages = [self.cc._storage_objs.get(rep.name)
                        for s in info.storages for rep in s.replicas]
            if (info.recovery_state == "fully_recovered" and logs
                    and all(o is not None and o.process.alive
                            for o in storages)):
                frontier = max(t.version.get() for t in logs)
                caught_up = all(o.version.get() >= frontier
                                for o in storages)
                drained = all(len(t.entries) == 0 for t in logs)
                if caught_up and drained:
                    return
                # the durability horizon (known_committed) only advances
                # with fresh commits: nudge one through so the tail
                # drains on an otherwise idle cluster
                from .types import CommitRequest
                await flow.catch_errors(flow.timeout_error(
                    info.proxies[0].commits.get_reply(
                        CommitRequest(0, (), (), ()),
                        self.cc.process), 1.0))
            await flow.delay(flow.SERVER_KNOBS.quiet_database_poll)
        diag = self._quiet_diagnosis()
        flow.TraceEvent("QuietDatabaseTimeout", self.cc.process.name,
                        severity=flow.trace.SevWarnAlways).detail(
            MaxWait=max_wait, Diagnosis=diag).log()
        raise flow.error("timed_out",
                         f"quiet_database timed out after {max_wait}s: "
                         + diag)

    def _quiet_diagnosis(self) -> str:
        """WHY the cluster never quiesced: which condition failed, and
        which roles/counters are behind — a hung chaos storm is
        triagable from the error message alone, not from a debugger."""
        parts = []
        info = self.cc.dbinfo.get()
        if info.recovery_state != "fully_recovered":
            parts.append(f"recovery_state={info.recovery_state} "
                         f"(epoch {info.epoch})")
        logs = self.cc.tlog_objs()
        if not logs:
            parts.append("no live current-generation tlogs")
        frontier = max((t.version.get() for t in logs), default=0)
        undrained = [(lr.store, len(obj.entries))
                     for lr in info.logs.logs
                     for wi in self.cc.workers.values()
                     for obj in (wi.worker.roles.get(lr.store),)
                     if obj is not None and obj.process.alive
                     and len(obj.entries) > 0]
        for store, n in undrained:
            parts.append(f"tlog {store} holds {n} unpopped entries")
        for s in info.storages:
            for rep in s.replicas:
                obj = self.cc._storage_objs.get(rep.name)
                if obj is None:
                    parts.append(f"storage {rep.name} unregistered")
                elif not obj.process.alive:
                    parts.append(f"storage {rep.name} dead "
                                 "(no reboot/rebuild landed)")
                elif obj.version.get() < frontier:
                    parts.append(
                        f"storage {rep.name} at v{obj.version.get()} "
                        f"trails the log frontier v{frontier} by "
                        f"{frontier - obj.version.get()}")
        if not parts:
            parts.append("all conditions met on the final poll "
                         "(quiesced too late)")
        return "; ".join(parts)

    # -- running ---------------------------------------------------------
    def run(self, coro, timeout_time: Optional[float] = None):
        """Drive the loop until the given actor completes. A device
        fault that outlasted its retries, and then a sim-validation
        violation, outrank the workload's own outcome — a detached
        actor's error would otherwise die silently in its task future,
        and a new epoch would recruit the faulted card again."""
        task = flow.spawn(coro, name="test-main")
        try:
            result = self.sched.run(until=task, timeout_time=timeout_time)
        except BaseException:
            self._raise_detached_error()
            raise
        self._raise_detached_error()
        return result

    def _on_fatal(self, e: BaseException) -> None:
        """A role's error that no recovery can mend: keep the first and
        stop the loop (shared by a sharing group), so that run raises
        it before anything recruits the card again."""
        if self._fatal is None:
            self._fatal = e
        self.sched.stop()

    def _raise_detached_error(self) -> None:
        # walk to the sharing group's root, then check every member —
        # a share_with secondary's fatal error or violation must not
        # die silently just because the PRIMARY's run() drives the loop
        root = self
        while root._share_src is not None:
            root = root._share_src
        stack = [root]
        group = []
        while stack:
            c = stack.pop()
            stack.extend(c._peer_clusters)
            group.append(c)
        for c in group:
            if c._fatal is not None:
                raise c._fatal
        for c in group:
            v = getattr(c, "_validator", None)
            if v is not None and v.is_ready and v.is_error:
                raise v.exception()

    def shutdown(self) -> None:
        # only the cluster that created the scheduler tears it down — a
        # share_with secondary must not pull it from under the primary
        if self._owns_scheduler:
            if self._io_pool is not None:
                self._io_pool.close()
            for d in self.net.disks.values():
                if hasattr(d, "close_all"):
                    d.close_all()   # release real-file handles
            flow.set_scheduler(None)
