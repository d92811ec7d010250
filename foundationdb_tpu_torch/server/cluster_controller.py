"""ClusterController: the elected brain — worker registry, recruitment,
ServerDBInfo broadcast, failure monitoring, master lifecycle.

Reference: fdbserver/ClusterController.actor.cpp — leader-elected via
the coordinators (LeaderElection.actor.cpp:78), keeps the worker
registry (registrationClient handshakes), recruits the transaction
subsystem per configuration (clusterRecruitFromConfiguration :1593),
broadcasts ServerDBInfo, runs the failure detection server, and
restarts the master — which re-runs the whole epoch recovery — whenever
any transaction-subsystem role fails (masterProcessFailure paths).
Failure detection here is the waitFailure heartbeat pattern
(fdbserver/WaitFailure.actor.cpp): ping every critical process; a
broken or timed-out ping is a failure.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

from .. import flow
from ..flow import AsyncVar, TaskPriority, error
from ..rpc import RequestStream, SimProcess
from .chaos import chaos_status as _chaos_status
from .coordination import CoordinatedState, elect_leader
from .dbinfo import (EMPTY_DBINFO, FULLY_RECOVERED, ServerDBInfo,
                     StorageRefs, StorageShard)
from .master import MasterRecovery
from .types import (CLEAR_RANGE, PING_REQUEST, SET_VALUE,
                    MetadataMutations)
from .worker import RegisterWorkerRequest


def _global_kernel_counters() -> dict:
    """Process-wide kernel launch profile for status. Guarded through
    sys.modules: a python-backend cluster never imported the ops layer,
    and status must not be the thing that drags torch's kernels in.
    Beside the profiled entries' counters, `launches.<kernel>` counts
    each CUDA kernel's launches in this process (`ops/*.launches`;
    only the ones launched, so the plain versions add none)."""
    import sys
    out: dict = {}
    for mod in ("foundationdb_tpu_torch.ops.conflict_kernel",
                "foundationdb_tpu_torch.ops.point_kernel"):
        m = sys.modules.get(mod)
        if m is not None:
            out.update(m.g_kernel_counters.snapshot())
    for mod in ("keys", "rmq", "conflict_kernel", "point_kernel"):
        m = sys.modules.get(f"foundationdb_tpu_torch.ops.{mod}")
        if m is not None:
            out.update((f"launches.{k}", n) for k, n in m.launches.items()
                       if n)
    return out


def epoch_roles(workers, epoch: int, cls):
    """Live current-epoch roles of `cls` from a CC worker registry:
    skip dead processes, match role class + the -e<epoch>- name
    convention. THE implementation of this walk — the CC's hot-spot
    push/merge and the Ratekeeper's input gathering both delegate
    here, so a change to role liveness or epoch naming lands once."""
    for wi in workers.values():
        if not wi.worker.process.alive:
            continue
        for rn, role in wi.worker.roles.items():
            if isinstance(role, cls) and f"-e{epoch}-" in rn:
                yield rn, role


class StorageHeatTable:
    """Decaying cluster-wide top-K of read-hot sub-ranges (ref: the DD/ratekeeper view over per-SS ReadHotSubRange replies).
    Same bounded-decay shape as ConflictHotSpots: each flagged range's
    read-bandwidth score halves every STORAGE_HEAT_HALF_LIFE seconds,
    the table caps at STORAGE_HEAT_MAX_ENTRIES (coldest evicted), so
    per-range state stays O(active hot ranges), never O(keyspace)."""

    __slots__ = ("_entries",)

    def __init__(self):
        # (server, begin, end) -> [decayed read-bps score, last density
        #                          ratio, last update time, sightings]
        self._entries: dict = {}

    @staticmethod
    def _decayed(score: float, since: float, now: float) -> float:
        hl = flow.SERVER_KNOBS.storage_heat_half_life
        if now <= since or hl <= 0:
            return score
        return score * 0.5 ** ((now - since) / hl)

    def record(self, server: str, begin: bytes, end: bytes,
               density: float, read_bps: float) -> None:
        now = flow.now()
        key = (server, begin, end)
        ent = self._entries.get(key)
        if ent is None:
            self._entries[key] = [float(read_bps), float(density), now, 1]
        else:
            ent[0] = self._decayed(ent[0], ent[2], now) + float(read_bps)
            ent[1] = float(density)
            ent[2] = now
            ent[3] += 1
        while len(self._entries) > \
                int(flow.SERVER_KNOBS.storage_heat_max_entries):
            worst = min(self._entries,
                        key=lambda k: self._decayed(
                            self._entries[k][0], self._entries[k][2], now))
            del self._entries[worst]

    def clear(self) -> None:
        self._entries.clear()

    def prune(self, live_servers) -> None:
        """Drop rows of retired replicas — a dead server's stale heat
        must not keep naming split candidates."""
        for key in [k for k in self._entries if k[0] not in live_servers]:
            del self._entries[key]

    def top(self, k: int = None) -> list:
        if k is None:
            k = int(flow.SERVER_KNOBS.storage_heat_top_k)
        now = flow.now()
        rows = [(self._decayed(s, t, now), d, srv, b, e, n)
                for (srv, b, e), (s, d, t, n) in self._entries.items()]
        rows.sort(key=lambda r: (-r[0], r[2], r[3]))
        return [{"server": srv, "begin": b.hex(), "end": e.hex(),
                 "density": round(d, 4), "read_bps": round(score, 2),
                 "sightings": n}
                for score, d, srv, b, e, n in rows[:k]]


def _client_profile_counters() -> dict:
    """Process-wide sampled-transaction profiler counters. Same
    sys.modules guard: a cluster that never sampled anything must not
    import the profiling module just to report zeros."""
    import sys
    m = sys.modules.get("foundationdb_tpu_torch.client.profiling")
    return m.profiler_counters() if m is not None else {}


def _run_loop_status() -> dict:
    """status.cluster.run_loop: the run-loop profiler rollup — step and
    busy-time totals, the wall-vs-sim ratio, the slow-task table (each
    entry carrying the coroutine suspension stack captured at the slow
    step), and the SIM_TASK_STATS attribution table when armed."""
    sched = flow.g()
    busy = sched.busy_seconds     # one read: the property may flush
    doc = {
        "tasks_run": sched.tasks_run,
        "busy_seconds": round(busy, 3),
        # how many sim-seconds each busy wall-second buys — the
        # sim-scale headline a faster simulator optimizes (None until the
        # loop has done any measurable work)
        "sim_seconds": round(sched.now(), 3),
        "sim_per_busy": (round(sched.now() / busy, 2) if busy > 0
                         else None),
        "slow_task_count": sched.slow_task_count,
        "slow_task_threshold": (
            sched.slow_task_threshold
            if sched.slow_task_threshold is not None
            else float(flow.SERVER_KNOBS.slow_task_threshold)),
        "slow_tasks": [
            {"task": n, "seconds": round(s, 4), "stack": stack}
            for n, s, stack in sorted(sched.slow_tasks,
                                      key=lambda t: -t[1])[:5]],
    }
    if sched.task_stats_armed:
        doc["task_stats"] = sched.task_stats_report(
            top_k=int(flow.SERVER_KNOBS.sim_task_stats_top_k))
    return doc


class ClusterConfig(NamedTuple):
    """(ref: DatabaseConfiguration — the subset this slice understands)"""

    n_proxies: int = 1
    n_resolvers: int = 1
    n_logs: int = 1            # log replication factor
    n_storage: int = 1         # storage shards
    storage_replicas: int = 1  # replicas per shard (same-tag teams)
    conflict_backend: str = "python"
    durable: bool = False
    storage_engine: str = "memory"   # memory | btree (ref: ssd engine)
    # 1 = single region; 2 = a remote region may attach (ref:
    # DatabaseConfiguration usable_regions — the fearless gate). The
    # region OBJECT still comes from the attach seam (cc.region);
    # this row is the committed operator intent that recruitment obeys.
    usable_regions: int = 1
    # explicit storage-team placement policy (a ReplicationPolicy over
    # processid/machineid/zoneid/dcid localities). None = the default
    # Across(storage_replicas, zoneid, One()). When set explicitly,
    # team construction is STRICT: an unsatisfiable policy refuses the
    # team instead of degrading (ref: DatabaseConfiguration
    # storagePolicy driving DDTeamCollection team building).
    storage_policy: object = None
    # where the CUDA conflict backends run: None = the card (raising
    # NoCudaDeviceError on a host without one), "cpu" = the kernels'
    # plain versions. Every worker's resolver is built on it; nothing
    # falls back from one to the other
    device: object = None


class OpenDatabaseRequest(NamedTuple):
    """Client handshake: long-polls until the broadcast sequence exceeds
    known_seq and recovery is complete (ref: openDatabase in
    ClusterController + MonitorLeader client polling)."""

    known_seq: int


class ChangeCoordinatorsRequest(NamedTuple):
    """Move the coordinated state to a new coordinator set (ref:
    ManagementAPI changeQuorum + MovableCoordinatedState,
    CoordinatedState.actor.cpp:220). `coordinators` is the new set's
    ref 4-tuples (reads, writes, candidacies, forwards)."""

    coordinators: tuple


class _WorkerInfo(NamedTuple):
    name: str
    machine: str
    worker: object
    roles: Tuple[str, ...]
    # always non-empty: registration falls back to machine / "dc0"
    zone: str
    dc: str


class ClusterController:
    def __init__(self, process: SimProcess, coordinators,
                 config: ClusterConfig, dbinfo_var=None,
                 takeover_from_region: bool = False,
                 leader_priority: int = 0):
        self.process = process
        self.config = config
        self.coordinators = coordinators   # ref 4-tuples:
        # (reads, writes, candidacies, forwards) — see SimCluster._coord_refs
        # dbinfo_var lets a promoted region's controller adopt the
        # broadcast var its storage servers already follow; a fresh CC
        # creates its own (ref: the remote DC's workers following the
        # same ServerDBInfo stream after failover)
        self.dbinfo = dbinfo_var if dbinfo_var is not None \
            else AsyncVar(EMPTY_DBINFO)
        # explicit region takeover (operator failover, ref: fdbcli
        # force_recovery_with_data_loss): recovery may end the previous
        # epoch by locking the REGION's log when no primary log survives
        self.takeover_from_region = takeover_from_region
        self.leader_priority = leader_priority
        self.workers: dict = {}            # name -> _WorkerInfo
        self.log_stores: dict = {}         # store name -> LogRefs (live)
        self.registrations = RequestStream(process)
        self.open_db = RequestStream(process)
        self.status_requests = RequestStream(process)
        self.management = RequestStream(process)
        self.excluded: set = set()         # worker names barred from roles
        # level-triggered: a change that lands mid-recovery is noticed
        # when the monitor next looks, never lost
        self._config_dirty = False
        self._move_inflight = False        # one shard move at a time
        self._vacate_seq = 0               # unique vacate-replica names
        self._vacate_retry_at = 0.0        # backoff for stuck vacates
        self._team_unhealthy_since: dict = {}  # tag -> first-seen time
        self._replica_progress: dict = {}  # name -> (version, since)
        self._dd_last_committed = -1       # idle detection for DD nudges
        self._max_tag_ever = max(config.n_storage - 1, 0)  # no tag reuse
        self.probe_paused = False          # quiet_database pauses probes
        self.backup_active = False         # continuous-backup tagging
        self.backup_agent = None           # the live agent, when any
        self.region = None                 # attached RemoteRegion, if any
        # authoritative shard boundaries (ref: the keyServers system
        # keyspace as ground truth); rebooted servers whose persisted
        # meta disagrees — e.g. crashed mid-move — are clamped to this
        self.shard_map: dict = {}          # name -> (tag, begin, end)
        self._recovery: Optional[MasterRecovery] = None
        self._recovery_task = None
        self._cstate: Optional[CoordinatedState] = None  # set once elected
        self._storage_objs: dict = {}      # name -> StorageServer (registry)
        # latest probe round + banded history per probe stage (ref: the
        # latencyProbe section of clusterGetStatus, Status.actor.cpp:983
        # — probes are real transactions, so the bands measure what a
        # client would actually experience)
        self._latency_probe: dict = {}
        self._probe_bands = {k: flow.RequestLatency(f"probe_{k}")
                             for k in ("grv", "read", "commit")}
        # the QoS telemetry plane: role name -> latest QosSample
        # (collected by _qos_sampler_loop at QOS_SAMPLE_INTERVAL; empty
        # when the knob is 0 — the plane then costs nothing anywhere)
        self.qos_samples: dict = {}
        # the storage heat plane's cluster rollup: decaying
        # top-K of read-hot sub-ranges across every storage replica +
        # the latest busiest-read-tag per server, fed by the QoS
        # sampler while STORAGE_HEAT_TRACKING is armed (empty — and
        # costless — otherwise)
        self.storage_heat = StorageHeatTable()
        self._heat_tags: dict = {}  # server -> (tag hex, busyness)
        # resolver split/merge accounting: the master's
        # balance loop records every split/merge/release/handoff
        # outcome here, so skew response is a status query
        # (`status.cluster.resolver_balance`), not a trace grep
        self.balance_stats = flow.CounterCollection("resolver_balance")
        self.balance_last: "dict | None" = None
        # the longitudinal plane (armed via METRIC_HISTORY):
        # the metric-history recorder, the SLO engine's latest verdict,
        # and TimeKeeper accounting. All stay empty/zero while the knob
        # is 0 — the plane's loops are then never even spawned, so the
        # off posture is byte-identical to pre-plane behavior
        self.metric_recorder = None
        self.slo_verdict: dict = {}
        self.slo_breaches = 0
        self._timekeeper_rows = 0
        # latency-forensics plane (armed via CRITICAL_PATH):
        # the decaying dominant-station table fed by the proxies' path
        # recorders, plus the host process's resource sampler. Same
        # off discipline as the longitudinal plane above.
        self.critical_path_table = None
        self._path_samples_folded = 0
        self.host_process_metrics = None
        # (instance name, counter) -> TimeSeries (ref: TDMetric levels)
        self.metrics: dict = {}
        self._metric_gauges: set = set()   # (rn, cn) sampled via set()
        self._rr = 0                       # recruitment round-robin
        self._seq = 0                      # dbinfo broadcast counter
        self._actors = flow.ActorCollection()

    def publish(self, info: ServerDBInfo) -> None:
        """Broadcast a new ServerDBInfo with a fresh sequence number —
        clients long-poll on the sequence so same-epoch updates (e.g. a
        rebooted storage's new endpoints) also reach them."""
        self._seq += 1
        self.dbinfo.set(info._replace(seq=self._seq))

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        loops = [(self._run(), "run"),
                 (self._registration_loop(), "register"),
                 (self._open_db_loop(), "openDatabase"),
                 (self._status_loop(), "status"),
                 (self._management_loop(), "management"),
                 (self._dd_loop(), "dataDistribution"),
                 (self._failure_monitor_loop(), "failureMonitor"),
                 (self._metric_sampler_loop(), "metricSampler"),
                 (self._qos_sampler_loop(), "qosSampler"),
                 (self._hot_spot_push_loop(), "hotSpotPush"),
                 (self._trace_counters_loop(), "traceCounters"),
                 (self._latency_probe_loop(), "latencyProbe"),
                 (self._conf_sync_loop(), "confSync")]
        # the longitudinal plane's loops exist ONLY while armed: gating
        # at spawn time (not inside the loop) keeps the METRIC_HISTORY=0
        # posture byte-identical — zero extra actors, zero extra timers,
        # identical scheduler step counts (the pinned off posture)
        if flow.SERVER_KNOBS.metric_history:
            loops += [(self._timekeeper_loop(), "timeKeeper"),
                      (self._metric_history_loop(), "metricHistory"),
                      (self._slo_loop(), "sloEngine")]
        # latency-forensics fold loop: same spawn-time
        # gating — CRITICAL_PATH=0 means the loop never exists
        if flow.SERVER_KNOBS.critical_path:
            from .critical_path import CriticalPathTable
            from .process_metrics import ProcessMetrics
            self.critical_path_table = CriticalPathTable()
            self.host_process_metrics = ProcessMetrics(role="cc")
            loops += [(self._critical_path_loop(), "criticalPath")]
        for coro, name in loops:
            self._actors.add(flow.spawn(coro, TaskPriority.CLUSTER_CONTROLLER,
                                        name=f"{self.process.name}.{name}"))
        self.process.on_kill(self._actors.cancel_all)

    async def _run(self) -> None:
        # an election against a moved-away quorum follows the forwards
        # to the live coordinator set. The nomination carries this CC's
        # client endpoints so a client can re-find the controller
        # through the coordinators after a failover (ref: LeaderInfo
        # reaching clients via MonitorLeader)
        from .coordination import LeaderInfo
        self.coordinators = await elect_leader(
            self.coordinators, b"\xff/clusterLeader",
            LeaderInfo(self.leader_priority, self.process.name,
                       self.open_db.ref(), self.status_requests.ref(),
                       self.management.ref()),
            self.process)
        self._cstate = CoordinatedState(
            [(c[0], c[1]) for c in self.coordinators], self.process)
        while True:
            await self._wait_for_workers()
            self._recovery = MasterRecovery(self.process, self,
                                            self._cstate, self.config)
            self._recovery_task = flow.spawn(
                self._recovery.run(), TaskPriority.CLUSTER_CONTROLLER,
                name=f"master-recovery-e{self._recovery.epoch}")
            # wait for recovery to fail, or for any critical role to die
            # after recovery completes (ref: masterFailure handling)
            failed = await self._watch_epoch(self._recovery_task)
            flow.cover("cc.epoch_failed")
            flow.TraceEvent("MasterEpochFailed", self.process.name).detail(
                Reason=failed).log()
            self._recovery_task.cancel()
            self._recovery.aux.cancel_all()
            if self._recovery.master is not None:
                self._recovery.master.stop()
            self._cancel_old_roles()

    async def _metric_sampler_loop(self) -> None:
        """Sample every live role's counters into multi-resolution time
        series (ref: flow/TDMetric.actor.h levels + the SystemMonitor
        periodic events): recent history fine-grained, old history
        cheap, all served through status."""
        while True:
            await flow.delay(flow.SERVER_KNOBS.metric_sample_interval,
                             TaskPriority.LOW_PRIORITY)
            now = flow.now()
            known: set = set()
            for wi in self.workers.values():
                # a rebooting worker's roles keep their HISTORY (its
                # registry entry persists through the reboot window);
                # only roles gone from the registry entirely are pruned
                known.update(wi.worker.roles.keys())
                if not wi.worker.process.alive:
                    continue
                for rn, role in wi.worker.roles.items():
                    stats = getattr(role, "stats", None)
                    if stats is None:
                        continue
                    for cname, c in stats.counters.items():
                        ts = self.metrics.get((rn, cname))
                        if ts is None:
                            ts = self.metrics[(rn, cname)] = \
                                flow.TimeSeries()
                        if c.gauge:
                            self._metric_gauges.add((rn, cname))
                        ts.append(now, c.value)
            # prune series of retired roles (old epochs, vacated
            # replicas): unbounded growth and stale 'latest' values
            # otherwise leak into every status document
            for key in [k for k in self.metrics if k[0] not in known]:
                del self.metrics[key]
                self._metric_gauges.discard(key)

    async def _qos_sampler_loop(self) -> None:
        """Collect every live role's QosSample (smoothed queue/lag/rate
        saturation signals) at QOS_SAMPLE_INTERVAL — the measurement
        half of the Ratekeeper feedback loop (ref: updateRate polling
        StorageQueuingMetrics/TLogQueuingMetrics; here the roles
        publish through one QosSample vocabulary and the controller
        holds the latest snapshot for status/exporter/ratekeeper).
        Interval 0 disables the plane: the dict empties and no role
        pays a thing (signals are pull-computed, never hot-path)."""
        while True:
            interval = flow.SERVER_KNOBS.qos_sample_interval
            if interval <= 0:
                if self.qos_samples:
                    self.qos_samples.clear()
                await flow.delay(1.0, TaskPriority.LOW_PRIORITY)
                continue
            await flow.delay(interval, TaskPriority.LOW_PRIORITY)
            now = flow.now()
            known: set = set()
            for wi in self.workers.values():
                if not wi.worker.process.alive:
                    continue
                for rn, role in wi.worker.roles.items():
                    fn = getattr(role, "qos_sample", None)
                    if fn is None:
                        continue
                    known.add(rn)
                    self.qos_samples[rn] = fn(now)
            # prune retired roles (old epochs, vacated replicas) so the
            # status document never reports a dead role's stale signals
            for rn in [r for r in self.qos_samples if r not in known]:
                del self.qos_samples[rn]
            self._roll_storage_heat()

    def _roll_storage_heat(self) -> None:
        """Fold every live replica's read-hot ranges + busiest read tag
        into the cluster rollup (one pull per QOS_SAMPLE_INTERVAL —
        the per-range state is the roles' own samples, never a second
        copy of the keyspace). Disarmed: empty both tables and pay one
        knob read per tick."""
        if not flow.SERVER_KNOBS.storage_heat_tracking:
            if self._heat_tags or self.storage_heat._entries:
                self.storage_heat.clear()
                self._heat_tags.clear()
            return
        live: set = set()
        for name, obj in self._storage_objs.items():
            if not obj.process.alive:
                continue
            live.add(name)
            for b, e, density, read_bps in obj.read_hot_ranges():
                self.storage_heat.record(name, b, e, density, read_bps)
            tag, busy = obj.busiest_read_tag()
            if tag is not None:
                self._heat_tags[name] = (tag.hex(), round(busy, 4))
            else:
                self._heat_tags.pop(name, None)
        self.storage_heat.prune(live)
        for name in [n for n in self._heat_tags if n not in live]:
            del self._heat_tags[name]

    def _epoch_roles(self, info, cls):
        """Live current-epoch roles of `cls` from the registry — the
        walk shared by the hot-spot merge/push and the ratekeeper's
        input gathering (module-level `epoch_roles` is the single
        implementation)."""
        return epoch_roles(self.workers, info.epoch, cls)

    def _merged_hot_rows(self, info) -> tuple:
        """Cluster-merged raw hot-spot rows across the current epoch's
        resolvers, hottest first: (begin, end, score, total,
        last_conflict_version). Keyspace-sharded resolvers each see
        disjoint causes; after a split-resolver move both owners may
        report the same range — scores sum, versions max."""
        from .resolver_role import Resolver
        merged: dict = {}
        for _rn, role in self._epoch_roles(info, Resolver):
            for b, e, s, t, v in role.hot_spots.rows():
                ent = merged.get((b, e))
                if ent is None:
                    merged[(b, e)] = [s, t, v]
                else:
                    ent[0] += s
                    ent[1] += t
                    ent[2] = max(ent[2], v)
        rows = [(b, e, s, t, v)
                for (b, e), (s, t, v) in merged.items()]
        rows.sort(key=lambda r: (-r[2], r[0], r[1]))
        return tuple(rows[:int(flow.SERVER_KNOBS.hot_spot_max_entries)])

    async def _hot_spot_push_loop(self) -> None:
        """Feed the conflict-prediction plane: the cluster-merged hot-spot rows — the only place the
        per-resolver attribution tables meet — are pushed to every
        current-epoch proxy at SCHED_HOT_PUSH_INTERVAL, where they
        drive the admission scheduler's ConflictPredictor and the GRV
        conflict-window piggyback. Idle (one knob read per interval)
        while both consuming planes are off."""
        while True:
            interval = flow.SERVER_KNOBS.sched_hot_push_interval
            await flow.delay(interval if interval > 0 else 1.0,
                             TaskPriority.LOW_PRIORITY)
            k = flow.SERVER_KNOBS
            if not (k.conflict_scheduling or k.client_conflict_windows
                    or k.txn_repair):
                continue
            from .proxy import Proxy
            info = self.dbinfo.get()
            rows = self._merged_hot_rows(info)
            for _rn, role in self._epoch_roles(info, Proxy):
                role.update_hot_spots(rows)

    async def _trace_counters_loop(self) -> None:
        """Roll every live role's CounterCollection into a periodic
        `*Metrics` TraceEvent with per-interval rates (ref:
        traceCounters, flow/Stats.actor.cpp — the reference's roles each
        run their own loop; the sim's registry lets one loop cover all
        of them). This is what turns the raw counters into rates an
        operator — or a later BENCH round — can actually read."""
        prev: dict = {}          # role name -> (snapshot, taken_at)
        while True:
            await flow.delay(flow.SERVER_KNOBS.trace_counters_interval,
                             TaskPriority.LOW_PRIORITY)
            now = flow.now()
            known: set = set()
            for wi in self.workers.values():
                # a rebooting worker's rate baselines survive the
                # reboot window (same rule as the metric sampler): a
                # missed tick must not blank the very rates an operator
                # reads around a fault. Only registry-departed roles
                # are pruned. Rates divide by each baseline's own age,
                # so a role that missed ticks reports a correct average
                # instead of an inflated one.
                known.update(wi.worker.roles.keys())
                if not wi.worker.process.alive:
                    continue
                for rn, role in wi.worker.roles.items():
                    stats = getattr(role, "stats", None)
                    if stats is None:
                        continue
                    p = prev.get(rn)
                    snap = stats.trace(
                        id=rn, elapsed=now - p[1] if p else None,
                        prev=p[0] if p else None)
                    prev[rn] = (snap, now)
            for key in [k for k in prev if k not in known]:
                del prev[key]

    async def _failure_monitor_loop(self) -> None:
        """Heartbeat every registered worker over the network and PUSH
        the failed set through the dbinfo broadcast (ref: the failure
        detection server + FailureMonitorClient — clients learn about
        down or unreachable machines without burning per-request
        timeouts; catches clogged-but-alive processes a liveness flag
        would miss)."""
        while True:
            await flow.delay(flow.SERVER_KNOBS.failure_detection_interval,
                             TaskPriority.FAILURE_MONITOR)
            pinged, futs = [], []
            for name, wi in self.workers.items():
                # snapshot the incarnation AND its roles with the ping:
                # a worker that reboots mid-round must not have its
                # freshly recovered roles blamed for the old ping
                pinged.append((name, tuple(wi.worker.roles.keys())))
                futs.append(flow.catch_errors(flow.timeout_error(
                    wi.worker.pings.ref().get_reply(PING_REQUEST,
                                                    self.process),
                    flow.SERVER_KNOBS.failure_monitor_ping_timeout)))
            settled = await flow.all_of(futs)
            failed: set = set()
            for (name, roles), f in zip(pinged, settled):
                if f.is_error:
                    failed.add(name)
                    # the roles a down worker hosts are down too —
                    # replica names are what clients route by
                    failed.update(roles)
            cur = self.dbinfo.get()
            if tuple(sorted(failed)) != cur.failed:
                flow.cover("cc.failure_state_pushed")
                self.publish(cur._replace(failed=tuple(sorted(failed))))

    async def _wait_for_workers(self) -> None:
        need = max(self.config.n_logs, 1)
        while self._live_included_workers() < need:
            await flow.delay(flow.SERVER_KNOBS.cc_worker_poll_delay,
                             TaskPriority.CLUSTER_CONTROLLER)

    async def _watch_epoch(self, recovery_task) -> str:
        """Resolve when this epoch is over: recovery errored, or a
        critical process died post-recovery."""
        # phase 1: wait for full recovery (or recovery failure)
        while True:
            info = self.dbinfo.get()
            if info.recovery_state == FULLY_RECOVERED:
                break
            got = await flow.first_of(flow.catch_errors(recovery_task),
                                      self.dbinfo.on_change())
            if got[0] == 0:
                inner = got[1]
                if inner.is_error:
                    return f"recovery_error:{inner.exception()}"
                return "recovery_returned"
        # phase 2: monitor the recruited processes (ref: waitFailure
        # heartbeats; the sim checks liveness directly — a ping RPC to a
        # dead process would report the same thing a beat later) and
        # management-driven config changes (level-triggered so a change
        # that raced the recovery is still honored). A critical process
        # that is ALIVE but ping-unreachable (a partitioned or wedged
        # machine — the failure monitor's set) for a sustained window
        # ends the epoch exactly like a death: the reference's failure
        # detection is network-based, so a partition triggers a real
        # recovery, not an indefinite stall (ref: waitFailureServer
        # timeouts). The window sits above every ordinary BUGGIFY clog
        # so transient clogging never thrashes epochs.
        unreachable_since: dict = {}
        while True:
            if self._config_dirty:
                self._config_dirty = False
                return "configuration_changed"
            failed = set(self.dbinfo.get().failed)
            limit = float(flow.SERVER_KNOBS.failure_unreachable_seconds)
            now = flow.now()
            for proc in self._recovery.critical_procs:
                if not proc.alive:
                    return f"process_failed:{proc.name}"
                if limit > 0 and proc is not self.process \
                        and proc.name in failed:
                    since = unreachable_since.setdefault(proc.name, now)
                    if now - since >= limit:
                        flow.cover("cc.epoch_unreachable")
                        return f"process_unreachable:{proc.name}"
                else:
                    unreachable_since.pop(proc.name, None)
            await flow.delay(flow.SERVER_KNOBS.failure_detection_interval,
                             TaskPriority.FAILURE_MONITOR)

    def _cancel_old_roles(self) -> None:
        """Cancel surviving roles of the failed epoch so stale proxies
        and resolvers stop answering (ref: the old generation's actors
        dying with the master's lifetime)."""
        epoch = self._recovery.epoch if self._recovery else 0
        for wi in self.workers.values():
            w = wi.worker
            for name, role in list(w.roles.items()):
                if name.startswith((f"proxy-e{epoch}", f"resolver-e{epoch}",
                                    f"ratekeeper-e{epoch}")):
                    stop = getattr(role, "stop", None)
                    if stop is not None:
                        stop()
                    else:
                        role._actors.cancel_all()
                    del w.roles[name]

    # -- worker registry -------------------------------------------------
    async def _registration_loop(self):
        while True:
            req, reply = await self.registrations.pop()
            assert isinstance(req, RegisterWorkerRequest)
            p = req.worker.process
            self.workers[req.name] = _WorkerInfo(
                req.name, req.machine, req.worker, (),
                getattr(p, "zone", req.machine),
                getattr(p, "dc", "dc0"))
            for lr in req.recovered_logs:
                self.log_stores[lr.store] = lr
            if req.recovered_logs:
                self._merge_recovered_logs(req.recovered_logs)
            if req.recovered_storages:
                for r in req.recovered_storages:
                    obj = req.worker.roles.get(r.name)
                    if obj is not None:
                        self._storage_objs[r.name] = obj
                self._merge_storages(req.recovered_storages)
            reply.send(None)

    def _merge_recovered_logs(self, refs) -> None:
        """A rebooted worker re-registered old-generation log stores:
        swap the fresh endpoints into the broadcast picture by store
        name, or a behind storage server could never finish draining
        that generation — its peeks would hit the dead pre-reboot refs
        until the next full recovery (found by the DD-under-attrition
        workload). Current-generation refs are recovery's job: a
        current tlog death already ends the epoch."""
        info = self.dbinfo.get()
        by_store = {lr.store: lr for lr in refs}
        changed = False
        new_old = []
        for gen in info.old_logs:
            logs = tuple(by_store.get(lr.store, lr) for lr in gen.logs)
            # a store that was UNREACHABLE when this generation's
            # picture was built rejoins by name — without this, a
            # reader needing the generation would wait forever (and
            # before the strict-coverage rule, it silently skipped)
            present = {lr.store for lr in logs}
            for store, _machine in gen.stores:
                lr = by_store.get(store)
                if lr is not None and store not in present:
                    flow.cover("cc.old_log_rejoined")
                    logs = logs + (lr,)
                    present.add(store)
            if logs != gen.logs:
                changed = True
            new_old.append(gen._replace(logs=logs))
        if changed:
            self.publish(info._replace(old_logs=tuple(new_old)))

    def _merge_storages(self, refs: Tuple[StorageRefs, ...]) -> None:
        """A rebooted worker re-registered storage shards: swap the new
        endpoints into the broadcast map, clamping each server's bounds
        to the authoritative shard map (its persisted meta may be stale
        if it crashed mid-move; the clamp also makes it shed data it no
        longer owns)."""
        info = self.dbinfo.get()
        shards = list(info.storages)
        changed = False
        for r in refs:
            auth = self.shard_map.get(r.name)
            if auth is None:
                continue
            _tag, b, e = auth
            if (r.begin, r.end) != (b, e):
                obj = self._storage_objs.get(r.name)
                if obj is not None:
                    flow.spawn(obj.set_bounds(b, e),
                               TaskPriority.DATA_DISTRIBUTION,
                               name=f"{r.name}.clampBounds")
                r = r._replace(begin=b, end=e)
            for si, shard in enumerate(shards):
                if any(rep.name == r.name for rep in shard.replicas):
                    shards[si] = shard._replace(replicas=tuple(
                        r if rep.name == r.name else rep
                        for rep in shard.replicas))
                    changed = True
        if changed:
            self.publish(info._replace(storages=tuple(shards)))

    # -- recruitment helpers (used by MasterRecovery) -------------------
    @staticmethod
    def _locality_of(wi) -> "Locality":
        from .replication_policy import Locality
        return Locality(processid=wi.name, machineid=wi.machine,
                        zoneid=wi.zone, dcid=wi.dc)

    def storage_policy(self, n: int):
        """The storage-team policy and whether it is strict: an
        explicitly configured policy refuses unsatisfiable teams; the
        default Across(n, zoneid, One()) degrades (ref:
        DatabaseConfiguration storagePolicy)."""
        from .replication_policy import PolicyAcross, PolicyOne
        if self.config.storage_policy is not None:
            return self.config.storage_policy, True
        return PolicyAcross(n, "zoneid", PolicyOne()), False

    def pick_workers(self, n: int, role: str, policy=None,
                     strict: bool = False):
        """Policy-placed selection over live, non-excluded workers:
        replicas land in distinct failure domains when the worker pool
        allows it, degrading to round-robin when it cannot — unless
        `strict`, in which case an unsatisfiable policy raises
        no_more_servers (a policy-violating team is unconstructible)
        (ref: clusterRecruitFromConfiguration applying the
        configuration's storagePolicy/tLogPolicy;
        fdbrpc/ReplicationPolicy.h). Candidate order rotates so
        consecutive recruitments spread roles the way the reference's
        fitness ranking does."""
        from .replication_policy import PolicyAcross, PolicyOne
        # recruitment is DC-local (ref: clusterRecruitFromConfiguration
        # recruiting the transaction subsystem in the primary DC):
        # satellite log workers register for lock/rejoin visibility but
        # must never be handed proxy/resolver/storage roles
        my_dc = getattr(self.process, "dc", "dc0")
        live = [wi for name, wi in self.workers.items()
                if wi.worker.process.alive and name not in self.excluded
                and wi.dc == my_dc]
        # prefer ping-REACHABLE workers: recruiting onto an alive but
        # partitioned machine hands the new epoch a role nobody can
        # talk to, and the unreachability watchdog immediately ends it
        # again — recovery-storms for the whole partition. Fall back to
        # the full live set when the reachable pool is too small (the
        # failure monitor may simply be behind)
        unreachable = set(self.dbinfo.get().failed)
        reachable = [wi for wi in live if wi.name not in unreachable]
        if len(reachable) >= n:
            live = reachable
        if not live:
            raise error("no_more_servers")
        rot = self._rr % len(live)
        self._rr += n
        ordered = live[rot:] + live[:rot]
        cands = [(wi.worker, self._locality_of(wi)) for wi in ordered]
        if policy is None:
            policy = PolicyAcross(n, "zoneid", PolicyOne())
        team = policy.select(cands)
        if team is not None:
            return team
        if strict:
            flow.TraceEvent("RecruitmentPolicyUnsatisfiable",
                            self.process.name,
                            severity=flow.trace.SevWarnAlways).detail(
                Role=role, Policy=repr(policy),
                Zones=len({wi.zone for wi in live})).log()
            raise error("no_more_servers")
        # not enough failure domains: place anyway, spread round-robin
        # (the reference recruits in degraded mode rather than stall)
        flow.TraceEvent("RecruitmentPolicyDegraded", self.process.name,
                        severity=flow.trace.SevWarn).detail(
            Role=role, Needed=n,
            Zones=len({wi.zone for wi in live})).log()
        return [ordered[i % len(ordered)].worker for i in range(n)]

    def storage_splits(self) -> Tuple[bytes, ...]:
        info = self.dbinfo.get()
        if info.storages:
            return tuple(s.begin for s in info.storages[1:])
        return tuple(bytes([(i * 256) // self.config.n_storage])
                     for i in range(1, self.config.n_storage))

    def storage_tags(self) -> Tuple[int, ...]:
        """Tags in shard (begin) order — explicit because splits mint
        fresh tags mid-keyspace."""
        info = self.dbinfo.get()
        if info.storages:
            return tuple(s.tag for s in info.storages)
        return tuple(range(self.config.n_storage))

    def recruit_initial_storages(self) -> None:
        """First boot only: create the shard set (ref: the initial
        `configure new` creating storage servers via DD; static shards
        here until DataDistribution arrives)."""
        info = self.dbinfo.get()
        if info.storages:
            return
        splits = list(self.storage_splits())
        bounds = [b""] + splits + [None]
        nrep = max(1, self.config.storage_replicas)
        pol, strict = self.storage_policy(nrep)
        storages = []
        for i in range(self.config.n_storage):
            team = self.pick_workers(nrep, role="storage", policy=pol,
                                     strict=strict)
            replicas = []
            for j, w in enumerate(team):
                refs = w.recruit_storage(f"storage-{i}-r{j}", i, bounds[i],
                                         bounds[i + 1])
                replicas.append(refs)
                self._storage_objs[refs.name] = w.roles[refs.name]
                self.shard_map[refs.name] = (i, bounds[i], bounds[i + 1])
            storages.append(StorageShard(i, bounds[i], bounds[i + 1],
                                         tuple(replicas)))
        self.publish(info._replace(storages=tuple(storages)))

    def tlog_objs(self):
        """Live TLog role objects of the current generation (stats feed
        for the ratekeeper; sim stand-in for TLogQueuingMetrics)."""
        out = []
        info = self.dbinfo.get()
        for lr in info.logs.logs:
            for wi in self.workers.values():
                obj = wi.worker.roles.get(lr.store)
                if obj is not None and wi.worker.process.alive:
                    out.append(obj)
        return out

    def min_storage_version(self) -> int:
        """Smallest DURABLE version across shards — the floor for
        retiring old log generations. A dead or unregistered shard
        pins the floor at 0: it may come back needing everything the
        old generation still holds."""
        info = self.dbinfo.get()
        vs = []
        for s in info.storages:
            for rep in s.replicas:
                obj = self._storage_objs.get(rep.name)
                if obj is None or not obj.process.alive:
                    return 0
                vs.append(obj.durable_version.get())
        return min(vs) if vs else 0

    # -- management -------------------------------------------------------
    async def _management_loop(self):
        """(ref: ManagementAPI + ApplyMetadataMutation.h — management
        state changes arrive as COMMITTED \\xff/conf//\\xff/excluded
        mutations forwarded by the proxies; a config change ends the
        epoch so recovery rebuilds the transaction subsystem with the
        new shape. Only the coordinators change — which needs the
        quorum-move dance, not a key write — remains a direct request.)"""
        while True:
            req, reply = await self.management.pop()
            if isinstance(req, MetadataMutations):
                self._apply_metadata_mutations(req)
            elif isinstance(req, ChangeCoordinatorsRequest):
                try:
                    await self._change_coordinators(
                        tuple(req.coordinators))
                    reply.send(None)
                except flow.FdbError as e:
                    reply.send_error(e)
                except Exception:
                    # a malformed payload (non-ref elements) must fail
                    # the REQUEST, never the management loop
                    reply.send_error(error("operation_failed"))
            else:
                reply.send_error(error("client_invalid_operation"))

    def _apply_metadata_mutations(self, req) -> None:
        """React to committed management keys (ref:
        ApplyMetadataMutation.h + the CC watching configuration: the
        committed rows are the medium; this interprets them — the
        low-latency trigger; _conf_sync_loop reconciles from the
        stored rows, so a lost notice only delays, never diverges).
        Invalid values are IGNORED with a SevWarnAlways trace rather
        than bricking recovery in a retry loop — mirroring the
        reference, where an unrecruitable \\xff/conf shape needs
        operator repair."""
        from .systemkeys import CONFLICT_BACKENDS, CONF_MUTABLE, \
            CONF_PREFIX, CONF_ROWS, EXCLUDED_PREFIX
        updates: dict = {}
        # worker -> desired excluded state, LAST mutation wins — a
        # single transaction may set then clear the same row and the
        # committed (ordered) outcome is what must apply
        excl_state: dict = {}
        for m in req.mutations:
            if m.type == CLEAR_RANGE:
                known = set(self.excluded) | \
                    {w for w, v in excl_state.items() if v}
                for w in known:
                    if m.param1 <= EXCLUDED_PREFIX + w.encode() \
                            < m.param2:
                        excl_state[w] = False
                for row in CONF_MUTABLE:
                    if m.param1 <= CONF_PREFIX + row.encode() < m.param2:
                        field = CONF_ROWS[row]
                        updates[field] = getattr(ClusterConfig(), field)
            elif m.type != SET_VALUE:
                # atomics on management keys have storage-side results
                # the proxy does not evaluate: leave them to the
                # reconcile loop, which reads the actual rows back
                flow.cover("cc.metadata.non_set_deferred")
            elif m.param1.startswith(CONF_PREFIX):
                row = m.param1[len(CONF_PREFIX):].decode(errors="replace")
                if row not in CONF_MUTABLE:
                    continue  # informational/unknown rows: inert
                field = CONF_ROWS[row]
                if row == "conflict_backend":
                    updates[field] = m.param2.decode(errors="replace")
                else:
                    try:
                        updates[field] = int(m.param2)
                    except ValueError:
                        flow.TraceEvent(
                            "MetadataConfValueIgnored", self.process.name,
                            severity=flow.trace.SevWarnAlways).detail(
                            Key=row, Value=repr(m.param2)).log()
            elif m.param1.startswith(EXCLUDED_PREFIX):
                w = m.param1[len(EXCLUDED_PREFIX):].decode(
                    errors="replace")
                excl_state[w] = True
        for w, want in excl_state.items():
            if not want:
                self.excluded.discard(w)
        for w, want in excl_state.items():
            if not want:
                continue
            need = max(self.config.n_logs, self.config.n_proxies,
                       self.config.n_resolvers, 1)
            if self._live_included_workers(without=w) < need:
                # honoring it would strand recovery in a retry loop;
                # the committed row stays (operator repair, like the
                # reference's FORCE-mode exclusions)
                flow.cover("cc.metadata.exclusion_unrecruitable")
                flow.TraceEvent(
                    "MetadataExclusionIgnored", self.process.name,
                    severity=flow.trace.SevWarnAlways).detail(
                    Worker=w).log()
                continue
            self.excluded.add(w)
            if self._hosts_current_txn_role(w):
                self._config_dirty = True
        if updates:
            cand = self.config._replace(**updates)
            live = self._live_included_workers()
            if (cand.n_proxies < 1 or cand.n_resolvers < 1
                    or cand.n_logs < 1 or cand.n_logs > live
                    or cand.n_resolvers > live or cand.n_proxies > live
                    or cand.usable_regions not in (1, 2)
                    or cand.conflict_backend not in CONFLICT_BACKENDS):
                flow.cover("cc.metadata.config_unrecruitable")
                flow.TraceEvent(
                    "MetadataConfigIgnored", self.process.name,
                    severity=flow.trace.SevWarnAlways).detail(
                    Config=repr(updates)).log()
            elif cand != self.config:
                self.config = cand
                self._config_dirty = True

    async def _conf_sync_loop(self) -> None:
        """The committed \\xff/conf//\\xff/excluded rows are
        AUTHORITATIVE (ref: the reference reading its configuration
        from the system keyspace during recovery): every sync round
        (a) ADOPTS valid divergent rows into the live config and
        exclusion set — so a lost proxy notice (the one-way datagram
        is only the low-latency trigger) delays a change, never loses
        it; (b) REPAIRS unparsable/unrecruitable rows back to the live
        values — an acked-but-invalid row must not sit forever; and
        (c) SEEDS missing rows (the initial `configure new`
        analogue)."""
        from ..client import Database
        db = Database(self.process, self.open_db.ref(),
                      status_ref=self.status_requests.ref(),
                      management_ref=self.management.ref())
        self.process.on_kill(db.close)
        while True:
            await flow.delay(flow.SERVER_KNOBS.conf_sync_interval,
                             TaskPriority.CLUSTER_CONTROLLER)
            if self.dbinfo.get().recovery_state != FULLY_RECOVERED:
                continue
            try:
                await self._conf_sync_once(db)
            except flow.FdbError as e:
                if e.name == "operation_cancelled":
                    raise
                flow.TraceEvent("ConfSyncRetry", self.process.name,
                                severity=flow.trace.SevWarn).detail(
                    Error=e.name).log()

    async def _conf_sync_once(self, db) -> None:
        from ..client import run_transaction
        from .systemkeys import (CONF_END, CONF_MUTABLE, CONF_PREFIX,
                                 CONF_ROWS, CONFLICT_BACKENDS,
                                 EXCLUDED_END, EXCLUDED_PREFIX)

        async def read(tr):
            tr.set_option("read_system_keys")
            conf = dict(await tr.get_range(CONF_PREFIX, CONF_END))
            excl = dict(await tr.get_range(EXCLUDED_PREFIX, EXCLUDED_END))
            return conf, excl

        conf_rows, excl_rows = await run_transaction(db, read,
                                                     max_retries=50)
        repairs: dict = {}       # key -> value to set (None = clear)
        updates: dict = {}
        for row, field in CONF_ROWS.items():
            key = CONF_PREFIX + row.encode()
            live = str(getattr(self.config, field)).encode()
            val = conf_rows.get(key)
            if val is None:
                repairs[key] = live          # seed missing row
                continue
            if row not in CONF_MUTABLE:
                if val != live:
                    repairs[key] = live      # informational: follow live
                continue
            if row == "conflict_backend":
                updates[field] = val.decode(errors="replace")
            else:
                try:
                    updates[field] = int(val)
                except ValueError:
                    repairs[key] = live
        cand = self.config._replace(**updates)
        live_workers = self._live_worker_names()
        n_live = sum(1 for name in live_workers
                     if name not in self.excluded)
        if (cand.n_proxies < 1 or cand.n_resolvers < 1
                or cand.n_logs < 1 or cand.n_logs > n_live
                or cand.n_resolvers > n_live or cand.n_proxies > n_live
                or cand.usable_regions not in (1, 2)
                or cand.conflict_backend not in CONFLICT_BACKENDS):
            flow.cover("cc.metadata.sync_repair_config")
            flow.TraceEvent("ConfRowsRepaired", self.process.name,
                            severity=flow.trace.SevWarnAlways).detail(
                Config=repr(updates)).log()
            for row in CONF_MUTABLE:
                field = CONF_ROWS[row]
                repairs[CONF_PREFIX + row.encode()] = \
                    str(getattr(self.config, field)).encode()
        elif cand != self.config:
            flow.cover("cc.metadata.sync_adopted")
            self.config = cand
            self._config_dirty = True
        # exclusions: the rows are the truth; refuse (and repair) only
        # rows that would leave recruitment impossible
        desired_excl: set = set()
        need = max(self.config.n_logs, self.config.n_proxies,
                   self.config.n_resolvers, 1)
        for key in sorted(excl_rows):
            w = key[len(EXCLUDED_PREFIX):].decode(errors="replace")
            remaining = sum(1 for name in live_workers
                            if name not in desired_excl and name != w)
            if remaining < need:
                flow.cover("cc.metadata.sync_repair_exclusion")
                flow.TraceEvent(
                    "ExclusionRowRepaired", self.process.name,
                    severity=flow.trace.SevWarnAlways).detail(
                    Worker=w).log()
                repairs[key] = None
                continue
            desired_excl.add(w)
        if desired_excl != self.excluded:
            added = desired_excl - self.excluded
            self.excluded = desired_excl
            if any(self._hosts_current_txn_role(w) for w in added):
                self._config_dirty = True
        if repairs:
            async def fix(tr):
                tr.set_option("access_system_keys")
                for k, v in repairs.items():
                    if v is None:
                        tr.clear(k)
                    else:
                        tr.set(k, v)
            await run_transaction(db, fix, max_retries=50)

    @staticmethod
    def _coord_id(c) -> tuple:
        """Stable identity of a coordinator ref-tuple (refs deserialize
        into fresh objects, so compare (process, token) pairs)."""
        return tuple((r.endpoint.process.name, r.endpoint.token)
                     for r in c[:4])

    async def _change_coordinators(self, new_coords: tuple) -> None:
        """MovableCoordinatedState (ref: CoordinatedState.actor.cpp:220
        + ManagementAPI changeQuorum): seed the NEW quorum with the
        current core state, then EXCLUSIVELY tombstone the old quorum
        with a MovedValue (a concurrent recovery's write makes this
        conflict and the whole change aborts cleanly), then decommission
        the old coordinators so everything redirects. Ends the epoch so
        the next recovery commits through the new quorum."""
        from .coordination import ForwardRequest, MovedValue
        # validate BEFORE touching anything: a malformed request must
        # fail the request, never the management loop
        if len(new_coords) < 1 or any(len(c) < 4 for c in new_coords):
            raise error("invalid_option_value")
        if getattr(self, "_cstate", None) is None:
            raise error("operation_failed")   # not elected yet
        new_ids = {self._coord_id(c) for c in new_coords}
        if new_ids == {self._coord_id(c) for c in self.coordinators}:
            flow.cover("coordination.change.noop")
            return  # already the active set (ref: changeQuorum no-op);
                    # re-running the move would forward the live quorum
                    # at itself and brick the cluster
        # the move runs on a PRIVATE handle over the old quorum: the
        # epoch machinery shares self._cstate, and sharing its
        # generation would let the tombstone commit at a generation
        # this mover never read — breaking the exclusivity that makes
        # a racing recovery abort the change
        old_cs = CoordinatedState(
            [(c[0], c[1]) for c in self.coordinators], self.process)
        # 0. rejoin broadcast: members of the new set clear any STALE
        # forward left from a previous decommissioning (a change-back
        # to once-retired hosts must not chase their old forwards)
        await flow.all_of([flow.catch_errors(flow.timeout_error(
            c[3].get_reply(ForwardRequest(new_coords), self.process),
            flow.SERVER_KNOBS.coordinator_forward_timeout))
            for c in new_coords])
        # 1. current state through the current quorum (raises read gens)
        cur = await old_cs.read()
        # 2. seed the new quorum
        new_cs = CoordinatedState(
            [(c[0], c[1]) for c in new_coords], self.process)
        await new_cs.read()
        await new_cs.set_exclusive(cur)
        # 3. exclusive tombstone on the old quorum — the linearization
        # point: past this await the change IS committed
        await old_cs.set_exclusive(MovedValue(new_coords, cur))
        # the change is durable: adopt the new quorum unconditionally
        # before the best-effort decommissioning below
        old_set = [c for c in self.coordinators
                   if self._coord_id(c) not in new_ids]
        self.coordinators = list(new_coords)
        self._cstate = new_cs
        flow.TraceEvent("CoordinatorsChanged", self.process.name).detail(
            N=len(new_coords)).log()
        # force a recovery: the next epoch's core state commits through
        # the new quorum (ref: changeQuorum triggering recovery)
        self._config_dirty = True
        # 4. decommission old coordinators NOT in the new set. Pure
        # best effort: the MovedValue tombstone already redirects any
        # reader that reaches a non-forwarded old coordinator
        await flow.all_of([flow.catch_errors(flow.timeout_error(
            c[3].get_reply(ForwardRequest(new_coords), self.process),
            flow.SERVER_KNOBS.coordinator_forward_timeout))
            for c in old_set])

    def _live_worker_names(self) -> list:
        """Alive workers in THIS controller's DC — the same filter
        pick_workers applies: cross-DC satellite workers can hold log
        replicas but never transaction roles, so recruitable-shape
        checks counting them would approve configs the primary DC
        cannot actually host."""
        my_dc = getattr(self.process, "dc", "dc0")
        return [name for name, wi in self.workers.items()
                if wi.worker.process.alive and wi.dc == my_dc]

    def _live_included_workers(self, without: str = None) -> int:
        return sum(1 for name in self._live_worker_names()
                   if name not in self.excluded and name != without)

    def _hosts_current_txn_role(self, worker_name: str) -> bool:
        """Does the worker host a CURRENT-epoch transaction role?
        Storage shards and retained old-generation logs don't count —
        exclusion can't vacate them without data distribution."""
        wi = self.workers.get(worker_name)
        if wi is None:
            return False
        ep = self.dbinfo.get().epoch
        prefixes = (f"tlog-e{ep}-", f"proxy-e{ep}-", f"resolver-e{ep}-",
                    f"ratekeeper-e{ep}")
        return any(rn.startswith(prefixes) for rn in wi.worker.roles)

    async def _latency_probe_loop(self):
        """Measure real GRV/read/commit latency through an ordinary
        client transaction and surface it in status (ref: the latency
        probe section of clusterGetStatus, Status.actor.cpp:983 —
        operators read these, and the bands feed alerting)."""
        from ..client import Database
        db = Database(self.process, self.open_db.ref())
        probe_seen_committed = -1
        rounds = 0
        while True:
            await flow.delay(flow.SERVER_KNOBS.latency_probe_interval,
                             TaskPriority.LOW_PRIORITY)
            if self.dbinfo.get().recovery_state != FULLY_RECOVERED or \
                    self.probe_paused:
                continue
            try:
                probe_key = b"\xff\x02/status/latency_probe"
                tr = db.create_transaction()
                tr.set_option("read_system_keys")
                t0 = flow.now()
                await tr.get_read_version()
                grv_s = flow.now() - t0
                t1 = flow.now()
                await tr.get(probe_key)
                read_s = flow.now() - t1
                self._probe_bands["grv"].record(grv_s)
                self._probe_bands["read"].record(read_s)
                rounds += 1
                probe = {
                    "transaction_start_seconds": round(grv_s, 6),
                    "read_seconds": round(read_s, 6),
                    "probed_at": round(flow.now(), 3),
                    "rounds": rounds,
                }
                # the COMMIT probe only runs while the cluster is
                # seeing commits: an idle cluster must be able to go
                # fully quiet (quiet_database drains the log to zero),
                # which a 5s probe write would forever prevent
                committed = max((p.committed_version.get()
                                 for p in self._current_proxies()),
                                default=-1)
                if committed != probe_seen_committed:
                    tr2 = db.create_transaction()
                    tr2.set_option("access_system_keys")
                    tr2.set(probe_key, b"%d" % int(flow.now() * 1000))
                    t2 = flow.now()
                    probe_seen_committed = await tr2.commit()
                    self._probe_bands["commit"].record(flow.now() - t2)
                    probe["commit_seconds"] = round(flow.now() - t2, 6)
                elif "commit_seconds" in self._latency_probe:
                    probe["commit_seconds"] = \
                        self._latency_probe["commit_seconds"]
                self._latency_probe = probe
            except flow.FdbError:
                pass  # a probe racing a recovery just skips a round

    # -- the longitudinal plane (spawned only when armed) ------
    async def _timekeeper_loop(self):
        """Commit the version<->wallclock map row by row through the
        ordinary pipeline (ref: fdbserver/TimeKeeper.actor.cpp). Writes
        only while the cluster is seeing OTHER commits — the latency
        probe's quiescence pattern: the row's own commit version is
        remembered so an idle cluster can still go fully quiet."""
        from ..client import Database
        from .systemkeys import timekeeper_key
        db = Database(self.process, self.open_db.ref())
        seen_committed = -1
        while True:
            await flow.delay(flow.SERVER_KNOBS.timekeeper_interval,
                             TaskPriority.LOW_PRIORITY)
            if self.dbinfo.get().recovery_state != FULLY_RECOVERED or \
                    self.probe_paused:
                continue
            committed = max((p.committed_version.get()
                             for p in self._current_proxies()),
                            default=-1)
            if committed < 0 or committed == seen_committed:
                continue
            try:
                tr = db.create_transaction()
                tr.set_option("access_system_keys")
                tr.set(timekeeper_key(int(flow.now() * 1000)),
                       b"%d" % committed)
                seen_committed = await tr.commit()
                self._timekeeper_rows += 1
            except flow.FdbError:
                pass  # a row racing a recovery just skips a round

    async def _metric_history_loop(self):
        """Sample the status signals into the recorder each tick and
        flush full chunks into \\xff\\x02/metrics/ (schema:
        systemkeys.py; recorder: server/metric_history.py). Sampling
        always runs (the SLO engine reads the in-memory tail even
        mid-recovery); flushing needs a recovered pipeline."""
        from ..client import Database
        from .metric_history import MetricHistoryRecorder
        self.metric_recorder = rec = MetricHistoryRecorder(self)
        db = Database(self.process, self.open_db.ref())
        while True:
            await flow.delay(flow.SERVER_KNOBS.metric_history_interval,
                             TaskPriority.LOW_PRIORITY)
            rec.record(flow.now())
            if self.dbinfo.get().recovery_state != FULLY_RECOVERED or \
                    self.probe_paused:
                continue
            try:
                await rec.flush(db)
            except flow.FdbError:
                pass  # buffered samples flush on a later round

    async def _slo_loop(self):
        """Evaluate the SLO rule table over the recorder's in-memory
        tail every SLO_EVAL_INTERVAL (server/slo.py — the same pure
        math the soak's post-hoc read-back runs over the persisted
        series). Breach transitions are counted and traced; the
        verdict rides status.cluster.slo + health messages."""
        from . import slo as slo_mod
        rules = slo_mod.default_rules()
        prev_state = "ok"
        while True:
            await flow.delay(flow.SERVER_KNOBS.slo_eval_interval,
                             TaskPriority.LOW_PRIORITY)
            rec = self.metric_recorder
            if rec is None:
                continue
            verdict = slo_mod.evaluate(rules, rec.tail_series(),
                                       int(flow.now() * 1000))
            self.slo_verdict = verdict
            if verdict["state"] == "breach" and prev_state != "breach":
                self.slo_breaches += 1
                flow.cover("slo.breach")
                flow.TraceEvent("SLOBreach", self.process.name).detail(
                    Rules=",".join(verdict["breached"])).log()
            prev_state = verdict["state"]

    # -- the latency-forensics plane (spawned only armed) ------
    async def _critical_path_loop(self):
        """Fold the proxies' buffered decomposition samples into the
        decaying dominant-station table every CRITICAL_PATH_INTERVAL,
        and refresh the host process's resource sample on the same
        cadence (the status doc serves the latest without re-sampling
        per request)."""
        while True:
            await flow.delay(flow.SERVER_KNOBS.critical_path_interval,
                             TaskPriority.LOW_PRIORITY)
            now = flow.now()
            for p in self._current_proxies():
                for dom, seconds, _e2e in p.path.drain_samples():
                    self.critical_path_table.record(dom, seconds, now)
                    self._path_samples_folded += 1
            if self.host_process_metrics is not None:
                self.host_process_metrics.sample()

    def _current_ratekeeper(self):
        """The current epoch's Ratekeeper role, or None mid-recovery
        (the recorder's rk/* signals read its rate + last decision)."""
        from .ratekeeper import Ratekeeper
        ep = self.dbinfo.get().epoch
        for wi in self.workers.values():
            if not wi.worker.process.alive:
                continue
            for rn, role in wi.worker.roles.items():
                if isinstance(role, Ratekeeper) and rn.endswith(f"-e{ep}"):
                    return role
        return None

    def _health_messages(self, info) -> list:
        """Event-driven health rollup: the status document's `messages`
        array (ref: the messages JSON clusterGetStatus assembles —
        operators and alerting read these, not raw counters). Each
        entry: name, severity, human description, plus the numbers
        behind the judgment. Conditions surfaced: a resolver holding
        more conflict-history rows than its memory limit (the window GC
        is losing to the write rate), a pathological conflict fraction
        over the recent metric-sample window, and storage trailing the
        log frontier by more than a healthy MVCC window."""
        msgs: list = []
        from .resolver_role import Resolver
        ep = info.epoch
        limit = flow.SERVER_KNOBS.resolver_state_memory_limit
        for wi in self.workers.values():
            if not wi.worker.process.alive:
                continue
            for rn, role in wi.worker.roles.items():
                if isinstance(role, Resolver) and f"-e{ep}-" in rn:
                    size = role.state_size()
                    if size > limit:
                        msgs.append({
                            "name": "saturated_resolver",
                            "severity": flow.trace.SevWarnAlways,
                            "description":
                                f"Resolver {rn} holds {size} conflict-"
                                f"history rows (limit {limit})",
                            "resolver": rn, "state_rows": size,
                            "limit": limit})
                    fo = role.failover_stats()
                    if fo and not fo.get("on_primary", True):
                        msgs.append({
                            "name": "conflict_backend_degraded",
                            "severity": flow.trace.SevWarnAlways,
                            "description":
                                f"Resolver {rn} failed over to the "
                                f"{fo.get('active_backend')} backend "
                                f"({fo.get('failovers')} failovers, "
                                f"{fo.get('device_faults')} device "
                                "faults); reattach pending",
                            "resolver": rn,
                            "failovers": fo.get("failovers", 0),
                            "device_faults": fo.get("device_faults", 0)})
                    mismatches = (fo.get("shadow", {}) or {}).get(
                        "mismatches", 0) if fo else 0
                    if mismatches:
                        # the corruption-grade message: shadow verdicts
                        # diverged — serializability is suspect (ref:
                        # how check_consistency reports replica
                        # divergence)
                        msgs.append({
                            "name": "shadow_resolve_mismatch",
                            "severity": flow.trace.SevError,
                            "description":
                                f"Resolver {rn}: {mismatches} sampled "
                                "batches re-resolved on the CPU shadow "
                                "disagreed with the "
                                f"{fo.get('active_backend')} backend",
                            "resolver": rn,
                            "mismatches": mismatches})
        # conflict fraction over the sampled tail (the metric sampler is
        # the event source; status just reads the window)
        conflicted = committed = 0.0
        sampled = False
        for (rn, cn), ts in self.metrics.items():
            if not rn.startswith("proxy"):
                continue
            tail = ts.series(0)
            if len(tail) < 2:
                continue
            delta = tail[-1][1] - tail[0][1]
            if cn == "transactions_conflicted":
                conflicted += max(delta, 0)
                sampled = True
            elif cn == "transactions_committed":
                committed += max(delta, 0)
        total = conflicted + committed
        if sampled and total >= 10 and \
                conflicted / total > flow.SERVER_KNOBS.health_conflict_rate:
            msgs.append({
                "name": "high_conflict_rate",
                "severity": flow.trace.SevWarnAlways,
                "description":
                    f"{conflicted / total:.0%} of recent transactions "
                    "aborted on conflicts (see conflict_hot_spots)",
                "conflict_rate": round(conflicted / total, 4),
                "window_transactions": int(total)})
        frontier = max((t.version.get() for t in self.tlog_objs()),
                       default=0)
        lag_limit = flow.SERVER_KNOBS.health_storage_lag_versions
        behind = []
        for s in info.storages:
            for rep in s.replicas:
                obj = self._storage_objs.get(rep.name)
                if obj is None or not obj.process.alive:
                    continue
                lag = frontier - obj.version.get()
                if lag > lag_limit:
                    behind.append((rep.name, lag))
        for name, lag in behind:
            msgs.append({
                "name": "storage_behind_tlog",
                "severity": flow.trace.SevWarnAlways,
                "description":
                    f"Storage {name} trails the log frontier by "
                    f"{lag} versions",
                "storage": name, "lag_versions": lag})
        # SLO breaches: one message per tripped rule while
        # the longitudinal plane is armed and breaching — empty (and
        # free) otherwise, so the off posture's messages are unchanged
        if self.slo_verdict.get("state") == "breach":
            for r in self.slo_verdict.get("rules", ()):
                if r.get("ok"):
                    continue
                msgs.append({
                    "name": "slo_breach",
                    "severity": flow.trace.SevWarnAlways,
                    "description":
                        f"SLO rule {r['name']} breached "
                        f"(value {r.get('value')}, "
                        f"threshold {r.get('threshold')})",
                    "rule": r["name"], "value": r.get("value"),
                    "threshold": r.get("threshold")})
        return msgs

    # -- status ----------------------------------------------------------
    async def _status_loop(self):
        while True:
            _req, reply = await self.status_requests.pop()
            try:
                reply.send(self.get_status())
            except Exception:  # noqa: BLE001 — status must never wedge
                reply.send({"cluster": {"error": "status_incomplete"}})

    def get_status(self) -> dict:
        """Assemble the cluster status document (ref: clusterGetStatus,
        fdbserver/Status.actor.cpp:1802 — the JSON consumed by fdbcli
        `status` and StatusClient). Role stats are read from the
        registry; a real deployment would gather them via RPC."""
        info = self.dbinfo.get()
        cfg = self.config
        workers = {
            name: {"machine": wi.machine,
                   "zone": wi.zone,
                   "dc": wi.dc,
                   "alive": wi.worker.process.alive,
                   "roles": sorted(wi.worker.roles)}
            for name, wi in self.workers.items()}
        logs = []
        for lr in info.logs.logs:
            entry = {"store": lr.store, "machine": lr.machine}
            for wi in self.workers.values():
                obj = wi.worker.roles.get(lr.store)
                if obj is not None:
                    entry.update(
                        durable_version=obj.version.get(),
                        queue_length=len(obj.entries),
                        counters=obj.stats.snapshot(),
                        latency_bands={
                            "commit": obj.commit_bands.snapshot()})
                    if flow.SERVER_KNOBS.critical_path:
                        # queue-vs-service split: version-ordering wait
                        # vs fsync service
                        entry["path"] = obj.path.snapshot()
            logs.append(entry)
        storages = []
        for s in info.storages:
            entry = {"tag": s.tag, "begin": s.begin.hex(),
                     "end": s.end.hex() if s.end is not None else None,
                     "replicas": []}
            for rep in s.replicas:
                rentry = {"name": rep.name}
                obj = self._storage_objs.get(rep.name)
                if obj is not None:
                    rentry.update(alive=obj.process.alive,
                                  version=obj.version.get(),
                                  durable_version=obj.durable_version.get(),
                                  sampled_bytes=obj.sampled_bytes(),
                                  write_bytes_per_sec=round(
                                      obj.write_bandwidth(), 1),
                                  # read-side heat meters (zeros while
                                  # the plane is disarmed — the fields
                                  # stay so dashboards are stable)
                                  read_bytes_per_sec=round(
                                      obj.read_bandwidth(), 1),
                                  read_ops_per_sec=round(
                                      obj.read_ops_rate(), 1),
                                  counters=obj.stats.snapshot(),
                                  latency_bands={
                                      "read": obj.read_bands.snapshot()})
                entry["replicas"].append(rentry)
            storages.append(entry)
        from .proxy import Proxy
        from .ratekeeper import Ratekeeper
        from .resolver_role import Resolver
        path_armed = bool(flow.SERVER_KNOBS.critical_path)
        proxies = []
        resolvers = []
        rate = None
        rk_role = None
        proxy_roles = []
        for wi in self.workers.values():
            for rn, role in wi.worker.roles.items():
                if isinstance(role, Proxy) and f"-e{info.epoch}-" in rn:
                    proxy_roles.append(role)
                    proxies.append({
                        "name": rn,
                        "committed_version": role.committed_version.get(),
                        "counters": role.stats.snapshot(),
                        "latency_bands": {
                            "grv": role.grv_bands.snapshot(),
                            "commit": role.commit_bands.snapshot()},
                        # conflict prediction & repair decision plane
                        # (server/scheduler.py + server/repair.py):
                        # deferral and repair accounting per proxy
                        "scheduler": role.scheduler_status(),
                        "repair": role.repair_status(),
                        # enforced admission control (server/
                        # admission.py): per-class admission counters,
                        # queue bounds, and the live tag-throttle rows
                        "admission": role.admission_status()})
                    if path_armed:
                        # per-proxy critical-path decomposition
                        #: station bands, dominant counts,
                        # residual bound — the raw feed behind
                        # cluster.critical_path
                        proxies[-1]["path"] = role.path.snapshot()
                elif isinstance(role, Resolver) and \
                        f"-e{info.epoch}-" in rn:
                    kern = role.kernel_stats()
                    rsnap = role.stats.snapshot()
                    resolvers.append({
                        "name": rn,
                        "version": role.version.get(),
                        "counters": rsnap,
                        # split/merge visibility:
                        # state rows + handoff counters per resolver;
                        # owned_ranges is patched in below from a live
                        # proxy's keyResolvers map
                        "splits": {
                            "state_rows": role.state_size(),
                            "checkpoints_served":
                                rsnap.get("split_checkpoints", 0),
                            "installs": rsnap.get("range_installs", 0),
                            "last_handoff": role.last_handoff},
                        "latency_bands": {
                            "resolve": role.resolve_bands.snapshot()},
                        # decaying conflict-attribution table: which
                        # key ranges are aborting transactions HERE
                        "hot_spots": role.hot_spots.top(),
                        # device-kernel profile: pad occupancy +
                        # compile/execute accounting ({} off-device)
                        "kernel": kern,
                        # split submit/drain resolve-pipeline window:
                        # in-flight depth, forced drains, submit-vs-
                        # drain latency bands (every backend has it;
                        # reuse the snapshot the device kernel stats
                        # already embed rather than recomputing)
                        "pipeline": (kern.get("pipeline")
                                     or role.pipeline_stats()),
                        # backend fault tolerance: checkpoint cadence,
                        # device faults/failovers/replay, shadow
                        # validation ({} for bare host backends)
                        "failover": role.failover_stats()})
                    if path_armed:
                        # queue-vs-service split: version-ordering wait
                        # vs resolve service
                        resolvers[-1]["path"] = role.path.snapshot()
                elif isinstance(role, Ratekeeper) and \
                        rn.endswith(f"-e{info.epoch}"):
                    rate = role.rate
                    rk_role = role
        # per-resolver owned-range counts off a live proxy's
        # keyResolvers map (every proxy applies moves at the same
        # version, so any one is representative)
        if proxy_roles and resolvers:
            owned = proxy_roles[0].key_resolvers.owned_ranges(
                len(resolvers))
            for r in resolvers:
                try:
                    ridx = int(r["name"].rsplit("-", 1)[1])
                except (ValueError, IndexError):
                    continue
                if 0 <= ridx < len(owned):
                    r["splits"]["owned_ranges"] = owned[ridx]
        # cluster-level hot-spot view: merge every resolver's table by
        # range (keyspace-sharded resolvers each see disjoint causes)
        merged_hot: dict = {}
        for r in resolvers:
            for row in r["hot_spots"]:
                ent = merged_hot.setdefault(
                    (row["begin"], row["end"]), {"score": 0.0, "total": 0})
                ent["score"] += row["score"]
                ent["total"] += row["total"]
        hot_rows = [{"begin": b, "end": e,
                     "score": round(v["score"], 4), "total": v["total"]}
                    for (b, e), v in merged_hot.items()]
        hot_rows.sort(key=lambda r: (-r["score"], r["begin"]))
        # the QoS telemetry plane: ratekeeper decision + per-role
        # smoothed saturation signals + tag/priority traffic accounting
        # (ref: the qos section of clusterGetStatus, grown here with
        # the full measurement plane tag throttling needs)
        qos_roles: dict = {}
        for s in self.qos_samples.values():
            qos_roles.setdefault(s.kind, {})[s.name] = dict(
                s.signals, sampled_at=round(s.sampled_at, 3))
        merged_tags: dict = {}
        prio_counts: dict = {}
        for p_role in proxy_roles:
            for row in p_role.tag_counter.top():
                ent = merged_tags.setdefault(row["tag"], {
                    "busyness": 0.0, "started": 0, "committed": 0,
                    "conflicted": 0})
                ent["busyness"] += row["busyness"]
                for f in ("started", "committed", "conflicted"):
                    ent[f] += row[f]
            snap = p_role.stats.snapshot()
            for prio in ("batch", "default", "immediate"):
                ent = prio_counts.setdefault(prio, {
                    "started": 0, "committed": 0, "conflicted": 0})
                ent["started"] += snap.get(
                    f"transactions_started_{prio}", 0)
                ent["committed"] += snap.get(
                    f"transactions_committed_{prio}", 0)
                ent["conflicted"] += snap.get(
                    f"transactions_conflicted_{prio}", 0)
        tag_rows = [dict(tag=t, busyness=round(v["busyness"], 4),
                         started=v["started"], committed=v["committed"],
                         conflicted=v["conflicted"])
                    for t, v in merged_tags.items()]
        tag_rows.sort(key=lambda r: (-r["busyness"], r["tag"]))
        decision = dict(rk_role.last_decision) if rk_role is not None \
            else {}
        qos_doc = {
            "transactions_per_second_limit": rate,
            "batch_transactions_per_second_limit":
                rk_role.batch_rate if rk_role is not None else None,
            "limiting_reason": decision.get("limiting_reason", "none"),
            "inputs": decision.get("inputs", {}),
            # the hex tag behind busiest_read_tag_busyness ("" while
            # the heat plane is off or no tagged reads were seen)
            "busiest_read_tag": decision.get("busiest_read_tag", ""),
            "roles": qos_roles,
            "tags": tag_rows[
                :int(flow.SERVER_KNOBS.qos_tag_top_k)],
            "priorities": prio_counts,
        }
        from ..flow import coverage as _coverage
        cov = _coverage.report()
        probe = dict(self._latency_probe)
        if probe:
            # banded history only beside a published round: consumers
            # key on the scalar fields ("if probe: probe[...]"), so a
            # mid-round bands-only dict must not make probe truthy
            bands = {k: v.snapshot()
                     for k, v in self._probe_bands.items()
                     if v.bands.total}
            if bands:
                probe["bands"] = bands
        return {
            "cluster": {
                "epoch": info.epoch,
                "recovery_state": info.recovery_state,
                "recovery_version": info.recovery_version,
                "coordinators": len(self.coordinators),
                "workers": workers,
                "logs": logs,
                "storages": storages,
                "proxies": proxies,
                "resolvers": resolvers,
                # process-global jitted-kernel accounting (compiles,
                # compile-vs-execute time per shape bucket): reported
                # once — the compiled kernels are shared across every
                # backend instance in this process
                "kernels": _global_kernel_counters(),
                "qos": qos_doc,
                # dynamic resolver split/merge rollup: the
                # balance loop's split/merge/release/handoff counters
                # and the last split it made — skew response as a
                # status query
                "resolver_balance": self._balance_doc(),
                # conflict prediction & transaction repair rollup:
                # the armed planes, cluster totals across the proxies,
                # and the client-side conflict-window cache counters
                # (process-wide, like client_profile)
                "conflict_scheduling": self._sched_doc(proxies),
                # enforced admission control & tag throttling rollup:
                # armed knobs, per-class admission totals across the
                # proxies, the merged live throttle-row table, the
                # ratekeeper's auto-throttler counters, and the
                # client-side backoff counters (process-wide)
                "admission_control": self._admission_doc(proxies,
                                                         rk_role),
                "latency_probe": probe,
                # the longitudinal plane's rollup: SLO
                # verdict + recorder/TimeKeeper accounting while
                # METRIC_HISTORY is armed; {"enabled": 0} otherwise
                "slo": self._slo_doc(),
                # latency forensics: the decaying dominant-
                # station table + per-station splits while
                # CRITICAL_PATH is armed; {"enabled": 0} otherwise
                "critical_path": self._critical_path_doc(proxies, logs,
                                                         resolvers),
                # per-process resource telemetry: the host's sampler
                # here; OS-process workers report their own via
                # federation into cluster.processes
                "process_metrics": self._process_metrics_doc(),
                # hottest conflict-causing key ranges, cluster-wide
                # (per-resolver tables under resolvers[*].hot_spots)
                "conflict_hot_spots": hot_rows[
                    :int(flow.SERVER_KNOBS.hot_spot_top_k)],
                # the storage heat plane's rollup: decaying
                # top-K read-hot sub-ranges across the storage replicas
                # + the busiest read tag per server — the feature
                # stream throttling and data distribution consume (which shard to
                # split, which tenant to throttle)
                "storage_heat": {
                    "tracking_enabled": int(bool(
                        flow.SERVER_KNOBS.storage_heat_tracking)),
                    "ranges": self.storage_heat.top(),
                    "busiest_read_tags": [
                        {"server": n, "tag": t, "busyness": b}
                        for n, (t, b) in sorted(self._heat_tags.items())],
                },
                # event-driven health rollup (ref: the status document's
                # messages array operators alert on)
                "messages": self._health_messages(info),
                # the chaos plane's shared fault accounting: every
                # injected fault — network ops, disk corruption, kills,
                # PLUS the device-fault injector's seam totals — under
                # one schema, so "did the storm actually fire" is a
                # status query, not a trace grep (server/chaos.py)
                "chaos": _chaos_status(self.process.net),
                # TEST() coverage summary (ref: the coverage tool over
                # annotated rare paths; full dump rides the CI artifact)
                "coverage": {"declared": len(cov["declared"]),
                             "hit": len(cov["hit"]),
                             "unhit": cov["unhit"]},
                # multi-resolution counter time series (ref: TDMetric):
                # newest sample + a short fine-grained tail per metric
                "metrics": {
                    f"{rn}/{cn}": {
                        "latest": ts.latest(),
                        "tail": ts.series(0)[-5:],
                        "levels": [len(lv) for lv in ts.levels],
                        "gauge": (rn, cn) in self._metric_gauges,
                    }
                    for (rn, cn), ts in sorted(self.metrics.items())},
                # run-loop profiler (ref: Net2 slow-task sampling /
                # SystemMonitor machine metrics in status) + the
                # SIM_TASK_STATS attribution table when armed
                "run_loop": _run_loop_status(),
                # sim-network message accounting (the plane's network
                # half): per-request-type counts when armed, plus the
                # always-available population gauges and totals
                "network": self.process.net.message_stats_report(
                    top_k=int(flow.SERVER_KNOBS.sim_task_stats_top_k)),
                # sampled-transaction profiler counters (process-wide,
                # like the kernel profile: every client in this sim
                # shares the sampler's CounterCollection)
                "client_profile": _client_profile_counters(),
                "configuration": {
                    "proxies": cfg.n_proxies,
                    "resolvers": cfg.n_resolvers,
                    "logs": cfg.n_logs,
                    "storage_shards": cfg.n_storage,
                    "conflict_backend": cfg.conflict_backend,
                    "durable": cfg.durable,
                    "excluded": sorted(self.excluded),
                },
            },
        }

    def _slo_doc(self) -> dict:
        """status.cluster.slo: the engine's latest verdict + the
        recorder's and TimeKeeper's accounting."""
        enabled = int(bool(flow.SERVER_KNOBS.metric_history))
        if not enabled:
            return {"enabled": 0}
        return {
            "enabled": 1,
            "state": self.slo_verdict.get("state", "ok"),
            "breached": self.slo_verdict.get("breached", []),
            "breaches": self.slo_breaches,
            "rules": self.slo_verdict.get("rules", []),
            "recorder": (self.metric_recorder.status()
                         if self.metric_recorder is not None else {}),
            "timekeeper_rows": self._timekeeper_rows,
        }

    def _critical_path_doc(self, proxies: list, logs: list,
                           resolvers: list) -> dict:
        """status.cluster.critical_path: the decaying top-cause table
        plus a cluster-wide fold of the per-role path sections already
        assembled for this status doc (proxy station segments, and the
        resolver/tlog queue-vs-service splits)."""
        if not flow.SERVER_KNOBS.critical_path or \
                self.critical_path_table is None:
            return {"enabled": 0}
        from .critical_path import STATIONS
        samples = 0
        max_residual = 0.0
        dominant = {s: 0 for s in STATIONS}
        station_seconds = {s: 0.0 for s in STATIONS}
        for p in proxies:
            path = p.get("path") or {}
            samples += path.get("samples", 0)
            max_residual = max(max_residual,
                               path.get("max_residual_seconds", 0.0))
            for s, n in (path.get("dominant") or {}).items():
                dominant[s] = dominant.get(s, 0) + n
            for s, ent in (path.get("stations") or {}).items():
                station_seconds[s] = (station_seconds.get(s, 0.0)
                                      + ent.get("seconds", 0.0))

        def _split(entries):
            wait = {"total": 0, "sum_seconds": 0.0}
            service = {"total": 0, "sum_seconds": 0.0}
            for e in entries:
                path = e.get("path") or {}
                for kind, acc in (("wait", wait), ("service", service)):
                    snap = path.get(kind) or {}
                    acc["total"] += snap.get("total", 0)
                    acc["sum_seconds"] += snap.get("sum_seconds", 0.0)
            wait["sum_seconds"] = round(wait["sum_seconds"], 6)
            service["sum_seconds"] = round(service["sum_seconds"], 6)
            return {"wait": wait, "service": service}

        top = self.critical_path_table.top()
        return {
            "enabled": 1,
            "samples": samples,
            "samples_folded": self._path_samples_folded,
            "max_residual_seconds": round(max_residual, 9),
            "tolerance": flow.SERVER_KNOBS.critical_path_tolerance,
            "dominant": dominant,
            "dominant_now": top[0]["station"] if top else None,
            "top": top,
            "station_seconds": {s: round(v, 6)
                                for s, v in station_seconds.items()},
            # queue-vs-service from the serving side: did the time go
            # to version-ordering (upstream pressure) or to the work
            "splits": {"resolve": _split(resolvers),
                       "tlog_fsync": _split(logs)},
        }

    def _process_metrics_doc(self) -> dict:
        """status.cluster.process_metrics: the host process's latest
        resource sample (per-OS-process docs federate into
        cluster.processes, tools/exporter.py)."""
        if not flow.SERVER_KNOBS.critical_path or \
                self.host_process_metrics is None:
            return {"enabled": 0}
        return {"enabled": 1,
                "interval": flow.SERVER_KNOBS.process_metrics_interval,
                "host": dict(self.host_process_metrics.latest),
                "role_cpu_share": self._role_cpu_share()}

    def _role_cpu_share(self) -> dict:
        """Per-role CPU share inside this host process, folded from the
        SIM_TASK_STATS busy table when armed ({} otherwise) — the
        proxy-vs-resolver number a role split-out is judged against."""
        from .process_metrics import role_cpu_share
        rl = _run_loop_status()
        return role_cpu_share((rl.get("task_stats") or {}).get("tasks"))

    def _balance_doc(self) -> dict:
        """status.cluster.resolver_balance: knob posture + the balance
        loop's event counters + the last split made."""
        snap = self.balance_stats.snapshot()
        return {
            "enabled": int(bool(flow.SERVER_KNOBS.resolver_balance)),
            "splits": snap.get("splits", 0),
            "merges": snap.get("merges", 0),
            "releases": snap.get("releases", 0),
            "handoff_timeouts": snap.get("handoff_timeouts", 0),
            "last_split": self.balance_last,
        }

    @staticmethod
    def _admission_doc(proxies: list, rk_role) -> dict:
        """status.cluster.admission_control: knob posture + totals over
        the per-proxy admission sections + the merged throttle table +
        the ratekeeper auto-throttler + client backoff counters."""
        from .tag_throttler import client_throttle_counters
        k = flow.SERVER_KNOBS
        totals = {"admitted": {"immediate": 0, "default": 0, "batch": 0},
                  "queued_now": 0, "rejected": 0, "timed_out": 0,
                  "throttle_delayed": 0, "throttle_released": 0,
                  "throttle_rejected": 0, "confirm_rounds": 0}
        rows: dict = {}
        for p in proxies:
            a = p.get("admission") or {}
            for cls, n in (a.get("admitted") or {}).items():
                totals["admitted"][cls] = totals["admitted"].get(cls,
                                                                 0) + n
            totals["queued_now"] += sum((a.get("queued") or {}).values())
            for f in ("rejected", "timed_out", "throttle_delayed",
                      "throttle_released", "throttle_rejected",
                      "confirm_rounds"):
                totals[f] += a.get(f, 0)
            for r in a.get("tag_rows", ()):
                # every proxy enforces the same durable rows; keep the
                # freshest picture per tag
                if r["tag"] not in rows or \
                        r["expiry"] > rows[r["tag"]]["expiry"]:
                    rows[r["tag"]] = dict(r)
        return {
            "grv_admission_enabled": int(bool(k.grv_admission_control)),
            "tag_throttling_enabled": int(bool(k.tag_throttling)),
            "auto_tag_throttling_enabled": int(
                bool(k.auto_tag_throttling)),
            **totals,
            "throttled_tags": sorted(rows.values(),
                                     key=lambda r: r["tag"]),
            "auto_throttler": (rk_role.throttler.status()
                               if rk_role is not None else {}),
            "client": client_throttle_counters(),
        }

    @staticmethod
    def _sched_doc(proxies: list) -> dict:
        """status.cluster.conflict_scheduling: knob posture + totals
        over the per-proxy scheduler/repair sections + the client
        early-abort counters."""
        from .scheduler import client_window_counters
        k = flow.SERVER_KNOBS
        totals = {"deferrals": 0, "released": 0, "overflow": 0,
                  "deferred_now": 0, "repair_attempts": 0,
                  "repair_committed": 0, "repair_conflicted": 0,
                  "repair_fallbacks": 0}
        for p in proxies:
            s = p.get("scheduler") or {}
            r = p.get("repair") or {}
            totals["deferrals"] += s.get("deferrals", 0)
            totals["released"] += s.get("released", 0)
            totals["overflow"] += s.get("overflow", 0)
            totals["deferred_now"] += s.get("deferred_now", 0)
            totals["repair_attempts"] += r.get("attempts", 0)
            totals["repair_committed"] += r.get("committed", 0)
            totals["repair_conflicted"] += r.get("conflicted", 0)
            totals["repair_fallbacks"] += r.get("fallbacks", 0)
        return {
            "scheduling_enabled": int(bool(k.conflict_scheduling)),
            "repair_enabled": int(bool(k.txn_repair)),
            "client_windows_enabled": int(bool(k.client_conflict_windows)),
            **totals,
            "client": client_window_counters(),
        }

    # -- data distribution (ref: DataDistribution + MoveKeys) ------------
    async def _dd_loop(self):
        """Shift shard boundaries toward balanced row counts (ref:
        dataDistributionTracker splitting on size +
        dataDistributionQueue scheduling moveKeys). One move at a time;
        only when the cluster is healthy."""
        while True:
            await flow.delay(flow.SERVER_KNOBS.dd_poll_interval,
                             TaskPriority.DATA_DISTRIBUTION)
            info = self.dbinfo.get()
            if info.recovery_state != FULLY_RECOVERED or self._move_inflight:
                continue
            # exclusion-driven vacates first: data must leave excluded
            # workers before balance moves matter (ref: the exclusion
            # check in dataDistribution — removeKeysFromFailedServers /
            # teams containing excluded servers get rebuilt)
            if await self._vacate_excluded(info):
                continue
            # team health: a team missing a replica past the rebuild
            # delay gets a replacement built from a live teammate
            if await self._heal_unhealthy_teams(info):
                continue
            teams = [[self._storage_objs.get(rep.name)
                      for rep in s.replicas] for s in info.storages]
            if any(o is None or not o.process.alive or o._adding
                   for team in teams for o in team):
                continue
            objs0 = [self._storage_objs.get(s.replicas[0].name)
                     for s in info.storages]
            if (len(info.storages) > self.config.n_storage and info.proxies
                    and all(o is not None for o in objs0)):
                # post-split watch state: row counts only reflect
                # reality once the storages SETTLE — pending un-durable
                # mutations folded in and the MVCC window drained — and
                # both only advance with commits. Nudge until settled,
                # then the cluster goes fully quiet again.
                if any(o._pending or o.data._keys for o in objs0):
                    await self._nudge_commit()
            objs = [team[0] for team in teams]   # per-shard spokesman
            counts = [o.sampled_bytes() for o in objs]
            from ..flow import SERVER_KNOBS as _K
            # split a hot shard: too many sampled bytes OR sustained
            # write bandwidth past the per-shard ceiling (ref:
            # shardSplitter on getStorageMetrics bytes +
            # SHARD_MAX_BYTES_PER_KSEC bandwidth splits)
            hot = [i for i, n in enumerate(counts)
                   if (n > _K.dd_shard_split_bytes
                       or objs[i].write_bandwidth() * 1000.0
                       > _K.dd_shard_split_bytes_per_ksec)
                   # splittable only: a one-key hotspot has no interior
                   # split point — retrying would livelock DD and
                   # starve merges/balance moves
                   and objs[i].split_key_estimate() is not None]
            if hot:
                try:
                    await self._split_shard(hot[0])
                except Exception as e:  # noqa: BLE001 — DD survives
                    flow.TraceEvent(
                        "ShardSplitError", self.process.name,
                        severity=flow.trace.SevWarnAlways).detail(
                        Error=repr(e)).log()
                continue
            # merge adjacent cold shards — never below the configured
            # baseline count (ref: shardMerger; SHARD_MIN_BYTES floor)
            cold = [i for i in range(len(counts) - 1)
                    if counts[i] + counts[i + 1] < _K.dd_shard_merge_bytes]
            if cold and len(info.storages) > self.config.n_storage:
                try:
                    await self._merge_shards(cold[0])
                except Exception as e:  # noqa: BLE001 — DD survives
                    flow.TraceEvent(
                        "ShardMergeError", self.process.name,
                        severity=flow.trace.SevWarnAlways).detail(
                        Error=repr(e)).log()
                continue
            if len(info.storages) < 2:
                continue
            for i in range(len(objs) - 1):
                big, small = counts[i], counts[i + 1]
                src, direction = (i, "right") if big > small else (i + 1,
                                                                   "left")
                hi, lo = max(big, small), min(big, small)
                if hi < _K.dd_min_balance_bytes or hi <= 2 * lo:
                    continue
                split = objs[src].split_key_estimate()
                if split is None:
                    continue
                # moving [split, src.end) right, or [src.begin, split)
                # left — only when the split lands strictly inside src
                s_begin = objs[src].shard_begin
                s_end = objs[src].shard_end
                if not (split > s_begin
                        and (s_end is None or split < s_end)):
                    continue
                try:
                    await self._move_boundary(i, direction, split)
                except Exception as e:  # noqa: BLE001 — DD must survive
                    flow.TraceEvent(
                        "MoveKeysError", self.process.name,
                        severity=flow.trace.SevWarnAlways).detail(
                        Error=repr(e)).log()
                break

    def _worker_of_role(self, role_name: str):
        for name, wi in self.workers.items():
            if role_name in wi.worker.roles:
                return name, wi
        return None, None

    async def _heal_unhealthy_teams(self, info) -> bool:
        """Team-health tracking (ref: DDTeamCollection,
        DataDistribution.actor.cpp:539 — teams are continuously
        monitored; a team below its replication target is rebuilt).
        A dead replica is given DD_TEAM_REBUILD_DELAY to come back (the
        auto-reboot path); past that, a fresh replica is built from a
        live teammate with the same fetchKeys machinery exclusion
        vacates use. Returns True when a rebuild ran this tick."""
        now = flow.now()
        healthy_tags = set()
        acted = False
        frontier = max((t.version.get() for t in self.tlog_objs()),
                       default=0)
        for si, shard in enumerate(info.storages):
            dead = []
            for rep in shard.replicas:
                obj = self._storage_objs.get(rep.name)
                if obj is None or not obj.process.alive:
                    # reset the stuck clock: time spent DEAD must not
                    # count as "no progress", or a rebooted replica
                    # gets rebuilt as stuck before it can catch up
                    self._replica_progress.pop(rep.name, None)
                    dead.append(rep.name)
                    continue
                # STUCK detection: alive, far behind the frontier, and
                # making no progress — e.g. it recovered at a version
                # whose covering log generation retired while it was
                # down; only a rebuild can bring it back
                v = obj.version.get()
                last_v, since = self._replica_progress.get(
                    rep.name, (None, now))
                if v != last_v:
                    self._replica_progress[rep.name] = (v, now)
                elif (frontier - v >
                        flow.SERVER_KNOBS.dd_replica_stuck_versions
                        and now - since >
                        flow.SERVER_KNOBS.dd_team_rebuild_delay):
                    flow.cover("dd.replica_stuck")
                    dead.append(rep.name)
            if not dead:
                healthy_tags.add(shard.tag)
                continue
            live = [rep for rep in shard.replicas
                    if rep.name not in dead]
            if not live:
                # total team loss: only a disk-recovering reboot can
                # bring the data back — nothing to copy from. Keep the
                # grace FRESH: when replicas start reappearing, the
                # remaining dead ones get a full grace window again
                # (a stale timer would rebuild over a reboot in flight)
                self._team_unhealthy_since[shard.tag] = now
                continue
            first = self._team_unhealthy_since.setdefault(shard.tag, now)
            if now - first < flow.SERVER_KNOBS.dd_team_rebuild_delay:
                continue
            flow.cover("dd.team_rebuild")
            flow.TraceEvent("TeamUnhealthyRebuild",
                            self.process.name).detail(
                Tag=shard.tag, Dead=dead[0],
                DegradedSeconds=round(now - first, 1)).log()
            try:
                await self._replace_replica(si, dead[0])
                self._team_unhealthy_since.pop(shard.tag, None)
                acted = True
            except Exception as e:  # noqa: BLE001 — DD survives
                flow.TraceEvent(
                    "TeamRebuildError", self.process.name,
                    severity=flow.trace.SevWarnAlways).detail(
                    Tag=shard.tag, Error=repr(e)).log()
                # re-arm the grace so a stuck rebuild (e.g. no eligible
                # destination yet) retries without a hot loop
                self._team_unhealthy_since[shard.tag] = \
                    now - flow.SERVER_KNOBS.dd_team_rebuild_delay / 2
            break   # one rebuild attempt per tick
        # stale timers: healed teams AND tags retired by merges
        live_tags = {s.tag for s in info.storages}
        for tag in list(self._team_unhealthy_since):
            if tag in healthy_tags or tag not in live_tags:
                del self._team_unhealthy_since[tag]
        current = {rep.name for s in info.storages for rep in s.replicas}
        for n in [n for n in self._replica_progress if n not in current]:
            del self._replica_progress[n]
        return acted

    async def _vacate_excluded(self, info) -> bool:
        """Move one storage replica off an excluded worker (ref:
        exclusion handling in DataDistribution — a team containing an
        excluded server is unhealthy; its data is re-replicated onto an
        included server, then the old server is removed). Returns True
        when a vacate ran (or was attempted) this tick."""
        if flow.now() < self._vacate_retry_at:
            return False
        for si, shard in enumerate(info.storages):
            for rep in shard.replicas:
                wname, _wi = self._worker_of_role(rep.name)
                if wname is not None and wname in self.excluded:
                    try:
                        await self._replace_replica(si, rep.name)
                        return True
                    except Exception as e:  # noqa: BLE001 — DD survives
                        flow.TraceEvent(
                            "VacateExcludedError", self.process.name,
                            severity=flow.trace.SevWarnAlways).detail(
                            Replica=rep.name, Error=repr(e)).log()
                        # back off a stuck vacate (e.g. no eligible
                        # destination) so balance moves aren't starved
                        # by a 2s retry storm
                        self._vacate_retry_at = flow.now() + 30.0
                        return False
        return False

    async def _replace_replica(self, shard_idx: int, old_name: str) -> None:
        """Re-home one replica of a shard onto an included worker: the
        whole-shard fetchKeys — recruit (buffering from the log), add
        the newcomer to every TLog's expected set so its records are
        pinned, snapshot from a live teammate, install, publish the
        swapped team, retire the old role (ref: MoveKeys.actor.cpp
        startMoveKeys/finishMoveKeys over a full server team change)."""
        info = self.dbinfo.get()
        shard = info.storages[shard_idx]
        epoch0 = info.epoch
        team_workers = {self._worker_of_role(rep.name)[0]
                        for rep in shard.replicas}
        # destination: included, live, not already hosting this shard;
        # the replacement must leave a team the replication policy
        # validates (ref: DDTeamCollection rebuilding through the
        # configured storagePolicy, DataDistribution.actor.cpp:539) —
        # candidates producing a policy-violating team are skipped
        cands = [wi for name, wi in self.workers.items()
                 if wi.worker.process.alive and name not in self.excluded
                 and name not in team_workers]
        if not cands:
            raise error("no_more_servers")
        pol, strict = self.storage_policy(len(shard.replicas))
        keep_locs = [self._locality_of(self.workers[w])
                     for rep in shard.replicas if rep.name != old_name
                     for w in [self._worker_of_role(rep.name)[0]]
                     if w in self.workers]
        fits = []
        if len(keep_locs) == len(shard.replicas) - 1:
            fits = [wi for wi in cands
                    if pol.validate(keep_locs + [self._locality_of(wi)])]
            if not fits and strict:
                raise error("no_more_servers")
        # teammates unresolvable (e.g. their workers rebooted with
        # empty role sets) or no policy-fitting candidate: degrade
        # like recruitment does — prefer at least a fresh zone over a
        # doubled-up one, never wedge the heal
        if not fits:
            team_zones = {self.workers[w].zone
                          for w in team_workers if w in self.workers}
            fits = [wi for wi in cands
                    if wi.zone not in team_zones] or cands
        dst_wi = fits[self._rr % len(fits)]
        self._rr += 1
        # source: a LIVE teammate (the excluded server may itself be the
        # only live copy — exclusion is not death)
        src = None
        for rep in shard.replicas:
            obj = self._storage_objs.get(rep.name)
            if obj is not None and obj.process.alive and \
                    rep.name != old_name:
                src = obj
                break
        if src is None:
            src = self._storage_objs.get(old_name)
        if src is None or not src.process.alive:
            raise error("no_more_servers")
        self._move_inflight = True
        self._vacate_seq += 1
        new_name = f"storage-{shard.tag}-v{self._vacate_seq}"
        try:
            # pin the tag's records for the newcomer BEFORE it exists:
            # teammates' pops must not free records it will still need
            for t in self.tlog_objs():
                exp = dict(t.expected_replicas)
                exp[shard.tag] = tuple(exp.get(shard.tag, ())) + (new_name,)
                t.set_expected_replicas(exp)
            refs = dst_wi.worker.recruit_storage(
                new_name, shard.tag, shard.begin, shard.end)
            new_obj = dst_wi.worker.roles[new_name]
            # same-turn: nothing can have been applied yet — buffer all
            # in-range mutations until the snapshot lands
            new_obj.begin_adding(shard.begin, shard.end)
            flow.TraceEvent("VacateReplicaStart", self.process.name).detail(
                Old=old_name, New=new_name, Worker=dst_wi.name).log()
            # the newcomer's engine must finish recovering before a
            # durable install can land on it
            await flow.timeout_error(
                new_obj.recovered,
                flow.SERVER_KNOBS.storage_recruit_recovery_timeout)
            v_s = min(src.known_committed, src.version.get())
            rows = src.snapshot_range(shard.begin, shard.end, v_s)
            if self.dbinfo.get().epoch != epoch0:
                raise error("operation_failed")
            await new_obj.install_snapshot(rows, v_s)
            if self.dbinfo.get().epoch != epoch0:
                raise error("operation_failed")
            # publish the swapped team — the commit point
            info2 = self.dbinfo.get()
            shards = list(info2.storages)
            shards[shard_idx] = shard._replace(replicas=tuple(
                refs if rep.name == old_name else rep
                for rep in shards[shard_idx].replicas))
            self._storage_objs[new_name] = new_obj
            self.shard_map[new_name] = (shard.tag, shard.begin, shard.end)
            self.shard_map.pop(old_name, None)
            self.publish(info2._replace(storages=tuple(shards)))
            # release the old replica's pin; keep the newcomer's
            for t in self.tlog_objs():
                exp = dict(t.expected_replicas)
                exp[shard.tag] = tuple(
                    n for n in exp.get(shard.tag, ()) if n != old_name)
                t.set_expected_replicas(exp)
            old_wname, old_wi = self._worker_of_role(old_name)
            self._storage_objs.pop(old_name, None)
            if old_wi is not None:
                old_wi.worker.retire_storage(old_name)
            flow.TraceEvent("VacateReplicaFinish", self.process.name).detail(
                Old=old_name, New=new_name).log()
        except BaseException:
            # roll back the newcomer: drop ITS pin (prior successful
            # vacates' replicas keep theirs) and its half-built role
            for t in self.tlog_objs():
                exp = dict(t.expected_replicas)
                exp[shard.tag] = tuple(
                    n for n in exp.get(shard.tag, ()) if n != new_name)
                t.set_expected_replicas(exp)
            if new_name not in self.shard_map:
                wname, wi = self._worker_of_role(new_name)
                if wi is not None:
                    wi.worker.retire_storage(new_name)
            raise
        finally:
            self._move_inflight = False

    async def _split_shard(self, shard_idx: int) -> None:
        """Split a hot shard: mint a fresh tag, recruit a policy-spread
        team for the upper half, dual-tag it through the transition,
        snapshot + buffered-replay onto the newcomers, publish the
        extra shard (ref: dataDistributionTracker shardSplitter →
        executing moveKeys to a new team; the keyServers map gains a
        boundary)."""
        info = self.dbinfo.get()
        shard = info.storages[shard_idx]
        epoch0 = info.epoch
        src_team = [self._storage_objs.get(rep.name)
                    for rep in shard.replicas]
        if any(o is None or not o.process.alive for o in src_team):
            raise error("operation_failed")
        src = src_team[0]
        split = src.split_key_estimate()
        if split is None or not (shard.begin < split and (
                shard.end is None or split < shard.end)):
            raise error("operation_failed")
        # tags are NEVER reused within a CC lifetime: a merged-away
        # tag's force-pops (1<<60) persist on the epoch's tlogs and
        # would instantly free a re-minted tag's records
        self._max_tag_ever = max(self._max_tag_ever,
                                 max(s.tag for s in info.storages))
        self._max_tag_ever += 1
        new_tag = self._max_tag_ever
        nrep = max(1, self.config.storage_replicas)
        pol, strict = self.storage_policy(nrep)
        team = self.pick_workers(nrep, role="storage", policy=pol,
                                 strict=strict)
        # names follow the team actually built — a mismatched policy
        # must never pin phantom replica names into the tlogs
        names = [f"storage-{new_tag}-r{j}" for j in range(len(team))]
        proxies = self._current_proxies()
        if not proxies:
            raise error("operation_failed")
        self._move_inflight = True
        flow.TraceEvent("ShardSplitStart", self.process.name).detail(
            Tag=shard.tag, NewTag=new_tag, Split=split.hex()).log()
        new_refs = []
        dual_tagged = False
        published = False
        try:
            # pin the fresh tag before any record can exist for it
            for t in self.tlog_objs():
                exp = dict(t.expected_replicas)
                exp[new_tag] = tuple(names)
                t.set_expected_replicas(exp)
            new_objs = []
            for j, w in enumerate(team):
                refs = w.recruit_storage(names[j], new_tag, split,
                                         shard.end)
                obj = w.roles[names[j]]
                obj.begin_adding(split, shard.end)  # same-turn: no gap
                new_refs.append(refs)
                new_objs.append(obj)
            for p in proxies:
                p.start_move(split, shard.end, new_tag)
            dual_tagged = True
            for o in new_objs:
                await flow.timeout_error(
                    o.recovered,
                    flow.SERVER_KNOBS.storage_recruit_recovery_timeout)
            v_s = await self._wait_replication_horizon(src, epoch0, proxies)
            rows = src.snapshot_range(split, shard.end, v_s)
            if self.dbinfo.get().epoch != epoch0:
                raise error("operation_failed")
            for o in new_objs:
                await o.install_snapshot(rows, v_s)
            if self.dbinfo.get().epoch != epoch0:
                raise error("operation_failed")
            # publish: the commit point
            info2 = self.dbinfo.get()
            shards = list(info2.storages)
            left = shard._replace(end=split, replicas=tuple(
                rep._replace(end=split) for rep in shard.replicas))
            right = StorageShard(new_tag, split, shard.end, tuple(
                r._replace(begin=split, end=shard.end) for r in new_refs))
            shards[shard_idx] = left
            shards.insert(shard_idx + 1, right)
            for rep in left.replicas:
                self.shard_map[rep.name] = (left.tag, left.begin, left.end)
            for j, rep in enumerate(right.replicas):
                self.shard_map[rep.name] = (new_tag, split, shard.end)
                self._storage_objs[rep.name] = new_objs[j]
            self.publish(info2._replace(storages=tuple(shards)))
            published = True   # the commit point: only roll forward
            for p in self._current_proxies():
                p.finish_move(split, shard.end, new_tag,
                              [s.begin for s in shards[1:]],
                              [s.tag for s in shards])
            for sobj in src_team:
                try:
                    await sobj.shrink_to(sobj.shard_begin, split)
                except flow.FdbError:
                    pass  # a dead replica is clamped on re-register
            flow.TraceEvent("ShardSplitFinish", self.process.name).detail(
                NewTag=new_tag).log()
        except BaseException:
            if not published:
                if dual_tagged:
                    for p in self._current_proxies():
                        p.finish_move(split, shard.end, new_tag,
                                      [s.begin for s in info.storages[1:]],
                                      [s.tag for s in info.storages])
                for t in self.tlog_objs():
                    exp = dict(t.expected_replicas)
                    exp.pop(new_tag, None)
                    t.set_expected_replicas(exp)
                    # commits dual-tagged during the aborted split would
                    # otherwise pin log records for the rest of the epoch
                    t.pop(1 << 60, new_tag, "split-aborted")
                for j, w in enumerate(team[:len(new_refs)]):
                    w.retire_storage(names[j])
                    self._storage_objs.pop(names[j], None)
            raise
        finally:
            self._move_inflight = False

    async def _merge_shards(self, left_idx: int) -> None:
        """Fold shard left_idx+1 into left_idx: the left team absorbs
        the right range (dual-tagged through the transition), the right
        team and its tag retire (ref: dataDistributionTracker
        shardMerger — adjacent cold shards collapse to one)."""
        info = self.dbinfo.get()
        left, right = info.storages[left_idx], info.storages[left_idx + 1]
        epoch0 = info.epoch
        l_team = [self._storage_objs.get(rep.name) for rep in left.replicas]
        r_team = [self._storage_objs.get(rep.name) for rep in right.replicas]
        if any(o is None or not o.process.alive for o in l_team + r_team):
            raise error("operation_failed")
        src = r_team[0]
        proxies = self._current_proxies()
        if not proxies:
            raise error("operation_failed")
        self._move_inflight = True
        flow.TraceEvent("ShardMergeStart", self.process.name).detail(
            Left=left.tag, Right=right.tag).log()
        published = False
        l_old_bounds = [(o.shard_begin, o.shard_end) for o in l_team]
        try:
            for o in l_team:
                o.begin_adding(right.begin, right.end)
            for p in proxies:
                p.start_move(right.begin, right.end, left.tag)
            v_s = await self._wait_replication_horizon(src, epoch0, proxies)
            rows = src.snapshot_range(right.begin, right.end, v_s)
            if self.dbinfo.get().epoch != epoch0:
                raise error("operation_failed")
            for o in l_team:
                await o.install_snapshot(rows, v_s)
            if self.dbinfo.get().epoch != epoch0:
                raise error("operation_failed")
            # publish the collapsed map
            info2 = self.dbinfo.get()
            shards = list(info2.storages)
            merged = left._replace(end=right.end, replicas=tuple(
                rep._replace(end=right.end) for rep in left.replicas))
            shards[left_idx] = merged
            del shards[left_idx + 1]
            for rep in merged.replicas:
                self.shard_map[rep.name] = (merged.tag, merged.begin,
                                            merged.end)
            for rep in right.replicas:
                self.shard_map.pop(rep.name, None)
            self.publish(info2._replace(storages=tuple(shards)))
            published = True
            for p in self._current_proxies():
                p.finish_move(right.begin, right.end, left.tag,
                              [s.begin for s in shards[1:]],
                              [s.tag for s in shards])
            # retire the right team; its tag's residual records are
            # covered by the left tag's copies, so pop them fully or
            # the log would pin them forever
            for rep in right.replicas:
                wname, wi = self._worker_of_role(rep.name)
                self._storage_objs.pop(rep.name, None)
                if wi is not None:
                    wi.worker.retire_storage(rep.name)
            for t in self.tlog_objs():
                exp = dict(t.expected_replicas)
                expected = exp.pop(right.tag, ())
                t.set_expected_replicas(exp)
                for name in expected:
                    t.pop(1 << 60, right.tag, name)
            flow.TraceEvent("ShardMergeFinish", self.process.name).detail(
                Tag=merged.tag).log()
        except BaseException:
            if not published:
                for o, old in zip(l_team, l_old_bounds):
                    o.abort_adding()
                    if (o.shard_begin, o.shard_end) != old:
                        # a durable install already extended the claim:
                        # retract it (floor + rows stay, unreachable)
                        await flow.catch_errors(flow.spawn(
                            o.set_bounds(*old)))
                for p in self._current_proxies():
                    p.finish_move(right.begin, right.end, left.tag,
                                  [s.begin for s in info.storages[1:]],
                                  [s.tag for s in info.storages])
            raise
        finally:
            self._move_inflight = False

    async def _nudge_commit(self) -> None:
        """Push one empty commit through — idle clusters advance
        known_committed (and thus durability) only with fresh commits
        (ref: the recovery txn idiom)."""
        from .types import CommitRequest
        info = self.dbinfo.get()
        if info.proxies:
            await flow.catch_errors(flow.timeout_error(
                info.proxies[0].commits.get_reply(
                    CommitRequest(0, (), (), ()), self.process), 1.0))

    async def _wait_replication_horizon(self, src, epoch0: int,
                                        proxies) -> int:
        """Safe snapshot version for a move source: at least v0 — the
        master's issued max, covering batches whose tags were computed
        BEFORE a dual-tag landed — and known replicated on the whole
        log set, so an epoch rollback can never rewind below it and a
        durable install can't capture a phantom timeline. `proxies` is
        the caller's already-validated non-empty list (re-fetching here
        could observe an epoch transition's empty window)."""
        v0 = max(p.committed_version.get() for p in proxies)
        if self._recovery is not None and \
                self._recovery.master is not None:
            v0 = max(v0, self._recovery.master.version)
        deadline = flow.now() + 30.0
        while src.known_committed < v0 or src.version.get() < v0:
            if flow.now() > deadline:
                raise error("timed_out")
            if self.dbinfo.get().epoch != epoch0:
                raise error("operation_failed")
            await self._nudge_commit()
            await flow.delay(flow.SERVER_KNOBS.dd_move_nudge_interval,
                             TaskPriority.DATA_DISTRIBUTION)
        return min(src.known_committed, src.version.get())

    async def _move_boundary(self, left_idx: int, direction: str,
                             split: bytes) -> None:
        """Move the boundary between adjacent shards left_idx and
        left_idx+1 to `split` (ref: moveKeys start/finish + fetchKeys).
        Sequence: destination buffers; proxies dual-tag; destination
        backfills a snapshot the source serves at its own version;
        ownership flips durably on the destination, is published, and
        only then do proxies drop the dual tag and the source shrink."""
        info = self.dbinfo.get()
        storages = info.storages
        if direction == "right":
            src_i, dst_i = left_idx, left_idx + 1
            r_begin, r_end = split, storages[dst_i].begin
        else:
            src_i, dst_i = left_idx + 1, left_idx
            r_begin, r_end = storages[src_i].begin, split
        src_team = [self._storage_objs[rep.name]
                    for rep in storages[src_i].replicas]
        dst_team = [self._storage_objs[rep.name]
                    for rep in storages[dst_i].replicas]
        src = src_team[0]
        dst = dst_team[0]
        dst_old_bounds = (dst.shard_begin, dst.shard_end)
        proxies = self._current_proxies()
        if not proxies:
            return
        epoch0 = info.epoch
        self._move_inflight = True
        flow.TraceEvent("MoveKeysStart", self.process.name).detail(
            Begin=r_begin.hex(), End=r_end.hex(),
            Src=storages[src_i].replicas[0].name,
            Dst=storages[dst_i].replicas[0].name).log()
        published = False
        try:
            for d in dst_team:
                d.begin_adding(r_begin, r_end)
            for p in proxies:
                p.start_move(r_begin, r_end, dst.tag)
            v_s = await self._wait_replication_horizon(src, epoch0, proxies)
            rows = src.snapshot_range(r_begin, r_end, v_s)
            if self.dbinfo.get().epoch != epoch0:
                raise error("operation_failed")   # abort pre-install
            for d in dst_team:
                await d.install_snapshot(rows, v_s)
            if self.dbinfo.get().epoch != epoch0:
                raise error("operation_failed")   # abort pre-publish
            # publish: THE commit point — from here the move only rolls
            # forward (a revert after publish would diverge routing from
            # the advertised map)
            new_storages = []
            for j, s in enumerate(storages):
                if j == dst_i:
                    ns = (s._replace(begin=split) if direction == "right"
                          else s._replace(end=split))
                elif j == src_i:
                    ns = (s._replace(end=split) if direction == "right"
                          else s._replace(begin=split))
                else:
                    ns = s
                ns = ns._replace(replicas=tuple(
                    rep._replace(begin=ns.begin, end=ns.end)
                    for rep in ns.replicas))
                new_storages.append(ns)
            for s in new_storages:
                for rep in s.replicas:
                    self.shard_map[rep.name] = (s.tag, s.begin, s.end)
            self.publish(self.dbinfo.get()._replace(
                storages=tuple(new_storages)))
            published = True
            for p in self._current_proxies():
                p.finish_move(r_begin, r_end, dst.tag,
                              [s.begin for s in new_storages[1:]],
                              [s.tag for s in new_storages])
            for sobj in src_team:
                try:
                    if direction == "right":
                        await sobj.shrink_to(sobj.shard_begin, split)
                    else:
                        await sobj.shrink_to(split, sobj.shard_end)
                except flow.FdbError:
                    pass  # a dead replica is clamped on re-register
            flow.TraceEvent("MoveKeysFinish", self.process.name).detail(
                Split=split.hex()).log()
        except BaseException:
            if not published:
                for d in dst_team:
                    d.abort_adding()
                    if (d.shard_begin, d.shard_end) != dst_old_bounds:
                        # a durable install already extended the claim:
                        # retract it (floor + fetched rows stay, unreachable)
                        await flow.catch_errors(flow.spawn(
                            d.set_bounds(*dst_old_bounds)))
                for p in self._current_proxies():
                    p.finish_move(r_begin, r_end, dst.tag,
                                  [s.begin for s in storages[1:]],
                                  [s.tag for s in storages])
            raise
        finally:
            self._move_inflight = False

    def _current_proxies(self):
        from .proxy import Proxy
        ep = self.dbinfo.get().epoch
        out = []
        for wi in self.workers.values():
            if not wi.worker.process.alive:
                continue
            for rn, role in wi.worker.roles.items():
                if isinstance(role, Proxy) and f"-e{ep}-" in rn:
                    out.append(role)
        return out

    # -- client handshake -----------------------------------------------
    async def _open_db_loop(self):
        while True:
            req, reply = await self.open_db.pop()
            flow.spawn(self._serve_open_db(req, reply),
                       TaskPriority.CLUSTER_CONTROLLER)

    async def _serve_open_db(self, req: OpenDatabaseRequest, reply):
        while True:
            info = self.dbinfo.get()
            if info.seq > req.known_seq and \
                    info.recovery_state == FULLY_RECOVERED and info.storages:
                reply.send(_client_safe_info(info))
                return
            await self.dbinfo.on_change()


def _client_safe_info(info):
    """The CLIENT-facing dbinfo reply rides the sim's wire round trip
    (the serialization oracle). With externally-hosted tlogs
    (tools/rolehost.py) the log refs are RetryingTcpRefs — process-
    local handles with no wire encoding, and nothing a client could
    use anyway (clients reach tlogs only THROUGH proxies). Blank them
    here; with in-process logs this returns `info` itself untouched,
    so the default posture stays byte-identical."""

    def is_ext(lr):
        return lr.commits is not None and \
            type(lr.commits).__name__ != "NetworkRef"

    def strip(ls):
        if not any(is_ext(lr) for lr in ls.logs):
            return ls
        return ls._replace(logs=tuple(
            lr._replace(commits=None, peeks=None, pops=None, locks=None)
            if is_ext(lr) else lr for lr in ls.logs))

    logs = strip(info.logs)
    old_logs = tuple(strip(ls) for ls in info.old_logs)
    if logs is info.logs and all(
            a is b for a, b in zip(old_logs, info.old_logs)):
        return info
    return info._replace(logs=logs, old_logs=old_logs)

from ..rpc import wire as _wire

_wire.register_module(__name__)  # all NamedTuples here are RPC vocabulary
