"""The cluster chaos plane: named, seeded, replayable scenario storms.

Reference: fdbrpc/sim2.actor.cpp (swizzling, link clogging, machine
reboots, connection failures) and the simulation workload stacking in
fdbserver/workloads/ (MachineAttrition, RandomClogging, DiskFailure) —
the part of the reference's robustness story the device-fault seams
did not cover: tearing the WHOLE CLUSTER apart mid-commit and requiring
it to heal.

Three layers live here:

- **Station hooks**: the commit-debug stations in the proxy/tlog double
  as chaos kill points. `arm_station(location, fn)` installs a one-shot
  callback fired synchronously when the pipeline reaches that station,
  so a scenario can kill a role at an EXACT commit station (GRV handed
  out, commit version assigned, resolve answered, fsync pending, log
  push acked) instead of "roughly around a commit".
- **Format-aware corruption helpers**: `corrupt_record_payload` flips
  payload bytes of a committed DiskQueue record (header + CRC intact
  chain ⇒ DETECTED at recovery as checksum_failed ⇒ recoverable role
  death); `corrupt_value_bytes` flips bytes AND fixes the record CRC —
  corruption the disk format cannot see, which exists precisely so
  tests can prove check_consistency catches it.
- **Scenarios**: named `ChaosScenario`s (`SCENARIOS`) that a
  `ChaosStorm` workload (server/workloads.py) applies mid-flight under
  open-loop traffic, then heals and verifies. Every random choice draws
  from the seeded sim RNG and every injected fault lands in the
  network's `chaos_log`, so one seed replays one identical storm — the
  determinism tests pin `chaos_log` + the post-quiesce consistency
  digest across runs.

`chaos_status(net)` is the shared accounting schema
(status.cluster.chaos): network/disk/kill counters merged with the
device-fault injector's seam totals (ops/fault_injection.py), so
"did the storm actually fire, and what did it inject" is a status
query per fault kind — no trace grepping.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from .. import flow

# -- station hooks -------------------------------------------------------

#: location -> list of one-shot callbacks (process-global, like the
#: knobs; SimCluster clears it when a new simulation starts)
_stations: Dict[str, List[Callable[[str], None]]] = {}

#: commit-pipeline stations a scenario can arm (the proxy/tlog fire
#: these via fire_station on every batch)
COMMIT_STATIONS = (
    "MasterProxyServer.GRV.AfterReply",
    "MasterProxyServer.commitBatch.Before",
    "MasterProxyServer.commitBatch.GotCommitVersion",
    "MasterProxyServer.commitBatch.AfterResolution",
    "TLog.tLogCommit.AfterWaitForVersion",
    "TLog.tLogCommit.AfterTLogCommit",
    "MasterProxyServer.commitBatch.AfterLogPush",
)


def arm_station(location: str, fn: Callable[[str], None]) -> None:
    """Install a ONE-SHOT callback at a commit-pipeline station; it
    fires synchronously inside the role actor that reaches the station
    (so a kill lands at exactly that point of the batch)."""
    _stations.setdefault(location, []).append(fn)


def clear_stations() -> None:
    _stations.clear()


def fire_station(location: str) -> None:
    """Called by the pipeline roles at their stations. Free while
    nothing is armed (one dict check on an empty dict)."""
    if not _stations:
        return
    hooks = _stations.get(location)
    if not hooks:
        return
    fn = hooks.pop(0)
    if not hooks:
        del _stations[location]
    fn(location)


# -- shared chaos accounting schema --------------------------------------

def chaos_status(net) -> dict:
    """The status.cluster.chaos document: one schema over every fault
    source — network ops, kills, disk corruption (SimNetwork
    chaos_counters) AND the device-fault injector's per-seam totals."""
    from ..ops.fault_injection import g_device_faults
    injected = dict(getattr(net, "chaos_counters", ()) or {})
    for point, n in g_device_faults.injected.items():
        if n:
            injected[f"device_{point}"] = n
    return {
        "injected": injected,
        "events": (len(getattr(net, "chaos_log", ()))
                   + getattr(net, "chaos_log_dropped", 0)),
        "messages_dropped": getattr(net, "messages_dropped", 0),
        "messages_duplicated": getattr(net, "messages_duplicated", 0),
        "scenarios": dict(getattr(net, "chaos_scenarios", ()) or {}),
    }


def record_scenario(net, name: str) -> None:
    net.chaos_scenarios[name] = net.chaos_scenarios.get(name, 0) + 1
    net.chaos_note("scenario", name=name)


# -- format-aware disk corruption ----------------------------------------

def _parse_dq_records(raw):
    """Committed records of a DiskQueue file image, via the ONE shared
    format walker (diskqueue.walk_records — the corruption helpers and
    recovery's scan must never disagree on what a record is):
    [(seq, payload_off, length, record_off)] — the walker's materialized
    payload is dropped here; the helpers only patch bytes in place."""
    from .diskqueue import walk_records
    return [(seq, poff, length, off)
            for seq, _payload, poff, length, off in walk_records(raw)[0]]


def corrupt_record_payload(simfile, rng) -> bool:
    """DETECTABLE corruption: flip payload bytes of a committed record
    that has a valid successor (header + CRC chain left intact), so the
    next recovery's checksum scan reports checksum_failed instead of
    quietly shortening the log. Returns False if the file holds fewer
    than two committed records (nothing to confirm the hole against)."""
    recs = _parse_dq_records(simfile._durable)
    recs = [r for r in recs[:-1] if r[2] > 0]   # need a valid successor
    if not recs:
        return False
    _seq, poff, length, _off = recs[rng.random_int(0, len(recs))]
    flip = poff + rng.random_int(0, length)
    simfile._durable[flip] ^= rng.random_int(1, 256)
    if simfile.disk.net is not None:
        simfile.disk.net.chaos_note(
            "disk_corruption", file=simfile.name,
            machine=simfile.disk.machine, bytes=1, detectable=True)
    return True


def corrupt_value_bytes(simfile, pattern: bytes, rng) -> bool:
    """UNDETECTABLE corruption: flip a byte inside `pattern` wherever it
    occurs in a committed record's payload, then RECOMPUTE that
    record's CRC — bit rot the storage format cannot see. The only net
    left to catch it is check_consistency's replica comparison, which
    is exactly what the corruption tests prove."""
    import struct
    import zlib
    from .diskqueue import _REC_HDR
    raw = simfile._durable
    hit = bytes(raw).find(pattern)
    if hit < 0:
        return False
    for _seq, poff, length, off in _parse_dq_records(raw):
        if poff <= hit and hit + len(pattern) <= poff + length:
            flip = hit + rng.random_int(0, len(pattern))
            raw[flip] ^= rng.random_int(1, 256)
            # the crc is _REC_HDR's trailing u32 ("<QII")
            struct.pack_into(
                "<I", raw, off + _REC_HDR.size - 4,
                zlib.crc32(bytes(raw[poff:poff + length])))
            if simfile.disk.net is not None:
                simfile.disk.net.chaos_note(
                    "disk_corruption_undetected", file=simfile.name,
                    machine=simfile.disk.machine, bytes=1)
            return True
    return False


# -- scenario helpers ----------------------------------------------------

def worker_machines(cluster) -> list:
    return sorted({w.process.machine for w in cluster.workers.values()})


async def wait_fully_recovered(cluster, timeout: float = 60.0) -> bool:
    from .dbinfo import FULLY_RECOVERED
    deadline = flow.now() + timeout
    while flow.now() < deadline:
        if cluster.cc.dbinfo.get().recovery_state == FULLY_RECOVERED:
            return True
        await flow.delay(0.25)
    return False


async def database_digest(db, page_rows: int = 500) -> str:
    """SHA-256 over the full user keyspace read through the client
    surface — the "identical final state" half of the seed-replay
    determinism contract."""
    import hashlib
    from ..client.transaction import run_transaction
    h = hashlib.sha256()
    cursor = b""
    while True:
        async def page(tr, cursor=cursor):
            return await tr.get_range(cursor, b"\xff", limit=page_rows)
        rows = await run_transaction(db, page, max_retries=500)
        for k, v in rows:
            h.update(b"%d:%b=%d:%b;" % (len(k), k, len(v), v))
        if len(rows) < page_rows:
            return h.hexdigest()
        cursor = rows[-1][0] + b"\x00"


def _role_stores(cluster, prefix: str) -> list:
    """Live (machine, store_name) pairs for durable role stores whose
    name starts with `prefix`."""
    out = []
    for w in cluster.workers.values():
        if not w.process.alive:
            continue
        disk = cluster.net.disks.get(w.process.machine)
        if disk is None:
            continue
        for fname in sorted(disk.files):
            if fname.startswith(prefix) and fname.endswith(".dq0"):
                out.append((w.process.machine, fname))
    return out


async def _kill_role_safely(cluster, kind: str) -> Optional[str]:
    try:
        return cluster.kill_role(kind)
    except KeyError:
        return None


# -- scenarios -----------------------------------------------------------

class ChaosScenario:
    """One named, seeded chaos recipe. `cluster_kwargs` are the
    SimCluster arguments the scenario needs (the harness builds the
    cluster from them); `run` applies the faults, HEALS, and returns a
    report dict. A scenario that moves the surviving database (region
    failover) returns the client to verify under "check_db"."""

    name = "?"
    cluster_kwargs: dict = {"durable": True, "n_workers": 6,
                            "n_logs": 2, "n_storage": 2}

    async def run(self, cluster, rng) -> dict:
        raise NotImplementedError


class PartitionMinority(ChaosScenario):
    """Isolate a strict minority of worker machines from EVERYTHING
    (majority workers, CC, coordinators, clients) for
    CHAOS_PARTITION_SECONDS, then heal. Ping-based failure detection
    sees the minority as down; the unreachability watchdog ends the
    epoch if a critical role was inside; the majority recovers and
    keeps committing; after the heal the minority rejoins and catches
    up (ref: sim2's connection-failure partitions)."""

    name = "partition_minority"

    async def run(self, cluster, rng) -> dict:
        machines = worker_machines(cluster)
        pick = list(machines)
        rng.random_shuffle(pick)
        minority = sorted(pick[:max(1, (len(machines) - 1) // 2)])
        seconds = float(flow.SERVER_KNOBS.chaos_partition_seconds)
        pid = cluster.net.partition(minority)
        await flow.delay(seconds)
        cluster.net.heal(pid)
        await wait_fully_recovered(cluster)
        return {"partitioned": minority, "seconds": seconds}


class SwizzleLinks(ChaosScenario):
    """Swizzled-clogging storm (ref: the swizzle dance in sim2): open
    reorder/duplicate windows on random links while one-sided send/recv
    clogs with staggered expiries churn the rest of the mesh. Pure
    message-schedule hostility — nothing dies, so the oracle is that
    NOTHING needed to: same consistency, same liveness."""

    name = "swizzle_links"

    async def run(self, cluster, rng) -> dict:
        machines = worker_machines(cluster) + [cluster.cc.process.machine]
        window = float(flow.SERVER_KNOBS.chaos_swizzle_seconds)
        rounds = int(flow.SERVER_KNOBS.chaos_kill_rounds)
        swizzled = clogged = 0
        for _ in range(rounds):
            a = rng.random_choice(machines)
            b = rng.random_choice(machines)
            if a != b:
                cluster.net.swizzle(a, b, window)
                swizzled += 1
            # the clog dance: a seeded subset clogs with staggered
            # durations, so the unclog order differs from the clog order
            dance = list(machines)
            rng.random_shuffle(dance)
            for m in dance[:len(machines) // 2]:
                if rng.coinflip():
                    cluster.net.clog_send(m, rng.random01() * window)
                else:
                    cluster.net.clog_recv(m, rng.random01() * window)
                clogged += 1
            await flow.delay(window * (0.5 + rng.random01()))
        await flow.delay(window)   # let the last windows expire
        return {"swizzles": swizzled, "clogs": clogged}


class KillMidCommit(ChaosScenario):
    """Kill the role under a commit batch at an EXACT pipeline station
    (GRV handed out / commit version assigned / resolve answered /
    tlog fsync pending / log push acked) via the station hooks, once
    per round, letting recovery land between rounds. The atomicity
    oracle: every client observes commit-or-abort, never a partial
    write — enforced by the storm's check_consistency plus the
    directed marker-exactness tests."""

    name = "kill_mid_commit"

    #: (station, victim role kind) — which role dying at that station
    #: hurts the most
    STATION_VICTIMS = (
        ("MasterProxyServer.GRV.AfterReply", "proxy"),
        ("MasterProxyServer.commitBatch.GotCommitVersion", "proxy"),
        ("MasterProxyServer.commitBatch.AfterResolution", "resolver"),
        ("TLog.tLogCommit.AfterWaitForVersion", "tlog"),
        ("MasterProxyServer.commitBatch.AfterLogPush", "storage"),
    )

    async def run(self, cluster, rng) -> dict:
        kills = []
        for _ in range(int(flow.SERVER_KNOBS.chaos_kill_rounds)):
            station, kind = self.STATION_VICTIMS[
                rng.random_int(0, len(self.STATION_VICTIMS))]
            done = flow.Promise()

            def on_station(loc, kind=kind, done=done):
                victim = None
                try:
                    victim = cluster.kill_role(kind)
                except KeyError:
                    pass
                if not done.is_set:
                    done.send(victim)

            arm_station(station, on_station)
            got = await flow.catch_errors(
                flow.timeout_error(done.future, 15.0))
            victim = got.get() if not got.is_error else None
            kills.append((station, kind, victim))
            await wait_fully_recovered(cluster)
            await flow.delay(0.5 + rng.random01())
        clear_stations()   # an unfired arm must not leak past the storm
        return {"kills": kills}


class MachinePowerLoss(ChaosScenario):
    """Whole-machine power loss with co-located workers: every process
    on the machine dies at once, unsynced writes independently survive,
    are dropped, or TEAR (SIM_TORN_WRITE_PROB); auto-reboot brings the
    workers back onto the same disks and recovery must reassemble the
    cluster from whatever the CRC scan salvages (ref: killMachine +
    AsyncFileNonDurable)."""

    name = "machine_power_loss"
    cluster_kwargs = {"durable": True, "n_workers": 8,
                      "workers_per_machine": 2, "n_zones": 4,
                      "n_logs": 2, "n_storage": 2}

    async def run(self, cluster, rng) -> dict:
        lost = []
        for _ in range(2):
            machines = worker_machines(cluster)
            m = rng.random_choice(machines)
            lost.append((m, cluster.kill_machine(m)))
            await flow.delay(flow.SERVER_KNOBS.sim_reboot_delay + 1.0)
            await wait_fully_recovered(cluster)
        return {"lost": lost}


class DiskCorruptionRecovery(ChaosScenario):
    """Seeded sector corruption into committed DiskQueue records of a
    live tlog store AND a storage replica store, then power-fail the
    machines. Recovery's checksum scan detects the damage
    (checksum_failed), the worker drops the store — a recoverable role
    death — and replication heals: the log generation recovers from its
    peer, DD rebuilds the replica. check_consistency is the final
    oracle that nothing silently regressed."""

    name = "disk_corruption_recovery"
    cluster_kwargs = {"durable": True, "n_workers": 7, "n_logs": 2,
                      "n_storage": 2, "storage_replicas": 2}

    async def run(self, cluster, rng) -> dict:
        corrupted = []
        for prefix in ("tlog-", "storage-"):
            stores = _role_stores(cluster, prefix)
            if not stores:
                continue
            machine, fname = stores[rng.random_int(0, len(stores))]
            disk = cluster.net.disks[machine]
            f = disk.files.get(fname)
            alt = disk.files.get(fname[:-1] + "1")   # the .dq1 twin
            target = max((x for x in (f, alt) if x is not None),
                         key=lambda x: len(_parse_dq_records(x._durable)),
                         default=None)
            if target is None or not corrupt_record_payload(target, rng):
                continue
            corrupted.append((machine, target.name))
            cluster.kill_machine(machine)
            await flow.delay(flow.SERVER_KNOBS.sim_reboot_delay + 1.0)
        await wait_fully_recovered(cluster)
        return {"corrupted": corrupted}


class CoordinatorLossRecoveryStorm(ChaosScenario):
    """Kill a strict minority of the coordinators (the quorum
    survives), then force repeated master recoveries by killing a
    commit-pipeline role per round — the recovery state machine churns
    while coordination runs degraded (ref: the coordinators quorum
    contract + masterProcessFailure restart storms)."""

    name = "coordinator_loss_recovery_storm"
    cluster_kwargs = {"durable": True, "n_workers": 6, "n_logs": 2,
                      "n_storage": 2, "n_coordinators": 3}

    async def run(self, cluster, rng) -> dict:
        # a strict minority of coordinators dies (quorum lives)
        n_lose = (len(cluster.coordinators) - 1) // 2
        victims = list(range(len(cluster.coordinators)))
        rng.random_shuffle(victims)
        for i in victims[:n_lose]:
            cluster.net.kill(cluster.coordinators[i].process)
        kinds = ("tlog", "proxy", "resolver")
        killed = []
        for r in range(int(flow.SERVER_KNOBS.chaos_kill_rounds)):
            killed.append(await _kill_role_safely(cluster, kinds[r % 3]))
            await wait_fully_recovered(cluster)
            await flow.delay(0.5 + rng.random01() * 0.5)
        return {"coordinators_lost": n_lose, "killed": killed}


class RegionFailover(ChaosScenario):
    """Attach an async remote region (a recovery), replicate the storm
    through the log router, then BLACK OUT the primary — workers, CC,
    and a coordinator MINORITY (the surviving majority models the
    fearless layouts that place a coordinator quorum outside the
    primary DC; without one, promotion is impossible by design) — and
    promote the region through the coordinated recovery path
    (server/region.py). The verified database is the promoted one
    ("check_db"); losing the advertised replication lag is the
    async-region contract, losing anything else is a bug."""

    name = "region_failover"
    cluster_kwargs = {"durable": True, "auto_reboot": False,
                      "n_workers": 6, "n_storage": 2,
                      "n_coordinators": 5}

    async def run(self, cluster, rng) -> dict:
        from .region import RemoteRegion
        region = RemoteRegion(cluster)
        await region.start()
        # let the storm's traffic flow through the router, then give
        # the shipped frontier a bounded settle window (the lag never
        # reaches 0 while the version clock advances — the leftover IS
        # what the blackout is allowed to lose)
        await flow.delay(1.5)
        for _ in range(20):
            if region.lag() <= 0:
                break
            await flow.delay(0.25)
        lag_at_blackout = region.lag()
        for w in list(cluster.workers.values()):
            if w.process.alive:
                cluster.net.kill(w.process)
        cluster.net.kill(cluster.cc.process)
        # a coordinator MINORITY dies with the primary; the quorum
        # survives outside it (drawn seeded so replay kills the same set)
        coords = list(range(len(cluster.coordinators)))
        rng.random_shuffle(coords)
        for i in coords[:(len(coords) - 1) // 2]:
            if cluster.coordinators[i].process.alive:
                cluster.net.kill(cluster.coordinators[i].process)
        cluster.net.chaos_note("region_blackout",
                               lag_versions=lag_at_blackout)
        promoted = await region.promote()
        return {"check_db": promoted.client("chaos-region-check"),
                "promoted_epoch": promoted.cc.dbinfo.get().epoch,
                "lag_at_blackout": lag_at_blackout}


SCENARIOS: Dict[str, type] = {
    s.name: s for s in (
        PartitionMinority, SwizzleLinks, KillMidCommit, MachinePowerLoss,
        DiskCorruptionRecovery, CoordinatorLossRecoveryStorm,
        RegionFailover)
}


def get_scenario(name: str) -> ChaosScenario:
    try:
        return SCENARIOS[name]()
    except KeyError:
        raise ValueError(
            f"unknown chaos scenario {name!r}; "
            f"known: {sorted(SCENARIOS)}") from None
