"""The reference's chaos cases (tests/test_chaos_storms.py) on the port's
SimCluster, its two exporter cases among them (the device-fault one on
`cuda` at device="cpu"), and the port's chaos stations and format-aware
corruption helpers (`server.chaos`) without a cluster.

Sim2-grade cluster chaos: scenario storms with deterministic seed
replay (server/chaos.py).

What is pinned here, in order:

- **The storm matrix**: every named scenario (partition / swizzle /
  kill-mid-commit / machine power loss / disk corruption / coordinator
  loss / region failover) runs green under open-loop traffic, heals,
  quiesces inside the recovery bound, and passes `check_consistency` +
  shadow-validation cleanliness — AND replaying the same seed
  reproduces an identical chaos event schedule and an identical
  post-quiesce keyspace digest. Determinism is asserted, not assumed.
- **Kill-mid-commit atomicity**: a role death armed at each exact
  commit-pipeline station leaves every multi-key transaction
  commit-or-abort — never a partial write (ref: the recovery
  version's all-or-nothing contract over a commit's mutation set).
- **The corruption oracles**: DETECTED corruption (bad payload, intact
  CRC chain) surfaces as a recoverable role death; UNDETECTED
  corruption (payload rotted with the CRC recomputed) is caught by
  `check_consistency`'s replica sweep; torn writes at power loss
  recover through the CRC cut.
- **Triage ergonomics**: `quiet_database` timeouts diagnose which
  roles/counters never quiesced; the failure hook in conftest.py makes
  any red sim test replayable via `--seed`.
- **The shared chaos schema**: network/disk/kill injections AND the
  device-fault seams roll into one `status.cluster.chaos` document
  and one `fdbtpu_chaos_*` exporter family.
"""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.client import run_transaction  # noqa: E402
from foundationdb_tpu_torch.rpc import SimNetwork  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402
from foundationdb_tpu_torch.server.chaos import (  # noqa: E402
    COMMIT_STATIONS,
    SCENARIOS,
    KillMidCommit,
    arm_station,
    clear_stations,
    corrupt_record_payload,
    corrupt_value_bytes,
    fire_station,
    get_scenario,
    wait_fully_recovered,
)
from foundationdb_tpu_torch.server.consistency import (  # noqa: E402
    ConsistencyError,
    check_consistency,
)
from foundationdb_tpu_torch.server.workloads import ChaosStorm  # noqa: E402
from foundationdb_tpu_torch.ops.fault_injection import (  # noqa: E402
    g_device_faults,
)

#: per-scenario default seeds for the matrix (any seed must pass — the
#: nightly grid sweeps others; these are the deterministic tier-1 picks,
#: overridable with --seed for replay)
SCENARIO_SEEDS = {
    "partition_minority": 101,
    "swizzle_links": 102,
    "kill_mid_commit": 103,
    "machine_power_loss": 104,
    "disk_corruption_recovery": 105,
    "coordinator_loss_recovery_storm": 106,
    "region_failover": 107,
}


def run_storm(scenario: str, seed: int) -> dict:
    """One full ChaosStorm run in a fresh simulation (the repro unit
    the conftest failure hook points at)."""
    kwargs = dict(SCENARIOS[scenario].cluster_kwargs)
    c = SimCluster(seed=seed, **kwargs)
    try:
        dbs = [c.client(f"chaos{i}") for i in range(3)]
        storm = ChaosStorm(c, dbs, flow.g_random, scenario)
        return c.run(storm.run(), timeout_time=900)
    finally:
        c.shutdown()


# -- the storm matrix + seed replay --------------------------------------

@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_storm_matrix_replays_identically(scenario, sim_seed):
    seed = sim_seed(SCENARIO_SEEDS[scenario])
    first = run_storm(scenario, seed)

    # the storm went green: traffic flowed, the scenario fired, the
    # cluster healed inside the bound, and the oracle swept real rows
    assert first["storm"]["issued"] > 0, first["storm"]
    assert first["storm"]["completed"] > 0, first["storm"]
    assert first["chaos"]["scenarios"].get(scenario) == 1, first["chaos"]
    assert first["chaos"]["injected"].get("scenario") == 1, first["chaos"]
    assert len(first["events"]) >= 2, first["events"]
    assert first["consistency"]["shards"] > 0, first["consistency"]
    assert first["consistency"]["rows"] > 0, first["consistency"]
    assert first["recovery_seconds"] <= \
        flow.SERVER_KNOBS.chaos_recovery_bound

    # seed replay: identical fault schedule (kind, sim-time, detail —
    # the whole event log) and identical final keyspace digest
    second = run_storm(scenario, seed)
    assert second["events"] == first["events"], (
        scenario, seed, first["events"], second["events"])
    assert second["digest"] == first["digest"], (scenario, seed)


def test_unknown_scenario_rejected():
    with pytest.raises(ValueError, match="unknown chaos scenario"):
        get_scenario("does_not_exist")


# -- kill-mid-commit atomicity -------------------------------------------

@pytest.mark.parametrize("station,kind", KillMidCommit.STATION_VICTIMS)
def test_kill_mid_commit_atomicity(station, kind, sim_seed):
    """A role death at an exact commit station leaves the multi-key
    transaction all-or-nothing: committed => every key present; an
    abort => none; only an UNKNOWN commit outcome may legitimately go
    either way (but still never partially)."""
    seed = sim_seed(500 + list(KillMidCommit.STATION_VICTIMS).index(
        (station, kind)))
    c = SimCluster(seed=seed, durable=True, n_workers=6, n_logs=2,
                   n_storage=2, storage_replicas=2)
    # keys straddling the shard boundary (n_storage=2 splits at 0x80):
    # a partial write would leave the shards visibly disagreeing
    keys = (b"atomic/a", b"atomic/b", b"\xc0atomic/c")
    try:
        db = c.client("atomic")

        async def main():
            async def baseline(tr):
                tr.set(b"baseline", b"1")
            await run_transaction(db, baseline)

            armed = {}

            def on_station(_loc):
                try:
                    armed["victim"] = c.kill_role(kind)
                except KeyError:
                    armed["victim"] = None
            # armed AFTER boot so recruitment-time pipeline traffic
            # cannot trip it before the transaction under test
            arm_station(station, on_station)

            tr = db.create_transaction()
            phase, err = "grv", None
            try:
                await tr.get_read_version()
                phase = "commit"
                for k in keys:
                    tr.set(k, b"present")
                await tr.commit()
                phase = "committed"
            except flow.FdbError as e:
                err = e.name
            clear_stations()
            await wait_fully_recovered(c)

            async def read_all(tr2):
                return [await tr2.get(k) for k in keys]
            vals = await run_transaction(db, read_all, max_retries=300)
            present = [v is not None for v in vals]
            if phase == "committed":
                assert all(present), (station, kind, vals, armed)
            elif phase == "grv" or err == "not_committed":
                # the commit never reached the pipeline / was rejected
                assert not any(present), (station, kind, err, vals, armed)
            else:
                # an unknown outcome may land either way — but never
                # partially (the recovery version takes the whole
                # mutation set or none of it)
                assert all(present) or not any(present), (
                    station, kind, err, vals, armed)
            await check_consistency(c)
            return phase, err

        c.run(main(), timeout_time=600)
    finally:
        clear_stations()
        c.shutdown()


# -- corruption oracles --------------------------------------------------

def _committed_rows(c, db, n=30, prefix=b"c"):
    async def main():
        for i in range(n):
            async def w(tr, i=i):
                tr.set(prefix + b"%02d" % i, b"v%02d" % i)
            await run_transaction(db, w)
        await c.quiet_database()
    c.run(main(), timeout_time=300)


def test_detected_corruption_is_recoverable_role_death(sim_seed):
    """Payload bytes rotted under an intact CRC chain: the recovery
    scan raises checksum_failed, the worker drops the store (a counted,
    recoverable role death) and replication heals — the data survives
    on the peer replica and check_consistency stays clean."""
    c = SimCluster(seed=sim_seed(600), durable=True, n_workers=7,
                   n_logs=2, n_storage=2, storage_replicas=2)
    try:
        db = c.client("corr")
        _committed_rows(c, db)

        async def main():
            corrupted_machine = None
            for w in c.workers.values():
                disk = c.net.disks.get(w.process.machine)
                if disk is None:
                    continue
                for fname in sorted(disk.files):
                    if not fname.startswith("storage-"):
                        continue
                    f = disk.files[fname]
                    if corrupt_record_payload(f, flow.g_random):
                        corrupted_machine = w.process.machine
                        break
                if corrupted_machine:
                    break
            assert corrupted_machine, "no corruptible storage record"
            assert c.net.chaos_counters.get("disk_corruption"), \
                c.net.chaos_counters

            before = c.net.chaos_counters.get("corrupt_store_lost", 0)
            c.kill_machine(corrupted_machine)
            for _ in range(400):
                if c.net.chaos_counters.get(
                        "corrupt_store_lost", 0) > before:
                    break
                await flow.delay(0.25)
            assert c.net.chaos_counters.get(
                "corrupt_store_lost", 0) > before, c.net.chaos_counters
            await wait_fully_recovered(c)

            async def r(tr):
                return await tr.get(b"c00")
            assert await run_transaction(db, r, max_retries=300) == b"v00"
            await check_consistency(c)

        c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


def test_undetected_corruption_caught_by_check_consistency(sim_seed):
    """Bit rot the disk format cannot see (payload flipped AND the
    record CRC recomputed): nothing dies, recovery succeeds — and the
    replica sweep is the net that catches it."""
    marker = b"UNDETECTABLE-ROT-MARKER"
    c = SimCluster(seed=sim_seed(601), durable=True, n_workers=7,
                   n_logs=2, n_storage=2, storage_replicas=2)
    try:
        db = c.client("rot")

        async def seed_marker(tr):
            tr.set(b"rot/target", marker)
        c.run(run_transaction(db, seed_marker), timeout_time=60)
        _committed_rows(c, db, n=10, prefix=b"rot/fill")

        async def main():
            rotted_machine = None
            for w in c.workers.values():
                disk = c.net.disks.get(w.process.machine)
                if disk is None:
                    continue
                for fname in sorted(disk.files):
                    if not fname.startswith("storage-"):
                        continue
                    if corrupt_value_bytes(disk.files[fname], marker,
                                           flow.g_random):
                        rotted_machine = w.process.machine
                        break
                if rotted_machine:
                    break
            assert rotted_machine, "marker not found in any durable store"
            # power-cycle so the storage server re-reads the rotted
            # bytes (a live server serves from memory)
            c.kill_machine(rotted_machine)
            await flow.delay(flow.SERVER_KNOBS.sim_reboot_delay + 1.0)
            await wait_fully_recovered(c)
            with pytest.raises(ConsistencyError):
                await check_consistency(c)

        c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


def test_torn_write_recovers_through_crc_cut():
    """With SIM_TORN_WRITE_PROB=1 the write in flight at power loss is
    TORN — only a prefix of it lands. Recovery's checksum scan cuts the
    torn tail (tail damage, NOT mid-log corruption: no checksum_failed,
    no store drop) and every synced record survives."""
    from foundationdb_tpu_torch.flow import coverage
    from foundationdb_tpu_torch.server.diskqueue import DiskQueue
    flow.set_seed(9)
    s = flow.Scheduler(virtual=True)
    flow.set_scheduler(s)
    saved = {n: getattr(flow.SERVER_KNOBS, n) for n in
             ("sim_torn_write_prob", "sim_power_loss_drop_prob")}
    flow.SERVER_KNOBS.set("sim_torn_write_prob", 1.0)
    flow.SERVER_KNOBS.set("sim_power_loss_drop_prob", 0.0)
    try:
        net = SimNetwork(s, flow.g_random)
        disk = net.disk("m")
        before_torn = coverage.hits("disk.torn_write")

        async def main():
            dq = DiskQueue(disk, "torn")
            await dq.recover()
            synced = [b"rec%02d" % i * 8 for i in range(5)]
            for payload in synced:
                await dq.push(payload)
            await dq.commit()
            await dq.push(b"UNSYNCED-IN-FLIGHT" * 16)
            disk.power_loss(flow.g_random)
            assert coverage.hits("disk.torn_write") > before_torn
            assert net.chaos_counters.get("torn_write") == 1
            dq2 = DiskQueue(disk, "torn")
            recovered = await dq2.recover()
            # the torn record is gone, every synced one survives, and
            # nothing was (mis)classified as mid-log corruption
            assert recovered == synced, recovered
            return True

        task = s.spawn(main())
        assert s.run(until=task, timeout_time=60)
    finally:
        for n, v in saved.items():
            flow.SERVER_KNOBS.set(n, v)
        flow.set_scheduler(None)


def test_raw_sector_rot_never_silently_regresses(sim_seed):
    """`SimDisk.corrupt_file` flips CHAOS_CORRUPT_BYTES seeded bytes
    with no format awareness: a payload hit is detected at recovery
    (store drop), a header hit is CRC-cut like a torn tail and healed
    from replication. Either way the cluster must end consistent with
    the committed data intact — raw rot may cost a store, never a
    row."""
    c = SimCluster(seed=sim_seed(607), durable=True, n_workers=7,
                   n_logs=2, n_storage=2, storage_replicas=2)
    try:
        db = c.client("rawrot")
        _committed_rows(c, db)

        async def main():
            machine, fname = next(
                (w.process.machine, f)
                for w in c.workers.values()
                for f in sorted(c.net.disks.get(w.process.machine,
                                                _EMPTY_DISK).files)
                if f.startswith("storage-") and f.endswith(".dq0"))
            flips = c.net.disks[machine].corrupt_file(fname, flow.g_random)
            assert flips, "no durable bytes to rot"
            assert c.net.chaos_counters.get("disk_corruption"), \
                c.net.chaos_counters
            c.kill_machine(machine)
            await flow.delay(flow.SERVER_KNOBS.sim_reboot_delay + 1.0)
            await wait_fully_recovered(c)

            async def r(tr):
                return await tr.get(b"c00")
            assert await run_transaction(db, r, max_retries=300) == b"v00"
            await check_consistency(c)

        c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


class _EMPTY_DISK:
    files = ()


# -- triage ergonomics ---------------------------------------------------

def test_quiet_database_timeout_diagnoses_stuck_roles(sim_seed):
    """A quiesce that cannot finish says WHY: the error names the dead
    replica / undrained counters instead of a bare timed_out."""
    c = SimCluster(seed=sim_seed(603), durable=True, auto_reboot=False,
                   n_workers=6, n_logs=2, n_storage=2,
                   storage_replicas=2)
    try:
        db = c.client("diag")

        async def main():
            async def w(tr):
                tr.set(b"k", b"v")
            await run_transaction(db, w)
            c.kill_role("storage")
            with pytest.raises(flow.FdbError) as ei:
                await c.quiet_database(max_wait=4.0)
            assert ei.value.name == "timed_out"
            msg = str(ei.value)
            assert "quiet_database timed out" in msg, msg
            # the diagnosis names what was stuck, not just that it was
            assert "storage" in msg or "tlog" in msg or \
                "recovery_state" in msg, msg

        c.run(main(), timeout_time=300)
    finally:
        c.shutdown()


def test_sim_seed_is_recorded_for_replay_hook(sim_seed):
    """The conftest failure hook prints cluster.last_sim_seed — pin
    that every SimCluster records it."""
    from foundationdb_tpu_torch.server import cluster as cluster_mod
    c = SimCluster(seed=sim_seed(604))
    try:
        assert cluster_mod.last_sim_seed == sim_seed(604)
    finally:
        c.shutdown()


# -- chaos primitives, directed ------------------------------------------

def test_partition_unreachability_ends_epoch_and_heals(sim_seed):
    """A partitioned (alive!) tlog machine must end the epoch through
    the CC's unreachability watchdog — the reference's failure
    detection is network-based — and rejoin after heal."""
    c = SimCluster(seed=sim_seed(605), durable=True, n_workers=6,
                   n_logs=2, n_storage=2)
    try:
        db = c.client("part")

        async def main():
            from foundationdb_tpu_torch.flow import coverage
            from foundationdb_tpu_torch.server.dbinfo import FULLY_RECOVERED

            async def w(tr):
                tr.set(b"k", b"v")
            await run_transaction(db, w)
            e0 = c.cc.dbinfo.get().epoch
            machine = next(wi.process.machine
                           for wi in c.workers.values()
                           for r in wi.roles if r.startswith("tlog-e"))
            pid = c.net.partition([machine])
            for _ in range(240):
                info = c.cc.dbinfo.get()
                if info.epoch > e0 and \
                        info.recovery_state == FULLY_RECOVERED:
                    break
                await flow.delay(0.25)
            info = c.cc.dbinfo.get()
            assert info.epoch > e0, "partition never ended the epoch"
            assert coverage.hits("cc.epoch_unreachable") > 0
            # the partitioned processes never died — only unreachable
            assert all(p.alive for p in c.net.processes.values()
                       if p.machine == machine)
            c.net.heal(pid)
            await c.quiet_database()
            await check_consistency(c, quiesce=False)

        c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


def _raw_net():
    s = flow.Scheduler(virtual=True)
    flow.set_scheduler(s)
    return s, SimNetwork(s, flow.g_random)


def test_clog_send_delays_inflight_reply():
    """A send clog installed AFTER the request went out still delays
    the answer: reply latency is drawn at reply time."""
    from foundationdb_tpu_torch.rpc import RequestStream
    from foundationdb_tpu_torch.server.types import MutationRef, SET_VALUE
    flow.set_seed(7)
    s, net = _raw_net()
    try:
        server = net.new_process("server", machine="ms")
        client = net.new_process("client", machine="mc")
        stream = RequestStream(server)

        async def serve():
            req, reply = await stream.pop()
            # the request is already here; clog the RESPONDER's sends
            # before answering — the in-flight reply must honor it
            net.clog_send("ms", 5.0)
            reply.send(req)

        async def main():
            t = flow.spawn(serve())
            t0 = s.now()
            await stream.ref().get_reply(
                MutationRef(SET_VALUE, b"k", b"v"), client)
            await t
            return s.now() - t0

        task = s.spawn(main())
        elapsed = s.run(until=task, timeout_time=60)
        assert elapsed >= 5.0, elapsed
        assert net.chaos_counters.get("clog_send") == 1
    finally:
        flow.set_scheduler(None)


def test_swizzle_duplicates_oneway_datagrams():
    """Inside a swizzle window one-way datagrams may deliver twice,
    each copy drawing its own scrambled latency."""
    from foundationdb_tpu_torch.rpc import RequestStream
    from foundationdb_tpu_torch.server.types import MutationRef, SET_VALUE
    flow.set_seed(8)
    s, net = _raw_net()
    flow.SERVER_KNOBS.set("chaos_swizzle_dup_prob", 1.0)
    try:
        server = net.new_process("server", machine="ms")
        client = net.new_process("client", machine="mc")
        stream = RequestStream(server)
        net.swizzle("mc", "ms", 30.0)

        async def main():
            stream.ref().send(MutationRef(SET_VALUE, b"k", b"v"), client)
            got = []
            for _ in range(2):
                req, _reply = await stream.pop()
                got.append(req)
            return got

        task = s.spawn(main())
        got = s.run(until=task, timeout_time=60)
        assert len(got) == 2 and got[0] == got[1]
        assert net.messages_duplicated == 1
        assert net.chaos_counters.get("swizzle") == 1
    finally:
        flow.SERVER_KNOBS.set("chaos_swizzle_dup_prob", 0.25)
        flow.set_scheduler(None)


# -- the shared chaos schema ---------------------------------------------

def test_device_faults_share_chaos_schema(sim_seed):
    """The device-fault injector and the scenario storms report
    through ONE status/exporter schema: a seam fault shows up as
    `device_<point>` beside the network/disk kinds."""
    from foundationdb_tpu_torch.tools.exporter import (parse_prometheus,
                                                       render_prometheus)
    c = SimCluster(seed=sim_seed(606), durable=True,
                   conflict_backend="cuda", device="cpu", n_workers=5)
    try:
        db = c.client("dev")
        before = dict(g_device_faults.injected)

        async def main():
            g_device_faults.schedule("submit")
            for i in range(3):
                async def w(tr, i=i):
                    tr.set(b"d%d" % i, b"v")
                await run_transaction(db, w)
            return await db.get_status()

        status = c.run(main(), timeout_time=300)
        assert g_device_faults.injected["submit"] > before.get(
            "submit", 0), g_device_faults.injected
        chaos = status["cluster"]["chaos"]
        assert chaos["injected"].get("device_submit", 0) >= \
            g_device_faults.injected["submit"], chaos

        samples = parse_prometheus(render_prometheus(status))
        kinds = {l["kind"]: v for n, l, v in samples
                 if n == "fdbtpu_chaos_injected"}
        assert kinds.get("device_submit", 0) >= 1, kinds
    finally:
        c.shutdown()


def test_storm_chaos_counters_reach_status_and_exporter(sim_seed):
    """After a storm, status.cluster.chaos and the fdbtpu_chaos_*
    exporter family answer 'did it actually fire' without trace greps,
    and the cli renders a chaos section."""
    from foundationdb_tpu_torch.tools.cli import Cli
    from foundationdb_tpu_torch.tools.exporter import (parse_prometheus,
                                                       render_prometheus)
    seed = sim_seed(SCENARIO_SEEDS["partition_minority"])
    kwargs = dict(SCENARIOS["partition_minority"].cluster_kwargs)
    c = SimCluster(seed=seed, **kwargs)
    try:
        cli = Cli.for_cluster(c)
        dbs = [c.client(f"chaos{i}") for i in range(3)]
        storm = ChaosStorm(c, dbs, flow.g_random, "partition_minority")

        async def main():
            rep = await storm.run()
            status = await dbs[0].get_status()
            return rep, status

        rep, status = c.run(main(), timeout_time=900)
        chaos = status["cluster"]["chaos"]
        assert chaos["scenarios"].get("partition_minority") == 1, chaos
        assert chaos["injected"].get("partition") == 1, chaos
        assert chaos["injected"].get("heal") == 1, chaos
        assert chaos["messages_dropped"] > 0, chaos
        assert chaos["events"] >= len(rep["events"]), chaos

        samples = parse_prometheus(render_prometheus(status))
        names = {n for n, _l, _v in samples}
        for need in ("fdbtpu_chaos_injected", "fdbtpu_chaos_scenario_runs",
                     "fdbtpu_chaos_events",
                     "fdbtpu_chaos_messages_dropped"):
            assert need in names, f"exporter missing {need}"
        runs = {l["scenario"]: v for n, l, v in samples
                if n == "fdbtpu_chaos_scenario_runs"}
        assert runs.get("partition_minority") == 1, runs

        details = cli.execute("status details")
        assert "Chaos (injected faults):" in details, details
        assert "scenario partition_minority" in details, details
    finally:
        c.shutdown()



# -- the port's stations and corruption helpers, without a cluster ----

def test_stations_fire_once_in_arming_order():
    """An armed station fires its callbacks one a pass, first armed
    first, and is free again once they are spent."""
    clear_stations()
    seen = []
    at = COMMIT_STATIONS[4]
    try:
        arm_station(at, lambda loc: seen.append(("a", loc)))
        arm_station(at, lambda loc: seen.append(("b", loc)))
        fire_station(COMMIT_STATIONS[0])
        assert seen == []
        for _ in range(3):
            fire_station(at)
        assert seen == [("a", at), ("b", at)]
    finally:
        clear_stations()


@pytest.mark.parametrize("undetected", [False, True])
def test_corruption_helpers_against_recovery(undetected):
    """A payload flip with the CRC chain intact fails recovery with
    checksum_failed; a flip whose CRC is recomputed recovers, with the
    marker's record changed and every other record intact."""
    from foundationdb_tpu_torch.server.diskqueue import DiskQueue
    flow.set_seed(13)
    s, net = _raw_net()
    try:
        disk = net.disk("m")
        records = [b"rec%02d-" % i + b"payload" * 4 for i in range(6)]
        records[3] = b"rec03-MARKER-" + b"payload" * 3

        async def main():
            dq = DiskQueue(disk, "rot")
            await dq.recover()
            for r in records:
                await dq.push(r)
            await dq.commit()
            f = disk.files["rot.dq0"]
            if undetected:
                assert corrupt_value_bytes(f, b"MARKER", flow.g_random)
            else:
                assert corrupt_record_payload(f, flow.g_random)
            dq2 = DiskQueue(disk, "rot")
            if not undetected:
                with pytest.raises(flow.FdbError) as ei:
                    await dq2.recover()
                assert ei.value.name == "checksum_failed"
                return True
            got = await dq2.recover()
            assert len(got) == len(records)
            diff = [i for i, (a, b) in enumerate(zip(got, records))
                    if a != b]
            assert diff == [3], diff
            return True

        task = s.spawn(main())
        assert s.run(until=task, timeout_time=60)
        kind = ("disk_corruption_undetected" if undetected
                else "disk_corruption")
        assert net.chaos_counters.get(kind) == 1
    finally:
        flow.set_scheduler(None)
