"""The reference's recovery cases (tests/test_recovery.py) on the port's
SimCluster. Epoch recovery under faults: kill transaction roles mid-workload on
durable clusters; the recovery state machine — not test scaffolding —
heals the cluster and no acknowledged commit is lost.

Ref: fdbserver/masterserver.actor.cpp masterCore (:1212),
TagPartitionedLogSystem.actor.cpp epochEnd (:1265), and the simulation
test strategy of workloads running *while* processes die
(fdbserver/workloads/MachineAttrition.actor.cpp, tests/fast/CycleTest.txt).
"""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.client import run_transaction  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402


def _durable_cluster(seed, **kw):
    kw.setdefault("durable", True)
    return SimCluster(seed=seed, **kw)


@pytest.mark.parametrize("role,seed", [("tlog", 101), ("proxy", 102),
                                       ("resolver", 103)])
def test_kill_role_cluster_heals(role, seed):
    """Killing any transaction-subsystem role mid-stream triggers an
    epoch recovery; acknowledged writes survive, later writes work."""
    c = _durable_cluster(seed=seed)
    try:
        db = c.client()

        async def main():
            acked = []
            for i in range(5):
                async def body(tr, i=i):
                    tr.set(b"k%02d" % i, b"v%d" % i)
                await run_transaction(db, body)
                acked.append(i)
            c.kill_role(role)
            # commits must keep working through the recovery
            for i in range(5, 10):
                async def body(tr, i=i):
                    tr.set(b"k%02d" % i, b"v%d" % i)
                await run_transaction(db, body)
                acked.append(i)
            tr = db.create_transaction()
            got = await tr.get_range(b"k", b"l")
            assert got == [(b"k%02d" % i, b"v%d" % i) for i in acked]
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


def test_kill_tlog_during_cycle_workload():
    """The Cycle invariant holds across a TLog kill mid-workload
    (ref: Cycle.actor.cpp stacked with Attrition)."""
    n = 6
    c = _durable_cluster(seed=7)
    try:
        db = c.client()
        dbs = [c.client(f"c{i}") for i in range(3)]

        async def setup():
            tr = db.create_transaction()
            for i in range(n):
                tr.set(b"cyc%02d" % i, b"%02d" % ((i + 1) % n))
            await tr.commit()

        async def swap_loop(db, iters):
            for _ in range(iters):
                async def body(tr):
                    a = flow.g_random.random_int(0, n)
                    b = int(await tr.get(b"cyc%02d" % a))
                    cc_ = int(await tr.get(b"cyc%02d" % b))
                    d = int(await tr.get(b"cyc%02d" % cc_))
                    tr.set(b"cyc%02d" % a, b"%02d" % cc_)
                    tr.set(b"cyc%02d" % cc_, b"%02d" % b)
                    tr.set(b"cyc%02d" % b, b"%02d" % d)
                await run_transaction(db, body, max_retries=200)

        async def killer():
            await flow.delay(0.05)
            c.kill_role("tlog")

        async def main():
            await setup()
            tasks = [flow.spawn(swap_loop(d, 6)) for d in dbs]
            tasks.append(flow.spawn(killer()))
            await flow.wait_for_all(tasks)

            async def check(tr):
                kvs = await tr.get_range(b"cyc", b"cyd")
                assert len(kvs) == n
                nxt = {int(k[3:]): int(v) for k, v in kvs}
                seen, cur = set(), 0
                while cur not in seen:
                    seen.add(cur)
                    cur = nxt[cur]
                assert len(seen) == n, f"cycle broken: {nxt}"
            await run_transaction(db, check, max_retries=50)
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


def test_storage_worker_reboot_rejoins():
    """A killed storage worker auto-reboots, recovers its engine from
    disk, re-registers, and serves reads again — no epoch change
    needed."""
    c = _durable_cluster(seed=23)
    try:
        db = c.client()

        async def main():
            async def body(tr):
                tr.set(b"a", b"1")
                tr.set(b"b", b"2")
            await run_transaction(db, body)
            c.kill_role("storage")

            async def body2(tr):
                assert await tr.get(b"a") == b"1"
                tr.set(b"c", b"3")
            await run_transaction(db, body2, max_retries=200)
            tr = db.create_transaction()
            assert await tr.get(b"c") == b"3"
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


def test_master_epoch_advances_on_kill():
    """Recovery bumps the epoch in the coordinated state and the
    broadcast dbinfo."""
    c = _durable_cluster(seed=41)
    try:
        db = c.client()

        async def main():
            async def body(tr):
                tr.set(b"x", b"1")
            await run_transaction(db, body)
            e0 = c.cc.dbinfo.get().epoch
            assert e0 >= 1
            c.kill_role("proxy")

            async def body2(tr):
                tr.set(b"y", b"2")
            await run_transaction(db, body2, max_retries=200)
            assert c.cc.dbinfo.get().epoch > e0
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


def test_acked_commits_survive_power_loss_of_tlog():
    """Every acknowledged commit is readable after the TLog machine
    power-loses its unsynced writes and the cluster recovers (the
    durability contract end-to-end)."""
    c = _durable_cluster(seed=59)
    try:
        db = c.client()

        async def main():
            acked = {}
            for i in range(8):
                async def body(tr, i=i):
                    tr.set(b"p%02d" % i, b"v%d" % i)
                await run_transaction(db, body)
                acked[b"p%02d" % i] = b"v%d" % i
                if i == 4:
                    c.kill_role("tlog")
            tr = db.create_transaction()
            got = dict(await tr.get_range(b"p", b"q"))
            assert got == acked, (got, acked)
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


def test_coordination_quorum_survives_minority_loss():
    """With 3 coordinators, killing one leaves the quorum working:
    recovery (coordinated-state read + exclusive write) still succeeds
    (ref: CoordinatedState majority quorums,
    CoordinatedState.actor.cpp:60-197)."""
    c = _durable_cluster(seed=211, n_coordinators=3)
    try:
        db = c.client()

        async def main():
            async def body(tr):
                tr.set(b"k", b"1")
            await run_transaction(db, body)
            # kill one coordinator (minority), then force a recovery
            c.net.kill(c.coordinators[0].process)
            c.kill_role("tlog")

            async def body2(tr):
                assert await tr.get(b"k") == b"1"
                tr.set(b"k2", b"2")
            await run_transaction(db, body2, max_retries=300)
            assert c.cc.dbinfo.get().epoch >= 2
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


@pytest.mark.parametrize("seed", (91, 92, 93))
def test_whole_cluster_blackout_recovers_from_disks(seed):
    """Kill EVERY worker at the same instant mid-workload (total power
    event; only the coordinators/CC survive): the cluster must rebuild
    the transaction subsystem from the surviving disk stores with every
    acknowledged commit intact (ref: the simulation restart tests —
    recovery from durable state alone)."""
    c = _durable_cluster(seed, n_logs=2, n_storage=2, n_workers=6)
    try:
        db = c.client()

        async def main():
            acked = {}
            async def write(lo, hi):
                for i in range(lo, hi):
                    async def body(tr, i=i):
                        tr.set(b"bl%04d" % i, b"v%d" % i)
                    await run_transaction(db, body, max_retries=500)
                    acked[b"bl%04d" % i] = b"v%d" % i
            await write(0, 60)

            # total blackout: every worker dies in the same instant
            for name in list(c.workers):
                c.kill_worker(name)

            # auto-reboot + epoch recovery must heal from disks alone
            async def check(tr):
                rows = await tr.get_range(b"bl", b"bm")
                assert rows == sorted(acked.items()), (
                    len(rows), len(acked))
            await run_transaction(db, check, max_retries=800)

            # and the healed cluster keeps accepting commits
            await write(60, 80)
            await run_transaction(db, check, max_retries=500)
            return True

        assert c.run(main(), timeout_time=900)
    finally:
        c.shutdown()


def test_full_process_restart_from_real_disks(tmp_path):
    """The ULTIMATE durability test: the entire cluster object is
    discarded (process death) and a brand-new one boots from REAL
    on-disk state — coordinated state, log stores, storage stores —
    with every acknowledged commit intact (ref: the reference's restart
    tests: kill fdbserver, restart from the data directory)."""
    data = str(tmp_path / "data")

    def boot(seed):
        return SimCluster(seed=seed, durable=True, n_logs=2, n_storage=2,
                          data_dir=data)

    c1 = boot(201)
    try:
        db = c1.client()

        async def main():
            async def w(tr):
                for i in range(80):
                    tr.set(b"pr%03d" % i, b"v%d" % i)
            await run_transaction(db, w)
            # settle durability so the disks hold everything acked
            await c1.quiet_database()
            return True

        assert c1.run(main(), timeout_time=300)
    finally:
        c1.shutdown()

    # a completely new "process": fresh scheduler, network, CC,
    # coordinators — only the directory carries over
    c2 = boot(202)
    try:
        db2 = c2.client()

        async def main2():
            async def check(tr):
                rows = await tr.get_range(b"pr", b"ps")
                assert len(rows) == 80, len(rows)
                assert await tr.get(b"pr042") == b"v42"
                tr.set(b"after-restart", b"1")
            await run_transaction(db2, check, max_retries=500)
            # the restarted cluster recovered INTO a later epoch, not a
            # fresh database (the coordinated state survived)
            info = c2.cc.dbinfo.get()
            assert info.epoch >= 2, info.epoch

            async def check2(tr):
                assert await tr.get(b"after-restart") == b"1"
            await run_transaction(db2, check2, max_retries=500)
            return True

        assert c2.run(main2(), timeout_time=600)
    finally:
        c2.shutdown()
