"""The reference's cases of tests/test_locality.py on the port's
SimCluster.

Machine/zone locality model + policy-driven DD teams.

Ref: fdbrpc/simulator.h:47-147 (processes belong to machines; machine
kills correlate), fdbserver/DataDistribution.actor.cpp:68,563
(TCMachineTeamInfo — teams built across machines with locality
diversity through the configured storagePolicy), SimulatedCluster
setupSimulatedSystem (machines spread over zones/DCs).
"""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.client import run_transaction  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402
from foundationdb_tpu_torch.server.replication_policy import (PolicyAcross,  # noqa: E402
                                                        PolicyOne)


def _team_zones(c):
    """zone of every replica's worker, per shard."""
    info = c.cc.dbinfo.get()
    out = []
    for s in info.storages:
        zones = []
        for rep in s.replicas:
            wname, wi = c.cc._worker_of_role(rep.name)
            assert wname is not None, rep.name
            zones.append(wi.zone or wi.machine)
        out.append(zones)
    return out


def test_processes_share_machines_and_zones():
    """workers_per_machine/n_zones lay workers onto a machine grid;
    kill_machine takes out every co-located process at once."""
    c = SimCluster(seed=701, workers_per_machine=2, n_zones=3,
                   n_workers=12)
    try:
        machines = {}
        for name, w in c.workers.items():
            machines.setdefault(w.process.machine, []).append(name)
        assert len(machines) == 6
        assert all(len(v) == 2 for v in machines.values())
        zones = {w.process.zone for w in c.workers.values()}
        assert zones == {"z0", "z1", "z2"}

        async def main():
            m = c.workers["worker0"].process.machine
            names = set(c.kill_machine(m))
            # both co-located workers died in the same event
            assert {"worker0", "worker1"} <= names
            assert not c.net.processes["worker0"].alive
            assert not c.net.processes["worker1"].alive
            return True

        assert c.run(main(), timeout_time=60)
    finally:
        c.shutdown()


def test_storage_teams_built_across_zones():
    """With a 3-zone grid and triple replication, every shard's team
    lands in 3 distinct zones (the policy algebra drives placement)."""
    c = SimCluster(seed=703, storage_replicas=3, n_storage=2,
                   workers_per_machine=2, n_zones=3, n_workers=12,
                   durable=True)
    try:
        async def main():
            while c.cc.dbinfo.get().recovery_state != "fully_recovered":
                await flow.delay(0.1)
            for zones in _team_zones(c):
                assert len(set(zones)) == 3, zones
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_policy_violating_team_unconstructible():
    """An explicitly configured policy is strict: a pool that cannot
    satisfy it refuses the team (no silent degradation), both through
    pick_workers and validate()."""
    c = SimCluster(seed=705, workers_per_machine=2, n_zones=2,
                   n_workers=8)
    try:
        async def main():
            while c.cc.dbinfo.get().recovery_state != "fully_recovered":
                await flow.delay(0.1)
            pol = PolicyAcross(3, "zoneid", PolicyOne())
            with pytest.raises(flow.FdbError) as ei:
                c.cc.pick_workers(3, role="storage", policy=pol,
                                  strict=True)
            assert ei.value.name == "no_more_servers"
            # the same pool satisfies a 2-zone policy
            team = c.cc.pick_workers(2, role="storage",
                                     policy=PolicyAcross(2, "zoneid",
                                                         PolicyOne()),
                                     strict=True)
            assert len(team) == 2
            # machine-level diversity: 4 machines can host 4-across
            team4 = c.cc.pick_workers(
                4, role="storage",
                policy=PolicyAcross(4, "machineid", PolicyOne()),
                strict=True)
            assert len(team4) == 4
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_machine_kill_zero_data_loss():
    """Triple replication across 3 zones survives a whole-machine kill
    (two storage-hosting processes at once) with zero data loss; the
    team heals back to 3 distinct zones."""
    c = SimCluster(seed=707, storage_replicas=3, n_storage=1,
                   workers_per_machine=2, n_zones=3, n_workers=12,
                   durable=True, auto_reboot=False)
    try:
        db = c.client()

        async def main():
            async def put(i):
                async def body(tr):
                    tr.set(b"mk%04d" % i, b"v%d" % i)
                await run_transaction(db, body, max_retries=500)

            for i in range(60):
                await put(i)

            # kill the whole machine hosting the first replica
            info = c.cc.dbinfo.get()
            rep0 = info.storages[0].replicas[0].name
            wname, _wi = c.cc._worker_of_role(rep0)
            machine = c.machine_of(wname)
            killed = c.kill_machine(machine)
            assert wname in killed

            # writes keep working through the surviving replicas
            for i in range(60, 90):
                await put(i)

            # DD heals the team back to full strength on live zones
            deadline = flow.now() + 120
            while flow.now() < deadline:
                info = c.cc.dbinfo.get()
                objs = [c.cc._storage_objs.get(r.name)
                        for r in info.storages[0].replicas]
                if all(o is not None and o.process.alive for o in objs):
                    break
                await flow.delay(1.0)
            zones = _team_zones(c)[0]
            assert len(set(zones)) == 3, zones

            # zero data loss: every acknowledged row readable
            async def check(tr):
                rows = await tr.get_range(b"mk", b"ml")
                assert len(rows) == 90, len(rows)
                for i in range(90):
                    assert (b"mk%04d" % i, b"v%d" % i) in rows
            await run_transaction(db, check, max_retries=500)
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


@pytest.mark.parametrize("seed", range(20))
def test_machine_kill_sweep(seed):
    """20-seed sweep: triple replication
    across 3 zones + a whole-machine kill mid-traffic never loses an
    acknowledged write; the cluster recovers to a fully-replicated
    state on every seed."""
    c = SimCluster(seed=7100 + seed, storage_replicas=3, n_storage=1,
                   workers_per_machine=2, n_zones=3, n_workers=12,
                   durable=True)
    try:
        db = c.client()

        async def main():
            acked = []

            async def put(i):
                async def body(tr):
                    tr.set(b"s%04d" % i, b"v%d" % i)
                await run_transaction(db, body, max_retries=500)
                acked.append(i)

            for i in range(25):
                await put(i)
            # pick a VICTIM machine actually hosting storage
            info = c.cc.dbinfo.get()
            rep = info.storages[0].replicas[seed % 3].name
            wname, _wi = c.cc._worker_of_role(rep)
            c.kill_machine(c.machine_of(wname))
            for i in range(25, 50):
                await put(i)

            async def check(tr):
                rows = dict(await tr.get_range(b"s", b"t"))
                for i in acked:
                    assert rows.get(b"s%04d" % i) == b"v%d" % i, i
            await run_transaction(db, check, max_retries=500)
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        c.shutdown()
