"""The reference's replication-policy cases
(tests/test_replication_policy.py) on the port's
`server.replication_policy`, its two recruitment cases on the port's
SimCluster.

Replication policy algebra + locality-aware recruitment.

Ref: fdbrpc/ReplicationPolicy.h:101-168 (PolicyOne/Across/And trees over
LocalityData), fdbserver/ClusterController recruitment applying the
configured policies to worker placement.
"""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch.server.replication_policy import (Locality, PolicyAnd,  # noqa: E402
                                                        PolicyAcross,
                                                        PolicyOne)


def _cands(spec):
    """spec: list of (name, zoneid, dcid)"""
    return [(name, Locality(processid=name, zoneid=z, dcid=d))
            for name, z, d in spec]


def test_policy_one():
    p = PolicyOne()
    assert p.replica_count() == 1
    assert p.select(_cands([("a", "z1", "dc1")])) == ["a"]
    assert p.select([]) is None
    assert p.validate([Locality(zoneid="z")])
    assert not p.validate([])


def test_policy_across_zones():
    p = PolicyAcross(2, "zoneid", PolicyOne())
    assert p.replica_count() == 2
    team = p.select(_cands([("a", "z1", "dc1"), ("b", "z1", "dc1"),
                            ("c", "z2", "dc1")]))
    assert team == ["a", "c"]  # two distinct zones, candidate order
    # one zone only: unsatisfiable
    assert p.select(_cands([("a", "z1", "dc1"), ("b", "z1", "dc1")])) is None
    assert p.validate([Locality(zoneid="z1"), Locality(zoneid="z2")])
    assert not p.validate([Locality(zoneid="z1"), Locality(zoneid="z1")])


def test_policy_across_nested():
    # two dcs, each with two distinct zones
    p = PolicyAcross(2, "dcid", PolicyAcross(2, "zoneid", PolicyOne()))
    assert p.replica_count() == 4
    spec = [("a", "z1", "dc1"), ("b", "z2", "dc1"),
            ("c", "z3", "dc2"),                      # dc2: one zone only
            ("d", "z4", "dc3"), ("e", "z5", "dc3")]
    team = p.select(_cands(spec))
    # dc2 cannot satisfy the inner policy and is skipped for dc3
    assert team == ["a", "b", "d", "e"]
    assert p.validate([Locality(zoneid="z1", dcid="dc1"),
                       Locality(zoneid="z2", dcid="dc1"),
                       Locality(zoneid="z4", dcid="dc3"),
                       Locality(zoneid="z5", dcid="dc3")])
    assert not p.validate([Locality(zoneid="z1", dcid="dc1"),
                           Locality(zoneid="z2", dcid="dc1"),
                           Locality(zoneid="z3", dcid="dc2")])


def test_policy_and():
    # three replicas AND at least two zones
    p = PolicyAnd([PolicyAcross(3, "processid", PolicyOne()),
                   PolicyAcross(2, "zoneid", PolicyOne())])
    team = p.select(_cands([("a", "z1", "dc1"), ("b", "z1", "dc1"),
                            ("c", "z2", "dc1")]))
    assert team is not None and len(team) == 3
    # three processes but a single zone fails the zone clause
    assert p.select(_cands([("a", "z1", "dc1"), ("b", "z1", "dc1"),
                            ("d", "z1", "dc1")])) is None


def test_missing_attribute_is_skipped():
    p = PolicyAcross(1, "zoneid", PolicyOne())
    assert p.select([("a", Locality(processid="a"))]) is None


def test_recruitment_places_logs_across_machines():
    """n_logs=2 TLogs land on two distinct machines whenever the worker
    pool spans two, across repeated recoveries (ref: tLogPolicy
    placement in recruitEverything)."""
    from foundationdb_tpu_torch.server.cluster import SimCluster

    c = SimCluster(seed=31, n_logs=2, n_workers=5)
    try:
        async def main():
            import foundationdb_tpu_torch.flow as fl
            while c.cc.dbinfo.get().recovery_state != "fully_recovered":
                await c.cc.dbinfo.on_change()
            for _ in range(3):
                info = c.cc.dbinfo.get()
                machines = {lr.machine for lr in info.logs.logs}
                assert len(machines) == 2, info.logs
                c.kill_role("tlog")
                await fl.delay(3.0)
                while c.cc.dbinfo.get().recovery_state != "fully_recovered":
                    await c.cc.dbinfo.on_change()
            return True

        assert c.run(main(), timeout_time=300)
    finally:
        c.shutdown()


def test_recruitment_degrades_on_single_machine():
    """A one-zone pool still recruits (degraded mode) instead of
    stalling recovery."""
    from foundationdb_tpu_torch.server.cluster import SimCluster

    c = SimCluster(seed=32, n_logs=2, n_workers=4)
    try:
        async def main():
            while c.cc.dbinfo.get().recovery_state != "fully_recovered":
                await c.cc.dbinfo.on_change()
            # collapse every registered worker onto one zone: the policy
            # becomes unsatisfiable and selection must fall back instead
            # of raising
            c.cc.workers = {name: wi._replace(machine="onezone")
                            for name, wi in c.cc.workers.items()}
            team = c.cc.pick_workers(2, role="tlog")
            assert len(team) == 2
            assert len(set(map(id, team))) == 2  # still distinct workers
            return True

        assert c.run(main(), timeout_time=60)
    finally:
        c.shutdown()
