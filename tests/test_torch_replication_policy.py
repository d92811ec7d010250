"""The reference's replication-policy algebra cases
(tests/test_replication_policy.py) on the port's
`server.replication_policy`. Its two recruitment cases need the
cluster controller and come with the port's cluster.

Ref: fdbrpc/ReplicationPolicy.h:101-168 (PolicyOne/Across/And trees over
LocalityData).
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
