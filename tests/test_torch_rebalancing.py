"""The reference's cases of tests/test_rebalancing.py on the port's
SimCluster.

Resolver rebalancing: the keyResolvers owner-history map, the
double-delivery window that keeps conflict detection exact across a
move, and the master's resolutionBalancing actor shifting a hotspot.

Moves are VERSIONED THROUGH THE COMMIT STREAM: the master stamps each
move with the next version it will assign and piggybacks unseen moves
on every version reply, so all proxies apply a move at the same
effective version (no cross-proxy apply skew, no slack margin).

Ref: masterserver.actor.cpp:1008 (resolutionBalancing),
MasterProxyServer.actor.cpp:204 (keyResolvers riding the commit
stream via ApplyMetadataMutation), ResolverInterface.h:121.
"""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.client import run_transaction  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402
from foundationdb_tpu_torch.server.proxy import MWTLV, KeyResolverMap  # noqa: E402


def test_key_resolver_map_move_and_window():
    m = KeyResolverMap([b"\x80"], 2)   # resolver 0: [..80), 1: [80..)
    # initially single owners
    assert m.clip_per_resolver([(b"\x10", b"\x11")], 2) == \
        [[(b"\x10", b"\x11")], []]
    # move [10,11) to resolver 1 at version 1000
    m.move(b"\x10", b"\x11", 1, 1000)
    # both owners see it during the window (double delivery)
    clipped = m.clip_per_resolver([(b"\x10", b"\x11")], 2)
    assert clipped[0] == [(b"\x10", b"\x11")]
    assert clipped[1] == [(b"\x10", b"\x11")]
    # untouched ranges unchanged
    assert m.clip_per_resolver([(b"\x90", b"\x91")], 2) == \
        [[], [(b"\x90", b"\x91")]]
    # exactly one MVCC window after the move, only the new owner
    # remains — no skew slack (moves are version-stamped)
    m.prune(1000 + MWTLV)
    clipped = m.clip_per_resolver([(b"\x10", b"\x11")], 2)
    assert clipped[0] == [(b"\x10", b"\x11")]  # still within horizon
    m.prune(1000 + MWTLV + 1)
    clipped = m.clip_per_resolver([(b"\x10", b"\x11")], 2)
    assert clipped[0] == []
    assert clipped[1] == [(b"\x10", b"\x11")]
    # a range spanning the moved bucket splits correctly
    clipped = m.clip_per_resolver([(b"\x0f", b"\x12")], 2)
    assert clipped[0] == [(b"\x0f", b"\x10"), (b"\x11", b"\x12")]
    assert clipped[1] == [(b"\x10", b"\x11")]


def test_hotspot_moves_bucket_and_stays_correct():
    """All load on two byte-prefixes owned by resolver 0; the balancer
    moves one to resolver 1; the increments stay exact throughout."""
    c = SimCluster(seed=501, n_resolvers=2)
    try:
        dbs = [c.client(f"cl{i}") for i in range(3)]

        def moved():
            for w in c.workers.values():
                for rn, role in w.roles.items():
                    if rn.startswith("proxy-e"):
                        return len(role.key_resolvers.bounds) > 2
            return False

        async def incr(db, key, n):
            for _ in range(n):
                async def body(tr):
                    cur = await tr.get(key)
                    tr.set(key, b"%d" % (int(cur or b"0") + 1))
                await run_transaction(db, body, max_retries=500)
                await flow.delay(0.05)

        async def main():
            # hot prefixes 0x10 and 0x20, both on resolver 0
            tasks = [flow.spawn(incr(dbs[0], b"\x10hot", 60)),
                     flow.spawn(incr(dbs[1], b"\x20hot", 60)),
                     flow.spawn(incr(dbs[2], b"\x20hot2", 60))]
            await flow.wait_for_all(tasks)
            assert moved(), "balancer never moved a bucket"
            tr = dbs[0].create_transaction()
            a = int(await tr.get(b"\x10hot"))
            b = int(await tr.get(b"\x20hot"))
            b2 = int(await tr.get(b"\x20hot2"))
            assert (a, b, b2) == (60, 60, 60), (a, b, b2)
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


def _proxy_roles(c):
    out = []
    for w in c.workers.values():
        for rn, role in w.roles.items():
            if rn.startswith("proxy-e"):
                out.append(role)
    return out


def test_conflict_detected_across_move():
    """A write committed BEFORE a boundary move must still conflict
    with a stale-snapshot transaction committed AFTER the move — the
    double-delivery window means some live resolver holds the write's
    history (the exactness property of the transition)."""
    c = SimCluster(seed=503, n_resolvers=2)
    try:
        db = c.client()

        async def main():
            setup = db.create_transaction()
            setup.set(b"\x10k", b"0")
            await setup.commit()

            # t_stale reads before the conflicting write
            t_stale = db.create_transaction()
            assert await t_stale.get(b"\x10k") == b"0"

            # W commits (resolver 0 records it)
            w = db.create_transaction()
            w.set(b"\x10k", b"1")
            await w.commit()

            # boundary moves: bucket 0x10 now owned by resolver 1,
            # stamped into the version chain by the master
            c.cc._recovery.master.register_move(b"\x10", b"\x11", 1)

            # the stale transaction must CONFLICT, not commit
            t_stale.set(b"\x10k", b"2")
            with pytest.raises(flow.FdbError) as ei:
                await t_stale.commit()
            assert ei.value.name == "not_committed"
            tr = db.create_transaction()
            assert await tr.get(b"\x10k") == b"1"
            return True

        assert c.run(main(), timeout_time=300)
    finally:
        c.shutdown()


def test_move_applies_at_same_version_despite_skewed_proxies():
    """Artificially skew the proxies' apply
    points — proxy A processes commits (and thus applies the move)
    long before proxy B sees any traffic — then prove (a) a stale
    transaction routed through the laggard still conflicts, and (b)
    both proxies recorded the move at the SAME effective version."""
    from foundationdb_tpu_torch.server.types import (CommitRequest, MutationRef,
                                               SET_VALUE)
    c = SimCluster(seed=507, n_resolvers=2, n_proxies=2)
    try:
        db = c.client()

        async def commit_via(proxy, snapshot, reads, writes, mutations):
            return await proxy.commits.ref().get_reply(
                CommitRequest(snapshot, tuple(reads), tuple(writes),
                              tuple(mutations)), db.process)

        async def main():
            # wait for recovery (roles exist only once recruited)
            boot = db.create_transaction()
            boot.set(b"boot", b"1")
            await boot.commit()
            pa, pb = _proxy_roles(c)
            key = b"\x10k"
            kr = (key, key + b"\x00")
            # seed through proxy A
            v0 = (await commit_via(pa, 0, (), (kr,),
                                   (MutationRef(SET_VALUE, key, b"0"),))
                  ).version

            # stale snapshot: v0 (before the conflicting write)
            v1 = (await commit_via(pa, v0, (), (kr,),
                                   (MutationRef(SET_VALUE, key, b"1"),))
                  ).version

            # version-stamped move of bucket 0x10 to resolver 1
            eff = c.cc._recovery.master.register_move(b"\x10", b"\x11", 1)

            # SKEW: proxy A processes several commits (applying the
            # move); proxy B gets no traffic at all
            for i in range(3):
                await commit_via(pa, v1, (), ((b"other", b"other\x00"),),
                                 (MutationRef(SET_VALUE, b"other",
                                              b"%d" % i),))
            assert any(v == eff for own in pa.key_resolvers.owners
                       for v, _ in own), "proxy A never applied the move"
            assert not any(v == eff for own in pb.key_resolvers.owners
                           for v, _ in own), "test setup: B applied early"

            # the stale txn (snapshot v0, conflicts with the v1 write)
            # goes through the LAGGARD proxy B — it must still abort
            with pytest.raises(flow.FdbError) as ei:
                await commit_via(pb, v0, (kr,), (kr,),
                                 (MutationRef(SET_VALUE, key, b"2"),))
            assert ei.value.name == "not_committed"

            # and B applied the move at the SAME effective version as A
            def applied_at(proxy):
                for own in proxy.key_resolvers.owners:
                    for v, idx in own:
                        if v == eff and idx == 1:
                            return v
                return None
            assert applied_at(pa) == applied_at(pb) == eff
            return True

        assert c.run(main(), timeout_time=300)
    finally:
        c.shutdown()
