"""The reference's coordinator-change cases
(tests/test_coordinator_change.py) on the port's SimCluster, without
its CLI case (`tools.cli` is not ported yet). Coordinator change:
MovableCoordinatedState + the `coordinators` management command.

Ref: fdbserver/CoordinatedState.actor.cpp:220 (MovableCoordinatedState),
fdbclient/ManagementAPI.actor.cpp (changeQuorum), and the coordinators'
ForwardRequest (fdbserver/CoordinationInterface.h) that keeps a
decommissioned quorum redirecting clients.
"""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.client import run_transaction  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402
from foundationdb_tpu_torch.server.coordination import (CoordinatedState,  # noqa: E402
                                                  ForwardRequest,
                                                  MovedValue, elect_leader)


def test_change_coordinators_under_live_traffic():
    """Change the quorum under live traffic,
    kill a majority of the OLD coordinators, and prove the cluster
    still recovers — the coordinated state must now live entirely on
    the new quorum."""
    c = SimCluster(seed=601, n_coordinators=3, durable=True)
    try:
        db = c.client()
        stop = [False]

        async def traffic():
            i = 0
            while not stop[0]:
                async def body(tr, i=i):
                    tr.set(b"t%04d" % i, b"v%d" % i)
                await run_transaction(db, body, max_retries=500)
                i += 1
                await flow.delay(0.05)
            return i

        async def main():
            t = flow.spawn(traffic())
            # let some commits land
            await flow.delay(2.0)

            # stand up a fresh quorum and move the coordinated state
            new_refs = c.add_coordinators(3)
            epoch_before = c.cc.dbinfo.get().epoch
            await db.change_coordinators(new_refs)

            # an operator retry with the same set (e.g. after a client
            # timeout) is a no-op, NOT a self-forwarding brick
            await db.change_coordinators(new_refs)

            # the change forces a recovery onto the new quorum
            while c.cc.dbinfo.get().epoch == epoch_before or \
                    c.cc.dbinfo.get().recovery_state != "fully_recovered":
                await flow.delay(0.1)

            # a majority of the OLD coordinators dies — fatal before
            # the change, irrelevant after it
            for coord in c.coordinators[:2]:
                c.net.kill(coord.process)

            # recovery through the NEW quorum must still work
            epoch2 = c.cc.dbinfo.get().epoch
            c.kill_role("tlog")
            while c.cc.dbinfo.get().epoch <= epoch2 or \
                    c.cc.dbinfo.get().recovery_state != "fully_recovered":
                await flow.delay(0.1)

            await flow.delay(1.0)
            stop[0] = True
            n = await t

            # every acknowledged write survived both recoveries
            tr = db.create_transaction()
            rows = await tr.get_range(b"t", b"u")
            assert len(rows) >= n, (len(rows), n)
            for i in range(n):
                assert (b"t%04d" % i, b"v%d" % i) in rows
            return True

        assert c.run(main(), timeout_time=900)
    finally:
        c.shutdown()


def test_overlapping_change_and_change_back():
    """The standard operational cases: replace ONE coordinator of
    three (old and new sets overlap — shared members hold the
    tombstone as their newest register write and must serve its
    carried value, not chase it), then change BACK to a set containing
    previously-decommissioned hosts (their stale forwards must
    clear)."""
    c = SimCluster(seed=607, n_coordinators=3, durable=True)
    try:
        db = c.client()

        async def recovered_past(epoch):
            while c.cc.dbinfo.get().epoch <= epoch or \
                    c.cc.dbinfo.get().recovery_state != "fully_recovered":
                await flow.delay(0.1)

        async def main():
            async def put(k, v):
                async def body(tr):
                    tr.set(k, v)
                await run_transaction(db, body, max_retries=500)

            await put(b"a", b"1")
            old_refs = [c._coord_refs(x) for x in c.coordinators[:3]]
            (extra,) = c.add_coordinators(1, tag="x")

            # overlap change: {0,1,2} -> {1,2,extra}
            e0 = c.cc.dbinfo.get().epoch
            await db.change_coordinators([old_refs[1], old_refs[2],
                                          extra])
            await recovered_past(e0)
            await put(b"b", b"2")

            # change BACK to the original three: host 0 was
            # decommissioned (forwarding) and must rejoin cleanly
            e1 = c.cc.dbinfo.get().epoch
            await db.change_coordinators(old_refs)
            await recovered_past(e1)
            await put(b"c", b"3")

            # recovery still works on the final quorum
            e2 = c.cc.dbinfo.get().epoch
            c.kill_role("tlog")
            await recovered_past(e2)

            async def check(tr):
                rows = await tr.get_range(b"a", b"d")
                assert rows == [(b"a", b"1"), (b"b", b"2"), (b"c", b"3")]
            await run_transaction(db, check, max_retries=200)
            return True

        assert c.run(main(), timeout_time=900)
    finally:
        c.shutdown()


def test_moved_value_followed_after_partial_change():
    """Mid-move crash: the mover seeded the new quorum and wrote the
    MovedValue tombstone but died before any ForwardRequest landed. A
    reader of the OLD quorum must still find the state by following
    the tombstone (ref: MovableValue modes)."""
    c = SimCluster(seed=603, n_coordinators=3)
    try:
        async def main():
            old = [c._coord_refs(x) for x in c.coordinators[:3]]
            new = c.add_coordinators(3, tag="b")
            proc = c.net.new_process("mover", machine="mover")

            old_cs = CoordinatedState([(x[0], x[1]) for x in old], proc)
            cur = await old_cs.read()  # whatever the cluster wrote
            new_cs = CoordinatedState([(x[0], x[1]) for x in new], proc)
            await new_cs.read()
            await new_cs.set_exclusive(cur)
            await old_cs.set_exclusive(MovedValue(tuple(new), cur))
            # NO forwards sent: the mover "crashed" here

            reader = CoordinatedState([(x[0], x[1]) for x in old],
                                      c.net.new_process("r2", machine="r2"))
            got = await reader.read()
            assert got == cur
            # the reader is now retargeted at the new quorum: a write
            # through it must be visible via the new coordinators
            await reader.set_exclusive(("post-move", 1))
            check = CoordinatedState([(x[0], x[1]) for x in new],
                                     c.net.new_process("r3", machine="r3"))
            assert await check.read() == ("post-move", 1)
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_election_follows_forwarded_quorum():
    """A candidate electing against decommissioned coordinators is
    redirected to the new set and wins there."""
    c = SimCluster(seed=605, n_coordinators=3)
    try:
        async def main():
            old = [c._coord_refs(x) for x in c.coordinators[:3]]
            new = c.add_coordinators(3, tag="e")
            proc = c.net.new_process("cand", machine="cand")
            for x in old:
                await x[3].get_reply(ForwardRequest(tuple(new)), proc)
            final = await elect_leader(old, b"\xff/otherLeader",
                                       "cand", proc)
            assert len(final) == len(new)
            # the leadership was recorded on the NEW quorum: electing
            # a worse candidate there observes "cand" as the leader
            with pytest.raises(flow.FdbError):
                await elect_leader(new, b"\xff/otherLeader", "zzz", proc)
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()
