"""The reference's cases of tests/test_team_health.py on the port's
SimCluster.

DD team-health tracking (ref: DDTeamCollection,
DataDistribution.actor.cpp:539): a team that stays below its
replication target past the rebuild delay gets a fresh replica built
from a live teammate — no operator exclusion required."""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.client import run_transaction  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402
from foundationdb_tpu_torch.server.consistency import check_consistency  # noqa: E402


def test_dead_replica_is_rebuilt():
    c = SimCluster(seed=921, durable=True, n_storage=1,
                   storage_replicas=2, n_workers=6, auto_reboot=False)
    try:
        db = c.client()

        async def main():
            for i in range(20):
                async def body(tr, i=i):
                    tr.set(b"h%03d" % i, b"v%d" % i)
                await run_transaction(db, body)

            info = c.cc.dbinfo.get()
            victim = info.storages[0].replicas[0].name
            wname = c.cc._worker_of_role(victim)[0]
            c.kill_worker(wname)

            # past the rebuild delay, DD builds a replacement replica
            deadline = flow.now() + 120
            while True:
                assert flow.now() < deadline, "team never rebuilt"
                info = c.cc.dbinfo.get()
                team = info.storages[0].replicas
                objs = [c.cc._storage_objs.get(r.name) for r in team]
                if victim not in [r.name for r in team] and \
                        all(o is not None and o.process.alive
                            for o in objs) and len(team) == 2:
                    break
                # keep a trickle of commits so frontiers advance
                async def body(tr):
                    tr.set(b"nudge", b"x")
                await run_transaction(db, body, max_retries=500)
                await flow.delay(0.5)

            # more writes land on the healed team
            for i in range(20, 30):
                async def body(tr, i=i):
                    tr.set(b"h%03d" % i, b"v%d" % i)
                await run_transaction(db, body, max_retries=500)

            # both replicas byte-agree over everything
            stats = await check_consistency(c)
            assert stats["replicas"] >= 2

            async def check(tr):
                rows = dict(await tr.get_range(b"h", b"i"))
                for i in range(30):
                    assert rows.get(b"h%03d" % i) == b"v%d" % i, i
            await run_transaction(db, check, max_retries=500)
            return True

        assert c.run(main(), timeout_time=900)
    finally:
        c.shutdown()


def test_rebooting_worker_wins_the_grace_race():
    """With auto-reboot ON, a crashed worker comes back inside the
    rebuild delay and the team heals by REJOINING — DD must not burn a
    rebuild on it."""
    c = SimCluster(seed=923, durable=True, n_storage=1,
                   storage_replicas=2, n_workers=6)
    try:
        db = c.client()

        async def main():
            async def body(tr):
                tr.set(b"x", b"1")
            await run_transaction(db, body)
            info = c.cc.dbinfo.get()
            victim = info.storages[0].replicas[0].name
            before = [r.name for r in info.storages[0].replicas]
            wname = c.cc._worker_of_role(victim)[0]
            c.kill_worker(wname)
            # wait for reboot + re-registration (sim_reboot_delay 0.5)
            deadline = flow.now() + 60
            while True:
                assert flow.now() < deadline
                obj = c.cc._storage_objs.get(victim)
                if obj is not None and obj.process.alive:
                    break
                await flow.delay(0.2)
            await flow.delay(flow.SERVER_KNOBS.dd_team_rebuild_delay + 2)
            after = [r.name for r in
                     c.cc.dbinfo.get().storages[0].replicas]
            assert after == before    # same team: no rebuild happened
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


def test_stuck_replica_is_rebuilt():
    """A replica that is ALIVE but cannot make progress (it recovered
    at a version whose covering log generation retired while it was
    down) must be detected as stuck and rebuilt — found by a fresh-seed
    sweep where exactly this wedged quiet_database forever."""
    c = SimCluster(seed=925, durable=True, n_storage=1,
                   storage_replicas=2, n_workers=6)
    try:
        db = c.client()

        async def main():
            for i in range(10):
                async def body(tr, i=i):
                    tr.set(b"s%03d" % i, b"v%d" % i)
                await run_transaction(db, body)

            # wedge one replica: no log source ever covers its needs
            info = c.cc.dbinfo.get()
            victim = info.storages[0].replicas[0].name
            obj = c.cc._storage_objs[victim]
            obj.version.rollback(0)          # "recovered at version 0"
            obj._pick_source = lambda needed: None   # nothing covers it

            # commits keep flowing; the healer detects the stuck
            # replica and rebuilds the team
            deadline = flow.now() + 120
            while True:
                assert flow.now() < deadline, "stuck replica never healed"
                info = c.cc.dbinfo.get()
                team = info.storages[0].replicas
                if victim not in [r.name for r in team]:
                    break
                async def body(tr):
                    tr.set(b"nudge", b"x")
                await run_transaction(db, body, max_retries=500)
                await flow.delay(0.5)

            await c.quiet_database()
            stats = await check_consistency(c, quiesce=False)
            assert stats["replicas"] >= 2
            return True

        assert c.run(main(), timeout_time=900)
    finally:
        c.shutdown()
