"""The reference's cases of tests/test_management.py on the port's
SimCluster.

ManagementAPI: live reconfiguration and worker exclusion
(ref: fdbclient/ManagementAPI.actor.cpp changeConfig/excludeServers)."""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch.client import run_transaction  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402


def test_configure_changes_shape_through_recovery():
    c = SimCluster(seed=901, n_workers=5)
    try:
        db = c.client()

        async def main():
            async def body(tr):
                tr.set(b"a", b"1")
            await run_transaction(db, body)
            st = await db.get_status()
            assert st["cluster"]["configuration"]["resolvers"] == 1
            e0 = st["cluster"]["epoch"]

            await db.configure(n_resolvers=2, n_logs=2)

            # data survives; the new epoch runs the new shape (the
            # config change lands on the monitor's next tick, like the
            # reference's changeConfig returning before recovery)
            from foundationdb_tpu_torch import flow
            for _ in range(200):
                st = await db.get_status()
                if st["cluster"]["epoch"] > e0 and \
                        st["cluster"]["recovery_state"] == "fully_recovered":
                    break
                await flow.delay(0.1)

            async def body2(tr):
                assert await tr.get(b"a") == b"1"
                tr.set(b"b", b"2")
            await run_transaction(db, body2, max_retries=300)
            st = await db.get_status()
            cl = st["cluster"]
            assert cl["epoch"] > e0
            assert cl["configuration"]["resolvers"] == 2
            assert cl["configuration"]["logs"] == 2
            assert len(cl["logs"]) == 2
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


def test_exclude_worker_moves_roles_off_it():
    c = SimCluster(seed=903, durable=True, n_workers=5)
    try:
        db = c.client()

        async def main():
            async def body(tr):
                tr.set(b"k", b"v")
            await run_transaction(db, body)
            # find the worker hosting the current tlog and exclude it
            st = await db.get_status()
            victim = None
            for wname, w in st["cluster"]["workers"].items():
                if any(r.startswith("tlog-e") for r in w["roles"]):
                    victim = wname
                    break
            assert victim is not None
            e0 = st["cluster"]["epoch"]
            await db.exclude(victim)

            from foundationdb_tpu_torch import flow
            for _ in range(200):
                st = await db.get_status()
                if st["cluster"]["epoch"] > e0 and \
                        st["cluster"]["recovery_state"] == "fully_recovered":
                    break
                await flow.delay(0.1)

            async def body2(tr):
                assert await tr.get(b"k") == b"v"
                tr.set(b"k2", b"v2")
            await run_transaction(db, body2, max_retries=300)
            st = await db.get_status()
            cl = st["cluster"]
            # the new epoch's transaction roles avoid the excluded worker
            cur = f"-e{cl['epoch']}-"
            roles_on_victim = [r for r in cl["workers"][victim]["roles"]
                               if cur in r]
            assert roles_on_victim == [], roles_on_victim
            # include it back: eligible again (no immediate role change)
            await db.exclude(victim, exclude=False)
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


def test_conf_sync_survives_committed_exclusion_rows():
    """Regression: the conf-sync reconcile loop must keep running with
    committed \\xff/excluded/ rows present (a crash there permanently
    stops config adoption) — proven by excluding a worker, letting
    several sync rounds pass, then committing a config change and
    seeing it adopted."""
    from foundationdb_tpu_torch import flow

    c = SimCluster(seed=907, n_workers=4)
    try:
        db = c.client()

        async def main():
            async def body(tr):
                tr.set(b"k", b"v")
            await run_transaction(db, body)
            st = await db.get_status()
            workers = st["cluster"]["workers"]
            # prefer a role-less worker; any worker is excludable here
            victim = min((w for w, info in workers.items()
                          if not info["roles"]), default=max(workers))
            await db.exclude(victim)
            # several sync intervals with the row present
            await flow.delay(3 * flow.SERVER_KNOBS.conf_sync_interval)
            # the sync actor must still adopt config changes
            await db.configure(n_proxies=2)
            deadline = flow.now() + 60
            while True:
                st = await db.get_status()
                cfg = st["cluster"]["configuration"]
                if cfg.get("proxies") == 2 and \
                        st["cluster"]["recovery_state"] == "fully_recovered":
                    break
                assert flow.now() < deadline, cfg
                await flow.delay(0.5)
            assert victim in set(cfg.get("excluded", ()))
            return True

        assert c.run(main(), timeout_time=300)
    finally:
        c.shutdown()
