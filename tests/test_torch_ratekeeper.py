"""The reference's ratekeeper cases (tests/test_ratekeeper.py) on the
port's SimCluster. Ratekeeper admission control: GRVs are batched and rate-gated; an
unhealthy cluster throttles instead of growing queues without bound.

Ref: fdbserver/Ratekeeper.actor.cpp (updateRate :150-635),
MasterProxyServer.actor.cpp transactionStarter (:1102, GRV batching).
"""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.client import run_transaction  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402


def test_healthy_cluster_grvs_flow_freely():
    c = SimCluster(seed=401)
    try:
        db = c.client()

        async def main():
            async def body(tr):
                tr.set(b"x", b"1")
            await run_transaction(db, body)
            served = 0
            end = flow.now() + 0.5
            while flow.now() < end:
                tr = db.create_transaction()
                await tr.get_read_version()
                served += 1
            assert served > 50, served
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_dead_storage_throttles_admission():
    """With a shard dead (auto-reboot off), the ratekeeper drops the
    budget to a trickle: GRV admission — and therefore the TLog's
    unpopped backlog — stays bounded instead of growing with demand
    ."""
    c = SimCluster(seed=409, durable=True, auto_reboot=False)
    try:
        db = c.client()

        async def main():
            async def body(tr):
                tr.set(b"x", b"1")
            await run_transaction(db, body)
            c.kill_role("storage")
            await flow.delay(0.3)   # let the ratekeeper notice

            served = [0]

            async def flood(cl):
                end = flow.now() + 2.0
                while flow.now() < end:
                    tr = cl.create_transaction()
                    try:
                        await flow.timeout_error(
                            flow.spawn(tr.get_read_version()), 3.0)
                        served[0] += 1
                    except flow.FdbError:
                        return
            clients = [c.client(f"fl{i}") for i in range(10)]
            await flow.wait_for_all([flow.spawn(flood(cl))
                                     for cl in clients])
            # trickle: ~10 tps * 2s, plus scheduling slack — nowhere
            # near the hundreds/second a healthy cluster serves
            assert served[0] <= 60, served[0]
            logs = c.cc.tlog_objs()
            assert logs and all(len(t.entries) < 1000 for t in logs)
            return True

        assert c.run(main(), timeout_time=300)
    finally:
        c.shutdown()


def test_grv_priority_classes():
    """BATCH priority is throttled first when the rate budget runs dry;
    IMMEDIATE bypasses the gate entirely (ref: TransactionPriority +
    the per-class budgets in transactionStarter/Ratekeeper)."""
    from foundationdb_tpu_torch.server.proxy import Proxy

    c = SimCluster(seed=61)
    try:
        db = c.client()

        async def main():
            await db.info()   # wait for recruitment
            # choke the admission rate at its SOURCE — the proxies
            # re-poll the ratekeeper every 100ms, so patching their
            # cached copy alone would be overwritten
            from foundationdb_tpu_torch.server.ratekeeper import Ratekeeper
            proxies = [role for wi in c.cc.workers.values()
                       for role in wi.worker.roles.values()
                       if isinstance(role, Proxy)]
            for wi in c.cc.workers.values():
                for role in wi.worker.roles.values():
                    if isinstance(role, Ratekeeper):
                        role._compute_rates = lambda: (0.0, 0.0)
            for p in proxies:
                p._rate = 0.0
                p._batch_rate = 0.0
            await flow.delay(0.3)   # let the zero rate propagate

            tr_b = db.create_transaction()
            tr_b.set_option("priority_batch")
            tr_i = db.create_transaction()
            tr_i.set_option("priority_system_immediate")

            # immediate sails through a zero-rate gate
            fi = flow.spawn(tr_i.get_read_version())
            fb = flow.spawn(tr_b.get_read_version())
            await flow.delay(1.0)
            assert fi.is_ready and not fi.is_error
            assert not fb.is_ready          # batch is throttled

            # restoring the budget (at the source) releases the batch
            for wi in c.cc.workers.values():
                for role in wi.worker.roles.values():
                    if isinstance(role, Ratekeeper):
                        role._compute_rates = lambda: (1e9, 1e9)
            for p in proxies:
                p._rate = 1e9
                p._batch_rate = 1e9
            await flow.delay(1.0)
            assert fb.is_ready and not fb.is_error
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_spring_zone_and_batch_limits():
    """Unit-level controller shape (ref: updateRate's spring zones):
    full speed below the zone, linear decay inside, trickle above —
    and the batch limit collapses before the default limit."""
    from foundationdb_tpu_torch.server.ratekeeper import Ratekeeper

    k = flow.SERVER_KNOBS
    mx, mn = k.rk_max_rate, k.rk_min_rate
    sl = Ratekeeper._spring_limit
    assert sl(0, 1000, 200, mx, mn) == mx             # far below target
    assert sl(799, 1000, 200, mx, mn) == mx           # at the zone edge
    mid = sl(900, 1000, 200, mx, mn)
    assert mn < mid < mx                              # inside the zone
    assert sl(1000, 1000, 200, mx, mn) == mn          # at target
    assert sl(5000, 1000, 200, mx, mn) == mn          # above target
    # monotone decay through the zone
    assert sl(850, 1000, 200, mx, mn) > sl(950, 1000, 200, mx, mn)


def test_batch_throttles_before_default_under_storage_queue():
    """With a storage queue held between the batch target and the
    default target, the ratekeeper publishes batch_tps < tps, and the
    proxy's gate throttles ONLY batch traffic."""
    c = SimCluster(seed=415)
    try:
        db = c.client()

        async def main():
            async def body(tr):
                tr.set(b"x", b"1")
            await run_transaction(db, body)

            # hold the smoothed storage queue between the two targets:
            # batch target = target * fraction < q < target - spring
            from foundationdb_tpu_torch.server.ratekeeper import Ratekeeper
            k = flow.SERVER_KNOBS
            k.set("RK_TARGET_STORAGE_QUEUE_BYTES", 1000)
            k.set("RK_SPRING_STORAGE_QUEUE_BYTES", 100)
            k.set("RK_BATCH_TARGET_FRACTION", 0.5)
            k.set("RK_SMOOTHING_SECONDS", 0.0)   # no lag in the test
            rk = None
            for wi in c.cc.workers.values():
                for role in wi.worker.roles.values():
                    if isinstance(role, Ratekeeper):
                        rk = role
            assert rk is not None
            # fabricate the queue reading: 700 bytes pending
            from foundationdb_tpu_torch.server.types import (MutationRef,
                                                       SET_VALUE)
            for obj in c.cc._storage_objs.values():
                obj._pending = [(1, tuple(
                    MutationRef(SET_VALUE, b"k" * 10, b"v" * 340)
                    for _ in range(2)))]
            rk._storage_smooth.clear()   # fresh, unsmoothed read
            rate, batch = rk._compute_rates()
            assert batch < rate, (batch, rate)
            assert rate == k.rk_max_rate      # default unthrottled
            assert batch == k.rk_min_rate     # above the batch target
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        flow.reset_server_knobs(randomize=False)
        c.shutdown()


def test_smoothing_decays_spikes():
    from foundationdb_tpu_torch.server.ratekeeper import Smoother
    s = Smoother()
    assert s.sample(1000.0, 0.0, 1.0) == 1000.0
    # the sample decays toward a new level with tau=1s
    v1 = s.sample(0.0, 1.0, 1.0)
    assert 300 < v1 < 400        # 1000 * e^-1 ~ 368
    v2 = s.sample(0.0, 4.0, 1.0)
    assert v2 < 25               # mostly forgotten after 3 more taus
