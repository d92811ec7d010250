"""The reference's conflict-scheduler cases
(tests/test_conflict_scheduler.py) on the port. Conflict prediction &
admission scheduling (server/scheduler.py): the ConflictHotSpots
live-knob audit, the
predictor's probability math, the proxy's deferral queues (bounds,
priority order, release-marker round trip), the CC hot-spot push loop,
and the ratekeeper's deferral-pressure throttle input.

Ref: arXiv:2409.01675 (conflict-prediction scheduling); the hot-spot
table is the resolvers' attribution aggregate turned actionable.
"""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.client import run_transaction  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402
from foundationdb_tpu_torch.server.resolver_role import ConflictHotSpots  # noqa: E402
from foundationdb_tpu_torch.server.scheduler import (AdmissionScheduler,  # noqa: E402
                                               ConflictPredictor)
from foundationdb_tpu_torch.server.types import (PRIORITY_BATCH,  # noqa: E402
                                           PRIORITY_DEFAULT,
                                           PRIORITY_IMMEDIATE,
                                           CommitRequest, MutationRef,
                                           SET_VALUE)


def _sched_env():
    flow.set_seed(0)
    s = flow.Scheduler()
    flow.set_scheduler(s)
    flow.reset_server_knobs(randomize=False)
    return s


def _teardown():
    flow.reset_server_knobs(randomize=False)
    flow.set_scheduler(None)


# -- ConflictHotSpots live-read knobs ----------------------------------

def test_hot_spots_half_life_is_live_read():
    """As in the Smoother, the half-life must be read
    per use, not frozen at construction — a SimCluster (or operator)
    retuning HOT_SPOT_HALF_LIFE must change the decay immediately."""
    _sched_env()
    try:
        k = flow.SERVER_KNOBS
        k.set("hot_spot_half_life", 2.0)
        hs = ConflictHotSpots()          # defaults -> live knob reads
        assert hs._decayed(100.0, 0.0, 2.0) == pytest.approx(50.0)
        k.set("hot_spot_half_life", 4.0)  # retune AFTER construction
        assert hs.half_life == 4.0
        assert hs._decayed(100.0, 0.0, 4.0) == pytest.approx(50.0)
        assert hs._decayed(100.0, 0.0, 2.0) == pytest.approx(
            100.0 * 0.5 ** 0.5)
        # an explicit construction pin still wins (directed tests and
        # the legacy signature rely on it)
        pinned = ConflictHotSpots(half_life=1.0)
        k.set("hot_spot_half_life", 100.0)
        assert pinned.half_life == 1.0
    finally:
        _teardown()


def test_hot_spots_capacity_and_top_k_are_live_read():
    _sched_env()
    try:
        k = flow.SERVER_KNOBS
        k.set("hot_spot_max_entries", 64)
        hs = ConflictHotSpots()
        for i in range(6):
            hs.record(b"k%d" % i, b"k%d\x00" % i)
        assert len(hs._entries) == 6
        # shrink the capacity knob: the NEXT record drains the excess
        k.set("hot_spot_max_entries", 3)
        hs.record(b"k9", b"k9\x00")
        assert len(hs._entries) == 3
        k.set("hot_spot_top_k", 2)
        assert len(hs.top()) == 2       # top() live-reads top-K
    finally:
        _teardown()


def test_hot_spots_rows_carry_last_conflict_version():
    _sched_env()
    try:
        hs = ConflictHotSpots(half_life=10.0)
        hs.record(b"a", b"b", version=100)
        hs.record(b"a", b"b", version=700)
        hs.record(b"a", b"b", version=400)   # never regresses
        rows = hs.rows()
        assert rows[0][0] == b"a" and rows[0][4] == 700
        # top() output shape is unchanged (status/exporter consumers)
        assert set(hs.top()[0]) == {"begin", "end", "score", "total"}
    finally:
        _teardown()


# -- predictor ----------------------------------------------------------

def test_predictor_probability_math():
    _sched_env()
    try:
        flow.SERVER_KNOBS.set("sched_hot_score_scale", 5.0)
        p = ConflictPredictor()
        p.update([(b"a", b"b", 5.0, 10, 7), (b"x", b"y", 95.0, 10, 9)],
                 0.0)
        # score==scale -> 0.5 per range; non-overlapping -> 0
        prob, hot = p.score([(b"a", b"a\x00")])
        assert prob == pytest.approx(0.5) and hot == (b"a", b"b")
        prob, hot = p.score([(b"m", b"n")])
        assert prob == 0.0 and hot is None
        # overlapping both: 1 - 0.5*0.05; hottest range wins the key
        prob, hot = p.score([(b"a", b"a\x00"), (b"x", b"x\x00")])
        assert prob == pytest.approx(1 - 0.5 * 0.05)
        assert hot == (b"x", b"y")
    finally:
        _teardown()


# -- admission scheduler ------------------------------------------------

def _req(prio=PRIORITY_DEFAULT, attempt=0):
    return CommitRequest(0, ((b"a", b"a\x00"),), (),
                         (MutationRef(SET_VALUE, b"a", b"v"),),
                         priority=prio, repair_attempt=attempt)


class _Proc:
    name = "p0"


def test_scheduler_defers_bounds_and_priority_order():
    s = _sched_env()
    try:
        k = flow.SERVER_KNOBS
        k.set("conflict_scheduling", 1)
        k.set("sched_conflict_threshold", 0.5)
        k.set("sched_queue_max", 2)
        k.set("sched_release_spacing", 0.001)
        k.set("sched_max_delay", 1.0)
        stats = flow.CounterCollection("proxy")
        released = []
        sched = AdmissionScheduler(
            _Proc(), stats, lambda req, reply: released.append(reply))
        sched.predictor.update([(b"a", b"b", 100.0, 10, 5)], 0.0)
        r_batch, r_def, r_over = object(), object(), object()
        # IMMEDIATE and repair resubmissions never defer
        assert not sched.consider(_req(PRIORITY_IMMEDIATE), object())
        assert not sched.consider(_req(attempt=1), object())
        assert sched.consider(_req(PRIORITY_BATCH), r_batch)
        assert sched.consider(_req(), r_def)
        assert sched.queue_depth() == 2
        # queue cap -> bounded-delay overflow: admitted immediately
        assert not sched.consider(_req(), r_over)
        assert stats.snapshot()["sched_overflow"] == 1

        async def drain():
            await flow.delay(0.1)
        s.run(until=flow.spawn(drain()))
        # default released before batch (priority-aware), both out
        assert released == [r_def, r_batch]
        assert sched.queue_depth() == 0
        # the release marker makes the round trip admit exactly once
        assert not sched.consider(_req(), r_def)
        assert sched.consider(_req(), r_def)
    finally:
        _teardown()


def test_scheduler_off_or_cold_predictor_never_defers():
    _sched_env()
    try:
        k = flow.SERVER_KNOBS
        stats = flow.CounterCollection("proxy")
        sched = AdmissionScheduler(_Proc(), stats,
                                   lambda req, reply: None)
        # knob off (default): no deferral even with a hot predictor
        sched.predictor.update([(b"a", b"b", 100.0, 10, 5)], 0.0)
        k.set("conflict_scheduling", 0)
        assert not sched.consider(_req(), object())
        # knob on but cold predictor: nothing to key a queue on
        k.set("conflict_scheduling", 1)
        sched.predictor.update([], 0.0)
        assert not sched.consider(_req(), object())
        assert stats.snapshot().get("sched_deferrals", 0) == 0
    finally:
        _teardown()


def test_scheduler_shutdown_breaks_held_commits():
    _sched_env()
    try:
        k = flow.SERVER_KNOBS
        k.set("conflict_scheduling", 1)
        k.set("sched_release_spacing", 10.0)   # hold them
        k.set("sched_max_delay", 100.0)
        stats = flow.CounterCollection("proxy")
        sched = AdmissionScheduler(_Proc(), stats,
                                   lambda req, reply: None)
        sched.predictor.update([(b"a", b"b", 100.0, 10, 5)], 0.0)
        errs = []

        class _Reply:
            def send_error(self, e):
                errs.append(e.name)
        assert sched.consider(_req(), _Reply())
        sched.shutdown()
        assert errs == ["broken_promise"]
        assert sched.queue_depth() == 0
    finally:
        _teardown()


# -- end to end: deferral under real contention ------------------------

def test_scheduler_defers_under_contention_and_liveness_holds():
    """With scheduling armed, a burst of hot-key commits gets deferred
    (counters + status prove it) and every transaction still settles —
    bounded delay means deferral can never wedge a commit."""
    c = SimCluster(seed=808, durable=True)
    flow.SERVER_KNOBS.set("conflict_scheduling", 1)
    flow.SERVER_KNOBS.set("sched_hot_push_interval", 0.05)
    flow.SERVER_KNOBS.set("sched_conflict_threshold", 0.3)
    try:
        db = c.client()

        async def main():
            async def seed(tr):
                tr.set(b"hot", b"0")
            await run_transaction(db, seed)
            # heat the table: repeated conflicts on b"hot"
            for _ in range(8):
                tr = db.create_transaction()
                await tr.get(b"hot")
                tr.set(b"mine", b"v")

                async def bump(t2):
                    t2.set(b"hot", b"x")
                await run_transaction(db, bump)
                try:
                    await tr.commit()
                except flow.FdbError as e:
                    assert e.name == "not_committed", e.name
            await flow.delay(0.3)   # pushes land at the proxy
            # now a conflicting-range commit gets deferred yet commits
            done = 0
            for i in range(6):
                async def body(tr, i=i):
                    await tr.get(b"hot")
                    tr.set(b"hot", b"w%d" % i)
                await run_transaction(db, body)
                done += 1
            status = await db.get_status()
            return done, status

        done, status = c.run(main(), timeout_time=300)
        assert done == 6
        px = status["cluster"]["proxies"][0]
        sched = px["scheduler"]
        assert sched["enabled"] == 1
        assert sched["pushes"] > 0, sched
        assert sched["hot_rows"] > 0, sched
        assert sched["deferrals"] > 0, sched
        assert sched["released"] == sched["deferrals"], sched
        assert sched["deferred_now"] == 0, sched
        doc = status["cluster"]["conflict_scheduling"]
        assert doc["scheduling_enabled"] == 1 and doc["deferrals"] > 0
    finally:
        flow.reset_server_knobs(randomize=False)
        c.shutdown()


# -- ratekeeper deferral-pressure input --------------------------------

def test_ratekeeper_throttles_on_deferral_pressure():
    """A deep deferred-commit queue becomes a first-class limiting
    reason: spring-zone throttle over the smoothed depth, reported as
    conflict_deferrals in the decision (and RkUpdate/qos mirrors)."""
    from foundationdb_tpu_torch.server.ratekeeper import LIMIT_REASONS, Ratekeeper
    assert "conflict_deferrals" in LIMIT_REASONS
    c = SimCluster(seed=809, durable=True)
    try:
        db = c.client()

        async def main():
            async def body(tr):
                tr.set(b"x", b"1")
            await run_transaction(db, body)
            k = flow.SERVER_KNOBS
            k.set("rk_sched_defer_limit", 4.0)
            k.set("rk_sched_defer_spring", 2.0)
            k.set("rk_smoothing_seconds", 0.0)
            rk = None
            from foundationdb_tpu_torch.server.proxy import Proxy
            for wi in c.cc.workers.values():
                for role in wi.worker.roles.values():
                    if isinstance(role, Ratekeeper):
                        rk = role
                    elif isinstance(role, Proxy):
                        role.scheduler._depth = 10   # fabricated depth
            assert rk is not None
            rk._sched_smooth.clear()
            rate, _batch = rk._compute_rates()
            d = rk.last_decision
            assert d["limiting_reason"] == "conflict_deferrals", d
            assert d["inputs"]["sched_deferred_depth"] == 10, d
            assert rate == k.rk_min_rate, rate
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        flow.reset_server_knobs(randomize=False)
        c.shutdown()
