"""The reference's conflict-window cache cases
(tests/test_conflict_window_cache.py) on the port's SimCluster.

Client-side conflict-window cache (server/scheduler.py ConflictWindowCache + client/transaction.py early
abort): staleness expiry, survival across on_error, the GRV piggyback
plumbing end to end, and the indistinguishability contract — a
cache-driven early abort must look exactly like a resolver abort to
retry loops, reporting, and profiling.

Ref: *Early Detection for MVCC Conflicts in Hyperledger Fabric*
(PAPERS.md) — abort doomed transactions before commit submission.
"""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.client import run_transaction  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402
from foundationdb_tpu_torch.server.scheduler import (ConflictWindowCache,  # noqa: E402
                                               client_window_counters)

HOT = (b"hot", b"hot\x00")


def _env():
    flow.set_seed(0)
    s = flow.Scheduler()
    flow.set_scheduler(s)
    flow.reset_server_knobs(randomize=False)
    return s


def _teardown():
    flow.reset_server_knobs(randomize=False)
    flow.set_scheduler(None)


# -- unit: the cache itself --------------------------------------------

def test_window_staleness_expiry():
    _env()
    try:
        flow.SERVER_KNOBS.set("conflict_window_ttl", 2.0)
        cache = ConflictWindowCache()
        cache.update([(b"hot", b"hot\x00", 500)], now=10.0)
        # fresh + snapshot below the window version -> doomed
        assert cache.doomed([HOT], snapshot=100, now=10.5) == (HOT,)
        # snapshot at/after the window's last conflict -> clean
        assert cache.doomed([HOT], snapshot=500, now=10.5) == ()
        # non-overlapping read -> clean
        assert cache.doomed([(b"cold", b"cold\x00")], 100, 10.5) == ()
        # past the TTL the window expires — and is physically dropped
        assert cache.doomed([HOT], snapshot=100, now=12.5) == ()
        assert cache.live_rows(12.5) == ()
        # a later update repopulates (wholesale replacement)
        cache.update([(b"hot", b"hot\x00", 900)], now=20.0)
        assert cache.doomed([HOT], snapshot=100, now=20.1) == (HOT,)
    finally:
        _teardown()


def test_window_ttl_knob_is_live_read():
    _env()
    try:
        flow.SERVER_KNOBS.set("conflict_window_ttl", 0.1)
        cache = ConflictWindowCache()
        cache.update([(b"hot", b"hot\x00", 500)], now=0.0)
        assert cache.doomed([HOT], 100, 0.05) == (HOT,)
        assert cache.doomed([HOT], 100, 0.2) == ()
    finally:
        _teardown()


# -- end to end: GRV piggyback + early abort ---------------------------

def _heat_and_refresh(db):
    """Produce real conflicts on b"hot" so the resolver attributes
    them, wait for the CC push, then refresh the client cache via a
    fresh GRV."""
    async def inner():
        async def seed(tr):
            tr.set(b"hot", b"0")
        await run_transaction(db, seed)
        for _ in range(6):
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
        await flow.delay(0.3)        # CC hot push lands at the proxy
        probe = db.create_transaction()
        await probe.get_read_version()   # windows ride THIS reply
    return inner


def test_windows_ride_grv_and_early_abort_end_to_end():
    """Full stack: conflicts heat the table, the CC pushes windows,
    they ride a GRV reply into the Database cache, and a stale-
    snapshot transaction overlapping the window aborts CLIENT-side —
    the proxy's conflict counter does not move."""
    c = SimCluster(seed=921, durable=True)
    flow.SERVER_KNOBS.set("client_conflict_windows", 1)
    flow.SERVER_KNOBS.set("sched_hot_push_interval", 0.05)
    flow.SERVER_KNOBS.set("conflict_window_score_min", 0.1)
    try:
        db = c.client()

        async def main():
            # the victim takes its snapshot FIRST
            victim = db.create_transaction()
            victim.set_option("report_conflicting_keys")
            await victim.get_read_version()
            await _heat_and_refresh(db)()
            assert db._conflict_cache is not None, \
                "windows never reached the client cache"
            assert db._conflict_cache._rows, "cache empty after refresh"
            before = (await db.get_status())["cluster"]["proxies"][0][
                "counters"].get("transactions_conflicted", 0)
            ca_before = client_window_counters().get("early_aborts", 0)
            await victim.get(b"hot")
            victim.set(b"w", b"v")
            try:
                await victim.commit()
                raise AssertionError("expected early abort")
            except flow.FdbError as e:
                assert e.name == "not_committed", e.name
            # reporting surface matches the resolver-abort shape
            assert victim.get_conflicting_ranges() == (HOT,), \
                victim.get_conflicting_ranges()
            after = (await db.get_status())["cluster"]["proxies"][0][
                "counters"].get("transactions_conflicted", 0)
            ca_after = client_window_counters().get("early_aborts", 0)
            # the abort was client-side: no proxy/resolver involvement
            assert after == before, (before, after)
            assert ca_after == ca_before + 1, (ca_before, ca_after)
            status = await db.get_status()
            return status

        status = c.run(main(), timeout_time=300)
        client = status["cluster"]["conflict_scheduling"]["client"]
        assert client.get("early_aborts", 0) >= 1, client
        assert client.get("windows_cached", 0) >= 1, client
    finally:
        flow.reset_server_knobs(randomize=False)
        c.shutdown()


def test_cache_survives_on_error_and_retry_succeeds():
    """The cache is Database-scoped: on_error's reset cannot drop it;
    the RETRY attempt (fresh snapshot, newer than the window) then
    commits — the retry-loop experience is identical to recovering
    from a resolver conflict."""
    c = SimCluster(seed=922, durable=True)
    flow.SERVER_KNOBS.set("client_conflict_windows", 1)
    flow.SERVER_KNOBS.set("sched_hot_push_interval", 0.05)
    flow.SERVER_KNOBS.set("conflict_window_score_min", 0.1)
    try:
        db = c.client()

        async def main():
            victim = db.create_transaction()
            await victim.get_read_version()
            await _heat_and_refresh(db)()
            cache = db._conflict_cache
            assert cache is not None and cache._rows
            await victim.get(b"hot")
            victim.set(b"w", b"v")
            try:
                await victim.commit()
                raise AssertionError("expected early abort")
            except flow.FdbError as e:
                await victim.on_error(e)     # retryable, like any abort
            # the DB cache survived the transaction reset
            assert db._conflict_cache is cache
            assert cache._rows
            # the retry's fresh snapshot postdates the window: commits
            await victim.get(b"hot")
            victim.set(b"w", b"v2")
            await victim.commit()

            async def read(tr):
                return await tr.get(b"w")
            assert await run_transaction(db, read) == b"v2"
            return True

        assert c.run(main(), timeout_time=300)
    finally:
        flow.reset_server_knobs(randomize=False)
        c.shutdown()


def test_early_abort_indistinguishable_to_profiling():
    """A sampled transaction whose commit early-aborts must record the
    SAME conflicted CommitEvent a resolver abort records — the
    profiling pipeline cannot tell the two apart."""
    from foundationdb_tpu_torch.client.profiling import CommitEvent
    c = SimCluster(seed=923, durable=True)
    flow.SERVER_KNOBS.set("client_conflict_windows", 1)
    flow.SERVER_KNOBS.set("sched_hot_push_interval", 0.05)
    flow.SERVER_KNOBS.set("conflict_window_score_min", 0.1)
    try:
        db = c.client()

        async def main():
            victim = db.create_transaction()
            victim.set_option("transaction_logging_enable", "early")
            victim.set_option("report_conflicting_keys")
            await victim.get_read_version()
            await _heat_and_refresh(db)()
            await victim.get(b"hot")
            victim.set(b"w", b"v")
            try:
                await victim.commit()
                raise AssertionError("expected early abort")
            except flow.FdbError as e:
                assert e.name == "not_committed", e.name
            commits = [ev for ev in victim._profile.events
                       if isinstance(ev, CommitEvent)]
            assert commits, victim._profile.events
            ev = commits[-1]
            assert ev.verdict == "conflicted", ev
            assert ev.version == 0, ev
            assert ev.conflicting_ranges == (HOT,), ev
            return True

        assert c.run(main(), timeout_time=300)
    finally:
        flow.reset_server_knobs(randomize=False)
        c.shutdown()


def test_windows_off_by_default_reply_is_bare():
    """With CLIENT_CONFLICT_WINDOWS off (the default), GRV replies
    carry no windows, the cache is never created, and commit pays
    nothing."""
    c = SimCluster(seed=924, durable=True)
    try:
        db = c.client()

        async def main():
            async def body(tr):
                tr.set(b"k", b"v")
            await run_transaction(db, body)
            assert db._conflict_cache is None
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()
