"""The reference's system-keyspace cases (tests/test_system_keyspace.py)
on the port's SimCluster and bindings (fdb.api_version). \xff system
keyspace.

Ref: fdbclient/SystemData.cpp (keyServers/, conf/, excluded/ prefixes),
system-key write protection (key_outside_legal_range without
ACCESS_SYSTEM_KEYS).
"""

import pytest

torch = pytest.importorskip("torch")

import foundationdb_tpu_torch.bindings as fdb  # noqa: E402
from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.client import run_transaction  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402


def test_system_keyspace_reads_and_write_protection():
    c = SimCluster(seed=51, n_storage=2, storage_replicas=2)
    try:
        db = c.client()

        async def main():
            async def seed(tr):
                tr.set(b"user", b"row")
            await run_transaction(db, seed)

            tr = db.create_transaction()
            # \xff reads are gated (ref: key_outside_legal_range
            # without READ/ACCESS_SYSTEM_KEYS)
            with pytest.raises(flow.FdbError) as ei:
                await tr.get(b"\xff/keyServers/user")
            assert ei.value.name == "key_outside_legal_range"
            with pytest.raises(flow.FdbError):
                await tr.get_range(b"\xff/conf/", b"\xff/conf0")
            tr.set_option("read_system_keys")
            # keyServers: one row per shard, value = the replica team
            rows = await tr.get_range(b"\xff/keyServers/",
                                      b"\xff/keyServers0")
            assert len(rows) == 2
            assert rows[0][0] == b"\xff/keyServers/"
            for _k, team in rows:
                assert len(team.split(b",")) == 2
            # point lookup: the team owning an arbitrary user key
            team = await tr.get(b"\xff/keyServers/user")
            assert team == rows[0][1] or team == rows[1][1]

            # conf rows are REAL stored rows now, seeded by the CC
            # after recovery — poll with fresh
            # read versions until the seed transaction lands
            for _ in range(100):
                tr2 = db.create_transaction()
                tr2.set_option("read_system_keys")
                conf = dict(await tr2.get_range(b"\xff/conf/",
                                                b"\xff/conf0"))
                if conf:
                    break
                await flow.delay(0.2)
            assert conf[b"\xff/conf/storage_shards"] == b"2"
            assert conf[b"\xff/conf/proxies"] == b"1"

            # exclusion shows up under \xff/excluded/ — committed data,
            # so a FRESH read version is needed to observe it
            info = c.cc.dbinfo.get()
            victim = None
            for name, wi in c.cc.workers.items():
                if not any(rn.startswith(("storage", "tlog", "proxy",
                                          "resolver", "ratekeeper"))
                           for rn in wi.worker.roles):
                    victim = name
                    break
            if victim is not None:
                await db.exclude(victim)
                tr3 = db.create_transaction()
                tr3.set_option("read_system_keys")
                rows = await tr3.get_range(b"\xff/excluded/",
                                           b"\xff/excluded0")
                assert (b"\xff/excluded/" + victim.encode(), b"") in rows

            # system keys are write-protected
            with pytest.raises(flow.FdbError) as ei:
                tr.set(b"\xff/conf/proxies", b"9")
            assert ei.value.name == "key_outside_legal_range"
            with pytest.raises(flow.FdbError):
                tr.clear_range(b"\xff", b"\xff\xff")
            with pytest.raises(flow.FdbError):
                tr.atomic_op(b"\xff/x", b"\x01", 2)

            # the user-space scan convention b"" .. b"\xff" is untouched
            user = await tr.get_range(b"", b"\xff")
            assert user == [(b"user", b"row")]
            # with the option, a scan crossing the \xff boundary sees
            # the same materialized rows an \xff-anchored scan serves
            crossing = await tr.get_range(b"", b"\xff/keyServers0")
            assert (b"user", b"row") in crossing
            anchored = await tr.get_range(b"\xff/keyServers/",
                                          b"\xff/keyServers0")
            for row in anchored:
                assert row in crossing
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_api_version_selection():
    fdb._selected_api_version = None
    with pytest.raises(RuntimeError):
        fdb.api_version(200)     # out of range
    fdb.api_version(710)
    fdb.api_version(710)         # idempotent re-selection is fine
    with pytest.raises(RuntimeError):
        fdb.api_version(630)     # conflicting re-selection is not
    fdb._selected_api_version = None


def test_clear_range_cannot_reach_system_space():
    """A clear whose END crosses \xff must be rejected — it would wipe
    the storage engine's own \xff\xff metadata."""
    c = SimCluster(seed=52, durable=True)
    try:
        db = c.client()

        async def main():
            tr = db.create_transaction()
            tr.set(b"safe", b"1")
            await tr.commit()
            tr.reset()
            with pytest.raises(flow.FdbError) as ei:
                tr.clear_range(b"b", b"\xff\xffzz")
            assert ei.value.name == "key_outside_legal_range"
            # the legal full-wipe bound is untouched
            tr.clear_range(b"", b"\xff")
            await tr.commit()
            return True

        assert c.run(main(), timeout_time=60)
    finally:
        c.shutdown()


def test_access_system_keys_option_and_stored_subspace():
    """ACCESS_SYSTEM_KEYS admits \xff\x02 stored-system writes (the
    latency-probe subspace); without it they reject; \xff\xff engine
    space rejects always; user scans never see system rows."""
    c = SimCluster(seed=53, durable=True)
    try:
        db = c.client()

        async def main():
            tr = db.create_transaction()
            with pytest.raises(flow.FdbError):
                tr.set(b"\xff\x02/own", b"x")       # no option
            tr.set_option("access_system_keys")
            tr.set(b"\xff\x02/own", b"x")           # option: allowed
            with pytest.raises(flow.FdbError):
                tr.set(b"\xff\xff/engine", b"x")    # never
            tr.set(b"user", b"1")
            await tr.commit()

            tr2 = db.create_transaction()
            tr2.set_option("read_system_keys")
            assert await tr2.get(b"\xff\x02/own") == b"x"  # stored read
            rows = await tr2.get_range(b"", b"\xff")
            assert rows == [(b"user", b"1")]        # user scan is clean
            # a plain scan whose end crosses \xff is rejected outright
            # (ref: validateKeyRange — no silent leak of stored rows
            # through the last shard's open end)
            tr3 = db.create_transaction()
            with pytest.raises(flow.FdbError) as ei:
                await tr3.get_range(b"", b"\xff\xf0")
            assert ei.value.name == "key_outside_legal_range"
            # selectors can't walk into stored system space either
            from foundationdb_tpu_torch.server.types import KeySelector
            k = await tr3.get_key(KeySelector(b"zzz", False, 5))
            assert k == b"\xff"
            # ...but the canonical last_less_than(\xff) "last key"
            # idiom stays legal without any option
            k = await tr3.get_key(KeySelector(b"\xff", False, 0))
            assert k == b"user"
            # a stored-subspace scan anchored ABOVE \xff\x02 must not
            # return rows below its begin
            tr4 = db.create_transaction()
            tr4.set_option("read_system_keys")
            rows = await tr4.get_range(b"\xff\x03", b"\xff\x10")
            assert all(k >= b"\xff\x03" for k, _v in rows), rows
            # option state resets with the transaction
            tr2.reset()
            with pytest.raises(flow.FdbError):
                tr2.set(b"\xff\x02/own", b"y")
            return True

        assert c.run(main(), timeout_time=60)
    finally:
        c.shutdown()


def test_timeout_and_retry_limit_options():
    """TIMEOUT bounds the whole retry loop; RETRY_LIMIT caps on_error
    resets (ref: fdb_transaction_set_option TIMEOUT/RETRY_LIMIT — the
    options survive resets so the loop actually terminates)."""
    c = SimCluster(seed=54)
    try:
        db = c.client()

        async def main():
            # retry_limit: a perpetually-conflicting transaction stops
            # after exactly N retries
            tr = db.create_transaction()
            tr.set_option("retry_limit", 3)
            attempts = [0]
            for _ in range(50):
                attempts[0] += 1
                await tr.get(b"rl")
                # sabotage: commit something conflicting from the side
                side = db.create_transaction()
                side.set(b"rl", b"x%d" % attempts[0])
                await side.commit()
                tr.set(b"rl", b"mine")
                try:
                    await tr.commit()
                    raise AssertionError("should have conflicted")
                except flow.FdbError as e:
                    assert e.name == "not_committed"
                    try:
                        await tr.on_error(e)
                    except flow.FdbError as e2:
                        assert e2.name == "not_committed"
                        break
            else:
                raise AssertionError("retry_limit never enforced")
            assert attempts[0] == 4  # initial + 3 retries

            # timeout: the loop dies with transaction_timed_out once the
            # deadline passes, regardless of retryable errors
            # the deadline can surface from on_error OR clip any
            # in-flight operation directly (the reference's semantics:
            # every pending future errors with transaction_timed_out)
            tr2 = db.create_transaction()
            tr2.set_option("timeout", 0.5)
            for _ in range(100):
                try:
                    await tr2.get(b"to")
                    side = db.create_transaction()
                    side.set(b"to", b"y")
                    await side.commit()
                    tr2.set(b"to", b"mine")
                    await tr2.commit()
                    raise AssertionError("should have conflicted")
                except flow.FdbError as e:
                    if e.name == "transaction_timed_out":
                        return True
                    try:
                        await tr2.on_error(e)
                    except flow.FdbError as e2:
                        assert e2.name == "transaction_timed_out"
                        return True
            raise AssertionError("timeout never enforced")

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()
