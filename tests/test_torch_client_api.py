"""The reference's client API cases (tests/test_client_api.py) on the
port's client and SimCluster. Client API surface: atomic ops, key selectors, watches, reverse
ranges, versionstamps (ref workloads: AtomicOps.actor.cpp,
WatchAndWait.actor.cpp, SelectorCorrectness.actor.cpp; semantics:
fdbclient/Atomic.h)."""

import struct

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.client import run_transaction  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402
from foundationdb_tpu_torch.server.types import (ADD_VALUE, AND, APPEND_IF_FITS,  # noqa: E402
                                           BYTE_MAX, BYTE_MIN,
                                           COMPARE_AND_CLEAR, KeySelector,
                                           MAX, MIN, OR,
                                           SET_VERSIONSTAMPED_KEY,
                                           SET_VERSIONSTAMPED_VALUE, XOR)


@pytest.fixture
def cluster():
    c = SimCluster(seed=5)
    yield c
    c.shutdown()


def le8(n):
    return struct.pack("<q", n)


def test_atomic_add(cluster):
    db = cluster.client()

    async def main():
        tr = db.create_transaction()
        tr.atomic_op(b"ctr", le8(5), ADD_VALUE)
        await tr.commit()
        tr = db.create_transaction()
        tr.atomic_op(b"ctr", le8(7), ADD_VALUE)
        # RYW: the computed value is visible before commit
        assert struct.unpack("<q", await tr.get(b"ctr"))[0] == 12
        await tr.commit()
        tr = db.create_transaction()
        assert struct.unpack("<q", await tr.get(b"ctr"))[0] == 12
        return True

    assert cluster.run(main(), timeout_time=30)


def test_atomic_concurrent_adds_all_count(cluster):
    """Blind atomic adds never conflict; all increments land
    (ref: AtomicOps workload invariant)."""
    dbs = [cluster.client(f"c{i}") for i in range(4)]

    async def add_loop(db, n):
        for _ in range(n):
            async def body(tr):
                tr.atomic_op(b"sum", le8(1), ADD_VALUE)
            await run_transaction(db, body)

    async def main():
        await flow.wait_for_all([flow.spawn(add_loop(d, 10)) for d in dbs])
        tr = dbs[0].create_transaction()
        assert struct.unpack("<q", await tr.get(b"sum"))[0] == 40
        return True

    assert cluster.run(main(), timeout_time=120)


def test_atomic_ops_matrix(cluster):
    db = cluster.client()

    async def main():
        cases = [
            (AND, b"\x0f\xff", b"\xf1\x10", b"\x01\x10"),
            (OR, b"\x0f\x00", b"\xf1\x10", b"\xff\x10"),
            (XOR, b"\x0f\xff", b"\xf1\x10", b"\xfe\xef"),
            (MAX, le8(10), le8(7), le8(10)),
            (MIN, le8(10), le8(7), le8(7)),
            (BYTE_MIN, b"abc", b"abd", b"abc"),
            (BYTE_MAX, b"abc", b"abd", b"abd"),
            (APPEND_IF_FITS, b"foo", b"bar", b"foobar"),
        ]
        for i, (op, initial, param, want) in enumerate(cases):
            k = b"mx%d" % i
            tr = db.create_transaction()
            tr.set(k, initial)
            await tr.commit()
            tr = db.create_transaction()
            tr.atomic_op(k, param, op)
            await tr.commit()
            tr = db.create_transaction()
            got = await tr.get(k)
            assert got == want, (i, op, got, want)
        # compare-and-clear
        tr = db.create_transaction()
        tr.set(b"cc", b"x")
        await tr.commit()
        tr = db.create_transaction()
        tr.atomic_op(b"cc", b"y", COMPARE_AND_CLEAR)
        await tr.commit()
        tr = db.create_transaction()
        assert await tr.get(b"cc") == b"x"   # mismatch: untouched
        tr = db.create_transaction()
        tr.atomic_op(b"cc", b"x", COMPARE_AND_CLEAR)
        await tr.commit()
        tr = db.create_transaction()
        assert await tr.get(b"cc") is None   # match: cleared
        return True

    assert cluster.run(main(), timeout_time=60)


def test_key_selectors(cluster):
    db = cluster.client()

    async def main():
        tr = db.create_transaction()
        for k in (b"a", b"c", b"e", b"g"):
            tr.set(k, b"v" + k)
        await tr.commit()
        tr = db.create_transaction()
        assert await tr.get_key(KeySelector.first_greater_or_equal(b"c")) == b"c"
        assert await tr.get_key(KeySelector.first_greater_than(b"c")) == b"e"
        assert await tr.get_key(KeySelector.last_less_than(b"c")) == b"a"
        assert await tr.get_key(KeySelector.last_less_or_equal(b"c")) == b"c"
        assert await tr.get_key(KeySelector.last_less_or_equal(b"d")) == b"c"
        assert await tr.get_key(KeySelector.first_greater_or_equal(b"zz")) == b"\xff"
        assert await tr.get_key(KeySelector.last_less_than(b"a")) == b""
        # offsets walk present keys
        assert await tr.get_key(KeySelector(b"a", True, 2)) == b"e"
        # selector-bounded range
        got = await tr.get_range(KeySelector.first_greater_than(b"a"),
                                 KeySelector.first_greater_or_equal(b"g"))
        assert [k for k, _ in got] == [b"c", b"e"]
        return True

    assert cluster.run(main(), timeout_time=30)


def test_reverse_and_limited_ranges(cluster):
    db = cluster.client()

    async def main():
        tr = db.create_transaction()
        for i in range(10):
            tr.set(b"r%02d" % i, b"%d" % i)
        await tr.commit()
        tr = db.create_transaction()
        fwd = await tr.get_range(b"r", b"s", limit=3)
        assert [k for k, _ in fwd] == [b"r00", b"r01", b"r02"]
        rev = await tr.get_range(b"r", b"s", limit=3, reverse=True)
        assert [k for k, _ in rev] == [b"r09", b"r08", b"r07"]
        return True

    assert cluster.run(main(), timeout_time=30)


def test_watch_fires_on_change(cluster):
    db = cluster.client()
    db2 = cluster.client("other")

    async def main():
        tr = db.create_transaction()
        tr.set(b"w", b"0")
        w = tr.watch(b"w")
        await tr.commit()
        assert not w.is_ready

        async def later_write():
            await flow.delay(0.5)
            tr2 = db2.create_transaction()
            tr2.set(b"w", b"1")
            await tr2.commit()

        flow.spawn(later_write())
        fired_at = await w
        assert fired_at > 0
        tr3 = db.create_transaction()
        assert await tr3.get(b"w") == b"1"
        return True

    assert cluster.run(main(), timeout_time=60)


def test_watch_cancelled_on_failed_commit(cluster):
    db = cluster.client()
    db2 = cluster.client("other")

    async def main():
        setup = db.create_transaction()
        setup.set(b"k", b"0")
        await setup.commit()
        t1 = db.create_transaction()
        t2 = db2.create_transaction()
        await t1.get(b"k")
        await t2.get(b"k")
        t1.set(b"k", b"1")
        t2.set(b"k", b"2")
        w = t2.watch(b"w2")
        await t1.commit()
        try:
            await t2.commit()
        except flow.FdbError:
            pass
        assert w.is_ready and w.is_error
        assert w.exception().name == "transaction_cancelled"
        return True

    assert cluster.run(main(), timeout_time=60)


def test_versionstamped_key_and_value(cluster):
    db = cluster.client()

    async def main():
        tr = db.create_transaction()
        # key = prefix + 10-byte placeholder; offset (4B LE) = len(prefix)
        key = b"log/" + b"\x00" * 10 + struct.pack("<I", 4)
        tr.atomic_op(key, b"entry1", SET_VERSIONSTAMPED_KEY)
        await tr.commit()
        stamp = tr.get_versionstamp()
        assert len(stamp) == 10
        tr = db.create_transaction()
        got = await tr.get_range(b"log/", b"log0")
        assert got == [(b"log/" + stamp, b"entry1")]

        # versionstamped value
        tr = db.create_transaction()
        val = b"v:" + b"\x00" * 10 + struct.pack("<I", 2)
        tr.atomic_op(b"vs", val, SET_VERSIONSTAMPED_VALUE)
        await tr.commit()
        stamp2 = tr.get_versionstamp()
        tr = db.create_transaction()
        assert await tr.get(b"vs") == b"v:" + stamp2
        assert stamp2 > stamp  # stamps are monotone in commit order
        return True

    assert cluster.run(main(), timeout_time=30)


def test_atomic_in_range_read(cluster):
    db = cluster.client()

    async def main():
        tr = db.create_transaction()
        tr.set(b"q1", le8(1))
        await tr.commit()
        tr = db.create_transaction()
        tr.atomic_op(b"q1", le8(10), ADD_VALUE)   # existing key
        tr.atomic_op(b"q2", le8(5), ADD_VALUE)    # materializes
        got = await tr.get_range(b"q", b"r")
        assert got == [(b"q1", le8(11)), (b"q2", le8(5))]
        await tr.commit()
        tr = db.create_transaction()
        assert await tr.get_range(b"q", b"r") == \
            [(b"q1", le8(11)), (b"q2", le8(5))]
        return True

    assert cluster.run(main(), timeout_time=30)


def test_size_limits_enforced_client_side():
    """(ref: NativeAPI key/value/transaction size checks)"""
    import pytest

    from foundationdb_tpu_torch import flow
    from foundationdb_tpu_torch.server import SimCluster

    c = SimCluster(seed=95)
    try:
        db = c.client()

        async def main():
            tr = db.create_transaction()
            with pytest.raises(flow.FdbError) as ei:
                tr.set(b"k" * 10_001, b"v")
            assert ei.value.name == "key_too_large"
            with pytest.raises(flow.FdbError) as ei:
                tr.set(b"k", b"v" * 100_001)
            assert ei.value.name == "value_too_large"
            tr2 = db.create_transaction()
            with pytest.raises(flow.FdbError) as ei:
                for i in range(200):
                    tr2.set(b"big%03d" % i, b"x" * 99_000)
            assert ei.value.name == "transaction_too_large"
            return True

        assert c.run(main(), timeout_time=60)
    finally:
        c.shutdown()
