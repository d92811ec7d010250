"""The reference's cases of tests/test_layers.py on the port's tuple
layer and subspace.

Tuple layer + Subspace: round-trips, the order-preserving property,
and spec-pinned encodings (ref: fdbclient/Tuple.cpp, design/tuple.md,
bindings/python/fdb/tuple.py; Subspace.cpp)."""

import random
import uuid

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch.layers import Subspace, Versionstamp, tuple_layer

pack = tuple_layer.pack
unpack = tuple_layer.unpack


def test_spec_pinned_encodings():
    # byte-for-byte values from the cross-binding tuple spec
    assert pack((None,)) == b"\x00"
    assert pack((b"foo\x00bar",)) == b"\x01foo\x00\xffbar\x00"
    assert pack(("FÔO",)) == b"\x02F\xc3\x94O\x00"
    assert pack((0,)) == b"\x14"
    assert pack((5,)) == b"\x15\x05"
    assert pack((-5,)) == b"\x13\xfa"
    assert pack((255,)) == b"\x15\xff"
    assert pack((256,)) == b"\x16\x01\x00"
    assert pack((True,)) == b"\x27"
    assert pack((False,)) == b"\x26"
    assert pack(((b"a", None),)) == b"\x05\x01a\x00\x00\xff\x00"


def test_roundtrip_random_tuples():
    rng = random.Random(77)

    def rand_val(depth=0):
        kind = rng.randrange(8 if depth < 2 else 7)
        if kind == 0:
            return None
        if kind == 1:
            return rng.choice([True, False])
        if kind == 2:
            return rng.randint(-(1 << 60), 1 << 60)
        if kind == 3:
            return bytes(rng.randrange(256) for _ in range(rng.randrange(6)))
        if kind == 4:
            return "".join(chr(rng.randrange(32, 1000))
                           for _ in range(rng.randrange(5)))
        if kind == 5:
            return rng.uniform(-1e10, 1e10)
        if kind == 6:
            return uuid.UUID(int=rng.getrandbits(128))
        return tuple(rand_val(depth + 1) for _ in range(rng.randrange(3)))

    for _ in range(300):
        t = tuple(rand_val() for _ in range(rng.randrange(4)))
        assert unpack(pack(t)) == t, t


def test_order_preserving():
    rng = random.Random(78)
    ints = sorted(rng.randint(-(1 << 50), 1 << 50) for _ in range(200))
    packed = [pack((i,)) for i in ints]
    assert packed == sorted(packed)

    floats = sorted(rng.uniform(-1e9, 1e9) for _ in range(200))
    packed = [pack((f,)) for f in floats]
    assert packed == sorted(packed)

    words = sorted(bytes(rng.randrange(1, 256) for _ in range(
        rng.randrange(1, 5))) for _ in range(100))
    packed = [pack((w,)) for w in words]
    assert packed == sorted(packed)

    # escaped NUL bytes keep ordering too
    ks = sorted([b"a", b"a\x00", b"a\x00b", b"a\x01", b"ab"])
    packed = [pack((k,)) for k in ks]
    assert packed == sorted(packed)


def test_versionstamp_roundtrip_and_order():
    a = Versionstamp(bytes(range(12)))
    b = Versionstamp(bytes(range(1, 13)))
    assert unpack(pack((a,))) == (a,)
    assert pack((a,)) < pack((b,))


def test_subspace():
    s = Subspace(("users",))
    k = s.pack((42, "bob"))
    assert s.contains(k)
    assert s.unpack(k) == (42, "bob")
    nested = s[42]
    assert nested.pack(("bob",)) == k
    b, e = s.range()
    assert b < k < e
    with pytest.raises(Exception):
        s.unpack(b"\x01zzz\x00")


def test_tuple_keys_through_the_database():
    """Tuple-packed keys sort correctly through a real cluster range
    read (the layer working end-to-end)."""
    from foundationdb_tpu_torch.client import run_transaction
    from foundationdb_tpu_torch.server import SimCluster

    c = SimCluster(seed=601)
    try:
        db = c.client()
        s = Subspace(("t",))

        async def main():
            rows = [(5, "a"), (5, "b"), (10, "a"), (-3, "z")]

            async def body(tr):
                for i, (n, w) in enumerate(rows):
                    tr.set(s.pack((n, w)), b"%d" % i)
            await run_transaction(db, body)
            tr = db.create_transaction()
            b, e = s.range()
            got = await tr.get_range(b, e)
            keys = [s.unpack(k) for k, _v in got]
            assert keys == sorted(rows), keys
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()
