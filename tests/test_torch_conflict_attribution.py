"""The reference's conflict-attribution cases
(tests/test_conflict_attribution.py) on the port: the directed
report_conflicting_keys semantics and the randomized cross-backend
parity over python, brute, native, cuda, cuda-point and sharded-cuda
(the CUDA backends at `device="cpu"`, their kernels' plain versions,
and again on the card under the `cuda` marker), with the reference's
brute-force model beside the port's in the randomized parity, and the
decaying hot-spot table of the port's resolver role. Verdicts and
attributed index sets are integers: equality is exact."""

import random

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu.models import (  # noqa: E402
    BruteForceConflictSet as RefBruteForceConflictSet,
)
from foundationdb_tpu_torch.models import (  # noqa: E402
    COMMITTED,
    CONFLICT,
    TOO_OLD,
    BruteForceConflictSet,
    PyConflictSet,
    ResolverTransaction,
    create_conflict_set,
    native_available,
)

MWTLV = 5_000_000
ON_CARD = ("cuda", "sharded-cuda")


def txn(snapshot, reads=(), writes=()):
    return ResolverTransaction(snapshot, tuple(reads), tuple(writes))


def _device_backend(name, device, **kw):
    def make():
        return create_conflict_set(name, device=device, **kw)
    return make


HOST = ("python", "brute", "native")


def backends():
    """(name, factory) of every backend this host runs: the native one
    only where its library builds (decided here, inside a test)."""
    from foundationdb_tpu_torch.models import NativeConflictSet
    out = [("python", PyConflictSet), ("brute", BruteForceConflictSet)]
    if native_available():
        out.append(("native", NativeConflictSet))
    out += [(name, _device_backend(name, "cpu")) for name in ON_CARD]
    return out


@pytest.fixture(params=list(HOST) + list(ON_CARD) + [
    pytest.param(f"{b}@card", marks=pytest.mark.cuda) for b in ON_CARD])
def cs_factory(request):
    name, _, where = request.param.partition("@")
    if where:
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        return _device_backend(name, None)
    if name == "native" and not native_available():
        pytest.skip("the native C++ backend does not build here")
    return dict(backends())[name]


@pytest.fixture(params=["cpu", pytest.param("card", marks=pytest.mark.cuda)])
def device(request):
    """The device the CUDA backends run on: the CPU (plain versions) or
    the card (skipped without one)."""
    if request.param == "card" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cpu" if request.param == "cpu" else None


# ---------------------------------------------------------------- directed --
def test_external_conflict_attributes_only_the_hit_range(cs_factory):
    cs = cs_factory()
    cs.resolve([txn(0, writes=[(b"k", b"k\x00")])], 100, 0)
    v, a = cs.resolve_with_attribution(
        [txn(50, reads=[(b"a", b"b"), (b"k", b"k\x00")],
             writes=[(b"x", b"y")])], 200, 0)
    assert v == [CONFLICT]
    assert a[0] == (1,)


def test_intra_batch_attribution(cs_factory):
    cs = cs_factory()
    v, a = cs.resolve_with_attribution(
        [txn(0, writes=[(b"k", b"k\x00")]),
         txn(0, reads=[(b"a", b"b"), (b"k", b"k\x00")],
             writes=[(b"z", b"z\x00")])], 100, 0)
    assert v == [COMMITTED, CONFLICT]
    assert a == [(), (1,)]


def test_union_of_external_and_intra_causes(cs_factory):
    """A txn conflicting BOTH against history (range 0) and an earlier
    txn's write (range 1) attributes both — the order-insensitive union
    every backend computes identically."""
    cs = cs_factory()
    cs.resolve([txn(0, writes=[(b"h", b"h\x00")])], 100, 0)
    v, a = cs.resolve_with_attribution(
        [txn(150, writes=[(b"w", b"w\x00")]),
         txn(50, reads=[(b"h", b"h\x00"), (b"w", b"w\x00")])], 200, 0)
    assert v == [COMMITTED, CONFLICT]
    assert a == [(), (0, 1)]


def test_conflicted_txn_writes_not_attributed_to_later_reads(cs_factory):
    """A conflicted txn's writes never become causes (ref:
    checkIntraBatchConflicts skipping conflicted txns' writes)."""
    cs = cs_factory()
    cs.resolve([txn(0, writes=[(b"a", b"a\x00")])], 100, 0)
    v, a = cs.resolve_with_attribution(
        [txn(50, reads=[(b"a", b"a\x00")], writes=[(b"b", b"b\x00")]),
         txn(150, reads=[(b"b", b"b\x00")])], 200, 0)
    assert v == [CONFLICT, COMMITTED]
    assert a == [(0,), ()]


def test_too_old_attributes_nothing(cs_factory):
    cs = cs_factory()
    cs.resolve([txn(0, writes=[(b"a", b"b")])], 10_000_000,
               10_000_000 - MWTLV)
    v, a = cs.resolve_with_attribution(
        [txn(4_000_000, reads=[(b"q", b"r")])],
        11_000_000, 11_000_000 - MWTLV)
    assert v == [TOO_OLD]
    assert a == [()]


def test_indices_are_original_positions(cs_factory):
    """Empty/inverted ranges keep their slot: attribution indexes the
    caller's read_ranges tuple, not the marshalled survivors."""
    cs = cs_factory()
    cs.resolve([txn(0, writes=[(b"k", b"k\x00")])], 100, 0)
    v, a = cs.resolve_with_attribution(
        [txn(50, reads=[(b"m", b"m"), (b"k", b"k\x00")],
             writes=[(b"x", b"y")])], 200, 0)
    assert v == [CONFLICT]
    assert a[0] == (1,)


def test_committed_txns_attribute_nothing(cs_factory):
    cs = cs_factory()
    v, a = cs.resolve_with_attribution(
        [txn(0, reads=[(b"a", b"b")], writes=[(b"c", b"c\x00")])], 100, 0)
    assert v == [COMMITTED]
    assert a == [()]


# -------------------------------------------------------------- randomized --
def _random_range(rng, space, klen):
    if rng.random() < 0.5:
        k = bytes(rng.randrange(space) for _ in range(klen))
        return (k, k + b"\x00")
    a = bytes(rng.randrange(space) for _ in range(klen))
    b = bytes(rng.randrange(space) for _ in range(klen))
    if a > b:
        a, b = b, a
    return (a, b + b"\x00") if a == b else (a, b)


def _random_range(rng, space, klen):
    if rng.random() < 0.5:
        k = bytes(rng.randrange(space) for _ in range(klen))
        return (k, k + b"\x00")
    a = bytes(rng.randrange(space) for _ in range(klen))
    b = bytes(rng.randrange(space) for _ in range(klen))
    if a > b:
        a, b = b, a
    return (a, b + b"\x00") if a == b else (a, b)


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_randomized_attribution_parity(seed, device):
    """Tiny keyspace maximizes collisions; verdicts AND attributed
    index sets must agree with the brute-force model everywhere (the
    port's and the reference's)."""
    rng = random.Random(seed)
    impls = {name: make() for name, make in backends()
             if name not in ON_CARD}
    for name in ON_CARD:
        impls[name] = create_conflict_set(name, device=device)
    impls["reference brute"] = RefBruteForceConflictSet()
    version = 0
    for batch_idx in range(50):
        version += rng.randrange(1, 300_000)
        oldest = max(0, version - MWTLV)
        batch = [
            txn(max(0, version - rng.randrange(0, int(1.2 * MWTLV))),
                [_random_range(rng, 5, 2)
                 for _ in range(rng.randrange(0, 4))],
                [_random_range(rng, 5, 2)
                 for _ in range(rng.randrange(0, 4))])
            for _ in range(rng.randrange(1, 10))]
        results = {name: cs.resolve_with_attribution(batch, version, oldest)
                   for name, cs in impls.items()}
        vref, aref = results["brute"]
        for name, (v, a) in results.items():
            assert v == vref, (
                f"{name} verdicts diverged at batch {batch_idx}: "
                f"{v} != {vref}\n{batch}")
            assert [tuple(x) for x in a] == [tuple(x) for x in aref], (
                f"{name} attribution diverged at batch {batch_idx}: "
                f"{a} != {aref}\n{batch}")


def test_point_backend_attribution_parity(device):
    rng = random.Random(31)
    brute = BruteForceConflictSet()
    pt = create_conflict_set("cuda-point", device=device)
    version = 0

    def rpoint():
        k = bytes([rng.randrange(6)])
        return (k, k + b"\x00")

    for batch_idx in range(40):
        version += rng.randrange(1, 300_000)
        oldest = max(0, version - MWTLV)
        batch = [txn(max(0, version - rng.randrange(0, MWTLV)),
                     [rpoint() for _ in range(rng.randrange(0, 3))],
                     [rpoint() for _ in range(rng.randrange(0, 3))])
                 for _ in range(rng.randrange(1, 8))]
        v1, a1 = brute.resolve_with_attribution(batch, version, oldest)
        v2, a2 = pt.resolve_with_attribution(batch, version, oldest)
        assert v1 == v2, (batch_idx, v1, v2, batch)
        assert [tuple(x) for x in a1] == [tuple(x) for x in a2], (
            batch_idx, a1, a2, batch)


def test_sharded_backend_attribution_parity(device):
    """Clipped per-shard attribution unions back to the global answer —
    bit-identical to the single-shard backends."""
    rng = random.Random(41)
    brute = BruteForceConflictSet()
    sh = create_conflict_set("sharded-cuda", device=device, n_shards=4)
    version = 0

    def rrange():
        a = bytes(rng.randrange(250) for _ in range(2))
        b = bytes(rng.randrange(250) for _ in range(2))
        if a > b:
            a, b = b, a
        return (a, b + b"\x00") if a == b else (a, b)

    for batch_idx in range(20):
        version += rng.randrange(1, 300_000)
        oldest = max(0, version - MWTLV)
        batch = [txn(max(0, version - rng.randrange(0, MWTLV)),
                     [rrange() for _ in range(rng.randrange(0, 3))],
                     [rrange() for _ in range(rng.randrange(0, 3))])
                 for _ in range(rng.randrange(1, 6))]
        v1, a1 = brute.resolve_with_attribution(batch, version, oldest)
        v2, a2 = sh.resolve_with_attribution(batch, version, oldest)
        assert v1 == v2, (batch_idx, v1, v2, batch)
        assert [tuple(x) for x in a1] == [tuple(x) for x in a2], (
            batch_idx, a1, a2, batch)


# -------------------------------------------------------------- hot spots --
def test_hot_spot_table_decay_and_topk():
    from foundationdb_tpu_torch import flow
    from foundationdb_tpu_torch.server.resolver_role import ConflictHotSpots

    sched = flow.Scheduler()
    flow.set_scheduler(sched)
    try:
        async def main():
            hs = ConflictHotSpots(half_life=1.0, max_entries=3)
            for _ in range(4):
                hs.record(b"a", b"a\x00")
            hs.record(b"b", b"b\x00")
            top = hs.top(10)
            assert top[0]["begin"] == b"a".hex()
            assert top[0]["total"] == 4
            # decay: after 2 half-lives the score quarters, totals stay
            s0 = top[0]["score"]
            await flow.delay(2.0)
            top2 = hs.top(10)
            assert top2[0]["total"] == 4
            assert top2[0]["score"] == pytest.approx(s0 / 4, rel=0.01)
            # bounded: the coldest entry is evicted past max_entries
            hs.record(b"c", b"c\x00")
            hs.record(b"d", b"d\x00")
            assert len(hs.top(10)) == 3
            return True

        task = flow.spawn(main())
        assert sched.run(until=task, timeout_time=60)
    finally:
        flow.set_scheduler(None)
