"""Conflict-resolution semantics on the port's backends: the directed
cases and the randomized cross-backend parity of
tests/test_conflict_semantics.py, one for one, over the port's
`python`, `brute` and `native` backends and the `cuda` and
`sharded-cuda` factories on the CPU (their plain PyTorch steps; the
sharded one with 4 shards split inside the test keys), and again on the
card under the `cuda` marker. The port's models package exports
`NativeConflictSet` and `native_available` as the reference's does, and
a native batch agrees with `PyConflictSet`. Verdicts are integers:
equality is exact."""

import functools
import random

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch.models import (  # noqa: E402
    COMMITTED,
    CONFLICT,
    TOO_OLD,
    BruteForceConflictSet,
    NativeConflictSet,
    PyConflictSet,
    ResolverTransaction,
    create_conflict_set,
    native_available,
)

MWTLV = 5_000_000  # MAX_WRITE_TRANSACTION_LIFE_VERSIONS (ref: Knobs.cpp:35)
SPLITS = [b"b", b"m", b"t"]  # shard edges inside the directed cases' keys
CPU_BACKENDS = ("python", "brute", "native", "cuda", "sharded-cuda")
CARD_BACKENDS = ("cuda@card", "sharded-cuda@card")


def txn(snapshot, reads=(), writes=()):
    return ResolverTransaction(snapshot, tuple(reads), tuple(writes))


def _factory(name, dev, init_version=0):
    kw = {"n_shards": 4, "split_keys": SPLITS} if name == "sharded-cuda" \
        else {}
    return create_conflict_set(name, init_version, device=dev, **kw)


def make_factory(name):
    """A constructor taking the initial version, or a skip when the
    backend cannot run here (no native build, no card)."""
    if name == "python":
        return PyConflictSet
    if name == "brute":
        return BruteForceConflictSet
    if name == "native":
        if not native_available():
            pytest.skip("the native backend did not build")
        return NativeConflictSet
    base, _, where = name.partition("@")
    if where == "card":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        return functools.partial(_factory, base, None)
    return functools.partial(_factory, base, "cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain steps run on small tensors: one intra-op thread is
    faster here and leaves the other test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=list(CPU_BACKENDS) + [
    pytest.param(n, marks=pytest.mark.cuda) for n in CARD_BACKENDS])
def cs_factory(request):
    return make_factory(request.param)


# ---------------------------------------------------------------- directed --
def test_blind_write_commits(cs_factory):
    cs = cs_factory()
    v = cs.resolve([txn(0, writes=[(b"a", b"b")])], 100, 0)
    assert v == [COMMITTED]


def test_read_after_write_conflicts(cs_factory):
    cs = cs_factory()
    cs.resolve([txn(0, writes=[(b"k", b"k\x00")])], 100, 0)
    # snapshot 50 < write version 100 -> conflict
    v = cs.resolve([txn(50, reads=[(b"k", b"k\x00")],
                        writes=[(b"x", b"y")])], 200, 0)
    assert v == [CONFLICT]


def test_read_at_or_after_commit_version_ok(cs_factory):
    cs = cs_factory()
    cs.resolve([txn(0, writes=[(b"k", b"k\x00")])], 100, 0)
    # snapshot == write version: maxVersion > snapshot is FALSE (strict)
    v = cs.resolve([txn(100, reads=[(b"k", b"k\x00")])], 200, 0)
    assert v == [COMMITTED]


def test_disjoint_ranges_no_conflict(cs_factory):
    cs = cs_factory()
    cs.resolve([txn(0, writes=[(b"a", b"b")])], 100, 0)
    v = cs.resolve([txn(50, reads=[(b"b", b"c")])], 200, 0)
    assert v == [COMMITTED]


def test_half_open_boundary(cs_factory):
    """Write [a,b) then read [b,c): end key excluded -> no conflict."""
    cs = cs_factory()
    cs.resolve([txn(0, writes=[(b"a", b"b")])], 100, 0)
    v = cs.resolve(
        [txn(0, reads=[(b"b", b"c")]), txn(0, reads=[(b"a\xff", b"b")])],
        200, 0)
    assert v == [COMMITTED, CONFLICT]


def test_range_overlap_conflicts(cs_factory):
    cs = cs_factory()
    cs.resolve([txn(0, writes=[(b"d", b"m")])], 100, 0)
    assert cs.resolve([txn(0, reads=[(b"a", b"e")])], 200, 0) == [CONFLICT]
    assert cs.resolve([txn(50, reads=[(b"l", b"z")])], 300, 0) == [CONFLICT]
    assert cs.resolve([txn(150, reads=[(b"f", b"g")])], 400, 0) == \
        [COMMITTED]
    assert cs.resolve([txn(0, reads=[(b"m", b"z")])], 500, 0) == [COMMITTED]


def test_intra_batch_read_after_earlier_write(cs_factory):
    """Later txn in a batch reading what an earlier txn writes -> conflict."""
    cs = cs_factory()
    v = cs.resolve(
        [txn(0, writes=[(b"k", b"k\x00")]),
         txn(0, reads=[(b"k", b"k\x00")], writes=[(b"z", b"z\x00")])],
        100, 0)
    assert v == [COMMITTED, CONFLICT]


def test_intra_batch_order_matters(cs_factory):
    """Earlier txn reading what a LATER txn writes -> no conflict."""
    cs = cs_factory()
    v = cs.resolve(
        [txn(0, reads=[(b"k", b"k\x00")]),
         txn(0, writes=[(b"k", b"k\x00")])], 100, 0)
    assert v == [COMMITTED, COMMITTED]


def test_intra_batch_conflicted_writes_excluded(cs_factory):
    """A conflicted txn's writes must not conflict later txns in the
    batch (ref: checkIntraBatchConflicts skips conflicted txns)."""
    cs = cs_factory()
    cs.resolve([txn(0, writes=[(b"a", b"a\x00")])], 100, 0)
    v = cs.resolve(
        [txn(50, reads=[(b"a", b"a\x00")], writes=[(b"b", b"b\x00")]),
         txn(150, reads=[(b"b", b"b\x00")])],  # b was NOT actually written
        200, 0)
    assert v == [CONFLICT, COMMITTED]


def test_intra_batch_chain(cs_factory):
    """t0 writes A; t1 reads A (conflict), writes B; t2 reads B commits
    because t1 was removed; t3 reads t2's write C -> conflict."""
    cs = cs_factory()
    v = cs.resolve(
        [txn(0, writes=[(b"a", b"a\x00")]),
         txn(0, reads=[(b"a", b"a\x00")], writes=[(b"b", b"b\x00")]),
         txn(0, reads=[(b"b", b"b\x00")], writes=[(b"c", b"c\x00")]),
         txn(0, reads=[(b"c", b"c\x00")])], 100, 0)
    assert v == [COMMITTED, CONFLICT, COMMITTED, CONFLICT]


def test_too_old(cs_factory):
    cs = cs_factory()
    cs.resolve([txn(0, writes=[(b"a", b"b")])], 10_000_000,
               10_000_000 - MWTLV)
    # snapshot below oldestVersion (5e6) with reads -> too old
    v = cs.resolve(
        [txn(4_000_000, reads=[(b"q", b"r")]),
         txn(4_000_000, writes=[(b"q", b"r")]),  # blind write: NOT too old
         txn(6_000_000, reads=[(b"q", b"r")]),   # reads txn1's write
         txn(6_000_000, reads=[(b"s", b"t")])],  # disjoint: fine
        11_000_000, 11_000_000 - MWTLV)
    assert v == [TOO_OLD, COMMITTED, CONFLICT, COMMITTED]


def test_too_old_writes_not_merged(cs_factory):
    """A tooOld txn's writes are dropped (ref: addTransaction tooOld
    branch records no ranges)."""
    cs = cs_factory()
    cs.resolve([txn(0, writes=[(b"a", b"b")])], 10_000_000,
               10_000_000 - MWTLV)
    cs.resolve([txn(0, reads=[(b"x", b"y")], writes=[(b"k", b"k\x00")])],
               11_000_000, 11_000_000 - MWTLV)  # too old, write dropped
    v = cs.resolve([txn(10_500_000, reads=[(b"k", b"k\x00")])],
                   12_000_000, 12_000_000 - MWTLV)
    assert v == [COMMITTED]


def test_empty_and_inverted_ranges_ignored(cs_factory):
    cs = cs_factory()
    cs.resolve([txn(0, writes=[(b"a", b"z")])], 100, 0)
    v = cs.resolve(
        [txn(0, reads=[(b"m", b"m")]),           # empty
         txn(0, reads=[(b"z", b"a")]),           # inverted
         txn(0, writes=[(b"q", b"q")])], 200, 0)
    assert v == [COMMITTED, COMMITTED, COMMITTED]


def test_empty_transaction_commits(cs_factory):
    cs = cs_factory()
    assert cs.resolve([txn(0)], 100, 0) == [COMMITTED]


def test_initial_version_covers_keyspace(cs_factory):
    """After init at version V, reads below V conflict everywhere
    (ref: clearConflictSet / SkipList(v) header maxVersion)."""
    cs = cs_factory(1000)
    assert cs.resolve([txn(500, reads=[(b"anything", b"anythinh")])],
                      2000, 0) == [CONFLICT]
    assert cs.resolve([txn(1000, reads=[(b"anything", b"anythinh")])],
                      2000, 0) == [COMMITTED]


def test_write_versions_accumulate_max(cs_factory):
    """Later write to a sub-range: queries over the larger range see the
    max."""
    cs = cs_factory()
    cs.resolve([txn(0, writes=[(b"a", b"z")])], 100, 0)
    cs.resolve([txn(100, writes=[(b"m", b"n")])], 200, 0)
    assert cs.resolve([txn(150, reads=[(b"a", b"c")])], 300, 0) == \
        [COMMITTED]
    assert cs.resolve([txn(150, reads=[(b"a", b"z")])], 400, 0) == \
        [CONFLICT]


# -------------------------------------------------------------- randomized --
def _random_key(rng, space, klen):
    return bytes(rng.randrange(space) for _ in range(klen))


def _random_range(rng, space, klen, point_bias=0.5):
    if rng.random() < point_bias:
        k = _random_key(rng, space, klen)
        return (k, k + b"\x00")
    a, b = _random_key(rng, space, klen), _random_key(rng, space, klen)
    if a > b:
        a, b = b, a
    return (a, b + b"\x00") if a == b else (a, b)


def _random_batch(rng, version, oldest, n_txns, space=6, klen=3):
    out = []
    for _ in range(n_txns):
        snapshot = version - rng.randrange(1, int(1.5 * MWTLV)) \
            if rng.random() < 0.15 else version - rng.randrange(0, MWTLV // 2)
        reads = [_random_range(rng, space, klen)
                 for _ in range(rng.randrange(0, 4))]
        writes = [_random_range(rng, space, klen)
                  for _ in range(rng.randrange(0, 4))]
        out.append(txn(max(0, snapshot), reads, writes))
    return out


def _impls(names):
    impls = {}
    for name in names:
        if name == "native" and not native_available():
            continue
        impls[name] = make_factory(name)()
    return impls


def _small_keyspace(seed, names):
    """Tiny keyspace maximizes collisions; every backend must agree with
    the brute-force model on every verdict of every batch."""
    rng = random.Random(seed)
    impls = _impls(("brute",) + tuple(names))
    version = 0
    for batch_idx in range(60):
        version += rng.randrange(1, 300_000)
        oldest = max(0, version - MWTLV)
        batch = _random_batch(rng, version, oldest, rng.randrange(1, 12))
        results = {name: cs.resolve(batch, version, oldest)
                   for name, cs in impls.items()}
        ref = results["brute"]
        for name, got in results.items():
            assert got == ref, (
                f"backend {name} diverged at batch {batch_idx}: {got} != "
                f"{ref}\nbatch={batch}, version={version}, oldest={oldest}")


def _long_keys(seed, names):
    """Variable-length keys incl. shared prefixes and \\x00/\\xff bytes."""
    rng = random.Random(seed)
    impls = _impls(("brute",) + tuple(names))

    def rkey():
        return bytes(rng.choice(b"\x00ab\xff")
                     for _ in range(rng.randrange(0, 5)))

    def rrange():
        a, b = rkey(), rkey()
        if a > b:
            a, b = b, a
        if a == b:
            b = a + b"\x00"
        return a, b

    version = 0
    for _ in range(40):
        version += rng.randrange(1, 200_000)
        oldest = max(0, version - MWTLV)
        batch = [
            txn(max(0, version - rng.randrange(0, 2 * MWTLV)),
                [rrange() for _ in range(rng.randrange(0, 3))],
                [rrange() for _ in range(rng.randrange(0, 3))])
            for _ in range(rng.randrange(1, 8))
        ]
        results = {name: cs.resolve(batch, version, oldest)
                   for name, cs in impls.items()}
        ref = results["brute"]
        for name, got in results.items():
            assert got == ref, f"{name} diverged: {got} != {ref}\n{batch}"


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_randomized_parity_small_keyspace(seed):
    _small_keyspace(seed, CPU_BACKENDS)


@pytest.mark.parametrize("seed", [11, 12])
def test_randomized_parity_long_keys(seed):
    _long_keys(seed, CPU_BACKENDS)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_randomized_parity_small_keyspace_on_card(seed):
    _small_keyspace(seed, CARD_BACKENDS)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [11, 12])
def test_randomized_parity_long_keys_on_card(seed):
    _long_keys(seed, CARD_BACKENDS)


def test_native_backend_loads():
    assert native_available(), "native C++ backend failed to build/load"
    cs = create_conflict_set("native")
    assert cs.resolve([txn(0, writes=[(b"a", b"b")])], 100, 0) == [COMMITTED]


def test_package_exports_native_backend():
    """`NativeConflictSet` and `native_available` come from the models
    package, as the reference's do, and a native batch with reads,
    writes, an intra-batch chain and a too-old snapshot gets
    `PyConflictSet`'s verdicts."""
    from foundationdb_tpu_torch import models
    assert {"NativeConflictSet", "native_available"} <= set(models.__all__)
    if not native_available():
        pytest.skip("the native backend did not build")
    native, py = NativeConflictSet(10), PyConflictSet(10)
    batches = [
        ([txn(10, writes=[(b"a", b"c")]), txn(10, reads=[(b"b", b"b\x00")],
                                              writes=[(b"x", b"y")])],
         100, 0),
        ([txn(50, reads=[(b"a", b"b")]), txn(100, reads=[(b"x", b"z")])],
         200, 20),
        ([txn(15, reads=[(b"q", b"r")])], 300, 20),
    ]
    got = []
    for batch, version, oldest in batches:
        got.append(py.resolve(batch, version, oldest))
        assert native.resolve(batch, version, oldest) == got[-1]
    assert got == [[COMMITTED, CONFLICT], [CONFLICT, COMMITTED], [TOO_OLD]]
