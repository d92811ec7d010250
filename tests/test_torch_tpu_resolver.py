"""The reference's TPU-backend cases (tests/test_tpu_resolver.py) on the
port's device backends: capacity growth, version re-basing past 2^30,
the recovery-style jump, the jump past int32, the window that must
advance, key-width and version-regression contracts, the empty batch,
and randomized parity at larger batches. Each runs over `cuda`,
`cuda-point` and `sharded-cuda` at `device="cpu"` (the kernels' plain
versions; the sharded one with 4 shards split inside the test keys) and
again on the card under the `cuda` marker, against the reference's
`TpuConflictSet` and `BruteForceConflictSet` on the same batches. The
point backend takes point ranges only, so its batches turn each range
[b, e) into the point [b, b + b"\\x00"), for it and for the reference
alike. These cases drive all four modes of K4 (the version-window
upkeep) through the resolvers. Verdicts are integers: equality is
exact."""

import random

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu.models import BruteForceConflictSet  # noqa: E402
from foundationdb_tpu.models import ResolverTransaction as RefTxn  # noqa: E402
from foundationdb_tpu.models.tpu_resolver import TpuConflictSet  # noqa: E402
from foundationdb_tpu_torch.models import (  # noqa: E402
    COMMITTED,
    CONFLICT,
    ResolverTransaction,
    create_conflict_set,
)
from foundationdb_tpu_torch.models.cuda_resolver import (  # noqa: E402
    CudaConflictSet,
)

MWTLV = 5_000_000
SPLITS = [b"b", b"k0800", b"t"]   # shard edges inside the test keys
BACKENDS = ("cuda", "cuda-point", "sharded-cuda")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain steps run on small tensors: one intra-op thread is
    faster here and leaves the other test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=list(BACKENDS) + [
    pytest.param(f"{b}@card", marks=pytest.mark.cuda) for b in BACKENDS])
def backend(request):
    """(backend name, device): the CPU path, or the card (skipped
    without one)."""
    name, _, where = request.param.partition("@")
    if where == "card" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return name, None if where == "card" else "cpu"


def make(backend, **kw):
    name, dev = backend
    if name == "sharded-cuda":
        kw.update(n_shards=4, split_keys=SPLITS)
    return create_conflict_set(name, device=dev, **kw)


def txn(snapshot, reads=(), writes=()):
    return (snapshot, tuple(reads), tuple(writes))


def for_backend(backend, batch):
    """The batch as the backend takes it: ranges as points for the
    point backend."""
    if backend[0] != "cuda-point":
        return batch
    return [(s, tuple((b, b + b"\x00") for b, _e in r),
             tuple((b, b + b"\x00") for b, _e in w)) for s, r, w in batch]


def port(batch):
    return [ResolverTransaction(*t) for t in batch]


def ref(batch):
    return [RefTxn(*t) for t in batch]


def resolve_all(backend, cs, refs, batch, v, oldest):
    """The batch through the port backend and each reference backend;
    asserts they agree and returns the verdicts."""
    batch = for_backend(backend, batch)
    got = cs.resolve(port(batch), v, oldest)
    for r in refs:
        assert r.resolve(ref(batch), v, oldest) == got
    return got


def test_factory_builds_tpu_backend(backend):
    cs = make(backend)
    assert isinstance(cs, CudaConflictSet)
    assert cs.BACKEND == backend[0]
    assert cs.resolve(port(for_backend(backend, [txn(0, writes=[
        (b"a", b"b")])])), 100, 0) == [COMMITTED]


def test_capacity_growth_preserves_history(backend):
    cs = make(backend, capacity=1024)
    v = 0
    for i in range(40):
        v += 10
        writes = [(b"k%04d" % (i * 40 + j), b"k%04d\x00" % (i * 40 + j))
                  for j in range(40)]
        cs.resolve(port([txn(v - 10, writes=writes)]), v, 0)
    assert cs._cap > 1024
    rng = random.Random(7)
    for _ in range(20):
        k = b"k%04d" % rng.randrange(40 * 40)
        got = cs.resolve(port([txn(0, reads=[(k, k + b"\x00")])]), v + 1, 0)
        assert got == [CONFLICT]


def test_rebase_at_large_versions(backend):
    """Versions past 2^30 keep working through int32 offset re-bases
    (K4's re-base)."""
    cs = make(backend)
    refs = (TpuConflictSet(), BruteForceConflictSet())
    v = 0
    rng = random.Random(3)
    for _ in range(12):
        v += 300_000_000
        oldest = v - MWTLV
        batch = [txn(v - rng.randrange(0, MWTLV // 2),
                     reads=[(b"a", b"c")] if rng.random() < 0.5 else [],
                     writes=[(b"b", b"b\x00")] if rng.random() < 0.5 else [])
                 for _ in range(5)]
        resolve_all(backend, cs, refs, batch, v, oldest)
    assert cs._base > 0


def test_recovery_style_version_jump(backend):
    """One huge version jump with an advanced window (K4's jump fixup
    after the placeholder step)."""
    cs = make(backend)
    refs = (TpuConflictSet(), BruteForceConflictSet())
    resolve_all(backend, cs, refs, [txn(0, writes=[(b"a", b"b")])], 100, 0)
    v = (1 << 31) + 500
    batch = [txn(v - 10, reads=[(b"a", b"b")]), txn(50, reads=[(b"a", b"b")]),
             txn(v - 10, writes=[(b"c", b"d")])]
    resolve_all(backend, cs, refs, batch, v, v - MWTLV)


def test_giant_version_jump_beyond_int32(backend):
    """Jumps whose base shift exceeds int32 (K4's reset and its large
    jump fixup)."""
    cs = make(backend)
    refs = (TpuConflictSet(), BruteForceConflictSet())
    resolve_all(backend, cs, refs, [txn(0, writes=[(b"a", b"b")])], 100, 0)
    for jump in (1 << 32, 1 << 33):
        batch = [txn(jump - 10, reads=[(b"a", b"b")]),
                 txn(jump - 10, writes=[(b"c", b"d")])]
        resolve_all(backend, cs, refs, batch, jump, jump - MWTLV)
    v = (1 << 33) + 50
    assert resolve_all(backend, cs, refs, [txn((1 << 33) - 5, reads=[
        (b"c", b"d")])], v, v - MWTLV) == [CONFLICT]


def test_window_must_advance_past_threshold(backend):
    cs = make(backend)
    w = port(for_backend(backend, [txn(0, writes=[(b"a", b"b")])]))
    cs.resolve(w, 100, 0)
    with pytest.raises(OverflowError):
        cs.resolve(w, 1 << 31, 0)


def test_key_longer_than_width_rejected(backend):
    cs = make(backend, key_bytes=16)
    with pytest.raises(ValueError):
        cs.resolve(port(for_backend(backend, [txn(0, writes=[
            (b"x" * 17, b"y" * 17)])])), 100, 0)


def test_commit_version_regression_rejected(backend):
    cs = make(backend)
    w = port(for_backend(backend, [txn(0, writes=[(b"a", b"b")])]))
    cs.resolve(w, 100, 0)
    with pytest.raises(ValueError):
        cs.resolve(w, 50, 0)


def test_empty_batch_advances_window(backend):
    cs = make(backend)
    assert cs.resolve([], 100, 40) == []
    assert cs.oldest_version == 40


@pytest.mark.parametrize("seed", [21, 22])
def test_randomized_parity_large_batches(backend, seed):
    """Bigger batches than the cross-backend suite: the intra-batch
    fixpoint at real batch sizes and periodic compaction."""
    rng = random.Random(seed)
    cs = make(backend, capacity=1024)
    refs = (TpuConflictSet(capacity=1024), BruteForceConflictSet())
    version = 0

    def rrange():
        a = bytes([rng.randrange(10), rng.randrange(10)])
        b = bytes([rng.randrange(10), rng.randrange(10)])
        if a > b:
            a, b = b, a
        if a == b:
            b = a + b"\x00"
        return a, b

    for _ in range(12):
        version += rng.randrange(1, 400_000)
        oldest = max(0, version - MWTLV)
        batch = [txn(max(0, version - rng.randrange(0, MWTLV)),
                     [rrange() for _ in range(rng.randrange(0, 5))],
                     [rrange() for _ in range(rng.randrange(0, 5))])
                 for _ in range(100)]
        resolve_all(backend, cs, refs, batch, version, oldest)
