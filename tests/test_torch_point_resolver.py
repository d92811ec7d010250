"""Port parity for models/point_resolver.py: CudaPointConflictSet on the
CPU (K5's and K6's plain versions) gives the same verdicts, attribution
and state as the reference's PointConflictSet, and the same verdicts
and attribution as PyConflictSet, on randomized point streams; the same
holds through GC, capacity growth, rebases past 2^30, version jumps of
2^30 and more, out-of-order pipelined drains and the pre-encoded
`resolve_arrays` path; the reference's ValueError contracts hold;
checkpoints round-trip between the port and the reference; and a
reference backend's state carries across into the port with identical
verdicts and state afterwards."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu.models.conflict_set import (  # noqa: E402
    ConflictSetCheckpoint as RefCheckpoint,
)
from foundationdb_tpu.models.point_resolver import (  # noqa: E402
    PointConflictSet,
)
from foundationdb_tpu_torch.flow.knobs import SERVER_KNOBS  # noqa: E402
from foundationdb_tpu_torch.models import (  # noqa: E402
    COMMITTED,
    CONFLICT,
    ConflictSetCheckpoint,
    PyConflictSet,
    ResolverTransaction,
    create_conflict_set,
)
from foundationdb_tpu_torch.models.point_resolver import (  # noqa: E402
    CudaPointConflictSet,
    load_reference_point_state,
)
from foundationdb_tpu_torch.ops.keys import encode_keys  # noqa: E402
from test_point_resolver import pt, random_point_batch, txn  # noqa: E402

MWTLV = 5_000_000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def depth4():
    SERVER_KNOBS.set("resolve_pipeline_depth", 4)
    yield
    SERVER_KNOBS.set("resolve_pipeline_depth",
                     SERVER_KNOBS._defaults["RESOLVE_PIPELINE_DEPTH"])


def port_batch(batch):
    return [ResolverTransaction(*t) for t in batch]


def cpu_set(**kw):
    return CudaPointConflictSet(device="cpu", **kw)


def run(cs, batches, port=False):
    return [cs.resolve_with_attribution(port_batch(b) if port else b, v, o)
            for b, v, o in batches]


def assert_same_state(ref, port):
    np.testing.assert_array_equal(np.asarray(ref._hk), port._hk.numpy())
    np.testing.assert_array_equal(np.asarray(ref._hv), port._hv.numpy())
    assert (ref._base, ref._oldest, ref._last_commit, ref._cap) == \
        (port._base, port._oldest, port._last_commit, port._cap)


def point_stream(seed, n_batches, n_txns=24, keyspace=200,
                 stride=50_000, spread=100_000):
    rng = random.Random(seed)
    out, version = [], 0
    for _ in range(n_batches):
        version += rng.randrange(1, stride)
        oldest = max(0, version - rng.randrange(20_000, 120_000))
        batch = random_point_batch(rng, n_txns=rng.randrange(0, n_txns),
                                   keyspace=keyspace, version=version,
                                   spread=spread)
        out.append((batch, version, oldest))
    return out


@pytest.mark.parametrize("seed", [1, 2])
def test_parity_with_reference_backends(seed):
    batches = point_stream(seed, 25)
    ref = PointConflictSet()
    want = run(ref, batches)
    port = cpu_set()
    assert run(port, batches, port=True) == want
    assert run(PyConflictSet(), batches, port=True) == want
    assert_same_state(ref, port)


def test_gc_growth_rebase_and_jumps(depth4):
    """Tiny capacity that must grow, GC pruning as the window passes,
    strides that cross the 2^30 rebase threshold, one jump of >= 2^30
    with pre-jump snapshots live (the placeholder + fixup path), all
    submitted before the first drain at depth 4 and drained in reverse
    order."""
    rng = random.Random(5)
    batches, v = [], 0
    for i in range(12):
        v += rng.randrange(1, 300_000_000)
        if i == 8:
            v += (1 << 31) + 5
        batch = [txn(max(0, v - rng.randrange(0, MWTLV)),
                     [pt(b"%03d" % rng.randrange(40))],
                     [pt(b"%03d" % rng.randrange(40))])
                 for _ in range(rng.randrange(1, 6))]
        batches.append((batch, v, max(0, v - MWTLV)))
    for i in range(5):
        v += 1000
        batch = [txn(v - 10, [], [pt(b"g%05d" % (i * 300 + j))])
                 for j in range(300)]
        batches.append((batch, v, max(0, v - MWTLV)))
    v += MWTLV + 10
    batches.append(([txn(v - 5, [pt(b"g00001")], [pt(b"zz")])], v, v - 10))
    port = cpu_set(capacity=1 << 10)
    tickets = [port.submit(port_batch(b), v, o, attribute=True)
               for b, v, o in batches]
    got = [port.drain_with_attribution(t) for t in reversed(tickets)][::-1]
    ref = PointConflictSet(capacity=1 << 10)
    assert got == run(ref, batches)
    assert port._cap > 1 << 10 and port._base > 0
    assert_same_state(ref, port)
    port._sync_count()
    assert port._count_hint <= 4   # the window passed: pruned by GC


def test_giant_jump_beyond_int32():
    port, ref = cpu_set(), PointConflictSet()
    for cs in (port, ref):
        cs.resolve([txn(0, writes=[pt(b"a")])], 100, 0)
    for jump in (1 << 32, 1 << 33):
        batch = [txn(jump - 10, reads=[pt(b"a")]),
                 txn(jump - 10, writes=[pt(b"c")])]
        assert port.resolve(port_batch(batch), jump, jump - MWTLV) == \
            ref.resolve(batch, jump, jump - MWTLV)
    v = (1 << 33) + 50
    batch = [txn((1 << 33) - 5, reads=[pt(b"c")])]
    assert port.resolve(port_batch(batch), v, v - MWTLV) == \
        ref.resolve(batch, v, v - MWTLV) == [CONFLICT]
    assert_same_state(ref, port)


def _flatten(batch, key_bytes):
    snaps, has_reads, rk, rt, wk, wt = [], [], [], [], [], []
    for t, tr in enumerate(batch):
        snaps.append(tr.read_snapshot)
        has_reads.append(bool(tr.read_ranges))
        for b, _e in tr.read_ranges:
            rk.append(b)
            rt.append(t)
        for b, _e in tr.write_ranges:
            wk.append(b)
            wt.append(t)
    return (np.asarray(snaps, np.int64), np.asarray(has_reads),
            encode_keys(rk, key_bytes)[:len(rk)], None,
            np.asarray(rt, np.int32), encode_keys(wk, key_bytes)[:len(wk)],
            None, np.asarray(wt, np.int32))


def test_resolve_arrays_parity():
    """The pre-encoded array path gives the object path's verdicts and
    the reference's state."""
    rng = random.Random(991)
    obj = PyConflictSet()
    port = cpu_set(key_bytes=8)
    ref = PointConflictSet(key_bytes=8)
    version = 0
    for _round in range(10):
        version += 250_000
        batch = random_point_batch(rng, 24, 300, version, 400_000)
        oldest = max(0, version - MWTLV)
        want = obj.resolve(port_batch(batch), version, oldest)
        arrays = _flatten(batch, 8)
        conflict, too_old = port.resolve_arrays(
            *arrays, commit_version=version, new_oldest_version=oldest)
        assert port.finalize_verdicts(conflict, too_old) == want
        ref.resolve_arrays(*arrays, commit_version=version,
                           new_oldest_version=oldest)
    assert_same_state(ref, port)


def test_value_error_contracts():
    cs = cpu_set()
    with pytest.raises(ValueError, match="single-key ranges only"):
        cs.resolve([txn(0, reads=[(b"a", b"c")])], 10, 0)
    with pytest.raises(ValueError, match="exceeds bucket width"):
        cs.resolve([txn(0, writes=[pt(b"a" * 9)])], 10, 0)
    bad = np.zeros((1, 6), np.uint32)   # a 20-byte-bucket row
    with pytest.raises(ValueError, match="does not match the point bucket"):
        cs.resolve_arrays(np.zeros(1, np.int64), np.ones(1, bool),
                          bad, None, np.zeros(1, np.int32),
                          bad, None, np.zeros(1, np.int32),
                          commit_version=100, new_oldest_version=0)
    with pytest.raises(ValueError):
        cs.validate_txns([txn(0, writes=[(b"a", b"b")])])
    cs.resolve([txn(0, writes=[pt(b"a")])], 100, 0)
    with pytest.raises(ValueError, match="non-decreasing"):
        cs.resolve([txn(0, writes=[pt(b"a")])], 50, 0)


def test_intra_batch_edges_match_reference():
    """Duplicate keys in one batch and one txn, a txn's own write never
    hits its own read, a dead write does not abort a later reader, and
    the init_version baseline."""
    port, ref = cpu_set(init_version=5), PointConflictSet(init_version=5)
    batches = [
        ([txn(0, writes=[pt(b"d"), pt(b"d")]),
          txn(0, reads=[pt(b"d"), pt(b"d")]),
          txn(0, writes=[pt(b"d")])], 10, 0),
        ([txn(3, reads=[pt(b"d")]), txn(10, reads=[pt(b"d")],
                                         writes=[pt(b"d")]),
          txn(10, reads=[pt(b"x")], writes=[pt(b"x")]),
          txn(10, reads=[pt(b"x")])], 20, 0),
        ([txn(20, writes=[pt(b"a")]),
          txn(20, reads=[pt(b"a")], writes=[pt(b"b")]),
          txn(20, reads=[pt(b"b")])], 30, 0),
    ]
    got = run(port, batches, port=True)
    assert got == run(ref, batches)
    assert [v for v, _ in got] == [[COMMITTED, CONFLICT, COMMITTED],
                                   [CONFLICT, COMMITTED, COMMITTED, CONFLICT],
                                   [COMMITTED, CONFLICT, COMMITTED]]
    assert_same_state(ref, port)


def test_checkpoint_round_trips_with_reference():
    batches = point_stream(17, 24)
    head, tail = batches[:16], batches[16:]
    port, ref = cpu_set(), PointConflictSet()
    run(port, head, port=True)
    run(ref, head)
    ckpt = port.checkpoint()
    assert tuple(ckpt) == tuple(ref.checkpoint())
    # the port's checkpoint restores into the reference, the reference's
    # into the port, and the port's into the pure-Python baseline
    ref_from_port = PointConflictSet()
    ref_from_port.restore(RefCheckpoint(*ckpt))
    port_from_ref = cpu_set()
    port_from_ref.restore(ConflictSetCheckpoint(*ref.checkpoint()))
    py = PyConflictSet()
    py.restore(ckpt)
    want = run(port, tail, port=True)
    assert run(ref_from_port, tail) == want
    assert run(port_from_ref, tail, port=True) == want
    assert run(py, tail, port=True) == want
    assert_same_state(ref_from_port, port_from_ref)


def test_state_carries_across_from_reference():
    batches = point_stream(23, 30)
    ref = PointConflictSet()
    run(ref, batches[:15])
    port = load_reference_point_state(
        np.asarray(ref._hk), np.asarray(ref._hv), base=ref._base,
        oldest=ref._oldest, last_commit=ref._last_commit,
        init_version=ref._init_version, key_bytes=ref._key_bytes,
        device="cpu")
    assert_same_state(ref, port)
    assert run(port, batches[15:], port=True) == run(ref, batches[15:])
    assert_same_state(ref, port)


def test_factory_and_stats():
    cs = create_conflict_set("cuda-point", device="cpu", key_bytes=16)
    assert isinstance(cs, CudaPointConflictSet)
    cs.resolve([txn(0, [pt(b"a")], [pt(b"a")])], 10, 0)
    st = cs.kernel_stats()
    assert st["backend"] == "cuda-point" and st["platform"] == "cpu"
    assert st["h2d"]["per_batch"] == 1.0


@pytest.mark.cuda
def test_cuda_stream_matches_cpu(cuda):
    batches = point_stream(5, 25)
    gpu = CudaPointConflictSet(device=cuda)
    cpu = cpu_set()
    assert run(gpu, batches, port=True) == run(cpu, batches, port=True)
    assert torch.equal(gpu._hk.cpu(), cpu._hk)
    assert torch.equal(gpu._hv.cpu(), cpu._hv)
    assert gpu.kernel_stats()["platform"] == "gpu"
