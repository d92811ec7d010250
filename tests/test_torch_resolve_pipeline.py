"""The reference's split submit/drain pipeline cases
(tests/test_resolve_pipeline.py, all but the cluster stress, which
waits for the port's sim cluster) on the port's device backends:
pipelined verdicts equal serial ones on directed and randomized
streams, attribution through drained tickets, out-of-order drains,
depth 1 as the synchronous path, version order, capacity growth and
re-basing mid-pipeline, the pre-encoded array path, the pipeline's
counters, the host backend's eager tickets and a row count that does
not drain. Each runs over `cuda`, `cuda-point` and `sharded-cuda` at
`device="cpu"` (4 shards split on the first key byte), and again on the
card under the `cuda` marker; the serial verdicts are also held to the
reference's backend of the same kind (`TpuConflictSet`,
`PointConflictSet`) and to its brute-force set on the same batches."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu.models import BruteForceConflictSet  # noqa: E402
from foundationdb_tpu.models import ResolverTransaction as RefTxn  # noqa: E402
from foundationdb_tpu.models.point_resolver import (  # noqa: E402
    PointConflictSet as RefPointConflictSet,
)
from foundationdb_tpu.models.tpu_resolver import TpuConflictSet  # noqa: E402
from foundationdb_tpu_torch.flow.knobs import SERVER_KNOBS  # noqa: E402
from foundationdb_tpu_torch.models import (  # noqa: E402
    PyConflictSet,
    ResolverTransaction,
    create_conflict_set,
)

MWTLV = 5_000_000
BACKENDS = ("interval", "point", "sharded")
NAMES = {"interval": "cuda", "point": "cuda-point", "sharded": "sharded-cuda"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain steps run on small tensors: one intra-op thread is
    faster here and leaves the other test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def on(kinds):
    """Parameters (kind, device) for each kind: the CPU path, and the
    card under the `cuda` marker."""
    return [(k, "cpu") for k in kinds] + [
        pytest.param((k, None), marks=pytest.mark.cuda,
                     id=f"{k}-card") for k in kinds]


@pytest.fixture
def depth_knob():
    """Set RESOLVE_PIPELINE_DEPTH for a test and restore it after."""
    prev = SERVER_KNOBS.resolve_pipeline_depth

    def set_depth(d):
        SERVER_KNOBS.set("resolve_pipeline_depth", d)

    yield set_depth
    SERVER_KNOBS.set("resolve_pipeline_depth", prev)


def make_backend(where, **kw):
    """The port's backend of `where` = (kind, device); skipped on the
    card when there is none."""
    kind, dev = where
    if dev is None and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if kind == "sharded":
        kw.setdefault("n_shards", 4)
    return create_conflict_set(NAMES[kind], device=dev, **kw)


def reference_backend(kind, **kw):
    return RefPointConflictSet(**kw) if kind == "point" \
        else TpuConflictSet(**kw)


def txn(snapshot, reads=(), writes=()):
    return ResolverTransaction(snapshot, tuple(reads), tuple(writes))


def rand_batches(seed, n_batches, point=False, n_keys=40, max_txns=8,
                 version_stride=2000, window=5000):
    """The reference test's stream: [(batch, commit_version,
    new_oldest_version)] with keys spread over the whole byte range (so
    every shard sees traffic), occasional empty batches, and snapshots
    that sometimes fall below the window."""
    rng = random.Random(seed)
    out = []
    v = 0

    def key():
        return bytes([rng.randrange(256)]) + b"%02d" % rng.randrange(n_keys)

    def rd():
        k = key()
        if point:
            return (k, k + b"\x00")
        return (k, k + bytes([rng.randrange(1, 8)]))

    for _ in range(n_batches):
        v += rng.randrange(1, version_stride)
        batch = []
        for _ in range(rng.randrange(0, max_txns)):
            reads = [rd() for _ in range(rng.randrange(0, 3))]
            writes = [rd() for _ in range(rng.randrange(0, 3))]
            snap = max(0, v - rng.randrange(0, 2 * window))
            batch.append(txn(snap, reads, writes))
        out.append((batch, v, max(0, v - window)))
    return out


def as_ref(batch):
    return [RefTxn(*t) for t in batch]


def run_serial(cs, batches):
    return [cs.resolve(b, v, o) for b, v, o in batches]


def run_pipelined(cs, batches, window=4, attribute=False):
    """Submit with up to `window` tickets pending, drain in order."""
    got, pending = [], []

    def drain(t):
        return cs.drain_with_attribution(t) if attribute else cs.drain(t)

    for b, v, o in batches:
        pending.append(cs.submit(b, v, o, attribute=attribute))
        if len(pending) >= window:
            got.append(drain(pending.pop(0)))
    got.extend(drain(t) for t in pending)
    return got


def held_to_reference(kind, batches, want, **kw):
    """The serial verdicts equal the reference's backend of the same
    kind and its brute-force set on the same batches."""
    ref = reference_backend(kind, **kw)
    brute = BruteForceConflictSet()
    assert want == [ref.resolve(as_ref(b), v, o) for b, v, o in batches]
    assert want == [brute.resolve(as_ref(b), v, o) for b, v, o in batches]


@pytest.mark.parametrize("where", on(BACKENDS))
def test_pipelined_matches_serial_directed(where, depth_knob):
    """Write in batch 1, conflicting and clean reads in later batches,
    with an intra-batch write->read dependency chain in flight."""
    depth_knob(4)
    point = where[0] == "point"

    def pt(k):
        return (k, k + b"\x00") if point else (k, k + b"\x08")

    batches = [
        ([txn(0, writes=[pt(b"\x10aa")]), txn(0, writes=[pt(b"\x90bb")])],
         100, 0),
        ([txn(50, reads=[pt(b"\x10aa")]),
          txn(150, reads=[pt(b"\x10aa")]),
          txn(150, reads=[pt(b"\x90bb")], writes=[pt(b"\x90cc")])],
         200, 0),
        ([txn(250, writes=[pt(b"\x90cc")]),
          txn(250, reads=[pt(b"\x90cc")]),
          txn(250, reads=[pt(b"\x90bb")])],
         300, 0),
        ([], 400, 0),
        ([txn(350, reads=[pt(b"\x90cc")]),
          txn(450, reads=[pt(b"\x90cc")])],
         500, 0),
    ]
    want = run_serial(make_backend(where), batches)
    held_to_reference(where[0], batches, want)
    assert run_pipelined(make_backend(where), batches, window=4) == want


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("where", on(BACKENDS))
def test_pipelined_matches_serial_randomized(where, seed, depth_knob):
    depth_knob(4)
    batches = rand_batches(seed, 30, point=where[0] == "point")
    want = run_serial(make_backend(where), batches)
    held_to_reference(where[0], batches, want)
    assert run_pipelined(make_backend(where), batches, window=4) == want


@pytest.mark.parametrize("where", on(("interval", "point")))
def test_pipelined_attribution_parity(where, depth_knob):
    """drain_with_attribution on in-flight tickets returns the same
    (verdicts, causes) as the synchronous resolve_with_attribution."""
    depth_knob(4)
    batches = rand_batches(5, 20, point=where[0] == "point")
    serial = make_backend(where)
    want = [serial.resolve_with_attribution(b, v, o) for b, v, o in batches]
    got = run_pipelined(make_backend(where), batches, window=4,
                        attribute=True)
    assert [g[0] for g in got] == [w[0] for w in want]
    assert [g[1] for g in got] == [w[1] for w in want]


@pytest.mark.parametrize("where", on(BACKENDS))
def test_out_of_order_drain(where, depth_knob):
    depth_knob(8)
    batches = rand_batches(3, 8, point=where[0] == "point")
    want = run_serial(make_backend(where), batches)
    piped = make_backend(where)
    tickets = [piped.submit(b, v, o) for b, v, o in batches]
    order = list(range(len(tickets)))
    random.Random(9).shuffle(order)
    got = [None] * len(tickets)
    for i in order:
        got[i] = piped.drain(tickets[i])
    assert got == want
    # draining again returns the cached result, not a recompute
    assert piped.drain(tickets[0]) == want[0]
    assert piped.pipeline.stats()["drains"] == len(tickets)


@pytest.mark.parametrize("where", on(("interval",)))
def test_depth_one_degenerates_to_serial_path(where, depth_knob):
    """At depth 1 every submit force-drains its predecessor: at most
    one batch in flight, verdicts unchanged."""
    depth_knob(1)
    batches = rand_batches(4, 12)
    want = run_serial(make_backend(where), batches)
    piped = make_backend(where)
    tickets = []
    for b, v, o in batches:
        tickets.append(piped.submit(b, v, o))
        assert len(piped.pipeline.in_flight) <= 1
    assert [piped.drain(t) for t in tickets] == want
    stats = piped.pipeline.stats()
    assert stats["depth"] == 1
    assert stats["forced_drains"] > 0
    assert stats["peak_in_flight"] <= 1


@pytest.mark.parametrize("where", on(("interval",)))
def test_submit_requires_nondecreasing_versions(where, depth_knob):
    depth_knob(4)
    cs = make_backend(where)
    cs.submit([txn(0, writes=[(b"a", b"b")])], 100, 0)
    with pytest.raises(ValueError):
        cs.submit([txn(0, writes=[(b"c", b"d")])], 50, 0)


@pytest.mark.parametrize("where", on(BACKENDS))
def test_capacity_growth_mid_pipeline(where, depth_knob):
    """A tiny initial capacity forces doubling while tickets are in
    flight; the growth cannot corrupt submitted batches' verdicts."""
    depth_knob(4)
    point = where[0] == "point"
    rng = random.Random(6)
    batches = []
    v = 0
    for i in range(24):
        v += 10
        writes = []
        for j in range(24):
            k = bytes([rng.randrange(256)]) + b"%04d" % (i * 24 + j)
            writes.append((k, k + b"\x00") if point else (k, k + b"\x02"))
        reads = []
        if i > 2:
            k = bytes([rng.randrange(256)]) + b"%04d" % rng.randrange(i * 24)
            reads.append((k, k + b"\x00") if point else (k, k + b"\x02"))
        batches.append(([txn(v - 10, reads, writes)], v, 0))
    want = run_serial(make_backend(where, capacity=64), batches)
    held_to_reference(where[0], batches, want, capacity=64)
    piped = make_backend(where, capacity=64)
    assert run_pipelined(piped, batches, window=4) == want
    assert piped._cap > 64


@pytest.mark.parametrize("where", on(BACKENDS))
def test_rebase_mid_pipeline(where, depth_knob):
    """Version offsets crossing the 2^30 re-base threshold while the
    window is full: K4's re-base rides the same chain of states."""
    depth_knob(4)
    point = where[0] == "point"
    rng = random.Random(13)
    batches = []
    v = 0
    rd = (b"a", b"a\x00") if point else (b"a", b"c")
    for _ in range(12):
        v += 300_000_000
        batch = [txn(v - rng.randrange(0, MWTLV // 2),
                     reads=[rd] if rng.random() < 0.5 else [],
                     writes=[(b"b", b"b\x00")] if rng.random() < 0.5 else [])
                 for _ in range(5)]
        batches.append((batch, v, v - MWTLV))
    want = run_serial(make_backend(where), batches)
    held_to_reference(where[0], batches, want)
    piped = make_backend(where)
    assert run_pipelined(piped, batches, window=4) == want
    assert piped._base > 0


@pytest.mark.parametrize("where", on(("point",)))
def test_submit_arrays_matches_resolve_arrays(where, depth_knob):
    """The pre-encoded pipelined path (what the bench drives) returns
    the same conflict flags as the synchronous array path."""
    depth_knob(4)
    from foundationdb_tpu_torch.ops.keys import encode_keys

    rng = np.random.default_rng(11)
    n, kb = 32, 8
    a = make_backend(where, key_bytes=kb, capacity=1 << 12)
    b = make_backend(where, key_bytes=kb, capacity=1 << 12)

    def enc_batch(v):
        rk = [b"%06d" % k for k in rng.integers(0, 200, n)]
        wk = [b"%06d" % k for k in rng.integers(0, 200, n)]
        keys = encode_keys(rk + wk, kb)
        snaps = np.full(n, max(0, v - 150), np.int64)
        tids = np.arange(n, dtype=np.int32)
        return (snaps, np.ones(n, bool), keys[:n], None, tids,
                keys[n:], None, tids)

    batches = [(enc_batch((i + 1) * 100), (i + 1) * 100) for i in range(10)]
    serial_out = []
    for arrs, v in batches:
        conflict, too_old = a.resolve_arrays(
            *arrs, commit_version=v, new_oldest_version=0)
        serial_out.append((np.asarray(conflict)[:n].copy(),
                           np.asarray(too_old).copy()))
    tickets = [b.submit_arrays(*arrs, commit_version=v, new_oldest_version=0)
               for arrs, v in batches]
    for (want_c, want_t), t in zip(serial_out, tickets):
        got_c, got_t = b.drain_arrays(t)
        assert (np.asarray(got_c)[:n] == want_c).all()
        assert (np.asarray(got_t) == want_t).all()


@pytest.mark.parametrize("where", on(("point",)))
def test_pipeline_stats_and_kernel_stats(where, depth_knob):
    depth_knob(3)
    cs = make_backend(where)
    run_pipelined(cs, rand_batches(8, 10, point=True), window=3)
    stats = cs.pipeline_stats()
    assert stats["submits"] == 10
    assert stats["drains"] == 10
    assert stats["in_flight"] == 0
    assert 1 <= stats["peak_in_flight"] <= 3
    assert stats["occupancy"] is not None and 0 < stats["occupancy"] <= 1
    assert stats["latency"]["submit"]["total"] == 10
    # drain latency only counts drains that actually blocked
    assert stats["latency"]["drain"]["total"] <= 10
    assert cs.kernel_stats()["pipeline"]["submits"] == 10


def test_base_backend_submit_drain_parity(depth_knob):
    """Host backends get the same ticket API (eager, depth-free): the
    resolver role runs one code path whatever the backend."""
    depth_knob(4)
    batches = rand_batches(2, 15)
    serial = PyConflictSet()
    want = [serial.resolve_with_attribution(b, v, o) for b, v, o in batches]
    piped = PyConflictSet()
    assert run_pipelined(piped, batches, window=4, attribute=True) == want
    stats = piped.pipeline_stats()
    assert stats["submits"] == 15
    assert stats["drains"] == 15
    assert stats["in_flight"] == 0        # eager tickets never queue


@pytest.mark.parametrize("where", on(("interval",)))
def test_interval_count_does_not_drain_pipeline(where, depth_knob):
    """With tickets in flight, reading interval_count leaves the
    un-arrived tail of the count copies pending; after a full sync the
    estimate converges to the exact count."""
    depth_knob(4)
    cs = make_backend(where)
    pending = [cs.submit(b, v, o) for b, v, o in rand_batches(7, 6)]
    assert cs.interval_count >= 0
    for t in pending:
        cs.drain(t)
    cs._sync_count()
    assert cs.interval_count == cs._count_hint
