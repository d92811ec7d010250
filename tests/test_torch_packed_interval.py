"""The reference's packed-feed cases (tests/test_packed_interval.py) on
the port: the packed interval feed (one host->device transfer a batch)
against the unpacked one (INTERVAL_PACKED_FEED=0: the step's 12 inputs,
each its own transfer), verdicts and attribution, on the interval,
point and sharded backends at `device="cpu"` (the kernels' plain
versions), each held to the reference's `TpuConflictSet` /
`ShardedTpuConflictSet` under the same knob value and to the CPU models;
out-of-order pipelined drains; capacity growth and version re-basing
mid-window; and the feed path's counters: one counted transfer a batch
packed, twelve unpacked, the same bytes as the reference, and staging
that stops allocating. The knob is flipped in each package's own
SERVER_KNOBS and both are restored after.

Where the reference checks that the JAX runtime copies (never aliases)
an unaligned staging buffer, the port's hazard is its own: a pinned
staging entry must not be handed out again before the event behind its
last copy has fired. That case, and unpacked against packed on the
interval and sharded backends, run on the card under the `cuda` marker
(skipped without one). The port's sharded backend runs 4 shards split
on the first byte (the reference's, under the tests' 8-device virtual
mesh, 8): the verdicts do not depend on the split. Verdicts are
integers: equality is exact."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu.flow.knobs import (  # noqa: E402
    SERVER_KNOBS as REF_KNOBS,
)
from foundationdb_tpu.models import BruteForceConflictSet  # noqa: E402
from foundationdb_tpu.models import PyConflictSet as RefPyConflictSet  # noqa: E402
from foundationdb_tpu.models import ResolverTransaction as RefTxn  # noqa: E402
from foundationdb_tpu.models.point_resolver import (  # noqa: E402
    PointConflictSet,
)
from foundationdb_tpu.models.tpu_resolver import TpuConflictSet  # noqa: E402
from foundationdb_tpu.parallel import ShardedTpuConflictSet  # noqa: E402
from foundationdb_tpu_torch import testing  # noqa: E402
from foundationdb_tpu_torch.flow.knobs import SERVER_KNOBS  # noqa: E402
from foundationdb_tpu_torch.models import (  # noqa: E402
    PyConflictSet,
    ResolverTransaction,
)
from foundationdb_tpu_torch.models.cuda_resolver import (  # noqa: E402
    CudaConflictSet,
)
from foundationdb_tpu_torch.models.point_resolver import (  # noqa: E402
    CudaPointConflictSet,
)
from foundationdb_tpu_torch.ops import conflict_kernel as ck  # noqa: E402
from foundationdb_tpu_torch.ops.keys import encode_keys  # noqa: E402
from foundationdb_tpu_torch.parallel import (  # noqa: E402
    ShardedCudaConflictSet,
)
from test_packed_interval import rand_batches as ref_rand_batches  # noqa: E402

MWTLV = 5_000_000
N_SHARDS = 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain steps run on small tensors: one intra-op thread is
    faster here and leaves the other test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def packed_knob():
    """Flip INTERVAL_PACKED_FEED in both packages for a test and
    restore both after."""
    prev = (int(SERVER_KNOBS.interval_packed_feed),
            int(REF_KNOBS.interval_packed_feed))

    def set_packed(v):
        SERVER_KNOBS.set("interval_packed_feed", int(v))
        REF_KNOBS.set("interval_packed_feed", int(v))

    yield set_packed
    SERVER_KNOBS.set("interval_packed_feed", prev[0])
    REF_KNOBS.set("interval_packed_feed", prev[1])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return None


def streams(seed, n_batches, **kw):
    """(the port's batches, the reference's): the same stream drawn
    by each package's copy of `rand_batches`."""
    return (testing.rand_batches(seed, n_batches, **kw),
            ref_rand_batches(seed, n_batches, **kw))


def run_attributed(cs, batches):
    return [cs.resolve_with_attribution(b, v, o) for b, v, o in batches]


def interval(device="cpu", **kw):
    return CudaConflictSet(capacity=1 << 10, device=device, **kw)


def sharded(device="cpu"):
    return ShardedCudaConflictSet(capacity=1 << 10, device=device,
                                  n_shards=N_SHARDS)


def count_entries(monkeypatch):
    """Count the calls of the unpacked and packed step entries (the
    resolvers reach them through make_resolve_fn and its kin)."""
    calls = {}
    for name in ("resolve_step", "resolve_step_packed",
                 "resolve_step_sharded", "resolve_step_sharded_packed"):
        calls[name] = 0

        def wrap(*a, _f=getattr(ck, name), _n=name, **k):
            calls[_n] += 1
            return _f(*a, **k)

        monkeypatch.setattr(ck, name, wrap)
    return calls


# ---------------------------------------------------------------------------
# packed vs unpacked vs the reference and the CPU models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2, 3])
def test_packed_unpacked_bit_exact_interval(seed, packed_knob):
    batches, ref_batches = streams(seed, 30)
    got = {}
    for knob in (1, 0):
        packed_knob(knob)
        got[knob] = run_attributed(interval(), batches)
        assert got[knob] == run_attributed(TpuConflictSet(capacity=1 << 10),
                                           ref_batches), knob
    assert got[1] == got[0]
    assert got[1] == run_attributed(PyConflictSet(), batches)
    assert got[1] == run_attributed(RefPyConflictSet(), ref_batches)
    bf = BruteForceConflictSet()
    for (verdicts, _attr), (b, v, o) in zip(got[1], ref_batches):
        assert verdicts == bf.resolve(b, v, o)


@pytest.mark.parametrize("seed", [11, 12])
def test_packed_parity_sharded(seed, packed_knob):
    batches, ref_batches = streams(seed, 20)
    got = {}
    for knob in (1, 0):
        packed_knob(knob)
        got[knob] = run_attributed(sharded(), batches)
        assert got[knob] == run_attributed(
            ShardedTpuConflictSet(capacity=1 << 10), ref_batches), knob
    assert got[1] == got[0]
    assert got[1] == run_attributed(PyConflictSet(), batches)


def test_packed_parity_point_backend():
    """The point backend rides its own packed feed (no knob); parity
    with the interval backend, the CPU model and the reference's point
    backend on point-shaped batches."""
    batches, ref_batches = streams(21, 25, point=True)
    got_pt = run_attributed(
        CudaPointConflictSet(key_bytes=8, device="cpu"), batches)
    got_iv = run_attributed(CudaConflictSet(device="cpu"), batches)
    got_py = run_attributed(PyConflictSet(), batches)
    assert got_pt == got_iv == got_py
    assert got_pt == run_attributed(PointConflictSet(key_bytes=8),
                                    ref_batches)


def test_packed_attribution_with_filtered_and_tooold_ranges(packed_knob):
    """Empty ranges BETWEEN real ones shift the surviving-slot ->
    original-range-index mapping, and tooOld txns contribute no slots:
    attribution names the ORIGINAL read_ranges indices on both feeds,
    as the reference's does."""
    probe = [
        (150, (), ((b"\x12", b"\x13"), (b"\x85", b"\x86"))),
        (150, ((b"\x30", b"\x30"), (b"\x12", b"\x13"),
               (b"\x40", b"\x41"), (b"\x85", b"\x86")), ()),
        (50, ((b"\x12", b"\x13"),), ()),
    ]
    out = {}
    for knob in (1, 0):
        packed_knob(knob)
        cs = CudaConflictSet(device="cpu")
        cs.resolve([], 100, 120)
        out[knob] = cs.resolve_with_attribution(
            [ResolverTransaction(*t) for t in probe], 200, 120)
        ref = TpuConflictSet()
        ref.resolve([], 100, 120)
        assert out[knob] == ref.resolve_with_attribution(
            [RefTxn(*t) for t in probe], 200, 120), knob
    assert out[1] == out[0]
    verdicts, attr = out[1]
    assert verdicts == [2, 0, 1]         # COMMITTED, CONFLICT, TOO_OLD
    assert attr == [(), (1, 3), ()]      # ORIGINAL range indices


def growth_batches(txn_cls):
    rng = random.Random(99)
    batches = []
    v = 0
    for _ in range(12):
        v += rng.randrange(1, 300_000_000)
        batch = [txn_cls(max(0, v - rng.randrange(0, MWTLV)),
                         ((bytes([rng.randrange(250)]), bytes([251])),),
                         ((bytes([rng.randrange(250)]), bytes([251])),))
                 for _ in range(rng.randrange(1, 6))]
        batches.append((batch, v, max(0, v - MWTLV)))
    return batches


@pytest.mark.parametrize("backend", ["interval", "sharded"])
def test_growth_and_rebase_mid_window_packed(backend, packed_knob):
    """Capacity growth (a 1,024-row history) and version jumps past
    2^30 land mid-stream; both feeds stay equal to the reference's and
    to the CPU model throughout."""
    batches = growth_batches(ResolverTransaction)
    ref_batches = growth_batches(RefTxn)

    def mk():
        return interval() if backend == "interval" else sharded()

    def mk_ref():
        if backend == "interval":
            return TpuConflictSet(capacity=1 << 10)
        return ShardedTpuConflictSet(capacity=1 << 10)

    got = {}
    for knob in (1, 0):
        packed_knob(knob)
        got[knob] = run_attributed(mk(), batches)
        assert got[knob] == run_attributed(mk_ref(), ref_batches), knob
    assert got[1] == got[0]
    assert got[1] == run_attributed(PyConflictSet(), batches)


def test_pipeline_out_of_order_drain_packed(packed_knob):
    """A full in-flight window of packed batches drained in REVERSE
    order equals the serial unpacked resolve, the port's and the
    reference's."""
    prev = int(SERVER_KNOBS.resolve_pipeline_depth)
    packed_knob(1)
    SERVER_KNOBS.set("resolve_pipeline_depth", 4)
    try:
        batches, ref_batches = streams(31, 12, max_txns=6)
        cs = interval()
        results, pending = {}, []
        for i, (b, v, o) in enumerate(batches):
            pending.append((i, cs.submit(b, v, o)))
            if len(pending) == 3:
                for j, t in reversed(pending):
                    results[j] = cs.drain(t)
                pending.clear()
        for j, t in reversed(pending):
            results[j] = cs.drain(t)
        packed_knob(0)
        serial = interval()
        ref = TpuConflictSet(capacity=1 << 10)
        for i, ((b, v, o), rb) in enumerate(zip(batches, ref_batches)):
            want = ref.resolve(rb[0], v, o)
            assert results[i] == serial.resolve(b, v, o) == want, i
    finally:
        SERVER_KNOBS.set("resolve_pipeline_depth", prev)


# ---------------------------------------------------------------------------
# the feed path's counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["interval", "sharded"])
def test_one_transfer_per_batch_counted(backend, packed_knob,
                                        monkeypatch):
    """Packed: one counted transfer a batch through the packed entry.
    The interval backend's transfers and bytes are the reference's; the
    reference's sharded feed counts one put per mesh device (8 under
    the virtual mesh), the port's one copy to its one card."""
    packed_knob(1)
    batches, ref_batches = streams(41, 15, max_txns=6)
    cs = interval() if backend == "interval" else sharded()
    calls = count_entries(monkeypatch)
    for b, v, o in batches:
        cs.resolve(b, v, o)
    st = cs.kernel_stats()
    dispatched = st["batches"]
    assert dispatched > 0
    assert st["h2d"]["transfers"] == dispatched
    assert st["h2d"]["per_batch"] == 1.0
    assert st["h2d"]["bytes"] > 0
    entry = "resolve_step" if backend == "interval" else \
        "resolve_step_sharded"
    assert calls[entry + "_packed"] == dispatched and calls[entry] == 0
    ref = (TpuConflictSet() if backend == "interval"
           else ShardedTpuConflictSet(capacity=1 << 10))
    for b, v, o in ref_batches:
        ref.resolve(b, v, o)
    rst = ref.kernel_stats()
    assert rst["batches"] == dispatched
    puts = 1 if backend == "interval" else len(ref._mesh.devices.flat)
    assert rst["h2d"]["transfers"] == puts * dispatched
    assert rst["h2d"]["bytes"] == puts * st["h2d"]["bytes"]


@pytest.mark.parametrize("backend", ["interval", "sharded"])
def test_unpacked_fallback_counts_many_transfers(backend, packed_knob,
                                                 monkeypatch):
    """The unpacked feed really is the multi-transfer path: every batch
    goes through the unpacked step entry with 12 counted transfers, the
    reference's count and bytes, and takes no staging."""
    packed_knob(0)
    batches, ref_batches = streams(42, 6, max_txns=6)
    cs = interval() if backend == "interval" else sharded()
    calls = count_entries(monkeypatch)
    for b, v, o in batches:
        cs.resolve(b, v, o)
    st = cs.kernel_stats()
    assert st["batches"] > 0
    assert st["h2d"]["per_batch"] >= 10
    assert st["h2d"]["staging_allocs"] == 0
    entry = "resolve_step" if backend == "interval" else \
        "resolve_step_sharded"
    assert calls[entry] == st["batches"] and calls[entry + "_packed"] == 0
    ref = (TpuConflictSet() if backend == "interval"
           else ShardedTpuConflictSet(capacity=1 << 10))
    for b, v, o in ref_batches:
        ref.resolve(b, v, o)
    rst = ref.kernel_stats()
    assert (st["batches"], st["h2d"]["transfers"], st["h2d"]["bytes"]) == (
        rst["batches"], rst["h2d"]["transfers"], rst["h2d"]["bytes"])


def test_staging_allocation_flat(packed_knob):
    """A steady same-shape stream: staging allocations stop once the
    rotating pool (pipeline depth + 2) and the encode scratch exist,
    while transfers keep climbing 1:1 with batches; the unpacked feed
    allocates no staging at all."""
    rng = random.Random(5)

    def batch(v):
        return [ResolverTransaction(
            max(0, v - 500), ((bytes([rng.randrange(200)]), bytes([201])),),
            ((bytes([rng.randrange(200)]), bytes([201])),))
            for _ in range(4)]

    packed_knob(1)
    cs = CudaConflictSet(device="cpu")
    v = 0
    for _ in range(8):     # warmup: fills the rotating pool
        v += 100
        cs.resolve(batch(v), v, max(0, v - 5000))
    warm = cs.kernel_stats()["h2d"]["staging_allocs"]
    assert warm > 0
    for _ in range(20):
        v += 100
        cs.resolve(batch(v), v, max(0, v - 5000))
    st = cs.kernel_stats()
    assert st["h2d"]["staging_allocs"] == warm, \
        "steady-state batches must not allocate staging"
    assert st["h2d"]["transfers"] == st["batches"]
    packed_knob(0)
    for _ in range(8):
        v += 100
        cs.resolve(batch(v), v, max(0, v - 5000))
    assert cs.kernel_stats()["h2d"]["staging_allocs"] == warm


@pytest.mark.cuda
def test_staging_buffer_never_aliased_by_device(card, packed_knob):
    """The port's staging hazard: a pinned entry is handed out again
    only after the event behind its last host->device copy has fired,
    and writing over its host buffer once that copy has landed leaves
    the batch's verdicts as they were."""
    packed_knob(1)
    batches = testing.rand_batches(51, 24, max_txns=8)
    py = PyConflictSet()
    want = [py.resolve(b, v, o) for b, v, o in batches]
    for scribble in (False, True):
        cs = CudaConflictSet(capacity=1 << 10, device=card)
        handed = []
        take = cs._staging_views

        def checked(*a):
            ent = take(*a)
            # a reused entry's last copies have landed before it is
            # handed out (one event a card the entry went to)
            assert all(ev.query() for ev in ent.events)
            handed.append(ent)
            return ent

        cs._staging_views = checked
        tickets = []
        for b, v, o in batches:
            tickets.append(cs.submit(b, v, o))
            if scribble:
                handed[-1].wait()
                handed[-1].buf[:] = 0xFFFFFFFF    # after the copy landed
        assert [cs.drain(t) for t in tickets] == want, scribble
        assert len({id(e) for e in handed}) < len(handed), "no entry reused"


def encoded_arrays(seed, v):
    rng = np.random.default_rng(seed)
    n = 8
    ks = rng.integers(0, 30, size=2 * n)
    enc = encode_keys([b"%02d" % k for k in ks], 8)
    ends = enc.copy()
    ends[:, -1] += 1       # end = key + b"\x00"
    snapshots = np.full(n, v - 50, np.int64)
    has_reads = np.ones(n, bool)
    ids = np.arange(n, dtype=np.int32)
    return (snapshots, has_reads, enc[:n], ends[:n], ids,
            enc[n:], ends[n:], ids)


def test_resolve_arrays_rides_packed_path(packed_knob):
    """The pre-encoded entry (resolve_arrays) uses the same feeds: one
    transfer a batch packed, twelve unpacked, and verdicts equal to each
    other and to the reference's under each knob value."""
    outs = {}
    for knob in (1, 0):
        packed_knob(knob)
        cs = CudaConflictSet(key_bytes=8, device="cpu")
        ref = TpuConflictSet(key_bytes=8)
        got = []
        for i in range(6):
            v = 100 * (i + 1)
            conflict, too_old = cs.resolve_arrays(
                *encoded_arrays(i, v), commit_version=v,
                new_oldest_version=0)
            r_conflict, r_too_old = ref.resolve_arrays(
                *encoded_arrays(i, v), commit_version=v,
                new_oldest_version=0)
            got.append((np.asarray(conflict)[:8].tolist(),
                        np.asarray(too_old).tolist()))
            assert got[-1] == (np.asarray(r_conflict)[:8].tolist(),
                               np.asarray(r_too_old).tolist()), (knob, i)
        outs[knob] = got
        st = cs.kernel_stats()
        assert st["batches"] == 6
        assert st["h2d"]["transfers"] == (6 if knob else 72)
    assert outs[1] == outs[0]


# ---------------------------------------------------------------------------
# on the card: the unpacked feed against the packed one
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["interval", "sharded"])
def test_unpacked_equals_packed_on_card(backend, card, packed_knob,
                                        monkeypatch):
    """On the card the unpacked feed launches the unpacked kernel entry
    (K3 or K8 unpacked) with 12 transfers a batch, the packed feed the
    packed one with 1, and both give the CPU model's verdicts and
    attribution, across growth from 1,024 rows and a re-base."""
    batches = testing.rand_batches(61, 30) + [
        (b, v + (1 << 30), o + (1 << 30))
        for b, v, o in testing.rand_batches(62, 10)]
    want = run_attributed(PyConflictSet(), batches)
    entry = "resolve_step" if backend == "interval" else \
        "resolve_step_sharded"
    for knob, per_batch in ((1, 1.0), (0, 12.0)):
        packed_knob(knob)
        calls = count_entries(monkeypatch)
        cs = interval(card) if backend == "interval" else sharded(card)
        assert run_attributed(cs, batches) == want, knob
        st = cs.kernel_stats()
        assert st["platform"] == "gpu"
        assert st["h2d"]["per_batch"] == per_batch
        name = entry if knob == 0 else entry + "_packed"
        assert calls[name] == st["batches"] > 0
        monkeypatch.undo()
