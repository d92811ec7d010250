"""Port parity for models/cuda_resolver.py: CudaConflictSet on the CPU
(the kernels' plain versions) gives the same verdicts and attribution
as the reference's TpuConflictSet and PyConflictSet on randomized
streams, through capacity growth, rebases past 2^30, version jumps of
2^30 and more, out-of-order pipelined drains and checkpoint/restore; it
keeps the reference's ValueError contracts; and a reference backend's
state carries across into the port with identical verdicts and state
afterwards."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu.models import PyConflictSet as RefPy  # noqa: E402
from foundationdb_tpu.models.tpu_resolver import TpuConflictSet  # noqa: E402
from foundationdb_tpu_torch.flow.knobs import SERVER_KNOBS  # noqa: E402
from foundationdb_tpu_torch.models import (  # noqa: E402
    CONFLICT,
    ConflictSetCheckpoint,
    PyConflictSet,
    ResolverTransaction,
    create_conflict_set,
)
from foundationdb_tpu_torch.models.cuda_resolver import (  # noqa: E402
    CudaConflictSet,
    load_reference_state,
)
from test_packed_interval import rand_batches, txn  # noqa: E402

MWTLV = 5_000_000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def port_batches(batches):
    """The same batches as the port's own transaction type."""
    return [([ResolverTransaction(*t) for t in b], v, o)
            for b, v, o in batches]


def run_attributed(cs, batches):
    return [cs.resolve_with_attribution(b, v, o) for b, v, o in batches]


def cpu_set(**kw):
    return CudaConflictSet(device="cpu", **kw)


def assert_same_state(tpu, port):
    np.testing.assert_array_equal(np.asarray(tpu._hk), port._hk.numpy())
    np.testing.assert_array_equal(np.asarray(tpu._hv), port._hv.numpy())
    assert (tpu._base, tpu._oldest, tpu._last_commit, tpu._cap) == \
        (port._base, port._oldest, port._last_commit, port._cap)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_parity_with_reference_backends(seed):
    batches = rand_batches(seed, 30)
    tpu = TpuConflictSet(capacity=1 << 10)
    got_ref = run_attributed(tpu, batches)
    port = cpu_set(capacity=1 << 10)
    got = run_attributed(port, port_batches(batches))
    assert got == got_ref
    assert got == run_attributed(PyConflictSet(), port_batches(batches))
    assert_same_state(tpu, port)


@pytest.mark.parametrize("pipelined", [False, True])
def test_growth_rebase_and_jumps_mid_stream(pipelined):
    """Tiny initial capacity (growth), strides that cross the 2^30
    rebase threshold, and one jump of >= 2^30 with pre-jump snapshots
    live (the placeholder + fixup path), resolved one batch at a time
    and with every batch submitted before the first drain at pipeline
    depth 4 (the capacity audit then reads the oldest pending count)."""
    rng = random.Random(99)
    batches = []
    v = 0
    for i in range(14):
        v += rng.randrange(1, 300_000_000)
        if i == 9:
            v += (1 << 31) + 5
        batch = [txn(max(0, v - rng.randrange(0, MWTLV)),
                     [(bytes([rng.randrange(250)]), bytes([251]))],
                     [(bytes([rng.randrange(250)]),
                       bytes([rng.randrange(250)]) + b"\x01")])
                 for _ in range(rng.randrange(1, 6))]
        batches.append((batch, v, max(0, v - MWTLV)))
    # plenty of distinct keys so the 1024-row history must grow
    for i in range(6):
        v += 1000
        batch = [txn(v - 10, [], [(b"g%05d" % (i * 200 + j),
                                   b"g%05d\x00" % (i * 200 + j))])
                 for j in range(200)]
        batches.append((batch, v, max(0, v - MWTLV)))
    port = cpu_set(capacity=1 << 10)
    if pipelined:
        SERVER_KNOBS.set("resolve_pipeline_depth", 4)
        try:
            tickets = [port.submit(b, v, o, attribute=True)
                       for b, v, o in port_batches(batches)]
            got = [port.drain_with_attribution(t) for t in tickets]
        finally:
            SERVER_KNOBS.set("resolve_pipeline_depth",
                             SERVER_KNOBS._defaults["RESOLVE_PIPELINE_DEPTH"])
    else:
        got = run_attributed(port, port_batches(batches))
    tpu = TpuConflictSet(capacity=1 << 10)
    assert got == run_attributed(tpu, batches)
    assert got == run_attributed(RefPy(), batches)
    assert port._cap > 1 << 10 and port._base > 0
    assert_same_state(tpu, port)


def test_giant_jump_beyond_int32():
    port, tpu = cpu_set(), TpuConflictSet()
    for cs in (port, tpu):
        cs.resolve([txn(0, writes=[(b"a", b"b")])], 100, 0)
    for jump in (1 << 32, 1 << 33):
        batch = [txn(jump - 10, reads=[(b"a", b"b")]),
                 txn(jump - 10, writes=[(b"c", b"d")])]
        assert port.resolve(port_batches([(batch, 0, 0)])[0][0], jump,
                            jump - MWTLV) == tpu.resolve(batch, jump,
                                                         jump - MWTLV)
    v = (1 << 33) + 50
    batch = [txn((1 << 33) - 5, reads=[(b"c", b"d")])]
    assert port.resolve(batch, v, v - MWTLV) == \
        tpu.resolve(batch, v, v - MWTLV) == [CONFLICT]
    assert_same_state(tpu, port)


def test_out_of_order_drains_match_serial():
    SERVER_KNOBS.set("resolve_pipeline_depth", 4)
    try:
        batches = port_batches(rand_batches(31, 14, max_txns=6))
        cs = cpu_set(capacity=1 << 10)
        results, pending = {}, []
        for i, (b, v, o) in enumerate(batches):
            pending.append((i, cs.submit(b, v, o, attribute=i % 2 == 0)))
            if len(pending) == 3:
                for j, t in reversed(pending):
                    results[j] = cs.drain(t)
                    assert cs.drain(t) == results[j]   # idempotent
                pending.clear()
        for j, t in reversed(pending):
            results[j] = cs.drain(t)
        serial = cpu_set(capacity=1 << 10)
        for i, (b, v, o) in enumerate(batches):
            assert results[i] == serial.resolve(b, v, o), i
    finally:
        SERVER_KNOBS.set("resolve_pipeline_depth",
                         SERVER_KNOBS._defaults["RESOLVE_PIPELINE_DEPTH"])


def test_checkpoint_restore_round_trip():
    batches = rand_batches(17, 30)
    head, tail = port_batches(batches[:18]), port_batches(batches[18:])
    port = cpu_set(capacity=1 << 10)
    run_attributed(port, head)
    ckpt = port.checkpoint()
    tpu = TpuConflictSet(capacity=1 << 10)
    run_attributed(tpu, batches[:18])
    # the reference's checkpoint restores into the port, and the port's
    # into a fresh port and into the pure-Python baseline
    from_ref = cpu_set()
    from_ref.restore(ConflictSetCheckpoint(*tpu.checkpoint()))
    assert tuple(ConflictSetCheckpoint(*tpu.checkpoint())) == tuple(ckpt)
    restored = cpu_set()
    restored.restore(ckpt)
    py = PyConflictSet()
    py.restore(ckpt)
    want = run_attributed(port, tail)
    assert run_attributed(restored, tail) == want
    assert run_attributed(from_ref, tail) == want
    assert run_attributed(py, tail) == want


def test_value_error_contracts():
    cs = cpu_set(key_bytes=16)
    cs.resolve([txn(0, writes=[(b"a", b"b")])], 100, 0)
    with pytest.raises(ValueError):
        cs.resolve([txn(0, writes=[(b"a", b"b")])], 50, 0)
    with pytest.raises(ValueError):
        cs.resolve([txn(0, writes=[(b"x" * 17, b"y" * 17)])], 200, 0)
    from foundationdb_tpu_torch.ops.keys import encode_keys
    k = encode_keys([b"a", b"b"], 16)
    for rt, wt in (([1, 0], [0, 1]), ([0, 1], [1, 0])):
        with pytest.raises(ValueError):
            cs.resolve_arrays(np.array([100, 100]), np.array([1, 1]),
                              k, k, np.array(rt), k, k, np.array(wt),
                              300, 0)
    with pytest.raises(ValueError):
        cs.resolve_arrays(np.array([100]), np.array([1]), k[:1], k[:1],
                          np.array([0]), k[:1], k[:1], np.array([0]), 50, 0)
    with pytest.raises(ValueError):
        CudaConflictSet(key_bytes=6, device="cpu")
    with pytest.raises(OverflowError):
        cs.resolve([txn(0, writes=[(b"a", b"b")])], 1 << 31, 0)


def test_state_carries_across_from_reference():
    batches = rand_batches(23, 40)
    tpu = TpuConflictSet(capacity=1 << 10)
    run_attributed(tpu, batches[:20])
    port = load_reference_state(
        np.asarray(tpu._hk), np.asarray(tpu._hv), base=tpu._base,
        oldest=tpu._oldest, last_commit=tpu._last_commit,
        init_version=tpu._init_version, key_bytes=tpu._key_bytes,
        device="cpu")
    assert_same_state(tpu, port)
    assert run_attributed(port, port_batches(batches[20:])) == \
        run_attributed(tpu, batches[20:])
    assert_same_state(tpu, port)


def test_factory_and_stats():
    cs = create_conflict_set("cuda", device="cpu", key_bytes=16)
    assert isinstance(cs, CudaConflictSet)
    assert isinstance(create_conflict_set("python"), PyConflictSet)
    with pytest.raises(ValueError):
        create_conflict_set("tpu")
    cs.resolve([txn(0, [(b"a", b"b")], [(b"a", b"b")])], 10, 0)
    st = cs.kernel_stats()
    assert st["backend"] == "cuda" and st["platform"] == "cpu"
    assert st["h2d"]["per_batch"] == 1.0


@pytest.mark.cuda
def test_cuda_stream_matches_cpu(cuda):
    batches = port_batches(rand_batches(5, 30))
    gpu = CudaConflictSet(capacity=1 << 10, device=cuda)
    cpu = cpu_set(capacity=1 << 10)
    assert run_attributed(gpu, batches) == run_attributed(cpu, batches)
    assert torch.equal(gpu._hk.cpu(), cpu._hk)
    assert torch.equal(gpu._hv.cpu(), cpu._hv)
    assert gpu.kernel_stats()["platform"] == "gpu"
