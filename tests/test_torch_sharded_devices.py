"""The per-device sharded resolver: one shard a device, K8 split at its
cross-shard combine into K8e (a shard's external read flags) and K8f
(the rest of the step from every shard's flags), against the
reference's ShardedTpuConflictSet on the 8 virtual CPU devices:

  - the stream: `ShardedCudaConflictSet(devices=["cpu"] * 8)` against
    the reference's 8-device mesh, batch by batch: verdicts, read_hit,
    every shard's history, the checkpoint and the h2d counters under
    both feeds; and the reference's own sharded cases (a cross-shard
    range, intra-batch across shards, randomized parity with the
    brute-force model, growth, re-bases and a version jump);
  - the step: K8e's and K8f's plain versions over D shards against the
    lockstep plain step, on the adversarial batch kinds of
    `foundationdb_tpu_torch.testing` and the clip-edge kinds at three
    key widths;
  - the per-device form against the lockstep form (n_shards=8) over a
    stream, serial and pipelined at two depths; the port's
    `dryrun_multichip`; the device-list contract and its faults.

Every output is integer or boolean: equality is exact. The card's
cases are in test_torch_sharded_devices_cuda.py, which imports no JAX."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu.models import BruteForceConflictSet  # noqa: E402
from foundationdb_tpu.models import PyConflictSet as RefPy  # noqa: E402
from foundationdb_tpu.parallel import ShardedTpuConflictSet  # noqa: E402
from foundationdb_tpu_torch import device as fdev  # noqa: E402
from foundationdb_tpu_torch import testing as tg  # noqa: E402
from foundationdb_tpu_torch.flow.knobs import SERVER_KNOBS  # noqa: E402
from foundationdb_tpu_torch.models import (  # noqa: E402
    ResolverTransaction,
    create_conflict_set,
    create_resilient_conflict_set,
)
from foundationdb_tpu_torch.models.conflict_set import (  # noqa: E402
    step_from_checkpoint,
)
from foundationdb_tpu_torch.ops import conflict_kernel as ck  # noqa: E402
from foundationdb_tpu_torch.ops import rmq  # noqa: E402
from foundationdb_tpu_torch.ops.fault_injection import (  # noqa: E402
    DeviceFaultError,
    g_device_faults,
)
from foundationdb_tpu_torch.parallel import (  # noqa: E402
    ShardedCudaConflictSet,
    dryrun_multichip,
    load_reference_sharded_state,
)
from foundationdb_tpu_torch.testing import rand_batches, txn  # noqa: E402

MWTLV = 5_000_000
CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain steps run on small tensors: one intra-op thread is
    faster here and leaves the other test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def depth_knob():
    def set_depth(d):
        SERVER_KNOBS.set("resolve_pipeline_depth", d)

    yield set_depth
    SERVER_KNOBS.set("resolve_pipeline_depth",
                     SERVER_KNOBS._defaults["RESOLVE_PIPELINE_DEPTH"])


@pytest.fixture
def feed_knob():
    saved = int(SERVER_KNOBS.interval_packed_feed)
    yield
    SERVER_KNOBS.set("interval_packed_feed", saved)


def port_batches(batches):
    return [([ResolverTransaction(*t) for t in b], v, o)
            for b, v, o in batches]


def run_attributed(cs, batches):
    return [cs.resolve_with_attribution(b, v, o) for b, v, o in batches]


def per_device(devices=CPU8, **kw):
    return ShardedCudaConflictSet(devices=devices,
                                  capacity=kw.pop("capacity", 1024), **kw)


def assert_same_shards(ref, port):
    """Every shard's history on its device equals the reference's shard
    of its [S, cap] arrays; the version bookkeeping too."""
    rhk, rhv = np.asarray(ref._hk), np.asarray(ref._hv)
    assert len(port._hk) == rhk.shape[0]
    for i, (k, v) in enumerate(zip(port._hk, port._hv)):
        np.testing.assert_array_equal(k.numpy(), rhk[i], err_msg=f"HK {i}")
        np.testing.assert_array_equal(v.numpy(), rhv[i], err_msg=f"HV {i}")
    assert (ref._base, ref._oldest, ref._last_commit, ref._cap) == \
        (port._base, port._oldest, port._last_commit, port._cap)


# ---------------------------------------------------------------------------
# the stream against the reference's 8-device mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2])
def test_stream_matches_reference_mesh(seed):
    batches = rand_batches(seed, 20)
    ref = ShardedTpuConflictSet(capacity=1024)
    port = per_device()
    assert ref._n_shards == port._n_shards == 8
    for (b, v, o), (pb, _v, _o) in zip(batches, port_batches(batches)):
        assert port.resolve_with_attribution(pb, v, o) == \
            ref.resolve_with_attribution(b, v, o)
        assert_same_shards(ref, port)
    assert tuple(port.checkpoint()) == tuple(ref.checkpoint())


@pytest.mark.parametrize("packed", [1, 0], ids=["packed", "unpacked"])
def test_h2d_counters_match_reference(packed, feed_knob):
    """The reference counts one transfer a device a packed batch and one
    an input an unpacked one (its feed goes to one device and jit
    replicates it): the port's per-device form counts the same."""
    from foundationdb_tpu.flow.knobs import SERVER_KNOBS as REF_KNOBS
    ref_saved = int(REF_KNOBS.interval_packed_feed)
    SERVER_KNOBS.set("interval_packed_feed", packed)
    REF_KNOBS.set("interval_packed_feed", packed)
    try:
        batches = rand_batches(11, 8)
        ref = ShardedTpuConflictSet(capacity=1024)
        port = per_device()
        assert run_attributed(port, port_batches(batches)) == \
            run_attributed(ref, batches)
        assert_same_shards(ref, port)
        got, want = port.kernel_stats()["h2d"], ref.kernel_stats()["h2d"]
    finally:
        REF_KNOBS.set("interval_packed_feed", ref_saved)
    assert got == want
    assert got["per_batch"] == (8.0 if packed else 12.0)


@pytest.mark.parametrize("pipelined", [False, True])
def test_growth_rebase_and_jumps(pipelined, depth_knob):
    """Growth past 1024 rows, strides across the 2^30 re-base threshold
    and a jump of more than 2^31 with pre-jump snapshots live (K4 on
    every device's versions), serial and pipelined at depth 4."""
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
    for i in range(6):
        v += 1000
        batch = [txn(v - 10, [], [(b"g%05d" % (i * 200 + j),
                                   b"g%05d\x00" % (i * 200 + j))])
                 for j in range(200)]
        batches.append((batch, v, max(0, v - MWTLV)))
    port = per_device()
    if pipelined:
        depth_knob(4)
        tickets = [port.submit(b, v, o, attribute=True)
                   for b, v, o in port_batches(batches)]
        got = [port.drain_with_attribution(t) for t in tickets]
    else:
        got = run_attributed(port, port_batches(batches))
    ref = ShardedTpuConflictSet(capacity=1024)
    assert got == run_attributed(ref, batches)
    assert got == run_attributed(RefPy(), batches)
    assert port._cap > 1024 and port._base > 0
    assert_same_shards(ref, port)
    assert tuple(port.checkpoint()) == tuple(ref.checkpoint())


def test_cross_shard_range_conflict():
    """A single range spanning every shard boundary behaves as one."""
    sh = per_device()
    sh.resolve([txn(0, writes=[(b"\x01", b"\xfe")])], 100, 0)
    got = sh.resolve(
        [txn(50, reads=[(b"\x70", b"\x90")]),
         txn(50, reads=[(b"\x00", b"\x01")]),
         txn(100, reads=[(b"\x01", b"\xfe")])], 200, 0)
    assert got == [0, 2, 2]


def test_intra_batch_across_shards():
    """Writer on one device's shard, reader on another's, in the same
    batch: the gathered flags and the one matrix see the dependency."""
    sh = per_device()
    got = sh.resolve(
        [txn(0, writes=[(b"\x10", b"\x11")]),
         txn(0, reads=[(b"\x10", b"\x11")], writes=[(b"\xf0", b"\xf1")]),
         txn(0, reads=[(b"\xf0", b"\xf1")])], 100, 0)
    assert got == [2, 0, 2]


@pytest.mark.parametrize("seed", [31, 32])
def test_randomized_parity_with_brute_force(seed):
    rng = random.Random(seed)
    sh = per_device()
    brute = BruteForceConflictSet()

    def rrange():
        a = bytes([rng.randrange(256), rng.randrange(8)])
        b = bytes([rng.randrange(256), rng.randrange(8)])
        if a > b:
            a, b = b, a
        if a == b:
            b = a + b"\x00"
        return a, b

    version = 0
    for bi in range(16):
        version += rng.randrange(1, 300_000)
        oldest = max(0, version - MWTLV)
        batch = [txn(max(0, version - rng.randrange(0, int(1.2 * MWTLV))),
                     [rrange() for _ in range(rng.randrange(0, 4))],
                     [rrange() for _ in range(rng.randrange(0, 4))])
                 for _ in range(rng.randrange(1, 16))]
        assert sh.resolve_with_attribution(batch, version, oldest) == \
            brute.resolve_with_attribution(batch, version, oldest), bi


def test_growth_on_one_shard():
    """Every key in shard 0's range: one device's load grows the one
    capacity of all."""
    sh = per_device()
    v = 0
    for i in range(30):
        v += 10
        writes = [(b"\x00" + b"%04d" % (i * 50 + j),
                   b"\x00" + b"%04d\x00" % (i * 50 + j)) for j in range(50)]
        sh.resolve([txn(v - 10, writes=writes)], v, 0)
    assert sh._cap > 1024
    assert all(k.shape[0] == sh._cap for k in sh._hk)
    # CONFLICT (0) below the last write, COMMITTED (2) at it
    assert sh.resolve([txn(0, reads=[(b"\x00", b"\xff")])], v + 1, 0) == [0]
    assert sh.resolve([txn(v, reads=[(b"\x00", b"\xff")])], v + 2, 0) == [2]


def test_checkpoint_restore_and_reference_state():
    batches = rand_batches(17, 24)
    head, tail = batches[:14], batches[14:]
    port = per_device()
    run_attributed(port, port_batches(head))
    ckpt = port.checkpoint()
    ref = ShardedTpuConflictSet(capacity=1024)
    run_attributed(ref, head)
    assert tuple(ref.checkpoint()) == tuple(ckpt)
    restored = per_device(["cpu"] * 4)
    restored.restore(ckpt)
    carried = load_reference_sharded_state(
        np.asarray(ref._hk), np.asarray(ref._hv), base=ref._base,
        oldest=ref._oldest, last_commit=ref._last_commit,
        init_version=ref._init_version, key_bytes=ref._key_bytes,
        split_keys=ref._split_keys[1:], devices=CPU8)
    assert_same_shards(ref, carried)
    want = run_attributed(ref, tail)
    assert run_attributed(port, port_batches(tail)) == want
    assert run_attributed(restored, port_batches(tail)) == want
    assert run_attributed(carried, port_batches(tail)) == want
    assert_same_shards(ref, carried)
    with pytest.raises(ValueError):
        load_reference_sharded_state(
            np.asarray(ref._hk), np.asarray(ref._hv), base=0, oldest=0,
            last_commit=0, init_version=0, key_bytes=ref._key_bytes,
            split_keys=ref._split_keys[1:], devices=["cpu"] * 4)


# ---------------------------------------------------------------------------
# the step: K8e's and K8f's plain versions against the lockstep step
# ---------------------------------------------------------------------------

KIND_SHAPE = (1024, 32, 64, 64)  # cap, T, R, Wr


def kind_case(kind, n_shards, n_words=2, seed=0):
    """A kind's batch on its history sharded at the quantiles of the
    kind's keys: (HK[S], HV[S], lows, highs, arrays, T, R, Wr)."""
    cap, T, R, Wr = KIND_SHAPE
    splits = tg.split_ids(4 * T, n_shards)
    hk, hv, arrays = tg.adversarial_batch(
        np.random.default_rng(seed), kind, cap, T, R, Wr, n_words,
        splits=splits or None)
    lows, highs = tg.shard_bounds(splits, n_words)
    shk, shv = tg.shard_history(hk, hv, lows, highs)
    return shk, shv, lows, highs, arrays, T, R, Wr


def split_steps(shk, shv, lows, highs, feed, attribute, packed, dims=None):
    """K8e on every shard, its rows stacked as the all-gather leaves
    them, then K8f on every shard: (HK'[S], HV'[S], count[S], each
    shard's conflict and read_hit). `feed` is (buf, T, R, Wr) packed or
    the 12 inputs."""
    n = shk.shape[0]
    exts = []
    for i in range(n):
        if packed:
            buf, T, R, Wr = feed
            exts.append(ck.resolve_shard_ext_packed(
                shk[i], shv[i], buf, lows[i], highs[i], T, R, Wr))
        else:
            exts.append(ck.resolve_shard_ext(shk[i], shv[i], *feed, lows[i],
                                             highs[i]))
    ext_all = torch.stack(exts)
    outs = []
    for i in range(n):
        if packed:
            buf, T, R, Wr = feed
            outs.append(ck.resolve_shard_finish_packed(
                shk[i], shv[i], buf, lows[i], highs[i], ext_all, T, R, Wr,
                attribute=attribute))
        else:
            outs.append(ck.resolve_shard_finish(
                shk[i], shv[i], *feed, lows[i], highs[i], ext_all,
                attribute=attribute))
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]),
            torch.stack([o[2] for o in outs]),
            [o[3] for o in outs], [o[4] for o in outs])


def assert_split_equals_lockstep(case, attribute, packed):
    shk, shv, lows, highs, arrays, T, R, Wr = case
    lows_t, highs_t = torch.from_numpy(lows), torch.from_numpy(highs)
    state = (torch.from_numpy(shk), torch.from_numpy(shv))
    for commit in (tg.COMMIT, tg.COMMIT + 20):   # fresh, then a step on
        buf = torch.from_numpy(ck.pack_interval_batch(*arrays, commit,
                                                      tg.OLDEST))
        unpacked = ck.interval_unpack(buf, T, R, Wr, shk.shape[-1] - 1)
        want = ck.resolve_step_sharded_plain(*state, *unpacked, lows_t,
                                             highs_t, attribute=attribute)
        feed = (buf, T, R, Wr) if packed else unpacked
        hk, hv, count, conflicts, hits = split_steps(
            *state, lows_t, highs_t, feed, attribute, packed)
        assert torch.equal(hk, want[0]) and torch.equal(hv, want[1])
        assert torch.equal(count, want[2])
        for c, h in zip(conflicts, hits):
            assert torch.equal(c, want[3])
            assert (h is None) == (want[4] is None)
            if h is not None:
                assert torch.equal(h, want[4])
        state = want[:2]


@pytest.mark.parametrize("kind", tg.KINDS)
@pytest.mark.parametrize("n_shards", [1, 4])
def test_split_plain_equals_lockstep_on_kinds(kind, n_shards):
    assert_split_equals_lockstep(kind_case(kind, n_shards), True, True)


@pytest.mark.parametrize("n_words", [4, 8, 12])
@pytest.mark.parametrize("kind", ["split_edges", "clip_edges"])
@pytest.mark.parametrize("attribute", [True, False])
def test_split_plain_equals_lockstep_at_clip_edges(n_words, kind, attribute):
    assert_split_equals_lockstep(kind_case(kind, 4, n_words, seed=n_words),
                                 attribute, packed=attribute)


def test_split_plain_on_empty_ranges():
    """Valid empty and inverted ranges in the feed: K8f's one matrix
    counts them invalid, as every shard's clip does; none conflicts."""
    T, R, Wr, width = 16, 32, 32, 3

    def row(k):
        return (0, k, 4)
    rb = np.zeros((R, width), np.uint32)
    re = np.zeros((R, width), np.uint32)
    wb = np.zeros((Wr, width), np.uint32)
    we = np.zeros((Wr, width), np.uint32)
    rt, wt = np.full(R, T, np.int32), np.full(Wr, T, np.int32)
    rv, wv = np.zeros(R, bool), np.zeros(Wr, bool)
    for i, (b, e) in enumerate(((8, 36), (48, 48), (64, 56))):
        wb[i], we[i], wt[i], wv[i] = row(b), row(e), 0, True
    for i, (b, e) in enumerate(((16, 16), (24, 20), (44, 52), (54, 66))):
        rb[i], re[i], rt[i], rv[i] = row(b), row(e), i + 1, True
    arrays = (np.full(T, 60, np.int32), np.zeros(T, bool), rb, re, rt, rv,
              wb, we, wt, wv)
    lows = np.zeros((4, width), np.uint32)
    for k in range(1, 4):
        lows[k] = (0, 16 * k, 4)
    highs = np.full_like(lows, 0xFFFFFFFF)
    highs[:-1] = lows[1:]
    hk = np.full((4, 1024, width), 0xFFFFFFFF, np.uint32)
    hv = np.full((4, 1024), rmq.VDEAD, np.int32)
    hk[:, 0], hv[:, 0] = lows, 0
    case = (hk, hv, lows, highs, arrays, T, R, Wr)
    assert_split_equals_lockstep(case, True, True)
    buf = torch.from_numpy(ck.pack_interval_batch(*arrays, tg.COMMIT,
                                                  tg.OLDEST))
    out = split_steps(torch.from_numpy(hk), torch.from_numpy(hv),
                      torch.from_numpy(lows), torch.from_numpy(highs),
                      (buf, T, R, Wr), True, True)
    assert not bool(out[3][0].any()) and not bool(out[4][0].any())


def test_split_entries_reject_bad_shapes():
    hk = torch.zeros((1024, 3), dtype=torch.uint32)
    hv = torch.zeros(1024, dtype=torch.int32)
    row = torch.zeros(3, dtype=torch.uint32)
    with pytest.raises(ValueError):
        ck.resolve_shard_ext_packed(hk, hv, torch.zeros(7, dtype=torch.uint32),
                                    row, row, 16, 32, 32)
    with pytest.raises(ValueError):
        ck.resolve_shard_finish_packed(
            hk, hv, torch.zeros(7, dtype=torch.uint32), row, row,
            torch.zeros((2, 32), dtype=torch.bool), 16, 32, 32)
    assert ck.shard_scratch(hk, 16, 32, 32) is None


# ---------------------------------------------------------------------------
# the per-device form against the lockstep form
# ---------------------------------------------------------------------------

def stitched(cs):
    rows, vers = cs._stitched_rows()
    return rows, vers + cs._base


@pytest.mark.parametrize("seed", [3, 4])
def test_per_device_equals_lockstep(seed):
    batches = port_batches(rand_batches(seed, 24))
    lock = ShardedCudaConflictSet(device="cpu", n_shards=8, capacity=1024)
    port = per_device()
    for b, v, o in batches:
        assert port.resolve_with_attribution(b, v, o) == \
            lock.resolve_with_attribution(b, v, o)
    for a, b in zip(stitched(port), stitched(lock)):
        np.testing.assert_array_equal(a, b)
    hk, hv = port._host_state()
    np.testing.assert_array_equal(hk, lock._hk.numpy())
    np.testing.assert_array_equal(hv, lock._hv.numpy())
    assert step_from_checkpoint(port.checkpoint()) == \
        step_from_checkpoint(lock.checkpoint())


def _run_pipelined(cs, batches, window=4):
    got, pending = [], []
    for b, v, o in batches:
        pending.append(cs.submit(b, v, o, attribute=True))
        if len(pending) >= window:
            got.append(cs.drain_with_attribution(pending.pop(0)))
    got.extend(cs.drain_with_attribution(t) for t in pending)
    return got


@pytest.mark.parametrize("depth", [2, 4])
def test_pipelined_equals_serial(depth, depth_knob):
    batches = port_batches(rand_batches(5, 24))
    serial = per_device(["cpu"] * 4)
    want = run_attributed(serial, batches)
    depth_knob(depth)
    piped = per_device(["cpu"] * 4)
    assert _run_pipelined(piped, batches, window=depth) == want
    # out of order: each window of three drained newest first
    tickets = []
    ooo = per_device(["cpu"] * 4)
    got = {}
    for i, (b, v, o) in enumerate(batches):
        tickets.append((i, ooo.submit(b, v, o, attribute=True)))
        if len(tickets) == 3:
            for j, t in reversed(tickets):
                got[j] = ooo.drain_with_attribution(t)
            tickets.clear()
    for j, t in reversed(tickets):
        got[j] = ooo.drain_with_attribution(t)
    assert [got[i] for i in range(len(batches))] == want
    for a, b in zip(stitched(piped), stitched(serial)):
        np.testing.assert_array_equal(a, b)


def test_capacity_growth_mid_pipeline(depth_knob):
    depth_knob(4)
    rng = random.Random(6)
    batches = []
    v = 0
    for i in range(24):
        v += 10
        writes = []
        for j in range(24):
            k = bytes([rng.randrange(32)]) + b"%04d" % (i * 24 + j)
            writes.append((k, k + b"\x02"))
        reads = []
        if i > 2:
            k = bytes([rng.randrange(32)]) + b"%04d" % rng.randrange(i * 24)
            reads.append((k, k + b"\x02"))
        batches.append(([txn(v - 10, reads, writes)], v, 0))
    serial = per_device(capacity=64)
    want = [serial.resolve(b, v, o) for b, v, o in batches]
    piped = per_device(capacity=64)
    got, pending = [], []
    for b, v, o in batches:
        pending.append(piped.submit(b, v, o))
        if len(pending) >= 4:
            got.append(piped.drain(pending.pop(0)))
    got.extend(piped.drain(t) for t in pending)
    assert got == want
    assert piped._cap > 1024


def test_dryrun_multichip_on_eight_cpu_devices():
    assert dryrun_multichip(8, devices=CPU8) >= 120 + 6
    with pytest.raises(AssertionError):
        dryrun_multichip(8, devices=["cpu"] * 4)


# ---------------------------------------------------------------------------
# the device-list contract
# ---------------------------------------------------------------------------

def test_device_list_contract(monkeypatch):
    cs = per_device(["cpu"] * 4, key_bytes=16)
    assert cs._n_shards == 4 and len(cs._hk) == 4
    assert all(k.shape == (1024, 5) for k in cs._hk)
    assert cs.kernel_stats()["platform"] == "cpu"
    with pytest.raises(ValueError):
        per_device(["cpu", "cuda:0"])
    with pytest.raises(ValueError):
        per_device([])
    with pytest.raises(ValueError):
        per_device(["cpu"] * 4, n_shards=8)
    with pytest.raises(ValueError):
        per_device(["cpu"] * 4, split_keys=[b"\x10"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(fdev.NoCudaDeviceError):
        per_device(["cuda:0"] * 2)
    with pytest.raises(fdev.NoCudaDeviceError):
        dryrun_multichip(2)
    # without a card the default stays one shard on the CPU path
    assert ShardedCudaConflictSet(device="cpu")._devices is None


def test_factory_wrapper_and_role_take_devices():
    """`devices` reaches the backend through the factory, the failover
    wrapper and the resolver role's `backend_kwargs`."""
    from foundationdb_tpu_torch import flow
    from foundationdb_tpu_torch.rpc import SimNetwork
    from foundationdb_tpu_torch.server.resolver_role import Resolver
    batches = rand_batches(8, 6)
    cs = create_conflict_set("sharded-cuda", device="cpu",
                             devices=["cpu"] * 4)
    assert isinstance(cs, ShardedCudaConflictSet) and cs._n_shards == 4
    wrapped = create_resilient_conflict_set("sharded-cuda", device="cpu",
                                            devices=["cpu"] * 4)
    py = RefPy()
    want = [py.resolve(b, v, o) for b, v, o in batches]
    assert [wrapped.resolve(b, v, o)
            for b, v, o in port_batches(batches)] == want
    sched = flow.Scheduler()
    flow.set_scheduler(sched)
    try:
        net = SimNetwork(sched, flow.g_random)
        role = Resolver(net.new_process("resolver"), "sharded-cuda",
                        device="cpu", backend_kwargs={"devices": CPU8})
        b, v, o = port_batches(batches)[0]
        assert role.conflict_set.resolve(b, v, o) == want[0]
        assert role.conflict_set.kernel_stats()["backend"] == "sharded-cuda"
    finally:
        flow.set_scheduler(None)


def test_device_fault_on_a_shard_fails_the_resolver():
    """A fault injected at a launch of any device's K8e or K8f raises
    DeviceFaultError out of the resolve: no verdict, and no fallback."""
    cs = per_device(["cpu"] * 4)
    batches = port_batches(rand_batches(9, 4))
    b, v, o = batches[0]
    cs.resolve(b, v, o)
    g_device_faults.schedule("submit")
    try:
        with pytest.raises(DeviceFaultError):
            cs.resolve(*batches[1])
    finally:
        g_device_faults.clear()
