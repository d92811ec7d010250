"""Port parity for the key-range sharded resolver (parallel/ and K8's
plain version in ops/conflict_kernel.py), against the reference's
ShardedTpuConflictSet on the 8 virtual CPU devices:

  - step level: one packed host buffer through the reference's
    shard_map'd packed step and `resolve_step_sharded_packed` on the
    CPU (and the unpacked entries likewise), at 1, 4 and 8 shards, with
    ranges crossing every split and ranges ending or starting on one:
    per-shard HK/HV, count[S], verdicts and attribution;
  - stream level: verdicts, attribution and per-shard state after every
    batch over several seeds at 4 and 8 shards, growth past the initial
    capacity, re-bases and version jumps mid-stream, pipelined and
    out-of-order drains, the stitched checkpoint and restore onto fresh
    backends, and a reference state carried into the port;
  - the reference's own sharded cases, one for one (cross-shard range,
    intra-batch across shards, randomized parity with the brute-force
    model, growth, attribution, the pipeline cases);
  - the factory, the split-key contract, and no card without asking;
  - the adversarial batch kinds of `foundationdb_tpu_torch.testing`
    (the shard-edge kind among them) on a history sharded at the
    kind's quartiles: the port's plain sharded step against the
    reference's shard_map'd packed step, from the fresh state and one
    step later, attributed and not.

Every output is integer or boolean: equality is exact. The CUDA-marked
cases hold K8 to its plain version on the card, on those kinds at 1
and 4 shards and at key widths that take the endpoint sort's two widest
record sizes."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from foundationdb_tpu.models import BruteForceConflictSet  # noqa: E402
from foundationdb_tpu.models import PyConflictSet as RefPy  # noqa: E402
from foundationdb_tpu.parallel import ShardedTpuConflictSet  # noqa: E402
from foundationdb_tpu_torch import device as fdev  # noqa: E402
from foundationdb_tpu_torch import testing as tg  # noqa: E402
from foundationdb_tpu_torch.flow.knobs import SERVER_KNOBS  # noqa: E402
from foundationdb_tpu_torch.models import (  # noqa: E402
    CONFLICT_BACKENDS,
    ResolverTransaction,
    create_conflict_set,
)
from foundationdb_tpu_torch.models.conflict_set import (  # noqa: E402
    step_from_checkpoint,
)
from foundationdb_tpu_torch.models.cuda_resolver import (  # noqa: E402
    CudaConflictSet,
)
from foundationdb_tpu_torch.ops import conflict_kernel as ck  # noqa: E402
from foundationdb_tpu_torch.ops import keys  # noqa: E402
from foundationdb_tpu_torch.ops.keys import encode_keys  # noqa: E402
from foundationdb_tpu_torch.ops.keys import next_pow2  # noqa: E402
from foundationdb_tpu_torch.parallel import (  # noqa: E402
    ShardedCudaConflictSet,
    default_split_keys,
    load_reference_sharded_state,
)
from foundationdb_tpu_torch.testing import rand_batches, txn  # noqa: E402

MWTLV = 5_000_000
KEY_BYTES = 8
W = KEY_BYTES // 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


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


def port_batches(batches):
    return [([ResolverTransaction(*t) for t in b], v, o)
            for b, v, o in batches]


def run_attributed(cs, batches):
    return [cs.resolve_with_attribution(b, v, o) for b, v, o in batches]


def sharded(n_shards=8, **kw):
    """The port on the CPU; 8 shards by default, as the reference's
    mesh of 8 virtual devices gives it."""
    return ShardedCudaConflictSet(device="cpu", n_shards=n_shards,
                                  capacity=kw.pop("capacity", 1024), **kw)


def assert_same_state(ref, port):
    np.testing.assert_array_equal(np.asarray(ref._hk), port._hk.numpy())
    np.testing.assert_array_equal(np.asarray(ref._hv), port._hv.numpy())
    assert (ref._base, ref._oldest, ref._last_commit, ref._cap) == \
        (port._base, port._oldest, port._last_commit, port._cap)


# ---------------------------------------------------------------------------
# step level: K8's plain version against the reference's sharded step
# ---------------------------------------------------------------------------

def split_batch(rng, n_shards, n_txns=12):
    """Transactions whose ranges cross every split, end exactly on one,
    start exactly on one, and fall anywhere; with write->read chains."""
    splits = default_split_keys(n_shards)
    out = [txn(90, [(b"", b"\xff\xff")], [(b"\x01", b"\xfe")])]
    for s in splits:
        out.append(txn(95, [(b"\x00", s)], [(s, s + b"\x00")]))
        out.append(txn(95, [(s, s + b"\x01")], [(b"\x05", s)]))
    for _ in range(n_txns):
        def rng_range():
            a, b = sorted(bytes([rng.randrange(256)]) for _ in range(2))
            return (a, b + b"\x02")
        out.append(txn(rng.randrange(60, 120),
                       [rng_range() for _ in range(rng.randrange(3))],
                       [rng_range() for _ in range(rng.randrange(3))]))
    return out


def empty_range_batch():
    """Valid empty and inverted ranges, which every shard's clip marks
    invalid. Counted as valid, each read of transactions 1-4 would
    overlap a write of transaction 0 (the [0x10, 0x48) write, the empty
    write at 0x60, the inverted write [0x80, 0x70)); as it is, none
    conflicts."""
    return [txn(95, [], [(b"\x10", b"\x48"), (b"\x60", b"\x60"),
                         (b"\x80", b"\x70")]),
            txn(95, [(b"\x20", b"\x20")]),
            txn(95, [(b"\x30", b"\x28")]),
            txn(95, [(b"\x58", b"\x68")]),
            txn(95, [(b"\x6c", b"\x84")])]


def feed(batch, commit, oldest, keep_empty=False):
    """One batch's packed feed at version base 0 (ranges flattened in
    txn order, padded to the shape bucket) and its 10 arrays. Empty and
    inverted ranges are dropped, as the resolver drops them, unless
    `keep_empty`: then they go in as valid ranges."""
    T = next_pow2(max(len(batch), 16))
    rr = [(t, b, e) for t, tr in enumerate(batch)
          for b, e in tr.read_ranges if keep_empty or b < e]
    ww = [(t, b, e) for t, tr in enumerate(batch)
          for b, e in tr.write_ranges if keep_empty or b < e]
    R = next_pow2(max(len(rr), 32))
    Wr = next_pow2(max(len(ww), 32))

    def ranges(rs, n):
        b = np.zeros((n, W + 1), np.uint32)
        e = np.zeros((n, W + 1), np.uint32)
        ids = np.full(n, T, np.int32)
        valid = np.zeros(n, bool)
        if rs:
            b[:len(rs)] = encode_keys([x[1] for x in rs], KEY_BYTES)
            e[:len(rs)] = encode_keys([x[2] for x in rs], KEY_BYTES)
            ids[:len(rs)] = [x[0] for x in rs]
            valid[:len(rs)] = True
        return b, e, ids, valid

    rb, re, rt, rv = ranges(rr, R)
    wb, we, wt, wv = ranges(ww, Wr)
    snap = np.zeros(T, np.int32)
    snap[:len(batch)] = [tr.read_snapshot for tr in batch]
    too_old = np.zeros(T, bool)
    arrays = (snap, too_old, rb, re, rt, rv, wb, we, wt, wv)
    return ck.pack_interval_batch(*arrays, commit, oldest), arrays, T, R, Wr


def reference_after(n_shards, seed, n_batches=4):
    """A reference sharded resolver with some history, and its state as
    numpy arrays."""
    ref = ShardedTpuConflictSet(capacity=1024, n_shards=n_shards,
                                key_bytes=KEY_BYTES)
    for b, v, o in rand_batches(seed, n_batches, version_stride=20,
                                window=80):
        ref.resolve(b, v, o)
    return ref, np.array(ref._hk), np.array(ref._hv)


def _np(outs):
    return [None if x is None else np.asarray(x) for x in outs]


def _port_bounds(ref):
    lows, highs = ref._shard_bounds
    return torch.from_numpy(np.array(lows)), torch.from_numpy(
        np.array(highs))


def step_batch(kind, n_shards):
    """The step-level batches: `split` crosses and meets every split;
    `empty` holds valid empty and inverted ranges (fed as they are)."""
    if kind == "empty":
        return empty_range_batch()
    return split_batch(random.Random(n_shards), n_shards)


STEP_CASES = pytest.mark.parametrize(
    "n_shards,kind", [(1, "split"), (4, "split"), (8, "split"),
                      (1, "empty"), (4, "empty")],
    ids=["1", "4", "8", "1-empty", "4-empty"])


@STEP_CASES
@pytest.mark.parametrize("attribute", [True, False])
def test_packed_step_matches_reference(n_shards, attribute, kind):
    ref, hk, hv = reference_after(n_shards, 40 + n_shards)
    batch = step_batch(kind, n_shards)
    buf, _arrays, T, R, Wr = feed(batch, 130, 20,
                                  keep_empty=kind == "empty")
    fn = ref._get_shard_packed_fn(T, R, Wr, attribute)
    lows, highs = ref._shard_bounds
    state = jax.device_put((hk, hv), NamedSharding(ref._mesh, P(ref.AXIS)))
    want = _np(fn(lows, highs, *state, ref._feed(buf)))
    got = ck.resolve_step_sharded_packed(
        torch.from_numpy(hk), torch.from_numpy(hv), torch.from_numpy(buf),
        *_port_bounds(ref), T, R, Wr, attribute=attribute)
    assert got[0].shape == (n_shards, 1024, W + 1)
    assert (got[4] is None) == (not attribute)
    for name, g, w in zip(("HK", "HV", "count", "conflict", "read_hit"),
                          _np(got), want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    # the empty ranges would each conflict, were they counted as valid
    assert want[3][:len(batch)].any() == (kind == "split")


@pytest.mark.parametrize("attribute", [True, False])
def test_unpacked_step_matches_reference(attribute):
    n_shards = 4
    ref, hk, hv = reference_after(n_shards, 7)
    _buf, arrays, T, R, Wr = feed(split_batch(random.Random(3), n_shards),
                                  130, 20)
    fn = ref._get_shard_fn(T, R, Wr, attribute)
    lows, highs = ref._shard_bounds
    state = jax.device_put((hk, hv), NamedSharding(ref._mesh, P(ref.AXIS)))
    want = _np(fn(lows, highs, *state, *[jnp.asarray(a) for a in arrays],
                  jnp.int32(130), jnp.int32(20)))
    got = _np(ck.resolve_step_sharded(
        torch.from_numpy(hk), torch.from_numpy(hv),
        *[torch.from_numpy(a) for a in arrays], 130, 20,
        *_port_bounds(ref), attribute=attribute))
    for name, g, w in zip(("HK", "HV", "count"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    # the reference's unpacked step returns its combined flags per shard
    np.testing.assert_array_equal(got[3], want[3][0])
    if attribute:
        np.testing.assert_array_equal(got[4], want[4][0])


def test_single_shard_step_is_k3s():
    """S = 1 with the bounds [b"", +inf) is the single-shard step."""
    rng = np.random.default_rng(2)
    cs = CudaConflictSet(device="cpu", key_bytes=KEY_BYTES)
    for b, v, o in port_batches(rand_batches(9, 5)):
        cs.resolve(b, v, o)
    buf, _arrays, T, R, Wr = feed(split_batch(random.Random(1), 4), 40000,
                                  int(rng.integers(0, 100)))
    buf = torch.from_numpy(buf)
    lows = torch.zeros((1, W + 1), dtype=torch.uint32)
    highs = torch.full((1, W + 1), 0xFFFFFFFF, dtype=torch.uint32)
    want = ck.resolve_step_packed(cs._hk, cs._hv, buf, T, R, Wr)
    got = ck.resolve_step_sharded_packed(cs._hk[None], cs._hv[None], buf,
                                         lows, highs, T, R, Wr)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g[0], w)
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])


def test_step_rejects_bad_shapes():
    hk = torch.zeros((2, 1024, W + 1), dtype=torch.uint32)
    hv = torch.zeros((2, 1024), dtype=torch.int32)
    lows = torch.zeros((2, W + 1), dtype=torch.uint32)
    with pytest.raises(ValueError):
        ck.resolve_step_sharded_packed(hk, hv, torch.zeros(7, dtype=torch.uint32),
                                       lows, lows, 16, 32, 32)
    with pytest.raises(ValueError):
        ck.resolve_step_sharded_packed(hk[0], hv[0],
                                       torch.zeros(7, dtype=torch.uint32),
                                       lows, lows, 16, 32, 32)


KIND_SHAPE = (1024, 32, 64, 64)  # cap, T, R, Wr


def kind_case(kind, n_shards, n_words=W, seed=0):
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


@pytest.fixture(scope="module")
def ref4():
    """One reference sharded resolver at the kinds' shape: its jitted
    packed steps are compiled once for every kind."""
    return ShardedTpuConflictSet(capacity=KIND_SHAPE[0], n_shards=4,
                                 key_bytes=KEY_BYTES)


def _kind_against_reference(ref, case, kind, attribute):
    """The plain sharded step against `ref`'s shard_map'd packed step on
    a `kind_case`, fresh and one step on."""
    shk, shv, lows, highs, arrays, T, R, Wr = case
    fn = ref._get_shard_packed_fn(T, R, Wr, attribute)
    bounds = ref._make_bounds(lows)
    state = (shk, shv)
    for commit in (tg.COMMIT, tg.COMMIT + 20):   # fresh, then a step on
        buf = ck.pack_interval_batch(*arrays, commit, tg.OLDEST)
        dev_state = jax.device_put(state,
                                   NamedSharding(ref._mesh, P(ref.AXIS)))
        want = _np(fn(*bounds, *dev_state, ref._feed(buf)))
        got = _np(ck.resolve_step_sharded_packed(
            torch.from_numpy(state[0]), torch.from_numpy(state[1]),
            torch.from_numpy(buf), torch.from_numpy(lows),
            torch.from_numpy(highs), T, R, Wr, attribute=attribute))
        for name, g, w in zip(("HK", "HV", "count", "conflict", "read_hit"),
                              got, want):
            np.testing.assert_array_equal(g, w, err_msg=f"{kind} {name}")
        state = (want[0], want[1])


@pytest.mark.parametrize("kind", tg.KINDS)
@pytest.mark.parametrize("attribute", [True, False])
def test_packed_step_matches_reference_on_kinds(ref4, kind, attribute):
    _kind_against_reference(ref4, kind_case(kind, 4), kind, attribute)


def test_split_edges_kind_hits_its_corners():
    """The shard-edge kind's ranges start and end on split keys, span
    every shard, and no write reaches the last shard, which so has no
    survivor."""
    shk, _shv, lows, highs, arrays, T, R, Wr = kind_case("split_edges", 4)
    rb, re, wb, we, wv = arrays[2], arrays[3], arrays[6], arrays[7], \
        arrays[9]
    splits = [tuple(x) for x in lows[1:]]
    assert any(tuple(x) in splits for x in rb)
    assert any(tuple(x) in splits for x in re)
    assert any(tuple(b) < splits[0] and tuple(e) > splits[-1]
               for b, e in zip(rb, re))
    assert all(tuple(e) <= splits[-1] for e in we[wv])
    out = ck.resolve_step_sharded_packed(
        torch.from_numpy(shk), torch.from_numpy(_shv),
        torch.from_numpy(ck.pack_interval_batch(*arrays, tg.COMMIT,
                                                tg.OLDEST)),
        torch.from_numpy(lows), torch.from_numpy(highs), T, R, Wr)
    # the history holds versions below the commit: only survivors write
    # it, into every shard but the last
    wrote = (out[1] == tg.COMMIT).any(dim=1).tolist()
    assert wrote == [True, True, True, False]


def test_clip_edges_kind_hits_its_corners():
    """The clip-edge kind's reads begin and end exactly on a bound and
    on the key one past it, are emptied by a shard's clip (valid and
    non-empty, invalid once clipped to that shard), cover the whole
    keyspace or are inverted; the history holds the bounds and the keys
    one past them; and some reads conflict with the history."""
    shk, shv, lows, highs, arrays, T, R, Wr = kind_case("clip_edges", 4)
    rb, re, rv = arrays[2], arrays[3], arrays[5]
    bounds = [tuple(x) for x in lows[1:]]
    past = [b[:-1] + (b[-1] + 1,) for b in bounds]
    for rows in (rb, re):
        assert any(tuple(x) in bounds for x in rows)
        assert any(tuple(x) in past for x in rows)
    assert any(tuple(b) > tuple(e) for b, e in zip(rb, re))
    assert any((e == tg.INF).all() for e in re)
    real = [tuple(x) for x in shk.reshape(-1, shk.shape[-1])]
    assert all(x in real for x in bounds + past)
    _cb, _ce, cv = keys.clip_to_shards_plain(
        *[torch.from_numpy(a) for a in (rb, re, rv)],
        torch.from_numpy(lows), torch.from_numpy(highs))
    nonempty = (keys.lt_rows_plain(torch.from_numpy(rb), torch.from_numpy(re))
                & torch.from_numpy(rv))
    assert bool((nonempty[None] & ~cv).any())
    out = ck.resolve_step_sharded_packed(
        torch.from_numpy(shk), torch.from_numpy(shv),
        torch.from_numpy(ck.pack_interval_batch(*arrays, tg.COMMIT,
                                                tg.OLDEST)),
        torch.from_numpy(lows), torch.from_numpy(highs), T, R, Wr,
        attribute=True)
    assert bool(out[3].any()) and bool(out[4].any())


# the cells' key width (4 words), and widths past the row searches'
# ROW_CW = 8 loaded words: at 8 words the length word lies past them, at
# 12 the key ids too, so every compare of two real keys ties there
CLIP_WIDTHS = (4, 8, 12)


@pytest.fixture(scope="module")
def ref_by_width():
    """Reference sharded resolvers at the clip-edge tests' key widths,
    one a width, so each one's jitted steps compile once."""
    return {n: ShardedTpuConflictSet(capacity=KIND_SHAPE[0], n_shards=4,
                                     key_bytes=4 * n)
            for n in CLIP_WIDTHS}


@pytest.mark.parametrize("n_words", CLIP_WIDTHS)
@pytest.mark.parametrize("kind", ["split_edges", "clip_edges"])
@pytest.mark.parametrize("attribute", [True, False])
def test_packed_step_matches_reference_at_clip_edges(ref_by_width, n_words,
                                                     kind, attribute):
    """The plain sharded step against the reference's shard_map'd packed
    step on the shard-bound kinds, at the cell's key width and at keys
    longer than the searches' loaded words, fresh and one step on."""
    _kind_against_reference(ref_by_width[n_words],
                            kind_case(kind, 4, n_words, seed=n_words), kind,
                            attribute)


# ---------------------------------------------------------------------------
# stream level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [4, 8])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_stream_parity_with_reference(n_shards, seed):
    batches = rand_batches(seed, 24)
    ref = ShardedTpuConflictSet(capacity=1024, n_shards=n_shards)
    port = sharded(n_shards)
    for (b, v, o), (pb, _v, _o) in zip(batches, port_batches(batches)):
        assert port.resolve_with_attribution(pb, v, o) == \
            ref.resolve_with_attribution(b, v, o)
        assert_same_state(ref, port)
    assert tuple(port.checkpoint()) == tuple(ref.checkpoint())
    # the stitched checkpoint is the single-shard resolver's
    single = CudaConflictSet(device="cpu")
    run_attributed(single, port_batches(batches))
    assert step_from_checkpoint(port.checkpoint()) == \
        step_from_checkpoint(single.checkpoint())


@pytest.mark.parametrize("pipelined", [False, True])
def test_growth_rebase_and_jumps_mid_stream(pipelined, depth_knob):
    """A 1024-row capacity that must grow, strides across the 2^30
    re-base threshold and one jump of more than 2^31 with pre-jump
    snapshots live (K4's fixups over [S, cap] versions), one batch at a
    time and pipelined at depth 4."""
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
    port = sharded(4)
    if pipelined:
        depth_knob(4)
        tickets = [port.submit(b, v, o, attribute=True)
                   for b, v, o in port_batches(batches)]
        got = [port.drain_with_attribution(t) for t in tickets]
    else:
        got = run_attributed(port, port_batches(batches))
    ref = ShardedTpuConflictSet(capacity=1024, n_shards=4)
    assert got == run_attributed(ref, batches)
    assert got == run_attributed(RefPy(), batches)
    assert port._cap > 1024 and port._base > 0
    assert_same_state(ref, port)


def test_out_of_order_drains_match_serial(depth_knob):
    depth_knob(4)
    batches = port_batches(rand_batches(31, 14, max_txns=6))
    cs = sharded(4)
    results, pending = {}, []
    for i, (b, v, o) in enumerate(batches):
        pending.append((i, cs.submit(b, v, o, attribute=i % 2 == 0)))
        if len(pending) == 3:
            for j, t in reversed(pending):
                results[j] = cs.drain(t)
                assert cs.drain(t) == results[j]
            pending.clear()
    for j, t in reversed(pending):
        results[j] = cs.drain(t)
    serial = CudaConflictSet(device="cpu")
    for i, (b, v, o) in enumerate(batches):
        assert results[i] == serial.resolve(b, v, o), i


def test_checkpoint_restore_round_trip():
    batches = rand_batches(17, 30)
    head, tail = port_batches(batches[:18]), port_batches(batches[18:])
    port = sharded(4)
    run_attributed(port, head)
    ckpt = port.checkpoint()
    ref = ShardedTpuConflictSet(capacity=1024, n_shards=4)
    run_attributed(ref, batches[:18])
    assert tuple(ref.checkpoint()) == tuple(ckpt)
    # onto fresh backends: the port at 4 and 8 shards, the reference's
    # checkpoint into the port, and the single-shard port
    from foundationdb_tpu_torch.models import ConflictSetCheckpoint
    restored = [sharded(4), sharded(8), CudaConflictSet(device="cpu")]
    for r in restored:
        r.restore(ckpt)
    from_ref = sharded(4)
    from_ref.restore(ConflictSetCheckpoint(*ref.checkpoint()))
    ref_restored = ShardedTpuConflictSet(capacity=1024, n_shards=4)
    ref_restored.restore(ckpt)
    want = run_attributed(port, tail)
    for r in restored + [from_ref]:
        assert run_attributed(r, tail) == want
    assert run_attributed(ref_restored, batches[18:]) == want
    assert_same_state(ref_restored, from_ref)


def test_state_carries_across_from_reference():
    batches = rand_batches(23, 40)
    ref = ShardedTpuConflictSet(capacity=1024, n_shards=4)
    run_attributed(ref, batches[:20])
    port = load_reference_sharded_state(
        np.asarray(ref._hk), np.asarray(ref._hv), base=ref._base,
        oldest=ref._oldest, last_commit=ref._last_commit,
        init_version=ref._init_version, key_bytes=ref._key_bytes,
        split_keys=ref._split_keys[1:], device="cpu")
    assert_same_state(ref, port)
    assert run_attributed(port, port_batches(batches[20:])) == \
        run_attributed(ref, batches[20:])
    assert_same_state(ref, port)
    with pytest.raises(ValueError):
        load_reference_sharded_state(
            np.asarray(ref._hk)[0], np.asarray(ref._hv)[0], base=0,
            oldest=0, last_commit=0, init_version=0, key_bytes=32,
            split_keys=[], device="cpu")


# ---------------------------------------------------------------------------
# the reference's sharded cases, one for one
# ---------------------------------------------------------------------------

def test_default_split_keys():
    ks = default_split_keys(4)
    assert ks == [b"\x40", b"\x80", b"\xc0"]
    assert ks == sorted(ks)


def test_cross_shard_range_conflict():
    """A single range spanning every shard boundary behaves as one."""
    sh = sharded()
    assert sh._n_shards == 8
    sh.resolve([txn(0, writes=[(b"\x01", b"\xfe")])], 100, 0)
    got = sh.resolve(
        [txn(50, reads=[(b"\x70", b"\x90")]),
         txn(50, reads=[(b"\x00", b"\x01")]),
         txn(100, reads=[(b"\x01", b"\xfe")])], 200, 0)
    assert got == [0, 2, 2]


def test_intra_batch_across_shards():
    """Writer on one shard, reader on another, in the same batch: the
    combined fixpoint sees the dependency."""
    sh = sharded()
    got = sh.resolve(
        [txn(0, writes=[(b"\x10", b"\x11")]),
         txn(0, reads=[(b"\x10", b"\x11")], writes=[(b"\xf0", b"\xf1")]),
         txn(0, reads=[(b"\xf0", b"\xf1")])], 100, 0)
    assert got == [2, 0, 2]


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_randomized_sharded_parity(seed):
    rng = random.Random(seed)
    sh = sharded()
    single = CudaConflictSet(device="cpu")
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
    for bi in range(20):
        version += rng.randrange(1, 300_000)
        oldest = max(0, version - MWTLV)
        batch = [txn(max(0, version - rng.randrange(0, int(1.2 * MWTLV))),
                     [rrange() for _ in range(rng.randrange(0, 4))],
                     [rrange() for _ in range(rng.randrange(0, 4))])
                 for _ in range(rng.randrange(1, 16))]
        vs = sh.resolve(batch, version, oldest)
        v1 = single.resolve(batch, version, oldest)
        vb = brute.resolve(batch, version, oldest)
        assert vs == v1 == vb, (bi, vs, v1, vb)


def test_sharded_growth():
    sh = sharded()
    v = 0
    for i in range(30):
        v += 10
        writes = [(bytes([j % 256]) + b"%04d" % (i * 50 + j),
                   bytes([j % 256]) + b"%04d\x00" % (i * 50 + j))
                  for j in range(50)]
        sh.resolve([txn(v - 10, writes=writes)], v, 0)
    got = sh.resolve([txn(0, reads=[(b"\x00", b"\xff")])], v + 1, 0)
    assert got == [0]


def test_sharded_backend_attribution_parity():
    """Clipped per-shard attribution unions back to the global answer."""
    rng = random.Random(41)
    brute, sh = BruteForceConflictSet(), sharded(4)
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
        assert [tuple(x) for x in a1] == [tuple(x) for x in a2]


def _run_pipelined(cs, batches, window=4):
    got, pending = [], []
    for b, v, o in batches:
        pending.append(cs.submit(b, v, o))
        if len(pending) >= window:
            got.append(cs.drain(pending.pop(0)))
    got.extend(cs.drain(t) for t in pending)
    return got


def test_pipelined_matches_serial_directed(depth_knob):
    depth_knob(4)

    def pt(k):
        return (k, k + b"\x08")

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
    brute = BruteForceConflictSet()
    serial = sharded()
    want = [serial.resolve(b, v, o) for b, v, o in batches]
    assert want == [brute.resolve(b, v, o) for b, v, o in batches]
    assert _run_pipelined(sharded(), batches) == want


@pytest.mark.parametrize("seed", [1, 2])
def test_pipelined_matches_serial_randomized(seed, depth_knob):
    depth_knob(4)
    batches = port_batches(rand_batches(seed, 30))
    serial = sharded()
    want = [serial.resolve(b, v, o) for b, v, o in batches]
    brute = BruteForceConflictSet()
    assert want == [brute.resolve(b, v, o) for b, v, o in batches]
    assert _run_pipelined(sharded(), batches) == want


def test_capacity_growth_mid_pipeline(depth_knob):
    """The reference's case with its keys in shard 0 of 8, so that one
    shard's load doubles the capacity of all while tickets are in
    flight."""
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
    serial = sharded(capacity=64)
    want = [serial.resolve(b, v, o) for b, v, o in batches]
    piped = sharded(capacity=64)
    assert _run_pipelined(piped, batches) == want
    assert piped._cap > 1024


# ---------------------------------------------------------------------------
# factory and contracts
# ---------------------------------------------------------------------------

def test_factory_and_contracts(monkeypatch):
    assert "sharded-cuda" in CONFLICT_BACKENDS
    splits = [b"0000500", b"0001000", b"0001500"]
    cs = create_conflict_set("sharded-cuda", device="cpu", key_bytes=16,
                             n_shards=4, split_keys=splits, capacity=1 << 12)
    assert isinstance(cs, ShardedCudaConflictSet)
    assert cs._hk.shape == (4, 1 << 12, 5) and cs._hv.shape == (4, 1 << 12)
    assert cs._split_keys == [b""] + splits
    # slot 0 of each shard is its lower bound at the initial version
    assert encode_keys(splits, 16).tolist() == cs._hk[1:, 0].tolist()
    cs.resolve([txn(0, [(b"0000400", b"0001600")],
                    [(b"0000400", b"0001600")])], 10, 0)
    st = cs.kernel_stats()
    assert st["backend"] == "sharded-cuda" and st["platform"] == "cpu"
    assert st["h2d"]["per_batch"] == 1.0
    assert sharded(None)._n_shards == 1
    with pytest.raises(ValueError):
        sharded(4, split_keys=[b"\x10"])
    with pytest.raises(ValueError):
        sharded(3, split_keys=[b"\x80", b"\x10"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(fdev.NoCudaDeviceError):
        create_conflict_set("sharded-cuda")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@STEP_CASES
def test_k8_matches_plain(cuda, n_shards, kind):
    """K8 against its plain version; on the `empty` batch K8's one
    matrix over the unclipped ranges must count the empty and inverted
    ranges invalid, as the plain version's per-shard clip does."""
    _ref, hk, hv = reference_after(n_shards, 40 + n_shards)
    buf, arrays, T, R, Wr = feed(step_batch(kind, n_shards), 130, 20,
                                 keep_empty=kind == "empty")
    lows, highs = _port_bounds(_ref)
    for attribute in (True, False):
        want = ck.resolve_step_sharded_packed(
            torch.from_numpy(hk), torch.from_numpy(hv),
            torch.from_numpy(buf), lows, highs, T, R, Wr,
            attribute=attribute)
        before = ck.launches["resolve_sharded"]
        got = ck.resolve_step_sharded_packed(
            torch.from_numpy(hk).to(cuda), torch.from_numpy(hv).to(cuda),
            torch.from_numpy(buf).to(cuda), lows.to(cuda), highs.to(cuda),
            T, R, Wr, attribute=attribute)
        assert ck.launches["resolve_sharded"] == before + 1
        got_u = ck.resolve_step_sharded(
            torch.from_numpy(hk).to(cuda), torch.from_numpy(hv).to(cuda),
            *[torch.from_numpy(a).to(cuda) for a in arrays], 130, 20,
            lows.to(cuda), highs.to(cuda), attribute=attribute)
        for outs in (got, got_u):
            for g, w in zip(outs, want):
                assert (g is None) == (w is None)
                if g is not None:
                    assert torch.equal(g.cpu(), w)


def _k8_against_plain(cuda, shk, shv, lows, highs, arrays, T, R, Wr):
    """K8, packed and unpacked, attributed and not, against its plain
    version from the given state and from the state one step later."""
    lows_t, highs_t = torch.from_numpy(lows), torch.from_numpy(highs)
    for attribute in (True, False):
        state = (torch.from_numpy(shk), torch.from_numpy(shv))
        for commit in (tg.COMMIT, tg.COMMIT + 20):
            buf = torch.from_numpy(ck.pack_interval_batch(*arrays, commit,
                                                          tg.OLDEST))
            want = ck.resolve_step_sharded_packed(
                *state, buf, lows_t, highs_t, T, R, Wr, attribute=attribute)
            before = ck.launches["resolve_sharded"]
            got = ck.resolve_step_sharded_packed(
                state[0].to(cuda), state[1].to(cuda), buf.to(cuda),
                lows_t.to(cuda), highs_t.to(cuda), T, R, Wr,
                attribute=attribute)
            got_u = ck.resolve_step_sharded(
                state[0].to(cuda), state[1].to(cuda),
                *[torch.from_numpy(a).to(cuda) for a in arrays], commit,
                tg.OLDEST, lows_t.to(cuda), highs_t.to(cuda),
                attribute=attribute)
            assert ck.launches["resolve_sharded"] == before + 2
            for outs in (got, got_u):
                for g, w in zip(outs, want):
                    assert (g is None) == (w is None)
                    if g is not None:
                        assert torch.equal(g.cpu(), w)
            state = want[:2]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", tg.KINDS)
@pytest.mark.parametrize("n_shards", [1, 4])
def test_k8_matches_plain_on_kinds(cuda, kind, n_shards):
    _k8_against_plain(cuda, *kind_case(kind, n_shards))


@pytest.mark.cuda
@pytest.mark.parametrize("n_words", [40, 100])
def test_k8_matches_plain_at_wide_keys(cuda, n_words):
    """Keys of 41 and 101 words: endpoint records of 16 and 32 uint4s,
    the second with the sort's smaller tiles."""
    _k8_against_plain(cuda, *kind_case("mixed", 4, n_words))


@pytest.mark.cuda
@pytest.mark.parametrize("n_words", CLIP_WIDTHS)
@pytest.mark.parametrize("kind", ["split_edges", "clip_edges"])
def test_k8_matches_plain_at_clip_edges(cuda, n_words, kind):
    """K8's bounds search with the clip fused in, on the shard-bound
    kinds at the cell's key width and past the searches' loaded words."""
    _k8_against_plain(cuda, *kind_case(kind, 4, n_words, seed=n_words))


@pytest.mark.cuda
def test_cuda_stream_matches_cpu(cuda):
    batches = port_batches(rand_batches(5, 30))
    gpu = ShardedCudaConflictSet(n_shards=4, device=cuda)
    cpu = sharded(4)
    assert run_attributed(gpu, batches) == run_attributed(cpu, batches)
    assert torch.equal(gpu._hk.cpu(), cpu._hk)
    assert torch.equal(gpu._hv.cpu(), cpu._hv)
    assert gpu.kernel_stats()["platform"] == "gpu"
