"""The packed path's native check and staging fill (csrc/marshal.cpp,
ops/marshal.py) against the NumPy code they replace.

The oracle is the resolver's former field-by-field fill of a staging
entry, kept here word for word: the header, the snapshot offsets
clipped to [0, SNAP_CLAMP], the too-old flags, the four key matrices
(pre-encoded rows copied, raw key bytes encoded, pad rows zeroed), the
txn ids padded with the bucket's transaction count and the valid flags.
The native fill must write the same entry word for word, from a
poisoned buffer, over batches whose counts are not powers of two, with
too-old transactions and transactions without reads, snapshots below
the base and past SNAP_CLAMP, keys of 16, 24 and 32 bytes, pre-encoded
or raw, and random layouts. The native check must give the NumPy
expressions' too-old flags and floor, and `resolve_arrays` the same
`ValueError` for decreasing `rt` or `wt`, unsigned ids included.
Everything runs on the CPU build (g++), the source the card's library
compiles into its one-call submit."""

import ctypes
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch.models.cuda_resolver import (  # noqa: E402
    _KERNEL_MIN_RANGES,
    _KERNEL_MIN_TXNS,
    CudaConflictSet,
)
from foundationdb_tpu_torch.ops import marshal  # noqa: E402
from foundationdb_tpu_torch.ops.conflict_kernel import (  # noqa: E402
    SNAP_CLAMP,
    interval_batch_views,
    interval_feed_len,
)
from foundationdb_tpu_torch.ops.keys import (  # noqa: E402
    encode_keys,
    encode_keys_into,
    next_pow2,
)
from foundationdb_tpu_torch.parallel import (  # noqa: E402
    ShardedCudaConflictSet,
)

POISON = 0xDEADBEEF
ID_DTYPES = [np.int32, np.int64, np.uint32, np.uint64]


# -- the oracle: the former NumPy fill, field by field ----------------------
def oracle_fill_keys(dst, src, nsrc, key_bytes):
    if isinstance(src, np.ndarray):
        dst[:nsrc] = src[:nsrc]
    else:
        sc = np.empty((next_pow2(max(nsrc, _KERNEL_MIN_RANGES)), key_bytes),
                      np.uint8)
        encode_keys_into(src, key_bytes, dst, sc)
    dst[nsrc:] = 0


def oracle_entry(key_bytes, base, n, snapshots, too_old, rb, re, rt, wb, we,
                 wt, commit_off, oldest_off):
    nr, nw = len(rt), len(wt)
    npad = next_pow2(max(n, _KERNEL_MIN_TXNS))
    nrp = next_pow2(max(nr, _KERNEL_MIN_RANGES))
    nwp = next_pow2(max(nw, _KERNEL_MIN_RANGES))
    n_words = key_bytes // 4
    buf = np.full(interval_feed_len(npad, nrp, nwp, n_words), POISON,
                  np.uint32)
    v = interval_batch_views(buf, npad, nrp, nwp, n_words)
    snap_off = np.clip(snapshots - base, 0, SNAP_CLAMP).astype(np.int32)
    v.hdr[0] = commit_off
    v.hdr[1] = oldest_off
    v.snap[:n] = snap_off
    v.snap[n:] = 0
    v.too_old[:n] = too_old
    v.too_old[n:] = 0
    oracle_fill_keys(v.rb, rb, nr, key_bytes)
    oracle_fill_keys(v.re, re, nr, key_bytes)
    v.rtxn[:nr] = np.asarray(rt, np.int32)
    v.rtxn[nr:] = npad
    v.rvalid[:nr] = 1
    v.rvalid[nr:] = 0
    oracle_fill_keys(v.wb, wb, nw, key_bytes)
    oracle_fill_keys(v.we, we, nw, key_bytes)
    v.wtxn[:nw] = np.asarray(wt, np.int32)
    v.wtxn[nw:] = npad
    v.wvalid[:nw] = 1
    v.wvalid[nw:] = 0
    return buf


def native_entry(cs, n, snapshots, too_old, rb, re, rt, wb, we, wt,
                 commit_off, oldest_off):
    """The resolver's own staging and native fill, from a poisoned
    entry of the batch's shape bucket."""
    npad = next_pow2(max(n, _KERNEL_MIN_TXNS))
    nrp = next_pow2(max(len(rt), _KERNEL_MIN_RANGES))
    nwp = next_pow2(max(len(wt), _KERNEL_MIN_RANGES))
    ent = cs._staging_views(npad, nrp, nwp)
    ent.buf[:] = POISON
    f = marshal.FillArgs()
    keep = cs._stage(f, ent, n, snapshots, too_old, rb, re, rt, wb, we, wt,
                     commit_off, oldest_off)
    cs._mlib().fdb_marshal_fill(ctypes.addressof(f))
    del keep
    return ent.buf.copy()


# -- random batches -----------------------------------------------------------
def rand_keys(rng, count, key_bytes):
    return [bytes(rng.randrange(256) for _ in range(rng.randrange(
        0, key_bytes + 1))) for _ in range(count)]


def rand_ids(rng, n, count, dtype):
    ids = sorted(rng.randrange(max(n, 1)) for _ in range(count))
    return np.array(ids, dtype)


def rand_batch(seed, key_bytes, raw: bool, base: int):
    """One batch of `resolve`'s inputs at a random layout: a count that
    is rarely a power of two, ranges short of their bucket, snapshots
    around `base` (below it and past SNAP_CLAMP above it), too-old
    flags and transactions without reads."""
    rng = random.Random(seed)
    n = rng.choice([1, 5, 17, 33, 100, 129, rng.randrange(1, 300)])
    nr = rng.randrange(0, 3 * n + 1)
    nw = rng.randrange(0, 3 * n + 1)
    offs = [rng.choice([-5, -1, 0, 1, 7, SNAP_CLAMP - 1, SNAP_CLAMP,
                        SNAP_CLAMP + 1, 1 << 40, -(1 << 40),
                        rng.randrange(-1000, 1 << 31)]) for _ in range(n)]
    snapshots = np.array([base + o for o in offs], np.int64)
    too_old = np.array([rng.random() < 0.2 for _ in range(n)], bool)
    dtype = rng.choice(ID_DTYPES)
    rt = rand_ids(rng, n, nr, dtype)
    wt = rand_ids(rng, n, nw, dtype)
    keys = [rand_keys(rng, c, key_bytes) for c in (nr, nr, nw, nw)]
    if not raw:
        keys = [encode_keys(k, key_bytes) if k else
                np.zeros((0, key_bytes // 4 + 1), np.uint32) for k in keys]
    rb, re, wb, we = keys
    commit_off = rng.randrange(0, 1 << 30)
    oldest_off = rng.randrange(0, commit_off + 1)
    return n, snapshots, too_old, rb, re, rt, wb, we, wt, commit_off, \
        oldest_off


@pytest.mark.parametrize("key_bytes", [16, 24, 32])
@pytest.mark.parametrize("raw", [False, True], ids=["encoded", "raw"])
@pytest.mark.parametrize("seed", range(6))
def test_native_fill_equals_the_field_by_field_fill(key_bytes, raw, seed):
    cs = CudaConflictSet(key_bytes=key_bytes, device="cpu")
    base = random.Random(seed).choice([0, 12345, 1 << 33])
    cs._base = base
    batch = rand_batch(seed * 7 + key_bytes, key_bytes, raw, base)
    want = oracle_entry(key_bytes, base, *batch)
    assert not (want == POISON).any()
    got = native_entry(cs, *batch)
    bad = np.flatnonzero(got != want)
    assert not bad.size, f"words differ from {bad[0]}: {bad[:8]}"


@pytest.mark.parametrize("ids_dtype", [np.int16, np.float64])
def test_native_fill_keeps_numpys_casts_of_odd_inputs(ids_dtype):
    """Key rows of another dtype or layout, ids of another dtype, and
    rows past the batch's count go in as NumPy's assignment puts
    them."""
    cs = CudaConflictSet(key_bytes=16, device="cpu")
    n, snaps, too_old, rb, re, rt, wb, we, wt, c, o = rand_batch(
        3, 16, False, 0)
    nr, nw = len(rt), len(wt)
    rb = np.asfortranarray(rb)                  # not C-contiguous
    re = re.astype(np.int64)                    # another dtype
    wb = np.concatenate([wb, wb[:3]])           # rows past the count
    rt = rt.astype(ids_dtype)
    batch = (n, snaps, too_old, rb, re, rt, wb, we, wt, c, o)
    assert (len(rt), len(wt)) == (nr, nw)
    assert np.array_equal(native_entry(cs, *batch),
                          oracle_entry(16, 0, *batch))


# -- the check ----------------------------------------------------------------
def numpy_check(snapshots, has_reads, oldest, commit_version,
                new_oldest_version):
    too_old = (snapshots < oldest) & has_reads.astype(bool)
    live = has_reads.astype(bool) & ~too_old
    floor = min(int(snapshots[live].min()) if live.any() else commit_version,
                max(oldest, new_oldest_version))
    return too_old, floor


@pytest.mark.parametrize("dtype", ID_DTYPES)
@pytest.mark.parametrize("seed", range(8))
def test_native_check_equals_numpy(dtype, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 400))
    oldest = int(rng.integers(-50, 1000))
    snapshots = rng.integers(-100, 1100, n).astype(np.int64)
    has_reads = rng.random(n) < [0.0, 0.5, 1.0][seed % 3]
    commit = 5000
    new_oldest = int(rng.integers(-100, 2000))
    rt, rt_kind = marshal.ids(np.sort(rng.integers(0, n, 3 * n)).astype(
        dtype))
    wt, wt_kind = marshal.ids(np.sort(rng.integers(0, n, n)).astype(dtype))
    code, too_old, floor = marshal.check(
        marshal.host_lib(), snapshots, has_reads, rt, rt_kind, wt, wt_kind,
        oldest, commit, max(oldest, new_oldest))
    want_old, want_floor = numpy_check(snapshots, has_reads, oldest, commit,
                                       new_oldest)
    assert code == 0
    assert np.array_equal(too_old, want_old)
    assert floor == want_floor


def arrays(n, rt, wt):
    keys = encode_keys([b"k%03d" % i for i in range(max(len(rt),
                                                        len(wt)))], 16)
    return (np.zeros(n, np.int64), np.ones(n, bool), keys[:len(rt)],
            keys[:len(rt)], rt, keys[:len(wt)], keys[:len(wt)], wt)


@pytest.mark.parametrize("dtype", ID_DTYPES)
@pytest.mark.parametrize("side", ["rt", "wt", "both"])
def test_decreasing_ids_raise_the_same_error(dtype, side):
    good = np.array([0, 0, 1, 3], dtype)
    bad = np.array([0, 2, 1, 3], dtype)
    if dtype == np.uint64:
        # an id of 2^63 or more is negative to the signed check, as
        # NumPy's int64 view made it
        bad = np.array([0, 1 << 63, 2, 3], dtype)
    rt = bad if side in ("rt", "both") else good
    wt = bad if side in ("wt", "both") else good
    cs = CudaConflictSet(key_bytes=16, device="cpu")
    name = "wt" if side == "wt" else "rt"
    msg = (f"per-range txn ids ({name}) must be non-decreasing: flatten "
           "conflict ranges in transaction order (the kernel reduces "
           "per-txn flags as segment sums over the slot order)")
    with pytest.raises(ValueError) as err:
        cs.resolve_arrays(*arrays(4, rt, wt), commit_version=10,
                          new_oldest_version=0)
    assert str(err.value) == msg
    # nothing of the batch counted
    assert cs.kernel_stats()["batches"] == 0


@pytest.mark.parametrize("has_reads", [True, [1, 0, 1, 1], "short"])
def test_has_reads_broadcasts_as_numpy_did(has_reads):
    """`has_reads` of another dtype or a scalar broadcasts to the batch
    as NumPy broadcast it; one of another length raises, as before."""
    rt = np.array([0, 1, 2, 3], np.int32)
    a = arrays(4, rt, rt)
    cs = CudaConflictSet(key_bytes=16, device="cpu")
    cs._oldest = 5                  # every snapshot (0) below the window
    if has_reads == "short":
        with pytest.raises(ValueError):
            cs.resolve_arrays(a[0], np.ones(3, bool), *a[2:],
                              commit_version=10, new_oldest_version=5)
        return
    _c, too_old = cs.resolve_arrays(a[0], np.asarray(has_reads), *a[2:],
                                    commit_version=10, new_oldest_version=5)
    want = (a[0] < 5) & np.broadcast_to(np.asarray(has_reads).astype(bool),
                                        (4,))
    assert np.array_equal(too_old, want)


@pytest.mark.parametrize("dtype", ID_DTYPES)
def test_sorted_ids_of_every_dtype_resolve_alike(dtype):
    """Sorted ids of every dtype give the verdicts int32 ids give."""
    rt = np.array([0, 0, 1, 3], dtype)
    wt = np.array([0, 1, 2, 3], dtype)
    got = []
    for ids_dtype in (np.int32, dtype):
        cs = CudaConflictSet(key_bytes=16, device="cpu")
        t = cs.submit_arrays(*arrays(4, rt.astype(ids_dtype),
                                     wt.astype(ids_dtype)),
                             commit_version=10, new_oldest_version=0)
        cs.submit_arrays(*arrays(4, rt.astype(ids_dtype),
                                 wt.astype(ids_dtype)),
                         commit_version=20, new_oldest_version=0)
        got.append([np.asarray(x) for x in cs.drain_arrays(t)])
    assert all(np.array_equal(a, b) for a, b in zip(*got))


@pytest.mark.parametrize("backend", ["cuda", "sharded-cuda"])
def test_cpu_path_counts_no_one_call_batch(backend):
    """The one-call submit is the card's: on the CPU every batch takes
    the native fill and the plain step, and the counter stays 0."""
    cs = (CudaConflictSet(key_bytes=16, device="cpu") if backend == "cuda"
          else ShardedCudaConflictSet(key_bytes=16, device="cpu",
                                      n_shards=2, split_keys=[b"k5"]))
    rt = np.array([0, 1, 2, 3], np.int32)
    for v in (10, 20, 30):
        cs.drain_arrays(cs.submit_arrays(*arrays(4, rt, rt),
                                         commit_version=v,
                                         new_oldest_version=0))
    host = cs.kernel_stats()["host"]
    assert host["one_call_batches"] == 0
    assert host["phases"]["submit"]["calls"] == 3


# ---------------------------------------------------------------------------
# on the card: the one-call submit (csrc/submit.cu)
# ---------------------------------------------------------------------------

KB = 8
BACKENDS = ["cuda", "sharded-cuda"]


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def make(backend, device, capacity=1 << 10):
    if backend == "cuda":
        return CudaConflictSet(key_bytes=KB, capacity=capacity,
                               device=device)
    return ShardedCudaConflictSet(
        key_bytes=KB, capacity=capacity, device=device, n_shards=4,
        split_keys=[bytes([64]), bytes([128]), bytes([192])])


def encoded(batch, shift=0):
    """`submit_arrays`' inputs for a batch of transactions, versions
    moved up by `shift`."""
    snaps = np.array([t.read_snapshot + shift for t in batch], np.int64)
    has_reads = np.array([bool(t.read_ranges) for t in batch])
    out = [snaps, has_reads]
    for side in ("read_ranges", "write_ranges"):
        pairs = [(i, b, e) for i, t in enumerate(batch)
                 for b, e in getattr(t, side) if b < e]
        out += [encode_keys([b for _i, b, _e in pairs], KB),
                encode_keys([e for _i, _b, e in pairs], KB),
                np.array([i for i, _b, _e in pairs], np.int32)]
    return out


def card_stream(seed=11, n=24):
    """Batches whose versions start past 2^30 (the first is a K4
    re-base) and whose history outgrows 1,024 rows (nothing leaves the
    window); every key's first byte is divided by 4, so all of them
    fall in the first of 4 shards, which outgrows its rows too."""
    from foundationdb_tpu_torch import testing
    out = []
    for b, v, o in testing.rand_batches(seed, n, max_txns=80, n_keys=90,
                                        version_stride=10):
        b = [t._replace(**{side: tuple(
            (bytes([k[0] // 4]) + k[1:], bytes([e[0] // 4]) + e[1:])
            for k, e in getattr(t, side))
            for side in ("read_ranges", "write_ranges")}) for t in b]
        if b:
            out.append((encoded(b, 1 << 30), v + (1 << 30), o + (1 << 30)))
    return out


def fixed_batches(seed, count, n=40, v0=1000):
    """Batches of one shape bucket: n transactions of one point read and
    one point write each, every snapshot at the batch before."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        v = v0 + 10 * (i + 1)
        keys = [bytes([int(k) % 256]) + b"%03d" % (int(k) // 256)
                for k in rng.integers(0, 3000, 2 * n)]
        rk = encode_keys(keys[:n], KB)
        re_ = encode_keys([k + b"\x00" for k in keys[:n]], KB)
        wk = encode_keys(keys[n:], KB)
        we = encode_keys([k + b"\x00" for k in keys[n:]], KB)
        ids = np.arange(n, dtype=np.int32)
        out.append(([np.full(n, v - 10, np.int64), np.ones(n, bool), rk, re_,
                     ids, wk, we, ids], v, 0))
    return out


def run(cs, batches):
    tickets = [cs.submit_arrays(*a, commit_version=v, new_oldest_version=o)
               for a, v, o in batches]
    return [cs.drain_arrays(t) for t in tickets]


def counting(monkeypatch, cls):
    calls = [0]
    inner = cls._submit_one_call

    def wrapped(self, *a, **kw):
        calls[0] += 1
        return inner(self, *a, **kw)
    monkeypatch.setattr(cls, "_submit_one_call", wrapped)
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("backend", BACKENDS)
def test_one_call_submit_equals_the_plain_path(backend, monkeypatch):
    """Over a stream that crosses a K4 re-base and a growth, the
    one-call submit's verdicts, history rows and counters equal the
    plain path's on the CPU; the counter counts the one-call batches."""
    need_card()
    batches = card_stream()
    cpu = make(backend, "cpu")
    want = run(cpu, batches)
    card = make(backend, None)
    calls = counting(monkeypatch, type(card))
    got = run(card, batches)
    for (c1, t1), (c2, t2) in zip(want, got):
        assert np.array_equal(c1, c2) and np.array_equal(t1, t2)
    assert card._base == cpu._base > 0
    assert card._cap == cpu._cap > 1 << 10
    for a, b in zip(cpu._host_state(), card._host_state()):
        assert np.array_equal(a, b)
    s_cpu, s_card = cpu.kernel_stats(), card.kernel_stats()
    for key in ("counts", "h2d", "occupancy", "batches"):
        assert s_cpu[key] == s_card[key], key
    # only a step's first call (a bucket at a capacity), which its
    # profile fences and times, takes the Python sequence
    host = s_card["host"]
    assert host["one_call_batches"] == calls[0]
    assert len(batches) // 2 < calls[0] <= len(batches)
    assert s_cpu["host"]["one_call_batches"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("backend", BACKENDS)
def test_results_never_alias_a_reused_slot(backend):
    """Results held past the readback ring (pipeline depth + 2 slots),
    read out of order, equal the CPU's, and no array a caller was
    handed changes as later batches reuse the slots."""
    need_card()
    depth = CudaConflictSet(device="cpu").pipeline.depth
    batches = fixed_batches(3, 3 * (depth + 3))
    k = depth + 3
    cpu = make(backend, "cpu")
    want = [cpu.resolve_arrays(*a, commit_version=v, new_oldest_version=o)
            for a, v, o in batches]
    want = [(np.asarray(c)[:len(t)], t) for c, t in want]
    card = make(backend, None)
    run(card, batches[:2])                 # the bucket's first call
    before = card.kernel_stats()["host"]["one_call_batches"]
    held = [card.resolve_arrays(*a, commit_version=v, new_oldest_version=o)
            for a, v, o in batches[2:2 + k]]
    assert card.kernel_stats()["host"]["one_call_batches"] == before + k
    got = [np.asarray(c) for c, _t in reversed(held)][::-1]
    for (c, t), (wc, wt) in zip(zip(got, [t for _c, t in held]),
                                want[2:2 + k]):
        assert np.array_equal(c[:len(wt)], wc) and np.array_equal(t, wt)
    copies = [c.copy() for c in got]
    # the same through tickets, drained newest first
    tickets = [card.submit_arrays(*a, commit_version=v,
                                  new_oldest_version=o)
               for a, v, o in batches[2 + k:2 + 2 * k]]
    drained = [card.drain_arrays(t) for t in reversed(tickets)][::-1]
    for (c, t), (wc, wt) in zip(drained, want[2 + k:2 + 2 * k]):
        assert np.array_equal(c, wc) and np.array_equal(t, wt)
    kept = [(c.copy(), t.copy()) for c, t in drained]
    run(card, batches[2 + 2 * k:])
    for c, c0 in zip(got, copies):
        assert np.array_equal(c, c0)
    for (c, t), (c0, t0) in zip(drained, kept):
        assert np.array_equal(c, c0) and np.array_equal(t, t0)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", BACKENDS)
def test_fixup_and_time_device_take_the_python_sequence(backend):
    """A batch with a jump fixup and a batch under `time_device` take
    the Python sequence (the counter stays), with the CPU's verdicts;
    the batch after each takes the one-call submit again."""
    need_card()
    batches = fixed_batches(5, 6)
    cpu, card = make(backend, "cpu"), make(backend, None)
    for cs in (cpu, card):
        run(cs, batches[:4])
    host = card.kernel_stats()["host"]
    assert host["one_call_batches"] >= 2
    # time_device: events between the phases, the Python sequence
    before = host["one_call_batches"]
    card.time_device(True)
    assert np.array_equal(run(card, batches[4:5])[0][0],
                          run(cpu, batches[4:5])[0][0])
    assert card.device_ms() > 0
    card.time_device(False)
    assert card.kernel_stats()["host"]["one_call_batches"] == before
    run(card, batches[5:6])
    run(cpu, batches[5:6])
    assert card.kernel_stats()["host"]["one_call_batches"] == before + 1
    # a jump of more than 2^30 versions with a pre-jump snapshot live
    a, v, _o = fixed_batches(6, 1, v0=(1 << 31))[0]
    a[0][0] = batches[5][1]                # one snapshot before the jump
    jump = [(a, v, v - 100)]
    w = run(cpu, jump)
    g = run(card, jump)
    assert np.array_equal(w[0][0], g[0][0])
    assert np.array_equal(w[0][1], g[0][1])
    assert card._base == cpu._base
    assert card.kernel_stats()["host"]["one_call_batches"] == before + 1
    nxt = fixed_batches(7, 1, v0=v)
    assert np.array_equal(run(card, nxt)[0][0], run(cpu, nxt)[0][0])
    assert card.kernel_stats()["host"]["one_call_batches"] == before + 2
    for x, y in zip(cpu._host_state(), card._host_state()):
        assert np.array_equal(x, y)
