"""Port parity for ops/conflict_kernel.py: the packed-feed helpers build
buffers identical to the reference's; on one buffer from the reference's
pack_interval_batch, the port's plain resolve step (K3's plain version)
matches the reference's jitted step on the JAX CPU backend in all five
outputs, with attribution on and off, over several shape buckets and
seeds; the unpacked entry matches too; and the four window-upkeep modes
(K4's plain version) match the reference's functions. Every output is
integer or boolean: equality is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from foundationdb_tpu.ops import conflict_kernel as ref  # noqa: E402
from foundationdb_tpu_torch.ops import conflict_kernel as port  # noqa: E402

VDEAD = -(1 << 30)
BUCKETS = [  # (cap, T, R, Wr, W)
    (1024, 16, 32, 32, 4),
    (2048, 32, 64, 32, 2),
    (1024, 16, 64, 128, 8),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(rng, n, W):
    """Key rows over a small alphabet, so keys collide with each other
    and with the history (duplicate-key runs in the merge)."""
    rows = rng.integers(0, 4, size=(n, W + 1)).astype(np.uint32)
    rows[:, W] = rng.integers(0, 4 * W + 1, size=n)
    return rows


def rand_state(rng, cap, W, nrows):
    """A canonical history: the empty key first, sorted unique real
    rows, +inf / VDEAD padding; some versions below the window."""
    keys = np.unique(_rows(rng, nrows, W), axis=0)
    keys = keys[(keys != 0).any(axis=1)][:cap - 2]
    hk = np.full((cap, W + 1), 0xFFFFFFFF, np.uint32)
    hk[0] = 0
    hk[1:1 + len(keys)] = keys
    hv = np.full(cap, VDEAD, np.int32)
    hv[:1 + len(keys)] = rng.integers(-5, 60, size=1 + len(keys))
    hv[rng.random(cap) < 0.05] = VDEAD
    hv[len(keys) + 1:] = VDEAD
    return hk, hv


def _ranges(rng, n, W, pad):
    b, e = _rows(rng, n, W), _rows(rng, n, W)
    swap = np.array([tuple(x) > tuple(y) for x, y in zip(b, e)], bool)
    b[swap], e[swap] = e[swap].copy(), b[swap].copy()
    out_b = np.zeros((pad, W + 1), np.uint32)
    out_e = np.zeros((pad, W + 1), np.uint32)
    out_b[:n], out_e[:n] = b, e
    return out_b, out_e


def rand_batch(rng, T, R, Wr, W):
    """One padded batch as the 10 host arrays the marshaller produces:
    txn ids non-decreasing with pad = T, some tooOld, snapshots around
    the history's versions (commit 70, oldest 20 below)."""
    nt = int(rng.integers(1, T + 1))
    nr = int(rng.integers(1, R + 1))
    nw = int(rng.integers(1, Wr + 1))
    rb, re = _ranges(rng, nr, W, R)
    wb, we = _ranges(rng, nw, W, Wr)
    rt = np.full(R, T, np.int32)
    rt[:nr] = np.sort(rng.integers(0, nt, nr))
    wt = np.full(Wr, T, np.int32)
    wt[:nw] = np.sort(rng.integers(0, nt, nw))
    rv = np.zeros(R, bool)
    rv[:nr] = True
    wv = np.zeros(Wr, bool)
    wv[:nw] = True
    snap = np.zeros(T, np.int32)
    snap[:nt] = rng.integers(0, 70, nt)
    too_old = np.zeros(T, bool)
    too_old[:nt] = rng.random(nt) < 0.1
    return snap, too_old, rb, re, rt, rv, wb, we, wt, wv


COMMIT, OLDEST = 70, 20


def _np(outs):
    return [None if x is None else np.asarray(x) for x in outs]


def test_feed_helpers_identical():
    rng = np.random.default_rng(0)
    for cap, T, R, Wr, W in BUCKETS:
        arrays = rand_batch(rng, T, R, Wr, W)
        assert port.interval_feed_len(T, R, Wr, W) == \
            ref.interval_feed_len(T, R, Wr, W)
        a = port.pack_interval_batch(*arrays, COMMIT, OLDEST)
        b = ref.pack_interval_batch(*arrays, COMMIT, OLDEST)
        assert a.dtype == b.dtype == np.uint32
        assert a.tobytes() == b.tobytes()
        va = port.interval_batch_views(a, T, R, Wr, W)
        vb = ref.interval_batch_views(b, T, R, Wr, W)
        assert va._fields == vb._fields
        for x, y in zip(va, vb):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("bucket", BUCKETS)
@pytest.mark.parametrize("attribute", [True, False])
def test_plain_packed_step_matches_reference(bucket, attribute):
    cap, T, R, Wr, W = bucket
    jfn = ref.make_resolve_packed_fn(cap, T, R, Wr, W, attribute=attribute,
                                     donate=False)
    rng = np.random.default_rng(cap + T + R + Wr + W)
    for _trial in range(3):
        hk, hv = rand_state(rng, cap, W, 400)
        buf = ref.pack_interval_batch(*rand_batch(rng, T, R, Wr, W),
                                      COMMIT, OLDEST)
        want = _np(jfn(hk, hv, buf))
        got = port.resolve_step_packed(
            torch.from_numpy(hk), torch.from_numpy(hv),
            torch.from_numpy(buf), T, R, Wr, attribute=attribute)
        assert got[0].dtype == torch.uint32 and got[1].dtype == torch.int32
        assert (got[4] is None) == (not attribute)
        got = _np(got)[:len(want)]
        for name, g, w in zip(("HK", "HV", "count", "conflict", "read_hit"),
                              got, want):
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("attribute", [True, False])
def test_plain_unpacked_step_matches_reference(attribute):
    cap, T, R, Wr, W = BUCKETS[0]
    jfn = ref.make_resolve_fn(cap, T, R, Wr, W, attribute=attribute,
                              donate=False)
    rng = np.random.default_rng(77)
    for _trial in range(3):
        hk, hv = rand_state(rng, cap, W, 300)
        arrays = rand_batch(rng, T, R, Wr, W)
        want = _np(jfn(hk, hv, *arrays, jnp.int32(COMMIT),
                       jnp.int32(OLDEST)))
        got = port.resolve_step(
            torch.from_numpy(hk), torch.from_numpy(hv),
            *[torch.from_numpy(a) for a in arrays],
            torch.tensor(COMMIT, dtype=torch.int32), OLDEST,
            attribute=attribute)
        for g, w in zip(_np(got), want):
            np.testing.assert_array_equal(g, w)


def test_packed_step_rejects_mismatched_buffer():
    cap, T, R, Wr, W = BUCKETS[0]
    hk, hv = rand_state(np.random.default_rng(1), cap, W, 10)
    with pytest.raises(ValueError):
        port.resolve_step_packed(torch.from_numpy(hk), torch.from_numpy(hv),
                                 torch.zeros(7, dtype=torch.uint32),
                                 T, R, Wr)


def _window_state(n=4096):
    rng = np.random.default_rng(9)
    hv = rng.integers(VDEAD, 1 << 30, n).astype(np.int32)
    hv[::5] = VDEAD
    hv[::7] = ref.REBASE_THRESHOLD
    return hv


@pytest.mark.parametrize("delta", [0, 5, 1 << 20, (1 << 31) - 1])
def test_window_rebase_matches_reference(delta):
    hv = _window_state()
    want = np.asarray(ref.make_rebase_fn()(jnp.asarray(hv),
                                           jnp.int32(delta)))
    got = port.rebase(torch.from_numpy(hv), delta)
    np.testing.assert_array_equal(got.numpy(), want)


def test_window_reset_and_fixups_match_reference():
    hv = _window_state()
    p = ref.REBASE_THRESHOLD
    np.testing.assert_array_equal(
        port.reset(torch.from_numpy(hv)).numpy(),
        np.asarray(ref.make_reset_fn()(jnp.asarray(hv))))
    for commit_off, delta in ((77, 1000), (5, (1 << 31) - 1), (0, 0)):
        want = ref.make_jump_fixup_fn()(jnp.asarray(hv), jnp.int32(p),
                                        jnp.int32(commit_off),
                                        jnp.int32(delta))
        got = port.jump_fixup(torch.from_numpy(hv), p, commit_off, delta)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        want = ref.make_jump_fixup_large_fn()(
            jnp.asarray(hv), jnp.int32(p), jnp.int32(commit_off))
        got = port.jump_fixup_large(torch.from_numpy(hv), p, commit_off)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_window_upkeep_in_place():
    hv = torch.from_numpy(_window_state())
    want = port.rebase(hv, 123)
    port.rebase(hv, 123, out=hv)
    assert torch.equal(hv, want)


@pytest.mark.cuda
@pytest.mark.parametrize("attribute", [True, False])
def test_resolve_kernel_matches_plain(cuda, attribute):
    rng = np.random.default_rng(5)
    for cap, T, R, Wr, W in BUCKETS:
        for _trial in range(3):
            hk, hv = rand_state(rng, cap, W, 400)
            arrays = rand_batch(rng, T, R, Wr, W)
            buf = torch.from_numpy(port.pack_interval_batch(
                *arrays, COMMIT, OLDEST))
            want = port.resolve_step_packed(
                torch.from_numpy(hk), torch.from_numpy(hv), buf, T, R, Wr,
                attribute=attribute)
            before = port.launches["resolve"]
            got = port.resolve_step_packed(
                torch.from_numpy(hk).to(cuda), torch.from_numpy(hv).to(cuda),
                buf.to(cuda), T, R, Wr, attribute=attribute)
            assert port.launches["resolve"] == before + 1
            for g, w in zip(got, want):
                assert (g is None) == (w is None)
                if g is not None:
                    assert torch.equal(g.cpu(), w)
            got_u = port.resolve_step(
                torch.from_numpy(hk).to(cuda), torch.from_numpy(hv).to(cuda),
                *[torch.from_numpy(a).to(cuda) for a in arrays],
                COMMIT, OLDEST, attribute=attribute)
            for g, w in zip(got_u, want):
                if g is not None:
                    assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_window_kernel_matches_plain(cuda):
    hv = torch.from_numpy(_window_state(1 << 16))
    p = ref.REBASE_THRESHOLD
    for mode, args in ((port.REBASE, (5, 0, 0)), (port.RESET, (0, 0, 0)),
                       (port.JUMP_FIXUP, (p, 77, 1000)),
                       (port.JUMP_FIXUP_LARGE, (p, 77, 0))):
        got = port.window_upkeep(hv.to(cuda), mode, *args)
        assert torch.equal(got.cpu(), port.window_upkeep_plain(hv, mode,
                                                               *args))
