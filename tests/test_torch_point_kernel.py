"""Port parity for ops/point_kernel.py and the row search of ops/keys.py:
the packed point feed helpers build buffers identical to the
reference's; on one buffer from the reference's pack_point_batch, the
port's plain point step (K5's plain version) matches the reference's
jitted step on the JAX CPU backend in all five outputs, with
attribution on and off, over several shape buckets and seeds, on states
that hold duplicate keys, rows below the window and no pad row; the
unpacked entry matches too, and so does a batch whose surviving
+inf-key writes commit above VMASK (they sort past every masked row);
the last transaction's read is checked when no pad slot exists; and the
plain row search, its per-query-side
variant and the row order (K6's plain version) match the reference,
the no-pad cap-1 answer included. The point batch kinds of
`foundationdb_tpu_torch.testing` (every write on one key, every write
invalid, +inf-key writes, a tiny alphabet) match the reference too, at
Wr = 32 and Wr = 1. Every output is integer or boolean: equality is
exact. On a card, K5 is held to the plain step on the same kinds, also
at a Wr that is no power of two, over several sort tiles, and at keys
of 41 and 101 words."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from foundationdb_tpu.ops import keys as ref_keys  # noqa: E402
from foundationdb_tpu.ops import point_kernel as ref  # noqa: E402
from foundationdb_tpu_torch import testing as tg  # noqa: E402
from foundationdb_tpu_torch.ops import keys as port_keys  # noqa: E402
from foundationdb_tpu_torch.ops import point_kernel as port  # noqa: E402

VDEAD = -(1 << 30)
BUCKETS = [  # (cap, T, R, Wr, W)
    (64, 16, 32, 32, 2),
    (256, 32, 64, 32, 1),
    (128, 16, 32, 64, 4),
]
COMMIT, OLDEST = 70, 20
POINT_EDGE_SHAPES = [(64, 16, 32, 32, 2), (64, 16, 32, 1, 2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(rng, n, W):
    """Key rows over a tiny alphabet, so reads, writes and state rows
    collide (duplicate keys, same-key runs across transactions)."""
    rows = rng.integers(0, 3, size=(n, W + 1)).astype(np.uint32)
    rows[:, W] = rng.integers(0, 3, size=n)
    return rows


def _sorted(keys, vals):
    order = np.lexsort([vals] + [keys[:, w]
                                 for w in range(keys.shape[1] - 1, -1, -1)])
    return keys[order], vals[order]


def rand_state(rng, cap, W):
    """A point state as the resolver holds it: rows sorted by (key,
    version) with duplicate keys, versions on both sides of OLDEST, then
    +inf padding (sometimes none at all: a full state)."""
    n = int(rng.integers(0, cap + 1))
    keys, vals = _sorted(_rows(rng, n, W),
                         rng.integers(-5, 60, n).astype(np.int32))
    sk = np.full((cap, W + 1), 0xFFFFFFFF, np.uint32)
    sv = np.full(cap, ref.VMASK if rng.random() < 0.5 else VDEAD, np.int32)
    sk[:n], sv[:n] = keys, vals
    return sk, sv


def rand_batch(rng, T, R, Wr, W):
    """One padded batch as the 8 host arrays the marshaller produces:
    txn ids non-decreasing with pad = T, some tooOld."""
    nt = int(rng.integers(1, T + 1))
    nr = int(rng.integers(1, R + 1))
    nw = int(rng.integers(1, Wr + 1))
    rk = np.zeros((R, W + 1), np.uint32)
    wk = np.zeros((Wr, W + 1), np.uint32)
    rk[:nr], wk[:nw] = _rows(rng, nr, W), _rows(rng, nw, W)
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
    return snap, too_old, rk, rt, rv, wk, wt, wv


def _np(outs):
    return [None if x is None else np.asarray(x) for x in outs]


def _assert_outputs(got, want):
    for name, g, w in zip(("SK", "SV", "count", "conflict", "read_hit"),
                          _np(got), _np(want)):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_feed_helpers_identical():
    rng = np.random.default_rng(0)
    for cap, T, R, Wr, W in BUCKETS:
        arrays = rand_batch(rng, T, R, Wr, W)
        assert port.point_feed_len(T, R, Wr, W) == \
            ref.point_feed_len(T, R, Wr, W)
        a = port.pack_point_batch(*arrays, COMMIT, OLDEST, 7)
        b = ref.pack_point_batch(*arrays, COMMIT, OLDEST, 7)
        assert a.dtype == b.dtype == np.uint32
        assert a.tobytes() == b.tobytes()
        va = port.point_batch_views(a, T, R, Wr, W)
        vb = ref.point_batch_views(b, T, R, Wr, W)
        assert va._fields == vb._fields
        for x, y in zip(va, vb):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
    assert (port.VMASK, port.INF) == (ref.VMASK, ref.INF)


@pytest.mark.parametrize("bucket", BUCKETS)
@pytest.mark.parametrize("attribute", [True, False])
def test_plain_packed_step_matches_reference(bucket, attribute):
    cap, T, R, Wr, W = bucket
    jfn = ref.make_point_resolve_packed_fn(cap, T, R, Wr, W,
                                           attribute=attribute,
                                           donate=False)
    rng = np.random.default_rng(cap + T + R + Wr + W)
    for _trial in range(4):
        sk, sv = rand_state(rng, cap, W)
        init_off = int(rng.integers(0, 40))
        buf = ref.pack_point_batch(*rand_batch(rng, T, R, Wr, W),
                                   COMMIT, OLDEST, init_off)
        want = list(jfn(sk, sv, buf))
        got = port.point_resolve_step_packed(
            torch.from_numpy(sk), torch.from_numpy(sv),
            torch.from_numpy(buf), T, R, Wr, attribute=attribute)
        assert got[0].dtype == torch.uint32 and got[1].dtype == torch.int32
        assert (got[4] is None) == (not attribute)
        _assert_outputs(got[:len(want)], want)


@pytest.mark.parametrize("attribute", [True, False])
def test_plain_unpacked_step_matches_reference(attribute):
    cap, T, R, Wr, W = BUCKETS[0]
    jfn = ref.make_point_resolve_fn(cap, T, R, Wr, W, attribute=attribute,
                                    donate=False)
    rng = np.random.default_rng(77)
    for _trial in range(3):
        sk, sv = rand_state(rng, cap, W)
        arrays = rand_batch(rng, T, R, Wr, W)
        want = list(jfn(sk, sv, *arrays, jnp.int32(COMMIT),
                        jnp.int32(OLDEST), jnp.int32(5)))
        got = port.point_resolve_step(
            torch.from_numpy(sk), torch.from_numpy(sv),
            *[torch.from_numpy(a) for a in arrays],
            torch.tensor(COMMIT, dtype=torch.int32), OLDEST, 5,
            attribute=attribute)
        _assert_outputs(got[:len(want)], want)


def _inf_write_case(rng, cap, T, R, Wr, W):
    """A batch whose surviving writes include +inf-key rows, committed
    above VMASK: in the reference's one big sort they land after every
    masked row, so past cap, counted but never stored."""
    sk, sv = rand_state(rng, cap, W)
    arrays = list(rand_batch(rng, T, R, Wr, W))
    arrays[5][:3] = 0xFFFFFFFF
    arrays[6][:3] = 0
    arrays[7][:3] = True
    return sk, sv, arrays, ref.VMASK + 3


def test_inf_key_writes_match_reference():
    cap, T, R, Wr, W = BUCKETS[0]
    jfn = ref.make_point_resolve_packed_fn(cap, T, R, Wr, W, donate=False)
    rng = np.random.default_rng(21)
    for _trial in range(3):
        sk, sv, arrays, commit = _inf_write_case(rng, cap, T, R, Wr, W)
        buf = ref.pack_point_batch(*arrays, commit, OLDEST, 3)
        got = port.point_resolve_step_packed(
            torch.from_numpy(sk), torch.from_numpy(sv),
            torch.from_numpy(buf), T, R, Wr)
        _assert_outputs(got, list(jfn(sk, sv, buf)))


def _no_pad_batches(n):
    """The reference's pad-free drive (tests/test_point_resolver.py:205):
    nr == n_txns with every slot valid. Batch 1: txn i writes key i;
    batch 2: txn i reads key i at a pre-write snapshot."""
    keys = port_keys.encode_keys([b"k%02d" % i for i in range(n)], 8)
    zeros = np.zeros((n, 3), np.uint32)
    rt = np.arange(n, dtype=np.int32)
    valid = np.ones(n, bool)
    first = (np.zeros(n, np.int32), np.zeros(n, bool), zeros, rt,
             np.zeros(n, bool), keys, rt, valid, 100, 0, 0)
    second = (np.full(n, 50, np.int32), np.zeros(n, bool), keys, rt, valid,
              zeros, rt, np.zeros(n, bool), 200, 0, 0)
    return first, second


def test_no_pad_last_txn_checked():
    """Every slot valid and no pad row: the LAST transaction's read is
    still conflict-checked (K1's correction step reaches r_starts[n] =
    n), and every read is the cause of its transaction's conflict."""
    n = 16
    sk = torch.full((64, 3), 0xFFFFFFFF, dtype=torch.uint32)
    sv = torch.full((64,), VDEAD, dtype=torch.int32)

    def step(state, batch):
        return port.point_resolve_step(
            *state, *[torch.from_numpy(a) if isinstance(a, np.ndarray)
                      else a for a in batch])

    first, second = _no_pad_batches(n)
    sk2, sv2, _count, conflict, _hit = step((sk, sv), first)
    assert not conflict.any()
    _sk3, _sv3, _count, conflict, read_hit = step((sk2, sv2), second)
    assert conflict.all() and read_hit.all()


def _sorted_table(rng, cap, W, pad):
    keys, _ = _sorted(_rows(rng, cap, W), np.zeros(cap, np.int32))
    if pad:
        keys[-max(1, cap // 4):] = 0xFFFFFFFF
    return keys


@pytest.mark.parametrize("cap", [1, 2, 8, 64])
def test_plain_row_search_matches_reference(cap):
    rng = np.random.default_rng(cap)
    W = 2
    for pad in (True, False):
        table = _sorted_table(rng, cap, W, pad)
        q = np.concatenate([_rows(rng, 40, W), table[:3],
                            np.full((2, W + 1), 0xFFFFFFFF, np.uint32)])
        t_t, q_t = torch.from_numpy(table), torch.from_numpy(q)
        for side in ("left", "right"):
            want = np.asarray(ref_keys.searchsorted_rows(
                jnp.asarray(table), jnp.asarray(q), side=side))
            got = port_keys.searchsorted_rows(t_t, q_t, side)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
        # no pad row: a query above every row answers cap-1, not cap
        if not pad:
            top = port_keys.searchsorted_rows(
                t_t, torch.full((1, W + 1), 0xFFFFFFFF, dtype=torch.uint32),
                "right")
            assert int(top[0]) == cap - 1
        mask = rng.random(q.shape[0]) < 0.5
        want = np.asarray(ref_keys.searchsorted_rows_mixed(
            jnp.asarray(table), jnp.asarray(q), jnp.asarray(mask)))
        got = port_keys.searchsorted_rows_mixed(t_t, q_t,
                                                torch.from_numpy(mask))
        np.testing.assert_array_equal(got.numpy(), want)
        a, b = q[:, None, :], table[None, :, :]
        for fn_ref, fn_port in ((ref_keys.lt_rows, port_keys.lt_rows),
                                (ref_keys.le_rows, port_keys.le_rows)):
            np.testing.assert_array_equal(
                fn_port(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                np.asarray(fn_ref(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("kind", tg.POINT_KINDS)
@pytest.mark.parametrize("attribute", [True, False])
def test_plain_step_matches_reference_on_point_kinds(kind, attribute):
    for cap, T, R, Wr, W in POINT_EDGE_SHAPES:
        jfn = ref.make_point_resolve_packed_fn(cap, T, R, Wr, W,
                                               attribute=attribute,
                                               donate=False)
        for seed in (0, 1):
            sk, sv, arrays = tg.point_batch(np.random.default_rng(seed),
                                            kind, cap, T, R, Wr, W)
            buf = ref.pack_point_batch(*arrays, COMMIT, OLDEST, 9)
            got = port.point_resolve_step_packed(
                torch.from_numpy(sk), torch.from_numpy(sv),
                torch.from_numpy(buf), T, R, Wr, attribute=attribute)
            _assert_outputs(got, list(jfn(sk, sv, buf)))


def test_packed_step_rejects_mismatched_buffer():
    cap, T, R, Wr, W = BUCKETS[0]
    sk, sv = rand_state(np.random.default_rng(1), cap, W)
    with pytest.raises(ValueError):
        port.point_resolve_step_packed(torch.from_numpy(sk),
                                       torch.from_numpy(sv),
                                       torch.zeros(7, dtype=torch.uint32),
                                       T, R, Wr)


@pytest.mark.cuda
@pytest.mark.parametrize("attribute", [True, False])
def test_point_kernel_matches_plain(cuda, attribute):
    rng = np.random.default_rng(5)
    for cap, T, R, Wr, W in BUCKETS:
        for _trial in range(4):
            sk, sv = rand_state(rng, cap, W)
            arrays = rand_batch(rng, T, R, Wr, W)
            buf = torch.from_numpy(port.pack_point_batch(
                *arrays, COMMIT, OLDEST, 9))
            want = port.point_resolve_step_packed(
                torch.from_numpy(sk), torch.from_numpy(sv), buf, T, R, Wr,
                attribute=attribute)
            before = port.launches["point_resolve"]
            got = port.point_resolve_step_packed(
                torch.from_numpy(sk).to(cuda), torch.from_numpy(sv).to(cuda),
                buf.to(cuda), T, R, Wr, attribute=attribute)
            assert port.launches["point_resolve"] == before + 1
            _assert_outputs([None if g is None else g.cpu() for g in got],
                            want)
            got_u = port.point_resolve_step(
                torch.from_numpy(sk).to(cuda), torch.from_numpy(sv).to(cuda),
                *[torch.from_numpy(a).to(cuda) for a in arrays],
                COMMIT, OLDEST, 9, attribute=attribute)
            _assert_outputs([None if g is None else g.cpu() for g in got_u],
                            want)
        sk, sv, arrays, commit = _inf_write_case(rng, cap, T, R, Wr, W)
        args = [commit, OLDEST, 3]
        want = port.point_resolve_step(
            torch.from_numpy(sk), torch.from_numpy(sv),
            *[torch.from_numpy(a) for a in arrays], *args,
            attribute=attribute)
        got = port.point_resolve_step(
            torch.from_numpy(sk).to(cuda), torch.from_numpy(sv).to(cuda),
            *[torch.from_numpy(a).to(cuda) for a in arrays], *args,
            attribute=attribute)
        _assert_outputs([None if g is None else g.cpu() for g in got], want)


@pytest.mark.cuda
def test_no_pad_kernel_matches_plain(cuda):
    n = 16
    state = (torch.full((64, 3), 0xFFFFFFFF, dtype=torch.uint32),
             torch.full((64,), VDEAD, dtype=torch.int32))
    for batch in _no_pad_batches(n):
        args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                for a in batch]
        want = port.point_resolve_step(*state, *args)
        got = port.point_resolve_step(
            *[s.to(cuda) for s in state],
            *[a.to(cuda) if isinstance(a, torch.Tensor) else a
              for a in args])
        _assert_outputs([g.cpu() for g in got], want)
        state = want[:2]


@pytest.mark.cuda
def test_row_search_kernel_matches_plain(cuda):
    rng = np.random.default_rng(11)
    for cap in (1, 2, 64, 4096):
        for pad in (True, False):
            table = torch.from_numpy(_sorted_table(rng, cap, 4, pad))
            q = torch.from_numpy(np.concatenate(
                [_rows(rng, 500, 4), table[:5].numpy(),
                 np.full((2, 5), 0xFFFFFFFF, np.uint32)]))
            mask = torch.from_numpy(rng.random(q.shape[0]) < 0.5)
            for side in ("left", "right"):
                got = port_keys.searchsorted_rows(table.to(cuda), q.to(cuda),
                                                  side)
                assert torch.equal(got.cpu(), port_keys.searchsorted_rows(
                    table, q, side))
            got = port_keys.searchsorted_rows_mixed(
                table.to(cuda), q.to(cuda), mask.to(cuda))
            assert torch.equal(got.cpu(), port_keys.searchsorted_rows_mixed(
                table, q, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", tg.POINT_KINDS)
def test_point_kernel_matches_plain_on_point_kinds(cuda, kind):
    """K5 against its plain step on the point kinds: Wr = 32 and 1, Wr =
    3000 (no power of two, two sort tiles and a merge round), and keys
    of 41 and 101 words (sort records of 16 and 32 uint4s); packed and
    unpacked, attributed and not, from the kind's state and one step
    later."""
    shapes = POINT_EDGE_SHAPES + [(4096, 1024, 1024, 3000, 4),
                                  (256, 64, 64, 64, 40),
                                  (256, 64, 64, 64, 100)]
    for cap, T, R, Wr, W in shapes:
        sk, sv, arrays = tg.point_batch(np.random.default_rng(cap + Wr + W),
                                        kind, cap, T, R, Wr, W)
        for attribute in (True, False):
            state = (torch.from_numpy(sk), torch.from_numpy(sv))
            for commit in (COMMIT, COMMIT + 20):
                buf = torch.from_numpy(port.pack_point_batch(
                    *arrays, commit, OLDEST, 9))
                want = port.point_resolve_step_packed(
                    *state, buf, T, R, Wr, attribute=attribute)
                before = port.launches["point_resolve"]
                got = port.point_resolve_step_packed(
                    state[0].to(cuda), state[1].to(cuda), buf.to(cuda), T,
                    R, Wr, attribute=attribute)
                got_u = port.point_resolve_step(
                    state[0].to(cuda), state[1].to(cuda),
                    *[torch.from_numpy(a).to(cuda) for a in arrays], commit,
                    OLDEST, 9, attribute=attribute)
                assert port.launches["point_resolve"] == before + 2
                for outs in (got, got_u):
                    _assert_outputs([None if g is None else g.cpu()
                                     for g in outs], want)
                state = want[:2]
