"""K8f's fixpoint without the overlap matrix, held to the dense form.

K8f (csrc/shard_step.cu) finds, each round, the least transaction id of
an alive write that overlaps a read from two trees over the batch's
sorted endpoint positions, in place of the R x Wr overlap matrix that
the plain version (`ops/conflict_kernel.py` `_overlap`, `_fixpoint`)
builds. The mirror below is that round in plain PyTorch, laid out as the
kernel lays it out: every endpoint's position in the total order (key,
end before begin, index); a range-min tree whose leaf w_lo holds an
alive write's wtxn, queried over the read's open range (r_lo, r_hi); a
stabbing-min tree that each alive write lowers to its wtxn on the
canonical nodes of (w_lo, w_hi), read along r_lo's path to the root;
the changed test, the base verdicts and the cap of T + 2 rounds. It must
give the dense form's verdicts and read_hit (attribution on) on every
adversarial batch kind of `foundationdb_tpu_torch.testing` and on random
rank-space layouts with empty, inverted, nested and equal-key ranges.
The port's K8e and K8f plain versions are also held to the reference's
shard_map'd sharded step on the same seeded batches. Every output is
integer or boolean: equality is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from foundationdb_tpu.parallel import ShardedTpuConflictSet  # noqa: E402
from foundationdb_tpu_torch import testing as tg  # noqa: E402
from foundationdb_tpu_torch.ops import conflict_kernel as ck  # noqa: E402
from foundationdb_tpu_torch.ops import keys  # noqa: E402

KIND_SHAPE = (1024, 32, 64, 64)   # cap, T, R, Wr
N_WORDS = 2
NONE = (1 << 31) - 1              # no alive write
BEGIN = 1 << 31                   # the begin tag bit of a record


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the mirror of K8f's fixpoint
# ---------------------------------------------------------------------------

def positions(rb, re, rvalid, wb, we, wvalid):
    """Each endpoint's sorted position in the order K8f's sort gives:
    records of (key words, tag), the tag BEGIN | g for rb and wb and g
    for we and re (g: rb [0, R), wb [R, R+Wr), we [R+Wr, R+2Wr), re
    after), an invalid read's rb and an invalid write's wb and we the
    +inf row. Returns (r_lo, r_hi, w_lo, w_hi, at), `at` the endpoint
    at each position."""
    R, Wr = rb.shape[0], wb.shape[0]
    inf = torch.full_like(rb[:1], 0xFFFFFFFF)
    rows = torch.cat([torch.where(rvalid[:, None], rb, inf),
                      torch.where(wvalid[:, None], wb, inf),
                      torch.where(wvalid[:, None], we, inf), re])
    g = torch.arange(rows.shape[0], dtype=torch.int64)
    tag = torch.where(g < R + Wr, g | BEGIN, g)
    cols = [rows[:, w] for w in range(rows.shape[1])] + [tag]
    order = torch.arange(rows.shape[0])
    for c in reversed(cols):                  # lexicographic, stable
        order = order[torch.sort(c[order], stable=True).indices]
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.shape[0])
    return (pos[:R], pos[R + 2 * Wr:], pos[R:R + Wr], pos[R + Wr:R + 2 * Wr],
            order)


def leaves_for(n):
    np_ = 1
    while np_ < n:
        np_ <<= 1
    return np_


def range_min_tree(leaf, n_leaves):
    """The heap of mins over `leaf` [NP]: node k's children 2k, 2k+1,
    leaf p at NP + p, built level by level as K8f folds it."""
    tree = torch.full((2 * n_leaves,), NONE, dtype=torch.int64)
    tree[n_leaves:] = leaf
    k = n_leaves // 2
    while k >= 1:
        tree[k:2 * k] = torch.minimum(tree[2 * k:4 * k:2],
                                      tree[2 * k + 1:4 * k:2])
        k //= 2
    return tree


def range_min(tree, n_leaves, a, b):
    """min over leaves [a, b): K8f's bottom-up walk."""
    m, a, b = NONE, a + n_leaves, b + n_leaves
    while a < b:
        if a & 1:
            m = min(m, int(tree[a]))
            a += 1
        if b & 1:
            b -= 1
            m = min(m, int(tree[b]))
        a >>= 1
        b >>= 1
    return m


def stab_tree(writes, n_leaves):
    """Each (lo, hi, v): v min'ed onto the canonical nodes of the open
    range (lo, hi), K8f's atomicMin walk (order-free)."""
    tree = [NONE] * (2 * n_leaves)
    for lo, hi, v in writes:
        a, b = lo + 1 + n_leaves, hi + n_leaves
        while a < b:
            if a & 1:
                tree[a] = min(tree[a], v)
                a += 1
            if b & 1:
                b -= 1
                tree[b] = min(tree[b], v)
            a >>= 1
            b >>= 1
    return tree


def stab_min(tree, n_leaves, p):
    m, k = NONE, p + n_leaves
    while k >= 1:
        m = min(m, tree[k])
        k >>= 1
    return m


def mirror_fixpoint(rb, re, rtxn, rvalid, wb, we, wtxn, wvalid, too_old,
                    ext_all, r_starts, attribute):
    """K8f's fixpoint round by round: (conflict_pad [T+1], read_hit or
    None). `r_starts` are K1's segment starts [T+2]."""
    T, R = too_old.shape[0], rb.shape[0]
    r_lo, r_hi, w_lo, w_hi, at = positions(rb, re, rvalid, wb, we, wvalid)
    n = at.shape[0]
    n_leaves = leaves_for(n)
    rs = [int(x) for x in r_starts]
    ext_any = ext_all.any(dim=0)
    base = [1] * (T + 1)
    for t in range(T):
        base[t] = int(bool(ext_any[rs[t]:rs[t + 1]].any())
                      or bool(too_old[t]))
    seg = [-1] * R
    for t in range(T):
        for r in range(rs[t], rs[t + 1]):
            seg[r] = t
    read_ok = [bool(rvalid[r]) and int(r_lo[r]) < int(r_hi[r])
               for r in range(R)]
    write_ok = [bool(wvalid[w]) and int(w_lo[w]) < int(w_hi[w])
                for w in range(wb.shape[0])]

    def alive(c, txn):
        return c[min(max(txn, 0), T)] == 0

    def trees(c):
        leaf = torch.full((n_leaves,), NONE, dtype=torch.int64)
        for p in range(n):
            w = int(at[p]) - R
            if 0 <= w < wb.shape[0] and write_ok[w] \
                    and alive(c, int(wtxn[w])):
                leaf[p] = int(wtxn[w])
        stab = stab_tree([(int(w_lo[w]), int(w_hi[w]), int(wtxn[w]))
                          for w in range(wb.shape[0])
                          if write_ok[w] and alive(c, int(wtxn[w]))],
                         n_leaves)
        return range_min_tree(leaf, n_leaves), stab

    def read_min(rm, stab, r):
        lo, hi = int(r_lo[r]), int(r_hi[r])
        return min(range_min(rm, n_leaves, lo + 1, hi),
                   stab_min(stab, n_leaves, lo))

    cur, prev, i = list(base), None, 0
    while True:
        rm, stab = trees(cur)
        if i > 0 and (prev == cur or i >= T + 2):
            break
        nxt = list(base)
        for r in range(R):
            t = seg[r]
            if t >= 0 and read_ok[r] and not nxt[t] \
                    and read_min(rm, stab, r) < int(rtxn[r]):
                nxt[t] = 1
        prev, cur, i = cur, nxt, i + 1
    read_hit = None
    if attribute:
        read_hit = torch.tensor(
            [(read_ok[r] and read_min(rm, stab, r) < int(rtxn[r]))
             or bool(ext_all[:, r].any()) for r in range(R)])
    return torch.tensor(cur, dtype=torch.bool), read_hit


def dense_fixpoint(rb, re, rtxn, rvalid, wb, we, wtxn, wvalid, too_old,
                   ext_all, attribute):
    """The plain K8f's verdicts: the overlap matrix over the unclipped
    ranges, an empty or inverted range invalid, and `_fixpoint` over
    it. Returns (conflict_pad, read_hit, r_starts)."""
    i64 = torch.int64
    n = too_old.shape[0]
    rtxn, wtxn = rtxn.to(i64), wtxn.to(i64)
    r_starts = ck.searchsorted_i32_plain(
        rtxn, torch.arange(n + 2, dtype=i64)).to(i64)
    rv = rvalid & keys.lt_rows_plain(rb, re)
    wv = wvalid & keys.lt_rows_plain(wb, we)
    ovp = ck._overlap(rb, re, rtxn, rv, wb, we, wtxn, wv,
                      min(32, wtxn.shape[0]))
    ext = ck._seg_any(ext_all.any(dim=0), r_starts, n)
    conflict, read_hit = ck._fixpoint(ext, too_old, [ovp], wtxn, r_starts,
                                      attribute, list(ext_all))
    return conflict, read_hit, r_starts


def assert_mirror_is_dense(rb, re, rtxn, rvalid, wb, we, wtxn, wvalid,
                           too_old, ext_all):
    want_c, want_h, r_starts = dense_fixpoint(
        rb, re, rtxn, rvalid, wb, we, wtxn, wvalid, too_old, ext_all, True)
    got_c, got_h = mirror_fixpoint(rb, re, rtxn, rvalid, wb, we, wtxn,
                                   wvalid, too_old, ext_all, r_starts, True)
    assert torch.equal(got_c, want_c)
    assert torch.equal(got_h, want_h)
    return want_c


def kind_inputs(kind, seed=0, n_devices=4):
    """A kind's batch at the kinds' shape as int64 rows and bool flags,
    with seeded external flags from `n_devices` shards (a tenth set)."""
    cap, T, R, Wr = KIND_SHAPE
    _hk, _hv, (snap, too_old, rb, re, rt, rv, wb, we, wt, wv) = \
        tg.adversarial_batch(np.random.default_rng(seed), kind, cap, T, R,
                             Wr, N_WORDS)
    rng = np.random.default_rng(seed + 1)
    ext_all = torch.from_numpy(rng.random((n_devices, R)) < 0.03)
    t64 = [torch.from_numpy(x.astype(np.int64)) for x in (rb, re, wb, we)]
    return (t64[0], t64[1], torch.from_numpy(rt), torch.from_numpy(rv),
            t64[2], t64[3], torch.from_numpy(wt), torch.from_numpy(wv),
            torch.from_numpy(too_old), ext_all)


@pytest.mark.parametrize("kind", tg.KINDS)
def test_mirror_equals_dense_on_kinds(kind):
    assert_mirror_is_dense(*kind_inputs(kind))


def test_mirror_equals_dense_with_no_external_flags():
    """The chain's verdicts come from the fixpoint alone: it alternates
    down the links, so the rounds run to the chain's length."""
    args = list(kind_inputs("chain"))
    args[-1] = torch.zeros_like(args[-1])
    args[-2] = torch.zeros_like(args[-2])
    conflict = assert_mirror_is_dense(*args)
    assert not conflict[0] and conflict[1] and not conflict[2]


def test_nested_kind_reaches_high_nodes():
    """The nested kind's wide writes contain other writes, and its wide
    reads span several write begins."""
    rb, re, _rt, rv, wb, we, _wt, wv, _to, _ext = kind_inputs("nested")

    def ids(x):
        return (x[:, 0] << 32) | x[:, 1]
    b, e, wbi, wei = ids(rb), ids(re), ids(wb), ids(we)
    inner = ((wbi[None, :] >= wbi[:, None]) & (wei[None, :] <= wei[:, None])
             & wv[None, :] & wv[:, None]).sum(1) - 1
    assert int(inner.max()) >= 4
    begins = ((wbi[None, :] > b[:, None]) & (wbi[None, :] < e[:, None])
              & wv[None, :] & rv[:, None]).sum(1)
    assert int(begins.max()) >= 8


@st.composite
def rank_layouts(draw):
    """A batch over a tiny keyspace (one key word and the length word):
    ranges empty, inverted, nested and on equal keys, transaction ids
    sorted with pad slots at T, validity and external flags random."""
    T = draw(st.integers(1, 6))
    R = draw(st.sampled_from([1, 2, 4, 8, 16]))
    Wr = draw(st.integers(1, 12))
    key = st.integers(0, 7)

    def rows(n):
        b = draw(st.lists(key, min_size=n, max_size=n))
        e = draw(st.lists(key, min_size=n, max_size=n))
        out_b = torch.tensor([[k, 4] for k in b], dtype=torch.int64)
        out_e = torch.tensor([[k, 4] for k in e], dtype=torch.int64)
        return out_b, out_e

    def txns(n):
        ids = sorted(draw(st.lists(st.integers(0, T), min_size=n,
                                   max_size=n)))
        return torch.tensor(ids, dtype=torch.int32)

    def flags(n):
        return torch.tensor(draw(st.lists(st.booleans(), min_size=n,
                                          max_size=n)), dtype=torch.bool)
    rb, re = rows(R)
    wb, we = rows(Wr)
    rt, wt = txns(R), txns(Wr)
    rv, wv = flags(R) & (rt < T), flags(Wr) & (wt < T)
    too_old = flags(T)
    ext_all = torch.stack([flags(R) for _ in range(draw(st.integers(1, 3)))])
    ext_all &= torch.tensor(draw(st.lists(st.booleans(), min_size=R,
                                          max_size=R)))
    return rb, re, rt, rv, wb, we, wt, wv, too_old, ext_all


@settings(max_examples=150, deadline=None, derandomize=True)
@given(rank_layouts())
def test_mirror_equals_dense_on_random_layouts(layout):
    assert_mirror_is_dense(*layout)


# ---------------------------------------------------------------------------
# K8e's and K8f's plain versions against the reference's sharded step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref4():
    return ShardedTpuConflictSet(capacity=KIND_SHAPE[0], n_shards=4,
                                 key_bytes=4 * N_WORDS)


def _np(outs):
    return [None if x is None else np.asarray(x) for x in outs]


@pytest.mark.parametrize("kind", ["nested", "chain", "mixed", "clip_edges"])
@pytest.mark.parametrize("attribute", [True, False])
def test_split_plain_equals_reference_step(ref4, kind, attribute):
    """K8e's plain version on every shard, the flags stacked as the
    all-gather leaves them, then K8f's plain version on every shard,
    against the reference's shard_map'd packed step on the same batch,
    fresh and one step on: each shard's state and count, and every
    shard's verdicts and read_hit."""
    cap, T, R, Wr = KIND_SHAPE
    splits = tg.split_ids(4 * T, 4)
    hk, hv, arrays = tg.adversarial_batch(
        np.random.default_rng(7), kind, cap, T, R, Wr, N_WORDS,
        splits=splits)
    lows, highs = tg.shard_bounds(splits, N_WORDS)
    state = tg.shard_history(hk, hv, lows, highs)
    fn = ref4._get_shard_packed_fn(T, R, Wr, attribute)
    bounds = ref4._make_bounds(lows)
    lows_t, highs_t = torch.from_numpy(lows), torch.from_numpy(highs)
    for commit in (tg.COMMIT, tg.COMMIT + 20):
        buf = ck.pack_interval_batch(*arrays, commit, tg.OLDEST)
        dev_state = jax.device_put(state,
                                   NamedSharding(ref4._mesh, P(ref4.AXIS)))
        want = _np(fn(*bounds, *dev_state, ref4._feed(buf)))
        unpacked = ck.interval_unpack(torch.from_numpy(buf), T, R, Wr,
                                      N_WORDS)
        shk, shv = (torch.from_numpy(np.array(x)) for x in state)
        ext_all = torch.stack([ck.resolve_shard_ext_plain(
            shk[i], shv[i], *unpacked, lows_t[i], highs_t[i])
            for i in range(4)])
        for i in range(4):
            got = _np(ck.resolve_shard_finish_plain(
                shk[i], shv[i], *unpacked, lows_t[i], highs_t[i], ext_all,
                attribute))
            np.testing.assert_array_equal(got[0], want[0][i])
            np.testing.assert_array_equal(got[1], want[1][i])
            np.testing.assert_array_equal(got[2], want[2][i])
            np.testing.assert_array_equal(got[3], want[3])
            if attribute:
                np.testing.assert_array_equal(got[4], want[4])
            else:
                assert got[4] is None
        state = (want[0], want[1])
