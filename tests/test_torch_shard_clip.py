"""Port parity for K7, ops/keys.py's row compare and shard clip: the
plain lt_rows / le_rows equal the reference's over random rows with
shared prefixes and differing length words, broadcast either way; and
the plain clip of a packed feed equals the begins, ends and validity
the reference's sharded step (`_clip_and_resolve_packed`) hands its
core, for 1, 4 and 8 shards, with ranges crossing and sitting on the
splits. On the card (CUDA-marked) K7 equals the plain versions. Every
output is integer or boolean: equality is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from foundationdb_tpu.ops import conflict_kernel as ref_ck  # noqa: E402
from foundationdb_tpu.ops import keys as ref_keys  # noqa: E402
from foundationdb_tpu.parallel.sharded_resolver import (  # noqa: E402
    _clip_and_resolve_packed,
    default_split_keys,
)
from foundationdb_tpu_torch.ops import conflict_kernel as ck  # noqa: E402
from foundationdb_tpu_torch.ops import keys  # noqa: E402

KEY_BYTES = 8
W = KEY_BYTES // 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rand_rows(rng, n, width=W + 1):
    """Rows over a tiny alphabet: long shared prefixes, equal rows and
    rows that differ only in the length word."""
    rows = rng.integers(0, 3, size=(n, width)).astype(np.uint32)
    rows[rng.random(n) < 0.1] = 0xFFFFFFFF
    return rows


def bounds(n_shards):
    """The reference resolver's [S, W+1] shard bounds for its default
    split keys: lows from b"", the last high the all-ones row."""
    lows = ref_keys.encode_keys([b""] + default_split_keys(n_shards),
                                KEY_BYTES)
    highs = np.full_like(lows, 0xFFFFFFFF)
    highs[:-1] = lows[1:]
    return lows, highs


def clip_batch(rng, n_shards, n):
    """[n, W+1] begin and end rows and a valid mask: random keys, the
    whole keyspace, ranges ending and starting exactly on each split,
    empty and reversed ranges, and invalid pad slots of zero rows."""
    lows, _highs = bounds(n_shards)
    split = [bytes([b]) for b in range(0, 256, 7)]
    ks = sorted(split + [s + b"\x00" for s in split])
    kb = ref_keys.encode_keys(ks, KEY_BYTES)
    b = kb[rng.integers(0, len(ks), n)]
    e = kb[rng.integers(0, len(ks), n)]
    b[0], e[0] = ref_keys.encode_keys([b""], KEY_BYTES)[0], 0xFFFFFFFF
    for i, lo in enumerate(lows[1:]):
        b[1 + 2 * i], e[1 + 2 * i] = lows[0], lo       # ends on the split
        b[2 + 2 * i], e[2 + 2 * i] = lo, e[2 + 2 * i]  # starts on it
    valid = rng.random(n) < 0.8
    valid[0] = True
    b[-4:], e[-4:], valid[-4:] = 0, 0, False           # pad slots
    return b, e, valid


def test_lt_le_rows_match_reference():
    rng = np.random.default_rng(0)
    a, b = rand_rows(rng, 500), rand_rows(rng, 500)
    b[:100] = a[:100]                                  # equal rows
    b[100:200, :-1] = a[100:200, :-1]                  # length word only
    for fn_ref, fn in ((ref_keys.lt_rows, keys.lt_rows),
                       (ref_keys.le_rows, keys.le_rows),
                       (ref_keys.lt_rows, keys.lt_rows_plain)):
        for x, y in ((a, b), (b, a), (a, a[7]), (a[3], b)):
            want = np.asarray(fn_ref(jnp.asarray(x), jnp.asarray(y)))
            got = fn(torch.from_numpy(x), torch.from_numpy(y))
            assert got.dtype == torch.bool
            np.testing.assert_array_equal(got.numpy(), want)


def _reference_clip(n_shards, buf, T, R, Wr):
    """What the reference's packed sharded wrapper hands its resolve
    core, shard by shard: a core that records its clipped inputs."""
    lows, highs = bounds(n_shards)
    unpack = ref_ck.make_interval_unpack(T, R, Wr, W)
    seen = []

    def core(hk, hv, snap, too_old, rb, re, rtxn, rvalid, wb, we, wtxn,
             wvalid, commit, oldest):
        seen.append([np.asarray(x) for x in (rb, re, rvalid, wb, we,
                                             wvalid)])
        return hk, hv, jnp.int32(0), jnp.zeros(T, bool), jnp.zeros(R, bool)

    fn = _clip_and_resolve_packed(core, True, unpack)
    hk = jnp.zeros((1, 8, W + 1), jnp.uint32)
    hv = jnp.zeros((1, 8), jnp.int32)
    for s in range(n_shards):
        fn(jnp.asarray(lows[s:s + 1]), jnp.asarray(highs[s:s + 1]), hk, hv,
           jnp.asarray(buf))
    return [np.stack(col) for col in zip(*seen)]


@pytest.mark.parametrize("n_shards", [1, 4, 8])
def test_clip_of_packed_feed_matches_reference(n_shards):
    rng = np.random.default_rng(n_shards)
    T, R, Wr = 16, 64, 32
    rb, re, rv = clip_batch(rng, n_shards, R)
    wb, we, wv = clip_batch(rng, n_shards, Wr)
    rt = np.sort(rng.integers(0, T, R)).astype(np.int32)
    wt = np.sort(rng.integers(0, T, Wr)).astype(np.int32)
    buf = ck.pack_interval_batch(np.zeros(T, np.int32), np.zeros(T, bool),
                                 rb, re, rt, rv, wb, we, wt, wv, 70, 20)
    want = _reference_clip(n_shards, buf, T, R, Wr)
    lows, highs = (torch.from_numpy(x) for x in bounds(n_shards))
    v = ck.interval_unpack(torch.from_numpy(buf), T, R, Wr, W)
    got = [*keys.clip_to_shards(v[2], v[3], v[5], lows, highs),
           *keys.clip_to_shards(v[6], v[7], v[9], lows, highs)]
    for name, g, w in zip(("rb", "re", "rvalid", "wb", "we", "wvalid"),
                          got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    # every crossing range is valid in more than one shard
    if n_shards > 1:
        assert int(got[2][:, 0].sum()) == n_shards


def test_pad_rows_clip_invalid():
    lows, highs = (torch.from_numpy(x) for x in bounds(4))
    z = torch.zeros((3, W + 1), dtype=torch.uint32)
    _cb, _ce, cv = keys.clip_to_shards(z, z, torch.ones(3, dtype=torch.bool),
                                       lows, highs)
    assert not bool(cv.any())


@pytest.mark.cuda
def test_k7_matches_plain(cuda):
    rng = np.random.default_rng(5)
    a, b = rand_rows(rng, 3000), rand_rows(rng, 3000)
    b[:500] = a[:500]
    for x, y in ((a, b), (a, b[9]), (a[4], b)):
        before = keys.launches["shard_clip"]
        got = keys.lt_rows(torch.from_numpy(x).to(cuda),
                           torch.from_numpy(y).to(cuda))
        assert keys.launches["shard_clip"] == before + 1
        assert torch.equal(got.cpu(), keys.lt_rows_plain(
            torch.from_numpy(x), torch.from_numpy(y)))
    for n_shards in (1, 4, 8):
        lows, highs = (torch.from_numpy(x) for x in bounds(n_shards))
        rb, re, rv = clip_batch(rng, n_shards, 4096)
        args = [torch.from_numpy(x) for x in (rb, re, rv.astype(np.uint32))]
        want = keys.clip_to_shards_plain(*args, lows, highs)
        got = keys.clip_to_shards(*[x.to(cuda) for x in args],
                                  lows.to(cuda), highs.to(cuda))
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
