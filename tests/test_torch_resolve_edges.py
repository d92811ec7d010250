"""Edge batches for the interval resolve step (K3) and K1.

The adversarial batches of `foundationdb_tpu_torch.testing` (duplicate
endpoints, empty and inverted ranges, +inf and all-0xFF key rows, every
write invalid, a conflict chain that makes the fixpoint run one round
per link, and a mix of them) go through the reference's jitted steps on
the JAX CPU backend and through the port's plain steps: every output
equal, bit for bit, with attribution on and off, packed and unpacked.
On a card, K3 is held to the plain version on the same batches (and at
keys of 41 and 101 words, which take the endpoint sort's two widest
record sizes), and K1 to its plain version on unsorted tables and at
n = 1, 2 and 2^16 (the table larger than the kernel stages in shared
memory). The shard-bound kinds also run at key widths of 4, 8 and 12
words, past the external check's 8 words loaded a probed row, against
the reference on the CPU and K3 against its plain version on a card.
Every output is integer or boolean: equality is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from foundationdb_tpu.ops import conflict_kernel as ref  # noqa: E402
from foundationdb_tpu_torch import testing as tg  # noqa: E402
from foundationdb_tpu_torch.ops import conflict_kernel as port  # noqa: E402
from foundationdb_tpu_torch.ops import keys  # noqa: E402

CAP, T, R, WR, W = 256, 32, 64, 64, 2
SEEDS = (0, 1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _np(outs):
    return [None if x is None else np.asarray(x) for x in outs]


def _batches(kind):
    for seed in SEEDS:
        yield tg.adversarial_batch(np.random.default_rng(seed), kind, CAP, T,
                                   R, WR, W)


def test_generator_hits_its_corners():
    """Each kind holds what it is named for, and the chain makes the
    plain fixpoint alternate down the links."""
    rng = np.random.default_rng(0)
    inf = np.full(W + 1, 0xFFFFFFFF, np.uint32)
    _hk, _hv, a = tg.adversarial_batch(rng, "empty_inverted", CAP, T, R, WR, W)
    rb, re = a[2].astype(np.int64), a[3].astype(np.int64)
    assert (rb == re).all(axis=1).any()
    assert any(tuple(x) > tuple(y) for x, y in zip(rb, re))
    _hk, _hv, a = tg.adversarial_batch(rng, "inf_rows", CAP, T, R, WR, W)
    assert (a[7] == inf).all(axis=1).any() and (a[2] == inf).all(axis=1).any()
    _hk, _hv, a = tg.adversarial_batch(rng, "no_valid_writes", CAP, T, R, WR,
                                       W)
    assert not a[9].any() and a[5].any()
    hk, hv, a = tg.adversarial_batch(rng, "chain", CAP, T, R, WR, W)
    out = port.resolve_step_plain(
        torch.from_numpy(hk), torch.from_numpy(hv),
        *[torch.from_numpy(x) for x in a], tg.COMMIT, tg.OLDEST)
    conflict = out[3].numpy()
    links = min(T, R, WR)
    assert not conflict[0] and conflict[1] and not conflict[2]
    assert int(conflict[:links].sum()) >= links // 2 - 1


@pytest.mark.parametrize("kind", tg.KINDS)
@pytest.mark.parametrize("attribute", [True, False])
def test_plain_packed_step_matches_reference_on_edges(kind, attribute):
    jfn = ref.make_resolve_packed_fn(CAP, T, R, WR, W, attribute=attribute,
                                     donate=False)
    for hk, hv, arrays in _batches(kind):
        buf = ref.pack_interval_batch(*arrays, tg.COMMIT, tg.OLDEST)
        want = _np(jfn(hk, hv, buf))
        got = _np(port.resolve_step_packed(
            torch.from_numpy(hk), torch.from_numpy(hv), torch.from_numpy(buf),
            T, R, WR, attribute=attribute))
        assert (got[4] is None) == (not attribute)
        for name, g, w in zip(("HK", "HV", "count", "conflict", "read_hit"),
                              got, want):
            np.testing.assert_array_equal(g, w, err_msg=f"{kind} {name}")


@pytest.mark.parametrize("kind", tg.KINDS)
@pytest.mark.parametrize("attribute", [True, False])
def test_plain_unpacked_step_matches_reference_on_edges(kind, attribute):
    jfn = ref.make_resolve_fn(CAP, T, R, WR, W, attribute=attribute,
                              donate=False)
    for hk, hv, arrays in _batches(kind):
        want = _np(jfn(hk, hv, *arrays, jnp.int32(tg.COMMIT),
                       jnp.int32(tg.OLDEST)))
        got = _np(port.resolve_step(
            torch.from_numpy(hk), torch.from_numpy(hv),
            *[torch.from_numpy(a) for a in arrays], tg.COMMIT, tg.OLDEST,
            attribute=attribute))
        for name, g, w in zip(("HK", "HV", "count", "conflict", "read_hit"),
                              got, want):
            np.testing.assert_array_equal(g, w, err_msg=f"{kind} {name}")


# the cells' key width (4 words), and widths past the external check's
# ROW_CW = 8 loaded words a probed row: at 8 words the length word lies
# past them, at 12 the key ids too
CLIP_WIDTHS = (4, 8, 12)


@pytest.mark.parametrize("n_words", CLIP_WIDTHS)
@pytest.mark.parametrize("kind", ["split_edges", "clip_edges"])
def test_plain_packed_step_matches_reference_at_clip_edges(n_words, kind):
    """Searches that tie past the loaded words: the shard-bound kinds
    (rows that tie a bound up to the length word) at three key widths,
    attributed, the plain interval step against the reference's."""
    jfn = ref.make_resolve_packed_fn(CAP, T, R, WR, n_words, attribute=True,
                                     donate=False)
    hk, hv, arrays = tg.adversarial_batch(np.random.default_rng(n_words),
                                          kind, CAP, T, R, WR, n_words)
    buf = ref.pack_interval_batch(*arrays, tg.COMMIT, tg.OLDEST)
    want = _np(jfn(hk, hv, buf))
    got = _np(port.resolve_step_packed(
        torch.from_numpy(hk), torch.from_numpy(hv), torch.from_numpy(buf),
        T, R, WR, attribute=True))
    for name, g, w in zip(("HK", "HV", "count", "conflict", "read_hit"),
                          got, want):
        np.testing.assert_array_equal(g, w, err_msg=f"{kind} {name}")
    assert want[3].any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", tg.KINDS)
@pytest.mark.parametrize("attribute", [True, False])
def test_resolve_kernel_matches_plain_on_edges(cuda, kind, attribute):
    # the small bucket, and one whose endpoints span several sort tiles
    for cap, t, r, wr, w in ((CAP, T, R, WR, W), (4096, 512, 1024, 1024, 4)):
        for seed in SEEDS:
            _kernel_against_plain(cuda, tg.adversarial_batch(
                np.random.default_rng(seed), kind, cap, t, r, wr, w),
                t, r, wr, attribute, kind)


def _kernel_against_plain(cuda, batch, t, r, wr, attribute, kind):
    """K3, packed and unpacked, against its plain version on one
    `adversarial_batch`."""
    hk, hv, arrays = batch
    buf = torch.from_numpy(port.pack_interval_batch(
        *arrays, tg.COMMIT, tg.OLDEST))
    want = port.resolve_step_packed(
        torch.from_numpy(hk), torch.from_numpy(hv), buf, t, r, wr,
        attribute=attribute)
    before = port.launches["resolve"]
    got = port.resolve_step_packed(
        torch.from_numpy(hk).to(cuda), torch.from_numpy(hv).to(cuda),
        buf.to(cuda), t, r, wr, attribute=attribute)
    got_u = port.resolve_step(
        torch.from_numpy(hk).to(cuda), torch.from_numpy(hv).to(cuda),
        *[torch.from_numpy(a).to(cuda) for a in arrays], tg.COMMIT,
        tg.OLDEST, attribute=attribute)
    assert port.launches["resolve"] == before + 2
    for g, gu, wnt in zip(got, got_u, want):
        assert (g is None) == (wnt is None) == (gu is None)
        if wnt is not None:
            assert torch.equal(g.cpu(), wnt), kind
            assert torch.equal(gu.cpu(), wnt), kind


@pytest.mark.cuda
@pytest.mark.parametrize("n_words", [40, 100])
def test_resolve_kernel_matches_plain_at_wide_keys(cuda, n_words):
    for kind in ("mixed", "split_edges"):
        hk, hv, arrays = tg.adversarial_batch(
            np.random.default_rng(n_words), kind, CAP, T, R, WR, n_words)
        buf = torch.from_numpy(port.pack_interval_batch(
            *arrays, tg.COMMIT, tg.OLDEST))
        want = port.resolve_step_packed(
            torch.from_numpy(hk), torch.from_numpy(hv), buf, T, R, WR)
        got = port.resolve_step_packed(
            torch.from_numpy(hk).to(cuda), torch.from_numpy(hv).to(cuda),
            buf.to(cuda), T, R, WR)
        for g, wnt in zip(got, want):
            assert torch.equal(g.cpu(), wnt), kind


@pytest.mark.cuda
@pytest.mark.parametrize("n_words", CLIP_WIDTHS)
@pytest.mark.parametrize("kind", ["split_edges", "clip_edges"])
def test_resolve_kernel_matches_plain_at_clip_edges(cuda, n_words, kind):
    """K3's bounds search (the kernel K8 runs with the clip fused in) on
    the shard-bound kinds at three key widths, packed and unpacked,
    attributed and not, in the small bucket and at a 2^14-row history."""
    for cap in (CAP, 1 << 14):
        batch = tg.adversarial_batch(np.random.default_rng(n_words), kind,
                                     cap, T, R, WR, n_words)
        for attribute in (True, False):
            _kernel_against_plain(cuda, batch, T, R, WR, attribute, kind)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 1 << 16])
@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_kernel_on_unsorted_and_edge_tables(cuda, n, side):
    rng = np.random.default_rng(n)
    tables = [np.sort(rng.integers(-50, 50, n)),      # sorted
              rng.integers(-50, 50, n)]               # unsorted: same probes
    q = torch.from_numpy(np.concatenate([
        rng.integers(-60, 60, 5000), [2**31 - 1, -2**31]]).astype(np.int32))
    for table in tables:
        table = torch.from_numpy(table.astype(np.int32))
        before = keys.launches["searchsorted_i32"]
        got = keys.searchsorted_i32(table.to(cuda), q.to(cuda), side)
        assert keys.launches["searchsorted_i32"] == before + 1
        assert torch.equal(got.cpu(),
                           keys.searchsorted_i32_plain(table, q, side))
