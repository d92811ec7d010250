"""Port parity for ops/rmq.py: the plain range max (K2's plain version)
matches the reference's build_range_max_table/range_max on empty,
same-block and cross-block ranges, exactly, one array or S at once; the
kernel (CUDA-marked) matches the plain version at edge ranges and at
the cells' shapes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from foundationdb_tpu.ops import rmq as ref  # noqa: E402
from foundationdb_tpu_torch.ops import rmq as port  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _queries(rng, n, q):
    """Empty (hi <= lo), same-block, cross-block and whole-array ranges."""
    lo = rng.integers(0, n, q)
    kind = rng.integers(0, 4, q)
    span = np.where(kind == 0, -rng.integers(0, 3, q),        # empty
                    np.where(kind == 1, rng.integers(1, 8, q),  # same-ish
                             rng.integers(1, n + 1, q)))        # cross
    hi = np.clip(lo + span, 0, n)
    lo = np.concatenate([lo, [0, 0, n - 1, 127 if n > 128 else 0]])
    hi = np.concatenate([hi, [n, 0, n, 129 if n > 128 else 1]])
    return lo.astype(np.int32), hi.astype(np.int32)


@pytest.mark.parametrize("n", [128, 256, 1024, 8192])
def test_range_max_plain_matches_reference(n):
    rng = np.random.default_rng(n)
    vals = rng.integers(port.VDEAD, 1 << 20, n).astype(np.int32)
    vals[rng.random(n) < 0.3] = port.VDEAD
    lo, hi = _queries(rng, n, 2000)
    want = np.asarray(ref.range_max(ref.build_range_max_table(
        jnp.asarray(vals)), jnp.asarray(lo), jnp.asarray(hi)))
    got = port.range_max(torch.from_numpy(vals), torch.from_numpy(lo),
                         torch.from_numpy(hi))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # and the definition itself
    naive = [max([port.VDEAD] + list(vals[a:b])) for a, b in zip(lo, hi)]
    np.testing.assert_array_equal(got.numpy(), naive)


def _out_of_range_queries(rng, n, q):
    """Ranges that start below 0, end past n, or lie wholly past n."""
    lo = rng.integers(-5, n + 5, q)
    hi = lo + rng.integers(1, 300, q)
    return lo.astype(np.int32), hi.astype(np.int32)


@pytest.mark.parametrize("n", [128, 1024])
def test_range_max_plain_clamps_out_of_range(n):
    """A non-empty range's first and last index clamp into [0, n-1]: a
    range that overhangs either end gives the max of its part inside the
    array, and one wholly outside reads the nearest end value."""
    rng = np.random.default_rng(n + 1)
    vals = rng.integers(port.VDEAD, 1 << 20, n).astype(np.int32)
    lo, hi = _out_of_range_queries(rng, n, 2000)
    got = port.range_max(torch.from_numpy(vals), torch.from_numpy(lo),
                         torch.from_numpy(hi))
    want = [max(vals[np.clip(a, 0, n - 1):np.clip(b - 1, 0, n - 1) + 1])
            for a, b in zip(lo, hi)]
    np.testing.assert_array_equal(got.numpy(), want)


def test_constants_match_reference():
    assert port.VDEAD == ref.VDEAD
    assert port.BLOCK == ref.BLOCK


@pytest.mark.cuda
def test_range_max_kernel_matches_plain(cuda):
    rng = np.random.default_rng(3)
    for n in (128, 8192, 1 << 20):
        vals = torch.from_numpy(rng.integers(port.VDEAD, 1 << 20, n)
                                .astype(np.int32))
        lo, hi = (torch.from_numpy(x) for x in _queries(rng, n, 5000))
        before = port.launches["range_max"]
        got = port.range_max(vals.to(cuda), lo.to(cuda), hi.to(cuda))
        assert port.launches["range_max"] == before + 1
        assert torch.equal(got.cpu(), port.range_max_plain(vals, lo, hi))
        # ranges overhanging either end, or wholly past it
        lo, hi = (torch.from_numpy(x)
                  for x in _out_of_range_queries(rng, n, 5000))
        got = port.range_max(vals.to(cuda), lo.to(cuda), hi.to(cuda))
        assert torch.equal(got.cpu(), port.range_max_plain(vals, lo, hi))


def _edge_queries(rng, n, q):
    """Random ranges, then every edge: empty, inverted, one value, the
    first and last value, across a block edge, over more than 128
    blocks where n allows, the whole array, all inside [0, n]."""
    lo, hi = _queries(rng, n, q)
    edges = [(5, 5), (0, 0), (n, n), (9, 3), (n, 0), (n - 1, 0),
             (0, 1), (n - 1, n), (7, 8), (127, 129), (120, 136), (0, n)]
    if n > 129 * port.BLOCK:
        edges += [(3, 129 * port.BLOCK + 5), (100, n - 77), (64, n)]
    lo = np.concatenate([lo, [a for a, _ in edges]]) % (n + 1)
    hi = np.concatenate([hi, [b for _, b in edges]]) % (n + 1)
    return lo.astype(np.int32), hi.astype(np.int32)


def _sharded_case(seed, n_arrays, n, q):
    rng = np.random.default_rng(seed)
    vals = rng.integers(port.VDEAD, 1 << 20, (n_arrays, n)).astype(np.int32)
    vals[rng.random((n_arrays, n)) < 0.3] = port.VDEAD
    lo, hi = zip(*[_edge_queries(rng, n, q) for _ in range(n_arrays)])
    return vals, np.stack(lo), np.stack(hi)


@pytest.mark.parametrize("n", [128, 256, 8192, 32768])
@pytest.mark.parametrize("n_arrays", [1, 4])
def test_range_max_plain_over_arrays_matches_reference(n_arrays, n):
    """The S-array plain entry ([S, n] values, [S, q] ranges) against the
    reference's table and query, array by array, on every edge range;
    then ranges that overhang either end against the definition."""
    vals, lo, hi = _sharded_case(n + n_arrays, n_arrays, n, 600)
    got = port.range_max(torch.from_numpy(vals), torch.from_numpy(lo),
                         torch.from_numpy(hi))
    assert got.dtype == torch.int32 and got.shape == lo.shape
    for k in range(n_arrays):
        want = np.asarray(ref.range_max(ref.build_range_max_table(
            jnp.asarray(vals[k])), jnp.asarray(lo[k]), jnp.asarray(hi[k])))
        np.testing.assert_array_equal(got[k].numpy(), want)
    rng = np.random.default_rng(n)
    lo, hi = zip(*[_out_of_range_queries(rng, n, 300)
                   for _ in range(n_arrays)])
    lo, hi = np.stack(lo), np.stack(hi)
    got = port.range_max(torch.from_numpy(vals), torch.from_numpy(lo),
                         torch.from_numpy(hi))
    for k in range(n_arrays):
        want = [max(vals[k][np.clip(a, 0, n - 1):np.clip(b - 1, 0, n - 1)
                            + 1]) for a, b in zip(lo[k], hi[k])]
        np.testing.assert_array_equal(got[k].numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_arrays,n", [(1, 128), (4, 256), (1, 1 << 20),
                                        (4, 1 << 18)])
def test_range_max_kernel_over_arrays_matches_plain(cuda, n_arrays, n):
    """One launch for all S arrays: edge ranges, then the cells' point
    reads (one or two values each, 16,384 an array) mixed with long
    ranges, and ranges overhanging either end."""
    vals, lo, hi = _sharded_case(n_arrays, n_arrays, n, 5000)
    rng = np.random.default_rng(n)
    point_lo = rng.integers(0, n - 2, (n_arrays, 16384))
    point_hi = point_lo + rng.integers(1, 3, (n_arrays, 16384))
    long_at = rng.random((n_arrays, 16384)) < 0.01
    point_hi[long_at] = rng.integers(0, n + 1, int(long_at.sum()))
    oob_lo, oob_hi = zip(*[_out_of_range_queries(rng, n, 3000)
                           for _ in range(n_arrays)])
    vals_t = torch.from_numpy(vals)
    for lo_np, hi_np in ((lo, hi), (point_lo, point_hi),
                         (np.stack(oob_lo), np.stack(oob_hi))):
        lo_t = torch.from_numpy(lo_np.astype(np.int32))
        hi_t = torch.from_numpy(hi_np.astype(np.int32))
        before = port.launches["range_max"]
        got = port.range_max(vals_t.to(cuda), lo_t.to(cuda), hi_t.to(cuda))
        assert port.launches["range_max"] == before + 1
        assert torch.equal(got.cpu(), port.range_max_plain(vals_t, lo_t,
                                                           hi_t))
