"""Port parity for ops/rmq.py: the plain range max (K2's plain version)
matches the reference's build_range_max_table/range_max on empty,
same-block and cross-block ranges, exactly."""

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
