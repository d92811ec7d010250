"""Port parity for ops/keys.py: the numpy key encoders are byte-identical
to the reference's, and the int32 binary search (K1) matches the
reference's searchsorted_i32 exactly, on both sides, including queries
above every element. Every value is an integer: equality is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from foundationdb_tpu.ops import keys as ref  # noqa: E402
from foundationdb_tpu_torch.ops import keys as port  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand_keys(rng, n, key_bytes):
    out = [b"", b"\x00", b"\xff" * key_bytes, b"a", b"a\x00", b"ab"]
    for _ in range(n):
        out.append(bytes(rng.integers(0, 256, rng.integers(0, key_bytes + 1),
                                      dtype=np.uint8)))
    return out


@pytest.mark.parametrize("key_bytes", [4, 16, 32])
def test_encode_decode_byte_identical(key_bytes):
    rng = np.random.default_rng(key_bytes)
    keys = _rand_keys(rng, 200, key_bytes)
    a = port.encode_keys(keys, key_bytes)
    b = ref.encode_keys(keys, key_bytes)
    assert a.dtype == b.dtype == np.uint32
    assert a.tobytes() == b.tobytes()
    assert port.decode_keys(a) == ref.decode_keys(b) == keys
    # the in-place encoder over a reused scratch matrix, as the resolver
    # marshals into its staging buffer
    out_a = np.full((len(keys) + 3, key_bytes // 4 + 1), 7, np.uint32)
    out_b = out_a.copy()
    scratch = np.empty((len(keys) + 8, key_bytes), np.uint8)
    port.encode_keys_into(keys, key_bytes, out_a, scratch)
    ref.encode_keys_into(keys, key_bytes, out_b)
    assert out_a.tobytes() == out_b.tobytes()


def test_encode_rejects_wide_key_and_next_pow2():
    with pytest.raises(ValueError):
        port.encode_keys([b"x" * 17], 16)
    for n in (0, 1, 2, 3, 5, 16, 17, 1000, 1 << 20):
        assert port.next_pow2(n) == ref.next_pow2(n)


@pytest.mark.parametrize("n", [1, 2, 16, 256, 4096])
@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_plain_matches_reference(n, side):
    rng = np.random.default_rng(n)
    table = np.sort(rng.integers(-20, 20, n)).astype(np.int32)
    # duplicates, queries below/above every element, and exact hits
    queries = np.concatenate([
        rng.integers(-30, 30, 500), table[:8], [table.max() + 1,
                                                np.iinfo(np.int32).max,
                                                table.min() - 1]]
    ).astype(np.int32)
    want = np.asarray(ref.searchsorted_i32(jnp.asarray(table),
                                           jnp.asarray(queries), side))
    got = port.searchsorted_i32(torch.from_numpy(table),
                                torch.from_numpy(queries), side)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, np.searchsorted(table, queries, side=side))


def test_searchsorted_segment_starts_layout():
    """The resolve step's use: a non-decreasing txn-id table padded
    with T, searched at arange(T+2)."""
    T, R = 16, 32
    rt = np.full(R, T, np.int32)
    rt[:20] = np.sort(np.random.default_rng(5).integers(0, T, 20))
    q = np.arange(T + 2, dtype=np.int32)
    want = np.asarray(ref.searchsorted_i32(jnp.asarray(rt), jnp.asarray(q)))
    got = port.searchsorted_i32(torch.from_numpy(rt), torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_kernel_matches_plain(cuda, side):
    rng = np.random.default_rng(11)
    for n in (1, 2, 1024, 16384):
        table = torch.from_numpy(np.sort(rng.integers(-50, 50, n))
                                 .astype(np.int32))
        q = torch.from_numpy(rng.integers(-60, 60, 5000).astype(np.int32))
        before = port.launches["searchsorted_i32"]
        got = port.searchsorted_i32(table.to(cuda), q.to(cuda), side)
        assert port.launches["searchsorted_i32"] == before + 1
        assert torch.equal(got.cpu(),
                           port.searchsorted_i32_plain(table, q, side))
