"""Port parity for ops/keys.py: the numpy key encoders are byte-identical
to the reference's, the int32 binary search (K1) matches the
reference's searchsorted_i32 exactly, on both sides, including queries
above every element, and the row search (K6) matches the reference's
searchsorted_rows and _mixed on tables with long runs of equal rows,
with and without a +inf pad row, at caps 1 to 2^19 and widths 1 to
127. Every value is an integer: equality is exact."""

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


def _id_rows(ids, width):
    """[n, width] rows ordered as their ids: the id in base 2^16 over
    the words before the length word (leading words mostly zero, as
    real keys share prefixes), the length word 8; width 1 is the id."""
    ids = np.asarray(ids, np.int64)
    rows = np.zeros((len(ids), width), np.uint32)
    if width == 1:
        rows[:, 0] = ids
        return rows
    for j in range(width - 1):
        shift = 16 * (width - 2 - j)
        rows[:, j] = (ids >> shift) & 0xFFFF if shift < 64 else 0
    rows[:, -1] = 8
    return rows


def _edge_table(rng, cap, width, pad):
    """A sorted [cap, width] table of even ids >= 2 in runs of ~37 equal
    rows; with `pad`, its last quarter (at least one row) +inf."""
    ids = 2 * np.sort(rng.integers(0, max(1, cap // 37), cap)) + 2
    table = _id_rows(ids, width)
    if pad:
        table[cap - max(1, cap // 4):] = 0xFFFFFFFF
    return table


def _edge_row_queries(rng, table, width, n):
    """Rows of the table, ids between and beyond them, below every row
    and above every row (the +inf row among them)."""
    top = int(rng.integers(1, 1 << 20))
    return np.concatenate([
        table[rng.integers(0, table.shape[0], n)],
        _id_rows(rng.integers(0, 2 * top + 8, n), width),
        _id_rows([0, 1], width),
        _id_rows([1 << 40], width),
        np.full((1, width), 0xFFFFFFFF, np.uint32)])


@pytest.mark.parametrize("width", [1, 5, 9])
@pytest.mark.parametrize("cap", [1, 2, 2048, 4096])
def test_row_search_plain_matches_reference_on_edge_tables(cap, width):
    """K6's plain version against the reference at caps 1, 2, 2^11 and
    2^12, on tables with long runs of equal rows, with and without a pad
    row, on both sides and a mixed mask."""
    rng = np.random.default_rng(cap * 10 + width)
    for pad in (True, False):
        table = _edge_table(rng, cap, width, pad)
        q = _edge_row_queries(rng, table, width, 150)
        t_t, q_t = torch.from_numpy(table), torch.from_numpy(q)
        for side in ("left", "right"):
            want = np.asarray(ref.searchsorted_rows(
                jnp.asarray(table), jnp.asarray(q), side=side))
            np.testing.assert_array_equal(
                port.searchsorted_rows(t_t, q_t, side).numpy(), want)
        mask = rng.random(q.shape[0]) < 0.5
        want = np.asarray(ref.searchsorted_rows_mixed(
            jnp.asarray(table), jnp.asarray(q), jnp.asarray(mask)))
        np.testing.assert_array_equal(port.searchsorted_rows_mixed(
            t_t, q_t, torch.from_numpy(mask)).numpy(), want)
        if not pad:   # above every row: cap-1, not cap
            assert int(port.searchsorted_rows(t_t, q_t[-1:], "right")[0]) \
                == cap - 1


@pytest.mark.cuda
@pytest.mark.parametrize("width,caps", [
    (1, (1, 2, 2048, 4096, 1 << 19)),
    (5, (1, 2, 2048, 4096, 1 << 19)),
    (9, (2, 1024, 2048, 1 << 15)),
    (127, (1, 2, 64, 128, 4096))])
def test_row_search_kernel_matches_plain_on_edge_tables(cuda, width, caps):
    """The kernel against its plain version at caps from 1 to the point
    cell's 2^19 (2^11 and 2^12 at widths 1 and 5; at width 9 a row
    spans the kernel's 8-word load; 127 is the widest key the steps
    take), on tables with long runs of equal rows, with and without a
    pad row, on both sides and a mixed mask, queries equal to rows,
    between them, below and above every row."""
    rng = np.random.default_rng(width)
    for cap in caps:
        for pad in (True, False):
            table = torch.from_numpy(_edge_table(rng, cap, width, pad))
            q = torch.from_numpy(_edge_row_queries(rng, table.numpy(),
                                                   width, 3000))
            mask = torch.from_numpy(rng.random(q.shape[0]) < 0.5)
            for side in ("left", "right"):
                before = port.launches["searchsorted_rows"]
                got = port.searchsorted_rows(table.to(cuda), q.to(cuda),
                                             side)
                assert port.launches["searchsorted_rows"] == before + 1
                assert torch.equal(got.cpu(), port.searchsorted_rows_plain(
                    table, q, side)), (cap, pad, side)
            got = port.searchsorted_rows_mixed(table.to(cuda), q.to(cuda),
                                               mask.to(cuda))
            assert torch.equal(got.cpu(), port.searchsorted_rows_mixed_plain(
                table, q, mask)), (cap, pad)
