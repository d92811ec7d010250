"""Fixed-width key encoding (numpy), the int32 binary search (K1), the
multiword row search (K6), and the row compare with the shard clip
built on it (K7).

A key is W big-endian uint32 words (zero-padded) plus one trailing
length word; lexicographic comparison of those (W+1)-word rows equals
lexicographic comparison of the byte strings (the shorter of two
prefix-equal keys sorts first through its length word). The all-ones
row is +infinity, strictly above every real key. The encoders are the
reference's numpy code, so both packages produce byte-identical rows.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import device as _device
from . import _build

INF_WORD = np.uint32(0xFFFFFFFF)


def next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


_ENC_SHIFTS = np.array([1 << 24, 1 << 16, 1 << 8, 1], np.uint32)


def encode_keys_into(keys: Sequence[bytes], key_bytes: int,
                     out: np.ndarray, scratch: np.ndarray = None) -> None:
    """encode_keys writing straight into a preallocated [>=n, W+1]
    uint32 view (typically a slice of a packed feed staging buffer);
    `scratch` is an optional reusable [>=n, key_bytes] uint8 matrix."""
    n = len(keys)
    n_words = key_bytes // 4
    if scratch is None:
        scratch = np.zeros((max(n, 1), key_bytes), dtype=np.uint8)
    else:
        scratch = scratch[:n]
        scratch[:] = 0
    for i, k in enumerate(keys):
        kl = len(k)
        if kl > key_bytes:
            raise ValueError(
                f"key length {kl} exceeds backend key width {key_bytes}")
        if kl:
            scratch[i, :kl] = np.frombuffer(k, np.uint8)
        out[i, n_words] = kl
    out[:n, :n_words] = (
        scratch[:n].reshape(n, n_words, 4).astype(np.uint32) * _ENC_SHIFTS
    ).sum(axis=2, dtype=np.uint32)


def encode_keys(keys: Sequence[bytes], key_bytes: int) -> np.ndarray:
    """Encode byte-string keys into [n, W+1] uint32 rows (host side)."""
    n = len(keys)
    n_words = key_bytes // 4
    out = np.zeros((max(n, 1), n_words + 1), dtype=np.uint32)
    encode_keys_into(keys, key_bytes, out)
    return out[:n]


def decode_keys(rows: np.ndarray) -> list:
    """Inverse of encode_keys for real rows ([n, W+1] uint32 -> bytes);
    rows must not be +inf sentinels."""
    rows = np.asarray(rows, np.uint32)
    n, width = rows.shape
    n_words = width - 1
    buf = np.empty((n, n_words, 4), np.uint8)
    words = rows[:, :n_words]
    for i, shift in enumerate((24, 16, 8, 0)):
        buf[:, :, i] = (words >> np.uint32(shift)).astype(np.uint8)
    flat = buf.reshape(n, n_words * 4)
    out = []
    for i in range(n):
        kl = int(rows[i, n_words])
        if kl > n_words * 4:
            raise ValueError(f"row {i} is not a real key (length {kl})")
        out.append(flat[i, :kl].tobytes())
    return out


# ---------------------------------------------------------------------------
# K1: searchsorted_i32 (csrc/searchsorted.cu)
# ---------------------------------------------------------------------------

launches = {"searchsorted_i32": 0, "searchsorted_rows": 0, "shard_clip": 0}


def searchsorted_i32_plain(table: torch.Tensor, queries: torch.Tensor,
                           side: str = "left") -> torch.Tensor:
    """Plain version: the reference's branchless loop, gather by gather.
    `table` is int32, sorted, of power-of-two length; returns per query
    the count of elements < query ("left") or <= query ("right")."""
    cap = table.shape[0]
    assert cap & (cap - 1) == 0, "table length must be a power of two"
    logn = cap.bit_length() - 1
    table = table.to(torch.int64)
    queries = queries.to(torch.int64)
    pos = torch.zeros(queries.shape, dtype=torch.int64, device=table.device)

    def take(probe, q):
        return probe < q if side == "left" else probe <= q

    for i in range(logn):
        step = cap >> (i + 1)
        probe = table[pos + step - 1]
        pos = pos + step * take(probe, queries).to(torch.int64)
    pos = pos + take(table[pos], queries).to(torch.int64)
    return pos.to(torch.int32)


def searchsorted_i32(table: torch.Tensor, queries: torch.Tensor,
                     side: str = "left") -> torch.Tensor:
    """K1 on a CUDA tensor, the plain version on a CPU tensor. The card's
    path is kept short on the host: device indices compare as ints, the
    output is `empty_like` the queries, the stream is read raw."""
    if side != "left" and side != "right":
        raise ValueError(f"side must be 'left' or 'right', not {side!r}")
    if not _device.is_cuda(table):
        return searchsorted_i32_plain(table, queries, side)
    n = table.shape[0]
    if table.dtype != torch.int32 or table.dim() != 1 or n & (n - 1) or not n:
        raise ValueError("table must be a 1-D int32 power-of-two array")
    index = table.get_device()
    if queries.get_device() != index or queries.dtype != torch.int32:
        raise ValueError("queries must be int32 on the table's device")
    table = table.contiguous()
    q = queries.contiguous()
    out = torch.empty_like(q)
    _build.check(_build.lib().fdb_searchsorted_i32(
        table.data_ptr(), n, q.data_ptr(), q.numel(), int(side == "right"),
        out.data_ptr(), _device.stream_handle(index)), "searchsorted_i32")
    launches["searchsorted_i32"] += 1
    return out


# ---------------------------------------------------------------------------
# K7: row order and the shard clip (csrc/shard_clip.cu). The sharded
# step runs the clip fused into its bounds search (csrc/resolve.cu) and
# counts that launch under "shard_clip"; these are the standalone entries.
# ---------------------------------------------------------------------------

def lt_rows_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a < b over the trailing word axis ([..., W+1]),
    folded from the least significant word up as the reference does.
    uint32 words widen to int64 (PyTorch's uint32 has no ordered
    compares)."""
    a, b = a.to(torch.int64), b.to(torch.int64)
    r = torch.zeros(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]),
                    dtype=torch.bool, device=a.device)
    for w in range(a.shape[-1] - 1, -1, -1):
        aw, bw = a[..., w], b[..., w]
        r = (aw < bw) | ((aw == bw) & r)
    return r


def lt_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K7's row compare on CUDA tensors, the plain fold on CPU tensors.
    The leading axes broadcast; on the card an operand that is one row
    is read in place for every row of the other."""
    if not _device.is_cuda(a):
        return lt_rows_plain(a, b)
    from ._build import check, lib
    if b.device != a.device or a.dtype != torch.uint32 \
            or b.dtype != torch.uint32 or a.dim() < 1 or b.dim() < 1 \
            or a.shape[-1] != b.shape[-1] or not a.shape[-1]:
        raise ValueError("lt_rows takes two uint32 row tensors of one "
                         "width on one device")
    width = a.shape[-1]
    lead = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])

    def operand(x):
        if x.shape[:-1].numel() == 1:
            return x.reshape(width).contiguous(), 0
        return x.expand(*lead, width).contiguous(), 1

    (a, a_step), (b, b_step) = operand(a), operand(b)
    out = torch.empty(lead, dtype=torch.bool, device=a.device)
    if out.numel():
        check(lib().fdb_lt_rows(a.data_ptr(), a_step, b.data_ptr(), b_step,
                                out.numel(), width, out.data_ptr(),
                                _device.stream_handle(a.device)), "lt_rows")
        launches["shard_clip"] += 1
    return out


def le_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ~lt_rows(b, a)


def clip_to_shards_plain(b_rows, e_rows, valid, lows, highs):
    """Plain version of the shard clip: every range [b, e) against every
    shard's [lo, hi), as rows_max / rows_min / valid & lt_rows(b', e')
    of the reference's sharded step. Returns [S, N, W+1] clipped begins
    and ends and [S, N] bool validity."""
    i64 = torch.int64
    lo, hi = lows.to(i64)[:, None, :], highs.to(i64)[:, None, :]
    b, e = b_rows.to(i64)[None], e_rows.to(i64)[None]
    cb = torch.where(lt_rows_plain(b, lo)[..., None], lo, b)
    ce = torch.where(lt_rows_plain(hi, e)[..., None], hi, e)
    cv = (valid != 0)[None] & lt_rows_plain(cb, ce)
    return cb.to(torch.uint32), ce.to(torch.uint32), cv


def clip_to_shards(b_rows: torch.Tensor, e_rows: torch.Tensor,
                   valid: torch.Tensor, lows: torch.Tensor,
                   highs: torch.Tensor):
    """K7's clip on CUDA tensors, the plain version on CPU tensors.
    `b_rows`/`e_rows` [N, W+1] uint32, `valid` [N] (1- or 4-byte flags,
    nonzero = true), `lows`/`highs` [S, W+1] uint32 shard bounds."""
    if not _device.is_cuda(b_rows):
        return clip_to_shards_plain(b_rows, e_rows, valid, lows, highs)
    from ._build import check, lib
    dev = b_rows.device
    n, width = b_rows.shape
    n_shards = lows.shape[0]
    for t, shape in ((b_rows, (n, width)), (e_rows, (n, width)),
                     (lows, (n_shards, width)), (highs, (n_shards, width))):
        if t.dtype != torch.uint32 or tuple(t.shape) != shape \
                or t.device != dev:
            raise ValueError("clip_to_shards takes [N, W+1] range rows and "
                             "[S, W+1] bounds, uint32 on one device")
    if valid.shape != (n,) or valid.element_size() not in (1, 4) \
            or valid.device != dev:
        raise ValueError("valid must be [N] 1- or 4-byte flags beside the "
                         "rows")
    b_rows, e_rows, valid, lows, highs = (
        t.contiguous() for t in (b_rows, e_rows, valid, lows, highs))
    cb = torch.empty((n_shards, n, width), dtype=torch.uint32, device=dev)
    ce = torch.empty_like(cb)
    cv = torch.empty((n_shards, n), dtype=torch.bool, device=dev)
    check(lib().fdb_clip_to_shards(
        b_rows.data_ptr(), e_rows.data_ptr(), valid.data_ptr(),
        valid.element_size(), lows.data_ptr(), highs.data_ptr(), n_shards,
        n, width, cb.data_ptr(), ce.data_ptr(), cv.data_ptr(),
        _device.stream_handle(dev)), "clip_to_shards")
    launches["shard_clip"] += 1
    return cb, ce, cv


# ---------------------------------------------------------------------------
# K6: searchsorted_rows (csrc/searchsorted_rows.cu)
# ---------------------------------------------------------------------------

def _rows_search_plain(table, queries, right):
    """The reference's loop: log2(cap) probes from 0, no correction
    step; `right` is a bool per query (probe <= q) or a Python bool."""
    cap = table.shape[0]
    assert cap & (cap - 1) == 0, "table length must be a power of two"
    logn = cap.bit_length() - 1
    table = table.to(torch.int64)
    queries = queries.to(torch.int64)
    pos = torch.zeros(queries.shape[0], dtype=torch.int64,
                      device=table.device)
    for i in range(logn):
        step = cap >> (i + 1)
        probe = table[pos + step - 1]
        lt = lt_rows_plain(probe, queries)
        le = ~lt_rows_plain(queries, probe)
        go = torch.where(right, le, lt) if isinstance(right, torch.Tensor) \
            else (le if right else lt)
        pos = pos + step * go.to(torch.int64)
    return pos.to(torch.int32)


def searchsorted_rows_plain(table: torch.Tensor, queries: torch.Tensor,
                            side: str = "left") -> torch.Tensor:
    """Plain version of B3: `table` is [cap, W+1] sorted rows, cap a
    power of two, with at least one +inf pad row for exact counts;
    returns per query the count of rows < query ("left") or <= query
    ("right"), which caps at cap-1 without a pad row."""
    return _rows_search_plain(table, queries, side == "right")


def searchsorted_rows_mixed_plain(table: torch.Tensor, queries: torch.Tensor,
                                  right_mask: torch.Tensor) -> torch.Tensor:
    """searchsorted_rows_plain with a per-query side: right where
    `right_mask`, left elsewhere."""
    return _rows_search_plain(table, queries, right_mask.to(torch.bool))


def _rows_search(table, queries, mask, right: bool):
    from ._build import check, lib
    cap = table.shape[0]
    if table.dtype != torch.uint32 or table.dim() != 2 or not cap \
            or cap & (cap - 1):
        raise ValueError("table must be a [cap, W+1] uint32 tensor, cap a "
                         "power of two")
    if queries.device != table.device or queries.dtype != torch.uint32 \
            or queries.dim() != 2 or queries.shape[1] != table.shape[1]:
        raise ValueError("queries must be [Q, W+1] uint32 rows on the "
                         "table's device")
    if mask is not None and (mask.device != table.device
                             or mask.shape != queries.shape[:1]
                             or mask.element_size() != 1):
        raise ValueError("right_mask must be one byte per query on the "
                         "table's device")
    table = table.contiguous()
    q = queries.contiguous()
    if mask is not None:
        mask = mask.contiguous()
    out = torch.empty(q.shape[0], dtype=torch.int32, device=table.device)
    check(lib().fdb_searchsorted_rows(
        table.data_ptr(), cap, table.shape[1], q.data_ptr(), q.shape[0],
        None if mask is None else mask.data_ptr(), int(right),
        out.data_ptr(), _device.stream_handle(table.device)),
        "searchsorted_rows")
    launches["searchsorted_rows"] += 1
    return out


def searchsorted_rows(table: torch.Tensor, queries: torch.Tensor,
                      side: str = "left") -> torch.Tensor:
    """K6 on a CUDA tensor, the plain version on a CPU tensor."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', not {side!r}")
    if not _device.is_cuda(table):
        return searchsorted_rows_plain(table, queries, side)
    return _rows_search(table, queries, None, side == "right")


def searchsorted_rows_mixed(table: torch.Tensor, queries: torch.Tensor,
                            right_mask: torch.Tensor) -> torch.Tensor:
    """K6 with a per-query side on a CUDA tensor, the plain version on a
    CPU tensor."""
    if not _device.is_cuda(table):
        return searchsorted_rows_mixed_plain(table, queries, right_mask)
    return _rows_search(table, queries, right_mask, False)
