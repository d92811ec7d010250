"""Fixed-width key encoding (numpy) and the int32 binary search (K1).

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

launches = {"searchsorted_i32": 0}


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
    """K1 on a CUDA tensor, the plain version on a CPU tensor."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', not {side!r}")
    if not _device.is_cuda(table):
        return searchsorted_i32_plain(table, queries, side)
    from ._build import check, lib
    n = table.shape[0]
    if table.dtype != torch.int32 or table.dim() != 1 or n & (n - 1) or not n:
        raise ValueError("table must be a 1-D int32 power-of-two array")
    if queries.device != table.device or queries.dtype != torch.int32:
        raise ValueError("queries must be int32 on the table's device")
    table = table.contiguous()
    q = queries.contiguous()
    out = torch.empty(q.shape, dtype=torch.int32, device=table.device)
    check(lib().fdb_searchsorted_i32(
        table.data_ptr(), n, q.data_ptr(), q.numel(),
        int(side == "right"), out.data_ptr(),
        _device.stream_handle(table.device)), "searchsorted_i32")
    launches["searchsorted_i32"] += 1
    return out
