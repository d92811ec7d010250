"""Range max over int32 version arrays (K2).

For each query [lo, hi) the max of `vals[lo:hi]`, VDEAD for an empty
range. The plain version is the reference's block structure written in
PyTorch: 128-wide blocks with in-block prefix and suffix maxima, and a
doubling sparse table over the block maxima. The kernel
(csrc/range_max.cu) keeps the same structure. Values are version
offsets, never below VDEAD.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import device as _device

VDEAD = -(1 << 30)  # version of padded / dead slots; below any live version
BLOCK = 128

launches = {"range_max": 0}


class RangeMaxTable(NamedTuple):
    pre: torch.Tensor     # [n] prefix max within each block
    suf: torch.Tensor     # [n] suffix max within each block
    rows: torch.Tensor    # [n/BLOCK, BLOCK] raw values, one row per block
    btab: torch.Tensor    # [L, n/BLOCK] sparse table over block maxima


def build_range_max_table(vals: torch.Tensor) -> RangeMaxTable:
    """vals: [n] int32, n a multiple of BLOCK."""
    n = vals.shape[0]
    assert n % BLOCK == 0
    vals = vals.to(torch.int64)
    rows = vals.reshape(n // BLOCK, BLOCK)
    pre = torch.cummax(rows, dim=1).values.reshape(n)
    suf = torch.cummax(rows.flip(1), dim=1).values.flip(1).reshape(n)
    bmax = rows.max(dim=1).values
    nb = bmax.shape[0]
    levels = [bmax]
    k = 1
    while (1 << k) <= nb:
        prev = levels[-1]
        half = 1 << (k - 1)
        shifted = torch.cat([prev[half:], torch.full(
            (half,), VDEAD, dtype=prev.dtype, device=prev.device)])
        levels.append(torch.maximum(prev, shifted))
        k += 1
    return RangeMaxTable(pre, suf, rows, torch.stack(levels))


def _block_range_max(btab, lo_b, hi_b):
    """Max over block indices [lo_b, hi_b); empty -> VDEAD."""
    nb = btab.shape[1]
    length = hi_b - lo_b
    safe = torch.clamp(length, min=1)
    k = torch.zeros_like(safe)          # floor(log2(safe)), exactly
    for j in range(1, 32):
        k += (safe >= (1 << j)).to(k.dtype)
    flat = btab.reshape(-1)
    a = flat[(k * nb + lo_b).clamp(0, flat.numel() - 1)]
    b = flat[(k * nb + hi_b - (1 << k)).clamp(0, flat.numel() - 1)]
    dead = torch.full_like(a, VDEAD)
    return torch.where(length > 0, torch.maximum(a, b), dead)


def range_max_query(table: RangeMaxTable, lo: torch.Tensor,
                    hi: torch.Tensor) -> torch.Tensor:
    """Max over [lo, hi) per query; empty ranges give VDEAD."""
    n = table.pre.shape[0]
    lo = lo.to(torch.int64)
    hi = hi.to(torch.int64)
    last = hi - 1
    # gathers of empty or out-of-range queries are masked below; clamp
    # their indices so they stay in bounds
    lo_c = lo.clamp(0, n - 1)
    last_c = last.clamp(0, n - 1)
    lo_b, lo_l = lo_c // BLOCK, lo_c % BLOCK
    hi_b = last_c // BLOCK
    same = lo_b == hi_b
    cross = torch.maximum(
        torch.maximum(table.suf[lo_c], table.pre[last_c]),
        _block_range_max(table.btab, lo_b + 1, hi_b))
    row = table.rows[lo_b]                                   # [q, BLOCK]
    lanes = torch.arange(BLOCK, device=lo.device)
    mask = (lanes[None, :] >= lo_l[:, None]) & \
           (lanes[None, :] <= (last_c % BLOCK)[:, None])
    dead = torch.full_like(row, VDEAD)
    within = torch.where(mask, row, dead).max(dim=1).values
    out = torch.where(hi > lo, torch.where(same, within, cross),
                      torch.full_like(within, VDEAD))
    return out.to(torch.int32)


def range_max_plain(vals: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor) -> torch.Tensor:
    return range_max_query(build_range_max_table(vals), lo, hi)


def range_max(vals: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor) -> torch.Tensor:
    """K2 on a CUDA tensor (build + query, one call), the plain version
    on a CPU tensor. `vals` int32 [n], n a multiple of BLOCK; lo/hi
    int32 [q]. A non-empty range's ends clamp into [0, n-1]."""
    if not _device.is_cuda(vals):
        return range_max_plain(vals, lo, hi)
    from ._build import check, lib
    n = vals.shape[0]
    if vals.dtype != torch.int32 or vals.dim() != 1 or n % BLOCK or not n:
        raise ValueError("vals must be 1-D int32 of a multiple of 128")
    for t in (lo, hi):
        if t.device != vals.device or t.dtype != torch.int32:
            raise ValueError("lo/hi must be int32 on the values' device")
    if lo.shape != hi.shape:
        raise ValueError("lo and hi must have one shape")
    vals, lo, hi = vals.contiguous(), lo.contiguous(), hi.contiguous()
    L = lib()
    nbytes = L.fdb_range_max_scratch_bytes(n)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=vals.device)
    out = torch.empty(lo.shape, dtype=torch.int32, device=vals.device)
    check(L.fdb_range_max(vals.data_ptr(), n, lo.data_ptr(), hi.data_ptr(),
                          lo.numel(), out.data_ptr(), scratch.data_ptr(),
                          nbytes, _device.stream_handle(vals.device)),
          "range_max")
    launches["range_max"] += 1
    return out
