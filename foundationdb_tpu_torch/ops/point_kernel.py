"""The point-op conflict-resolution step (K5), as a hand-written CUDA
kernel and its plain PyTorch version.

FDB's commit hot path is dominated by point reads and writes: conflict
ranges [k, k+'\\x00'). This step is the interval step restricted to
such batches, over a "latest write version per key" state

  SK[cap, W+1]  key rows sorted by (key words, version); duplicate keys
                allowed (newest last), +inf padded
  SV[cap]       int32 version offsets

and one padded batch (snapshots, tooOld flags, read and write keys with
per-slot transaction ids and valid masks, commit / oldest / init
offsets). It returns (SK', SV', count, conflict[T], read_hit[R]):

  1. external check: a read conflicts iff the newest state row of its
     key is above its snapshot, or its snapshot is below `init_off`
     (the whole-keyspace baseline the point map cannot store as a row);
  2. intra-batch check: the antitone fixpoint over "an alive write of
     my key by an earlier transaction";
  3. attribution (only when `attribute` is set);
  4. merge + GC: the live state rows and the surviving writes (at the
     commit offset) sorted together by (key, version), masked rows
     (+inf, VMASK) after them, sliced back to cap; `count` is the real
     row count before the slice.

The plain version (`point_resolve_step_plain`) follows the reference's
make_point_resolve_core line by line with PyTorch calls (key words
widen to int64; every multi-column sort is a chain of stable sorts).
The CUDA kernel (csrc/point_resolve.cu) takes another route; see the
note there. Both are bit-identical to the reference on the same packed
buffer.
"""

from __future__ import annotations

import ctypes
import functools
from collections import namedtuple

import numpy as np
import torch

from .. import device as _device
from . import keys as _keys
from .conflict_kernel import (SNAP_CLAMP, KernelCounters, _check_history,
                              _fault_seamed, _first_of_run, _lex_sort,
                              _outputs, profile_kernel)
from .conflict_kernel import _scratch as _step_scratch
from .keys import searchsorted_i32_plain, searchsorted_rows_plain

VMASK = SNAP_CLAMP + 1  # version column for masked rows (sorts, never read)
INF = 0xFFFFFFFF

# point-kernel call/first-call/execute accounting, separate from the
# interval family
g_kernel_counters = KernelCounters("point_kernel")

launches = {"point_resolve": 0}


# ---------------------------------------------------------------------------
# Packed single-buffer feed: the three version scalars ride the buffer
# head, so one batch is exactly ONE host->device transfer. The layout is
# the reference's word for word: one host buffer feeds both packages.

PointBatchViews = namedtuple(
    "PointBatchViews", "hdr snap too_old rk rtxn rvalid wk wtxn wvalid")


def point_feed_len(n_txns: int, n_reads: int, n_writes: int,
                   n_words: int) -> int:
    """Total uint32 words of one packed point feed buffer."""
    width = n_words + 1
    return 3 + 2 * n_txns + (n_reads + n_writes) * (width + 2)


def point_batch_views(buf: np.ndarray, n_txns: int, n_reads: int,
                      n_writes: int, n_words: int) -> PointBatchViews:
    """Named numpy views over one packed point feed buffer; `hdr` is
    [commit_off, oldest_off, init_off] as int32. The views alias `buf`
    so marshallers build the batch in place (see
    conflict_kernel.interval_batch_views)."""
    width = n_words + 1
    o = [3]

    def take(n):
        part = buf[o[0]:o[0] + n]
        o[0] += n
        return part

    v = PointBatchViews(
        hdr=buf[0:3].view(np.int32),
        snap=take(n_txns).view(np.int32),
        too_old=take(n_txns),
        rk=take(n_reads * width).reshape(n_reads, width),
        rtxn=take(n_reads).view(np.int32),
        rvalid=take(n_reads),
        wk=take(n_writes * width).reshape(n_writes, width),
        wtxn=take(n_writes).view(np.int32),
        wvalid=take(n_writes))
    assert o[0] == buf.shape[0], (o[0], buf.shape)
    return v


def pack_point_batch(snap, too_old, rk, rtxn, rvalid, wk, wtxn, wvalid,
                     commit_off: int = 0, oldest_off: int = 0,
                     init_off: int = 0):
    """Pack one batch's host arrays into a single contiguous uint32
    buffer for make_point_resolve_packed_fn. One host->device transfer
    per batch instead of eleven: on a remote-attached accelerator the
    per-transfer latency dominates the streamed resolve path, and the
    unpack on device is free (fused slices/bitcasts)."""
    npad = snap.shape[0]
    nrp, width = rk.shape
    nwp = wk.shape[0]
    buf = np.empty(point_feed_len(npad, nrp, nwp, width - 1), np.uint32)
    v = point_batch_views(buf, npad, nrp, nwp, width - 1)
    v.hdr[0] = commit_off
    v.hdr[1] = oldest_off
    v.hdr[2] = init_off
    v.snap[:] = np.asarray(snap, np.int32)
    v.too_old[:] = np.asarray(too_old, np.uint32)
    v.rk[:] = rk
    v.rtxn[:] = np.asarray(rtxn, np.int32)
    v.rvalid[:] = np.asarray(rvalid, np.uint32)
    v.wk[:] = wk
    v.wtxn[:] = np.asarray(wtxn, np.int32)
    v.wvalid[:] = np.asarray(wvalid, np.uint32)
    return buf


def point_unpack(buf: torch.Tensor, n_txns: int, n_reads: int,
                 n_writes: int, n_words: int):
    """The 11 step inputs as views of one packed uint32 feed tensor (no
    copies): int32 fields through an int32 view of the same words,
    flags as `!= 0`, the header scalars as 0-d int32 views."""
    width = n_words + 1
    words = buf.view(torch.int32)
    o = [3]

    def take(n, signed=False):
        part = (words if signed else buf)[o[0]:o[0] + n]
        o[0] += n
        return part

    snap = take(n_txns, True)
    too_old = take(n_txns, True) != 0
    rk = take(n_reads * width).reshape(n_reads, width)
    rtxn = take(n_reads, True)
    rvalid = take(n_reads, True) != 0
    wk = take(n_writes * width).reshape(n_writes, width)
    wtxn = take(n_writes, True)
    wvalid = take(n_writes, True) != 0
    return (snap, too_old, rk, rtxn, rvalid, wk, wtxn, wvalid,
            words[0], words[1], words[2])


# ---------------------------------------------------------------------------
# K5, the plain version
# ---------------------------------------------------------------------------

def _seg_or_scan(vals, seg_start):
    """Inclusive segmented prefix-OR: resets at seg_start rows."""
    idx = torch.arange(vals.shape[0], device=vals.device)
    start = torch.cummax(torch.where(seg_start, idx, 0), dim=0).values
    cs = torch.cumsum(vals.to(torch.int64), 0)
    before = torch.where(start > 0, cs[start - 1], 0)
    return (cs - before) > 0


def point_resolve_step_plain(sk, sv, snap, too_old, rk, rtxn, rvalid,
                             wk, wtxn, wvalid, commit, oldest, init_off,
                             attribute: bool = True):
    """One point resolve step in plain PyTorch, line by line after the
    reference's step; returns (SK', SV', count, conflict, read_hit) with
    read_hit None when `attribute` is False."""
    i64 = torch.int64
    dev = sv.device
    cap, width = sk.shape
    n = snap.shape[0]
    n_reads = rk.shape[0]
    nb = n_reads + wk.shape[0]
    commit, oldest, init_off = int(commit), int(oldest), int(init_off)
    sk, rk, wk = (x.to(i64) for x in (sk, rk, wk))
    sv, snap, rtxn, wtxn = (x.to(i64) for x in (sv, snap, rtxn, wtxn))
    too_old, rvalid, wvalid = (x.to(torch.bool)
                               for x in (too_old, rvalid, wvalid))
    inf_row = torch.full((width,), INF, dtype=i64, device=dev)

    def full(k, v, dtype=i64):
        return torch.full((k,), v, dtype=dtype, device=dev)

    r_starts = searchsorted_i32_plain(
        rtxn, torch.arange(n + 2, dtype=i64, device=dev)).to(i64)
    snap_pad = torch.cat([snap, full(1, SNAP_CLAMP)])

    # ---- 1. external check: point lookup in the state map ---------------
    pos = torch.clamp(searchsorted_rows_plain(sk, rk, side="right")
                      .to(i64) - 1, min=0)
    hit_k = sk[pos]
    hit_v = sv[pos]
    match = (hit_k == rk).all(dim=1)
    ext_r = rvalid & match & (hit_v > snap_pad[rtxn])

    def seg_count(flags):
        cum = torch.cat([full(1, 0), torch.cumsum(flags.to(i64), 0)])
        at = cum[r_starts]
        return at[1:] - at[:-1]

    has_read = seg_count(rvalid)[:n] > 0
    ext = (seg_count(ext_r)[:n] > 0) | (has_read & (snap < init_off))

    # ---- 2. intra-batch fixpoint over (key, txn)-sorted rows ------------
    bk = torch.cat([rk, wk])
    bvalid = torch.cat([rvalid, wvalid])
    btxn = torch.cat([rtxn, wtxn])
    is_w_slot = (torch.arange(nb, device=dev) >= n_reads).to(i64)
    tie = torch.where(bvalid, (btxn << 1) | is_w_slot, 0x7FFFFFFF)
    bk = torch.where(bvalid[:, None], bk, inf_row[None, :])
    meta = torch.arange(nb, dtype=i64, device=dev)
    ops = _lex_sort([bk[:, w] for w in range(width)] + [tie, meta],
                    width + 1)
    tie_s, meta_s = ops[width], ops[width + 1]
    valid_s = tie_s != 0x7FFFFFFF
    txn_s = torch.where(valid_s, tie_s >> 1, n)
    isw_s = valid_s & ((tie_s & 1) == 1)
    isr_s = valid_s & ((tie_s & 1) == 0)
    seg_start = _first_of_run(ops[:width])

    ones = torch.ones(1, dtype=torch.bool, device=dev)
    base_c = torch.cat([ext | too_old, ones])
    nhot = torch.arange(n + 1, device=dev) == n

    def hits_flat(c):
        # alive-write-strictly-before-me within my key run, routed back
        # to flat slot order (meta is a permutation of arange)
        alive = isw_s & ~c[txn_s]
        shifted = torch.cat([~ones, alive[:-1]]) & ~seg_start
        hit_row = isr_s & _seg_or_scan(shifted, seg_start)
        flat = torch.zeros(nb, dtype=torch.bool, device=dev)
        flat[meta_s] = hit_row
        return flat[:n_reads]

    def s_map(c):
        return base_c | (seg_count(hits_flat(c)) > 0) | nhot

    prev, cur, i = base_c, s_map(base_c), 1
    while bool((prev != cur).any()) and i < n + 2:
        prev, cur, i = cur, s_map(cur), i + 1
    conflict_pad = cur
    conflict = conflict_pad[:n]

    read_hit = None
    if attribute:
        init_r = rvalid & (snap_pad[rtxn] < init_off)
        read_hit = ext_r | init_r | hits_flat(conflict_pad)

    # ---- 3. merge + GC: one sort, pre-masked ----------------------------
    surv = wvalid & ~conflict_pad[wtxn]
    live = (sv >= max(oldest, 0)) & (sk[:, -1] != INF)
    mk = torch.where(live[:, None], sk, inf_row[None, :])
    mv = torch.where(live, sv, VMASK)
    ik = torch.where(surv[:, None], wk, inf_row[None, :])
    iv = torch.where(surv, commit, VMASK)
    allk = torch.cat([mk, ik])
    allv = torch.cat([mv, iv])
    sorted_ops = _lex_sort([allk[:, w] for w in range(width)] + [allv],
                           width + 1)
    out_k = torch.stack(sorted_ops[:width], dim=1)[:cap].to(torch.uint32)
    out_v = sorted_ops[width][:cap].to(torch.int32)
    count = (live.sum() + surv.sum()).to(torch.int32)
    return out_k, out_v, count, conflict, read_hit


# ---------------------------------------------------------------------------
# K5, the kernel (csrc/point_resolve.cu)
# ---------------------------------------------------------------------------

def _scratch(dev, cap, n_txns, n_reads, n_writes, width) -> torch.Tensor:
    return _step_scratch(dev, cap, n_txns, n_reads, n_writes, width,
                         sizer="fdb_point_resolve_scratch_bytes")


def _kernel_outputs(sk, sv, n_txns, n_reads, attribute, out):
    outs = _outputs(sk, n_txns, n_reads, attribute, out)
    if outs[0].data_ptr() == sk.data_ptr() \
            or outs[1].data_ptr() == sv.data_ptr():
        raise ValueError("the output state must not alias the input state")
    return outs


def _note_launches(counts) -> None:
    launches["point_resolve"] += 1
    _keys.launches["searchsorted_i32"] += int(counts[0])
    _keys.launches["searchsorted_rows"] += int(counts[1])


def point_resolve_step(sk, sv, snap, too_old, rk, rtxn, rvalid,
                       wk, wtxn, wvalid, commit, oldest, init_off,
                       attribute: bool = True, out=None):
    """The unpacked entry: K5 on CUDA tensors, the plain version on CPU
    tensors. `out` = (SK', SV') buffers the kernel writes into (the
    resolver's ping-pong pair, never the input state), optionally
    followed by count and conflict buffers; fresh buffers when None. Flags are bool (or 32-bit, nonzero = true); the three
    scalars are 0-d int32 tensors on the device or Python ints."""
    if not _device.is_cuda(sk):
        return point_resolve_step_plain(sk, sv, snap, too_old, rk, rtxn,
                                        rvalid, wk, wtxn, wvalid, commit,
                                        oldest, init_off, attribute)
    from ._build import check, lib
    _check_history(sk, sv)
    dev = sk.device
    cap, width = sk.shape
    n_txns, n_reads, n_writes = snap.shape[0], rk.shape[0], wk.shape[0]
    flags = (too_old, rvalid, wvalid)
    flag_bytes = flags[0].element_size()
    for f in flags:
        if f.element_size() != flag_bytes or f.device != dev:
            raise ValueError("flags must share one 1- or 4-byte dtype on "
                             "the state's device")
    scalars = [x if isinstance(x, torch.Tensor)
               else torch.tensor(int(x), dtype=torch.int32, device=dev)
               for x in (commit, oldest, init_off)]
    ins = [t.contiguous() for t in (snap, too_old, rk, rtxn, rvalid,
                                    wk, wtxn, wvalid, *scalars)]
    for t in ins:
        if t.device != dev:
            raise ValueError("every input must lie on the state's device")
    for t, n, key in ((ins[0], n_txns, False), (ins[1], n_txns, False),
                      (ins[2], n_reads, True), (ins[3], n_reads, False),
                      (ins[4], n_reads, False), (ins[5], n_writes, True),
                      (ins[6], n_writes, False), (ins[7], n_writes, False)):
        if tuple(t.shape) != ((n, width) if key else (n,)):
            raise ValueError(f"input of shape {tuple(t.shape)} does not "
                             f"match the bucket (T={n_txns}, R={n_reads}, "
                             f"Wr={n_writes}, W+1={width})")
        if key and t.dtype != torch.uint32:
            raise ValueError("key rows must be uint32")
    for t in (ins[0], ins[3], ins[6], *ins[8:]):
        if t.dtype != torch.int32 or not t.numel():
            raise ValueError("snapshots, txn ids and the three scalars "
                             "must be int32")
    outs = _kernel_outputs(sk, sv, n_txns, n_reads, attribute, out)
    scratch = _scratch(dev, cap, n_txns, n_reads, n_writes, width)
    counts = (ctypes.c_longlong * 2)()
    check(lib().fdb_point_resolve(
        sk.data_ptr(), sv.data_ptr(), *[t.data_ptr() for t in ins],
        flag_bytes, cap, n_txns, n_reads, n_writes, width, int(attribute),
        *[t.data_ptr() if t is not None else None for t in outs],
        scratch.data_ptr(), scratch.numel(), _device.stream_handle(dev),
        counts), "point_resolve")
    _note_launches(counts)
    return outs


def point_resolve_step_packed(sk, sv, buf, n_txns: int, n_reads: int,
                              n_writes: int, attribute: bool = True,
                              out=None):
    """The packed entry: `buf` is one uint32 feed tensor in the layout
    above. K5 reads its 11 inputs in place on the card; on the CPU the
    plain version runs on views of the buffer."""
    cap, width = sk.shape
    if buf.dtype != torch.uint32 or buf.dim() != 1 or buf.shape[0] != \
            point_feed_len(n_txns, n_reads, n_writes, width - 1):
        raise ValueError("feed buffer does not match the shape bucket")
    if not _device.is_cuda(sk):
        return point_resolve_step_plain(
            sk, sv, *point_unpack(buf, n_txns, n_reads, n_writes,
                                  width - 1), attribute)
    from ._build import check, lib
    _check_history(sk, sv)
    dev = sk.device
    if buf.device != dev:
        raise ValueError("feed buffer must lie on the state's device")
    buf = buf.contiguous()
    outs = _kernel_outputs(sk, sv, n_txns, n_reads, attribute, out)
    scratch = _scratch(dev, cap, n_txns, n_reads, n_writes, width)
    counts = (ctypes.c_longlong * 2)()
    check(lib().fdb_point_resolve_packed(
        sk.data_ptr(), sv.data_ptr(), buf.data_ptr(), cap, n_txns, n_reads,
        n_writes, width, int(attribute),
        *[t.data_ptr() if t is not None else None for t in outs],
        scratch.data_ptr(), scratch.numel(), _device.stream_handle(dev),
        counts), "point_resolve_packed")
    _note_launches(counts)
    return outs


@functools.lru_cache(maxsize=None)
def make_point_resolve_packed_fn(cap: int, n_txns: int, n_reads: int,
                                 n_writes: int, n_words: int,
                                 attribute: bool = True):
    """Profiled, fault-seamed packed entry for one shape bucket:
    fn(SK, SV, buf, out=None) -> (SK', SV', count, conflict, read_hit)."""
    def fn(sk, sv, buf, out=None):
        return point_resolve_step_packed(sk, sv, buf, n_txns, n_reads,
                                         n_writes, attribute=attribute,
                                         out=out)

    tag = "" if attribute else "/noattr"
    fn = profile_kernel(
        fn,
        f"point_packed[{cap}c/{n_txns}t/{n_reads}r/{n_writes}w{tag}]",
        g_kernel_counters)
    return _fault_seamed(fn, f"point_packed[{cap}c]")
