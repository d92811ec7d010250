"""The interval conflict-resolution step (K3), its key-range sharded
form (K8) and version-window upkeep (K4), each as a hand-written CUDA
kernel and its plain PyTorch version.

One step is one `ConflictBatch::detectConflicts` round
(fdbserver/SkipList.cpp:1163) over the history state

  HK[cap, W+1]  sorted boundary keys (uint32 words, +inf padded)
  HV[cap]       int32 version offsets of the intervals they start

and one padded batch (snapshots, tooOld flags, read and write ranges
with per-range transaction ids, valid masks, commit and oldest
offsets). It returns (HK', HV', count, conflict[T], read_hit[R]):

  1. external check: a read [b, e) conflicts iff the max version over
     the history intervals it touches exceeds its snapshot;
  2. intra-batch check: the antitone fixpoint
     c[t] = ext[t] | tooOld[t] | any(read of t overlaps a write of an
     earlier transaction t' with c[t'] false);
  3. attribution: a read is a cause iff it hit the history or overlaps
     a surviving earlier write (only when `attribute` is set);
  4. merge: the surviving writes' intervals take the commit version;
  5. window GC: duplicate keys, equal-version and dead-dead neighbours
     drop out, and the kept rows pack to the front.

The output state is canonical (sorted, deduplicated, +inf / VDEAD
padded), so the kernel and the plain version agree bit for bit, and
both agree with the reference package on the same packed buffer.

The sharded step runs S such steps in lockstep over a [S, cap, W+1]
history, each on the batch's ranges clipped to its shard, with the
external verdicts, every fixpoint round and the attribution OR-combined
over the shards (the reference's psum across chips). The plain version
(`resolve_step_sharded_plain`) does just that, one overlap matrix per
shard. K8 clips only the reads, for the external check: it sorts the
batch's unclipped endpoints once, as K3 does, builds ONE matrix from
their ranks, an empty range counted invalid, which is the OR of the
shards' clipped matrices bit for bit when the shards tile the key space,
and gives every shard its surviving writes, clipped, by one stable
partition of the same sort (see csrc/resolve.cu).

The plain version (`resolve_step_plain`) follows the reference line by
line with PyTorch calls: key words widen to int64 (PyTorch's uint32
has no ordered compares), and every multi-column sort is a chain of
stable sorts from the last key column to the first. The CUDA kernel
(csrc/resolve.cu) takes another route; see the note there.
"""

from __future__ import annotations

import ctypes
import functools
import time
from collections import namedtuple

import numpy as np
import torch

from .. import device as _device
from ..flow.stats import CounterCollection
from . import keys as _keys
from . import rmq as _rmq
from .keys import searchsorted_i32_plain
from .rmq import VDEAD, build_range_max_table, range_max_query

SNAP_CLAMP = (1 << 30) + 1  # above any storable version offset
REBASE_THRESHOLD = 1 << 30

# Per-process kernel profile: every resolve entry accounts calls, its
# first call (the kernel build included) and sampled execute time here.
g_kernel_counters = CounterCollection("conflict_kernel")

launches = {"resolve": 0, "resolve_sharded": 0, "window_upkeep": 0}


def _args_device(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def profile_kernel(fn, kernel: str,
                   counters: CounterCollection = g_kernel_counters):
    """Wrap a kernel entry with first-call/execute accounting.

    The FIRST call is fenced on both sides and timed on the host clock:
    on the card it includes the kernel library's build and load, the
    number to watch when the first batch is slow. Afterwards only
    1-in-KERNEL_PROFILE_EVERY calls are timed, with CUDA events around
    the launch on the card (host clock on the CPU), so the unfenced
    pipeline stays asynchronous; 0 disables the periodic timing."""
    from ..flow.knobs import SERVER_KNOBS
    state = {"compiled": False, "calls": 0}
    calls_c = counters.counter(f"{kernel}.calls")

    def call(*args, **kwargs):
        state["calls"] += 1
        first = not state["compiled"]
        if not first:
            every = int(SERVER_KNOBS.kernel_profile_every)
            if not every or state["calls"] % every:
                calls_c.add(1)
                return fn(*args, **kwargs)
        dev = _args_device(args)
        if first or dev.type != "cuda":
            _device.synchronize(dev)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _device.synchronize(dev)
            dt = time.perf_counter() - t0
        else:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        calls_c.add(1)
        if first:
            state["compiled"] = True
            counters.counter(f"{kernel}.compiles").add(1)
            counters.counter(f"{kernel}.compile_us").add(int(dt * 1e6))
            from ..flow.trace import SevDebug, TraceEvent
            TraceEvent("KernelCompile", kernel, severity=SevDebug).detail(
                Backend=_device.platform(dev), Seconds=round(dt, 6)).log()
        else:
            counters.counter(f"{kernel}.timed_calls").add(1)
            counters.counter(f"{kernel}.execute_us").add(int(dt * 1e6))
        return out

    return call


# ---------------------------------------------------------------------------
# Packed single-buffer feed: every per-batch input rides ONE contiguous
# uint32 host buffer, so a batch costs one host->device transfer.
#
# Layout (uint32 words; int32 values ride as bit patterns):
#   [0]                commit_off        [1]              oldest_off
#   [2           : 2+T]         snapshots          (int32)
#   [2+T         : 2+2T]        too_old            (0/1)
#   [..          : +R*(W+1)]    read begin rows
#   [..          : +R*(W+1)]    read end rows
#   [..          : +R]          read txn ids       (int32, pad = T)
#   [..          : +R]          read valid         (0/1)
#   [..          : +Wr*(W+1)]   write begin rows
#   [..          : +Wr*(W+1)]   write end rows
#   [..          : +Wr]         write txn ids
#   [..          : +Wr]         write valid
# with T = n_txns slots, R = n_reads slots, Wr = n_writes slots and
# W+1 the encoded key width (ops.keys layout). The layout is the
# reference's word for word: one host buffer feeds both packages.

IntervalBatchViews = namedtuple(
    "IntervalBatchViews",
    "hdr snap too_old rb re rtxn rvalid wb we wtxn wvalid")


def interval_feed_len(n_txns: int, n_reads: int, n_writes: int,
                      n_words: int) -> int:
    """Total uint32 words of one packed interval feed buffer."""
    width = n_words + 1
    return 2 + 2 * n_txns + (n_reads + n_writes) * (2 * width + 2)


def interval_batch_views(buf: np.ndarray, n_txns: int, n_reads: int,
                         n_writes: int, n_words: int) -> IntervalBatchViews:
    """Named numpy views over one packed feed buffer (see layout above).

    The views alias `buf`, so a marshaller can build the batch IN PLACE
    — keys encoded straight into the rb/re/wb/we sub-matrices — and
    hand the single buffer to the device. int32 fields come back as
    int32 views of the same words."""
    width = n_words + 1
    o = [2]

    def take(n):
        part = buf[o[0]:o[0] + n]
        o[0] += n
        return part

    v = IntervalBatchViews(
        hdr=buf[0:2].view(np.int32),
        snap=take(n_txns).view(np.int32),
        too_old=take(n_txns),
        rb=take(n_reads * width).reshape(n_reads, width),
        re=take(n_reads * width).reshape(n_reads, width),
        rtxn=take(n_reads).view(np.int32),
        rvalid=take(n_reads),
        wb=take(n_writes * width).reshape(n_writes, width),
        we=take(n_writes * width).reshape(n_writes, width),
        wtxn=take(n_writes).view(np.int32),
        wvalid=take(n_writes))
    assert o[0] == buf.shape[0], (o[0], buf.shape)
    return v


def pack_interval_batch(snap, too_old, rb, re, rtxn, rvalid,
                        wb, we, wtxn, wvalid,
                        commit_off: int, oldest_off: int) -> np.ndarray:
    """Pack one padded interval batch into a fresh single-transfer
    buffer for make_resolve_packed_fn (tests / one-shot callers; the
    resolver builds batches in place over reused staging buffers via
    interval_batch_views instead)."""
    npad = snap.shape[0]
    nrp, width = rb.shape
    nwp = wb.shape[0]
    buf = np.empty(interval_feed_len(npad, nrp, nwp, width - 1), np.uint32)
    v = interval_batch_views(buf, npad, nrp, nwp, width - 1)
    v.hdr[0] = commit_off
    v.hdr[1] = oldest_off
    v.snap[:] = np.asarray(snap, np.int32)
    v.too_old[:] = np.asarray(too_old, np.uint32)
    v.rb[:] = rb
    v.re[:] = re
    v.rtxn[:] = np.asarray(rtxn, np.int32)
    v.rvalid[:] = np.asarray(rvalid, np.uint32)
    v.wb[:] = wb
    v.we[:] = we
    v.wtxn[:] = np.asarray(wtxn, np.int32)
    v.wvalid[:] = np.asarray(wvalid, np.uint32)
    return buf


def interval_unpack(buf: torch.Tensor, n_txns: int, n_reads: int,
                    n_writes: int, n_words: int):
    """The 12 step inputs as views of one packed uint32 feed tensor
    (no copies): int32 fields through an int32 view of the same words,
    flags as `!= 0`, scalars as 0-d int32 views."""
    width = n_words + 1
    words = buf.view(torch.int32)
    o = [2]

    def take(n, signed=False):
        part = (words if signed else buf)[o[0]:o[0] + n]
        o[0] += n
        return part

    snap = take(n_txns, True)
    too_old = take(n_txns, True) != 0
    rb = take(n_reads * width).reshape(n_reads, width)
    re = take(n_reads * width).reshape(n_reads, width)
    rtxn = take(n_reads, True)
    rvalid = take(n_reads, True) != 0
    wb = take(n_writes * width).reshape(n_writes, width)
    we = take(n_writes * width).reshape(n_writes, width)
    wtxn = take(n_writes, True)
    wvalid = take(n_writes, True) != 0
    return (snap, too_old, rb, re, rtxn, rvalid, wb, we, wtxn, wvalid,
            words[0], words[1])


# ---------------------------------------------------------------------------
# K3, the plain version
# ---------------------------------------------------------------------------

def _lex_sort(cols, num_keys: int):
    """Stable lexicographic sort of parallel columns by the first
    `num_keys` (lax.sort(..., num_keys) with is_stable=True): a chain
    of stable single-column sorts from the last key to the first."""
    perm = torch.arange(cols[0].shape[0], device=cols[0].device)
    for c in reversed(cols[:num_keys]):
        perm = perm[torch.sort(c[perm], stable=True).indices]
    return [c[perm] for c in cols]


def _carry_last(vals, flags):
    """out[i] = vals[last j <= i with flags[j]], vals[0] when none:
    the reference's associative keep-first / carry-last scan."""
    idx = torch.arange(vals.shape[0], device=vals.device)
    idx = torch.cummax(torch.where(flags, idx, 0), dim=0).values
    return vals[idx]


def _first_of_run(cols):
    """True where a row differs from the previous one in any column."""
    n = cols[0].shape[0]
    out = torch.zeros(n, dtype=torch.bool, device=cols[0].device)
    out[:1] = True
    for c in cols:
        out[1:] |= c[1:] != c[:-1]
    return out


def _pack_bits(flags):
    """[..., k] bool -> [...] int64 with bit b set where flags[..., b]."""
    out = torch.zeros(flags.shape[:-1], dtype=torch.int64,
                      device=flags.device)
    for b in range(flags.shape[-1]):
        out |= flags[..., b].to(torch.int64) << b
    return out


def _seg_any(flags, r_starts, n):
    """Per transaction, whether any of its read slots is flagged: cumsum
    differences at the segment starts (the slots are in txn order)."""
    cum = torch.cat([torch.zeros(1, dtype=torch.int64, device=flags.device),
                     torch.cumsum(flags.to(torch.int64), 0)])
    at = cum[r_starts]
    return (at[1:] - at[:-1])[:n] > 0


def _external_reads(hk, hv, snap_pad, rb, re, rtxn, rvalid):
    """1. One shard's external check: read r hits its history iff the max
    version over the history intervals [rb, re) touches exceeds its
    snapshot (int64 keys and ids, bool flags)."""
    i64 = torch.int64
    dev = hv.device
    cap, width = hk.shape
    n_reads = rb.shape[0]
    nq = 2 * n_reads

    def full(k, v):
        return torch.full((k,), v, dtype=i64, device=dev)

    tie_e = torch.cat([full(cap, 1), full(n_reads, 2), full(n_reads, 0)])
    qid_e = torch.cat([full(cap, nq), torch.arange(nq, dtype=i64,
                                                   device=dev)])
    rows_e = torch.cat([hk, rb, re])
    sorted_e = _lex_sort([rows_e[:, w] for w in range(width)]
                         + [tie_e, qid_e], width + 1)
    is_q = sorted_e[width] != 1
    cq = torch.cumsum(is_q.to(i64), 0)
    ranks_e = torch.arange(cap + nq, dtype=i64, device=dev) - cq + 1
    pos_q = _lex_sort([sorted_e[width + 1], ranks_e], 1)[1]
    lo = pos_q[:n_reads] - 1
    hi = pos_q[n_reads:nq]
    vmax = range_max_query(build_range_max_table(hv), lo, hi).to(i64)
    return rvalid & (vmax > snap_pad[rtxn])


def _overlap(rb, re, rtxn, rvalid, wb, we, wtxn, wvalid, pack_w):
    """2a. One shard's read x write overlap matrix, packed at once into
    uint32 lanes of `pack_w` writes (int64 words): read r overlaps write
    w of an earlier transaction, both valid. Ranked in the space of
    {rb, wb, we} as the reference does."""
    i64 = torch.int64
    dev = rb.device
    n_reads, width = rb.shape
    n_writes = wb.shape[0]
    inf_row = torch.full((width,), 0xFFFFFFFF, dtype=i64, device=dev)
    endpoints = torch.cat([rb, wb, we])
    ep_valid = torch.cat([rvalid, wvalid, wvalid])
    endpoints = torch.where(ep_valid[:, None], endpoints, inf_row[None, :])
    na = endpoints.shape[0]
    nall = na + n_reads
    rows_r = torch.cat([endpoints, re])
    is_a = (torch.arange(nall, dtype=i64, device=dev) < na).to(i64)
    qid_r = torch.arange(nall, dtype=i64, device=dev)
    sorted_r = _lex_sort([rows_r[:, w] for w in range(width)]
                         + [is_a, qid_r], width)
    a_s = sorted_r[width]
    rank_a = torch.cumsum(a_s, 0) - a_s          # #A rows strictly before i
    rank_run = _carry_last(rank_a, _first_of_run(sorted_r[:width]))
    pos_r = _lex_sort([sorted_r[width + 1], rank_run], 1)[1]
    r_lo = pos_r[:n_reads]
    w_lo = pos_r[n_reads:n_reads + n_writes]
    w_hi = pos_r[n_reads + n_writes:na]
    r_hi = pos_r[na:]
    ov = ((w_lo[None, :] < r_hi[:, None]) & (r_lo[:, None] < w_hi[None, :])
          & rvalid[:, None] & wvalid[None, :]
          & (wtxn[None, :] < rtxn[:, None]))      # [n_reads, n_writes]
    ovp = _pack_bits(ov.reshape(n_reads, n_writes // pack_w, pack_w))
    del ov
    return ovp


def _merge_gc(hk, hv, wb, we, wvalid, wtxn, conflict_pad, commit, oldest):
    """3. + 4. One shard: the surviving writes' intervals take the commit
    version, then window GC and dedup, compacted by one more sort."""
    i64 = torch.int64
    dev = hv.device
    cap, width = hk.shape
    inf_row = torch.full((width,), 0xFFFFFFFF, dtype=i64, device=dev)
    ones = torch.ones(1, dtype=torch.bool, device=dev)

    def full(k, v):
        return torch.full((k,), v, dtype=i64, device=dev)

    surv = wvalid & ~conflict_pad[wtxn]
    ins_valid = torch.cat([surv, surv])
    ins = torch.where(ins_valid[:, None], torch.cat([wb, we]),
                      inf_row[None, :])
    mi = ins.shape[0]
    rows_m = torch.cat([hk, ins])
    tie_m = torch.cat([full(cap, 1), torch.where(surv, 6, 1).to(i64),
                       torch.where(surv, 4, 1).to(i64)])
    vcol = torch.cat([hv, full(mi, VDEAD)])
    sm = _lex_sort([rows_m[:, w] for w in range(width)] + [tie_m, vcol],
                   width + 1)
    is_ins = sm[width] >= 4
    merged_k = torch.stack(sm[:width], dim=1)
    mv_raw = sm[width + 1]
    delta_s = torch.where(is_ins, sm[width] - 5, 0)
    lhv = _carry_last(mv_raw, ~is_ins)
    merged_v = torch.where(is_ins, lhv, mv_raw)
    run_end = torch.cat([_first_of_run(sm[:width])[1:], ones])
    covered = torch.cumsum(delta_s, 0) > 0
    merged_v = torch.where(covered, torch.clamp(merged_v, min=commit),
                           merged_v)

    oldest2 = max(oldest, 0)
    keep1 = run_end
    dead = merged_v < oldest2
    prev_keep = torch.cat([~ones, keep1[:-1]])
    prev_v = torch.cat([full(1, VDEAD), merged_v[:-1]])
    prev_dead = torch.cat([ones, dead[:-1]])
    redundant = prev_keep & ((merged_v == prev_v) | (dead & prev_dead))
    redundant[0] = False
    keep = keep1 & ~redundant
    is_real = ~(merged_k == inf_row[None, :]).all(dim=1)
    val_k = torch.where(keep[:, None], merged_k, inf_row[None, :])
    val_v = torch.where(keep, merged_v, VDEAD)
    sc = _lex_sort([val_k[:, w] for w in range(width)] + [val_v], width)
    out_k = torch.stack(sc[:width], dim=1)[:cap].to(torch.uint32)
    out_v = sc[width][:cap].to(torch.int32)
    count = (keep & is_real).sum().to(torch.int32)
    return out_k, out_v, count


def _resolve_shards(hks, hvs, snap, too_old, rtxn, wtxn, shards, commit,
                    oldest, attribute: bool):
    """The plain step over S shards in lockstep, line by line after the
    reference's step (S = 1 is the single-shard step). `shards` holds
    each shard's (rb, re, rvalid, wb, we, wvalid), its ranges clipped to
    it; the external verdicts, every fixpoint round and the attribution
    are OR-combined over the shards (the reference's psum), so the
    verdicts are the single-shard step's. Returns per-shard lists of
    (HK', HV', count), then conflict and read_hit."""
    i64 = torch.int64
    dev = snap.device
    n = snap.shape[0]
    n_writes = wtxn.shape[0]
    pack_w = min(32, n_writes)
    n_lanes = n_writes // pack_w
    commit, oldest = int(commit), int(oldest)
    snap, rtxn, wtxn = (x.to(i64) for x in (snap, rtxn, wtxn))
    too_old = too_old.to(torch.bool)
    ones = torch.ones(1, dtype=torch.bool, device=dev)
    snap_pad = torch.cat([snap, torch.full((1,), SNAP_CLAMP, dtype=i64,
                                           device=dev)])
    r_starts = searchsorted_i32_plain(
        rtxn, torch.arange(n + 2, dtype=i64, device=dev)).to(i64)
    shards = [(rb.to(i64), re.to(i64), rvalid.to(torch.bool), wb.to(i64),
               we.to(i64), wvalid.to(torch.bool))
              for rb, re, rvalid, wb, we, wvalid in shards]

    # ---- 1. external check against each shard's history -----------------
    ext_r = [_external_reads(hk.to(i64), hv.to(i64), snap_pad, rb, re, rtxn,
                             rvalid)
             for hk, hv, (rb, re, rvalid, _wb, _we, _wv)
             in zip(hks, hvs, shards)]
    ext = torch.zeros(n, dtype=torch.bool, device=dev)
    for e in ext_r:
        ext |= _seg_any(e, r_starts, n)

    # ---- 2. intra-batch fixpoint, its rounds combined over the shards ----
    ovps = [_overlap(rb, re, rtxn, rvalid, wb, we, wtxn, wvalid, pack_w)
            for rb, re, rvalid, wb, we, wvalid in shards]
    base_c = torch.cat([ext | too_old, ones])

    def s_map(c):
        alive_p = _pack_bits((~c[wtxn]).reshape(n_lanes, pack_w))
        hit = torch.zeros(n, dtype=torch.bool, device=dev)
        for ovp in ovps:
            hit |= _seg_any(((ovp & alive_p[None, :]) != 0).any(dim=1),
                            r_starts, n)
        return torch.cat([base_c[:n] | hit, ones])

    prev, cur, i = base_c, s_map(base_c), 1
    while bool((prev != cur).any()) and i < n + 2:
        prev, cur, i = cur, s_map(cur), i + 1
    conflict_pad = cur
    conflict = conflict_pad[:n]

    read_hit = None
    if attribute:
        alive_fp = _pack_bits((~conflict_pad[wtxn]).reshape(n_lanes, pack_w))
        read_hit = torch.zeros(rtxn.shape[0], dtype=torch.bool, device=dev)
        for e, ovp in zip(ext_r, ovps):
            read_hit |= e | ((ovp & alive_fp[None, :]) != 0).any(dim=1)

    # ---- 3. + 4. merge, GC and compaction, shard by shard ----------------
    outs = [_merge_gc(hk.to(i64), hv.to(i64), wb, we, wvalid, wtxn,
                      conflict_pad, commit, oldest)
            for hk, hv, (_rb, _re, _rv, wb, we, wvalid)
            in zip(hks, hvs, shards)]
    return ([o[0] for o in outs], [o[1] for o in outs], [o[2] for o in outs],
            conflict, read_hit)


def resolve_step_plain(hk, hv, snap, too_old, rb, re, rtxn, rvalid,
                       wb, we, wtxn, wvalid, commit, oldest,
                       attribute: bool = True):
    """One resolve step in plain PyTorch, line by line after the
    reference's step; returns (HK', HV', count, conflict, read_hit)
    with read_hit None when `attribute` is False."""
    ks, vs, counts, conflict, read_hit = _resolve_shards(
        [hk], [hv], snap, too_old, rtxn, wtxn,
        [(rb, re, rvalid, wb, we, wvalid)], commit, oldest, attribute)
    return ks[0], vs[0], counts[0], conflict, read_hit


def resolve_step_sharded_plain(hk, hv, snap, too_old, rb, re, rtxn, rvalid,
                               wb, we, wtxn, wvalid, commit, oldest, lows,
                               highs, attribute: bool = True):
    """K8's plain version: the reference's sharded step on a [S, cap,
    W+1] history. The ranges are clipped to every shard's [lows[s],
    highs[s]) by the plain clip, then the S shards resolve in lockstep.
    Returns (HK'[S], HV'[S], count[S], conflict, read_hit)."""
    crb, cre, crv = _keys.clip_to_shards_plain(rb, re, rvalid, lows, highs)
    cwb, cwe, cwv = _keys.clip_to_shards_plain(wb, we, wvalid, lows, highs)
    ks, vs, counts, conflict, read_hit = _resolve_shards(
        list(hk), list(hv), snap, too_old, rtxn, wtxn,
        [(crb[k], cre[k], crv[k], cwb[k], cwe[k], cwv[k])
         for k in range(hk.shape[0])], commit, oldest, attribute)
    return (torch.stack(ks), torch.stack(vs), torch.stack(counts), conflict,
            read_hit)


# ---------------------------------------------------------------------------
# K3, the kernel (csrc/resolve.cu)
# ---------------------------------------------------------------------------

_scratch_cache: dict = {}


def _scratch(dev, cap, n_txns, n_reads, n_writes, width,
             sizer: str = "fdb_resolve_scratch_bytes",
             shards=None) -> torch.Tensor:
    """Per-shape scratch for a resolve step's kernels, sized by the C
    entry `sizer` (K3's, K5's, or K8's, which takes the shard count
    first). Reuse across calls is safe: every launch is ordered on the
    one stream."""
    key = (sizer, dev, shards, cap, n_txns, n_reads, n_writes, width)
    s = _scratch_cache.get(key)
    if s is None:
        from ._build import lib
        if len(_scratch_cache) >= 8:
            _scratch_cache.clear()
        lead = () if shards is None else (shards,)
        nbytes = getattr(lib(), sizer)(*lead, cap, n_txns, n_reads, n_writes,
                                       width)
        s = _scratch_cache[key] = torch.empty(nbytes, dtype=torch.uint8,
                                              device=dev)
    return s


def _check_history(hk, hv, dims: int = 2):
    """HK [cap, W+1] (dims 2) or [S, cap, W+1] (dims 3) uint32 and HV
    of its shape less the word axis, int32, contiguous, on one device."""
    if hk.dtype != torch.uint32 or hk.dim() != dims or not hk.is_contiguous():
        raise ValueError(f"HK must be a contiguous {dims}-D uint32 tensor "
                         "of rows")
    if hv.dtype != torch.int32 or hv.shape != hk.shape[:-1] \
            or not hv.is_contiguous() or hv.device != hk.device:
        raise ValueError("HV must be a contiguous int32 tensor beside HK")


def _check_bounds(hk, lows, highs):
    want = (hk.shape[0], hk.shape[-1])
    for t in (lows, highs):
        if t.dtype != torch.uint32 or tuple(t.shape) != want \
                or not t.is_contiguous() or t.device != hk.device:
            raise ValueError("shard bounds must be contiguous [S, W+1] "
                             "uint32 rows beside the history")


def _outputs(hk, n_txns, n_reads, attribute, out):
    """The step's outputs: `out` is (HK', HV') or (HK', HV', count,
    conflict), the caller's buffers (a bench chain allocates nothing
    per step); what it leaves out is allocated here."""
    dev = hk.device
    if out is None:
        out = (torch.empty_like(hk), torch.empty(hk.shape[:-1],
                                                 dtype=torch.int32,
                                                 device=dev))
    hk_out, hv_out, *given = out
    _check_history(hk_out, hv_out, hk.dim())
    if hk_out.shape != hk.shape or hk_out.device != dev:
        raise ValueError("output history must have the input's shape")
    if given:
        count, conflict = given
        if count.dtype != torch.int32 or count.shape != hk.shape[:-2] \
                or conflict.dtype != torch.bool \
                or tuple(conflict.shape) != (n_txns,) \
                or not (count.is_contiguous() and conflict.is_contiguous()) \
                or count.device != dev or conflict.device != dev:
            raise ValueError("count and conflict buffers must be int32 "
                             "[S] / bool [T] on the history's device")
    else:
        count = torch.empty(hk.shape[:-2], dtype=torch.int32, device=dev)
        conflict = torch.empty(n_txns, dtype=torch.bool, device=dev)
    read_hit = (torch.empty(n_reads, dtype=torch.bool, device=dev)
                if attribute else None)
    return hk_out, hv_out, count, conflict, read_hit


def _note_launches(counts, name: str = "resolve") -> None:
    """Count a step and the kernels it launched inside: K1, K2 and, for
    the sharded step, K7, whose clip runs fused into the step's bounds
    search (one launch a sharded batch)."""
    launches[name] += 1
    _keys.launches["searchsorted_i32"] += int(counts[0])
    _rmq.launches["range_max"] += int(counts[1])
    if len(counts) > 2:
        _keys.launches["shard_clip"] += int(counts[2])


def _unpacked_inputs(dev, width, snap, too_old, rb, re, rtxn, rvalid,
                     wb, we, wtxn, wvalid, commit, oldest):
    """The unpacked entries' 12 inputs checked and made contiguous:
    returns (inputs, flag bytes, T, R, Wr)."""
    n_txns, n_reads, n_writes = snap.shape[0], rb.shape[0], wb.shape[0]
    flags = (too_old, rvalid, wvalid)
    flag_bytes = flags[0].element_size()
    for f in flags:
        if f.element_size() != flag_bytes or f.device != dev:
            raise ValueError("flags must share one 1- or 4-byte dtype on "
                             "the history's device")
    scalars = [x if isinstance(x, torch.Tensor)
               else torch.tensor(int(x), dtype=torch.int32, device=dev)
               for x in (commit, oldest)]
    ins = [t.contiguous() for t in (snap, too_old, rb, re, rtxn, rvalid,
                                    wb, we, wtxn, wvalid, *scalars)]
    for t in ins:
        if t.device != dev:
            raise ValueError("every input must lie on the history's device")
    for t, n, key in ((ins[0], n_txns, False), (ins[1], n_txns, False),
                      (ins[2], n_reads, True), (ins[3], n_reads, True),
                      (ins[4], n_reads, False), (ins[5], n_reads, False),
                      (ins[6], n_writes, True), (ins[7], n_writes, True),
                      (ins[8], n_writes, False), (ins[9], n_writes, False)):
        if tuple(t.shape) != ((n, width) if key else (n,)):
            raise ValueError(f"input of shape {tuple(t.shape)} does not "
                             f"match the bucket (T={n_txns}, R={n_reads}, "
                             f"Wr={n_writes}, W+1={width})")
        if key and t.dtype != torch.uint32:
            raise ValueError("key rows must be uint32")
    for t in (ins[0], ins[4], ins[8], ins[10], ins[11]):
        if t.dtype != torch.int32 or not t.numel():
            raise ValueError("snapshots, txn ids, commit and oldest must "
                             "be int32")
    return ins, flag_bytes, n_txns, n_reads, n_writes


def _ptrs(outs):
    return [t.data_ptr() if t is not None else None for t in outs]


def resolve_step(hk, hv, snap, too_old, rb, re, rtxn, rvalid,
                 wb, we, wtxn, wvalid, commit, oldest,
                 attribute: bool = True, out=None):
    """The unpacked entry: K3 on CUDA tensors, the plain version on CPU
    tensors. `out` = (HK', HV') buffers the kernel writes into (the
    resolver's ping-pong pair), optionally followed by count and
    conflict buffers; fresh buffers when None. Flags are bool (or
    32-bit, nonzero = true); `commit`/`oldest` are 0-d int32 tensors on
    the device or Python ints."""
    if not _device.is_cuda(hk):
        return resolve_step_plain(hk, hv, snap, too_old, rb, re, rtxn,
                                  rvalid, wb, we, wtxn, wvalid, commit,
                                  oldest, attribute)
    from ._build import check, lib
    _check_history(hk, hv)
    dev = hk.device
    cap, width = hk.shape
    ins, flag_bytes, n_txns, n_reads, n_writes = _unpacked_inputs(
        dev, width, snap, too_old, rb, re, rtxn, rvalid, wb, we, wtxn,
        wvalid, commit, oldest)
    outs = _outputs(hk, n_txns, n_reads, attribute, out)
    scratch = _scratch(dev, cap, n_txns, n_reads, n_writes, width)
    counts = (ctypes.c_longlong * 2)()
    check(lib().fdb_resolve(
        hk.data_ptr(), hv.data_ptr(), *[t.data_ptr() for t in ins],
        flag_bytes, cap, n_txns, n_reads, n_writes, width, int(attribute),
        *_ptrs(outs), scratch.data_ptr(), scratch.numel(),
        _device.stream_handle(dev), counts), "resolve")
    _note_launches(counts)
    return outs


def _check_feed(buf, n_txns, n_reads, n_writes, width):
    if buf.dtype != torch.uint32 or buf.dim() != 1 or buf.shape[0] != \
            interval_feed_len(n_txns, n_reads, n_writes, width - 1):
        raise ValueError("feed buffer does not match the shape bucket")


def resolve_step_packed(hk, hv, buf, n_txns: int, n_reads: int,
                        n_writes: int, attribute: bool = True, out=None):
    """The packed entry: `buf` is one uint32 feed tensor in the layout
    above. K3 reads its 12 inputs in place on the card; on the CPU the
    plain version runs on views of the buffer."""
    cap, width = hk.shape
    _check_feed(buf, n_txns, n_reads, n_writes, width)
    if not _device.is_cuda(hk):
        return resolve_step_plain(
            hk, hv, *interval_unpack(buf, n_txns, n_reads, n_writes,
                                     width - 1), attribute)
    from ._build import check, lib
    _check_history(hk, hv)
    dev = hk.device
    if buf.device != dev:
        raise ValueError("feed buffer must lie on the history's device")
    buf = buf.contiguous()
    outs = _outputs(hk, n_txns, n_reads, attribute, out)
    scratch = _scratch(dev, cap, n_txns, n_reads, n_writes, width)
    counts = (ctypes.c_longlong * 2)()
    check(lib().fdb_resolve_packed(
        hk.data_ptr(), hv.data_ptr(), buf.data_ptr(), cap, n_txns, n_reads,
        n_writes, width, int(attribute), *_ptrs(outs), scratch.data_ptr(),
        scratch.numel(), _device.stream_handle(dev), counts),
        "resolve_packed")
    _note_launches(counts)
    return outs


# ---------------------------------------------------------------------------
# K8, the key-range sharded step (csrc/resolve.cu fdb_resolve_sharded*)
# ---------------------------------------------------------------------------

def resolve_step_sharded(hk, hv, snap, too_old, rb, re, rtxn, rvalid,
                         wb, we, wtxn, wvalid, commit, oldest, lows, highs,
                         attribute: bool = True, out=None):
    """The unpacked sharded entry: K8 on CUDA tensors, its plain version
    on CPU tensors. HK [S, cap, W+1], HV [S, cap]; `lows`/`highs` [S,
    W+1] are the shards' key ranges, which tile the key space as the
    resolver builds them (lows[0] the zero row, highs[k] == lows[k+1],
    highs[-1] the +inf row); the batch is K3's, empty ranges allowed.
    Returns (HK'[S], HV'[S], count[S], conflict[T], read_hit[R] or
    None)."""
    if not _device.is_cuda(hk):
        return resolve_step_sharded_plain(hk, hv, snap, too_old, rb, re,
                                          rtxn, rvalid, wb, we, wtxn, wvalid,
                                          commit, oldest, lows, highs,
                                          attribute)
    from ._build import check, lib
    _check_history(hk, hv, 3)
    _check_bounds(hk, lows, highs)
    dev = hk.device
    n_shards, cap, width = hk.shape
    ins, flag_bytes, n_txns, n_reads, n_writes = _unpacked_inputs(
        dev, width, snap, too_old, rb, re, rtxn, rvalid, wb, we, wtxn,
        wvalid, commit, oldest)
    outs = _outputs(hk, n_txns, n_reads, attribute, out)
    scratch = _scratch(dev, cap, n_txns, n_reads, n_writes, width,
                       "fdb_resolve_sharded_scratch_bytes", n_shards)
    counts = (ctypes.c_longlong * 3)()
    check(lib().fdb_resolve_sharded(
        hk.data_ptr(), hv.data_ptr(), *[t.data_ptr() for t in ins],
        lows.data_ptr(), highs.data_ptr(), flag_bytes, n_shards, cap, n_txns,
        n_reads, n_writes, width, int(attribute), *_ptrs(outs),
        scratch.data_ptr(), scratch.numel(), _device.stream_handle(dev),
        counts), "resolve_sharded")
    _note_launches(counts, "resolve_sharded")
    return outs


def resolve_step_sharded_packed(hk, hv, buf, lows, highs, n_txns: int,
                                n_reads: int, n_writes: int,
                                attribute: bool = True, out=None):
    """The packed sharded entry, the counterpart of the reference's
    shard_map'd packed step: one feed buffer, read word for word as K3
    reads it, shared by every shard. K8 on the card; on the CPU the
    plain version on views of the buffer."""
    if hk.dim() != 3:
        raise ValueError("a sharded history is [S, cap, W+1]")
    width = hk.shape[-1]
    _check_feed(buf, n_txns, n_reads, n_writes, width)
    if not _device.is_cuda(hk):
        return resolve_step_sharded_plain(
            hk, hv, *interval_unpack(buf, n_txns, n_reads, n_writes,
                                     width - 1), lows, highs, attribute)
    from ._build import check, lib
    _check_history(hk, hv, 3)
    _check_bounds(hk, lows, highs)
    dev = hk.device
    if buf.device != dev:
        raise ValueError("feed buffer must lie on the history's device")
    n_shards, cap, _ = hk.shape
    buf = buf.contiguous()
    outs = _outputs(hk, n_txns, n_reads, attribute, out)
    scratch = _scratch(dev, cap, n_txns, n_reads, n_writes, width,
                       "fdb_resolve_sharded_scratch_bytes", n_shards)
    counts = (ctypes.c_longlong * 3)()
    check(lib().fdb_resolve_sharded_packed(
        hk.data_ptr(), hv.data_ptr(), buf.data_ptr(), lows.data_ptr(),
        highs.data_ptr(), n_shards, cap, n_txns, n_reads, n_writes, width,
        int(attribute), *_ptrs(outs), scratch.data_ptr(), scratch.numel(),
        _device.stream_handle(dev), counts), "resolve_sharded_packed")
    _note_launches(counts, "resolve_sharded")
    return outs


@functools.lru_cache(maxsize=None)
def make_resolve_sharded_packed_fn(n_shards: int, cap: int, n_txns: int,
                                   n_reads: int, n_writes: int, n_words: int,
                                   attribute: bool = True):
    """Profiled, fault-seamed packed sharded entry for one shape bucket:
    fn(HK, HV, buf, lows, highs, out=None) -> (HK'[S], HV'[S], count[S],
    conflict, read_hit)."""
    def fn(hk, hv, buf, lows, highs, out=None):
        return resolve_step_sharded_packed(hk, hv, buf, lows, highs, n_txns,
                                           n_reads, n_writes,
                                           attribute=attribute, out=out)

    tag = "" if attribute else "/noattr"
    fn = profile_kernel(
        fn, f"sharded_packed[{n_shards}s/{cap}c/{n_txns}t/{n_reads}r/"
            f"{n_writes}w{tag}]")
    return _fault_seamed(fn, f"sharded_packed[{cap}c]")


@functools.lru_cache(maxsize=None)
def make_resolve_packed_fn(cap: int, n_txns: int, n_reads: int,
                           n_writes: int, n_words: int,
                           attribute: bool = True):
    """Profiled, fault-seamed packed entry for one shape bucket:
    fn(HK, HV, buf, out=None) -> (HK', HV', count, conflict, read_hit)."""
    def fn(hk, hv, buf, out=None):
        return resolve_step_packed(hk, hv, buf, n_txns, n_reads, n_writes,
                                   attribute=attribute, out=out)

    tag = "" if attribute else "/noattr"
    fn = profile_kernel(
        fn,
        f"resolve_packed[{cap}c/{n_txns}t/{n_reads}r/{n_writes}w{tag}]")
    return _fault_seamed(fn, f"resolve_packed[{cap}c]")


def _fault_seamed(fn, where: str):
    """Device-fault seam at kernel launch (the `submit` point): an
    injected fault models the device rejecting the launch, and a lost
    device (a CUDA error PyTorch raises, memory exhausted) is converted
    to the same DeviceFaultError — either way the history buffers are
    in an unknown state. An error the kernel itself reports
    (`CudaKernelError`) escapes unconverted."""
    from .fault_injection import convert_device_errors, g_device_faults

    def call(*args, **kwargs):
        g_device_faults.check("submit", where)
        with convert_device_errors("submit", where):
            return fn(*args, **kwargs)

    return call


# ---------------------------------------------------------------------------
# K4: version-window upkeep (csrc/window.cu)
# ---------------------------------------------------------------------------

REBASE, RESET, JUMP_FIXUP, JUMP_FIXUP_LARGE = range(4)


def window_upkeep_plain(hv, mode: int, a: int = 0, b: int = 0,
                        c: int = 0) -> torch.Tensor:
    v = hv.to(torch.int64)
    if mode == REBASE:
        r = torch.clamp(v, min=VDEAD + a) - a
    elif mode == RESET:
        r = torch.full_like(v, VDEAD)
    elif mode == JUMP_FIXUP:
        r = torch.where(v == a, b, torch.clamp(v, min=VDEAD + c) - c)
    elif mode == JUMP_FIXUP_LARGE:
        r = torch.where(v == a, b, VDEAD)
    else:
        raise ValueError(f"unknown window mode {mode}")
    return r.to(torch.int32)


def window_upkeep(hv, mode: int, a: int = 0, b: int = 0, c: int = 0,
                  out=None) -> torch.Tensor:
    """K4 on a CUDA tensor, the plain version on a CPU tensor. `out`
    may be `hv` itself (in-place upkeep, as the resolver uses it)."""
    if not _device.is_cuda(hv):
        r = window_upkeep_plain(hv, mode, a, b, c)
        return r if out is None else out.copy_(r)
    from ._build import check, lib
    if hv.dtype != torch.int32 or not hv.is_contiguous():
        raise ValueError("HV must be a contiguous int32 tensor")
    if out is None:
        out = torch.empty_like(hv)
    elif out.shape != hv.shape or out.dtype != torch.int32 \
            or not out.is_contiguous() or out.device != hv.device:
        raise ValueError("out must match HV")
    check(lib().fdb_window_upkeep(hv.data_ptr(), out.data_ptr(), hv.numel(),
                                  int(mode), int(a), int(b), int(c),
                                  _device.stream_handle(hv.device)),
          "window_upkeep")
    launches["window_upkeep"] += 1
    return out


def rebase(hv, delta: int, out=None):
    """Shift stored version offsets down by delta (overflow-safe clamp)."""
    return window_upkeep(hv, REBASE, a=delta, out=out)


def reset(hv, out=None):
    """Rebase for deltas beyond int32: every stored version is dead."""
    return window_upkeep(hv, RESET, out=out)


def jump_fixup(hv, placeholder: int, commit_off: int, delta: int, out=None):
    """After a version jump: placeholder entries become the commit
    offset under the new base; everything else shifts (saturating)."""
    return window_upkeep(hv, JUMP_FIXUP, a=placeholder, b=commit_off,
                         c=delta, out=out)


def jump_fixup_large(hv, placeholder: int, commit_off: int, out=None):
    """Jump fixup when the base shift exceeds int32: placeholder entries
    get the commit offset, everything else is dead."""
    return window_upkeep(hv, JUMP_FIXUP_LARGE, a=placeholder, b=commit_off,
                         out=out)
