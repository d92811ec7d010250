#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--trace]

Run from the root of a checkout on a host with a CUDA card and the CUDA
toolkit. It builds the port's kernels from `foundationdb_tpu_torch/csrc`,
holds each of them bit-exact against its plain PyTorch version at edge
shapes and at the deployment's shapes, then drives the interval
conflict resolver through `create_conflict_set("cuda")` at the
deployment scale of the repo's interval streamed cell: 16-byte keys,
one point read and one point write per transaction, 16,384 transactions
per batch over 4,000,000 uniform keys, a 5,000,000-version MVCC window
at 250,000 versions per batch, and a 2^20-row history. The stream
starts just below version 2^30, so the resolver re-bases its int32
version window mid-run. The same batches go through the port on the
CPU (the kernels' plain versions) and the verdicts, per-batch conflict
counts and final history must agree. Each path's timed window runs
four times on a fresh resolver; in two of those runs CUDA events
bracket each batch's device work, which gives the device's busy share
of the wall time without a profiler. `--trace` adds a profiler window
over the streamed path: each kernel's device time per batch.

The last line of standard output is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`;
the line before it holds each kernel's launches, times and bound. Any
failure exits non-zero before that line is printed. Without a CUDA
device, or outside a checkout, it exits 2.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

KEY_BYTES = 16
N_WORDS = KEY_BYTES // 4
N_TXNS = 16_384
KEYSPACE = 4_000_000
MWTLV = 5_000_000
VERSION_STEP = 250_000
CAPACITY = 1 << 20
WARMUP = 3
TIMED = 96                                     # ~0.15 s per timed window
FIRST_VERSION = (1 << 30) - 8 * VERSION_STEP   # crosses 2^30: one re-base
PIPELINE_DEPTH = 4
SPANS = (False, True, True, False)   # per timed window: CUDA-event spans
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM (data sheet)
SEED = 20260729


def make_batch(rng, n_txns, keyspace, version):
    """Pre-encoded arrays for one batch: 16-byte big-endian point keys;
    each transaction reads one key and writes one key, reading at the
    previous batch's version."""
    rk = rng.integers(0, keyspace, size=n_txns, dtype=np.int64)
    wk = rng.integers(0, keyspace, size=n_txns, dtype=np.int64)

    def enc(idx, end):
        k = np.zeros((idx.shape[0], N_WORDS + 1), np.uint32)
        # the low words carry the id; the end key is key + b"\x00",
        # the same words with length 17
        k[:, N_WORDS - 2] = (idx >> 32).astype(np.uint32)
        k[:, N_WORDS - 1] = (idx & 0xFFFFFFFF).astype(np.uint32)
        k[:, N_WORDS] = KEY_BYTES + 1 if end else KEY_BYTES
        return k

    snapshots = np.full(n_txns, version - VERSION_STEP, np.int64)
    has_reads = np.ones(n_txns, bool)
    ids = np.arange(n_txns, dtype=np.int32)
    return (snapshots, has_reads, enc(rk, False), enc(rk, True), ids,
            enc(wk, False), enc(wk, True), ids.copy())


def card_tag() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warm: int = 2) -> float:
    """Median device time of one call, by CUDA events around each."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sectors_touched(lo, hi, n, elem_bytes=4, sector=32) -> int:
    """Distinct 32-byte sectors of an n-element array that the non-empty
    ranges [lo, hi) cover: the least the array's reads must move."""
    lo = np.clip(np.asarray(lo, np.int64), 0, n - 1)
    hi = np.asarray(hi, np.int64)
    keep = hi > np.asarray(lo)
    per = sector // elem_bytes
    first = lo[keep] // per
    last = np.clip(hi[keep] - 1, 0, n - 1) // per
    diff = np.zeros(-(-n // per) + 1, np.int64)
    np.add.at(diff, first, 1)
    np.add.at(diff, last + 1, -1)
    return int((np.cumsum(diff)[:-1] > 0).sum())


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over every output (0 = bit-exact)."""
    import torch
    err = 0
    for g, w in zip(got, want):
        if (g is None) != (w is None):
            raise AssertionError("kernel and plain disagree on outputs")
        if g is None:
            continue
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        d = (g.cpu().to(torch.int64) - w.cpu().to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def expect_exact(what, got, want) -> int:
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"{what}: kernel differs from plain by {err}")
    return err


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------

def check_edges(dev):
    """Edge shapes: empty ranges, queries above every element, same-
    and cross-block ranges, intra-batch chains, every K4 mode."""
    import torch
    from foundationdb_tpu_torch.ops import conflict_kernel as ck
    from foundationdb_tpu_torch.ops import keys, rmq
    rng = np.random.default_rng(1)
    for n in (1, 2, 16, 1024):
        table = torch.from_numpy(np.sort(rng.integers(-9, 9, n))
                                 .astype(np.int32))
        q = torch.from_numpy(np.concatenate([
            rng.integers(-12, 12, 300), [2**31 - 1, -2**31]])
            .astype(np.int32))
        for side in ("left", "right"):
            expect_exact(f"K1 edge n={n}", [keys.searchsorted_i32(
                table.to(dev), q.to(dev), side)],
                [keys.searchsorted_i32_plain(table, q, side)])
    for n in (128, 256, 8192):
        vals = torch.from_numpy(rng.integers(rmq.VDEAD, 1000, n)
                                .astype(np.int32))
        lo = rng.integers(0, n, 3000)
        hi = np.clip(lo + rng.integers(-3, 300, 3000), 0, n)
        # then: whole, empty, reversed, cross-block, and ranges that
        # overhang either end or lie past it (ends clamp into [0, n-1])
        lo = np.concatenate([lo, [0, 5, 0, 127, 100, n - 3, n + 4, -7]]
                            ).astype(np.int32)
        hi = np.concatenate([hi, [n, 5, 0, min(n, 129), 90, n + 50, n + 9,
                                  3]]).astype(np.int32)
        lo_t, hi_t = torch.from_numpy(lo), torch.from_numpy(hi)
        expect_exact(f"K2 edge n={n}", [rmq.range_max(
            vals.to(dev), lo_t.to(dev), hi_t.to(dev))],
            [rmq.range_max_plain(vals, lo_t, hi_t)])
    hv = torch.from_numpy(rng.integers(rmq.VDEAD, 1 << 30, 4099)
                          .astype(np.int32))
    hv[::7] = ck.REBASE_THRESHOLD
    for mode, args in ((ck.REBASE, (1000, 0, 0)), (ck.RESET, (0, 0, 0)),
                       (ck.JUMP_FIXUP, (ck.REBASE_THRESHOLD, 77, 5000)),
                       (ck.JUMP_FIXUP_LARGE, (ck.REBASE_THRESHOLD, 77, 0))):
        for n in (4099, 4096):
            expect_exact(f"K4 edge mode {mode}", [ck.window_upkeep(
                hv[:n].to(dev), mode, *args)],
                [ck.window_upkeep_plain(hv[:n], mode, *args)])
    # K3: a batch of chains (each transaction reads what the previous
    # one writes, so the fixpoint needs many rounds), pads, tooOld
    cap, T, R, Wr, W = 1024, 32, 64, 64, 2
    hk = np.full((cap, W + 1), 0xFFFFFFFF, np.uint32)
    hk[0] = 0
    hv3 = np.full(cap, rmq.VDEAD, np.int32)
    hv3[0] = 0
    for i in range(1, 100):
        hk[i] = (0, i * 2, 4)
        hv3[i] = int(rng.integers(0, 50))
    rb = np.zeros((R, W + 1), np.uint32)
    re = np.zeros((R, W + 1), np.uint32)
    wb = np.zeros((Wr, W + 1), np.uint32)
    we = np.zeros((Wr, W + 1), np.uint32)
    for t in range(30):
        rb[t] = (0, t, 4)
        re[t] = (0, t, 5)
        wb[t] = (0, t + 1, 4)
        we[t] = (0, t + 1, 5)
    rt = np.full(R, T, np.int32)
    rt[:30] = np.arange(30)
    wt = np.full(Wr, T, np.int32)
    wt[:30] = np.arange(30)
    rv = np.zeros(R, bool)
    rv[:30] = True
    wv = rv[:Wr].copy()
    snap = np.full(T, 60, np.int32)
    snap[0] = 10
    too_old = np.zeros(T, bool)
    too_old[17] = True
    arrays = (snap, too_old, rb, re, rt, rv, wb, we, wt, wv)
    buf = torch.from_numpy(ck.pack_interval_batch(*arrays, 70, 20))
    for attribute in (True, False):
        want = ck.resolve_step_packed(torch.from_numpy(hk),
                                      torch.from_numpy(hv3), buf, T, R, Wr,
                                      attribute=attribute)
        got = ck.resolve_step_packed(
            torch.from_numpy(hk).to(dev), torch.from_numpy(hv3).to(dev),
            buf.to(dev), T, R, Wr, attribute=attribute)
        expect_exact("K3 edge packed", [g.cpu() if g is not None else None
                                        for g in got], want)
        got = ck.resolve_step(
            torch.from_numpy(hk).to(dev), torch.from_numpy(hv3).to(dev),
            *[torch.from_numpy(a).to(dev) for a in arrays], 70, 20,
            attribute=attribute)
        expect_exact("K3 edge unpacked", [g.cpu() if g is not None
                                          else None for g in got], want)
        if int(want[3].sum()) < 3:
            raise AssertionError("edge batch lost its conflict chain")


def measure_kernels(dev, mid, batch, version):
    """Each kernel against its plain version on the card at the
    deployment's shapes, with device times. `mid` is a mid-stream
    history of the main path (HK, HV, base, oldest) and `batch` the
    batch it resolved next, at `version` (commit, new oldest)."""
    import torch
    from foundationdb_tpu_torch.ops import conflict_kernel as ck
    from foundationdb_tpu_torch.ops import keys, rmq
    rng = np.random.default_rng(7)
    out = {}
    hk, hv, base, oldest = mid
    T = R = Wr = N_TXNS
    count = int((hk[:, -1] != 0xFFFFFFFF).to(torch.int64).sum())

    # K1: the resolve step's r_starts search
    table = torch.arange(R, dtype=torch.int32, device=dev)
    q = torch.arange(T + 2, dtype=torch.int32, device=dev)
    got = keys.searchsorted_i32(table, q)
    err = expect_exact("K1", [got], [keys.searchsorted_i32_plain(table, q)])
    out["searchsorted_i32"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: keys.searchsorted_i32(table, q), 50),
        plain_ms=time_ms(lambda: keys.searchsorted_i32_plain(table, q), 5),
        library_ms=time_ms(lambda: torch.searchsorted(table, q), 50),
        bound_ms=4 * (R + 2 * (T + 2)) / HBM_BYTES_PER_S * 1e3)

    # K2: point reads touch one or two intervals of the live history
    lo = torch.from_numpy(rng.integers(0, max(count - 2, 1), R)
                          .astype(np.int32)).to(dev)
    hi = lo + torch.from_numpy(rng.integers(1, 3, R).astype(np.int32)).to(dev)
    got = rmq.range_max(hv, lo, hi)
    err = expect_exact("K2", [got], [rmq.range_max_plain(hv, lo, hi)])
    # bound: the sectors of HV these ranges touch, (lo, hi) read and one
    # answer written per query
    k2_bytes = 32 * sectors_touched(lo.cpu().numpy(), hi.cpu().numpy(),
                                    hv.numel()) + 12 * R
    out["range_max"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: rmq.range_max(hv, lo, hi), 50),
        plain_ms=time_ms(lambda: rmq.range_max_plain(hv, lo, hi), 5),
        library_ms=None,
        bound_ms=k2_bytes / HBM_BYTES_PER_S * 1e3)

    # K3: the packed step the main path ran for `batch`, on the history
    # it ran it on
    snapshots, _has_reads, rb, re, rt, wb, we, wt = batch
    v, o = version
    snap_off = np.clip(snapshots - base, 0, ck.SNAP_CLAMP).astype(np.int32)
    buf_np = ck.pack_interval_batch(
        snap_off, snapshots < oldest, rb, re, rt, np.ones(R, bool), wb, we,
        wt, np.ones(Wr, bool), v - base, max(oldest, o) - base)
    buf = torch.from_numpy(buf_np).to(dev)
    outs = (torch.empty_like(hk), torch.empty_like(hv))
    got = ck.resolve_step_packed(hk, hv, buf, T, R, Wr, attribute=False,
                                 out=outs)
    want = ck.resolve_step_packed(hk.cpu(), hv.cpu(), buf.cpu(), T, R, Wr,
                                  attribute=False)
    err = expect_exact("K3", [g.cpu() if g is not None else None
                              for g in got], want)
    got_u = ck.resolve_step(hk, hv, *ck.interval_unpack(buf, T, R, Wr,
                                                        N_WORDS),
                            attribute=False)
    expect_exact("K3 unpacked", [g.cpu() if g is not None else None
                                 for g in got_u], want)
    # bound: the live history rows read once, the whole padded history
    # written once, the feed read, the flags and the count written
    row_bytes = (N_WORDS + 1) * 4 + 4
    k3_bytes = (count + hk.shape[0]) * row_bytes + buf.numel() * 4 + T + 4
    out["resolve"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ck.resolve_step_packed(
            hk, hv, buf, T, R, Wr, attribute=False, out=outs), 20),
        plain_ms=time_ms(lambda: ck.resolve_step_plain(
            hk, hv, *ck.interval_unpack(buf, T, R, Wr, N_WORDS),
            attribute=False), 3, warm=1),
        library_ms=None,
        bound_ms=k3_bytes / HBM_BYTES_PER_S * 1e3)

    # K4: the re-base mode over the whole version array
    delta = 1_000_000
    hv2 = hv.clone()
    got = ck.window_upkeep(hv2, ck.REBASE, delta)
    err = expect_exact("K4", [got], [ck.window_upkeep_plain(
        hv2, ck.REBASE, delta)])
    for mode, args in ((ck.RESET, (0, 0, 0)),
                       (ck.JUMP_FIXUP, (ck.REBASE_THRESHOLD, 77, delta)),
                       (ck.JUMP_FIXUP_LARGE, (ck.REBASE_THRESHOLD, 77, 0))):
        expect_exact(f"K4 mode {mode}", [ck.window_upkeep(hv2, mode, *args)],
                     [ck.window_upkeep_plain(hv2, mode, *args)])
    out["window_upkeep"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ck.window_upkeep(hv2, ck.REBASE, delta,
                                            out=hv2), 50),
        plain_ms=time_ms(lambda: ck.window_upkeep_plain(hv2, ck.REBASE,
                                                        delta), 10),
        library_ms=None,
        bound_ms=8 * hv.numel() / HBM_BYTES_PER_S * 1e3)
    return out


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def launch_counts() -> dict:
    from foundationdb_tpu_torch.ops import conflict_kernel as ck
    from foundationdb_tpu_torch.ops import keys, rmq
    return {"searchsorted_i32": keys.launches["searchsorted_i32"],
            "range_max": rmq.launches["range_max"],
            "resolve": ck.launches["resolve"],
            "window_upkeep": ck.launches["window_upkeep"]}


def zero_counts() -> None:
    from foundationdb_tpu_torch.ops import conflict_kernel as ck
    from foundationdb_tpu_torch.ops import keys, rmq
    for d in (keys.launches, rmq.launches, ck.launches):
        for k in d:
            d[k] = 0


def versions():
    for i in range(WARMUP + TIMED):
        v = FIRST_VERSION + (i + 1) * VERSION_STEP
        yield v, max(0, v - MWTLV)


def run_streamed(cs, batches, snapshot_at=None, spans=False):
    """resolve_arrays over every batch; the verdict copies are awaited
    only at the end. With `spans`, CUDA events bracket each timed
    batch's device work (`CudaConflictSet.time_device`). Returns
    (conflict arrays, timed seconds, device ms of the timed batches or
    None, snapshot of the history taken after batch `snapshot_at`)."""
    import torch
    results, snap, t0 = [], None, None
    for i, (b, (v, o)) in enumerate(zip(batches, versions())):
        conflict, _too_old = cs.resolve_arrays(*b, commit_version=v,
                                               new_oldest_version=o)
        results.append(conflict)
        if i == snapshot_at:
            snap = (cs._hk.clone(), cs._hv.clone(), cs._base, cs._oldest)
        if i + 1 == WARMUP:
            np.asarray(conflict)          # the device is idle from here
            cs.time_device(spans)
            t0 = time.perf_counter()
    out = [np.asarray(c)[:N_TXNS].copy() for c in results]
    if cs._hk.device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, secs, cs.device_ms() if spans else None, snap


def run_pipelined(cs, batches, spans=False):
    """submit_arrays / drain_arrays with RESOLVE_PIPELINE_DEPTH in
    flight; returns (conflict arrays, timed seconds, device ms or None)."""
    tickets, t0 = [], None
    for i, (b, (v, o)) in enumerate(zip(batches, versions())):
        tickets.append(cs.submit_arrays(*b, commit_version=v,
                                        new_oldest_version=o))
        if i + 1 == WARMUP:
            for t in tickets:
                cs.drain_arrays(t)
            cs.time_device(spans)
            t0 = time.perf_counter()
    out = [cs.drain_arrays(t)[0].copy() for t in tickets]
    secs = time.perf_counter() - t0
    return out, secs, cs.device_ms() if spans else None


def final_state(cs):
    cs._sync_count()
    return cs._hk.cpu(), cs._hv.cpu(), cs._count_hint


def trace_stream(backend, batches, tag) -> None:
    """`--trace`: a torch.profiler window over the streamed main path
    (after 3 untraced warm-up batches). Prints each kernel's share of
    the device time and the device's busy share of the window's wall
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cs = backend(None)
    vs = list(versions())
    for b, (v, o) in zip(batches[:WARMUP], vs):
        cs.resolve_arrays(*b, commit_version=v, new_oldest_version=o)
    torch.cuda.synchronize()
    window = batches[WARMUP:WARMUP + 6]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = [cs.resolve_arrays(*b, commit_version=v,
                                 new_oldest_version=o)[0]
               for b, (v, o) in zip(window, vs[WARMUP:])]
        np.asarray(out[-1])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(getattr(e, "self_device_time_total", 0.0), e.count, e.key)
            for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    rows = sorted([r for r in rows if r[0] > 0], reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"[{tag}] trace: {len(window)} batches, wall {wall_us:.1f} us, "
          f"device busy under the profiler {busy:.1f} us "
          f"({100 * busy / wall_us:.1f}%)",
          flush=True)
    for us, n, name in rows[:16]:
        print(f"[{tag}] trace: {us / len(window):10.1f} us/batch "
              f"{n / len(window):6.1f} calls/batch  {name[:90]}",
              flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "foundationdb_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from foundationdb_tpu_torch import device as fdev
    from foundationdb_tpu_torch.flow.knobs import SERVER_KNOBS
    from foundationdb_tpu_torch.models import create_conflict_set
    from foundationdb_tpu_torch.ops import _build

    t_start = time.perf_counter()
    tag = card_tag()
    print(f"card: {tag}", flush=True)
    dev = fdev.resolve(None)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    _build.lib()
    print(f"[{tag}] kernel build: {time.perf_counter() - t0:.3f} s "
          f"({_build.build_info.get('units')} sources, nvcc "
          f"{_build.build_info.get('seconds', 0.0):.3f} s)", flush=True)

    check_edges(dev)
    print(f"[{tag}] edge shapes: K1-K4 bit-exact against plain", flush=True)

    # the deployment's batches, made once from the seed
    rng = np.random.default_rng(SEED)
    batches = [make_batch(rng, N_TXNS, KEYSPACE, v)
               for v, _o in versions()]
    SERVER_KNOBS.set("KERNEL_PROFILE_EVERY", 0)
    SERVER_KNOBS.set("RESOLVE_PIPELINE_DEPTH", PIPELINE_DEPTH)
    mid_at = WARMUP + TIMED // 2

    def backend(device):
        return create_conflict_set("cuda", device=device,
                                   key_bytes=KEY_BYTES, capacity=CAPACITY)

    # the port on the CPU, same batches: what every GPU run must equal
    t0 = time.perf_counter()
    cpu = backend("cpu")
    ref, _secs, _dev, _snap = run_streamed(cpu, batches)
    cpu_state = final_state(cpu)
    del cpu
    print(f"[{tag}] CPU reference run: {time.perf_counter() - t0:.3f} s",
          flush=True)

    def check(name, got, state):
        for i in range(WARMUP):
            if not np.array_equal(got[i], ref[i]):
                raise AssertionError(f"{name}: verdicts of batch {i} differ")
        for i, (g, r) in enumerate(zip(got, ref)):
            if g.shape != (N_TXNS,) or int(g.sum()) != int(r.sum()):
                raise AssertionError(f"{name}: conflict count of batch {i} "
                                     f"{int(g.sum())} != {int(r.sum())}")
        if not (torch.equal(state[0], cpu_state[0])
                and torch.equal(state[1], cpu_state[1])
                and state[2] == cpu_state[2]):
            raise AssertionError(f"{name}: final history differs from CPU")

    # the main path: each path's timed window runs once per entry of
    # SPANS, each time on a fresh resolver; the first run's launch counts
    # are the ones reported
    runs = {"streamed": [], "pipelined": []}    # (seconds, device ms)
    counts, mid, got_a, state_a = {}, None, None, None
    for rep, spans in enumerate(SPANS):
        for path in runs:
            cs = backend(None)
            zero_counts()
            if path == "streamed":
                got, secs, dev_ms, snap = run_streamed(
                    cs, batches, snapshot_at=mid_at if rep == 0 else None,
                    spans=spans)
            else:
                got, secs, dev_ms = run_pipelined(cs, batches, spans=spans)
            c = launch_counts()
            idle = [k for k, n in c.items() if n <= 0]
            if idle:
                raise AssertionError(f"{path} run {rep} never launched {idle}")
            state = final_state(cs)
            check(f"{path} run {rep}", got, state)
            runs[path].append((secs, dev_ms))
            if rep == 0:
                counts[path] = c
                if path == "streamed":
                    mid, got_a, state_a = snap, got, state
                    stats = cs.kernel_stats()
                    if (stats["platform"] != "gpu"
                            or stats["h2d"]["per_batch"] != 1.0):
                        raise AssertionError(
                            f"unexpected kernel_stats: {stats}")
            del cs
    counts_a = counts["streamed"]
    n_conf = [int(g.sum()) for g in got_a]
    print(f"[{tag}] verdicts equal to the CPU run; conflicts per batch "
          f"{n_conf}; final rows {state_a[2]}", flush=True)

    if "--trace" in sys.argv[1:]:
        trace_stream(backend, batches, tag)
    nxt = mid_at + 1
    kern = measure_kernels(dev, mid, batches[nxt], list(versions())[nxt])
    sources = {
        "searchsorted_i32": ("foundationdb_tpu_torch/csrc/searchsorted.cu",
                             "foundationdb_tpu/ops/keys.py:166"),
        "range_max": ("foundationdb_tpu_torch/csrc/range_max.cu",
                      "foundationdb_tpu/ops/rmq.py:69"),
        "resolve": ("foundationdb_tpu_torch/csrc/resolve.cu",
                    "foundationdb_tpu/ops/conflict_kernel.py:138"),
        "window_upkeep": ("foundationdb_tpu_torch/csrc/window.cu",
                          "foundationdb_tpu/ops/conflict_kernel.py:628"),
    }
    n_batches = WARMUP + TIMED
    for label, rs in runs.items():
        per = [secs / TIMED * 1e3 for secs, _ in rs]
        med = statistics.median(per)
        print(f"[{tag}] {label}: {N_TXNS / (med / 1e3):.1f} txn/s, "
              f"{med:.3f} ms/batch (median of {len(rs)} windows of {TIMED} "
              f"batches of {N_TXNS} txns: "
              f"{', '.join(f'{x:.3f}' for x in per)} ms/batch)", flush=True)
        off = [x for x, (_, d) in zip(per, rs) if d is None]
        on = [x for x, (_, d) in zip(per, rs) if d is not None]
        busy = [d / (secs * 1e3) for secs, d in rs if d is not None]
        span_ms = [d / TIMED for _, d in rs if d is not None]
        print(f"[{tag}] {label}: device busy "
              f"{', '.join(f'{100 * b:.1f}%' for b in busy)} of the wall "
              f"({', '.join(f'{d:.3f}' for d in span_ms)} ms/batch in "
              f"CUDA-event "
              f"spans); spans cost "
              f"{statistics.median(on) - statistics.median(off):+.3f} "
              f"ms/batch", flush=True)
    rows = []
    for name, m in kern.items():
        src, rep = sources[name]
        print(f"[{tag}] {name}: {m['ms']:.4f} ms (plain {m['plain_ms']:.3f} "
              f"ms, bound {m['bound_ms']:.4f} ms), "
              f"{counts_a[name] / n_batches:.3f} launches/batch", flush=True)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": counts_a[name],
                     "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                     "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                     "bound_by": "bytes", "library_ms": m["library_ms"]})
    print(f"[{tag}] total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        import traceback
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
