#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--trace | --probe]

Run from the root of a checkout on a host with a CUDA card and the CUDA
toolkit. It builds the port's kernels from `foundationdb_tpu_torch/csrc`,
holds each of them bit-exact against its plain PyTorch version at edge
shapes and at the deployment's shapes, then drives three paths at the
deployment scale of the repo's streamed cells: 16-byte keys, one point
read and one point write per transaction, 16,384 transactions per batch
over 4,000,000 uniform keys, a 5,000,000-version MVCC window at 250,000
versions per batch. The stream starts just below version 2^30, so each
resolver re-bases its int32 version window mid-run.

  - The interval resolver, `create_conflict_set("cuda")`, on a
    2^20-row history. The first CPU_BATCHES batches go through the port
    on the CPU (the kernels' plain versions): the verdicts of the first
    batches, the per-batch conflict counts and the history after that
    prefix must agree, and every run must end on the same history.
  - The point-op resolver, `create_conflict_set("cuda-point")`, on a
    2^19-row state, over the same batches. Its verdicts of the first
    batches, conflict counts and state after batch POINT_CPU_BATCHES
    must equal the port's CPU run of that prefix, and every batch's
    conflict count must equal the interval path's.
  - The key-range sharded resolver, `create_conflict_set("sharded-cuda")`,
    4 shards of 2^18 rows split at the keyspace's quartiles (key ids 1M,
    2M and 3M: the ids sit in the low 8 bytes, so the default
    first-byte splits would send every key to shard 0), over the same
    batches. Every batch's verdicts must equal the interval path's, the
    per-shard state after batch SHARDED_CPU_BATCHES the port's CPU run
    of that prefix, and its history stitched across the shards (the
    stitch `checkpoint()` decodes) the interval history mid-stream and
    at the end.
  - The failover wrapper, `create_resilient_conflict_set` around the
    three CUDA backends: no fault and no failover on a clean run, and
    with a device fault injected at each seam, recovery onto a fresh
    CUDA backend with the clean run's verdicts.
  - The bench chains (`ops/bench_chain.py`, the reference bench's
    device-driven loops): CHAIN_BATCHES steps of K9 (the batch made on
    the card, `jax.random` bit for bit), K5 or K3, and K10 (the tally)
    from `PRNGKey(7)`. The point and interval chains must count the same
    conflicts; the first CHAIN_PREFIX steps' counts, key and state must
    equal the port's CPU run; the timed runs make no sync (they run
    under `torch.cuda.set_sync_debug_mode("error")`).
  - The resolver role, `server/resolver_role.py:Resolver`, on each
    CUDA backend at its defaults (a 32-byte key width, the point
    backend's 8; one shard on one card), on a virtual scheduler and a
    simulated network: the first ROLE_CUT_BATCHES of ROLE_BATCHES
    ResolveRequests of the same traffic (16-byte keys; 8-byte keys with
    the same ids for the point backend), 4 in flight from a proxy
    process. Every reply must equal
    the backend driven directly (verdicts and attributed ranges), the
    first ROLE_CPU_BATCHES the port's CPU role's; no failover; one
    re-base; an in-flight and a cached duplicate answer as the first
    delivery. It prints the role's ms a batch, the host's split of it,
    the device's busy share and each kernel's launches a batch.
  - The commit leg (`foundationdb_tpu_torch.testing.commit_leg`): the
    role phase's cuda traffic, each transaction carrying one SET_VALUE
    of its write key to a versionstamp, resolved by the role on the
    card, the committed mutations logged to a durable TLog and pulled
    by four StorageServers (one a tag, tags split at key ids 1M, 2M
    and 3M) on KeyValueStoreMemory engines, each role on its own
    machine's SimDisk. Every acknowledged write must be read back and
    no conflicted one, at the last version and (sampled) at batch 30's,
    before and after a power loss of every log and storage machine;
    the first COMMIT_CPU_BATCHES batches must equal the same leg with
    the resolver on the CPU; no failover. It prints the leg's ms a
    batch, its parts, the recovery time and the device's busy share.
  - The whole cluster (`foundationdb_tpu_torch.testing.cluster_run`):
    `SimCluster` at FDB 6.1's default role counts (3 proxies, 3 logs,
    1 resolver on the card, 4 storage teams of 2, durable, the memory
    engine), 64 concurrent clients of 100 transactions, each a point
    read and a point write of 16-byte keys over 1,000,000 ids, retried
    until they commit; the worker that holds the resolver is killed at
    half and the next epoch recruits it anew on the card. Every
    acknowledged write must read back equal to a plain dict of the
    outcomes and no failed attempt's; one recovery; no device fault and
    no failover; every kernel counter of the status document above 0.
    Short runs of 64 x 10 transactions on cuda, cuda-point (8-byte
    keys) and sharded-cuda must give the same outcomes and digest on
    the card as at device="cpu". It prints committed txn/s, commit
    latency, resolve batches, launches a batch, the busy share, the
    host's busy time by task and the recovery's time.
  - The simulation tester (`foundationdb_tpu_torch.testing`
    `contention_run` and `region_run`): the reference smoke's
    contention cell, `SimCluster(8383, durable=True,
    conflict_backend="cuda")` with 4 client handles and TESTER_DURATION
    virtual seconds of 150 arrivals a second, each a read-modify-write
    of one of 2 hot keys, with the conflict scheduler, the client
    windows and transaction repair off, then on; then a region
    failover at seed 801: a remote region attached, 40 writes, a
    concurrent writer, a blackout of the primary and `promote()`,
    whose recovery recruits a resolver on the card in the second DC.
    The hot keys' total must lie within the committed and unknown
    counts, the consistency sweep pass (both clusters keep one replica
    of each shard, so on the card it reads every shard but compares no
    replica with another), the off run conflict, every
    write at or below the promoted recovery version read back through
    the promoted region; no device fault, no failover, K1-K3 launched
    in each run (by the promoted resolver after the blackout), and
    every result equal to the same run at device="cpu" (made in a child
    process, `--tester-cpu`, while the kernels build and the edge checks
    run). It prints
    goodput per virtual and per wall second, attempts a commit,
    deferrals and repairs, resolve batches, launches a batch, the busy
    share, the host's busy time by task and the promotion's time.
  - The server process (FDB's fdbserver under fdbmonitor, operated by
    fdbcli): `python -m foundationdb_tpu_torch.tools.monitor` as a child
    with the server's flags (the cluster phase's role counts, a data
    directory, a cluster file), `tools.cli -C <cluster file> --exec
    "configure conflict_backend=cuda"` as another, then 16 concurrent
    clients of 50 transactions over TCP from this process through
    `RemoteCluster` (the cluster phase's transaction shape), a SIGKILL
    of the server and the monitor's restart. Every acknowledged write
    must read back after the restart; the status document must show
    the resolver on `cuda` on the card, no failover, and K1-K3 launched
    once a resolve batch, growing again after the restart; no child may
    build the kernels again. It prints committed txn a wall second,
    commit latency, conflicts, launches a batch, the kernels' busy share
    and the seconds from the kill to the first commit.
  - The resolver role in its own OS process (`tools.rolehost`, FDB's
    one fdbserver process a recruited role), in three parts. (a) One
    resolver host at the default device, recruited over TCP on `cuda`
    and sent the role phase's first ROLE_HOST_BATCHES ResolveRequests:
    every reply must equal the in-process `cuda` role's (kept from the
    role phase); the host checkpoints, is sent SIGKILL after request
    8, respawns on its pinned port, restores the checkpoint onto the
    card and replays its journal; the resend of request 8 must be the
    byte-identical cached payload; K1-K3 once a resolve batch, K4 once.
    (b) The commit pipeline with two resolver hosts and a tlog host,
    a wall-clock SimCluster on `cuda` recruiting them, and two proxy
    worker processes (`clusterbench --worker`) at 400 arrivals a wall
    second for 8 s; resolver host 0 is killed halfway: every arrival
    must commit, commits resume within CHAOS_RECOVERY_BOUND, every
    acknowledged write reads back. (c) `tools.smoke --faults` and
    `--packed` in this process on the card. It prints the kill to
    ready and to the first commit, the replay count, committed a wall
    second, commit latency and each role host's own launches.
  - The bench entry, `python -m foundationdb_tpu_torch.bench` in `all`
    mode as a subprocess: one JSON line carrying the card's name, every
    cross-check of its modes met, its chains' count equal to this
    script's.

Each path's timed window runs four times on a fresh resolver; in two of
those runs CUDA events bracket each batch's device work, which gives
the device's busy share of the wall time without a profiler. `--trace`
adds a profiler window over each streamed path: each kernel's device
time per batch. Every run also traces K4 in each mode at each path's
version array with L2 warm and cold, and a window over each chain's
steps (each kernel's device time and the launches a step). `--probe`
builds the kernels and runs only those two: copied into another
checkout of the port, it measures that checkout's code the same way.

The last line of standard output is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`;
the line before it holds each kernel's launches, times and bound. Any
failure exits non-zero before that line is printed. Without a CUDA
device, or outside a checkout, it exits 2.
"""

from __future__ import annotations

import gc
import atexit
import json
import os
import pickle
import queue
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
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
POINT_CAPACITY = 1 << 19                       # next_pow2(22 * N_TXNS + 2)
WARMUP = 3
TIMED = 384                 # 0.3-0.5 s per timed window: 96-batch point
#                             windows (~0.1 s) spread +-30% with host noise
CPU_BATCHES = WARMUP + 19   # the interval path's CPU comparison: past the
                            # re-base at batch 8 and the first GC of the
                            # 20-batch window (~30-45 s)
POINT_CPU_BATCHES = 30                         # GC has pruned for 10
FIRST_VERSION = (1 << 30) - 8 * VERSION_STEP   # crosses 2^30: one re-base
LAST = WARMUP + TIMED - 1
PIPELINE_DEPTH = 4
FO_BATCHES, FO_TXNS, FO_KEYS = 30, 100, 2000   # the failover phase
FO_FAULT_AT = (5, 13, 22)
FO_SPLITS = [b"0000500", b"0001000", b"0001500"]   # inside b"%07d" keys
N_SHARDS = 4
SHARD_CAPACITY = 1 << 18      # per shard: ~650K live rows split 4 ways
# the key id sits in the low 8 bytes (make_batch), so the first byte is
# always 0: the splits are ids 1M, 2M and 3M, the keyspace's quartiles
SPLIT_IDS = [i * KEYSPACE // N_SHARDS for i in range(1, N_SHARDS)]
SHARD_SPLITS = [bytes(8) + (i * KEYSPACE // N_SHARDS).to_bytes(8, "big")
                for i in range(1, N_SHARDS)]
SHARDED_CPU_BATCHES = WARMUP  # the sharded path's CPU comparison (~10-30
                              # s); its re-base at batch 8 is held to the
                              # interval path's, itself held to the CPU
                              # past it, by the stitched history
SPANS = (False, True, True, False)   # per timed window: CUDA-event spans
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM (data sheet)
# int32 operations outside the tensor cores: 132 SMs x 64 INT32 lanes at
# the 1.98 GHz boost clock (H100 SXM data sheet, Hopper white paper)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
THREEFRY_OPS = 77      # 20 rounds x (add, rotate, xor), 5 injections x 3, 2
CHAIN_BATCHES = 100    # the reference bench's FDBTPU_BENCH_BATCHES
CHAIN_PREFIX = 8       # the chains' CPU comparison
CHAIN_REPEATS = 3
TALLY_EDGES = (1, 15, 17, 16_383, 16_385)   # K10's edge lengths
CHAIN_PROBE_STEPS = 30   # the traced window over each chain's steps
LEAD_IN = 3   # calls a profiler window makes before those it must catch
# K4 at the version arrays of the three paths, and the write between
# calls that leaves L2 (50 MB) cold
WINDOW_SHAPES = (("interval", (CAPACITY,)), ("point", (POINT_CAPACITY,)),
                 ("sharded", (N_SHARDS, SHARD_CAPACITY)))
L2_FLUSH_BYTES = 128 << 20
ENTRY_BATCHES = 100    # the bench entry phase's FDBTPU_BENCH_BATCHES
ROLE_BATCHES = 32      # the role traffic's ResolveRequests (the leg's)
ROLE_CUT_BATCHES = 16  # each backend's role run (cut for the time)
ROLE_HOST_BATCHES = 16  # the role-host phase's requests (the role's first)
ROLE_CPU_BATCHES = 4   # the first replies, held to the CPU role's
ROLE_DUP_AT = 12       # batch whose successor's two copies wait on it
ROLE_POINT_KEY_BYTES = 8   # the point backend's default key width
COMMIT_READ_AT = 30    # the commit leg's older point reads: batch 30's
COMMIT_SAMPLE = 4096   # version, inside the storage's MVCC window
COMMIT_CPU_BATCHES = 4   # the leg's prefix held to the CPU leg
CLUSTER_CLIENTS = 64     # the cluster phase: concurrent clients, each
CLUSTER_TXNS = 100       # with this many transactions (the kill at half)
CLUSTER_SHORT_TXNS = 10  # a client's transactions in the short runs
CLUSTER_IDS = 1_000_000  # ids the keys are drawn from, uniform
TESTER_DURATION = 4.0    # the contention cell's virtual seconds
TESTER_KERNELS = ("searchsorted_i32", "range_max", "resolve")
# the backends of the short runs, the kernels each must launch there
# and its key width (the point backend's is 8 bytes)
CLUSTER_BACKENDS = (
    ("cuda", ("searchsorted_i32", "range_max", "resolve"), 16),
    ("cuda-point", ("searchsorted_i32", "point_resolve",
                    "searchsorted_rows"), 8),
    ("sharded-cuda", ("searchsorted_i32", "range_max", "shard_clip",
                      "resolve_sharded"), 16))
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


def _device_us(event) -> float:
    """A profiler row's own device time (the attribute's name moved
    between PyTorch releases)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def traced_window(fn, reps: int, between=None, exclude=()):
    """One torch.profiler window over `reps` calls of `fn` (and a call
    of `between` after each, when given): {kernel name: [launches,
    device us]} of every CUDA kernel, copy and memset recorded, less
    those named in `exclude`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
            if between is not None:
                between()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        if e.key in exclude:
            continue
        row = out.setdefault(e.key, [0, 0.0])
        row[0] += int(e.count)
        row[1] += _device_us(e)
    return out


def traced_calls(fn, reps: int = 50, kernels: int = 1, tries: int = 5,
                 between=None, exclude=()):
    """One call of `fn` by torch.profiler: {kernel name: (launches a
    call, device us a launch)}, from a window of LEAD_IN + `reps` calls.
    A launch's time is its kernel's recorded device time over its
    recorded launches. The profiler can miss a window's first launches
    (the lead-in calls absorb that) and at times many more: a window in
    which some kernel was recorded fewer than `reps` times a call, or
    the call's kernels add up to fewer than `kernels` launches, is taken
    again; None if every try was."""
    import torch
    fn()
    torch.cuda.synchronize()
    calls = LEAD_IN + reps
    for _ in range(tries):
        rows = traced_window(fn, calls, between, exclude)
        out = {name: (max(1, round(n / calls)), us / n)
               for name, (n, us) in rows.items() if n}
        if out and sum(m for m, _us in out.values()) >= kernels and all(
                rows[name][0] >= m * reps for name, (m, _us) in out.items()):
            return out
    return None


def traced_ms(fn, kernels: int = 1, reps: int = 50, tries: int = 5,
              between=None, exclude=()):
    """Device time of one call by torch.profiler, in ms: each kernel,
    copy and memset a call launches (less those named in `exclude`), at
    its recorded device time over its recorded launch count, times its
    launches a call (`traced_calls`); None if no window caught every
    call."""
    calls = traced_calls(fn, reps, kernels, tries, between, exclude)
    if calls is None:
        return None
    return sum(m * us for m, us in calls.values()) / 1e3


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def host_profile(tag, label, fn, calls: int = 2000, top: int = 10) -> float:
    """cProfile of `calls` back-to-back calls of `fn` (launches only:
    the card keeps up, so this is the host's own time); prints the top
    entries by own time and returns the host us per call."""
    import cProfile
    import pstats
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    per_call = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:top]
    print(f"[{tag}] {label} host profile: {per_call:.2f} us a call "
          f"unprofiled; own time per call by function:", flush=True)
    for (file, line, name), (_cc, nc, tt, _ct, _callers) in rows:
        print(f"[{tag}]   {tt / calls * 1e6:8.2f} us  {nc / calls:5.1f}x  "
              f"{os.path.basename(file)}:{line} {name}", flush=True)
    return per_call


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


def probe_sectors(table, queries, sector=32) -> int:
    """Distinct 32-byte sectors of `table` ([cap, W+1] uint32 rows) that
    the row search's probes read for these queries (side right): the
    least the table's reads must move."""
    cap, width = table.shape
    t = table.astype(np.int64)
    q = queries.astype(np.int64)
    pos = np.zeros(q.shape[0], np.int64)
    probed = []
    step = cap >> 1
    while step:
        idx = pos + step - 1
        probed.append(idx)
        probe = t[idx]
        le = np.ones(q.shape[0], bool)
        decided = np.zeros(q.shape[0], bool)
        for w in range(width):
            lt = (probe[:, w] < q[:, w]) & ~decided
            gt = (probe[:, w] > q[:, w]) & ~decided
            le[gt] = False
            decided |= lt | gt
        pos += step * le
        step >>= 1
    if not probed:
        return 0
    start = np.unique(np.concatenate(probed)) * (width * 4)
    secs = [(start + off) // sector for off in range(0, width * 4, sector)]
    secs.append((start + width * 4 - 1) // sector)
    return int(np.unique(np.concatenate(secs)).size)


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------

def edge_batch(rng):
    """K3's edge batch: a batch of chains (each transaction reads what
    the previous one writes, so the fixpoint needs many rounds), pads
    and a tooOld transaction, on a 1024-row history of 99 keys.
    Returns (T, R, Wr, HK, HV, the batch's 10 arrays)."""
    from foundationdb_tpu_torch.ops import rmq
    cap, T, R, Wr, W = 1024, 32, 64, 64, 2
    hk = np.full((cap, W + 1), 0xFFFFFFFF, np.uint32)
    hk[0] = 0
    hv = np.full(cap, rmq.VDEAD, np.int32)
    hv[0] = 0
    for i in range(1, 100):
        hk[i] = (0, i * 2, 4)
        hv[i] = int(rng.integers(0, 50))
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
    return T, R, Wr, hk, hv, (snap, too_old, rb, re, rt, rv, wb, we, wt, wv)


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
    for n_arrays, n in ((1, 128), (1, 256), (1, 8192), (4, 128),
                        (4, 8192), (4, 1 << 15)):
        vals = torch.from_numpy(rng.integers(rmq.VDEAD, 1000, (n_arrays, n))
                                .astype(np.int32))
        lo = rng.integers(0, n, (n_arrays, 3000))
        hi = np.clip(lo + rng.integers(-3, 300, (n_arrays, 3000)), 0, n)
        # then: whole, empty, reversed, cross-block, over 129 blocks and
        # more, and ranges that overhang either end or lie past it (ends
        # clamp into [0, n-1])
        edge_lo = [0, 5, 0, 127, 100, n - 3, n + 4, -7, 3, 64]
        edge_hi = [n, 5, 0, min(n, 129), 90, n + 50, n + 9, 3,
                   min(n, 129 * rmq.BLOCK + 5), n - 1]
        lo = np.concatenate([lo, np.tile(edge_lo, (n_arrays, 1))], axis=1)
        hi = np.concatenate([hi, np.tile(edge_hi, (n_arrays, 1))], axis=1)
        lo_t = torch.from_numpy(lo.astype(np.int32))
        hi_t = torch.from_numpy(hi.astype(np.int32))
        if n_arrays == 1:
            vals, lo_t, hi_t = vals[0], lo_t[0], hi_t[0]
        expect_exact(f"K2 edge S={n_arrays} n={n}", [rmq.range_max(
            vals.to(dev), lo_t.to(dev), hi_t.to(dev))],
            [rmq.range_max_plain(vals, lo_t, hi_t)])
    hv = torch.from_numpy(rng.integers(rmq.VDEAD, 1 << 30, 4099)
                          .astype(np.int32))
    hv[::7] = ck.REBASE_THRESHOLD
    for mode, args in window_modes(5000):
        # whole int4s, a scalar tail, a view 4 bytes off alignment (all
        # scalar), and a few elements; new outputs and in place
        for lo, n in ((0, 4099), (0, 4096), (1, 4099), (0, 3)):
            want = ck.window_upkeep_plain(hv[lo:n], mode, *args)
            expect_exact(f"K4 edge mode {mode} [{lo}:{n}]", [
                ck.window_upkeep(hv.to(dev)[lo:n], mode, *args)], [want])
            work = hv.to(dev, copy=True)[lo:n]
            got = ck.window_upkeep(work, mode, *args, out=work)
            if got.data_ptr() != work.data_ptr():
                raise AssertionError("K4 in place returned another tensor")
            expect_exact(f"K4 edge mode {mode} [{lo}:{n}] in place", [work],
                         [want])
    T, R, Wr, hk, hv3, arrays = edge_batch(rng)
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


def check_resolve_edges(dev, tag):
    """K3 against its plain version on the card, on the adversarial
    batches of `foundationdb_tpu_torch.testing` at the interval cell's
    shape (a 2^20-row history, 16,384 transactions, reads and writes,
    16-byte keys), packed with attribution on and off and unpacked:
    every output equal."""
    from foundationdb_tpu_torch import testing as tg
    from foundationdb_tpu_torch.ops import conflict_kernel as ck
    import torch
    t0 = time.perf_counter()
    conflicts = []
    for i, kind in enumerate(tg.KINDS):
        hk, hv, arrays = tg.adversarial_batch(
            np.random.default_rng(SEED + i), kind, CAPACITY, N_TXNS, N_TXNS,
            N_TXNS, N_WORDS)
        buf = torch.from_numpy(ck.pack_interval_batch(
            *arrays, tg.COMMIT, tg.OLDEST)).to(dev)
        hk, hv = torch.from_numpy(hk).to(dev), torch.from_numpy(hv).to(dev)
        unpacked = ck.interval_unpack(buf, N_TXNS, N_TXNS, N_TXNS, N_WORDS)
        for attribute in (True, False):
            want = ck.resolve_step_plain(hk, hv, *unpacked,
                                         attribute=attribute)
            got = ck.resolve_step_packed(hk, hv, buf, N_TXNS, N_TXNS,
                                         N_TXNS, attribute=attribute)
            expect_exact(f"K3 edge {kind} attribute={attribute}", got, want)
        # `want` is the attribute-free step's, the last of the loop
        got = ck.resolve_step(hk, hv, *unpacked, attribute=False)
        expect_exact(f"K3 edge {kind} unpacked", got, want)
        conflicts.append(int(want[3].sum()))
    print(f"[{tag}] K3 edge batches at {CAPACITY} rows x {N_TXNS} txns "
          f"({', '.join(tg.KINDS)}): bit-exact against plain, packed with "
          f"attribution on and off and unpacked; conflicts {conflicts} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def check_sharded_kinds(dev, tag):
    """K8 against its plain version on the card, on every adversarial
    batch kind of `foundationdb_tpu_torch.testing` (the shard-edge kind
    among them) at the sharded cell's shape: 4 shards of 2^18 rows split
    at key ids 1M, 2M and 3M (the kind's keys spread over them, its
    history sharded there), 16,384 transactions, reads and writes,
    16-byte keys; packed with attribution on and off and unpacked, from
    the fresh sharded state and one step later: every output equal."""
    from foundationdb_tpu_torch import testing as tg
    from foundationdb_tpu_torch.ops import conflict_kernel as ck
    import torch
    t0 = time.perf_counter()
    T = N_TXNS
    lows, highs = (torch.from_numpy(b).to(dev)
                   for b in tg.shard_bounds(SPLIT_IDS, N_WORDS))
    conflicts = []
    for i, kind in enumerate(tg.KINDS):
        hk, hv, arrays = tg.adversarial_batch(
            np.random.default_rng(SEED + 100 + i), kind, SHARD_CAPACITY, T,
            T, T, N_WORDS, splits=SPLIT_IDS)
        hk, hv = tg.shard_history(hk, hv, *tg.shard_bounds(SPLIT_IDS,
                                                           N_WORDS))
        for attribute in (True, False):
            state = (torch.from_numpy(hk).to(dev),
                     torch.from_numpy(hv).to(dev))
            for step, commit in enumerate((tg.COMMIT, tg.COMMIT + 20)):
                buf = torch.from_numpy(ck.pack_interval_batch(
                    *arrays, commit, tg.OLDEST)).to(dev)
                unpacked = ck.interval_unpack(buf, T, T, T, N_WORDS)
                want = ck.resolve_step_sharded_plain(
                    *state, *unpacked, lows, highs, attribute=attribute)
                name = f"K8 edge {kind} step {step} attribute={attribute}"
                expect_exact(name, ck.resolve_step_sharded_packed(
                    *state, buf, lows, highs, T, T, T, attribute=attribute),
                    want)
                expect_exact(f"{name} unpacked", ck.resolve_step_sharded(
                    *state, *unpacked, lows, highs, attribute=attribute),
                    want)
                state = want[:2]
                if attribute:
                    conflicts.append(int(want[3].sum()))
    print(f"[{tag}] K8 edge batches at {N_SHARDS} x {SHARD_CAPACITY} rows x "
          f"{T} txns ({', '.join(tg.KINDS)}): bit-exact against plain, "
          f"packed with attribution on and off and unpacked, fresh and one "
          f"step on; conflicts {conflicts} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def check_point_kinds(dev, tag):
    """K5 against its plain version on the card, on the point batch
    kinds of `foundationdb_tpu_torch.testing` (every write on one key,
    every write invalid, +inf-key writes, a tiny alphabet) at the point
    cell's shape (a 2^19-row state, 16,384 transactions and reads,
    16-byte keys) with 16,384 writes, one write and 12,289 writes (no
    power of two): packed with attribution on and off and unpacked, from
    the kind's state and one step later: every output equal."""
    from foundationdb_tpu_torch import testing as tg
    from foundationdb_tpu_torch.ops import point_kernel as pk
    import torch
    t0 = time.perf_counter()
    T = R = N_TXNS
    widths = (N_TXNS, 1, 12_289)
    conflicts = []
    for i, kind in enumerate(tg.POINT_KINDS):
        for Wr in widths:
            sk, sv, arrays = tg.point_batch(
                np.random.default_rng(SEED + 200 + i), kind, POINT_CAPACITY,
                T, R, Wr, N_WORDS)
            for attribute in (True, False):
                state = (torch.from_numpy(sk).to(dev),
                         torch.from_numpy(sv).to(dev))
                for step, commit in enumerate((tg.COMMIT, tg.COMMIT + 20)):
                    buf = torch.from_numpy(pk.pack_point_batch(
                        *arrays, commit, tg.OLDEST, 9)).to(dev)
                    unpacked = pk.point_unpack(buf, T, R, Wr, N_WORDS)
                    want = pk.point_resolve_step_plain(
                        *state, *unpacked, attribute=attribute)
                    name = (f"K5 edge {kind} Wr={Wr} step {step} "
                            f"attribute={attribute}")
                    expect_exact(name, pk.point_resolve_step_packed(
                        *state, buf, T, R, Wr, attribute=attribute), want)
                    expect_exact(f"{name} unpacked", pk.point_resolve_step(
                        *state, *unpacked, attribute=attribute), want)
                    state = want[:2]
                    if attribute:
                        conflicts.append(int(want[3].sum()))
    print(f"[{tag}] K5 edge batches at {POINT_CAPACITY} rows x {T} txns, "
          f"Wr in {widths} ({', '.join(tg.POINT_KINDS)}): "
          f"bit-exact against plain, packed with attribution on and off "
          f"and unpacked, from the state and one step on; conflicts "
          f"{conflicts} ({time.perf_counter() - t0:.1f} s)", flush=True)


def profile_k1(dev, tag) -> dict:
    """K1 and `torch.searchsorted` on the resolve step's search (a
    16,384-entry table, 16,386 queries): device time by the profiler,
    and the host's own time per call with its profile by function."""
    import torch
    from foundationdb_tpu_torch.ops import keys
    table = torch.arange(N_TXNS, dtype=torch.int32, device=dev)
    q = torch.arange(N_TXNS + 2, dtype=torch.int32, device=dev)
    return dict(
        traced_ms=traced_ms(lambda: keys.searchsorted_i32(table, q)),
        library_traced_ms=traced_ms(lambda: torch.searchsorted(table, q)),
        host_us=host_profile(tag, "K1 searchsorted_i32",
                             lambda: keys.searchsorted_i32(table, q)),
        library_host_us=host_profile(tag, "torch.searchsorted",
                                     lambda: torch.searchsorted(table, q),
                                     top=5))


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
        traced_ms=traced_ms(lambda: rmq.range_max(hv, lo, hi), kernels=2),
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
    # the unpacked entry (B7): the same step on 12 separate inputs, its
    # flags one byte each
    unpacked = ck.interval_unpack(buf, T, R, Wr, N_WORDS)
    in_bytes = sum(t.numel() * t.element_size() for t in unpacked)
    out["resolve"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ck.resolve_step_packed(
            hk, hv, buf, T, R, Wr, attribute=False, out=outs), 20),
        plain_ms=time_ms(lambda: ck.resolve_step_plain(
            hk, hv, *unpacked, attribute=False), 3, warm=1),
        library_ms=None,
        bound_ms=k3_bytes / HBM_BYTES_PER_S * 1e3,
        unpacked_ms=time_ms(lambda: ck.resolve_step(
            hk, hv, *unpacked, attribute=False, out=outs), 20),
        # 29 kernels and a memset a call; 20 is the least a call launches
        unpacked_traced_ms=traced_ms(lambda: ck.resolve_step(
            hk, hv, *unpacked, attribute=False, out=outs), kernels=20),
        unpacked_bound_ms=((count + hk.shape[0]) * row_bytes + in_bytes
                           + T + 4) / HBM_BYTES_PER_S * 1e3)

    # K4: every mode over the mid-stream version array, in place as the
    # resolver calls it; the re-base (the mode the stream runs) timed
    delta = 1_000_000
    err = 0
    for mode, args in window_modes(delta):
        hv2 = hv.clone()
        want = ck.window_upkeep_plain(hv2, mode, *args)
        ck.window_upkeep(hv2, mode, *args, out=hv2)
        err = max(err, expect_exact(f"K4 mode {mode} in place", [hv2],
                                    [want]))
    hv2 = hv.clone()
    out["window_upkeep"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ck.window_upkeep(hv2, ck.REBASE, delta,
                                            out=hv2), 50),
        plain_ms=time_ms(lambda: ck.window_upkeep_plain(hv2, ck.REBASE,
                                                        delta), 10),
        library_ms=None,
        bound_ms=window_bytes(ck.REBASE, hv.numel()) / HBM_BYTES_PER_S
        * 1e3)
    return out


def window_modes(delta):
    """K4's four modes with the arguments the resolvers give them: a
    re-base by `delta`, the reset, and the two jump fixups (placeholder,
    commit offset, delta)."""
    from foundationdb_tpu_torch.ops import conflict_kernel as ck
    return ((ck.REBASE, (delta, 0, 0)), (ck.RESET, (0, 0, 0)),
            (ck.JUMP_FIXUP, (ck.REBASE_THRESHOLD, 77, delta)),
            (ck.JUMP_FIXUP_LARGE, (ck.REBASE_THRESHOLD, 77, 0)))


def window_bytes(mode, n) -> int:
    """K4's bytes at n elements: each read once and written once; the
    reset (mode 1) reads nothing."""
    return 4 * n if mode == 1 else 8 * n


def measure_window(dev, tag) -> dict:
    """K4 in each mode at each path's version array (WINDOW_SHAPES), in
    place as the resolvers call it: bit-exact against its plain version
    there, then traced with L2 warm (calls back to back) and cold (a
    write of L2_FLUSH_BYTES between calls, not counted); beside the
    reset `Tensor.fill_(VDEAD)` (the library call that computes it) and
    beside the re-base `clamp_min_` + `sub_` (two calls), traced alike.
    Returns {path: {mode: {"warm", "cold", "bound"}, "fill": ...,
    "clamp_sub": ...}} in ms."""
    import torch
    from foundationdb_tpu_torch.ops import conflict_kernel as ck
    rng = np.random.default_rng(4)
    delta = 1_000_000
    flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)

    def cold():
        flush.bitwise_not_()

    # the flush's own kernels, left out of the cold windows
    cold()
    flush_kernels = set(traced_window(cold, 3))
    print(f"[{tag}] K4 L2 flush: {sorted(flush_kernels)}", flush=True)

    def both(fn, kernels=1):
        return (traced_ms(fn, kernels),
                traced_ms(fn, kernels, between=cold, exclude=flush_kernels)
                if flush_kernels else None)

    res = {}
    for path, shape in WINDOW_SHAPES:
        n = int(np.prod(shape))
        hv0 = torch.from_numpy(rng.integers(ck.VDEAD, 1 << 30, n)
                               .astype(np.int32).reshape(shape))
        hv0.view(-1)[::7] = ck.REBASE_THRESHOLD
        row = res[path] = {}
        for mode, args in window_modes(delta):
            work = hv0.to(dev, copy=True)
            ck.window_upkeep(work, mode, *args, out=work)
            expect_exact(f"K4 {path} mode {mode} in place", [work],
                         [ck.window_upkeep_plain(hv0, mode, *args)])
            warm, cold_ms = both(lambda: ck.window_upkeep(
                work, mode, *args, out=work))
            row[mode] = {"warm": warm, "cold": cold_ms,
                         "bound": window_bytes(mode, n) / HBM_BYTES_PER_S
                         * 1e3}
        work = hv0.to(dev, copy=True)
        row["fill"] = both(lambda: work.fill_(ck.VDEAD))
        row["clamp_sub"] = both(lambda: (work.clamp_min_(ck.VDEAD + delta),
                                         work.sub_(delta)), kernels=2)
        for mode in range(4):
            m = row[mode]
            print(f"[{tag}] K4 {path} {tuple(shape)} mode {mode}: traced "
                  f"warm {fmt_ms(m['warm'])}, cold {fmt_ms(m['cold'])}, "
                  f"bound {m['bound']:.6f} ms", flush=True)
        print(f"[{tag}] K4 {path}: fill_(VDEAD) traced warm "
              f"{fmt_ms(row['fill'][0])}, cold {fmt_ms(row['fill'][1])}; "
              f"clamp_min_ + sub_ warm {fmt_ms(row['clamp_sub'][0])}, "
              f"cold {fmt_ms(row['clamp_sub'][1])}", flush=True)
    return res


def empty_range_batch(T, R, Wr, width):
    """Valid empty and inverted ranges, which every shard's clip marks
    invalid: transaction 0 writes [8, 36), the empty [48, 48) and the
    inverted [64, 56); transactions 1-4 read the empty [16, 16), the
    inverted [24, 20), [44, 52) around the empty write and [54, 66)
    across the inverted one. Had the ranges counted as valid, each read
    would overlap one of the writes; as it is, none conflicts."""
    def row(k):
        return (0,) * (width - 2) + (k, 4)
    rb = np.zeros((R, width), np.uint32)
    re = np.zeros((R, width), np.uint32)
    wb = np.zeros((Wr, width), np.uint32)
    we = np.zeros((Wr, width), np.uint32)
    rt = np.full(R, T, np.int32)
    wt = np.full(Wr, T, np.int32)
    rv = np.zeros(R, bool)
    wv = np.zeros(Wr, bool)
    for i, (b, e) in enumerate(((8, 36), (48, 48), (64, 56))):
        wb[i], we[i], wt[i], wv[i] = row(b), row(e), 0, True
    for i, (b, e) in enumerate(((16, 16), (24, 20), (44, 52), (54, 66))):
        rb[i], re[i], rt[i], rv[i] = row(b), row(e), i + 1, True
    snap = np.full(T, 60, np.int32)
    too_old = np.zeros(T, bool)
    return (snap, too_old, rb, re, rt, rv, wb, we, wt, wv)


def check_sharded_edges(dev):
    """K7 and K8 at edge shapes. K7's compare: equal rows, rows that
    differ only in the length word, +inf rows, one row broadcast either
    way. At 1 and 4 shards, K3's chain batch plus one transaction that
    reads and writes across every split (the splits sit on keys the
    chains read and write, so ranges start and end on them): K7's clip
    of its reads and writes, and K8 from the fresh sharded state and
    from the state one step later, attributed and not, packed and
    unpacked; then K8 on a batch of valid empty and inverted ranges."""
    import torch
    from foundationdb_tpu_torch.ops import conflict_kernel as ck
    from foundationdb_tpu_torch.ops import keys, rmq
    rng = np.random.default_rng(4)
    a = rng.integers(0, 3, (999, 3)).astype(np.uint32)
    b = a.copy()
    b[::3, -1] += 1
    b[1::3] = 0xFFFFFFFF
    for x, y in ((a, b), (b, a), (a, b[5]), (a[7], b)):
        x, y = torch.from_numpy(x), torch.from_numpy(y)
        expect_exact("K7 lt_rows edge", [keys.lt_rows(x.to(dev), y.to(dev))],
                     [keys.lt_rows_plain(x, y)])
    T, R, Wr, _hk, _hv, arrays = edge_batch(rng)
    snap, too_old, rb, re, rt, rv, wb, we, wt, wv = (x.copy() for x in arrays)
    rb[30], re[30], rt[30], rv[30] = (0, 0, 0), (0, 99, 4), 30, True
    wb[30], we[30], wt[30], wv[30] = (0, 5, 4), (0, 27, 5), 30, True
    arrays = (snap, too_old, rb, re, rt, rv, wb, we, wt, wv)
    width = rb.shape[1]
    for n_shards in (1, 4):
        lows = np.zeros((n_shards, width), np.uint32)
        for k in range(1, n_shards):
            lows[k] = (0, 8 * k, 4)
        highs = np.full_like(lows, 0xFFFFFFFF)
        highs[:-1] = lows[1:]
        lows, highs = torch.from_numpy(lows), torch.from_numpy(highs)
        bounds = (lows.to(dev), highs.to(dev))
        for rows in ((rb, re, rv), (wb, we, wv)):
            args = [torch.from_numpy(x) for x in rows]
            expect_exact(f"K7 clip edge S={n_shards}", list(
                keys.clip_to_shards(*[x.to(dev) for x in args], *bounds)),
                list(keys.clip_to_shards_plain(*args, lows, highs)))
        hk = np.full((n_shards, 1024, width), 0xFFFFFFFF, np.uint32)
        hv = np.full((n_shards, 1024), rmq.VDEAD, np.int32)
        hk[:, 0], hv[:, 0] = lows.numpy(), 0
        hk, hv = torch.from_numpy(hk), torch.from_numpy(hv)
        for commit in (70, 90):
            buf = torch.from_numpy(ck.pack_interval_batch(*arrays, commit,
                                                          20))
            for attribute in (True, False):
                want = ck.resolve_step_sharded_packed(
                    hk, hv, buf, lows, highs, T, R, Wr, attribute=attribute)
                got = ck.resolve_step_sharded_packed(
                    hk.to(dev), hv.to(dev), buf.to(dev), *bounds, T, R, Wr,
                    attribute=attribute)
                expect_exact(f"K8 edge S={n_shards} packed",
                             [None if g is None else g.cpu() for g in got],
                             want)
                got = ck.resolve_step_sharded(
                    hk.to(dev), hv.to(dev),
                    *[torch.from_numpy(x).to(dev) for x in arrays], commit,
                    20, *bounds, attribute=attribute)
                expect_exact(f"K8 edge S={n_shards} unpacked",
                             [None if g is None else g.cpu() for g in got],
                             want)
            if int(want[3].sum()) < 3:
                raise AssertionError("sharded edge batch lost its chain")
            hk, hv = want[0], want[1]
        empty = empty_range_batch(T, R, Wr, width)
        buf = torch.from_numpy(ck.pack_interval_batch(*empty, 110, 20))
        want = ck.resolve_step_sharded_packed(hk, hv, buf, lows, highs, T, R,
                                              Wr)
        got = ck.resolve_step_sharded_packed(hk.to(dev), hv.to(dev),
                                             buf.to(dev), *bounds, T, R, Wr)
        expect_exact(f"K8 edge S={n_shards} empty ranges",
                     [g.cpu() for g in got], want)
        if bool(want[3].any()) or bool(want[4].any()):
            raise AssertionError("an empty range conflicted in the plain K8")


def measure_sharded_kernels(dev, mid, batch, version, bounds):
    """K2 over the shards, K7 and K8 against their plain versions on the
    card at the sharded path's shapes, with device times. `mid` is a
    mid-stream state of the sharded path (HK[S], HV[S], base, oldest),
    `batch` the batch it resolved next, at `version` (commit, new
    oldest), and `bounds` the shards' (lows, highs) on the card."""
    import torch
    from foundationdb_tpu_torch.ops import conflict_kernel as ck
    from foundationdb_tpu_torch.ops import keys, rmq
    out = {}
    hk, hv, base, oldest = mid
    n_shards, cap, width = hk.shape
    T = R = Wr = N_TXNS
    snapshots, _has_reads, rb, re, rt, wb, we, wt = batch
    v, o = version
    snap_off = np.clip(snapshots - base, 0, ck.SNAP_CLAMP).astype(np.int32)
    buf = torch.from_numpy(ck.pack_interval_batch(
        snap_off, snapshots < oldest, rb, re, rt, np.ones(R, bool), wb, we,
        wt, np.ones(Wr, bool), v - base, max(oldest, o) - base)).to(dev)
    unpacked = ck.interval_unpack(buf, T, R, Wr, N_WORDS)
    cpu_bounds = [b.cpu() for b in bounds]

    # K7: the standalone clip of the batch's reads (K8 runs the same
    # clip fused into its bounds search for the reads, and inside its
    # survivor partition for the writes)
    clip_in = (unpacked[2], unpacked[3], unpacked[5])
    got = keys.clip_to_shards(*clip_in, *bounds)
    err = expect_exact("K7", list(got), list(keys.clip_to_shards_plain(
        *[x.cpu() for x in clip_in], *cpu_bounds)))
    # bound: the rows and flags read once, the bounds, the clipped rows
    # and flags written once
    k7_bytes = (R * (2 * width * 4 + 1) + 2 * n_shards * width * 4
                + n_shards * R * (2 * width * 4 + 1))
    out["shard_clip"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: keys.clip_to_shards(*clip_in, *bounds), 50),
        traced_ms=traced_ms(
            lambda: keys.clip_to_shards(*clip_in, *bounds)),
        plain_ms=time_ms(lambda: keys.clip_to_shards_plain(*clip_in,
                                                           *bounds), 5),
        library_ms=None,
        bound_ms=k7_bytes / HBM_BYTES_PER_S * 1e3)

    # K2 over every shard's HV in one call: point reads in each shard's
    # live rows, R a shard, as the step's external check makes them
    rng = np.random.default_rng(8)
    live = (hk[:, :, -1] != 0xFFFFFFFF).to(torch.int64).sum(1).tolist()
    lo = np.stack([rng.integers(0, max(c - 2, 1), R) for c in live])
    hi = lo + rng.integers(1, 3, (n_shards, R))
    lo_t = torch.from_numpy(lo.astype(np.int32)).to(dev)
    hi_t = torch.from_numpy(hi.astype(np.int32)).to(dev)
    got = rmq.range_max(hv, lo_t, hi_t)
    err = expect_exact("K2 over the shards", [got], [rmq.range_max_plain(
        hv.cpu(), lo_t.cpu(), hi_t.cpu())])
    k2_bytes = sum(32 * sectors_touched(lo[k], hi[k], cap)
                   for k in range(n_shards)) + 12 * n_shards * R
    out["range_max_sharded"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: rmq.range_max(hv, lo_t, hi_t), 50),
        traced_ms=traced_ms(lambda: rmq.range_max(hv, lo_t, hi_t),
                            kernels=2),
        plain_ms=time_ms(lambda: rmq.range_max_plain(hv, lo_t, hi_t), 5),
        bound_ms=k2_bytes / HBM_BYTES_PER_S * 1e3)

    # K8: the packed step the main path ran for `batch`, on its state
    outs = (torch.empty_like(hk), torch.empty_like(hv))
    got = ck.resolve_step_sharded_packed(hk, hv, buf, *bounds, T, R, Wr,
                                         attribute=False, out=outs)
    want = ck.resolve_step_sharded_packed(hk.cpu(), hv.cpu(), buf.cpu(),
                                          *cpu_bounds, T, R, Wr,
                                          attribute=False)
    err = expect_exact("K8", [None if g is None else g.cpu() for g in got],
                       want)
    got = ck.resolve_step_sharded(hk, hv, *unpacked, *bounds, attribute=True)
    want = ck.resolve_step_sharded_plain(hk.cpu(), hv.cpu(),
                                         *[x.cpu() for x in unpacked],
                                         *cpu_bounds, attribute=True)
    expect_exact("K8 unpacked, attributed", [g.cpu() for g in got], want)
    # bound: each shard's real rows read once, the whole [S, cap] state
    # written once, the feed read, the flags and counts written (K8
    # clips on the fly: no clipped range is written)
    rows = int((hk[:, :, -1] != 0xFFFFFFFF).to(torch.int64).sum())
    row_bytes = width * 4 + 4
    k8_bytes = ((rows + n_shards * cap) * row_bytes + buf.numel() * 4
                + T + 4 * n_shards)
    in_bytes = sum(t.numel() * t.element_size() for t in unpacked)
    out["resolve_sharded"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ck.resolve_step_sharded_packed(
            hk, hv, buf, *bounds, T, R, Wr, attribute=False, out=outs), 20),
        plain_ms=time_ms(lambda: ck.resolve_step_sharded_plain(
            hk, hv, *unpacked, *bounds, attribute=False), 3, warm=1),
        library_ms=None,
        bound_ms=k8_bytes / HBM_BYTES_PER_S * 1e3,
        state_rows=rows,
        unpacked_ms=time_ms(lambda: ck.resolve_step_sharded(
            hk, hv, *unpacked, *bounds, attribute=False, out=outs), 20),
        unpacked_bound_ms=((rows + n_shards * cap) * row_bytes + in_bytes
                           + T + 4 * n_shards) / HBM_BYTES_PER_S * 1e3)
    return out


def _point_rows(ids, width, length):
    """[n, width] uint32 point keys: the id in the last key word, the
    length word `length` (ids 0.. sort in id order)."""
    rows = np.zeros((len(ids), width), np.uint32)
    rows[:, width - 2] = np.asarray(ids, np.uint32)
    rows[:, width - 1] = length
    return rows


def check_point_edges(dev):
    """K6: queries equal to a row, between rows, below the first row and
    above the last, with and without a +inf pad row, with the uniform
    sides and a mixed side mask. K5: a state with duplicate keys and rows
    below the window, a read and a write of one key in one transaction, a
    write chain across transactions (a -> b -> c), a tooOld transaction,
    a snapshot below init_off, a full state that overflows cap, with
    attribution on and off, packed and unpacked."""
    import torch
    from foundationdb_tpu_torch.ops import keys
    from foundationdb_tpu_torch.ops import point_kernel as pk
    rng = np.random.default_rng(3)
    W = 2
    for cap in (1, 2, 64, 4096):
        for pad in (False, True):
            ids = np.sort(rng.choice(4 * cap, cap, replace=False)) * 2 + 2
            table = _point_rows(ids, W + 1, 8)
            if pad:
                table[cap - max(1, cap // 4):] = 0xFFFFFFFF
            q = np.concatenate([
                table[rng.integers(0, cap, 64)],                 # equal
                _point_rows(rng.integers(0, 8 * cap + 4, 64) * 2 + 1,
                            W + 1, 8),                           # between
                _point_rows([0, 1], W + 1, 0),                   # below
                _point_rows([9 * cap + 9], W + 1, 8),            # above
                np.full((1, W + 1), 0xFFFFFFFF, np.uint32)])
            t_t, q_t = torch.from_numpy(table), torch.from_numpy(q)
            for side in ("left", "right"):
                expect_exact(f"K6 edge cap={cap} pad={pad} {side}",
                             [keys.searchsorted_rows(t_t.to(dev),
                                                     q_t.to(dev), side)],
                             [keys.searchsorted_rows_plain(t_t, q_t, side)])
            mask = torch.from_numpy(rng.random(q.shape[0]) < 0.5)
            expect_exact(f"K6 edge cap={cap} pad={pad} mixed",
                         [keys.searchsorted_rows_mixed(
                             t_t.to(dev), q_t.to(dev), mask.to(dev))],
                         [keys.searchsorted_rows_mixed_plain(t_t, q_t,
                                                             mask)])
    # tables of long runs of equal rows at caps 2^11, 2^12 and the point
    # cell's 2^19, at widths 1, 5 (the cells' keys) and 127 (the widest
    # the steps take; past the kernel's 8-word row load)
    def rows(ids, width):
        ids = np.asarray(ids, np.uint32)
        return ids[:, None].copy() if width == 1 else _point_rows(
            ids, width, 8)

    for width, caps in ((1, (2048, 4096)), (5, (2048, 4096, 1 << 19)),
                        (127, (64, 128))):
        for cap in caps:
            for pad in (False, True):
                ids = np.sort(rng.integers(0, max(1, cap // 37), cap))
                table = rows(ids * 2 + 2, width)
                if pad:
                    table[cap - cap // 4:] = 0xFFFFFFFF
                q = np.concatenate([
                    table[rng.integers(0, cap, 2000)],            # equal
                    rows(rng.integers(0, cap // 18 + 4, 2000) * 2 + 1,
                         width),                                  # between
                    rows([0, 1], width),                          # below
                    rows([cap + 9], width),                       # above
                    np.full((1, width), 0xFFFFFFFF, np.uint32)])
                t_t, q_t = torch.from_numpy(table), torch.from_numpy(q)
                what = f"K6 edge table width={width} cap={cap} pad={pad}"
                for side in ("left", "right"):
                    expect_exact(f"{what} {side}", [keys.searchsorted_rows(
                        t_t.to(dev), q_t.to(dev), side)],
                        [keys.searchsorted_rows_plain(t_t, q_t, side)])
                mask = torch.from_numpy(rng.random(q.shape[0]) < 0.5)
                expect_exact(f"{what} mixed", [keys.searchsorted_rows_mixed(
                    t_t.to(dev), q_t.to(dev), mask.to(dev))],
                    [keys.searchsorted_rows_mixed_plain(t_t, q_t, mask)])

    cap, T, R, Wr = 64, 16, 32, 32
    commit, oldest, init_off = 70, 20, 25

    def key(i):
        return _point_rows([i], W + 1, 8)[0]

    # state: key 3 three times (newest last), key 5 below the window
    rows = [(3, 10), (3, 30), (3, 50), (5, 5), (7, 40), (9, 60)]
    sk = np.full((cap, W + 1), 0xFFFFFFFF, np.uint32)
    sv = np.full(cap, pk.VMASK, np.int32)
    for i, (k, v) in enumerate(rows):
        sk[i], sv[i] = key(k), v
    full_k = _point_rows(np.arange(cap) * 2 + 100, W + 1, 8)
    full_v = rng.integers(oldest, 60, cap).astype(np.int32)
    # (snapshot, reads, writes, tooOld) per transaction
    txns = [(45, [3], [20], False),      # state row 3 (v 50) > 45
            (60, [21], [21], False),     # own write never hits own read
            (60, [], [30], False),       # a
            (60, [30], [31], False),     # reads a: conflict, b is dead
            (60, [31], [32], False),     # reads dead b: commits, c alive
            (60, [32], [], False),       # reads c: conflict
            (60, [3], [33], True),       # tooOld
            (10, [40], [], False),       # snapshot below init_off
            (10, [], [41], False)]       # write-only: baseline irrelevant
    snap = np.zeros(T, np.int32)
    too_old = np.zeros(T, bool)
    rk = np.zeros((R, W + 1), np.uint32)
    wk = np.zeros((Wr, W + 1), np.uint32)
    rt = np.full(R, T, np.int32)
    wt = np.full(Wr, T, np.int32)
    rv = np.zeros(R, bool)
    wv = np.zeros(Wr, bool)
    nr = nw = 0
    for t, (sn, reads, writes, old) in enumerate(txns):
        snap[t], too_old[t] = sn, old
        for k in reads:
            rk[nr], rt[nr], rv[nr] = key(k), t, True
            nr += 1
        for k in writes:
            wk[nw], wt[nw], wv[nw] = key(k), t, True
            nw += 1
    for name, (state_k, state_v) in (("state", (sk, sv)),
                                     ("full state", (full_k, full_v))):
        arrays = (snap, too_old, rk, rt, rv, wk, wt, wv)
        buf = torch.from_numpy(pk.pack_point_batch(*arrays, commit, oldest,
                                                   init_off))
        for attribute in (True, False):
            want = pk.point_resolve_step_packed(
                torch.from_numpy(state_k), torch.from_numpy(state_v), buf,
                T, R, Wr, attribute=attribute)
            got = pk.point_resolve_step_packed(
                torch.from_numpy(state_k).to(dev),
                torch.from_numpy(state_v).to(dev), buf.to(dev), T, R, Wr,
                attribute=attribute)
            expect_exact(f"K5 edge {name} packed",
                         [None if g is None else g.cpu() for g in got], want)
            got = pk.point_resolve_step(
                torch.from_numpy(state_k).to(dev),
                torch.from_numpy(state_v).to(dev),
                *[torch.from_numpy(a).to(dev) for a in arrays], commit,
                oldest, init_off, attribute=attribute)
            expect_exact(f"K5 edge {name} unpacked",
                         [None if g is None else g.cpu() for g in got], want)
        if name == "state" and want[3][:len(txns)].tolist() != [
                True, False, False, True, False, True, True, True, False]:
            raise AssertionError(f"K5 edge batch lost its cases: {want[3]}")
        if name == "full state" and int(want[2]) <= cap:
            raise AssertionError("K5 edge: the full state did not overflow")


def measure_point_kernels(dev, mid, batch, version):
    """K5 and K6 against their plain versions on the card at the point
    path's shapes, with device times. `mid` is a mid-stream state of the
    point path (SK, SV, base, oldest) and `batch` the batch it resolved
    next, at `version` (commit, new oldest)."""
    import torch
    from foundationdb_tpu_torch.ops import keys
    from foundationdb_tpu_torch.ops import point_kernel as pk
    from foundationdb_tpu_torch.ops.conflict_kernel import SNAP_CLAMP
    out = {}
    sk, sv, base, oldest = mid
    T = R = Wr = N_TXNS
    snapshots, _has_reads, rb, _re, rt, wb, _we, wt = batch
    v, o = version

    # K6: the step's lookup of the batch's read keys in the state
    rk = torch.from_numpy(rb).to(dev)
    got = keys.searchsorted_rows(sk, rk, "right")
    err = expect_exact("K6", [got], [keys.searchsorted_rows_plain(
        sk.cpu(), rk.cpu(), "right")])
    # bound: the state sectors the probes touch, the queries read and
    # one answer written per query
    k6_bytes = (32 * probe_sectors(sk.cpu().numpy(), rb)
                + R * (N_WORDS + 1) * 4 + 4 * R)
    out["searchsorted_rows"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: keys.searchsorted_rows(sk, rk, "right"), 50),
        traced_ms=traced_ms(
            lambda: keys.searchsorted_rows(sk, rk, "right")),
        plain_ms=time_ms(lambda: keys.searchsorted_rows_plain(sk, rk,
                                                              "right"), 5),
        library_ms=None,
        bound_ms=k6_bytes / HBM_BYTES_PER_S * 1e3)

    # K5: the packed step the main path ran for `batch`, on the state it
    # ran it on
    snap_off = np.clip(snapshots - base, 0, SNAP_CLAMP).astype(np.int32)
    init_off = int(np.clip(-base, 0, SNAP_CLAMP + 1))
    buf = torch.from_numpy(pk.pack_point_batch(
        snap_off, snapshots < oldest, rb, rt, np.ones(R, bool), wb, wt,
        np.ones(Wr, bool), v - base, max(oldest, o) - base,
        init_off)).to(dev)
    outs = (torch.empty_like(sk), torch.empty_like(sv))
    got = pk.point_resolve_step_packed(sk, sv, buf, T, R, Wr,
                                       attribute=False, out=outs)
    want = pk.point_resolve_step_packed(sk.cpu(), sv.cpu(), buf.cpu(), T, R,
                                        Wr, attribute=False)
    err = expect_exact("K5", [None if g is None else g.cpu() for g in got],
                       want)
    unpacked = pk.point_unpack(buf, T, R, Wr, N_WORDS)
    got = pk.point_resolve_step(sk, sv, *unpacked, attribute=True)
    want = pk.point_resolve_step_plain(
        sk.cpu(), sv.cpu(), *pk.point_unpack(buf.cpu(), T, R, Wr, N_WORDS),
        attribute=True)
    expect_exact("K5 unpacked, attributed", [g.cpu() for g in got], want)
    # bound: the real state rows read once, the whole padded state
    # written once, the feed read, the flags and the count written
    count = int((sk[:, -1] != 0xFFFFFFFF).to(torch.int64).sum())
    row_bytes = (N_WORDS + 1) * 4 + 4
    k5_bytes = (count + sk.shape[0]) * row_bytes + buf.numel() * 4 + T + 4
    in_bytes = sum(t.numel() * t.element_size() for t in unpacked)
    out["point_resolve"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: pk.point_resolve_step_packed(
            sk, sv, buf, T, R, Wr, attribute=False, out=outs), 20),
        plain_ms=time_ms(lambda: pk.point_resolve_step_plain(
            sk, sv, *unpacked, attribute=False), 3, warm=1),
        library_ms=None,
        bound_ms=k5_bytes / HBM_BYTES_PER_S * 1e3,
        state_rows=count,
        unpacked_ms=time_ms(lambda: pk.point_resolve_step(
            sk, sv, *unpacked, attribute=False, out=outs), 20),
        # 23 kernels and 3 memsets a call; 20 is the least a call launches
        unpacked_traced_ms=traced_ms(lambda: pk.point_resolve_step(
            sk, sv, *unpacked, attribute=False, out=outs), kernels=20),
        unpacked_bound_ms=((count + sk.shape[0]) * row_bytes + in_bytes
                           + T + 4) / HBM_BYTES_PER_S * 1e3)
    return out


def _chain_buffers(dev, slots, interval):
    """K9's outputs for `slots` reads and writes: [rb, re, wb, we]
    (the end rows None on the point chain), snapshots, commit, oldest."""
    import torch
    width = N_WORDS + 1
    rows = [torch.zeros((slots, width), dtype=torch.uint32, device=dev)
            if k in (0, 2) or interval else None for k in range(4)]
    return (rows, torch.zeros(slots, dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev))


def check_chain_edges(dev):
    """K9 and K10 against their plain versions over 8 chained keys from
    a well-formed control block at PRNGKey(7): at 1, 7, 300 and 16,384
    slots, keyspaces 1, 2^16+1, 4,000,000 and 2^31-1, with and without
    end rows, K9 storing whole rows into the fresh buffers on the first
    step and only the id words after; K10 tallies flags taken from the
    step's rows, so they differ step by step, and records each step's
    count. Then K10 alone at the lengths TALLY_EDGES, on flags aligned
    to 16 bytes and one byte off."""
    import torch
    from foundationdb_tpu_torch.ops import bench_chain as bc
    for slots, keyspace in ((1, 1), (7, 2**16 + 1), (7, 2**31 - 1),
                            (300, KEYSPACE), (N_TXNS, KEYSPACE),
                            (N_TXNS, 2**31 - 1)):
        for interval in (False, True):
            runs = []
            for d in ("cpu", dev):
                ctl = bc.chain_ctl(bc.prng_key(7)).to(d)
                rows, snap, commit, oldest = _chain_buffers(d, slots,
                                                            interval)
                per_step = torch.zeros(8, dtype=torch.int32, device=d)
                seen = []
                for step in range(8):
                    bc.chain_gen(ctl, *rows, snap, commit, oldest, keyspace,
                                 whole=step == 0)
                    flags = (rows[0][:, N_WORDS - 1].to(torch.int64)
                             & 1) == 1
                    bc.chain_tally(ctl, flags, slots, per_step)
                    seen.append([t.cpu().clone() for t in
                                 (*rows, snap, commit, oldest, ctl)
                                 if t is not None])
                runs.append((seen, per_step.cpu()))
            for i, (want, got) in enumerate(zip(runs[0][0], runs[1][0])):
                expect_exact(f"K9/K10 edge slots={slots} keyspace="
                             f"{keyspace} step {i}", got, want)
            expect_exact("K10 edge per-step counts", [runs[1][1]],
                         [runs[0][1]])
    # K10 alone around a 16-byte word and around 16,384 flags, on flags
    # that start 16-byte aligned and one byte off (a view into an aligned
    # buffer), with a per_step that holds the step and one too short
    rng = np.random.default_rng(10)
    for n in TALLY_EDGES:
        for offset in (0, 1):
            buf = torch.zeros(n + 32, dtype=torch.bool, device=dev)
            flags = buf[offset:offset + n]
            flags.copy_(torch.from_numpy(rng.random(n) < 0.5))
            if flags.data_ptr() % 16 != offset:
                raise AssertionError("K10 edge: the view is not offset")
            ctl = torch.from_numpy(rng.integers(
                0, 2**32, bc.C_WORDS, dtype=np.uint64).astype(np.uint32))
            ctl[bc.C_STEP] = 3
            for per_len in (8, 3):
                got, want = ctl.to(dev), ctl.clone()
                per_got = torch.full((per_len,), -1, dtype=torch.int32,
                                     device=dev)
                per_want = per_got.cpu()
                bc.chain_tally(got, flags, n, per_got)
                bc.chain_tally(want, flags.cpu(), n, per_want)
                expect_exact(f"K10 edge n={n} offset={offset}",
                             [got, per_got], [want, per_want])


def measure_chain_kernels(dev, ctl0):
    """K9 and K10 against their plain versions at the chains' shapes
    (16,384 read and write slots), from the control block `ctl0` the
    main path left (a key and step counter mid-chain), with device
    times. K9 is timed at the point chain's shape storing the id words
    (as the chains call it), and storing whole rows, and at the interval
    shape (with end rows, id words) beside them; K10 on the flags of a
    resolved batch."""
    import torch
    from foundationdb_tpu_torch.ops import bench_chain as bc
    out = {}
    width = N_WORDS + 1
    got = ctl0.clone()
    rows, snap, commit, oldest = _chain_buffers(dev, N_TXNS, False)
    bc.chain_gen(got, *rows, snap, commit, oldest, KEYSPACE)
    want = ctl0.cpu()
    p_rows, p_snap, p_commit, p_oldest = _chain_buffers("cpu", N_TXNS, False)
    bc.chain_gen(want, *p_rows, p_snap, p_commit, p_oldest, KEYSPACE)
    err = expect_exact("K9", [got, rows[0], rows[2], snap, commit, oldest],
                       [want, p_rows[0], p_rows[2], p_snap, p_commit,
                        p_oldest])
    # the id words alone, over rows that hold the other words already
    got = ctl0.clone()
    for r in rows[0], rows[2]:
        r[:, N_WORDS - 1] = 0
    bc.chain_gen(got, *rows, snap, commit, oldest, KEYSPACE, whole=False)
    err = max(err, expect_exact(
        "K9 id words", [got, rows[0], rows[2], snap, commit, oldest],
        [want, p_rows[0], p_rows[2], p_snap, p_commit, p_oldest]))
    i_rows, i_snap, i_commit, i_oldest = _chain_buffers(dev, N_TXNS, True)
    bc.chain_gen(got, *i_rows, i_snap, i_commit, i_oldest, KEYSPACE)
    # bound: the hashing (two threefry evaluations a slot, three for the
    # next key, kr and kw, and randint's 3 remainders of 4 operations and
    # its product and sum a slot) against the bytes: the id words (whole
    # rows) and snapshots written, the control block read and written
    slots = 2 * N_TXNS
    k9_ops = (2 * slots + 3) * THREEFRY_OPS + 14 * slots
    k9_o = k9_ops / INT32_OPS_PER_S
    k9_bytes = 4 * slots + 4 * N_TXNS + 4 * (1 + 8 + 2 + 6 + 2)
    k9_whole = k9_bytes + (width - 1) * 4 * slots
    k9_b = k9_bytes / HBM_BYTES_PER_S

    def gen(whole=False):
        return lambda: bc.chain_gen(got, *rows, snap, commit, oldest,
                                    KEYSPACE, whole=whole)

    out["chain_gen"] = dict(
        max_abs_err=err,
        ms=time_ms(gen(), 50),
        traced_ms=traced_ms(gen()),
        plain_ms=time_ms(lambda: bc.chain_gen_plain(
            got, *rows, snap, commit, oldest, KEYSPACE), 5),
        library_ms=None,
        bound_ms=max(k9_b, k9_o) * 1e3,
        bound_by="bytes" if k9_b >= k9_o else "operations",
        whole_ms=time_ms(gen(True), 50),
        whole_traced_ms=traced_ms(gen(True)),
        whole_bound_ms=max(k9_whole / HBM_BYTES_PER_S, k9_o) * 1e3,
        interval_ms=time_ms(lambda: bc.chain_gen(
            got, *i_rows, i_snap, i_commit, i_oldest, KEYSPACE,
            whole=False), 50),
        interval_traced_ms=traced_ms(lambda: bc.chain_gen(
            got, *i_rows, i_snap, i_commit, i_oldest, KEYSPACE,
            whole=False)),
        interval_bound_ms=max((k9_bytes + 4 * slots) / HBM_BYTES_PER_S,
                              k9_o) * 1e3)

    flags = rows[0][:, N_WORDS - 1].to(torch.int64) % 97 == 0
    steps = int(ctl0[bc.C_STEP].to(torch.int64)) + 1
    got = ctl0.clone()
    per_got = torch.zeros(steps, dtype=torch.int32, device=dev)
    bc.chain_tally(got, flags, N_TXNS, per_got)
    want = ctl0.cpu()
    per_want = torch.zeros(steps, dtype=torch.int32)
    bc.chain_tally(want, flags.cpu(), N_TXNS, per_want)
    err = expect_exact("K10", [got, per_got], [want, per_want])
    # bound: the flags read once, the control block read (the step,
    # count and next key) and written (those, the key and RK); K10's
    # hashing (8 threefry evaluations) is far below it
    k10_bytes = N_TXNS + 4 * 4 + 4 * 12
    out["chain_tally"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: bc.chain_tally(got, flags, N_TXNS), 50),
        traced_ms=traced_ms(lambda: bc.chain_tally(got, flags, N_TXNS)),
        plain_ms=time_ms(lambda: bc.chain_tally_plain(got, flags, N_TXNS),
                         5),
        library_ms=time_ms(lambda: torch.sum(flags[:N_TXNS]), 50),
        library_traced_ms=traced_ms(lambda: torch.sum(flags[:N_TXNS])),
        bound_ms=k10_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    return out


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

# the kernels each path must launch (K1-K4 on the interval path; K1,
# K4, K5 and K6 on the point path; K1, K2, K4, K7 and K8 on the sharded
# path)
INTERVAL_KERNELS = ("searchsorted_i32", "range_max", "resolve",
                    "window_upkeep")
POINT_KERNELS = ("searchsorted_i32", "window_upkeep", "point_resolve",
                 "searchsorted_rows")
SHARDED_KERNELS = ("searchsorted_i32", "range_max", "window_upkeep",
                   "shard_clip", "resolve_sharded")
# the chains: K9, K5 (with K1 and K6) or K3 (with K1 and K2), K10
CHAIN_KERNELS = ("chain_gen", "point_resolve", "searchsorted_i32",
                 "searchsorted_rows", "resolve", "range_max", "chain_tally")


def launch_counts() -> dict:
    from foundationdb_tpu_torch.ops import bench_chain as bc
    from foundationdb_tpu_torch.ops import conflict_kernel as ck
    from foundationdb_tpu_torch.ops import keys, rmq
    from foundationdb_tpu_torch.ops import point_kernel as pk
    return {"searchsorted_i32": keys.launches["searchsorted_i32"],
            "range_max": rmq.launches["range_max"],
            "resolve": ck.launches["resolve"],
            "window_upkeep": ck.launches["window_upkeep"],
            "point_resolve": pk.launches["point_resolve"],
            "searchsorted_rows": keys.launches["searchsorted_rows"],
            "shard_clip": keys.launches["shard_clip"],
            "resolve_sharded": ck.launches["resolve_sharded"],
            "chain_gen": bc.launches["chain_gen"],
            "chain_tally": bc.launches["chain_tally"]}


def zero_counts() -> None:
    from foundationdb_tpu_torch.ops import bench_chain as bc
    from foundationdb_tpu_torch.ops import conflict_kernel as ck
    from foundationdb_tpu_torch.ops import keys, rmq
    from foundationdb_tpu_torch.ops import point_kernel as pk
    for d in (keys.launches, rmq.launches, ck.launches, pk.launches,
              bc.launches):
        for k in d:
            d[k] = 0


def versions():
    for i in range(WARMUP + TIMED):
        v = FIRST_VERSION + (i + 1) * VERSION_STEP
        yield v, max(0, v - MWTLV)


def run_streamed(cs, batches, snapshot_at=(), spans=False):
    """resolve_arrays over every batch; the verdict copies are awaited
    only at the end. With `spans`, CUDA events bracket each timed
    batch's device work (`CudaConflictSet.time_device`). Returns
    (conflict arrays, timed seconds, device ms of the timed batches or
    None, {i: snapshot of the state taken after batch i} for each i in
    `snapshot_at`, host seconds of each timed call)."""
    import torch
    results, snap, t0, marks = [], {}, None, []
    for i, (b, (v, o)) in enumerate(zip(batches, versions())):
        conflict, _too_old = cs.resolve_arrays(*b, commit_version=v,
                                               new_oldest_version=o)
        if t0 is not None:
            marks.append(time.perf_counter())
        results.append(conflict)
        if i in snapshot_at:
            snap[i] = (cs._hk.clone(), cs._hv.clone(), cs._base, cs._oldest)
        if i + 1 == WARMUP:
            np.asarray(conflict)          # the device is idle from here
            cs.time_device(spans)
            t0 = time.perf_counter()
    out = [np.asarray(c)[:N_TXNS].copy() for c in results]
    if cs._hk.device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return (out, secs, cs.device_ms() if spans else None, snap,
            np.diff([t0] + marks))


def run_pipelined(cs, batches, spans=False):
    """submit_arrays / drain_arrays with RESOLVE_PIPELINE_DEPTH in
    flight; returns (conflict arrays, timed seconds, device ms or None,
    host seconds of each timed submit)."""
    tickets, t0, marks = [], None, []
    for i, (b, (v, o)) in enumerate(zip(batches, versions())):
        tickets.append(cs.submit_arrays(*b, commit_version=v,
                                        new_oldest_version=o))
        if t0 is not None:
            marks.append(time.perf_counter())
        if i + 1 == WARMUP:
            for t in tickets:
                cs.drain_arrays(t)
            cs.time_device(spans)
            t0 = time.perf_counter()
    out = [cs.drain_arrays(t)[0].copy() for t in tickets]
    secs = time.perf_counter() - t0
    return (out, secs, cs.device_ms() if spans else None,
            np.diff([t0] + marks))


def final_state(cs):
    cs._sync_count()
    return cs._hk.cpu(), cs._hv.cpu(), cs._count_hint


def failover_phase(tag) -> None:
    """The failover wrapper around each CUDA backend (the sharded one at
    4 shards split inside the phase's keyspace), as the resolver role
    builds it, over a few thousand point transactions in small
    batches through submit/drain at depth 4: a clean run must see no
    device fault, no failover and stay on the CUDA backend with the
    pure-Python baseline's verdicts; a run with a device fault injected
    at one seam (three times) must recover onto a fresh CUDA backend,
    never fail over to the CPU, and give the clean run's verdicts."""
    from foundationdb_tpu_torch.models import (
        PyConflictSet, ResolverTransaction, create_resilient_conflict_set)
    from foundationdb_tpu_torch.models.cuda_resolver import CudaConflictSet
    from foundationdb_tpu_torch.models.point_resolver import (
        CudaPointConflictSet)
    from foundationdb_tpu_torch.ops.fault_injection import POINTS
    from foundationdb_tpu_torch.ops.fault_injection import g_device_faults
    from foundationdb_tpu_torch.parallel import ShardedCudaConflictSet

    rng = np.random.default_rng(SEED + 1)
    batches, v = [], 1000

    def pts(n):
        return tuple((b"%07d" % k, b"%07d\x00" % k)
                     for k in rng.integers(0, FO_KEYS, n))

    for _ in range(FO_BATCHES):
        v += 10_000
        batches.append(([ResolverTransaction(
            v - int(rng.integers(1, 60_000)), pts(rng.integers(0, 3)),
            pts(rng.integers(0, 3))) for _ in range(FO_TXNS)],
            v, max(0, v - 50_000)))
    py = PyConflictSet()
    want = [py.resolve(b, v, o) for b, v, o in batches]

    def drive(fo, seam=None):
        got, pending = [], []
        for i, (b, v, o) in enumerate(batches):
            if seam is not None and i in FO_FAULT_AT:
                g_device_faults.schedule(seam)
            pending.append(fo.submit(b, v, o))
            if len(pending) >= PIPELINE_DEPTH:
                got.append(fo.drain(pending.pop(0)))
        got.extend(fo.drain(t) for t in pending)
        g_device_faults.clear()
        return got, fo.failover_stats()

    for backend, cls, kw in (
            ("cuda", CudaConflictSet, {}),
            ("cuda-point", CudaPointConflictSet, {}),
            ("sharded-cuda", ShardedCudaConflictSet,
             {"n_shards": N_SHARDS, "split_keys": FO_SPLITS})):
        fo = create_resilient_conflict_set(backend, device=None, **kw)
        got, st = drive(fo)
        if (got != want or st["device_faults"] or st["failovers"]
                or not st["on_primary"] or type(fo.active) is not cls
                or fo.kernel_stats()["platform"] != "gpu"):
            raise AssertionError(f"failover {backend} clean run: {st}")
        recovered = []
        for seam in POINTS:
            fo = create_resilient_conflict_set(backend, device=None, **kw)
            got, st = drive(fo, seam)
            if (got != want or st["device_faults"] < len(FO_FAULT_AT)
                    or st["device_recoveries"] < 1 or st["failovers"]
                    or not st["on_primary"] or type(fo.active) is not cls
                    or fo.kernel_stats()["platform"] != "gpu"):
                raise AssertionError(f"failover {backend} faults at "
                                     f"{seam}: {st}")
            recovered.append(f"{seam} {st['device_recoveries']} "
                             f"recoveries, {st['replayed_batches']} "
                             f"batches replayed")
        conflicts = sum(r.count(0) for r in want)
        print(f"[{tag}] failover {backend}: {FO_BATCHES * FO_TXNS} txns in "
              f"{FO_BATCHES} batches, {conflicts} conflicts, verdicts equal "
              f"to the Python baseline; clean run: 0 faults, 0 failovers; "
              f"faults at {'; '.join(recovered)}; 0 failovers", flush=True)


def chain_phase(tag, dev):
    """The bench chains at the reference bench's shape (16,384 txns,
    keyspace 4,000,000, CHAIN_BATCHES batches from PRNGKey(7); the
    point chain on a 2^19-row state, the interval chain on a 2^20-row
    history). The first CHAIN_PREFIX steps of each must equal the port's
    CPU run (per-step counts, key, state). Then CHAIN_REPEATS timed runs
    of each chain from a fresh state, each under sync-debug "error" (a
    sync in the loop raises), with the launch counts set to 0 just
    before and read just after; both chains must count the same
    conflicts in every run. A last run per chain brackets each step
    with CUDA events (the busy share), then the capacity audit.
    Returns ({kind: numbers}, the timed runs' launch counts, the point
    chain's control block)."""
    import torch
    from foundationdb_tpu_torch.ops import bench_chain as bc
    chains = {kind: bc.BenchChain(kind, N_TXNS, KEYSPACE, device=dev,
                                  record=CHAIN_PREFIX)
              for kind in ("point", "interval")}
    res = {}
    for kind, ch in chains.items():
        t0 = time.perf_counter()
        cpu = bc.BenchChain(kind, N_TXNS, KEYSPACE, device="cpu",
                            record=CHAIN_PREFIX)
        cpu.run(CHAIN_PREFIX)
        cpu_s = time.perf_counter() - t0
        ch.run(CHAIN_PREFIX)
        if ch.step_counts() != cpu.step_counts() or not (
                np.array_equal(ch.key(), cpu.key())
                and torch.equal(ch.state[0].cpu(), cpu.state[0])
                and torch.equal(ch.state[1].cpu(), cpu.state[1])):
            raise AssertionError(
                f"{kind} chain: the first {CHAIN_PREFIX} steps differ from "
                f"the CPU run (counts {ch.step_counts()} vs "
                f"{cpu.step_counts()})")
        res[kind] = {"prefix_counts": cpu.step_counts(),
                     "cpu_ms_per_step": 1e3 * cpu_s / CHAIN_PREFIX,
                     "cap": ch.cap, "runs": []}
        print(f"[{tag}] {kind} chain: the first {CHAIN_PREFIX} steps equal "
              f"the CPU run (counts {cpu.step_counts()}, key, state; CPU "
              f"{cpu_s:.3f} s)", flush=True)
        del cpu
    torch.cuda.synchronize()
    zero_counts()
    for _ in range(CHAIN_REPEATS):
        for kind, ch in chains.items():
            ch.reset()
            torch.cuda.synchronize()
            enq = []
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
            torch.cuda.set_sync_debug_mode("error")
            try:
                start.record()
                t0 = time.perf_counter()
                ch.run(CHAIN_BATCHES, enqueue_s=enq)
                end.record()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            end.synchronize()
            wall = time.perf_counter() - t0
            if torch.cuda.memory_stats()["allocation.all.allocated"] != allocs:
                raise AssertionError(f"the {kind} chain allocated on the "
                                     f"card inside its loop")
            res[kind]["runs"].append((wall, start.elapsed_time(end),
                                      1e3 * float(np.median(enq)),
                                      ch.conflicts(), 1e3 * min(enq)))
    counts = launch_counts()
    idle = [k for k in CHAIN_KERNELS if counts[k] <= 0]
    if idle:
        raise AssertionError(f"the chains never launched {idle}")
    totals = {kind: {r[3] for r in res[kind]["runs"]} for kind in chains}
    if len(totals["point"] | totals["interval"]) != 1:
        raise AssertionError(f"chain conflict totals differ: {totals}")
    # what a step's second launch costs the chain: runs with one more K10
    # a step (onto a spare control block) in turns with plain runs; the
    # most that folding K10 into K9 could save
    spare = bc.chain_ctl(bc.prng_key(7)).to(dev)
    for kind, ch in chains.items():
        pairs = []
        for _ in range(CHAIN_REPEATS):
            walls = []
            for extra in (False, True):
                ch.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(CHAIN_BATCHES):
                    flags = ch.step()
                    if extra:
                        bc.chain_tally(spare, flags, N_TXNS)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            pairs.append(walls)
        res[kind]["extra_launch_us"] = [
            1e6 * (b - a) / CHAIN_BATCHES for a, b in pairs]
        print(f"[{tag}] {kind} chain: one more K10 launch a step costs "
              f"{', '.join(f'{x:+.2f}' for x in res[kind]['extra_launch_us'])}"
              f" us a batch ({CHAIN_REPEATS} pairs of {CHAIN_BATCHES}-batch "
              f"runs, plain then with the launch)", flush=True)
    for kind, ch in chains.items():
        ch.reset()
        torch.cuda.synchronize()
        spans = []
        t0 = time.perf_counter()
        ch.run(CHAIN_BATCHES, spans=spans)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        r = res[kind]
        r["busy"] = sum(a.elapsed_time(b) for a, b in spans) / (wall * 1e3)
        r["audit_rows"] = ch.audit()
        best = min(r["runs"])
        r["ms_per_batch"] = 1e3 * best[0] / CHAIN_BATCHES
        r["device_ms_per_batch"] = best[1] / CHAIN_BATCHES
        r["enqueue_ms_per_step"] = best[2]
        r["enqueue_min_ms"] = best[4]
        r["total"] = best[3]
        print(f"[{tag}] {kind} chain: {N_TXNS * CHAIN_BATCHES / best[0]:.1f} "
              f"txn/s, {r['ms_per_batch']:.4f} ms/batch (best of "
              f"{CHAIN_REPEATS} runs of {CHAIN_BATCHES} batches: "
              f"{', '.join(f'{1e3 * x[0] / CHAIN_BATCHES:.4f}' for x in r['runs'])}"
              f"), CUDA events {r['device_ms_per_batch']:.4f} ms/batch, host "
              f"enqueue {r['enqueue_ms_per_step']:.4f} ms/step median, "
              f"{r['enqueue_min_ms']:.4f} min (a step's launches block "
              f"once the launch queue is full), device busy "
              f"{100 * r['busy']:.1f}% (CUDA-event spans), {r['total']} "
              f"conflicts, no sync and no allocation in the loop, audit "
              f"{r['audit_rows']} rows of {ch.cap}", flush=True)
    print(f"[{tag}] chains: point and interval count {totals['point']} "
          f"conflicts in every run", flush=True)
    return res, counts, chains["point"].ctl.clone()


def chain_probe(dev, tag) -> dict:
    """A traced window over CHAIN_PROBE_STEPS steps of each chain (from
    PRNGKey(7), after 2 warm-up steps; `traced_calls`, which retries a
    window that missed a step's launches): each kernel's launches and
    device time a step, and the launches (kernels, copies and memsets)
    a step; the chain's numbers are not measured when no window caught
    every step, or K9 and K10 once each a step."""
    import torch
    from foundationdb_tpu_torch.ops import bench_chain as bc
    res = {}
    for kind in ("point", "interval"):
        ch = bc.BenchChain(kind, N_TXNS, KEYSPACE, device=dev)
        ch.run(2)
        torch.cuda.synchronize()
        steps = CHAIN_PROBE_STEPS
        calls = traced_calls(ch.step, steps, kernels=2)
        once = calls is not None and [
            sum(m for k, (m, _us) in calls.items() if name in k)
            for name in ("chain_gen", "chain_tally")] == [1, 1]
        if not once:
            print(f"[{tag}] {kind} chain probe: no window caught every "
                  f"step; not measured", flush=True)
            res[kind] = None
            continue
        r = res[kind] = {
            "launches_per_step": sum(m for m, _us in calls.values()),
            "memsets_per_step": sum(m for k, (m, _us) in calls.items()
                                    if "emset" in k),
            "device_us_per_step": sum(m * us for m, us in calls.values()),
            "k9_traced_ms": sum(m * us for k, (m, us) in calls.items()
                                if "chain_gen" in k) / 1e3}
        print(f"[{tag}] {kind} chain probe ({steps} steps traced): "
              f"{r['launches_per_step']} launches a step "
              f"({r['memsets_per_step']} memsets), "
              f"{r['device_us_per_step']:.1f} us of device time a step, "
              f"K9 {1e3 * r['k9_traced_ms']:.2f} us a step", flush=True)
        for k, (m, us) in sorted(calls.items(), key=lambda kv:
                                 -kv[1][0] * kv[1][1]):
            print(f"[{tag}]   {m * us:9.2f} us {m:3d}x  {k[:90]}",
                  flush=True)
    return res


# ---------------------------------------------------------------------------
# the resolver role: ResolveRequests through the sim network
# ---------------------------------------------------------------------------

ROLE_BACKENDS = (("cuda", INTERVAL_KERNELS, ROLE_CUT_BATCHES),
                 ("cuda-point", POINT_KERNELS, ROLE_CUT_BATCHES),
                 ("sharded-cuda", SHARDED_KERNELS, ROLE_CUT_BATCHES))


def role_requests(key_bytes, n=ROLE_BATCHES):
    """The cells' traffic as ResolveRequests: the first `n` of
    ROLE_BATCHES batches of N_TXNS CommitRequests, each one point read
    [k, k + b"\\x00") and one point write over KEYSPACE uniform ids
    (big-endian in the key's low 8 bytes), read at the previous batch's
    version, VERSION_STEP versions a batch from just below 2^30,
    chained by prev_version from the resolver's recovery version 0; one
    transaction of every other batch asks for report_conflicting_keys.
    The same ids at every key width.
    Returns [(ResolveRequest, new oldest version)]."""
    from foundationdb_tpu_torch.server.types import (CommitRequest,
                                                     ResolveRequest)
    rng = np.random.default_rng(SEED + 2)
    pad = bytes(key_bytes - 8)
    out, prev = [], 0
    for i, (v, o) in zip(range(n), versions()):
        ids = rng.integers(0, KEYSPACE, size=2 * N_TXNS, dtype=np.int64)
        raw = ids.astype(">u8").tobytes()
        keys = [pad + raw[j:j + 8] for j in range(0, len(raw), 8)]
        txns = tuple(CommitRequest(
            v - VERSION_STEP, ((r, r + b"\x00"),), ((w, w + b"\x00"),), (),
            report_conflicting_keys=(t == 0 and i % 2 == 1))
            for t, (r, w) in enumerate(zip(keys[0::2], keys[1::2])))
        out.append((ResolveRequest(prev, v, txns), o))
        prev = v
    return out


class _Timed:
    """Wall seconds spent in one callable, by a label the caller picks
    from the arguments (`label(*args)`, or one bucket)."""

    def __init__(self, fn, label=None):
        self.fn, self.label, self.secs, self.calls = fn, label, {}, 0

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return self.fn(*args, **kwargs)
        finally:
            k = self.label(*args) if self.label else ""
            self.secs[k] = self.secs.get(k, 0.0) + time.perf_counter() - t0
            self.calls += 1

    def total(self, k="") -> float:
        return self.secs.get(k, 0.0)


def role_run(backend, requests, device, timed=False):
    """The port's Resolver(process, backend, device=device) on a virtual
    Scheduler and a SimNetwork, fed by a proxy process that keeps
    PIPELINE_DEPTH requests outstanding, as a proxy does (the sim's
    latencies reorder them). When the run reaches ROLE_DUP_AT, the two
    copies of the next batch go out first and its predecessor after
    them: both copies wait on it, and the second finds the first in
    flight and drains the same ticket. After the stream the same batch
    goes out once more and comes from the reply cache. Returns (the
    replies by batch, the duplicates' replies, the resolver, the wall
    seconds of the stream, the timers when `timed`, the scheduler's
    per-task report)."""
    from foundationdb_tpu_torch import flow
    from foundationdb_tpu_torch.rpc import SimNetwork
    from foundationdb_tpu_torch.server.resolver_role import Resolver
    flow.set_seed(SEED)
    sched = flow.Scheduler()
    flow.set_scheduler(sched)
    try:
        net = SimNetwork(sched, flow.g_random)
        proxy = net.new_process("proxy", machine="p")
        res = Resolver(net.new_process("resolver", machine="r"), backend,
                       device=device)
        timers = {}
        if timed:
            cs = res.conflict_set
            timers = {
                "wire": _Timed(net._wire, lambda obj: type(obj).__name__),
                "submit": _Timed(cs.submit),
                "checkpoint": _Timed(cs._take_checkpoint),
                "drain": _Timed(cs.drain_with_attribution),
                "payload": _Timed(res._build_payload),
                "state": _Timed(res._check_state_pressure)}
            net._wire = timers["wire"]
            cs.submit, cs._take_checkpoint = (timers["submit"],
                                              timers["checkpoint"])
            cs.drain_with_attribution = timers["drain"]
            res._build_payload = timers["payload"]
            res._check_state_pressure = timers["state"]
            if cs.active.kernel_stats()["platform"] == "gpu":
                cs.active.time_device(True)
        res.start()
        ref = res.resolves.ref()
        n = len(requests)
        replies, dups = {}, {}

        async def send(req, into, key):
            into[key] = await ref.get_reply(req, proxy)

        async def run():
            pending, i = [], 0
            while i < n:
                if i == ROLE_DUP_AT and i + 1 < n:
                    nxt = requests[i + 1][0]
                    copies = [flow.spawn(send(nxt, dups, c), name="proxy")
                              for c in ("first copy", "second copy")]
                    await flow.delay(2 * net.max_latency)
                    pending.append(flow.spawn(
                        send(requests[i][0], replies, i), name="proxy"))
                    await flow.all_of(copies)
                    replies[i + 1] = dups["first copy"]
                    i += 2
                    continue
                pending.append(flow.spawn(send(requests[i][0], replies, i),
                                          name="proxy"))
                i += 1
                while len(pending) >= PIPELINE_DEPTH:
                    await pending.pop(0)
            await flow.all_of(pending)
            if ROLE_DUP_AT + 1 < n:
                await send(requests[ROLE_DUP_AT + 1][0], dups, "cached")
            return True

        sched.start_task_stats()
        t0 = time.perf_counter()
        task = sched.spawn(run(), name="proxy")
        sched.run(until=task, timeout_time=1e9)
        secs = time.perf_counter() - t0
        return replies, dups, res, secs, timers, sched.stop_task_stats()
    finally:
        flow.set_scheduler(None)


def _verdicts(reply):
    """(verdicts, attributed ranges or None) of one reply."""
    if isinstance(reply, tuple) and hasattr(reply, "_fields"):
        return list(reply.verdicts), list(reply.conflicting_ranges)
    return list(reply), None


def role_phase(tag) -> dict:
    """The resolver role on each CUDA backend at its defaults (a 32-byte
    key width, the point backend's 8, whose requests carry the same ids
    in 8-byte keys; one shard on one card): the first ROLE_CUT_BATCHES
    requests through `role_run` on the card. Every reply must equal the
    same backend driven directly on the card (`resolve_with_attribution`
    over the same batches at the role's oldest versions): verdicts, and
    the attributed ranges where the batch asked for them; the first
    ROLE_CPU_BATCHES replies the port's CPU role's (`device="cpu"`);
    the failover wrapper must count no device fault and no failover,
    K4 must run once (the re-base when the versions cross 2^30), as
    often as in the direct run, and every kernel of the backend's path
    must launch; the in-flight and the cached duplicate must answer as
    the first delivery did. Prints the role's wall time a batch, the
    host's split of it, the device's busy share and each kernel's
    launches a batch; returns ({backend: launch counts}, the cuda run's
    first ROLE_HOST_BATCHES requests and replies, which the role-host
    phase holds a resolver in its own process to)."""
    from foundationdb_tpu_torch.flow import coverage
    from foundationdb_tpu_torch.models import (ResolverTransaction,
                                               create_conflict_set)
    t_phase = time.perf_counter()
    cell_requests = role_requests(KEY_BYTES, ROLE_CUT_BATCHES)
    counts_by = {}
    for backend, kernels, n_batches in ROLE_BACKENDS:
        requests = (role_requests(ROLE_POINT_KEY_BYTES, ROLE_CUT_BATCHES)
                    if backend == "cuda-point" else cell_requests)[:n_batches]
        cov0 = {k: coverage.hits(f"resolver.reply_cache.{k}")
                for k in ("inflight_dup", "hit")}
        zero_counts()
        replies, dups, res, secs, timers, tasks = role_run(
            backend, requests, None, timed=True)
        counts = launch_counts()
        n = len(requests)
        cov = {k: coverage.hits(f"resolver.reply_cache.{k}") - v
               for k, v in cov0.items()}
        active = res.conflict_set.active
        dev_ms = active.device_ms()
        fo = res.failover_stats()
        res.stop()
        if sorted(replies) != list(range(n)):
            raise AssertionError(f"role {backend}: replies for "
                                 f"{sorted(replies)}")
        idle = [k for k in kernels if counts[k] <= 0]
        if idle:
            raise AssertionError(f"role {backend} never launched {idle}")
        if fo.get("failovers") or fo.get("device_faults") \
                or not fo.get("on_primary", True) \
                or active.kernel_stats()["platform"] != "gpu":
            raise AssertionError(f"role {backend}: failover stats {fo}")
        first = dups["first copy"]
        if not (dups["second copy"] == first == dups["cached"]) \
                or cov != {"inflight_dup": 1, "hit": 1}:
            raise AssertionError(f"role {backend}: duplicates of batch "
                                 f"{ROLE_DUP_AT + 1} answered "
                                 f"differently or missed their path: {cov}")
        # the same backend driven directly over the same batches
        zero_counts()
        cs = create_conflict_set(backend, device=None)
        t0 = time.perf_counter()
        for i, (req, oldest) in enumerate(requests):
            txns = [ResolverTransaction(t.read_snapshot,
                                        t.read_conflict_ranges,
                                        t.write_conflict_ranges)
                    for t in req.transactions]
            want, attr = cs.resolve_with_attribution(txns, req.version,
                                                     oldest)
            got, ranges = _verdicts(replies[i])
            if got != want:
                raise AssertionError(f"role {backend}: verdicts of batch "
                                     f"{i} differ from the direct run's")
            if ranges is not None and ranges != [
                    tuple(txns[t].read_ranges[j] for j in a)
                    for t, a in enumerate(attr)]:
                raise AssertionError(f"role {backend}: attributed ranges "
                                     f"of batch {i} differ")
        direct_secs = time.perf_counter() - t0
        direct = launch_counts()
        del cs
        if counts["window_upkeep"] != 1 or direct["window_upkeep"] != 1:
            raise AssertionError(
                f"role {backend}: K4 ran {counts['window_upkeep']} times, "
                f"{direct['window_upkeep']} in the direct run; one re-base "
                "expected")
        # the first replies against the port's CPU role
        t0 = time.perf_counter()
        cpu_replies, _d, cpu_res, _s, _t, _k = role_run(
            backend, requests[:ROLE_CPU_BATCHES], "cpu")
        cpu_res.stop()
        for i in range(ROLE_CPU_BATCHES):
            if cpu_replies[i] != replies[i]:
                raise AssertionError(f"role {backend}: reply {i} differs "
                                     "from the CPU role's")
        cpu_secs = time.perf_counter() - t0
        conflicts = sum(_verdicts(replies[i])[0].count(0) for i in range(n))
        reports = sum(1 for i in range(n) if _verdicts(replies[i])[1]
                      is not None)
        print(f"[{tag}] role {backend}: {n} ResolveRequests of {N_TXNS} "
              f"txns ({reports} with a ResolveReply), {conflicts} "
              f"conflicts; every reply equal to the direct run's verdicts "
              f"and attributed ranges ({direct_secs:.1f} s), the first "
              f"{ROLE_CPU_BATCHES} to the CPU role's ({cpu_secs:.1f} s); "
              f"{fo.get('failovers')} failovers, {fo.get('device_faults')} "
              f"device faults, {fo.get('checkpoints')} checkpoints; K4 "
              f"{counts['window_upkeep']} launch (one re-base); the "
              f"in-flight and the cached duplicate of batch "
              f"{ROLE_DUP_AT + 1} equal its first reply", flush=True)
        ms = secs / n * 1e3
        print(f"[{tag}] role {backend}: {ms:.3f} ms/batch, {n / secs:.3f} "
              f"batches/s, {n * N_TXNS / secs:.1f} txn/s over the wall "
              f"time ({secs:.3f} s for {n} batches)", flush=True)
        wire = timers["wire"].secs
        per = {k: 1e3 * t.total() / n for k, t in timers.items()}
        wire_req = 1e3 * wire.get("ResolveRequest", 0.0) / n
        wire_rep = 1e3 * sum(v for k, v in wire.items()
                             if k != "ResolveRequest") / n
        busy = {r["task"]: r["busy_us"] / 1e3 / n for r in tasks["tasks"]}
        # the resolve actor's steps hold the build, submit, drain,
        # payload, the state check and the reply's wire trip
        rest = busy.get("_resolve_batch", 0.0) - wire_rep - sum(
            per[k] for k in ("submit", "drain", "payload", "state"))
        print(f"[{tag}] role {backend}: host ms a batch: wire round trip "
              f"{wire_req:.3f} request, {wire_rep:.3f} reply; "
              f"ResolverTransaction build, key histogram and the rest of "
              f"the step {rest:.3f}; submit (marshal, H2D, launch) "
              f"{per['submit'] - per['checkpoint']:.3f}, the failover "
              f"wrapper's checkpoints inside it {per['checkpoint']:.3f} "
              f"({timers['checkpoint'].calls} calls); "
              f"drain_with_attribution {per['drain']:.3f}; _build_payload "
              f"{per['payload']:.3f}; state check {per['state']:.3f}; the "
              f"loop busy {sum(busy.values()):.3f} of {ms:.3f}", flush=True)
        print(f"[{tag}] role {backend}: device busy "
              f"{100 * dev_ms / (secs * 1e3):.2f}% of the wall "
              f"({dev_ms / n:.3f} ms/batch in CUDA-event spans)",
              flush=True)
        print(f"[{tag}] role {backend}: launches a role batch "
              + ", ".join(f"{k} {counts[k] / n:.3f}" for k in counts
                          if counts[k]) + "; direct run "
              + ", ".join(f"{k} {direct[k] / n:.3f}" for k in direct
                          if direct[k]), flush=True)
        counts_by[backend] = counts
        if backend == "cuda":
            kept = ([r for r, _o in requests[:ROLE_HOST_BATCHES]],
                    {i: replies[i] for i in range(ROLE_HOST_BATCHES)})
    print(f"[{tag}] role phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return counts_by, kept


def commit_leg_phase(tag) -> dict:
    """The commit leg (`testing.commit_leg` over the port): the role
    phase's cuda traffic, each transaction carrying one SET_VALUE of its
    write key to a versionstamp, resolved by `Resolver(process, "cuda")`
    on the card with PIPELINE_DEPTH requests in flight; the committed
    mutations logged to one durable TLog, tagged to 4 storage tags split
    at key ids 1M, 2M and 3M, each pulled by a StorageServer on its own
    machine's KeyValueStoreMemory at the default durability lag. Checks
    (inside the leg): every shard paged at the last version equals the
    plain dict of the verdicts, COMMIT_SAMPLE point reads at batch
    COMMIT_READ_AT's version equal the dict at that version, and after
    a power loss of the log's and every storage machine new roles on
    the same disks recover and answer both again. Here: the role ran on
    the card with no failover, every interval kernel launched and K4
    once, the leg's requests are the role phase's plus the mutations,
    and the first COMMIT_CPU_BATCHES batches of the leg (verdicts,
    commit replies, reads before and after the power loss) equal the
    same leg with the resolver at device="cpu". Prints the leg's wall
    ms a batch, its parts, the recovery time and the device's busy
    share; returns the leg's launch counts."""
    from foundationdb_tpu_torch import testing as tg
    t_phase = time.perf_counter()
    P = tg.leg_package()
    rng = np.random.default_rng(SEED + 2)     # role_requests' draws
    ids = np.stack([rng.integers(0, KEYSPACE, size=2 * N_TXNS,
                                 dtype=np.int64) for _ in range(ROLE_BATCHES)])
    vers = [v for v, _o in versions()][:ROLE_BATCHES]
    for got, want in zip(tg.leg_requests(P, ids, vers, VERSION_STEP,
                                         tg.LEG_KEY_BYTES),
                         role_requests(KEY_BYTES)):
        bare = got._replace(transactions=tuple(
            t._replace(mutations=()) for t in got.transactions))
        if bare != want[0] or any(
                len(t.mutations) != 1 for t in got.transactions):
            raise AssertionError("commit leg: traffic differs from the "
                                 "role phase's")
    kw = dict(split_ids=SPLIT_IDS, seed=SEED)
    active = {}

    def on_resolver(res):
        cs = res.conflict_set.active
        if cs.kernel_stats()["platform"] != "gpu":
            raise AssertionError("commit leg: the role is not on the card")
        cs.time_device(True)
        active["cs"] = cs

    zero_counts()
    out = tg.commit_leg(P, "cuda", ids, vers, VERSION_STEP,
                        resolver_kwargs={"device": None},
                        read_at=COMMIT_READ_AT, n_sample=COMMIT_SAMPLE,
                        on_resolver=on_resolver, **kw)
    counts = launch_counts()
    n = len(vers)
    fo = out["resolver"].failover_stats()
    dev_ms = active["cs"].device_ms()
    idle = [k for k in INTERVAL_KERNELS if counts[k] <= 0]
    if idle:
        raise AssertionError(f"commit leg never launched {idle}")
    if counts["window_upkeep"] != 1:
        raise AssertionError(f"commit leg: K4 ran {counts['window_upkeep']} "
                             "times; one re-base expected")
    if fo.get("failovers") or fo.get("device_faults") \
            or not fo.get("on_primary", True):
        raise AssertionError(f"commit leg: failover stats {fo}")
    # the leg's prefix on the card and with the resolver on the CPU
    t0 = time.perf_counter()
    m = COMMIT_CPU_BATCHES
    legs = [tg.commit_leg(P, "cuda", ids[:m], vers[:m], VERSION_STEP,
                          resolver_kwargs={"device": d}, read_at=m - 2,
                          n_sample=COMMIT_SAMPLE, **kw)
            for d in (None, "cpu")]
    if legs[0]["log"] != legs[1]["log"]:
        raise AssertionError(f"commit leg: the first {m} batches differ "
                             "from the CPU leg's")
    if out["log"]["verdicts"][:m] != legs[1]["log"]["verdicts"]:
        raise AssertionError(f"commit leg: verdicts of the first {m} "
                             "batches differ from the CPU leg's")
    cpu_secs = time.perf_counter() - t0
    log = out["log"]
    print(f"[{tag}] commit leg: {n} batches of {N_TXNS} txns, "
          f"{out['committed']} committed; {out['rows']} rows over 4 "
          f"storage tags equal to the model at the last version, "
          f"{out['sample']} point reads at batch {COMMIT_READ_AT}'s version "
          f"equal to it, both again after the power loss; durable at "
          f"{log['durable']} (versions), {len(log['log_left'])} of {n} "
          f"batches left in the log; the first {m} batches equal to the "
          f"CPU leg's ({cpu_secs:.1f} s); {fo.get('failovers')} failovers, "
          f"{fo.get('device_faults')} device faults; launches "
          + ", ".join(f"{k} {counts[k]}" for k in counts if counts[k]),
          flush=True)
    wall = {k: 1e3 * sum(v) / n for k, v in out["wall"].items()}
    print(f"[{tag}] commit leg: {1e3 * out['stream_s'] / n:.3f} ms/batch "
          f"over the wall ({out['stream_s']:.3f} s for {n} batches); "
          f"a batch's parts on the host's wall clock, overlapping "
          f"across the {tg.LEG_DEPTH} batches in flight: resolve round "
          f"trip {wall['resolve']:.3f} ms, TLog commit round trip "
          f"(accept to fsync ack) {wall['tlog']:.3f} ms, storage apply "
          f"lag (ack to readable on every tag) {wall['apply']:.3f} ms; "
          f"read-back {1e3 * out['reads_s']:.3f} ms ({out['rows']} rows "
          f"and {out['sample']} point reads); recovery after the power "
          f"loss {1e3 * out['recovery_s']:.3f} ms", flush=True)
    busy = sorted(out["tasks"].items(), key=lambda kv: -kv[1])
    print(f"[{tag}] commit leg: host busy ms a batch by task over the "
          f"stream: " + ", ".join(f"{k} {1e3 * v / n:.3f}"
                                  for k, v in busy[:12])
          + f"; all {1e3 * sum(out['tasks'].values()) / n:.3f}", flush=True)
    print(f"[{tag}] commit leg: device busy "
          f"{100 * dev_ms / (out['stream_s'] * 1e3):.2f}% of the stream's "
          f"wall ({dev_ms / n:.3f} ms/batch in CUDA-event spans)",
          flush=True)
    print(f"[{tag}] commit leg phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return counts


def drive_resolvers(label, run, device):
    """`run(seen)` with every resolver it starts caught in `seen`, with
    its platform (its device time is taken in CUDA-event spans when it
    is on the card; an error raised inside the recruitment would make
    every recovery retry it, so the platform is checked after the run:
    each must be on the card when `device` is None, else on the CPU).
    Returns (run's result, the resolvers)."""
    from foundationdb_tpu_torch.server import resolver_role
    seen = []
    start = resolver_role.Resolver.start

    def caught(self):
        active = self.conflict_set.active
        self.platform = active.kernel_stats()["platform"]
        if self.platform == "gpu":
            active.time_device(True)
        seen.append(self)
        start(self)

    resolver_role.Resolver.start = caught
    try:
        out = run(seen)
    finally:
        resolver_role.Resolver.start = start
    want = "gpu" if device is None else "cpu"
    if any(r.platform != want for r in seen):
        raise AssertionError(f"{label}: resolvers on "
                             f"{[r.platform for r in seen]}, not {want}")
    return out, seen


def arm_task_stats(c):
    c.sched.start_task_stats()


def settle_heap(tag, label):
    """Collect what earlier runs left behind before a timed run: a
    finished cluster's actors are finalized in one collection and freed
    in the next, and a full collection left to run inside the timed
    window is charged to whichever task set it off. Prints what it
    freed and how long it took."""
    t0 = time.perf_counter()
    freed, rounds = 0, 0
    while n := gc.collect():
        freed += n
        rounds += 1
    print(f"[{tag}] {label}: heap settled before the run, {freed} "
          f"unreachable objects in {rounds} collections, "
          f"{1e3 * (time.perf_counter() - t0):.1f} ms", flush=True)


def cluster_drive(backend, n_txns, key_bytes, device, timed=False):
    """`testing.cluster_run` over the port: a SimCluster at FDB 6.1's
    default role counts (`testing.CLUSTER_LAYOUT`) on `backend` at
    `device`, CLUSTER_CLIENTS clients of `n_txns` transactions each at
    SEED, the resolver's worker killed when client 0 reaches half of
    them, every resolver caught (`drive_resolvers`). With `timed`, the
    scheduler's task stats are armed. Returns (the run's result, the
    resolvers)."""
    from foundationdb_tpu_torch import testing as tg
    return drive_resolvers(
        f"cluster {backend}",
        lambda seen: tg.cluster_run(
            tg.cluster_package(), backend, SEED, CLUSTER_CLIENTS, n_txns,
            CLUSTER_IDS, key_bytes=key_bytes, kill_at=n_txns // 2,
            cluster_kwargs={"device": device},
            on_cluster=arm_task_stats if timed else None),
        device)


def no_failover(label, resolvers):
    """No device fault and no failover in any of the resolvers."""
    for r in resolvers:
        fo = r.failover_stats()
        if fo.get("failovers") or fo.get("device_faults") \
                or not fo.get("on_primary", True):
            raise AssertionError(f"{label}: failover stats {fo}")


def cluster_checks(label, out, resolvers):
    """What every cluster run must show: one recovery past the boot's,
    caused by the kill, and a resolver recruited anew for it; no device
    fault and no failover in any resolver; every kernel counter of the
    status document above 0 (`cluster_run` itself held the keyspace to
    the plain dict of the outcomes)."""
    if out["epoch"] != out["kill_epoch"] + 1 or out["recovered"] is None:
        raise AssertionError(f"{label}: epoch {out['epoch']} after the kill "
                             f"at epoch {out['kill_epoch']}")
    if len(resolvers) < 2:
        raise AssertionError(f"{label}: {len(resolvers)} resolvers started; "
                             "the recovery must recruit one anew")
    no_failover(label, resolvers)
    kern = out["status"]["cluster"]["kernels"]
    if not kern or any(v <= 0 for v in kern.values()):
        raise AssertionError(f"{label}: status kernel counters {kern}")


def resolve_totals(resolvers):
    """(resolve batches, transactions, device ms in CUDA-event spans)
    over the resolvers."""
    snaps = [r.stats.snapshot() for r in resolvers]
    return (sum(x.get("batches_resolved", 0) for x in snaps),
            sum(x.get("transactions_resolved", 0) for x in snaps),
            sum(r.conflict_set.active.device_ms() for r in resolvers
                if r.platform == "gpu"))


def host_tasks(tasks, top=12) -> str:
    busy = sorted(tasks["tasks"], key=lambda r: -r["busy_us"])
    return (", ".join(f"{r['task']} {r['busy_us'] / 1e3:.3f}"
                      for r in busy[:top])
            + f"; all {sum(r['busy_us'] for r in busy) / 1e3:.3f}")


def cluster_phase(tag) -> dict:
    """The whole cluster on the card: `SimCluster(SEED,
    conflict_backend="cuda", n_proxies=3, n_logs=3, n_resolvers=1,
    n_storage=4, storage_replicas=2, durable=True)` (FDB 6.1's default
    role counts in `double` mode on the memory engine) with its
    resolver on the card, CLUSTER_CLIENTS concurrent clients of
    CLUSTER_TXNS transactions, each a point read and a point write of
    16-byte keys uniform over CLUSTER_IDS ids, retried until they
    commit; at half of client 0's transactions the worker that holds the
    resolver is killed and the next epoch recruits it anew on the card.
    Checks (`cluster_checks`): every acknowledged write reads back equal
    to the plain dict of the outcomes and no failed attempt's; one
    recovery; no device fault, no failover; every status kernel counter
    above 0; K1-K3 launched. Then short runs (CLUSTER_SHORT_TXNS a
    client, same seed, same kill) of `cuda`, `cuda-point` (8-byte keys)
    and `sharded-cuda` on the card and at device="cpu": the same
    outcomes and digest, each backend's kernels launched on the card.
    Prints committed txn/s over the wall, commit latency, resolve
    batches and their transactions, launches a batch, the device's busy
    share, the host's busy time by task and the recovery's time;
    returns the main run's launch counts and its resolve batches."""
    t_phase = time.perf_counter()
    settle_heap(tag, "cluster cuda")
    zero_counts()
    out, resolvers = cluster_drive("cuda", CLUSTER_TXNS, KEY_BYTES, None,
                                   timed=True)
    counts = launch_counts()
    label = "cluster cuda"
    cluster_checks(label, out, resolvers)
    idle = [k for k in CLUSTER_BACKENDS[0][1] if counts[k] <= 0]
    if idle:
        raise AssertionError(f"{label} never launched {idle}")
    n_all = CLUSTER_CLIENTS * CLUSTER_TXNS
    if out["committed"] != n_all:
        raise AssertionError(f"{label}: {out['committed']} of {n_all} "
                             "transactions committed")
    batches, txns, dev_ms = resolve_totals(resolvers)
    wall = out["wall_s"]
    lat = np.asarray(out["latency"]) * 1e3
    print(f"[{tag}] {label}: {out['committed']} of {n_all} transactions "
          f"committed ({CLUSTER_CLIENTS} clients), {out['rows']} rows read "
          f"back equal to the plain dict of the outcomes; epoch "
          f"{out['kill_epoch']} -> {out['epoch']} after the kill, "
          f"{len(resolvers)} resolvers on the card, 0 failovers, 0 device "
          f"faults; digest {out['digest'][:16]}", flush=True)
    print(f"[{tag}] {label}: {out['committed'] / wall:.1f} committed txn/s "
          f"over the wall ({wall:.3f} s); commit latency p50 / p99 "
          f"{np.percentile(lat[:, 0], 50):.3f} / "
          f"{np.percentile(lat[:, 0], 99):.3f} virtual ms, "
          f"{np.percentile(lat[:, 1], 50):.3f} / "
          f"{np.percentile(lat[:, 1], 99):.3f} wall ms over "
          f"{len(lat)} commits", flush=True)
    kv, kw = out["kill"]
    rv, rw = out["recovered"]
    print(f"[{tag}] {label}: {batches} resolve batches, "
          f"{txns / max(batches, 1):.3f} transactions a batch; launches a "
          "batch " + ", ".join(f"{k} {counts[k] / max(batches, 1):.3f}"
                               for k in counts if counts[k])
          + f"; device busy {100 * dev_ms / (wall * 1e3):.3f}% of the "
          f"wall ({dev_ms / max(batches, 1):.3f} ms a batch in CUDA-event "
          f"spans); recovery {1e3 * (rw - kw):.3f} wall ms, "
          f"{1e3 * (rv - kv):.3f} virtual ms from the kill to the next "
          "epoch fully recovered", flush=True)
    print(f"[{tag}] {label}: host busy ms by task over the workload: "
          + host_tasks(out["tasks"]), flush=True)
    for backend, kernels, key_bytes in CLUSTER_BACKENDS:
        t0 = time.perf_counter()
        zero_counts()
        card, card_res = cluster_drive(backend, CLUSTER_SHORT_TXNS,
                                       key_bytes, None)
        short = launch_counts()
        cpu, cpu_res = cluster_drive(backend, CLUSTER_SHORT_TXNS,
                                     key_bytes, "cpu")
        label = f"cluster {backend} short"
        cluster_checks(label, card, card_res)
        cluster_checks(f"{label} cpu", cpu, cpu_res)
        idle = [k for k in kernels if short[k] <= 0]
        if idle:
            raise AssertionError(f"{label} never launched {idle}")
        if card["outcomes"] != cpu["outcomes"] \
                or card["digest"] != cpu["digest"]:
            raise AssertionError(f"{label}: outcomes or digest differ from "
                                 "the CPU run's")
        print(f"[{tag}] {label}: {card['committed']} committed, outcomes "
              f"and digest equal to the device=\"cpu\" run's "
              f"({time.perf_counter() - t0:.1f} s for both); launches "
              + ", ".join(f"{k} {short[k]}" for k in short if short[k]),
              flush=True)
    print(f"[{tag}] cluster phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return counts, batches


TESTER_CPU_FLAG = "--tester-cpu"   # the child that makes the CPU runs


def tester_cpu_runs() -> dict:
    """The tester phase's runs at device="cpu" (the storm off and on, the
    failover), each with no failover or device fault in its resolvers,
    which the card's runs must equal: {label: (the run's result, its
    wall seconds)}."""
    from foundationdb_tpu_torch import testing as tg
    P = tg.tester_package()
    out = {}
    for on in (False, True):
        label = f"tester contention {'on' if on else 'off'}"
        t0 = time.perf_counter()
        run, res = drive_resolvers(f"{label} cpu", lambda seen: (
            tg.contention_run(P, "cuda", tg.CONTENTION_SEED, on,
                              TESTER_DURATION,
                              cluster_kwargs={"device": "cpu"})), "cpu")
        no_failover(f"{label} cpu", res)
        out[label] = (run, time.perf_counter() - t0)
    label = "tester region failover"
    t0 = time.perf_counter()
    run, res = drive_resolvers(f"{label} cpu", lambda seen: tg.region_run(
        P, "cuda", tg.REGION_SEED, cluster_kwargs={"device": "cpu"}), "cpu")
    no_failover(f"{label} cpu", res)
    out[label] = (run, time.perf_counter() - t0)
    return out


class TesterCpuRuns:
    """`tester_cpu_runs` in a child process (`chip_smoke.py --tester-cpu
    PATH`, one torch thread), started before the kernel build: it needs
    no card and no kernel, so it runs beside the build and the edge
    checks (not beside the CPU prefixes, whose torch threads it would
    slow) and not after each card run. `result()` waits for it and
    fails if it failed; `stop()` (at exit) kills it if it still runs."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_")
        self.path = os.path.join(self.dir, "tester_cpu.pkl")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), TESTER_CPU_FLAG,
             self.path], cwd=ROOT, stdout=subprocess.DEVNULL,
            env=dict(os.environ, OMP_NUM_THREADS="1"))
        atexit.register(self.stop)

    def result(self) -> dict:
        rc = self.proc.wait(timeout=900)
        if rc:
            raise AssertionError(f"the tester's CPU runs exited {rc}")
        with open(self.path, "rb") as f:
            return pickle.load(f)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


def tester_cpu_main(path) -> int:
    """`--tester-cpu PATH`: `tester_cpu_runs`, pickled to PATH."""
    import torch
    torch.set_num_threads(1)
    runs = tester_cpu_runs()
    with open(path + ".part", "wb") as f:
        pickle.dump(runs, f)
    os.replace(path + ".part", path)
    return 0


def tester_phase(tag, cpu_runs) -> tuple:
    """The simulation tester on the card (`foundationdb_tpu_torch.
    testing`): the reference smoke's contention cell
    (`contention_run`: `SimCluster(8383, durable=True,
    conflict_backend="cuda")`, 4 client handles, TESTER_DURATION
    virtual s of 150 arrivals a second on 2 hot keys) with the conflict
    scheduler, the client windows and repair off, then on; then the
    region failover (`region_run`, seed 801, `conflict_backend="cuda"`:
    a remote region attached, 40 writes, a concurrent writer, a primary
    blackout, `promote()`). Each run again at device="cpu", whose stats
    (without the host clock's fields), hot-key total, consistency
    sweep and digest the card's must equal: the sim does not depend on
    the device. Checks: the hot-key oracle (inside `contention_run`),
    `check_consistency` with rows, the off run conflicted, no device
    fault and no failover, no recovery past the boot's, every resolver
    on the card and K1-K3 launched in each run; in the failover, the
    promoted region's resolver on the card launching K1-K3 after the
    blackout, every write at or below the recovery version read back
    through the promoted region, each write lost above it by at most
    the advertised lag. `cpu_runs()` gives the device="cpu" runs
    (`tester_cpu_runs`). Prints goodput per virtual and per wall second,
    attempts a commit, deferrals and repairs, resolve batches and their
    transactions, launches a batch, the device's busy share, the host's
    busy ms by task, and the promotion's time. Returns the runs' summed
    launch counts and resolve batches."""
    from foundationdb_tpu_torch import testing as tg
    t_phase = time.perf_counter()
    P = tg.tester_package()
    cpu_run = cpu_runs()
    total = dict.fromkeys(launch_counts(), 0)
    total_batches = 0
    for on in (False, True):
        label = f"tester contention {'on' if on else 'off'}"
        settle_heap(tag, label)
        zero_counts()
        card, res = drive_resolvers(label, lambda seen: tg.contention_run(
            P, "cuda", tg.CONTENTION_SEED, on, TESTER_DURATION,
            cluster_kwargs={"device": None}, on_cluster=arm_task_stats),
            None)
        counts = launch_counts()
        cpu, cpu_s = cpu_run[label]
        no_failover(label, res)
        idle = [k for k in TESTER_KERNELS if counts[k] <= 0]
        if idle:
            raise AssertionError(f"{label} never launched {idle}")
        stats = card["stats"]
        if card["epoch"] != 1 or card["consistency"]["rows"] <= 0 \
                or stats["committed"] <= 0 or (not on and
                                               stats["conflicts"] <= 0):
            raise AssertionError(f"{label}: epoch {card['epoch']}, "
                                 f"consistency {card['consistency']}, "
                                 f"stats {stats}")
        for k in ("total", "consistency", "digest", "epoch"):
            if card[k] != cpu[k]:
                raise AssertionError(f"{label}: {k} {card[k]} differs from "
                                     f"the CPU run's {cpu[k]}")
        if tg.sim_stats(stats) != tg.sim_stats(cpu["stats"]):
            raise AssertionError(f"{label}: stats differ from the CPU run's")
        batches, txns, dev_ms = resolve_totals(res)
        total_batches += batches
        for k in total:
            total[k] += counts[k]
        wall = card["wall_s"]
        doc = card["status"]["cluster"]["conflict_scheduling"]
        print(f"[{tag}] {label}: {stats['committed']} of {stats['issued']} "
              f"arrivals committed, hot-key total {card['total']} "
              f"(committed {stats['committed']}, unknown "
              f"{stats['unknown']}), {stats['conflicts']} conflicts, "
              f"{stats['failed']} failed; consistency "
              f"{card['consistency']['rows']} rows over "
              f"{card['consistency']['replicas']} replicas; stats, total, "
              f"sweep and digest {card['digest'][:16]} equal to the "
              f"device=\"cpu\" run's (made beside the earlier phases in "
              f"{cpu_s:.1f} s); {len(res)} resolver on "
              "the card, 0 failovers, 0 device faults", flush=True)
        print(f"[{tag}] {label}: goodput {stats['goodput_per_sec']:.2f} a "
              f"virtual s, {stats['committed'] / wall:.2f} a wall s "
              f"({wall:.3f} s for {stats['wall_seconds']} virtual s); "
              f"{stats['attempts_per_commit']:.3f} attempts a commit; "
              f"{doc.get('deferrals', 0)} deferrals, "
              f"{doc.get('repair_committed', 0)} repairs committed", flush=True)
        print(f"[{tag}] {label}: {batches} resolve batches, "
              f"{txns / max(batches, 1):.3f} transactions a batch; launches "
              "a batch " + ", ".join(f"{k} {counts[k] / max(batches, 1):.3f}"
                                     for k in counts if counts[k])
              + f" (window_upkeep {counts['window_upkeep']}); device busy "
              f"{100 * dev_ms / (wall * 1e3):.3f}% of the wall "
              f"({dev_ms / max(batches, 1):.4f} ms a batch in CUDA-event "
              f"spans); host busy ms by task: {host_tasks(card['tasks'])}",
              flush=True)

    label = "tester region failover"
    at_blackout = {}

    def blackout(seen):
        at_blackout.update(resolvers=len(seen), counts=launch_counts(),
                           wall=time.perf_counter())

    settle_heap(tag, label)
    zero_counts()
    card, res = drive_resolvers(label, lambda seen: tg.region_run(
        P, "cuda", tg.REGION_SEED, cluster_kwargs={"device": None},
        on_blackout=lambda c: blackout(seen)), None)
    counts = launch_counts()
    cpu, _cpu_s = cpu_run[label]
    no_failover(label, res)
    promoted = res[at_blackout["resolvers"]:]
    after = {k: counts[k] - at_blackout["counts"][k] for k in counts}
    idle = [k for k in TESTER_KERNELS if after[k] <= 0]
    if not promoted or idle:
        raise AssertionError(f"{label}: {len(promoted)} promoted resolvers, "
                             f"never launched {idle} after the blackout")
    for k in ("committed", "epoch", "promoted_epoch", "recovery_version",
              "lag", "survived", "lost", "consistency", "digest"):
        if card[k] != cpu[k]:
            raise AssertionError(f"{label}: {k} differs from the CPU run's")
    rv, lag = card["recovery_version"], card["lag"]
    lost = {k: card["committed"][k] - rv for k in card["lost"]}
    if len(card["survived"]) < tg.REGION_SHIPPED or card["consistency"][
            "rows"] <= 0 or any(not 0 < d <= lag for d in lost.values()):
        raise AssertionError(f"{label}: survived {len(card['survived'])}, "
                             f"consistency {card['consistency']}, lost "
                             f"{lost} against a lag of {lag}")
    batches, txns, dev_ms = resolve_totals(res)
    p_batches, _p_txns, _p_dev = resolve_totals(promoted)
    total_batches += batches
    for k in total:
        total[k] += counts[k]
    bv, bw = card["blackout"]
    rv_t, rw = card["recovered"]
    print(f"[{tag}] {label}: epoch {card['epoch']} -> promoted epoch "
          f"{card['promoted_epoch']} at recovery version {rv}; "
          f"{len(card['survived'])} of {len(card['committed'])} writes read "
          f"back through the promoted region, {len(lost)} lost, each above "
          f"the recovery version by at most the advertised lag of {lag} "
          f"versions ({', '.join(str(d) for d in sorted(lost.values()))}); "
          f"consistency {card['consistency']['rows']} rows; committed "
          f"versions, survivors, sweep and digest {card['digest'][:16]} "
          "equal to the device=\"cpu\" run's", flush=True)
    print(f"[{tag}] {label}: blackout to the promoted epoch fully "
          f"recovered {1e3 * (rw - bw):.3f} wall ms, "
          f"{1e3 * (rv_t - bv):.3f} virtual ms; {len(res)} resolvers on the "
          f"card, {len(promoted)} in the promoted region with "
          f"{p_batches} resolve batches and launches after the blackout "
          + ", ".join(f"{k} {after[k]}" for k in after if after[k])
          + f"; {batches} resolve batches in all, "
          f"{txns / max(batches, 1):.3f} transactions a batch; 0 failovers, "
          "0 device faults", flush=True)
    print(f"[{tag}] tester phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return total, total_batches


SERVER_CLIENTS = 16      # the server phase: concurrent remote clients,
SERVER_TXNS = 50         # each with this many transactions before the kill
SERVER_AFTER_TXNS = 10   # and this many after the monitor's restart
SERVER_LAYOUT = ("--proxies", "3", "--logs", "3", "--storage", "4",
                 "--replicas", "2")   # FDB 6.1's role counts (cluster phase)
SERVER_KERNELS = ("searchsorted_i32", "range_max", "resolve")
SERVER_WAIT = 300.0      # seconds a child may take to print what is awaited
SERVER_KNOBS = ("--knob_kernel_profile_every", "1")   # time every step


class Child:
    """A child process of the server phase (`python -m <args>` from the
    checkout's root): its standard output read line by line into a
    queue by a thread, its standard error kept in a file."""

    def __init__(self, label, args, tmp):
        self.label = label
        self.err_path = os.path.join(tmp, f"{label}.err")
        self._err = open(self.err_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", *args], cwd=ROOT, env=child_env(),
            stdout=subprocess.PIPE, stderr=self._err, text=True)
        self.lines, self.seen = queue.Queue(), []

        def pump():
            for line in self.proc.stdout:
                self.lines.put(line.rstrip("\n"))
            self.lines.put(None)

        threading.Thread(target=pump, daemon=True).start()

    def wait_for(self, pred, what, timeout=SERVER_WAIT) -> str:
        """The first line from here on that `pred` accepts."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                line = self.lines.get(
                    timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                raise AssertionError(f"{self.label}: no {what} in {timeout} "
                                     f"s; stderr:\n{self.stderr()}")
            if line is None:
                raise AssertionError(f"{self.label} exited before {what}; "
                                     f"stderr:\n{self.stderr()}")
            self.seen.append(line)
            if pred(line):
                return line

    def stderr(self, tail=4000) -> str:
        self._err.flush()
        with open(self.err_path) as f:
            return f.read()[-tail:]

    def close(self):
        self._err.close()


def child_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    return env


def cli_child(tag, cf, script, label):
    """`python -m foundationdb_tpu_torch.tools.cli -C <cf> --exec
    <script>` to its end: its standard output, or AssertionError with
    its standard error when it fails."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "foundationdb_tpu_torch.tools.cli", "-C", cf,
         "--exec", script], cwd=ROOT, env=child_env(), capture_output=True,
        text=True, timeout=SERVER_WAIT)
    if out.returncode:
        raise AssertionError(f"server phase: cli {label} exited "
                             f"{out.returncode}; stderr:\n{out.stderr[-4000:]}")
    print(f"[{tag}] server phase: cli {label}: rc 0, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out.stdout


def server_status(tag, cf, label) -> dict:
    return json.loads(cli_child(tag, cf, "status json", label))


def server_resolvers(doc, label):
    """The current epoch's resolvers in a status document, each on
    `cuda` on the server's device, with no device fault and no
    failover."""
    cl = doc["cluster"]
    res = [r for r in cl.get("resolvers", ()) if r.get("kernel")]
    if cl["configuration"]["conflict_backend"] != "cuda" or not res \
            or any(r["kernel"]["backend"] != "cuda"
                   or r["kernel"]["platform"] != "gpu" for r in res):
        raise AssertionError(f"{label}: backend "
                             f"{cl['configuration']['conflict_backend']}, "
                             f"resolvers {[r.get('kernel') for r in res]}")
    for r in res:
        fo = r["failover"]
        if fo.get("failovers") or fo.get("device_faults") \
                or not fo.get("on_primary", True):
            raise AssertionError(f"{label}: {r['name']} failover {fo}")
    return res


def server_counts(doc, label) -> dict:
    """Launches of K1-K3 in the server process (the status document's
    `launches.<kernel>` counters), its resolve batches and the profiled
    entries' calls, first calls (the library's load, timed on the host),
    CUDA-event-timed calls and their microseconds."""
    kern = doc["cluster"]["kernels"]
    out = {k: kern.get(f"launches.{k}", 0) for k in SERVER_KERNELS}
    out["batches"] = sum(r["counters"].get("batches_resolved", 0)
                         for r in server_resolvers(doc, label))
    for stat in ("calls", "compiles", "timed_calls", "execute_us"):
        out[stat] = sum(v for k, v in kern.items()
                        if k.startswith("resolve_packed[")
                        and k.endswith(f".{stat}"))
    return out


def child_pids(ppid, needle) -> list:
    """Pids of `ppid`'s children whose command line holds `needle`."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == ppid and needle in cmd:
            out.append(int(d))
    return out


def server_phase(tag) -> tuple:
    """A separate server process on the card (FDB's fdbserver under
    fdbmonitor, operated by fdbcli): `python -m foundationdb_tpu_torch.
    tools.monitor` started as a child with the server's flags (a free
    port, SEED, a data directory, a cluster file, SERVER_LAYOUT); the
    kernels were built by this process before any child starts, and no
    child builds them again. Then, each through its own child process
    or over TCP:
      - `fdbcli -C <cluster file> --exec "configure
        conflict_backend=cuda"`, and `status json` until the new epoch
        is fully recovered with its resolver on `cuda` on the card;
      - SERVER_CLIENTS concurrent clients of SERVER_TXNS transactions
        from this process through `RemoteCluster` (the cluster phase's
        transaction shape: a point read and a point write of 16-byte
        keys over CLUSTER_IDS uniform ids, through `run_transaction`'s
        retry loop; `testing.remote_traffic`), every acknowledged write
        kept in a model dict;
      - `status json` again: no failover, and K1-K3 launched once a
        resolve batch over the traffic (the server's `launches.*`
        counters);
      - a SIGKILL of the server (not the monitor), the monitor's restart
        on the same data directory, which prints LISTENING only once
        the epoch recruited with the stored conf row has its resolver
        on the card; the first commit after it; every acknowledged
        write read back; SERVER_CLIENTS x SERVER_AFTER_TXNS more, read
        back too, with the restarted server's counters growing;
      - SIGINT to the monitor, every child's exit checked.
    The server times every resolve step with CUDA events (SERVER_KNOBS).
    Prints committed txn a wall second, commit latency, conflicts,
    launches a batch, the kernels' busy share of the traffic's wall time
    and the seconds from the kill to LISTENING and to the first commit;
    returns (the server's launch counts over the first traffic, its
    resolve batches)."""
    from foundationdb_tpu_torch import testing as tg
    from foundationdb_tpu_torch.client import run_transaction
    from foundationdb_tpu_torch.client.cluster_file import resolve_connect
    from foundationdb_tpu_torch.client.remote import RemoteCluster
    from foundationdb_tpu_torch.ops import _build
    t_phase = time.perf_counter()
    lib_path = _build.build_info["path"]
    built = (sorted(os.listdir(_build.BUILD_ROOT)),
             os.stat(lib_path).st_mtime_ns)
    tmp = tempfile.mkdtemp(prefix="fdb-server-")
    cf = os.path.join(tmp, "fdb.cluster")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mon = Child("monitor", ["foundationdb_tpu_torch.tools.monitor",
                            "--port", str(port), "--seed", str(SEED),
                            "--data-dir", os.path.join(tmp, "data"),
                            "--cluster-file", cf, *SERVER_LAYOUT,
                            *SERVER_KNOBS], tmp)
    stopped = False
    try:
        started = mon.wait_for(lambda l: l.startswith("MONITOR starting"),
                               "its server's start")
        if " -m foundationdb_tpu_torch.tools.server " not in started:
            raise AssertionError(f"server phase: the monitor runs {started}")
        mon.wait_for(lambda l: "LISTENING" in l, "LISTENING")
        t_boot = time.perf_counter() - t_phase
        out = cli_child(tag, cf, "configure conflict_backend=cuda",
                        "configure")
        if "Configuration changed" not in out:
            raise AssertionError(f"server phase: configure said {out!r}")
        for poll in range(60):
            doc = server_status(tag, cf, f"status {poll}")
            cl = doc["cluster"]
            if cl["epoch"] > 1 and cl["recovery_state"] == "fully_recovered" \
                    and cl["configuration"]["conflict_backend"] == "cuda" \
                    and any(r.get("kernel") for r in cl["resolvers"]):
                break
            time.sleep(1.0)
        else:
            raise AssertionError("server phase: the cuda epoch never "
                                 "recovered")
        res = server_resolvers(doc, "server phase after configure")
        before = server_counts(doc, "server phase after configure")
        print(f"[{tag}] server phase: monitor and server up in {t_boot:.1f} "
              f"s; epoch {cl['epoch']} fully recovered on conflict_backend "
              f"cuda, {len(res)} resolver on "
              f"{res[0]['kernel'].get('device', res[0]['kernel']['platform'])}"
              f" after {poll + 1} status polls", flush=True)

        host, port = resolve_connect(None, cf)
        rc = RemoteCluster(host or "127.0.0.1", port)
        try:
            traffic = tg.remote_traffic(rc, SEED, SERVER_CLIENTS, SERVER_TXNS,
                                        CLUSTER_IDS)
        finally:
            rc.close()
        n_all = SERVER_CLIENTS * SERVER_TXNS
        if traffic["committed"] != n_all:
            raise AssertionError(f"server phase: {traffic['committed']} of "
                                 f"{n_all} transactions acknowledged")
        doc = server_status(tag, cf, "status after the traffic")
        after = server_counts(doc, "server phase after the traffic")
        counts = {k: after[k] - before[k] for k in after}
        batches = counts["batches"]
        off = [k for k in SERVER_KERNELS if counts[k] != batches]
        if batches <= 0 or off:
            raise AssertionError(f"server phase: {batches} resolve batches, "
                                 f"launches {counts}")
        if counts["timed_calls"] + counts["compiles"] != counts["calls"]:
            raise AssertionError(f"server phase: {counts['timed_calls']} of "
                                 f"{counts['calls']} steps timed")
        wall = traffic["wall_s"]
        lat = np.asarray(traffic["latency"]) * 1e3
        busy_ms = counts["execute_us"] / 1e3
        print(f"[{tag}] server phase: {traffic['committed']} of {n_all} "
              f"transactions acknowledged over TCP ({SERVER_CLIENTS} "
              f"clients), {traffic['conflicts']} conflicted attempts "
              f"retried; {traffic['committed'] / wall:.1f} committed txn/s "
              f"over the wall ({wall:.3f} s); commit latency p50 / p99 "
              f"{np.percentile(lat, 50):.3f} / {np.percentile(lat, 99):.3f} "
              f"wall ms", flush=True)
        print(f"[{tag}] server phase: {batches} resolve batches in the "
              f"server, {traffic['committed'] / batches:.3f} acknowledged "
              "transactions a batch; launches a batch "
              + ", ".join(f"{k} {counts[k] / batches:.3f}"
                          for k in SERVER_KERNELS)
              + "; the kernels' busy share of the traffic's wall "
              f"{100 * busy_ms / (wall * 1e3):.3f}% ({busy_ms:.3f} ms over "
              f"{counts['timed_calls']} steps, each timed with CUDA events; "
              f"{counts['compiles']} first call, the library's load, "
              "not counted); "
              "0 failovers, 0 device faults", flush=True)

        pids = child_pids(mon.proc.pid, "foundationdb_tpu_torch.tools.server")
        if len(pids) != 1:
            raise AssertionError(f"server phase: server pids {pids}")
        t_kill = time.perf_counter()
        os.kill(pids[0], signal.SIGKILL)
        exited = mon.wait_for(lambda l: "child exited" in l, "the kill")
        mon.wait_for(lambda l: "LISTENING" in l, "LISTENING after the kill")
        t_listen = time.perf_counter() - t_kill
        rc = RemoteCluster(host or "127.0.0.1", port)
        try:
            # a restarted server opens its gateway only once the epoch
            # recruited with the stored conf row (cuda) is fully
            # recovered: no client is served on its flags' backend
            doc = rc.call(rc.db.get_status(), timeout=SERVER_WAIT)
            cl = doc["cluster"]
            if cl["recovery_state"] != "fully_recovered":
                raise AssertionError("server phase: LISTENING after the "
                                     f"kill at {cl['recovery_state']}")
            again = server_counts(doc, "server phase after the restart")

            async def mark(tr):
                tr.set(b"\xfe/server-phase/restarted", b"1")
            rc.call(run_transaction(rc.db, mark, max_retries=500),
                    timeout=SERVER_WAIT)
            t_first = time.perf_counter() - t_kill
            n_read = tg.remote_read_back(rc, traffic["model"])
            more = tg.remote_traffic(rc, SEED + 1, SERVER_CLIENTS,
                                     SERVER_AFTER_TXNS, CLUSTER_IDS,
                                     tag=b"r.")
            model = {**traffic["model"], **more["model"]}
            n_read2 = tg.remote_read_back(rc, model)
            doc = rc.call(rc.db.get_status(), timeout=SERVER_WAIT)
            grown = server_counts(doc, "server phase after the second round")
        finally:
            rc.close()
        if more["committed"] != SERVER_CLIENTS * SERVER_AFTER_TXNS:
            raise AssertionError(f"server phase: {more['committed']} "
                                 "acknowledged after the restart")
        idle = [k for k in SERVER_KERNELS if grown[k] <= again[k]]
        if idle:
            raise AssertionError(f"server phase: the restarted server never "
                                 f"launched {idle}: {again} -> {grown}")
        print(f"[{tag}] server phase: SIGKILL of the server ({exited}); "
              f"LISTENING again {t_listen:.3f} s after the kill with epoch "
              f"{cl['epoch']} fully recovered on cuda, the first commit "
              f"(on the card) {t_first:.3f} s after it; {n_read} "
              "acknowledged "
              f"writes read back equal; {more['committed']} more "
              f"committed, {n_read2} read back; the restarted server's "
              "launches " + ", ".join(f"{k} {again[k]} -> {grown[k]}"
                                      for k in SERVER_KERNELS)
              + f" over {grown['batches'] - again['batches']} resolve "
              "batches, its resolver on the card, 0 failovers", flush=True)

        mon.proc.send_signal(signal.SIGINT)
        rc_mon = mon.proc.wait(timeout=120)
        stopped = True
        mon.wait_for(lambda l: "MONITOR stopped" in l, "its stop", 30)
        if rc_mon != 0:
            raise AssertionError(f"server phase: the monitor exited {rc_mon}; "
                                 f"stderr:\n{mon.stderr()}")
    except BaseException:
        print(f"[{tag}] server phase: monitor output:\n"
              + "\n".join(mon.seen[-40:]) + f"\nmonitor stderr:\n"
              + mon.stderr(), flush=True)
        raise
    finally:
        if not stopped and mon.proc.poll() is None:
            mon.proc.send_signal(signal.SIGINT)
            try:
                mon.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                mon.proc.kill()
                mon.proc.wait(timeout=30)
        for pid in child_pids(mon.proc.pid, "foundationdb_tpu_torch"):
            os.kill(pid, signal.SIGKILL)
        mon.close()
        shutil.rmtree(tmp, ignore_errors=True)
    now = (sorted(os.listdir(_build.BUILD_ROOT)),
           os.stat(lib_path).st_mtime_ns)
    if now != built:
        raise AssertionError(f"server phase: a child built the kernels "
                             f"again: {built} -> {now}")
    print(f"[{tag}] server phase: the children loaded this process's "
          f"kernel build ({os.path.relpath(lib_path, ROOT)}), none started "
          f"nvcc; the monitor exited 0; {time.perf_counter() - t_phase:.1f} "
          "s", flush=True)
    return {k: counts.get(k, 0) for k in launch_counts()}, batches


ROLE_HOST_KERNELS = ("searchsorted_i32", "range_max", "resolve")


def role_host_phase(tag, kept) -> tuple:
    """The resolver role in its own OS process on the card, in three
    parts, each of which fails the run if it fails:

    (a) `testing.role_host_run`: one `RoleProcs` resolver host at the
        default device (the card), recruited over TCP on `cuda`, sent
        the role phase's first ROLE_CUT_BATCHES ResolveRequests (`kept`:
        the requests and the replies the in-process `cuda` role gave
        them, kept from the role phase); every reply must equal the
        kept one; after request ROLE_HOST_CKPT_AT the host checkpoints,
        after request ROLE_HOST_KILL_AT (both `testing`'s) it is sent
        SIGKILL and
        respawned on its pinned port, restores the checkpoint onto the
        card and replays the journal above it; the resend of request
        ROLE_HOST_KILL_AT must be the byte-identical cached payload and
        the later requests must equal too. K1-K3 must launch once a
        resolve batch in the host's own counters (replays included) and
        K4 once (the re-base at 2^30, before the kill).
    (b) `testing.role_cluster_run`: two resolver hosts and a tlog host,
        a wall-clock SimCluster on `cuda` with its roles recruited
        there, two proxy worker processes (`clusterbench --worker`) at
        400 arrivals a wall s for 8 s on disjoint keys, resolver host 0
        killed halfway and respawned: every arrival commits, commits
        resume within CHAOS_RECOVERY_BOUND, every acknowledged write
        reads back; K1-K3 launch in each resolver host.
    (c) `tools.smoke`'s `--faults` and `--packed` modes in this process
        on the card (K1-K3 launched).

    Returns ({kernel: launches of every role host}, their resolve
    batches)."""
    from foundationdb_tpu_torch import testing
    from foundationdb_tpu_torch.ops import _build
    from foundationdb_tpu_torch.tools import smoke
    t_phase = time.perf_counter()
    lib_path = _build.build_info["path"]
    built = (sorted(os.listdir(_build.BUILD_ROOT)),
             os.stat(lib_path).st_mtime_ns)
    requests, replies = kept
    tmp = tempfile.mkdtemp(prefix="chip-rolehost-")
    saved_path = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = child_env()["PYTHONPATH"]
    total = dict.fromkeys(launch_counts(), 0)
    procs_b = None
    try:
        # (b)'s role hosts start while (a) runs: their start-up (torch's
        # import) overlaps it
        procs_b = testing.role_cluster_procs(os.path.join(tmp, "b"))
        # (a) one resolver host, a SIGKILL, the checkpoint and the journal
        t0 = time.perf_counter()
        a = testing.role_host_run(requests, replies,
                                  os.path.join(tmp, "a"))
        secs = time.perf_counter() - t0
        n_req = len(requests)
        for i, (c, n) in enumerate(zip(a["launches"], a["batches"])):
            off = [k for k in ROLE_HOST_KERNELS if c.get(k, 0) != n]
            if off:
                raise AssertionError(f"role host (a): incarnation {i} "
                                     f"launched {c} over {n} batches")
        k4 = [c.get("window_upkeep", 0) for c in a["launches"]]
        if k4 != [1, 0]:
            raise AssertionError(f"role host (a): K4 ran {k4} times by "
                                 "incarnation; one re-base expected")
        for c in a["launches"]:
            for k, n in c.items():
                total[k] += n
        print(f"[{tag}] role host (a): {n_req} ResolveRequests of {N_TXNS} "
              f"txns to a resolver host on cuda over TCP, every reply equal "
              f"to the in-process cuda role's; checkpoint after request "
              f"{a['checkpoint_at']} ({a['checkpoints']} before the "
              f"kill); SIGKILL after request {testing.ROLE_HOST_KILL_AT}, "
              f"ready "
              f"again {a['kill_to_ready_s']:.3f} s later, the resend's "
              f"byte-identical cached payload {a['kill_to_reply_s']:.3f} s "
              f"after the kill, {a['replayed']} journal requests "
              f"replayed; requests 0-{testing.ROLE_HOST_KILL_AT} "
              f"{a['requests_s']:.3f} s ("
              f"{1e3 * a['requests_s'] / (testing.ROLE_HOST_KILL_AT + 1):.1f}"
              f" ms a request); the part {secs:.1f} s", flush=True)
        print(f"[{tag}] role host (a): the host's launches, by "
              f"incarnation: " + "; ".join(
                  ", ".join(f"{k} {v}" for k, v in sorted(c.items()))
                  + f" over {n} resolve batches"
                  for c, n in zip(a["launches"], a["batches"])), flush=True)

        # (b) the commit pipeline with its roles in other processes
        t0 = time.perf_counter()
        b = testing.role_cluster_run(os.path.join(tmp, "b"), roles=procs_b)
        secs = time.perf_counter() - t0
        if b["kill_to_commit_s"] is None:
            raise AssertionError("role host (b): no arrival was left for "
                                 "the respawned resolver host to commit")
        for name, c in b["launches"].items():
            if name.startswith("ext-resolver"):
                idle = [k for k in ROLE_HOST_KERNELS if c.get(k, 0) <= 0]
                if idle:
                    raise AssertionError(f"role host (b): {name} never "
                                         f"launched {idle}")
            for k, n in c.items():
                total[k] += n
        lat = "; ".join(f"worker {i} p50 {c['p50_ms']:.3f} / p99 "
                        f"{c['p99_ms']:.3f} ms" for i, c in
                        enumerate(b["commit"]))
        print(f"[{tag}] role host (b): {b['committed']} of {b['offered']} "
              f"arrivals committed through 2 resolver hosts and 1 tlog host "
              f"from 2 proxy worker processes, {b['txn_per_s']:.1f} "
              f"committed a wall s over {b['elapsed']:.3f} s; commit "
              f"latency {lat}; SIGKILL of resolver host 0 halfway, ready "
              f"again {b['kill_to_ready_s']:.3f} s later, the first "
              f"cluster-wide commit advance {b['kill_to_commit_s']:.3f} s "
              f"after the kill; {b['read_back']} acknowledged writes read "
              f"back; the part {secs:.1f} s", flush=True)
        print(f"[{tag}] role host (b): launches by host: " + "; ".join(
            f"{name}: " + (", ".join(f"{k} {v}" for k, v in sorted(c.items()))
                           or "none")
            for name, c in sorted(b["launches"].items())), flush=True)
        batches = sum(a["batches"]) + sum(
            c.get("resolve", 0) for n, c in b["launches"].items())
    finally:
        if procs_b is not None:
            procs_b.terminate_all()
        if saved_path is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = saved_path
        shutil.rmtree(tmp, ignore_errors=True)

    # (c) the port's fault and packed smokes, in this process on the card
    for label, run in (("--faults", smoke.run_smoke_faults),
                       ("--packed", smoke.run_smoke_packed)):
        lines = []
        zero_counts()
        t0 = time.perf_counter()
        if run(out=lines.append) != 0:
            raise AssertionError(f"smoke {label} failed: {lines}")
        c = launch_counts()
        idle = [k for k in ROLE_HOST_KERNELS if c[k] <= 0]
        if idle:
            raise AssertionError(f"smoke {label} never launched {idle}")
        print(f"[{tag}] role host (c): smoke {label} on the card: "
              f"{lines[-1]}; K1-K3 "
              + ", ".join(str(c[k]) for k in ROLE_HOST_KERNELS)
              + f" launches; {time.perf_counter() - t0:.1f} s", flush=True)
    now = (sorted(os.listdir(_build.BUILD_ROOT)),
           os.stat(lib_path).st_mtime_ns)
    if now != built:
        raise AssertionError(f"role host phase: a child built the kernels "
                             f"again: {built} -> {now}")
    print(f"[{tag}] role host phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {k: total.get(k, 0) for k in launch_counts()}, batches


def probe_main(tag, dev) -> int:
    """`--probe`: only K4's table and the chains' traced window, for a
    checkout whose own smoke script predates them; one JSON line."""
    res = {"window": measure_window(dev, tag),
           "chains": chain_probe(dev, tag)}
    print(json.dumps({"probe": res}))
    return 0


def entry_phase(tag, chain_total) -> dict:
    """`python -m foundationdb_tpu_torch.bench` in `all` mode at
    ENTRY_BATCHES batches: exit 0, one JSON line naming this card, every
    cross-check of its modes met (the entry refuses to publish when one
    fails; they are read here again), and its chains' count equal to the
    chain phase's. The record goes to chiprun_out/bench_entry.json."""
    import torch
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("FDBTPU_BENCH_")}
    env.update(FDBTPU_BENCH_BACKEND="all",
               FDBTPU_BENCH_BATCHES=str(ENTRY_BATCHES))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "foundationdb_tpu_torch.bench"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    secs = time.perf_counter() - t0
    if r.returncode:
        raise AssertionError(f"bench entry exited {r.returncode}:\n"
                             f"{r.stderr[-4000:]}")
    lines = r.stdout.strip().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"bench entry printed {len(lines)} lines")
    rec = json.loads(lines[0])
    card = rec["config"]["device"]
    if card["name"] != torch.cuda.get_device_name(0) \
            or not card["power_limit"]:
        raise AssertionError(f"bench entry's device record {card}")
    sub = rec["sub_metrics"]
    checks = sub["cross_checks"]
    for what, counts in checks.items():
        if len(set(counts.values())) != 1:
            raise AssertionError(f"bench entry cross-check {what}: {counts}")
    if set(checks["chains_equal"].values()) != {chain_total}:
        raise AssertionError(f"bench entry chains {checks['chains_equal']} "
                             f"vs the chain phase's {chain_total}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "bench_entry.json"),
              "w") as f:
        f.write(lines[0] + "\n")
    t = sub["transport"]
    print(f"[{tag}] bench entry (all, {ENTRY_BATCHES} batches, "
          f"{secs:.1f} s): value {rec['value']} txn/s "
          f"({rec['config']['backend']}), card {card}; "
          + "; ".join(f"{m} {sub[m]['txn_per_s']}"
                      for m in ("cuda-point", "cuda", "cuda-streamed",
                                "cuda-streamed-interval", "cuda-pipelined",
                                "native", "native-streamed", "python"))
          + f" txn/s; pipelined by depth {sub['cuda-pipelined']['txn_per_s_by_depth']}; "
          f"chains ms/batch {sub['cuda-point']['ms_per_batch']} / "
          f"{sub['cuda']['ms_per_batch']}, enqueue ms/step "
          f"{sub['cuda-point']['enqueue_ms_per_step']} / "
          f"{sub['cuda']['enqueue_ms_per_step']}; transport "
          f"{t['dispatch_roundtrip_ms']} ms round trip, {t['h2d_mb_s']} "
          f"MB/s H2D; cross-checks {checks}", flush=True)
    return rec


def history_steps(rows, vers, base, oldest):
    """A history's step function as `checkpoint()` describes it
    (versions absolute, those below `oldest` clamped to one dead value,
    equal neighbours merged), on encoded rows: the stream's end keys
    (key + b"\\x00", the key's words with length 17) are wider than the
    16-byte key width, so they have no byte string to decode to."""
    v = vers.astype(np.int64) + base
    v = np.where(v < oldest, min(int(v[-1]), oldest - 1), v)
    keep = np.concatenate([[True], v[1:] != v[:-1]])
    return rows[keep], v[keep]


def compare_steps(i, snap_interval, snap_sharded) -> int:
    """The interval history after batch `i` and the sharded one,
    stitched across its shards by the sharded resolver (the stitch its
    `checkpoint()` decodes), as step functions: they must be equal. A
    difference raises with the first differing key and both versions.
    Returns the step count."""
    from foundationdb_tpu_torch.parallel import load_reference_sharded_state
    hk, hv, base, oldest = (x.cpu().numpy() if hasattr(x, "cpu") else x
                            for x in snap_interval)
    real = hk[:, -1] != 0xFFFFFFFF
    ka, va = history_steps(hk[real], hv[real], base, oldest)
    shk, shv, sbase, soldest = snap_sharded
    cs = load_reference_sharded_state(
        shk.cpu().numpy(), shv.cpu().numpy(), base=sbase, oldest=soldest,
        last_commit=list(versions())[i][0], init_version=0,
        key_bytes=KEY_BYTES, split_keys=SHARD_SPLITS, device=None)
    kb, vb = history_steps(*cs._stitched_rows(), sbase, soldest)
    if ka.shape != kb.shape or not (np.array_equal(ka, kb)
                                    and np.array_equal(va, vb)):
        n = min(len(ka), len(kb))
        diff = np.flatnonzero((ka[:n] != kb[:n]).any(axis=1)
                              | (va[:n] != vb[:n]))
        j = int(diff[0]) if diff.size else n
        pick = (lambda k, v: (k[j].tolist(), int(v[j])) if j < len(k)
                else None)
        raise AssertionError(
            f"after batch {i} the sharded history differs from the "
            f"interval history at step {j}: interval (key words, version) "
            f"{pick(ka, va)}, sharded {pick(kb, vb)} ({len(ka)} vs "
            f"{len(kb)} steps)")
    return len(ka)


# the steps' phases by kernel name, for `--trace` (first match wins)
TRACE_PHASES = (
    ("endpoint sort (K3, K8; its last pass writes the ranks)",
     ("EpLoad", "EpPlace")),
    ("K5 write sort", ("WLoad", "NoPlace")),
    ("rank-space overlap (lane tables + matrix)",
     ("lane_tables", "overlap_rank")),
    ("survivor partition (K3: one list; K8: one a shard)",
     ("part_count", "part_place")),
    ("fixpoint + attribution", ("fixpoint",)),
    ("merge into the history", ("merge_hist", "merge_ins")),
    ("cover, GC and compaction scans",
     ("cover_", "keep_reduce", "compact_kernel", "fill_tail",
      "scan_tiles")),
    # the external check, kernel by kernel: "searchsorted" names both
    # K6 and K1, so K6 comes first; "base_kernel" matches K5's
    # point_base_kernel and "point_ext" its flags, before "point_"
    ("external check: K6 row search", ("searchsorted_rows",)),
    ("external check: K1 segment starts", ("searchsorted_i32",)),
    ("external check: K2 range max", ("rmq_",)),
    ("external check: bounds search + shard clip (K3, K8)",
     ("ext_bounds",)),
    ("external check: flags and base",
     ("ext_flags", "point_ext", "base_kernel")),
    ("K5 runs, scatters and scans", ("point_",)),
    ("shard clip (K7)", ("clip",)),
    ("feed and result copies", ("Memcpy", "memcpy", "Memset", "memset")),
)


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
    rows = [(_device_us(e), e.count, e.key)
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
    phases = {}
    for us, n, name in rows:
        phase = next((p for p, keys in TRACE_PHASES if any(
            k in name for k in keys)), "other")
        tot = phases.setdefault(phase, [0.0, 0])
        tot[0] += us
        tot[1] += n
    for phase, (us, n) in sorted(phases.items(), key=lambda kv: -kv[1][0]):
        print(f"[{tag}] trace phase: {us / len(window):10.1f} us/batch "
              f"{n / len(window):6.1f} launches/batch  {phase}", flush=True)


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
    if TESTER_CPU_FLAG in sys.argv[1:]:
        return tester_cpu_main(sys.argv[sys.argv.index(TESTER_CPU_FLAG) + 1])
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

    probe = "--probe" in sys.argv[1:]
    tester_cpu = None if probe else TesterCpuRuns()   # beside the build
    t0 = time.perf_counter()
    _build.lib()
    print(f"[{tag}] kernel build: {time.perf_counter() - t0:.3f} s "
          f"({_build.build_info.get('units')} sources, nvcc "
          f"{_build.build_info.get('seconds', 0.0):.3f} s)", flush=True)
    if probe:
        return probe_main(tag, dev)

    check_edges(dev)
    print(f"[{tag}] edge shapes: K1-K4 bit-exact against plain", flush=True)
    check_resolve_edges(dev, tag)
    check_point_edges(dev)
    print(f"[{tag}] edge shapes: K5, K6 bit-exact against plain",
          flush=True)
    check_point_kinds(dev, tag)
    check_sharded_edges(dev)
    print(f"[{tag}] edge shapes: K7, K8 bit-exact against plain at 1 and "
          f"{N_SHARDS} shards", flush=True)
    check_sharded_kinds(dev, tag)
    check_chain_edges(dev)
    print(f"[{tag}] edge shapes: K9, K10 bit-exact against plain over 8 "
          f"chained keys; K10 at n in {TALLY_EDGES}, aligned and one byte "
          f"off", flush=True)

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

    def point_backend(device):
        return create_conflict_set("cuda-point", device=device,
                                   key_bytes=KEY_BYTES,
                                   capacity=POINT_CAPACITY)

    def sharded_backend(device):
        return create_conflict_set("sharded-cuda", device=device,
                                   key_bytes=KEY_BYTES,
                                   capacity=SHARD_CAPACITY,
                                   n_shards=N_SHARDS,
                                   split_keys=SHARD_SPLITS)

    def cpu_prefix(make, n):
        """The port on the CPU over the first `n` batches: what every GPU
        run must equal there. Returns (verdicts, state after batch n-1)."""
        t0 = time.perf_counter()
        cpu = make("cpu")
        got, _secs, _dev, snap, _host = run_streamed(
            cpu, batches[:n], snapshot_at=(n - 1,))
        print(f"[{tag}] CPU {cpu.BACKEND} run ({n} batches): "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        return got, snap[n - 1]

    def checker(label, cpu_got, cpu_snap, counts=None, verdicts=None):
        """A run's check: the verdicts of the first batches and the
        conflict counts of the CPU prefix equal the CPU run's, every
        count equals `counts[i]` and every batch's verdicts equal
        `verdicts[i]` when given, the state after the prefix (when the
        run took it) equals the CPU's, and every run ends on the first
        run's final state."""
        last, finals = len(cpu_got) - 1, []

        def check_run(name, got, state, snap):
            name = f"{label} {name}"
            for i in range(WARMUP):
                if not np.array_equal(got[i], cpu_got[i]):
                    raise AssertionError(f"{name}: verdicts of batch {i} "
                                         "differ from the CPU run")
            for i, g in enumerate(got):
                n = int(g.sum())
                want = int(cpu_got[i].sum()) if i <= last else n
                other = n if counts is None else counts[i]
                if g.shape != (N_TXNS,) or n != want or n != other:
                    raise AssertionError(
                        f"{name}: conflict count of batch {i} {n} != CPU "
                        f"{want} / interval {other}")
                if verdicts is not None and not np.array_equal(
                        g, verdicts[i]):
                    raise AssertionError(f"{name}: verdicts of batch {i} "
                                         "differ from the interval path's")
            if snap:
                s_k, s_v, s_base, s_oldest = snap[last]
                if not (torch.equal(s_k.cpu(), cpu_snap[0])
                        and torch.equal(s_v.cpu(), cpu_snap[1])
                        and (s_base, s_oldest) == cpu_snap[2:]):
                    raise AssertionError(f"{name}: state after batch "
                                         f"{last} differs from the CPU run")
            if finals and not (torch.equal(state[0], finals[0][0])
                               and torch.equal(state[1], finals[0][1])
                               and state[2] == finals[0][2]):
                raise AssertionError(f"{name}: final state differs")
            finals.append(state)

        return check_run

    def drive(make, check_run, kernels, snapshot_at):
        """Each path's timed window, once per entry of SPANS, each time on
        a fresh resolver, with the launch counts set to 0 just before and
        read just after; returns ({path: [(seconds, device ms)]}, the
        first run's counts per path, the first streamed run's verdicts,
        snapshots and final state)."""
        runs = {"streamed": [], "pipelined": []}
        counts, first = {}, None
        for rep, spans in enumerate(SPANS):
            for path in runs:
                cs = make(None)
                zero_counts()
                snap = None
                if path == "streamed":
                    got, secs, dev_ms, snap, host = run_streamed(
                        cs, batches,
                        snapshot_at=snapshot_at if rep == 0 else (),
                        spans=spans)
                else:
                    got, secs, dev_ms, host = run_pipelined(cs, batches,
                                                      spans=spans)
                c = launch_counts()
                idle = [k for k in kernels if c[k] <= 0]
                if idle:
                    raise AssertionError(f"{path} run {rep} never launched "
                                         f"{idle}")
                state = final_state(cs)
                check_run(f"{path} run {rep}", got, state, snap)
                runs[path].append((secs, dev_ms, host))
                if rep == 0:
                    counts[path] = c
                    if path == "streamed":
                        first = (got, snap, state)
                        stats = cs.kernel_stats()
                        if (stats["platform"] != "gpu"
                                or stats["h2d"]["per_batch"] != 1.0):
                            raise AssertionError(
                                f"unexpected kernel_stats: {stats}")
                del cs
        return runs, counts, first

    # the interval path
    cpu_got, cpu_snap = cpu_prefix(backend, CPU_BATCHES)
    runs, counts, (got_a, snaps_a, state_a) = drive(
        backend, checker("interval", cpu_got, cpu_snap), INTERVAL_KERNELS,
        (CPU_BATCHES - 1, mid_at, LAST))
    counts_a = counts["streamed"]
    n_conf = [int(g.sum()) for g in got_a]
    print(f"[{tag}] verdicts equal to the CPU run over {CPU_BATCHES} "
          f"batches; conflicts per batch {n_conf}; final rows {state_a[2]}",
          flush=True)

    # the point path: the port's CPU run over a prefix of the same
    # batches, long enough for GC to have pruned for several batches
    cpu_got, cpu_snap = cpu_prefix(point_backend, POINT_CPU_BATCHES)
    point_runs, point_counts, (_got_p, snaps_p, state_p) = drive(
        point_backend, checker("point", cpu_got, cpu_snap, n_conf),
        POINT_KERNELS, (POINT_CPU_BATCHES - 1, mid_at))
    counts_p = point_counts["streamed"]
    print(f"[{tag}] point verdicts equal to the CPU run over "
          f"{POINT_CPU_BATCHES} batches, conflict counts equal to the "
          f"interval path's in all {len(n_conf)}; final rows {state_p[2]}",
          flush=True)

    # the sharded path: every batch's verdicts equal the interval
    # path's, the per-shard state after the CPU prefix equals the CPU
    # run's, and the stitched history equals the interval history
    # mid-stream and at the end
    cpu_got, cpu_snap = cpu_prefix(sharded_backend, SHARDED_CPU_BATCHES)
    sharded_runs, sharded_counts, (_got_s, snaps_s, state_s) = drive(
        sharded_backend, checker("sharded", cpu_got, cpu_snap, n_conf,
                                 got_a), SHARDED_KERNELS,
        (SHARDED_CPU_BATCHES - 1, mid_at, LAST))
    counts_s = sharded_counts["streamed"]
    rows = [compare_steps(i, snaps_a[i], snaps_s[i]) for i in (mid_at, LAST)]
    print(f"[{tag}] sharded ({N_SHARDS} shards of {SHARD_CAPACITY} rows): "
          f"verdicts equal to the interval path's in all {len(n_conf)} "
          f"batches, per-shard state equal to the CPU run after "
          f"{SHARDED_CPU_BATCHES} batches, stitched history equal to the "
          f"interval history after batches {mid_at} and {LAST} ({rows[0]} "
          f"and {rows[1]} steps); final rows per shard max {state_s[2]}",
          flush=True)

    role_counts, role_kept = role_phase(tag)
    commit_counts = commit_leg_phase(tag)
    cluster_counts, cluster_batches = cluster_phase(tag)
    tester_counts, tester_batches = tester_phase(tag, tester_cpu.result)
    server_counts_, server_batches = server_phase(tag)
    host_counts, host_batches = role_host_phase(tag, role_kept)

    failover_phase(tag)

    chain_res, counts_c, chain_ctl = chain_phase(tag, dev)
    entry_phase(tag, chain_res["point"]["total"])

    if "--trace" in sys.argv[1:]:
        trace_stream(backend, batches, tag)
        trace_stream(point_backend, batches, f"{tag} point")
        trace_stream(sharded_backend, batches, f"{tag} sharded")
    nxt = mid_at + 1
    kern = measure_kernels(dev, snaps_a[mid_at], batches[nxt],
                           list(versions())[nxt])
    kern["searchsorted_i32"].update(profile_k1(dev, tag))
    kern.update(measure_point_kernels(dev, snaps_p[mid_at], batches[nxt],
                                      list(versions())[nxt]))
    shards = sharded_backend(None)
    kern.update(measure_sharded_kernels(
        dev, snaps_s[mid_at], batches[nxt], list(versions())[nxt],
        (shards._lows, shards._highs)))
    kern.update(measure_chain_kernels(dev, chain_ctl))
    window = measure_window(dev, tag)
    kern["window_upkeep"]["modes"] = window
    # the re-base (mode 0), the mode the stream runs, at the interval
    # path's array
    kern["window_upkeep"]["traced_ms"] = window["interval"][0]["warm"]
    probe = chain_probe(dev, tag)
    kern["range_max"].update({f"sharded_{k}": v for k, v in
                              kern.pop("range_max_sharded").items()})
    sources = {
        "searchsorted_i32": ("foundationdb_tpu_torch/csrc/searchsorted.cu",
                             "foundationdb_tpu/ops/keys.py:166"),
        "range_max": ("foundationdb_tpu_torch/csrc/range_max.cu",
                      "foundationdb_tpu/ops/rmq.py:69"),
        "resolve": ("foundationdb_tpu_torch/csrc/resolve.cu",
                    "foundationdb_tpu/ops/conflict_kernel.py:138"),
        "window_upkeep": ("foundationdb_tpu_torch/csrc/window.cu",
                          "foundationdb_tpu/ops/conflict_kernel.py:628"),
        "point_resolve": ("foundationdb_tpu_torch/csrc/point_resolve.cu",
                          "foundationdb_tpu/ops/point_kernel.py:85"),
        "searchsorted_rows": (
            "foundationdb_tpu_torch/csrc/searchsorted_rows.cu",
            "foundationdb_tpu/ops/keys.py:118"),
        "shard_clip": ("foundationdb_tpu_torch/csrc/shard_clip.cu",
                       "foundationdb_tpu/ops/keys.py:101"),
        "resolve_sharded": ("foundationdb_tpu_torch/csrc/resolve.cu",
                            "foundationdb_tpu/parallel/sharded_resolver.py:36"),
        "chain_gen": ("foundationdb_tpu_torch/csrc/bench_chain.cu",
                      "bench.py:164"),
        "chain_tally": ("foundationdb_tpu_torch/csrc/bench_chain.cu",
                        "bench.py:173"),
    }
    n_batches = WARMUP + TIMED
    for label, rs in (("streamed", runs["streamed"]),
                      ("pipelined", runs["pipelined"]),
                      ("point streamed", point_runs["streamed"]),
                      ("point pipelined", point_runs["pipelined"]),
                      ("sharded streamed", sharded_runs["streamed"]),
                      ("sharded pipelined", sharded_runs["pipelined"])):
        per = [secs / TIMED * 1e3 for secs, _, _ in rs]
        med = statistics.median(per)
        print(f"[{tag}] {label}: {N_TXNS / (med / 1e3):.1f} txn/s, "
              f"{med:.3f} ms/batch (median of {len(rs)} windows of {TIMED} "
              f"batches of {N_TXNS} txns: "
              f"{', '.join(f'{x:.3f}' for x in per)} ms/batch)", flush=True)
        off = [x for x, (_, d, _) in zip(per, rs) if d is None]
        on = [x for x, (_, d, _) in zip(per, rs) if d is not None]
        busy = [d / (secs * 1e3) for secs, d, _ in rs if d is not None]
        span_ms = [d / TIMED for _, d, _ in rs if d is not None]
        print(f"[{tag}] {label}: device busy "
              f"{', '.join(f'{100 * b:.1f}%' for b in busy)} of the wall "
              f"({', '.join(f'{d:.3f}' for d in span_ms)} ms/batch in "
              f"CUDA-event "
              f"spans); spans cost "
              f"{statistics.median(on) - statistics.median(off):+.3f} "
              f"ms/batch", flush=True)
        # where a window's spread comes from: a slower host moves the
        # median call; stalls (a call over 2x the median) add the excess
        host = []
        for _, _, h in rs:
            h = np.asarray(h) * 1e3
            p50 = float(np.median(h))
            slow = h[h > 2 * p50]
            host.append(f"{p50:.3f} / {np.percentile(h, 90):.3f} / "
                        f"{h.max():.3f}, {slow.size} stalls "
                        f"{(slow - p50).sum() / h.sum() * 100:.1f}%")
        print(f"[{tag}] {label}: host ms per call by window (p50 / p90 / "
              f"max, calls over 2x p50 and their excess share of the "
              f"window): {'; '.join(host)}", flush=True)
    chain_steps = 2 * CHAIN_REPEATS * CHAIN_BATCHES   # both chains' steps
    rows = []
    for name, m in kern.items():
        src, rep = sources[name]
        by_path = {"interval": counts_a[name], "point": counts_p[name],
                   "sharded": counts_s[name], "chain": counts_c[name]}
        by_path.update({f"role {b}": c[name]
                        for b, c in role_counts.items()})
        by_path["commit leg"] = commit_counts[name]
        by_path["cluster"] = cluster_counts[name]
        by_path["tester"] = tester_counts[name]
        by_path["server"] = server_counts_[name]
        by_path["role host"] = host_counts[name]
        main = ("point" if name in ("point_resolve", "searchsorted_rows")
                else "sharded" if name in ("shard_clip", "resolve_sharded")
                else "chain" if name in ("chain_gen", "chain_tally")
                else "interval")
        launches = by_path[main]
        extra = (f", {m['state_rows']} state rows" if "state_rows" in m
                 else "")
        if "unpacked_ms" in m:
            extra += (f"; unpacked entry {m['unpacked_ms']:.4f} ms, bound "
                      f"{m['unpacked_bound_ms']:.4f} ms")
        if "unpacked_traced_ms" in m:
            extra += f", traced {fmt_ms(m['unpacked_traced_ms'])}"
        if "whole_ms" in m:
            extra += (f"; whole rows {m['whole_ms']:.4f} ms, traced "
                      f"{fmt_ms(m['whole_traced_ms'])}, bound "
                      f"{m['whole_bound_ms']:.6f} ms")
        if "interval_ms" in m:
            extra += (f"; with end rows {m['interval_ms']:.4f} ms, traced "
                      f"{fmt_ms(m['interval_traced_ms'])}")
        if m["library_ms"] is not None:
            extra += f"; library {m['library_ms']:.4f} ms"
        if "traced_ms" in m:
            extra += f"; traced {fmt_ms(m['traced_ms'])}"
        if "sharded_ms" in m:
            extra += (f"; over {N_SHARDS} shards {m['sharded_ms']:.4f} ms, "
                      f"traced {fmt_ms(m['sharded_traced_ms'])}, plain "
                      f"{m['sharded_plain_ms']:.3f} ms, bound "
                      f"{m['sharded_bound_ms']:.6f} ms")
        if "library_traced_ms" in m:
            extra += f", library traced {fmt_ms(m['library_traced_ms'])}"
        if "host_us" in m:
            extra += (f"; host {m['host_us']:.2f} us a call, library "
                      f"{m['library_host_us']:.2f} us")
        print(f"[{tag}] {name}: {m['ms']:.4f} ms (plain {m['plain_ms']:.3f} "
              f"ms, bound {m['bound_ms']:.6f} ms by "
              f"{m.get('bound_by', 'bytes')}{extra}), launches/batch "
              f"{by_path['interval'] / n_batches:.3f} interval, "
              f"{by_path['point'] / n_batches:.3f} point, "
              f"{by_path['sharded'] / n_batches:.3f} sharded, "
              f"{by_path['chain'] / chain_steps:.3f} chain step, "
              + ", ".join(f"{by_path[f'role {b}'] / n:.3f} role {b}"
                          for b, _k, n in ROLE_BACKENDS)
              + f", {by_path['commit leg'] / ROLE_BATCHES:.3f} commit leg, "
              f"{by_path['cluster'] / cluster_batches:.3f} "
              f"cluster batch, {by_path['tester'] / tester_batches:.3f} "
              f"tester batch, {by_path['server'] / server_batches:.3f} "
              f"server batch, {by_path['role host'] / host_batches:.3f} "
              "role host batch", flush=True)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches,
                     "launches_by_path": by_path,
                     "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                     "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                     "bound_by": m.get("bound_by", "bytes"),
                     "library_ms": m["library_ms"],
                     "traced_ms": m.get("traced_ms"),
                     "library_traced_ms": m.get("library_traced_ms")})
        for k in ("unpacked_traced_ms", "whole_traced_ms",
                  "interval_traced_ms"):
            if k in m:
                rows[-1][k] = m[k]
        if name == "window_upkeep":
            rows[-1]["modes"] = m["modes"]
        if name == "chain_gen":
            rows[-1]["in_chain"] = probe
        if name == "shard_clip":
            # the standalone clip is timed above; on the sharded path K7
            # runs fused into the step's bounds search
            rows[-1]["fused_into"] = ("foundationdb_tpu_torch/csrc/"
                                      "resolve.cu ext_bounds_kernel<true>")
    for kind, step in (("point", "point_resolve"), ("interval", "resolve")):
        gen = kern["chain_gen"]
        bound = (kern[step]["bound_ms"] + kern["chain_tally"]["bound_ms"]
                 + gen["bound_ms" if kind == "point" else "interval_bound_ms"])
        r = chain_res[kind]
        print(f"[{tag}] {kind} chain: {r['ms_per_batch']:.4f} ms/batch "
              f"against a bound of {bound:.6f} ms (K9 + {step} + K10; the "
              f"step's bound on the {kind} path's mid-stream state); CPU "
              f"{r['cpu_ms_per_step']:.1f} ms/step over the prefix", flush=True)
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
