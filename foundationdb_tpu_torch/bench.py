"""North-star benchmark of the port: conflict-resolution throughput on
the CUDA backends.

    python -m foundationdb_tpu_torch.bench [--cpu] [--dry]

The port's counterpart of the repository's `bench.py`, mode for mode,
reading the same `FDBTPU_BENCH_*` variables. Workload: the reference
conflict-set microbench's shape (`fdbserver -r skiplisttest`,
fdbserver/SkipList.cpp:1412-1551): 16-byte point keys, READS point
reads and one point write per transaction, uniform over the keyspace,
snapshots one VERSION_STEP behind, the MVCC window advancing per
MAX_WRITE_TRANSACTION_LIFE_VERSIONS.

Modes (FDBTPU_BENCH_BACKEND, default `all`):

  cuda-point              the device-driven K5 chain (ops/bench_chain.py)
  cuda                    the device-driven K3 chain
  cuda-streamed           create_conflict_set("cuda-point"), resolve_arrays
                          over host batches from default_rng(20260729)
  cuda-streamed-interval  the same through create_conflict_set("cuda")
  cuda-pipelined          submit_arrays / drain_arrays at depth
                          FDBTPU_BENCH_PIPELINE_DEPTH
  python, native          the CPU baselines through the object API
  native-streamed         the native backend's C-ABI row, pre-marshalled,
                          with its empty-batch call floor
  all                     every mode above; the pipelined depth swept over
                          {1, 2, 4, 8}

Other variables: FDBTPU_BENCH_TXNS (batch size, 16384),
FDBTPU_BENCH_BATCHES (timed batches, 100), FDBTPU_BENCH_KEYS (keyspace,
4,000,000), FDBTPU_BENCH_READS (reads per txn, 1), FDBTPU_BENCH_REPEATS
(chain repeats, 4), FDBTPU_BENCH_DRY_BATCHES (40).

`all` refuses to publish (raises, no JSON line) when the native
object-API and streamed rows count different conflicts, when the
pipelined depths do, when the two streamed backends do, or when the
point and interval chains do: each pair resolves the same batches.

`--cpu` runs every mode on the kernels' plain PyTorch versions (the
tests use it). Without it the device modes need a CUDA card: with none,
the entry prints an error record with value 0 and exits 2; it never
falls back to the CPU. `--dry` runs the parity gate instead of a bench
round (see `run_dry`).

Prints exactly one JSON line: metric `resolver_throughput`, value in
conflict-checked transactions per second, `vs_baseline` against the
north-star 1e6 txn/s (BASELINE.json), the configuration with the card's
name and power limit, and each mode's numbers under `sub_metrics`.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import deque

import numpy as np

TARGET_TXN_PER_S = 1_000_000.0  # north star (BASELINE.json)
MWTLV = 5_000_000
KEY_BYTES = 16
N_WORDS = KEY_BYTES // 4
READS_PER_TXN = int(os.environ.get("FDBTPU_BENCH_READS", 1))
VERSION_STEP = 250_000
WINDOW_BATCHES = MWTLV // VERSION_STEP
STREAM_SEED = 20260729
DRY_SEED = 20260804
DEVICE_MODES = ("cuda-point", "cuda", "cuda-streamed",
                "cuda-streamed-interval", "cuda-pipelined")
MODES = DEVICE_MODES + ("python", "native", "native-streamed", "all")


def make_batch(rng, n_txns, keyspace, version):
    """Pre-encoded arrays for one batch: 16-byte big-endian point keys,
    the id in the low words; the end key is key + b"\\x00", the same
    words with length 17."""
    rk = rng.integers(0, keyspace, size=n_txns * READS_PER_TXN, dtype=np.int64)
    wk = rng.integers(0, keyspace, size=n_txns, dtype=np.int64)

    def enc(idx, end):
        k = np.zeros((idx.shape[0], N_WORDS + 1), np.uint32)
        k[:, N_WORDS - 2] = (idx >> 32).astype(np.uint32)
        k[:, N_WORDS - 1] = (idx & 0xFFFFFFFF).astype(np.uint32)
        k[:, N_WORDS] = KEY_BYTES + 1 if end else KEY_BYTES
        return k

    snapshots = np.full(n_txns, version - VERSION_STEP, np.int64)
    has_reads = np.ones(n_txns, bool)
    rt = np.repeat(np.arange(n_txns, dtype=np.int32), READS_PER_TXN)
    wt = np.arange(n_txns, dtype=np.int32)
    return (snapshots, has_reads, enc(rk, False), enc(rk, True), rt,
            enc(wk, False), enc(wk, True), wt)


def _rate(tps):
    return {"txn_per_s": round(tps, 1),
            "vs_baseline": round(tps / TARGET_TXN_PER_S, 4)}


# ---------------------------------------------------------------------------
# the device modes
# ---------------------------------------------------------------------------

def bench_chain(kind, n_txns, n_batches, keyspace, device):
    """The device-driven chain (`bench.py:122 bench_tpu_point` for
    "point", `:201 bench_tpu` for "interval"): best of
    FDBTPU_BENCH_REPEATS runs. Returns (txn/s, conflicts, detail)."""
    from .ops.bench_chain import measure_chain
    m = measure_chain(kind, n_txns, n_batches, keyspace,
                      int(os.environ.get("FDBTPU_BENCH_REPEATS", 4)),
                      device, READS_PER_TXN)
    dev_ms = m["device_ms"]
    return m["txn_per_s"], m["conflicts"], {
        "ms_per_batch": round(m["ms_per_batch"], 4),
        "device_ms_per_batch": (round(dev_ms / n_batches, 4)
                                if dev_ms is not None else None),
        "enqueue_ms_per_step": round(m["enqueue_ms_per_step"], 4),
        "cap": m["cap"], "audit_rows": m["audit_rows"]}


def bench_streamed(n_txns, n_batches, keyspace, device, backend="point"):
    """Host-fed path (`bench.py:282`): one packed H2D feed and one
    resolve step per batch through `resolve_arrays`; verdicts are
    awaited only at the end. Returns (txn/s, conflicts, h2d stats)."""
    from .models import create_conflict_set
    from .ops.keys import next_pow2

    rng = np.random.default_rng(STREAM_SEED)
    cap = next_pow2((WINDOW_BATCHES + 2) * n_txns + 2)
    if backend == "point":
        cs = create_conflict_set("cuda-point", device=device,
                                 key_bytes=KEY_BYTES, capacity=cap)
    else:
        cs = create_conflict_set("cuda", device=device, key_bytes=KEY_BYTES,
                                 capacity=next_pow2(2 * cap))
    warmup = 3
    batches = [make_batch(rng, n_txns, keyspace, (i + 1) * VERSION_STEP)
               for i in range(warmup + n_batches)]
    results, t0 = [], None
    for i, b in enumerate(batches):
        v = (i + 1) * VERSION_STEP
        conflict, _too_old = cs.resolve_arrays(
            *b, commit_version=v, new_oldest_version=max(0, v - MWTLV))
        results.append(conflict)
        if i + 1 == warmup:
            np.asarray(results[-1])
            t0 = time.perf_counter()
    n_conflicts = int(sum(np.asarray(c)[:n_txns].sum()
                          for c in results[warmup:]))
    elapsed = time.perf_counter() - t0
    return (n_batches * n_txns / elapsed, n_conflicts,
            cs.kernel_stats()["h2d"])


def bench_pipelined(n_txns, n_batches, keyspace, depth, device):
    """Host-fed resolve through submit/drain at a fixed in-flight window
    of `depth` batches (`bench.py:354`). Returns (txn/s, conflicts,
    pipeline stats)."""
    from .flow.knobs import SERVER_KNOBS
    from .models import create_conflict_set
    from .ops.keys import next_pow2

    rng = np.random.default_rng(STREAM_SEED)
    cap = next_pow2((WINDOW_BATCHES + 2) * n_txns + 2)
    saved = int(SERVER_KNOBS.resolve_pipeline_depth)
    SERVER_KNOBS.set("RESOLVE_PIPELINE_DEPTH", depth)
    try:
        cs = create_conflict_set("cuda-point", device=device,
                                 key_bytes=KEY_BYTES, capacity=cap)
        warmup = 3
        batches = [make_batch(rng, n_txns, keyspace, (i + 1) * VERSION_STEP)
                   for i in range(warmup + n_batches)]

        def submit(i):
            v = (i + 1) * VERSION_STEP
            return cs.submit_arrays(*batches[i], commit_version=v,
                                    new_oldest_version=max(0, v - MWTLV))

        for i in range(warmup):
            cs.drain_arrays(submit(i))
        pending: deque = deque()
        n_conflicts = 0
        t0 = time.perf_counter()
        for j in range(n_batches):
            pending.append(submit(warmup + j))
            if len(pending) >= depth:
                n_conflicts += int(cs.drain_arrays(pending.popleft())[0].sum())
        while pending:
            n_conflicts += int(cs.drain_arrays(pending.popleft())[0].sum())
        elapsed = time.perf_counter() - t0
        stats = _compact_pipeline_stats(cs.pipeline_stats())
    finally:
        SERVER_KNOBS.set("RESOLVE_PIPELINE_DEPTH", saved)
    return n_batches * n_txns / elapsed, n_conflicts, stats


def _compact_pipeline_stats(pipe: dict) -> dict:
    lat = pipe.get("latency") or {}
    out = {k: pipe.get(k) for k in ("depth", "occupancy", "peak_in_flight",
                                    "submits", "drains", "forced_drains")}
    for stage in ("submit", "drain"):
        snap = lat.get(stage) or {}
        out[f"{stage}_p50_s"] = snap.get("p50")
        out[f"{stage}_p99_s"] = snap.get("p99")
    return out


def _measure_transport(device) -> dict:
    """The counterpart of the reference's link figures: an empty
    kernel's round trip (launch, one int32 back to the host) and the
    rate of an 8 MB H2D copy from pinned memory."""
    import torch
    if device.type != "cuda":
        return {"dispatch_roundtrip_ms": None, "h2d_mb_s": None,
                "note": "cpu run: no card"}
    x = torch.zeros(8, dtype=torch.int32, device=device)
    (x + 1)[:1].cpu()
    t0 = time.perf_counter()
    n_disp = 10
    for _ in range(n_disp):
        (x + 1)[:1].cpu()
    dispatch_ms = (time.perf_counter() - t0) / n_disp * 1e3
    host = torch.zeros(2 * 1024 * 1024, dtype=torch.int32, pin_memory=True)
    dst = torch.empty_like(host, device=device)
    dst.copy_(host, non_blocking=True)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(3):
        dst.copy_(host, non_blocking=True)
        torch.cuda.synchronize(device)
    h2d = (time.perf_counter() - t0) / 3
    return {"dispatch_roundtrip_ms": round(dispatch_ms, 4),
            "h2d_mb_s": round(8.0 / h2d, 1)}


# ---------------------------------------------------------------------------
# the CPU baselines
# ---------------------------------------------------------------------------

def _obj_batch(rng, n_txns, keyspace, v):
    """One object-API batch (the CPU baselines and the native streamed
    row share the rng, the draw order and the 16-byte point keys, so
    their conflict counts are comparable)."""
    from .models import ResolverTransaction

    txns = []
    for _ in range(n_txns):
        reads = []
        for _ in range(READS_PER_TXN):
            kb = int(rng.integers(0, keyspace)).to_bytes(KEY_BYTES, "big")
            reads.append((kb, kb + b"\x00"))
        kb = int(rng.integers(0, keyspace)).to_bytes(KEY_BYTES, "big")
        txns.append(ResolverTransaction(v - VERSION_STEP, tuple(reads),
                                        ((kb, kb + b"\x00"),)))
    return txns


def bench_cpu(backend, n_txns, n_batches, keyspace):
    """A CPU baseline through the object API (`bench.py:443`); batch
    construction stays outside the timed region."""
    from .models import create_conflict_set

    rng = np.random.default_rng(STREAM_SEED)
    cs = create_conflict_set(backend)
    prebuilt = [((i + 1) * VERSION_STEP,
                 _obj_batch(rng, n_txns, keyspace, (i + 1) * VERSION_STEP))
                for i in range(n_batches)]
    n_conflicts = 0
    t0 = time.perf_counter()
    for v, txns in prebuilt:
        verdicts = cs.resolve(txns, v, max(0, v - MWTLV))
        n_conflicts += sum(1 for x in verdicts if x == 0)
    return n_batches * n_txns / (time.perf_counter() - t0), n_conflicts


def bench_native_streamed(n_txns, n_batches, keyspace):
    """The native backend's C-ABI row (`bench.py:468`): marshalling out
    of the timed region, one ctypes call per batch; then the floor of
    an empty-batch call and the throughput if the kernel were free.
    Conflict counts equal the object-API `native` row's at equal batch
    counts (same rng, draw order and versions; the warm-up calls are
    empty batches at version 0)."""
    import ctypes

    from .models.native_backend import NativeConflictSet, _marshal, _ptr

    rng = np.random.default_rng(STREAM_SEED)
    cs = NativeConflictSet()
    lib, handle = cs._lib, cs._handle
    pre = []
    for i in range(n_batches):
        v = (i + 1) * VERSION_STEP
        pre.append((v, _marshal(_obj_batch(rng, n_txns, keyspace, v)),
                    np.empty(n_txns, np.uint8)))

    def call(v, arrays, out, n):
        snapshots, rc, wc, blob, rr, wr = arrays
        lib.fdbtpu_conflictset_resolve(
            handle, v, max(0, v - MWTLV), n,
            _ptr(snapshots, ctypes.c_int64), _ptr(rc, ctypes.c_int32),
            _ptr(wc, ctypes.c_int32), _ptr(blob, ctypes.c_uint8),
            _ptr(rr, ctypes.c_int64), _ptr(wr, ctypes.c_int64),
            _ptr(out, ctypes.c_uint8))

    empty = _marshal([])
    eout = np.empty(1, np.uint8)
    for _ in range(10):
        call(0, empty, eout, 0)
    t0 = time.perf_counter()
    for v, arrays, out in pre:
        call(v, arrays, out, n_txns)
    elapsed = time.perf_counter() - t0
    txn_per_s = n_batches * n_txns / elapsed
    n_conflicts = int(sum(int((out == 0).sum()) for _v, _a, out in pre))
    v = pre[-1][0]
    n_probe = 500
    t0 = time.perf_counter()
    for j in range(n_probe):
        call(v + (j + 1) * VERSION_STEP, empty, eout, 0)
    floor_s = (time.perf_counter() - t0) / n_probe
    ceiling = n_txns / floor_s if floor_s > 0 else None
    return txn_per_s, n_conflicts, {
        "abi_call_floor_us": round(floor_s * 1e6, 2),
        "abi_ceiling_txn_per_s": round(ceiling, 1) if ceiling else None,
        "pct_of_abi_ceiling": (round(100.0 * txn_per_s / ceiling, 2)
                               if ceiling else None),
        "batch_wall_us": round(elapsed / n_batches * 1e6, 1)}


def cpu_sub_metrics(n_txns, n_batches, keyspace) -> dict:
    """The native and pure-Python baselines on the same host, and the
    native streamed row, which must count the object-API row's
    conflicts. Batch counts are capped (the prebuilt object batches are
    ~16k Python objects each)."""
    out = {}
    for name, nb in (("native", min(n_batches, 25)),
                     ("python", min(n_batches, 10))):
        tps, nc = bench_cpu(name, n_txns, nb, keyspace)
        out[name] = {**_rate(tps), "batches": nb, "conflicts": nc}
    nb = min(n_batches, 25)
    tps, nc, detail = bench_native_streamed(n_txns, nb, keyspace)
    if nc != out["native"]["conflicts"]:
        raise RuntimeError(
            f"native streamed vs object-API conflict counts diverged: "
            f"{nc} vs {out['native']['conflicts']} - refusing to publish")
    out["native-streamed"] = {**_rate(tps), "batches": nb, "conflicts": nc,
                              **detail}
    return out


# ---------------------------------------------------------------------------
# the parity gate
# ---------------------------------------------------------------------------

def run_dry(device) -> int:
    """The parity gate (`bench.py --dry`): seeded random interval
    batches (mixed widths, empty ranges, tooOld snapshots, growth from
    a 1024-row history) resolved with attribution through
    `CudaConflictSet`'s packed feed; verdicts and attribution must equal
    `PyConflictSet`'s, verdicts `BruteForceConflictSet`'s. The port's
    resolver has only the packed feed, so the reference's unpacked leg
    has no counterpart here. No timing is published."""
    import random

    from .models import (BruteForceConflictSet, PyConflictSet,
                         ResolverTransaction)
    from .models.cuda_resolver import CudaConflictSet

    rng = random.Random(DRY_SEED)

    def rrange():
        a = bytes([rng.randrange(256), rng.randrange(8)])
        b = bytes([rng.randrange(256), rng.randrange(8)])
        if a > b:
            a, b = b, a
        if a == b:
            b = a + (b"\x00" if rng.random() < 0.9 else b"")  # some empty
        return a, b

    n_batches = int(os.environ.get("FDBTPU_BENCH_DRY_BATCHES", 40))
    version, batches = 0, []
    for _ in range(n_batches):
        version += rng.randrange(1, 400_000)
        batch = [ResolverTransaction(
            max(0, version - rng.randrange(0, int(1.4 * MWTLV))),
            tuple(rrange() for _ in range(rng.randrange(0, 5))),
            tuple(rrange() for _ in range(rng.randrange(0, 5))))
            for _ in range(rng.randrange(1, 24))]
        batches.append((version, max(0, version - MWTLV), batch))

    cs = CudaConflictSet(capacity=1 << 10, device=device)  # forces growth
    packed = [cs.resolve_with_attribution(b, v, o) for v, o, b in batches]
    py = PyConflictSet()
    python = [py.resolve_with_attribution(b, v, o) for v, o, b in batches]
    bf = BruteForceConflictSet()
    bf_verdicts = [bf.resolve(b, v, o) for v, o, b in batches]

    detail = ""
    for i, (a, b) in enumerate(zip(packed, python)):
        if a != b:
            detail = f"packed vs python diverged at batch {i}: {a} != {b}"
            break
    if not detail:
        for i, (a, v) in enumerate(zip(packed, bf_verdicts)):
            if a[0] != v:
                detail = (f"packed vs brute-force verdicts diverged at "
                          f"batch {i}: {a[0]} != {v}")
                break
    n_conf = sum(sum(1 for x in v if x == 0) for v, _a in packed)
    print(json.dumps({
        "metric": "packed_interval_parity", "dry": True, "ok": not detail,
        "batches": n_batches,
        "txns": sum(len(b) for _v, _o, b in batches),
        "conflicts": n_conf, "device": card_info(device),
        **({"error": detail} if detail else {})}))
    sys.stdout.flush()
    return 0 if not detail else 1


# ---------------------------------------------------------------------------
# the entry
# ---------------------------------------------------------------------------

def card_info(device) -> dict:
    """The card's name and power limit (`nvidia-smi`), or the CPU."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    import torch
    limit = None
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader",
                            f"--id={device.index or 0}"],
                           capture_output=True, text=True, timeout=60)
        if r.returncode == 0 and r.stdout.strip():
            limit = r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return {"name": torch.cuda.get_device_name(device), "power_limit": limit}


def _pipeline_depth() -> int:
    return max(1, int(os.environ.get("FDBTPU_BENCH_PIPELINE_DEPTH", 4)))


def _run_all(n_txns, n_batches, keyspace, device) -> dict:
    sub = {}
    chains = {}
    for mode, kind in (("cuda-point", "point"), ("cuda", "interval")):
        tps, nc, detail = bench_chain(kind, n_txns, n_batches, keyspace,
                                      device)
        sub[mode] = {**_rate(tps), "conflicts": nc, **detail}
        chains[mode] = nc
    if chains["cuda-point"] != chains["cuda"]:
        raise RuntimeError(f"point and interval chains diverged: {chains} "
                           f"- refusing to publish")
    streamed = {}
    for mode, backend in (("cuda-streamed", "point"),
                          ("cuda-streamed-interval", "interval")):
        tps, nc, h2d = bench_streamed(n_txns, n_batches, keyspace, device,
                                      backend)
        sub[mode] = {**_rate(tps), "conflicts": nc, "h2d": h2d}
        streamed[mode] = nc
    if len(set(streamed.values())) != 1:
        raise RuntimeError(f"per-mode conflict counts diverged: {streamed} "
                           f"- refusing to publish")
    pdepth = _pipeline_depth()
    by_depth, conflicts_by_depth, pipe_by_depth = {}, {}, {}
    for k in sorted({1, 2, 4, 8} | {pdepth}):
        tps, nc, pstats = bench_pipelined(n_txns, n_batches, keyspace, k,
                                          device)
        by_depth[str(k)] = round(tps, 1)
        conflicts_by_depth[str(k)] = nc
        pipe_by_depth[str(k)] = pstats
    if len(set(conflicts_by_depth.values())) != 1:
        raise RuntimeError(f"pipelined conflict counts diverged across "
                           f"depths: {conflicts_by_depth}")
    head = by_depth[str(pdepth)]
    sub["cuda-pipelined"] = {
        **_rate(head), "depth": pdepth, "txn_per_s_by_depth": by_depth,
        "conflicts": conflicts_by_depth[str(pdepth)],
        "pipeline_stats": pipe_by_depth[str(pdepth)],
        "pipeline_stats_by_depth": pipe_by_depth,
        "speedup_vs_serial": (round(head / by_depth["1"], 2)
                              if by_depth["1"] else None)}
    sub["transport"] = _measure_transport(device)
    sub.update(cpu_sub_metrics(n_txns, n_batches, keyspace))
    sub["cross_checks"] = {
        "chains_equal": chains, "streamed_equal": streamed,
        "pipelined_equal_across_depths": conflicts_by_depth,
        "native_rows_equal": {
            "native": sub["native"]["conflicts"],
            "native-streamed": sub["native-streamed"]["conflicts"]}}
    return sub


def main() -> int:
    import torch

    from .flow.knobs import SERVER_KNOBS

    argv = sys.argv[1:]
    cpu = "--cpu" in argv
    backend = os.environ.get("FDBTPU_BENCH_BACKEND", "all")
    if backend not in MODES:
        raise ValueError(f"unknown FDBTPU_BENCH_BACKEND {backend!r}; one of "
                         f"{', '.join(MODES)}")
    needs_card = "--dry" in argv or backend in DEVICE_MODES + ("all",)
    if needs_card and not cpu and not torch.cuda.is_available():
        print(json.dumps({
            "metric": "resolver_throughput", "value": 0, "unit": "txn/s",
            "vs_baseline": 0.0,
            "error": "no CUDA device: the device modes need a card "
                     "(--cpu runs the plain PyTorch versions)"}))
        sys.stdout.flush()
        return 2
    from . import device as _device
    device = _device.resolve("cpu" if cpu or not needs_card else None)
    if "--dry" in argv:
        return run_dry(device)
    # the periodic kernel-profiling fence would drain the pipeline the
    # streamed path depends on: the bench measures the unfenced pipeline
    SERVER_KNOBS.set("KERNEL_PROFILE_EVERY", 0)
    n_txns = int(os.environ.get("FDBTPU_BENCH_TXNS", 16384))
    n_batches = int(os.environ.get("FDBTPU_BENCH_BATCHES", 100))
    keyspace = int(os.environ.get("FDBTPU_BENCH_KEYS", 4_000_000))

    sub = {}
    if backend == "all":
        sub = _run_all(n_txns, n_batches, keyspace, device)
        head = "cuda-streamed"
        txn_per_s = sub[head]["txn_per_s"]
        n_conflicts = sub[head]["conflicts"]
    elif backend in ("cuda-point", "cuda"):
        kind = "point" if backend == "cuda-point" else "interval"
        txn_per_s, n_conflicts, sub[backend] = bench_chain(
            kind, n_txns, n_batches, keyspace, device)
    elif backend in ("cuda-streamed", "cuda-streamed-interval"):
        txn_per_s, n_conflicts, h2d = bench_streamed(
            n_txns, n_batches, keyspace, device,
            "point" if backend == "cuda-streamed" else "interval")
        sub[backend] = {"h2d": h2d}
    elif backend == "cuda-pipelined":
        pdepth = _pipeline_depth()
        txn_per_s, n_conflicts, pstats = bench_pipelined(
            n_txns, n_batches, keyspace, pdepth, device)
        sub[backend] = {"depth": pdepth, "pipeline_stats": pstats}
    elif backend == "native-streamed":
        txn_per_s, n_conflicts, sub[backend] = bench_native_streamed(
            n_txns, n_batches, keyspace)
        nb_obj = min(n_batches, 25)
        tps_obj, nc_obj = bench_cpu("native", n_txns, nb_obj, keyspace)
        sub["native"] = {"txn_per_s": round(tps_obj, 1), "batches": nb_obj,
                         "conflicts": nc_obj,
                         "note": "object API: per-batch Python marshalling "
                                 "inside the timed region"}
        sub[backend]["speedup_vs_object_api"] = (
            round(txn_per_s / tps_obj, 2) if tps_obj else None)
    else:
        txn_per_s, n_conflicts = bench_cpu(backend, n_txns, n_batches,
                                           keyspace)
    print(json.dumps({
        "metric": "resolver_throughput",
        "value": round(txn_per_s, 1),
        "unit": "txn/s",
        "vs_baseline": round(txn_per_s / TARGET_TXN_PER_S, 4),
        "config": {
            "backend": "cuda-streamed" if backend == "all" else backend,
            "batch_txns": n_txns, "batches": n_batches,
            "reads_per_txn": READS_PER_TXN, "writes_per_txn": 1,
            "keyspace": keyspace, "window_batches": WINDOW_BATCHES,
            "key_bytes": KEY_BYTES, "conflicts": n_conflicts,
            "device": card_info(device),
        },
        "sub_metrics": sub,
    }))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
