"""The benchmark's runner: finds a cell's configuration, traffic mix and
per-layer metrics by name, drives the port's resolver batch API over a
timed window, and checks every verdict against the plain reference.

Nothing here knows a cell: a cell names a configuration
(`BENCHMARK.json` `configs[].file`), a traffic mix
(`traffic/<name>.json`, which names its generator module under `gen/`)
and the per-layer metrics (`metrics/<name>.py`, each with `read(ctx)`).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GIB = float(1 << 30)
# a traced run traces this much past its window: the profiler's events
# of a longer trace take long to read
TRACE_SECONDS = 10.0
# the reference counts the history's rows every this many traced batches
ROW_SAMPLE = 128
# the reference's verdicts come back to the host this many batches at once
REPLAY_BLOCK = 256


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def find_cell(name: str, bench: dict | None = None):
    """(cell entry, configuration, traffic mix) of the cell `name`."""
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(ROOT, configs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(HERE, "traffic",
                                     cell["traffic"] + ".json"))
    return cell, config, traffic


def generator(traffic: dict):
    return importlib.import_module(f"portbench.gen.{traffic['generator']}")


def metric_reader(name: str):
    """`read(ctx)` of `metrics/<name>.py`."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def backend_kwargs(config: dict) -> dict:
    kw = dict(config.get("backend_kwargs", {}))
    if "split_keys" in kw:
        kw["split_keys"] = [k.encode("latin-1") for k in kw["split_keys"]]
    return kw


class Loop:
    """The closed loop: `depth` batches in flight, the next submitted as
    soon as the oldest one's verdicts are in host memory. Batch i is pool
    batch i % P at commit version v0 + i * step. Its transactions read
    at the newest commit version drained before it (as a GRV returns
    it), its probes at the oldest version the program holds."""

    def __init__(self, cs, pool, config: dict, traffic: dict):
        self.cs = cs
        self.pool = pool
        self.depth = int(traffic["in_flight"])
        self.step = int(traffic["version_step"])
        self.mwtlv = int(config["mvcc_window_versions"])
        past = int(traffic["warmup_past_window"])
        self.warmup = pool.window + past
        # the warm-up's versions cross `version_origin` half-way through
        # its batches past the first MVCC window
        self.v0 = (int(traffic["version_origin"])
                   - (pool.window + past // 2) * self.step)
        self.n = pool.n
        self.pending: deque = deque()
        self.next = 0
        # the cluster's newest commit when the loop starts
        self.read_version = self.version(-1)
        self.oldest = 0
        # batch i's (read version, oldest version before it)
        self.reads: list = []
        self.conflict_bits: list = []
        self.too_old_bits: list = []
        self.submit_s: list = []
        # (start ns, end ns, "submit" or "drain") of each call, while set
        self.spans: list | None = None

    def version(self, i: int) -> int:
        return self.v0 + i * self.step

    def submit(self) -> None:
        i = self.next
        rb, re, rt, wb, we, wt = self.pool.batch(i % self.pool.n_batches)
        v = self.version(i)
        snap = self.pool.snapshots(self.read_version, self.oldest)
        self.reads.append((self.read_version, self.oldest))
        t = time.perf_counter_ns()
        ticket = self.cs.submit_arrays(
            snap, self.pool.has_reads, rb, re, rt, wb, we, wt,
            commit_version=v, new_oldest_version=v - self.mwtlv)
        t1 = time.perf_counter_ns()
        self.submit_s.append((t1 - t) / 1e9)
        if self.spans is not None:
            self.spans.append((t, t1, "submit"))
        self.oldest = max(self.oldest, v - self.mwtlv)
        self.pending.append((ticket, i, t))
        self.next = i + 1

    def drain(self):
        """Waits for the oldest batch; returns (batch, latency s, time
        ns)."""
        ticket, i, t = self.pending.popleft()
        t0 = time.perf_counter_ns()
        conflict, too_old = self.cs.drain_arrays(ticket)
        done = time.perf_counter_ns()
        if self.spans is not None:
            self.spans.append((t0, done, "drain"))
        # a too-old transaction's conflict flag is not its verdict
        too_old = np.asarray(too_old, bool)[:self.n]
        conflict = np.asarray(conflict, bool)[:self.n] & ~too_old
        self.conflict_bits.append(np.packbits(conflict))
        self.too_old_bits.append(np.packbits(too_old))
        self.read_version = max(self.read_version, self.version(i))
        return i, (done - t) / 1e9, done

    def step_once(self):
        """Submits a batch and, with `depth` in flight, drains the
        oldest: its (batch, latency s, time ns), or None."""
        self.submit()
        if len(self.pending) >= self.depth:
            return self.drain()
        return None

    def run_batches(self, count: int) -> None:
        for _ in range(count):
            self.step_once()

    def run_for(self, seconds: float):
        """Runs until a drain lands past `seconds` from now. Returns the
        (latency s, time s into the window) of each batch drained inside
        it, and the batches submitted."""
        first = self.next
        done_in = []
        t0 = time.perf_counter_ns()
        t_end = t0 + int(seconds * 1e9)
        while True:
            got = self.step_once()
            if got is None:
                continue
            _i, lat, done = got
            if done <= t_end:
                done_in.append((lat, (done - t0) / 1e9))
            if done >= t_end:
                return done_in, self.next - first

    def finish(self) -> None:
        while self.pending:
            self.drain()


class NullResolver:
    """Stands in for the program where only the loop's schedule is
    wanted (the control): every transaction reads as committed."""

    def submit_arrays(self, snap, *_a, **_kw):
        return snap.shape[0]

    def drain_arrays(self, n):
        flags = np.zeros(n, bool)
        return flags, flags


def replay(loop, config: dict, device="cpu", count_rows_at=(),
           **ref_kwargs):
    """Replays every batch of `loop` through the plain reference on
    `device`. Yields (first batch, [k, n] uint8 flags: 1 conflict, 2 too
    old) a block of batches; returns (the history's rows after each batch
    of `count_rows_at`, the reference's counts)."""
    import torch

    from .reference.resolver import BatchShape, Reference
    pool = loop.pool
    total = loop.next
    with ThreadPoolExecutor(4) as ex:
        shapes = list(ex.map(
            lambda j: BatchShape(*pool.ids(j), device=device),
            range(min(total, pool.n_batches))))
    ref = Reference(pool.units, device=device, **ref_kwargs)
    n_shards = int(config.get("backend_kwargs", {}).get("n_shards", 1))
    contiguous = "range_ids" in config
    rows = {}
    count_rows_at = set(count_rows_at)
    flags = torch.empty((REPLAY_BLOCK, pool.n), dtype=torch.uint8,
                        device=device)
    for i in range(total):
        v = loop.version(i)
        snaps = torch.from_numpy(pool.snapshots(*loop.reads[i])).to(device)
        conflict, too_old = ref.resolve(shapes[i % pool.n_batches], snaps,
                                        v, v - loop.mwtlv)
        k = i % REPLAY_BLOCK
        flags[k] = conflict.to(torch.uint8) | (too_old.to(torch.uint8) << 1)
        if k == REPLAY_BLOCK - 1 or i == total - 1:
            yield i - k, flags[:k + 1].cpu().numpy()
        if i in count_rows_at:
            rows[i] = ref.history_rows(n_shards, contiguous)
    return rows, ref.counts


def check_verdicts(verdicts, loop, config: dict, device="cpu",
                   count_rows_at=(), **ref_kwargs):
    """Replays every batch of `loop` through the plain reference and
    compares its verdicts with `verdicts`: a (conflict bits, too-old
    bits) pair of lists, one packed array a batch. Returns (mismatched
    verdicts, the history's rows after each batch of `count_rows_at`,
    the reference's counts)."""
    conflict_bits, too_old_bits = verdicts
    mismatched = 0
    blocks = replay(loop, config, device, count_rows_at, **ref_kwargs)
    while True:
        try:
            i0, got = next(blocks)
        except StopIteration as done:
            rows, counts = done.value
            return mismatched, rows, counts
        k = got.shape[0]
        diff = ((np.packbits(got & 1, axis=1)
                 ^ np.stack(conflict_bits[i0:i0 + k]))
                | (np.packbits(got >> 1, axis=1)
                   ^ np.stack(too_old_bits[i0:i0 + k])))
        mismatched += int(np.unpackbits(diff).sum())


def mem_used(torch) -> int:
    free, total = torch.cuda.mem_get_info()
    return int(total - free)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device=None, overrides: dict | None = None, wrap=None,
             t_start: float | None = None) -> dict:
    """One run of cell `name`. `device=None` is the card. `overrides`
    ({"config": {...}, "traffic": {...}}) and `wrap` (a function of the
    conflict set returning the object the loop drives) serve the tests.
    A traced run measures the same untraced window, then traces
    `TRACE_SECONDS` more."""
    t_start = time.perf_counter() if t_start is None else t_start
    _cell, config, traffic = find_cell(name)
    overrides = overrides or {}
    config = {**config, **overrides.get("config", {})}
    traffic = {**traffic, **overrides.get("traffic", {})}

    import torch
    from foundationdb_tpu_torch.models import create_conflict_set

    on_card = device is None or torch.device(device).type == "cuda"
    used0 = None
    if on_card:
        torch.cuda.init()
        torch.cuda.set_device(0)
        used0 = mem_used(torch)
    marks = {"context": time.perf_counter()}
    pool = generator(traffic).Pool(config, traffic, seed)
    marks["pool"] = time.perf_counter()
    cs = create_conflict_set(config["backend"], init_version=0,
                             device=device, key_bytes=int(config["key_bytes"]),
                             **backend_kwargs(config))
    loop = Loop(wrap(cs) if wrap else cs, pool, config, traffic)
    loop.run_batches(loop.warmup)
    marks["warmup"] = time.perf_counter()
    used_setup = mem_used(torch) if on_card else None
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    h2d0 = cs.kernel_stats()["h2d"]["transfers"]
    first = loop.next
    done_in, submitted = loop.run_for(seconds)
    h2d = cs.kernel_stats()["h2d"]["transfers"] - h2d0
    submit_s = loop.submit_s[-submitted:]
    used_end = mem_used(torch) if on_card else None
    summary = None
    if trace and on_card:
        from .trace import traced_window
        summary = traced_window(torch, loop, TRACE_SECONDS)
    loop.finish()
    if on_card:
        torch.cuda.synchronize()
    gc.unfreeze()

    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else "cpu"),
                   "count": 1,
                   "memory_peak_bytes": (max(used_setup, used_end)
                                         if on_card else 0)}
    # the program's state is freed before the reference runs
    del cs, loop.cs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    last = first + submitted - 1
    count_at = {last}
    if summary is not None:
        tf, tn = summary.first_batch, summary.batches
        count_at |= set(range(tf - 1, tf + tn, ROW_SAMPLE)) | {tf + tn - 1}
    t_ref = time.perf_counter()
    mismatched, rows, counts = check_verdicts(
        (loop.conflict_bits, loop.too_old_bits), loop, config,
        "cuda" if on_card else "cpu", count_at)
    reference_s = time.perf_counter() - t_ref
    resolved = loop.next
    checked = len(loop.conflict_bits)
    checks = {"verdict_mismatches": {"value": mismatched, "limit": 0},
              "batches_unchecked": {"value": resolved - checked,
                                    "limit": 0}}
    correct = mismatched == 0 and checked == resolved

    n = pool.n
    result = {"correct": bool(correct),
              "attempted": (resolved - first) * n,
              "failed": (resolved - checked) * n}
    lat = np.asarray([x[0] for x in done_in])
    if not trace:
        metrics = {
            "txn_per_s": {"value": len(done_in) * n / seconds,
                          "unit": "txn/s"},
            "resolve_p95_ms": {"value": float(np.percentile(lat, 95) * 1e3),
                               "unit": "ms"},
            "device_mem_gib": {"value": ((device_info["memory_peak_bytes"]
                                          - used0) / GIB if on_card else 0.0),
                               "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    else:
        ctx = SimpleNamespace(
            config=config, traffic=traffic, n_txns=n, batches=submitted,
            submit_s=submit_s, h2d_transfers=h2d, trace=summary,
            window_batches=len(done_in), seconds=seconds,
            device_kind=device_info["kind"])
        if summary is not None:
            # rows after each traced batch, between the counted ones
            at = sorted(i for i in rows if i >= summary.first_batch - 1)
            after = np.interp(np.arange(tf - 1, tf + tn), at,
                              [rows[i] for i in at])
            ctx.rows_before, ctx.rows_after = after[:-1], after[1:]
            device_info["busy_s"] = summary.busy_s
            device_info["window_s"] = summary.window_s
            result["breakdown"] = summary.breakdown
        metrics = {}
        for m in benchmark()["per_layer"]:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device_info
    tx = max(counts["transactions"], 1)
    result["history"] = {
        "rows": rows[last], "batches": resolved,
        "window_batches": len(done_in), "reference_s": reference_s,
        "shares": {k: counts[k] / tx for k in
                   ("external", "intra_batch", "too_old")},
        "setup_parts_s": {
            "import_and_context": marks["context"] - t_start,
            "pool": marks["pool"] - marks["context"],
            "warmup": marks["warmup"] - marks["pool"]},
        "per_second": np.bincount(np.asarray(
            [x[1] for x in done_in], int)).tolist(),
        "p50_ms": float(np.percentile(lat, 50) * 1e3)}
    if summary is not None:
        result["history"]["traced"] = summary.host
    result["checks"] = checks
    return result
