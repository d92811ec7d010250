"""The host phases inside the program's `submit_arrays`, and the card's
idle time put down to the phase that was running.

The program keeps, per resolver, the totals of its host spans
(`kernel_stats()["host"]`: each phase's ns, calls and ns in waits, each
wait's ns and count, the growths, the exact live history rows) and,
while `trace_spans(True)`, a ring of single spans on
`time.perf_counter_ns`, the clock the trace's marker kernels map onto
the card's (`trace.py`). This module reads both:

- `layer_metrics`: the host metrics of a window from the totals'
  deltas over its batches (`host.prep_ms`, `host.stage_ms`,
  `host.launch_ms`, `host.readback_ms`, `host.wait_ms`) and the share
  of the rows K3/K8 sweep that are live (`step.live_share`).
- `flatten` / `idle_by_phase`: nested spans flattened to the deepest
  span at each instant, and the card's idle gaps split over them.

One measurement of a cell, from the root of a checkout with a card:

    python3 -m portbench.phases --workload ycsbf-4r.zipf --seed 7 \\
        --seconds 51 --trace-seconds 10 --ab-seconds 20 --check 1

sets the cell up as a benchmark run does, runs its untraced window
(`--seconds`) and prints its phase split, then a traced window with the
ring on (`idle_by_phase_s`), then an untraced window of `--ab-seconds`
with the ring on for every second batch (the ring's cost, batch against
neighbouring batch, which the host's drift over seconds cannot bias).
With `--check 1` the plain reference then replays every batch, as a
benchmark run does: the verdicts compared, and its history rows after
the batch of the program's last live-row sample beside that sample.
One JSON line.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from collections import defaultdict

# self time of these phases, a batch, per metric
GROUPS = {"host.prep_ms": ("check", "versions", "audit"),
          "host.stage_ms": ("stage",),
          "host.launch_ms": ("feed", "launch"),
          "host.readback_ms": ("readback",)}
OUTSIDE = "outside"
SUBMIT_SELF = "submit.self"


def host_delta(before: dict, after: dict) -> dict:
    """`kernel_stats()["host"]` of a window: `after` less `before`."""
    def sub(a, b):
        return {k: (sub(v, b.get(k, {})) if isinstance(v, dict)
                    else v - b.get(k, 0)) for k, v in a.items()}
    out = sub(after, before)
    # the last sample is a level, not a sum
    out["live"]["live_rows_last"] = after["live"]["live_rows_last"]
    out["live"]["live_rows_last_seq"] = after["live"]["live_rows_last_seq"]
    return out


def phase_split(delta: dict, batches: int) -> dict:
    """ms a batch of each phase's self time, of each wait, and of the
    whole `submit` span."""
    out = {n: (t["ns"] - t["wait_ns"]) / batches / 1e6
           for n, t in delta["phases"].items() if n != "submit"}
    out.update({n: t["ns"] / batches / 1e6
                for n, t in delta["waits"].items()})
    out["submit"] = delta["phases"]["submit"]["ns"] / batches / 1e6
    return out


def layer_metrics(delta: dict | None, batches: int) -> dict:
    """The per-layer metrics a window's host deltas give, over its
    `batches` submits: {name: value}, a metric left out where the window
    has nothing to read."""
    if not delta or not batches or not delta["phases"]["submit"]["calls"]:
        return {}
    split = phase_split(delta, batches)
    out = {name: sum(split[n] for n in names)
           for name, names in GROUPS.items()}
    out["host.wait_ms"] = delta["phases"]["submit"]["wait_ns"] \
        / batches / 1e6
    live = delta["live"]
    if live["capacity_rows_sum"] > 0:
        out["step.live_share"] = (100.0 * live["live_rows_sum"]
                                  / live["capacity_rows_sum"])
    return out


# -- the timeline --------------------------------------------------------------
def labeled(spans, loop_submits=()):
    """Nested intervals as (start, end, depth, label): the loop's own
    `submit` spans (`loop_submits`, (start, end)) at depth 0, then the
    program's ring (`traced_spans()` rows) by their parent links: its
    `submit` 1, phases 2, waits 3 and deeper. Both `submit` levels are
    labeled `submit.self`, what no deeper span covers."""
    by_id = {s[1]: s for s in spans}

    def depth(s):
        d = 1
        while s[2] != -1 and s[2] in by_id:
            s = by_id[s[2]]
            d += 1
        return d
    out = [(a, b, 0, SUBMIT_SELF) for a, b in loop_submits]
    for s in spans:
        out.append((s[4], s[5], depth(s),
                    SUBMIT_SELF if s[3] == "submit" else s[3]))
    return out


def flatten(intervals):
    """Nested (start, end, depth, label) intervals as the deepest one at
    each instant: sorted, non-overlapping (start, end, label) pieces.
    Time no interval covers yields no piece."""
    pieces = []
    stack = []                      # (end, label), the deepest on top
    at = None

    def emit(a, b, label):
        if b > a:
            if pieces and pieces[-1][1] == a and pieces[-1][2] == label:
                pieces[-1] = (pieces[-1][0], b, label)
            else:
                pieces.append((a, b, label))

    for s, e, _d, label in sorted(intervals, key=lambda x: (x[0], x[2])):
        while stack and stack[-1][0] <= s:
            end, top = stack.pop()
            if end > at:
                emit(at, end, top)
                at = end
        if stack and s > at:
            emit(at, s, stack[-1][1])
        at = s if at is None or s > at else at
        stack.append((e, label))
    while stack:
        end, top = stack.pop()
        if end > at:
            emit(at, end, top)
            at = end
    return pieces


def idle_by_phase(busy, pieces, window) -> dict:
    """Seconds of idle card in `window` (start, end) under each label of
    `pieces` (flattened, sorted), and `outside` them. `busy`: sorted,
    merged [start, end) intervals in which the card ran something."""
    w0, w1 = window
    gaps, at = [], w0
    for s, e in busy:
        if s > at:
            gaps.append((at, min(s, w1)))
        at = max(at, e)
        if at >= w1:
            break
    if at < w1:
        gaps.append((at, w1))
    idle = defaultdict(int)
    j = 0
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        covered, k = 0, j
        while k < len(pieces) and pieces[k][0] < g1:
            a, b, label = pieces[k]
            cut = min(b, g1) - max(a, g0)
            if cut > 0:
                idle[label] += cut
                covered += cut
            k += 1
        idle[OUTSIDE] += (g1 - g0) - covered
    return {k: v / 1e9 for k, v in sorted(idle.items(), key=lambda kv: -kv[1])
            if v > 0}


# -- one measurement on the card -----------------------------------------------
def traced_phases(torch, loop, seconds: float) -> dict:
    """Runs `loop` for `seconds` under the profiler (the card's activity
    alone) with the program's ring on; returns the window's idle share
    and `idle_by_phase_s`."""
    from torch.profiler import ProfilerActivity, profile

    from . import trace
    cs = loop.cs
    cs.trace_spans(True)
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    trace._marker(torch)
    m0 = trace._marker(torch)
    first = loop.next
    loop.spans = []
    t0 = time.perf_counter_ns()
    _done, submitted = loop.run_for(seconds)
    t1 = time.perf_counter_ns()
    spans, loop.spans = loop.spans, None
    m1 = trace._marker(torch)
    prof.stop()
    program = cs.traced_spans()
    cs.trace_spans(False)
    device = []
    for e in prof.profiler.kineto_results.events():
        if trace._kind(e):
            s = e.start_ns()
            device.append((s, s + e.duration_ns(), e.name()))
    del prof
    found = sorted(s for s, _e, name in device if trace.MARKER in name)
    if len(found) < 2:
        raise RuntimeError(f"the trace holds {len(found)} marker kernels")
    d0, d1 = found[-2:]
    scale = (d1 - d0) / (m1 - m0)

    def on_card(t):
        return d0 + round((t - m0) * scale)
    busy = trace.union([(s, e) for s, e, name in device
                        if trace.MARKER not in name])
    window = (on_card(t0), on_card(t1))
    program = [(q, i, p, n, on_card(a), on_card(b))
               for q, i, p, n, a, b in program]
    loop_submits = [(on_card(a), on_card(b)) for a, b, k in spans
                    if k == "submit"]
    pieces = flatten(labeled(program, loop_submits))
    idle = idle_by_phase(busy, pieces, window)
    idle_s = sum(idle.values())
    in_submit = idle_s - idle.get(OUTSIDE, 0.0)
    return {"batches": submitted, "first_batch": first,
            "window_s": (window[1] - window[0]) / 1e9,
            "idle_s": idle_s,
            "idle_in_submit_s": in_submit,
            "named_share_of_submit_idle": (
                (in_submit - idle.get(SUBMIT_SELF, 0.0)) / in_submit
                if in_submit > 0 else None),
            "ring_spans": len(program),
            "idle_by_phase_s": idle,
            "clock_scale": scale}


def window(loop, cs, seconds: float) -> dict:
    """An untraced window: its host metrics from the program's totals
    and the benchmark's own clock around each call."""
    before = cs.kernel_stats()["host"]
    _done, submitted = loop.run_for(seconds)
    delta = host_delta(before, cs.kernel_stats()["host"])
    submit_ms = sum(loop.submit_s[-submitted:]) / submitted * 1e3
    metrics = layer_metrics(delta, submitted)
    program_ms = delta["phases"]["submit"]["ns"] / submitted / 1e6
    parts = sum(v for k, v in metrics.items() if k.startswith("host."))
    return {"batches": submitted, "host.submit_ms": submit_ms,
            "program_submit_ms": program_ms,
            "parts_ms": parts,
            "outside_program_ms": submit_ms - program_ms,
            "metrics": metrics,
            "split_ms": phase_split(delta, submitted),
            "grows": delta["grows"],
            "live": delta["live"]}


class Alternate:
    """Stands in for the program in the loop with its ring of spans on
    for every second batch, and sums each phase's ns apart for the
    batches with the ring on and off."""

    def __init__(self, cs):
        from foundationdb_tpu_torch import host_spans
        self.cs = cs
        self.names = host_spans.NAMES
        cs.trace_spans(True)
        self.ring = cs.host_spans.ring
        self.on: list = []
        self.ns = {False: [0] * len(self.names),
                   True: [0] * len(self.names)}

    def submit_arrays(self, *a, **kw):
        spans = self.cs.host_spans
        on = len(self.on) % 2 == 1
        spans.ring = self.ring if on else None
        before = spans.ns[:]
        ticket = self.cs.submit_arrays(*a, **kw)
        acc = self.ns[on]
        for i, (x, y) in enumerate(zip(before, spans.ns)):
            acc[i] += y - x
        self.on.append(on)
        return ticket

    def drain_arrays(self, ticket):
        return self.cs.drain_arrays(ticket)

    def result(self, submit_s) -> dict:
        """The window's ms a batch with the ring off and on: the
        benchmark's clock around each call and the program's phases."""
        self.cs.trace_spans(False)
        out = {}
        for on in (False, True):
            k = max(self.on.count(on), 1)
            calls = [t for t, o in zip(submit_s, self.on) if o == on]
            out["on" if on else "off"] = {
                "batches": len(calls),
                "host.submit_ms": sum(calls) / k * 1e3,
                "ns_ms": {n: v / k / 1e6
                          for n, v in zip(self.names, self.ns[on])}}
        off = out["off"]["host.submit_ms"]
        out["ratio"] = (out["on"]["host.submit_ms"] / off
                        if off and out["on"]["batches"] else None)
        return out


def measure(name: str, seed: int, seconds: float, trace_seconds: float,
            ab_seconds: float, *, check: bool = False,
            device=None, overrides: dict | None = None) -> dict:
    """One measurement of cell `name` (see the module's note); on the
    CPU (`device="cpu"`) the traced window is left out."""
    import torch

    from foundationdb_tpu_torch.models import create_conflict_set

    from . import harness
    _cell, config, traffic = harness.find_cell(name)
    overrides = overrides or {}
    config = {**config, **overrides.get("config", {})}
    traffic = {**traffic, **overrides.get("traffic", {})}
    on_card = device is None or torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.init()
        torch.cuda.set_device(0)
    pool = harness.generator(traffic).Pool(config, traffic, seed)
    cs = create_conflict_set(config["backend"], init_version=0,
                             device=device,
                             key_bytes=int(config["key_bytes"]),
                             **harness.backend_kwargs(config))
    loop = harness.Loop(cs, pool, config, traffic)
    loop.run_batches(loop.warmup)
    gc.collect()
    gc.freeze()
    out = {"cell": name, "seed": seed,
           "device": (torch.cuda.get_device_name(0) if on_card else "cpu"),
           "untraced": window(loop, cs, seconds)}
    if trace_seconds > 0 and on_card:
        out["traced"] = traced_phases(torch, loop, trace_seconds)
    if ab_seconds > 0:
        loop.cs = alt = Alternate(cs)
        _done, submitted = loop.run_for(ab_seconds)
        loop.cs = cs
        out["ab"] = alt.result(loop.submit_s[-submitted:])
    loop.finish()
    if on_card:
        torch.cuda.synchronize()
    gc.unfreeze()
    if check:
        live = cs.kernel_stats()["host"]["live"]
        at = live["live_rows_last_seq"] - 1      # seq 1 is batch 0
        del cs, loop.cs
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        mismatched, rows, _counts = harness.check_verdicts(
            (loop.conflict_bits, loop.too_old_bits), loop, config,
            "cuda" if on_card else "cpu", {at})
        out["check"] = {"verdict_mismatches": mismatched,
                        "batches": len(loop.conflict_bits),
                        "live_rows_last": live["live_rows_last"],
                        "reference_rows": rows[at], "at_batch": at}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--trace-seconds", type=float, default=10.0)
    ap.add_argument("--ab-seconds", type=float, default=0.0)
    ap.add_argument("--check", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from . import harness, run
    run.cache_dirs(harness.ROOT)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the measurement runs only on the card",
              file=sys.stderr)
        return 3
    print(json.dumps(measure(args.workload, args.seed, args.seconds,
                             args.trace_seconds, args.ab_seconds,
                             check=bool(args.check))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
