"""The device timeline of a traced window, from torch.profiler's trace
of the card's activity alone (no host operations are recorded, so the
host's calls run nearly as they do untraced): kernel time, the union of
the intervals in which a kernel or a copy ran, the operations that took
most time, and the idle gaps named by what the host was doing (the
loop's own `submit` and `drain` spans on its clock; `loop` between
them). A marker kernel on an idle card before and after the window
maps the host's clock onto the trace's.

The trace costs the host time all the same (CUPTI's callbacks on every
CUDA call): `submit` runs longer in it than untraced, so its idle gaps
overstate the host's share, and the untraced window is what the host
metrics read."""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from types import SimpleNamespace

TOP = 10
MARKER = "spin_kernel"          # torch.cuda._sleep's kernel


def _kind(e) -> str:
    """"kernel", "copy" (a memcpy or memset) or "" (not on the card)."""
    if "CUDA" not in str(e.device_type()):
        return ""
    kind = getattr(e, "activity_type", None)
    kind = (kind() if callable(kind) else "").lower()
    if "memcpy" in kind or "memset" in kind or e.name().startswith(
            ("Memcpy", "Memset")):
        return "copy"
    return "kernel"


def union(intervals):
    """Sorted, merged [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce_events(device, spans, window):
    """`device`: (start ns, end ns, name, kind) of device operations;
    `spans`: (start ns, end ns, name) host spans; `window`: (start ns,
    end ns). Returns the summary of the window."""
    w0, w1 = window
    clipped = [(max(s, w0), min(e, w1), name, kind)
               for s, e, name, kind in device if e > w0 and s < w1]
    busy = union([(s, e) for s, e, _n, _k in clipped])
    busy_ns = sum(e - s for s, e in busy)
    kernel_ns = sum(e - s for s, e, _n, k in clipped if k == "kernel")
    by_name = defaultdict(int)
    for s, e, name, _k in clipped:
        by_name[name] += e - s
    spans = sorted(spans)          # one host thread: they do not overlap
    ends = [e for _s, e, _n in spans]
    idle = defaultdict(int)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for k in range(0, len(edges), 2):
        g0, g1 = edges[k], edges[k + 1]
        if g1 <= g0:
            continue
        # split the gap over the host spans that cover parts of it
        j = bisect.bisect_right(ends, g0)
        at = g0
        while j < len(spans) and spans[j][0] < g1:
            s0, s1, label = spans[j]
            if s0 > at:
                idle["loop"] += s0 - at
                at = s0
            cut = min(s1, g1)
            idle[label] += cut - at
            at = cut
            j += 1
        idle["loop"] += g1 - at
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(((k, v) for k, v in idle.items() if v > 0),
                  key=lambda kv: -kv[1])[:TOP]
    return SimpleNamespace(
        window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
        kernel_s=kernel_ns / 1e9,
        breakdown={"device_ops": [[n, v / 1e9] for n, v in top],
                   "idle_gaps": [[n, v / 1e9] for n, v in gaps]})


def _marker(torch) -> int:
    """The host's clock (ns) as a marker kernel is launched on an idle
    card."""
    torch.cuda.synchronize()
    t = time.perf_counter_ns()
    torch.cuda._sleep(10_000)
    torch.cuda.synchronize()
    return t


def traced_window(torch, loop, seconds: float):
    """Runs `loop` for `seconds` under the profiler and returns the
    summary of that window, with the batches submitted in it
    (`first_batch`, `batches`) and the host's submit time there."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    _marker(torch)                 # the first launch traced runs long
    m0 = _marker(torch)
    first = loop.next
    loop.spans = []
    t0 = time.perf_counter_ns()
    _done, submitted = loop.run_for(seconds)
    t1 = time.perf_counter_ns()
    spans, loop.spans = loop.spans, None
    m1 = _marker(torch)
    prof.stop()
    summary = summarize(prof, spans, (t0, t1), (m0, m1))
    del prof
    summary.first_batch, summary.batches = first, submitted
    summary.host["submit_ms"] = (sum(loop.submit_s[-submitted:])
                                 / submitted * 1e3)
    return summary


def summarize(prof, spans, window, marks):
    """The summary of a stopped profile: `spans` and `window` are on the
    host's clock, `marks` the host's times of the two marker kernels."""
    device = []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if kind:
            s = e.start_ns()
            device.append((s, s + e.duration_ns(), e.name(), kind))
    found = sorted(s for s, _e, name, _k in device if MARKER in name)
    if len(found) < 2:
        raise RuntimeError(f"the trace holds {len(found)} marker kernels")
    (h0, h1), (d0, d1) = marks, found[-2:]
    scale = (d1 - d0) / (h1 - h0)

    def on_card(t):
        return d0 + round((t - h0) * scale)
    device = [d for d in device if MARKER not in d[2]]
    out = reduce_events(device,
                        [(on_card(s), on_card(e), n) for s, e, n in spans],
                        (on_card(window[0]), on_card(window[1])))
    out.host = {"clock_offset_ns": d0 - h0, "clock_scale": scale}
    return out
