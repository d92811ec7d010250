"""Merge per-process trace files into cross-process commit trees.

Reference: the reference cluster writes one XML/JSON trace file per
process and the commit-debug stations (g_traceBatch) are reassembled
OFFLINE by contrib tooling — no process ever sees the whole picture
live. This is that tool for the run directories the soak harness and
clusterbench workers write: each process dumps
role+pid-stamped span lines (flow/trace.py, `Process=` /
`RemoteParent*=` fields) plus client-side `WireHop` events carrying
the four NTP-style timestamps of every traced TCP request/reply pair.

The merge: estimate each process's clock offset from the hop
timestamps (median of ((t1-t0)+(t2-t3))/2 per process pair, chained
from a root process — no trusted wall clock anywhere), stitch spans
into per-debug-id trees across the process boundary via the
RemoteParent links, order the merged timeline skew-tolerantly (tree
order wins over adjusted timestamps when a child's clock says it
started before its parent), and emit a human report (slowest commits
end-to-end with a per-hop breakdown) plus flamegraph-ready folded
stacks (`flamegraph.pl` / speedscope).

    python -m foundationdb_tpu_torch.tools.tracemerge <run_dir> \
        [--top N] [--out report.txt] [--folded stacks.folded] [--json doc.json]
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional, Tuple

#: process name for span lines written without a process identity (no
#: Process field, no ProcessIdentity header) — single-process sim traces merge
#: under this one identity
LOCAL_PROCESS = "local"


# ---------------------------------------------------------------- loading
def _segment_index(name: str) -> int:
    """Rolled-generation ordinal: `trace.x.jsonl.N` segments are older
    than the bare `trace.x.jsonl` (flow/trace.py rolls aside as .1, .2,
    ... with the bare path always newest), so N orders and the bare
    file sorts last."""
    tail = name.rsplit(".", 1)[-1]
    return int(tail) if tail.isdigit() else (1 << 62)


def trace_file_groups(run_dir: str) -> List[List[str]]:
    """Trace files grouped per base file, each group's rolled segments
    in WRITE order — .1 (oldest), .2, ..., bare (newest). Numeric
    ordering matters: a lexicographic sort reads .10 before .2 and
    would interleave an hours-long worker's spans out of order."""
    groups: Dict[str, List[str]] = {}
    for name in os.listdir(run_dir):
        if not (name.startswith("trace.") and ".jsonl" in name):
            continue
        base = name[:name.index(".jsonl") + len(".jsonl")]
        groups.setdefault(base, []).append(name)
    return [[os.path.join(run_dir, n)
             for n in sorted(groups[base], key=_segment_index)]
            for base in sorted(groups)]


def trace_files(run_dir: str) -> List[str]:
    """Every trace file in the run directory, rolled generations
    included (trace.<role>.<pid>.jsonl and .jsonl.N), in read order."""
    return [p for group in trace_file_groups(run_dir) for p in group]


def load_run(run_dir: str) -> dict:
    """Parse every trace file: span rows, wire-hop rows, and the
    per-process span counts. A broken line is skipped, never fatal — a
    kill -9 mid-write must not hide the rest of the run. Rolled
    segments of one base file are read as ONE stream sharing one
    ProcessIdentity: a pre-fix segment without its own header still
    attributes to its file group, not to the local-process bucket."""
    spans: List[dict] = []
    hops: List[dict] = []
    skipped = 0
    for group in trace_file_groups(run_dir):
        rows = []
        for path in group:
            with open(path) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rows.append(json.loads(line))
                    except ValueError:
                        skipped += 1
        default_proc = LOCAL_PROCESS
        for ev in rows:
            if ev.get("Type") == "ProcessIdentity" and ev.get("ID"):
                default_proc = ev["ID"]
                break
        for ev in rows:
            t = ev.get("Type")
            if t == "Span":
                remote = None
                if ev.get("RemoteParentID") is not None:
                    remote = (ev.get("RemoteParentProcess", ""),
                              ev["RemoteParentID"])
                begin = ev.get("Begin", 0.0) or 0.0
                end = ev.get("End")
                spans.append({
                    "process": ev.get("Process") or default_proc,
                    "span_id": ev.get("SpanID"),
                    "parent_id": ev.get("ParentID"),
                    "remote": remote,
                    "debug_id": str(ev.get("ID", "")),
                    "location": ev.get("Location", ""),
                    "begin": begin,
                    "end": end if end is not None else begin,
                })
            elif t == "WireHop":
                hops.append({
                    "client": ev.get("Client") or default_proc,
                    "server": ev.get("Server", ""),
                    "ids": [str(d) for d in ev.get("DebugIDs", ())],
                    "t0": ev.get("T0"), "t1": ev.get("T1"),
                    "t2": ev.get("T2"), "t3": ev.get("T3"),
                })
    return {"run_dir": run_dir, "spans": spans, "hops": hops,
            "skipped_lines": skipped}


# ---------------------------------------------------------------- offsets
def _median(sorted_vals: List[float]) -> float:
    n = len(sorted_vals)
    mid = n // 2
    if n % 2:
        return sorted_vals[mid]
    return (sorted_vals[mid - 1] + sorted_vals[mid]) / 2.0


def estimate_offsets(hops: List[dict], spans: List[dict] = (),
                     root: Optional[str] = None
                     ) -> Tuple[str, Dict[str, float], dict]:
    """Per-process clock offsets from the hop timestamp quads.

    For one (client, server) pair the NTP local-offset formula
    ((t1-t0)+(t2-t3))/2 estimates `server_clock - client_clock` per
    exchange; the pair's estimate is the MEDIAN over its exchanges (a
    single reactor-poll outlier must not skew the alignment). Offsets
    chain outward from a root process (the busiest hop client by
    default, ties lexicographic), so `t - offsets[process]` maps any
    timestamp into the root's clock. Returns (root, offsets,
    pair_table)."""
    pair_samples: Dict[Tuple[str, str], List[float]] = {}
    for h in hops:
        if not h["server"] or None in (h["t0"], h["t1"], h["t2"],
                                       h["t3"]):
            continue
        off = ((h["t1"] - h["t0"]) + (h["t2"] - h["t3"])) / 2.0
        pair_samples.setdefault((h["client"], h["server"]),
                                []).append(off)
    med = {k: _median(sorted(v)) for k, v in pair_samples.items()}
    procs = sorted({s["process"] for s in spans}
                   | {p for k in med for p in k})
    if not procs:
        procs = [LOCAL_PROCESS]
    if root is None:
        client_weight: Dict[str, int] = {}
        for (c, _sv), v in pair_samples.items():
            client_weight[c] = client_weight.get(c, 0) + len(v)
        root = min(procs, key=lambda p: (-client_weight.get(p, 0), p))
    offsets: Dict[str, float] = {root: 0.0}
    frontier = [root]
    while frontier:
        nxt = []
        for a in frontier:
            for (c, sv) in sorted(med):
                if c == a and sv not in offsets:
                    offsets[sv] = offsets[a] + med[(c, sv)]
                    nxt.append(sv)
                elif sv == a and c not in offsets:
                    offsets[c] = offsets[a] - med[(c, sv)]
                    nxt.append(c)
        frontier = nxt
    for p in procs:
        offsets.setdefault(p, 0.0)   # unreachable: no hop evidence
    pairs = {f"{c}->{sv}": {"offset_s": round(med[(c, sv)], 6),
                            "samples": len(pair_samples[(c, sv)])}
             for (c, sv) in sorted(med)}
    return root, offsets, pairs


# ------------------------------------------------------------------ merge
def merge(run_dir: str, root: Optional[str] = None) -> dict:
    """The merged cross-process picture of one run directory: clock
    offsets, and one span tree per sampled debug id (slowest first,
    every timestamp mapped into the root process's clock)."""
    data = load_run(run_dir)
    spans, hops = data["spans"], data["hops"]
    root, offsets, pairs = estimate_offsets(hops, spans, root=root)

    by_debug: Dict[str, List[dict]] = {}
    for s in spans:
        by_debug.setdefault(s["debug_id"], []).append(s)

    chains = []
    for debug_id in sorted(by_debug):
        group = by_debug[debug_id]
        nodes = {(s["process"], s["span_id"]): s for s in group
                 if s["span_id"] is not None}
        children: Dict[tuple, list] = {}
        roots = []
        for s in group:
            s["begin_adj"] = round(
                s["begin"] - offsets.get(s["process"], 0.0), 6)
            s["end_adj"] = round(
                s["end"] - offsets.get(s["process"], 0.0), 6)
            pkey = s["remote"] if s["remote"] is not None else (
                (s["process"], s["parent_id"])
                if s["parent_id"] is not None else None)
            if pkey is not None and tuple(pkey) in nodes:
                children.setdefault(tuple(pkey), []).append(s)
            else:
                roots.append(s)

        # skew-tolerant ordering: siblings sort by adjusted begin (ties
        # by process/span id), but a child ALWAYS nests under its
        # parent even when residual skew says it began first
        def order_key(s):
            return (s["begin_adj"], s["process"], s["span_id"] or 0)

        rows: List[dict] = []

        def walk(s, depth, visiting):
            key = (s["process"], s["span_id"])
            if key in visiting:    # defensive: a cyclic parent link
                return
            rows.append({"process": s["process"],
                         "location": s["location"],
                         "span_id": s["span_id"],
                         "begin": s["begin_adj"], "end": s["end_adj"],
                         "depth": depth})
            for c in sorted(children.get(key, ()), key=order_key):
                walk(c, depth + 1, visiting | {key})

        for s in sorted(roots, key=order_key):
            walk(s, 0, frozenset())
        if not rows:
            continue
        t_begin = min(r["begin"] for r in rows)
        t_end = max(r["end"] for r in rows)
        procs = sorted({r["process"] for r in rows})
        chains.append({
            "debug_id": debug_id,
            "end_to_end_s": round(t_end - t_begin, 6),
            "begin": t_begin,
            "processes": procs,
            "cross_process": len(procs) > 1,
            "spans": rows,
        })
    chains.sort(key=lambda c: (-c["end_to_end_s"], c["debug_id"]))
    return {
        "run_dir": run_dir,
        "root_process": root,
        "processes": sorted({s["process"] for s in spans}),
        "clock_offsets_s": {p: round(v, 6)
                            for p, v in sorted(offsets.items())},
        "hop_pairs": pairs,
        "wire_hops": len(hops),
        "skipped_lines": data["skipped_lines"],
        "chains": chains,
    }


def cross_process_chains(merged: dict) -> List[dict]:
    """Chains whose span tree crosses at least one process boundary."""
    return [c for c in merged["chains"] if c["cross_process"]]


def full_commit_chains(merged: dict) -> List[dict]:
    """Cross-process chains carrying the complete commit path — a
    client leg, the proxy commitBatch leg, a resolver leg and a tlog
    leg (the SOAK_r01 acceptance shape)."""
    want = ("NativeAPI.commit", "MasterProxyServer.commitBatch",
            "Resolver.resolveBatch", "TLog.tLogCommit")
    out = []
    for c in cross_process_chains(merged):
        locs = {r["location"] for r in c["spans"]}
        if all(w in locs for w in want):
            out.append(c)
    return out


# ------------------------------------------------ critical-path stations
#: cross-process commit stations in path order. Boundary timestamps are
#: read off the merged (clock-rebased) span tree of one full commit
#: chain; consecutive boundaries telescope to the chain's client-side
#: extent, the offline analogue of the live in-process decomposition
#: (server/critical_path.py STATIONS).
PATH_STATIONS = ("client_to_proxy", "proxy_batcher", "resolve",
                 "log_push", "tlog_fsync", "reply")


def path_decomposition(merged: dict, tolerance: float = 0.05) -> dict:
    """Decompose every full commit chain into critical-path station
    segments.

    Boundaries, in path order: client span begin, proxy commitBatch
    begin, first resolver begin, last resolver end, first tlog begin,
    last tlog end, client span end. Residual clock skew can push a
    boundary backwards; boundaries are made monotone (running max) so
    segments are non-negative AND still telescope exactly to the
    client-observed extent — any skew shows up as a zero-width station,
    never a negative one. `residual_s` per chain is the difference
    between the chain's merged end-to-end and the telescoped sum (the
    tree may extend past the client span on either side)."""
    rows: List[dict] = []
    seconds = {s: 0.0 for s in PATH_STATIONS}
    dominant: Dict[str, int] = {}
    max_residual = 0.0
    chains = full_commit_chains(merged)
    for c in chains:
        by_loc: Dict[str, List[dict]] = {}
        for r in c["spans"]:
            by_loc.setdefault(r["location"], []).append(r)
        client = by_loc["NativeAPI.commit"][0]
        proxy = by_loc["MasterProxyServer.commitBatch"][0]
        res = by_loc["Resolver.resolveBatch"]
        tlog = by_loc["TLog.tLogCommit"]
        bounds = (client["begin"], proxy["begin"],
                  min(r["begin"] for r in res),
                  max(r["end"] for r in res),
                  min(r["begin"] for r in tlog),
                  max(r["end"] for r in tlog),
                  client["end"])
        cuts = [bounds[0]]
        for b in bounds[1:]:
            cuts.append(max(cuts[-1], b))
        segments = {s: round(cuts[i + 1] - cuts[i], 6)
                    for i, s in enumerate(PATH_STATIONS)}
        dom = max(PATH_STATIONS, key=lambda s: segments[s])
        residual = c["end_to_end_s"] - (cuts[-1] - cuts[0])
        for s in PATH_STATIONS:
            seconds[s] += segments[s]
        dominant[dom] = dominant.get(dom, 0) + 1
        max_residual = max(max_residual, abs(residual))
        rows.append({"debug_id": c["debug_id"],
                     "end_to_end_s": c["end_to_end_s"],
                     "segments": segments,
                     "dominant": dom,
                     "residual_s": round(residual, 6)})
    return {
        "chains": len(chains),
        "decomposed": len(rows),
        "stations": {s: round(v, 6) for s, v in seconds.items()},
        "dominant": dominant,
        "max_residual_seconds": round(max_residual, 6),
        "tolerance": tolerance,
        "rows": rows,
    }


# ----------------------------------------------------------------- output
def render_report(merged: dict, top: int = 5) -> str:
    lines = [f"tracemerge: {merged['run_dir']}"]
    lines.append("processes: " + (", ".join(merged["processes"])
                                  or "(none)"))
    lines.append(f"root clock: {merged['root_process']} "
                 f"(wire hops: {merged['wire_hops']})")
    for pair, row in merged["hop_pairs"].items():
        lines.append(f"  offset {pair}: {row['offset_s'] * 1e3:+.3f} ms"
                     f" ({row['samples']} samples)")
    for p, off in merged["clock_offsets_s"].items():
        lines.append(f"  clock {p}: {off * 1e3:+.3f} ms vs root")
    chains = merged["chains"]
    cross = sum(1 for c in chains if c["cross_process"])
    full = len(full_commit_chains(merged))
    lines.append(f"chains: {len(chains)} total, {cross} cross-process, "
                 f"{full} full commit paths")
    if full:
        path = path_decomposition(merged)
        doms = ", ".join(f"{s}={n}" for s, n in
                         sorted(path["dominant"].items(),
                                key=lambda kv: -kv[1]))
        lines.append(f"critical path ({path['decomposed']} commits "
                     f"decomposed, max residual "
                     f"{path['max_residual_seconds'] * 1e3:.3f} ms): "
                     f"dominant {doms or '-'}")
        for s in PATH_STATIONS:
            lines.append(f"  {s:<16} {path['stations'][s] * 1e3:9.3f} ms"
                         " total")
    lines.append(f"slowest commits (top {min(top, len(chains))}):")
    for c in chains[:top]:
        lines.append(f"  {c['debug_id']}: "
                     f"{c['end_to_end_s'] * 1e3:.3f} ms end-to-end, "
                     f"processes={','.join(c['processes'])}")
        for r in c["spans"]:
            rel = (r["begin"] - c["begin"]) * 1e3
            dur = (r["end"] - r["begin"]) * 1e3
            lines.append(f"    {'  ' * r['depth']}+{rel:.3f}ms "
                         f"{r['location']} [{r['process']}] "
                         f"{dur:.3f}ms")
    return "\n".join(lines) + "\n"


def render_folded(merged: dict) -> str:
    """Flamegraph-ready folded stacks: one line per span,
    `proc:loc;proc:loc...` from the chain root, value = SELF time in
    integer microseconds (children's time subtracted, clamped at 0)."""
    out = []
    for c in merged["chains"]:
        rows = c["spans"]
        stack: List[str] = []
        for i, r in enumerate(rows):
            del stack[r["depth"]:]
            stack.append(f"{r['process']}:{r['location']}")
            dur = max(0.0, r["end"] - r["begin"])
            # children of THIS span only: stop scanning at the next
            # row at or above our depth
            child = 0.0
            for x in rows[i + 1:]:
                if x["depth"] <= r["depth"]:
                    break
                if x["depth"] == r["depth"] + 1:
                    child += max(0.0, x["end"] - x["begin"])
            self_us = max(0, int(round((dur - child) * 1e6)))
            out.append(f"{';'.join(stack)} {self_us}")
    return "\n".join(out) + ("\n" if out else "")


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    run_dir = None
    top = 5
    out_path = folded_path = json_path = None
    while argv:
        a = argv.pop(0)
        if a == "--top":
            top = int(argv.pop(0))
        elif a == "--out":
            out_path = argv.pop(0)
        elif a == "--folded":
            folded_path = argv.pop(0)
        elif a == "--json":
            json_path = argv.pop(0)
        elif a == "--run-dir":
            run_dir = argv.pop(0)
        elif not a.startswith("-") and run_dir is None:
            run_dir = a
        else:
            print(f"unknown argument {a!r}", file=sys.stderr)
            return 2
    if run_dir is None or not os.path.isdir(run_dir):
        print("usage: tracemerge <run_dir> [--top N] [--out f] "
              "[--folded f] [--json f]", file=sys.stderr)
        return 2
    merged = merge(run_dir)
    report = render_report(merged, top=top)
    if out_path:
        with open(out_path, "w") as fh:
            fh.write(report)
    if folded_path:
        with open(folded_path, "w") as fh:
            fh.write(render_folded(merged))
    if json_path:
        with open(json_path, "w") as fh:
            json.dump(merged, fh, indent=2, sort_keys=True)
            fh.write("\n")
    print(report, end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
