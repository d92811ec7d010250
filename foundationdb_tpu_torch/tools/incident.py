"""Incident bundles: snapshot an SLO breach window into one directory.

The longitudinal plane's last mile: when the SLO engine
trips — or an operator asks — everything needed to diagnose the breach
is collected into a self-contained bundle dir:

    manifest.json   window, version bounds, verdict, content inventory
    series.json     every \\xff\\x02/metrics/ signal's samples in the
                    window (version-aligned via the TimeKeeper map)
    timekeeper.json the version<->wallclock rows covering the window
    status.json     the status document at capture time
    chaos.json      the chaos accounting (what faults were firing)
    traces.txt      the tracemerge report over the run dir's per-
                    process trace files (rolled segments included)
    chains.json     the merged cross-process commit chains

`capture_bundle` is async and needs a database handle (the soak
harness and `cli incident` both have one); `python -m ...incident
<run_dir>` is the offline half — it rebuilds the trace report/chains
from a run directory after the fact, no live cluster required.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

from ..layers import metrics as metrics_layer
from ..server import timekeeper


def _write_json(path: str, doc) -> None:
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1, default=str)
        fh.write("\n")


def _trace_docs(run_dir: Optional[str], out_dir: str) -> dict:
    """The tracemerge half: report + commit chains over the run dir's
    trace files (best-effort — a bundle without traces is still a
    bundle)."""
    inventory = {}
    if not run_dir or not os.path.isdir(run_dir):
        return inventory
    try:
        from . import tracemerge
        doc = tracemerge.merge(run_dir)
        _write_json(os.path.join(out_dir, "chains.json"), doc)
        inventory["chains.json"] = len(doc.get("chains", ()))
        report = tracemerge.render_report(doc)
        with open(os.path.join(out_dir, "traces.txt"), "w") as fh:
            fh.write(report)
        inventory["traces.txt"] = True
    except Exception as e:  # noqa: BLE001 — diagnostics stay best-effort
        inventory["trace_error"] = str(e)
    return inventory


async def capture_bundle(db, out_dir: str,
                         window: Tuple[float, float],
                         run_dir: Optional[str] = None,
                         status_doc: Optional[dict] = None,
                         verdict: Optional[dict] = None,
                         reason: str = "operator") -> dict:
    """Snapshot the breach window [t0, t1] (cluster seconds) into
    `out_dir`; returns the manifest."""
    os.makedirs(out_dir, exist_ok=True)
    t0, t1 = window
    t0_ms, t1_ms = int(t0 * 1000), int(t1 * 1000)

    # version alignment: the TimeKeeper map translates the wallclock
    # window into the version interval the commit pipeline spoke
    time_map = await timekeeper.read_time_map(db)
    v0 = timekeeper.version_at_time_from_map(time_map, t0)
    v1 = timekeeper.version_at_time_from_map(time_map, t1)
    _write_json(os.path.join(out_dir, "timekeeper.json"),
                [{"ts": ts, "version": v} for ts, v in time_map
                 if t0 - 60 <= ts <= t1 + 60])

    # every recorded signal's samples inside the window
    series = {}
    for signal in await metrics_layer.list_history_signals(db):
        samples = await metrics_layer.read_history(
            db, signal, start_ms=t0_ms, end_ms=t1_ms + 1)
        if samples:
            series[signal] = samples
    _write_json(os.path.join(out_dir, "series.json"), series)

    if status_doc is not None:
        _write_json(os.path.join(out_dir, "status.json"), status_doc)
        chaos = (status_doc.get("cluster") or {}).get("chaos")
        if chaos is not None:
            _write_json(os.path.join(out_dir, "chaos.json"), chaos)

    inventory = _trace_docs(run_dir, out_dir)

    # flight recorder: the capturing process's ring of
    # recent trace events joins the bundle — the seconds leading INTO
    # the breach, finer-grained than the sampled series
    from ..flow import g_flightrec
    rec_path = g_flightrec.dump(directory=out_dir,
                                reason=f"incident:{reason}")
    if rec_path is not None:
        inventory["flightrec"] = os.path.basename(rec_path)

    manifest = {
        "reason": reason,
        "window": {"t0": t0, "t1": t1,
                   "version_at_t0": v0, "version_at_t1": v1},
        "verdict": verdict,
        "signals": sorted(series),
        "samples": sum(len(s) for s in series.values()),
        "timekeeper_rows": len(time_map),
        "contents": sorted(os.listdir(out_dir)) + ["manifest.json"],
        **inventory,
    }
    _write_json(os.path.join(out_dir, "manifest.json"), manifest)
    return manifest


def main(argv=None) -> int:
    """Offline mode: rebuild the trace report/chains for a finished run
    directory (the live-keyspace halves need a database handle — the
    soak harness and `cli incident` capture those)."""
    import argparse
    ap = argparse.ArgumentParser(
        description="Assemble an offline incident bundle from a soak/"
                    "clusterbench run directory's trace files.")
    ap.add_argument("run_dir", help="run directory with trace.*.jsonl")
    ap.add_argument("--out", default=None,
                    help="bundle dir (default <run_dir>/incident)")
    args = ap.parse_args(argv)
    out_dir = args.out or os.path.join(args.run_dir, "incident")
    os.makedirs(out_dir, exist_ok=True)
    inventory = _trace_docs(args.run_dir, out_dir)
    _write_json(os.path.join(out_dir, "manifest.json"),
                {"reason": "offline", "run_dir": args.run_dir,
                 **inventory})
    print(json.dumps({"bundle": out_dir, **inventory}))
    return 0 if "trace_error" not in inventory else 1


if __name__ == "__main__":
    raise SystemExit(main())
