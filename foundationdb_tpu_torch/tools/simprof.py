"""simprof: the sim-performance attribution tool (ROADMAP item 6 —
"profile the run loop before refactoring it").

Runs a NAMED storm with the SIM_TASK_STATS plane armed (per-task
run-loop accounting, per-TaskPriority-band rollup, per-message-type
network accounting, sampled coroutine stacks) and emits:

  - a text report (who burns the wall clock: task table, priority
    bands, message types, wall-vs-sim budget),
  - a JSON report (the machine-readable version, for CI artifacts),
  - optionally a flamegraph-ready `.folded` collapsed-stack file
    (`--folded out.folded` -> flamegraph.pl / speedscope).

`--compare SIMPERF_r01.json` checks the run against a committed
baseline and exits non-zero when a storm's wall time regressed past
the tolerance — the regression gate every sim-scale PR runs against.
Wall baselines are machine-dependent, so the gate is a RATIO
(default: fail at > 2x the recorded wall seconds); the deterministic
columns (tasks_run, messages_sent) are reported as drift, never
failed, because code changes move them legitimately.

    python -m foundationdb_tpu_torch.tools.simprof --storm open_loop
    python -m foundationdb_tpu_torch.tools.simprof --storms open_loop,overload
    python -m foundationdb_tpu_torch.tools.simprof --all \
        --compare SIMPERF_r02.json
    python -m foundationdb_tpu_torch.tools.simprof --all \
        --write-baseline SIMPERF_r03.json
    python -m foundationdb_tpu_torch.tools.simprof --storm overload_million
"""

from __future__ import annotations

import json
import sys
from typing import List, Optional

from . import report_path

JSON_REPORT_PATH = report_path("_simprof_report.json")
TEXT_REPORT_PATH = report_path("_simprof_report.txt")

#: the named storm set. `baseline: True` rows form the rNN baseline
#: set (the acceptance floor is >= 3 named storms). `clients`,
#: `multiplex` and `horizon` parameterize the overload-family storms
#: (overridable from the command line with --clients / --multiplex /
#: --horizon, so any cell — including the 10^6-client one — is
#: reproducible from the same entry point CI uses).
STORMS = {
    "open_loop": {"baseline": True, "seed": 6262,
                  "help": "seeded Zipfian open-loop burst (QoS storm)"},
    "contention": {"baseline": True, "seed": 8383,
                   "help": "hot-key read-modify-write contention storm"},
    "overload": {"baseline": True, "seed": 9393,
                 "help": "10^4-client open-loop overload storm"},
    "overload_million": {"baseline": True, "seed": 11311,
                         "clients": 1_000_000, "multiplex": 600,
                         "horizon": 10.0,
                         "help": "10^6-distinct-client overload storm, "
                                 "10x horizon, multiplexed arrivals"},
    "chaos_partition": {"baseline": False, "seed": 101,
                        "help": "partition_minority ChaosStorm "
                                "(traffic + faults + heal + verify)"},
}


def _arm(cluster) -> None:
    """Arm the whole plane on a freshly built cluster (SimCluster
    re-initializes knobs in __init__, so the knob is set afterwards
    and the scheduler/network are armed directly)."""
    from .. import flow
    flow.SERVER_KNOBS.set("sim_task_stats", 1)
    cluster.sched.start_task_stats()
    cluster.net.arm_message_stats()
    cluster.sched.start_profiler(sample_every=16)


def run_storm(name: str, seed: Optional[int] = None,
              duration: float = 3.0, clients: Optional[int] = None,
              horizon: Optional[float] = None,
              multiplex: Optional[int] = None) -> dict:
    """One named storm under the armed plane -> the simprof report
    dict (storm stats incl. sim_perf, the FULL task/message tables,
    and the sampled collapsed stacks). `clients`/`horizon`/`multiplex`
    override the overload-family population size, duration multiplier
    and clients-per-arrival block (defaults come from the STORMS row),
    so any population/horizon cell is one command line. NOTE: the
    `overload` cell keeps the tightened (collapse-shape)
    ratekeeper knobs; the committed 10^6 baseline is the HEALTHY
    `overload_million` cell — reproduce it by NAME (overrides apply to
    it too):

        python -m foundationdb_tpu_torch.tools.simprof --storm overload_million
    """
    from .. import flow
    from ..server import SimCluster
    from ..server.workloads import (ChaosStorm, ContentionStorm,
                                    OpenLoopStorm, OverloadStorm)
    if name not in STORMS:
        raise ValueError(f"unknown storm {name!r}; known: "
                         f"{sorted(STORMS)}")
    cfg = STORMS[name]
    if seed is None:
        seed = cfg["seed"]
    if clients is None:
        clients = cfg.get("clients", 10_000)
    if multiplex is None:
        multiplex = cfg.get("multiplex", 1)
    if horizon is None:
        horizon = cfg.get("horizon", 1.0)

    if name == "chaos_partition":
        cluster = SimCluster(seed=seed, durable=True, n_workers=6)
        _arm(cluster)
        dbs = [cluster.client(f"sp{i}") for i in range(3)]
        storm = ChaosStorm(cluster, dbs, flow.g_random,
                           "partition_minority", duration=duration + 2.0)

        async def main():
            rep = await storm.run()
            return {k: rep[k] for k in ("storm", "recovery_seconds",
                                        "sim_perf")}
    else:
        overload_like = name.startswith("overload")
        cluster = SimCluster(seed=seed, durable=True,
                             n_proxies=2 if overload_like else 1)
        _arm(cluster)
        if name == "overload":
            # the 10^4 cell keeps the tightened ratekeeper (the
            # collapse-shape storm the admission work measured); the 10^6 cell
            # runs a HEALTHY cluster — its question is simulator
            # scale (can nightly afford a million clients at a 10x
            # horizon), not admission-control physics
            flow.SERVER_KNOBS.set("rk_target_storage_queue_bytes", 4000)
            flow.SERVER_KNOBS.set("rk_spring_storage_queue_bytes", 1000)
        dbs = [cluster.client(f"sp{i}") for i in range(6)]
        if name == "open_loop":
            storm = OpenLoopStorm(dbs, flow.g_random, duration=duration,
                                  rate=80.0, burst_rate=500.0,
                                  burst_start=1.0, burst_len=1.0,
                                  max_inflight=256)
        elif name == "contention":
            storm = ContentionStorm(dbs, flow.g_random,
                                    duration=duration, rate=120.0)
        else:
            storm = OverloadStorm(dbs, flow.g_random,
                                  duration=duration * horizon,
                                  fair_rate=60.0, abusive_rate=240.0,
                                  n_clients=clients,
                                  clients_per_arrival=multiplex)

        async def main():
            return {"storm": await storm.run()}

    try:
        out = cluster.run(main(), timeout_time=900)
        stats = out["storm"]
        sim_perf = out.get("sim_perf") or stats["sim_perf"]
        samples = cluster.sched.stop_profiler()
        folded = cluster.sched.profile_folded()
        report = {
            "storm": name,
            "seed": seed,
            "sim_perf": sim_perf,
            "stats": {k: v for k, v in stats.items()
                      if k not in ("sim_perf",)},
            "task_stats": cluster.sched.task_stats_report(),
            "message_stats": cluster.net.message_stats_report(),
            "profile_top": samples[:20],
            "folded": folded,
        }
        if "recovery_seconds" in out:
            report["recovery_seconds"] = out["recovery_seconds"]
        return report
    finally:
        from .. import flow as _flow
        _flow.reset_server_knobs(randomize=False)
        cluster.shutdown()


def baseline_row(report: dict) -> dict:
    """The comparable slice of one storm report (what the committed
    SIMPERF_rNN.json keeps per storm)."""
    sp = report["sim_perf"]
    return {
        "seed": report["seed"],
        "sim_seconds": sp["sim_seconds"],
        "wall_seconds": sp["wall_seconds"],
        "sim_per_wall": sp["sim_per_wall"],
        "tasks_run": sp["tasks_run"],
        "tasks_per_wall_sec": sp["tasks_per_wall_sec"],
        "messages_sent": sp.get("messages_sent"),
    }


def compare_reports(current: dict, baseline: dict,
                    tolerance: float = 2.0) -> tuple:
    """-> (regressions, lines). `current` and `baseline` both map
    storm name -> baseline_row-shaped dict. A storm regresses when its
    wall_seconds exceed tolerance x the baseline's; deterministic
    drift (tasks_run, messages_sent) is reported, never failed."""
    regressions: List[str] = []
    lines: List[str] = []
    for name in sorted(baseline):
        base = baseline[name]
        cur = current.get(name)
        if cur is None:
            lines.append(f"  {name:<16} (not run this round)")
            continue
        if cur.get("seed") != base.get("seed"):
            # a different seed is a different workload shape: gating
            # its wall time against this baseline would report seed
            # mismatch as "regression" — say so and skip instead
            lines.append(
                f"  {name:<16} seed {cur.get('seed')} != baseline "
                f"seed {base.get('seed')} — not comparable, skipped")
            continue
        wall, bwall = cur["wall_seconds"], base["wall_seconds"]
        ratio = wall / max(bwall, 1e-9)
        verdict = "ok"
        if ratio > tolerance:
            verdict = "REGRESSED"
            regressions.append(
                f"{name}: wall {wall:.3f}s vs baseline {bwall:.3f}s "
                f"({ratio:.2f}x > {tolerance:.2f}x tolerance)")
        lines.append(
            f"  {name:<16} wall {wall:>8.3f}s vs {bwall:>8.3f}s "
            f"({ratio:>5.2f}x)  sim/wall {cur['sim_per_wall']:>7.2f} "
            f"vs {base['sim_per_wall']:>7.2f}  "
            f"tasks {cur['tasks_run']} vs {base['tasks_run']}  "
            f"[{verdict}]")
    return regressions, lines


def format_report(report: dict, top_k: int = 10) -> str:
    """One storm report as the operator-facing text block."""
    sp = report["sim_perf"]
    lines = [
        f"== simprof: {report['storm']} (seed {report['seed']}) ==",
        f"sim {sp['sim_seconds']}s in wall {sp['wall_seconds']}s "
        f"(sim/wall {sp['sim_per_wall']}x) — {sp['tasks_run']} steps, "
        f"{sp['tasks_per_wall_sec']}/wall-sec",
    ]
    ts = report.get("task_stats") or {}
    if ts.get("tasks"):
        lines.append("task families by busy time:")
        for r in ts["tasks"][:top_k]:
            lines.append(f"  {r['task']:<32} steps={r['steps']:<9}"
                         f" busy={r['busy_us'] / 1e6:<9.4f}s"
                         f" max={r['max_us']:.0f}us")
        if ts.get("dropped_names"):
            lines.append(f"  ({ts['dropped_names']} folds in '(other)': "
                         f"table bound hit)")
    if ts.get("bands"):
        lines.append("priority bands: " + "  ".join(
            f"{b['band']}={b['busy_us'] / 1e6:.4f}s"
            for b in ts["bands"][:top_k]))
    ms = report.get("message_stats") or {}
    if ms.get("types"):
        lines.append("message types:")
        for r in ms["types"][:top_k]:
            lines.append(f"  {r['type']:<32} {r['count']}")
        lines.append(f"  total sent={ms.get('messages_sent')} "
                     f"timers_now={ms.get('timers_now')}")
    prof = report.get("profile_top") or ()
    if prof:
        lines.append("sampled stacks (top):")
        for e in prof[:5]:
            lines.append(f"  {e['samples']:>5}  {e['task']}  {e['stack']}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    storms: List[str] = []
    seed = None
    duration = 3.0
    compare_path = None
    write_baseline = None
    tolerance = None     # None = baseline file's (or 2.0)
    json_path = JSON_REPORT_PATH
    text_path = TEXT_REPORT_PATH
    folded_path = None
    clients = None
    horizon = None
    multiplex = None
    while argv:
        a = argv.pop(0)
        if a == "--storm":
            storms.append(argv.pop(0))
        elif a == "--storms":
            # comma-separated filter, e.g. --storms open_loop,overload
            storms.extend(s for s in argv.pop(0).split(",") if s)
        elif a == "--all":
            storms = [n for n, s in STORMS.items() if s["baseline"]]
        elif a == "--seed":
            seed = int(argv.pop(0))
        elif a == "--duration":
            duration = float(argv.pop(0))
        elif a == "--clients":
            clients = int(argv.pop(0))
        elif a == "--horizon":
            horizon = float(argv.pop(0))
        elif a == "--multiplex":
            multiplex = int(argv.pop(0))
        elif a == "--compare":
            compare_path = argv.pop(0)
        elif a == "--write-baseline":
            write_baseline = argv.pop(0)
        elif a == "--tolerance":
            tolerance = float(argv.pop(0))
        elif a == "--json":
            json_path = argv.pop(0)
        elif a == "--report":
            text_path = argv.pop(0)
        elif a == "--folded":
            folded_path = argv.pop(0)
        elif a in ("-h", "--help"):
            print(__doc__)
            print("storms:")
            for n, s in STORMS.items():
                print(f"  {n:<16} {s['help']}"
                      + ("  [baseline set]" if s["baseline"] else ""))
            return 0
        else:
            print(f"unknown argument {a!r} (try --help)",
                  file=sys.stderr)
            return 2
    if not storms:
        storms = [n for n, s in STORMS.items() if s["baseline"]]

    unknown = [n for n in storms if n not in STORMS]
    if unknown:
        print(f"unknown storms {unknown} (known: {sorted(STORMS)})",
              file=sys.stderr)
        return 2

    reports = {}
    blocks = []
    for name in storms:
        rep = run_storm(name, seed=seed, duration=duration,
                        clients=clients, horizon=horizon,
                        multiplex=multiplex)
        reports[name] = rep
        block = format_report(rep)
        blocks.append(block)
        print(block)

    with open(json_path, "w") as fh:
        json.dump({n: {k: v for k, v in r.items() if k != "folded"}
                   for n, r in reports.items()},
                  fh, indent=2, sort_keys=True, default=str)
        fh.write("\n")
    with open(text_path, "w") as fh:
        fh.write("\n\n".join(blocks) + "\n")
    if folded_path:
        with open(folded_path, "w") as fh:
            fh.write("\n".join(r["folded"] for r in reports.values()
                               if r.get("folded")) + "\n")
    print(f"\nreports: {text_path} {json_path}"
          + (f" {folded_path}" if folded_path else ""))

    if write_baseline:
        import os.path
        import re
        # SIMPERF_rNN.json names the round (the documented convention)
        m = re.search(r"[_-](r\d+)", os.path.basename(write_baseline))
        doc = {"round": m.group(1) if m else "r01",
               "tolerance": tolerance if tolerance is not None else 2.0,
               "note": "simprof wall-time baselines; compare is a "
                       "ratio gate (machine-dependent absolute walls)",
               "storms": {n: baseline_row(r)
                          for n, r in reports.items()}}
        with open(write_baseline, "w") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"baseline written: {write_baseline}")

    if compare_path:
        with open(compare_path) as fh:
            base = json.load(fh)
        # explicit --tolerance overrides the file's; otherwise the
        # baseline's recorded tolerance (default 2.0) gates
        tol = (tolerance if tolerance is not None
               else float(base.get("tolerance", 2.0)))
        regressions, lines = compare_reports(
            {n: baseline_row(r) for n, r in reports.items()},
            base["storms"], tolerance=tol)
        print(f"\ncompare vs {compare_path} "
              f"(round {base.get('round', '?')}, tol {tol:.2f}x):")
        print("\n".join(lines))
        if regressions:
            print("\nWALL-TIME REGRESSIONS:", file=sys.stderr)
            for r in regressions:
                print(f"  {r}", file=sys.stderr)
            return 1
        print("no wall-time regressions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
