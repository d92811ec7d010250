"""CI smoke: boot an in-process cluster, run a conflicting workload and
one latency-probe round, then assert the operator surfaces are
well-formed — `status details` (conflict hot spots + latency probe
sections), `top`, and the Prometheus exporter text.

`python -m foundationdb_tpu_torch.tools.smoke` exits 0 on success; the
tier-1 workflow runs it after the test suite as an end-to-end guard
that the observability stack assembles outside pytest too.
`--profile` runs the transaction-profiling smoke instead: sampling at
100%, a conflicting workload, and the tools/profiler.py analyzer must
find both a committed and a conflicted transaction; the report lands
in $TMPDIR/fdbtpu_torch_profile_report.txt for the CI artifact."""

from __future__ import annotations

import sys
from typing import List, Optional

from . import report_path

PROFILE_REPORT_PATH = report_path("_profile_report.txt")
STORM_REPORT_PATH = report_path("_storm_report.txt")
CHAOS_REPORT_PATH = report_path("_chaos_report.txt")
CHAOS_TRACE_PATH = report_path("_chaos_trace.jsonl")
CONTENTION_REPORT_PATH = report_path("_contention_report.txt")
OVERLOAD_REPORT_PATH = report_path("_overload_report.txt")
HEAT_REPORT_PATH = report_path("_heat_report.txt")
SIMPROF_REPORT_PATH = report_path("_simprof_smoke.txt")
SPLITS_REPORT_PATH = report_path("_splits_report.txt")
SOAK_REPORT_PATH = report_path("_soak_report.txt")
SLO_REPORT_PATH = report_path("_slo_report.txt")
PATH_REPORT_PATH = report_path("_path_report.txt")
SIMPROF_CHAOS_PATH = report_path("_simprof_chaos.json")
SIMPROF_CHAOS_FOLDED_PATH = report_path("_simprof_chaos.folded")


def run_smoke(out=print) -> int:
    import os

    from .. import flow
    from ..client import run_transaction
    from ..server import SimCluster
    from .cli import Cli
    from .exporter import parse_prometheus, render_prometheus

    cluster = SimCluster(seed=4242, durable=True)
    # resolve-pipeline depth under test (CI runs RESOLVE_PIPELINE_DEPTH=4
    # on the CPU backend); set AFTER SimCluster re-initializes the knobs
    flow.SERVER_KNOBS.set(
        "resolve_pipeline_depth",
        int(os.environ.get("RESOLVE_PIPELINE_DEPTH", 4)))
    cli = Cli.for_cluster(cluster)
    try:
        db = cluster.client("smoke")

        async def workload():
            async def seed(tr):
                tr.set(b"hot", b"0")
            await run_transaction(db, seed)
            for _ in range(6):
                tr = db.create_transaction()
                tr.set_option("report_conflicting_keys")
                await tr.get(b"hot")
                tr.set(b"mine", b"v")

                async def bump(t2):
                    t2.set(b"hot", b"x")
                await run_transaction(db, bump)
                try:
                    await tr.commit()
                    raise AssertionError("expected a conflict")
                except flow.FdbError as e:
                    assert e.name == "not_committed", e.name
                assert tr.get_conflicting_ranges() == \
                    ((b"hot", b"hot\x00"),), tr.get_conflicting_ranges()
            # one probe round: past LATENCY_PROBE_INTERVAL (5s) + the
            # metric sampler tick
            await flow.delay(7.0)
            return await db.get_status()

        status = cluster.run(workload(), timeout_time=300)
        cl = status["cluster"]
        assert cl["conflict_hot_spots"], "no hot spots attributed"
        assert cl["conflict_hot_spots"][0]["begin"] == b"hot".hex()
        assert cl["latency_probe"].get("rounds", 0) >= 1, \
            "latency probe never ran"

        # the resolve pipeline must be visible without a bench run:
        # every resolver submitted/drained batches through it
        res = cl.get("resolvers", ())
        assert res, "no resolvers in status"
        for r in res:
            pipe = r.get("pipeline") or {}
            assert pipe.get("submits", 0) > 0, f"pipeline idle: {pipe}"
            assert pipe.get("drains") == pipe.get("submits"), pipe
            assert pipe.get("depth", 0) >= 1, pipe

        details = cli.execute("status details")
        for section in ("Latency (seconds):", "Conflict hot spots",
                        "Latency probe:", "Resolve pipeline:",
                        b"hot".hex()):
            assert str(section) in details, f"missing {section!r}"
        top = cli.execute("top")
        assert b"hot".hex() in top

        text = render_prometheus(status)
        samples = parse_prometheus(text)   # raises on malformed lines
        kinds = {l.get("kind") for n, l, _ in samples
                 if n == "fdbtpu_role_counter"}
        missing = {"proxy", "resolver", "tlog", "storage"} - kinds
        assert not missing, f"exporter missing role kinds: {missing}"
        names = {n for n, _, _ in samples}
        for need in ("fdbtpu_conflict_hot_spot_score",
                     "fdbtpu_latency_probe_seconds",
                     "fdbtpu_request_latency_seconds_bucket",
                     "fdbtpu_resolve_pipeline_submits",
                     "fdbtpu_resolve_pipeline_depth"):
            assert need in names, f"exporter missing {need}"
        out(f"SMOKE OK: {len(samples)} exporter samples, "
            f"{len(cl['conflict_hot_spots'])} hot spots, "
            f"{cl['latency_probe']['rounds']} probe rounds, "
            f"pipeline depth {res[0]['pipeline']['depth']} "
            f"({res[0]['pipeline']['submits']} submits)")
        return 0
    finally:
        cluster.shutdown()


#: the fault smoke's cluster seed, the reference's. Every fault at
#: p=0.05 is recovered on a fresh device backend: the rebuild is one
#: seam for the injector (models/failover.py `_rebuild_on`).
FAULTS_SEED = 4646


def run_smoke_faults(out=print, device=None) -> int:
    """Backend fault-tolerance smoke: a CUDA-backed cluster (`device`:
    None is the card, "cpu" the plain versions) with device
    faults injected at the submit/materialize/drain seams
    (DEVICE_FAULT_INJECTION env, default 0.05) and shadow validation
    sampling every SHADOW_RESOLVE_SAMPLE-th batch (default 2) runs a
    conflicting workload; commits must keep succeeding, the
    failover/shadow counters must surface in `status details` and the
    exporter text, and the shadow must report ZERO mismatches (the
    backend is honest — only the fault timing is hostile). Every
    fault must be recovered on a fresh device backend: the port has
    no CPU failover, so `failovers` stays 0 (a fault past the retries
    fails the run with DeviceFaultError)."""
    import os

    from .. import flow
    from ..client import run_transaction
    from ..server import SimCluster
    from .cli import Cli
    from .exporter import parse_prometheus, render_prometheus

    cluster = SimCluster(seed=FAULTS_SEED, durable=True,
                         conflict_backend="cuda", device=device)
    # knobs AFTER SimCluster re-initializes them; capture the
    # re-initialized values so the finally restores ALL of them for
    # in-process callers that run another smoke after this one
    saved = {n: getattr(flow.SERVER_KNOBS, n) for n in
             ("device_fault_injection", "shadow_resolve_sample",
              "resolve_pipeline_depth", "conflict_checkpoint_versions")}
    flow.SERVER_KNOBS.set(
        "device_fault_injection",
        float(os.environ.get("DEVICE_FAULT_INJECTION", 0.05)))
    flow.SERVER_KNOBS.set(
        "shadow_resolve_sample",
        int(os.environ.get("SHADOW_RESOLVE_SAMPLE", 2)))
    flow.SERVER_KNOBS.set(
        "resolve_pipeline_depth",
        int(os.environ.get("RESOLVE_PIPELINE_DEPTH", 4)))
    flow.SERVER_KNOBS.set("conflict_checkpoint_versions", 200_000)
    cli = Cli.for_cluster(cluster)
    try:
        db = cluster.client("fsmoke")

        async def workload():
            async def seed(tr):
                tr.set(b"hot", b"0")
            await run_transaction(db, seed)
            conflicts = 0
            for i in range(20):
                tr = db.create_transaction()
                await tr.get(b"hot")
                tr.set(b"mine%d" % i, b"v")

                async def bump(t2):
                    t2.set(b"hot", b"x")
                await run_transaction(db, bump)
                try:
                    await tr.commit()
                except flow.FdbError as e:
                    assert e.name == "not_committed", e.name
                    conflicts += 1
            assert conflicts == 20, conflicts
            return await db.get_status()

        status = cluster.run(workload(), timeout_time=600)
        res = status["cluster"].get("resolvers", ())
        assert res, "no resolvers in status"
        fo = res[0].get("failover") or {}
        assert fo, "device backend not under the failover controller"
        assert fo["shadow"]["sampled"] > 0, fo
        assert fo["shadow"]["mismatches"] == 0, fo
        assert fo["shadow"]["errors"] == 0, fo
        # the injection campaign must actually FIRE (deterministic at
        # this seed/probability) and every fault must be survived:
        # recovered on a fresh device, never served from the CPU
        assert fo["device_faults"] > 0, fo
        assert fo["device_recoveries"] > 0, fo
        assert fo["failovers"] == 0, fo
        assert fo["checkpoints"] > 0, fo
        details = cli.execute("status details")
        assert "Backend failover:" in details, details
        assert "shadow=" in details, details

        text = render_prometheus(status)
        samples = parse_prometheus(text)
        names = {n for n, _, _ in samples}
        for need in ("fdbtpu_conflict_failover_on_primary",
                     "fdbtpu_conflict_failover_checkpoints",
                     "fdbtpu_conflict_failover_device_faults",
                     "fdbtpu_shadow_resolve_sampled",
                     "fdbtpu_shadow_resolve_mismatches"):
            assert need in names, f"exporter missing {need}"
        mm = [v for n, l, v in samples
              if n == "fdbtpu_shadow_resolve_mismatches"]
        assert mm and all(v == 0 for v in mm), mm
        out(f"FAULT SMOKE OK: {fo['device_faults']} device faults, "
            f"{fo['device_recoveries']} recoveries, "
            f"{fo['failovers']} failovers, "
            f"{fo['reattaches']} reattaches, "
            f"{fo['checkpoints']} checkpoints, "
            f"shadow {fo['shadow']['sampled']} sampled / "
            f"{fo['shadow']['mismatches']} mismatches")
        return 0
    finally:
        for name, value in saved.items():
            flow.SERVER_KNOBS.set(name, value)
        cluster.shutdown()


def run_smoke_storm(out=print,
                    report_path: str = STORM_REPORT_PATH) -> int:
    """QoS-telemetry storm smoke: an open-loop Zipfian burst workload
    (server/workloads.py OpenLoopStorm — seeded arrivals, tagged and
    priority-mixed traffic) against a cluster whose storage-queue
    target is tightened so the burst saturates it. Asserts the whole
    measurement plane moves: every role kind publishes QoS signals,
    the Ratekeeper's RkUpdate trace reports a non-`none` limiting
    reason under the burst, tag/priority counts surface in status and
    the exporter, p99 GRV latency of ADMITTED transactions stays
    bounded (the cluster degrades by shedding at a controlled rate,
    not by collapsing), and the exporter text parses."""
    import json
    import os

    from .. import flow
    from ..server import SimCluster
    from ..server.ratekeeper import LIMIT_REASONS
    from ..server.workloads import OpenLoopStorm
    from .cli import Cli
    from .exporter import parse_prometheus, render_prometheus

    cluster = SimCluster(seed=int(os.environ.get("STORM_SEED", 6262)),
                         durable=True)
    # knobs AFTER SimCluster re-initializes them: a storage-queue
    # target small enough that the burst's MVCC-window bytes blow
    # through it (the durability lag holds ~5s of writes pending), and
    # a fast QoS collection cadence so signals land within the run
    saved = {n: getattr(flow.SERVER_KNOBS, n) for n in
             ("rk_target_storage_queue_bytes",
              "rk_spring_storage_queue_bytes", "qos_sample_interval")}
    flow.SERVER_KNOBS.set("rk_target_storage_queue_bytes",
                          int(os.environ.get("STORM_QUEUE_TARGET", 4000)))
    flow.SERVER_KNOBS.set("rk_spring_storage_queue_bytes", 1000)
    flow.SERVER_KNOBS.set("qos_sample_interval", 0.25)
    cli = Cli.for_cluster(cluster)
    try:
        n_clients = int(os.environ.get("STORM_CLIENTS", 8))
        dbs = [cluster.client(f"storm{i}") for i in range(n_clients)]

        async def workload():
            storm = OpenLoopStorm(
                dbs, flow.g_random,
                duration=float(os.environ.get("STORM_DURATION", 3.0)),
                rate=float(os.environ.get("STORM_RATE", 80.0)),
                burst_rate=float(os.environ.get("STORM_BURST_RATE",
                                                500.0)),
                burst_start=1.0, burst_len=1.0, max_inflight=256)
            stats = await storm.run()
            status = await dbs[0].get_status()
            return stats, status

        stats, status = cluster.run(workload(), timeout_time=600)
        cl = status["cluster"]
        qos = cl.get("qos") or {}

        # (1) every role kind publishes smoothed saturation signals
        roles = qos.get("roles") or {}
        for kind in ("storage", "tlog", "proxy", "resolver"):
            assert roles.get(kind), f"no {kind} QoS samples: {roles.keys()}"
        sto = next(iter(roles["storage"].values()))
        assert sto["queue_bytes"] > 0, sto   # the signals actually moved
        assert qos.get("limiting_reason") in LIMIT_REASONS, qos

        # (2) the burst drove the Ratekeeper past a limit: some RkUpdate
        # during the run reported a non-none limiting reason
        rk_updates = [e for e in flow.g_trace.events
                      if e.get("Type") == "RkUpdate"]
        assert rk_updates, "no RkUpdate traces emitted"
        limited = [e for e in rk_updates
                   if e.get("LimitingReason") not in (None, "none")]
        assert limited, ("limiting reason never engaged",
                         rk_updates[-3:])
        for e in limited:
            assert e["LimitingReason"] in LIMIT_REASONS, e

        # (3) tag & priority accounting surfaced
        tags = {r["tag"] for r in qos.get("tags", ())}
        assert tags, "no tag rows in status.cluster.qos"
        assert any(r["started"] > 0 for r in qos["tags"]), qos["tags"]
        prios = qos.get("priorities") or {}
        assert prios.get("batch", {}).get("started", 0) > 0, prios
        assert prios.get("default", {}).get("started", 0) > 0, prios

        # (4) controlled degradation: admitted GRVs keep a bounded p99
        # (shed/timed-out arrivals are the DESIGNED overload response)
        grv = stats["grv"]
        assert stats["completed"] > 0, stats
        assert grv["p99"] <= float(
            flow.SERVER_KNOBS.client_request_timeout), grv

        # (5) operator surfaces: cli qos view + status details section
        qos_view = cli.execute("qos")
        for section in ("Ratekeeper:", "Storage signals:",
                        "Tag traffic", "Priority classes:"):
            assert section in qos_view, f"missing {section!r}\n{qos_view}"
        details = cli.execute("status details")
        assert "Ratekeeper:" in details, details
        assert "limited_by=" in details, details

        # (6) exporter families parse and cover the plane
        text = render_prometheus(status)
        samples = parse_prometheus(text)
        names = {n for n, _, _ in samples}
        for need in ("fdbtpu_qos_signal", "fdbtpu_qos_limiting_reason",
                     "fdbtpu_qos_input", "fdbtpu_tag_busyness",
                     "fdbtpu_tag_transactions",
                     "fdbtpu_qos_priority_transactions"):
            assert need in names, f"exporter missing {need}"
        hot = [(l["reason"], v) for n, l, v in samples
               if n == "fdbtpu_qos_limiting_reason"]
        assert sum(v for _r, v in hot) == 1, hot   # one-hot enum

        report = {"storm": stats, "qos": qos,
                  "rk_updates": len(rk_updates),
                  "limited_updates": len(limited),
                  "limiting_reasons_seen": sorted(
                      {e["LimitingReason"] for e in limited})}
        with open(report_path, "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True, default=str)
            fh.write("\n")
        out(f"STORM SMOKE OK: {stats['issued']} arrivals "
            f"({stats['completed']} committed, "
            f"{stats['conflicted']} conflicted, {stats['shed']} shed), "
            f"grv p99 {grv['p99']}s, "
            f"{len(limited)}/{len(rk_updates)} RkUpdates limited by "
            f"{report['limiting_reasons_seen']}; report at {report_path}")
        return 0
    finally:
        for name, value in saved.items():
            flow.SERVER_KNOBS.set(name, value)
        cluster.shutdown()


def run_smoke_profile(out=print,
                      report_path: str = PROFILE_REPORT_PATH) -> int:
    """The transaction-profiling end-to-end: sample EVERY transaction,
    drive a workload with a guaranteed conflict, and require the
    analyzer to read back ≥1 committed and ≥1 conflicted transaction
    from the \\xff\\x02/fdbClientInfo/ keyspace."""
    from .. import flow
    from ..client import run_transaction
    from ..client.profiling import profiler_counters
    from ..server import SimCluster
    from .cli import Cli
    from .exporter import parse_prometheus, render_prometheus
    from .profiler import format_report, profile_analysis

    cluster = SimCluster(seed=2424, durable=True, profile_janitor=True)
    flow.SERVER_KNOBS.set("profile_sample_rate", 1.0)
    cli = Cli.for_cluster(cluster)
    try:
        db = cluster.client("psmoke")

        async def workload():
            async def seed(tr):
                tr.set(b"hot", b"0")
            await run_transaction(db, seed)
            for i in range(4):
                async def w(tr, i=i):
                    await tr.get(b"hot")
                    tr.set(b"k%d" % i, b"v")
                await run_transaction(db, w)
            # one transaction that conflicts and is NOT retried, so a
            # "conflicted" verdict persists
            tr = db.create_transaction()
            tr.set_option("report_conflicting_keys")
            await tr.get(b"hot")
            tr.set(b"mine", b"v")

            async def bump(t2):
                t2.set(b"hot", b"x")
            await run_transaction(db, bump)
            try:
                await tr.commit()
                raise AssertionError("expected a conflict")
            except flow.FdbError as e:
                assert e.name == "not_committed", e.name
            await flow.delay(2.0)   # let background flushes land
            return await profile_analysis(db)

        analysis, stats = cluster.run(workload(), timeout_time=300)
        assert analysis["records"] >= 2, analysis
        assert analysis["committed"] >= 1, analysis
        assert analysis["conflicted"] >= 1, analysis
        assert stats["skipped_missing_chunks"] == 0, stats
        assert any(r["key"] == b"hot".hex()
                   for r in analysis["hottest_keys"]), analysis

        # the cli renders the same analysis
        report = cli.execute("profile analyze")
        assert "Slowest transactions:" in report, report
        assert "conflicted" in report, report

        # sampler counters reach status + the exporter
        async def st():
            return await db.get_status()
        status = cluster.run(st(), timeout_time=60)
        counters = status["cluster"].get("client_profile", {})
        assert counters.get("transactions_sampled", 0) >= 2, counters
        names = {n for n, _, _ in
                 parse_prometheus(render_prometheus(status))}
        assert "fdbtpu_client_profile" in names, sorted(names)

        with open(report_path, "w") as f:
            f.write(format_report(analysis, stats) + "\n")
        out(f"PROFILE SMOKE OK: {analysis['records']} records "
            f"({analysis['committed']} committed, "
            f"{analysis['conflicted']} conflicted), "
            f"{profiler_counters()['chunks_written']} chunks; "
            f"report at {report_path}")
        return 0
    finally:
        flow.SERVER_KNOBS.set("profile_sample_rate", 0.0)
        cluster.shutdown()


def run_smoke_chaos(out=print,
                    report_path: str = CHAOS_REPORT_PATH) -> int:
    """Single-scenario chaos smoke (the nightly chaos-matrix runs this
    per grid cell; tier-1 runs one fast cell): one named scenario
    (`CHAOS_SCENARIO`, default partition_minority) applied as a
    ChaosStorm at a seeded sim (`CHAOS_SEED`) — open-loop traffic,
    mid-flight faults, heal, quiesce, `check_consistency` + shadow
    cleanliness + bounded recovery — then the SAME seed replayed,
    asserting an identical chaos event schedule and keyspace digest.
    Chaos accounting must surface in status, the exporter, and the cli
    section; the full report (events + digest + counters) and the
    trace file land at $TMPDIR/fdbtpu_torch_chaos_{report.txt,
    trace.jsonl} for the CI artifacts."""
    import json
    import os

    from .. import flow
    from ..server import SimCluster
    from ..server.chaos import SCENARIOS
    from ..server.workloads import ChaosStorm
    from .cli import _render_details
    from .exporter import parse_prometheus, render_prometheus

    scenario = os.environ.get("CHAOS_SCENARIO", "partition_minority")
    seed = int(os.environ.get("CHAOS_SEED", 101))
    # CHAOS_BUGGIFY=1: BUGGIFY knob randomization on top of the
    # scenario (the nightly's randomized-knob cells) — the same seed
    # draws the same knob distortions, so replay determinism holds,
    # and the CONFLICT_SCHEDULING/TXN_REPAIR/CLIENT_CONFLICT_WINDOWS
    # buggify arms run the scheduler/repair paths under the storm
    buggify = os.environ.get("CHAOS_BUGGIFY", "") not in ("", "0")
    if scenario not in SCENARIOS:
        out(f"unknown scenario {scenario!r}; known: {sorted(SCENARIOS)}")
        return 2
    flow.g_trace.reset(os.environ.get("CHAOS_TRACE_FILE",
                                      CHAOS_TRACE_PATH))

    # CHAOS_ADMISSION=1: force the enforced-admission planes on under
    # the scenario (the nightly's admission-armed storm cells — GRV
    # queues, tag throttling and the auto-throttler run under
    # partitions/kills/recoveries with the same consistency + replay
    # oracles; the storm's tagged open-loop traffic drives them)
    admission = os.environ.get("CHAOS_ADMISSION", "") not in ("", "0")

    # CHAOS_HEAT=1: arm the storage heat plane under the scenario (the
    # nightly's heat-armed storm cells — read sampling, read-hot
    # detection and per-SS tag busyness run under partitions/kills
    # with the same consistency + same-seed replay oracles; the plane
    # is observe-only, so the oracles must hold bit-identically)
    heat = os.environ.get("CHAOS_HEAT", "") not in ("", "0")

    # CHAOS_SPLITS=1: arm the resolver balance loop under the scenario
    # (the storm-splits nightly cells: load-driven splits with
    # live checkpoint/graft handoff race partitions, kills and
    # recoveries under the same same-seed-replay + check_consistency
    # oracles; the storm's Zipfian traffic is skewed enough for the
    # one-shot FORCE to land a split on multi-resolver scenarios)
    splits = os.environ.get("CHAOS_SPLITS", "") not in ("", "0")

    def run_once() -> dict:
        kwargs = dict(SCENARIOS[scenario].cluster_kwargs)
        if buggify:
            kwargs["buggify"] = True
        if splits:
            # the balance loop only exists on multi-resolver clusters;
            # both the run and its replay share this shape, so the
            # same-seed determinism oracle is unaffected
            kwargs["n_resolvers"] = 2
        cluster = SimCluster(seed=seed, **kwargs)
        # the sim-perf plane rides every chaos cell: profiling reads
        # only the wall clock (armed-vs-off same-seed equivalence is
        # test-pinned), and a red cell's post-mortem then carries the
        # wall-time attribution picture
        # ($TMPDIR/fdbtpu_torch_simprof_chaos.json) plus flamegraph-ready
        # collapsed stacks ($TMPDIR/fdbtpu_torch_simprof_chaos.folded —
        # flamegraph.pl / speedscope)
        cluster.sched.start_task_stats()
        cluster.net.arm_message_stats()
        cluster.sched.start_profiler(sample_every=16)
        if admission:
            flow.SERVER_KNOBS.set("grv_admission_control", 1)
            flow.SERVER_KNOBS.set("tag_throttling", 1)
            flow.SERVER_KNOBS.set("auto_tag_throttling", 1)
        if heat:
            flow.SERVER_KNOBS.set("storage_heat_tracking", 1)
            flow.SERVER_KNOBS.set("tag_throttle_storage_busyness", 1)
        if splits:
            flow.SERVER_KNOBS.set("resolver_balance", 1)
            flow.SERVER_KNOBS.set("resolver_balance_force", 1)
            flow.SERVER_KNOBS.set("resolver_balance_interval", 0.5)
        try:
            dbs = [cluster.client(f"chaos{i}") for i in range(3)]
            storm = ChaosStorm(cluster, dbs, flow.g_random, scenario)
            return cluster.run(storm.run(), timeout_time=900)
        finally:
            # the wall-time picture must survive a RED cell (a storm
            # that fails its oracle raises before any report exists):
            # snapshot the attribution tables straight off the
            # scheduler/network, whatever happened
            with open(SIMPROF_CHAOS_PATH, "w") as fh:
                json.dump(
                    {"scenario": scenario, "seed": seed,
                     "tasks_run": cluster.sched.tasks_run,
                     "busy_seconds": round(cluster.sched.busy_seconds,
                                           3),
                     "task_stats": cluster.sched.task_stats_report(),
                     "message_stats":
                         cluster.net.message_stats_report()},
                    fh, indent=2, sort_keys=True, default=str)
                fh.write("\n")
            with open(SIMPROF_CHAOS_FOLDED_PATH, "w") as fh:
                fh.write(cluster.sched.profile_folded() + "\n")
            cluster.shutdown()

    rep = run_once()
    chaos = rep["status"]["cluster"]["chaos"]
    # the report is THE triage artifact the CI matrix uploads on
    # failure — build it now and write it even when an assert below
    # fires (a replay divergence must not lose the event logs)
    report = {"scenario": scenario, "seed": seed,
              "digest": rep["digest"],
              "recovery_seconds": rep["recovery_seconds"],
              "consistency": rep["consistency"],
              "chaos": chaos, "storm": rep["storm"],
              "sim_perf": rep["sim_perf"],
              "events": rep["events"]}
    try:
        assert rep["storm"]["completed"] > 0, rep["storm"]
        assert rep["consistency"]["rows"] > 0, rep["consistency"]

        # the shared accounting schema: status doc, exporter, cli section
        status = rep["status"]
        assert chaos["scenarios"].get(scenario) == 1, chaos
        assert chaos["injected"].get("scenario") == 1, chaos
        samples = parse_prometheus(render_prometheus(status))
        names = {n for n, _l, _v in samples}
        for need in ("fdbtpu_chaos_injected", "fdbtpu_chaos_scenario_runs",
                     "fdbtpu_chaos_events"):
            assert need in names, f"exporter missing {need}"
        runs = {l["scenario"]: v for n, l, v in samples
                if n == "fdbtpu_chaos_scenario_runs"}
        assert runs.get(scenario) == 1, runs
        details = _render_details(status["cluster"])
        assert "Chaos (injected faults):" in details, details
        assert f"scenario {scenario}" in details, details

        # seed replay: the same seed must reproduce the identical fault
        # schedule and the identical final keyspace (the determinism half
        # of the acceptance contract, enforced per nightly grid cell)
        replay = run_once()
        report["replay"] = {"digest": replay["digest"],
                            "events": replay["events"]}
        assert replay["events"] == rep["events"], \
            "replay diverged: event schedules differ (see report)"
        assert replay["digest"] == rep["digest"], (
            rep["digest"], replay["digest"])
    finally:
        with open(report_path, "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True, default=str)
            fh.write("\n")
    out(f"CHAOS SMOKE OK: {scenario} seed={seed} — "
        f"{len(rep['events'])} chaos events "
        f"({', '.join(f'{k}={v}' for k, v in sorted(chaos['injected'].items()))}), "
        f"storm {rep['storm']['completed']}/{rep['storm']['issued']} "
        f"committed, recovery {rep['recovery_seconds']}s, "
        f"digest {rep['digest'][:16]} (replay identical); "
        f"report at {report_path}")
    return 0


def run_smoke_contention(out=print,
                         report_path: str = CONTENTION_REPORT_PATH) -> int:
    """Conflict-prediction & transaction-repair smoke: the SAME seeded
    high-contention storm run twice
    — abort-only baseline vs scheduler + repair + client windows armed
    — at equal offered load. Asserts committed goodput improves by at
    least CONTENTION_MIN_UPLIFT (default 1.25x), the hot-key ADD
    counters sum EXACTLY to the committed count both runs (the
    bit-exactness oracle: a repair that double-applied or lost a
    mutation cannot hide), `check_consistency` stays green under the
    new paths, non-zero deferral AND repair counters surface in
    `status details`, and the fdbtpu_sched_*/fdbtpu_repair_* exporter
    families parse. The goodput table lands at
    $TMPDIR/fdbtpu_torch_contention_report for the CI artifact (and PERF.md's scheduler off/on/on+repair
    table)."""
    import json
    import os

    from .. import flow
    from ..server import SimCluster
    from ..server.consistency import check_consistency
    from ..server.workloads import ContentionStorm
    from .cli import _render_details
    from .exporter import parse_prometheus, render_prometheus

    seed = int(os.environ.get("CONTENTION_SEED", 8383))
    duration = float(os.environ.get("CONTENTION_DURATION", 4.0))
    rate = float(os.environ.get("CONTENTION_RATE", 150.0))
    min_uplift = float(os.environ.get("CONTENTION_MIN_UPLIFT", 1.25))

    def run_once(scheduling: bool, repair: bool) -> tuple:
        cluster = SimCluster(seed=seed, durable=True)
        # knobs AFTER SimCluster re-initializes them; restored by the
        # next SimCluster (and the finally) so runs stay independent
        flow.SERVER_KNOBS.set("conflict_scheduling", int(scheduling))
        flow.SERVER_KNOBS.set("client_conflict_windows", int(scheduling))
        flow.SERVER_KNOBS.set("txn_repair", int(repair))
        flow.SERVER_KNOBS.set("sched_hot_push_interval", 0.05)
        try:
            dbs = [cluster.client(f"cont{i}") for i in range(4)]

            async def main():
                storm = ContentionStorm(dbs, flow.g_random,
                                        duration=duration, rate=rate)
                stats = await storm.run()
                total = await storm.read_hot_total(dbs[0])
                # bit-exactness oracle: every committed txn added
                # exactly 1; unknown-outcome attempts may or may not
                # have landed and were deliberately not retried
                assert stats["committed"] <= total <= \
                    stats["committed"] + stats["unknown"], (total, stats)
                cons = await check_consistency(cluster)
                status = await dbs[0].get_status()
                return stats, status, cons

            stats, status, cons = cluster.run(main(), timeout_time=900)
            assert cons["rows"] > 0, cons
            return stats, status
        finally:
            flow.reset_server_knobs(randomize=False)
            cluster.shutdown()

    base_stats, _base_status = run_once(scheduling=False, repair=False)
    on_stats, on_status = run_once(scheduling=True, repair=True)

    base_good = base_stats["goodput_per_sec"]
    on_good = on_stats["goodput_per_sec"]
    report = {"seed": seed, "offered_rate": rate, "duration": duration,
              "baseline": base_stats, "scheduler_repair_on": on_stats,
              "uplift": round(on_good / max(base_good, 1e-9), 3),
              "min_uplift": min_uplift}
    try:
        assert base_stats["conflicts"] > 0, \
            ("baseline never conflicted — not a contention storm",
             base_stats)
        assert on_good >= min_uplift * base_good, (
            f"goodput uplift {on_good}/{base_good} = "
            f"{on_good / max(base_good, 1e-9):.2f}x < {min_uplift}x")

        cl = on_status["cluster"]
        sched_doc = cl["conflict_scheduling"]
        assert sched_doc["scheduling_enabled"] == 1, sched_doc
        assert sched_doc["repair_enabled"] == 1, sched_doc
        # the decision planes actually fired
        assert sched_doc["deferrals"] > 0, sched_doc
        assert sched_doc["repair_committed"] > 0, sched_doc
        details = _render_details(cl)
        assert "Conflict scheduler:" in details, details
        assert "Transaction repair:" in details, details

        samples = parse_prometheus(render_prometheus(on_status))
        names = {n for n, _l, _v in samples}
        for need in ("fdbtpu_sched_enabled", "fdbtpu_sched_deferrals",
                     "fdbtpu_sched_released", "fdbtpu_sched_client",
                     "fdbtpu_repair_attempts", "fdbtpu_repair_committed",
                     "fdbtpu_repair_in_flight"):
            assert need in names, f"exporter missing {need}"
        repaired = sum(v for n, _l, v in samples
                       if n == "fdbtpu_repair_committed")
        assert repaired > 0, "no repaired commits in the exporter"
    finally:
        with open(report_path, "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True, default=str)
            fh.write("\n")
    out(f"CONTENTION SMOKE OK: goodput {base_good}/s abort-only -> "
        f"{on_good}/s with scheduler+repair "
        f"({report['uplift']}x, floor {min_uplift}x) at "
        f"{rate}/s offered; "
        f"{on_stats['committed']}/{on_stats['issued']} committed "
        f"(baseline {base_stats['committed']}/{base_stats['issued']}, "
        f"{base_stats['failed']} gave up), "
        f"deferrals={sched_doc['deferrals']} "
        f"repaired={sched_doc['repair_committed']}; "
        f"report at {report_path}")
    return 0


def run_smoke_overload(out=print,
                       report_path: str = OVERLOAD_REPORT_PATH) -> int:
    """Enforced-admission-control smoke:
    the SAME seeded overload storm run twice — a simulated open-loop
    client population (OVERLOAD_CLIENTS logical tenants, Zipfian keys,
    one abusive tenant tag) offering several times the ratekeeper's
    budget against a tightened storage-queue target. Disarmed, the
    run demonstrates the collapse (GRV waits walk toward the client
    timeout for every tenant). Armed (GRV admission queues + tag
    throttling + auto-throttler), the cluster must settle at the
    budget: committed throughput within the ratekeeper's limit,
    BOUNDED admitted-GRV p99, a non-none limiting reason, an auto
    throttle row for the abusive tag in \\xff\\x02/throttledTags/,
    non-zero fdbtpu_throttle_* counters, and the other tenants' p99
    recovering vs the disarmed run. The before/after table lands at
    $TMPDIR/fdbtpu_torch_overload_report.txt for the CI artifact."""
    import json
    import os

    from .. import flow
    from ..client import run_transaction
    from ..server import SimCluster
    from ..server import systemkeys as sk
    from ..server.ratekeeper import LIMIT_REASONS
    from ..server.workloads import OverloadStorm
    from .cli import _render_details
    from .exporter import parse_prometheus, render_prometheus

    seed = int(os.environ.get("OVERLOAD_SEED", 9393))
    duration = float(os.environ.get("OVERLOAD_DURATION", 4.0))
    fair_rate = float(os.environ.get("OVERLOAD_FAIR_RATE", 60.0))
    abusive_rate = float(os.environ.get("OVERLOAD_ABUSIVE_RATE", 240.0))
    n_clients = int(os.environ.get("OVERLOAD_CLIENTS", 100_000))

    def run_once(armed: bool) -> tuple:
        cluster = SimCluster(seed=seed, durable=True, n_proxies=2)
        # knobs AFTER SimCluster re-initializes them; restored by the
        # next SimCluster (and the finally) so the runs stay
        # independent. The tightened storage-queue target is what
        # makes the offered load an OVERLOAD for both runs.
        flow.SERVER_KNOBS.set("rk_target_storage_queue_bytes", 4000)
        flow.SERVER_KNOBS.set("rk_spring_storage_queue_bytes", 1000)
        flow.SERVER_KNOBS.set("qos_sample_interval", 0.25)
        if armed:
            flow.SERVER_KNOBS.set("grv_admission_control", 1)
            flow.SERVER_KNOBS.set("tag_throttling", 1)
            flow.SERVER_KNOBS.set("auto_tag_throttling", 1)
            flow.SERVER_KNOBS.set("tag_throttle_update_interval", 0.25)
            flow.SERVER_KNOBS.set("tag_throttle_poll_interval", 0.1)
            flow.SERVER_KNOBS.set("tag_throttle_busy_rate", 40.0)
            flow.SERVER_KNOBS.set("tag_throttle_duration", 30.0)
            flow.SERVER_KNOBS.set("grv_queue_max_wait", 1.0)
        try:
            dbs = [cluster.client(f"ovl{i}") for i in range(8)]

            async def main():
                storm = OverloadStorm(dbs, flow.g_random,
                                      duration=duration,
                                      fair_rate=fair_rate,
                                      abusive_rate=abusive_rate,
                                      n_clients=n_clients)
                stats = await storm.run()

                async def throttle_rows(tr):
                    tr.set_option("read_system_keys")
                    return await tr.get_range(sk.THROTTLED_TAGS_PREFIX,
                                              sk.THROTTLED_TAGS_END)
                rows = await run_transaction(dbs[0], throttle_rows,
                                             max_retries=200)
                status = await dbs[0].get_status()
                return stats, rows, status

            return cluster.run(main(), timeout_time=900)
        finally:
            flow.reset_server_knobs(randomize=False)
            cluster.shutdown()

    flow.g_trace.reset(None)
    base_stats, _base_rows, base_status = run_once(armed=False)
    base_rk = [e for e in flow.g_trace.events
               if e.get("Type") == "RkUpdate"]
    flow.g_trace.reset(None)
    on_stats, on_rows, on_status = run_once(armed=True)
    on_rk = [e for e in flow.g_trace.events if e.get("Type") == "RkUpdate"]

    def grv_economy(status, stats) -> dict:
        """The confirmation-round economy: offered arrivals vs wire
        GRV requests (client batching) vs causal-confirmation round
        trips (proxy batching + enforcement) — the interior
        request-rate drop the GRV coalescing buys."""
        px = [p["counters"] for p in status["cluster"].get("proxies",
                                                           ())]
        started = sum(c.get("transactions_started", 0) for c in px)
        wire = sum(c.get("grv_wire_requests", 0) for c in px)
        rounds = sum(c.get("grv_confirm_rounds", 0) for c in px)
        return {"offered_arrivals": stats["issued"],
                "transactions_started": started,
                "wire_grv_requests": wire,
                "confirm_rounds": rounds,
                "offered_per_confirm_round": round(
                    stats["issued"] / max(rounds, 1), 2)}

    cl = on_status["cluster"]
    adm = cl.get("admission_control") or {}
    limited = [e for e in on_rk
               if e.get("LimitingReason") not in (None, "none")]
    # the deepest throttle the controller commanded: a spring-zone
    # descent passes through barely-limited updates, so the FLOOR is
    # what proves the storm genuinely out-offered the budget
    budget = min((e["TPSLimit"] for e in limited), default=None)
    # the settle-window budget: what the ratekeeper commanded during
    # the storm's second half (each update capped at the offered rate
    # so a recovered 1e9 "unlimited" tick can't poison the mean)
    offered = fair_rate + abusive_rate
    late_cut = max((e.get("Time", 0.0) for e in on_rk), default=0.0) \
        - duration / 2
    late_updates = [e for e in on_rk if e.get("Time", 0.0) >= late_cut]
    late_budget = (sum(min(e["TPSLimit"], offered) for e in late_updates)
                   / len(late_updates) if late_updates else offered)
    report = {
        "seed": seed, "n_clients": n_clients,
        "offered_per_sec": fair_rate + abusive_rate,
        "duration": duration,
        "disarmed": base_stats, "armed": on_stats,
        "ratekeeper_budget_floor_tps": budget,
        "late_window_budget_tps": late_budget,
        "throttled_tags": [r["tag"] for r in adm.get("throttled_tags",
                                                     ())],
        "grv_batching": {"disarmed": grv_economy(base_status,
                                                 base_stats),
                         "armed": grv_economy(on_status, on_stats)},
        "rk_updates": {"disarmed": len(base_rk), "armed": len(on_rk),
                       "armed_limited": len(limited)},
    }
    try:
        wall = max(on_stats["wall_seconds"], 1e-9)
        # (1) the storm genuinely overloads: the ratekeeper engaged a
        # non-none limiting reason during the armed run
        assert limited, ("limiting reason never engaged", on_rk[-3:])
        for e in limited:
            assert e["LimitingReason"] in LIMIT_REASONS, e
        # (2) the cluster SETTLES at the budget instead of collapsing:
        # once past the initial unthrottled burst (the storm's second
        # half), committed throughput sits within the rate the
        # ratekeeper commanded over that window, with real progress —
        # and the offered load is genuinely above the throttled budget
        assert on_stats["completed"] > 0, on_stats
        assert budget is not None and budget > 0, limited[-3:]
        late_rate = on_stats["late_committed_per_sec"]
        assert late_rate <= late_budget * 1.5 + 5.0, (late_rate,
                                                      late_budget)
        assert offered > budget, ("not an overload at all", budget)
        # (3) bounded admitted-GRV p99: the wait bound (1.0s armed)
        # plus confirmation slack — far below the 5s client timeout
        # the disarmed queue walks toward
        for group in ("abusive", "others"):
            g = on_stats["grv"][group]
            if g.get("count"):
                assert g["p99"] <= 2.0, (group, g)
        # (4) the abusive tenant was auto-throttled: a live row in the
        # system keyspace, parseable, auto-flagged
        throttled = {}
        for key, value in on_rows:
            tag = sk.parse_throttled_tag_key(key)
            parsed = sk.parse_tag_throttle_value(value)
            if tag is not None and parsed is not None:
                throttled[tag] = parsed
        assert b"tenant-abuse" in throttled, sorted(throttled)
        assert throttled[b"tenant-abuse"][3] is True, throttled
        # (5) enforcement + backoff actually fired: non-zero
        # fdbtpu_throttle_* counters through the exporter
        samples = parse_prometheus(render_prometheus(on_status))
        by_name: dict = {}
        for n, _l, v in samples:
            by_name[n] = by_name.get(n, 0) + v
        for need in ("fdbtpu_admission_enabled",
                     "fdbtpu_admission_admitted",
                     "fdbtpu_throttle_tags", "fdbtpu_throttle_tag_tps"):
            assert need in by_name, f"exporter missing {need}"
        assert by_name.get("fdbtpu_throttle_tags", 0) > 0, by_name
        throttle_activity = (by_name.get("fdbtpu_throttle_delayed", 0)
                             + by_name.get("fdbtpu_throttle_client", 0)
                             + by_name.get("fdbtpu_throttle_rejected", 0))
        assert throttle_activity > 0, by_name
        # (6) the other tenants RECOVER: their p99 improves vs the
        # disarmed collapse (same seed, same offered load)
        base_p99 = base_stats["grv"]["others"]["p99"]
        on_p99 = on_stats["grv"]["others"]["p99"]
        assert on_p99 < base_p99, (on_p99, base_p99)
        # ...and the disarmed run really was a collapse: unbounded
        # queueing pushed waits at least toward seconds, or clients
        # timed out outright
        base_timeouts = base_stats["errors"].get("timed_out", 0)
        assert base_p99 > 1.0 or base_timeouts > 0, base_stats
        # (7) operator surfaces render
        details = _render_details(cl)
        assert "Admission control:" in details, details
        assert "throttled tag" in details, details
        report["asserts"] = "all passed"
    finally:
        with open(report_path, "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True, default=str)
            fh.write("\n")
    out(f"OVERLOAD SMOKE OK: {on_stats['distinct_clients']} of "
        f"{n_clients} simulated clients offering "
        f"{fair_rate + abusive_rate:g}/s vs budget ~{budget:.0f}/s — "
        f"armed committed {on_stats['completed']}/{on_stats['issued']} "
        f"({on_stats['committed_per_sec']}/s, attainment "
        f"{on_stats['attainment']}), others' grv p99 "
        f"{base_p99:.3f}s -> {on_p99:.3f}s, "
        f"abusive tag auto-throttled, "
        f"{report['grv_batching']['armed']['offered_per_confirm_round']}"
        f" offered GRVs per confirmation round; "
        f"report at {report_path}")
    return 0


def run_smoke_heat(out=print, report_path: str = HEAT_REPORT_PATH) -> int:
    """Storage-heat smoke: the SAME seeded
    HotShardStorm (one tenant tag concentrating Zipfian reads on a
    narrow hot range, background tenants reading uniformly) run three
    times — plane off, armed, and armed replay.

    Off-posture pin: arming the plane must not perturb the sim at all
    (identical keyspace digest, scheduler step count and network
    message count — the storm is read-only, and the heat plane adds no
    messages or tasks). Armed: `status.cluster.storage_heat` must NAME
    the injected hot sub-range and the hot tenant tag, the heat
    signals must ride the storage QosSamples, the fdbtpu_storage_*
    exporter families must parse, and `cli heat` + the `status
    details` section must render. Replay: the armed run's heat rows
    must be bit-identical at the same seed. The report lands at
    $TMPDIR/fdbtpu_torch_heat_report.txt for the CI artifact."""
    import json
    import os

    from .. import flow
    from ..server import SimCluster
    from ..server.chaos import database_digest
    from ..server.workloads import HotShardStorm
    from .cli import _render_details, _render_heat
    from .exporter import parse_prometheus, render_prometheus

    seed = int(os.environ.get("HEAT_SEED", 5151))
    duration = float(os.environ.get("HEAT_DURATION", 3.0))

    def run_once(armed: bool) -> tuple:
        cluster = SimCluster(seed=seed, durable=True)
        # knobs AFTER SimCluster re-initializes them; restored by the
        # next SimCluster (and the finally) so the runs stay independent
        flow.SERVER_KNOBS.set("qos_sample_interval", 0.25)
        if armed:
            flow.SERVER_KNOBS.set("storage_heat_tracking", 1)
        try:
            dbs = [cluster.client(f"heat{i}") for i in range(4)]

            async def main():
                storm = HotShardStorm(dbs, flow.g_random,
                                      duration=duration)
                await storm.seed(dbs[0])
                stats = await storm.run()
                await flow.delay(1.0)   # QoS sampler + heat rollup ticks
                status = await dbs[0].get_status()
                digest = await database_digest(dbs[0])
                return storm, stats, status, digest

            storm, stats, status, digest = cluster.run(main(),
                                                       timeout_time=600)
            return (storm, stats, status, digest,
                    cluster.sched.tasks_run, cluster.net.messages_sent)
        finally:
            flow.reset_server_knobs(randomize=False)
            cluster.shutdown()

    _sto, off_stats, off_status, off_digest, off_tasks, off_msgs = \
        run_once(armed=False)
    storm, on_stats, on_status, on_digest, on_tasks, on_msgs = \
        run_once(armed=True)
    _sto2, re_stats, re_status, re_digest, _re_tasks, re_msgs = \
        run_once(armed=True)

    cl = on_status["cluster"]
    heat = cl.get("storage_heat") or {}
    report = {"seed": seed, "duration": duration,
              "storm": on_stats, "heat": heat,
              "off": {"digest": off_digest, "tasks_run": off_tasks,
                      "messages_sent": off_msgs,
                      "heat": off_status["cluster"].get("storage_heat")},
              "armed": {"digest": on_digest, "tasks_run": on_tasks,
                        "messages_sent": on_msgs},
              "replay": {"digest": re_digest, "messages_sent": re_msgs,
                         "heat": re_status["cluster"].get("storage_heat")}}
    try:
        # (1) off-posture pin: arming the observe-only plane must not
        # perturb the sim — same digest, same step count, same message
        # count, same storm outcome
        assert on_digest == off_digest, (off_digest, on_digest)
        assert on_tasks == off_tasks, (off_tasks, on_tasks)
        assert on_msgs == off_msgs, (off_msgs, on_msgs)
        assert on_stats["issued"] == off_stats["issued"], report
        assert on_stats["completed"] == off_stats["completed"], report
        # ...and the disarmed plane is genuinely empty
        off_heat = off_status["cluster"]["storage_heat"]
        assert off_heat["tracking_enabled"] == 0, off_heat
        assert not off_heat["ranges"], off_heat
        assert not off_heat["busiest_read_tags"], off_heat

        # (2) the armed plane NAMES the injected hot sub-range: the
        # top-ranked flagged range overlaps the storm's hot range
        assert heat["tracking_enabled"] == 1, heat
        assert heat["ranges"], "no read-hot ranges flagged"
        hb, he = storm.hot_range
        top = heat["ranges"][0]
        tb, te = bytes.fromhex(top["begin"]), bytes.fromhex(top["end"])
        assert tb < he and te > hb, (
            "top hot range misses the injected one", top,
            hb.hex(), he.hex())
        assert top["density"] >= float(
            flow.SERVER_KNOBS.read_hot_range_ratio), top

        # (3) ...and the hot tenant: every reporting server's busiest
        # read tag is the storm's hot tag
        btags = heat["busiest_read_tags"]
        assert btags, "no busiest-read-tag rows"
        assert all(r["tag"] == storm.hot_tag.hex() for r in btags), btags

        # (4) the heat signals ride the storage QosSamples and the
        # ratekeeper saw the observe-only inputs
        roles = (cl.get("qos") or {}).get("roles") or {}
        sto = next(iter(roles.get("storage", {}).values()))
        for sig in ("read_bytes_per_sec", "read_ops_per_sec",
                    "read_hot_ranges", "busiest_read_tag_busyness",
                    "write_bandwidth"):
            assert sig in sto, (sig, sto)
        assert sto["read_bytes_per_sec"] > 0, sto
        inputs = (cl.get("qos") or {}).get("inputs") or {}
        assert inputs.get("worst_read_hot", 0) > 0, inputs
        assert inputs.get("busiest_read_tag_busyness", 0) > 0, inputs
        assert (cl.get("qos") or {}).get("busiest_read_tag") == \
            storm.hot_tag.hex(), cl.get("qos")

        # (5) exporter families parse and cover the plane
        samples = parse_prometheus(render_prometheus(on_status))
        names = {n for n, _l, _v in samples}
        for need in ("fdbtpu_storage_read_bytes",
                     "fdbtpu_storage_read_ops",
                     "fdbtpu_storage_read_hot_ranges",
                     "fdbtpu_storage_tag_busyness",
                     "fdbtpu_storage_shard_bytes",
                     "fdbtpu_storage_write_bandwidth",
                     "fdbtpu_storage_heat_tracking"):
            assert need in names, f"exporter missing {need}"
        busy = [(l, v) for n, l, v in samples
                if n == "fdbtpu_storage_tag_busyness"]
        assert busy and all(l["tag"] == storm.hot_tag.hex()
                            for l, _v in busy), busy

        # (6) operator surfaces render
        heat_view = _render_heat(cl)
        for section in ("Storage heat", "Read-hot sub-ranges",
                        "Busiest read tag", storm.hot_tag.hex()):
            assert section in heat_view, (section, heat_view)
        details = _render_details(cl)
        assert "Storage heat (read-hot sub-ranges):" in details, details

        # (7) same-seed replay: the armed plane names the same range
        # and tag BIT-IDENTICALLY (digest + message count too)
        re_heat = re_status["cluster"]["storage_heat"]
        assert re_heat == heat, (heat, re_heat)
        assert re_digest == on_digest, (on_digest, re_digest)
        assert re_msgs == on_msgs, (on_msgs, re_msgs)
        assert re_stats == on_stats or re_stats["issued"] == \
            on_stats["issued"], (on_stats, re_stats)
        report["asserts"] = "all passed"
    finally:
        with open(report_path, "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True, default=str)
            fh.write("\n")
    out(f"HEAT SMOKE OK: {on_stats['issued']} read arrivals "
        f"({on_stats['hot_issued']} hot / "
        f"{on_stats['background_issued']} background), hot range "
        f"[{top['begin']}, {top['end']}) density {top['density']}x "
        f"named on server {top['server']}, busiest tag "
        f"{btags[0]['tag']} everywhere, off-posture pin held "
        f"(digest {on_digest[:16]}, {on_tasks} steps, {on_msgs} msgs), "
        f"replay identical; report at {report_path}")
    return 0


def run_smoke_simprof(out=print,
                      report_path: str = SIMPROF_REPORT_PATH) -> int:
    """Sim-perf attribution smoke: the
    SAME seeded open-loop storm run twice — SIM_TASK_STATS off, then
    armed. The off-posture pin: identical keyspace digest, identical
    network message count, identical scheduler step count and storm
    outcome (profiling reads only the wall clock, never the sim
    timeline). The armed run must POPULATE the plane: a per-task table
    naming the storm's actors, a priority-band rollup, per-message-type
    counts, the wall-vs-sim budget in the storm report, the
    fdbtpu_task_* / fdbtpu_net_* / fdbtpu_sim_* exporter families
    parsing, and the `cli top` attribution section rendering. The
    report lands at $TMPDIR/fdbtpu_torch_simprof_smoke.txt for the CI
    artifact."""
    import json
    import os

    from .. import flow
    from ..server import SimCluster
    from ..server.chaos import database_digest
    from ..server.workloads import OpenLoopStorm
    from .cli import _render_top
    from .exporter import parse_prometheus, render_prometheus

    seed = int(os.environ.get("SIMPROF_SEED", 7272))
    duration = float(os.environ.get("SIMPROF_DURATION", 2.0))

    def run_once(armed: bool) -> tuple:
        cluster = SimCluster(seed=seed, durable=True)
        if armed:
            # knob AFTER SimCluster re-initializes them; arm directly
            # (the knob path arms at boot for operator-configured runs)
            flow.SERVER_KNOBS.set("sim_task_stats", 1)
            cluster.sched.start_task_stats()
            cluster.net.arm_message_stats()
        try:
            dbs = [cluster.client(f"sp{i}") for i in range(4)]

            async def main():
                storm = OpenLoopStorm(
                    dbs, flow.g_random, duration=duration, rate=80.0,
                    burst_rate=300.0, burst_start=0.5, burst_len=0.5,
                    max_inflight=256)
                stats = await storm.run()
                digest = await database_digest(dbs[0])
                status = await dbs[0].get_status()
                return stats, digest, status

            stats, digest, status = cluster.run(main(), timeout_time=600)
            return (stats, digest, status, cluster.sched.tasks_run,
                    cluster.net.messages_sent)
        finally:
            flow.reset_server_knobs(randomize=False)
            cluster.shutdown()

    off_stats, off_digest, _off_status, off_tasks, off_msgs = \
        run_once(armed=False)
    on_stats, on_digest, on_status, on_tasks, on_msgs = \
        run_once(armed=True)

    sp = on_stats.get("sim_perf") or {}
    report = {"seed": seed, "duration": duration,
              "off": {"digest": off_digest, "tasks_run": off_tasks,
                      "messages_sent": off_msgs,
                      "issued": off_stats["issued"],
                      "completed": off_stats["completed"]},
              "armed": {"digest": on_digest, "tasks_run": on_tasks,
                        "messages_sent": on_msgs,
                        "issued": on_stats["issued"],
                        "completed": on_stats["completed"]},
              "sim_perf": sp}
    try:
        # (1) off-posture pin: the armed plane must not perturb the sim
        assert on_digest == off_digest, (off_digest, on_digest)
        assert on_msgs == off_msgs, (off_msgs, on_msgs)
        assert on_tasks == off_tasks, (off_tasks, on_tasks)
        assert on_stats["issued"] == off_stats["issued"], report
        assert on_stats["completed"] == off_stats["completed"], report

        # (2) the plane populates under the storm
        assert sp.get("top_tasks"), sp
        top_names = [r["task"] for r in sp["top_tasks"]]
        assert "storm-txn-*" in top_names, top_names
        assert sp.get("top_messages"), sp
        msg_types = {r["type"] for r in sp["top_messages"]}
        assert "GetReadVersionRequest" in msg_types, msg_types
        rl = on_status["cluster"]["run_loop"]
        ts = rl.get("task_stats") or {}
        assert ts.get("tasks") and ts.get("bands"), rl
        assert rl.get("sim_per_busy"), rl
        netdoc = on_status["cluster"]["network"]
        assert netdoc["armed"] and netdoc["types"], netdoc

        # (3) exporter families parse and cover the plane
        samples = parse_prometheus(render_prometheus(on_status))
        names = {n for n, _l, _v in samples}
        for need in ("fdbtpu_task_steps", "fdbtpu_task_busy_us",
                     "fdbtpu_task_band_steps", "fdbtpu_net_messages",
                     "fdbtpu_net_delivery_timers", "fdbtpu_sim_seconds",
                     "fdbtpu_sim_per_busy_second"):
            assert need in names, f"exporter missing {need}"

        # (4) the operator view renders the attribution tables
        top = _render_top(on_status["cluster"])
        assert "Run-loop attribution" in top, top
        assert "Network messages" in top, top
        report["asserts"] = "all passed"
    finally:
        with open(report_path, "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True, default=str)
            fh.write("\n")
    out(f"SIMPROF SMOKE OK: seed={seed} off-posture pin held "
        f"(digest {on_digest[:16]}, {on_tasks} steps, {on_msgs} msgs "
        f"both postures); sim {sp['sim_seconds']}s in wall "
        f"{sp['wall_seconds']}s ({sp['sim_per_wall']}x), top task "
        f"{top_names[0]}, {len(msg_types)} message types; "
        f"report at {report_path}")
    return 0


def run_smoke_packed(out=print, device=None) -> int:
    """Packed interval feed-path smoke: a CUDA-backend cluster
    (`device`: None is the card, "cpu" the plain versions) runs a
    conflicting workload with both point and
    genuine interval conflict ranges, and the packed single-buffer
    discipline must be LIVE and counted — exactly ONE host->device
    transfer per dispatched batch (`kernel_stats()["h2d"]`), staging
    buffers reused rather than reallocated, the `h2d=` figure rendered
    in `status details`, and the fdbtpu_kernel_h2d_* exporter family
    parsing with per_batch == 1."""
    import os

    from .. import flow
    from ..client import run_transaction
    from ..server import SimCluster
    from .cli import Cli
    from .exporter import parse_prometheus, render_prometheus

    cluster = SimCluster(seed=4747, durable=True, conflict_backend="cuda",
                         device=device)
    flow.SERVER_KNOBS.set(
        "resolve_pipeline_depth",
        int(os.environ.get("RESOLVE_PIPELINE_DEPTH", 4)))
    assert int(flow.SERVER_KNOBS.interval_packed_feed) == 1, \
        "packed feed must be the default posture"
    cli = Cli.for_cluster(cluster)
    try:
        db = cluster.client("psmoke")

        async def workload():
            async def seed(tr):
                for i in range(8):
                    tr.set(b"k%02d" % i, b"0")
            await run_transaction(db, seed)
            # enough conflicting rounds that the staging pool must be
            # REUSED (transfers well past the pool size), with interval
            # read ranges (get_range) riding next to point ones
            for i in range(12):
                tr = db.create_transaction()
                await tr.get_range(b"k00", b"k99")
                tr.set(b"mine%d" % i, b"v")

                async def bump(t2, i=i):
                    t2.set(b"k%02d" % (i % 8), b"x%d" % i)
                await run_transaction(db, bump)
                try:
                    await tr.commit()
                    raise AssertionError("expected a conflict")
                except flow.FdbError as e:
                    assert e.name == "not_committed", e.name
            return await db.get_status()

        status = cluster.run(workload(), timeout_time=300)
        cl = status["cluster"]
        res = cl.get("resolvers", ())
        assert res, "no resolvers in status"
        for r in res:
            kern = r.get("kernel") or {}
            assert kern.get("backend") == "cuda", kern.get("backend")
            h2d = kern.get("h2d") or {}
            batches = kern.get("batches", 0)
            assert batches > 0, "no batches dispatched"
            # THE acceptance figure: one transfer per interval batch,
            # counted at the dispatch seam — not inferred
            assert h2d.get("transfers") == batches, (h2d, batches)
            assert h2d.get("per_batch") == 1.0, h2d
            assert h2d.get("bytes", 0) > 0, h2d
            # steady state is allocation-flat: the staging pool is
            # bounded by pipeline depth + 2 (plus the encode scratch),
            # far below one-allocation-per-batch churn
            allocs = h2d.get("staging_allocs", 0)
            assert 0 < allocs < batches, (allocs, batches)

        details = cli.execute("status details")
        assert "Resolver kernels:" in details, details
        assert "h2d=1/batch" in details, details

        text = render_prometheus(status)
        samples = parse_prometheus(text)   # raises on malformed lines
        names = {n for n, _, _ in samples}
        for need in ("fdbtpu_kernel_h2d_transfers",
                     "fdbtpu_kernel_h2d_bytes",
                     "fdbtpu_kernel_h2d_per_batch",
                     "fdbtpu_kernel_h2d_staging_allocs"):
            assert need in names, f"exporter missing {need}"
        per_batch = [v for n, _, v in samples
                     if n == "fdbtpu_kernel_h2d_per_batch"]
        assert per_batch and all(v == 1.0 for v in per_batch), per_batch
        h2d = res[0]["kernel"]["h2d"]
        out(f"PACKED SMOKE OK: {h2d['transfers']} transfers / "
            f"{res[0]['kernel']['batches']} batches "
            f"({h2d['bytes']}B, {h2d['staging_allocs']} staging allocs), "
            f"{len(samples)} exporter samples")
        return 0
    finally:
        cluster.shutdown()


def run_smoke_splits(out=print,
                     report_path: str = SPLITS_REPORT_PATH) -> int:
    """Dynamic resolver split smoke: the
    SAME seeded skewed SplitStorm run twice on a 2-proxy × 2-resolver
    cluster — balance loop armed-but-idle (unreachable MIN_WORK) as
    the unsplit baseline, then with the one-shot FORCE dropped in
    mid-storm so exactly one load-driven split (checkpoint → clip →
    graft-install → early release) lands under live traffic.

    Asserts: the split run's read-modify-write counter sums are EXACT
    and its keyspace digest equals the unsplit same-seed run's (the
    bit-exact-handoff acceptance); ≥1 split with the donor's per-batch
    load share measurably reduced; split counters render in `status
    details`; and the fdbtpu_resolver_split_* exporter family parses.
    Report lands at $TMPDIR/fdbtpu_torch_splits_report.txt for the CI
    artifact."""
    import json
    import os

    from .. import flow
    from ..server import SimCluster
    from ..server.workloads import SplitStorm
    from .cli import _render_details
    from .exporter import parse_prometheus, render_prometheus

    seed = int(os.environ.get("SPLITS_SEED", 4242))
    duration = float(os.environ.get("SPLITS_DURATION", 10.0))

    def run_once(force_split: bool) -> tuple:
        cluster = SimCluster(seed=seed, n_resolvers=2, n_proxies=2)
        # the loop is SPAWNED (so arming mid-storm works) but cannot
        # trigger: MIN_WORK is unreachable until the storm drops in
        # the one-shot FORCE; merges disabled so the forced split's
        # load-share drop is stable for the assert
        flow.SERVER_KNOBS.set("resolver_balance", 1)
        flow.SERVER_KNOBS.set("resolver_balance_min_work", 10 ** 12)
        flow.SERVER_KNOBS.set("resolver_balance_merge_work", -1)
        flow.SERVER_KNOBS.set("resolver_balance_interval", 0.5)
        try:
            dbs = [cluster.client(f"sp{i}") for i in range(4)]

            async def main():
                storm = SplitStorm(
                    cluster, dbs, flow.g_random, duration=duration,
                    arm_at=duration * 0.4 if force_split else None)
                rep = await storm.run()
                status = await dbs[0].get_status()
                return rep, status

            rep, status = cluster.run(main(), timeout_time=900)
            return rep, status
        finally:
            flow.reset_server_knobs(randomize=False)
            cluster.shutdown()

    base_rep, _base_status = run_once(force_split=False)
    rep, status = run_once(force_split=True)

    report = {"seed": seed, "duration": duration,
              "unsplit": base_rep, "split": rep}
    try:
        # unsplit baseline really was unsplit; forced run really split
        assert base_rep["balance"]["splits"] == 0, base_rep["balance"]
        assert rep["balance"]["splits"] >= 1, rep["balance"]
        assert rep["balance"]["releases"] >= 1, rep["balance"]
        # bit-exact across the handoff: exact increment sums AND the
        # same final keyspace as the same-seed unsplit run
        assert rep["exact"], (rep["expected"], rep["observed"])
        assert base_rep["exact"], base_rep
        assert rep["digest"] == base_rep["digest"], \
            ("split run diverged from unsplit same-seed run",
             rep["digest"], base_rep["digest"])
        assert rep["stats"]["conflicted"] == 0, rep["stats"]
        # the split measurably reduced the donor's per-batch share
        assert rep["share_before"] is not None \
            and rep["share_after"] is not None, rep
        assert rep["share_after"] <= rep["share_before"] - 0.1, (
            rep["share_before"], rep["share_after"])

        cl = status["cluster"]
        bal = cl["resolver_balance"]
        assert bal["enabled"] == 1 and bal["splits"] >= 1, bal
        assert bal["last_split"], bal
        installs = sum(r["splits"].get("installs", 0)
                       for r in cl["resolvers"])
        assert installs >= 1, cl["resolvers"]
        details = _render_details(cl)
        assert "Resolver balance" in details, details
        assert "last split" in details, details
        samples = parse_prometheus(render_prometheus(status))
        names = {n for n, _l, _v in samples}
        for need in ("fdbtpu_resolver_split_enabled",
                     "fdbtpu_resolver_split_splits",
                     "fdbtpu_resolver_split_releases",
                     "fdbtpu_resolver_split_owned_ranges",
                     "fdbtpu_resolver_split_state_rows",
                     "fdbtpu_resolver_split_installs"):
            assert need in names, f"exporter missing {need}"
        splits_total = sum(v for n, _l, v in samples
                           if n == "fdbtpu_resolver_split_splits")
        assert splits_total >= 1, "no splits in the exporter"
    finally:
        with open(report_path, "w") as fh:
            fh.write(json.dumps(report, indent=2, sort_keys=True,
                                default=str) + "\n")
    out(f"splits smoke OK: {rep['balance']['splits']} split(s), donor "
        f"share {rep['share_before']} -> {rep['share_after']}, digest "
        f"matches unsplit run; report -> {report_path}")
    return 0


def run_smoke_soak(out=print,
                   report_path: str = SOAK_REPORT_PATH) -> int:
    """Short multi-OS-process soak: a
    real 2-client-worker soak over TCP with one SIGKILL+respawn armed
    and tracing on.

    Asserts: commits landed with ZERO divergent verdicts; the kill
    recovered (recovery time recorded); the keyspace digest is stable
    across two passes; the mid-run federated scrape covered host +
    workers and parsed cleanly; and tools/tracemerge.py reassembled at
    least one FULL client->proxy->resolver->tlog span chain across the
    OS-process boundary from the run directory's trace files."""
    import json
    import os

    from .soak import render_soak_report, run_soak

    seed = int(os.environ.get("SOAK_SEED", 11))
    duration = float(os.environ.get("SOAK_DURATION", 8.0))
    doc = run_soak(processes=2, resolvers=2, duration=duration,
                   rate=400.0, kills=1, seed=seed, out=out)
    try:
        assert not doc["errors"], doc["errors"]
        assert doc["totals"]["committed"] > 0, doc["totals"]
        assert doc["totals"]["divergent_verdicts"] == 0, doc["totals"]
        assert doc["digest"]["consistent"], doc["digest"]
        assert len(doc["kills"]) == 1, doc["kills"]
        assert "recovery_s" in doc["kills"][0], doc["kills"]
        fed = doc["federation"]
        # host + >=2 worker entries, and the scrape parsed (the parse
        # runs inside run_soak; a malformed scrape lands in errors)
        assert fed.get("process_count", 0) >= 3, fed
        assert fed.get("scrape_samples", 0) > 0, fed
        tr = doc["trace"]
        assert tr["full_commit_chains"] >= 1, tr
        assert len(tr["processes"]) >= 2, tr
        assert doc["ok"], "soak self-check failed"
    finally:
        with open(report_path, "w") as fh:
            fh.write(json.dumps(doc, indent=2, sort_keys=True,
                                default=str) + "\n")
            fh.write(render_soak_report(doc))
    out(f"soak smoke OK: {doc['totals']['committed']} committed, "
        f"kill recovered in {doc['kills'][0]['recovery_s']}s, "
        f"{doc['trace']['full_commit_chains']} cross-process commit "
        f"chains; report -> {report_path} "
        f"trace-run-dir={doc['run_dir']}")
    return 0


def run_smoke_slo(out=print,
                  report_path: str = SLO_REPORT_PATH) -> int:
    """Longitudinal-observability cell: the
    soak run with the metric-history plane armed and a mid-run commit
    latency breach injected.

    Asserts: TimeKeeper rows landed and the clock<->version round trip
    holds; the \\xff\\x02/metrics/ keyspace holds enough signal series
    to rebuild the throughput timeline after the horizon (restart-safe
    accounting — read back from the database, not host memory); the
    ONLINE burn-rate SLO engine tripped during the injected breach (at
    least one ok->breach transition in status.cluster.slo); and the
    incident bundle covering the breach window was written with the
    version-aligned series, status/chaos docs, and the tracemerge
    report. The run is judged on DETECTION, not on ending green: the
    p99 reservoir decays slowly after the injection lifts, so the
    final evaluated state may legitimately still show the ceiling
    rules red."""
    import json
    import os

    from .soak import render_soak_report, run_soak

    seed = int(os.environ.get("SOAK_SEED", 11))
    duration = float(os.environ.get("SOAK_DURATION", 10.0))
    doc = run_soak(processes=2, resolvers=2, duration=duration,
                   rate=400.0, kills=0, seed=seed, slo=True,
                   breach_at=duration * 0.45,
                   breach_len=duration * 0.3, out=out)
    try:
        assert not doc["errors"], doc["errors"]
        assert doc["totals"]["committed"] > 0, doc["totals"]
        assert doc["totals"]["divergent_verdicts"] == 0, doc["totals"]
        assert doc["digest"]["consistent"], doc["digest"]
        sl = doc["slo"]
        assert sl["signals"] > 0, sl
        assert sl["timekeeper_rows"] > 0, sl
        assert sl["timekeeper_ok"], sl
        assert sl["rebuilt_samples"] > 0, sl
        assert sl["online_breaches"] >= 1, sl
        assert sl["posthoc_breaches"] >= 1, sl
        b = sl.get("bundle") or {}
        assert b, sl
        for name in ("manifest.json", "series.json",
                     "timekeeper.json", "status.json"):
            assert os.path.exists(os.path.join(b["dir"], name)), b
        assert b["samples"] > 0, b
        assert doc["ok"], "slo soak self-check failed"
    finally:
        with open(report_path, "w") as fh:
            fh.write(json.dumps(doc, indent=2, sort_keys=True,
                                default=str) + "\n")
            fh.write(render_soak_report(doc))
    out(f"slo smoke OK: {doc['slo']['signals']} signals, "
        f"{doc['slo']['timekeeper_rows']} timekeeper rows, "
        f"{doc['slo']['online_breaches']} online breach(es), bundle -> "
        f"{doc['slo']['bundle']['dir']}; report -> {report_path}")
    return 0


def run_smoke_path(out=print,
                   report_path: str = PATH_REPORT_PATH) -> int:
    """Latency-forensics cell: a CRITICAL_PATH-
    armed cluster with every tlog fsync stalled by an injected delay.

    Asserts: every commit batch was decomposed into consecutive
    pipeline stations and the per-txn segments telescope to the
    end-to-end latency within the pinned tolerance; the injected stall
    makes `tlog_fsync` the attributed dominant cause — per-commit
    counts, the decaying top-cause table, AND the queue-vs-service
    split all agree; the host ProcessMetrics sample rides the status
    doc; the fdbtpu_path_* / fdbtpu_process_* exporter families parse
    cleanly; and the `cli path` view renders. The report lands in
    $TMPDIR/fdbtpu_torch_path_report.txt for the CI artifact."""
    import json

    from .. import flow
    from ..client import run_transaction
    from ..server import SimCluster
    from .cli import Cli
    from .exporter import parse_prometheus, render_prometheus

    cluster = SimCluster(seed=7, durable=True, critical_path=True)
    # the stall: 3ms added to every fsync — set AFTER construction
    # (SimCluster re-initializes the knob set)
    flow.SERVER_KNOBS.set("tlog_fsync_injection", 0.003)
    cli = Cli.for_cluster(cluster)
    try:
        db = cluster.client("path-smoke")

        async def workload():
            for i in range(40):
                async def w(tr, i=i):
                    tr.set(b"path/%04d" % i, b"v%d" % i)
                await run_transaction(db, w)
            # past CRITICAL_PATH_INTERVAL so the CC folds the proxies'
            # samples into the decaying cause table at least once
            await flow.delay(5.0)
            return await db.get_status()

        status = cluster.run(workload(), timeout_time=300)
        cl = status["cluster"]
        cp = cl["critical_path"]
        assert cp["enabled"] == 1, cp
        assert cp["samples"] >= 40, cp
        # the decomposition invariant: station segments sum to the
        # end-to-end latency within the pinned tolerance
        assert cp["max_residual_seconds"] <= cp["tolerance"], cp
        # the injected stall must be ATTRIBUTED: tlog_fsync dominant
        # per-commit, now, and in the decayed table
        dom_share = (cp["dominant"].get("tlog_fsync", 0)
                     / max(1, cp["samples"]))
        assert dom_share >= 0.9, cp["dominant"]
        assert cp["dominant_now"] == "tlog_fsync", cp
        assert cp["top"] and cp["top"][0]["station"] == "tlog_fsync", \
            cp["top"]
        split = cp["splits"]["tlog_fsync"]
        assert split["service"]["total"] > 0, split
        assert split["service"]["sum_seconds"] > 0, split
        pm = cl["process_metrics"]
        assert pm["enabled"] == 1, pm
        assert (pm.get("host") or {}).get("samples", 0) >= 1, pm

        text = render_prometheus(status)
        samples = parse_prometheus(text)   # raises on malformed lines
        names = {n for n, _, _ in samples}
        for need in ("fdbtpu_path_samples_total",
                     "fdbtpu_path_residual_seconds_max",
                     "fdbtpu_path_dominant_total",
                     "fdbtpu_path_station_seconds_total",
                     "fdbtpu_path_cause_score",
                     "fdbtpu_process_cpu_seconds"):
            assert need in names, f"exporter missing {need}"
        dom = {lb["station"]: v for n, lb, v in samples
               if n == "fdbtpu_path_dominant_total"}
        assert max(dom, key=dom.get) == "tlog_fsync", dom

        view = cli.execute("path")
        assert "tlog_fsync" in view, view
        rec = flow.g_flightrec.status()
        assert rec["armed"] == 1 and rec["buffered"] > 0, rec
        with open(report_path, "w") as fh:
            fh.write(json.dumps({"critical_path": cp,
                                 "process_metrics": pm,
                                 "flightrec": rec},
                                indent=2, sort_keys=True,
                                default=str) + "\n\n")
            fh.write(view + "\n")
        out(f"path smoke OK: {cp['samples']} commits decomposed, "
            f"dominant=tlog_fsync ({dom_share:.0%} of commits), "
            f"max residual {cp['max_residual_seconds']}s <= "
            f"tolerance {cp['tolerance']}s; report -> {report_path}")
        return 0
    finally:
        cluster.shutdown()


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # where the CUDA-backed modes (--faults, --packed) resolve: the
    # card by default, `--device cpu` for the plain versions
    device = None
    if "--device" in argv:
        device = argv[argv.index("--device") + 1]
    if "--path" in argv:
        return run_smoke_path()
    if "--soak" in argv:
        return run_smoke_soak()
    if "--slo" in argv:
        return run_smoke_slo()
    if "--profile" in argv:
        return run_smoke_profile()
    if "--faults" in argv:
        return run_smoke_faults(device=device)
    if "--storm" in argv:
        return run_smoke_storm()
    if "--chaos" in argv:
        return run_smoke_chaos()
    if "--contention" in argv:
        return run_smoke_contention()
    if "--overload" in argv:
        return run_smoke_overload()
    if "--simprof" in argv:
        return run_smoke_simprof()
    if "--heat" in argv:
        return run_smoke_heat()
    if "--packed" in argv:
        return run_smoke_packed(device=device)
    if "--splits" in argv:
        return run_smoke_splits()
    return run_smoke()


if __name__ == "__main__":
    sys.exit(main())
