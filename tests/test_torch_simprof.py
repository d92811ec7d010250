"""The reference's tests/test_simprof.py on the port.

The sim-perf attribution plane.

What is pinned here, in order:

- **Profiling never perturbs the sim**: the SAME seeded ChaosStorm
  with SIM_TASK_STATS armed vs off yields an IDENTICAL chaos event
  schedule and keyspace digest (the same-seed oracle) — the
  plane reads only the wall clock, never the sim timeline.
- **Bounded tables**: task names beyond the cap fold into "(other)"
  (and indexed spawns fold by family); message types likewise.
- **Priority-band rollup**: steps land in the highest named
  TaskPriority level at or below their popped priority.
- **SlowTask stacks**: a slow step's entry carries the coroutine
  suspension stack (code location, not just the task label).
- **Off-posture timing**: with every profiling consumer off
  (threshold 0, plane off) the loop skips per-step timing yet
  busy_seconds stays correct through coarse accounting.
- **Exporter round-trip**: the fdbtpu_task_* / fdbtpu_net_* /
  fdbtpu_sim_* families render and re-parse with exact values.
- **The regression gate**: tools/simprof.py --compare exits non-zero
  on an injected wall-time regression and zero otherwise.
"""

import time as _t

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow
from foundationdb_tpu_torch.flow.scheduler import (Scheduler, TaskPriority,
                                                   priority_band)
from foundationdb_tpu_torch.rpc import SimNetwork
from foundationdb_tpu_torch.server import SimCluster
from foundationdb_tpu_torch.server.chaos import SCENARIOS
from foundationdb_tpu_torch.server.workloads import ChaosStorm
from foundationdb_tpu_torch.tools.exporter import (parse_prometheus,
                                                   render_prometheus)
from foundationdb_tpu_torch.tools.simprof import (baseline_row, compare_reports)


def _run_chaos(armed: bool, seed: int) -> dict:
    kwargs = dict(SCENARIOS["partition_minority"].cluster_kwargs)
    c = SimCluster(seed=seed, **kwargs)
    if armed:
        c.sched.start_task_stats()
        c.net.arm_message_stats()
    try:
        dbs = [c.client(f"chaos{i}") for i in range(3)]
        storm = ChaosStorm(c, dbs, flow.g_random, "partition_minority")
        return c.run(storm.run(), timeout_time=900)
    finally:
        c.shutdown()


def test_armed_vs_off_same_seed_identical(sim_seed):
    """The acceptance oracle: arming the plane must not move a single
    sim event — same seed, identical fault schedule and keyspace
    digest, identical storm outcome."""
    seed = sim_seed(101)
    off = _run_chaos(armed=False, seed=seed)
    on = _run_chaos(armed=True, seed=seed)
    assert on["events"] == off["events"], (seed, off["events"][:3])
    assert on["digest"] == off["digest"], seed
    assert on["storm"]["issued"] == off["storm"]["issued"]
    assert on["storm"]["completed"] == off["storm"]["completed"]
    # ...and the armed run actually attributed the wall time
    sp = on["sim_perf"]
    assert sp["tasks_run"] > 0 and sp["wall_seconds"] > 0
    assert sp.get("top_tasks"), sp
    assert sp.get("top_messages"), sp
    assert sp.get("priority_bands"), sp
    # the off run carries the budget too, just without the tables
    assert off["sim_perf"]["tasks_run"] == sp["tasks_run"]
    assert "top_tasks" not in off["sim_perf"]


# -- bounded tables -------------------------------------------------------

def test_task_table_bounds_and_name_folding():
    flow.set_seed(5)
    s = Scheduler(virtual=True)
    s.start_task_stats(max_names=3)

    async def nop():
        return None

    # indexed spawns fold into one family...
    for i in range(4):
        s.spawn(nop(), name=f"txn-{i}")
    # ...distinct families beyond the cap share "(other)"
    for name in ("alpha", "beta", "gamma", "delta"):
        s.spawn(nop(), name=name)
    s.run()
    rep = s.stop_task_stats()
    table = {r["task"]: r for r in rep["tasks"]}
    assert table["txn-*"]["steps"] == 4, table
    assert "(other)" in table, table
    assert len(table) <= 4, table    # cap + the overflow bucket
    assert rep["dropped_names"] >= 1
    total = sum(r["steps"] for r in rep["tasks"])
    assert total == 8, rep           # every step attributed somewhere
    assert s.task_stats_armed is False


def test_message_table_bounds():
    flow.set_seed(6)
    s = Scheduler(virtual=True)
    net = SimNetwork(s, flow.g_random)
    net.arm_message_stats(max_types=2)
    for t in ("A", "A", "B", "C", "D"):
        net._count_msg(t)
    rep = net.message_stats_report()
    by = {r["type"]: r["count"] for r in rep["types"]}
    assert by == {"A": 2, "B": 1, "(other)": 2}, by
    assert rep["dropped_types"] == 2
    assert rep["armed"] == 1
    # population gauges are pull-computed from the scheduler heaps
    s.delay(1.0)
    assert net.message_stats_report()["timers_now"] == 1


# -- priority bands -------------------------------------------------------

def test_priority_band_rollup():
    assert priority_band(TaskPriority.STORAGE) == "storage"
    # between two named levels -> the level it outranks
    assert priority_band(TaskPriority.PROXY_COMMIT + 5) == "proxy_commit"
    assert priority_band(-7) == "zero"
    assert priority_band(TaskPriority.MAX + 1) == "max"

    flow.set_seed(7)
    s = Scheduler(virtual=True)
    s.start_task_stats()

    async def nop():
        return None

    s.spawn(nop(), priority=TaskPriority.STORAGE, name="st")
    s.spawn(nop(), priority=TaskPriority.PROXY_COMMIT, name="pc")
    s.spawn(nop(), priority=TaskPriority.PROXY_COMMIT + 3, name="pc2")
    s.run()
    bands = {b["band"]: b for b in s.task_stats_report()["bands"]}
    assert bands["storage"]["steps"] == 1, bands
    assert bands["proxy_commit"]["steps"] == 2, bands


# -- SlowTask suspension stacks -------------------------------------------

def test_slow_task_captures_suspension_stack():
    flow.set_seed(8)
    s = Scheduler(virtual=True)
    s.slow_task_threshold = 0.005
    flow.set_scheduler(s)
    try:
        async def hog():
            _t.sleep(0.012)          # the blocking anti-pattern
            await flow.delay(0.0)    # suspends here -> frame captured

        t = s.spawn(hog(), name="stackHog")
        s.run(until=t, timeout_time=10)
        assert s.slow_task_count >= 1
        entries = [e for e in s.slow_tasks if e[0] == "stackHog"]
        assert entries, s.slow_tasks
        _name, secs, stack = entries[0]
        assert secs >= 0.005
        assert "hog" in stack and ".py:" in stack, stack
        # the trace event carries it too
        evs = [e for e in flow.g_trace.events
               if e["Type"] == "SlowTask" and e["TaskName"] == "stackHog"]
        assert evs and "hog" in evs[-1]["Stack"], evs
    finally:
        flow.set_scheduler(None)


# -- off-posture timing ---------------------------------------------------

def test_all_consumers_off_skips_fine_timing_keeps_busy_seconds():
    """Threshold 0 + plane off: no slow-task sampling fires (it used
    to flag EVERY step at threshold 0), and busy_seconds still
    advances via the coarse window."""
    flow.set_seed(9)
    s = Scheduler(virtual=True)
    s.slow_task_threshold = 0.0

    async def spin():
        x = 0
        for _ in range(20_000):
            x += 1
        return x

    for i in range(50):
        s.spawn(spin(), name=f"spin{i}")
    s.run()
    assert s.slow_task_count == 0
    assert s.slow_tasks == []
    assert s.tasks_run == 50
    assert s.busy_seconds > 0.0        # coarse accounting flushed
    # arming mid-life flips back to fine timing + attribution
    s.start_task_stats()
    s.spawn(spin(), name="late")
    s.run()
    table = {r["task"] for r in s.task_stats_report()["tasks"]}
    assert "late" in table


# -- exporter round-trip --------------------------------------------------

def test_exporter_families_round_trip():
    status = {"cluster": {
        "run_loop": {
            "tasks_run": 10, "busy_seconds": 0.5, "sim_seconds": 2.0,
            "sim_per_busy": 4.0, "slow_task_count": 1,
            "slow_task_threshold": 0.05,
            "slow_tasks": [{"task": "hog", "seconds": 0.06,
                            "stack": "hog (x.py:12)"}],
            "task_stats": {
                "armed": 1,
                "tasks": [{"task": "commit", "steps": 5,
                           "busy_us": 123.5, "max_us": 50.0}],
                "bands": [{"band": "storage", "steps": 5,
                           "busy_us": 123.5}],
                "dropped_names": 2}},
        "network": {
            "armed": 1,
            "types": [{"type": "CommitRequest", "count": 3},
                      {"type": "CommitRequest.reply", "count": 3}],
            "dropped_types": 0, "messages_sent": 6,
            "messages_dropped": 1, "messages_duplicated": 0,
            "timers_now": 4, "ready_now": 2},
    }}
    samples = parse_prometheus(render_prometheus(status))
    val = {}
    for n, labels, v in samples:
        val[(n, tuple(sorted(labels.items())))] = v
    assert val[("fdbtpu_sim_seconds", ())] == 2.0
    assert val[("fdbtpu_sim_per_busy_second", ())] == 4.0
    assert val[("fdbtpu_task_steps", (("task", "commit"),))] == 5
    assert val[("fdbtpu_task_busy_us", (("task", "commit"),))] == 123.5
    assert val[("fdbtpu_task_max_step_us", (("task", "commit"),))] == 50.0
    assert val[("fdbtpu_task_band_steps", (("band", "storage"),))] == 5
    assert val[("fdbtpu_task_names_dropped", ())] == 2
    assert val[("fdbtpu_net_messages",
                (("type", "CommitRequest"),))] == 3
    assert val[("fdbtpu_net_messages",
                (("type", "CommitRequest.reply"),))] == 3
    assert val[("fdbtpu_net_messages_dropped", ())] == 1
    assert val[("fdbtpu_net_delivery_timers", ())] == 4
    assert val[("fdbtpu_net_ready_tasks", ())] == 2
    # the slow-task row carries its stack as a label
    assert val[("fdbtpu_run_loop_slow_task_seconds",
                (("stack", "hog (x.py:12)"), ("task", "hog")))] == 0.06


# -- the --compare regression gate ----------------------------------------

def test_compare_flags_injected_regression():
    base = {"open_loop": {"seed": 1, "sim_seconds": 3.0,
                          "wall_seconds": 1.0, "sim_per_wall": 3.0,
                          "tasks_run": 1000, "tasks_per_wall_sec": 1000.0,
                          "messages_sent": 500}}
    ok_run = {n: dict(r) for n, r in base.items()}
    regs, lines = compare_reports(ok_run, base, tolerance=2.0)
    assert not regs and any("[ok]" in ln for ln in lines)
    bad_run = {n: dict(r) for n, r in base.items()}
    bad_run["open_loop"]["wall_seconds"] = 3.5   # 3.5x > 2x tolerance
    regs, lines = compare_reports(bad_run, base, tolerance=2.0)
    assert regs and "open_loop" in regs[0], (regs, lines)
    assert any("REGRESSED" in ln for ln in lines)
    # a run on a DIFFERENT seed is a different workload shape: never
    # gated against this baseline, reported as skipped instead
    mismatch = {n: dict(r) for n, r in base.items()}
    mismatch["open_loop"]["seed"] = 2
    mismatch["open_loop"]["wall_seconds"] = 99.0
    regs, lines = compare_reports(mismatch, base, tolerance=2.0)
    assert not regs, regs
    assert any("not comparable" in ln for ln in lines), lines


def test_profile_folded_is_root_first():
    """Collapsed stacks must read root->leaf or flamegraphs merge by
    leaf and group unrelated call paths together."""
    flow.set_seed(10)
    s = Scheduler(virtual=True)
    flow.set_scheduler(s)
    try:
        async def inner_leaf():
            await flow.delay(0.001)

        async def outer_root():
            await inner_leaf()

        s.start_profiler(sample_every=1)
        t = s.spawn(outer_root(), name="root task")
        s.run(until=t, timeout_time=5)
        folded = s.profile_folded()
        line = next(ln for ln in folded.splitlines()
                    if "inner_leaf" in ln and "outer_root" in ln)
        frames = line.rsplit(" ", 1)[0].split(";")
        assert frames[0] == "roottask", frames   # task label, sanitized
        outer_i = next(i for i, f in enumerate(frames)
                       if "outer_root" in f)
        inner_i = next(i for i, f in enumerate(frames)
                       if "inner_leaf" in f)
        assert outer_i < inner_i, frames
    finally:
        flow.set_scheduler(None)


@pytest.mark.slow
def test_simprof_main_exit_codes(tmp_path):
    """The end-to-end gate: a real storm run compared against a
    doctored baseline — tiny baseline wall -> exit 1; huge -> exit 0."""
    import json

    from foundationdb_tpu_torch.tools import simprof

    def run_main(baseline_wall: float) -> int:
        bpath = tmp_path / f"base_{baseline_wall}.json"
        bpath.write_text(json.dumps({
            "round": "r01", "tolerance": 2.0,
            "storms": {"open_loop": {
                "seed": 6262, "sim_seconds": 2.0,
                "wall_seconds": baseline_wall, "sim_per_wall": 1.0,
                "tasks_run": 1, "tasks_per_wall_sec": 1.0,
                "messages_sent": 1}}}))
        return simprof.main([
            "--storm", "open_loop", "--duration", "1.0",
            "--compare", str(bpath),
            "--json", str(tmp_path / "r.json"),
            "--report", str(tmp_path / "r.txt"),
            "--folded", str(tmp_path / "r.folded")])

    assert run_main(baseline_wall=1e-6) == 1     # injected regression
    assert run_main(baseline_wall=1e6) == 0
    # the folded output is flamegraph-shaped: "frames... count"
    folded = (tmp_path / "r.folded").read_text().strip()
    assert folded, "no folded stacks"
    for line in folded.splitlines():
        frames, _, count = line.rpartition(" ")
        assert frames and count.isdigit(), line


def test_baseline_file_committed_and_comparable():
    """SIMPERF_r01.json: present, >= 3 named storms, rows carry the
    comparable slice baseline_row produces."""
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "..",
                        "SIMPERF_r01.json")
    with open(path) as fh:
        doc = json.load(fh)
    storms = doc["storms"]
    assert len(storms) >= 3, sorted(storms)
    for name, row in storms.items():
        for field in ("seed", "sim_seconds", "wall_seconds",
                      "sim_per_wall", "tasks_run",
                      "tasks_per_wall_sec"):
            assert field in row, (name, field)
        assert row["wall_seconds"] > 0, (name, row)
    fake = {n: dict(r) for n, r in storms.items()}
    regs, _lines = compare_reports(fake, storms,
                                   tolerance=float(doc["tolerance"]))
    assert not regs


def test_baseline_row_slices_report():
    rep = {"seed": 3, "sim_perf": {
        "sim_seconds": 1.0, "wall_seconds": 0.5, "sim_per_wall": 2.0,
        "tasks_run": 10, "tasks_per_wall_sec": 20.0,
        "messages_sent": 7, "top_tasks": [{"task": "x"}]}}
    row = baseline_row(rep)
    assert row == {"seed": 3, "sim_seconds": 1.0, "wall_seconds": 0.5,
                   "sim_per_wall": 2.0, "tasks_run": 10,
                   "tasks_per_wall_sec": 20.0, "messages_sent": 7}
