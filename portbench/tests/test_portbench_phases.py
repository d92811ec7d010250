"""The host-phase readers on synthetic inputs and, at a small size on the
port's CPU path, one measurement of each cell."""

import json
import subprocess
import sys

import pytest

from portbench import harness, phases
from test_portbench_harness import CELLS, small

ROOT = harness.ROOT


def totals(ns, wait_ns=None, live=(0, 0, 0, 0, 0), calls=1):
    """A `kernel_stats()["host"]` with the given phase ns and ns in
    waits, `calls` calls each."""
    wait_ns = wait_ns or {}
    return {"phases": {n: {"ns": v, "calls": calls,
                           "wait_ns": wait_ns.get(n, 0)}
                       for n, v in ns.items()},
            "waits": {},
            "grows": 0,
            "live": dict(zip(("live_rows_sum", "live_samples",
                              "live_rows_last", "live_rows_last_seq",
                              "capacity_rows_sum"), live))}


def test_layer_metrics_read_self_time_a_batch():
    zero = totals({n: 0 for n in ("submit", "check", "versions", "audit",
                                  "stage", "feed", "launch", "readback")},
                  calls=0)
    after = totals({"submit": 20_000_000, "check": 1_000_000,
                    "versions": 2_000_000, "audit": 3_000_000,
                    "stage": 4_000_000, "feed": 1_000_000,
                    "launch": 5_000_000, "readback": 4_000_000},
                   wait_ns={"submit": 3_000_000, "audit": 1_000_000,
                            "readback": 2_000_000},
                   live=(300, 3, 90, 7, 1200), calls=2)
    d = phases.host_delta(zero, after)
    assert d["live"]["live_rows_last"] == 90
    m = phases.layer_metrics(d, batches=2)
    assert m == {"host.prep_ms": 2.5, "host.stage_ms": 2.0,
                 "host.launch_ms": 3.0, "host.readback_ms": 1.0,
                 "host.wait_ms": 1.5, "step.live_share": 25.0}
    # the parts add up to the program's submit span
    assert sum(v for k, v in m.items() if k.startswith("host.")) == \
        d["phases"]["submit"]["ns"] / 2 / 1e6
    assert phases.layer_metrics(None, 2) == {}
    assert phases.layer_metrics(d, 0) == {}


def test_flatten_keeps_the_deepest_span():
    ring = [  # (seq, id, parent, name, start, end)
        (1, 1, 0, "check", 10, 20),
        (1, 2, 0, "audit", 20, 40),
        (1, 3, 2, "wait.count", 25, 30),
        (1, 4, 0, "launch", 40, 60),
        (1, 0, -1, "submit", 10, 60)]
    pieces = phases.flatten(phases.labeled(ring, [(5, 70)]))
    assert pieces == [(5, 10, "submit.self"), (10, 20, "check"),
                      (20, 25, "audit"), (25, 30, "wait.count"),
                      (30, 40, "audit"), (40, 60, "launch"),
                      (60, 70, "submit.self")]
    # two batches, a gap between them that no span covers
    ring2 = [(2, 6, 5, "stage", 80, 90), (2, 5, -1, "submit", 80, 90)]
    pieces = phases.flatten(phases.labeled(ring + ring2))
    assert pieces[-1] == (80, 90, "stage")
    assert pieces[-2] == (40, 60, "launch")


def test_idle_by_phase_on_a_synthetic_timeline():
    pieces = [(0, 100, "stage"), (100, 150, "wait.count"),
              (150, 200, "submit.self"), (300, 400, "launch")]
    busy = [(50, 120), (320, 330)]
    idle = phases.idle_by_phase(busy, pieces, (0, 500))
    ns = {k: round(v * 1e9) for k, v in idle.items()}
    assert ns == {"stage": 50, "wait.count": 30, "submit.self": 50,
                  "launch": 90, "outside": 100 + 100}
    assert sum(ns.values()) == 500 - 80


@pytest.mark.parametrize("cell", CELLS)
def test_measurement_on_cpu(cell):
    r = phases.measure(cell, 2 ** 31 + 11, 0.3, 0, 0.3, check=True,
                       device="cpu", overrides=small(cell))
    w = r["untraced"]
    assert set(w["metrics"]) == {"host.prep_ms", "host.stage_ms",
                                 "host.launch_ms", "host.readback_ms",
                                 "host.wait_ms", "step.live_share"}
    assert 0 < w["metrics"]["step.live_share"] <= 100
    # the parts tile the program's span, which lies inside the call
    assert w["parts_ms"] == pytest.approx(w["program_submit_ms"])
    assert w["program_submit_ms"] <= w["host.submit_ms"]
    ab = r["ab"]
    assert ab["on"]["batches"] > 0 and ab["off"]["batches"] > 0
    assert abs(ab["on"]["batches"] - ab["off"]["batches"]) <= 1
    assert ab["ratio"] > 0
    assert "traced" not in r
    # the program's exact live rows (its own layout) against the
    # reference's least history at the same batch: a row or two apart,
    # where one keeps a boundary the other merges
    c = r["check"]
    assert c["verdict_mismatches"] == 0
    assert abs(c["live_rows_last"] - c["reference_rows"]) <= max(
        2, c["reference_rows"] // 100), c


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_measurement_on_card(card, cell):
    """The entry point as a benchmark run uses it: its own process, so
    that each traced window is the process's only profiler session."""
    out = subprocess.run(
        [sys.executable, "-m", "portbench.phases", "--workload", cell,
         "--seed", str(2 ** 31 + 13), "--seconds", "2",
         "--trace-seconds", "1", "--ab-seconds", "0.5"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    t = r["traced"]
    assert t["batches"] > 0 and t["ring_spans"] > 0, t
    assert sum(t["idle_by_phase_s"].values()) == pytest.approx(
        t["idle_s"]), t
    assert 0 < t["idle_s"] < t["window_s"], t
    assert set(r["untraced"]["metrics"]) >= {"host.prep_ms",
                                             "step.live_share"}, r
