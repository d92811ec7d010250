"""The reference's inert critical-path and flight-recorder cases
(tests/test_critical_path.py) on the port: the dominant-station
tiebreak in path order, the decaying cause table, the bounded flight
recorder ring with its capped auto-dumps, and the recorder riding the
trace collector's emit. Its cluster cases wait for the port's
SimCluster; its process-metrics cases for `server/process_metrics.py`.
`RolePathRecorder`, which the resolver role records into, gets a case
of its own."""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.flow import trace as trace_mod  # noqa: E402
from foundationdb_tpu_torch.flow.flightrec import (  # noqa: E402
    AUTO_DUMP_SEVERITY, MAX_AUTO_DUMPS, FlightRecorder)
from foundationdb_tpu_torch.server.critical_path import (  # noqa: E402
    STATIONS, CriticalPathTable, RolePathRecorder, dominant_station)


# -- pure pieces -----------------------------------------------------------

def test_dominant_station_path_order_tiebreak():
    assert dominant_station({s: 0.0 for s in STATIONS}) == STATIONS[0]
    segs = {s: 0.001 for s in STATIONS}
    segs["tlog_fsync"] = 0.5
    assert dominant_station(segs) == "tlog_fsync"
    # an exact tie resolves to the EARLIER pipeline station — stable
    # attribution, never dict-order luck
    tie = {s: 0.0 for s in STATIONS}
    tie["commit_version"] = tie["reply"] = 0.25
    assert dominant_station(tie) == "commit_version"


def test_cause_table_decays_and_ranks():
    t = CriticalPathTable(half_life=10.0)
    t.record("tlog_fsync", 0.08, now=0.0)
    t.record("resolve", 0.01, now=0.0)
    top = t.top(now=0.0)
    assert top[0]["station"] == "tlog_fsync"
    assert top[0]["count"] == 1 and top[0]["seconds"] > 0
    # ten half-lives later the old cause has decayed ~1024x: fresh
    # evidence for another station takes rank 0
    t.record("resolve", 0.01, now=100.0)
    assert t.top(now=100.0)[0]["station"] == "resolve"


# -- flight recorder (pure, tmp_path) --------------------------------------

def test_flightrec_ring_is_bounded():
    rec = FlightRecorder()
    rec.arm(size=4)
    for i in range(10):
        rec.note({"Type": "Ev", "N": i})
    st = rec.status()
    assert st == {"armed": 1, "size": 4, "buffered": 4, "noted": 10,
                  "dumps": 0}
    assert [e["N"] for e in rec.snapshot()] == [6, 7, 8, 9]
    rec.disarm()
    assert rec.status()["armed"] == 0 and rec.status()["buffered"] == 0


def test_flightrec_dump_and_auto_dump_cap(tmp_path):
    rec = FlightRecorder()
    rec.arm(size=8, dump_dir=str(tmp_path), name="tester.1")
    rec.note({"Type": "Before", "Severity": 10})
    path = rec.dump(reason="manual")
    assert path and os.path.exists(path)
    rows = [json.loads(line) for line in open(path)]
    assert rows[0]["Type"] == "FlightRecorderDump"
    assert rows[0]["Reason"] == "manual" and rows[0]["Events"] == 1
    assert rows[1]["Type"] == "Before"
    # a SevError note auto-dumps, but only MAX_AUTO_DUMPS times — a
    # crash loop must not fill the disk
    for i in range(MAX_AUTO_DUMPS + 3):
        rec.note({"Type": "Boom", "Severity": AUTO_DUMP_SEVERITY,
                  "N": i})
    assert rec.status()["dumps"] == 1 + MAX_AUTO_DUMPS
    # every dump got a distinct numbered file
    assert len({os.path.basename(p) for p in rec.dumps}) == \
        1 + MAX_AUTO_DUMPS
    # dumping with nowhere to write is a no-op, never a crash
    bare = FlightRecorder()
    bare.arm(size=2)
    bare.note({"Type": "X"})
    assert bare.dump() is None


def test_flightrec_rides_trace_emit(tmp_path):
    """The live wiring: while armed, every TraceCollector.emit lands in
    the ring; a SevError event dumps it."""
    rec = flow.g_flightrec
    prev = (rec.armed, rec.dump_dir, rec.name)
    rec.arm(size=32, dump_dir=str(tmp_path), name="emit.test")
    try:
        trace_mod.TraceEvent("FlightRecPing", "a").detail(K=1).log()
        assert rec.status()["buffered"] >= 1
        trace_mod.TraceEvent("FlightRecBoom", "b",
                             severity=trace_mod.SevError).log()
        dumps = [p for p in os.listdir(str(tmp_path))
                 if p.startswith("flightrec.")]
        assert dumps, os.listdir(str(tmp_path))
        rows = [json.loads(line)
                for line in open(os.path.join(str(tmp_path), dumps[0]))]
        assert rows[0]["Reason"] == "sev_error"
        assert any(r.get("Type") == "FlightRecBoom" for r in rows)
    finally:
        rec.disarm()
        rec.dump_dir, rec.name = prev[1], prev[2]
        if prev[0]:
            rec.arm()


def test_role_path_recorder_matches_the_reference():
    """The queue-vs-service split the resolver role records: the same
    samples give the reference's snapshot, a negative wait clamped."""
    from foundationdb_tpu.server.critical_path import (
        RolePathRecorder as RefRecorder)
    rec, ref = RolePathRecorder("resolver"), RefRecorder("resolver")
    for wait_s, service_s in ((0.002, 0.005), (-1.0, 0.001),
                              (0.25, 0.0), (0.0, 1.5)):
        rec.record(wait_s, service_s)
        ref.record(wait_s, service_s)
    snap = rec.snapshot()
    assert set(snap) == {"wait", "service"}
    assert snap == ref.snapshot()
    token = object()
    rec.note_enter(token, 3.5)
    assert rec.take_enter(token, 0.0) == 3.5
    assert rec.take_enter(token, 7.0) == 7.0   # taken once
