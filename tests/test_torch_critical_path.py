"""The reference's tests/test_critical_path.py on the port, with a case
of its own for `RolePathRecorder`, which the resolver role records into.

Latency-forensics pins.

The contracts: (1) the pure pieces behave — dominant-station tiebreak
follows path order, the decaying cause table forgets, the CPU-share
fold groups task rows by role, a ProcessMetrics sample always carries
the full field vocabulary; (2) the flight recorder is a bounded ring
that auto-dumps on SevError with a hard cap on unattended dumps;
(3) the default CRITICAL_PATH=0 posture adds NOTHING — disabled status
stanzas, no CC table, a disarmed recorder, and same-seed runs stay
bit-identical across digest/steps/messages; (4) armed, EVERY commit
batch decomposes into consecutive pipeline stations whose segments
telescope to the end-to-end latency within the pinned tolerance;
(5) an injected tlog fsync stall — via the knob or via a clogged tlog
NIC — is ATTRIBUTED: tlog_fsync dominates the per-commit counts and
the decayed cause table; (6) the cli `path`/`flightrec` views render;
(7) tools/tracemerge.py decomposes merged cross-process chains into
the same station vocabulary offline.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow
from foundationdb_tpu_torch.client import run_transaction
from foundationdb_tpu_torch.flow import trace as trace_mod
from foundationdb_tpu_torch.flow.flightrec import (AUTO_DUMP_SEVERITY,
                                                   MAX_AUTO_DUMPS,
                                                   FlightRecorder)
from foundationdb_tpu_torch.server import SimCluster
from foundationdb_tpu_torch.server.chaos import database_digest
from foundationdb_tpu_torch.server.critical_path import (STATIONS,
                                                         CriticalPathTable,
                                                         RolePathRecorder,
                                                         dominant_station)
from foundationdb_tpu_torch.server.process_metrics import (SAMPLE_FIELDS,
                                                           ProcessMetrics,
                                                           role_cpu_share)
from foundationdb_tpu_torch.tools import tracemerge
from foundationdb_tpu_torch.tools.cli import Cli


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


def test_role_cpu_share_folds_task_rows():
    rows = [{"task": "proxy.commit", "busy_us": 600},
            {"task": "proxy.grv", "busy_us": 150},
            {"task": "resolver-e3-1.batch", "busy_us": 200},
            {"task": "tlog.push", "busy_us": 50}]
    share = role_cpu_share(rows)
    assert share["proxy"] == 0.75
    assert share["resolver"] == 0.2
    assert share["tlog"] == 0.05
    assert list(share) == ["proxy", "resolver", "tlog"]  # heaviest first
    assert role_cpu_share([]) == {}
    assert role_cpu_share(None) == {}


def test_process_metrics_sample_shape():
    m = ProcessMetrics(role="tester")
    s1 = m.sample()
    for field in SAMPLE_FIELDS:
        assert field in s1, field
    assert s1["role"] == "tester" and s1["pid"] == os.getpid()
    assert s1["samples"] == 1
    m.observe_loop_lag(0.002)
    s2 = m.sample()
    assert s2["loop_lag_ms"] == 2.0
    assert s2["samples"] == 2
    assert s2["cpu_seconds"] >= s1["cpu_seconds"]


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


# -- sim: off posture ------------------------------------------------------

def _commit_workload(c, n=30, capture=None):
    db = c.client("cp")

    async def main():
        for i in range(n):
            async def w(tr, i=i):
                tr.set(b"cp/%04d" % i, b"%d" % i)
            await run_transaction(db, w)
        # past CRITICAL_PATH_INTERVAL so the CC fold loop (when armed)
        # drains the proxies' samples into the decaying cause table
        await flow.delay(5.0)
        if capture is not None:
            return await capture(db)
        return True

    return db, main


def test_off_posture_adds_nothing(sim_seed):
    """CRITICAL_PATH=0 (the default): disabled status stanzas, no CC
    table, a disarmed flight recorder, and two same-seed runs stay
    bit-identical — the plane's presence is unobservable until armed."""
    seed = sim_seed(1801)

    def run_off():
        c = SimCluster(seed=seed)
        try:
            async def capture(db):
                status = await db.get_status()
                digest = await database_digest(db)
                return status, digest

            _db, main = _commit_workload(c, n=12, capture=capture)
            status, digest = c.run(main(), timeout_time=600)
            cl = status["cluster"]
            assert cl["critical_path"] == {"enabled": 0}
            assert cl["process_metrics"] == {"enabled": 0}
            assert c.cc.critical_path_table is None
            assert flow.g_flightrec.armed is False
            for p in cl.get("proxies", ()):
                assert "path" not in p, p.keys()
            return digest, c.sched.tasks_run, c.net.messages_sent
        finally:
            c.shutdown()

    a, b = run_off(), run_off()
    assert a == b, "off-posture same-seed runs must stay bit-identical"


# -- sim: armed decomposition ----------------------------------------------

def _armed_status(seed, n=30, **cluster_kw):
    c = SimCluster(seed=seed, critical_path=True, **cluster_kw)
    try:
        async def capture(db):
            return await db.get_status()

        _db, main = _commit_workload(c, n=n, capture=capture)
        status = c.run(main(), timeout_time=600)
        return c, status
    finally:
        c.shutdown()


def test_armed_decomposition_telescopes(sim_seed):
    seed = sim_seed(1802)
    _c, status = _armed_status(seed)
    cl = status["cluster"]
    cp = cl["critical_path"]
    assert cp["enabled"] == 1
    assert cp["samples"] >= 30, cp
    assert cp["samples_folded"] > 0, cp
    # the invariant: per-txn station segments sum to the end-to-end
    # latency within the pinned tolerance (same clock reads on both
    # sides — the residual is exactly zero by construction)
    assert cp["max_residual_seconds"] <= cp["tolerance"], cp
    assert set(cp["station_seconds"]) == set(STATIONS)
    assert sum(cp["dominant"].values()) == cp["samples"], cp
    # per-proxy: station seconds telescope to the e2e band sum
    for p in cl["proxies"]:
        path = p["path"]
        station_sum = sum(ent["seconds"]
                          for ent in path["stations"].values())
        e2e_sum = path["end_to_end"]["sum_seconds"]
        assert abs(station_sum - e2e_sum) <= \
            cp["tolerance"] * max(1.0, e2e_sum), path
    # the role splits observed every commit: wait + service counted
    for role_key in ("resolve", "tlog_fsync"):
        split = cp["splits"][role_key]
        assert split["service"]["total"] > 0, (role_key, split)
        assert split["wait"]["total"] == split["service"]["total"]
    pm = cl["process_metrics"]
    assert pm["enabled"] == 1
    assert pm["host"].get("samples", 0) >= 1, pm
    for field in SAMPLE_FIELDS:
        assert field in pm["host"], field


def test_injected_fsync_stall_is_attributed(sim_seed):
    """TLOG_FSYNC_INJECTION stalls every fsync: the tlog durability
    hop must dominate per-commit, now, and in the decayed table, and
    the tlog's queue-vs-service split must carry the stall as SERVICE
    time (the disk was busy, not the queue)."""
    seed = sim_seed(1803)
    c = SimCluster(seed=seed, critical_path=True, durable=True)
    try:
        flow.SERVER_KNOBS.set("tlog_fsync_injection", 0.004)

        async def capture(db):
            return await db.get_status()

        _db, main = _commit_workload(c, n=30, capture=capture)
        status = c.run(main(), timeout_time=600)
    finally:
        c.shutdown()
    cp = status["cluster"]["critical_path"]
    assert cp["max_residual_seconds"] <= cp["tolerance"], cp
    share = cp["dominant"].get("tlog_fsync", 0) / max(1, cp["samples"])
    assert share >= 0.9, cp["dominant"]
    assert cp["dominant_now"] == "tlog_fsync", cp
    assert cp["top"][0]["station"] == "tlog_fsync", cp["top"]
    split = cp["splits"]["tlog_fsync"]
    assert split["service"]["sum_seconds"] > \
        split["wait"]["sum_seconds"], split


def test_clogged_tlog_nic_is_attributed(sim_seed):
    """The same verdict from a NETWORK cause: clogging the tlog
    machine's inbound side delays the proxy's log push, and the
    decomposition must still name tlog_fsync (the resolve-done ->
    push-acked hop) dominant — cause-agnostic attribution."""
    seed = sim_seed(1804)
    c = SimCluster(seed=seed, critical_path=True)
    try:
        db = c.client("cp")

        async def main():
            from foundationdb_tpu_torch.server import dbinfo as dbi
            while c.cc.dbinfo.get().recovery_state != \
                    dbi.FULLY_RECOVERED:
                await c.cc.dbinfo.on_change()
            machines = {lr.machine
                        for lr in c.cc.dbinfo.get().logs.logs}
            assert machines
            for i in range(24):
                for m in machines:
                    c.net.clog_recv(m, 0.03)

                async def w(tr, i=i):
                    tr.set(b"cp/%04d" % i, b"%d" % i)
                await run_transaction(db, w)
            await flow.delay(5.0)
            return await db.get_status()

        status = c.run(main(), timeout_time=600)
    finally:
        c.shutdown()
    cp = status["cluster"]["critical_path"]
    assert cp["samples"] >= 24, cp
    assert cp["max_residual_seconds"] <= cp["tolerance"], cp
    # roles can share machines in the default topology, so the clog
    # also taxes other hops — the pin is that tlog_fsync is still the
    # SINGLE largest attributed cause, live counts and decayed table
    dom = cp["dominant"]
    assert dom["tlog_fsync"] == max(dom.values()), dom
    assert dom["tlog_fsync"] / max(1, cp["samples"]) >= 0.5, dom
    assert cp["top"][0]["station"] == "tlog_fsync", cp["top"]


def test_armed_same_seed_is_deterministic(sim_seed):
    """The armed plane samples the SIM clock only: two same-seed armed
    runs must produce the identical critical-path document."""
    seed = sim_seed(1805)

    def fingerprint():
        c, status = _armed_status(seed, n=20)
        return (status["cluster"]["critical_path"],
                c.sched.tasks_run, c.net.messages_sent)

    assert fingerprint() == fingerprint()


# -- cli views -------------------------------------------------------------

def test_cli_path_and_flightrec_render(sim_seed, tmp_path):
    seed = sim_seed(1806)
    c = SimCluster(seed=seed, critical_path=True)
    cli = Cli.for_cluster(c)
    try:
        db = c.client("cp")

        async def warm():
            for i in range(15):
                async def w(tr, i=i):
                    tr.set(b"cp/%04d" % i, b"v")
                await run_transaction(db, w)
            await flow.delay(5.0)
            return True

        c.run(warm(), timeout_time=600)
        view = cli.execute("path")
        assert "Critical path" in view, view
        for s in STATIONS:
            assert s in view, (s, view)
        assert "commits decomposed" in view
        rec_view = cli.execute("flightrec")
        assert "armed" in rec_view, rec_view
        dump_view = cli.execute(f"flightrec dump {tmp_path}")
        assert "flightrec." in dump_view, dump_view
        dumped = [p for p in os.listdir(str(tmp_path))
                  if p.startswith("flightrec.")]
        assert len(dumped) == 1, dumped
    finally:
        c.shutdown()


def test_cli_path_renders_disabled_posture(sim_seed):
    c = SimCluster(seed=sim_seed(1807))
    cli = Cli.for_cluster(c)
    try:
        view = cli.execute("path")
        assert "critical-path decomposition off" in view, view
    finally:
        c.shutdown()


# -- tracemerge offline decomposition --------------------------------------

def _merged_doc(chain_spans):
    chains = []
    for i, spans in enumerate(chain_spans):
        rows = [dict(s) for s in spans]
        t0 = min(r["begin"] for r in rows)
        t1 = max(r["end"] for r in rows)
        chains.append({"debug_id": f"d{i}", "begin": t0,
                       "end_to_end_s": round(t1 - t0, 6),
                       "processes": sorted({r["process"]
                                            for r in rows}),
                       "cross_process": True, "spans": rows})
    return {"chains": chains}


def test_tracemerge_path_decomposition():
    def span(loc, proc, begin, end, depth):
        return {"location": loc, "process": proc, "span_id": 1,
                "begin": begin, "end": end, "depth": depth}

    merged = _merged_doc([[
        span("NativeAPI.commit", "client", 0.000, 0.100, 0),
        span("MasterProxyServer.commitBatch", "host", 0.010, 0.090, 1),
        span("Resolver.resolveBatch", "host", 0.020, 0.030, 2),
        span("TLog.tLogCommit", "host", 0.035, 0.085, 2),
    ]])
    doc = tracemerge.path_decomposition(merged)
    assert doc["chains"] == 1 and doc["decomposed"] == 1
    row = doc["rows"][0]
    segs = row["segments"]
    assert abs(segs["client_to_proxy"] - 0.010) < 1e-9
    assert abs(segs["proxy_batcher"] - 0.010) < 1e-9
    assert abs(segs["resolve"] - 0.010) < 1e-9
    assert abs(segs["log_push"] - 0.005) < 1e-9
    assert abs(segs["tlog_fsync"] - 0.050) < 1e-9
    assert abs(segs["reply"] - 0.015) < 1e-9
    # the telescoping invariant: segments sum to the client extent
    assert abs(sum(segs.values()) - row["end_to_end_s"]) <= 1e-6
    assert row["dominant"] == "tlog_fsync"
    assert row["residual_s"] == 0.0
    assert doc["dominant"] == {"tlog_fsync": 1}

    # residual clock skew pushing a boundary BACKWARDS zeroes that
    # station but keeps every segment non-negative and telescoping
    skewed = _merged_doc([[
        span("NativeAPI.commit", "client", 0.000, 0.100, 0),
        span("MasterProxyServer.commitBatch", "host", 0.050, 0.090, 1),
        span("Resolver.resolveBatch", "host", 0.030, 0.040, 2),
        span("TLog.tLogCommit", "host", 0.060, 0.080, 2),
    ]])
    doc2 = tracemerge.path_decomposition(skewed)
    segs2 = doc2["rows"][0]["segments"]
    assert segs2["proxy_batcher"] == 0.0   # resolver "began" earlier
    assert all(v >= 0.0 for v in segs2.values()), segs2
    assert abs(sum(segs2.values())
               - doc2["rows"][0]["end_to_end_s"]) <= 1e-6

    # a chain missing a leg is not a full commit chain: skipped
    partial = _merged_doc([[
        span("NativeAPI.commit", "client", 0.0, 0.1, 0),
        span("MasterProxyServer.commitBatch", "host", 0.01, 0.09, 1),
    ]])
    doc3 = tracemerge.path_decomposition(partial)
    assert doc3["chains"] == 0 and doc3["rows"] == []


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
