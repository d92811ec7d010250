"""The reference's longitudinal cases (tests/test_longitudinal.py) on the
port's `server.timekeeper`, `server.slo`, `server.systemkeys` and
SimCluster: the codecs, the time map's lookups, the SLO rules, the off
posture, and the history read back through `layers.metrics` with its
janitor, the incident bundle (`tools/incident.py`), and the trace roll
read back by `tools/tracemerge.py`.

Longitudinal observability pins: (1) the TimeKeeper/metric-history
key+value codecs round-trip (including '/'-bearing signal names and
negative deltas) and skip foreign rows; (2) the time map's interpolated
lookups invert; (3) the default METRIC_HISTORY=0 posture adds NOTHING —
no recorder, no system rows, and same-seed runs stay bit-identical
across digest/steps/messages; (4) the SLO math is directed — multiwindow
burn rates trip only when fast AND slow windows burn, ceilings need a
sustained window, insufficient data never pages. The armed cluster's
recorded rows, the SLO verdict and the time map are held against the
reference in tests/test_torch_workload_parity.py.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.flow import trace as trace_mod  # noqa: E402
from foundationdb_tpu_torch.client import run_transaction  # noqa: E402
from foundationdb_tpu_torch.layers import metrics as metrics_layer  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402
from foundationdb_tpu_torch.server import slo as slo_mod  # noqa: E402
from foundationdb_tpu_torch.server import systemkeys as sk  # noqa: E402
from foundationdb_tpu_torch.server import timekeeper as tk  # noqa: E402
from foundationdb_tpu_torch.server.chaos import database_digest  # noqa: E402
from foundationdb_tpu_torch.tools import tracemerge  # noqa: E402


# -- codecs (pure) ---------------------------------------------------------

def test_timekeeper_key_roundtrip_and_order():
    k1 = sk.timekeeper_key(1_000)
    k2 = sk.timekeeper_key(2_000)
    assert sk.TIMEKEEPER_PREFIX < k1 < k2 < sk.TIMEKEEPER_END
    assert sk.parse_timekeeper_key(k1) == (sk.TIMEKEEPER_VERSION, 1_000)
    # the cutoff key IS the first key at that timestamp: clear_range
    # up to it removes strictly-older rows only
    assert sk.timekeeper_cutoff_key(2_000) == k2
    # foreign shapes parse to None, never raise
    assert sk.parse_timekeeper_key(b"\xff\x02/other/1") is None
    assert sk.parse_timekeeper_key(sk.TIMEKEEPER_PREFIX + b"junk") is None
    assert sk.parse_timekeeper_key(
        sk.TIMEKEEPER_PREFIX + b"1/zz/extra") is None


def test_metric_chunk_codec_roundtrip():
    # negative deltas both axes... no — time is monotone, VALUES dip
    # (a gauge falling, a counter re-baselining after restart)
    samples = [(1_000, 50), (2_000, 75), (3_500, 60), (3_600, 0)]
    enc = sk.encode_metric_chunk(samples)
    assert sk.decode_metric_chunk(enc) == samples
    assert sk.decode_metric_chunk(sk.encode_metric_chunk(
        [(7, -3)])) == [(7, -3)]
    # foreign / future-version rows decode to None (reader skips)
    assert sk.decode_metric_chunk(b"gibberish") is None
    assert sk.decode_metric_chunk(b"9|1|2|") is None
    # signals carry '/' — the key parse splits the ts off the RIGHT
    key = sk.metric_history_key("latency/commit/p99_ms", 42_000)
    assert sk.parse_metric_history_key(key) == \
        (sk.METRIC_HISTORY_VERSION, "latency/commit/p99_ms", 42_000)
    assert sk.parse_metric_history_key(b"\xff\x02/metrics/zz") is None
    assert key.startswith(
        sk.metric_history_signal_prefix("latency/commit/p99_ms"))


def test_timekeeper_pure_lookup_interpolates_and_extrapolates():
    tmap = [(10.0, 1_000_000), (20.0, 11_000_000)]
    # interior: linear between the rows
    assert tk.version_at_time_from_map(tmap, 15.0) == 6_000_000
    assert tk.time_at_version_from_map(tmap, 6_000_000) == 15.0
    # past the ends: nominal 1e6 versions/second slope
    assert tk.version_at_time_from_map(tmap, 22.0) == 13_000_000
    assert tk.version_at_time_from_map(tmap, 9.0) == 0  # clamped >= 0
    assert tk.time_at_version_from_map(tmap, 12_000_000) == 21.0
    assert tk.version_at_time_from_map([], 5.0) is None
    assert tk.time_at_version_from_map([], 5) is None


# -- SLO math (pure, directed) ---------------------------------------------

def _mk_burn(budget=0.01):
    return slo_mod.SloRule(
        "r", "burn_rate", "bad", total_signal="total", budget=budget,
        fast_window_s=10.0, slow_window_s=60.0, fast_rate=14.0,
        slow_rate=3.0)


def test_burn_rate_directed_math():
    now = 100_000
    total = [(40_000, 0), (90_000, 500), (100_000, 600)]
    # fast window: 20 bad / 100 total = 20x budget; slow: 30/600 = 5x
    bad = [(40_000, 0), (90_000, 10), (100_000, 30)]
    assert slo_mod.burn_rate(bad, total, now, 10.0, 0.01) == 20.0
    assert slo_mod.burn_rate(bad, total, now, 60.0, 0.01) == 5.0
    doc = slo_mod._eval_rule(_mk_burn(), {"bad": bad, "total": total},
                             now)
    assert doc["ok"] is False and doc["value"] == 20.0 \
        and doc["slow_value"] == 5.0

    # slow window still burning but the fast window cooled: NO page
    # (the multiwindow shape — a resolved incident stops alerting)
    bad2 = [(40_000, 0), (90_000, 28), (100_000, 30)]
    doc2 = slo_mod._eval_rule(_mk_burn(), {"bad": bad2, "total": total},
                              now)
    assert doc2["ok"] is True and doc2["value"] == 2.0

    # under two samples in a window -> no verdict, rule stays ok
    doc3 = slo_mod._eval_rule(
        _mk_burn(), {"bad": [(99_000, 5)], "total": total}, now)
    assert doc3["ok"] is True and doc3["value"] is None
    assert slo_mod.burn_rate([], total, now, 10.0, 0.01) is None


def test_ceiling_zero_and_recovery_rules():
    now = 100_000
    ceil = slo_mod.SloRule("p99", "ceiling", "g", threshold=250.0,
                           window_s=10.0)
    over = {"g": [(95_000, 300), (100_000, 310)]}
    blip = {"g": [(95_000, 300), (100_000, 200)]}
    one = {"g": [(100_000, 9_999)]}
    assert slo_mod._eval_rule(ceil, over, now)["ok"] is False
    assert slo_mod._eval_rule(ceil, blip, now)["ok"] is True
    # a single over-limit sample never pages a sustained ceiling
    assert slo_mod._eval_rule(ceil, one, now)["ok"] is True

    zero = slo_mod.SloRule("div", "zero", "m")
    assert slo_mod._eval_rule(zero, {"m": [(1, 0)]}, now)["ok"] is True
    assert slo_mod._eval_rule(zero, {"m": [(1, 2)]}, now)["ok"] is False
    assert slo_mod._eval_rule(zero, {}, now)["ok"] is True

    # recovery age: window_s=0 means instantaneous (the signal already
    # integrates time — one over-limit sample IS a sustained outage)
    rec = slo_mod.SloRule("rec", "ceiling", "age", threshold=5_000.0,
                          window_s=0.0)
    assert slo_mod._eval_rule(rec, {"age": [(now, 6_000)]},
                              now)["ok"] is False
    assert slo_mod._eval_rule(rec, {"age": [(now, 0)]},
                              now)["ok"] is True

    # empty series under the shipped rule table -> state ok
    v = slo_mod.evaluate(slo_mod.default_rules(), {}, now)
    assert v["state"] == "ok" and v["breached"] == []


# -- armed sim: record, translate, read back -------------------------------

def _armed_workload(c, horizon=13.0, capture=None):
    db = c.client("lg")

    async def main():
        for i in range(int(horizon / 0.25)):
            tr = db.create_transaction()
            tr.set(b"lg/%03d" % (i % 40), b"%d" % i)
            await tr.commit()
            await flow.delay(0.25)
        if capture is not None:
            return await capture(db)
        return True

    return db, main


def test_off_posture_adds_nothing(sim_seed):
    """METRIC_HISTORY=0 (the default): no recorder object, a disabled
    status stanza, ZERO rows in any longitudinal keyspace, and two
    same-seed runs stay bit-identical — the feature's presence is
    unobservable until armed."""
    seed = sim_seed(1703)

    def run_off():
        c = SimCluster(seed=seed)
        try:
            async def capture(db):
                async def body(tr):
                    tr.set_option("read_system_keys")
                    tk_rows = await tr.get_range(
                        sk.TIMEKEEPER_PREFIX, sk.TIMEKEEPER_END)
                    mh_rows = await tr.get_range(
                        sk.METRIC_HISTORY_PREFIX, sk.METRIC_HISTORY_END)
                    return tk_rows, mh_rows
                tk_rows, mh_rows = await run_transaction(db, body)
                status = await db.get_status()
                digest = await database_digest(db)
                return tk_rows, mh_rows, status, digest

            _db, main = _armed_workload(c, horizon=6.0, capture=capture)
            tk_rows, mh_rows, status, digest = c.run(main(),
                                                     timeout_time=600)
            assert c.cc.metric_recorder is None
            return (tk_rows, mh_rows, status["cluster"]["slo"], digest,
                    c.sched.tasks_run, c.net.messages_sent)
        finally:
            c.shutdown()

    a, b = run_off(), run_off()
    tk_rows, mh_rows, slo_doc, _digest, _steps, _msgs = a
    assert tk_rows == [] and mh_rows == []
    assert slo_doc == {"enabled": 0}
    assert a == b, "off-posture same-seed runs must stay bit-identical"


# -- retention: one janitor, three keyspaces -------------------------------


# -- incident bundles ------------------------------------------------------

def test_incident_bundle_contents(sim_seed, tmp_path):
    from foundationdb_tpu_torch.tools import incident
    seed = sim_seed(1706)
    out_dir = str(tmp_path / "bundle")
    c = SimCluster(seed=seed, metric_history=True)
    try:
        async def capture(db):
            t1 = flow.now()
            status = await db.get_status()
            verdict = {"state": "breach", "breached": ["commit_p99"]}
            return await incident.capture_bundle(
                db, out_dir, (t1 - 6.0, t1 - 1.0), status_doc=status,
                verdict=verdict, reason="test")

        _db, main = _armed_workload(c, capture=capture)
        manifest = c.run(main(), timeout_time=600)
    finally:
        c.shutdown()

    assert manifest["reason"] == "test"
    w = manifest["window"]
    assert w["version_at_t0"] is not None \
        and w["version_at_t0"] <= w["version_at_t1"]
    assert manifest["samples"] > 0 and manifest["signals"]
    assert manifest["timekeeper_rows"] > 0
    for name in ("manifest.json", "series.json", "timekeeper.json",
                 "status.json", "chaos.json"):
        assert name in manifest["contents"], manifest["contents"]
        assert os.path.exists(os.path.join(out_dir, name))
    series = json.load(open(os.path.join(out_dir, "series.json")))
    t0_ms, t1_ms = int(w["t0"] * 1000), int(w["t1"] * 1000)
    for sig, samples in series.items():
        for ts, _v in samples:
            assert t0_ms <= ts <= t1_ms + 1, (sig, ts, w)
    verdict = json.load(open(os.path.join(
        out_dir, "manifest.json")))["verdict"]
    assert verdict["breached"] == ["commit_p99"]



# -- trace rolling + grouped merge -----------------------------------------

def test_roll_restamps_identity_and_merge_reads_segments(tmp_path):
    path = str(tmp_path / "trace.roller.7.jsonl")
    trace_mod.set_process_identity("roller", pid=7)
    col = trace_mod.TraceCollector(path, roll_size=400)
    try:
        for i in range(30):
            col.emit({"Severity": 10, "Time": float(i), "Type": "Span",
                      "Process": "roller:7", "SpanID": i + 1,
                      "ParentID": None, "ID": f"d{i}",
                      "Location": "RolledWork", "Begin": float(i),
                      "End": i + 0.5})
        col.flush()
        assert col.rolled_files, "roll never triggered"
        # every rolled-fresh segment re-stamps the identity header so
        # each file is self-describing
        with open(path) as fh:
            first = json.loads(fh.readline())
        assert first["Type"] == "ProcessIdentity"
        assert first["ID"] == "roller:7"
    finally:
        col.close()
        trace_mod.clear_process_identity()

    # the whole segment family merges under ONE process, nothing falls
    # back to the local-process bucket
    merged = tracemerge.merge(str(tmp_path))
    assert merged["processes"] == ["roller:7"]
    assert len(merged["chains"]) == 30


def test_tracemerge_segment_numeric_order(tmp_path):
    """.10 sorts AFTER .2 (numeric, not lexicographic), the bare file
    is the newest segment, and an identity header in the OLDEST
    segment covers the whole group."""
    base = "trace.m.1.jsonl"
    names = [f"{base}.{i}" for i in (1, 2, 10)] + [base]
    for n, name in enumerate(names):
        rows = []
        if name.endswith(".1"):
            rows.append({"Type": "ProcessIdentity", "ID": "m:1"})
        rows.append({"Type": "Span", "Process": "m:1",
                     "SpanID": n + 1, "ParentID": None,
                     "ID": f"d{n}", "Location": f"Seg{n}",
                     "Begin": 10.0 + n, "End": 10.5 + n})
        with open(tmp_path / name, "w") as fh:
            for r in rows:
                fh.write(json.dumps(r) + "\n")

    groups = tracemerge.trace_file_groups(str(tmp_path))
    assert len(groups) == 1
    assert [os.path.basename(p) for p in groups[0]] == \
        [f"{base}.1", f"{base}.2", f"{base}.10", base]
    merged = tracemerge.merge(str(tmp_path))
    assert merged["processes"] == ["m:1"]
    assert tracemerge.LOCAL_PROCESS not in merged["processes"]
    assert len(merged["chains"]) == 4



# -- the history read back, and its janitor ---------------------------------

def test_armed_sim_records_and_translates(sim_seed):
    seed = sim_seed(1701)
    c = SimCluster(seed=seed, metric_history=True)
    try:
        async def capture(db):
            tmap = await tk.read_time_map(db)
            sigs = await metrics_layer.list_history_signals(db)
            committed = await metrics_layer.read_history(
                db, "cluster/txn_committed")
            status = await db.get_status()
            return tmap, sigs, committed, status

        db, main = _armed_workload(c, capture=capture)
        tmap, sigs, committed, status = c.run(main(), timeout_time=600)
    finally:
        c.shutdown()

    # the map landed and is monotone on both axes
    assert len(tmap) >= 3, tmap
    assert tmap == sorted(tmap)
    assert [v for _t, v in tmap] == sorted(v for _t, v in tmap)
    # interpolated lookup inverts: clock -> version -> clock
    mid = (tmap[0][0] + tmap[-1][0]) / 2
    v_mid = tk.version_at_time_from_map(tmap, mid)
    assert tmap[0][1] <= v_mid <= tmap[-1][1]
    assert abs(tk.time_at_version_from_map(tmap, v_mid) - mid) < 0.5

    # the recorder's vocabulary persisted and replays in order
    for need in ("cluster/txn_committed", "latency/commit/total",
                 "latency/commit/p99_ms", "cluster/shadow_mismatches",
                 "chaos/events"):
        assert need in sigs, sigs
    assert len(committed) >= 8, committed
    assert committed == sorted(committed)
    assert committed[-1][1] > 0   # the workload's commits are visible
    assert [v for _t, v in committed] == \
        sorted(v for _t, v in committed)

    slo_doc = status["cluster"]["slo"]
    assert slo_doc["enabled"] == 1
    assert slo_doc["state"] == "ok", slo_doc
    assert slo_doc["timekeeper_rows"] >= 3
    assert slo_doc["recorder"]["rows_written"] > 0
    assert {r["name"] for r in slo_doc["rules"]} >= \
        {"commit_p99", "no_divergence", "commit_error_budget"}


def _series_fingerprint(seed):
    c = SimCluster(seed=seed, metric_history=True)
    try:
        async def capture(db):
            sigs = await metrics_layer.list_history_signals(db)
            series = {}
            for s in sigs:
                series[s] = await metrics_layer.read_history(db, s)
            tmap = await tk.read_time_map(db)
            digest = await database_digest(db)
            return series, tmap, digest

        _db, main = _armed_workload(c, capture=capture)
        series, tmap, digest = c.run(main(), timeout_time=600)
        return {"series": series, "tmap": tmap, "digest": digest,
                "sched_steps": c.sched.tasks_run,
                "net_messages": c.net.messages_sent}
    finally:
        c.shutdown()


def test_same_seed_series_bit_identical(sim_seed):
    seed = sim_seed(1702)
    a, b = _series_fingerprint(seed), _series_fingerprint(seed)
    assert a == b, "armed same-seed runs must record identical series"
    assert a["series"]["cluster/txn_committed"], a["series"].keys()


def test_janitor_trims_all_three_keyspaces(sim_seed):
    seed = sim_seed(1704)
    c = SimCluster(seed=seed, metric_history=True)
    try:
        db = c.client("jt")

        async def main():
            # populate all three planes: history + timekeeper via the
            # armed CC loops, the legacy tuple space via log_counters
            col = flow.CounterCollection("proxy")
            for i in range(40):
                tr = db.create_transaction()
                tr.set(b"jt/%d" % (i % 8), b"v")
                await tr.commit()
                if i % 8 == 0:
                    col.counter("transactions_committed").add(1)
                    await metrics_layer.log_counters(db, [col])
                await flow.delay(0.3)
            before_h = await metrics_layer.read_history(
                db, "cluster/txn_committed")
            before_tk = await tk.read_time_map(db)
            before_leg = await metrics_layer.read_series(
                db, "proxy", "transactions_committed")
            assert before_h and before_tk and before_leg

            cutoff_ms = int(flow.now() * 1000) + 1
            h = await metrics_layer.trim_history(db, cutoff_ms)
            leg = await metrics_layer.trim_series(db, cutoff_ms)
            t = await tk.trim_timekeeper(db, flow.now() + 1)
            assert h > 0 and leg > 0 and t > 0, (h, leg, t)

            after_h = await metrics_layer.read_history(
                db, "cluster/txn_committed",
                end_ms=cutoff_ms)
            after_tk = await tk.read_time_map(db, end_ts=flow.now())
            after_leg = await metrics_layer.read_series(
                db, "proxy", "transactions_committed")
            # trims are chunk-granular for history (a straddling chunk
            # survives whole); timekeeper + legacy clear fully
            assert len(after_tk) == 0, after_tk
            assert after_leg == [], after_leg
            assert len(after_h) < len(before_h)
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


def test_metrics_janitor_loop_trims(sim_seed):
    seed = sim_seed(1705)
    c = SimCluster(seed=seed, metric_history=True)
    try:
        flow.SERVER_KNOBS.set("metric_retention_seconds", 3.0)
        flow.SERVER_KNOBS.set("timekeeper_retention", 3.0)
        flow.SERVER_KNOBS.set("metric_janitor_interval", 2.0)
        jan = metrics_layer.MetricsJanitor(c)
        jan.start()
        try:
            _db, main = _armed_workload(c, horizon=14.0)
            assert c.run(main(), timeout_time=600)
        finally:
            jan.stop()
        assert jan.rounds > 0
        assert jan.rows_trimmed > 0, "janitor never trimmed a row"
    finally:
        c.shutdown()
