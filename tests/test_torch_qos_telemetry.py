"""The reference's cases of tests/test_qos_telemetry.py on the port's
SimCluster, the CLI's qos view among them.

QoS & saturation telemetry plane: the promoted Smoother (tau
behavior + the non-increasing-clock clamp), per-role QosSample signals
in status.cluster.qos, tag & priority traffic accounting, Ratekeeper
RkUpdate decision traces with limiting reasons, the open-loop storm
workload, and the zero-overhead-off posture.

Ref: fdbrpc/Smoother.h, Ratekeeper.actor.cpp updateRate (RkUpdate +
limitReason_t), fdbserver/TransactionTagCounter.
"""

import math

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.client import run_transaction  # noqa: E402
from foundationdb_tpu_torch.flow.smoother import (SmoothedQueue, SmoothedRate,  # noqa: E402
                                            Smoother)
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402
from foundationdb_tpu_torch.server.ratekeeper import LIMIT_REASONS  # noqa: E402

# the signal inventory each role kind publishes (README QoS telemetry
# section documents the same table — this test is the schema pin)
STORAGE_SIGNALS = {"queue_bytes", "durability_lag_versions",
                   "read_rate", "mutation_rate", "write_bandwidth"}
# armed-only storage heat additions: present exactly while
# STORAGE_HEAT_TRACKING is on — the armed-schema pin lives in
# tests/test_storage_heat.py (test_armed_plane_end_to_end_status_qos_cli
# asserts the armed set equals STORAGE_SIGNALS | STORAGE_HEAT_SIGNALS)
STORAGE_HEAT_SIGNALS = {"read_bytes_per_sec", "read_ops_per_sec",
                        "read_hot_ranges", "busiest_read_tag_busyness"}
TLOG_SIGNALS = {"queue_bytes", "queue_entries",
                "fsync_backlog_versions", "commit_rate"}
PROXY_SIGNALS = {"grv_queue_depth", "commit_batch_occupancy",
                 "resolve_in_flight", "grv_rate", "commit_rate",
                 "tps_budget"}
RESOLVER_SIGNALS = {"pipeline_occupancy", "pipeline_in_flight",
                    "pipeline_depth", "forced_drain_rate", "batch_rate",
                    "txn_rate", "state_rows"}
RK_INPUTS = {"worst_storage_queue_bytes", "worst_tlog_queue_bytes",
             "worst_durability_lag_versions", "pipeline_occupancy",
             "pipeline_forced_drain_rate", "sched_deferred_depth",
             "worst_read_hot", "busiest_read_tag_busyness",
             "dead_replicas"}


# -- Smoother (satellite: promotion + clamp) ---------------------------

def test_smoother_tau_decay_directed():
    """exp decay toward the newest sample: after exactly one tau the
    old value retains weight e^-1; tau<=0 snaps."""
    s = Smoother()
    assert s.sample(1000.0, 0.0, 1.0) == 1000.0
    v = s.sample(0.0, 1.0, 1.0)
    assert abs(v - 1000.0 * math.exp(-1)) < 1e-9
    # larger tau decays slower at the same dt
    s2 = Smoother()
    s2.sample(1000.0, 0.0, 10.0)
    assert s2.sample(0.0, 1.0, 10.0) > v
    # tau 0: no smoothing, the sample IS the value
    s3 = Smoother()
    s3.sample(5.0, 0.0, 0.0)
    assert s3.sample(7.0, 0.0, 0.0) == 7.0


def test_smoother_clamps_non_increasing_clock():
    """A non-increasing `now` (sim clock replay / duplicate tick) must
    clamp dt to 0 — the value holds still instead of amplifying through
    a positive exponent (the unguarded delta bug this PR fixes)."""
    s = Smoother()
    s.sample(1000.0, 10.0, 1.0)
    held = s.sample(0.0, 10.0, 1.0)       # duplicate tick: dt == 0
    assert held == 1000.0
    back = s.sample(0.0, 5.0, 1.0)        # clock went BACKWARDS
    assert back == 1000.0                 # not 1000 * e^+5 ~ 148k
    # the smoother keeps working once time advances again
    fwd = s.sample(0.0, 6.0, 1.0)
    assert abs(fwd - 1000.0 * math.exp(-1)) < 1e-9


def test_smoothed_rate_from_totals():
    r = SmoothedRate(tau=0.0)    # tau 0: instantaneous rate
    r.sample_total(0, 0.0)
    assert r.sample_total(100, 1.0) == 100.0
    assert r.sample_total(150, 1.5) == 100.0
    # a counter reset (role restart) re-baselines, never goes negative
    assert r.sample_total(10, 2.0) == 100.0   # held, not -280/s
    assert r.sample_total(60, 2.5) == 100.0   # 100/s again from fresh base
    # a non-advancing clock holds the rate too
    assert r.sample_total(1000, 2.5) == 100.0


def test_smoothed_queue_uses_knob_tau():
    q = SmoothedQueue()
    flow.SERVER_KNOBS.set("qos_smoothing_tau", 1.0)
    try:
        q.sample(1000.0, 0.0)
        v = q.sample(0.0, 1.0)
        assert abs(v - 1000.0 * math.exp(-1)) < 1e-9
        # live knob change applies to the existing smoother
        flow.SERVER_KNOBS.set("qos_smoothing_tau", 0.0)
        assert q.sample(7.0, 1.0) == 7.0
    finally:
        flow.reset_server_knobs(randomize=False)


def test_ratekeeper_reexports_smoother():
    """Back-compat: the Smoother is historically ratekeeper vocabulary."""
    from foundationdb_tpu_torch.server import ratekeeper
    assert ratekeeper.Smoother is Smoother


# -- status.cluster.qos schema ----------------------------------------

def _run_workload_and_status(c, n_txns=8):
    db = c.client()

    async def main():
        # spread the traffic across several QoS sample intervals so the
        # smoothed RATE signals see live deltas, not a finished burst
        for i in range(n_txns):
            async def body(tr, i=i):
                await tr.get(b"q%d" % (i % 3))
                tr.set(b"q%d" % (i % 3), b"v%d" % i)
            await run_transaction(db, body)
            await flow.delay(0.2)
        return await db.get_status()
    return c.run(main(), timeout_time=120)


def test_qos_status_schema_pins_signals_and_reason():
    c = SimCluster(seed=701, durable=True)
    flow.SERVER_KNOBS.set("qos_sample_interval", 0.25)
    try:
        status = _run_workload_and_status(c)
        qos = status["cluster"]["qos"]
        assert qos["transactions_per_second_limit"] is not None
        assert qos["batch_transactions_per_second_limit"] is not None
        assert qos["limiting_reason"] in LIMIT_REASONS
        assert set(qos["inputs"]) == RK_INPUTS
        roles = qos["roles"]
        for kind, want in (("storage", STORAGE_SIGNALS),
                           ("tlog", TLOG_SIGNALS),
                           ("proxy", PROXY_SIGNALS),
                           ("resolver", RESOLVER_SIGNALS)):
            assert roles.get(kind), (kind, roles.keys())
            for name, signals in roles[kind].items():
                assert set(signals) == want | {"sampled_at"}, \
                    (kind, name, signals)
        # the workload actually moved the signals
        sto = next(iter(roles["storage"].values()))
        assert sto["mutation_rate"] >= 0
        res = next(iter(roles["resolver"].values()))
        assert res["batch_rate"] > 0, res
        # priorities always present (zeros included) for dashboards
        assert set(qos["priorities"]) == {"batch", "default", "immediate"}
        assert qos["priorities"]["default"]["committed"] > 0
    finally:
        flow.reset_server_knobs(randomize=False)
        c.shutdown()


def test_qos_plane_off_is_empty_and_costless():
    """QOS_SAMPLE_INTERVAL=0 empties the plane; QOS_TAG_ACCOUNTING=0
    keeps tagged traffic out of the table — the knobs-off posture the
    PERF.md note pins."""
    c = SimCluster(seed=703, durable=True)
    flow.SERVER_KNOBS.set("qos_sample_interval", 0)
    flow.SERVER_KNOBS.set("qos_tag_accounting", 0)
    try:
        db = c.client()

        async def main():
            async def body(tr):
                tr.set_option("transaction_tag", b"offtag")
                tr.set(b"k", b"v")
            await run_transaction(db, body)
            await flow.delay(2.0)
            return await db.get_status()

        qos = c.run(main(), timeout_time=120)["cluster"]["qos"]
        assert qos["roles"] == {}, qos["roles"]
        assert qos["tags"] == [], qos["tags"]
        # the rate surface itself stays (it predates the plane)
        assert qos["transactions_per_second_limit"] is not None
        # and no per-priority counters accumulated on any proxy
        assert all(v["started"] == 0
                   for v in qos["priorities"].values()), qos["priorities"]
    finally:
        flow.reset_server_knobs(randomize=False)
        c.shutdown()


# -- tag & priority accounting ----------------------------------------

def test_tag_and_priority_accounting_in_status():
    c = SimCluster(seed=705, durable=True)
    try:
        db = c.client()

        async def main():
            # tagged committed traffic at two priorities
            for i in range(4):
                async def body(tr, i=i):
                    tr.set_option("transaction_tag", b"web")
                    if i % 2:
                        tr.set_option("priority_batch")
                    tr.set(b"t%d" % i, b"v")
                await run_transaction(db, body)
            # one tagged CONFLICTED transaction (not retried)
            tr = db.create_transaction()
            tr.set_option("transaction_tag", b"web")
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
            await flow.delay(1.5)
            return await db.get_status()

        qos = c.run(main(), timeout_time=120)["cluster"]["qos"]
        rows = {r["tag"]: r for r in qos["tags"]}
        web = rows[b"web".hex()]
        assert web["started"] == 5, web
        assert web["committed"] == 4, web
        assert web["conflicted"] == 1, web
        assert web["busyness"] > 0, web
        prios = qos["priorities"]
        assert prios["batch"]["committed"] == 2, prios
        assert prios["default"]["committed"] >= 3, prios   # incl. bumps
        assert prios["default"]["conflicted"] >= 1, prios
        assert prios["batch"]["started"] >= 2, prios
    finally:
        c.shutdown()


def test_tag_counter_bounds_and_decay():
    from foundationdb_tpu_torch.server.proxy import TransactionTagCounter
    tc = TransactionTagCounter(half_life=1.0, max_entries=3)
    c = SimCluster(seed=707)   # a scheduler for flow.now()
    try:
        async def main():
            for i in range(6):
                tc.record(b"t%d" % i, "started", flow.now())
            assert len(tc._entries) == 3   # bounded: coldest evicted
            tc.record(b"hot", "started", flow.now(), weight=100.0)
            top = tc.top(1)
            assert top[0]["tag"] == b"hot".hex()
            score0 = top[0]["busyness"]
            await flow.delay(2.0)          # two half-lives
            score1 = tc.top(1)[0]["busyness"]
            assert score1 == pytest.approx(score0 / 4, rel=0.05)
            return True
        assert c.run(main(), timeout_time=60)
    finally:
        c.shutdown()


def test_transaction_tag_option_validation():
    c = SimCluster(seed=709)
    try:
        db = c.client()
        tr = db.create_transaction()
        with pytest.raises(flow.FdbError) as ei:
            tr.set_option("transaction_tag",
                          b"x" * (int(flow.SERVER_KNOBS
                                      .max_transaction_tag_length) + 1))
        assert ei.value.name == "tag_too_long"
        for i in range(int(flow.SERVER_KNOBS.max_tags_per_transaction)):
            tr.set_option("transaction_tag", b"t%d" % i)
        tr.set_option("transaction_tag", b"t0")   # duplicate: collapses
        with pytest.raises(flow.FdbError) as ei:
            tr.set_option("transaction_tag", b"one-too-many")
        assert ei.value.name == "too_many_tags"
        with pytest.raises(flow.FdbError):
            tr.set_option("transaction_tag", b"")
        # str form is accepted and encoded
        tr2 = db.create_transaction()
        tr2.set_option("transaction_tag", "strtag")
        assert tr2._tags == (b"strtag",)
    finally:
        c.shutdown()


# -- ratekeeper decision tracing --------------------------------------

def test_rk_update_traces_with_limiting_reason():
    """A storage queue held over a tiny target: RkUpdate events carry
    the computed rate, every input signal, and limiting_reason
    storage_queue; status.cluster.qos mirrors the decision."""
    c = SimCluster(seed=711, durable=True)
    flow.SERVER_KNOBS.set("rk_target_storage_queue_bytes", 500)
    flow.SERVER_KNOBS.set("rk_spring_storage_queue_bytes", 100)
    try:
        db = c.client()

        async def main():
            for i in range(12):
                async def body(tr, i=i):
                    tr.set(b"rk%02d" % i, b"v" * 100)
                await run_transaction(db, body)
            await flow.delay(1.5)    # several RK update intervals
            return await db.get_status()

        status = c.run(main(), timeout_time=120)
        ups = [e for e in flow.g_trace.events
               if e.get("Type") == "RkUpdate"]
        assert ups, "no RkUpdate traces"
        for e in ups:
            assert "TPSLimit" in e and "BatchTPSLimit" in e, e
            assert e["LimitingReason"] in LIMIT_REASONS, e
            # every input signal rides the trace, CamelCased
            for f in ("WorstStorageQueueBytes", "WorstTlogQueueBytes",
                      "WorstDurabilityLagVersions", "PipelineOccupancy",
                      "PipelineForcedDrainRate", "DeadReplicas"):
                assert f in e, (f, e)
        limited = [e for e in ups if e["LimitingReason"] == "storage_queue"]
        assert limited, [e["LimitingReason"] for e in ups]
        assert limited[-1]["TPSLimit"] < flow.SERVER_KNOBS.rk_max_rate
        qos = status["cluster"]["qos"]
        assert qos["limiting_reason"] == "storage_queue", qos
        assert qos["inputs"]["worst_storage_queue_bytes"] > 500, qos
        assert qos["transactions_per_second_limit"] < \
            flow.SERVER_KNOBS.rk_max_rate
    finally:
        flow.reset_server_knobs(randomize=False)
        c.shutdown()


def test_rk_dead_replica_reports_durability_lag():
    c = SimCluster(seed=713, durable=True, auto_reboot=False)
    try:
        db = c.client()

        async def main():
            async def body(tr):
                tr.set(b"x", b"1")
            await run_transaction(db, body)
            c.kill_role("storage")
            await flow.delay(0.5)
            return await db.get_status()

        qos = c.run(main(), timeout_time=120)["cluster"]["qos"]
        assert qos["limiting_reason"] == "durability_lag", qos
        assert qos["inputs"]["dead_replicas"] >= 1, qos
        assert qos["transactions_per_second_limit"] == \
            flow.SERVER_KNOBS.rk_min_rate
    finally:
        c.shutdown()


# -- open-loop storm workload -----------------------------------------

def test_open_loop_storm_runs_and_measures():
    from foundationdb_tpu_torch.server.workloads import OpenLoopStorm
    c = SimCluster(seed=715, durable=True)
    try:
        dbs = [c.client(f"s{i}") for i in range(3)]

        async def main():
            storm = OpenLoopStorm(dbs, flow.g_random, duration=1.5,
                                  rate=60.0, burst_rate=200.0,
                                  burst_start=0.5, burst_len=0.5,
                                  keyspace=16, max_inflight=64)
            return await storm.run()

        stats = c.run(main(), timeout_time=300)
        assert stats["issued"] > 30, stats
        done = (stats["completed"] + stats["conflicted"]
                + sum(stats["errors"].values()))
        assert done + stats["shed"] == stats["issued"], stats
        assert stats["completed"] > 0, stats
        assert stats["grv"]["count"] > 0
        assert stats["grv"]["p99"] >= stats["grv"]["p50"] >= 0
        assert stats["commit"]["p99"] >= 0
    finally:
        c.shutdown()


def test_storm_sheds_at_inflight_cap():
    """max_inflight bounds the open-loop backlog: arrivals past the cap
    are counted as shed, not silently dropped or unboundedly queued."""
    from foundationdb_tpu_torch.server.workloads import OpenLoopStorm
    c = SimCluster(seed=717, durable=True)
    try:
        dbs = [c.client("shed0")]

        async def main():
            storm = OpenLoopStorm(dbs, flow.g_random, duration=1.0,
                                  rate=2000.0, burst_rate=2000.0,
                                  burst_start=0.0, burst_len=1.0,
                                  keyspace=4, max_inflight=8)
            return await storm.run()

        stats = c.run(main(), timeout_time=300)
        assert stats["shed"] > 0, stats
    finally:
        c.shutdown()


# -- operator surfaces -------------------------------------------------


def test_rk_batch_only_throttle_reports_its_reason():
    """Storage queue inside the BATCH spring zone but below the normal
    one: BatchTPSLimit drops while TPSLimit stays at max_rate — the
    decision must report storage_queue, not none (a batch-only
    throttle is still a throttle; "none" here would be a
    misleading posture)."""
    from foundationdb_tpu_torch.server.ratekeeper import Ratekeeper

    class _Gauge:
        def __init__(self, v):
            self._v = v

        def get(self):
            return self._v

    class _Obj:
        pass

    mut = _Obj()                      # 984 + 0 + 16 = 1000 queue bytes
    mut.param1, mut.param2 = b"x" * 984, b""
    sto = _Obj()
    sto.process = _Obj()
    sto.process.alive = True
    sto.kv = object()
    sto.version = _Gauge(0)
    sto.durable_version = _Gauge(0)
    sto._lag = 0
    sto._pending = [(0, [mut])]

    rep = _Obj()
    rep.name = "s0"
    shard = _Obj()
    shard.replicas = [rep]
    info = _Obj()
    info.storages = [shard]
    info.epoch = 1

    cc = _Obj()
    cc.dbinfo = _Gauge(info)
    cc._storage_objs = {"s0": sto}
    cc.tlog_objs = lambda: []
    cc.workers = {}

    flow.set_seed(0)
    s = flow.Scheduler()
    flow.set_scheduler(s)
    flow.reset_server_knobs(randomize=False)
    k = flow.SERVER_KNOBS
    k.set("rk_target_storage_queue_bytes", 2000)
    k.set("rk_spring_storage_queue_bytes", 100)
    k.set("rk_batch_target_fraction", 0.5)   # batch zone ends at 1000
    try:
        proc = _Obj()
        proc.name = "rk-test"
        proc.register = lambda stream: object()   # RequestStream endpoint
        rk = Ratekeeper(proc, cc)
        tps, batch_tps = rk._compute_rates()
        assert tps >= k.rk_max_rate, tps            # normal: unthrottled
        assert batch_tps <= k.rk_min_rate, batch_tps    # batch: floored
        d = rk.last_decision
        assert d["limiting_reason"] == "storage_queue", d
        assert d["inputs"]["worst_storage_queue_bytes"] == 1000.0, d
    finally:
        flow.reset_server_knobs(randomize=False)
        flow.set_scheduler(None)


def test_cli_qos_view_and_status_details_ratekeeper():
    from foundationdb_tpu_torch.tools.cli import Cli
    c = SimCluster(seed=719, durable=True)
    try:
        cli = Cli.for_cluster(c)
        db = c.client()

        async def main():
            async def body(tr):
                tr.set_option("transaction_tag", b"cli")
                tr.set(b"k", b"v")
            await run_transaction(db, body)
            await flow.delay(1.5)
            return True

        assert c.run(main(), timeout_time=120)
        view = cli.execute("qos")
        for section in ("Ratekeeper:", "limited_by=", "Decision inputs:",
                        "Storage signals:", "Tlog signals:",
                        "Proxy signals:", "Resolver signals:",
                        "Tag traffic", b"cli".hex(),
                        "Priority classes:"):
            assert str(section) in view, (section, view)
        details = cli.execute("status details")
        assert "Ratekeeper:" in details
        assert "limited_by=" in details
        assert "tps_limit=" in details
    finally:
        c.shutdown()
