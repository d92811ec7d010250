"""The reference's storage-heat cases (tests/test_storage_heat.py) on the
port's `server.storage` and SimCluster, the armed plane's end-to-end
case (its last check renders the CLI's heat view) among them.

Storage heat plane: read-bandwidth sampling, read-hot
sub-range detection, per-storage tag busyness, the typed metrics wire
endpoints, the QoS/status/ratekeeper surfaces, and the storage-aware
auto-throttler input.

Ref: StorageMetrics.actor (bytesReadSample, getReadHotRanges density
math), fdbserver/TransactionTagCounter on the storage server, and the
ratekeeper reading tag busyness from storage queues.
"""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.client import run_transaction  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402
from foundationdb_tpu_torch.server.storage import StorageMetrics  # noqa: E402


@pytest.fixture
def knobs():
    flow.set_seed(3)
    yield flow.SERVER_KNOBS
    flow.reset_server_knobs()


# -- read sample + meters (unit) ---------------------------------------

def _heat_up(m, hot_reads=400, cold_reads=40, t0=0.0):
    """Uniform byte sample over 64 keys; reads concentrated on the
    first 4 keys, a trickle across the rest."""
    for i in range(64):
        m.note_set(b"k%03d" % i, 110)
    t = t0
    for r in range(hot_reads):
        m.note_read(b"k%03d" % (r % 4), 110, t)
        t += 0.002
    for r in range(cold_reads):
        m.note_read(b"k%03d" % (4 + r % 60), 110, t)
        t += 0.002
    return t


def test_read_hot_detection_flags_hot_bucket(knobs):
    m = StorageMetrics()
    now = _heat_up(m)
    rows = m.read_hot_ranges(b"", b"\xff", now)
    assert rows, "hot bucket never flagged"
    b, e, density, read_bps = rows[0]
    # the flagged range covers the hammered keys and the density
    # crossed the knob ratio
    assert b <= b"k000" and e > b"k003", rows[0]
    assert density >= flow.SERVER_KNOBS.read_hot_range_ratio
    assert read_bps > 0


def test_read_hot_detection_quiet_when_uniform(knobs):
    m = StorageMetrics()
    for i in range(64):
        m.note_set(b"k%03d" % i, 110)
    t = 0.0
    for r in range(640):
        m.note_read(b"k%03d" % (r % 64), 110, t)
        t += 0.002
    assert m.read_hot_ranges(b"", b"\xff", t) == []


def test_read_sample_deterministic_across_replicas(knobs):
    """Deterministic crc32 inclusion: two replicas fed the identical
    read stream at identical times report identical hot ranges and
    identical smoothed rates (the sim-replay/replica contract)."""
    a, b = StorageMetrics(), StorageMetrics()
    ta = _heat_up(a)
    tb = _heat_up(b)
    assert ta == tb
    assert a.read_hot_ranges(b"", b"\xff", ta) == \
        b.read_hot_ranges(b"", b"\xff", tb)
    assert a.read_bytes_per_sec(ta) == b.read_bytes_per_sec(tb)
    assert a.read_ops_per_sec(ta) == b.read_ops_per_sec(tb)


def test_read_meters_decay_and_reset(knobs):
    m = StorageMetrics()
    for t in range(10):
        m.note_read(b"k", 1000, float(t))     # ~1000 B/s, 1 op/s
    r = m.read_bytes_per_sec(10.0)
    assert 500 < r < 1500, r
    assert 0.5 < m.read_ops_per_sec(10.0) < 1.5
    assert m.read_bytes_per_sec(60.0) < 10    # decays when idle
    # reset_rate clears the READ side exactly like the write meter
    # (shrink_to: the departed range's traffic must stop counting)
    m.note_write(500, 10.0)
    m.reset_rate()
    assert m.read_bytes_per_sec(10.0) == 0.0
    assert m.read_ops_per_sec(10.0) == 0.0
    assert m.write_bytes_per_sec(10.0) == 0.0
    assert m._read_sample == {}


def test_read_sample_bounded_at_knob(knobs):
    flow.SERVER_KNOBS.set("read_sample_max_keys", 8)
    m = StorageMetrics()
    for i in range(100):
        m.note_read(b"r%04d" % i, 500, float(i) * 0.01)
    assert len(m._read_sample) <= 8


def test_read_accounting_off_the_serve_path_guard(knobs):
    """The plane's off posture: _serve_get/_serve_range never call
    note_read while STORAGE_HEAT_TRACKING is 0 (the guard is the whole
    per-read cost — PERF.md posture table)."""
    c = SimCluster(seed=1605, durable=True)
    try:
        db = c.client()

        async def main():
            async def seed(tr):
                tr.set(b"g", b"v")
            await run_transaction(db, seed)

            async def rd(tr):
                tr.set_option("transaction_tag", b"off")
                await tr.get(b"g")
                return await tr.get_range(b"a", b"z")
            await run_transaction(db, rd)
            return True

        assert c.run(main(), timeout_time=120)
        for obj in c.cc._storage_objs.values():
            assert obj.metrics._read_sample == {}
            assert obj.metrics.read_bytes_per_sec(flow.now()) == 0.0
            assert obj.tag_counter.top() == []
    finally:
        c.shutdown()


# -- end to end: tags, wire endpoints ------------------------------------

def test_metrics_wire_endpoints_round_trip():
    """The typed probes (StorageMetricsRequest / ReadHotRangesRequest /
    SplitMetricsRequest) served by the storage role."""
    from foundationdb_tpu_torch.server.types import (
        READ_HOT_RANGES_REQUEST, SPLIT_METRICS_REQUEST,
        STORAGE_METRICS_REQUEST)
    c = SimCluster(seed=1609, durable=True)
    flow.SERVER_KNOBS.set("storage_heat_tracking", 1)
    try:
        db = c.client()

        async def main():
            async def seed(tr):
                for i in range(32):
                    tr.set(b"w%03d" % i, b"V" * 100)
            await run_transaction(db, seed)

            async def rd(tr):
                tr.set_option("transaction_tag", b"probe")
                await tr.get(b"w000")
            await run_transaction(db, rd)
            obj = next(iter(c.cc._storage_objs.values()))
            ref = obj.metrics_requests.ref()
            m = await ref.get_reply(STORAGE_METRICS_REQUEST, db.process)
            hot = await ref.get_reply(READ_HOT_RANGES_REQUEST, db.process)
            split = await ref.get_reply(SPLIT_METRICS_REQUEST, db.process)
            return m, hot, split

        m, hot, split = c.run(main(), timeout_time=120)
        assert m.sampled_bytes > 0
        assert m.read_bytes_per_sec > 0
        assert m.read_ops_per_sec > 0
        assert m.busiest_read_tag == b"probe"
        assert m.busiest_read_tag_rate > 0
        assert isinstance(hot.ranges, tuple)
        assert split.split_key is not None and \
            b"w000" < split.split_key < b"w031"
    finally:
        flow.reset_server_knobs(randomize=False)
        c.shutdown()


def test_read_tags_ride_requests_only_when_armed():
    """Byte-identical off posture at the wire vocabulary: the read
    requests carry () tags while the plane is off, and the tag set
    only while armed."""
    from foundationdb_tpu_torch.server.types import StorageGetRequest
    assert StorageGetRequest(b"k", 1) == \
        StorageGetRequest(b"k", 1, None, ())
    c = SimCluster(seed=1611, durable=True)
    try:
        db = c.client()
        tr = db.create_transaction()
        tr.set_option("transaction_tag", b"t")
        assert tr._read_tags() == ()          # off: never attached
        flow.SERVER_KNOBS.set("storage_heat_tracking", 1)
        assert tr._read_tags() == (b"t",)     # armed: the tag set
    finally:
        flow.reset_server_knobs(randomize=False)
        c.shutdown()


# -- storage-aware auto-throttling -------------------------------------

def test_storage_busyness_prefers_per_ss_signal():
    """A read-heavy tenant: few transactions (cluster-wide rate far
    below TAG_THROTTLE_BUSY_RATE) each hammering one shard with many
    reads. With TAG_THROTTLE_STORAGE_BUSYNESS armed the auto-throttler
    must still write the tag's throttle row — the per-SS read-request
    rate is what crosses the line (ref: the ratekeeper reading tag
    busyness from storage servers)."""
    from foundationdb_tpu_torch.server import systemkeys as sk
    c = SimCluster(seed=1613, durable=True)
    for name, v in (("storage_heat_tracking", 1),
                    ("auto_tag_throttling", 1),
                    ("tag_throttle_storage_busyness", 1),
                    ("tag_throttle_update_interval", 0.25),
                    ("tag_throttle_busy_rate", 25.0),
                    ("tag_throttle_duration", 30.0)):
        flow.SERVER_KNOBS.set(name, v)
    try:
        db = c.client()

        async def main():
            async def seed(tr):
                for i in range(40):
                    tr.set(b"s%03d" % i, b"V" * 64)
            await run_transaction(db, seed)
            # ~3 txn/s for 3s, each doing 40 point reads: per-SS read
            # rate ~120/s >> 25, txn rate ~3/s << 25
            for r in range(9):
                async def body(tr):
                    tr.set_option("transaction_tag", b"scanner")
                    for i in range(40):
                        await tr.get(b"s%03d" % i)
                await run_transaction(db, body)
                await flow.delay(0.3)
            await flow.delay(1.0)

            async def rows(tr):
                tr.set_option("read_system_keys")
                return await tr.get_range(sk.THROTTLED_TAGS_PREFIX,
                                          sk.THROTTLED_TAGS_END)
            return await run_transaction(db, rows, max_retries=200)

        rows = c.run(main(), timeout_time=300)
        throttled = {}
        for key, value in rows:
            tag = sk.parse_throttled_tag_key(key)
            parsed = sk.parse_tag_throttle_value(value)
            if tag is not None and parsed is not None:
                throttled[tag] = parsed
        assert b"scanner" in throttled, sorted(throttled)
        assert throttled[b"scanner"][3] is True   # auto row
        from foundationdb_tpu_torch.flow import coverage
        assert coverage.hits("tag_throttler.storage_busyness") > 0
    finally:
        flow.reset_server_knobs(randomize=False)
        c.shutdown()


# -- HotShardStorm ------------------------------------------------------

def test_hot_shard_storm_schedule_deterministic():
    from foundationdb_tpu_torch.server.workloads import HotShardStorm
    flow.set_seed(515)
    a = HotShardStorm([], flow.g_random, duration=2.0).draw_schedule()
    flow.set_seed(515)
    b = HotShardStorm([], flow.g_random, duration=2.0).draw_schedule()
    assert a == b
    times, hot, keys = a
    assert len(times) == len(hot) == len(keys)
    assert any(hot) and not all(hot)
    # hot arrivals stay inside the declared hot range
    storm = HotShardStorm([], flow.g_random, duration=2.0)
    hb, he = storm.hot_range
    for i in range(len(times)):
        if hot[i]:
            assert hb <= keys[i] < he, (i, keys[i])


def test_hot_shard_storm_runs_and_names_heat():
    from foundationdb_tpu_torch.server.workloads import HotShardStorm
    c = SimCluster(seed=1615, durable=True)
    flow.SERVER_KNOBS.set("storage_heat_tracking", 1)
    flow.SERVER_KNOBS.set("qos_sample_interval", 0.25)
    try:
        dbs = [c.client(f"h{i}") for i in range(2)]

        async def main():
            storm = HotShardStorm(dbs, flow.g_random, duration=2.0,
                                  hot_rate=120.0, background_rate=30.0)
            await storm.seed(dbs[0])
            stats = await storm.run()
            await flow.delay(1.0)
            status = await dbs[0].get_status()
            return storm, stats, status

        storm, stats, status = c.run(main(), timeout_time=300)
        assert stats["issued"] > 50, stats
        assert stats["completed"] > 0, stats
        assert stats["hot_issued"] > stats["background_issued"], stats
        heat = status["cluster"]["storage_heat"]
        assert heat["ranges"], heat
        hb, he = storm.hot_range
        top = heat["ranges"][0]
        assert bytes.fromhex(top["begin"]) < he and \
            bytes.fromhex(top["end"]) > hb, (top, hb, he)
        assert all(r["tag"] == storm.hot_tag.hex()
                   for r in heat["busiest_read_tags"]), heat
    finally:
        flow.reset_server_knobs(randomize=False)
        c.shutdown()


def _drive_hot_reads(c, db, rounds=12):
    async def main():
        async def seed(tr):
            for i in range(48):
                tr.set(b"h%03d" % i, b"V" * 100)
        await run_transaction(db, seed)
        for r in range(rounds):
            async def body(tr, r=r):
                tr.set_option("transaction_tag", b"hotreader")
                # hammer the first two keys, graze the rest
                await tr.get(b"h000")
                await tr.get(b"h001")
                await tr.get(b"h%03d" % (2 + r % 46))
            await run_transaction(db, body)
            await flow.delay(0.15)
        await flow.delay(1.0)   # QoS sampler + heat rollup ticks
        return await db.get_status()
    return c.run(main(), timeout_time=300)


def test_armed_plane_end_to_end_status_qos_cli():
    c = SimCluster(seed=1607, durable=True)
    flow.SERVER_KNOBS.set("storage_heat_tracking", 1)
    flow.SERVER_KNOBS.set("qos_sample_interval", 0.25)
    try:
        db = c.client()
        status = _drive_hot_reads(c, db)
        cl = status["cluster"]

        # the per-storage tag counter charged the read tag
        obj = next(iter(c.cc._storage_objs.values()))
        tag, busy = obj.busiest_read_tag()
        assert tag == b"hotreader" and busy > 0

        # heat signals ride the storage QosSample — the ARMED schema
        # pin: exactly the base inventory plus the heat additions
        # (test_qos_telemetry.py pins the disarmed set)
        from test_qos_telemetry import (STORAGE_HEAT_SIGNALS,
                                        STORAGE_SIGNALS)
        sto = next(iter(cl["qos"]["roles"]["storage"].values()))
        assert set(sto) == STORAGE_SIGNALS | STORAGE_HEAT_SIGNALS | \
            {"sampled_at"}, sto
        assert sto["read_bytes_per_sec"] > 0, sto
        assert sto["busiest_read_tag_busyness"] > 0, sto

        # the cluster rollup names the hot tag; the replicas report
        # read meters in the storages section
        heat = cl["storage_heat"]
        assert heat["tracking_enabled"] == 1
        assert any(r["tag"] == b"hotreader".hex()
                   for r in heat["busiest_read_tags"]), heat
        rep = cl["storages"][0]["replicas"][0]
        assert rep["read_bytes_per_sec"] > 0, rep
        assert rep["read_ops_per_sec"] > 0, rep

        # ratekeeper observe-only input picked the tag up
        assert cl["qos"]["inputs"]["busiest_read_tag_busyness"] > 0
        assert cl["qos"]["busiest_read_tag"] == b"hotreader".hex()

        # cli heat renders the armed view
        from foundationdb_tpu_torch.tools.cli import _render_heat
        view = _render_heat(cl)
        assert "Storage heat (STORAGE_HEAT_TRACKING=on)" in view
        assert b"hotreader".hex() in view, view
    finally:
        flow.reset_server_knobs(randomize=False)
        c.shutdown()
