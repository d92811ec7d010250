"""The reference's read-heat cases of StorageMetrics
(tests/test_storage_heat.py, the ones without a cluster) on the
port's `server.storage`: read-bandwidth sampling, read-hot sub-range
detection, replica determinism, meter decay and the sample's bound.

Ref: StorageMetrics.actor (bytesReadSample, getReadHotRanges density
math).
"""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
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


# -- end to end: tags, wire endpoints, status, cli ----------------------

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


# -- storage-aware auto-throttling -------------------------------------


# -- HotShardStorm ------------------------------------------------------
