"""The reference's StorageMetrics cases (tests/test_storage_metrics.py) on
the port's `server.storage`, its two split cases on the port's
SimCluster.

Byte-sample storage metrics + bandwidth-driven shard splits.

Ref: storageserver.actor.cpp:310-312 (byteSample — probabilistic size
sampling), StorageMetrics.actor.h:302 (splitMetrics byte-balanced
split points), Knobs.cpp SHARD_MAX_BYTES / SHARD_MAX_BYTES_PER_KSEC
(size- and bandwidth-triggered splits).
DD decisions must run on sampled bytes, not row counts.
"""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.client import run_transaction  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402
from foundationdb_tpu_torch.server.storage import StorageMetrics  # noqa: E402


@pytest.fixture
def knobs():
    flow.set_seed(2)
    yield flow.SERVER_KNOBS
    flow.reset_server_knobs()


def test_sample_is_unbiased_estimator(knobs):
    """Sampled totals track true totals within a sane tolerance at
    both dense (big values) and sparse (tiny values) extremes."""
    m = StorageMetrics()
    true = 0
    for i in range(2000):
        k = b"k%05d" % i
        v = b"x" * (7 + (i * 37) % 50)     # 7..56-byte values
        m.note_set(k, len(k) + len(v))
        true += len(k) + len(v)
    est = m.sampled_bytes()
    assert abs(est - true) / true < 0.25, (est, true)
    # overwriting with a smaller value re-samples, never double-counts
    for i in range(2000):
        m.note_set(b"k%05d" % i, 8)
    est2 = m.sampled_bytes()
    assert est2 < est
    # clears drop the sampled range
    m.note_clear(b"k00000", b"k99999")
    assert m.sampled_bytes() == 0


def test_sample_unbiased_across_factor_regimes(knobs):
    """Directed unbiasedness: the estimator
    tracks true bytes at every factor regime — all-big values (every
    row recorded exactly), all-tiny (probabilistic inclusion), and a
    mix — including after a live factor change."""
    for factor, sizes in ((10, (4, 7, 9)),        # all below factor
                          (100, (150, 400, 999)),  # all at/above
                          (100, (20, 80, 150, 600))):  # mixed
        flow.SERVER_KNOBS.set("byte_sample_factor", factor)
        m = StorageMetrics()
        true = 0
        for i in range(3000):
            k = b"u%05d" % i
            n = sizes[i % len(sizes)]
            m.note_set(k, n)
            true += n
        est = m.sampled_bytes()
        assert abs(est - true) / true < 0.25, (factor, est, true)
        # range queries agree with the total (prefix-sum consistency)
        mid = b"u01500"
        assert m.sampled_bytes(b"", mid) + m.sampled_bytes(mid) == est


def test_split_key_deterministic_across_replicas(knobs):
    """Two replicas applying the same rows (in different orders) hold
    identical samples and name the IDENTICAL split key — the
    deterministic-inclusion contract DD and sim replay rely on."""
    rows = [(b"d%04d" % i, 11 + (i * 13) % 70) for i in range(500)]
    a, b = StorageMetrics(), StorageMetrics()
    for k, n in rows:
        a.note_set(k, n)
    for k, n in reversed(rows):
        b.note_set(k, n)
    assert a.sampled_bytes() == b.sampled_bytes()
    assert a.split_key(b"", None) == b.split_key(b"", None)
    assert a.split_key(b"d0100", b"d0400") == \
        b.split_key(b"d0100", b"d0400")
    # and the split point genuinely byte-balances the sample
    s = a.split_key(b"", None)
    left = a.sampled_bytes(b"", s)
    assert abs(2 * left - a.sampled_bytes()) <= \
        a.sampled_bytes() * 0.2 + 2 * flow.SERVER_KNOBS.byte_sample_factor


def test_note_clear_and_rebuild_total_consistency(knobs):
    """note_clear drops exactly the range's sampled weight (the total
    equals a fresh rebuild of the surviving rows), and rebuild()
    resets rather than accumulates."""
    rows = [(b"c%04d" % i, 9 + (i * 29) % 120) for i in range(800)]
    m = StorageMetrics()
    for k, n in rows:
        m.note_set(k, n)
    m.note_clear(b"c0200", b"c0600")
    survivors = [(k, b"x" * (n - len(k))) for k, n in rows
                 if not b"c0200" <= k < b"c0600"]
    fresh = StorageMetrics()
    fresh.rebuild(survivors)
    assert m.sampled_bytes() == fresh.sampled_bytes()
    assert m._keys == fresh._keys
    # rebuild over the same rows twice: identical, not doubled
    fresh.rebuild(survivors)
    assert m.sampled_bytes() == fresh.sampled_bytes()
    # empty-range clear is a no-op
    before = m.sampled_bytes()
    m.note_clear(b"c0600", b"c0600")
    assert m.sampled_bytes() == before


def test_prefix_sums_match_naive_after_mutation_mix(knobs):
    """The lazily-rebuilt prefix sums (sub-linear
    sampled_bytes/split_key) stay exact through interleaved queries,
    overwrites, deletions and clears."""
    m = StorageMetrics()
    for i in range(300):
        m.note_set(b"p%04d" % i, 30 + (i * 7) % 90)
    def naive(b, e):
        i = 0
        return sum(w for k, w in m._sample.items()
                   if b <= k and (e is None or k < e))
    assert m.sampled_bytes(b"p0050", b"p0250") == naive(b"p0050",
                                                        b"p0250")
    m.note_set(b"p0100", 500)          # overwrite between queries
    m.note_clear(b"p0200", b"p0220")
    assert m.sampled_bytes(b"p0050", b"p0250") == naive(b"p0050",
                                                        b"p0250")
    assert m.sampled_bytes(b"", None) == naive(b"", None)


def test_split_key_is_byte_balanced(knobs):
    """With 100 tiny rows and 5 huge rows at the end, the byte-
    balanced split point lands inside the huge tail — a row-median
    would put it mid-keyspace (the skew the row-count knobs missed)."""
    m = StorageMetrics()
    for i in range(100):
        m.note_set(b"a%03d" % i, 10)
    for i in range(5):
        m.note_set(b"z%03d" % i, 2000)
    split = m.split_key(b"", None)
    assert split is not None and split >= b"z", split


def test_bandwidth_meter_decays(knobs):
    m = StorageMetrics()
    for t in range(10):
        m.note_write(1000, float(t))       # 1000 B/s steady
    r = m.write_bytes_per_sec(10.0)
    assert 500 < r < 1500, r
    assert m.write_bytes_per_sec(60.0) < 10   # decays when idle


def test_skewed_values_split_at_byte_balanced_key():
    """A shard hot by BYTES (few rows, huge
    values at one end) splits, and the boundary lands where bytes —
    not rows — balance. 160 one-byte-value rows plus 8 rows of 400B
    values: row-median splits near a0080; byte-median must land in the
    big-value tail (>= b"big")."""
    c = SimCluster(seed=1501, durable=True, n_storage=1, n_workers=5)
    flow.SERVER_KNOBS.init("DD_SHARD_SPLIT_BYTES", 2500)
    try:
        db = c.client()

        async def main():
            async def seed(tr):
                for i in range(160):
                    tr.set(b"a%04d" % i, b"v")        # ~8 B/row
            await run_transaction(db, seed)

            async def seed_big(tr):
                for i in range(8):
                    tr.set(b"big%02d" % i, b"X" * 400)  # ~3.2 KB
            await run_transaction(db, seed_big)

            for _ in range(120):
                await flow.delay(0.5)
                info = c.cc.dbinfo.get()
                if len(info.storages) >= 2:
                    break
            else:
                raise AssertionError("byte-hot shard never split")
            info = c.cc.dbinfo.get()
            boundary = info.storages[1].begin
            assert boundary >= b"big", boundary

            async def check(tr):
                rows = await tr.get_range(b"a", b"c")
                assert len(rows) == 168, len(rows)
            await run_transaction(db, check)
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        flow.reset_server_knobs()
        c.shutdown()


def test_write_bandwidth_triggers_split():
    """A shard small in bytes but hammered by writes splits on the
    bandwidth ceiling (ref: SHARD_MAX_BYTES_PER_KSEC)."""
    c = SimCluster(seed=1503, durable=True, n_storage=1, n_workers=5)
    flow.SERVER_KNOBS.init("DD_SHARD_SPLIT_BYTES_PER_KSEC", 40_000)
    try:
        db = c.client()

        async def main():
            stop = [False]

            async def hammer():
                i = 0
                while not stop[0]:
                    async def body(tr, i=i):
                        # overwrite a small keyset: bytes stay low,
                        # bandwidth stays high
                        tr.set(b"h%02d" % (i % 20), b"W" * 40)
                    await run_transaction(db, body, max_retries=500)
                    i += 1
                    await flow.delay(0.02)

            t = flow.spawn(hammer())
            ok = False
            for _ in range(240):
                await flow.delay(0.5)
                if len(c.cc.dbinfo.get().storages) >= 2:
                    ok = True
                    break
            stop[0] = True
            await flow.catch_errors(t)
            assert ok, "bandwidth-hot shard never split"
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        flow.reset_server_knobs()
        c.shutdown()
