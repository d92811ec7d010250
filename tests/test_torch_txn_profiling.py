"""The reference's cases of tests/test_txn_profiling.py on the port, its
exporter case among them (test_status_surfaces_sampler_counters, its
status half alone, stays beside it).

Sampled transaction profiling: the client sampler, the chunked
\\xff\\x02/fdbClientInfo/client_latency/ keyspace, the analyzer, and
the janitor.

Ref: fdbclient/ClientLogEvents.h + the CSI sampling path in NativeAPI
and contrib/transaction_profiling_analyzer.py. The load-bearing
property: every sampled transaction's event stream, written through
chunked system keys and read back by tools/profiler.py, reassembles
BIT-IDENTICALLY to what the client emitted — and with sampling
disabled the hot paths execute zero profiling code."""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow
from foundationdb_tpu_torch.client import run_transaction
from foundationdb_tpu_torch.client.profiling import (CommitEvent, ErrorEvent,
                                               GetEvent, GetRangeEvent,
                                               GetVersionEvent,
                                               TransactionProfile,
                                               decode_events,
                                               encode_events,
                                               record_rows,
                                               sample_decision,
                                               split_chunks)
from foundationdb_tpu_torch.server import SimCluster
from foundationdb_tpu_torch.server.systemkeys import (CLIENT_LATENCY_END,
                                                CLIENT_LATENCY_PREFIX,
                                                client_latency_key,
                                                parse_client_latency_key)
from foundationdb_tpu_torch.tools.profiler import (analyze, profile_analysis,
                                             scan_records)


def _random_events(rng, n):
    """A randomized event stream covering every type, with hostile
    byte payloads (keys are arbitrary bytes, not UTF-8)."""
    evs = []
    for _ in range(n):
        kind = rng.random_int(0, 5)
        t = rng.random01() * 100
        if kind == 0:
            evs.append(GetVersionEvent(t, rng.random01(), 0))
        elif kind == 1:
            evs.append(GetEvent(t, rng.random01(),
                                rng.random_bytes(rng.random_int(1, 40)),
                                rng.random_int(-1, 1000)))
        elif kind == 2:
            evs.append(GetRangeEvent(t, rng.random01(),
                                     rng.random_bytes(8),
                                     rng.random_bytes(8) + b"\xff",
                                     rng.random_int(0, 50)))
        elif kind == 3:
            evs.append(CommitEvent(
                t, rng.random01(), rng.random_int(0, 9),
                rng.random_int(0, 4096),
                ((rng.random_bytes(5), rng.random_bytes(5) + b"\x00"),),
                "committed" if rng.random_int(0, 2) else "conflicted",
                rng.random_int(0, 1 << 40),
                ((rng.random_bytes(4), rng.random_bytes(4) + b"\x00"),)))
        else:
            evs.append(ErrorEvent(t, "commit", "not_committed"))
    return tuple(evs)


def test_event_stream_chunk_roundtrip_bit_identical():
    """encode -> split -> join -> decode is the identity, for every
    chunk size — including sizes that split mid-field."""
    rng = flow.DeterministicRandom(1234)
    for trial in range(20):
        evs = _random_events(rng, rng.random_int(1, 30))
        blob = encode_events(evs)
        for chunk_bytes in (1, 7, 64, 4096):
            chunks = split_chunks(blob, chunk_bytes)
            assert all(len(c) <= chunk_bytes for c in chunks)
            assert b"".join(chunks) == blob
        assert decode_events(blob) == evs
        # typed, not just equal: the analyzer dispatches on type
        assert all(type(a) is type(b)
                   for a, b in zip(decode_events(blob), evs))


def test_client_latency_key_schema_roundtrip():
    k = client_latency_key(123456789, "ab" * 14, 3, 7)
    assert k.startswith(CLIENT_LATENCY_PREFIX)
    assert parse_client_latency_key(k) == (1, 123456789, "ab" * 14, 3, 7)
    # keys order by (start_ts, rec_id, chunk)
    assert client_latency_key(1, "aa", 1, 2) < \
        client_latency_key(1, "aa", 2, 2) < \
        client_latency_key(2, "aa", 1, 1)
    # foreign rows in the range never crash the parser
    assert parse_client_latency_key(CLIENT_LATENCY_PREFIX + b"junk") is None
    assert parse_client_latency_key(b"\xff\x02/other") is None


def test_sample_decision_deterministic_and_rate_shaped():
    hits = [sample_decision(0xDEAD, i, 0.25) for i in range(4000)]
    assert hits == [sample_decision(0xDEAD, i, 0.25) for i in range(4000)]
    frac = sum(hits) / len(hits)
    assert 0.18 < frac < 0.32, frac
    assert not any(sample_decision(0xDEAD, i, 0.0) for i in range(100))
    assert all(sample_decision(0xDEAD, i, 1.0) for i in range(100))


def _sampled_cluster(seed, **kw):
    """Cluster with the sampler on. The knob must be set AFTER boot:
    SimCluster re-initializes SERVER_KNOBS."""
    c = SimCluster(seed=seed, durable=True, **kw)
    flow.SERVER_KNOBS.set("profile_sample_rate", 1.0)
    return c


def _teardown(c):
    flow.SERVER_KNOBS.set("profile_sample_rate", 0.0)
    c.shutdown()


def test_sampled_transaction_roundtrips_through_cluster():
    """The acceptance property: what the client emitted is exactly
    what the analyzer reads back, through real commits."""
    c = _sampled_cluster(seed=501)
    try:
        db = c.client("prof")

        async def main():
            tr = db.create_transaction()
            assert tr._profile is not None   # rate = 1.0
            await tr.get(b"alpha")
            tr.set(b"alpha", b"A" * 100)
            tr.set(b"beta\x00\xfe", b"B")
            await tr.commit()
            emitted = list(tr._profile.events)   # pre-drain copy
            rec_id_prefix = tr._profile.rec_id
            await flow.delay(1.0)                # background flush
            assert tr._profile.events == []      # drained by the flush

            async def body(t2):
                t2.set_option("read_system_keys")
                return await scan_records(t2)
            records, stats = await run_transaction(db, body)
            mine = [r for r in records
                    if r.rec_id.startswith(rec_id_prefix)]
            assert len(mine) == 1, (stats, [r.rec_id for r in records])
            assert list(mine[0].events) == emitted
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        _teardown(c)


def test_multi_chunk_record_reassembles_across_page_boundaries():
    """A record bigger than PROFILE_CHUNK_BYTES splits into many
    chunks; the scan reassembles it even when its chunk run straddles
    scan pages (page_rows=2 forces the straddle)."""
    c = _sampled_cluster(seed=502)
    flow.SERVER_KNOBS.set("profile_chunk_bytes", 48)
    try:
        db = c.client("prof")

        async def main():
            tr = db.create_transaction()
            for i in range(6):
                await tr.get(b"key-%d" % i)
                tr.set(b"key-%d" % i, b"x" * 30)
            await tr.commit()
            emitted = list(tr._profile.events)
            await flow.delay(1.0)

            async def body(t2):
                t2.set_option("read_system_keys")
                return await scan_records(t2, page_rows=2)
            records, stats = await run_transaction(db, body)
            big = [r for r in records if list(r.events) == emitted]
            assert len(big) == 1, stats
            # it really was multi-chunk
            n = len(split_chunks(encode_events(emitted), 48))
            assert n > 1
            assert stats["chunks_seen"] >= n
            assert stats["skipped_missing_chunks"] == 0
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        _teardown(c)


def test_missing_chunk_skipped_and_counted_not_crashed():
    """Deleting one chunk of a multi-chunk record: the analyzer skips
    that record, counts it, and still decodes every intact record."""
    c = _sampled_cluster(seed=503)
    try:
        db = c.client("prof")

        async def main():
            # two hand-written records: one intact, one to be damaged
            intact = TransactionProfile("aaaa", 10.0)
            damaged = TransactionProfile("bbbb", 11.0)
            evs = _random_events(flow.DeterministicRandom(9), 12)
            rows_a = record_rows(intact, evs, chunk_bytes=32)
            rows_b = record_rows(damaged, evs, chunk_bytes=32)
            assert len(rows_b) > 2

            async def write(tr):
                tr.set_option("access_system_keys")
                for k, v in rows_a + rows_b:
                    tr.set(k, v)
                tr.clear(rows_b[1][0])     # knock out a middle chunk
            await run_transaction(db, write)

            async def body(tr):
                tr.set_option("read_system_keys")
                return await scan_records(tr)
            records, stats = await run_transaction(db, body)
            assert stats["skipped_missing_chunks"] == 1, stats
            assert [r for r in records if r.rec_id.startswith("aaaa")]
            assert not [r for r in records
                        if r.rec_id.startswith("bbbb")]
            ok = [r for r in records if r.rec_id.startswith("aaaa")][0]
            assert list(ok.events) == list(evs)
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        _teardown(c)


def test_janitor_trims_to_retention():
    """trim_client_log removes records older than the cutoff and
    counts them; newer records survive. The periodic janitor drives the
    same trim off the retention knobs."""
    from foundationdb_tpu_torch.layers.clientlog import trim_client_log
    c = SimCluster(seed=504, durable=True)
    try:
        db = c.client("prof")

        async def main():
            old = TransactionProfile("aaaa", 1.0)
            new = TransactionProfile("bbbb", 1000.0)
            evs = _random_events(flow.DeterministicRandom(5), 4)

            async def write(tr):
                tr.set_option("access_system_keys")
                for k, v in record_rows(old, evs, chunk_bytes=64) + \
                        record_rows(new, evs, chunk_bytes=64):
                    tr.set(k, v)
            await run_transaction(db, write)

            trimmed = await trim_client_log(db, cutoff_ts=500.0)
            assert trimmed == 1, trimmed

            async def body(tr):
                tr.set_option("read_system_keys")
                return await scan_records(tr)
            records, _stats = await run_transaction(db, body)
            ids = {r.rec_id for r in records}
            assert not any(i.startswith("aaaa") for i in ids), ids
            assert any(i.startswith("bbbb") for i in ids), ids
            # idempotent: nothing older remains
            assert await trim_client_log(db, cutoff_ts=500.0) == 0
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_janitor_actor_runs_on_interval():
    c = SimCluster(seed=505, durable=True, profile_janitor=True)
    flow.SERVER_KNOBS.set("profile_sample_rate", 1.0)
    flow.SERVER_KNOBS.set("profile_retention_seconds", 5.0)
    flow.SERVER_KNOBS.set("profile_janitor_interval", 1.0)
    try:
        db = c.client("prof")

        async def main():
            async def w(tr):
                tr.set(b"k", b"v")
            await run_transaction(db, w)
            await flow.delay(1.0)   # flush lands

            async def count(tr):
                tr.set_option("read_system_keys")
                return len(await tr.get_range(CLIENT_LATENCY_PREFIX,
                                              CLIENT_LATENCY_END))
            assert await run_transaction(db, count) > 0
            # sampling off; past retention + a janitor round, all gone
            flow.SERVER_KNOBS.set("profile_sample_rate", 0.0)
            await flow.delay(10.0)
            assert await run_transaction(db, count) == 0
            assert c.client_log_janitor.rounds >= 1
            assert c.client_log_janitor.records_trimmed >= 1
            return True

        assert c.run(main(), timeout_time=300)
    finally:
        _teardown(c)


def test_sampling_disabled_is_zero_overhead():
    """rate=0 (the default): no TransactionProfile is ever allocated,
    no profiling event exists, and the system keyspace stays empty —
    the bench's hot path guarantee."""
    c = SimCluster(seed=506, durable=True)
    assert float(flow.SERVER_KNOBS.profile_sample_rate) == 0.0
    try:
        db = c.client("plain")

        async def main():
            for i in range(5):
                tr = db.create_transaction()
                assert tr._profile is None
                await tr.get(b"z%d" % i)
                tr.set(b"z%d" % i, b"v")
                await tr.commit()
                assert tr._profile is None
            assert db._txn_seq == 0          # sampler never consulted

            async def count(tr):
                tr.set_option("read_system_keys")
                return len(await tr.get_range(CLIENT_LATENCY_PREFIX,
                                              CLIENT_LATENCY_END))
            assert await run_transaction(db, count) == 0
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_transaction_logging_enable_option_forces_sampling():
    """set_option("transaction_logging_enable", id) samples ONE
    transaction even with the database rate at 0, and the identifier
    names the record."""
    c = SimCluster(seed=507, durable=True)
    try:
        db = c.client("opt")

        async def main():
            tr = db.create_transaction()
            assert tr._profile is None
            tr.set_option("transaction_logging_enable", "my-txn")
            assert tr._profile is not None
            await tr.get(b"a")
            tr.set(b"a", b"1")
            await tr.commit()
            await flow.delay(1.0)

            async def body(t2):
                t2.set_option("read_system_keys")
                return await scan_records(t2)
            records, _stats = await run_transaction(db, body)
            mine = [r for r in records if r.rec_id.startswith("my-txn")]
            assert len(mine) == 1, [r.rec_id for r in records]
            kinds = {type(e).__name__ for e in mine[0].events}
            assert "CommitEvent" in kinds and "GetEvent" in kinds
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_conflicted_commit_records_verdict_and_attribution():
    """A conflicted sampled commit persists verdict="conflicted" with
    the resolver's attributed ranges (PR 2's report_conflicting_keys),
    and the analyzer counts it."""
    c = _sampled_cluster(seed=508)
    try:
        db = c.client("prof")

        async def main():
            async def seed(tr):
                tr.set(b"hot", b"0")
            await run_transaction(db, seed)
            tr = db.create_transaction()
            tr.set_option("report_conflicting_keys")
            await tr.get(b"hot")
            tr.set(b"mine", b"v")

            async def bump(t2):
                t2.set(b"hot", b"x")
            await run_transaction(db, bump)
            try:
                await tr.commit()
                raise AssertionError("expected conflict")
            except flow.FdbError as e:
                assert e.name == "not_committed"
            commits = [e for e in tr._profile.events
                       if isinstance(e, CommitEvent)]
            assert commits and commits[-1].verdict == "conflicted"
            assert commits[-1].conflicting_ranges == \
                ((b"hot", b"hot\x00"),)
            await flow.delay(1.0)
            analysis, _stats = await profile_analysis(db)
            assert analysis["conflicted"] >= 1
            assert analysis["committed"] >= 1
            assert any(r["key"] == b"hot".hex()
                       for r in analysis["hottest_keys"])
            assert any(r["key"] == b"hot".hex()
                       for r in analysis["hottest_written"])
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        _teardown(c)


def test_analyzer_orders_slowest_and_histograms():
    """Pure-analysis unit: slowest ordering, per-op histograms, and
    outcome counts over synthetic records."""
    from foundationdb_tpu_torch.tools.profiler import TxnRecord
    fast = TxnRecord(1.0, "fast", (
        GetVersionEvent(1.0, 0.001, 0),
        CommitEvent(1.0, 0.002, 1, 10, ((b"a", b"a\x00"),),
                    "committed", 7, ())))
    slow = TxnRecord(2.0, "slow", (
        GetEvent(2.0, 0.5, b"k", 3),
        CommitEvent(2.0, 0.25, 1, 10, ((b"a", b"a\x00"),),
                    "conflicted", 0, ((b"k", b"k\x00"),))))
    out = analyze([fast, slow], top_n=5)
    assert out["records"] == 2
    assert out["committed"] == 1 and out["conflicted"] == 1
    assert out["slowest"][0]["rec_id"] == "slow"
    assert out["per_op"]["get"]["total"] == 1
    assert out["per_op"]["commit"]["total"] == 2
    assert out["hottest_keys"][0]["key"] == b"k".hex()


def test_cli_profile_commands():
    """`profile on` arms the sampler, `profile analyze` renders the
    report, `profile off` disarms (and keeps the legacy run-loop
    profiler contract)."""
    from foundationdb_tpu_torch.tools.cli import Cli
    c = SimCluster(seed=509, durable=True)
    try:
        cli = Cli.for_cluster(c)
        assert cli.execute("profile on") == "Profiler on"
        assert float(flow.SERVER_KNOBS.profile_sample_rate) == 1.0
        for i in range(3):
            assert cli.execute(f"set pk{i} v") == "Committed"
        out = cli.execute("profile analyze")
        assert "Transaction profile:" in out, out
        assert "Slowest transactions:" in out, out
        out = cli.execute("profile off")
        assert out.startswith("Profiler off"), out
        assert float(flow.SERVER_KNOBS.profile_sample_rate) == 0.0
        assert cli.execute("profile bogus").startswith("usage:")
    finally:
        flow.SERVER_KNOBS.set("profile_sample_rate", 0.0)
        c.shutdown()


def test_status_and_exporter_surface_sampler_counters():
    from foundationdb_tpu_torch.tools.exporter import (parse_prometheus,
                                                       render_prometheus)
    c = _sampled_cluster(seed=510)
    try:
        db = c.client("prof")

        async def main():
            async def w(tr):
                tr.set(b"a", b"b")
            await run_transaction(db, w)
            await flow.delay(1.0)
            return await db.get_status()

        status = c.run(main(), timeout_time=120)
        prof = status["cluster"]["client_profile"]
        assert prof["transactions_sampled"] >= 1, prof
        assert prof["records_written"] >= 1, prof
        samples = parse_prometheus(render_prometheus(status))
        got = {l["counter"]: v for n, l, v in samples
               if n == "fdbtpu_client_profile"}
        assert got.get("transactions_sampled", 0) >= 1, got
    finally:
        _teardown(c)


def test_status_surfaces_sampler_counters():
    c = _sampled_cluster(seed=510)
    try:
        db = c.client("prof")

        async def main():
            async def w(tr):
                tr.set(b"a", b"b")
            await run_transaction(db, w)
            await flow.delay(1.0)
            return await db.get_status()

        status = c.run(main(), timeout_time=120)
        prof = status["cluster"]["client_profile"]
        assert prof["transactions_sampled"] >= 1, prof
        assert prof["records_written"] >= 1, prof
    finally:
        _teardown(c)
