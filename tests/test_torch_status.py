"""The reference's cases of tests/test_status.py on the port's SimCluster.

Status document + counters (ref: fdbserver/Status.actor.cpp
clusterGetStatus :1802, flow/Stats.actor.cpp CounterCollection)."""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.client import run_transaction  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402


def test_status_reflects_cluster_and_workload():
    c = SimCluster(seed=701, durable=True, n_storage=2)
    try:
        db = c.client()

        async def main():
            for i in range(6):
                async def body(tr, i=i):
                    tr.set(b"s%d" % i, b"v")
                await run_transaction(db, body)
            tr = db.create_transaction()
            await tr.get(b"s0")
            status = await db.get_status()
            cl = status["cluster"]
            assert cl["epoch"] == 1
            assert cl["recovery_state"] == "fully_recovered"
            assert cl["configuration"]["storage_shards"] == 2
            assert len(cl["storages"]) == 2
            assert len(cl["logs"]) == 1
            assert cl["logs"][0]["counters"]["commits"] >= 6
            px = cl["proxies"][0]["counters"]
            assert px["transactions_committed"] >= 6
            assert px["transactions_started"] >= 6
            total_gets = sum(r["counters"].get("get_queries", 0)
                             for s in cl["storages"]
                             for r in s["replicas"] if "counters" in r)
            assert total_gets >= 1
            assert cl["qos"]["transactions_per_second_limit"] is not None
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_status_shows_failure_and_recovery():
    c = SimCluster(seed=703, durable=True)
    try:
        db = c.client()

        async def main():
            async def body(tr):
                tr.set(b"x", b"1")
            await run_transaction(db, body)
            c.kill_role("tlog")

            async def body2(tr):
                tr.set(b"y", b"2")
            await run_transaction(db, body2, max_retries=300)
            status = await db.get_status()
            cl = status["cluster"]
            assert cl["epoch"] >= 2
            assert cl["recovery_state"] == "fully_recovered"
            # the new generation's log is the one reported
            assert cl["logs"][0]["store"].startswith(
                f"tlog-e{cl['epoch']}")
            return True

        assert c.run(main(), timeout_time=300)
    finally:
        c.shutdown()


def test_status_latency_probe():
    """The CC's periodic probe transaction reports real GRV/read/commit
    latencies in status (ref: Status.actor.cpp:983 latencyProbe)."""
    from foundationdb_tpu_torch import flow
    from foundationdb_tpu_torch.server import SimCluster

    c = SimCluster(seed=71)
    try:
        db = c.client()

        async def main():
            for _ in range(40):
                status = await db.get_status()
                probe = status["cluster"]["latency_probe"]
                if probe:
                    assert probe["transaction_start_seconds"] >= 0
                    assert probe["commit_seconds"] > 0
                    return True
                await flow.delay(1.0)
            raise AssertionError("latency probe never reported")

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_latency_bands_in_status():
    """Banded GRV/read/commit latencies appear in the status document
    once traffic has flowed (ref: fdbserver/LatencyBandConfig.cpp)."""
    from foundationdb_tpu_torch.client import run_transaction
    c = SimCluster(seed=63)
    try:
        db = c.client()

        async def main():
            for i in range(10):
                async def body(tr, i=i):
                    await tr.get(b"lb%d" % i)
                    tr.set(b"lb%d" % i, b"x")
                await run_transaction(db, body)
            status = await db.get_status()
            proxies = status["cluster"]["proxies"]
            assert proxies
            for p in proxies:
                bands = p["latency_bands"]
                assert bands["grv"]["total"] >= 10
                assert bands["commit"]["total"] >= 10
                # cumulative bands: the widest band covers everything
                widest = list(bands["commit"]["bands"].values())[-1]
                assert widest == bands["commit"]["total"]
            reads = [rep["latency_bands"]["read"]
                     for s in status["cluster"]["storages"]
                     for rep in s["replicas"] if "latency_bands" in rep]
            assert reads and sum(b["total"] for b in reads) >= 10
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_full_mutation_vocabulary():
    """21/21 mutation types (ref: CommitTransaction.h:49-109): V2 op
    codes apply, debug/no-op types are inert, and the never-legal
    types fail the transaction instead of poisoning the pipeline."""
    import pytest as _pytest

    from foundationdb_tpu_torch.client import run_transaction
    from foundationdb_tpu_torch.server.types import (AND_V2,
                                               AVAILABLE_FOR_REUSE,
                                               CommitRequest, DEBUG_KEY,
                                               DEBUG_KEY_RANGE, MIN_V2,
                                               MutationRef, NO_OP,
                                               RESERVED_LOG_PROTOCOL,
                                               SET_VALUE)
    c = SimCluster(seed=65)
    try:
        db = c.client()

        async def main():
            # V2 atomic codes through the client API
            async def setup(tr):
                tr.set(b"v2", (9).to_bytes(8, "little"))
            await run_transaction(db, setup)

            async def ops(tr):
                tr.atomic_op(b"v2", (4).to_bytes(8, "little"), MIN_V2)
                tr.atomic_op(b"missing_v2", b"\xf0", AND_V2)
            await run_transaction(db, ops)

            tr = db.create_transaction()
            assert await tr.get(b"v2") == (4).to_bytes(8, "little")
            # AND_V2 on an absent key takes the operand (V2 semantics)
            assert await tr.get(b"missing_v2") == b"\xf0"

            # inert types commit cleanly and change nothing
            info = await tr._get_info()
            proxy = info.proxies[0]
            await proxy.commits.get_reply(CommitRequest(
                0, (), ((b"inert", b"inert\x00"),),
                (MutationRef(NO_OP, b"", b""),
                 MutationRef(DEBUG_KEY, b"v2", b""),
                 MutationRef(DEBUG_KEY_RANGE, b"a", b"z"))),
                db.process)
            tr2 = db.create_transaction()
            assert await tr2.get(b"v2") == (4).to_bytes(8, "little")

            # never-legal types fail the txn loudly
            for t in (AVAILABLE_FOR_REUSE, RESERVED_LOG_PROTOCOL):
                with _pytest.raises(flow.FdbError) as ei:
                    await proxy.commits.get_reply(CommitRequest(
                        0, (), ((b"bad", b"bad\x00"),),
                        (MutationRef(t, b"bad", b"x"),)), db.process)
                assert ei.value.name == "client_invalid_operation"
            # and the client API refuses them outright
            tr3 = db.create_transaction()
            with _pytest.raises(flow.FdbError):
                tr3.atomic_op(b"k", b"x", AVAILABLE_FOR_REUSE)
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_time_series_metrics():
    """TDMetric-style multi-resolution counter series (ref:
    flow/TDMetric.actor.h levels): level 0 fine-grained, each level
    above 4x coarser; sampled from live roles into status."""
    # unit: the cascade
    ts = flow.TimeSeries(samples_per_level=8, n_levels=3)
    for i in range(32):
        ts.append(float(i), float(i))
    assert len(ts.series(0)) == 8          # ring holds the newest 8
    assert ts.latest() == (31.0, 31.0)
    l1 = ts.series(1)
    assert l1 and len(l1) == 8             # 32/4 = 8 cascaded samples
    assert l1[-1][1] == (28 + 29 + 30 + 31) / 4.0
    assert len(ts.series(2)) == 2          # 32/16

    # integration: the CC samples role counters into series
    from foundationdb_tpu_torch.client import run_transaction
    c = SimCluster(seed=67)
    try:
        db = c.client()

        async def main():
            for i in range(5):
                async def body(tr, i=i):
                    tr.set(b"m%d" % i, b"x")
                await run_transaction(db, body)
            await flow.delay(3.5)   # a few sample intervals
            status = await db.get_status()
            metrics = status["cluster"]["metrics"]
            commit_series = [v for k, v in metrics.items()
                             if k.endswith("/transactions_committed")]
            assert commit_series, list(metrics)[:10]
            s = commit_series[0]
            assert s["latest"][1] >= 5
            assert len(s["tail"]) >= 2     # multiple samples over time
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_trace_batch_stitches_commit_path():
    """Sampled-transaction latency stitching (ref: g_traceBatch,
    flow/Trace.h:107 — a debug id rides the commit through client,
    proxy, and resolver; the stations reassemble in time order)."""
    c = SimCluster(seed=69)
    try:
        db = c.client()

        async def main():
            tr = db.create_transaction()
            tr.set_option("debug_transaction_identifier", 4242)
            tr.set(b"dbg", b"1")
            await tr.commit()
            events = flow.g_trace_batch.events(4242)
            locations = [loc for _t, _et, loc in events]
            for expect in ("NativeAPI.commit.Before",
                           "MasterProxyServer.commitBatch.Before",
                           "MasterProxyServer.commitBatch.GotCommitVersion",
                           "Resolver.resolveBatch.AfterQueueSorted",
                           "Resolver.resolveBatch.After",
                           "MasterProxyServer.commitBatch.AfterResolution",
                           "MasterProxyServer.commitBatch.AfterLogPush",
                           "NativeAPI.commit.After"):
                assert expect in locations, (expect, locations)
            # stations are stitched in causal (time) order
            idx = [locations.index(l) for l in (
                "NativeAPI.commit.Before",
                "MasterProxyServer.commitBatch.Before",
                "Resolver.resolveBatch.AfterQueueSorted",
                "MasterProxyServer.commitBatch.AfterLogPush",
                "NativeAPI.commit.After")]
            assert idx == sorted(idx), locations
            times = [t for t, _et, _loc in events]
            assert times == sorted(times)
            # an unsampled transaction adds nothing
            tr2 = db.create_transaction()
            tr2.set(b"plain", b"1")
            await tr2.commit()
            assert flow.g_trace_batch.events(None) == []

            # the debug id survives an on_error retry (the retry is
            # the interesting attempt)
            t3 = db.create_transaction()
            t3.set_option("debug_transaction_identifier", 777)
            await t3.get(b"dbg")
            side = db.create_transaction()
            side.set(b"dbg", b"2")
            await side.commit()
            t3.set(b"dbg", b"mine")
            try:
                await t3.commit()
            except flow.FdbError as e:
                await t3.on_error(e)
            t3.set(b"dbg", b"mine")
            await t3.commit()
            locs = [l for _t, _et, l in flow.g_trace_batch.events(777)]
            assert locs.count("NativeAPI.commit.After") >= 1, locs
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        flow.g_trace_batch.clear()
        c.shutdown()
