"""The reference's cases of tests/test_observability.py on the port; the
kernel-profile, status and CLI cases run the port's cuda backend at
device="cpu" where the reference runs tpu.

Observability integration: kernel profiling counters, the resolver/
tlog latency surfaces in status, the periodic traceCounters rollup, and
the cli `status details` / `metrics` views (ref: flow/Stats.actor.cpp
traceCounters, fdbserver/Status.actor.cpp clusterGetStatus)."""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow
from foundationdb_tpu_torch.client import run_transaction
from foundationdb_tpu_torch.server import SimCluster


def test_kernel_profile_records_occupancy_and_compiles():
    """The CUDA backend accounts per-batch pad shapes (real rows vs
    padded slots), and the profiled kernel entry accounts its first
    call and fenced execute time per shape bucket."""
    from foundationdb_tpu_torch.models.conflict_set import ResolverTransaction
    from foundationdb_tpu_torch.models.cuda_resolver import CudaConflictSet

    flow.SERVER_KNOBS.set("KERNEL_PROFILE_EVERY", 1)  # fence every call
    try:
        cs = CudaConflictSet(device="cpu")
        for v in range(1, 4):
            txns = [ResolverTransaction(
                v - 1, ((b"k%d" % v, b"k%d\x00" % v),),
                ((b"k%d" % v, b"k%d\x00" % v),))]
            cs.resolve(txns, v * 10, 0)
        ks = cs.kernel_stats()
        assert ks["backend"] == "cuda"
        assert ks["platform"] == "cpu"
        assert ks["batches"] == 3
        # 3 real txns over 3 batches of 16 slots each
        assert ks["counts"]["txns"] == 3
        assert ks["counts"]["txn_slots"] == 48
        assert ks["occupancy"]["txn"] == round(3 / 48, 4)
        # compile/execute accounting is PER PROCESS (the lru-cached
        # entries are shared across instances), kept out of the
        # per-instance stats so status never double-attributes it
        assert "kernels" not in ks
        from foundationdb_tpu_torch.ops.conflict_kernel import g_kernel_counters
        kernels = g_kernel_counters.snapshot()
        # the minimum-size bucket all three batches land in (other
        # tests in this process may have populated other buckets):
        # verdict-only (resolve goes through the noattr variant) — via
        # the packed single-buffer feed entry point, the default
        # interval dispatch family (the port has no donate flag)
        bucket = "resolve_packed[1024c/16t/32r/32w/noattr]"
        assert kernels[f"{bucket}.compiles"] >= 1
        assert kernels[f"{bucket}.calls"] >= 3
        # the first call was timed between two device fences
        assert kernels[f"{bucket}.compile_us"] > 0
        # with KERNEL_PROFILE_EVERY=1 the post-compile calls are fenced
        assert kernels[f"{bucket}.timed_calls"] >= 1
        assert kernels[f"{bucket}.execute_us"] >= 0
    finally:
        flow.SERVER_KNOBS.set("KERNEL_PROFILE_EVERY", 64)


def test_status_folds_resolver_bands_kernel_and_tlog_bands():
    """The status document carries the full per-stage latency picture:
    proxy grv/commit, resolver resolve bands + kernel occupancy, tlog
    fsync bands, storage read bands — with reservoir percentiles."""
    c = SimCluster(seed=93, conflict_backend="cuda", device="cpu")
    try:
        db = c.client()

        async def main():
            for i in range(8):
                async def body(tr, i=i):
                    await tr.get(b"ob%d" % i)
                    tr.set(b"ob%d" % i, b"x")
                await run_transaction(db, body)
            status = await db.get_status()
            cl = status["cluster"]
            # resolver section: bands + percentiles + kernel profile
            assert cl["resolvers"], cl.keys()
            r = cl["resolvers"][0]
            bands = r["latency_bands"]["resolve"]
            assert bands["total"] >= 8
            assert "p99" in bands and "p50" in bands
            assert list(bands["bands"].values())[-1] == bands["total"]
            kern = r["kernel"]
            assert kern["backend"] == "cuda"
            assert kern["batches"] >= 8
            assert 0 < kern["occupancy"]["txn"] <= 1
            # process-wide compile accounting rides at cluster level
            assert any(k.endswith(".compiles") for k in cl["kernels"])
            # tlog fsync latency appears on the log entries
            lg = cl["logs"][0]
            assert lg["latency_bands"]["commit"]["total"] >= 8
            assert lg["latency_bands"]["commit"]["p50"] >= 0
            # proxy/storage surfaces gained percentiles too
            px = cl["proxies"][0]["latency_bands"]
            assert px["commit"]["p99"] > 0
            reads = [rep["latency_bands"]["read"]
                     for s in cl["storages"]
                     for rep in s["replicas"] if "latency_bands" in rep]
            assert reads and all("p90" in b for b in reads)
            return True

        assert c.run(main(), timeout_time=240)
    finally:
        c.shutdown()


def test_trace_counters_loop_emits_rate_rollups():
    """The CC's traceCounters loop periodically rolls every role's
    CounterCollection into *Metrics TraceEvents carrying values and
    per-interval rates (ref: traceCounters)."""
    c = SimCluster(seed=95)
    try:
        db = c.client()

        async def main():
            for i in range(6):
                async def body(tr, i=i):
                    tr.set(b"tc%d" % i, b"x")
                await run_transaction(db, body)
            await flow.delay(
                4 * flow.SERVER_KNOBS.trace_counters_interval)
            return True

        assert c.run(main(), timeout_time=120)
        for ev_type in ("ProxyMetrics", "TLogMetrics", "ResolverMetrics",
                        "StorageMetrics"):
            assert flow.g_trace.counts.get(ev_type, 0) >= 1, \
                (ev_type, flow.g_trace.counts)
        px = [e for e in flow.g_trace.events
              if e["Type"] == "ProxyMetrics"
              and e.get("transactions_committed", 0) >= 6]
        assert px, "rollup never saw the committed transactions"
        # rates are computed once a previous snapshot exists
        assert any("transactions_committed_per_sec" in e for e in px)
        # the rollup events carry the emitting role instance as ID
        assert all(e["ID"].startswith("proxy-") for e in px)
    finally:
        c.shutdown()


def test_trace_counters_reset_emits_no_negative_rate():
    """A role restarting under the same name zeroes its counters; the
    rollup must re-baseline instead of emitting negative rates."""
    cc = flow.CounterCollection("proxy")
    cc.counter("x").add(100)
    snap = cc.trace(id="p0")
    restarted = flow.CounterCollection("proxy")      # fresh counters
    snap2 = restarted.trace(id="p0", elapsed=1.0, prev=snap)
    ev = [e for e in flow.g_trace.events if e["Type"] == "ProxyMetrics"
          and e["ID"] == "p0"][-1]
    assert "x_per_sec" not in ev                     # reset: no rate
    restarted.counter("x").add(5)
    restarted.trace(id="p0", elapsed=1.0, prev=snap2)
    ev = [e for e in flow.g_trace.events if e["Type"] == "ProxyMetrics"
          and e["ID"] == "p0"][-1]
    assert ev["x_per_sec"] == 5.0                    # re-baselined


def test_resolver_counts_batches_and_latency():
    c = SimCluster(seed=97)
    try:
        db = c.client()

        async def main():
            for i in range(5):
                async def body(tr, i=i):
                    tr.set(b"rb%d" % i, b"x")
                await run_transaction(db, body)
            status = await db.get_status()
            r = status["cluster"]["resolvers"][0]
            assert r["counters"]["batches_resolved"] >= 5
            assert r["counters"]["transactions_resolved"] >= 5
            assert r["kernel"] == {}     # python backend: no device
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_cli_status_details_and_metrics_views():
    """`status details` renders the per-stage latency table and the
    kernel profile; `metrics` renders the counter time series."""
    from foundationdb_tpu_torch.tools.cli import Cli

    c = SimCluster(seed=99, conflict_backend="cuda", device="cpu",
                   durable=True)
    try:
        cli = Cli.for_cluster(c)
        for i in range(5):
            assert cli.execute(f"set cd{i} v{i}") == "Committed"
        assert cli.execute("get cd0").endswith("`v0'")
        out = cli.execute("status details")
        assert "Latency (seconds):" in out
        assert "grv" in out and "commit" in out
        assert "resolve" in out and "logfsync" in out and "read" in out
        assert "p99=" in out
        assert "Resolver kernels:" in out
        assert "backend=cuda" in out
        assert "occ[" in out
        assert "Kernel compile/execute (process-wide):" in out
        # the metric sampler needs a few virtual seconds of runway
        async def wait_samples():
            await flow.delay(3.5)
            return True
        assert c.run(wait_samples(), timeout_time=60)
        out = cli.execute("metrics")
        assert "transactions_committed" in out
        # plain status still works
        assert "Epoch" in cli.execute("status")
    finally:
        c.shutdown()
