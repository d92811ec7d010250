"""The reference's simulated-commit span case
(tests/test_trace_spans.py::test_simulated_commit_emits_full_span_chain)
on the port's SimCluster: a sampled commit opens the client -> proxy ->
{resolver, tlog} span tree on the port's `flow.g_trace_batch`, and on
`cuda` at `device="cpu"` as on `python` (ref: flow/Tracing.h Span)."""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402


@pytest.mark.parametrize("backend", ["python", "cuda"])
def test_simulated_commit_emits_full_span_chain(backend):
    """A sampled commit through the simulated cluster produces the
    complete client -> proxy -> {resolver, tlog} span tree with
    monotonic virtual-clock timestamps, alongside the classic commit-debug stations."""
    from foundationdb_tpu_torch.server import SimCluster

    c = SimCluster(seed=91, conflict_backend=backend, device="cpu")
    try:
        db = c.client()

        async def main():
            tr = db.create_transaction()
            tr.set_option("debug_transaction_identifier", 5150)
            await tr.get(b"span-k")
            tr.set(b"span-k", b"v")
            await tr.commit()
            return True

        assert c.run(main(), timeout_time=120)
        chain = flow.g_trace_batch.span_chain(5150)
        by_loc = {s["location"]: s for s in chain}
        assert set(by_loc) == {"NativeAPI.commit",
                               "MasterProxyServer.commitBatch",
                               "Resolver.resolveBatch",
                               "TLog.tLogCommit"}
        root = by_loc["NativeAPI.commit"]
        proxy = by_loc["MasterProxyServer.commitBatch"]
        res = by_loc["Resolver.resolveBatch"]
        tlog = by_loc["TLog.tLogCommit"]
        assert root["parent"] is None and root["depth"] == 0
        assert proxy["parent"] == "NativeAPI.commit" and proxy["depth"] == 1
        assert res["parent"] == "MasterProxyServer.commitBatch"
        assert tlog["parent"] == "MasterProxyServer.commitBatch"
        assert res["depth"] == tlog["depth"] == 2
        # virtual-clock sanity: begins are causally ordered and every
        # span closed at/after it opened, inside its parent's extent
        assert root["begin"] <= proxy["begin"] <= res["begin"] \
            <= tlog["begin"]
        for s in chain:
            assert s["end"] is not None and s["end"] >= s["begin"]
        assert proxy["end"] <= root["end"]
        assert res["end"] <= proxy["end"] and tlog["end"] <= proxy["end"]
        # resolution happens before the log fsync completes
        assert res["end"] <= tlog["end"]
        # the sampled read hit the storage stations too
        locs = [l for _t, _et, l in flow.g_trace_batch.events(5150)]
        assert "NativeAPI.getValue.Before" in locs
        assert "StorageServer.getValue.DoRead" in locs
        assert "StorageServer.getValue.AfterRead" in locs
        # an unsampled commit opens no spans
        assert flow.g_trace_batch.span_chain(None) == []
    finally:
        flow.g_trace_batch.clear()
        c.shutdown()
