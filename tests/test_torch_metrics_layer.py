"""The reference's cases of tests/test_metrics_layer.py on the port's
metrics layer.

layers/metrics.py: persisted counter series (ref: MetricLogger).

New this round: time-bounded `read_series` range queries and the
`extra` channel `log_counters` uses to persist the latency-probe and
conflict hot-spot series the status assembler exposes."""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow
from foundationdb_tpu_torch.layers import metrics
from foundationdb_tpu_torch.server import SimCluster


def test_read_series_time_bounds_and_extra_series():
    c = SimCluster(seed=811)
    try:
        db = c.client()

        async def main():
            col = flow.CounterCollection("proxy")
            col.counter("transactions_committed").add(3)
            # two samples ~2s apart; the extra channel carries the
            # probe/hot-spot style series with no CounterCollection
            t0 = flow.now()
            await metrics.log_counters(
                db, [col],
                extra={"latency_probe": {"grv_us": 1500},
                       "conflict_hot_spots": {"total": 6}})
            await flow.delay(2.0)
            col.counter("transactions_committed").add(2)
            t1 = flow.now()
            await metrics.log_counters(
                db, [col], extra={"latency_probe": {"grv_us": 900}})

            full = await metrics.read_series(db, "proxy",
                                             "transactions_committed")
            assert [v for _t, v in full] == [3, 5]

            probe = await metrics.read_series(db, "latency_probe",
                                              "grv_us")
            assert [v for _t, v in probe] == [1500, 900]
            hot = await metrics.read_series(db, "conflict_hot_spots",
                                            "total")
            assert [v for _t, v in hot] == [6]

            # start/end in ms, half-open [start, end)
            cut = int((t0 + 1.0) * 1000)
            early = await metrics.read_series(
                db, "latency_probe", "grv_us", end=cut)
            late = await metrics.read_series(
                db, "latency_probe", "grv_us", start=cut)
            assert [v for _t, v in early] == [1500]
            assert [v for _t, v in late] == [900]
            both = await metrics.read_series(
                db, "latency_probe", "grv_us",
                start=int(t0 * 1000), end=int((t1 + 1) * 1000))
            assert [v for _t, v in both] == [1500, 900]
            empty = await metrics.read_series(
                db, "latency_probe", "grv_us",
                start=int((t1 + 10) * 1000))
            assert empty == []
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_metric_logger_extra_fn():
    c = SimCluster(seed=812)
    try:
        db = c.client()

        async def main():
            col = flow.CounterCollection("resolver")
            col.counter("batches_resolved").add(1)
            rounds = {"n": 0}

            def extra():
                rounds["n"] += 1
                return {"latency_probe": {"rounds": rounds["n"]}}

            task = flow.spawn(metrics.metric_logger(
                db, [col], interval=0.5, extra_fn=extra))
            await flow.delay(1.8)
            task.cancel()
            series = await metrics.read_series(db, "latency_probe",
                                               "rounds")
            assert len(series) >= 2
            assert [v for _t, v in series] == \
                list(range(1, len(series) + 1))
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()
