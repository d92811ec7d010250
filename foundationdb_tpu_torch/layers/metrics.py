"""MetricLogger: persist role counters into the database itself.

Reference: fdbclient/MetricLogger.actor.cpp + flow/TDMetric — counter
samples written into a system-ish keyspace so the database stores its
own time series. Here: one snapshot per role per flush under a tuple
subspace keyed (role, counter, sim_time)."""

from __future__ import annotations

from .. import flow
from ..client import run_transaction
from .subspace import Subspace

DEFAULT_SPACE = Subspace(("\x02metrics",))


async def log_counters(db, collections, space: Subspace = DEFAULT_SPACE,
                       max_retries: int = 100, extra: dict = None) -> int:
    """Write one timestamped sample per counter; returns rows written.

    `extra` persists series that have no CounterCollection behind them
    — the latency-probe readings and the conflict hot-spot scores the
    cluster controller assembles for status: a mapping
    {series_role: {counter_name: int_value}} written under the same
    (role, counter, ms_timestamp) tuple keys, so `read_series` replays
    probe and conflict history exactly like any role counter."""
    now = flow.now()
    rows = []
    for col in collections:
        for name, value in col.snapshot().items():
            rows.append((space.pack((col.role, name, int(now * 1000))),
                         b"%d" % value))
    for role, counters in (extra or {}).items():
        for name, value in counters.items():
            rows.append((space.pack((role, name, int(now * 1000))),
                         b"%d" % int(value)))

    async def body(tr):
        for k, v in rows:
            tr.set(k, v)
    await run_transaction(db, body, max_retries=max_retries)
    return len(rows)


async def read_series(db, role: str, counter: str,
                      space: Subspace = DEFAULT_SPACE,
                      start: int = None, end: int = None):
    """Samples for one counter: [(ms_timestamp, value)], optionally
    bounded to start <= ms_timestamp < end (tuple-encoded bounds ride
    the ordinary range read, so the cut happens server-side: a dashboard asking for
    the last minute must not page years of samples)."""
    if start is None and end is None:
        b, e = space.range((role, counter))
    else:
        full_b, full_e = space.range((role, counter))
        b = space.pack((role, counter, int(start))) if start is not None \
            else full_b
        e = space.pack((role, counter, int(end))) if end is not None \
            else full_e
    tr = db.create_transaction()
    rows = await tr.get_range(b, e)
    return [(space.unpack(k)[-1], int(v)) for k, v in rows]


async def metric_logger(db, collections, interval: float = None,
                        space: Subspace = DEFAULT_SPACE,
                        extra_fn=None):
    """Periodic flush actor (ref: runMetrics). `extra_fn`, when given,
    is called each round for the `extra` sample dict (the probe /
    hot-spot series a status assembler exposes)."""
    if interval is None:
        interval = flow.SERVER_KNOBS.metric_logger_interval
    while True:
        await flow.delay(interval)
        await log_counters(db, collections, space,
                           extra=extra_fn() if extra_fn else None)


# -- the \xff\x02/metrics/ history series ----------------------------
# Written by the CC's MetricHistoryRecorder (server/metric_history.py)
# in delta-encoded chunk rows; read back here by anything with a
# database handle — the soak's restart-safe verdict, incident bundles,
# dashboards.

async def read_history(db, signal: str, start_ms: int = None,
                       end_ms: int = None, limit: int = 100_000):
    """One signal's persisted samples: [(ts_ms, int_value)], optionally
    bounded to start_ms <= ts < end_ms. Chunks are self-contained, so
    the row range is cut at chunk granularity and samples filtered —
    a chunk straddling the window still contributes its inside part."""
    from ..server.systemkeys import (decode_metric_chunk,
                                     metric_history_signal_prefix)
    prefix = metric_history_signal_prefix(signal)

    async def body(tr):
        tr.set_option("access_system_keys")
        return await tr.get_range(prefix, prefix + b"\xff", limit=limit)

    rows = await run_transaction(db, body)
    out = []
    for _k, v in rows:
        samples = decode_metric_chunk(v)
        if samples is None:
            continue
        for ts, val in samples:
            if start_ms is not None and ts < start_ms:
                continue
            if end_ms is not None and ts >= end_ms:
                continue
            out.append((ts, val))
    return out


async def list_history_signals(db, limit: int = 100_000):
    """Every signal with at least one persisted chunk, sorted."""
    from ..server.systemkeys import (METRIC_HISTORY_END,
                                     METRIC_HISTORY_PREFIX,
                                     parse_metric_history_key)

    async def body(tr):
        tr.set_option("access_system_keys")
        return await tr.get_range(METRIC_HISTORY_PREFIX,
                                  METRIC_HISTORY_END, limit=limit)

    rows = await run_transaction(db, body)
    signals = set()
    for k, _v in rows:
        parsed = parse_metric_history_key(k)
        if parsed is not None:
            signals.add(parsed[1])
    return sorted(signals)


async def trim_history(db, cutoff_ms: int, max_retries: int = 100,
                       scan_limit: int = 10_000) -> int:
    """Trim every signal's series to the retention window: one bounded
    scan to discover the live signals, then one clear_range per signal
    up to its cutoff chunk (the clientlog-janitor shape; chunks are
    keyed by their FIRST sample, so a straddling chunk survives whole)."""
    from ..server.systemkeys import (METRIC_HISTORY_END,
                                     METRIC_HISTORY_PREFIX,
                                     metric_history_cutoff_key,
                                     metric_history_signal_prefix,
                                     parse_metric_history_key)

    async def body(tr):
        tr.set_option("access_system_keys")
        rows = await tr.get_range(METRIC_HISTORY_PREFIX,
                                  METRIC_HISTORY_END, limit=scan_limit)
        doomed = 0
        signals = set()
        for k, _v in rows:
            parsed = parse_metric_history_key(k)
            if parsed is None:
                continue
            signals.add(parsed[1])
            if parsed[2] < cutoff_ms:
                doomed += 1
        for signal in signals:
            tr.clear_range(metric_history_signal_prefix(signal),
                           metric_history_cutoff_key(signal, cutoff_ms))
        return doomed

    return await run_transaction(db, body, max_retries=max_retries)


async def trim_series(db, cutoff_ms: int, space: Subspace = DEFAULT_SPACE,
                      max_retries: int = 100,
                      scan_limit: int = 10_000) -> int:
    """Trim the LEGACY tuple-space counter series (log_counters above)
    to the same retention window: keys order as (role, counter, ts), so
    old rows interleave per pair — one bounded scan discovers the live
    (role, counter) pairs, then one clear_range per pair trims its tail."""
    b, e = space.range(())

    async def body(tr):
        rows = await tr.get_range(b, e, limit=scan_limit)
        doomed = 0
        pairs = set()
        for k, _v in rows:
            try:
                role, counter, ts = space.unpack(k)
            except Exception:  # noqa: BLE001 — foreign rows are skipped
                continue
            pairs.add((role, counter))
            if ts < cutoff_ms:
                doomed += 1
        for role, counter in pairs:
            pb, _pe = space.range((role, counter))
            tr.clear_range(pb, space.pack((role, counter, cutoff_ms)))
        return doomed

    return await run_transaction(db, body, max_retries=max_retries)


class MetricsJanitor:
    """ONE retention janitor for every longitudinal keyspace (trimming
    is not ad hoc per series): the
    \\xff\\x02/metrics/ history and the legacy tuple-space counter
    series share METRIC_RETENTION_SECONDS; the TimeKeeper map keeps
    its own TIMEKEEPER_RETENTION (operators want version translation
    to reach further back than dense samples). Lifecycle mirrors
    ClientLogJanitor."""

    def __init__(self, cluster, retention: float = None,
                 interval: float = None, space: Subspace = DEFAULT_SPACE):
        self.cluster = cluster
        self.db = cluster.client("metrics-janitor")
        self.retention = retention
        self.interval = interval
        self.space = space
        self.rows_trimmed = 0
        self.rounds = 0
        self._task = None

    def start(self) -> None:
        from ..flow import TaskPriority
        self._task = flow.spawn(self._run(), TaskPriority.LOW_PRIORITY,
                                name="metricsJanitor")

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _run(self) -> None:
        from ..flow import TaskPriority
        from ..server.timekeeper import trim_timekeeper
        while True:
            await flow.delay(
                self.interval if self.interval is not None
                else flow.SERVER_KNOBS.metric_janitor_interval,
                TaskPriority.LOW_PRIORITY)
            retention = (self.retention if self.retention is not None
                         else flow.SERVER_KNOBS.metric_retention_seconds)
            cutoff_ms = int((flow.now() - retention) * 1000)
            try:
                trimmed = await trim_history(self.db, cutoff_ms)
                trimmed += await trim_series(self.db, cutoff_ms,
                                             self.space)
                trimmed += await trim_timekeeper(
                    self.db,
                    flow.now() - flow.SERVER_KNOBS.timekeeper_retention)
                if trimmed:
                    flow.TraceEvent("MetricsTrimmed").detail(
                        Rows=trimmed, CutoffMs=cutoff_ms).log()
                self.rows_trimmed += trimmed
                self.rounds += 1
            except flow.FdbError as e:
                if e.name == "operation_cancelled":
                    raise
                # a trim round losing to a recovery waits for the next
