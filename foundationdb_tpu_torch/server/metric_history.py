"""Metric history recorder: the status document's longitudinal twin.

Reference: the metrics-keyspace idiom (fdbclient/MetricLogger.actor.cpp
persisting TDMetric series through the ordinary commit pipeline) applied
to the signals clusterGetStatus already computes. The cluster
controller's recorder loop samples a BOUNDED, deterministic vocabulary
of cluster signals once per METRIC_HISTORY_INTERVAL, buffers them
per-signal, and commits METRIC_HISTORY_CHUNK-sample delta-encoded chunk
rows under \\xff\\x02/metrics/<signal>/<ts> (schema: systemkeys.py).

Two consumers read the result: the CC's own SLO engine evaluates rules
over the recorder's in-memory tail (no read transactions on the hot
path), and anything with a database handle — layers/metrics.read_history,
tools/soak.py's restart-safe read-back, tools/incident.py — replays the
persisted series.

All values are integers; float signals are stored fixed-point x1000
(the `_ms`/`_x1000` suffix names the unit). Sampling happens on the sim
clock at a fixed cadence, so same-seed runs record bit-identical series
(pinned by tests/test_longitudinal.py).
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Dict, List, Tuple

from .. import flow
from .chaos import chaos_status as _chaos_status
from .dbinfo import FULLY_RECOVERED
from .ratekeeper import LIMIT_REASONS
from .systemkeys import encode_metric_chunk, metric_history_key


def _fp(x) -> int:
    """Fixed-point x1000 (so p99 seconds become integer milliseconds)."""
    return int(round(float(x) * 1000))


def _good_count(bands, edge_s: float) -> int:
    """Requests that finished within `edge_s` — the cumulative band
    count at the largest edge <= edge_s (0 when the edge undercuts
    every band: nothing is provably fast enough)."""
    i = bisect_right(bands.bands, edge_s) - 1
    return bands.counts[i] if i >= 0 else 0


class MetricHistoryRecorder:
    """Owned by the ClusterController; `record()` is called once per
    METRIC_HISTORY_INTERVAL from the recorder loop, `drain_chunks()` by
    the flush path. Per-signal state is O(chunk + tail window), never
    O(run length) — the run's length lives in the keyspace."""

    def __init__(self, cc):
        self.cc = cc
        self._buffers: Dict[str, List[Tuple[int, int]]] = {}
        self._tail: Dict[str, List[Tuple[int, int]]] = {}
        self._recovery_down_since = None
        self.samples_taken = 0
        self.rows_written = 0
        self.flushes = 0

    # -- sampling --------------------------------------------------------
    def sample_signals(self, now: float) -> Dict[str, int]:
        """One tick's signal vector off the CC's live registry — the
        same sources get_status reads, collapsed to a bounded integer
        vocabulary."""
        from .resolver_role import Resolver
        cc = self.cc
        info = cc.dbinfo.get()
        out: Dict[str, int] = {"cluster/epoch": info.epoch}

        # recovery excursion age: 0 while fully recovered, else ms since
        # this excursion began (the SLO recovery-time rule's input)
        if info.recovery_state == FULLY_RECOVERED:
            self._recovery_down_since = None
            out["cluster/recovery_age_ms"] = 0
        else:
            if self._recovery_down_since is None:
                self._recovery_down_since = now
            out["cluster/recovery_age_ms"] = _fp(
                now - self._recovery_down_since)

        committed = conflicted = 0
        grv_total = grv_good = commit_total = commit_good = 0
        commit_p99 = grv_p99 = 0.0
        adm_admitted = adm_rejected = adm_throttled = 0
        commit_edge = flow.SERVER_KNOBS.slo_commit_p99_ms / 1000.0
        grv_edge = flow.SERVER_KNOBS.slo_grv_p99_ms / 1000.0
        for p in cc._current_proxies():
            snap = p.stats.snapshot()
            committed += snap.get("transactions_committed", 0)
            conflicted += snap.get("transactions_conflicted", 0)
            cb, gb = p.commit_bands, p.grv_bands
            commit_total += cb.bands.total
            commit_good += _good_count(cb.bands, commit_edge)
            grv_total += gb.bands.total
            grv_good += _good_count(gb.bands, grv_edge)
            commit_p99 = max(commit_p99, cb.sample.percentile(0.99))
            grv_p99 = max(grv_p99, gb.sample.percentile(0.99))
            adm = p.admission_status()
            adm_admitted += sum(adm.get("admitted", {}).values())
            adm_rejected += adm.get("rejected", 0) + adm.get(
                "throttle_rejected", 0)
            adm_throttled += adm.get("throttle_delayed", 0)
        out["cluster/txn_committed"] = committed
        out["cluster/txn_conflicted"] = conflicted
        out["latency/commit/total"] = commit_total
        out["latency/commit/bad"] = commit_total - commit_good
        out["latency/commit/p99_ms"] = _fp(commit_p99)
        out["latency/grv/total"] = grv_total
        out["latency/grv/bad"] = grv_total - grv_good
        out["latency/grv/p99_ms"] = _fp(grv_p99)
        out["admission/admitted"] = adm_admitted
        out["admission/rejected"] = adm_rejected
        out["admission/throttle_delayed"] = adm_throttled

        # shadow-resolve divergence across the epoch's resolvers (the
        # zero-divergent-verdicts SLO's input)
        mismatches = 0
        for _rn, role in cc._epoch_roles(info, Resolver):
            fo = role.failover_stats()
            if fo:
                mismatches += (fo.get("shadow", {}) or {}).get(
                    "mismatches", 0)
        out["cluster/shadow_mismatches"] = mismatches

        # ratekeeper decision
        rk = cc._current_ratekeeper()
        if rk is not None:
            out["rk/tps_limit"] = int(min(rk.rate, 10 ** 12))
            reason = (rk.last_decision or {}).get("limiting_reason",
                                                  "none")
            out["rk/limiting_reason"] = (
                LIMIT_REASONS.index(reason)
                if reason in LIMIT_REASONS else -1)

        # storage heat rollup (zeros while that plane is disarmed)
        heat = cc.storage_heat.top()
        out["heat/ranges"] = len(heat)
        out["heat/top_read_bps"] = int(heat[0]["read_bps"]) if heat else 0

        # chaos accounting (did the storm actually fire, and when)
        ch = _chaos_status(cc.process.net)
        out["chaos/events"] = ch["events"]
        out["chaos/messages_dropped"] = ch["messages_dropped"]
        out["chaos/messages_duplicated"] = ch["messages_duplicated"]

        # QoS plane: per role kind, the max of each smoothed signal
        # across that kind's roles (bounded: the QosSample vocabulary
        # is fixed per kind; empty while QOS_SAMPLE_INTERVAL is 0)
        agg: Dict[str, float] = {}
        for s in cc.qos_samples.values():
            for name, v in s.signals.items():
                if not isinstance(v, (int, float)):
                    continue
                key = f"qos/{s.kind}/{name}"
                agg[key] = max(agg.get(key, 0.0), float(v))
        for key in sorted(agg):
            out[key] = _fp(agg[key])
        return out

    def record(self, now: float) -> None:
        """Append one tick's samples to the per-signal buffers and the
        in-memory tail the SLO engine reads."""
        ts_ms = int(now * 1000)
        tail_ms = int(max(flow.SERVER_KNOBS.slo_burn_slow_window * 2,
                          120.0) * 1000)
        for signal, value in self.sample_signals(now).items():
            self._buffers.setdefault(signal, []).append((ts_ms, value))
            tail = self._tail.setdefault(signal, [])
            tail.append((ts_ms, value))
            cutoff = ts_ms - tail_ms
            while tail and tail[0][0] < cutoff:
                tail.pop(0)
        self.samples_taken += 1

    # -- flushing --------------------------------------------------------
    def drain_chunks(self, force: bool = False):
        """Pop every signal buffer that reached METRIC_HISTORY_CHUNK
        samples (all of them when `force`) as (key, value) chunk rows
        ready for one blind-write transaction."""
        chunk = max(1, int(flow.SERVER_KNOBS.metric_history_chunk))
        rows = []
        for signal in sorted(self._buffers):
            buf = self._buffers[signal]
            while len(buf) >= chunk or (force and buf):
                samples, self._buffers[signal] = buf[:chunk], buf[chunk:]
                buf = self._buffers[signal]
                rows.append((metric_history_key(signal, samples[0][0]),
                             encode_metric_chunk(samples)))
        return rows

    async def flush(self, db, force: bool = False) -> int:
        """Commit the ready chunk rows (blind sets — chunk keys are
        unique per (signal, first_ts), so this can never conflict)."""
        rows = self.drain_chunks(force)
        if not rows:
            return 0
        from ..client import run_transaction

        async def body(tr):
            tr.set_option("access_system_keys")
            for k, v in rows:
                tr.set(k, v)

        await run_transaction(db, body, max_retries=100)
        self.rows_written += len(rows)
        self.flushes += 1
        return len(rows)

    # -- reading (the SLO engine's view) ---------------------------------
    def tail_series(self) -> Dict[str, List[Tuple[int, int]]]:
        return self._tail

    def status(self) -> dict:
        return {"samples": self.samples_taken,
                "rows_written": self.rows_written,
                "flushes": self.flushes,
                "signals": len(self._tail),
                "buffered": sum(len(b) for b in self._buffers.values())}
