"""Prometheus exporter: the cluster status document as scrape text.

Reference: the reference cluster is scraped by parsing `status json`
(the community fdb-exporter pattern); here the status document the
ClusterController assembles (server/cluster_controller.py get_status)
is rendered directly into the Prometheus text exposition format —
every role's counters, the per-stage latency-band histograms, the
TPU-kernel profile gauges, the latency-probe readings, the conflict
hot-spot table, and the health messages — so one scrape covers the
whole commit pipeline.

Use in-process (`render_prometheus(status)`), or serve over HTTP:
`python -m foundationdb_tpu_torch.tools.exporter --connect host:port
[--listen-port 9090]` attaches to a tools.server cluster and serves
GET /metrics.
"""

from __future__ import annotations

import sys
import threading
from typing import Callable, List, Optional, Tuple

_PREFIX = "fdbtpu"


def _esc(v) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


class _Families:
    """Accumulate samples grouped by metric family so each family
    renders one # HELP/# TYPE header (the format requires grouping)."""

    def __init__(self, extra_labels: dict = None):
        self._fams: dict = {}   # name -> (type, help, [(suffix, labels, value)])
        self._order: List[str] = []
        # labels stamped onto every sample added while set — the
        # federated render swaps this per process so one accumulator
        # (and so one HELP/TYPE header per family) covers them all
        self.extra: dict = dict(extra_labels or {})

    def add(self, name: str, mtype: str, help_text: str,
            labels: dict, value, suffix: str = "") -> None:
        """`suffix` names histogram children (`_bucket`, `_count`):
        the TYPE/HELP header goes on the FAMILY name and the samples on
        name+suffix, the grouping strict OpenMetrics parsers require."""
        if value is None:
            return
        if self.extra:
            labels = {**self.extra, **labels}
        fam = self._fams.get(name)
        if fam is None:
            fam = self._fams[name] = (mtype, help_text, [])
            self._order.append(name)
        fam[2].append((suffix, labels, value))

    def render(self) -> str:
        out: List[str] = []
        for name in self._order:
            mtype, help_text, samples = self._fams[name]
            out.append(f"# HELP {name} {help_text}")
            out.append(f"# TYPE {name} {mtype}")
            for suffix, labels, value in samples:
                if labels:
                    lab = ",".join(f'{k}="{_esc(v)}"'
                                   for k, v in labels.items())
                    out.append(f"{name}{suffix}{{{lab}}} {value}")
                else:
                    out.append(f"{name}{suffix} {value}")
        return "\n".join(out) + "\n"


def _band_seconds(band_key: str) -> str:
    # "<=0.005s" -> "0.005"
    return band_key[2:].rstrip("s")


def _add_latency(f: _Families, kind: str, role: str, request: str,
                 snap: dict, stem: str = None) -> None:
    """One RequestLatency snapshot -> a WELL-FORMED Prometheus
    histogram (cumulative `_bucket` counts ordered by `le`, a final
    `+Inf` bucket, and matching `_count`/`_sum` children) plus max and
    quantile gauges (the reservoir percentiles ride a separate family:
    a summary and a histogram may not share a metric name). The raw
    per-band counters additionally ride a `*_band` series, so a
    dashboard keyed on the LatencyBands thresholds keeps working.
    `stem` picks the family name prefix (default: the shared
    request-latency family; the resolve pipeline uses its own)."""
    stem = stem or f"{_PREFIX}_request_latency"
    base = f"{stem}_seconds"
    help_text = "Request latency bands per pipeline stage"
    labels = {"kind": kind, "role": role, "request": request}
    # LatencyBands.record increments EVERY band at or above the
    # latency, so the snapshot counts are already cumulative — emit
    # them in threshold order (dict order follows the sorted band
    # tuple, but sort defensively: bucket monotonicity is a format
    # invariant, not a hope)
    bands = sorted(snap.get("bands", {}).items(),
                   key=lambda kv: float(_band_seconds(kv[0])))
    for bk, count in bands:
        f.add(base, "histogram", help_text,
              {**labels, "le": _band_seconds(bk)}, count, suffix="_bucket")
    f.add(base, "histogram", help_text,
          {**labels, "le": "+Inf"}, snap.get("total", 0),
          suffix="_bucket")
    f.add(base, "histogram", help_text, labels, snap.get("total", 0),
          suffix="_count")
    f.add(base, "histogram", help_text, labels,
          snap.get("sum_seconds", 0.0), suffix="_sum")
    for bk, count in bands:
        f.add(f"{stem}_band", "gauge",
              "Raw per-band request counts (LatencyBands thresholds)",
              {**labels, "band": _band_seconds(bk)}, count)
    f.add(f"{stem}_max_seconds", "gauge",
          "Largest latency ever observed per stage", labels,
          snap.get("max_seconds"))
    for q in ("p50", "p90", "p99"):
        if q in snap:
            f.add(f"{stem}_quantile_seconds", "gauge",
                  "Recent-reservoir latency percentiles per stage",
                  {**labels, "quantile": "0." + q[1:]}, snap[q])


def _add_process_metrics(f: _Families, sample: dict) -> None:
    """One ProcessMetrics sample (server/process_metrics.py) into the
    fdbtpu_process_* family set — shared by the host render and the
    federated per-worker render so the families line up."""
    if not sample:
        return
    labels = {"role": str(sample.get("role", "?")),
              "pid": str(sample.get("pid", "?"))}
    for field, mtype, help_text in (
            ("cpu_seconds", "counter",
             "Process CPU seconds (user+system) since sampling began"),
            ("rss_bytes", "gauge",
             "Resident set size in bytes (-1 where unreadable)"),
            ("open_fds", "gauge",
             "Open file descriptors (-1 where unreadable)"),
            ("gc_collections", "counter",
             "Cumulative Python GC collections across generations"),
            ("loop_lag_ms", "gauge",
             "Run-loop lag: how late a fixed real-time sleep fired"),
            ("uptime_seconds", "counter",
             "Wall seconds since the process's sampler started")):
        f.add(f"{_PREFIX}_process_{field}", mtype, help_text, labels,
              sample.get(field))


def _add_counters(f: _Families, kind: str, role: str, counters: dict) -> None:
    for cname, value in sorted((counters or {}).items()):
        f.add(f"{_PREFIX}_role_counter", "counter",
              "Role counters (flow/Stats CounterCollection values)",
              {"kind": kind, "role": role, "counter": cname}, value)


def render_prometheus(status: dict, f: _Families = None) -> str:
    """The status document as Prometheus text exposition format.
    Pass an existing `_Families` to accumulate into it instead (the
    federated scrape does — it returns "" and the caller renders)."""
    cl = status.get("cluster", status) or {}
    own = f is None
    if own:
        f = _Families()
    f.add(f"{_PREFIX}_cluster_epoch", "gauge",
          "Current recovery epoch", {}, cl.get("epoch"))
    f.add(f"{_PREFIX}_cluster_recovered", "gauge",
          "1 when recovery_state is fully_recovered", {},
          int(cl.get("recovery_state") == "fully_recovered"))
    qos = cl.get("qos") or {}
    f.add(f"{_PREFIX}_qos_transactions_per_second_limit", "gauge",
          "Ratekeeper transaction budget", {},
          qos.get("transactions_per_second_limit"))
    f.add(f"{_PREFIX}_qos_batch_transactions_per_second_limit", "gauge",
          "Ratekeeper batch-priority transaction budget", {},
          qos.get("batch_transactions_per_second_limit"))
    # the limiting reason as a one-hot family: exactly one reason label
    # carries 1 (an enum gauge dashboards can alert on without string
    # parsing); the enum matches server/ratekeeper.py LIMIT_REASONS
    reason = qos.get("limiting_reason")
    if reason is not None:
        from ..server.ratekeeper import LIMIT_REASONS
        for r in LIMIT_REASONS:
            f.add(f"{_PREFIX}_qos_limiting_reason", "gauge",
                  "Active Ratekeeper limiting reason (one-hot)",
                  {"reason": r}, int(r == reason))
    for iname, val in sorted((qos.get("inputs") or {}).items()):
        f.add(f"{_PREFIX}_qos_input", "gauge",
              "Ratekeeper decision input signals (RkUpdate)",
              {"input": iname}, val)
    # per-role smoothed saturation signals (the QosSample plane)
    for kind, roles in sorted((qos.get("roles") or {}).items()):
        for rname, signals in sorted(roles.items()):
            for sname, val in sorted(signals.items()):
                if sname == "sampled_at":
                    continue
                f.add(f"{_PREFIX}_qos_signal", "gauge",
                      "Per-role smoothed saturation signals",
                      {"kind": kind, "role": rname, "signal": sname},
                      val)
    # per-tag traffic accounting (the TransactionTagCounter surface)
    for row in qos.get("tags", ()):
        tl = {"tag": row["tag"]}
        f.add(f"{_PREFIX}_tag_busyness", "gauge",
              "Decayed per-tag commit-traffic score", tl,
              row.get("busyness"))
        for c in ("started", "committed", "conflicted"):
            f.add(f"{_PREFIX}_tag_transactions", "counter",
                  "Per-tag transaction outcomes at the proxies",
                  {**tl, "outcome": c}, row.get(c))
    for prio, counts in sorted((qos.get("priorities") or {}).items()):
        for c in ("started", "committed", "conflicted"):
            f.add(f"{_PREFIX}_qos_priority_transactions", "counter",
                  "Per-priority-class transaction outcomes",
                  {"priority": prio, "outcome": c}, counts.get(c))

    # conflict prediction & transaction repair (server/scheduler.py +
    # server/repair.py): armed planes, cluster totals, and the
    # client-side early-abort counters
    sched = cl.get("conflict_scheduling") or {}
    if sched:
        for feat in ("scheduling", "repair", "client_windows"):
            f.add(f"{_PREFIX}_sched_enabled", "gauge",
                  "1 while the named conflict-scheduling plane is armed",
                  {"feature": feat}, sched.get(f"{feat}_enabled"))
        for cname, value in sorted((sched.get("client") or {}).items()):
            if cname == "windows_cached":
                # a level (Counter.set), not a monotone count: typing
                # it counter would make rate() read every decrease as
                # a reset
                f.add(f"{_PREFIX}_sched_client_windows", "gauge",
                      "Hot-key conflict windows currently cached "
                      "client-side", {}, value)
            else:
                f.add(f"{_PREFIX}_sched_client", "counter",
                      "Client-side conflict-window cache counters "
                      "(early aborts, checks, updates)",
                      {"counter": cname}, value)

    # enforced admission control & tag throttling (server/admission.py
    # + server/tag_throttler.py): armed planes, the merged throttle
    # table, the ratekeeper's auto-throttler, and client backoff
    adm = cl.get("admission_control") or {}
    if adm:
        for feat in ("grv_admission", "tag_throttling",
                     "auto_tag_throttling"):
            f.add(f"{_PREFIX}_admission_enabled", "gauge",
                  "1 while the named admission-control plane is armed",
                  {"feature": feat}, adm.get(f"{feat}_enabled"))
        for r in adm.get("throttled_tags", ()):
            tl = {"tag": r["tag"], "priority": r.get("priority", "?"),
                  "auto": str(r.get("auto", 0))}
            f.add(f"{_PREFIX}_throttle_tag_tps", "gauge",
                  "Enforced per-tag transaction rate from the "
                  "throttledTags system keyspace", tl, r.get("tps"))
        f.add(f"{_PREFIX}_throttle_tags", "gauge",
              "Live rows in the tag-throttle table", {},
              len(adm.get("throttled_tags", ())))
        auto = adm.get("auto_throttler") or {}
        f.add(f"{_PREFIX}_throttle_auto_written", "counter",
              "Auto-throttle rows written by the ratekeeper", {},
              auto.get("auto_throttles"))
        f.add(f"{_PREFIX}_throttle_auto_cleared", "counter",
              "Expired auto-throttle rows cleared by the ratekeeper",
              {}, auto.get("auto_cleared"))
        for cname, value in sorted((adm.get("client") or {}).items()):
            if cname == "tags_cached":
                f.add(f"{_PREFIX}_throttle_client_tags", "gauge",
                      "Throttled tags currently cached client-side",
                      {}, value)
            else:
                f.add(f"{_PREFIX}_throttle_client", "counter",
                      "Client-honored backoff counters (local delays "
                      "before tagged GRVs)", {"counter": cname}, value)

    for p in cl.get("proxies", ()):
        _add_counters(f, "proxy", p["name"], p.get("counters"))
        for req, snap in (p.get("latency_bands") or {}).items():
            _add_latency(f, "proxy", p["name"], req, snap)
        pa = p.get("admission") or {}
        if pa:
            alabels = {"role": p["name"]}
            for cls, n in sorted((pa.get("admitted") or {}).items()):
                f.add(f"{_PREFIX}_admission_admitted", "counter",
                      "Transactions admitted through the GRV token "
                      "buckets per priority class",
                      {**alabels, "priority": cls}, n)
            for cls, n in sorted((pa.get("queued") or {}).items()):
                f.add(f"{_PREFIX}_admission_queued", "gauge",
                      "GRV requests currently queued per priority class",
                      {**alabels, "priority": cls}, n)
            for c, help_text in (
                    ("rejected", "GRV requests rejected by the queue "
                                 "depth bound (retryable)"),
                    ("timed_out", "Queued GRV requests shed by the "
                                  "wait bound (retryable)"),
                    ("confirm_rounds", "Causal-confirmation round "
                                       "trips (the GRV batching "
                                       "denominator)")):
                f.add(f"{_PREFIX}_admission_{c}", "counter", help_text,
                      alabels, pa.get(c))
            for c, help_text in (
                    ("delayed", "Tagged GRVs parked by a per-tag "
                                "throttle bucket"),
                    ("released", "Parked GRVs released at the tag's "
                                 "commanded pace"),
                    ("rejected", "Tagged GRVs rejected by the per-tag "
                                 "queue bound (retryable)")):
                f.add(f"{_PREFIX}_throttle_{c}", "counter", help_text,
                      alabels, pa.get(f"throttle_{c}"))
        ps = p.get("scheduler") or {}
        if ps:
            slabels = {"role": p["name"]}
            for c, help_text in (
                    ("deferrals", "Commits captured into per-hot-range "
                                  "deferral queues"),
                    ("released", "Deferred commits released back into "
                                 "the batcher"),
                    ("overflow", "Deferrals refused by the bounded-"
                                 "delay/queue-cap contract"),
                    ("pushes", "Hot-spot pushes received from the CC")):
                f.add(f"{_PREFIX}_sched_{c}", "counter", help_text,
                      slabels, ps.get(c))
            for g, help_text in (
                    ("deferred_now", "Commits currently held deferred"),
                    ("queue_ranges", "Hot ranges with a live deferral "
                                     "queue"),
                    ("hot_rows", "Hot-spot rows in the predictor")):
                f.add(f"{_PREFIX}_sched_{g}", "gauge", help_text,
                      slabels, ps.get(g))
        pr = p.get("repair") or {}
        if pr:
            rlabels = {"role": p["name"]}
            for c, help_text in (
                    ("attempts", "Conflicted transactions captured for "
                                 "server-side repair"),
                    ("committed", "Repairs that committed without a "
                                  "client round trip"),
                    ("conflicted", "Repairs that re-conflicted with the "
                                   "attempt budget exhausted"),
                    ("failed", "Repairs whose resubmission outcome is "
                               "unknown"),
                    ("fallbacks", "Repairs that fell back to the "
                                  "ordinary abort before resubmitting"),
                    ("shed", "Repairs refused by the in-flight cap"),
                    ("reread_rows", "Rows re-read from storage during "
                                    "partial re-execution")):
                f.add(f"{_PREFIX}_repair_{c}", "counter", help_text,
                      rlabels, pr.get(c))
            f.add(f"{_PREFIX}_repair_in_flight", "gauge",
                  "Repairs currently in flight", rlabels,
                  pr.get("in_flight"))
    for r in cl.get("resolvers", ()):
        _add_counters(f, "resolver", r["name"], r.get("counters"))
        for req, snap in (r.get("latency_bands") or {}).items():
            _add_latency(f, "resolver", r["name"], req, snap)
        kern = r.get("kernel") or {}
        if kern:
            f.add(f"{_PREFIX}_resolver_state_rows", "gauge",
                  "Conflict-history rows held by the resolver backend",
                  {"role": r["name"]}, kern.get("state_rows"))
            f.add(f"{_PREFIX}_resolver_state_capacity", "gauge",
                  "Device history capacity (rows)",
                  {"role": r["name"]}, kern.get("capacity"))
            f.add(f"{_PREFIX}_resolver_kernel_batches", "counter",
                  "Batches dispatched through the device kernel",
                  {"role": r["name"]}, kern.get("batches"))
            for dim, occ in (kern.get("occupancy") or {}).items():
                if occ is not None:
                    f.add(f"{_PREFIX}_resolver_kernel_occupancy", "gauge",
                          "Real rows / padded slots per batch dimension",
                          {"role": r["name"], "dim": dim}, occ)
            # feed-path transfer accounting (the packed single-buffer
            # discipline: per_batch == 1 when live, ~12 on the
            # unpacked fallback — counted at _dispatch, not inferred)
            h2d = kern.get("h2d") or {}
            if h2d:
                f.add(f"{_PREFIX}_kernel_h2d_transfers", "counter",
                      "Host->device transfers issued by the resolver "
                      "feed path",
                      {"role": r["name"]}, h2d.get("transfers"))
                f.add(f"{_PREFIX}_kernel_h2d_bytes", "counter",
                      "Bytes moved host->device by the resolver feed "
                      "path",
                      {"role": r["name"]}, h2d.get("bytes"))
                if h2d.get("per_batch") is not None:
                    f.add(f"{_PREFIX}_kernel_h2d_per_batch", "gauge",
                          "H2D transfers per dispatched batch (1 = "
                          "packed single-buffer feed live)",
                          {"role": r["name"]}, h2d.get("per_batch"))
                f.add(f"{_PREFIX}_kernel_h2d_staging_allocs", "counter",
                      "Packed-feed staging buffers allocated (flat in "
                      "steady state: buffers are bucket-reused)",
                      {"role": r["name"]}, h2d.get("staging_allocs"))
            # host phases and waits inside each submit, the batches
            # that took the one-call submit, and the history's exact
            # live rows (kernel_stats()["host"])
            host = kern.get("host") or {}
            for phase, t in sorted((host.get("phases") or {}).items()):
                f.add(f"{_PREFIX}_kernel_host_seconds", "counter",
                      "Host seconds in each phase of the resolver's "
                      "batch submit (submit: the whole call)",
                      {"role": r["name"], "phase": phase},
                      t.get("ns", 0) / 1e9)
            for w, t in sorted((host.get("waits") or {}).items()):
                f.add(f"{_PREFIX}_kernel_host_waits", "counter",
                      "Times the resolver's batch path waited for the "
                      "device, by what it waited for",
                      {"role": r["name"], "wait": w}, t.get("count"))
            if host.get("one_call_batches") is not None:
                f.add(f"{_PREFIX}_kernel_one_call_batches", "counter",
                      "Batches whose host work after the version "
                      "bookkeeping was one native call (the packed feed "
                      "on one card)",
                      {"role": r["name"]}, host.get("one_call_batches"))
            live = host.get("live") or {}
            if live.get("live_samples"):
                f.add(f"{_PREFIX}_kernel_live_rows", "gauge",
                      "Live history rows after the newest batch whose "
                      "exact count reached the host",
                      {"role": r["name"]}, live.get("live_rows_last"))
        pipe = r.get("pipeline") or {}
        if pipe:
            plabels = {"role": r["name"]}
            for g, help_text in (
                    ("depth", "Configured RESOLVE_PIPELINE_DEPTH"),
                    ("in_flight", "Batches submitted but not drained"),
                    ("peak_in_flight",
                     "High-water mark of the in-flight window"),
                    ("occupancy",
                     "Mean in-flight depth over configured depth")):
                f.add(f"{_PREFIX}_resolve_pipeline_{g}", "gauge",
                      help_text, plabels, pipe.get(g))
            for c, help_text in (
                    ("submits", "Batches submitted to the pipeline"),
                    ("drains", "Batch verdicts read back"),
                    ("forced_drains",
                     "Submits that hit the depth backpressure")):
                f.add(f"{_PREFIX}_resolve_pipeline_{c}", "counter",
                      help_text, plabels, pipe.get(c))
            for stage, snap in (pipe.get("latency") or {}).items():
                if snap.get("total"):
                    _add_latency(f, "resolver", r["name"], stage, snap,
                                 stem=f"{_PREFIX}_resolve_pipeline_latency")
        fo = r.get("failover") or {}
        if fo:
            flabels = {"role": r["name"]}
            f.add(f"{_PREFIX}_conflict_failover_on_primary", "gauge",
                  "1 while the device backend serves, 0 after failover",
                  flabels, int(bool(fo.get("on_primary"))))
            f.add(f"{_PREFIX}_conflict_failover_replay_log", "gauge",
                  "Batches in the bounded replay log since the last "
                  "checkpoint", flabels, fo.get("replay_log"))
            f.add(f"{_PREFIX}_conflict_failover_checkpoint_version",
                  "gauge", "Version of the last backend checkpoint",
                  flabels, fo.get("checkpoint_version"))
            for c, help_text in (
                    ("checkpoints", "Backend state checkpoints taken"),
                    ("device_faults", "Simulated/real device faults hit"),
                    ("device_recoveries",
                     "Rebuilds that stayed on a fresh device backend"),
                    ("failovers", "Falls to the CPU fallback backend"),
                    ("replayed_batches",
                     "Batches deterministically replayed during rebuilds"),
                    ("reattaches", "Successful moves back to the device"),
                    ("reattach_failures", "Reattach attempts that faulted")):
                f.add(f"{_PREFIX}_conflict_failover_{c}", "counter",
                      help_text, flabels, fo.get(c))
            sh = fo.get("shadow") or {}
            f.add(f"{_PREFIX}_shadow_resolve_sample", "gauge",
                  "Shadow-validation sampling interval (0 = off)",
                  flabels, sh.get("sample"))
            f.add(f"{_PREFIX}_shadow_resolve_sampled", "counter",
                  "Batches re-resolved on the CPU shadow backend",
                  flabels, sh.get("sampled"))
            f.add(f"{_PREFIX}_shadow_resolve_mismatches", "counter",
                  "Sampled batches whose shadow verdicts DIVERGED "
                  "(corruption-grade)", flabels, sh.get("mismatches"))
        # dynamic resolver split/merge: per-resolver skew
        # surface — owned ranges, state rows, handoff traffic — so a
        # dashboard shows the balancer's effect before and after
        sp = r.get("splits") or {}
        if sp:
            splabels = {"role": r["name"]}
            f.add(f"{_PREFIX}_resolver_split_owned_ranges", "gauge",
                  "Key ranges this resolver currently owns in the "
                  "keyResolvers map", splabels, sp.get("owned_ranges"))
            f.add(f"{_PREFIX}_resolver_split_state_rows", "gauge",
                  "Conflict-history rows held by this resolver's "
                  "backend", splabels, sp.get("state_rows"))
            f.add(f"{_PREFIX}_resolver_split_checkpoints", "counter",
                  "Handoff checkpoints served as split/merge donor",
                  splabels, sp.get("checkpoints_served"))
            f.add(f"{_PREFIX}_resolver_split_installs", "counter",
                  "Handoff pieces grafted in as split/merge recipient",
                  splabels, sp.get("installs"))
    bal = cl.get("resolver_balance") or {}
    if bal:
        f.add(f"{_PREFIX}_resolver_split_enabled", "gauge",
              "1 while the RESOLVER_BALANCE loop is armed", {},
              bal.get("enabled"))
        for c, help_text in (
                ("splits", "Balance-loop range splits (donor -> "
                           "recipient with live state handoff)"),
                ("merges", "Cooled ranges stitched back to their "
                           "former owner"),
                ("releases", "Early former-owner releases (double "
                             "delivery ended before the MVCC window)"),
                ("handoff_timeouts",
                 "Handoffs that fell back to window-only semantics")):
            f.add(f"{_PREFIX}_resolver_split_{c}", "counter", help_text,
                  {}, bal.get(c))
    for lg in cl.get("logs", ()):
        _add_counters(f, "tlog", lg.get("store", "?"), lg.get("counters"))
        f.add(f"{_PREFIX}_tlog_queue_length", "gauge",
              "Unpopped log entries", {"role": lg.get("store", "?")},
              lg.get("queue_length"))
        for req, snap in (lg.get("latency_bands") or {}).items():
            _add_latency(f, "tlog", lg.get("store", "?"), req, snap)
    seen_reps: set = set()
    for s in cl.get("storages", ()):
        for rep in s.get("replicas", ()):
            # the storages list is per SHARD; a server hosting several
            # shards carries the same snapshot in each entry
            if rep["name"] in seen_reps or "counters" not in rep:
                continue
            seen_reps.add(rep["name"])
            _add_counters(f, "storage", rep["name"], rep.get("counters"))
            for req, snap in (rep.get("latency_bands") or {}).items():
                _add_latency(f, "storage", rep["name"], req, snap)
            # the storage heat plane's per-server meters:
            # sampled shard bytes + smoothed write/read bandwidth and
            # read ops (read meters sit at zero while the plane is off
            # — the families stay, so dashboards are stable)
            slabels = {"role": rep["name"]}
            f.add(f"{_PREFIX}_storage_shard_bytes", "gauge",
                  "Sampled logical bytes per storage replica "
                  "(byteSample estimator)", slabels,
                  rep.get("sampled_bytes"))
            f.add(f"{_PREFIX}_storage_write_bandwidth", "gauge",
                  "Smoothed write bytes/sec into the shard", slabels,
                  rep.get("write_bytes_per_sec"))
            f.add(f"{_PREFIX}_storage_read_bytes", "gauge",
                  "Smoothed read bytes/sec out of the shard "
                  "(STORAGE_HEAT_TRACKING)", slabels,
                  rep.get("read_bytes_per_sec"))
            f.add(f"{_PREFIX}_storage_read_ops", "gauge",
                  "Smoothed key reads/sec (point reads + range rows)",
                  slabels, rep.get("read_ops_per_sec"))

    # the storage heat rollup: read-hot sub-ranges (decayed
    # read-bandwidth score per flagged range) + per-server busiest
    # read tag
    heat = cl.get("storage_heat") or {}
    if heat:
        f.add(f"{_PREFIX}_storage_heat_tracking", "gauge",
              "1 while STORAGE_HEAT_TRACKING is armed", {},
              heat.get("tracking_enabled"))
        for i, row in enumerate(heat.get("ranges", ())):
            hlabels = {"rank": str(i), "server": row["server"],
                       "begin": row["begin"], "end": row["end"]}
            f.add(f"{_PREFIX}_storage_read_hot_ranges", "gauge",
                  "Read-hot sub-ranges: decayed read bytes/sec per "
                  "flagged range (density in the density label set)",
                  hlabels, row.get("read_bps"))
            f.add(f"{_PREFIX}_storage_read_hot_density", "gauge",
                  "Read-bandwidth / sampled-byte density ratio vs the "
                  "shard's own density", hlabels, row.get("density"))
        for row in heat.get("busiest_read_tags", ()):
            f.add(f"{_PREFIX}_storage_tag_busyness", "gauge",
                  "Busiest read tag per storage server (decayed "
                  "read-cost score)",
                  {"server": row["server"], "tag": row["tag"]},
                  row.get("busyness"))

    # process-wide kernel profile: the profiled entries'
    # "family[shape].counter" keys, and "launches.<kernel>" (a CUDA
    # kernel's launches in this process), labeled kernel=<kernel>,
    # counter="launches"
    for key, value in sorted((cl.get("kernels") or {}).items()):
        if key.startswith("launches."):
            kernel, counter = key[len("launches."):], "launches"
        else:
            kernel, _, counter = key.rpartition(".")
        f.add(f"{_PREFIX}_kernel_profile", "counter",
              "Kernel execute and launch accounting per shape bucket",
              {"kernel": kernel or key, "counter": counter}, value)

    probe = cl.get("latency_probe") or {}
    for field, stage in (("transaction_start_seconds", "grv"),
                         ("read_seconds", "read"),
                         ("commit_seconds", "commit")):
        f.add(f"{_PREFIX}_latency_probe_seconds", "gauge",
              "Last cluster-controller probe transaction latencies",
              {"stage": stage}, probe.get(field))
    f.add(f"{_PREFIX}_latency_probe_rounds", "counter",
          "Probe rounds completed", {}, probe.get("rounds"))
    for stage, snap in (probe.get("bands") or {}).items():
        _add_latency(f, "probe", "cluster_controller", stage, snap)

    for i, row in enumerate(cl.get("conflict_hot_spots", ())):
        labels = {"rank": str(i), "begin": row["begin"],
                  "end": row["end"]}
        f.add(f"{_PREFIX}_conflict_hot_spot_score", "gauge",
              "Decayed conflict-attribution score per key range", labels,
              row["score"])
        f.add(f"{_PREFIX}_conflict_hot_spot_total", "counter",
              "Raw attributed-conflict count per key range", labels,
              row["total"])

    # the chaos plane's shared fault accounting (server/chaos.py):
    # injected-fault totals per kind + per-scenario run counts, so a
    # dashboard can confirm a storm actually fired without trace greps
    chaos = cl.get("chaos") or {}
    for kind, n in sorted((chaos.get("injected") or {}).items()):
        f.add(f"{_PREFIX}_chaos_injected", "counter",
              "Injected chaos faults by kind (network, disk, kills, "
              "device seams)", {"kind": kind}, n)
    for sc, n in sorted((chaos.get("scenarios") or {}).items()):
        f.add(f"{_PREFIX}_chaos_scenario_runs", "counter",
              "Chaos scenario storms started, by scenario name",
              {"scenario": sc}, n)
    if chaos:
        f.add(f"{_PREFIX}_chaos_events", "counter",
              "Total recorded chaos events", {}, chaos.get("events"))
        f.add(f"{_PREFIX}_chaos_messages_dropped", "counter",
              "Messages dropped by kills/partitions", {},
              chaos.get("messages_dropped"))
        f.add(f"{_PREFIX}_chaos_messages_duplicated", "counter",
              "One-way datagrams duplicated by swizzled links", {},
              chaos.get("messages_duplicated"))

    # the SLO engine's verdict (server/slo.py, METRIC_HISTORY armed):
    # overall state + per-rule ok/value so a dashboard alerts on the
    # same burn-rate math the cluster controller evaluates in-process
    slo = cl.get("slo") or {}
    if slo.get("enabled"):
        f.add(f"{_PREFIX}_slo_ok", "gauge",
              "1 when every SLO rule currently holds, 0 on breach", {},
              1 if slo.get("state") == "ok" else 0)
        f.add(f"{_PREFIX}_slo_breaches", "counter",
              "ok->breach transitions seen by the online SLO engine",
              {}, slo.get("breaches"))
        f.add(f"{_PREFIX}_slo_timekeeper_rows", "counter",
              "version<->wallclock rows committed by the TimeKeeper",
              {}, slo.get("timekeeper_rows"))
        rec = slo.get("recorder") or {}
        f.add(f"{_PREFIX}_slo_metric_rows", "counter",
              "Metric-history chunk rows flushed to the keyspace", {},
              rec.get("rows_written"))
        for r in slo.get("rules", ()):
            rl = {"rule": r.get("name", "?")}
            f.add(f"{_PREFIX}_slo_rule_ok", "gauge",
                  "1 while this SLO rule holds, 0 while breached", rl,
                  1 if r.get("ok") else 0)
            if r.get("value") is not None:
                f.add(f"{_PREFIX}_slo_rule_value", "gauge",
                      "Current evaluated value for this SLO rule "
                      "(fixed-point: floats scaled x1000)", rl,
                      r.get("value"))

    # the latency-forensics plane (CRITICAL_PATH armed):
    # commit critical-path decomposition — per-station seconds with a
    # wait/service split where the serving side keeps one, dominant-
    # station attribution, the decaying top-cause table, and the
    # telescoping-sum residual bound
    cp = cl.get("critical_path") or {}
    if cp.get("enabled"):
        f.add(f"{_PREFIX}_path_samples_total", "counter",
              "Commits decomposed into critical-path stations", {},
              cp.get("samples"))
        f.add(f"{_PREFIX}_path_residual_seconds_max", "gauge",
              "Largest |sum(stations) - end_to_end| seen (the "
              "telescoping-decomposition error bound)", {},
              cp.get("max_residual_seconds"))
        for s, n in sorted((cp.get("dominant") or {}).items()):
            f.add(f"{_PREFIX}_path_dominant_total", "counter",
                  "Decomposed commits whose largest segment was this "
                  "station", {"station": s}, n)
        for s, v in sorted((cp.get("station_seconds") or {}).items()):
            f.add(f"{_PREFIX}_path_station_seconds_total", "counter",
                  "Cumulative seconds attributed per pipeline station "
                  "(kind: total from the proxy decomposition, "
                  "wait/service from the serving role's split)",
                  {"station": s, "kind": "total"}, v)
        for station, split in sorted((cp.get("splits") or {}).items()):
            for kind in ("wait", "service"):
                f.add(f"{_PREFIX}_path_station_seconds_total", "counter",
                      "Cumulative seconds attributed per pipeline "
                      "station (kind: total from the proxy "
                      "decomposition, wait/service from the serving "
                      "role's split)",
                      {"station": station, "kind": kind},
                      (split.get(kind) or {}).get("sum_seconds"))
        for i, row in enumerate(cp.get("top", ())):
            f.add(f"{_PREFIX}_path_cause_score", "gauge",
                  "Decaying dominant-cause score per station (rank 0 "
                  "= the cluster's current primary latency cause)",
                  {"rank": str(i), "station": row.get("station", "?")},
                  row.get("score"))

    # per-process resource telemetry: the host's sample
    # here; every worker's rides the federated render
    pm = cl.get("process_metrics") or {}
    if pm.get("enabled"):
        _add_process_metrics(f, pm.get("host") or {})
        for role, share in sorted((pm.get("role_cpu_share")
                                   or {}).items()):
            f.add(f"{_PREFIX}_process_role_cpu_share", "gauge",
                  "Run-loop busy-time share per sim role inside this "
                  "host process (SIM_TASK_STATS fold)",
                  {"sim_role": role}, share)

    msgs = cl.get("messages", ())
    f.add(f"{_PREFIX}_health_messages", "gauge",
          "Active health messages in the status rollup", {}, len(msgs))
    # aggregate per (name, severity): two lagging storages would
    # otherwise emit identical label sets, which a real Prometheus
    # server rejects as duplicate samples — failing the whole scrape
    # exactly when the cluster is unhealthy
    by_kind: dict = {}
    for m in msgs:
        key = (m.get("name", "?"), str(m.get("severity", 0)))
        by_kind[key] = by_kind.get(key, 0) + 1
    for (name, severity), count in sorted(by_kind.items()):
        f.add(f"{_PREFIX}_health_message", "gauge",
              "Active conditions per health-message kind",
              {"name": name, "severity": severity}, count)

    rl = cl.get("run_loop") or {}
    f.add(f"{_PREFIX}_run_loop_tasks", "counter",
          "Scheduler tasks executed", {}, rl.get("tasks_run"))
    f.add(f"{_PREFIX}_run_loop_busy_seconds", "counter",
          "Scheduler busy time", {}, rl.get("busy_seconds"))
    # run-loop slow-task profiler (flow/scheduler.py SlowTask events)
    f.add(f"{_PREFIX}_run_loop_slow_tasks", "counter",
          "Steps that exceeded SLOW_TASK_THRESHOLD", {},
          rl.get("slow_task_count"))
    f.add(f"{_PREFIX}_run_loop_slow_task_threshold_seconds", "gauge",
          "Active slow-task threshold", {},
          rl.get("slow_task_threshold"))
    worst: dict = {}   # the same task label may recur: keep its worst
    for t in rl.get("slow_tasks", ()):
        prev = worst.get(t["task"])
        if prev is None or t["seconds"] > prev[0]:
            worst[t["task"]] = (t["seconds"], t.get("stack", "?"))
    for task, (seconds, stack) in sorted(worst.items()):
        f.add(f"{_PREFIX}_run_loop_slow_task_seconds", "gauge",
              "Worst run-loop steps by task label (stack = coroutine "
              "suspension stack at the slow step)",
              {"task": task, "stack": stack}, seconds)

    # sim-perf attribution plane (SIM_TASK_STATS — flow/scheduler.py
    # task table + rpc/network.py message accounting): the fdbtpu_sim_*
    # wall-vs-sim headline, the fdbtpu_task_* attribution families, and
    # the fdbtpu_net_* message families
    f.add(f"{_PREFIX}_sim_seconds", "counter",
          "Simulated seconds elapsed on the run loop's timeline", {},
          rl.get("sim_seconds"))
    f.add(f"{_PREFIX}_sim_per_busy_second", "gauge",
          "Sim seconds advanced per busy wall second (the sim-scale "
          "headline)", {}, rl.get("sim_per_busy"))
    ts = rl.get("task_stats") or {}
    if ts:
        f.add(f"{_PREFIX}_sim_task_stats_armed", "gauge",
              "1 while per-task run-loop attribution is armed", {},
              ts.get("armed"))
        f.add(f"{_PREFIX}_task_names_dropped", "counter",
              "Task-stat folds routed to the (other) bucket by the "
              "table bound", {}, ts.get("dropped_names"))
    for row in ts.get("tasks", ()):
        tl = {"task": row["task"]}
        f.add(f"{_PREFIX}_task_steps", "counter",
              "Run-loop steps per task family (SIM_TASK_STATS)", tl,
              row.get("steps"))
        f.add(f"{_PREFIX}_task_busy_us", "counter",
              "Cumulative step wall-microseconds per task family", tl,
              row.get("busy_us"))
        f.add(f"{_PREFIX}_task_max_step_us", "gauge",
              "Worst single step per task family (µs)", tl,
              row.get("max_us"))
    for row in ts.get("bands", ()):
        bl = {"band": row["band"]}
        f.add(f"{_PREFIX}_task_band_steps", "counter",
              "Run-loop steps per TaskPriority band", bl,
              row.get("steps"))
        f.add(f"{_PREFIX}_task_band_busy_us", "counter",
              "Cumulative step wall-microseconds per TaskPriority band",
              bl, row.get("busy_us"))
    netdoc = cl.get("network") or {}
    if netdoc:
        for row in netdoc.get("types", ()):
            f.add(f"{_PREFIX}_net_messages", "counter",
                  "Sim-network messages delivered, by request type "
                  "(armed with SIM_TASK_STATS)", {"type": row["type"]},
                  row.get("count"))
        f.add(f"{_PREFIX}_net_messages_sent", "counter",
              "Total sim-network messages sent", {},
              netdoc.get("messages_sent"))
        f.add(f"{_PREFIX}_net_messages_dropped", "counter",
              "Messages dropped by kills/partitions", {},
              netdoc.get("messages_dropped"))
        f.add(f"{_PREFIX}_net_messages_duplicated", "counter",
              "Datagrams duplicated by swizzled links", {},
              netdoc.get("messages_duplicated"))
        f.add(f"{_PREFIX}_net_delivery_timers", "gauge",
              "Scheduler timer-heap population (in-flight deliveries "
              "+ role timers)", {}, netdoc.get("timers_now"))
        f.add(f"{_PREFIX}_net_ready_tasks", "gauge",
              "Runnable task backlog on the scheduler ready heap", {},
              netdoc.get("ready_now"))

    # client transaction-profiling sampler (client/profiling.py,
    # process-wide like the kernel profile)
    for cname, value in sorted((cl.get("client_profile") or {}).items()):
        f.add(f"{_PREFIX}_client_profile", "counter",
              "Sampled-transaction profiler counters",
              {"counter": cname}, value)
    return f.render() if own else ""


# ------------------------------------------------------- federation
# Federation: every worker OS process serves a StatusRequest endpoint
# (tools/clusterbench.py run_worker) and drops a proc.<role>.<pid>.json
# discovery stub in the shared run directory. The helpers below read
# the stubs, fetch the per-process docs over real TCP, fold them into
# one `cluster.processes` status section, and render ONE Prometheus
# scrape where every sample carries process="role:pid" labels.

def _render_worker_doc(doc: dict, f: _Families) -> None:
    """One worker-process status doc (clusterbench worker_status shape)
    into the shared family accumulator. `f.extra` already carries the
    process label."""
    labels = {"role": doc.get("role", "?")}
    f.add(f"{_PREFIX}_process_up", "gauge",
          "1 while the worker process answers StatusRequest",
          labels, doc.get("up", 1))
    f.add(f"{_PREFIX}_process_uptime_seconds", "gauge",
          "Worker uptime since its workload started", labels,
          doc.get("uptime_s"))
    for cname, value in sorted((doc.get("counters") or {}).items()):
        if isinstance(value, (int, float)):
            f.add(f"{_PREFIX}_worker_txn", "counter",
                  "Per-worker workload transaction outcomes",
                  {**labels, "counter": cname}, value)
    for req in ("grv", "commit"):
        snap = doc.get(req) or {}
        for q, value in sorted(snap.items()):
            # clusterbench _lat_ms shape: p50_ms/p95_ms/... gauges
            if q.endswith("_ms") and isinstance(value, (int, float)):
                f.add(f"{_PREFIX}_worker_latency_ms", "gauge",
                      "Per-worker request-latency percentiles "
                      "(milliseconds)",
                      {**labels, "request": req,
                       "quantile": q[:-3]}, value)
    # per-process resource telemetry — .get throughout:
    # a worker running an OLDER build has no process_metrics section,
    # and the federated scrape must render it with defaults, not fail
    # (version-skew tolerance)
    _add_process_metrics(f, doc.get("process_metrics") or {})
    fr = doc.get("flightrec") or {}
    if fr:
        f.add(f"{_PREFIX}_flightrec_buffered", "gauge",
              "Trace events currently held in the flight-recorder "
              "ring", labels, fr.get("buffered"))
        f.add(f"{_PREFIX}_flightrec_noted_total", "counter",
              "Trace events ever filed into the flight recorder",
              labels, fr.get("noted"))
        f.add(f"{_PREFIX}_flightrec_dumps_total", "counter",
              "Flight-recorder dumps written by this process", labels,
              fr.get("dumps"))


def render_federated(host_status: dict, procs: List[dict],
                     host_process: str = "cluster-host") -> str:
    """One Prometheus scrape for the whole multi-process cluster: the
    host CC status document plus every worker doc, each sample labelled
    with its process identity. One accumulator keeps one HELP/TYPE
    header per family even when several processes emit it."""
    f = _Families()
    if host_status:
        f.extra = {"process": host_process}
        render_prometheus(host_status, f=f)
    for doc in procs or ():
        f.extra = {"process": str(doc.get("process", "?"))}
        _render_worker_doc(doc, f)
    f.extra = {}
    f.add(f"{_PREFIX}_federated_processes", "gauge",
          "Processes folded into this scrape (host + workers)", {},
          (1 if host_status else 0) + len(procs or ()))
    # cross-process role CPU share: host in-process fold
    # weighted by host cpu_seconds plus every worker/role process's
    # measured cpu_seconds under its role
    from ..server.process_metrics import federated_role_cpu_share
    pm = ((host_status or {}).get("cluster") or {}) \
        .get("process_metrics") or {}
    for role, share in federated_role_cpu_share(
            pm.get("role_cpu_share"),
            (pm.get("host") or {}).get("cpu_seconds"),
            list(procs or ())).items():
        f.add(f"{_PREFIX}_federated_role_cpu_share", "gauge",
              "CPU-seconds share per role across every OS process in "
              "the deployment (host sim-fold x host CPU + each "
              "worker/role process's own CPU)", {"role": role}, share)
    return f.render()


#: sections every federated process doc is normalized to carry —
#: version-skew tolerance: a worker running an OLDER build (or a
#: tombstone for a dead one) simply lacks the newer sections, and the
#: consumers (cli, exporter, soak timeline) must see defaults, never
#: a KeyError
_PROC_DOC_DEFAULTS = (
    ("role", "?"), ("pid", None), ("up", 1), ("uptime_s", None),
    ("counters", {}), ("grv", {}), ("commit", {}),
    ("process_metrics", {}), ("flightrec", {}),
)


def normalize_proc_doc(p: dict) -> dict:
    """Fill a worker status doc's missing sections with defaults (a
    fresh dict per doc — shared mutable defaults would alias)."""
    out = dict(p or {})
    for key, default in _PROC_DOC_DEFAULTS:
        if key not in out:
            out[key] = dict(default) if isinstance(default, dict) \
                else default
    return out


def federate_status(host_status: dict, procs: List[dict],
                    host_process: str = "cluster-host") -> dict:
    """Fold per-process docs into the host status document under
    `cluster.processes` (one section, keyed by "role:pid"), mirroring
    the reference `status json` processes map. Docs are normalized
    first (normalize_proc_doc), so a mixed-version cluster federates
    cleanly."""
    import copy
    doc = copy.deepcopy(host_status or {})
    cl = doc.setdefault("cluster", {})
    cl["processes"] = {str(p.get("process", f"?:{i}")):
                       normalize_proc_doc(p)
                       for i, p in enumerate(procs or ())}
    from ..server.process_metrics import federated_role_cpu_share
    pm = cl.get("process_metrics") or {}
    cl["federation"] = {"host_process": host_process,
                        "process_count": 1 + len(procs or ()),
                        "role_cpu_share": federated_role_cpu_share(
                            pm.get("role_cpu_share"),
                            (pm.get("host") or {}).get("cpu_seconds"),
                            list(cl["processes"].values()))}
    return doc


def read_proc_files(run_dir: str) -> List[dict]:
    """The proc.<role>.<pid>.json discovery stubs in a run dir (sorted
    by filename; unreadable stubs are skipped, not fatal — a worker may
    die mid-write)."""
    import json
    import os
    out: List[dict] = []
    try:
        names = sorted(os.listdir(run_dir))
    except OSError:
        return out
    for fn in names:
        if not (fn.startswith("proc.") and fn.endswith(".json")):
            continue
        try:
            with open(os.path.join(run_dir, fn)) as fh:
                out.append(json.load(fh))
        except (OSError, ValueError):
            continue
    return out


def fetch_process_docs(run_dir: str, *, timeout: float = 5.0,
                       stubs: List[dict] = None) -> List[dict]:
    """Fetch every discovered worker's status doc over real TCP. A
    worker that no longer answers yields an `up: 0` tombstone carrying
    its stub identity, so the federated scrape shows the gap instead
    of silently shrinking. Hosts its own wall-clock loop; the ambient
    scheduler/RNG are restored on exit (the networktest discipline)."""
    from .. import flow
    from ..flow import rng as _rng
    from ..rpc.tcp import TcpTransport
    from ..server.types import STATUS_REQUEST
    if stubs is None:
        stubs = read_proc_files(run_dir)
    if not stubs:
        return []
    prev_sched = flow.get_scheduler()
    prev_rng = _rng.rng_state()
    transport = None
    try:
        flow.set_seed(0)
        s = flow.Scheduler(virtual=False)
        flow.set_scheduler(s)
        transport = TcpTransport()

        async def fetch_one(stub: dict) -> dict:
            ref = transport.ref(stub.get("host", "127.0.0.1"),
                                int(stub["port"]),
                                int(stub["status_token"]))
            try:
                doc = await flow.timeout_error(
                    ref.get_reply(STATUS_REQUEST), timeout)
            except flow.FdbError:
                return {"process": stub.get("name", "?"),
                        "role": stub.get("role", "?"),
                        "pid": stub.get("pid"), "up": 0}
            doc = dict(doc)
            doc.setdefault("process", stub.get("name", "?"))
            doc["up"] = 1
            return doc

        async def main():
            transport.start()
            return list(await flow.wait_for_all(
                [flow.spawn(fetch_one(st)) for st in stubs]))

        t = s.spawn(main())
        return s.run(until=t, timeout_time=timeout * len(stubs) + 30)
    finally:
        if transport is not None:
            transport.close()
        flow.set_scheduler(prev_sched)
        _rng.restore_rng_state(prev_rng)


_ESCAPES = {"\\": "\\", '"': '"', "n": "\n"}


def parse_prometheus(text: str) -> List[Tuple[str, dict, float]]:
    """Exposition-format parser: [(name, labels, value)]. Raises
    ValueError on a malformed line — the CI smoke and the tests use it
    as the well-formedness check. Label values are scanned with full
    escape awareness (the format's \\\\, \\" and \\n sequences), so a
    tag, signal or stack label carrying a quote, comma, brace or
    newline round-trips through _esc exactly — the old tokenizer split
    the body on commas and never unescaped, silently corrupting any
    such value."""
    out: List[Tuple[str, dict, float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        labels: dict = {}
        if "{" in line:
            name, _, body = line.partition("{")
            i, n = 0, len(body)
            while True:
                if i >= n:
                    raise ValueError(f"unterminated label set: {line!r}")
                if body[i] == "}":
                    break
                j = body.find("=", i)
                if j < 0:
                    raise ValueError(f"label without '=': {line!r}")
                key = body[i:j].strip()
                i = j + 1
                if i >= n or body[i] != '"':
                    raise ValueError(f"unquoted label value: {line!r}")
                i += 1
                buf: List[str] = []
                while i < n and body[i] != '"':
                    c = body[i]
                    if c == "\\":
                        if i + 1 >= n:
                            raise ValueError(
                                f"dangling escape: {line!r}")
                        nxt = body[i + 1]
                        if nxt not in _ESCAPES:
                            raise ValueError(
                                f"bad escape \\{nxt}: {line!r}")
                        buf.append(_ESCAPES[nxt])
                        i += 2
                    else:
                        buf.append(c)
                        i += 1
                if i >= n:
                    raise ValueError(
                        f"unterminated label value: {line!r}")
                labels[key] = "".join(buf)
                i += 1          # closing quote
                if i < n and body[i] == ",":
                    i += 1
            value = body[i + 1:].strip()
        else:
            name, _, value = line.partition(" ")
            value = value.strip()
        if not name or not name.replace("_", "").replace(":", "") \
                .isalnum():
            raise ValueError(f"bad metric name: {line!r}")
        out.append((name, labels, float(value)))
    return out


class ExporterServer:
    """Tiny threaded HTTP server for GET /metrics. `get_text` runs on
    the serving thread — pass something thread-safe (for a live
    cluster, a RemoteCluster-backed closure; in tests, a canned
    string)."""

    def __init__(self, get_text: Callable[[], str], host: str = "127.0.0.1",
                 port: int = 0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — stdlib API
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                try:
                    body = exporter.get_text().encode()
                except Exception as e:  # noqa: BLE001 — scrape fails, server lives
                    self.send_error(500, explain=str(e))
                    return
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self.get_text = get_text
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    connect = None
    federate = None
    listen_port = 9090
    once = False
    while argv:
        a = argv.pop(0)
        if a == "--connect":
            connect = argv.pop(0)
        elif a == "--federate":
            federate = argv.pop(0)   # a run dir with proc.*.json stubs
        elif a == "--listen-port":
            listen_port = int(argv.pop(0))
        elif a == "--once":
            once = True   # print one scrape and exit (smoke / cron)
    if connect is None and federate is None:
        print("usage: exporter (--connect host:port | --federate "
              "run_dir) [--listen-port N] [--once]", file=sys.stderr)
        return 2
    if federate is not None and connect is None:
        # federate-only: fold every live worker in the run dir into
        # one scrape (no host CC — e.g. scraping a soak's workers)
        def scrape() -> str:
            return render_federated({}, fetch_process_docs(federate))

        if once:
            print(scrape(), end="")
            return 0
        server = ExporterServer(scrape, port=listen_port)
        server.start()
        print(f"serving /metrics on :{server.port}", flush=True)
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            pass
        finally:
            server.close()
        return 0
    from ..client.remote import RemoteCluster
    host, _, port = connect.partition(":")
    remote = RemoteCluster(host or "127.0.0.1", int(port))

    def scrape() -> str:
        status = remote.call(remote.db.get_status())
        if federate is not None:
            return render_federated(status,
                                    fetch_process_docs(federate))
        return render_prometheus(status)

    try:
        if once:
            print(scrape(), end="")
            return 0
        server = ExporterServer(scrape, port=listen_port)
        server.start()
        print(f"serving /metrics on :{server.port}", flush=True)
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            pass
        finally:
            server.close()
        return 0
    finally:
        remote.close()


if __name__ == "__main__":
    sys.exit(main())
