"""The reference's tests/test_exporter.py on the port.

Prometheus exporter: status -> text exposition format -> parse.

Ref: the fdb-exporter pattern (scrape `status json`, re-emit as
Prometheus metrics); here the render is first-party and must stay
parseable — the parse_prometheus round trip is the same well-formedness
gate the CI smoke runs against a live cluster."""

import urllib.request

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch.tools.exporter import (ExporterServer,
                                                   parse_prometheus,
                                                   render_prometheus)


def _canned_status():
    return {"cluster": {
        "epoch": 3,
        "recovery_state": "fully_recovered",
        "qos": {
            "transactions_per_second_limit": 1000.0,
            "batch_transactions_per_second_limit": 500.0,
            "limiting_reason": "storage_queue",
            "inputs": {"worst_storage_queue_bytes": 2048.5,
                       "worst_tlog_queue_bytes": 100.0,
                       "worst_durability_lag_versions": 0,
                       "pipeline_occupancy": 0.75,
                       "pipeline_forced_drain_rate": 1.25,
                       "dead_replicas": 0},
            "roles": {
                "storage": {"storage-0-r0": {
                    "queue_bytes": 2048.5, "durability_lag_versions": 3.0,
                    "read_rate": 12.5, "mutation_rate": 40.0,
                    "sampled_at": 9.5}},
                "proxy": {"proxy-e3-0": {
                    "grv_queue_depth": 1.5, "commit_batch_occupancy": 4.0,
                    "resolve_in_flight": 2, "grv_rate": 80.0,
                    "commit_rate": 75.0, "tps_budget": 1000.0,
                    "sampled_at": 9.5}}},
            "tags": [{"tag": "776562", "busyness": 3.5, "started": 10,
                      "committed": 8, "conflicted": 2}],
            "priorities": {
                "batch": {"started": 3, "committed": 2, "conflicted": 0},
                "default": {"started": 9, "committed": 8,
                            "conflicted": 1},
                "immediate": {"started": 0, "committed": 0,
                              "conflicted": 0}}},
        "proxies": [{
            "name": "proxy-e3-0",
            "counters": {"transactions_committed": 42,
                         "transactions_conflicted": 7},
            "latency_bands": {"commit": {
                "total": 49, "max_seconds": 0.2,
                "p50": 0.01, "p90": 0.05, "p99": 0.1,
                "bands": {"<=0.005s": 10, "<=0.1s": 45}}}}],
        "resolvers": [{
            "name": "resolver-e3-0",
            "counters": {"batches_resolved": 12},
            "latency_bands": {"resolve": {"total": 12, "bands": {}}},
            "hot_spots": [],
            "kernel": {"backend": "cuda", "platform": "cpu",
                       "capacity": 1024, "state_rows": 17, "batches": 12,
                       "occupancy": {"txn": 0.5, "read": None}}}],
        "logs": [{"store": "tlog-e3-0", "queue_length": 2,
                  "counters": {"commits": 30},
                  "latency_bands": {"commit": {"total": 30, "bands": {}}}}],
        "storages": [
            {"tag": 0, "replicas": [
                {"name": "storage-0-r0", "counters": {"get_queries": 5},
                 "latency_bands": {"read": {"total": 5, "bands": {}}}}]},
            # same server under a second shard: must not double-emit
            {"tag": 1, "replicas": [
                {"name": "storage-0-r0", "counters": {"get_queries": 5},
                 "latency_bands": {"read": {"total": 5, "bands": {}}}}]}],
        "kernels": {"resolve[1024c/16t/32r/32w].compiles": 1,
                    "resolve[1024c/16t/32r/32w].calls": 12},
        "latency_probe": {"transaction_start_seconds": 0.001,
                          "read_seconds": 0.002, "commit_seconds": 0.01,
                          "rounds": 4, "probed_at": 12.0,
                          "bands": {"grv": {"total": 4, "bands": {}}}},
        "conflict_hot_spots": [
            {"begin": "686f74", "end": "686f7400", "score": 2.5,
             "total": 6}],
        "messages": [{"name": "high_conflict_rate", "severity": 30,
                      "description": "x"}],
        "run_loop": {"tasks_run": 1000, "busy_seconds": 0.5},
    }}


def test_render_is_parseable_and_covers_roles():
    text = render_prometheus(_canned_status())
    samples = parse_prometheus(text)
    names = {n for n, _, _ in samples}
    for need in ("fdbtpu_cluster_epoch", "fdbtpu_role_counter",
                 "fdbtpu_request_latency_seconds_bucket",
                 "fdbtpu_request_latency_seconds_count",
                 "fdbtpu_kernel_profile", "fdbtpu_latency_probe_seconds",
                 "fdbtpu_conflict_hot_spot_score",
                 "fdbtpu_health_message", "fdbtpu_resolver_state_rows"):
        assert need in names, (need, sorted(names))
    # one sample per (name, labelset): duplicates are a scrape error
    keys = [(n, tuple(sorted(l.items()))) for n, l, _ in samples]
    assert len(keys) == len(set(keys))
    # roles from every section are labeled
    roles = {l.get("role") for n, l, _ in samples
             if n == "fdbtpu_role_counter"}
    assert {"proxy-e3-0", "resolver-e3-0", "tlog-e3-0",
            "storage-0-r0"} <= roles


def test_qos_and_tag_families_round_trip():
    """The QoS plane through the parser round trip: budgets, the
    one-hot limiting-reason enum, RkUpdate input signals, the per-role
    QosSample surface, and the tag/priority traffic families — every
    value must survive render -> parse bit-exactly, with no duplicate
    (name, labelset) pairs (already pinned suite-wide above)."""
    qos = _canned_status()["cluster"]["qos"]
    samples = parse_prometheus(render_prometheus(_canned_status()))
    names = {n for n, _, _ in samples}
    for need in ("fdbtpu_qos_transactions_per_second_limit",
                 "fdbtpu_qos_batch_transactions_per_second_limit",
                 "fdbtpu_qos_limiting_reason", "fdbtpu_qos_input",
                 "fdbtpu_qos_signal", "fdbtpu_tag_busyness",
                 "fdbtpu_tag_transactions",
                 "fdbtpu_qos_priority_transactions"):
        assert need in names, (need, sorted(names))
    # limiting reason is a one-hot enum over the full vocabulary
    from foundationdb_tpu_torch.server.ratekeeper import LIMIT_REASONS
    hot = {l["reason"]: v for n, l, v in samples
           if n == "fdbtpu_qos_limiting_reason"}
    assert set(hot) == set(LIMIT_REASONS)
    assert hot["storage_queue"] == 1 and sum(hot.values()) == 1
    # every decision input rides with its value intact
    inputs = {l["input"]: v for n, l, v in samples
              if n == "fdbtpu_qos_input"}
    assert inputs == qos["inputs"]
    # per-role signals keep (kind, role, signal) labels; sampled_at is
    # bookkeeping, not a metric
    sig = {(l["kind"], l["role"], l["signal"]): v
           for n, l, v in samples if n == "fdbtpu_qos_signal"}
    assert sig[("storage", "storage-0-r0", "queue_bytes")] == 2048.5
    assert sig[("proxy", "proxy-e3-0", "commit_batch_occupancy")] == 4.0
    assert not any(s == "sampled_at" for _k, _r, s in sig)
    assert len(sig) == 10    # 4 storage + 6 proxy signals
    # tag family: busyness gauge + one counter per outcome
    (busy,) = [v for n, l, v in samples
               if n == "fdbtpu_tag_busyness" and l["tag"] == "776562"]
    assert busy == 3.5
    tag_counts = {l["outcome"]: v for n, l, v in samples
                  if n == "fdbtpu_tag_transactions"
                  and l["tag"] == "776562"}
    assert tag_counts == {"started": 10, "committed": 8, "conflicted": 2}
    prio = {(l["priority"], l["outcome"]): v for n, l, v in samples
            if n == "fdbtpu_qos_priority_transactions"}
    assert prio[("default", "committed")] == 8
    assert prio[("immediate", "started")] == 0   # zeros still emitted


def test_histogram_buckets_are_cumulative_with_inf():
    text = render_prometheus(_canned_status())
    buckets = [(l["le"], v) for n, l, v in parse_prometheus(text)
               if n == "fdbtpu_request_latency_seconds_bucket"
               and l.get("role") == "proxy-e3-0"]
    by_le = dict(buckets)
    assert by_le["+Inf"] == 49
    assert by_le["0.005"] == 10 and by_le["0.1"] == 45


def test_histogram_well_formed_round_trip():
    """The full Prometheus histogram contract, verified through a
    parser round trip over a LIVE LatencyBands recording: buckets
    cumulative and ordered by le, a final +Inf bucket equal to _count,
    and a _sum sample; the raw per-band counts additionally ride the
    *_band series."""
    from foundationdb_tpu_torch.flow.latency import RequestLatency
    rl = RequestLatency("commit")
    for s in (0.0001, 0.002, 0.004, 0.03, 0.2, 2.0):   # one past 1.0s
        rl.record(s)
    st = {"cluster": {"epoch": 1, "recovery_state": "fully_recovered",
                      "proxies": [{"name": "p0", "counters": {},
                                   "latency_bands": {
                                       "commit": rl.snapshot()}}]}}
    samples = parse_prometheus(render_prometheus(st))
    buckets = [(float("inf") if l["le"] == "+Inf" else float(l["le"]), v)
               for n, l, v in samples
               if n == "fdbtpu_request_latency_seconds_bucket"]
    assert buckets == sorted(buckets), buckets
    counts = [v for _le, v in buckets]
    assert counts == sorted(counts), "buckets must be cumulative"
    assert buckets[-1][0] == float("inf")
    (count,) = [v for n, l, v in samples
                if n == "fdbtpu_request_latency_seconds_count"]
    assert buckets[-1][1] == count == 6
    (total,) = [v for n, l, v in samples
                if n == "fdbtpu_request_latency_seconds_sum"]
    assert abs(total - 2.2361) < 1e-6, total
    # the 2.0s sample fits no finite band: +Inf must exceed the last
    # finite bucket
    assert buckets[-1][1] > buckets[-2][1]
    # per-band series preserved beside the histogram
    band = {l["band"]: v for n, l, v in samples
            if n == "fdbtpu_request_latency_band"}
    assert band["0.005"] == 3 and band["1"] == 5, band


def test_value_escaping():
    st = _canned_status()
    st["cluster"]["proxies"][0]["name"] = 'weird"role\\name'
    text = render_prometheus(st)
    samples = parse_prometheus(text)
    assert any(l.get("role", "").startswith("weird")
               for _n, l, _v in samples)


def test_duplicate_health_messages_aggregate():
    """Two conditions of the same kind must not emit identical label
    sets (a real Prometheus server rejects duplicate samples — exactly
    when the cluster is unhealthy)."""
    st = _canned_status()
    st["cluster"]["messages"] = [
        {"name": "storage_behind_tlog", "severity": 30, "storage": "a"},
        {"name": "storage_behind_tlog", "severity": 30, "storage": "b"},
        {"name": "saturated_resolver", "severity": 30}]
    samples = parse_prometheus(render_prometheus(st))
    keys = [(n, tuple(sorted(l.items()))) for n, l, _ in samples]
    assert len(keys) == len(set(keys))
    vals = {l["name"]: v for n, l, v in samples
            if n == "fdbtpu_health_message"}
    assert vals == {"storage_behind_tlog": 2, "saturated_resolver": 1}


def test_parse_rejects_malformed():
    with pytest.raises(ValueError):
        parse_prometheus('bad_metric{le=0.1} 4')   # unquoted label
    with pytest.raises(ValueError):
        parse_prometheus('name with spaces 4')


def test_http_server_serves_metrics():
    text = render_prometheus(_canned_status())
    srv = ExporterServer(lambda: text)
    srv.start()
    try:
        url = f"http://127.0.0.1:{srv.port}/metrics"
        resp = urllib.request.urlopen(url, timeout=10)
        assert resp.headers["Content-Type"].startswith("text/plain")
        assert resp.read().decode() == text
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/other", timeout=10)
    finally:
        srv.close()


def test_http_server_survives_scrape_errors():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("status unavailable")
        return "ok_metric 1\n"

    srv = ExporterServer(flaky)
    srv.start()
    try:
        url = f"http://127.0.0.1:{srv.port}/metrics"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(url, timeout=10)
        assert urllib.request.urlopen(
            url, timeout=10).read() == b"ok_metric 1\n"
    finally:
        srv.close()


# -- escaping + version-skew federation -----------------------------------

def test_hostile_label_values_round_trip():
    """Backslashes, quotes, newlines, commas and braces in a label
    value must survive render -> parse EXACTLY: the exposition format
    escapes only \\, " and newline, and commas/braces are legal raw
    inside a quoted value — the parser must scan the quoted string,
    not split the body on commas."""
    hostile = 'a\\b"c\nd,e{f}=g'
    st = _canned_status()
    st["cluster"]["proxies"][0]["name"] = hostile
    samples = parse_prometheus(render_prometheus(st))
    roles = {l["role"] for _n, l, _v in samples if "role" in l}
    assert hostile in roles, roles


def test_parse_rejects_bad_escapes_and_unterminated():
    with pytest.raises(ValueError):
        parse_prometheus('m{a="bad\\q"} 1')      # unknown escape
    with pytest.raises(ValueError):
        parse_prometheus('m{a="dangling\\')
    with pytest.raises(ValueError):
        parse_prometheus('m{a="unterminated} 1')


def test_federate_tolerates_version_skew():
    """A worker doc from an OLDER build lacks the newer sections
    (process_metrics, flightrec, even counters): federation must fill
    defaults — no KeyError anywhere downstream — and the filled
    defaults must not alias between docs."""
    from foundationdb_tpu_torch.tools.exporter import (federate_status,
                                                       normalize_proc_doc,
                                                       render_federated)
    old_worker = {"process": "client-0:100", "role": "client-0",
                  "pid": 100}
    new_worker = {"process": "client-1:200", "role": "client-1",
                  "pid": 200, "up": 1, "counters": {"committed": 7},
                  "process_metrics": {"role": "client-1", "pid": 200,
                                      "cpu_seconds": 1.5,
                                      "rss_bytes": 1024,
                                      "open_fds": 9,
                                      "gc_collections": 3,
                                      "loop_lag_ms": 0.25,
                                      "uptime_seconds": 12.0},
                  "flightrec": {"armed": 1, "size": 512,
                                "buffered": 40, "noted": 99,
                                "dumps": 1}}
    fed = federate_status(_canned_status(), [old_worker, new_worker])
    procs = fed["cluster"]["processes"]
    for name, p in procs.items():
        for key in ("counters", "grv", "commit", "process_metrics",
                    "flightrec", "up", "uptime_s"):
            assert key in p, (name, key)
    # filled defaults are fresh dicts, never shared
    procs["client-0:100"]["counters"]["x"] = 1
    assert "x" not in normalize_proc_doc({})["counters"]

    # the federated scrape renders BOTH docs and parses; the new
    # worker's telemetry families carry its identity labels
    text = render_federated(_canned_status(), [old_worker, new_worker])
    samples = parse_prometheus(text)
    cpu = {(l.get("role"), l.get("pid")): v for n, l, v in samples
           if n == "fdbtpu_process_cpu_seconds"}
    assert cpu.get(("client-1", "200")) == 1.5, cpu
    rec = {n for n, _l, _v in samples if n.startswith("fdbtpu_flightrec")}
    assert {"fdbtpu_flightrec_buffered", "fdbtpu_flightrec_noted_total",
            "fdbtpu_flightrec_dumps_total"} <= rec, rec
    # the old worker still contributes its liveness row
    ups = {l.get("role") for n, l, _v in samples
           if n == "fdbtpu_process_up"}
    assert "client-0" in ups, ups


def test_launch_counters_labeled_by_kernel():
    """The port's status carries each CUDA kernel's launches as
    `launches.<kernel>` beside the profiled entries' counters: they
    render as kernel=<kernel>, counter="launches" (not split at the
    last dot into kernel="launches")."""
    st = _canned_status()
    st["cluster"]["kernels"].update({"launches.searchsorted_i32": 12,
                                     "launches.resolve": 12})
    samples = parse_prometheus(render_prometheus(st))
    prof = {(l["kernel"], l["counter"]): v for n, l, v in samples
            if n == "fdbtpu_kernel_profile"}
    assert prof[("searchsorted_i32", "launches")] == 12
    assert prof[("resolve", "launches")] == 12
    assert prof[("resolve[1024c/16t/32r/32w]", "calls")] == 12
    assert not any(k == "launches" for k, _ in prof)
