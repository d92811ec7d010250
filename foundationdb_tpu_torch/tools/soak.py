"""SOAK_r01: a long-horizon multi-OS-process soak with kills armed.

Reference: the reference project's nightly "soak" runs — a real
cluster held under load for hours with failures injected, watching
throughput, latency, recovery time, and end-state consistency. Here
the host process runs the full commit pipeline wall-clock behind a
peer-serving TcpGateway (rpc/gateway.py) and `--processes` client
worker OS processes drive a seeded open-loop workload over real TCP.
At a scheduled point the harness SIGKILLs a worker and respawns it,
measuring recovery time (kill -> first committed transaction of the
replacement). Throughout, it samples committed-txn/s and latency
bands into time-series rows, fetches every worker's StatusRequest doc
mid-run for the federated status/metrics surface, and at
the end asserts ZERO divergent verdicts and a digest that is stable
across two full keyspace passes. With tracing armed (the default)
every worker writes role+pid-stamped trace files into the shared run
directory and tools/tracemerge.py must reassemble at least one full
client->proxy->resolver->tlog commit chain across the process
boundary.

With `--slo` the cluster runs the longitudinal plane:
TimeKeeper + metric-history recorder + SLO engine armed
(METRIC_HISTORY=1), per-sample timeline rows streamed to
<run_dir>/timeline.jsonl and cumulative counts banked to banked.json
(an hours-long run's accounting survives a host crash, not just
client SIGKILLs), and the final timeline + verdict REBUILT from the
persistent \\xff\\x02/metrics/ + \\xff\\x02/timeKeeper/ keyspaces — the
run is judged by what the database recorded about itself, not by the
driver's memory. `--breach-at T` arms COMMIT_LATENCY_INJECTION for
`--breach-len` seconds mid-run: the burn-rate SLO must trip online
and an incident bundle (tools/incident.py) must cover the window.
`--hours H` is the long-horizon spelling of --duration.

CLI:
  python -m foundationdb_tpu_torch.tools.soak [--processes N] [--duration S]
      [--hours H] [--rate R] [--resolvers N] [--kills N] [--seed S]
      [--sample-period S] [--run-dir D] [--no-trace] [--slo]
      [--breach-at T] [--breach-len S]
      [--resolver-processes N] [--tlog-processes N] [--kill-resolver N]
      [--backend B] [--device cpu]
      [--out PATH] [--report PATH]

Role-per-process arming: `--resolver-processes N` hosts
every resolver in its own rolehost OS process (tools/rolehost.py) and
`--tlog-processes 1` does the same for the tlog — the host's proxies
fan out resolve/commit over real TCP with per-request retry, and the
role processes' proc stubs join the same federation fetch.
`--kill-resolver K` SIGKILLs a live resolver process K times at evenly
spaced points and respawns it on its pinned port: recovery (checkpoint
restore + deterministic journal replay, kill -> first cluster-wide
committed advance) must land inside CHAOS_RECOVERY_BOUND.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import List, Optional

from .. import flow
from ..flow import rng as _rng
from ..flow.future import Promise
from .clusterbench import (RoleProcs, _drive_commits, _lat_ms,
                           worker_trace_setup, write_proc_file)

#: the document and report land in the run dir unless --out/--report
#: name other paths
OUT_NAME = "SOAK_r01.json"
REPORT_NAME = "SOAK_r01.md"
COUNT_KEYS = ("offered", "shed", "committed", "conflicted", "too_old",
              "errors")


# ------------------------------------------------------------- worker
def run_soak_worker(cfg: dict) -> dict:
    """Client-worker entry (one OS process): fetch the CLIENT describe
    document from the gateway and drive a share of the open-loop
    workload against the HOST's proxies over real TCP — so every
    sampled commit's span tree crosses the process boundary at the
    client->proxy hop. Emits a cumulative-count JSON sample line every
    `sample_period` seconds (cumulative so the driver's accounting
    survives a SIGKILL mid-run) and a final line when the horizon
    ends."""
    prev_sched = flow.get_scheduler()
    prev_rng = _rng.rng_state()
    transport = None
    try:
        from ..rpc.gateway import DESCRIBE_TOKEN
        from ..rpc.tcp import TcpRequestStream, TcpTransport
        from ..server.process_metrics import ProcessMetrics, \
            loop_lag_probe
        flow.set_seed(int(cfg["seed"]))
        s = flow.Scheduler(virtual=False)
        flow.set_scheduler(s)
        idx = int(cfg["index"])
        gen = int(cfg.get("generation", 0))
        role = f"client-{idx}"
        pid = os.getpid()
        # worker_trace_setup also arms the flight recorder against the
        # shared run dir (auto-dump on SevError)
        worker_trace_setup(role, cfg)
        metrics = ProcessMetrics(role=role)
        transport = TcpTransport()
        status_stream = TcpRequestStream(transport)
        if cfg.get("run_dir"):
            write_proc_file(cfg["run_dir"], role, transport.port,
                            status_stream.token)
        host, port = cfg["host"], int(cfg["port"])
        live: dict = {}
        started = time.perf_counter()

        def worker_status() -> dict:
            counts = live.get("counts") or {}
            return {
                "process": f"{role}:{pid}", "role": role, "pid": pid,
                "generation": gen,
                "uptime_s": round(time.perf_counter() - started, 3),
                "counters": dict(counts),
                "grv": _lat_ms(list(live.get("grv_lat") or [])),
                "commit": _lat_ms(list(live.get("commit_lat") or [])),
                "process_metrics": metrics.sample(),
                "flightrec": flow.g_flightrec.status(),
            }

        async def status_loop():
            while True:
                _req, reply = await status_stream.pop()
                reply.send(worker_status())

        async def pipe(fut, promise: Promise) -> None:
            try:
                promise.send(await fut)
            except flow.FdbError as e:
                promise.send_error(e)

        async def sampler():
            period = float(cfg.get("sample_period", 1.0))
            gi = ci = 0
            while True:
                await flow.delay(period)
                counts = dict(live.get("counts") or {})
                grv_lat = live.get("grv_lat") or []
                commit_lat = live.get("commit_lat") or []
                row = {"type": "sample", "index": idx, "pid": pid,
                       "generation": gen,
                       "t": round(time.perf_counter() - started, 3)}
                for k in COUNT_KEYS:
                    row[k] = counts.get(k, 0)
                # latency over the window since the LAST sample — a
                # time series of bands, not one run-wide smear
                if len(grv_lat) > gi:
                    row["grv"] = _lat_ms(list(grv_lat[gi:]))
                if len(commit_lat) > ci:
                    row["commit"] = _lat_ms(list(commit_lat[ci:]))
                gi, ci = len(grv_lat), len(commit_lat)
                row["proc"] = metrics.sample()
                print(json.dumps(row), flush=True)

        async def main():
            transport.start()
            flow.spawn(status_loop())
            flow.spawn(loop_lag_probe(metrics))
            describe = transport.ref(host, port, DESCRIBE_TOKEN)
            doc = None
            for _ in range(50):
                try:
                    doc = await flow.timeout_error(
                        describe.get_reply(-1), 5.0)
                    if doc.get("proxies"):
                        break
                    doc = None
                except flow.FdbError:
                    pass
                await flow.delay(0.2)
            if doc is None:
                raise RuntimeError("client describe never became ready")
            grv_refs = [transport.ref(host, port, p["grvs"])
                        for p in doc["proxies"]]
            commit_refs = [transport.ref(host, port, p["commits"])
                           for p in doc["proxies"]]

            def grv_send(req, reply):
                flow.spawn(pipe(grv_refs[0].get_reply(req), reply))

            def commit_send(i, req, reply):
                ref = commit_refs[i % len(commit_refs)]
                # get_reply is called HERE, synchronously, while the
                # NativeAPI.commit span _drive_commits opened is still
                # the top of this debug id's stack — the transport
                # captures it as the cross-process parent
                flow.spawn(pipe(ref.get_reply(req), reply))

            # priming commit: a blind write (no read ranges — immune
            # to the MVCC too_old window) advances the cluster's
            # committed version past the idle gap this process's own
            # startup opened, so the measured workload's first GRVs
            # land inside max_write_transaction_life_versions
            from ..server.types import (CommitRequest,
                                        GetReadVersionRequest,
                                        MutationRef, SET_VALUE)
            pk = b"\x00soak-prime/%d" % idx
            reply = Promise()
            grv_send(GetReadVersionRequest(), reply)
            ver0 = (await reply.future).version
            reply = Promise()
            commit_send(0, CommitRequest(
                ver0, (), ((pk, pk + b"\x00"),),
                (MutationRef(SET_VALUE, pk, b"p"),)), reply)
            await reply.future

            flow.spawn(sampler())
            counts = await _drive_commits(
                grv_send, commit_send, seed=int(cfg["seed"]),
                duration=float(cfg["duration"]),
                rate=float(cfg["rate"]),
                key_prefix=b"soak/%d/%d/" % (idx, gen),
                clock=time.perf_counter,
                sample_every=int(cfg.get("sample_every", 0)),
                debug_prefix=f"soak{idx}g{gen}-", live=live)
            counts["type"] = "final"
            counts["index"] = idx
            counts["pid"] = pid
            counts["generation"] = gen
            return counts

        t = s.spawn(main())
        result = s.run(until=t, timeout_time=float(cfg["duration"]) + 90)
        print(json.dumps(result), flush=True)
        return result
    finally:
        if transport is not None:
            transport.close()
        try:
            flow.g_trace_batch.dump()
            flow.g_trace.flush()
        except Exception:  # noqa: BLE001 — exiting anyway
            pass
        flow.g_flightrec.disarm()
        flow.set_scheduler(prev_sched)
        _rng.restore_rng_state(prev_rng)


# ------------------------------------------------------------- driver
class _Slot:
    """One worker seat: the live Popen, its reader thread, the latest
    cumulative sample, and the counts already banked from previous
    (killed or finished) generations."""

    def __init__(self, index: int):
        self.index = index
        self.generation = -1
        self.proc: Optional[subprocess.Popen] = None
        self.pid = 0
        self.last: Optional[dict] = None       # latest sample row
        self.final: Optional[dict] = None      # final row, if any
        self.banked = {k: 0 for k in COUNT_KEYS}
        self.kill_time: Optional[float] = None  # awaiting recovery

    def live_counts(self) -> dict:
        row = self.final or self.last or {}
        return {k: self.banked[k] + row.get(k, 0) for k in COUNT_KEYS}


def run_soak(*, processes: int = 2, resolvers: int = 2,
             duration: float = 20.0, hours: float = None,
             rate: float = 600.0,
             kills: int = 1, seed: int = 0, sample_period: float = 1.0,
             sample_every: int = 32, trace: bool = True,
             run_dir: str = None, slo: bool = False,
             breach_at: float = None, breach_len: float = 4.0,
             breach_delay: float = 0.4,
             resolver_processes: int = 0, tlog_processes: int = 0,
             kill_resolver: int = 0, backend: str = "python",
             device=None, out=print) -> dict:
    """The soak: host cluster + gateway in this process, `processes`
    client workers as real OS processes, `kills` SIGKILL+respawn
    rounds at evenly spaced points of the horizon. Returns the
    SOAK_r01 document (see module docstring for what it asserts).

    Role-per-process arming: `resolver_processes` > 0 puts
    every resolver in its own rolehost OS process (and overrides
    `resolvers`), `tlog_processes` > 0 does the same for the tlog.
    `kill_resolver` rounds SIGKILL a LIVE resolver process at evenly
    spaced points and respawn it on its pinned port: the commit
    pipeline must resume — checkpoint restore + deterministic journal
    replay — within CHAOS_RECOVERY_BOUND wall seconds, measured as
    kill -> first cluster-wide committed-count advance.

    `backend` is the cluster's conflict backend (in-host resolvers, and
    the role hosts' through the master's recruitment) and `device`
    where a CUDA backend runs (None: the card, "cpu": the plain
    versions). A CUDA backend without a card fails with
    NoCudaDeviceError: the soak never resolves on the CPU in its place."""
    if processes < 1:
        raise ValueError("soak needs at least one worker process")
    if hours is not None:
        duration = hours * 3600.0
    if breach_at is not None and not slo:
        raise ValueError("--breach-at needs --slo (nothing would "
                         "detect the breach)")
    if resolver_processes:
        resolvers = resolver_processes
    if kill_resolver and not resolver_processes:
        raise ValueError("--kill-resolver needs --resolver-processes "
                         "(in-host resolvers have no pid to SIGKILL)")
    prev_sched = flow.get_scheduler()
    prev_rng = _rng.rng_state()
    prev_trace_path = flow.g_trace.path
    cluster = gw = fed_transport = timeline_fh = None
    roles = ext = None
    if run_dir is None:
        import tempfile
        run_dir = tempfile.mkdtemp(prefix="fdbtpu-soak-")
    else:
        os.makedirs(run_dir, exist_ok=True)
    lock = threading.Lock()
    slots = [_Slot(i) for i in range(processes)]
    kill_rows: List[dict] = []
    resolver_kill_rows: List[dict] = []
    errors: List[str] = []
    t_start = [0.0]
    try:
        from ..rpc.gateway import TcpGateway
        from ..rpc.tcp import TcpTransport
        from ..server import SimCluster
        from ..server import dbinfo as dbi
        from ..server.chaos import database_digest
        from ..server.process_metrics import ProcessMetrics, \
            loop_lag_probe
        from ..server.types import STATUS_REQUEST
        from . import exporter, tracemerge
        if trace:
            flow.reset_trace(os.path.join(
                run_dir, f"trace.cluster-host.{os.getpid()}.jsonl"))
            flow.trace.set_process_identity("cluster-host")
        if resolver_processes or tlog_processes:
            # role hosts first: the master's recruitment phase needs
            # their control endpoints live before the first epoch
            roles = RoleProcs(
                n_resolvers=resolver_processes,
                n_tlogs=1 if tlog_processes else 0,
                run_dir=run_dir,
                state_root=os.path.join(run_dir, "state"),
                seed=seed, trace=trace, backend=backend, device=device)
            roles.spawn_all().wait_ready()
        cluster = SimCluster(seed=seed, virtual=False, n_proxies=1,
                             n_resolvers=resolvers, n_storage=1,
                             n_logs=1, metric_history=slo,
                             metrics_janitor=slo,
                             conflict_backend=backend, device=device)
        if roles is not None:
            ext = roles.external_roles()
            cluster.cc.external_roles = ext
        if trace:
            # AFTER construction — SimCluster re-seeds the knob set
            flow.SERVER_KNOBS.set("trace_propagation", 1)
        if slo:
            # scale the longitudinal plane to the horizon (also AFTER
            # construction): small chunks + burn windows that fit a
            # smoke-length run, their defaults for long runs. Both
            # retentions must out-live the run — the end-of-run
            # read-back and the breach-window version alignment need
            # the WHOLE timeline still in the keyspace (the janitor's
            # trim math is unit-tested; here it must not eat evidence)
            flow.SERVER_KNOBS.set("metric_history_chunk",
                                  4 if duration < 60 else 8)
            fast = max(2.0, min(10.0, duration * 0.2))
            flow.SERVER_KNOBS.set("slo_burn_fast_window", fast)
            flow.SERVER_KNOBS.set("slo_burn_slow_window",
                                  max(2 * fast, min(60.0,
                                                    duration * 0.5)))
            flow.SERVER_KNOBS.set("slo_eval_interval", 0.5)
            flow.SERVER_KNOBS.set("metric_retention_seconds",
                                  duration * 2 + 600.0)
            flow.SERVER_KNOBS.set("timekeeper_retention",
                                  duration * 2 + 600.0)
        # host-side telemetry + flight recorder — armed
        # AFTER construction (SimCluster disarms the process-global
        # recorder to keep pinned sims clean)
        host_metrics = ProcessMetrics(role="cluster-host")
        flow.g_flightrec.arm(dump_dir=run_dir,
                             name=f"cluster-host.{os.getpid()}")
        db = cluster.client("soak-status")
        gw = TcpGateway(cluster.client("soakgw"), cluster=cluster)

        def reader(slot: _Slot, p: subprocess.Popen) -> None:
            for line in p.stdout:
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                with lock:
                    if row.get("pid") != slot.pid:
                        continue   # a straggler line from an old gen
                    if row.get("type") == "sample":
                        slot.last = row
                        if slot.kill_time is not None and \
                                row.get("committed", 0) > 0:
                            kill_rows[-1]["recovery_s"] = round(
                                time.perf_counter() - slot.kill_time,
                                3)
                            kill_rows[-1]["recovered_pid"] = slot.pid
                            slot.kill_time = None
                    elif row.get("type") == "final":
                        slot.final = row

        def spawn_worker(slot: _Slot, remaining: float) -> None:
            with lock:
                slot.generation += 1
                slot.last = slot.final = None
                cfg = {"host": "127.0.0.1", "port": gw.port,
                       "seed": seed + 1000 * (slot.index + 1)
                       + 71 * slot.generation,
                       "index": slot.index,
                       "generation": slot.generation,
                       "duration": round(remaining, 3),
                       "rate": rate / processes,
                       "run_dir": run_dir,
                       "trace": int(bool(trace)),
                       # the HOST's roll size governs worker trace
                       # files too: an hours-long worker rotates into
                       # .N segments tracemerge reads back in order
                       "trace_roll_size":
                           int(flow.SERVER_KNOBS.trace_roll_size),
                       "sample_every": sample_every if trace else 0,
                       "sample_period": sample_period}
            err_path = os.path.join(
                run_dir, f"worker-{slot.index}.{slot.generation}.stderr")
            p = subprocess.Popen(
                [sys.executable, "-m", "foundationdb_tpu_torch.tools.soak",
                 "--worker", json.dumps(cfg)],
                stdout=subprocess.PIPE,
                stderr=open(err_path, "w"),
                text=True, bufsize=1)
            with lock:
                slot.proc = p
                slot.pid = p.pid
            threading.Thread(target=reader, args=(slot, p),
                             daemon=True).start()

        def kill_worker(slot: _Slot) -> None:
            with lock:
                p, pid, gen = slot.proc, slot.pid, slot.generation
                row = slot.last or {}
                for k in COUNT_KEYS:
                    slot.banked[k] += row.get(k, 0)
                slot.last = slot.final = None
            if p is not None and p.poll() is None:
                p.send_signal(signal.SIGKILL)
                p.wait(timeout=30)
            with lock:
                slot.kill_time = time.perf_counter()
                kill_rows.append({
                    "t": round(time.perf_counter() - t_start[0], 3),
                    "slot": slot.index, "killed_pid": pid,
                    "killed_generation": gen,
                    "committed_before_kill": row.get("committed", 0)})

        # long-horizon accounting: per-sample rows
        # STREAM to disk as JSON lines and only a bounded tail stays in
        # memory for the report; cumulative totals + kill rows bank to
        # banked.json every tick so a host crash loses at most one
        # sample period of accounting
        timeline: List[dict] = []
        timeline_tail = 720
        timeline_rows = [0]
        timeline_path = os.path.join(run_dir, "timeline.jsonl")
        timeline_fh = open(timeline_path, "a", buffering=1)
        federation: dict = {}
        breach = {"t0": None, "t1": None}

        def note_sample(trow: dict) -> None:
            timeline_fh.write(json.dumps(trow) + "\n")
            timeline_rows[0] += 1
            timeline.append(trow)
            if len(timeline) > timeline_tail:
                del timeline[: len(timeline) - timeline_tail]

        def bank_totals(totals: dict) -> None:
            tmp = os.path.join(run_dir, ".banked.json.tmp")
            with open(tmp, "w") as fh:
                json.dump({"totals": totals, "kills": kill_rows,
                           "samples": timeline_rows[0]}, fh)
            os.replace(tmp, os.path.join(run_dir, "banked.json"))

        async def fetch_federation() -> None:
            """Mid-run: every worker's StatusRequest doc over the
            host's own client TCP transport, folded with the CC
            status into one federated doc + one Prometheus scrape."""
            stubs = exporter.read_proc_files(run_dir)
            procs: List[dict] = []
            for stub in stubs:
                ref = fed_transport.ref(stub.get("host", "127.0.0.1"),
                                        int(stub["port"]),
                                        int(stub["status_token"]))
                try:
                    doc = await flow.timeout_error(
                        ref.get_reply(STATUS_REQUEST), 5.0)
                    doc = dict(doc)
                    doc.setdefault("process", stub.get("name", "?"))
                    doc["up"] = 1
                except flow.FdbError:
                    doc = {"process": stub.get("name", "?"),
                           "role": stub.get("role", "?"),
                           "pid": stub.get("pid"), "up": 0}
                procs.append(doc)
            host_status = await db.get_status()
            # the host's own resource sample rides the cluster doc —
            # when the sim's CRITICAL_PATH plane is off (the soak's
            # default), inject it so the federated scrape still covers
            # EVERY OS process with fdbtpu_process_* samples
            cl_doc = host_status.setdefault("cluster", {})
            if not (cl_doc.get("process_metrics") or {}).get("enabled"):
                cl_doc["process_metrics"] = {
                    "enabled": 1, "interval": sample_period,
                    "host": host_metrics.sample(),
                    "role_cpu_share": {}}
            fed_doc = exporter.federate_status(
                host_status, procs,
                host_process=f"cluster-host:{os.getpid()}")
            scrape = exporter.render_federated(
                host_status, procs,
                host_process=f"cluster-host:{os.getpid()}")
            samples = exporter.parse_prometheus(scrape)  # well-formed?
            federation["processes"] = sorted(
                fed_doc["cluster"]["processes"])
            federation["process_count"] = \
                fed_doc["cluster"]["federation"]["process_count"]
            federation["up"] = sum(
                1 for p in procs if p.get("up"))
            federation["scrape_samples"] = len(samples)
            federation["process_metric_pids"] = sorted(
                {lb.get("pid") for name, lb, _v in samples
                 if name == "fdbtpu_process_cpu_seconds"})
            federation["role_cpu_share"] = \
                fed_doc["cluster"]["federation"].get(
                    "role_cpu_share") or {}

        async def slo_read_back(run_t0_clock: float) -> dict:
            """Acceptance: the timeline and the final verdict
            must be reconstructable from the PERSISTENT plane alone —
            the \\xff\\x02/metrics/ series plus the TimeKeeper map, not
            host memory — so a restarted observer reaches the same
            conclusion the live SLO engine did."""
            from ..layers import metrics as metrics_layer
            from ..server import slo as slo_mod
            from ..server import timekeeper
            from . import incident
            status = await db.get_status()
            slo_status = (status.get("cluster") or {}).get("slo") or {}
            signals = await metrics_layer.list_history_signals(db)
            series = {}
            for sig in signals:
                series[sig] = await metrics_layer.read_history(db, sig)
            # the rebuilt timeline: throughput from the keyspace series
            rebuilt = []
            prev = None
            for ts_ms, committed in series.get("cluster/txn_committed",
                                               []):
                row = {"t": round(ts_ms / 1000.0 - run_t0_clock, 3),
                       "committed": committed}
                if prev is not None and ts_ms > prev[0]:
                    row["txn_per_s"] = round(
                        (committed - prev[1]) * 1000.0
                        / (ts_ms - prev[0]), 1)
                rebuilt.append(row)
                prev = (ts_ms, committed)
            rules = slo_mod.default_rules()
            sample_ts = sorted({ts for s in series.values()
                                for ts, _ in s})
            final_verdict = (slo_mod.evaluate(rules, series,
                                              sample_ts[-1])
                             if sample_ts else {"state": "no-data",
                                                "breached": []})
            # post-hoc sweep: replay the rules over the persisted
            # series (strided so an hours-long run stays O(samples))
            posthoc_breaches = 0
            prev_state = "ok"
            for ts in sample_ts[::max(1, len(sample_ts) // 600)]:
                v = slo_mod.evaluate(rules, series, ts)
                if v["state"] == "breach" and prev_state == "ok":
                    posthoc_breaches += 1
                prev_state = v["state"]
            # TimeKeeper sanity: clock -> version -> clock round trip
            tk_map = await timekeeper.read_time_map(db)
            tk_ok = len(tk_map) > 0
            if sample_ts and tk_map:
                mid = sample_ts[len(sample_ts) // 2] / 1000.0
                v_mid = timekeeper.version_at_time_from_map(tk_map, mid)
                t_back = timekeeper.time_at_version_from_map(tk_map,
                                                             v_mid)
                tk_ok = v_mid > 0 and abs(t_back - mid) < 5.0
            sdoc = {
                "signals": len(signals),
                "series_samples": sum(len(s) for s in series.values()),
                "timekeeper_rows": len(tk_map),
                "timekeeper_ok": tk_ok,
                "rebuilt_samples": len(rebuilt),
                "rebuilt_tail": rebuilt[-5:],
                "timeline_source": "metric-history keyspace",
                "final_state": final_verdict.get("state"),
                "final_breached": final_verdict.get("breached", []),
                "posthoc_breaches": posthoc_breaches,
                "online_state": slo_status.get("state"),
                "online_breaches": slo_status.get("breaches", 0),
                "breach_window": dict(breach),
            }
            if breach["t0"] is not None or \
                    final_verdict.get("state") == "breach":
                # red run (or breach drill): snapshot the window
                if trace:
                    flow.g_trace_batch.dump()
                    flow.g_trace.flush()
                w0 = (breach["t0"] if breach["t0"] is not None
                      else (sample_ts[0] / 1000.0 if sample_ts
                            else run_t0_clock))
                w1 = (breach["t1"] if breach["t1"] is not None
                      else flow.now())
                bundle_dir = os.path.join(run_dir, "incident")
                manifest = await incident.capture_bundle(
                    db, bundle_dir, (w0, w1),
                    run_dir=run_dir if trace else None,
                    status_doc=status, verdict=final_verdict,
                    reason=("breach_drill" if breach["t0"] is not None
                            else "slo_breach"))
                sdoc["bundle"] = {
                    "dir": bundle_dir,
                    "samples": manifest.get("samples", 0),
                    "signals": len(manifest.get("signals", [])),
                    "contents": manifest.get("contents", [])}
            return sdoc

        async def main():
            gw.start()
            while cluster.cc.dbinfo.get().recovery_state != \
                    dbi.FULLY_RECOVERED:
                await flow.delay(0.05)
            fed_transport.start()
            t0 = time.perf_counter()
            t_start[0] = t0
            run_t0_clock = flow.now()
            for slot in slots:
                spawn_worker(slot, duration)
            kill_at = [t0 + duration * (k + 1) / (kills + 1)
                       for k in range(kills)]
            rkill_at = [t0 + duration * (k + 1) / (kill_resolver + 1)
                        for k in range(kill_resolver)]

            async def rewait_resolver(i: int, row: dict) -> None:
                # scheduler-friendly: the host keeps serving while the
                # replacement boots, recovers, and re-writes ready
                await roles.wait_ready_async(
                    [("resolver", i)],
                    timeout=float(
                        flow.SERVER_KNOBS.chaos_recovery_bound))
                rdoc = roles.ready[("resolver", i)]
                row["respawned_pid"] = rdoc["pid"]
                row["respawn_recovered_state"] = bool(
                    rdoc.get("recovered"))
            fed_at = t0 + duration * 0.75
            fed_done = False
            next_sample = t0 + sample_period
            prev_committed = 0
            prev_t = t0
            breach_on_at = (t0 + breach_at if breach_at is not None
                            else None)
            breach_off_at = None
            while time.perf_counter() < t0 + duration:
                await flow.delay(0.1)
                wall = time.perf_counter()
                if breach_on_at is not None and wall >= breach_on_at:
                    # the drill: every commit batch slowed past the
                    # latency-band edge until breach_len elapses — the
                    # ONLINE SLO engine must notice within its fast
                    # window (asserted below from the status doc)
                    breach_on_at = None
                    breach_off_at = wall + breach_len
                    breach["t0"] = flow.now()
                    flow.SERVER_KNOBS.set("commit_latency_injection",
                                          breach_delay)
                if breach_off_at is not None and wall >= breach_off_at:
                    breach_off_at = None
                    breach["t1"] = flow.now()
                    flow.SERVER_KNOBS.set("commit_latency_injection",
                                          0.0)
                while kill_at and wall >= kill_at[0]:
                    kill_at.pop(0)
                    victim = slots[len(kill_rows) % processes]
                    kill_worker(victim)
                    spawn_worker(victim,
                                 t0 + duration - time.perf_counter())
                while rkill_at and wall >= rkill_at[0]:
                    # resolver chaos: SIGKILL a LIVE
                    # resolver role process mid-load, respawn on its
                    # pinned port; recovery is judged by the whole
                    # pipeline committing again (every commit fans out
                    # to every resolver, so a dead one stalls all)
                    rkill_at.pop(0)
                    ri = len(resolver_kill_rows) % roles.n_resolvers
                    with lock:
                        before = 0
                        for slot in slots:
                            before += slot.live_counts()["committed"]
                    dead = roles.kill("resolver", ri)
                    rrow = {"t": round(wall - t0, 3), "resolver": ri,
                            "name": roles.name("resolver", ri),
                            "killed_pid": dead,
                            "committed_before_kill": before,
                            "wall_at_kill": wall}
                    resolver_kill_rows.append(rrow)
                    roles.respawn("resolver", ri)
                    flow.spawn(rewait_resolver(ri, rrow))
                if not fed_done and wall >= fed_at:
                    fed_done = True
                    try:
                        await fetch_federation()
                    except Exception as e:  # noqa: BLE001 — recorded
                        errors.append(f"federation: {e!r}")
                if wall >= next_sample:
                    next_sample += sample_period
                    with lock:
                        totals = {k: 0 for k in COUNT_KEYS}
                        lat = {}
                        up = 0
                        procs_row = {}
                        for slot in slots:
                            for k, v in slot.live_counts().items():
                                totals[k] += v
                            row = slot.last or {}
                            if slot.proc is not None and \
                                    slot.proc.poll() is None:
                                up += 1
                            prow = row.get("proc") or {}
                            if prow:
                                procs_row[f"client-{slot.index}"] = {
                                    k: prow.get(k) for k in
                                    ("cpu_seconds", "rss_bytes",
                                     "open_fds", "loop_lag_ms")}
                            for req in ("grv", "commit"):
                                for q, v in (row.get(req)
                                             or {}).items():
                                    key = f"{req}_{q}"
                                    lat[key] = max(lat.get(key, 0.0),
                                                   v)
                    hrow = host_metrics.sample()
                    procs_row["cluster-host"] = {
                        k: hrow.get(k) for k in
                        ("cpu_seconds", "rss_bytes", "open_fds",
                         "loop_lag_ms")}
                    trow = {"t": round(wall - t0, 3),
                            "committed": totals["committed"],
                            "txn_per_s": round(
                                (totals["committed"] - prev_committed)
                                / max(1e-9, wall - prev_t), 1),
                            "divergent": totals["conflicted"]
                            + totals["too_old"] + totals["errors"],
                            "workers_up": up}
                    trow.update({k: round(v, 3)
                                 for k, v in sorted(lat.items())})
                    trow["proc"] = procs_row
                    # resolver-kill recovery: the pipeline is
                    # recovered once the CLUSTER-WIDE committed count
                    # moves past its pre-kill snapshot (every commit
                    # fans out to every resolver, so a dead one stalls
                    # all workers, not a share)
                    for rrow in resolver_kill_rows:
                        if "recovery_s" not in rrow and \
                                totals["committed"] > \
                                rrow["committed_before_kill"]:
                            rrow["recovery_s"] = round(
                                wall - rrow.pop("wall_at_kill"), 3)
                    note_sample(trow)
                    bank_totals(totals)
                    prev_committed = totals["committed"]
                    prev_t = wall
            # horizon over: let the workers publish their final rows
            grace = time.perf_counter() + 30
            while time.perf_counter() < grace:
                with lock:
                    if all(s.final is not None or s.proc is None
                           or s.proc.poll() is not None
                           for s in slots):
                        break
                await flow.delay(0.2)
            if not fed_done:
                try:
                    await fetch_federation()
                except Exception as e:  # noqa: BLE001 — recorded
                    errors.append(f"federation: {e!r}")
            # end-state consistency: two full keyspace passes must
            # hash identically (quiesced database, stable digest)
            d1 = await database_digest(db)
            d2 = await database_digest(db)
            sdoc = None
            if slo:
                try:
                    sdoc = await slo_read_back(run_t0_clock)
                except Exception as e:  # noqa: BLE001 — recorded
                    errors.append(f"slo_read_back: {e!r}")
            return d1, d2, round(time.perf_counter() - t0, 3), sdoc

        fed_transport = TcpTransport()
        d1, d2, wall, slo_doc = cluster.run(main(),
                                            timeout_time=duration + 300)
        for slot in slots:
            if slot.proc is not None and slot.proc.poll() is None:
                slot.proc.send_signal(signal.SIGKILL)
                slot.proc.wait(timeout=30)
        with lock:
            totals = {k: 0 for k in COUNT_KEYS}
            for slot in slots:
                for k, v in slot.live_counts().items():
                    totals[k] += v
            finals = [s.final for s in slots if s.final is not None]
        totals["divergent_verdicts"] = (totals["conflicted"]
                                        + totals["too_old"]
                                        + totals["errors"])
        doc = {
            "metric": "soak_multi_process",
            "config": {"processes": processes, "resolvers": resolvers,
                       "duration_wall_s": duration, "offered_rate": rate,
                       "kills": kills, "seed": seed,
                       "sample_period_s": sample_period,
                       "sample_every": sample_every,
                       "trace": bool(trace), "slo": bool(slo),
                       "hours": hours, "breach_at": breach_at,
                       "breach_len": breach_len,
                       "resolver_processes": resolver_processes,
                       "tlog_processes": tlog_processes,
                       "kill_resolver": kill_resolver},
            "run_dir": run_dir,
            "wall_seconds": wall,
            "timeline": timeline,
            "timeline_path": timeline_path,
            "timeline_rows": timeline_rows[0],
            "kills": kill_rows,
            "totals": totals,
            "txn_per_s": round(totals["committed"] / max(1e-9, wall), 1),
            "latency_ms": {
                "grv": finals[0].get("grv", {}) if finals else {},
                "commit": finals[0].get("commit", {}) if finals else {},
            },
            "digest": {"first": d1, "second": d2,
                       "consistent": d1 == d2},
            "federation": federation,
            "errors": errors,
        }
        if roles is not None:
            doc["resolver_kills"] = resolver_kill_rows
            try:
                role_docs = exporter.fetch_process_docs(
                    run_dir, stubs=roles.status_stubs())
            except Exception as e:  # noqa: BLE001 — recorded
                role_docs = []
                errors.append(f"role_status: {e!r}")
            doc["role_processes"] = {
                "resolvers": roles.n_resolvers,
                "tlogs": roles.n_tlogs,
                "kills": roles.kills,
                "status": [
                    {k: d.get(k) for k in
                     ("process", "role", "name", "pid", "up",
                      "uptime_s", "counters", "version",
                      "process_metrics") if k in d}
                    for d in role_docs],
            }
        if trace:
            # the cross-process proof: merge the run dir and demand at
            # least one complete client->proxy->resolver->tlog chain
            flow.g_trace_batch.dump()
            flow.g_trace.flush()
            if roles is not None:
                # role processes are still serving: their resolver/tlog
                # span legs sit in per-process TraceBatch buffers until
                # asked — flush before reading the run dir or the merge
                # sees client+host legs only
                from . import rolehost
                try:
                    rolehost.flush_role_traces(
                        list(roles.ready.values()))
                except Exception as e:  # noqa: BLE001 — recorded
                    errors.append(f"trace_flush: {e!r}")
            merged = tracemerge.merge(run_dir)
            full = tracemerge.full_commit_chains(merged)
            doc["trace"] = {
                "run_dir": run_dir,
                "processes": merged["processes"],
                "chains": len(merged["chains"]),
                "cross_process_chains": len(
                    tracemerge.cross_process_chains(merged)),
                "full_commit_chains": len(full),
                "clock_offsets_s": merged["clock_offsets_s"],
            }
        if slo_doc is not None:
            doc["slo"] = slo_doc
        ok = (not errors
              and totals["divergent_verdicts"] == 0
              and totals["committed"] > 0
              and doc["digest"]["consistent"]
              and all("recovery_s" in k for k in kill_rows)
              and (not trace
                   or doc["trace"]["full_commit_chains"] >= 1))
        if kill_resolver:
            # every resolver SIGKILL must have recovered — checkpoint
            # restore + deterministic journal replay — within the same
            # bound the in-sim chaos workloads are held to
            bound = float(flow.SERVER_KNOBS.chaos_recovery_bound)
            ok = (ok and len(resolver_kill_rows) == kill_resolver
                  and all("recovery_s" in r
                          for r in resolver_kill_rows)
                  and max(r["recovery_s"]
                          for r in resolver_kill_rows) <= bound)
        if slo:
            # the self-watching contract: the persistent plane must
            # hold a readable timeline, a sane TimeKeeper map, and —
            # when the drill armed — the online engine must have
            # tripped AND the incident bundle must exist. A drill run
            # is judged on detection, not on ending green (the p99
            # reservoir decays slowly after the injection lifts).
            ok = (ok and slo_doc is not None
                  and slo_doc["signals"] > 0
                  and slo_doc["timekeeper_rows"] > 0
                  and slo_doc["timekeeper_ok"]
                  and slo_doc["rebuilt_samples"] > 0)
            if ok and breach_at is not None:
                ok = (slo_doc["online_breaches"] >= 1
                      and "bundle" in slo_doc)
            elif ok:
                ok = slo_doc["final_state"] == "ok"
        doc["ok"] = ok
        if not ok:
            # red run: the host's flight-recorder ring joins the run
            # dir (the workers' rings already auto-dump on SevError) —
            # nightly CI uploads the whole directory on failure
            dump_path = flow.g_flightrec.dump(directory=run_dir,
                                              reason="soak_red")
            if dump_path:
                doc["flightrec_dump"] = dump_path
        slo_note = ""
        if slo_doc is not None:
            slo_note = (f"slo={slo_doc['final_state']} "
                        f"online_breaches={slo_doc['online_breaches']} "
                        f"signals={slo_doc['signals']} ")
        out(f"  soak {processes}p x {duration}s: "
            f"{doc['txn_per_s']}/s committed={totals['committed']} "
            f"divergent={totals['divergent_verdicts']} "
            f"kills={len(kill_rows)} "
            f"resolver_kills={len(resolver_kill_rows)} "
            f"digest_consistent={doc['digest']['consistent']} "
            f"{slo_note}ok={ok} trace-run-dir={run_dir}")
        return doc
    finally:
        for slot in slots:
            if slot.proc is not None and slot.proc.poll() is None:
                slot.proc.send_signal(signal.SIGKILL)
        if timeline_fh is not None:
            timeline_fh.close()
        if fed_transport is not None:
            fed_transport.close()
        if gw is not None:
            gw.close()
        if ext is not None:
            ext.close()
        if cluster is not None:
            cluster.shutdown()
        if roles is not None:
            roles.terminate_all()
        if trace:
            flow.reset_trace(prev_trace_path)
            flow.trace.clear_process_identity()
            flow.SERVER_KNOBS.set("trace_propagation", 0)
        if slo:
            flow.SERVER_KNOBS.set("commit_latency_injection", 0.0)
            flow.SERVER_KNOBS.set("metric_history", 0)
        flow.g_flightrec.disarm()
        flow.set_scheduler(prev_sched)
        _rng.restore_rng_state(prev_rng)


def render_soak_report(doc: dict) -> str:
    """SOAK_rNN.md: the document as a human report."""
    cfg = doc["config"]
    role_proc = cfg.get("resolver_processes", 0)
    name = "SOAK_r02" if role_proc else "SOAK_r01"
    kind = ("role-per-process soak" if role_proc
            else "multi-process soak")
    lines = [
        f"# {name} — {kind}",
        "",
        f"- processes: {cfg['processes']} client workers + 1 cluster "
        f"host, resolvers={cfg['resolvers']}, seed={cfg['seed']}",
        f"- horizon: {cfg['duration_wall_s']}s wall at "
        f"{cfg['offered_rate']} offered txn/s, kills armed: "
        f"{cfg['kills']}",
        f"- committed: {doc['totals']['committed']} "
        f"({doc['txn_per_s']}/s), divergent verdicts: "
        f"{doc['totals']['divergent_verdicts']}",
        f"- digest: consistent={doc['digest']['consistent']} "
        f"({doc['digest']['first'][:16]}...)",
        f"- verdict: {'PASS' if doc.get('ok') else 'FAIL'}",
        "",
        "## Kills",
        "",
    ]
    for k in doc["kills"]:
        rec = k.get("recovery_s")
        lines.append(
            f"- t={k['t']}s slot {k['slot']}: SIGKILL pid "
            f"{k['killed_pid']} (gen {k['killed_generation']}, "
            f"{k['committed_before_kill']} committed) -> recovered in "
            f"{rec if rec is not None else 'NEVER'}s")
    if not doc["kills"]:
        lines.append("- none armed")
    rp = doc.get("role_processes") or {}
    if rp:
        lines += [
            "",
            "## Role processes",
            "",
            f"- externally hosted: {rp.get('resolvers', 0)} "
            f"resolver(s) + {rp.get('tlogs', 0)} tlog(s) "
            f"(rolehost OS processes), resolver SIGKILLs armed: "
            f"{cfg.get('kill_resolver', 0)}",
        ]
        for r in doc.get("resolver_kills") or []:
            rec = r.get("recovery_s")
            lines.append(
                f"- t={r['t']}s {r['name']}: SIGKILL pid "
                f"{r['killed_pid']} ({r['committed_before_kill']} "
                f"committed cluster-wide) -> pipeline recovered in "
                f"{rec if rec is not None else 'NEVER'}s "
                f"(respawned pid {r.get('respawned_pid', '?')}, "
                f"recovered_state="
                f"{r.get('respawn_recovered_state', '?')})")
        for d in rp.get("status") or []:
            c = d.get("counters") or {}
            pm = d.get("process_metrics") or {}
            lines.append(
                f"- {d.get('process', '?')}: requests="
                f"{c.get('requests', 0)} journaled="
                f"{c.get('journaled', 0)} replayed="
                f"{c.get('replayed', 0)} checkpoints="
                f"{c.get('checkpoints', 0)} cpu_s="
                f"{pm.get('cpu_seconds', '?')} rss="
                f"{pm.get('rss_bytes', '?')}")
    fed = doc.get("federation") or {}
    lines += [
        "",
        "## Federation",
        "",
        f"- processes in status.cluster.processes: "
        f"{fed.get('process_count', 0)} "
        f"({fed.get('up', 0)} up), scrape samples: "
        f"{fed.get('scrape_samples', 0)}",
        "- fdbtpu_process_* coverage (pids): "
        + (", ".join(str(p)
                     for p in fed.get("process_metric_pids", ()))
           or "-"),
    ]
    if fed.get("role_cpu_share"):
        lines.append(
            "- federated role_cpu_share: "
            + ", ".join(f"{r}={v}" for r, v in
                        fed["role_cpu_share"].items()))
    tr = doc.get("trace") or {}
    if tr:
        lines += [
            "",
            "## Cross-process traces",
            "",
            f"- merged chains: {tr['chains']} "
            f"({tr['cross_process_chains']} cross-process, "
            f"{tr['full_commit_chains']} full "
            f"client->proxy->resolver->tlog paths)",
            f"- processes: {', '.join(tr['processes'])}",
        ]
    sl = doc.get("slo") or {}
    if sl:
        lines += [
            "",
            "## SLO (read back from the persistent plane)",
            "",
            f"- signals: {sl.get('signals', 0)} "
            f"({sl.get('series_samples', 0)} samples), timekeeper rows: "
            f"{sl.get('timekeeper_rows', 0)} "
            f"(round-trip ok={sl.get('timekeeper_ok')})",
            f"- final verdict: {sl.get('final_state')} "
            f"breached={sl.get('final_breached')}",
            f"- breaches: online={sl.get('online_breaches', 0)} "
            f"post-hoc={sl.get('posthoc_breaches', 0)}, drill window: "
            f"{sl.get('breach_window')}",
        ]
        if sl.get("bundle"):
            b = sl["bundle"]
            lines.append(
                f"- incident bundle: {b['dir']} "
                f"({b['samples']} samples over {b['signals']} signals)")
    lines += ["", "## Timeline", ""]
    total_rows = doc.get("timeline_rows", len(doc["timeline"]))
    if total_rows > len(doc["timeline"]):
        lines += [f"(tail of {total_rows} rows — full series streams "
                  f"to {doc.get('timeline_path', 'timeline.jsonl')})",
                  ""]
    lines += ["| t (s) | committed | txn/s | divergent | workers up |",
              "|---|---|---|---|---|"]
    for row in doc["timeline"]:
        lines.append(
            f"| {row['t']} | {row['committed']} | {row['txn_per_s']} "
            f"| {row['divergent']} | {row['workers_up']} |")
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    kw: dict = {}
    out_path = report_path = None
    while argv:
        a = argv.pop(0)
        if a == "--worker":
            run_soak_worker(json.loads(argv.pop(0)))
            return 0
        if a == "--processes":
            kw["processes"] = int(argv.pop(0))
        elif a == "--resolvers":
            kw["resolvers"] = int(argv.pop(0))
        elif a == "--duration":
            kw["duration"] = float(argv.pop(0))
        elif a == "--rate":
            kw["rate"] = float(argv.pop(0))
        elif a == "--kills":
            kw["kills"] = int(argv.pop(0))
        elif a == "--seed":
            kw["seed"] = int(argv.pop(0))
        elif a == "--sample-period":
            kw["sample_period"] = float(argv.pop(0))
        elif a == "--hours":
            kw["hours"] = float(argv.pop(0))
        elif a == "--slo":
            kw["slo"] = True
        elif a == "--breach-at":
            kw["breach_at"] = float(argv.pop(0))
        elif a == "--breach-len":
            kw["breach_len"] = float(argv.pop(0))
        elif a == "--resolver-processes":
            kw["resolver_processes"] = int(argv.pop(0))
        elif a == "--tlog-processes":
            kw["tlog_processes"] = int(argv.pop(0))
        elif a == "--kill-resolver":
            kw["kill_resolver"] = int(argv.pop(0))
        elif a == "--run-dir":
            kw["run_dir"] = argv.pop(0)
        elif a == "--backend":
            kw["backend"] = argv.pop(0)
        elif a == "--device":
            kw["device"] = argv.pop(0)
        elif a == "--no-trace":
            kw["trace"] = False
        elif a == "--out":
            out_path = argv.pop(0)
        elif a == "--report":
            report_path = argv.pop(0)
        else:
            print(f"unknown argument {a!r}")
            return 2
    doc = run_soak(out=print, **kw)
    out_path = out_path or os.path.join(doc["run_dir"], OUT_NAME)
    report_path = report_path or os.path.join(doc["run_dir"], REPORT_NAME)
    with open(out_path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
    with open(report_path, "w") as fh:
        fh.write(render_soak_report(doc))
    print(f"report -> {out_path} + {report_path} "
          f"trace-run-dir={doc['run_dir']}")
    return 0 if doc.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
