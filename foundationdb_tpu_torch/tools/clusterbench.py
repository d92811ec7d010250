"""System bench: committed-txn/s across N proxies × M resolvers —
in-process (simulated time) and across OS processes over real TCP.

The kernel benches (bench.py) measure the resolver core; this driver
measures the SYSTEM the roadmap says to optimize (ROADMAP item 2): a
seeded open-loop commit workload driven through the whole pipeline —
GRV, batcher, version authority, resolver fan-out, log push — at every
shape in {1,2,4} proxies × {1,2,4} resolvers.

Two modes, two honest units:

- **in-process** (`--mode inprocess`): one SimCluster per cell on the
  virtual clock; committed-txn/s is SIM-time throughput. Saturation
  comes from the two modeled serial resources: the per-proxy commit
  cadence (one master version round-trip per batch, batch size capped
  by COMMIT_TRANSACTION_BATCH_COUNT_MAX for the bench) and the modeled
  resolver service time (SIM_RESOLVE_COST_PER_TXN — resolution cost is
  the quantity the source paper scales against, arXiv:1804.00947; the
  sim otherwise resolves in zero sim time and the resolver axis would
  be invisible). Adding proxies multiplies batch cadence; adding
  resolvers divides per-resolver service load (contention-light keys
  split evenly across the keyspace shards).

- **across-process** (`--mode tcp`, `--processes N`): the cluster —
  master, resolvers, tlogs, storage — runs wall-clock in THIS process
  behind a TcpGateway serving PEER endpoints (rpc/gateway.py); N proxy
  WORKER processes each build a real `Proxy` role from the
  peer-describe document and join the commit pipeline over rpc/tcp.py
  — resolver and tlog traffic crosses real sockets.
  Committed-txn/s is WALL-time throughput, and the workload must
  complete with ZERO divergent verdicts (contention-light disjoint
  keys: every arrival must commit; any conflict/too-old is a
  divergence).

`--matrix` runs both modes over the full grid and writes the
SYSBENCH_rNN.json artifact published in PERF.md.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from typing import List, Optional

from .. import flow
from ..flow import rng as _rng
from ..flow.future import Promise
from . import report_path

GRID = (1, 2, 4)
# bench saturation model (see module docstring): commit batches capped
# small so the per-proxy cadence (one master RTT per batch) binds, and
# a modeled resolver service time so the resolver axis is real
BATCH_CAP = 8
RESOLVE_COST = 400e-6          # seconds per txn at the resolver
REPORT_PATH = report_path("_clusterbench_report.json")


def _percentile(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(len(sorted_vals) * q))
    return sorted_vals[i]


def _lat_ms(vals: list) -> dict:
    vals = sorted(vals)
    return {"p50_ms": round(_percentile(vals, 0.50) * 1e3, 3),
            "p90_ms": round(_percentile(vals, 0.90) * 1e3, 3),
            "p99_ms": round(_percentile(vals, 0.99) * 1e3, 3)}


async def _drive_commits(grv_send, commit_send, *, seed: int,
                         duration: float, rate: float, key_prefix: bytes,
                         max_inflight: int = 2048,
                         clock=None, sample_every: int = 0,
                         debug_prefix: str = "",
                         live: Optional[dict] = None) -> dict:
    """The shared seeded open-loop commit workload: exponential
    arrivals at `rate` for `duration` seconds (sim or wall — `clock`
    decides what the latency numbers mean), each a GRV + a one-key
    read/write commit on its own UNIQUE key (contention-light by
    construction: any non-committed verdict is a divergence, not
    noise). Keys spread uniformly over the first byte so keyspace-split
    resolvers share the load. Arrivals past `max_inflight` are shed
    and counted, never hidden (the attainment discipline).

    `grv_send(req, reply)` / `commit_send(i, req, reply)` inject into
    a proxy's streams — in-process these round-robin the SimCluster's
    proxies; in a TCP worker they feed the worker's own Proxy role.

    With `sample_every` > 0, every Nth commit carries a debug id
    (`debug_prefix` + arrival index) and opens the client
    `NativeAPI.commit` span around its commit leg — the root of the
    cross-process span tree tracemerge reassembles. 0 (the
    default) changes nothing: no debug ids, no spans, identical
    requests."""
    from ..server.types import (CommitRequest, GetReadVersionRequest,
                                MutationRef, SET_VALUE)
    if clock is None:
        clock = flow.now
    g = flow.g_random.fork()
    counts = {"offered": 0, "shed": 0, "committed": 0, "conflicted": 0,
              "too_old": 0, "errors": 0}
    grv_lat: List[float] = []
    commit_lat: List[float] = []
    inflight = [0]
    done = flow.Promise()
    if live is not None:
        # expose the in-flight accumulators so a status endpoint can
        # snapshot the workload mid-run (federated status)
        live["counts"] = counts
        live["grv_lat"] = grv_lat
        live["commit_lat"] = commit_lat

    async def one(i: int) -> None:
        # the random byte LEADS the key: resolver ownership splits on
        # the first byte, so a uniform lead byte spreads the load
        # across every keyspace shard (the prefix keeps workers'
        # keyspaces disjoint)
        key = (bytes([g.random_int(0, 256)]) + key_prefix
               + b"%08d" % i)
        debug_id = (f"{debug_prefix}{i}"
                    if sample_every > 0 and i % sample_every == 0
                    else None)
        span = None
        try:
            t0 = clock()
            reply = Promise()
            grv_send(GetReadVersionRequest(), reply)
            ver = (await reply.future).version
            grv_lat.append(clock() - t0)
            t1 = clock()
            reply = Promise()
            if debug_id is not None:
                span = flow.g_trace_batch.begin_span(debug_id,
                                                     "NativeAPI.commit")
            commit_send(i, CommitRequest(
                ver, ((key, key + b"\x00"),), ((key, key + b"\x00"),),
                (MutationRef(SET_VALUE, key, b"v"),),
                debug_id=debug_id), reply)
            await reply.future
            commit_lat.append(clock() - t1)
            counts["committed"] += 1
        except flow.FdbError as e:
            if e.name == "operation_cancelled":
                raise
            if e.name == "not_committed":
                counts["conflicted"] += 1
            elif e.name == "transaction_too_old":
                counts["too_old"] += 1
            else:
                counts["errors"] += 1
        finally:
            if span is not None:
                span.finish()
            inflight[0] -= 1
            if counts["offered"] >= total[0] and inflight[0] == 0 \
                    and not done.is_set:
                done.send(None)

    # seeded open-loop schedule: one RNG fork, exponential gaps
    total = [1 << 30]
    start = clock()
    t_end = flow.now() + duration
    i = 0
    while flow.now() < t_end:
        if inflight[0] < max_inflight:
            counts["offered"] += 1
            inflight[0] += 1
            flow.spawn(one(i))
        else:
            counts["shed"] += 1
        i += 1
        gap = g.random_exp(1.0 / rate) if rate > 0 else 0.001
        await flow.delay(gap)
    total[0] = counts["offered"]
    if inflight[0] > 0 and not done.is_set:
        await flow.timeout(done.future, 30.0)
    admitted = counts["offered"]
    counts["attainment"] = round(
        admitted / max(1, admitted + counts["shed"]), 4)
    # throughput over the REAL window (arrivals + drain), not the
    # nominal duration: a saturated cell's stragglers land after
    # t_end, and crediting them against `duration` would overstate
    counts["elapsed"] = round(clock() - start, 3)
    counts["txn_per_s"] = round(
        counts["committed"] / max(1e-9, counts["elapsed"]), 1)
    counts["grv"] = _lat_ms(grv_lat)
    counts["commit"] = _lat_ms(commit_lat)
    return counts


# ---------------------------------------------------------------- in-process
def run_inprocess_cell(n_proxies: int, n_resolvers: int, *, seed: int,
                       duration: float, rate: float,
                       out=lambda *a, **k: None) -> dict:
    """One simulated cell: committed-txn/s in SIM time at this shape."""
    prev_sched = flow.get_scheduler()
    prev_rng = _rng.rng_state()
    cluster = None
    try:
        from ..server import SimCluster
        from ..server import dbinfo as dbi
        from ..server.proxy import Proxy
        cluster = SimCluster(seed=seed, n_proxies=n_proxies,
                             n_resolvers=n_resolvers, n_storage=1,
                             n_logs=1)
        flow.SERVER_KNOBS.set("sim_resolve_cost_per_txn", RESOLVE_COST)
        flow.SERVER_KNOBS.set("commit_transaction_batch_count_max",
                              BATCH_CAP)

        async def main():
            while cluster.cc.dbinfo.get().recovery_state != \
                    dbi.FULLY_RECOVERED:
                await flow.delay(0.05)
            info = cluster.cc.dbinfo.get()
            from ..server.cluster_controller import epoch_roles
            proxies = sorted(
                epoch_roles(cluster.cc.workers, info.epoch, Proxy),
                key=lambda p: p[0])
            objs = [p for _n, p in proxies]

            def grv_send(req, reply):
                grv_send.rr += 1
                objs[grv_send.rr % len(objs)].grvs.stream.send(
                    (req, reply))
            grv_send.rr = 0

            def commit_send(i, req, reply):
                objs[i % len(objs)].commits.stream.send((req, reply))

            return await _drive_commits(
                grv_send, commit_send, seed=seed, duration=duration,
                rate=rate, key_prefix=b"sb/")

        result = cluster.run(main(), timeout_time=3600)
        result.update({"proxies": n_proxies, "resolvers": n_resolvers,
                       "mode": "inprocess", "unit": "sim"})
        out(f"  inprocess {n_proxies}x{n_resolvers}: "
            f"{result['txn_per_s']}/s committed={result['committed']} "
            f"attainment={result['attainment']}")
        return result
    finally:
        if cluster is not None:
            cluster.shutdown()
        # the cell mutated the bench knobs (resolve cost, batch cap):
        # restore defaults so a caller mid-simulation is not left with
        # a 400µs modeled resolver (same discipline as the scheduler/
        # RNG restore; smoke's run_once precedent)
        flow.reset_server_knobs(randomize=False)
        flow.set_scheduler(prev_sched)
        _rng.restore_rng_state(prev_rng)


# ----------------------------------------------------------- role processes
# capacity model for role-per-process cells: each external resolver
# charges ROLE_RESOLVE_COST wall-seconds per txn and each worker proxy
# ROLE_COMMIT_COST, so a cell's modeled capacity is
# min(R / resolve_cost, P / commit_cost) committed/s and the grid's
# scaling is governed by genuinely-overlapping OS processes, not the
# host GIL. Offered load runs ROLE_HEADROOM past capacity with a small
# per-worker inflight window so the drain tail stays bounded.
ROLE_RESOLVE_COST = 10e-3
ROLE_COMMIT_COST = 6.8e-3
ROLE_HEADROOM = 2.5
ROLE_MAX_INFLIGHT = 128


def role_cell_capacity(n_proxies: int, n_resolvers: int,
                       resolve_cost: float = ROLE_RESOLVE_COST,
                       commit_cost: float = ROLE_COMMIT_COST) -> float:
    """Modeled committed-txn/s ceiling of a role-per-process cell."""
    caps = []
    if resolve_cost > 0:
        caps.append(n_resolvers / resolve_cost)
    if commit_cost > 0:
        caps.append(n_proxies / commit_cost)
    return min(caps) if caps else float("inf")


def _last_error(path: str) -> str:
    """The exception line of the last traceback in a role host's log
    (else its last line): what ended that incarnation."""
    try:
        with open(path, errors="replace") as fh:
            lines = [ln.rstrip() for ln in fh if ln.strip()]
    except OSError:
        return ""
    starts = [k for k, ln in enumerate(lines)
              if ln.startswith("Traceback (most recent call last)")]
    if starts:
        for ln in lines[starts[-1] + 1:]:
            if not ln[:1].isspace():
                return ln
    return lines[-1] if lines else ""


class RoleProcs:
    """Role-per-process supervisor: one OS process per external
    resolver/tlog (tools/rolehost.py --worker), spawned BEFORE the
    cluster host so recruitment finds live control endpoints. kill() /
    respawn() drive the chaos path: a respawn pins the dead host's
    port, so every outstanding TcpRef — the host's recruitment refs and
    the worker proxies' RetryingTcpRefs alike — heals onto the
    recovered process without re-describing.

    `device` is where a resolver host runs a CUDA backend (None: the
    card; "cpu": the plain versions). A host without a card, or with a
    device fault past the retries, exits with that error in its log
    (`rolehost.<name>.log` under the run dir), and `check_ready` raises
    naming it."""

    def __init__(self, n_resolvers: int = 0, n_tlogs: int = 0, *,
                 run_dir: str, state_root: str = None, seed: int = 0,
                 backend: str = "python", resolve_cost: float = 0.0,
                 checkpoint_every: float = 1.0, trace: bool = False,
                 device=None):
        self.run_dir = run_dir
        self.device = device
        self.state_root = state_root
        self.seed = seed
        self.backend = backend
        self.resolve_cost = resolve_cost
        self.checkpoint_every = checkpoint_every
        self.trace = trace
        self.keys = ([("resolver", i) for i in range(n_resolvers)]
                     + [("tlog", i) for i in range(n_tlogs)])
        self.procs: dict = {}
        self.ready: dict = {}
        self.kills = 0

    @property
    def n_resolvers(self) -> int:
        return sum(1 for k, _ in self.keys if k == "resolver")

    @property
    def n_tlogs(self) -> int:
        return sum(1 for k, _ in self.keys if k == "tlog")

    def name(self, kind: str, i: int) -> str:
        return f"ext-{kind}-{i}"

    def log_path(self, kind: str, i: int) -> str:
        return os.path.join(self.run_dir,
                            f"rolehost.{self.name(kind, i)}.log")

    def _ready_path(self, kind: str, i: int) -> str:
        return os.path.join(self.run_dir,
                            f"ready.{self.name(kind, i)}.json")

    def spawn(self, kind: str, i: int, port: int = 0) -> None:
        name = self.name(kind, i)
        cfg = {"role": kind, "name": name, "index": i, "port": port,
               "host": "127.0.0.1", "run_dir": self.run_dir,
               "seed": self.seed + 7000
               + i + (0 if kind == "resolver" else 100),
               "trace": int(bool(self.trace)),
               "trace_roll_size":
                   int(flow.SERVER_KNOBS.trace_roll_size),
               "checkpoint_every": self.checkpoint_every}
        if kind == "resolver":
            cfg["backend"] = self.backend
            cfg["device"] = self.device
            cfg["resolve_cost"] = self.resolve_cost
            if self.state_root:
                cfg["state_dir"] = os.path.join(self.state_root, name)
        try:
            os.unlink(self._ready_path(kind, i))
        except OSError:
            pass
        log = open(self.log_path(kind, i), "ab")
        try:
            self.procs[(kind, i)] = subprocess.Popen(
                [sys.executable, "-m",
                 "foundationdb_tpu_torch.tools.rolehost",
                 "--worker", json.dumps(cfg)],
                stdout=log, stderr=log)
        finally:
            log.close()     # the child holds its own dup

    def spawn_all(self) -> "RoleProcs":
        for kind, i in self.keys:
            self.spawn(kind, i)
        return self

    def check_ready(self, kind: str, i: int):
        """Non-blocking: the ready doc once the CURRENT incarnation
        (pid match) has written it, else None. Raises if the process
        exited — a role host never exits on its own."""
        p = self.procs[(kind, i)]
        if p.poll() is not None:
            path = self.log_path(kind, i)
            why = _last_error(path)
            raise RuntimeError(
                f"rolehost {self.name(kind, i)} exited "
                f"rc={p.returncode} (see {path}"
                + (f": {why}" if why else "") + ")")
        try:
            with open(self._ready_path(kind, i)) as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            return None
        if doc.get("pid") != p.pid:
            return None     # a previous incarnation's ready file
        self.ready[(kind, i)] = doc
        return doc

    def wait_ready(self, which=None, timeout: float = 60.0) \
            -> "RoleProcs":
        """Blocking (pre-scheduler) readiness wait."""
        deadline = time.time() + timeout
        for kind, i in (which or self.keys):
            while self.check_ready(kind, i) is None:
                if time.time() > deadline:
                    raise RuntimeError(
                        f"rolehost {self.name(kind, i)} never became "
                        f"ready")
                time.sleep(0.05)
        return self

    async def wait_ready_async(self, which=None,
                               timeout: float = 60.0) -> None:
        """Scheduler-friendly readiness wait (soak/test kill paths —
        the host loop keeps serving while the role host reboots)."""
        deadline = time.time() + timeout
        for kind, i in (which or self.keys):
            while self.check_ready(kind, i) is None:
                if time.time() > deadline:
                    raise RuntimeError(
                        f"rolehost {self.name(kind, i)} never became "
                        f"ready")
                await flow.delay(0.05)

    def kill(self, kind: str, i: int) -> int:
        """SIGKILL — the chaos primitive. Returns the dead pid."""
        p = self.procs[(kind, i)]
        p.kill()
        p.wait()
        self.kills += 1
        return p.pid

    def respawn(self, kind: str, i: int) -> None:
        """Relaunch on the SAME port (from the dead incarnation's
        ready doc) so existing refs heal; follow with wait_ready[_
        async] before expecting replies."""
        self.spawn(kind, i, port=int(self.ready[(kind, i)]["port"]))

    def external_roles(self):
        from .rolehost import ExternalRoles
        return ExternalRoles(
            [self.ready[("resolver", i)]
             for i in range(self.n_resolvers)],
            [self.ready[("tlog", i)] for i in range(self.n_tlogs)])

    def status_stubs(self) -> list:
        """proc-file-shaped stubs for exporter.fetch_process_docs —
        current incarnations only (self.ready tracks respawns)."""
        return [{"name": d["name"], "role": d["role"],
                 "pid": d["pid"], "host": d["host"], "port": d["port"],
                 "status_token": d["tokens"]["status"]}
                for d in (self.ready.get(k) for k in self.keys) if d]

    def terminate_all(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.terminate()
        for p in self.procs.values():
            try:
                p.wait(timeout=10)
            except Exception:  # noqa: BLE001 — escalate, never hang
                p.kill()
                p.wait()


# ------------------------------------------------------------ across-process
def run_tcp_cell(n_proxies: int, n_resolvers: int, *, seed: int,
                 duration: float, rate: float, run_dir: str = None,
                 trace: bool = False, sample_every: int = 32,
                 role_processes: bool = False,
                 resolve_cost: float = 0.0, commit_cost: float = 0.0,
                 batch_cap: int = 0, max_inflight: int = 2048,
                 state_root: str = None,
                 out=lambda *a, **k: None) -> dict:
    """One across-process cell: this process hosts the cluster
    (master/resolvers/tlogs/storage) wall-clock behind a peer-serving
    TcpGateway; `n_proxies` worker OS processes each run a real Proxy
    role over rpc/tcp.py and drive their share of the workload.

    Every cell gets a trace RUN DIRECTORY (`run_dir`, fresh tmpdir by
    default): workers write role+pid-stamped trace files and
    proc.<role>.<pid>.json discovery stubs there. With `trace=True`
    the TRACE_PROPAGATION knob arms in host and workers, sampled
    commits (1-in-`sample_every`) carry debug ids, and
    tools/tracemerge.py reassembles the cross-process span trees from
    the directory afterwards.

    With `role_processes=True` the cell goes FULLY
    role-per-process: every resolver and the tlog run as their own
    rolehost OS processes (spawned before the cluster, recruited by
    the master through `ExternalRoles`), worker proxies connect to
    them DIRECTLY over TCP, `resolve_cost` arms in the resolver
    processes and `commit_cost` in the worker proxies (the
    capacity model — see `role_cell_capacity`), and the cell doc gains
    per-OS-process CPU/RSS rows plus the federated `role_cpu_share`
    fold."""
    from ..server.process_metrics import (ProcessMetrics,
                                          federated_role_cpu_share,
                                          role_cpu_share)
    prev_sched = flow.get_scheduler()
    prev_rng = _rng.rng_state()
    cluster = gw = roles = ext = None
    prev_trace_path = flow.g_trace.path
    if run_dir is None:
        import tempfile
        run_dir = tempfile.mkdtemp(prefix="fdbtpu-run-")
    else:
        os.makedirs(run_dir, exist_ok=True)
    try:
        from ..rpc.gateway import TcpGateway
        from ..server import SimCluster
        from ..server import dbinfo as dbi
        if trace:
            # host-side trace file in the shared run dir: the
            # resolver/tlog legs of every sampled commit land here
            flow.reset_trace(os.path.join(
                run_dir, f"trace.cluster-host.{os.getpid()}.jsonl"))
            flow.trace.set_process_identity("cluster-host")
        if role_processes:
            # role hosts first: recruitment needs their control
            # endpoints live before the master's first epoch
            roles = RoleProcs(
                n_resolvers=n_resolvers, n_tlogs=1, run_dir=run_dir,
                state_root=state_root
                or os.path.join(run_dir, "state"),
                seed=seed, resolve_cost=resolve_cost, trace=trace)
            roles.spawn_all().wait_ready()
        cluster = SimCluster(seed=seed, virtual=False, n_proxies=1,
                             n_resolvers=n_resolvers, n_storage=1,
                             n_logs=1)
        if roles is not None:
            # attach point: constructed but not yet ticked — the
            # master's recruitment phase sees it on its first epoch
            ext = roles.external_roles()
            cluster.cc.external_roles = ext
        if trace:
            # AFTER cluster construction: SimCluster re-seeds the knob
            # set, which would silently disarm an earlier set()
            flow.SERVER_KNOBS.set("trace_propagation", 1)
        # host-side CPU attribution for the role_cpu_share fold: the
        # scheduler's per-task busy table + this process's OS counters
        flow.get_scheduler().start_task_stats()
        host_pm = ProcessMetrics(role="cluster-host")
        gw = TcpGateway(cluster.client("benchgw"), cluster=cluster)

        results: list = []
        errors: list = []

        def run_worker(idx: int) -> None:
            cfg = {"host": "127.0.0.1", "port": gw.port,
                   "seed": seed + 1000 * (idx + 1), "index": idx,
                   "duration": duration,
                   "rate": rate / n_proxies,
                   "run_dir": run_dir,
                   "trace": int(bool(trace)),
                   "trace_roll_size":
                       int(flow.SERVER_KNOBS.trace_roll_size),
                   "sample_every": sample_every if trace else 0,
                   "commit_cost": commit_cost,
                   "batch_cap": batch_cap,
                   "max_inflight": max_inflight}
            try:
                p = subprocess.run(
                    [sys.executable, "-m",
                     "foundationdb_tpu_torch.tools.clusterbench",
                     "--worker", json.dumps(cfg)],
                    capture_output=True, text=True,
                    timeout=duration + 120)
                lines = [ln for ln in p.stdout.splitlines() if ln.strip()]
                if p.returncode != 0 or not lines:
                    errors.append(f"worker {idx}: rc={p.returncode} "
                                  f"stderr={p.stderr[-2000:]}")
                    return
                results.append(json.loads(lines[-1]))
            except Exception as e:  # noqa: BLE001 — collected, reported
                errors.append(f"worker {idx}: {e!r}")

        async def main():
            gw.start()
            while cluster.cc.dbinfo.get().recovery_state != \
                    dbi.FULLY_RECOVERED:
                await flow.delay(0.05)
            threads = [threading.Thread(target=run_worker, args=(i,),
                                        daemon=True)
                       for i in range(n_proxies)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            while any(t.is_alive() for t in threads):
                await flow.delay(0.1)
            wall = time.perf_counter() - t0
            return wall

        wall = cluster.run(main(), timeout_time=duration + 300)
        if errors:
            raise RuntimeError("; ".join(errors))
        agg = {"proxies": n_proxies, "resolvers": n_resolvers,
               "mode": "tcp", "unit": "wall",
               "worker_processes": n_proxies,
               "run_dir": run_dir,
               "wall_seconds": round(wall, 2)}
        for c in ("offered", "shed", "committed", "conflicted",
                  "too_old", "errors"):
            agg[c] = sum(r[c] for r in results)
        agg["divergent_verdicts"] = (agg["conflicted"] + agg["too_old"]
                                     + agg["errors"])
        elapsed = max(r.get("elapsed", duration) for r in results) \
            if results else duration
        agg["elapsed"] = round(elapsed, 3)
        agg["txn_per_s"] = round(agg["committed"] / max(1e-9, elapsed), 1)
        agg["attainment"] = round(
            agg["offered"] / max(1, agg["offered"] + agg["shed"]), 4)
        agg["grv"] = results[0]["grv"] if results else {}
        agg["commit"] = results[0]["commit"] if results else {}
        # per-OS-process telemetry + the federated role CPU fold:
        # host sim-task share weighted by host CPU, worker
        # proxies' and role hosts' whole CPU under their roles
        host_share = role_cpu_share(
            flow.get_scheduler().task_stats_report().get("tasks"))
        host_sample = host_pm.sample()
        agg["host_proc"] = host_sample
        agg["worker_procs"] = [r["proc"] for r in results
                               if r.get("proc")]
        role_docs: list = []
        if roles is not None:
            from .exporter import fetch_process_docs
            role_docs = fetch_process_docs(
                run_dir, stubs=roles.status_stubs())
            agg["role_processes"] = {"resolvers": roles.n_resolvers,
                                     "tlogs": roles.n_tlogs}
            agg["role_procs"] = [
                {k: d.get(k) for k in
                 ("process", "role", "name", "pid", "up", "uptime_s",
                  "counters", "version", "process_metrics")}
                for d in role_docs]
            cap = role_cell_capacity(n_proxies, n_resolvers,
                                     resolve_cost, commit_cost)
            if cap != float("inf"):
                agg["capacity_model_txn_per_s"] = round(cap, 1)
        agg["role_cpu_share"] = federated_role_cpu_share(
            host_share, host_sample.get("cpu_seconds"),
            [{"role": s.get("role"), "process_metrics": s}
             for s in agg["worker_procs"]] + role_docs)
        out(f"  tcp{'-roleproc' if roles is not None else ''} "
            f"{n_proxies}x{n_resolvers}: {agg['txn_per_s']}/s "
            f"committed={agg['committed']} "
            f"divergent={agg['divergent_verdicts']} "
            f"trace-run-dir={run_dir}")
        return agg
    finally:
        if gw is not None:
            gw.close()
        if ext is not None:
            ext.close()
        if cluster is not None:
            cluster.shutdown()
        if roles is not None:
            roles.terminate_all()
        if trace:
            # host spans flushed into the run dir, then the shared
            # collector goes back exactly where the caller had it
            flow.g_trace_batch.dump()
            flow.reset_trace(prev_trace_path)
            flow.trace.clear_process_identity()
            flow.SERVER_KNOBS.set("trace_propagation", 0)
        flow.set_scheduler(prev_sched)
        _rng.restore_rng_state(prev_rng)


def worker_trace_setup(role: str, cfg: dict) -> None:
    """Per-process TraceCollector hygiene for worker OS processes: a
    role+pid-stamped trace file under the shared run directory, the
    TRACE_PROPAGATION knob armed when the
    driver asked for it, and the trace tail flushed on atexit AND on
    SIGTERM — a worker the soak harness kills must not lose its spans.
    (SIGKILL still loses whatever the OS buffers — the collector is
    line-buffered, so at most the current line.)"""
    import atexit
    import signal
    pid = os.getpid()
    run_dir = cfg.get("run_dir")
    # the HOST collector's roll size governs the workers too: the
    # driver ships its trace_roll_size knob in the worker cfg, so an
    # hours-long soak's per-worker trace files rotate into .N segments
    # instead of growing unbounded — set BEFORE reset_trace so the
    # fresh collector sizes against it
    if cfg.get("trace_roll_size"):
        flow.SERVER_KNOBS.set("trace_roll_size",
                              int(cfg["trace_roll_size"]))
    if run_dir:
        flow.reset_trace(os.path.join(run_dir,
                                      f"trace.{role}.{pid}.jsonl"))
        # always-on flight recorder: ring of recent trace
        # events, auto-dumped into the shared run dir on SevError so a
        # worker that dies screaming leaves its last moments behind
        flow.g_flightrec.arm(dump_dir=run_dir, name=f"{role}.{pid}")
    flow.trace.set_process_identity(
        role, addr=f"{cfg['host']}:{cfg['port']}")
    if cfg.get("trace"):
        flow.SERVER_KNOBS.set("trace_propagation", 1)

    def _flush_traces() -> None:
        try:
            flow.g_trace_batch.dump()
            flow.g_trace.flush()
        except Exception:  # noqa: BLE001 — never mask process exit
            pass

    def _on_sigterm(signum, _frame) -> None:
        _flush_traces()
        os._exit(128 + signum)

    atexit.register(_flush_traces)
    signal.signal(signal.SIGTERM, _on_sigterm)


def write_proc_file(run_dir: str, role: str, port: int,
                    status_token: int) -> str:
    """The discovery stub federated status readers key on
    (proc.<role>.<pid>.json): where this worker's StatusRequest
    endpoint listens."""
    pid = os.getpid()
    path = os.path.join(run_dir, f"proc.{role}.{pid}.json")
    with open(path, "w") as fh:
        json.dump({"name": f"{role}:{pid}", "role": role, "pid": pid,
                   "host": "127.0.0.1", "port": port,
                   "status_token": status_token}, fh)
        fh.write("\n")
    return path


def run_worker(cfg: dict) -> dict:
    """Proxy-worker entry (one OS process): fetch the peer-describe
    document, build a real Proxy role whose downstream refs are all
    TcpRefs into the cluster host, and drive this worker's share of
    the seeded workload through it. Prints the result JSON as the last
    stdout line."""
    prev_sched = flow.get_scheduler()
    prev_rng = _rng.rng_state()
    transport = None
    try:
        from ..rpc.gateway import DESCRIBE_TOKEN, PEER_DESCRIBE
        from ..rpc.network import SimNetwork
        from ..rpc.tcp import (RetryingTcpRef, TcpRequestStream,
                               TcpTransport)
        from ..server.process_metrics import ProcessMetrics, \
            loop_lag_probe
        from ..server.proxy import Proxy
        flow.set_seed(int(cfg["seed"]))
        s = flow.Scheduler(virtual=False)
        flow.set_scheduler(s)
        role = cfg.get("role", f"proxy-{cfg['index']}")
        worker_trace_setup(role, cfg)
        # bench knob arming shipped from the driver (role-per-process
        # cells model BOTH serial resources: the external resolver's
        # resolve cost and this worker proxy's commit cost)
        if cfg.get("commit_cost"):
            flow.SERVER_KNOBS.set("sim_commit_cost_per_txn",
                                  float(cfg["commit_cost"]))
        if cfg.get("batch_cap"):
            flow.SERVER_KNOBS.set("commit_transaction_batch_count_max",
                                  int(cfg["batch_cap"]))
        net = SimNetwork(s, flow.g_random)
        proc = net.new_process(f"benchproxy-{cfg['index']}",
                               machine=f"benchproxy-{cfg['index']}")
        transport = TcpTransport()
        # federated status: every worker serves
        # StatusRequest on its own transport; the proc file tells
        # exporter --federate / the soak driver where
        status_stream = TcpRequestStream(transport)
        if cfg.get("run_dir"):
            write_proc_file(cfg["run_dir"], role, transport.port,
                            status_stream.token)
        host, port = cfg["host"], int(cfg["port"])
        live: dict = {}
        started = time.perf_counter()
        pid = os.getpid()
        metrics = ProcessMetrics(role=role)

        def worker_status() -> dict:
            counts = live.get("counts") or {}
            return {
                "process": f"{role}:{pid}", "role": role, "pid": pid,
                "machine_id": f"benchproxy-{cfg['index']}",
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

        async def main():
            transport.start()
            flow.spawn(status_loop())
            flow.spawn(loop_lag_probe(metrics))
            describe = transport.ref(host, port, DESCRIBE_TOKEN)
            doc = None
            for _ in range(50):
                try:
                    doc = await flow.timeout_error(
                        describe.get_reply(PEER_DESCRIBE), 5.0)
                    break
                except flow.FdbError:
                    await flow.delay(0.2)
            if doc is None:
                raise RuntimeError("peer describe never became ready")

            def tref(token):
                return transport.ref(host, port, token)

            def pref(entry, key):
                # role-per-process entries carry the role host's OWN
                # addr (tools/rolehost.py): connect directly, wrapped
                # in a retrying ref so a role kill -9 + same-port
                # respawn heals through role idempotency. Plain int
                # entries are classic gateway tokens.
                if isinstance(entry, dict) and "addr" in entry:
                    h, p = entry["addr"]
                    return RetryingTcpRef(
                        transport.ref(h, int(p), int(entry[key])))
                return tref(entry[key] if isinstance(entry, dict)
                            else entry)

            proxy = Proxy(
                proc, tref(doc["master"]),
                [pref(r, "resolves") for r in doc["resolvers"]],
                [pref(t, "commits") for t in doc["tlogs"]],
                resolver_splits=tuple(doc["resolver_splits"]),
                storage_splits=tuple(doc["storage_splits"]),
                storage_tags=tuple(doc["storage_tags"]),
                recovery_version=int(doc["recovery_version"]))
            proxy.set_peers([tref(t)
                             for t in doc["proxy_raw_committed"]])
            proxy.start()

            def grv_send(req, reply):
                proxy.grvs.stream.send((req, reply))

            def commit_send(_i, req, reply):
                proxy.commits.stream.send((req, reply))

            # priming commit: this worker may start several wall
            # seconds after recovery (subprocess + import time), when
            # the cluster-wide committed version still dates from the
            # recovery epoch while the master's next assignment tracks
            # the wall clock — a read txn driven off that stale first
            # GRV would resolve outside the MVCC window and surface as
            # a spurious too_old "divergence". One blind write (no
            # read ranges: never too_old by definition) advances the
            # committed version to now before the measured workload.
            from ..server.types import (CommitRequest,
                                        GetReadVersionRequest,
                                        MutationRef, SET_VALUE)
            pk = b"\x00sb-prime/%d" % int(cfg["index"])
            reply = Promise()
            grv_send(GetReadVersionRequest(), reply)
            ver0 = (await reply.future).version
            reply = Promise()
            commit_send(0, CommitRequest(
                ver0, (), ((pk, pk + b"\x00"),),
                (MutationRef(SET_VALUE, pk, b"p"),)), reply)
            await reply.future

            counts = await _drive_commits(
                grv_send, commit_send, seed=int(cfg["seed"]),
                duration=float(cfg["duration"]),
                rate=float(cfg["rate"]),
                key_prefix=b"sb/%d/" % int(cfg["index"]),
                clock=time.perf_counter,
                max_inflight=int(cfg.get("max_inflight", 2048)),
                sample_every=int(cfg.get("sample_every", 0)),
                debug_prefix=f"cb{cfg['index']}-", live=live)
            counts["index"] = cfg["index"]
            # per-OS-process CPU/RSS for the cell artifact: the
            # role_cpu_share fold and the SYSBENCH before/after rows
            counts["proc"] = metrics.sample()
            return counts

        t = s.spawn(main())
        return s.run(until=t, timeout_time=float(cfg["duration"]) + 90)
    finally:
        if transport is not None:
            transport.close()
        # worker spans belong to the run dir — land them before the
        # process (and its trace file handle) goes away
        try:
            flow.g_trace_batch.dump()
            flow.g_trace.flush()
        except Exception:  # noqa: BLE001 — exiting anyway
            pass
        flow.g_flightrec.disarm()
        flow.set_scheduler(prev_sched)
        _rng.restore_rng_state(prev_rng)


# -------------------------------------------------------------------- driver
def run_matrix(modes=("inprocess", "tcp"), grid=GRID, *, seed: int = 0,
               duration: float = 2.0, rate: float = 12000.0,
               tcp_duration: float = 3.0, tcp_rate: float = 6000.0,
               role_processes: bool = False,
               role_resolve_cost: float = ROLE_RESOLVE_COST,
               role_commit_cost: float = ROLE_COMMIT_COST,
               role_headroom: float = ROLE_HEADROOM,
               role_max_inflight: int = ROLE_MAX_INFLIGHT,
               out=print) -> dict:
    cells: dict = {"inprocess": {}, "tcp": {}}
    for p in grid:
        for r in grid:
            if "inprocess" in modes:
                cells["inprocess"][f"{p}x{r}"] = run_inprocess_cell(
                    p, r, seed=seed, duration=duration, rate=rate,
                    out=out)
            if "tcp" in modes:
                if role_processes:
                    # offered load tracks the CELL's modeled capacity
                    # (role_cell_capacity) at a fixed headroom — a flat
                    # grid-wide rate would either starve the big cells
                    # or drown the small ones in drain tail
                    cell_rate = role_headroom * role_cell_capacity(
                        p, r, role_resolve_cost, role_commit_cost)
                else:
                    cell_rate = tcp_rate
                cells["tcp"][f"{p}x{r}"] = run_tcp_cell(
                    p, r, seed=seed, duration=tcp_duration,
                    rate=cell_rate, role_processes=role_processes,
                    resolve_cost=(role_resolve_cost
                                  if role_processes else 0.0),
                    commit_cost=(role_commit_cost
                                 if role_processes else 0.0),
                    max_inflight=(role_max_inflight
                                  if role_processes else 2048),
                    out=out)
    tcp_config = {"duration_wall_s": tcp_duration,
                  "offered_rate": tcp_rate}
    if role_processes:
        tcp_config = {"duration_wall_s": tcp_duration,
                      "role_processes": True,
                      "resolve_cost_per_txn_s": role_resolve_cost,
                      "commit_cost_per_txn_s": role_commit_cost,
                      "offered_headroom": role_headroom,
                      "max_inflight_per_worker": role_max_inflight}
    doc = {
        "metric": "system_committed_txn_per_s",
        "config": {
            "seed": seed, "grid": list(grid),
            "inprocess": {"duration_sim_s": duration,
                          "offered_rate": rate,
                          "batch_cap": BATCH_CAP,
                          "resolve_cost_per_txn_s": RESOLVE_COST},
            "tcp": tcp_config,
        },
        "cells": cells,
    }
    ip = cells.get("inprocess") or {}
    if "1x1" in ip and "4x4" in ip:
        base = ip["1x1"]["txn_per_s"] or 1
        doc["headline"] = {
            "inprocess_4x4_vs_1x1": round(ip["4x4"]["txn_per_s"] / base,
                                          2)}
    tcp = cells.get("tcp") or {}
    if tcp:
        doc.setdefault("headline", {})["tcp_divergent_verdicts"] = sum(
            c["divergent_verdicts"] for c in tcp.values())
    if "1x1" in tcp and "4x4" in tcp:
        base = tcp["1x1"]["txn_per_s"] or 1
        doc.setdefault("headline", {})["tcp_4x4_vs_1x1"] = round(
            tcp["4x4"]["txn_per_s"] / base, 2)
    return doc


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    seed = int(os.environ.get("CLUSTERBENCH_SEED", 0))
    out_path = REPORT_PATH
    mode = None
    processes = None
    proxies = resolvers = None
    duration = None
    rate = None
    matrix = False
    trace = False
    run_dir = None
    role_procs = False
    resolve_cost = commit_cost = None
    max_inflight = None
    while argv:
        a = argv.pop(0)
        if a == "--worker":
            print(json.dumps(run_worker(json.loads(argv.pop(0)))))
            return 0
        if a == "--matrix":
            matrix = True
        elif a == "--mode":
            mode = argv.pop(0)
        elif a == "--processes":
            processes = int(argv.pop(0))
        elif a == "--proxies":
            proxies = int(argv.pop(0))
        elif a == "--resolvers":
            resolvers = int(argv.pop(0))
        elif a == "--duration":
            duration = float(argv.pop(0))
        elif a == "--rate":
            rate = float(argv.pop(0))
        elif a == "--seed":
            seed = int(argv.pop(0))
        elif a == "--out":
            out_path = argv.pop(0)
        elif a == "--trace":
            trace = True
        elif a == "--run-dir":
            run_dir = argv.pop(0)
        elif a == "--role-processes":
            role_procs = True
        elif a == "--resolve-cost":
            resolve_cost = float(argv.pop(0))
        elif a == "--commit-cost":
            commit_cost = float(argv.pop(0))
        elif a == "--max-inflight":
            max_inflight = int(argv.pop(0))
        else:
            print(f"unknown argument {a!r}")
            return 2
    if matrix:
        modes = (mode,) if mode else ("inprocess", "tcp")
        doc = run_matrix(
            modes, seed=seed, role_processes=role_procs,
            duration=duration or 2.0,
            tcp_duration=12.0 if role_procs else 3.0, out=print)
    elif processes is not None:
        # the CI small shape: N proxy worker processes over real TCP
        # (--role-processes puts the resolvers and the tlog in their
        # own OS processes too; costs default to 0 — CI measures the
        # zero-divergence property, not the capacity model)
        doc = {"metric": "system_committed_txn_per_s",
               "cells": {"tcp": {}}}
        cell = run_tcp_cell(processes, resolvers or processes,
                            seed=seed, duration=duration or 3.0,
                            rate=rate or 2000.0, run_dir=run_dir,
                            trace=trace, role_processes=role_procs,
                            resolve_cost=resolve_cost or 0.0,
                            commit_cost=commit_cost or 0.0,
                            max_inflight=max_inflight or 2048,
                            out=print)
        doc["cells"]["tcp"][f"{processes}x{resolvers or processes}"] = \
            cell
        doc["headline"] = {
            "tcp_divergent_verdicts": cell["divergent_verdicts"]}
        if cell["divergent_verdicts"] or cell["committed"] == 0:
            with open(out_path, "w") as fh:
                json.dump(doc, fh, indent=2, sort_keys=True)
            print("FAIL: divergent verdicts or zero commits")
            return 1
    else:
        p, r = proxies or 2, resolvers or 2
        doc = {"metric": "system_committed_txn_per_s",
               "cells": {"inprocess": {
                   f"{p}x{r}": run_inprocess_cell(
                       p, r, seed=seed, duration=duration or 2.0,
                       rate=rate or 12000.0, out=print)}}}
    with open(out_path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
    # final summary line names the trace run dir when one exists so a
    # human (or CI log grep) can hand it straight to tracemerge
    dirs = sorted({c["run_dir"] for cells in doc["cells"].values()
                   for c in cells.values() if c.get("run_dir")})
    suffix = f" trace-run-dir={dirs[0]}" if dirs else ""
    print(f"report -> {out_path}{suffix}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
