"""Role host: one OS process hosting one externally-recruited cluster
role (resolver or tlog) behind fixed TCP tokens.

The reference runs every role in its own `fdbserver` process (SURVEY
layer 4: worker -> {master, proxy, resolver, tlog, storage}); this is
that shape for the resolver and tlog halves of the commit pipeline
(ROADMAP item 2). The cluster host recruits a role here with an init
RPC over the control token, then every proxy — in-host or a
clusterbench worker process — fans resolves/commits out to this
process over rpc/tcp.py. Token layout is FIXED so a respawned host on
the same port serves the same refs (the reference re-recruits after a
process death; we instead make the endpoint survive it, which is what
lets a kill -9 heal without a whole-cluster recovery):

    control = 1
    resolver: resolves = 2, metrics = 3, handoffs = 4, status = 5
    tlog:     commits = 2, peeks = 3, pops = 4, locks = 5, status = 6

Resolver recovery plane (the failover wrapper's checkpoint + replay
discipline moved across the process boundary): every accepted
resolve/install request is journaled (length-prefixed rpc/wire
frames, flushed before the role can reply), and a checkpoint actor
periodically persists the conflict state TOGETHER WITH the
duplicate-delivery reply cache — without the
cache, a proxy retrying a batch at-or-below the checkpoint version
after a kill -9 would hit the aged-out conflict-everything path and
diverge. On respawn the host restores the checkpoint, replays the
gapless journal prefix above it (modeled service cost disarmed), and
only then opens the pumps; batches lost in flight are re-driven by the
proxies' RetryingTcpRefs and land on the restored reply cache /
version chain idempotently.

A resolver on a CUDA backend runs where the cfg's `device` says (None:
the card; "cpu": the kernels' plain versions), and its checkpoint is
restored onto that device. A missing card (NoCudaDeviceError) or a
device fault past the retries (DeviceFaultError), at the first init,
in a resolve or in the respawn's recovery, ends the process with that
error (nonzero exit, the traceback in its log): it never serves a CPU
verdict in the card's place, and its respawn fails the same way. The
status reply carries the process's kernel counters (`kernels`, with
`launches.<kernel>`, as the cluster's status does).
"""

from __future__ import annotations

import json
import os
import struct
import sys
import time
from typing import List, Optional

from .. import flow
from ..flow import rng as _rng
from ..flow.future import Promise

CONTROL_TOKEN = 1
RESOLVER_TOKENS = {"resolves": 2, "metrics": 3, "handoffs": 4,
                   "status": 5}
TLOG_TOKENS = {"commits": 2, "peeks": 3, "pops": 4, "locks": 5,
               "status": 6}

_REC_HDR = struct.Struct("<BI")     # tag, payload length
REC_RESOLVE, REC_INSTALL = 0, 1


class _LocalReply:
    """Reply sink for journal replay: verdicts recomputed during replay
    go nowhere (their proxies already have them, or will retry)."""

    __slots__ = ("promise",)

    def __init__(self):
        self.promise = Promise()

    def send(self, value=None) -> None:
        if not self.promise.is_set:
            self.promise.send(value)

    def send_error(self, err) -> None:
        if not self.promise.is_set:
            self.promise.send_error(err)


class ResolverJournal:
    """Segmented on-disk journal + checkpoint for an external resolver.

    Segments rotate at each checkpoint; a rotated segment is deleted
    once the checkpointed version covers every resolve it holds (its
    max recorded version), so any record above the checkpoint version
    survives — the replayable chain is complete by construction."""

    def __init__(self, state_dir: str):
        self.dir = state_dir
        os.makedirs(state_dir, exist_ok=True)
        self._seg_max: dict[int, int] = {}     # seq -> max resolve version
        self._seq = 0
        self._fh = None

    # -- paths -----------------------------------------------------------
    def _seg_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"journal.{seq:06d}.bin")

    @property
    def ckpt_path(self) -> str:
        return os.path.join(self.dir, "ckpt.bin")

    @property
    def init_path(self) -> str:
        return os.path.join(self.dir, "init.json")

    def segments(self) -> List[int]:
        seqs = []
        for f in os.listdir(self.dir):
            if f.startswith("journal.") and f.endswith(".bin"):
                seqs.append(int(f.split(".")[1]))
        return sorted(seqs)

    def has_state(self) -> bool:
        return os.path.exists(self.init_path)

    # -- writing ---------------------------------------------------------
    def open_segment(self, seq: Optional[int] = None) -> None:
        if self._fh is not None:
            self._fh.close()
        self._seq = self._seq + 1 if seq is None else seq
        self._fh = open(self._seg_path(self._seq), "ab")
        self._seg_max.setdefault(self._seq, 0)

    def append(self, tag: int, payload: bytes, version: int = 0) -> None:
        self._fh.write(_REC_HDR.pack(tag, len(payload)) + payload)
        self._fh.flush()
        if version > self._seg_max.get(self._seq, 0):
            self._seg_max[self._seq] = version

    def write_init(self, doc: dict) -> None:
        tmp = self.init_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(doc, fh)
        os.replace(tmp, self.init_path)

    def read_init(self) -> dict:
        with open(self.init_path) as fh:
            return json.load(fh)

    def write_checkpoint(self, doc_bytes: bytes, version: int) -> None:
        tmp = self.ckpt_path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(doc_bytes)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.ckpt_path)
        # rotate, then retire every rotated segment the checkpoint
        # fully covers
        self.open_segment()
        for seq in list(self._seg_max):
            if seq != self._seq and self._seg_max[seq] <= version:
                try:
                    os.unlink(self._seg_path(seq))
                except OSError:
                    pass
                del self._seg_max[seq]

    # -- reading ---------------------------------------------------------
    def read_checkpoint(self) -> Optional[bytes]:
        try:
            with open(self.ckpt_path, "rb") as fh:
                return fh.read()
        except OSError:
            return None

    def read_records(self) -> list:
        """All surviving (tag, payload) records in write order; a torn
        tail record (the kill landed mid-write) is dropped."""
        from ..rpc import wire
        out = []
        for seq in self.segments():
            with open(self._seg_path(seq), "rb") as fh:
                buf = fh.read()
            off = 0
            while off + _REC_HDR.size <= len(buf):
                tag, ln = _REC_HDR.unpack_from(buf, off)
                off += _REC_HDR.size
                if off + ln > len(buf):
                    break
                try:
                    out.append((tag, wire.from_bytes(buf[off:off + ln],
                                                     None)))
                except wire.WireError:
                    break
                off += ln
            # rebuild the rotation bookkeeping for this boot
            self._seg_max[seq] = max(
                [r.version for t, r in out if t == REC_RESOLVE] or [0])
        return out


# ----------------------------------------------------------------- worker
def run_rolehost(cfg: dict) -> int:
    """Role-host process entry. cfg: role (resolver|tlog), name, index,
    port (0 first boot, pinned on respawn), run_dir, state_dir
    (resolver persistence), seed, backend, resolve_cost,
    checkpoint_every, trace, trace_roll_size, host, device (where a
    CUDA resolver runs: None is the card, "cpu" the plain versions)."""
    prev_sched = flow.get_scheduler()
    prev_rng = _rng.rng_state()
    transport = None
    try:
        from ..device import NoCudaDeviceError
        from ..ops.fault_injection import DeviceFaultError
        from ..rpc.network import SimNetwork
        from ..rpc.tcp import TcpRequestStream, TcpTransport
        from ..server.cluster_controller import _global_kernel_counters
        from ..server.process_metrics import ProcessMetrics, \
            loop_lag_probe
        from .clusterbench import worker_trace_setup, write_proc_file

        role_kind = cfg["role"]
        name = cfg["name"]
        flow.set_seed(int(cfg.get("seed", 0)))
        s = flow.Scheduler(virtual=False)
        flow.set_scheduler(s)
        transport = TcpTransport(port=int(cfg.get("port", 0)))
        cfg = dict(cfg, port=transport.port)
        worker_trace_setup(name, cfg)
        net = SimNetwork(s, flow.g_random)
        proc = net.new_process(name, machine=name)
        metrics = ProcessMetrics(role=name)

        control = TcpRequestStream(transport)
        assert control.token == CONTROL_TOKEN
        tokens = RESOLVER_TOKENS if role_kind == "resolver" \
            else TLOG_TOKENS
        streams = {}
        for key in tokens:
            st = TcpRequestStream(transport)
            assert st.token == tokens[key], (key, st.token)
            streams[key] = st

        run_dir = cfg.get("run_dir")
        if run_dir:
            write_proc_file(run_dir, name, transport.port,
                            tokens["status"])
        state = {"role": None, "fatal": None,
                 "counters": {"requests": 0,
                                            "journaled": 0,
                                            "replayed": 0,
                                            "checkpoints": 0}}
        started = time.perf_counter()
        pid = os.getpid()
        journal = (ResolverJournal(cfg["state_dir"])
                   if role_kind == "resolver" and cfg.get("state_dir")
                   else None)

        def write_ready() -> None:
            if not run_dir:
                return
            path = os.path.join(run_dir, f"ready.{name}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump({"name": name, "role": role_kind, "pid": pid,
                           "host": cfg.get("host", "127.0.0.1"),
                           "port": transport.port,
                           "tokens": dict(tokens),
                           "control": CONTROL_TOKEN,
                           "recovered": journal is not None
                           and journal.has_state()}, fh)
            os.replace(tmp, path)

        def fatal(e: BaseException) -> None:
            """A missing card or a lost device: keep the first error
            and stop the loop; run_rolehost raises it."""
            if state["fatal"] is None:
                state["fatal"] = e
            s.stop()

        # ---------------------------------------------------- role build
        def build_resolver(recovery_version: int, backend: str):
            from ..server.resolver_role import Resolver
            r = Resolver(proc, backend=backend,
                         recovery_version=recovery_version,
                         device=cfg.get("device"), on_fatal=fatal)
            r.start()
            return r

        def build_tlog(store: str, recovery_version: int):
            from ..server.tlog import TLog
            t = TLog(proc, disk=None, name=store,
                     recovery_version=recovery_version)
            t.start()
            return t

        async def feed(stream, req):
            reply = _LocalReply()
            stream.stream.send((req, reply))
            return await flow.timeout_error(reply.promise.future, 60.0)

        async def recover_resolver():
            """Respawn path: checkpoint + reply cache restore, then the
            gapless journal prefix replayed with the modeled cost
            disarmed — deterministic recompute, not re-resolution."""
            from ..rpc import wire
            init = journal.read_init()
            records = journal.read_records()
            ck = journal.read_checkpoint()
            version = int(init["recovery_version"])
            doc = None
            if ck is not None:
                doc = wire.from_bytes(ck, None)
                version = int(doc["version"])
            flow.SERVER_KNOBS.set("sim_resolve_cost_per_txn", 0.0)
            role = build_resolver(version, init.get("backend", "python"))
            if doc is not None:
                role.conflict_set.restore(doc["ckpt"])
                role._reply_cache = dict(doc["replies"])
                from collections import deque
                role._reply_order = deque(doc["order"])
            # installs always re-graft (pointwise max: idempotent);
            # resolves replay only the gapless chain above the
            # checkpoint — anything past a hole was never replied and
            # the proxies' retries re-drive it live
            cur = version
            resolves = sorted(
                {r.version: r for t, r in records
                 if t == REC_RESOLVE}.values(),
                key=lambda r: r.version)
            installs = [r for t, r in records if t == REC_INSTALL]
            for req in installs:
                await feed(role.handoffs, req)
            for req in resolves:
                if req.version <= cur:
                    continue
                if req.prev_version > cur:
                    break
                await feed(role.resolves, req)
                cur = req.version
                state["counters"]["replayed"] += 1
            journal.open_segment(max(journal.segments() or [0]) + 1)
            flow.SERVER_KNOBS.set("sim_resolve_cost_per_txn",
                                  float(cfg.get("resolve_cost", 0.0)))
            flow.TraceEvent("RoleHostRecovered", name).detail(
                CheckpointVersion=version, ReplayTo=cur,
                Replayed=state["counters"]["replayed"]).log()
            return role

        # --------------------------------------------------------- pumps
        def forward(stream_key: str, role_stream) -> None:
            async def pump():
                st = streams[stream_key]
                while True:
                    req, reply = await st.pop()
                    state["counters"]["requests"] += 1
                    role_stream.stream.send((req, reply))
            flow.spawn(pump(), name=f"{name}.{stream_key}")

        def forward_journaled(stream_key: str, role_stream, tag: int,
                              version_of) -> None:
            from ..rpc import wire

            async def pump():
                st = streams[stream_key]
                while True:
                    req, reply = await st.pop()
                    state["counters"]["requests"] += 1
                    try:
                        journal.append(tag, wire.to_bytes(req),
                                       version_of(req))
                        state["counters"]["journaled"] += 1
                    except wire.WireError:
                        pass    # non-replayable (e.g. checkpoint park)
                    role_stream.stream.send((req, reply))
            flow.spawn(pump(), name=f"{name}.{stream_key}")

        async def handoff_pump(role) -> None:
            """Handoffs split by type: installs (state grafts) are
            journaled, checkpoint parks are pass-through."""
            from ..rpc import wire
            from ..server.types import ResolverInstallRequest
            st = streams["handoffs"]
            while True:
                req, reply = await st.pop()
                state["counters"]["requests"] += 1
                if journal is not None and \
                        isinstance(req, ResolverInstallRequest):
                    journal.append(REC_INSTALL, wire.to_bytes(req))
                    state["counters"]["journaled"] += 1
                role.handoffs.stream.send((req, reply))

        async def status_loop():
            st = streams["status"]
            while True:
                _req, reply = await st.pop()
                role = state["role"]
                doc = {"process": f"{name}:{pid}", "role": role_kind,
                       "name": name, "pid": pid, "machine_id": name,
                       "uptime_s": round(
                           time.perf_counter() - started, 3),
                       "counters": dict(state["counters"]),
                       "process_metrics": metrics.sample(),
                       "flightrec": flow.g_flightrec.status(),
                       "kernels": _global_kernel_counters()}
                if role is not None and role_kind == "resolver":
                    doc["version"] = role.version.get()
                reply.send(doc)

        async def control_loop():
            while True:
                req, reply = await control.pop()
                try:
                    op = req.get("type")
                    if op == "init":
                        if state["role"] is None:
                            if journal is not None:
                                journal.write_init(
                                    {"name": req.get("store", name),
                                     "recovery_version":
                                         int(req["recovery_version"]),
                                     "backend": req.get("backend",
                                                        "python")})
                                journal.open_segment(0)
                            if role_kind == "resolver":
                                flow.SERVER_KNOBS.set(
                                    "sim_resolve_cost_per_txn",
                                    float(cfg.get("resolve_cost", 0.0)))
                                role = build_resolver(
                                    int(req["recovery_version"]),
                                    req.get("backend", "python"))
                                start_resolver_pumps(role)
                            else:
                                role = build_tlog(
                                    req.get("store", name),
                                    int(req["recovery_version"]))
                                start_tlog_pumps(role)
                            state["role"] = role
                        reply.send({"ok": True, "pid": pid})
                    elif op == "set_expected_replicas":
                        mapping = {int(k): tuple(v) for k, v in
                                   dict(req["expected"]).items()}
                        state["role"].set_expected_replicas(mapping)
                        reply.send({"ok": True})
                    elif op == "ping":
                        reply.send({"ok": True, "pid": pid,
                                    "ready": state["role"] is not None})
                    elif op == "trace_flush":
                        # the host merges trace files while this
                        # process is still alive — push buffered spans
                        # (TraceBatch holds them below MAX_BUFFERED)
                        # out to disk so tracemerge sees this leg
                        flow.g_trace_batch.dump()
                        flow.g_trace.flush()
                        reply.send({"ok": True})
                    else:
                        reply.send_error(flow.error(
                            "client_invalid_operation"))
                except (NoCudaDeviceError, DeviceFaultError) as e:
                    reply.send_error(flow.error("internal_error"))
                    fatal(e)
                    return
                except flow.FdbError as e:
                    if e.name == "operation_cancelled":
                        raise
                    reply.send_error(e)
                except Exception:  # noqa: BLE001 — one bad frame
                    reply.send_error(flow.error("internal_error"))

        def start_resolver_pumps(role) -> None:
            forward_journaled("resolves", role.resolves, REC_RESOLVE,
                              lambda r: r.version) \
                if journal is not None else \
                forward("resolves", role.resolves)
            forward("metrics", role.metrics)
            flow.spawn(handoff_pump(role), name=f"{name}.handoffs")
            if journal is not None:
                flow.spawn(checkpoint_loop(role), name=f"{name}.ckpt")

        def start_tlog_pumps(role) -> None:
            forward("commits", role.commits)
            forward("peeks", role.peeks)
            forward("pops", role.pops)
            forward("locks", role.locks)

        async def checkpoint_loop(role) -> None:
            from ..rpc import wire
            every = float(cfg.get("checkpoint_every", 1.0))
            while True:
                await flow.delay(every)
                if role._inflight:
                    continue    # state mid-pipeline: next tick
                doc = {"version": role.version.get(),
                       "ckpt": role.conflict_set.checkpoint(),
                       "replies": dict(role._reply_cache),
                       "order": list(role._reply_order)}
                try:
                    payload = wire.to_bytes(doc)
                except wire.WireError:
                    continue    # backend without a wire-able checkpoint
                journal.write_checkpoint(payload, doc["version"])
                state["counters"]["checkpoints"] += 1

        async def trace_flush_loop():
            # span dumps otherwise wait for process exit (the finally
            # below) — but a kill -9 never gets there, and the soak's
            # tracemerge runs while this process is still serving.
            # Cheap: dump() walks only what's buffered since last time.
            while True:
                await flow.delay(5.0)
                flow.g_trace_batch.dump()
                flow.g_trace.flush()

        async def main():
            transport.start()
            flow.spawn(status_loop(), name=f"{name}.status")
            flow.spawn(loop_lag_probe(metrics))
            flow.spawn(trace_flush_loop(), name=f"{name}.traceflush")
            if journal is not None and journal.has_state():
                try:
                    role = await recover_resolver()
                except (NoCudaDeviceError, DeviceFaultError) as e:
                    fatal(e)
                    return
                state["role"] = role
                start_resolver_pumps(role)
            flow.spawn(control_loop(), name=f"{name}.control")
            write_ready()
            while True:     # the driver owns this process's lifetime
                await flow.delay(3600.0)

        t = s.spawn(main())
        try:
            s.run(until=t)
        finally:
            if state["fatal"] is not None:
                raise state["fatal"]
        return 0
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


# ----------------------------------------------------- host-side directory
class ExternalRoles:
    """The cluster host's directory of externally-hosted roles.

    Attach one to a SimCluster BEFORE its first scheduler tick
    (`cluster.cc.external_roles = ext`): the master's recruitment phase
    then recruits resolvers/tlogs here — an init RPC per role host over
    its control token — instead of on in-process workers, and stashes
    the addr-carrying peer descriptors the TcpGateway serves to worker
    processes. All refs handed back are RetryingTcpRefs, so a role
    process kill -9 + same-port respawn heals through role idempotency
    instead of surfacing as broken_promise."""

    def __init__(self, resolvers=(), tlogs=(),
                 host: str = "127.0.0.1"):
        # each entry: the role host's ready-file doc (port + tokens)
        self.resolvers = list(resolvers)
        self.tlogs = list(tlogs)
        self.host = host
        self._transport = None
        self._names: dict = {}

    @property
    def n_resolvers(self) -> int:
        return len(self.resolvers)

    @property
    def n_tlogs(self) -> int:
        return len(self.tlogs)

    def _tp(self):
        if self._transport is None:
            from ..rpc.tcp import TcpTransport
            self._transport = TcpTransport()
            self._transport.start()
        return self._transport

    def _ref(self, entry: dict, key: str, retry: bool = True):
        from ..rpc.tcp import RetryingTcpRef
        token = entry["tokens"][key] if key != "control" \
            else CONTROL_TOKEN
        ref = self._tp().ref(entry.get("host", self.host),
                             int(entry["port"]), token)
        return RetryingTcpRef(ref) if retry else ref

    async def _control(self, entry: dict, request: dict) -> dict:
        ctrl = self._ref(entry, "control")
        return await flow.timeout_error(ctrl.get_reply(request), 60.0)

    async def recruit_resolver(self, i: int, name: str,
                               recovery_version: int, backend: str):
        entry = self.resolvers[i]
        await self._control(entry, {"type": "init", "store": name,
                                    "recovery_version": recovery_version,
                                    "backend": backend})
        self._names[("resolver", i)] = name
        return (self._ref(entry, "resolves"),
                self._ref(entry, "metrics"),
                self._ref(entry, "handoffs"))

    async def recruit_tlog(self, i: int, store: str,
                           recovery_version: int):
        from ..server.dbinfo import LogRefs
        entry = self.tlogs[i]
        await self._control(entry, {"type": "init", "store": store,
                                    "recovery_version": recovery_version})
        self._names[("tlog", i)] = store
        return LogRefs(store, entry.get("name", f"ext-tlog-{i}"),
                       self._ref(entry, "commits"),
                       self._ref(entry, "peeks"),
                       self._ref(entry, "pops"),
                       self._ref(entry, "locks"))

    async def flush_traces(self) -> int:
        """Ask every live role process to dump its buffered trace
        spans to disk NOW — the host calls this right before
        tracemerge reads the run directory, so the externally-hosted
        resolver/tlog legs of the commit chains are on disk instead of
        parked in each process's TraceBatch buffer. Best-effort: a
        mid-respawn process is skipped, not fatal. Returns the number
        of processes that acknowledged."""
        acked = 0
        for entry in list(self.resolvers) + list(self.tlogs):
            try:
                await self._control(entry, {"type": "trace_flush"})
                acked += 1
            except flow.FdbError:
                continue
        return acked

    async def set_expected_replicas(self, i: int, expected: dict) -> None:
        await self._control(self.tlogs[i],
                            {"type": "set_expected_replicas",
                             "expected": {int(k): tuple(v)
                                          for k, v in expected.items()}})

    def resolver_descriptors(self) -> list:
        return [{"name": self._names.get(("resolver", i),
                                         e.get("name", f"ext-resolver-{i}")),
                 "addr": [e.get("host", self.host), int(e["port"])],
                 "resolves": e["tokens"]["resolves"],
                 "handoffs": e["tokens"]["handoffs"]}
                for i, e in enumerate(self.resolvers)]

    def tlog_descriptors(self) -> list:
        return [{"addr": [e.get("host", self.host), int(e["port"])],
                 "commits": e["tokens"]["commits"]}
                for e in self.tlogs]

    def close(self) -> None:
        if self._transport is not None:
            self._transport.close()
            self._transport = None


def flush_role_traces(entries, host: str = "127.0.0.1",
                      timeout: float = 5.0) -> int:
    """Synchronous best-effort trace flush across live role processes:
    ask each one (by its ready-file doc) to dump its buffered spans to
    disk NOW. Hosts its own wall-clock loop with the ambient
    scheduler/RNG restored on exit (the networktest discipline), so
    the cluster host can call it AFTER its sim scheduler has finished
    — which is exactly when the soak merges the run directory. A
    process that no longer answers (mid-respawn) is skipped. Returns
    the number of processes that acknowledged."""
    from .. import flow
    from ..flow import rng as _rng
    from ..rpc.tcp import TcpTransport
    entries = [e for e in entries if e and e.get("port")]
    if not entries:
        return 0
    prev_sched = flow.get_scheduler()
    prev_rng = _rng.rng_state()
    transport = None
    try:
        flow.set_seed(0)
        s = flow.Scheduler(virtual=False)
        flow.set_scheduler(s)
        transport = TcpTransport()

        async def one(entry: dict) -> int:
            ref = transport.ref(entry.get("host", host),
                                int(entry["port"]), CONTROL_TOKEN)
            try:
                await flow.timeout_error(
                    ref.get_reply({"type": "trace_flush"}), timeout)
                return 1
            except flow.FdbError:
                return 0

        async def run():
            transport.start()
            return sum(await flow.wait_for_all(
                [flow.spawn(one(e)) for e in entries]))

        t = s.spawn(run())
        return s.run(until=t, timeout_time=timeout * len(entries) + 30)
    finally:
        if transport is not None:
            transport.close()
        flow.set_scheduler(prev_sched)
        _rng.restore_rng_state(prev_rng)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--worker":
        return run_rolehost(json.loads(argv[1]))
    print("usage: rolehost --worker '<json cfg>'")
    return 2


if __name__ == "__main__":
    sys.exit(main())
