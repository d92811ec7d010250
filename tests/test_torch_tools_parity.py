"""The port's operator tools held against the reference
(`foundationdb_tpu`) on the same inputs, exactly unless a case says
what it masks:

- a resolver role host (`tools.rolehost`, spawned by
  `clusterbench.RoleProcs`) driven by a raw loopback socket with the
  reference test's seeded batch stream (`_rand_batches(424242, 30)`), a
  checkpoint after batch 15, a SIGKILL after batch 19, a respawn on the
  pinned port and a resend of batch 19: every byte the role host writes
  back (its reply frames),
  its journal segment files, its checkpoint file, its init record and
  its status counters; on `python` in both packages, and on `cuda` at
  device="cpu" against `tpu` (the init record's backend name aside);
- `exporter.render_prometheus` of one status document in both
  packages, and of each package's own status at one seed with the
  host-clock fields masked and the kernel sections dropped;
- `tracemerge.merge`, `path_decomposition` and `render_folded` over one
  run directory that the reference's cross-process bench wrote;
- `simprof.run_storm` at one seed, the wall-clock fields dropped;
- `incident.capture_bundle`'s files at one seed, the host-clock fields
  of its status file masked;
- a short `soak.run_soak` on `python` (its document without the
  wall-clock fields, and its keyspace digest);
- the C client's replies from the port's gateway and the reference's.

Each package runs under its own scheduler in turn, never both at once.
"""

import importlib
import json
import os
import re
import socket
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

REF, PORT = "foundationdb_tpu", "foundationdb_tpu_torch"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# -- the role host -----------------------------------------------------------

#: batches before the checkpoint, then before the kill; the respawn
#: replays the second group from the journal above the checkpoint
ROLE_CKPT_AT, ROLE_KILL_AT = 15, 19


def _rand_batches(pkg, seed, n_batches):
    """tests/test_role_processes.py's `_rand_batches`, on `pkg`'s types."""
    import random
    types = _mod(pkg, "server.types")
    mwtlv = int(_mod(pkg, "server.proxy").MWTLV)
    rng = random.Random(seed)
    out = []
    v = mwtlv

    def key():
        return bytes([rng.randrange(1, 250)]) + b"%02d" % rng.randrange(30)

    def rd():
        k = key()
        if rng.random() < 0.1:
            return (k, k)
        return (k, k + bytes([rng.randrange(1, 8)]))

    prev = 0
    for _ in range(n_batches):
        v += rng.randrange(1, mwtlv // 3)
        batch = []
        for _ in range(rng.randrange(1, 5)):
            reads = tuple(rd() for _ in range(rng.randrange(0, 3)))
            writes = tuple(rd() for _ in range(rng.randrange(0, 3)))
            snap = max(0, v - rng.randrange(0, 2 * mwtlv))
            batch.append(types.CommitRequest(snap, reads, writes, (),
                                             report_conflicting_keys=True))
        out.append(types.ResolveRequest(prev, v, tuple(batch)))
        prev = v
    return out


class _RawPeer:
    """A client that speaks the TCP transport's framing by hand: the
    protocol tag, then one request frame at a time, reading back the
    role host's reply frame as raw bytes."""

    def __init__(self, pkg, port):
        self.tcp = _mod(pkg, "rpc.tcp")
        self.wire = _mod(pkg, "rpc.wire")
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=60)
        self.sock.sendall(self.tcp.PROTOCOL_VERSION)
        self.req_id = 0

    def call(self, token, msg) -> bytes:
        payload = self.wire.to_bytes(msg)
        self.req_id += 1
        self.sock.sendall(self.tcp._HDR.pack(
            len(payload), self.tcp.K_REQUEST, self.req_id, token) + payload)
        hdr = self.tcp._read_exact(self.sock, self.tcp._HDR.size)
        ln, kind, req_id, _token = self.tcp._HDR.unpack(hdr)
        assert req_id == self.req_id and kind == self.tcp.K_REPLY, \
            (kind, self.wire.from_bytes(self.tcp._read_exact(self.sock, ln),
                                        None))
        return hdr + self.tcp._read_exact(self.sock, ln)

    def close(self):
        self.sock.close()


def _status(peer, token):
    raw = peer.call(token, None)
    doc = peer.wire.from_bytes(raw[peer.tcp._HDR.size:], None)
    return {k: doc.get(k) for k in ("role", "counters", "version")}


def _role_host_run(pkg, backend, tmp, **kw):
    """Drive one resolver role host of `pkg` through three incarnations:
    the init and batches 0-15 with a short checkpoint period, killed
    once a checkpoint has landed after batch 15 (the pipeline idle: it
    covers batch 15, whatever the earlier ticks took); a respawn that
    restores it and takes batches 16-19; a SIGKILL, a respawn that
    replays 16-19 above the checkpoint, a resend of batch 19 (the reply
    cache) and batches 20-29. Returns the reply frames, the journal
    segments in order, the checkpoint file, the init record and the
    status of each incarnation."""
    import time
    cb = _mod(pkg, "tools.clusterbench")
    rh = _mod(pkg, "tools.rolehost")
    batches = _rand_batches(pkg, 424242, 30)
    run_dir = os.path.join(tmp, pkg)
    os.makedirs(run_dir)
    roles = cb.RoleProcs(n_resolvers=1, run_dir=run_dir,
                         state_root=os.path.join(run_dir, "state"),
                         seed=41, checkpoint_every=3600.0, **kw)
    resolves = rh.RESOLVER_TOKENS["resolves"]
    status = rh.RESOLVER_TOKENS["status"]
    frames, statuses = [], []

    def incarnation(body, every=3600.0, first=False):
        roles.checkpoint_every = every
        if first:
            roles.spawn_all()
        else:
            roles.kill("resolver", 0)
            roles.respawn("resolver", 0)
        roles.wait_ready(timeout=120)
        peer = _RawPeer(pkg, roles.ready[("resolver", 0)]["port"])
        try:
            body(peer)
            statuses.append(_status(peer, status))
        finally:
            peer.close()

    def first(peer):
        frames.append(peer.call(rh.CONTROL_TOKEN, {
            "type": "init", "store": "parity-r0", "recovery_version": 0,
            "backend": backend}))
        for req in batches[:ROLE_CKPT_AT + 1]:
            frames.append(peer.call(resolves, req))
        # a checkpoint step is one loop step: one counted after this
        # status began after batch 15's reply
        seen = _status(peer, status)["counters"]["checkpoints"]
        deadline = time.monotonic() + 60
        while _status(peer, status)["counters"]["checkpoints"] <= seen:
            assert time.monotonic() < deadline, "no checkpoint"
            time.sleep(0.05)

    def until_kill(peer):
        for req in batches[ROLE_CKPT_AT + 1:ROLE_KILL_AT + 1]:
            frames.append(peer.call(resolves, req))

    def after_kill(peer):
        for req in batches[ROLE_KILL_AT:]:
            frames.append(peer.call(resolves, req))

    try:
        incarnation(first, every=0.2, first=True)
        incarnation(until_kill)
        incarnation(after_kill)
    finally:
        roles.terminate_all()
    state = os.path.join(run_dir, "state", "ext-resolver-0")

    def read(name):
        with open(os.path.join(state, name), "rb") as fh:
            return fh.read()

    # the segments in order: their numbers count the short period's
    # checkpoints, which the host clock sets
    segs = [read(n) for n in sorted(os.listdir(state))
            if n.startswith("journal.")]
    return (frames, segs, read("ckpt.bin"), json.loads(read("init.json")),
            statuses)


@pytest.mark.parametrize("ref_backend,port_backend,kw", (
    ("python", "python", {}),
    ("tpu", "cuda", {"device": "cpu"}),
), ids=("python", "cuda"))
def test_role_host_bytes_equal(ref_backend, port_backend, kw, tmp_path):
    ref = _role_host_run(REF, ref_backend, str(tmp_path))
    port = _role_host_run(PORT, port_backend, str(tmp_path), **kw)
    frames, segs, ckpt, init, statuses = ref
    assert len(frames) == 1 + 30 + 1 and len(segs) == 3 and segs[0] == b""
    assert [st["counters"]["replayed"] for st in statuses] == [0, 0, 4]
    assert [st["counters"]["checkpoints"] > 0 for st in statuses] == \
        [True, False, False]
    assert frames[ROLE_KILL_AT + 2] == frames[-11]   # the cached resend
    # the init's reply names the host's pid
    wire = _mod(PORT, "rpc.wire")
    hdr = _mod(PORT, "rpc.tcp")._HDR.size
    inits = [wire.from_bytes(f[0][hdr:], None) for f in (port[0], frames)]
    assert inits[0].pop("pid") != inits[1].pop("pid")
    assert inits[0] == inits[1] == {"ok": True}
    assert port[0][1:] == frames[1:]
    assert port[1] == segs
    assert port[2] == ckpt
    assert init.pop("backend") == ref_backend
    assert port[3].pop("backend") == port_backend
    assert port[3] == init
    for got, want in zip(port[4], statuses):
        if got["counters"]["checkpoints"] or want["counters"]["checkpoints"]:
            # the short period's ticks are the host clock's
            got["counters"]["checkpoints"] = \
                want["counters"]["checkpoints"] = 1
        assert got == want


# -- the exporter -------------------------------------------------------------

def _status_doc(pkg, seed, **kw):
    """Each package's own status document after a small conflicting
    workload on a virtual cluster at `seed`."""
    flow = _mod(pkg, "flow")
    SimCluster = _mod(pkg, "server").SimCluster
    run_transaction = _mod(pkg, "client").run_transaction
    faults = _mod(pkg, "ops.fault_injection").g_device_faults.injected
    saved = dict(faults)
    faults.update(dict.fromkeys(faults, 0))
    flow.reset_server_knobs(randomize=False)
    flow.set_seed(seed)
    c = SimCluster(seed=seed, durable=True, **kw)
    try:
        db = c.client("prom")

        async def main():
            async def seed_rows(tr):
                tr.set(b"hot", b"0")
            await run_transaction(db, seed_rows)
            for i in range(6):
                tr = db.create_transaction()
                tr.set_option("report_conflicting_keys")
                await tr.get(b"hot")
                tr.set(b"mine%d" % i, b"v")

                async def bump(t2):
                    t2.set(b"hot", b"x")
                await run_transaction(db, bump)
                try:
                    await tr.commit()
                except flow.FdbError:
                    pass
            return await db.get_status()

        return _drop_process_wide(c.run(main(), timeout_time=300))
    finally:
        c.shutdown()
        flow.reset_server_knobs(randomize=False)
        faults.update(saved)


def _drop_process_wide(doc):
    """A status document without the sections that count the whole
    process (earlier tests' work adds to them): the kernel counters,
    the coverage sites, the client profiler's, the client conflict
    windows' and the client throttle cache's counters."""
    cl = doc["cluster"]
    for key in ("kernels", "coverage", "client_profile"):
        cl.pop(key, None)
    for key in ("conflict_scheduling", "admission_control"):
        (cl.get(key) or {}).pop("client", None)
    return doc


#: families whose values the host clock sets (the run loop's busy time
#: and slow tasks, sim seconds a busy second, the resolve pipeline's
#: submit and drain latencies, the process's CPU and memory), that
#: count process-wide kernel work, or that only the port's resolver
#: reports (its host phases and waits, its one-call batches, its exact
#: live rows)
_HOST_FAMILIES = re.compile(
    r"^fdbtpu_(run_loop_(busy|slow)\w*|sim_per_busy\w*"
    r"|resolve_pipeline_latency\w*|process_\w+|kernel_profile"
    r"|kernel_host_\w+|kernel_one_call_batches|kernel_live_rows)\b")


def _prom_norm(text, backend=None):
    out = []
    for line in text.split("\n"):
        name = line.split(" ")[2] if line.startswith("# ") else \
            line.split("{")[0].split(" ")[0]
        if _HOST_FAMILIES.match(name):
            continue
        if backend is not None:
            line = re.sub(r'"(cuda|tpu)"', f'"{backend}"', line)
        out.append(line)
    return "\n".join(out)


def test_render_prometheus_of_one_document_equal():
    """One status document, the reference cluster's (without its kernel
    section: the port labels its `launches.<kernel>` counters there),
    rendered by both packages: the same text."""
    doc = _status_doc(REF, 4242)
    ref = _mod(REF, "tools.exporter").render_prometheus(doc)
    port = _mod(PORT, "tools.exporter").render_prometheus(doc)
    assert len(ref.split("\n")) > 300
    assert port == ref


@pytest.mark.parametrize("ref_backend,port_backend,kw", (
    ("python", "python", {}),
    ("tpu", "cuda", {"device": "cpu"}),
), ids=("python", "cuda"))
def test_render_prometheus_of_each_status_equal(ref_backend, port_backend,
                                                kw):
    """Each package's own status at one seed, rendered by its own
    exporter: equal up to what the host clock sets, the process-wide
    counters and the backend's name."""
    ref = _mod(REF, "tools.exporter").render_prometheus(
        _status_doc(REF, 4243, conflict_backend=ref_backend))
    port = _mod(PORT, "tools.exporter").render_prometheus(
        _status_doc(PORT, 4243, conflict_backend=port_backend, **kw))
    assert _prom_norm(port, "dev") == _prom_norm(ref, "dev")


# -- tracemerge ---------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_run_dir(tmp_path_factory):
    """A run directory the reference's cross-process bench writes once:
    the cluster host, a proxy worker, a resolver and a tlog role host,
    each with its own trace file, commits sampled 1 in 4."""
    cb = _mod(REF, "tools.clusterbench")
    run_dir = str(tmp_path_factory.mktemp("ref_run"))
    cell = cb.run_tcp_cell(1, 1, seed=77, duration=1.5, rate=60.0,
                           run_dir=run_dir, trace=True, sample_every=4,
                           role_processes=True)
    assert cell["committed"] > 0 and cell["divergent_verdicts"] == 0, cell
    return run_dir


def _merge_views(pkg, run_dir):
    tm = _mod(pkg, "tools.tracemerge")
    merged = tm.merge(run_dir)
    return (json.dumps(merged, sort_keys=True, default=repr),
            json.dumps(tm.path_decomposition(merged), sort_keys=True),
            tm.render_folded(merged), tm.render_report(merged),
            len(tm.cross_process_chains(merged)),
            len(tm.full_commit_chains(merged)))


def test_tracemerge_equal_over_one_run_dir(ref_run_dir):
    ref = _merge_views(REF, ref_run_dir)
    assert ref[4] > 0 and ref[2], ref[4:]
    assert _merge_views(PORT, ref_run_dir) == ref


# -- simprof ------------------------------------------------------------------

#: what the host clock sets in a storm's report (`top_tasks` ranks the
#: tasks by their busy time; the whole table stays)
_WALL_KEYS = re.compile(r"wall|busy|_us$|_ms$|slow_task|lag|cpu|rss"
                        r"|elapsed|^top_tasks$")


def _drop_wall(doc):
    """`doc` without the host clock's fields; tables (which the host
    clock orders) sorted, and source lines dropped from stack frames
    (the port's files number their lines their own way)."""
    if isinstance(doc, dict):
        return {k: _drop_wall(v) for k, v in doc.items()
                if not _WALL_KEYS.search(str(k))}
    if isinstance(doc, list):
        rows = [_drop_wall(v) for v in doc]
        if rows and all(isinstance(r, dict) for r in rows):
            rows.sort(key=lambda r: json.dumps(r, sort_keys=True))
        return rows
    if isinstance(doc, str):
        return re.sub(r"(\.py):\d+", r"\1", doc)
    return doc


def _storm(pkg):
    flow = _mod(pkg, "flow")
    flow.reset_server_knobs(randomize=False)
    try:
        rep = _mod(pkg, "tools.simprof").run_storm("open_loop",
                                                   duration=1.0)
    finally:
        flow.reset_server_knobs(randomize=False)
        flow.set_scheduler(None)
    return rep


def test_simprof_storm_equal():
    """`run_storm` at the open-loop cell's seed: the storm's stats, the
    task and message tables and the sampled stacks, without what the
    host clock sets."""
    ref, port = _storm(REF), _storm(PORT)
    assert ref["stats"]["completed"] > 0
    assert _drop_wall(port) == _drop_wall(ref)


# -- incident -----------------------------------------------------------------

def _bundle(pkg, out_dir, seed=1706):
    """tests/test_longitudinal.py's incident case: an armed metric
    history, a bundle over a window that ends a second before the
    capture. Returns {file name: bytes}."""
    flow = _mod(pkg, "flow")
    SimCluster = _mod(pkg, "server").SimCluster
    incident = _mod(pkg, "tools.incident")
    faults = _mod(pkg, "ops.fault_injection").g_device_faults.injected
    saved = dict(faults)
    faults.update(dict.fromkeys(faults, 0))   # chaos.json counts them
    flow.reset_server_knobs(randomize=False)
    flow.set_seed(seed)
    c = SimCluster(seed=seed, metric_history=True)
    try:
        db = c.client("lg")

        async def main():
            for i in range(52):
                tr = db.create_transaction()
                tr.set(b"lg/%03d" % (i % 40), b"%d" % i)
                await tr.commit()
                await flow.delay(0.25)
            t1 = flow.now()
            status = await db.get_status()
            return await incident.capture_bundle(
                db, out_dir, (t1 - 6.0, t1 - 1.0), status_doc=status,
                verdict={"state": "breach", "breached": ["commit_p99"]},
                reason="parity")

        c.run(main(), timeout_time=600)
    finally:
        c.shutdown()
        flow.reset_server_knobs(randomize=False)
        faults.update(saved)
    out = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name), "rb") as fh:
            out[name] = fh.read()
    return out


def test_incident_bundle_equal(tmp_path):
    """Every file of the bundle byte for byte, but the status document,
    which is compared without what the host clock sets (the resolve
    pipeline's latencies among it) and without the process-wide
    counters."""
    ref = _bundle(REF, str(tmp_path / "ref"))
    port = _bundle(PORT, str(tmp_path / "port"))
    assert sorted(port) == sorted(ref)
    assert {"manifest.json", "series.json", "timekeeper.json",
            "chaos.json", "status.json"} <= set(ref)
    status = [_drop_process_wide(json.loads(b.pop("status.json")))
              for b in (ref, port)]
    for doc in status:
        for r in doc["cluster"]["resolvers"]:
            r["pipeline"].pop("latency")   # submit and drain, host clock
    assert _drop_wall(status[1]) == _drop_wall(status[0])
    assert port == ref


# -- the soak -----------------------------------------------------------------

#: a seed at which the one worker's open-loop arrivals (4 a second for
#: 3 wall seconds) end 0.6 s before the horizon and the next would come
#: 0.38 s after it: the count of arrivals does not depend on the host
SOAK_SEED = 9


def _soak(pkg, run_dir):
    soak = _mod(pkg, "tools.soak")
    doc = soak.run_soak(processes=1, duration=3.0, rate=4.0, kills=0,
                        seed=SOAK_SEED, trace=False, run_dir=run_dir,
                        out=lambda *a: None)
    for key in ("run_dir", "timeline", "timeline_path", "txn_per_s",
                "wall_seconds", "latency_ms", "federation"):
        doc.pop(key)
    return doc


def test_soak_equal_on_python(tmp_path):
    """A one-worker soak on `python` without kills: the document without
    the wall-clock fields (timeline, rates, latencies, the federation's
    pids), its totals and its keyspace digest."""
    ref = _soak(REF, str(tmp_path / "ref"))
    port = _soak(PORT, str(tmp_path / "port"))
    assert ref["ok"] and ref["totals"]["committed"] == 16, ref["totals"]
    assert ref["digest"]["consistent"]
    assert port == ref


# -- the C client -------------------------------------------------------------

def _c_script(db, CClientError):
    """A fixed script through the C client; returns what it read. The
    versions (a wall-clock cluster's) are held to their own facts."""
    out = []
    tr = db.create_transaction()
    tr.set(b"alpha", b"1")
    tr.set(b"zeta", b"26")
    tr.set(b"beta", b"2")
    v = tr.commit()
    stamp = tr.get_versionstamp()
    out.append(("commit", v > 0, int.from_bytes(stamp[:8], "big") == v))
    tr.reset()
    out.append(tr.get(b"alpha"))
    out.append(tr.get(b"missing"))
    tr.set(b"alpha", b"overlaid")
    tr.clear(b"beta")
    out.append(tr.get_range(b"a", b"zz"))
    out.append(tr.get_range(b"a", b"zz", reverse=True, limit=1))
    tr.commit()
    for delta in (5, 7):
        tr.reset()
        tr.atomic_op(b"ctr", delta.to_bytes(8, "little"), 2)
        out.append(tr.get(b"ctr"))
        tr.commit()
    tr.reset()
    out.append((tr.get_key(b"alpha", True, 1), tr.get_key(b"\xfe", False, 0)))
    t1, t2 = db.create_transaction(), db.create_transaction()
    out.append((t1.get(b"occ"), t2.get(b"occ")))
    t1.set(b"occ", b"first")
    t1.commit()
    t2.set(b"occ", b"second")
    try:
        t2.commit()
        out.append("committed")
    except CClientError as e:
        out.append(("error", e.code, e.name))
        t2.on_error(e.code)
        out.append(t2.get(b"occ"))
    for op in (lambda: t2.get(b"\xff/x"),
               lambda: t2.set_option("bogus_option")):
        try:
            op()
            out.append("no error")
        except CClientError as e:
            out.append(("error", e.code, e.name))
    for t in (t1, t2, tr):
        t.destroy()
    return out


def _c_client_run(gateways_module, lib):
    """The script through the port's C client build against one
    package's gateway (that package's GatewayedCluster)."""
    from foundationdb_tpu_torch.bindings.c_client import (CClientError,
                                                          CDatabase)
    gw = importlib.import_module(gateways_module)
    with gw.GatewayedCluster(seed=21, n_storage=2, n_proxies=2) as gc:
        db = CDatabase("127.0.0.1", gc.port, lib=lib)
        try:
            return _c_script(db, CClientError)
        finally:
            db.close()


def test_c_client_replies_equal():
    """One C client library (the port's build of bindings/c/fdb_tpu.cpp)
    runs the same script against the port's gateway and the
    reference's: the same replies and errors."""
    from foundationdb_tpu_torch.bindings.c_client import load_library
    lib = load_library()
    ref = _c_client_run("test_c_binding", lib)
    port = _c_client_run("test_torch_c_binding", lib)
    assert ref[0] == ("commit", True, True)
    assert ("error", 1020, "not_committed") in ref
    assert port == ref
