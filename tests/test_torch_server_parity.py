"""The port's TCP transport, cluster file, tuple layer, CLI, backup and
profiler held against the reference (`foundationdb_tpu`) on the same
inputs, exactly:

- the bytes a `TcpTransport` writes for one sequence of requests (and
  one fire-and-forget send), captured at a raw loopback socket;
- `cluster_file` parse and format over a table of good and bad
  connection strings (the value, or the error's type and text);
- `tuple_layer` `pack` and `unpack` over a seeded corpus;
- the output of one CLI `--exec` script (set, get, getrange, clear,
  `status details`, `qos`, `heat`, `configure`) on a virtual SimCluster
  at one seed: on `python` in both packages, and switched by the script
  to `cuda` at device="cpu" against `tpu`, up to the backend names that
  ROADMAP's known differences list; the kernel sections (process-wide
  counters, with the port's own names and times) are dropped and what
  the host clock sets (the run loop's busy time and slow tasks, the
  resolve pipeline's submit and drain medians) is masked in both;
- a continuous backup saved to a directory container (every file, byte
  for byte) and its restore (the database digest);
- `profiler.analyze` and `format_report` over the same seeded records.

Each package runs under its own scheduler in turn, never both at once.
"""

import importlib
import os
import re
import socket
import struct
import threading
import uuid

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REF, PORT = "foundationdb_tpu", "foundationdb_tpu_torch"


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# -- the TCP transport's bytes ------------------------------------------------

def _messages(pkg):
    t = _mod(pkg, "server.types")
    mut = t.MutationRef(t.SET_VALUE, b"k\x00ey", b"v" * 40)
    return [
        None, 7, -(1 << 70), 2.5, b"", b"\x00\xff" * 9, "héllo",
        (1, b"x", None), [1, [2, (3,)]], {b"k": (1, 2)},
        mut,
        t.CommitRequest(41, ((b"a", b"b"),), ((b"c", b"d"),), (mut,),
                        debug_id=9, tags=(b"web",)),
        t.GetReadVersionRequest(3, t.PRIORITY_BATCH),
        t.StorageGetRequest(b"key", 1 << 40),
        t.KeySelector(b"sel", True, -2),
    ]


def _capture_tcp(pkg, seed=23):
    """Every byte a client TcpTransport of `pkg` writes for the sequence
    above (requests to two tokens, then one send), as a raw loopback
    socket receives them; the socket closes once it has them all, which
    breaks the pending requests."""
    flow = _mod(pkg, "flow")
    tcp = _mod(pkg, "rpc.tcp")
    msgs = _messages(pkg)
    wire = _mod(pkg, "rpc.wire")
    want = len(tcp.PROTOCOL_VERSION) + sum(
        tcp._HDR.size + len(wire.to_bytes(m)) for m in msgs + msgs[:1])
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    got = []

    def accept():
        sock, _ = srv.accept()
        buf = b""
        sock.settimeout(60)
        while len(buf) < want:
            chunk = sock.recv(65536)
            if not chunk:
                break
            buf += chunk
        got.append(buf)
        sock.close()

    th = threading.Thread(target=accept, daemon=True)
    th.start()
    flow.set_seed(seed)
    s = flow.Scheduler(virtual=False)
    flow.set_scheduler(s)
    client = tcp.TcpTransport()
    try:
        client.start()
        port = srv.getsockname()[1]

        async def main():
            futs = [client.ref("127.0.0.1", port, 1 + i % 2).get_reply(m)
                    for i, m in enumerate(msgs)]
            client.ref("127.0.0.1", port, 5).send(msgs[0])
            errors = []
            for f in futs:
                try:
                    await f
                except flow.FdbError as e:
                    errors.append(e.name)
            return errors

        errors = s.run(until=s.spawn(main()), timeout_time=60)
    finally:
        client.close()
        flow.set_scheduler(None)
        srv.close()
    th.join(timeout=60)
    assert errors == ["broken_promise"] * len(msgs)
    return got[0], want


def test_tcp_transport_bytes_equal():
    ref, n = _capture_tcp(REF)
    port, m = _capture_tcp(PORT)
    assert n == m and len(ref) == n
    assert ref[:8] == b"fdbtpu01"
    # the frames in order: kind 0, request ids 1.., the two tokens
    hdr = struct.Struct("<IBQQ")
    off, ids = 8, []
    while off < len(ref):
        ln, kind, req_id, token = hdr.unpack_from(ref, off)
        assert kind == 0
        ids.append((req_id, token))
        off += hdr.size + ln
    assert off == len(ref)
    assert ids[:3] == [(1, 1), (2, 2), (3, 1)] and ids[-1][1] == 5
    assert port == ref


# -- the cluster file ---------------------------------------------------------

CONNECTION_STRINGS = [
    "mydb:abc123@10.0.0.1:4500",
    "# a comment\n  mydb:abc123@10.0.0.1:4500,10.0.0.2:4501\n",
    "\n\n fdbtpu:s7@127.0.0.1:1 \n# trailing\n",
    "a:b@h:65535", "a_b:c_d@host.example:80,[::1]:9",
    "nope", "a:b", "db:id@", "db:id@host:notaport", "db/x:id@h:1",
    "one:1@h:1\ntwo:2@h:2", "a:b@h:0", "a:b@h:65536", "a:b@:1",
    ":id@h:1", "db:@h:1", "", "# only a comment\n", "a:b@h:1,,h:2",
    "a:b:c@h:1", "a:b@h:1 , h:2",
]


def _parse_all(pkg):
    cf = _mod(pkg, "client.cluster_file")
    out = []
    for s in CONNECTION_STRINGS:
        try:
            conn = cf.parse_connection_string(s)
        except ValueError as e:
            out.append(("error", type(e).__name__, str(e)))
            continue
        out.append((tuple(conn), str(conn),
                    tuple(cf.parse_connection_string(str(conn)))))
    for s in ("h:1", "host:4500", "h:x", ":1", "h:70000"):
        try:
            out.append(cf.resolve_connect(s, None))
        except ValueError as e:
            out.append(("error", str(e)))
    return out


def test_cluster_file_parse_and_format_equal():
    ref, port = _parse_all(REF), _parse_all(PORT)
    assert sum(r[0] != "error" for r in ref) >= 5
    assert port == ref


# -- the tuple layer ----------------------------------------------------------

def _corpus(seed=61, n=300):
    rng = np.random.default_rng(seed)

    def item(depth):
        k = int(rng.integers(0, 11 if depth < 2 else 10))
        if k == 0:
            return None
        if k == 1:
            return bytes(rng.integers(0, 4, int(rng.integers(0, 6)))
                         .astype(np.uint8))
        if k == 2:
            return "".join(rng.choice(list("a\x00é中z"),
                                      int(rng.integers(0, 5))))
        if k == 3:
            bits = int(rng.integers(0, 65))
            v = int(rng.integers(0, 1 << 62)) << max(bits - 62, 0)
            return v % (1 << bits) if bits else 0
        if k == 4:
            return -int(rng.integers(0, 1 << 62)) * int(rng.integers(1, 5))
        if k == 5:
            return float(rng.choice([0.0, -0.0, 1.5, -2.25, 1e300, -1e-300,
                                     float("inf"), float("-inf")]))
        if k == 6:
            return bool(rng.integers(0, 2))
        if k == 7:
            return uuid.UUID(bytes=bytes(rng.integers(0, 256, 16)
                                         .astype(np.uint8)))
        if k == 8:
            return ("vs", bytes(rng.integers(0, 256, 12).astype(np.uint8)))
        if k == 9:
            return int(rng.integers(-300, 300))
        return tuple(item(depth + 1) for _ in range(int(rng.integers(0, 4))))

    return [tuple(item(0) for _ in range(int(rng.integers(0, 5))))
            for _ in range(n)]


def _tuples(pkg, corpus):
    tl = _mod(pkg, "layers.tuple_layer")

    def to_pkg(v):
        if isinstance(v, tuple) and len(v) == 2 and v[0] == "vs":
            return tl.Versionstamp(v[1])
        if isinstance(v, tuple):
            return tuple(to_pkg(x) for x in v)
        return v

    def plain(v):
        if isinstance(v, tl.Versionstamp):
            return ("vs", v.bytes_)
        if isinstance(v, tuple):
            return tuple(plain(x) for x in v)
        if isinstance(v, float):
            return ("float", struct.pack(">d", v))
        return (type(v).__name__, v)

    packed = [tl.pack(to_pkg(t)) for t in corpus]
    refused = []
    for v in (1 << 64, -(1 << 64), object(), {1: 2}):
        try:
            tl.pack((v,))
        except Exception as e:  # noqa: BLE001 — the refusal compares
            refused.append((type(e).__name__, getattr(e, "name", None)))
    return packed, [plain(tl.unpack(b)) for b in packed], \
        [tl.range_of(to_pkg(t)) for t in corpus[:50]], refused


def test_tuple_layer_pack_unpack_equal():
    corpus = _corpus()
    ref, port = _tuples(REF, corpus), _tuples(PORT, corpus)
    assert len(set(ref[0])) > 200 and len(ref[3]) == 4
    assert port == ref


# -- the CLI ------------------------------------------------------------------

SCRIPT = ("set alpha one; set beta two; set \\x01bin \\xff\\x00; get alpha; "
          "getrange a c; clear beta; getrange a c; getrange \\x00 \\xff 2; "
          "get beta; status details; qos; heat; configure proxies=2; "
          "set gamma three; get gamma; status details")


def _cli_run(pkg, seed, script, **kw):
    """The script's (line, output) pairs. The device-fault injector's
    process-wide counts, which status's chaos section reports and
    earlier tests' faults add to, start from 0 and are put back."""
    flow = _mod(pkg, "flow")
    SimCluster = _mod(pkg, "server").SimCluster
    cli_mod = _mod(pkg, "tools.cli")
    faults = _mod(pkg, "ops.fault_injection").g_device_faults.injected
    saved = dict(faults)
    faults.update(dict.fromkeys(faults, 0))
    flow.reset_server_knobs(randomize=False)
    flow.set_seed(seed)
    c = SimCluster(seed=seed, durable=True, **kw)
    try:
        cli = cli_mod.Cli.for_cluster(c)
        return [(line, cli.execute(line.strip()))
                for line in cli_mod._split_script(script)]
    finally:
        c.shutdown()
        flow.reset_server_knobs(randomize=False)
        faults.update(saved)


_RUN_LOOP = re.compile(r"busy=[0-9.e+-]+s (sim=[0-9.e+-]+s) "
                       r"sim/busy=[0-9.e+-]+x")
_PIPELINE = re.compile(r"\b(submit|drain)_p50=\S+s\b")
_KERNEL_SECTIONS = ("Resolver kernels:",
                    "Kernel compile/execute (process-wide):")


def _norm(out, backend=None):
    """Mask what the host clock sets: the run loop's busy time and its
    slow-task lines, the resolve pipeline's submit and drain medians;
    drop the kernel sections (process-wide counters, which earlier
    tests' kernels add to, with the port's own names and host or
    CUDA-event times). With `backend`, name the backend `backend`."""
    lines, skip = [], False
    for line in out.split("\n"):
        if line.startswith("  slow: "):
            continue
        if line in _KERNEL_SECTIONS:
            skip = True
            continue
        if skip and line.startswith("  "):
            continue
        skip = False
        if backend is not None:
            line = re.sub(r"\b(cuda|tpu)\b", backend, line)
        line = _PIPELINE.sub(r"\1_p50=-", line)
        lines.append(_RUN_LOOP.sub(r"busy=- \1 sim/busy=-", line))
    return "\n".join(lines)


def test_cli_script_equal_on_python():
    ref = _cli_run(REF, 9, SCRIPT)
    port = _cli_run(PORT, 9, SCRIPT)
    assert [o for _l, o in ref][:4] == ["Committed"] * 3 + ["`alpha' is `one'"]
    assert "Configuration changed" in [o for _l, o in ref]
    assert [(l, _norm(o)) for l, o in port] == \
        [(l, _norm(o)) for l, o in ref]


def test_cli_script_equal_on_cuda_against_tpu():
    """The script switches the resolver to the device backend first:
    `cuda` at device="cpu" in the port, `tpu` in the reference."""
    pre = "configure conflict_backend=%s; set delta four; status details; "
    ref = _cli_run(REF, 11, pre % "tpu" + SCRIPT)
    port = _cli_run(PORT, 11, pre % "cuda" + SCRIPT, device="cpu")
    assert ref[0][1] == port[0][1] == "Configuration changed"
    assert "backend=cuda platform=cpu" in port[-1][1]
    assert "backend=tpu" in ref[-1][1]
    assert [_norm(o, "B") for _l, o in port] == \
        [_norm(o, "B") for _l, o in ref]


# -- backup and restore -------------------------------------------------------

def _backup_run(pkg, path, seed=1603):
    flow = _mod(pkg, "flow")
    SimCluster = _mod(pkg, "server").SimCluster
    ba = _mod(pkg, "layers.backup_agent")
    bc = _mod(pkg, "layers.backup_container")
    run_transaction = _mod(pkg, "client").run_transaction
    database_digest = _mod(pkg, "server.chaos").database_digest
    flow.reset_server_knobs(randomize=False)
    flow.set_seed(seed)
    c = SimCluster(seed=seed, durable=True)
    try:
        db = c.client()

        async def work():
            agent = ba.BackupAgent(c, c.client("agent"))
            await agent.start()
            for i in range(12):
                async def body(tr, i=i):
                    tr.set(b"k%02d" % i, b"v%d" % (i * i))
                    if i % 4 == 3:
                        tr.clear(b"k%02d" % (i - 2))
                await run_transaction(db, body)
            tr = db.create_transaction()
            await tr.get(b"k00")
            v_end = await tr.get_read_version()
            await agent.wait_tailed_to(v_end)
            await agent.stop()
            agent.save_to(bc.open_container(f"file://{path}"),
                          chunk_records=3)
            before = await database_digest(db)

            async def wipe(tr):
                tr.clear_range(b"", b"\xff")
            await run_transaction(db, wipe)
            wiped = await database_digest(db)
            restored_to = await bc.restore_from_container(
                db, bc.DirectoryContainer(path), None)
            return before, wiped, await database_digest(db), restored_to

        out = c.run(work(), timeout_time=600)
    finally:
        c.shutdown()
        flow.reset_server_knobs(randomize=False)
    files = {}
    for dirpath, _dirs, names in os.walk(path):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                files[os.path.relpath(p, path)] = f.read()
    return out, files


def test_backup_to_directory_and_restore_equal(tmp_path):
    ref = _backup_run(REF, str(tmp_path / "ref"))
    port = _backup_run(PORT, str(tmp_path / "port"))
    (before, wiped, restored, _v), files = ref
    assert restored == before != wiped
    assert len(files) >= 3
    assert port == ref


# -- the profiler -------------------------------------------------------------

def _records(pkg, seed=71, n=40):
    p = _mod(pkg, "client.profiling")
    TxnRecord = _mod(pkg, "tools.profiler").TxnRecord
    rng = np.random.default_rng(seed)
    keys = [b"key%d" % i for i in range(6)]
    recs = []
    for r in range(n):
        t = float(r)
        evs = [p.GetVersionEvent(t, float(rng.integers(1, 900)) / 1e4,
                                 int(rng.integers(0, 3)))]
        for _ in range(int(rng.integers(0, 4))):
            k = keys[int(rng.integers(0, len(keys)))]
            if rng.integers(0, 2):
                evs.append(p.GetEvent(t, float(rng.integers(1, 5000)) / 1e5,
                                      k, int(rng.integers(-1, 100))))
            else:
                evs.append(p.GetRangeEvent(
                    t, float(rng.integers(1, 5000)) / 1e5, k, k + b"\xff",
                    int(rng.integers(0, 50))))
        w = keys[int(rng.integers(0, len(keys)))]
        kind = int(rng.integers(0, 3))
        if kind == 2:
            evs.append(p.ErrorEvent(t, "commit", "not_committed"))
        else:
            evs.append(p.CommitEvent(
                t, float(rng.integers(1, 9000)) / 1e5, int(rng.integers(1, 9)),
                int(rng.integers(10, 999)), ((w, w + b"\x00"),),
                "committed" if kind == 0 else "conflicted",
                int(rng.integers(1, 1 << 40)) if kind == 0 else 0,
                () if kind == 0 else ((w, w + b"\x00"),)))
        recs.append(TxnRecord(t, "r%03d" % r, tuple(evs)))
    return recs


def _profile(pkg):
    prof = _mod(pkg, "tools.profiler")
    recs = _records(pkg)
    stats = {"chunks_seen": 50, "records": len(recs),
             "skipped_missing_chunks": 1, "skipped_undecodable": 0,
             "skipped_foreign_version": 2}
    out = []
    for top_n in (1, 5, 50):
        a = prof.analyze(recs, top_n=top_n)
        out.append((a, prof.format_report(a), prof.format_report(a, stats)))
    return out


def test_profiler_analyze_and_report_equal():
    ref, port = _profile(REF), _profile(PORT)
    assert ref[1][0]["records"] == 40 and ref[1][0]["conflicted"] > 0
    assert port == ref
