"""The reference's tests/test_distributed_trace.py on the port.

Cross-process trace propagation pins.

Four contracts: (1) with TRACE_PROPAGATION off (the default) the TCP
wire bytes are BYTE-IDENTICAL to the pre-feature framing — a request
carrying a debug id still rides a plain K_REQUEST frame whose payload
is exactly `wire.to_bytes(request)`; (2) with the knob armed, a span
chain survives a hop between two REAL OS processes and
tools/tracemerge.py reassembles the parent->child tree with the
process identities attached; (3) tracemerge's NTP-style offset
estimator recovers a deliberately skewed process clock within bound
from the WireHop timestamp quads alone; (4) merging the SAME seeded
in-sim run twice yields bit-identical report and folded output — the
merge adds no nondeterminism of its own.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow
from foundationdb_tpu_torch.flow import trace as trace_mod
from foundationdb_tpu_torch.tools import tracemerge


@pytest.fixture
def wall_loop():
    """A wall-clock scheduler for real-socket tests, with the ambient
    scheduler, knob set, and trace state restored afterwards."""
    prev_trace_path = trace_mod.g_trace.path
    flow.set_seed(0)
    s = flow.Scheduler(virtual=False)
    flow.set_scheduler(s)
    try:
        yield s
    finally:
        flow.SERVER_KNOBS.set("trace_propagation", 0)
        trace_mod.clear_process_identity()
        flow.reset_trace(prev_trace_path)
        flow.g_trace_batch.clear()
        flow.set_scheduler(None)


def test_knob_off_wire_bytes_identical(wall_loop, monkeypatch):
    """Off posture: a debug-id-carrying request with an OPEN client
    span — everything that would trigger propagation — still produces
    only kinds {REQUEST, REPLY} on the wire, and the request payload
    is exactly wire.to_bytes(request): no context envelope, no new
    fields, nothing for an old peer to choke on."""
    from foundationdb_tpu_torch.rpc import tcp as tcp_mod
    from foundationdb_tpu_torch.rpc import wire
    from foundationdb_tpu_torch.rpc.tcp import TcpRequestStream, TcpTransport
    from foundationdb_tpu_torch.server.types import StorageGetRequest

    assert flow.SERVER_KNOBS.trace_propagation == 0  # the default
    frames = []
    orig = tcp_mod._Conn.enqueue

    def spy(self, kind, req_id, token, payload):
        frames.append((kind, bytes(payload)))
        orig(self, kind, req_id, token, payload)

    monkeypatch.setattr(tcp_mod._Conn, "enqueue", spy)
    server = TcpTransport()
    client = TcpTransport()
    s = wall_loop
    try:
        stream = TcpRequestStream(server)
        server.start()
        client.start()
        req = StorageGetRequest(b"k", 7, debug_id=41)

        async def serve():
            while True:
                got, reply = await stream.pop()
                reply.send(got.key)

        async def main():
            flow.spawn(serve())
            ref = client.ref("127.0.0.1", server.port, stream.token)
            span = flow.g_trace_batch.begin_span(41, "NativeAPI.commit")
            try:
                assert await ref.get_reply(req) == b"k"
            finally:
                span.finish()
            return True

        t = s.spawn(main())
        assert s.run(until=t, timeout_time=30)
    finally:
        server.close()
        client.close()
    kinds = {k for k, _p in frames}
    assert kinds <= {tcp_mod.K_REQUEST, tcp_mod.K_REPLY}, frames
    req_payloads = [p for k, p in frames if k == tcp_mod.K_REQUEST]
    assert wire.to_bytes(req) in req_payloads, \
        "request bytes differ from the plain encoding"


def test_knob_on_traced_frames_round_trip(wall_loop, monkeypatch):
    """Armed posture: the same exchange rides the NEW frame kinds
    (TRACED request, TRACED reply), the server still sees the bare
    request, and the client logs a WireHop event with the four
    monotonically ordered per-side timestamps."""
    from foundationdb_tpu_torch.rpc import tcp as tcp_mod
    from foundationdb_tpu_torch.rpc.tcp import TcpRequestStream, TcpTransport
    from foundationdb_tpu_torch.server.types import StorageGetRequest

    frames = []
    orig = tcp_mod._Conn.enqueue

    def spy(self, kind, req_id, token, payload):
        frames.append(kind)
        orig(self, kind, req_id, token, payload)

    monkeypatch.setattr(tcp_mod._Conn, "enqueue", spy)
    flow.SERVER_KNOBS.set("trace_propagation", 1)
    server = TcpTransport()
    client = TcpTransport()
    s = wall_loop
    try:
        stream = TcpRequestStream(server)
        server.start()
        client.start()

        async def serve():
            while True:
                got, reply = await stream.pop()
                assert got.key == b"k"   # bare request, not [ctx, req]
                reply.send(got.key)

        async def main():
            flow.spawn(serve())
            ref = client.ref("127.0.0.1", server.port, stream.token)
            span = flow.g_trace_batch.begin_span(43, "NativeAPI.commit")
            try:
                got = await ref.get_reply(
                    StorageGetRequest(b"k", 7, debug_id=43))
            finally:
                span.finish()
            assert got == b"k"
            return True

        t = s.spawn(main())
        assert s.run(until=t, timeout_time=30)
    finally:
        server.close()
        client.close()
    assert tcp_mod.K_TRACED in frames, frames
    assert tcp_mod.K_TRACED_REPLY in frames, frames
    hops = [e for e in trace_mod.g_trace.events
            if e.get("Type") == "WireHop"]
    assert hops, "traced exchange logged no WireHop"
    h = hops[-1]
    assert h["T0"] <= h["T3"] and h["T1"] <= h["T2"], h
    assert "43" in h["DebugIDs"], h


_CHILD_SRC = r"""
import json, os, sys
from foundationdb_tpu_torch import flow
from foundationdb_tpu_torch.flow import trace as trace_mod
from foundationdb_tpu_torch.rpc.tcp import TcpRequestStream, TcpTransport
import foundationdb_tpu_torch.server.types  # registers wire message types

run_dir = sys.argv[1]
flow.set_seed(1)
s = flow.Scheduler(virtual=False)
flow.set_scheduler(s)
flow.reset_trace(os.path.join(
    run_dir, "trace.childsrv.%d.jsonl" % os.getpid()))
trace_mod.set_process_identity("childsrv")
flow.SERVER_KNOBS.set("trace_propagation", 1)
transport = TcpTransport()
stream = TcpRequestStream(transport)

async def main():
    transport.start()
    print(json.dumps({"port": transport.port, "token": stream.token}),
          flush=True)
    while True:
        req, reply = await stream.pop()
        if req.key == b"quit":
            reply.send(b"bye")
            # let the writer thread flush the frame before the
            # transport (and process) goes away
            await flow.delay(0.2)
            return
        # no explicit parent anywhere: the remote parent the traced
        # frame carried must attach by itself
        span = flow.g_trace_batch.begin_span(req.debug_id, "ChildWork")
        await flow.delay(0.01)
        span.finish()
        reply.send(b"ok")

t = s.spawn(main())
s.run(until=t, timeout_time=60)
flow.g_trace_batch.dump()
flow.g_trace.flush()
transport.close()
"""


def test_span_tree_across_two_os_processes(wall_loop, tmp_path):
    """The tentpole shape in miniature: a client span opened in THIS
    process parents a server span opened in a real child OS process,
    and tracemerge reassembles the two per-process trace files into
    one tree with both process identities and a measured hop."""
    from foundationdb_tpu_torch.rpc.tcp import TcpTransport
    from foundationdb_tpu_torch.server.types import StorageGetRequest

    run_dir = str(tmp_path)
    child = subprocess.Popen(
        [sys.executable, "-c", _CHILD_SRC, run_dir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    client = None
    try:
        hello = json.loads(child.stdout.readline())
        port, token = hello["port"], hello["token"]
        flow.reset_trace(os.path.join(
            run_dir, f"trace.parentcli.{os.getpid()}.jsonl"))
        trace_mod.set_process_identity("parentcli")
        flow.SERVER_KNOBS.set("trace_propagation", 1)
        client = TcpTransport()
        s = wall_loop

        async def main():
            client.start()
            ref = client.ref("127.0.0.1", port, token)
            span = flow.g_trace_batch.begin_span(5, "ParentWork")
            try:
                assert await ref.get_reply(
                    StorageGetRequest(b"k", 1, debug_id=5)) == b"ok"
            finally:
                span.finish()
            try:
                await ref.get_reply(StorageGetRequest(b"quit", 1))
            except flow.FdbError:
                pass   # the reply may race the child's clean exit
            return True

        t = s.spawn(main())
        assert s.run(until=t, timeout_time=60)
        assert child.wait(timeout=30) == 0, child.stderr.read()
        flow.g_trace_batch.dump()
        flow.g_trace.flush()
    finally:
        if client is not None:
            client.close()
        if child.poll() is None:
            child.kill()

    merged = tracemerge.merge(run_dir)
    me = f"parentcli:{os.getpid()}"
    them = f"childsrv:{child.pid}"
    assert set(merged["processes"]) == {me, them}
    assert merged["wire_hops"] >= 1
    chains = tracemerge.cross_process_chains(merged)
    assert len(chains) == 1, merged["chains"]
    rows = chains[0]["spans"]
    assert [(r["location"], r["process"], r["depth"]) for r in rows] \
        == [("ParentWork", me, 0), ("ChildWork", them, 1)]
    # the hop's offset estimate maps the child's clock into the
    # parent's: the nested child span must land INSIDE the parent span
    assert rows[0]["begin"] <= rows[1]["begin"] + 0.005
    assert rows[1]["end"] <= rows[0]["end"] + 0.005


def test_offset_estimator_recovers_skewed_clock(tmp_path):
    """A synthetic run where process b's clock runs 3.7s ahead: the
    estimator must recover the offset within a couple of milliseconds
    from the hop quads, and the merged tree must place b's span inside
    a's despite the raw timestamps saying otherwise."""
    skew = 3.7
    a_rows = [{"Type": "ProcessIdentity", "ID": "a:1"},
              {"Type": "Span", "Process": "a:1", "SpanID": 1,
               "ParentID": None, "ID": "d1", "Location": "ParentWork",
               "Begin": 10.0, "End": 10.03}]
    rng_jitter = [0.0, 0.001, -0.0015, 0.0005, -0.0005]
    for i, j in enumerate(rng_jitter):
        t0 = 10.0 + i * 0.004
        t3 = t0 + 0.012
        a_rows.append({"Type": "WireHop", "Client": "a:1",
                       "Server": "b:2", "DebugIDs": ["d1"],
                       "T0": t0, "T1": t0 + 0.005 + skew + j,
                       "T2": t0 + 0.007 + skew + j, "T3": t3})
    b_rows = [{"Type": "ProcessIdentity", "ID": "b:2"},
              {"Type": "Span", "Process": "b:2", "SpanID": 1,
               "ParentID": None, "RemoteParentProcess": "a:1",
               "RemoteParentID": 1, "ID": "d1",
               "Location": "ChildWork",
               "Begin": 10.005 + skew, "End": 10.007 + skew}]
    for name, rows in (("trace.a.1.jsonl", a_rows),
                       ("trace.b.2.jsonl", b_rows)):
        with open(tmp_path / name, "w") as fh:
            for r in rows:
                fh.write(json.dumps(r) + "\n")
    # a corrupt tail (kill -9 mid-write) must be skipped, not fatal
    with open(tmp_path / "trace.c.3.jsonl", "w") as fh:
        fh.write('{"Type": "Span", "Proc')

    merged = tracemerge.merge(str(tmp_path))
    assert merged["root_process"] == "a:1"
    assert merged["skipped_lines"] == 1
    assert abs(merged["clock_offsets_s"]["b:2"] - skew) < 0.002, \
        merged["clock_offsets_s"]
    [chain] = merged["chains"]
    assert chain["cross_process"]
    parent, childrow = chain["spans"]
    assert (parent["location"], childrow["location"]) == \
        ("ParentWork", "ChildWork")
    assert childrow["depth"] == 1
    # after offset correction the child sits inside the parent window
    assert parent["begin"] <= childrow["begin"] <= parent["end"]
    assert childrow["end"] <= parent["end"] + 0.005


def test_same_seed_sim_merge_bit_identical(tmp_path):
    """Two same-seed in-sim runs, each traced into its own run dir,
    must merge to bit-identical report and folded output (modulo the
    run-dir path on the report's first line): the whole
    trace->merge->render path is deterministic."""
    from foundationdb_tpu_torch.server import SimCluster

    def run_once(run_dir: str):
        prev_trace_path = trace_mod.g_trace.path
        os.makedirs(run_dir, exist_ok=True)
        flow.reset_trace(os.path.join(run_dir, "trace.sim.0.jsonl"))
        cluster = SimCluster(seed=1234, n_resolvers=2, n_proxies=2)
        try:
            db = cluster.client("tm")

            async def main():
                for i in range(8):
                    tr = db.create_transaction()
                    tr.set_option("debug_transaction_identifier",
                                  f"tm-{i}")
                    tr.set(b"tm/%d" % i, b"v")
                    await tr.commit()
                flow.g_trace_batch.dump()
                return True

            assert cluster.run(main(), timeout_time=600)
        finally:
            cluster.shutdown()
            flow.reset_trace(prev_trace_path)
            flow.g_trace_batch.clear()
        merged = tracemerge.merge(run_dir)
        return (tracemerge.render_report(merged, top=10),
                tracemerge.render_folded(merged))

    rep1, fold1 = run_once(str(tmp_path / "r1"))
    rep2, fold2 = run_once(str(tmp_path / "r2"))
    strip = lambda rep: rep.split("\n", 1)[1]   # noqa: E731 — run dir line
    assert strip(rep1) == strip(rep2)
    assert fold1 == fold2
    assert "tm-0" in rep1 and "chains: 8" in rep1
    # single-process files without identity merge under one synthetic
    # process name, never a host-specific one
    assert tracemerge.LOCAL_PROCESS in fold1
