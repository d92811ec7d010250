"""Real TCP transport: token-addressed request/reply over sockets,
speaking the same wire format the simulator round-trips.

Reference: fdbrpc/FlowTransport.actor.cpp — a ConnectPacket handshake
(:200), token-addressed delivery to an EndpointMap (:517), one
connection per peer pair with a connectionReader/Writer pair per
socket (:646/:397). Frames: [u32 len][u8 kind][u64 req_id][u64 token]
[wire payload]; kind 0 request, 1 reply, 2 error reply.

The flow scheduler is single-threaded and (in wall-clock mode) has no
socket reactor, so ALL socket IO — connect, read, write — runs on OS
threads; the scheduler side only enqueues outbound frames and drains an
inbox of completions via a reactor actor (a miniature of Net2's
asio-reactor seam, flow/Net2.actor.cpp:123). A dying connection fails
its in-flight requests with broken_promise exactly like the simulated
transport's closed-connection semantics.
"""

from __future__ import annotations

import select
import socket
import ssl
import struct
import threading
from collections import deque
from typing import Dict, NamedTuple, Optional

from .. import flow
from ..flow import TaskPriority, error
from ..flow.actors import PromiseStream
from ..flow.future import Future, Promise
from . import wire

_HDR = struct.Struct("<IBQQ")   # len, kind, req_id, token
PROTOCOL_VERSION = b"fdbtpu01"
K_REQUEST, K_REPLY, K_ERROR = 0, 1, 2
# traced variants (gated on the TRACE_PROPAGATION knob):
# kind 3 wraps a request as [trace_ctx, request] — the sender's process
# identity, its open parent span per debug id, and the send timestamp
# t0; kind 4 wraps the reply as [hop, value] with the server identity
# and its recv/send timestamps t1/t2. With the knob off (the default)
# kinds 3/4 never hit a socket and kinds 0/1/2 frames are byte-
# identical to the pre-knob transport (pinned in
# tests/test_distributed_trace.py)
K_TRACED, K_TRACED_REPLY = 3, 4


def _trace_armed() -> bool:
    from ..flow import SERVER_KNOBS
    return bool(SERVER_KNOBS.trace_propagation)


def _trace_ctx(request):
    """The trace context a TRACED request frame carries: the sending
    process identity, (debug_id, open parent span id) pairs for every
    debug id the request ships, and the local send timestamp t0 (the
    first of the four NTP-style hop timestamps tracemerge's clock-
    offset estimator consumes). None when the request samples nothing —
    an unsampled request rides a plain K_REQUEST frame even while the
    knob is armed."""
    ids = getattr(request, "debug_ids", None)
    if not ids:
        d = getattr(request, "debug_id", None)
        ids = (d,) if d is not None else ()
    ids = tuple(d for d in ids if d is not None)
    if not ids:
        return None
    from ..flow import trace as _trace
    return {"process": _trace.process_name(),
            "spans": [[d, _trace.g_trace_batch.open_span_id(d)]
                      for d in ids],
            "t0": flow.now()}
def HANDSHAKE_TIMEOUT():
    from ..flow import SERVER_KNOBS
    return SERVER_KNOBS.tcp_handshake_timeout


def CONNECT_TIMEOUT():
    from ..flow import SERVER_KNOBS
    return SERVER_KNOBS.tcp_connect_timeout


class TlsConfig(NamedTuple):
    """Mutual-TLS configuration for a transport (ref: FDBLibTLS — both
    sides present certificates and verify the peer's chain; the
    reference plugs this in under FlowTransport the same way)."""

    certfile: str
    keyfile: str
    cafile: str
    verify_peer: bool = True

    def server_context(self) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.certfile, self.keyfile)
        if self.verify_peer:
            ctx.verify_mode = ssl.CERT_REQUIRED
            ctx.load_verify_locations(self.cafile)
        return ctx

    def client_context(self) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        # peers authenticate by certificate chain, not hostname — the
        # reference's TLS verifies subject/issuer fields, not DNS names
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.load_verify_locations(self.cafile)
        ctx.load_cert_chain(self.certfile, self.keyfile)
        return ctx


class TcpReply:
    """Reply handle handed to server actors; send() enqueues the framed
    value on the originating connection's writer thread. A request that
    arrived on a TRACED frame remembers its receive timestamp here and
    answers with a TRACED reply carrying this process's identity and
    the t1/t2 hop timestamps (errors stay plain: the offset estimator
    only wants clean request/reply pairs)."""

    __slots__ = ("conn", "req_id", "t_recv")

    def __init__(self, conn: "_Conn", req_id: int,
                 t_recv: Optional[float] = None):
        self.conn = conn
        self.req_id = req_id
        self.t_recv = t_recv

    def send(self, value=None) -> None:
        if self.t_recv is not None:
            from ..flow import trace as _trace
            hop = {"process": _trace.process_name(),
                   "t1": self.t_recv, "t2": flow.now()}
            self.conn.enqueue(K_TRACED_REPLY, self.req_id, 0,
                              wire.to_bytes([hop, value]))
            return
        self.conn.enqueue(K_REPLY, self.req_id, 0, wire.to_bytes(value))

    def send_error(self, err) -> None:
        name = getattr(err, "name", "unknown_error")
        self.conn.enqueue(K_ERROR, self.req_id, 0, wire.to_bytes(name))


class TcpRequestStream:
    """Server side of a TCP endpoint (mirror of rpc.network
    RequestStream)."""

    def __init__(self, transport: "TcpTransport"):
        self.stream = PromiseStream()
        self.token = transport._register(self)
        self.transport = transport

    def pop(self) -> Future:
        return self.stream.stream.pop()


class TcpRef:
    """Client handle to a remote TCP endpoint."""

    __slots__ = ("transport", "addr", "token")

    def __init__(self, transport: "TcpTransport", addr, token: int):
        self.transport = transport
        self.addr = addr
        self.token = token

    def get_reply(self, request, _src=None) -> Future:
        return self.transport._request(self.addr, self.token, request)

    def send(self, request, _src=None) -> None:
        """Fire-and-forget (the NetworkRef.send mirror): the frame rides
        a normal request id, but no promise is registered — a reply (or
        the connection dying) is silently dropped, matching the sim
        transport's best-effort datagram semantics."""
        self.transport._request(self.addr, self.token, request,
                                oneway=True)


class RetryingTcpRef:
    """A TcpRef that re-issues a request when the underlying connection
    dies mid-flight (broken_promise), with exponential backoff up to the
    ROLE_RETRY_DEADLINE wall-clock budget.

    This is the client half of role-process fault tolerance: an
    externally-hosted resolver/tlog killed with SIGKILL respawns on the
    SAME addr:port (SO_REUSEADDR) and recovers from its checkpoint +
    journal, so a retried request lands on a role whose reply cache /
    version chain make the re-delivery idempotent (the reference's
    model: endpoint tokens survive process restart only through
    recruitment, but OUR role hosts pin their token layout, so the
    ref stays valid across the respawn). Requests that fail with any
    error OTHER than broken_promise propagate immediately — retry is
    for dead transport, not for application verdicts."""

    __slots__ = ("ref",)

    def __init__(self, ref: TcpRef):
        self.ref = ref

    @property
    def addr(self):
        return self.ref.addr

    @property
    def token(self):
        return self.ref.token

    def get_reply(self, request, _src=None) -> Future:
        p = Promise()
        flow.spawn(self._drive(request, _src, p), TaskPriority.READ_SOCKET,
                   name="tcp.retry")
        return p.future

    def send(self, request, _src=None) -> None:
        self.ref.send(request, _src)

    async def _drive(self, request, src, p: Promise):
        from ..flow import SERVER_KNOBS
        deadline = flow.now() + float(SERVER_KNOBS.role_retry_deadline)
        backoff = 0.05
        while True:
            try:
                value = await self.ref.get_reply(request, src)
            except flow.FdbError as e:
                name = e.name
                if name != "broken_promise" or flow.now() >= deadline:
                    if not p.is_set:
                        p.send_error(e)
                    return
                await flow.delay(
                    min(backoff, max(0.0, deadline - flow.now())),
                    TaskPriority.READ_SOCKET)
                backoff = min(backoff * 2.0, 1.0)
                continue
            if not p.is_set:
                p.send(value)
            return


def _wait_ready(sock, events: int, timeout_ms: int = 50) -> bool:
    """Wait up to `timeout_ms` for `sock` to be ready for `events`;
    False once the socket is closed. `poll`, not `select`: select
    refuses descriptors at or above FD_SETSIZE (1024), which a busy
    server or gateway reaches."""
    fd = sock.fileno()
    if fd < 0:                 # closed under us by _die
        return False
    p = select.poll()
    p.register(fd, events)
    p.poll(timeout_ms)
    return True


class _Conn:
    """One socket + its reader/writer threads (ref: connectionReader /
    connectionWriter). Outbound frames queue through the writer so the
    scheduler thread never blocks on the kernel; death notifies the
    transport exactly once."""

    def __init__(self, transport: "TcpTransport", sock: Optional[socket.socket],
                 addr=None, handshake_in: bool = False):
        self.transport = transport
        self.sock = sock              # None: connect lazily (client side)
        self.addr = addr
        self.handshake_in = handshake_in
        self.dead = False
        self._wq: deque = deque()
        self._wq_event = threading.Event()
        self._lock = threading.Lock()
        # one OpenSSL connection must not be read and written from two
        # threads at once (a frame can be lost, and both sides wait for
        # ever): a TLS socket is non-blocking after its handshake and
        # each read or write holds this lock
        self._io_lock = threading.Lock()
        self.pending: set = set()     # req_ids in flight on this conn

    def start(self) -> None:
        threading.Thread(target=self._writer, daemon=True).start()

    def enqueue(self, kind, req_id, token, payload: bytes) -> None:
        with self._lock:
            if self.dead:
                return
            self._wq.append(_HDR.pack(len(payload), kind, req_id, token)
                            + payload)
        self._wq_event.set()

    # -- threads ---------------------------------------------------------
    def _writer(self) -> None:
        try:
            if self.sock is None:
                self.sock = socket.create_connection(
                    self.addr, timeout=CONNECT_TIMEOUT())
                ctx = self.transport.tls_client_ctx()
                if ctx is not None:
                    # TLS handshake before the protocol tag, exactly
                    # where the reference's TLS sits: beneath the
                    # ConnectPacket (FDBLibTLS under FlowTransport)
                    self.sock = ctx.wrap_socket(self.sock)
                self.sock.settimeout(None)
                self.sock.sendall(self.transport.protocol)
            elif self.handshake_in:
                self.sock.settimeout(HANDSHAKE_TIMEOUT())
                ctx = self.transport.tls_server_ctx()
                if ctx is not None:
                    self.sock = ctx.wrap_socket(self.sock,
                                                server_side=True)
                got = _read_exact(self.sock, len(PROTOCOL_VERSION))
                if got != self.transport.protocol:
                    if got is not None and \
                            got[:6] == PROTOCOL_VERSION[:6]:
                        # a versioned peer we don't speak: answer with
                        # OUR tag so a MultiVersion client can pick the
                        # matching library (ref: getServerProtocol)
                        try:
                            self.sock.sendall(self.transport.protocol)
                        except OSError:
                            pass
                    raise OSError("bad handshake")
                self.sock.settimeout(None)
            if isinstance(self.sock, ssl.SSLSocket):
                self.sock.setblocking(False)
            threading.Thread(target=self._reader, daemon=True).start()
            while True:
                self._wq_event.wait()
                with self._lock:
                    if self.dead:
                        return
                    frame = self._wq.popleft() if self._wq else None
                    if frame is None:
                        self._wq_event.clear()
                        continue
                self._send_all(frame)
        except OSError:
            self._die()

    def _send_all(self, data: bytes) -> None:
        if not isinstance(self.sock, ssl.SSLSocket):
            self.sock.sendall(data)
            return
        view = memoryview(data)
        while view:
            with self._io_lock:
                try:
                    n = self.sock.send(view)
                except (ssl.SSLWantWriteError, ssl.SSLWantReadError):
                    n = 0
            if n:
                view = view[n:]
                continue
            if not _wait_ready(self.sock, select.POLLOUT):
                raise OSError("connection closed")

    def _recv_exact(self, n: int) -> Optional[bytes]:
        if not isinstance(self.sock, ssl.SSLSocket):
            return _read_exact(self.sock, n)
        buf = b""
        while len(buf) < n:
            with self._io_lock:
                try:
                    chunk = self.sock.recv(n - len(buf))
                except (ssl.SSLWantReadError, ssl.SSLWantWriteError):
                    chunk = None
                except OSError:
                    return None
            if chunk is None:
                # wait for bytes outside the lock; OpenSSL's own buffer
                # was drained by the recv above
                if not _wait_ready(self.sock, select.POLLIN):
                    return None
                continue
            if not chunk:
                return None
            buf += chunk
        return buf

    def _reader(self) -> None:
        try:
            while True:
                hdr = self._recv_exact(_HDR.size)
                if hdr is None:
                    break
                ln, kind, req_id, token = _HDR.unpack(hdr)
                payload = self._recv_exact(ln)
                if payload is None:
                    break
                self.transport._post(("frame", self, kind, req_id, token,
                                      payload))
        finally:
            self._die()

    def _die(self) -> None:
        with self._lock:
            if self.dead:
                return
            self.dead = True
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
        self._wq_event.set()
        self.transport._post(("dead", self))


def _read_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return buf


class TcpTransport:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 tls: Optional[TlsConfig] = None,
                 protocol: bytes = None):
        self.host = host
        self.tls = tls
        # the 8-byte protocol tag this transport speaks (ref: the
        # ConnectPacket's protocolVersion). A server answers a
        # mismatched-but-recognizable tag with ITS OWN tag before
        # closing, so a MultiVersion client can discover the cluster's
        # protocol and select the matching versioned library
        # (ref: MultiVersionApi / getServerProtocol)
        self.protocol = protocol or PROTOCOL_VERSION
        assert len(self.protocol) == len(PROTOCOL_VERSION)
        # contexts built once and shared by every connection (cert files
        # are read at transport creation, not per reconnect)
        self._tls_server_ctx = tls.server_context() if tls else None
        self._tls_client_ctx = tls.client_context() if tls else None
        self._streams: Dict[int, TcpRequestStream] = {}
        self._next_token = 1
        self._next_req = 1
        self._pending: Dict[int, Promise] = {}
        #: req_id -> (t0, debug ids) for in-flight TRACED requests: the
        #: traced reply joins them with the server's t1/t2 into one
        #: client-side WireHop event (all four timestamps, both
        #: identities — everything the offset estimator needs)
        self._pending_trace: Dict[int, tuple] = {}
        self._conns: Dict[object, _Conn] = {}   # addr -> client conn
        self._lock = threading.Lock()
        self._inbox: deque = deque()
        self._closing = False
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.port = self._srv.getsockname()[1]

    def tls_server_ctx(self):
        return self._tls_server_ctx

    def tls_client_ctx(self):
        return self._tls_client_ctx

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        threading.Thread(target=self._accept_loop, daemon=True).start()
        flow.spawn(self._reactor(), TaskPriority.READ_SOCKET,
                   name=f"tcp:{self.port}.reactor")

    def close(self) -> None:
        self._closing = True
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns.values())
        for c in conns:
            c._die()

    # -- registration ----------------------------------------------------
    def _register(self, stream: TcpRequestStream) -> int:
        token = self._next_token
        self._next_token += 1
        self._streams[token] = stream
        return token

    def ref(self, host: str, port: int, token: int) -> TcpRef:
        return TcpRef(self, (host, port), token)

    # -- accept thread ---------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                sock, _addr = self._srv.accept()
            except OSError:
                return
            # handshake + IO happen on the connection's own threads so a
            # stalled peer can never freeze other accepts
            conn = _Conn(self, sock, handshake_in=True)
            conn.start()

    # -- inbox bridging ---------------------------------------------------
    def _post(self, item) -> None:
        with self._lock:
            self._inbox.append(item)

    async def _reactor(self):
        """Drain socket completions into the flow loop (the Net2
        reactor seam in miniature). A malformed frame fails its own
        request — never the reactor."""
        while not self._closing:
            while True:
                with self._lock:
                    item = self._inbox.popleft() if self._inbox else None
                if item is None:
                    break
                try:
                    self._handle(item)
                except Exception as e:  # noqa: BLE001 — isolate frames
                    flow.TraceEvent(
                        "TcpDispatchError", f"tcp:{self.port}",
                        severity=flow.trace.SevWarnAlways).detail(
                        Error=repr(e)).log()
            await flow.delay(flow.SERVER_KNOBS.tcp_reactor_poll_delay,
                             TaskPriority.READ_SOCKET)

    def _handle(self, item) -> None:
        if item[0] == "dead":
            _tag, conn = item
            with self._lock:
                if self._conns.get(conn.addr) is conn:
                    del self._conns[conn.addr]
            for req_id in list(conn.pending):
                p = self._pending.pop(req_id, None)
                self._pending_trace.pop(req_id, None)
                if p is not None and not p.is_set:
                    p.send_error(error("broken_promise"))
            conn.pending.clear()
            return
        _tag, conn, kind, req_id, token, payload = item
        if kind in (K_REQUEST, K_TRACED):
            t_recv = flow.now() if kind == K_TRACED else None
            reply = TcpReply(conn, req_id, t_recv)
            stream = self._streams.get(token)
            if stream is None:
                reply.send_error(error("broken_promise"))
                return
            try:
                request = wire.from_bytes(payload, None)
            except wire.WireError as e:
                reply.send_error(error("unknown_error"))
                raise e
            if kind == K_TRACED:
                # note the sender's open spans BEFORE dispatch, so the
                # role's begin_span for these ids sees its remote parent
                ctx, request = request
                from ..flow import trace as _trace
                for d, sid in ctx.get("spans", ()):
                    if sid is not None:
                        _trace.g_trace_batch.note_remote_parent(
                            d, ctx.get("process", ""), sid)
            stream.stream.send((request, reply))
        else:
            p = self._pending.pop(req_id, None)
            tr = self._pending_trace.pop(req_id, None)
            conn.pending.discard(req_id)
            if p is None or p.is_set:
                return
            try:
                value = wire.from_bytes(payload, None)
            except wire.WireError:
                p.send_error(error("unknown_error"))
                return
            if kind == K_TRACED_REPLY:
                hop, value = value
                if tr is not None:
                    self._emit_wire_hop(tr, hop)
                p.send(value)
            elif kind == K_REPLY:
                p.send(value)
            else:
                p.send_error(error(value))

    @staticmethod
    def _emit_wire_hop(tr, hop) -> None:
        """One client-side WireHop event per traced request/reply pair:
        both process identities plus the four timestamps
        (t0 client-send, t1 server-recv, t2 server-send, t3
        client-recv) — tracemerge estimates the per-process-pair clock
        offset as the median of ((t1-t0)+(t2-t3))/2 over these events
        (the NTP local-clock-offset formula; no trusted wall clock)."""
        t0, ids = tr
        from ..flow import trace as _trace
        flow.TraceEvent("WireHop", str(ids[0])).detail(
            DebugIDs=[str(d) for d in ids],
            Client=_trace.process_name(),
            Server=hop.get("process", ""),
            T0=t0, T1=hop.get("t1"), T2=hop.get("t2"),
            T3=flow.now()).log()

    # -- client side -------------------------------------------------------
    def _request(self, addr, token: int, request,
                 oneway: bool = False) -> Optional[Future]:
        p = Promise()
        # traced envelope only when the knob is armed AND the request
        # samples at least one debug id — everything else keeps the
        # exact pre-knob K_REQUEST bytes
        ctx = _trace_ctx(request) if _trace_armed() else None
        try:
            payload = (wire.to_bytes(request) if ctx is None
                       else wire.to_bytes([ctx, request]))
        except wire.WireError:
            return flow.error_future(error("unknown_error"))
        with self._lock:
            conn = self._conns.get(addr)
            if conn is None or conn.dead:
                conn = _Conn(self, None, addr=addr)
                self._conns[addr] = conn
                fresh = True
            else:
                fresh = False
            req_id = self._next_req
            self._next_req += 1
            if not oneway:
                self._pending[req_id] = p
                if ctx is not None:
                    self._pending_trace[req_id] = (
                        ctx["t0"], tuple(d for d, _sid in ctx["spans"]))
                conn.pending.add(req_id)
        if fresh:
            conn.start()     # connect happens on the writer thread
        conn.enqueue(K_REQUEST if ctx is None else K_TRACED,
                     req_id, token, payload)
        return None if oneway else p.future
