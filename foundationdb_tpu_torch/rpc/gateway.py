"""TCP gateway: the cluster's client-facing endpoints on real sockets.

Reference: in the reference every role endpoint is served directly by
FlowTransport on the process's listen address, and out-of-process
clients (the C binding linking NativeAPI) reach it by token
(fdbrpc/FlowTransport.actor.cpp:517 deliver; bindings/c/fdb_c.cpp is a
thin ABI over that client). Here the cluster's role endpoints live on
the in-process flow scheduler, so the gateway plays the listen-address
seam: each client-visible endpoint (proxy GRV/commit, storage
get/range/get_key) is assigned a real TCP token whose frames are
forwarded into the role's RequestStream and whose replies travel back
over the same wire format the simulator round-trips.

The describe endpoint (fixed token 1) plays MonitorLeader +
openDatabase: it serves a token-translated ServerDBInfo (proxy and
shard maps), long-polling the ClusterController through the attached
Database when the client's picture went stale — exactly the client
recovery path (fdbclient/MonitorLeader.actor.cpp, NativeAPI
getClientInfo), so an out-of-process client rides epoch recoveries the
same way in-process ones do.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .. import flow
from ..flow import error
from .tcp import TcpRequestStream, TcpTransport

DESCRIBE_TOKEN = 1

# request payload selecting the PEER describe (see _translate_peers):
# role endpoints — master version authority, resolver resolve/handoff,
# tlog commit, proxy raw-committed — for an out-of-process PEER
# (a proxy worker in tools/clusterbench.py), not a client
PEER_DESCRIBE = "peers"


async def forward_stream(stream: TcpRequestStream, ref, src) -> None:
    """Forward every frame arriving on a TCP endpoint into a sim
    NetworkRef and relay the reply — the role-endpoint serving seam
    shared by the gateway and clusterbench's worker processes."""

    async def one(req, reply):
        try:
            reply.send(await ref.get_reply(req, src))
        except flow.FdbError as e:
            reply.send_error(e)
        except Exception:  # noqa: BLE001 — a bad frame fails only itself
            reply.send_error(error("internal_error"))

    while True:
        req, reply = await stream.pop()
        flow.spawn(one(req, reply))


class TcpGateway:
    """Serve a cluster (via its client `Database` handle) over TCP.

    Two endpoint classes share the transport: CLIENT endpoints (proxy
    GRV/commit, storage reads — the original describe document) and,
    when a cluster object is attached, PEER endpoints:
    master version authority, per-resolver resolve + handoff streams,
    per-tlog commit streams and per-proxy raw-committed probes, so
    out-of-process PEER ROLES — clusterbench's proxy workers — can join
    the commit pipeline over the real wire, not just clients."""

    def __init__(self, db, host: str = "127.0.0.1", port: int = 0,
                 tls=None, protocol: bytes = None, cluster=None):
        self.db = db
        self.cluster = cluster
        self.transport = TcpTransport(host, port, tls=tls,
                                      protocol=protocol)
        self._describe = TcpRequestStream(self.transport)
        assert self._describe.token == DESCRIBE_TOKEN, \
            "describe must be the transport's first registered endpoint"
        #: (process name, sim token) -> tcp token
        self._exposed: Dict[Tuple[str, int], int] = {}
        self._actors: List[object] = []

    @property
    def port(self) -> int:
        return self.transport.port

    def start(self) -> None:
        self.transport.start()
        self._actors.append(flow.spawn(
            self._describe_loop(), name=f"gateway:{self.port}.describe"))

    def close(self) -> None:
        self.transport.close()
        for a in self._actors:
            a.cancel()
        self._actors.clear()

    # -- endpoint exposure ----------------------------------------------
    def _expose(self, ref) -> int:
        """TCP token for a sim NetworkRef, forwarding frames to it.

        Tokens are cached by (process, sim-token) identity: after a
        recovery the same describe tokens keep working for surviving
        roles, while new-epoch roles get fresh tokens in the next
        describe — dead tokens answer broken_promise, which the client
        treats as a stale-picture refresh signal.
        """
        ep = ref.endpoint
        key = (ep.process.name, ep.token)
        token = self._exposed.get(key)
        if token is None:
            stream = TcpRequestStream(self.transport)
            token = stream.token
            self._exposed[key] = token
            self._actors.append(flow.spawn(
                self._forward_loop(stream, ref),
                name=f"gateway:{self.port}.fwd.{ep.process.name}"))
        return token

    async def _forward_loop(self, stream: TcpRequestStream, ref) -> None:
        await forward_stream(stream, ref, self.db.process)

    # -- describe --------------------------------------------------------
    async def _describe_loop(self) -> None:
        while True:
            req, reply = await self._describe.pop()
            flow.spawn(self._describe_one(req, reply))

    async def _describe_one(self, min_seq, reply) -> None:
        """Request payload: the newest dbinfo seq the client has seen
        (-1 for "whatever is current"). A non-negative seq long-polls
        the CC until the broadcast picture moves past it (the client's
        post-failure refresh), mirroring Database.refresh_past. The
        string payload "peers" selects the peer-role document instead
        (requires the gateway to be attached to its cluster)."""
        try:
            if min_seq == PEER_DESCRIBE:
                reply.send(self._translate_peers())
                return
            if isinstance(min_seq, int) and min_seq >= 0:
                await self.db.refresh_past(min_seq)
            info = await self.db.info()
            reply.send(self._translate(info))
        except flow.FdbError as e:
            reply.send_error(e)
        except Exception:  # noqa: BLE001
            reply.send_error(error("internal_error"))

    def _translate_peers(self) -> dict:
        """The transaction subsystem's ROLE endpoints as TCP tokens:
        everything an out-of-process proxy needs to join
        the commit pipeline — the master's version authority, every
        current-epoch resolver's resolve + handoff streams, every
        tlog's commit stream, every in-cluster proxy's raw-committed
        probe (GRV causal confirmation), and the routing config
        (initial resolver splits — the master's version replies replay
        the whole move log onto them, so a late joiner reconstructs
        the exact current keyResolvers map — plus storage splits/tags
        and the recovery version)."""
        if self.cluster is None:
            raise error("client_invalid_operation")
        from ..server.cluster_controller import epoch_roles
        from ..server.master import initial_resolver_splits
        from ..server.proxy import Proxy
        from ..server.resolver_role import Resolver
        cc = self.cluster.cc
        info = cc.dbinfo.get()
        rec = cc._recovery
        if rec is None or rec.master is None or not info.proxies:
            # mid-recovery: peers retry exactly like stale clients
            raise error("broken_promise")

        def by_index(pairs):
            return sorted(pairs, key=lambda p: int(p[0].rsplit("-", 1)[1]))

        proxies = by_index(list(
            epoch_roles(cc.workers, info.epoch, Proxy)))
        first_proxy = proxies[0][1]
        # role-per-process deployment (tools/rolehost.py): recruitment
        # stashed addr-carrying descriptors — a worker proxy connects
        # DIRECTLY to each role process instead of through this
        # gateway's forwarders. In-process roles keep the original
        # gateway-token shape; an entry is a dict with an "addr" iff
        # the role is external (tlog entries: bare int = gateway token,
        # dict = external commit endpoint).
        ext_resolvers = getattr(rec, "peer_resolvers", None)
        if ext_resolvers is not None:
            resolvers_doc = [dict(e) for e in ext_resolvers]
        else:
            resolvers = by_index(list(
                epoch_roles(cc.workers, info.epoch, Resolver)))
            resolvers_doc = [
                {"name": rn,
                 "resolves": self._expose(r.resolves.ref()),
                 "handoffs": self._expose(r.handoffs.ref())}
                for rn, r in resolvers]
        ext_tlogs = getattr(rec, "peer_tlogs", None)
        if ext_tlogs is not None:
            tlogs_doc = [dict(e) for e in ext_tlogs]
        else:
            tlogs_doc = [self._expose(lr.commits)
                         for lr in info.logs.logs]
        n_res = len(resolvers_doc)
        return {
            "epoch": info.epoch,
            "recovery_version": info.recovery_version,
            "master": self._expose(rec.master.version_requests.ref()),
            "resolvers": resolvers_doc,
            "tlogs": tlogs_doc,
            "proxy_raw_committed": [
                self._expose(p.raw_committed.ref())
                for _rn, p in proxies],
            # recruitment-time resolver splits (THE shared formula —
            # server/master.py); the move-log replay reconstructs the
            # live map from them
            "resolver_splits": list(initial_resolver_splits(n_res)),
            "storage_splits": list(first_proxy._sbounds[1:-1]),
            "storage_tags": list(first_proxy._stags),
        }

    def _translate(self, info) -> dict:
        """ServerDBInfo with every NetworkRef replaced by a TCP token
        (refs themselves cannot cross this wire: their encoding names a
        sim process, meaningless to an out-of-process peer)."""
        return {
            "seq": info.seq,
            "epoch": info.epoch,
            "recovery_state": info.recovery_state,
            "failed": list(info.failed),
            # control plane (ref: StatusClient / ManagementAPI reach the
            # CC the same way data ops reach the roles)
            "status": (self._expose(self.db.status_ref)
                       if self.db.status_ref is not None else 0),
            "management": (self._expose(self.db.management_ref)
                           if self.db.management_ref is not None else 0),
            "proxies": [
                {"name": p.name,
                 "grvs": self._expose(p.grvs),
                 "commits": self._expose(p.commits)}
                for p in info.proxies],
            "shards": [
                {"begin": s.begin,
                 "end": s.end if s.end is not None else b"",
                 "has_end": s.end is not None,
                 "replicas": [
                     {"name": r.name,
                      "gets": self._expose(r.gets),
                      "ranges": self._expose(r.ranges),
                      "get_keys": self._expose(r.get_keys),
                      "watches": self._expose(r.watches)}
                     for r in s.replicas]}
                for s in info.storages],
        }
