"""Out-of-process Python client: the full client stack over TCP.

Reference: an external fdbcli/client process reaches a cluster through
FlowTransport + MonitorLeader (fdbclient/MonitorLeader.actor.cpp,
NativeAPI) — no shared memory, only the wire. Here `RemoteCluster`
hosts a wall-clock flow scheduler on a background thread, connects a
TcpTransport to a cluster's TcpGateway, translates the gateway's
describe document into a ServerDBInfo whose endpoints are TcpRefs, and
reuses the ENTIRE in-process client (`client/transaction.py` — RYW,
shard routing, replica load balance, OCC retry loop) unchanged on top:
the transaction logic cannot diverge between local and remote use.

Blocking surface: `call(coro)` runs any client coroutine on the loop
thread and returns its result, so synchronous tools (the CLI's
``--connect`` mode) drive transactions without owning a scheduler.

Watches work over the seam too: the gateway forwards the storage watch
long-polls like any other endpoint.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

from .. import flow
from ..rpc.gateway import DESCRIBE_TOKEN
from ..rpc.tcp import TcpTransport
from ..server.dbinfo import (LogSetInfo, ProxyRefs, ServerDBInfo,
                             StorageRefs, StorageShard)
from .transaction import Database


def _build_info(d: dict, transport: TcpTransport, host: str,
                port: int) -> ServerDBInfo:
    def mk(token: int):
        return transport.ref(host, port, token)

    proxies = tuple(
        ProxyRefs(p.get("name", f"proxy-{i}"), mk(p["grvs"]),
                  mk(p["commits"]))
        for i, p in enumerate(d["proxies"]))
    shards = []
    for s in d["shards"]:
        end = s["end"] if s["has_end"] else None
        replicas = tuple(
            StorageRefs(r.get("name", f"rep-{r['gets']}"), 0, s["begin"],
                        end, mk(r["gets"]), mk(r["ranges"]),
                        mk(r["get_keys"]),
                        mk(r["watches"]) if r.get("watches") else None)
            for r in s["replicas"])
        shards.append(StorageShard(0, s["begin"], end, replicas))
    return ServerDBInfo(
        epoch=d.get("epoch", 0),
        recovery_state=d.get("recovery_state", "fully_recovered"),
        recovery_version=0, proxies=proxies,
        logs=LogSetInfo(0, 0, -1, ()), old_logs=(),
        storages=tuple(shards), seq=d["seq"],
        failed=tuple(d.get("failed", ())))


class RemoteDatabase(Database):
    """Database whose cluster picture comes from a TcpGateway describe
    instead of the in-sim ClusterController broadcast."""

    def __init__(self, transport: TcpTransport, host: str, port: int):
        super().__init__(process=None, cluster_ref=None)
        self._transport = transport
        self._host = host
        self._port = port
        self._status_token = 0
        self._management_token = 0

    async def _describe(self, min_seq: int) -> None:
        ref = self._transport.ref(self._host, self._port, DESCRIBE_TOKEN)
        d = await flow.timeout_error(
            ref.get_reply(int(min_seq)),
            flow.SERVER_KNOBS.remote_client_request_timeout)
        self._status_token = d.get("status", 0)
        self._management_token = d.get("management", 0)
        self._info = _build_info(d, self._transport, self._host, self._port)

    async def info(self):
        if self._info is None:
            await self._describe(-1)
        return self._info

    async def refresh_past(self, used_seq: int) -> None:
        if self._info is not None and self._info.seq > used_seq:
            return
        await self._describe(max(used_seq, 0))

    async def get_status(self) -> dict:
        if not self._status_token:
            raise flow.error("client_invalid_operation")
        ref = self._transport.ref(self._host, self._port,
                                  self._status_token)
        from ..server.types import STATUS_REQUEST
        return await flow.timeout_error(
            ref.get_reply(STATUS_REQUEST),
            flow.SERVER_KNOBS.remote_client_request_timeout)

    # configure/exclude ride the inherited Database implementations —
    # ordinary \xff/conf//\xff/excluded transactions over the same
    # remote refs as any other write (ref: ManagementAPI building
    # system-key transactions client-side) — but keep the gateway's
    # management-token authorization gate for the convenience API

    def _check_management(self) -> None:
        if not self._management_token:
            raise flow.error("client_invalid_operation")

    async def configure(self, **kwargs) -> None:
        self._check_management()
        await super().configure(**kwargs)

    async def exclude(self, worker: str, exclude: bool = True) -> None:
        self._check_management()
        await super().exclude(worker, exclude)


class RemoteCluster:
    """Blocking handle: a background wall-clock loop thread owns the
    transport and scheduler; `call(coro)` executes client coroutines
    there and returns the result to the calling thread."""

    def __init__(self, host: str, port: int,
                 connect_timeout: float = None,
                 tls=None):
        self.host = host
        self.port = port
        self._tls = tls
        self._submissions: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._started: queue.Queue = queue.Queue()
        if connect_timeout is None:
            from ..flow import SERVER_KNOBS
            connect_timeout = SERVER_KNOBS.remote_connect_timeout
        self._connect_timeout = connect_timeout
        self._thread = threading.Thread(target=self._main, daemon=True)
        self._thread.start()
        # the loop thread's own boot timeout governs; the queue wait is
        # slightly longer so the REAL boot error arrives here instead
        # of a generic queue.Empty
        item = self._started.get(timeout=connect_timeout + 10)
        if isinstance(item, BaseException):
            raise item
        self.db: RemoteDatabase = item

    def _main(self) -> None:
        s = flow.Scheduler(virtual=False)
        flow.set_scheduler(s)
        transport = TcpTransport(tls=self._tls)
        try:
            transport.start()
            db = RemoteDatabase(transport, self.host, self.port)

            async def boot():
                await db.info()
                return True

            async def pump():
                # drain cross-thread submissions; each is
                # (coroutine, result_box, done_event)
                while not self._stop.is_set():
                    try:
                        coro, box, done = self._submissions.get_nowait()
                    except queue.Empty:
                        await flow.delay(
                            flow.SERVER_KNOBS.remote_client_poll_delay)
                        continue
                    flow.spawn(self._run_one(coro, box, done))

            t = s.spawn(boot())
            s.run(until=t, timeout_time=self._connect_timeout)
            self._started.put(db)
            s.run(until=s.spawn(pump()))
        except BaseException as e:  # noqa: BLE001 — surface to creator
            self._started.put(e)
        finally:
            self._stop.set()   # later call()s fail fast, never hang
            transport.close()
            flow.set_scheduler(None)

    @staticmethod
    async def _run_one(coro, box, done) -> None:
        try:
            box.append(("ok", await coro))
        except BaseException as e:  # noqa: BLE001 — marshalled to caller
            box.append(("err", e))
        finally:
            done.set()

    def call(self, coro, timeout: float = None):
        """Run a client coroutine on the loop thread; blocking."""
        if self._stop.is_set() or not self._thread.is_alive():
            raise flow.error("broken_promise")   # loop gone: fail fast
        if timeout is None:
            from ..flow import SERVER_KNOBS
            timeout = SERVER_KNOBS.remote_call_timeout
        box: list = []
        done = threading.Event()
        self._submissions.put((coro, box, done))
        if not done.wait(timeout):
            raise flow.error("timed_out")
        kind, value = box[0]
        if kind == "err":
            raise value
        return value

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
