"""The reference's tests/test_c_binding.py on the port.

Native C client binding e2e: real sockets, real wire protocol.

A wall-clock SimCluster serves its client endpoints through a
TcpGateway (rpc/gateway.py) in a background thread; the C library
(bindings/c/fdb_tpu.cpp, loaded via ctypes) connects from the test
thread like any out-of-process client and must deliver the full client
contract — RYW, atomics, shard-routed range reads, selectors, OCC
conflicts, and the on_error retry protocol.

Ref: bindings/c/fdb_c.cpp + bindings/python/fdb (the binding surface),
fdbclient/NativeAPI.actor.cpp (the client logic the C library
re-implements), bindings/bindingtester (cross-binding parity — see
test_cross_binding_parity).
"""

import queue
import random
import threading

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch.bindings.c_client import (CClientError, CDatabase,
                                                      load_library)

pytestmark = pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")


class GatewayedCluster:
    """Wall-clock SimCluster + TcpGateway on a background thread."""

    def __init__(self, gateway_protocol: bytes = None, **kw):
        self.kw = kw
        self.gateway_protocol = gateway_protocol
        self.q: queue.Queue = queue.Queue()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._main, daemon=True)
        self.port = None

    def __enter__(self):
        self.thread.start()
        item = self.q.get(timeout=120)
        if isinstance(item, BaseException):
            raise item
        self.port = item
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=120)
        # surface any simulation-thread crash that happened after the
        # port was handed out — otherwise it shows up only as an opaque
        # C-client timeout
        while not self.q.empty():
            item = self.q.get_nowait()
            if isinstance(item, BaseException) and exc == (None, None, None):
                raise item

    def _main(self):
        import foundationdb_tpu_torch.flow as fl
        from foundationdb_tpu_torch.rpc.gateway import TcpGateway
        from foundationdb_tpu_torch.server.cluster import SimCluster

        gw = None
        c = None
        try:
            c = SimCluster(virtual=False, **self.kw)
            db = c.client("gateway-host")
            gw = TcpGateway(db, protocol=self.gateway_protocol)

            async def main():
                gw.start()
                self.q.put(gw.port)
                while not self.stop.is_set():
                    await fl.delay(0.02)

            c.run(main())
        except BaseException as e:  # noqa: BLE001 — surface to the test
            self.q.put(e)
        finally:
            if gw is not None:
                gw.close()
            if c is not None:
                c.shutdown()


def test_c_client_end_to_end():
    load_library()
    with GatewayedCluster(seed=21, n_storage=2, n_proxies=2) as gc:
        db = CDatabase("127.0.0.1", gc.port)
        try:
            tr = db.create_transaction()

            # blind writes on both sides of the shard split + commit
            tr.set(b"alpha", b"1")
            tr.set(b"zeta", b"26")
            tr.set(b"beta", b"2")
            v1 = tr.commit()
            assert v1 > 0
            stamp = tr.get_versionstamp()
            assert len(stamp) == 10
            assert int.from_bytes(stamp[:8], "big") == v1

            # fresh transaction observes the commit; RYW overlays
            tr.reset()
            assert tr.get(b"alpha") == b"1"
            assert tr.get(b"missing") is None
            tr.set(b"alpha", b"overlaid")
            assert tr.get(b"alpha") == b"overlaid"
            tr.clear(b"beta")
            assert tr.get(b"beta") is None
            # cross-shard range read merges base + overlay
            rows = tr.get_range(b"a", b"zz")
            assert rows == [(b"alpha", b"overlaid"), (b"zeta", b"26")]
            rows_rev = tr.get_range(b"a", b"zz", reverse=True)
            assert rows_rev == rows[::-1]
            rows_lim = tr.get_range(b"a", b"zz", limit=1)
            assert rows_lim == [(b"alpha", b"overlaid")]
            tr.commit()

            # atomics: server-side apply + RYW fold
            tr.reset()
            tr.atomic_op(b"ctr", (5).to_bytes(8, "little"), 2)  # ADD
            assert tr.get(b"ctr") == (5).to_bytes(8, "little")
            tr.commit()
            tr.reset()
            tr.atomic_op(b"ctr", (7).to_bytes(8, "little"), 2)
            assert tr.get(b"ctr") == (12).to_bytes(8, "little")
            tr.commit()
            tr.reset()
            assert tr.get(b"ctr") == (12).to_bytes(8, "little")

            # selectors: firstGreaterThan walks to the next present key
            assert tr.get_key(b"alpha", True, 1) == b"ctr"
            # lastLessThan from beyond the end resolves the last key
            assert tr.get_key(b"\xfe", False, 0) == b"zeta"

            # OCC conflict: two readers of the same key, both write it
            t1 = db.create_transaction()
            t2 = db.create_transaction()
            assert t1.get(b"occ") is None
            assert t2.get(b"occ") is None
            t1.set(b"occ", b"first")
            t1.commit()
            t2.set(b"occ", b"second")
            with pytest.raises(CClientError) as ei:
                t2.commit()
            assert ei.value.code == 1020  # not_committed
            t2.on_error(ei.value.code)    # resets for retry
            assert t2.get(b"occ") == b"first"
            t2.set(b"occ", b"second")
            t2.commit()
            t1.destroy()
            t2.destroy()

            # explicit conflict ranges
            t3 = db.create_transaction()
            t3.get_read_version()  # snapshot predates t4's commit
            t3.add_conflict_range(b"occ", b"occ\x00", write=False)
            t3.set(b"unrelated", b"x")
            t4 = db.create_transaction()
            t4.set(b"occ", b"third")
            t4.commit()
            with pytest.raises(CClientError) as ei:
                t3.commit()
            assert ei.value.code == 1020
            t3.destroy()
            t4.destroy()

            # error table sanity
            lib = load_library()
            assert lib.fdb_tpu_get_error(1020) == b"not_committed"
            assert lib.fdb_tpu_error_retryable(1020) == 1
            assert lib.fdb_tpu_error_retryable(2000) == 0

            # system-keyspace gate parity with the Python client: \xff
            # reads/writes need the option; scans clamp at user space
            t5 = db.create_transaction()
            for op in (lambda: t5.get(b"\xff/x"),
                       lambda: t5.get_range(b"", b"\xff\xf0"),
                       lambda: t5.set(b"\xff\x02/own", b"x"),
                       lambda: t5.atomic_op(
                           b"\xff/x", (1).to_bytes(8, "little"), 2)):
                with pytest.raises(CClientError) as ei:
                    op()
                assert ei.value.code == 2004, ei.value
            # selectors walking off the end clamp to \xff, not \xff\x02
            assert t5.get_key(b"\xfe", False, 9) == b"\xff"
            with pytest.raises(CClientError) as ei:
                t5.set_option("bogus_option")
            assert ei.value.code == 2006
            t5.set_option("access_system_keys")
            t5.set(b"\xff\x02/own", b"x")       # stored subspace: allowed
            t5.commit()
            t5.reset()                           # options reset
            with pytest.raises(CClientError):
                t5.get(b"\xff\x02/own")
            t5.set_option("read_system_keys")
            assert t5.get(b"\xff\x02/own") == b"x"
            with pytest.raises(CClientError):
                t5.set(b"\xff\x02/own", b"y")    # read option: no writes
            t5.destroy()

            tr.destroy()
        finally:
            db.close()


def _make_script(seed: int, n_ops: int = 80):
    """Deterministic op script both bindings execute (the bindingtester
    idiom: same instruction stream, byte-compared outcomes)."""
    rng = random.Random(seed)
    keys = [b"bt/%02d" % i for i in range(14)] + \
           [b"bt/\x00bin", b"bt/\xfe\xff", b"bt/"]
    atomic_ops = [2, 6, 7, 8, 9, 12, 13, 16, 17, 18, 19, 20]

    def rkey():
        return rng.choice(keys)

    def rval():
        return bytes(rng.randrange(256) for _ in range(rng.randrange(0, 9)))

    script = []
    for _ in range(n_ops):
        c = rng.random()
        if c < 0.22:
            script.append(("set", rkey(), rval()))
        elif c < 0.30:
            script.append(("clear", rkey()))
        elif c < 0.36:
            a, b = sorted((rkey(), rkey()))
            script.append(("clear_range", a, b + b"\x00"))
        elif c < 0.56:
            script.append(("get", rkey()))
        elif c < 0.70:
            a, b = sorted((rkey(), rkey()))
            script.append(("get_range", a, b + b"\x00",
                           rng.choice([0, 1, 2, 5]),
                           rng.random() < 0.3))
        elif c < 0.78:
            script.append(("get_key", rkey(), rng.random() < 0.5,
                           rng.randrange(-2, 3)))
        elif c < 0.92:
            script.append(("atomic", rkey(), rval(),
                           rng.choice(atomic_ops)))
        else:
            script.append(("commit",))
    return script


def _run_script_python(script, seed):
    """Execute on the in-process Python binding (virtual-time cluster)."""
    from foundationdb_tpu_torch.server.cluster import SimCluster
    from foundationdb_tpu_torch.server.types import KeySelector

    c = SimCluster(seed=seed, n_storage=2)
    try:
        db = c.client()
        results = []

        async def main():
            tr = db.create_transaction()
            for op in script:
                if op[0] == "set":
                    tr.set(op[1], op[2])
                elif op[0] == "clear":
                    tr.clear(op[1])
                elif op[0] == "clear_range":
                    tr.clear_range(op[1], op[2])
                elif op[0] == "get":
                    results.append(("get", await tr.get(op[1])))
                elif op[0] == "get_range":
                    limit = op[3] if op[3] else 1 << 20
                    results.append(("range", await tr.get_range(
                        op[1], op[2], limit=limit, reverse=op[4])))
                elif op[0] == "get_key":
                    results.append(("key", await tr.get_key(
                        KeySelector(op[1], op[2], op[3]))))
                elif op[0] == "atomic":
                    tr.atomic_op(op[1], op[2], op[3])
                elif op[0] == "commit":
                    await tr.commit()
                    tr = db.create_transaction()
            await tr.commit()
            tr2 = db.create_transaction()
            results.append(("final", await tr2.get_range(b"", b"\xff")))
            return True

        assert c.run(main(), timeout_time=600)
        return results
    finally:
        c.shutdown()


def _run_script_c(script, seed):
    """Execute the same stream through the C binding over the gateway."""
    with GatewayedCluster(seed=seed, n_storage=2) as gc:
        db = CDatabase("127.0.0.1", gc.port)
        try:
            results = []
            tr = db.create_transaction()
            for op in script:
                if op[0] == "set":
                    tr.set(op[1], op[2])
                elif op[0] == "clear":
                    tr.clear(op[1])
                elif op[0] == "clear_range":
                    tr.clear_range(op[1], op[2])
                elif op[0] == "get":
                    results.append(("get", tr.get(op[1])))
                elif op[0] == "get_range":
                    results.append(("range", tr.get_range(
                        op[1], op[2], limit=op[3], reverse=op[4])))
                elif op[0] == "get_key":
                    results.append(("key", tr.get_key(op[1], op[2], op[3])))
                elif op[0] == "atomic":
                    tr.atomic_op(op[1], op[2], op[3])
                elif op[0] == "commit":
                    tr.commit()
                    tr.reset()
            tr.commit()
            tr.reset()
            results.append(("final", tr.get_range(b"", b"\xff")))
            tr.destroy()
            return results
        finally:
            db.close()


@pytest.mark.parametrize("seed", [101, 202, 303])
def test_cross_binding_parity(seed):
    """bindingtester analogue: an identical randomized instruction
    stream through the Python binding and the native C binding must
    produce byte-identical outcomes — every get, every range (with
    limits/reverse/RYW overlay/atomic folds), every selector
    resolution, and the final full scan (ref: bindings/bindingtester —
    same stack machine, compared results)."""
    load_library()
    script = _make_script(seed)
    py = _run_script_python(script, seed)
    cc = _run_script_c(script, seed)
    assert len(py) == len(cc)
    for i, (a, b) in enumerate(zip(py, cc)):
        assert a == b, f"op result {i} diverged: python={a!r} c={b!r}"


def test_c_binding_watch():
    """The C binding's blocking watch fires when another client writes
    the key (ref: fdb_transaction_watch; thread-safe blocking shape)."""
    import threading

    load_library()
    with GatewayedCluster(seed=22) as gc:
        db = CDatabase("127.0.0.1", gc.port)
        try:
            tr = db.create_transaction()
            tr.set(b"wkey", b"v0")
            tr.commit()
            tr.destroy()

            fired = []

            def watcher():
                db.watch(b"wkey", timeout_ms=30000)
                fired.append(True)

            t = threading.Thread(target=watcher)
            t.start()
            import time
            time.sleep(0.3)   # let the long poll arm
            assert not fired

            t2 = db.create_transaction()
            t2.set(b"wkey", b"v1")
            t2.commit()
            t2.destroy()
            t.join(timeout=30)
            assert fired, "watch never fired"
        finally:
            db.close()


def test_cross_binding_parity_deep():
    """A longer instruction stream (300 ops) through both bindings —
    the bindingtester's depth knob (kept to one seed so the suite
    stays fast; more seeds ran in earlier sweeps)."""
    load_library()
    script = _make_script(911, n_ops=300)
    py = _run_script_python(script, 911)
    cc = _run_script_c(script, 911)
    assert py == cc
