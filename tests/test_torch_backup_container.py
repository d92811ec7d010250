"""The reference's cases of tests/test_backup_container.py on the port's
layers.

Backup containers: the abstract target + blob-store HTTP target.

Ref: fdbclient/BackupContainer.actor.cpp (file layout + describe),
BlobStore.actor.cpp / HTTP.actor.cpp (the S3-style object client the
blobstore:// URL scheme selects): a backup/restore round-trip THROUGH
the container API, including an HTTP object-store target.
"""

import pytest

torch = pytest.importorskip("torch")

import foundationdb_tpu_torch.layers.backup_agent as ba
from foundationdb_tpu_torch import flow
from foundationdb_tpu_torch.client import run_transaction
from foundationdb_tpu_torch.layers.backup_container import (BlobStoreContainer,
                                                      BlobStoreServer,
                                                      DirectoryContainer,
                                                      MemoryContainer,
                                                      open_container,
                                                      restore_from_container)
from foundationdb_tpu_torch.server import SimCluster


def _run_backup_workload(c, db):
    """Write two eras under a continuous backup; returns
    (agent, v_mid, v_end) once the tail covers everything."""
    async def work():
        async def write_kv(k, v):
            async def body(tr):
                tr.set(k, v)
            await run_transaction(db, body)

        agent = ba.BackupAgent(c, c.client("agent"))
        await agent.start()
        for i in range(6):
            await write_kv(b"a%d" % i, b"A")
        tr = db.create_transaction()
        await tr.get(b"a0")
        v_mid = await tr.get_read_version()
        for i in range(6):
            await write_kv(b"b%d" % i, b"B")
        tr2 = db.create_transaction()
        await tr2.get(b"b0")
        v_end = await tr2.get_read_version()
        await agent.wait_tailed_to(v_end)
        await agent.stop()
        return agent, v_mid, v_end
    return c.run(work(), timeout_time=600)


def _check_restore(c, db, container, to_version, expect_a, expect_b):
    async def main():
        async def wipe(tr):
            tr.clear_range(b"", b"\xff")
        await run_transaction(db, wipe)
        await restore_from_container(db, container, to_version)

        async def check(tr):
            got = dict(await tr.get_range(b"", b"\xff"))
            for i in range(6):
                assert (got.get(b"a%d" % i) == b"A") == expect_a, got
                assert (got.get(b"b%d" % i) == b"B") == expect_b, got
        await run_transaction(db, check, max_retries=200)
        return True
    assert c.run(main(), timeout_time=600)


def test_memory_container_roundtrip_and_pitr():
    c = SimCluster(seed=1601, durable=True)
    try:
        db = c.client()
        agent, v_mid, v_end = _run_backup_workload(c, db)
        cont = MemoryContainer()
        desc = agent.save_to(cont, chunk_records=3)  # force chunking
        assert desc["snapshot_versions"] == [agent.base_version]
        assert len(desc["log_ranges"]) >= 2          # actually chunked
        assert desc["max_restorable_version"] >= v_end

        # point-in-time: era A only
        _check_restore(c, db, cont, v_mid, expect_a=True, expect_b=False)
        # full: both eras
        _check_restore(c, db, cont, None, expect_a=True, expect_b=True)

        # a HOLE in the log chain makes the target unreachable, loudly
        middle = cont.list_objects("logs/")[1]
        cont.delete_object(middle)
        with pytest.raises(ValueError):
            cont.latest_restorable(v_end)
    finally:
        c.shutdown()


def test_directory_container_roundtrip(tmp_path):
    c = SimCluster(seed=1603, durable=True)
    try:
        db = c.client()
        agent, _v_mid, v_end = _run_backup_workload(c, db)
        cont = open_container(f"file://{tmp_path}/bk")
        agent.save_to(cont)
        # a fresh handle over the same directory sees the objects
        cont2 = DirectoryContainer(str(tmp_path / "bk"))
        assert cont2.describe()["max_restorable_version"] >= v_end
        _check_restore(c, db, cont2, None, expect_a=True, expect_b=True)
    finally:
        c.shutdown()


def test_blobstore_container_over_real_http():
    """The blobstore:// target: objects round-trip through a real HTTP
    object server on localhost (PUT/GET/LIST/DELETE), and restore
    consumes them through the same container API."""
    server = BlobStoreServer()
    c = SimCluster(seed=1605, durable=True)
    try:
        db = c.client()
        agent, _v_mid, v_end = _run_backup_workload(c, db)
        cont = open_container(f"blobstore://{server.host}:{server.port}")
        assert isinstance(cont, BlobStoreContainer)
        agent.save_to(cont, chunk_records=4)

        # raw object semantics
        cont.put_object("properties/unittest", b"hello")
        assert cont.get_object("properties/unittest") == b"hello"
        assert "properties/unittest" in cont.list_objects("properties/")
        cont.delete_object("properties/unittest")
        assert cont.get_object("properties/unittest") is None
        assert cont.get_object("no/such/object") is None

        desc = cont.describe()
        assert desc["max_restorable_version"] >= v_end

        # the sim fetches are separable from the HTTP IO: pull the
        # restorable set over HTTP first, then restore inside the sim
        blob, records, target = cont.latest_restorable()
        from foundationdb_tpu_torch.layers.backup_container import \
            _records_to_log_blob

        async def main():
            async def wipe(tr):
                tr.clear_range(b"", b"\xff")
            await run_transaction(db, wipe)
            await ba.restore_to_version(
                db, blob, _records_to_log_blob(records, 0), target)

            async def check(tr):
                got = dict(await tr.get_range(b"", b"\xff"))
                assert all(got.get(b"a%d" % i) == b"A" for i in range(6))
                assert all(got.get(b"b%d" % i) == b"B" for i in range(6))
            await run_transaction(db, check, max_retries=200)
            return True
        assert c.run(main(), timeout_time=600)
    finally:
        c.shutdown()
        server.close()


def test_blobstore_hmac_auth():
    """Requests are HMAC-signed per (verb, date, resource); the server
    rejects missing, wrong-secret, and stale-date requests (ref:
    BlobStore.actor.cpp setAuthHeaders — S3 V2 shape)."""
    from foundationdb_tpu_torch.layers.backup_container import (
        BlobStoreContainer, BlobStoreServer)

    srv = BlobStoreServer(secrets={"acct": "s3cret"})
    try:
        good = BlobStoreContainer(srv.host, srv.port,
                                  key="acct", secret="s3cret")
        good.put_object("a/b", b"payload")
        assert good.get_object("a/b") == b"payload"
        assert good.list_objects("a/") == ["a/b"]

        bad = BlobStoreContainer(srv.host, srv.port,
                                 key="acct", secret="wrong")
        with pytest.raises(IOError):
            bad.put_object("a/c", b"x")
        anon = BlobStoreContainer(srv.host, srv.port)
        with pytest.raises(IOError):
            anon.get_object("a/b")
        # the object store was not touched by the rejects
        assert good.list_objects("") == ["a/b"]
    finally:
        srv.close()


def test_blobstore_multipart_upload():
    """Objects above the multipart threshold upload in parts and appear
    atomically at completion (ref: S3 multipart via BlobStore client)."""
    from foundationdb_tpu_torch import flow
    from foundationdb_tpu_torch.layers.backup_container import (
        BlobStoreContainer, BlobStoreServer)

    srv = BlobStoreServer()
    try:
        c = BlobStoreContainer(srv.host, srv.port)
        big = bytes(range(256)) * 4096   # 1MB > 256KB threshold
        assert len(big) > flow.SERVER_KNOBS.blobstore_multipart_threshold
        c.put_object("big", big)
        assert c.get_object("big") == big
        # several parts were actually used
        assert len(big) > flow.SERVER_KNOBS.blobstore_multipart_part_bytes
    finally:
        srv.close()


def test_blobstore_retries_transient_failures():
    """Connection errors and 5xx retry with backoff under the try
    budget; 4xx answers do not retry (ref: BlobStore doRequest)."""
    from foundationdb_tpu_torch.layers.backup_container import (
        BlobStoreContainer, BlobStoreServer, _BlobHandler)
    import threading
    from http.server import ThreadingHTTPServer

    fail_n = {"n": 2, "seen": 0}

    class Flaky(_BlobHandler):
        store = {}
        lock = threading.Lock()
        secrets = {}
        uploads = {}
        upload_names = {}

        def do_GET(self):
            with self.lock:
                fail_n["seen"] += 1
                if fail_n["seen"] <= fail_n["n"]:
                    return self._ok(status=503)
            return super().do_GET()

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Flaky)
    host, port = httpd.server_address[:2]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        c = BlobStoreContainer(host, port)
        c.put_object("k", b"v")
        # first GET eats the two 503s, then succeeds
        assert c.get_object("k") == b"v"
        assert fail_n["seen"] >= 3
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)


def test_blobstore_authenticated_url_round_trip():
    """open_container parses credentials from the URL and the whole
    backup surface works through an authenticated store."""
    from foundationdb_tpu_torch.layers.backup_container import (
        BlobStoreServer, open_container)

    srv = BlobStoreServer(secrets={"k1": "sec1"})
    try:
        c = open_container(f"blobstore://k1:sec1@{srv.host}:{srv.port}")
        c.put_object("snap/1", b"data1")
        c.put_object("snap/2", b"data2")
        assert c.list_objects("snap/") == ["snap/1", "snap/2"]
        c.delete_object("snap/1")
        assert c.list_objects("snap/") == ["snap/2"]
    finally:
        srv.close()
