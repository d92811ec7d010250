"""Backup containers: the abstract backup target + a blob-store target.

Ref: fdbclient/BackupContainer.actor.cpp (the container file layout —
snapshot files named by version, mutation-log files named by version
range, plus a describable manifest), fdbclient/BlobStore.actor.cpp (the
S3-compatible object client) and fdbclient/HTTP.actor.cpp (its HTTP
layer). The reference's backup URL scheme (`file://...`,
`blobstore://host:port/...`) maps here to container classes behind one
interface:

  MemoryContainer      in-process dict (tests, DR staging)
  DirectoryContainer   real files in a directory (`file://`)
  BlobStoreContainer   HTTP object PUT/GET/DELETE/LIST against a real
                       socket server (`blobstore://`) — the in-repo
                       BlobStoreServer provides the S3-ish endpoint the
                       way the reference expects an external store

Object layout inside a container (ref: BackupContainer's
snapshots/logs/ directory split):

  snapshots/snapshot,<version>        one range-snapshot blob
  logs/log,<begin>,<end>              one mutation-log chunk
  properties/...                      small metadata objects
"""

from __future__ import annotations

import hashlib
import hmac
import json
import socket
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import quote, unquote

from . import backup as snapshot_backup
from . import backup_agent as agent_mod

# Shared IThreadPool for blocking blob IO on WALL-CLOCK schedulers
# (ref: the eio pool behind AsyncFileEIO — the reference never runs
# blocking network IO on the Net2 loop). One pool per scheduler: the
# reactor actor dies with its loop, so a new run loop lazily gets a
# fresh pool. The deterministic simulator never uses it — pool threads
# would break determinism, and the in-sim blob server answers fast.
_blob_pool = None
_blob_pool_sched = None


def _offload(fn, *args):
    """A flow Future running fn on the shared blob pool, or None when
    the caller should just run it inline (no scheduler, or a virtual
    one)."""
    from ..flow.scheduler import _tls
    s = _tls.current
    if s is None or s.virtual:
        return None
    global _blob_pool, _blob_pool_sched
    if _blob_pool is None or _blob_pool_sched is not s:
        from ..flow.threadpool import ThreadPool
        if _blob_pool is not None:
            # a NEW run loop replaced the one this pool's reactor lived
            # on: stop its worker threads and error its outstanding
            # futures instead of leaking both per scheduler generation
            try:
                _blob_pool.close()
            except Exception:  # noqa: BLE001 — old loop already gone
                pass
        _blob_pool = ThreadPool(n_threads=2, name="blobio")
        _blob_pool.start()
        _blob_pool_sched = s
    return _blob_pool.run(fn, *args)


class BackupContainer:
    """Object-store surface every backup target implements (ref:
    IBackupContainer)."""

    async def arun(self, fn, *args):
        """Run a blocking container operation from a flow actor without
        stalling the loop (blob retry backoff would block the
        whole scheduler): wall-clock schedulers ship the call — wire
        attempts AND backoff sleeps — to the blob IThreadPool; the
        deterministic simulator calls inline (its retry backoff skips
        the wall sleep instead, see BlobStoreContainer._retry_backoff).
        Pool-run exceptions surface as io_error (the original rides the
        ThreadPoolTaskError trace)."""
        fut = _offload(fn, *args)
        if fut is None:
            return fn(*args)
        return await fut

    def put_object(self, name: str, data: bytes) -> None:
        raise NotImplementedError

    def get_object(self, name: str) -> Optional[bytes]:
        raise NotImplementedError

    def list_objects(self, prefix: str = "") -> List[str]:
        raise NotImplementedError

    def delete_object(self, name: str) -> None:
        raise NotImplementedError

    # -- the backup file layout (shared by every target) ----------------
    def store_snapshot(self, blob: bytes, version: int) -> str:
        name = f"snapshots/snapshot,{version:020d}"
        self.put_object(name, blob)
        return name

    def store_log(self, blob: bytes, begin: int, end: int) -> str:
        name = f"logs/log,{begin:020d},{end:020d}"
        self.put_object(name, blob)
        return name

    def describe(self) -> dict:
        """Manifest view (ref: BackupContainer describeBackup):
        snapshot versions + contiguous log coverage + restorability."""
        snaps = sorted(int(n.rsplit(",", 1)[1])
                       for n in self.list_objects("snapshots/"))
        logs = sorted(tuple(map(int, n.split(",")[1:]))
                      for n in self.list_objects("logs/"))
        max_restorable = None
        if snaps:
            max_restorable = snaps[-1]
            cursor = snaps[-1]
            for b, e in logs:
                # a chunk named (b, e] certifies versions strictly
                # above b only — contiguity requires b <= cursor
                if b <= cursor and e > cursor:
                    cursor = e
            max_restorable = cursor
        return {"snapshot_versions": snaps, "log_ranges": logs,
                "max_restorable_version": max_restorable}

    def latest_restorable(self, to_version: Optional[int] = None
                          ) -> Tuple[bytes, list, int]:
        """The snapshot blob + ordered log records needed to restore to
        `to_version` (default: the newest restorable point). Raises
        ValueError when the container cannot reach that version."""
        d = self.describe()
        snaps = d["snapshot_versions"]
        if not snaps:
            raise ValueError("container holds no snapshot")
        target = to_version if to_version is not None \
            else d["max_restorable_version"]
        base = None
        for v in snaps:
            if v <= target:
                base = v
        if base is None:
            raise ValueError(
                f"no snapshot at or below target version {target}")
        blob = self.get_object(f"snapshots/snapshot,{base:020d}")
        records: list = []
        covered = base
        for b, e in sorted(tuple(map(int, n.split(",")[1:]))
                           for n in self.list_objects("logs/")):
            if e <= covered or b > target:
                continue
            if b > covered and covered < target:
                # a hole below the target makes it unreachable
                break
            chunk = self.get_object(f"logs/log,{b:020d},{e:020d}")
            _bv, recs = agent_mod.read_log(chunk)
            # clip to (covered, target]: overlapping chunks (e.g. two
            # save_to() calls) must not replay a record twice
            records.extend((v, ms) for v, ms in recs
                           if covered < v <= target and v > base)
            covered = max(covered, e)
        if covered < target:
            raise ValueError(
                f"log coverage ends at {covered}, target {target}")
        return blob, records, target


class MemoryContainer(BackupContainer):
    def __init__(self):
        self._objects: Dict[str, bytes] = {}

    def put_object(self, name: str, data: bytes) -> None:
        self._objects[name] = bytes(data)

    def get_object(self, name: str) -> Optional[bytes]:
        return self._objects.get(name)

    def list_objects(self, prefix: str = "") -> List[str]:
        return sorted(n for n in self._objects if n.startswith(prefix))

    def delete_object(self, name: str) -> None:
        self._objects.pop(name, None)


class DirectoryContainer(BackupContainer):
    """`file://` target: objects are real files under a directory."""

    def __init__(self, root: str):
        import os
        self._root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, name: str) -> str:
        import os
        # object names map to REAL subdirectories; non-canonical names
        # (empty/./.. segments) are rejected rather than normalized so
        # distinct names can never collide on disk
        parts = name.split("/")
        if not parts or any(p in ("", ".", "..") for p in parts):
            raise ValueError(f"non-canonical object name: {name!r}")
        return os.path.join(self._root, *parts)

    def put_object(self, name: str, data: bytes) -> None:
        import os
        path = self._path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def get_object(self, name: str) -> Optional[bytes]:
        try:
            with open(self._path(name), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def list_objects(self, prefix: str = "") -> List[str]:
        import os
        out = []
        for dirpath, _dirs, files in os.walk(self._root):
            rel = os.path.relpath(dirpath, self._root)
            for fn in files:
                if fn.endswith(".tmp"):
                    continue
                name = fn if rel == "." else f"{rel}/{fn}".replace(
                    os.sep, "/")
                if name.startswith(prefix):
                    out.append(name)
        return sorted(out)

    def delete_object(self, name: str) -> None:
        import os
        try:
            os.unlink(self._path(name))
        except FileNotFoundError:
            pass


# ---------------------------------------------------------------------
# blobstore:// — HTTP object store over real sockets
# ---------------------------------------------------------------------

class _BlobHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    store: Dict[str, bytes] = {}
    lock = threading.Lock()
    #: access-key -> secret; empty dict = unauthenticated server
    secrets: Dict[str, str] = {}
    uploads: Dict[str, Dict[int, bytes]] = {}
    upload_names: Dict[str, str] = {}
    completed_uploads: Dict[str, str] = {}   # uploadId -> object name

    def log_message(self, *a):   # no stderr noise in tests
        pass

    def _split(self) -> Tuple[str, Dict[str, str]]:
        from urllib.parse import parse_qsl
        path, _, query = self.path.partition("?")
        return (unquote(path.lstrip("/")),
                dict(parse_qsl(query, keep_blank_values=True)))

    def _authorized(self, verb: str) -> bool:
        """HMAC request auth (ref: BlobStore.actor.cpp setAuthHeaders —
        S3 V2 shape: sign (verb, date, resource) with the account
        secret; a date outside the replay window is rejected even with
        a valid signature)."""
        if not self.secrets:
            return True
        auth = self.headers.get("Authorization", "")
        date = self.headers.get("X-FDBTPU-Date", "")
        if not auth.startswith("FDBTPU ") or ":" not in auth[7:]:
            return False
        key, _, sig = auth[7:].partition(":")
        secret = self.secrets.get(key)
        if secret is None:
            return False
        try:
            then = float(date)
        except ValueError:
            return False
        from ..flow import SERVER_KNOBS
        if abs(time.time() - then) > SERVER_KNOBS.blobstore_auth_window:
            return False
        want = _sign(secret, verb, date, self.path)
        return hmac.compare_digest(sig, want)

    def _deny(self) -> None:
        # drain the request body first: HTTP/1.1 keep-alive parses the
        # unread body as the next request line otherwise
        length = int(self.headers.get("Content-Length", 0))
        if length:
            self.rfile.read(length)
        self.send_response(403)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def _ok(self, body: bytes = b"", status: int = 200,
            ctype: str = "application/octet-stream") -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def do_PUT(self):
        if not self._authorized("PUT"):
            return self._deny()
        name, q = self._split()
        length = int(self.headers.get("Content-Length", 0))
        data = self.rfile.read(length)
        if "uploadId" in q and "partNumber" in q:
            # one part of a multipart upload (ref: S3 UploadPart)
            with self.lock:
                parts = self.uploads.get(q["uploadId"])
                if parts is None or self.upload_names.get(
                        q["uploadId"]) != name:
                    return self._ok(status=404)
                parts[int(q["partNumber"])] = data
            return self._ok()
        with self.lock:
            self.store[name] = data
        self._ok()

    def do_POST(self):
        if not self._authorized("POST"):
            return self._deny()
        name, q = self._split()
        length = int(self.headers.get("Content-Length", 0))
        self.rfile.read(length)
        if "uploads" in q:
            # initiate multipart (ref: S3 CreateMultipartUpload)
            uid = uuid.uuid4().hex
            with self.lock:
                self.uploads[uid] = {}
                self.upload_names[uid] = name
                # bounded in-flight uploads, oldest evicted
                # (a client dying between initiate and abort/complete —
                # including a failed abort-on-exception — leaked its
                # parts forever; mirror the completed_uploads cap. An
                # evicted-but-live upload's later part PUTs get 404 and
                # the client's retry budget surfaces the failure.)
                while len(self.uploads) > 256:
                    old = next(iter(self.uploads))
                    self.uploads.pop(old, None)
                    self.upload_names.pop(old, None)
            return self._ok(json.dumps({"uploadId": uid}).encode(),
                            ctype="application/json")
        if "uploadId" in q:
            # complete: assemble parts in part-number order; the object
            # appears atomically only now. IDEMPOTENT on retry: a
            # client whose first complete succeeded but whose response
            # was lost must get 200, not 404 (ref:
            # CompleteMultipartUpload semantics the retry layer assumes)
            with self.lock:
                owner = self.upload_names.get(q["uploadId"])
                if owner is not None and owner != name:
                    return self._ok(status=404)   # wrong object name
                parts = self.uploads.pop(q["uploadId"], None)
                self.upload_names.pop(q["uploadId"], None)
                if parts is None:
                    if self.completed_uploads.get(q["uploadId"]) == name:
                        return self._ok()
                    return self._ok(status=404)
                self.store[name] = b"".join(
                    parts[i] for i in sorted(parts))
                self.completed_uploads[q["uploadId"]] = name
                # retry memory, bounded: only recent completions need
                # the idempotent answer
                while len(self.completed_uploads) > 256:
                    self.completed_uploads.pop(
                        next(iter(self.completed_uploads)))
            return self._ok()
        self._ok(status=400)

    def do_GET(self):
        if not self._authorized("GET"):
            return self._deny()
        name, q = self._split()
        if "list" in q:
            prefix = q["list"]
            with self.lock:
                names = sorted(n for n in self.store
                               if n.startswith(prefix))
            return self._ok(json.dumps(names).encode(),
                            ctype="application/json")
        with self.lock:
            data = self.store.get(name)
        if data is None:
            return self._ok(status=404)
        self._ok(data)

    def do_DELETE(self):
        if not self._authorized("DELETE"):
            return self._deny()
        name, q = self._split()
        with self.lock:
            if "uploadId" in q:     # abort multipart (name must match)
                if self.upload_names.get(q["uploadId"]) == name:
                    self.uploads.pop(q["uploadId"], None)
                    self.upload_names.pop(q["uploadId"], None)
            else:
                self.store.pop(name, None)
        self._ok()


def _sign(secret: str, verb: str, date: str, resource: str) -> str:
    msg = "\n".join((verb, date, resource)).encode()
    return hmac.new(secret.encode(), msg, hashlib.sha256).hexdigest()


class BlobStoreServer:
    """An S3-shaped object server on a real socket (the endpoint the
    reference's BlobStore client talks to): per-request HMAC auth,
    multipart uploads assembled atomically at completion, prefix
    listing. Each instance has an isolated object namespace."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 secrets: Optional[Dict[str, str]] = None):
        handler = type("Handler", (_BlobHandler,),
                       {"store": {}, "lock": threading.Lock(),
                        "secrets": dict(secrets or {}),
                        "uploads": {}, "upload_names": {},
                        "completed_uploads": {}})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)


class BlobStoreContainer(BackupContainer):
    """HTTP client side (ref: BlobStore.actor.cpp doRequest over
    HTTP.actor.cpp): every request retries transient failures
    (connection errors, 5xx) with exponential backoff under a bounded
    try budget; requests are HMAC-signed when credentials are given;
    large objects upload in parts, each part retried independently,
    and the object appears only at completion."""

    def __init__(self, host: str, port: int, timeout: float = None,
                 key: str = "", secret: str = ""):
        from ..flow import SERVER_KNOBS
        if timeout is None:
            timeout = SERVER_KNOBS.blobstore_request_timeout
        self.host, self.port, self.timeout = host, port, timeout
        self.key, self.secret = key, secret

    def _conn(self):
        import http.client
        return http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)

    def _headers(self, verb: str, path: str) -> Dict[str, str]:
        if not self.key:
            return {}
        date = repr(time.time())
        return {"X-FDBTPU-Date": date,
                "Authorization": "FDBTPU %s:%s" % (
                    self.key, _sign(self.secret, verb, date, path))}

    @staticmethod
    def _retry_backoff(seconds: float) -> None:
        """Backoff between wire attempts. On ANY flow scheduler's
        thread a time.sleep stalls the whole run loop (up to
        ~4s of cumulative scheduler stall per down endpoint — and on a
        virtual scheduler the sleep does not even advance simulated
        time), so the retry proceeds immediately there: each attempt
        stays bounded by the connection timeout, so a down endpoint
        costs tries x timeout, never an added backoff stall. Off the
        loop — tools, and pure container IO shipped to the blob
        IThreadPool via BackupContainer.arun — the backoff really
        waits."""
        from ..flow.scheduler import _tls
        if _tls.current is not None:
            return
        time.sleep(seconds)

    def _request(self, verb: str, path: str, body: bytes = b""):
        """One logical request = up to BLOBSTORE_REQUEST_TRIES wire
        attempts; connection failures and 5xx retry with exponential
        backoff, 4xx and 404 do not (they are answers, not weather)."""
        from ..flow import SERVER_KNOBS
        tries = int(SERVER_KNOBS.blobstore_request_tries)
        backoff = SERVER_KNOBS.blobstore_backoff_min
        last = None
        for attempt in range(tries):
            c = self._conn()
            try:
                c.request(verb, path, body=body,
                          headers=self._headers(verb, path))
                r = c.getresponse()
                data = r.read()
                if r.status >= 500:
                    last = IOError(f"{verb} {path}: HTTP {r.status}")
                else:
                    return r.status, data
            except OSError as e:
                last = e
            finally:
                c.close()
            if attempt + 1 < tries:
                self._retry_backoff(backoff)
                backoff = min(backoff * 2,
                              SERVER_KNOBS.blobstore_backoff_max)
        raise IOError(f"{verb} {path}: retries exhausted ({last})")

    def put_object(self, name: str, data: bytes) -> None:
        from ..flow import SERVER_KNOBS
        path = "/" + quote(name, safe="/,")
        if len(data) > SERVER_KNOBS.blobstore_multipart_threshold:
            return self._put_multipart(name, path, data)
        status, _ = self._request("PUT", path, data)
        if status != 200:
            raise IOError(f"PUT {name}: HTTP {status}")

    def _put_multipart(self, name: str, path: str, data: bytes) -> None:
        from ..flow import SERVER_KNOBS
        part_bytes = int(SERVER_KNOBS.blobstore_multipart_part_bytes)
        status, body = self._request("POST", path + "?uploads")
        if status != 200:
            raise IOError(f"POST {name}?uploads: HTTP {status}")
        uid = json.loads(body)["uploadId"]
        try:
            for i in range(0, len(data), part_bytes):
                status, _ = self._request(
                    "PUT", "%s?partNumber=%d&uploadId=%s"
                    % (path, i // part_bytes, uid),
                    data[i:i + part_bytes])
                if status != 200:
                    raise IOError(f"PUT {name} part: HTTP {status}")
            status, _ = self._request("POST",
                                      "%s?uploadId=%s" % (path, uid))
            if status != 200:
                raise IOError(f"complete {name}: HTTP {status}")
        except BaseException:
            try:
                self._request("DELETE", "%s?uploadId=%s" % (path, uid))
            except IOError:
                pass   # orphaned upload: server-side garbage, not data
            raise

    def get_object(self, name: str) -> Optional[bytes]:
        status, data = self._request("GET", "/" + quote(name, safe="/,"))
        if status == 404:
            return None
        if status != 200:
            raise IOError(f"GET {name}: HTTP {status}")
        return data

    def list_objects(self, prefix: str = "") -> List[str]:
        status, data = self._request("GET",
                                     "/?list=" + quote(prefix, safe=""))
        if status != 200:
            raise IOError(f"LIST {prefix}: HTTP {status}")
        return json.loads(data)

    def delete_object(self, name: str) -> None:
        status, _ = self._request("DELETE", "/" + quote(name, safe="/,"))
        if status != 200:
            raise IOError(f"DELETE {name}: HTTP {status}")


def open_container(url: str) -> BackupContainer:
    """Backup-URL scheme (ref: the reference's backup URLs):
    `file:///path`, `blobstore://host:port`, `memory:`."""
    if url.startswith("file://"):
        return DirectoryContainer(url[len("file://"):])
    if url.startswith("blobstore://"):
        rest = url[len("blobstore://"):].split("/", 1)[0]
        key = secret = ""
        if "@" in rest:
            creds, rest = rest.rsplit("@", 1)
            key, _, secret = creds.partition(":")
        host, port = rest.rsplit(":", 1)
        return BlobStoreContainer(host, int(port), key=key, secret=secret)
    if url == "memory:":
        return MemoryContainer()
    raise ValueError(f"unknown backup container url: {url}")


async def restore_from_container(db, container: BackupContainer,
                                 to_version: Optional[int] = None) -> int:
    """Restore the database from a container: newest snapshot at or
    below the target, then replay its logs (ref: fdbrestore driving
    FileBackupAgent restore from a container). Returns the version the
    database was restored to."""
    blob, records, target = await container.arun(
        container.latest_restorable, to_version)
    log_blob = _records_to_log_blob(records, 0)
    await agent_mod.restore_to_version(db, blob, log_blob, target)
    return target


def _records_to_log_blob(records, base_version: int) -> bytes:
    """Container chunks use THE mutation-log encoder (one format, one
    encoder — backup_agent.encode_log)."""
    return agent_mod.encode_log(records, base_version)
