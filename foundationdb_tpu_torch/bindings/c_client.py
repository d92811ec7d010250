"""ctypes harness for the native C client (bindings/c/fdb_tpu.cpp),
built by `build_library` with the flags of bindings/c/Makefile into the
port's `_kbuild/` (not bindings/c/build/, which `make` writes).

Reference: the reference's Python binding sits on fdb_c via ctypes
(bindings/python/fdb/impl.py loading libfdb_c); this module is the same
seam pointed at this framework's C library, used by the cross-binding
parity tests and available as a C-backed client for out-of-process
access through a cluster's TcpGateway.

Calls are blocking (the C library is a synchronous native client), so
use this from a plain thread — NOT from inside the flow scheduler, which
must stay free to serve the cluster the C client is talking to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import List, Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(os.path.dirname(_PKG), "bindings", "c")
SOURCES = ("fdb_tpu.cpp", "fdb_tpu.h")
#: the flags of bindings/c/Makefile
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
             "-shared"]
BUILD_ROOT = os.path.join(_PKG, "_kbuild")

_lib: Optional[ctypes.CDLL] = None
_build_lock = threading.Lock()


class CClientError(Exception):
    def __init__(self, code: int, name: str):
        super().__init__(f"{name} ({code})")
        self.code = code
        self.name = name


def library_path(protocol: Optional[str] = None) -> str:
    """Where the build of bindings/c/fdb_tpu.cpp for these flags (and
    the wire tag `protocol`, the Makefile's `versioned` target, when
    given) lives: `_kbuild/cclient-<digest>/`, keyed by the sources,
    the flags and the tag."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + [protocol or ""]).encode())
    for name in SOURCES:
        with open(os.path.join(_SRC_DIR, name), "rb") as fh:
            h.update(fh.read())
    name = ("libfdb_tpu_c.so" if protocol is None
            else f"libfdb_tpu_c_{protocol}.so")
    return os.path.join(BUILD_ROOT, "cclient-" + h.hexdigest()[:16], name)


def build_library(protocol: Optional[str] = None) -> str:
    """Build the C client with g++ (once per digest) and return its
    path; `protocol` builds the protocol-versioned copy the
    MultiVersion shim loads. A failed build raises with the
    compiler's output."""
    path = library_path(protocol)
    with _build_lock:
        if os.path.exists(path):
            return path
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            raise RuntimeError("g++ not found: the C client is built from "
                               "bindings/c/fdb_tpu.cpp at first use")
        os.makedirs(BUILD_ROOT, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix="cclient-build-", dir=BUILD_ROOT)
        define = ([f'-DFDBTPU_PROTOCOL="{protocol}"']
                  if protocol is not None else [])
        r = subprocess.run(
            [cxx, *CXX_FLAGS, *define, "-o",
             os.path.join(tmp, os.path.basename(path)),
             os.path.join(_SRC_DIR, "fdb_tpu.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if r.returncode:
            shutil.rmtree(tmp, ignore_errors=True)
            raise RuntimeError("C client build failed:\n"
                               + r.stdout.decode(errors="replace"))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        try:
            # one file per tag in the digest's directory; a process
            # that lost the race keeps the winner's copy
            os.link(os.path.join(tmp, os.path.basename(path)), path)
        except FileExistsError:
            pass
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return path


def load_library(build_if_missing: bool = True) -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    path = build_library() if build_if_missing else library_path()
    _lib = load_library_at(path)
    return _lib


def load_library_at(path: str) -> ctypes.CDLL:
    """dlopen + configure a C client library at an arbitrary path —
    the seam the MultiVersion shim uses to hold several
    protocol-versioned copies at once (ref: MultiVersionApi's
    externalClients, each its own dlopen of a versioned libfdb_c)."""
    lib = ctypes.CDLL(path)
    _configure(lib)
    return lib


def _configure(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    try:
        lib.fdb_tpu_get_protocol.restype = ctypes.c_char_p
        lib.fdb_tpu_get_protocol.argtypes = []
    except AttributeError:
        pass  # an older library without the protocol export
    lib.fdb_tpu_get_error.restype = ctypes.c_char_p
    lib.fdb_tpu_get_error.argtypes = [ctypes.c_int]
    lib.fdb_tpu_error_retryable.restype = ctypes.c_int
    lib.fdb_tpu_error_retryable.argtypes = [ctypes.c_int]
    lib.fdb_tpu_create_database.restype = ctypes.c_int
    lib.fdb_tpu_create_database.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)]
    lib.fdb_tpu_database_destroy.argtypes = [ctypes.c_void_p]
    lib.fdb_tpu_database_create_transaction.restype = ctypes.c_int
    lib.fdb_tpu_database_create_transaction.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
    lib.fdb_tpu_transaction_destroy.argtypes = [ctypes.c_void_p]
    lib.fdb_tpu_transaction_reset.argtypes = [ctypes.c_void_p]
    lib.fdb_tpu_transaction_set_option.restype = ctypes.c_int
    lib.fdb_tpu_transaction_set_option.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p]
    lib.fdb_tpu_transaction_get_read_version.restype = ctypes.c_int
    lib.fdb_tpu_transaction_get_read_version.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.fdb_tpu_transaction_get.restype = ctypes.c_int
    lib.fdb_tpu_transaction_get.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(u8p),
        ctypes.POINTER(ctypes.c_int)]
    lib.fdb_tpu_transaction_get_key.restype = ctypes.c_int
    lib.fdb_tpu_transaction_get_key.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(u8p),
        ctypes.POINTER(ctypes.c_int)]
    lib.fdb_tpu_transaction_get_range.restype = ctypes.c_int
    lib.fdb_tpu_transaction_get_range.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)]
    lib.fdb_tpu_transaction_set.restype = ctypes.c_int
    lib.fdb_tpu_transaction_set.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int]
    lib.fdb_tpu_transaction_clear.restype = ctypes.c_int
    lib.fdb_tpu_transaction_clear.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.fdb_tpu_transaction_clear_range.restype = ctypes.c_int
    lib.fdb_tpu_transaction_clear_range.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int]
    lib.fdb_tpu_transaction_atomic_op.restype = ctypes.c_int
    lib.fdb_tpu_transaction_atomic_op.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int]
    lib.fdb_tpu_transaction_add_conflict_range.restype = ctypes.c_int
    lib.fdb_tpu_transaction_add_conflict_range.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int]
    lib.fdb_tpu_transaction_commit.restype = ctypes.c_int
    lib.fdb_tpu_transaction_commit.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.fdb_tpu_transaction_get_versionstamp.restype = ctypes.c_int
    lib.fdb_tpu_transaction_get_versionstamp.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_int)]
    lib.fdb_tpu_transaction_on_error.restype = ctypes.c_int
    lib.fdb_tpu_transaction_on_error.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_int]
    lib.fdb_tpu_database_watch.restype = ctypes.c_int
    lib.fdb_tpu_database_watch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.fdb_tpu_free.argtypes = [ctypes.c_void_p]
    lib.fdb_tpu_free_keyvalues.argtypes = [ctypes.c_void_p, ctypes.c_int]


class _KeyValue(ctypes.Structure):
    _fields_ = [("key", ctypes.POINTER(ctypes.c_uint8)),
                ("key_length", ctypes.c_int),
                ("value", ctypes.POINTER(ctypes.c_uint8)),
                ("value_length", ctypes.c_int)]


def _check(lib, code: int) -> None:
    if code != 0:
        raise CClientError(code, lib.fdb_tpu_get_error(code).decode())


def _take_bytes(lib, ptr, length: int) -> bytes:
    try:
        return ctypes.string_at(ptr, length) if length else b""
    finally:
        lib.fdb_tpu_free(ptr)


class CDatabase:
    """Out-of-process database handle over a TcpGateway."""

    def __init__(self, host: str, port: int, lib: ctypes.CDLL = None,
                 connect_timeout: float = 5.0):
        self.lib = lib if lib is not None else load_library()
        handle = ctypes.c_void_p()
        # connection establishment retries transient failures for a
        # bounded window (ref: the client connecting to a cluster keeps
        # trying through recoveries/boot; a cluster mid-recovery may
        # drop or stall the first describe)
        import time
        deadline = time.monotonic() + connect_timeout
        while True:
            code = self.lib.fdb_tpu_create_database(
                host.encode(), port, ctypes.byref(handle))
            if code == 0:
                break
            if (not self.lib.fdb_tpu_error_retryable(code)
                    or time.monotonic() > deadline):
                _check(self.lib, code)
            time.sleep(0.1)
        self._h = handle

    def close(self) -> None:
        if self._h:
            self.lib.fdb_tpu_database_destroy(self._h)
            self._h = None

    def create_transaction(self) -> "CTransaction":
        handle = ctypes.c_void_p()
        _check(self.lib, self.lib.fdb_tpu_database_create_transaction(
            self._h, ctypes.byref(handle)))
        return CTransaction(self.lib, handle)

    def watch(self, key: bytes, timeout_ms: int = 60000) -> None:
        """Block until the key's value changes (or timed_out raises)."""
        _check(self.lib, self.lib.fdb_tpu_database_watch(
            self._h, key, len(key), timeout_ms))

    def run(self, body, max_retries: int = 100):
        """The standard retry loop over the C on_error protocol."""
        tr = self.create_transaction()
        try:
            for _ in range(max_retries):
                try:
                    result = body(tr)
                    tr.commit()
                    return result
                except CClientError as e:
                    tr.on_error(e.code)
        finally:
            tr.destroy()
        raise CClientError(1031, "transaction_timed_out")


class CTransaction:
    def __init__(self, lib, handle):
        self.lib = lib
        self._h = handle

    def destroy(self) -> None:
        if self._h:
            self.lib.fdb_tpu_transaction_destroy(self._h)
            self._h = None

    def reset(self) -> None:
        self.lib.fdb_tpu_transaction_reset(self._h)

    def set_option(self, option: str) -> None:
        _check(self.lib, self.lib.fdb_tpu_transaction_set_option(
            self._h, option.encode()))

    def get_read_version(self) -> int:
        out = ctypes.c_int64()
        _check(self.lib, self.lib.fdb_tpu_transaction_get_read_version(
            self._h, ctypes.byref(out)))
        return out.value

    def get(self, key: bytes, snapshot: bool = False) -> Optional[bytes]:
        present = ctypes.c_int()
        val = ctypes.POINTER(ctypes.c_uint8)()
        vlen = ctypes.c_int()
        _check(self.lib, self.lib.fdb_tpu_transaction_get(
            self._h, key, len(key), int(snapshot), ctypes.byref(present),
            ctypes.byref(val), ctypes.byref(vlen)))
        if not present.value:
            return None
        return _take_bytes(self.lib, val, vlen.value)

    def get_key(self, key: bytes, or_equal: bool, offset: int,
                snapshot: bool = False) -> bytes:
        out = ctypes.POINTER(ctypes.c_uint8)()
        olen = ctypes.c_int()
        _check(self.lib, self.lib.fdb_tpu_transaction_get_key(
            self._h, key, len(key), int(or_equal), offset, int(snapshot),
            ctypes.byref(out), ctypes.byref(olen)))
        return _take_bytes(self.lib, out, olen.value)

    def get_range(self, begin: bytes, end: bytes, limit: int = 0,
                  reverse: bool = False,
                  snapshot: bool = False) -> List[Tuple[bytes, bytes]]:
        arr = ctypes.c_void_p()
        count = ctypes.c_int()
        _check(self.lib, self.lib.fdb_tpu_transaction_get_range(
            self._h, begin, len(begin), end, len(end), limit, int(reverse),
            int(snapshot), ctypes.byref(arr), ctypes.byref(count)))
        try:
            kvs = ctypes.cast(arr, ctypes.POINTER(_KeyValue))
            out = []
            for i in range(count.value):
                kv = kvs[i]
                out.append((
                    ctypes.string_at(kv.key, kv.key_length)
                    if kv.key_length else b"",
                    ctypes.string_at(kv.value, kv.value_length)
                    if kv.value_length else b""))
            return out
        finally:
            self.lib.fdb_tpu_free_keyvalues(arr, count.value)

    def set(self, key: bytes, value: bytes) -> None:
        _check(self.lib, self.lib.fdb_tpu_transaction_set(
            self._h, key, len(key), value, len(value)))

    def clear(self, key: bytes) -> None:
        _check(self.lib, self.lib.fdb_tpu_transaction_clear(
            self._h, key, len(key)))

    def clear_range(self, begin: bytes, end: bytes) -> None:
        _check(self.lib, self.lib.fdb_tpu_transaction_clear_range(
            self._h, begin, len(begin), end, len(end)))

    def atomic_op(self, key: bytes, param: bytes, op_type: int) -> None:
        _check(self.lib, self.lib.fdb_tpu_transaction_atomic_op(
            self._h, key, len(key), param, len(param), op_type))

    def add_conflict_range(self, begin: bytes, end: bytes,
                           write: bool) -> None:
        _check(self.lib, self.lib.fdb_tpu_transaction_add_conflict_range(
            self._h, begin, len(begin), end, len(end), int(write)))

    def commit(self) -> int:
        out = ctypes.c_int64()
        _check(self.lib, self.lib.fdb_tpu_transaction_commit(
            self._h, ctypes.byref(out)))
        return out.value

    def get_versionstamp(self) -> bytes:
        out = ctypes.POINTER(ctypes.c_uint8)()
        olen = ctypes.c_int()
        _check(self.lib, self.lib.fdb_tpu_transaction_get_versionstamp(
            self._h, ctypes.byref(out), ctypes.byref(olen)))
        return _take_bytes(self.lib, out, olen.value)

    def on_error(self, code: int) -> None:
        err = self.lib.fdb_tpu_transaction_on_error(self._h, code)
        if err != 0:
            raise CClientError(err, self.lib.fdb_tpu_get_error(err).decode())
