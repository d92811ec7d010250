"""The port's conflict-set backend factory (the plugin selection point,
ref: fdbrpc/LoadPlugin.h), and the native C++ baseline behind it.

The port serves the pure-Python baseline, the native C++ baseline
(`native/conflictset.cpp` through ctypes), the CUDA interval resolver,
the CUDA point-op resolver and the key-range sharded CUDA resolver.
`CONFLICT_BACKENDS` is the port's own authority. The resolver role
reaches the device backends through
`failover.create_resilient_conflict_set`.

The native library is the port's own build of the repository's
`native/conflictset.cpp` (g++ -O3 -march=native), made at first use
under `foundationdb_tpu_torch/_kbuild/native-<hash>/`, keyed by the
source, the flags and the host (the build is host-specific); a failed
build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from typing import Optional, Sequence

import numpy as np

from .conflict_set import (ConflictSetBase, ConflictSetCheckpoint,
                           ResolverTransaction, checkpoint_from_step)

CONFLICT_BACKENDS = ("python", "native", "cuda", "cuda-point",
                     "sharded-cuda")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_SOURCE = os.path.join(os.path.dirname(_PKG), "native",
                             "conflictset.cpp")
BUILD_ROOT = os.path.join(_PKG, "_kbuild")
LIB_NAME = "libfdbtpu_native.so"
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _digest(source: str) -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(f"{platform.node()} {platform.machine()}".encode())
    with open(source, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def _build(out_dir: str, source: str, lib_name: str) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: {os.path.basename(source)} is "
                           "built at first use")
    os.makedirs(BUILD_ROOT, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="native-build-", dir=BUILD_ROOT)
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", os.path.join(tmp, lib_name),
                        source], stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT)
    if r.returncode:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(f"{os.path.basename(source)} build failed:\n"
                           + r.stdout.decode(errors="replace"))
    try:
        os.replace(tmp, out_dir)
    except OSError:          # another process won the race: use its build
        shutil.rmtree(tmp, ignore_errors=True)


def build_host_library(tag: str, source: str, lib_name: str) -> str:
    """The path of `source` built by g++ into a shared library under
    `_kbuild/<tag>-<hash>/`, keyed by the source, the flags and the
    host; built on first use (the caller holds its own lock)."""
    path = os.path.join(BUILD_ROOT, f"{tag}-{_digest(source)}", lib_name)
    if not os.path.exists(path):
        _build(os.path.dirname(path), source, lib_name)
    return path


def load_native_library() -> ctypes.CDLL:
    """The loaded native library (built on first use)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_host_library("native", NATIVE_SOURCE,
                                                 LIB_NAME))
            p = ctypes.POINTER
            lib.fdbtpu_conflictset_new.restype = ctypes.c_void_p
            lib.fdbtpu_conflictset_new.argtypes = [ctypes.c_int64]
            lib.fdbtpu_conflictset_destroy.argtypes = [ctypes.c_void_p]
            lib.fdbtpu_conflictset_oldest.restype = ctypes.c_int64
            lib.fdbtpu_conflictset_oldest.argtypes = [ctypes.c_void_p]
            lib.fdbtpu_conflictset_interval_count.restype = ctypes.c_int64
            lib.fdbtpu_conflictset_interval_count.argtypes = [
                ctypes.c_void_p]
            lib.fdbtpu_conflictset_resolve.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32,
                p(ctypes.c_int64),   # snapshots
                p(ctypes.c_int32),   # read_counts
                p(ctypes.c_int32),   # write_counts
                p(ctypes.c_uint8),   # key_blob
                p(ctypes.c_int64),   # read_ranges
                p(ctypes.c_int64),   # write_ranges
                p(ctypes.c_uint8),   # verdicts_out
            ]
            lib.fdbtpu_conflictset_resolve_attributed.argtypes = \
                lib.fdbtpu_conflictset_resolve.argtypes + [
                    p(ctypes.c_uint8)]   # read_hits_out
            lib.fdbtpu_conflictset_export_rows.restype = ctypes.c_int64
            lib.fdbtpu_conflictset_export_rows.argtypes = [ctypes.c_void_p]
            lib.fdbtpu_conflictset_export_key_bytes.restype = ctypes.c_int64
            lib.fdbtpu_conflictset_export_key_bytes.argtypes = [
                ctypes.c_void_p]
            lib.fdbtpu_conflictset_export.argtypes = [
                ctypes.c_void_p,
                p(ctypes.c_uint8),   # key_blob_out
                p(ctypes.c_int64),   # key_lens_out
                p(ctypes.c_int64),   # versions_out
            ]
            _lib = lib
    return _lib


def native_available() -> bool:
    try:
        load_native_library()
        return True
    except Exception:
        return False


def _marshal(txns: Sequence[ResolverTransaction]):
    """Flatten a batch into the C ABI arrays."""
    n = len(txns)
    snapshots = np.empty(n, dtype=np.int64)
    read_counts = np.empty(n, dtype=np.int32)
    write_counts = np.empty(n, dtype=np.int32)
    blob_parts: list[bytes] = []
    read_quads: list[int] = []
    write_quads: list[int] = []
    off = 0

    def push(key: bytes) -> tuple[int, int]:
        nonlocal off
        blob_parts.append(key)
        o = off
        off += len(key)
        return o, len(key)

    for t, tr in enumerate(txns):
        snapshots[t] = tr.read_snapshot
        read_counts[t] = len(tr.read_ranges)
        write_counts[t] = len(tr.write_ranges)
        for b, e in tr.read_ranges:
            read_quads.extend(push(b))
            read_quads.extend(push(e))
        for b, e in tr.write_ranges:
            write_quads.extend(push(b))
            write_quads.extend(push(e))

    blob = np.frombuffer(b"".join(blob_parts) or b"\x00", dtype=np.uint8)
    rr = np.asarray(read_quads or [0], dtype=np.int64)
    wr = np.asarray(write_quads or [0], dtype=np.int64)
    return snapshots, read_counts, write_counts, blob, rr, wr


def _ptr(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


class NativeConflictSet(ConflictSetBase):
    """Native C++ step-function backend (native/conflictset.cpp)."""

    BACKEND = "native"

    def __init__(self, init_version: int = 0):
        self._lib = load_native_library()
        self._handle = self._lib.fdbtpu_conflictset_new(init_version)
        self._last_commit = init_version   # ordering floor for checkpoints

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.fdbtpu_conflictset_destroy(self._handle)
                self._handle = None
        except Exception:
            pass

    @property
    def oldest_version(self) -> int:
        return self._lib.fdbtpu_conflictset_oldest(self._handle)

    @property
    def interval_count(self) -> int:
        return self._lib.fdbtpu_conflictset_interval_count(self._handle)

    def _checkpoint_state(self) -> ConflictSetCheckpoint:
        rows = self._lib.fdbtpu_conflictset_export_rows(self._handle)
        nbytes = self._lib.fdbtpu_conflictset_export_key_bytes(self._handle)
        blob = np.empty(max(int(nbytes), 1), np.uint8)
        lens = np.empty(max(int(rows), 1), np.int64)
        vers = np.empty(max(int(rows), 1), np.int64)
        self._lib.fdbtpu_conflictset_export(
            self._handle, _ptr(blob, ctypes.c_uint8),
            _ptr(lens, ctypes.c_int64), _ptr(vers, ctypes.c_int64))
        raw = blob.tobytes()
        keys: list = []
        off = 0
        for i in range(int(rows)):
            kl = int(lens[i])
            keys.append(raw[off:off + kl])
            off += kl
        vals = [int(v) for v in vers[:int(rows)]]
        return checkpoint_from_step(keys, vals, self.oldest_version,
                                    self._last_commit)

    def _reset_state(self, baseline_version: int) -> None:
        # the generic replay-based restore (ConflictSetBase) rebuilds
        # the step function through resolve(); only the reset is native
        self._lib.fdbtpu_conflictset_destroy(self._handle)
        self._handle = self._lib.fdbtpu_conflictset_new(baseline_version)
        self._last_commit = baseline_version

    def _call(self, entry, txns, commit_version, new_oldest_version, out,
              *extra):
        # empty batches still run: the GC window advances exactly like
        # the other backends' empty-batch paths
        if commit_version > self._last_commit:
            self._last_commit = commit_version
        snapshots, rc, wc, blob, rr, wr = _marshal(txns)
        entry(self._handle, commit_version, new_oldest_version, len(txns),
              _ptr(snapshots, ctypes.c_int64), _ptr(rc, ctypes.c_int32),
              _ptr(wc, ctypes.c_int32), _ptr(blob, ctypes.c_uint8),
              _ptr(rr, ctypes.c_int64), _ptr(wr, ctypes.c_int64),
              _ptr(out, ctypes.c_uint8),
              *[_ptr(x, ctypes.c_uint8) for x in extra])
        return rc

    def resolve(self, txns: Sequence[ResolverTransaction], commit_version: int,
                new_oldest_version: int) -> list[int]:
        out = np.empty(max(len(txns), 1), dtype=np.uint8)
        self._call(self._lib.fdbtpu_conflictset_resolve, txns,
                   commit_version, new_oldest_version, out)
        return out[:len(txns)].tolist()

    def resolve_with_attribution(self, txns: Sequence[ResolverTransaction],
                                 commit_version: int,
                                 new_oldest_version: int):
        """Verdicts + conflicting read-range indices via the attributed
        C entry point (the same union semantics as every backend)."""
        n = len(txns)
        if n == 0:
            return self.resolve(txns, commit_version,
                                new_oldest_version), []
        out = np.empty(n, dtype=np.uint8)
        n_reads = sum(len(t.read_ranges) for t in txns)
        hits = np.zeros(max(n_reads, 1), dtype=np.uint8)
        rc = self._call(self._lib.fdbtpu_conflictset_resolve_attributed,
                        txns, commit_version, new_oldest_version, out, hits)
        attr: list[tuple] = []
        off = 0
        for t in range(n):
            cnt = int(rc[t])
            attr.append(tuple(ri for ri in range(cnt) if hits[off + ri]))
            off += cnt
        return out.tolist(), attr


def create_conflict_set(backend: str = "python", init_version: int = 0,
                        device=None, **kwargs) -> ConflictSetBase:
    """Backend factory. `device` (and `key_bytes` / `capacity` in
    `kwargs`, and `n_shards` / `split_keys` / `devices` for
    `sharded-cuda`) configure the CUDA backends: `device=None` is the
    card, and a host without one raises; `device="cpu"` runs the plain
    PyTorch versions of the kernels. `devices` puts one shard on each
    entry of the list."""
    if backend == "python":
        from .conflict_set import PyConflictSet
        return PyConflictSet(init_version)
    if backend == "native":
        return NativeConflictSet(init_version)
    if backend == "cuda":
        from .cuda_resolver import CudaConflictSet
        return CudaConflictSet(init_version, device=device, **kwargs)
    if backend == "cuda-point":
        from .point_resolver import CudaPointConflictSet
        return CudaPointConflictSet(init_version, device=device, **kwargs)
    if backend == "sharded-cuda":
        from ..parallel import ShardedCudaConflictSet
        return ShardedCudaConflictSet(init_version, device=device, **kwargs)
    raise ValueError(f"unknown conflict-set backend: {backend}")
