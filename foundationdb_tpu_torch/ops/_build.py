"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` compiles with its own `nvcc` process (all started
together) into an object file, and one more `nvcc` links them into a
shared library with a plain C interface, loaded with `ctypes`. Nothing
here runs at import: the first wrapper that is handed a CUDA tensor
calls `lib()`, which builds (or finds the cached build of) the library.

Builds live under `foundationdb_tpu_torch/_kbuild/<hash>/`, keyed by a
hash of the sources and flags, so an edit rebuilds and an unchanged
tree reuses its build. A build that fails raises `KernelBuildError`
with the compiler's output; a launch that fails raises
`CudaKernelError` with the CUDA error string.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "_kbuild")
LIB_NAME = "libfdbtorch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# units whose host code is hot (the one-call submit's check and fill)
# are built for the host that runs them, as g++ builds that code for the
# CPU path (ops/marshal.py): its loops vectorize
UNIT_FLAGS = {"submit.cu": ["-Xcompiler", "-march=native"]}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class CudaKernelError(RuntimeError):
    """A kernel launch (or the work before it) reported a CUDA error."""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (CUDA toolkit required to "
                           "build the port's kernels)")


def sources() -> list:
    """Every file of the build: the `.cu` units, the headers, and the
    plain host C++ (`marshal.cpp`) that `submit.cu` includes."""
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh", ".cpp")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(UNIT_FLAGS.items())).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _build(out_dir: str) -> None:
    nvcc = _nvcc()
    os.makedirs(BUILD_ROOT, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT)
    units = [p for p in sources() if p.endswith(".cu")]
    t0 = time.perf_counter()
    procs = []
    for src in units:
        obj = os.path.join(tmp, os.path.basename(src)[:-3] + ".o")
        extra = UNIT_FLAGS.get(os.path.basename(src), [])
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, "-I", CSRC, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    log, failed = [], []
    for src, _obj, p in procs:
        out = p.communicate()[0].decode(errors="replace")
        log.append(f"== {os.path.basename(src)}\n{out}")
        if p.returncode:
            failed.append(os.path.basename(src))
    if failed:
        shutil.rmtree(tmp, ignore_errors=True)
        raise KernelBuildError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    link = subprocess.run(
        [nvcc, "-shared", "-o", os.path.join(tmp, LIB_NAME),
         *[o for _s, o, _p in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if link.returncode:
        shutil.rmtree(tmp, ignore_errors=True)
        raise KernelBuildError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace"))
    with open(os.path.join(tmp, "build.log"), "w") as f:
        f.write("\n".join(log))
    build_info.update(seconds=time.perf_counter() - t0, units=len(units))
    try:
        os.replace(tmp, out_dir)
    except OSError:          # another process won the race: use its build
        shutil.rmtree(tmp, ignore_errors=True)


_P = ctypes.c_void_p
_I = ctypes.c_int
_SZ = ctypes.c_size_t
_U = ctypes.c_uint
_L = ctypes.c_int64
_SIGNATURES = {
    "fdb_error_string": ([_I], ctypes.c_char_p),
    "fdb_searchsorted_i32": ([_P, _I, _P, _I, _I, _P, _P], _I),
    "fdb_range_max_scratch_bytes": ([_I, _I], _SZ),
    "fdb_range_max": ([_P, _I, _I, _P, _P, _I, _P, _P, _SZ, _P], _I),
    "fdb_resolve_scratch_bytes": ([_I, _I, _I, _I, _I], _SZ),
    "fdb_resolve": ([_P] * 14 + [_I] * 7 + [_P] * 5 + [_P, _SZ, _P, _P],
                    _I),
    "fdb_resolve_packed": ([_P, _P, _P] + [_I] * 6 + [_P] * 5
                           + [_P, _SZ, _P, _P], _I),
    "fdb_resolve_sharded_scratch_bytes": ([_I] * 6, _SZ),
    "fdb_resolve_sharded": ([_P] * 16 + [_I] * 8 + [_P] * 5
                            + [_P, _SZ, _P, _P], _I),
    "fdb_resolve_sharded_packed": ([_P] * 5 + [_I] * 7 + [_P] * 5
                                   + [_P, _SZ, _P, _P], _I),
    "fdb_resolve_shard_scratch_bytes": ([_I] * 5, _SZ),
    "fdb_resolve_shard_ext": ([_P] * 16 + [_I] * 6 + [_P, _P, _SZ, _P, _P],
                              _I),
    "fdb_resolve_shard_ext_packed": ([_P] * 5 + [_I] * 5
                                     + [_P, _P, _SZ, _P, _P], _I),
    "fdb_resolve_shard_finish": ([_P] * 17 + [_I] * 8 + [_P] * 5
                                 + [_P, _SZ, _P], _I),
    "fdb_resolve_shard_finish_packed": ([_P] * 6 + [_I] * 7 + [_P] * 5
                                        + [_P, _SZ, _P], _I),
    "fdb_lt_rows":([_P, _I, _P, _I, _I, _I, _P, _P], _I),
    "fdb_clip_to_shards": ([_P, _P, _P, _I, _P, _P, _I, _I, _I, _P, _P, _P,
                            _P], _I),
    "fdb_window_upkeep": ([_P, _P, _I, _I, _I, _I, _I, _P], _I),
    "fdb_searchsorted_rows": ([_P, _I, _I, _P, _I, _P, _I, _P, _P], _I),
    "fdb_point_resolve_scratch_bytes": ([_I, _I, _I, _I, _I], _SZ),
    "fdb_point_resolve": ([_P] * 13 + [_I] * 7 + [_P] * 5
                          + [_P, _SZ, _P, _P], _I),
    "fdb_point_resolve_packed": ([_P, _P, _P] + [_I] * 6 + [_P] * 5
                                 + [_P, _SZ, _P, _P], _I),
    "fdb_chain_gen": ([_P] * 8 + [_I] * 4 + [_U, _U, _U, _I, _P], _I),
    "fdb_chain_tally": ([_P, _P, _I, _P, _I, _P], _I),
    "fdb_marshal_check": ([_P, _P, _L, _P, _L, _L, _P, _L, _L, _L, _L, _L,
                           _P, _P], _I),
    "fdb_marshal_fill": ([_P], None),
    "fdb_submit_packed": ([_P], _I),
}


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            out_dir = os.path.join(BUILD_ROOT, _digest())
            path = os.path.join(out_dir, LIB_NAME)
            if not os.path.exists(path):
                _build(out_dir)
            else:
                build_info.setdefault("seconds", 0.0)
            build_info["path"] = path
            handle = ctypes.CDLL(path)
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = args
                fn.restype = res
            _lib = handle
    return _lib


def check(code: int, what: str) -> None:
    """Raise for a nonzero code returned by a C entry point."""
    if code:
        msg = lib().fdb_error_string(code).decode()
        raise CudaKernelError(f"{what}: {msg} (code {code})")
