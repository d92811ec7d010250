"""The packed path's per-batch host marshalling in native code.

`csrc/marshal.cpp` holds two plain C++ entries: `fdb_marshal_check`,
the order check of a pre-encoded batch's per-range transaction ids with
its too-old flags and window floor, and `fdb_marshal_fill`, which fills
one staging entry in the packed feed layout (`conflict_kernel.py`'s
`interval_batch_views`) in one pass. The resolvers call them on every
packed batch. On the CPU path the library is that file built by g++
under `_kbuild/marshal-<hash>/` at first use, keyed by the source, the
flags and the host; on the card it is the kernel library, whose
`csrc/submit.cu` compiles the same source into its one-call submit
(`fdb_submit_packed`, arguments in `SubmitArgs`). So the CPU tests run
the code the card runs.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ._build import CSRC

MARSHAL_SOURCE = os.path.join(CSRC, "marshal.cpp")
LIB_NAME = "libfdbtorch_marshal.so"

# the element types an id array may come in, as csrc/marshal.cpp's
# IdKind; any other is converted to int64 first
ID_KINDS = {np.dtype(np.int32): 0, np.dtype(np.int64): 1,
            np.dtype(np.uint32): 2, np.dtype(np.uint64): 3}

_P = ctypes.c_void_p
_L = ctypes.c_int64

_lock = threading.Lock()
_host_lib = None


class FillArgs(ctypes.Structure):
    """csrc/marshal.cpp's FillArgs: one staging entry's fill."""

    _fields_ = [("buf", _P), ("n", _L), ("nr", _L), ("nw", _L),
                ("npad", _L), ("nrp", _L), ("nwp", _L), ("width", _L),
                ("commit_off", _L), ("oldest_off", _L), ("snapshots", _P),
                ("base", _L), ("too_old", _P), ("rb", _P), ("re", _P),
                ("wb", _P), ("we", _P), ("rt", _P), ("wt", _P),
                ("rt_kind", _L), ("wt_kind", _L)]


class SubmitArgs(ctypes.Structure):
    """csrc/submit.cu's SubmitArgs: one batch's one-call submit (the
    fill, the feed copy, the step and the readback copies), with the
    launch counts and the parts' boundary times coming back in it."""

    _fields_ = [("fill", FillArgs), ("feed", _P), ("feed_event", _P),
                ("sharded", _L), ("hk", _P), ("hv", _P), ("hk_out", _P),
                ("hv_out", _P), ("lows", _P), ("highs", _P),
                ("shards", _L), ("cap", _L), ("attribute", _L),
                ("count", _P), ("conflict", _P), ("read_hit", _P),
                ("scratch", _P), ("scratch_bytes", _L), ("stream", _P),
                ("timed_start", _P), ("timed_end", _P),
                ("host_count", _P), ("host_conflict", _P),
                ("host_read_hit", _P), ("result_event", _P),
                ("launches", ctypes.c_longlong * 3), ("t", _L * 5)]


def host_lib() -> ctypes.CDLL:
    """The g++ build of csrc/marshal.cpp (built on first use)."""
    global _host_lib
    if _host_lib is not None:
        return _host_lib
    with _lock:
        if _host_lib is None:
            from ..models.native_backend import build_host_library
            lib = ctypes.CDLL(build_host_library("marshal", MARSHAL_SOURCE,
                                                 LIB_NAME))
            lib.fdb_marshal_check.argtypes = [_P, _P, _L, _P, _L, _L, _P, _L,
                                              _L, _L, _L, _L, _P, _P]
            lib.fdb_marshal_check.restype = ctypes.c_int
            lib.fdb_marshal_fill.argtypes = [_P]
            lib.fdb_marshal_fill.restype = None
            _host_lib = lib
    return _host_lib


_from_buffer = ctypes.c_char.from_buffer
_addressof = ctypes.addressof


def addr(a: np.ndarray) -> int:
    """The address of a C-contiguous array's first byte: a third of
    `a.ctypes.data`'s cost where the array is writable and not empty,
    which the batch path's arrays are."""
    try:
        return _addressof(_from_buffer(a))
    except (TypeError, ValueError, BufferError):
        return a.ctypes.data


def lib_for(dev) -> ctypes.CDLL:
    """The library whose check and fill a resolver on `dev` calls: the
    card's kernel library, or the host build on the CPU."""
    if dev.type == "cuda":
        from ._build import lib
        return lib()
    return host_lib()


def ids(a):
    """(array, kind) of a per-range txn id array as the check and the
    fill read it: C-contiguous, of a kind in ID_KINDS (any other dtype
    is cast to int64, as NumPy's `asarray(.., int64)` casts it)."""
    a = np.asarray(a)
    kind = ID_KINDS.get(a.dtype)
    if kind is None:
        a, kind = np.asarray(a, np.int64), ID_KINDS[np.dtype(np.int64)]
    return np.ascontiguousarray(a), kind


def check(lib, snapshots, has_reads, rt, rt_kind, wt, wt_kind,
          oldest: int, commit_version: int, window_oldest: int):
    """One pass of `fdb_marshal_check`: (0, too_old, floor), or (1, ...)
    when `rt` decreases and (2, ...) when `wt` does. `snapshots` is
    C-contiguous int64 and `has_reads` C-contiguous of one byte an
    element; `rt`/`wt` as `ids` gives them."""
    n = snapshots.shape[0]
    too_old = np.empty(n, bool)
    floor = ctypes.c_int64()
    code = lib.fdb_marshal_check(
        addr(snapshots), addr(has_reads), n, addr(rt), rt_kind, rt.shape[0],
        addr(wt), wt_kind, wt.shape[0], oldest, commit_version,
        window_oldest, addr(too_old), _addressof(floor))
    return code, too_old, floor.value
