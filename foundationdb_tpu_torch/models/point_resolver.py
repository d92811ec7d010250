"""Point-op CUDA conflict-set backend (host wrapper).

Same `ConflictSetBase` contract and version-offset machinery as the
interval backend (cuda_resolver.CudaConflictSet), specialized to
batches whose conflict ranges are all single keys ([k, k+'\\x00')). The
hot commit path of an FDB-style workload is exactly this shape (ref:
NativeAPI point reads/sets produce single-key conflict ranges,
fdbclient/ReadYourWrites.actor.cpp), and the point restriction admits a
far cheaper device step (ops/point_kernel.py, K5).

This is the port of the reference's `PointConflictSet`: the host logic
is carried over as it is, on the port's staging, single-transfer feed
and ping-pong state. Raises ValueError for non-point ranges; callers
that may see general ranges use CudaConflictSet, and
`create_conflict_set("cuda-point")` is an explicit opt-in.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..ops.keys import next_pow2
from .conflict_set import ConflictSetCheckpoint, ResolverTransaction
from .cuda_resolver import (_KERNEL_MIN_RANGES, _KERNEL_MIN_TXNS, _MIN_CAP,
                            CudaConflictSet)

_POINT_KEY_BYTES = 8  # max key length the point bucket stores


class CudaPointConflictSet(CudaConflictSet):
    """Latest-version-per-key map on the device; one K5 step per batch."""

    BACKEND = "cuda-point"

    def __init__(self, init_version: int = 0, key_bytes: int = _POINT_KEY_BYTES,
                 capacity: int = _MIN_CAP, device=None):
        self._init_version = init_version  # read by _initial_state hooks
        super().__init__(init_version=init_version, key_bytes=key_bytes,
                         capacity=capacity, device=device)
        self._count_hint = 0

    def _initial_state(self, init_version: int):
        """No whole-keyspace sentinel row: state starts empty (all +inf);
        the init_version baseline is enforced via init_off in the kernel."""
        hk = np.full((self._cap, self._n_words + 1), 0xFFFFFFFF, np.uint32)
        hv = np.full((self._cap,), -(1 << 30), np.int32)
        return hk, hv

    # -- checkpoint / restore ------------------------------------------
    def _checkpoint_state(self) -> ConflictSetCheckpoint:
        """Point state is a latest-version-per-key map, not a step
        function: the checkpoint carries one [k, k+'\\x00') assignment
        per live key over the init-version baseline — a representation
        the interval backends restore verbatim (cross-backend parity),
        and exactly what restores back into the point map."""
        from ..ops.fault_injection import convert_device_errors
        with convert_device_errors("drain", f"{self.BACKEND}.checkpoint"):
            hk, hv = self._hk.cpu().numpy(), self._hv.cpu().numpy()
        keys, vals = self._decode_step(hk, hv)
        baseline = int(self._init_version)
        dead_v = min(baseline, self._oldest - 1)
        # the device map may hold several rows per key (an update adds a
        # new row; queries read the highest version in the key run, GC
        # retires the rest): the checkpoint is the per-key MAX
        latest: dict = {}
        for k, v in zip(keys, vals):
            if v > latest.get(k, v - 1):
                latest[k] = v
        assignments = []
        for k in sorted(latest):
            v = latest[k]
            if v < self._oldest:
                v = dead_v
            if v != baseline:
                assignments.append((k, k + b"\x00", v))
        return ConflictSetCheckpoint(self._oldest, self._last_commit,
                                     baseline, tuple(assignments))

    def _restore_state(self, ckpt: ConflictSetCheckpoint) -> None:
        """Direct point-map rebuild; every assignment must be a point
        within the key bucket (restoring an interval checkpoint into
        the point backend is an explicit opt-in that only works when
        the captured history is point-shaped)."""
        pts = sorted(ckpt.assignments)
        for b, e, _v in pts:
            self._check_point(b, e)
        self._restore_bookkeeping(ckpt)
        self._cap = max(_MIN_CAP, self._cap, next_pow2(len(pts) + 2))
        hk, hv = self._encode_step([b for b, _e, _v in pts],
                                   [v for _b, _e, v in pts], self._cap)
        self._hk, self._hv = self._to_device(hk, hv)
        self._count_hint = len(pts)

    def _marshal_ranges(self, txns: Sequence[ResolverTransaction], too_old,
                        attribute: bool = False):
        """Point marshalling: end keys are never encoded (they are
        begin+'\\x00', one byte past the bucket width); each range is
        validated to be a point instead. Same ((lists), read_map)
        contract as the interval backend — keys stay raw bytes here and
        are encoded once, straight into the packed staging buffer, by
        `_dispatch`; txn ids ride one np.repeat per side."""
        n = len(txns)
        r_counts = np.zeros(n, np.int32)
        w_counts = np.zeros(n, np.int32)
        read_k: list = []
        write_k: list = []
        r_src: list = []
        for t, tr in enumerate(txns):
            if too_old[t]:
                continue
            c0 = len(read_k)
            for ri, (b, e) in enumerate(tr.read_ranges):
                if b >= e:
                    continue
                self._check_point(b, e)
                read_k.append(b)
                if attribute:
                    r_src.append(ri)
            r_counts[t] = len(read_k) - c0
            c0 = len(write_k)
            for b, e in tr.write_ranges:
                if b >= e:
                    continue
                self._check_point(b, e)
                write_k.append(b)
            w_counts[t] = len(write_k) - c0
        ids = np.arange(n, dtype=np.int32)
        rt = np.repeat(ids, r_counts)
        wt = np.repeat(ids, w_counts)
        read_map = ((rt, np.asarray(r_src, np.int32)) if attribute else ())
        return (read_k, None, rt, write_k, None, wt), read_map

    def _validate_range(self, b: bytes, e: bytes) -> None:
        self._check_point(b, e)

    def _check_point(self, b: bytes, e: bytes) -> None:
        if e != b + b"\x00":
            raise ValueError(
                "PointConflictSet handles single-key ranges only "
                f"(got [{b!r}, {e!r})); use the interval backend")
        if len(b) > self._key_bytes:
            raise ValueError(
                f"point key length {len(b)} exceeds bucket width "
                f"{self._key_bytes}")

    def resolve_arrays(self, snapshots, has_reads, rb, re, rt, wb, we, wt,
                       commit_version: int, new_oldest_version: int):
        """Pre-encoded fast path for point batches (same contract as the
        interval backend's resolve_arrays). The end-key arrays are
        accepted for signature compatibility but ignored — every range
        MUST be [k, k+'\\x00'); the caller guarantees it, which is what
        makes the cheaper point kernel sound."""
        for a in (rb, wb):
            if a.shape[1] != self._n_words + 1:
                raise ValueError(
                    f"encoded key width {a.shape[1] - 1} words does not "
                    f"match the point bucket ({self._n_words} words)")
        return super().resolve_arrays(snapshots, has_reads, rb, re, rt,
                                      wb, we, wt, commit_version,
                                      new_oldest_version)

    # -- packed single-buffer feed path --------------------------------
    def _feed_len(self, npad: int, nrp: int, nwp: int) -> int:
        from ..ops.point_kernel import point_feed_len
        return point_feed_len(npad, nrp, nwp, self._n_words)

    def _feed_views(self, buf, npad: int, nrp: int, nwp: int):
        from ..ops.point_kernel import point_batch_views
        return point_batch_views(buf, npad, nrp, nwp, self._n_words)

    def _dispatch(self, n, snapshots, too_old, rb, re, rt, wb, we, wt,
                  offsets, attribute: bool = False):
        commit_off, oldest_off, fixup = offsets
        from ..ops.conflict_kernel import SNAP_CLAMP
        from ..ops.point_kernel import make_point_resolve_packed_fn

        nr, nw = len(rt), len(wt)
        npad = next_pow2(max(n, _KERNEL_MIN_TXNS))
        # exact bucket: one extra slot would double both dimensions
        nrp = next_pow2(max(nr, _KERNEL_MIN_RANGES))
        nwp = next_pow2(max(nw, _KERNEL_MIN_RANGES))
        self._audit_capacity(nw)  # one state row per point write
        self._note_occupancy(n, npad, nr, nrp, nw, nwp)

        snap_off = np.clip(snapshots - self._base, 0,
                           SNAP_CLAMP).astype(np.int32)
        init_off = int(np.clip(self._init_version - self._base, 0,
                               SNAP_CLAMP + 1))
        fn = make_point_resolve_packed_fn(self._cap, npad, nrp, nwp,
                                          self._n_words,
                                          attribute=attribute)
        # ONE host->device transfer per batch: the eleven logical inputs,
        # version scalars included, ride one contiguous buffer built IN
        # PLACE over reused staging and read in place by K5
        ent = self._staging_views(npad, nrp, nwp)
        v = ent.views
        v.hdr[0] = commit_off
        v.hdr[1] = oldest_off
        v.hdr[2] = init_off
        v.snap[:n] = snap_off
        v.snap[n:] = 0
        v.too_old[:n] = too_old
        v.too_old[n:] = 0
        self._fill_keys(v.rk, rb, nr)
        v.rtxn[:nr] = rt
        v.rtxn[nr:] = npad
        v.rvalid[:nr] = 1
        v.rvalid[nr:] = 0
        self._fill_keys(v.wk, wb, nw)
        v.wtxn[:nw] = wt
        v.wtxn[nw:] = npad
        v.wvalid[:nw] = 1
        v.wvalid[nw:] = 0
        span = self._span_start()
        dev_buf = self._feed(ent)
        self._span_end(span)
        span = self._span_start()
        count, conflict, read_hit = self._run_step(fn, dev_buf)
        self._apply_fixup(fixup)
        self._span_end(span)
        self._note_count(count, nw)
        return conflict, read_hit


def load_reference_point_state(sk, sv, *, base: int, oldest: int,
                               last_commit: int, init_version: int,
                               key_bytes: int,
                               device=None) -> CudaPointConflictSet:
    """A CudaPointConflictSet that continues another point backend's
    stream with identical verdicts and state: `sk`/`sv` are that
    backend's state arrays (uint32 [cap, W+1] and int32 [cap] as numpy,
    e.g. `np.asarray(point._hk)`) and the rest its version bookkeeping
    (`_base`, `_oldest`, `_last_commit`, `_init_version`)."""
    sk = np.array(sk, np.uint32)
    sv = np.array(sv, np.int32)
    cap = sk.shape[0]
    if cap & (cap - 1) or cap < _MIN_CAP or sk.shape != (
            cap, key_bytes // 4 + 1) or sv.shape != (cap,):
        raise ValueError("state arrays do not match the key width or a "
                         "power-of-two capacity")
    cs = CudaPointConflictSet(init_version=init_version, key_bytes=key_bytes,
                              capacity=cap, device=device)
    cs._base = int(base)
    cs._oldest = int(oldest)
    cs._last_commit = int(last_commit)
    cs._hk, cs._hv = cs._to_device(sk, sv)
    cs._count_hint = int(np.count_nonzero(sk[:, -1] != 0xFFFFFFFF))
    return cs
