"""CUDA conflict-set backend: the host wrapper around the resolve kernel.

Same `ConflictSetBase` contract as the CPU baselines, so callers can
swap backends and demand bit-identical verdicts. This is the port of
the reference's `TpuConflictSet`; the host logic is carried over as it
is, and only the runtime glue differs:

  - the history lives in a ping-pong pair of device buffers: each
    resolve step reads one (HK, HV) pair and writes the other, so K
    in-flight batches share two state allocations;
  - verdicts, attribution flags and row counts come back through
    pinned host tensors filled by `non_blocking` copies, each with a
    CUDA event that says when it has landed;
  - the packed feed is staged in a rotating pool of pinned host
    buffers (pipeline depth + 2 entries); an entry is reused only after
    the event recorded behind its last host->device copy has fired.

Host responsibilities (everything the kernel cannot do with static
shapes): marshal batches into flat padded arrays, bucketing counts to
powers of two; track the absolute version base, since the device
stores int32 offsets and is re-based long before overflow; the tooOld
test on absolute versions; grow the history capacity by doubling.

With `device="cpu"` the same class runs the kernels' plain PyTorch
versions; `device=None` means the CUDA card and raises without one.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from .. import device as _device
from ..flow.stats import CounterCollection
from ..ops.keys import decode_keys, encode_keys, encode_keys_into, next_pow2
from .conflict_set import (COMMITTED, CONFLICT, TOO_OLD, ConflictSetBase,
                           ConflictSetCheckpoint, ResolveTicket,
                           ResolverTransaction, checkpoint_from_step,
                           step_from_checkpoint)

# Minimum shape buckets: small batches all land in one shape bucket.
_KERNEL_MIN_TXNS = 16
_KERNEL_MIN_RANGES = 32
_MIN_CAP = 1 << 10


class _HostCopy:
    """A device tensor on its way to host memory: a pinned host tensor
    filled by a `non_blocking` copy, and the event recorded behind it.
    `np.asarray(x)` waits for THIS copy only. A CPU tensor is already
    host-resident."""

    __slots__ = ("host", "event")

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.host = t
            self.event = None

    def is_ready(self) -> bool:
        return self.event is None or self.event.query()

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)


class _Staging:
    """One pool entry of packed-feed staging: the host buffer (pinned on
    the card's path), its named views, and the event behind the last
    host->device copy that read it."""

    __slots__ = ("buf", "views", "host", "event")

    def __init__(self, buf, views, host):
        self.buf = buf
        self.views = views
        self.host = host
        self.event = None

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class CudaConflictSet(ConflictSetBase):
    BACKEND = "cuda"

    def __init__(self, init_version: int = 0, key_bytes: int = 32,
                 capacity: int = _MIN_CAP, device=None):
        if key_bytes % 4:
            raise ValueError("key_bytes must be a multiple of 4")
        self._device = _device.resolve(device)
        self._key_bytes = key_bytes
        self._n_words = key_bytes // 4
        self._cap = max(_MIN_CAP, int(capacity))
        if init_version >= (1 << 30):
            raise ValueError("init_version too large for the version window")
        self._init_version = init_version
        self._base = 0
        self._oldest = 0
        self._last_commit = init_version
        self._count_hint = 1
        self._count_dev = None
        # (async count copy, rows_added_since) pairs, oldest first: the
        # capacity audit reads the OLDEST, which rarely stalls because
        # newer batches are queued behind it
        self._count_async: list = []
        self._rows_since_async = 0
        self.profile = CounterCollection(f"{self.BACKEND}_kernel")
        self._staging: dict = {}
        self._staging_idx: dict = {}
        self._enc_scratch = np.empty((0, 0), np.uint8)
        self._hk_alt = self._hv_alt = None
        self._spans = None      # (start, end) CUDA events: time_device()
        self._hk, self._hv = self._to_device(*self._initial_state(init_version))

    def _initial_state(self, init_version: int):
        """Host arrays for the fresh history: one sentinel row baselining
        the whole keyspace at init_version."""
        hk = np.full((self._cap, self._n_words + 1), 0xFFFFFFFF, np.uint32)
        hk[0] = 0
        hv = np.full((self._cap,), -(1 << 30), np.int32)
        hv[0] = init_version
        return hk, hv

    # -- device state helpers -------------------------------------------
    def _to_device(self, hk: np.ndarray, hv: np.ndarray):
        """Install host arrays as the device history (the ping-pong
        partner is reallocated on the next step)."""
        self._hk_alt = self._hv_alt = None
        return (torch.from_numpy(np.ascontiguousarray(hk, np.uint32))
                .to(self._device),
                torch.from_numpy(np.ascontiguousarray(hv, np.int32))
                .to(self._device))

    def _alt(self):
        """The buffers the next step writes into (None on the CPU path,
        whose plain step allocates its outputs)."""
        if self._device.type != "cuda":
            return None
        if self._hk_alt is None or self._hk_alt.shape != self._hk.shape:
            self._hk_alt = torch.empty_like(self._hk)
            self._hv_alt = torch.empty_like(self._hv)
        return self._hk_alt, self._hv_alt

    def _swap_in(self, hk, hv) -> None:
        if self._device.type == "cuda":
            self._hk_alt, self._hv_alt = self._hk, self._hv
        self._hk, self._hv = hk, hv

    @property
    def oldest_version(self) -> int:
        return self._oldest

    @property
    def interval_count(self) -> int:
        """Upper bound on live state rows, refreshed from async count
        copies that HAVE ARRIVED — it never drains the in-flight
        pipeline. Exact counts are available via `_sync_count`."""
        while self._count_async and self._count_async[0][0].is_ready():
            self._consume_oldest_count()
        return self._count_hint

    def _sync_count(self) -> None:
        """EXACT current row count: blocks until the newest submitted
        batch lands (a full pipeline drain — last resort only)."""
        if self._count_dev is not None:
            self._count_hint = int(np.max(np.asarray(self._count_dev)))
            self._count_dev = None
        self._count_async.clear()
        self._rows_since_async = 0

    def _grow(self, needed: int) -> None:
        """Double the capacity (or more, to fit `needed`); a sharded
        history ([S, cap] rows) keeps one capacity for every shard."""
        new_cap = max(self._cap * 2, next_pow2(needed + 2))
        lead = tuple(self._hv.shape[:-1])
        hk = np.full(lead + (new_cap, self._n_words + 1), 0xFFFFFFFF,
                     np.uint32)
        hv = np.full(lead + (new_cap,), -(1 << 30), np.int32)
        hk[..., :self._cap, :] = _host(self._hk)
        hv[..., :self._cap] = _host(self._hv)
        self._cap = new_cap
        self._hk, self._hv = self._to_device(hk, hv)

    def _prepare_versions(self, commit_version: int, new_oldest_version: int,
                          window_floor: int):
        """Pick int32 offsets for this batch, re-basing if needed.

        Returns (commit_off, oldest_off, fixup). `window_floor` is the
        lowest version whose exact ordering still matters this batch:
        min over (the incoming oldestVersion, every non-tooOld read
        snapshot). Stored versions <= the base can never exceed any
        checked snapshot again, so clamping them during a shift is
        verdict-invariant.

        If the batch itself spans >= 2^30 versions (a recovery-style
        jump with pre-jump snapshots still live), verdicts are computed
        as usual with the merge done at a placeholder offset; the
        returned fixup (applied right after the kernel) rewrites
        placeholder entries to the true commit version relative to a
        fresh base."""
        from ..ops.conflict_kernel import REBASE_THRESHOLD, rebase, reset

        target = max(self._oldest, new_oldest_version)
        if commit_version - self._base >= REBASE_THRESHOLD:
            new_base = max(self._base, min(target, window_floor))
            if commit_version - new_base < REBASE_THRESHOLD:
                delta = new_base - self._base
                if delta > (1 << 31) - 1:
                    # shift exceeds int32 arithmetic; every stored version
                    # is below the new base, so clamp them all dead
                    reset(self._hv, out=self._hv)
                else:
                    rebase(self._hv, delta, out=self._hv)
                self._base = new_base
            elif commit_version - target < REBASE_THRESHOLD:
                p = REBASE_THRESHOLD
                oldest_off = min(max(target - self._base, 0), p)
                return p, oldest_off, (commit_version, max(self._base, target))
            else:
                raise OverflowError(
                    "version window exceeds 2^30: advance new_oldest_version "
                    "(ref: MAX_WRITE_TRANSACTION_LIFE_VERSIONS keeps the "
                    "live window ~5e6 versions wide)")
        return (commit_version - self._base,
                max(self._oldest, new_oldest_version) - self._base, None)

    def _apply_fixup(self, fixup) -> None:
        if fixup is None:
            return
        from ..ops.conflict_kernel import (REBASE_THRESHOLD, jump_fixup,
                                           jump_fixup_large)
        commit_version, new_base = fixup
        delta = new_base - self._base
        if delta > (1 << 31) - 1:
            jump_fixup_large(self._hv, REBASE_THRESHOLD,
                             commit_version - new_base, out=self._hv)
        else:
            jump_fixup(self._hv, REBASE_THRESHOLD,
                       commit_version - new_base, delta, out=self._hv)
        self._base = new_base

    # -- checkpoint / restore -------------------------------------------
    def _decode_step(self, hk: np.ndarray, hv: np.ndarray):
        """Device state back into a (keys, vals) step function with
        ABSOLUTE versions; +inf pad rows drop out."""
        real = np.flatnonzero(hk[:, -1] != 0xFFFFFFFF)
        keys = decode_keys(hk[real])
        vals = [int(v) + self._base for v in hv[real]]
        return keys, vals

    def _checkpoint_state(self) -> ConflictSetCheckpoint:
        from ..ops.fault_injection import convert_device_errors
        with convert_device_errors("drain", f"{self.BACKEND}.checkpoint"):
            hk, hv = _host(self._hk), _host(self._hv)
        keys, vals = self._decode_step(hk, hv)
        return checkpoint_from_step(keys, vals, self._oldest,
                                    self._last_commit)

    def _restore_bookkeeping(self, ckpt: ConflictSetCheckpoint) -> None:
        self._oldest = int(ckpt.oldest_version)
        self._last_commit = int(ckpt.last_commit)
        self._init_version = int(ckpt.baseline_version)
        # re-base so every live offset fits the int32 device window
        self._base = max(0, int(ckpt.oldest_version))
        self._count_dev = None
        self._count_async.clear()
        self._rows_since_async = 0

    def _restore_state(self, ckpt: ConflictSetCheckpoint) -> None:
        keys, vals = step_from_checkpoint(ckpt)
        self._restore_bookkeeping(ckpt)
        self._install_step(keys, vals)

    def _encode_step(self, keys, vals, cap: int):
        """Host (hk, hv) arrays for a step function: encoded keys
        +inf-padded to cap, versions as clamped offsets from the base."""
        from ..ops.conflict_kernel import REBASE_THRESHOLD
        from ..ops.rmq import VDEAD
        hk = np.full((cap, self._n_words + 1), 0xFFFFFFFF, np.uint32)
        hv = np.full((cap,), VDEAD, np.int32)
        if keys:
            hk[:len(keys)] = encode_keys(list(keys), self._key_bytes)
        for i, v in enumerate(vals):
            off = int(v) - self._base
            if off >= REBASE_THRESHOLD:
                raise OverflowError(
                    "checkpoint version window exceeds 2^30 (see "
                    "MAX_WRITE_TRANSACTION_LIFE_VERSIONS)")
            hv[i] = max(off, VDEAD)
        return hk, hv

    def _install_step(self, keys, vals) -> None:
        self._cap = max(_MIN_CAP, self._cap, next_pow2(len(keys) + 2))
        hk, hv = self._encode_step(keys, vals, self._cap)
        self._hk, self._hv = self._to_device(hk, hv)
        self._count_hint = max(1, len(keys))

    # -- resolve --------------------------------------------------------
    def resolve(self, txns: Sequence[ResolverTransaction], commit_version: int,
                new_oldest_version: int) -> list[int]:
        return self.drain(self.submit(txns, commit_version,
                                      new_oldest_version))

    def resolve_with_attribution(self, txns: Sequence[ResolverTransaction],
                                 commit_version: int,
                                 new_oldest_version: int):
        """Verdicts + per-txn conflicting read-range indices (see
        ConflictSetBase.resolve_with_attribution)."""
        return self.drain_with_attribution(
            self.submit(txns, commit_version, new_oldest_version,
                        attribute=True))

    def submit(self, txns: Sequence[ResolverTransaction],
               commit_version: int, new_oldest_version: int,
               attribute: bool = False) -> ResolveTicket:
        """Asynchronous half of the split resolve: marshal + H2D +
        kernel launch without blocking on any result. Up to
        RESOLVE_PIPELINE_DEPTH tickets stay in flight; `drain` awaits
        only one batch's verdict copy. The device serializes the chained
        history, so pipelined verdicts equal the serial path's."""
        t0 = time.perf_counter()
        conflict, too_old, n, read_hit, read_map = self._resolve_flags(
            txns, commit_version, new_oldest_version, attribute=attribute)
        if n == 0:
            ticket = ResolveTicket(commit_version, 0,
                                   result=([], [] if attribute else None))
        else:
            def materialize():
                from ..ops.fault_injection import (convert_device_errors,
                                                   g_device_faults)
                g_device_faults.check("materialize", self.BACKEND)
                with convert_device_errors("materialize", self.BACKEND):
                    return _materialize_inner()

            def _materialize_inner():
                verdicts = self.finalize_verdicts(conflict, too_old)
                if not attribute:
                    return verdicts, None
                attr: list[list[int]] = [[] for _ in range(n)]
                if read_map:
                    slot_txn, slot_src = read_map
                    hits = np.asarray(read_hit)[:slot_txn.shape[0]]
                    for slot in np.nonzero(hits)[0]:
                        attr[int(slot_txn[slot])].append(int(slot_src[slot]))
                return verdicts, [tuple(a) for a in attr]

            ticket = ResolveTicket(commit_version, n,
                                   materialize=materialize)
        self.pipeline.note_submit(ticket, t0)
        return ticket

    def submit_arrays(self, snapshots, has_reads, rb, re, rt, wb, we, wt,
                      commit_version: int,
                      new_oldest_version: int) -> ResolveTicket:
        """Pipelined pre-encoded fast path: `resolve_arrays` wrapped in
        a ticket whose `drain_arrays` yields (conflict[:n] ndarray,
        too_old ndarray)."""
        t0 = time.perf_counter()
        conflict, too_old = self.resolve_arrays(
            snapshots, has_reads, rb, re, rt, wb, we, wt,
            commit_version, new_oldest_version)
        n = snapshots.shape[0]

        def materialize():
            from ..ops.fault_injection import (convert_device_errors,
                                               g_device_faults)
            g_device_faults.check("materialize", self.BACKEND)
            with convert_device_errors("materialize", self.BACKEND):
                return np.asarray(conflict)[:n], too_old

        ticket = ResolveTicket(commit_version, n, materialize=materialize)
        self.pipeline.note_submit(ticket, t0)
        return ticket

    def drain_arrays(self, ticket: ResolveTicket):
        """(conflict flags ndarray, too_old ndarray) for a ticket from
        `submit_arrays` (idempotent, any order)."""
        return self.pipeline.drain(ticket)

    # -- device-fault seams (ops/fault_injection.py) --------------------
    def drain(self, ticket: ResolveTicket) -> list:
        if not ticket.done:
            from ..ops.fault_injection import g_device_faults
            g_device_faults.check("drain", self.BACKEND)
        return super().drain(ticket)

    def drain_with_attribution(self, ticket: ResolveTicket):
        if not ticket.done:
            from ..ops.fault_injection import g_device_faults
            g_device_faults.check("drain", self.BACKEND)
        return super().drain_with_attribution(ticket)

    def _resolve_flags(self, txns, commit_version, new_oldest_version,
                       attribute: bool = False):
        """Launch one batch; returns (pending conflict flags, too_old,
        n, pending per-read-slot cause flags — None unless `attribute` —
        read slot -> (txn, range index) map)."""
        if commit_version < self._last_commit:
            raise ValueError("commit versions must be non-decreasing "
                             "(ref: Resolver version ordering, "
                             "Resolver.actor.cpp:104-115)")
        n = len(txns)
        if n == 0:
            self._last_commit = commit_version
            self._oldest = max(self._oldest, new_oldest_version)
            return None, None, 0, None, []
        live_snaps = [tr.read_snapshot for tr in txns
                      if len(tr.read_ranges) and tr.read_snapshot >= self._oldest]
        offsets = self._prepare_versions(
            commit_version, new_oldest_version,
            min([max(self._oldest, new_oldest_version)] + live_snaps))

        too_old = np.zeros(n, bool)
        snapshots = np.zeros(n, np.int64)
        for t, tr in enumerate(txns):
            snapshots[t] = tr.read_snapshot
            if tr.read_snapshot < self._oldest and len(tr.read_ranges):
                too_old[t] = True

        arrays, read_map = self._marshal_ranges(txns, too_old,
                                                attribute=attribute)
        conflict, read_hit = self._dispatch(
            n, snapshots, too_old, *arrays, offsets, attribute=attribute)
        self._last_commit = commit_version  # only after a successful batch
        self._oldest = max(self._oldest, new_oldest_version)
        return conflict, too_old, n, read_hit, read_map

    def validate_txns(self, txns, oldest_version=None):
        """Raises exactly when `_resolve_flags` would: a tooOld
        transaction contributes no ranges, empty ranges are skipped,
        and both ends of every surviving range must fit the key bucket."""
        oldest = self._oldest if oldest_version is None else oldest_version
        for tr in txns:
            if tr.read_snapshot < oldest and len(tr.read_ranges):
                continue
            for b, e in (*tr.read_ranges, *tr.write_ranges):
                if b < e:
                    self._validate_range(b, e)

    def _validate_range(self, b: bytes, e: bytes) -> None:
        for k in (b, e):
            if len(k) > self._key_bytes:
                raise ValueError(
                    f"key length {len(k)} exceeds backend key width "
                    f"{self._key_bytes}")

    def input_contract(self):
        # a view carrying ONLY the key-bucket width, so a long-lived
        # holder never pins this instance's device buffers
        view = object.__new__(type(self))
        view._key_bytes = self._key_bytes
        return view.validate_txns

    def _marshal_ranges(self, txns, too_old, attribute: bool = False):
        """Flatten the batch's conflict ranges in txn order.

        Returns ((rb, re, rt, wb, we, wt), read_map): rb/re/wb/we are
        flat LISTS of raw key bytes (encoded exactly once, straight into
        the packed staging buffer, by `_dispatch`), rt/wt int32 txn-id
        arrays built by one np.repeat over per-txn counts (the
        non-decreasing layout the kernel's segment sums require).
        `read_map` (only when `attribute` asks for it) is a (txn-ids,
        ORIGINAL read_ranges indices) pair. tooOld txns contribute no
        ranges at all (ref: SkipList.cpp:979 addTransaction)."""
        n = len(txns)
        r_counts = np.zeros(n, np.int32)
        w_counts = np.zeros(n, np.int32)
        rb: list = []
        re_: list = []
        wb: list = []
        we: list = []
        r_src: list = []
        for t, tr in enumerate(txns):
            if too_old[t]:
                continue
            rr = tr.read_ranges
            if rr:
                kept = [p for p in rr if p[0] < p[1]]
                r_counts[t] = len(kept)
                rb += [p[0] for p in kept]
                re_ += [p[1] for p in kept]
                if attribute:
                    if len(kept) == len(rr):
                        r_src += range(len(rr))
                    else:
                        r_src += [i for i, p in enumerate(rr)
                                  if p[0] < p[1]]
            ww = tr.write_ranges
            if ww:
                kept = [p for p in ww if p[0] < p[1]]
                w_counts[t] = len(kept)
                wb += [p[0] for p in kept]
                we += [p[1] for p in kept]
        ids = np.arange(n, dtype=np.int32)
        rt = np.repeat(ids, r_counts)
        wt = np.repeat(ids, w_counts)
        read_map = ((rt, np.asarray(r_src, np.int32)) if attribute else ())
        return (rb, re_, rt, wb, we, wt), read_map

    def resolve_arrays(self, snapshots: np.ndarray, has_reads: np.ndarray,
                       rb: np.ndarray, re: np.ndarray, rt: np.ndarray,
                       wb: np.ndarray, we: np.ndarray, wt: np.ndarray,
                       commit_version: int, new_oldest_version: int):
        """Pre-encoded fast path: keys already packed via
        ops.keys.encode_keys, ranges flattened with per-range txn ids.
        Returns the pending conflict flags (`np.asarray` waits for them)
        and the host too_old array. Ranges of tooOld txns may be
        included — their writes are excluded by the kernel and their
        reads only affect their own (overridden) flag.

        CONTRACT: `rt` and `wt` must be NON-DECREASING (ranges flattened
        in transaction order). The kernel's per-txn reductions are
        segment sums over that slot order, so out-of-order ids are
        rejected here."""
        if commit_version < self._last_commit:
            raise ValueError("commit versions must be non-decreasing")
        for name, ids in (("rt", rt), ("wt", wt)):
            # signed view: np.diff on a uint array wraps modulo
            ids = np.asarray(ids, dtype=np.int64)
            if ids.size > 1 and not np.all(np.diff(ids) >= 0):
                raise ValueError(
                    f"per-range txn ids ({name}) must be non-decreasing: "
                    "flatten conflict ranges in transaction order (the "
                    "kernel reduces per-txn flags as segment sums over "
                    "the slot order)")
        too_old = (snapshots < self._oldest) & has_reads.astype(bool)
        live = has_reads.astype(bool) & ~too_old
        floor = min(int(snapshots[live].min()) if live.any() else commit_version,
                    max(self._oldest, new_oldest_version))
        offsets = self._prepare_versions(commit_version, new_oldest_version,
                                         floor)
        conflict, _read_hit = self._dispatch(
            snapshots.shape[0], snapshots, too_old, rb, re,
            np.asarray(rt, np.int32), wb, we, np.asarray(wt, np.int32),
            offsets)
        self._last_commit = commit_version  # only after a successful batch
        self._oldest = max(self._oldest, new_oldest_version)
        return conflict, too_old

    @staticmethod
    def finalize_verdicts(conflict, too_old) -> list[int]:
        n = too_old.shape[0]
        conflict = np.asarray(conflict)[:n]
        return [TOO_OLD if too_old[t] else
                (CONFLICT if conflict[t] else COMMITTED) for t in range(n)]

    # -- marshalling helpers --------------------------------------------
    def _note_count(self, count: _HostCopy, new_rows: int) -> None:
        """Record a batch's row count (its host copy already started);
        keep roughly one pending copy per in-flight pipeline slot so the
        front of the list is the OLDEST submitted batch."""
        self._count_dev = count
        self._rows_since_async += new_rows
        self._count_async.append((count, self._rows_since_async))
        limit = max(2, self.pipeline.depth + 1)
        while len(self._count_async) > limit:
            self._consume_oldest_count()

    def _consume_oldest_count(self) -> bool:
        """Fold the OLDEST pending async count into the hint: its value
        plus every row added since it was taken bounds the current count
        from above (rows only leave via GC)."""
        if not self._count_async:
            return False
        old, rows_after = self._count_async.pop(0)
        stale = int(np.max(np.asarray(old)))
        bound = stale + (self._rows_since_async - rows_after)
        if bound < self._count_hint:
            self._count_hint = bound
        if not self._count_async:
            # the consumed entry WAS the newest count: the hint is exact
            self._count_dev = None
            self._rows_since_async = 0
        return True

    def _audit_capacity(self, new_rows: int) -> None:
        """Grow the device state if this batch could overflow it
        (`new_rows` = 2 boundaries per write). Pending async counts are
        consumed oldest-first; a full `_sync_count` drain is the
        no-pending-copies fallback."""
        while (self._count_hint + new_rows + 2 > self._cap
               and self._consume_oldest_count()):
            pass
        if self._count_hint + new_rows + 2 > self._cap:
            self._sync_count()
        if self._count_hint + new_rows + 2 > self._cap:
            self._grow(self._count_hint + new_rows)
        self._count_hint = min(self._cap - 1, self._count_hint + new_rows)

    def _note_occupancy(self, n, npad, nr, nrp, nw, nwp) -> None:
        """Per-batch pad-shape accounting: real rows vs padded slots."""
        p = self.profile
        p.counter("batches").add(1)
        p.counter("txns").add(int(n))
        p.counter("txn_slots").add(int(npad))
        p.counter("reads").add(int(nr))
        p.counter("read_slots").add(int(nrp))
        p.counter("writes").add(int(nw))
        p.counter("write_slots").add(int(nwp))

    def kernel_stats(self) -> dict:
        """This backend INSTANCE's status-ready profile: pad sizes,
        occupancy, backend, platform and device name, state rows."""
        snap = self.profile.snapshot()
        occ = {}
        for dim in ("txn", "read", "write"):
            rows = snap.get(f"{dim}s", 0)
            slots = snap.get(f"{dim}_slots", 0)
            occ[dim] = round(rows / slots, 4) if slots else None
        batches = snap.get("batches", 0)
        h2d_t = snap.get("h2d_transfers", 0)
        return {"backend": self.BACKEND,
                "platform": _device.platform(self._device),
                "device": _device.device_name(self._device),
                "capacity": self._cap,
                "state_rows": self._count_hint,
                "batches": batches,
                "occupancy": occ,
                # the packed single-buffer discipline shows as
                # per_batch == 1.0
                "h2d": {"transfers": h2d_t,
                        "bytes": snap.get("h2d_bytes", 0),
                        "per_batch": (round(h2d_t / batches, 2)
                                      if batches else None),
                        "staging_allocs": snap.get("staging_allocs", 0)},
                "counts": {k: v for k, v in snap.items()
                           if k != "batches"},
                "pipeline": self.pipeline.stats()}

    def _run_step(self, fn, *args):
        """One resolve step into the ping-pong partner; the pending
        outputs' host copies start right away."""
        hk, hv, count, conflict, read_hit = fn(self._hk, self._hv, *args,
                                               out=self._alt())
        self._swap_in(hk, hv)
        return (_HostCopy(count), _HostCopy(conflict),
                None if read_hit is None else _HostCopy(read_hit))

    # -- packed single-buffer feed path ---------------------------------
    def _feed_len(self, npad: int, nrp: int, nwp: int) -> int:
        from ..ops.conflict_kernel import interval_feed_len
        return interval_feed_len(npad, nrp, nwp, self._n_words)

    def _feed_views(self, buf, npad: int, nrp: int, nwp: int):
        from ..ops.conflict_kernel import interval_batch_views
        return interval_batch_views(buf, npad, nrp, nwp, self._n_words)

    def _staging_views(self, npad: int, nrp: int, nwp: int) -> _Staging:
        """Reusable packed-feed staging for one shape bucket.

        Buffers ROTATE through a small per-bucket pool (pipeline depth
        + 2 entries). On the card each is pinned host memory, and an
        entry is handed out again only after the event behind its last
        host->device copy has fired, so an in-flight copy never sees
        the next batch's writes. Steady state is allocation-flat —
        `staging_allocs` counts pool entries, not batches."""
        key = (npad, nrp, nwp)
        pool = self._staging.get(key)
        if pool is None:
            pool = self._staging[key] = []
        want = max(2, int(self.pipeline.depth) + 2)
        if len(pool) < want:
            n = self._feed_len(npad, nrp, nwp)
            host = torch.empty(n, dtype=torch.uint32,
                               pin_memory=self._device.type == "cuda")
            buf = host.numpy()
            ent = _Staging(buf, self._feed_views(buf, npad, nrp, nwp), host)
            pool.append(ent)
            self.profile.counter("staging_allocs").add(1)
            return ent
        i = self._staging_idx.get(key, 0)
        self._staging_idx[key] = (i + 1) % len(pool)
        ent = pool[i % len(pool)]
        ent.wait()
        return ent

    def _fill_keys(self, dst: np.ndarray, src, nsrc: int) -> None:
        """Fill one padded key sub-matrix of the staging buffer: raw
        byte keys encode STRAIGHT into the buffer; pre-encoded arrays
        memcpy. Pad rows are zeroed for deterministic buffer content."""
        if isinstance(src, np.ndarray):
            dst[:nsrc] = src[:nsrc]
        else:
            sc = self._enc_scratch
            if sc.shape[0] < nsrc or sc.shape[1] != self._key_bytes:
                sc = np.empty((next_pow2(max(nsrc, _KERNEL_MIN_RANGES)),
                               self._key_bytes), np.uint8)
                self._enc_scratch = sc
                self.profile.counter("staging_allocs").add(1)
            encode_keys_into(src, self._key_bytes, dst, sc)
        dst[nsrc:] = 0

    def _feed(self, ent: _Staging) -> torch.Tensor:
        """ONE host->device transfer carrying the whole packed batch; on
        the CPU path the plain step reads the staging buffer directly
        (it finishes before the buffer comes around again)."""
        p = self.profile
        p.counter("h2d_transfers").add(1)
        p.counter("h2d_bytes").add(int(ent.buf.nbytes))
        if self._device.type != "cuda":
            return ent.host
        dev = torch.empty(ent.host.shape, dtype=torch.uint32,
                          device=self._device)
        dev.copy_(ent.host, non_blocking=True)
        ent.event = torch.cuda.Event()
        ent.event.record(torch.cuda.current_stream(self._device))
        return dev

    def _call_kernel_packed(self, npad, nrp, nwp, dev_buf, attribute: bool):
        from ..ops.conflict_kernel import make_resolve_packed_fn
        fn = make_resolve_packed_fn(self._cap, npad, nrp, nwp,
                                    self._n_words, attribute=attribute)
        return self._run_step(fn, dev_buf)

    def _dispatch(self, n, snapshots, too_old, rb, re, rt, wb, we, wt,
                  offsets, attribute: bool = False):
        """Pad one batch to its shape bucket, build the packed feed
        buffer IN PLACE over reused staging, and launch. rb/re/wb/we are
        either flat lists of raw key bytes (encoded straight into the
        buffer) or pre-encoded [n, W+1] arrays (memcpy'd)."""
        commit_off, oldest_off, fixup = offsets
        from ..ops.conflict_kernel import SNAP_CLAMP

        nr, nw = len(rt), len(wt)
        npad = next_pow2(max(n, _KERNEL_MIN_TXNS))
        nrp = next_pow2(max(nr, _KERNEL_MIN_RANGES))
        nwp = next_pow2(max(nw, _KERNEL_MIN_RANGES))
        self._audit_capacity(2 * nw)
        self._note_occupancy(n, npad, nr, nrp, nw, nwp)

        ent = self._staging_views(npad, nrp, nwp)
        v = ent.views
        v.hdr[0] = commit_off
        v.hdr[1] = oldest_off
        v.snap[:n] = np.clip(snapshots - self._base, 0,
                             SNAP_CLAMP).astype(np.int32)
        v.snap[n:] = 0
        v.too_old[:n] = too_old
        v.too_old[n:] = 0
        self._fill_keys(v.rb, rb, nr)
        self._fill_keys(v.re, re, nr)
        v.rtxn[:nr] = rt
        v.rtxn[nr:] = npad
        v.rvalid[:nr] = 1
        v.rvalid[nr:] = 0
        self._fill_keys(v.wb, wb, nw)
        self._fill_keys(v.we, we, nw)
        v.wtxn[:nw] = wt
        v.wtxn[nw:] = npad
        v.wvalid[:nw] = 1
        v.wvalid[nw:] = 0
        span = self._span_start()
        dev_buf = self._feed(ent)
        self._span_end(span)
        span = self._span_start()
        count, conflict, read_hit = self._call_kernel_packed(
            npad, nrp, nwp, dev_buf, attribute)
        self._apply_fixup(fixup)
        self._span_end(span)
        self._note_count(count, 2 * nw)
        return conflict, read_hit

    # -- device time of the stream (off unless asked for) ---------------
    def time_device(self, on: bool = True) -> None:
        """Record a pair of CUDA events around each later batch's feed
        copy and around its resolve step (K3, any jump fixup, the result
        copies), for `device_ms`. Off by default; a no-op on the CPU.
        A span includes the launch gaps inside the step, so the sum is
        an upper bound on the device's busy time."""
        self._spans = [] if on and self._device.type == "cuda" else None

    def device_ms(self) -> float:
        """Device milliseconds in the spans recorded since `time_device`
        (waits for the last of them)."""
        if not self._spans:
            return 0.0
        self._spans[-1][1].synchronize()
        return sum(a.elapsed_time(b) for a, b in self._spans)

    def _span_start(self):
        if self._spans is None:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self._device))
        return ev

    def _span_end(self, start) -> None:
        if start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self._device))
            self._spans.append((start, end))


def load_reference_state(hk, hv, *, base: int, oldest: int,
                         last_commit: int, init_version: int,
                         key_bytes: int, device=None) -> CudaConflictSet:
    """A CudaConflictSet that continues another interval backend's
    stream with identical verdicts: `hk`/`hv` are that backend's history
    arrays (uint32 [cap, W+1] and int32 [cap] as numpy, e.g.
    `np.asarray(tpu._hk)`) and the rest its version bookkeeping
    (`_base`, `_oldest`, `_last_commit`, `_init_version`)."""
    hk = np.array(hk, np.uint32)
    hv = np.array(hv, np.int32)
    cap = hk.shape[0]
    if cap & (cap - 1) or cap < _MIN_CAP or hk.shape != (
            cap, key_bytes // 4 + 1) or hv.shape != (cap,):
        raise ValueError("history arrays do not match the key width or "
                         "a power-of-two capacity")
    cs = CudaConflictSet(init_version=init_version, key_bytes=key_bytes,
                         capacity=cap, device=device)
    cs._base = int(base)
    cs._oldest = int(oldest)
    cs._last_commit = int(last_commit)
    cs._hk, cs._hv = cs._to_device(hk, hv)
    cs._count_hint = max(1, int(np.count_nonzero(hk[:, -1] != 0xFFFFFFFF)))
    return cs
