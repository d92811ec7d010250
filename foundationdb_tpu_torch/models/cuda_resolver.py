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
    the event recorded behind its last host->device copy has fired;
  - on one card a packed batch's host work below the version
    bookkeeping is one native call (csrc/submit.cu): the staging
    fill, the feed copy into the bucket's device feed buffer, the step
    into the bucket's outputs, and the result copies into a ring of
    pinned slots (`_submit_one_call`); a jump fixup, `time_device` and
    one shard a device take the same steps one call at a time, with the
    same native fill (csrc/marshal.cpp, which also checks the
    pre-encoded path's order and too-old flags);
  - with INTERVAL_PACKED_FEED=0 (read on every batch) the batch goes
    instead as the unpacked step's 12 inputs, each its own copy from a
    fresh pageable host array: the packed feed's parity baseline and
    rollback, as in the reference.

Host responsibilities (everything the kernel cannot do with static
shapes): marshal batches into flat padded arrays, bucketing counts to
powers of two; track the absolute version base, since the device
stores int32 offsets and is re-based long before overflow; the tooOld
test on absolute versions; grow the history capacity by doubling.

With `device="cpu"` the same class runs the kernels' plain PyTorch
versions; `device=None` means the CUDA card and raises without one.
"""

from __future__ import annotations

import ctypes
import time
from typing import Sequence

import numpy as np
import torch

from .. import device as _device
from ..flow.stats import CounterCollection
from ..host_spans import HostSpans
from ..ops import marshal as _marshal
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
        if self.event is not None and self.event.query():
            self.event = None       # landed: `numpy` waits for nothing
        return self.event is None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)


class _HostCopies:
    """The per-device row counts on their way to the host, one
    `_HostCopy` a device; reads as the [D] array of them."""

    __slots__ = ("parts",)

    def __init__(self, counts):
        self.parts = [_HostCopy(c) for c in counts]

    def is_ready(self) -> bool:
        return all(p.is_ready() for p in self.parts)

    def numpy(self) -> np.ndarray:
        return np.stack([p.numpy() for p in self.parts])

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)


class _Staging:
    """One pool entry of packed-feed staging: the host buffer (pinned on
    the card's path), its named views, and the events behind the last
    host->device copies that read it (one a card it went to). `event`
    is the entry's own, which the one-call submit records."""

    __slots__ = ("buf", "views", "host", "events", "addr", "event")

    def __init__(self, buf, views, host):
        self.buf = buf
        self.views = views
        self.host = host
        self.events = ()
        self.addr = buf.ctypes.data
        self.event = None

    def is_ready(self) -> bool:
        return all(ev.query() for ev in self.events)

    def wait(self) -> None:
        for ev in self.events:
            ev.synchronize()


def _made_event(dev: torch.device) -> torch.cuda.Event:
    """A CUDA event of `dev` that exists (an event is made at its first
    record), so native code can record it: `cuda_event` is its handle."""
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return ev


class _Slot:
    """One pinned slot of a shape bucket's readback ring: the step's
    count, verdict flags and read flags land in it by the copies the
    one-call submit enqueues, and `event` fires behind them. `parts`
    are the results handed out of it; the slot is written again only
    once its event has fired and each part has been copied out."""

    __slots__ = ("count", "conflict", "read_hit", "event", "parts", "host",
                 "ptrs")

    def __init__(self, dev, count_shape, npad: int, nrp: int):
        count_bytes = 4 * max(1, int(np.prod(count_shape)))
        at = -(-count_bytes // 16) * 16
        self.host = torch.empty(at + npad + nrp, dtype=torch.uint8,
                                pin_memory=True)
        b = self.host.numpy()
        self.count = b[:count_bytes].view(np.int32).reshape(count_shape)
        self.conflict = b[at:at + npad].view(bool)
        self.read_hit = b[at + npad:].view(bool)
        self.event = _made_event(dev)
        self.parts = []
        base = b.ctypes.data
        self.ptrs = (base, base + at, base + at + npad,
                     self.event.cuda_event)

    def part(self, view) -> "_SlotPart":
        p = _SlotPart(self, view)
        self.parts.append(p)
        return p

    def release(self) -> None:
        """Copy out every part not yet read (the event has fired)."""
        for p in self.parts:
            if p.data is None:
                p.copy_out()
        self.parts.clear()


class _SlotPart:
    """A result on its way to host memory in a readback slot; reads as
    `_HostCopy` does. The first read waits for the slot's event and
    copies the part out, so what a caller holds never aliases a slot
    that is written again."""

    __slots__ = ("slot", "view", "data")

    def __init__(self, slot: _Slot, view: np.ndarray):
        self.slot = slot
        self.view = view
        self.data = None

    def copy_out(self) -> None:
        self.data = self.view.copy()
        self.slot = self.view = None

    def is_ready(self) -> bool:
        return self.data is not None or self.slot.event.query()

    def numpy(self) -> np.ndarray:
        if self.data is None:
            self.slot.event.synchronize()
            self.copy_out()
        return self.data

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)


class _OneCall:
    """A shape bucket's state for the one-call submit (csrc/submit.cu):
    its argument block, the device feed buffer and step outputs (one
    each, reused by every batch of the bucket: the next batch's copy and
    step queue behind this one's on the stream), the step's profile and
    fault seam, and the ring of pinned readback slots."""

    __slots__ = ("args", "addr", "shape", "fn", "tensors", "slots",
                 "slot_idx", "count_shape", "npad", "nrp", "launches")


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
        # (async count copy, rows_added_since, batch seq, capacity rows)
        # of each pending count, oldest first: the capacity audit reads
        # the OLDEST, which rarely stalls because newer batches are
        # queued behind it
        self._count_async: list = []
        self._rows_since_async = 0
        self.profile = CounterCollection(f"{self.BACKEND}_kernel")
        self._staging: dict = {}
        self._staging_idx: dict = {}
        self._enc_scratch = np.empty((0, 0), np.uint8)
        # the packed path's native check and fill (ops/marshal.py), and
        # the one-call submit's state a shape bucket
        self._marshal_lib = None
        self._fill_args = _marshal.FillArgs()
        self._one_calls: dict = {}
        self._one_call_batches = 0
        self._hk_alt = self._hv_alt = None
        self._spans = None      # (start, end) CUDA events: time_device()
        self._span_open = None  # the start event of a device phase
        # phase and wait totals, the span ring (host_spans.py)
        self.host_spans = HostSpans()
        # exact live rows: the folded counts' running totals
        self._live = {"live_rows_sum": 0, "live_samples": 0,
                      "live_rows_last": 0, "live_rows_last_seq": 0,
                      "capacity_rows_sum": 0}
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
            with self.host_spans.wait("wait.sync"):
                rows = np.asarray(self._count_dev).ravel().tolist()
            self._count_hint = max(rows)
            if self._count_async:
                self._note_live(rows, *self._count_async[-1][2:])
            self._count_dev = None
        self._count_async.clear()
        self._rows_since_async = 0

    def _grow(self, needed: int) -> None:
        """Double the capacity (or more, to fit `needed`); a sharded
        history ([S, cap] rows) keeps one capacity for every shard."""
        with self.host_spans.wait("wait.grow"):
            new_cap = max(self._cap * 2, next_pow2(needed + 2))
            old_k, old_v = self._host_state()
            lead = old_v.shape[:-1]
            hk = np.full(lead + (new_cap, self._n_words + 1), 0xFFFFFFFF,
                         np.uint32)
            hv = np.full(lead + (new_cap,), -(1 << 30), np.int32)
            hk[..., :self._cap, :], hv[..., :self._cap] = old_k, old_v
            self._cap = new_cap
            self._hk, self._hv = self._to_device(hk, hv)

    def _host_state(self):
        """The device history as host arrays (HK, HV)."""
        return _host(self._hk), _host(self._hv)

    def _upkeep(self, fn, *args) -> None:
        """A window upkeep (K4: rebase, reset, a jump fixup) in place on
        the device versions."""
        fn(self._hv, *args, out=self._hv)

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
                    self._upkeep(reset)
                else:
                    self._upkeep(rebase, delta)
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
            self._upkeep(jump_fixup_large, REBASE_THRESHOLD,
                         commit_version - new_base)
        else:
            self._upkeep(jump_fixup, REBASE_THRESHOLD,
                         commit_version - new_base, delta)
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
            hk, hv = self._host_state()
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
        t0 = time.perf_counter_ns()
        self.host_spans.begin(t0, self.pipeline.submits + 1)
        try:
            ticket = self._submit_txns(t0, txns, commit_version,
                                       new_oldest_version, attribute)
        except BaseException:
            self.host_spans.abort()
            raise
        self.host_spans.end()
        return ticket

    def _submit_txns(self, t0, txns, commit_version, new_oldest_version,
                     attribute):
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
        self.pipeline.note_submit(ticket, t0 * 1e-9, self.host_spans)
        return ticket

    def submit_arrays(self, snapshots, has_reads, rb, re, rt, wb, we, wt,
                      commit_version: int,
                      new_oldest_version: int) -> ResolveTicket:
        """Pipelined pre-encoded fast path: `resolve_arrays` wrapped in
        a ticket whose `drain_arrays` yields (conflict[:n] ndarray,
        too_old ndarray). Its host spans (`host_spans`): one `submit`
        span a call, tiled by the phases `resolve_arrays` switches to."""
        t0 = time.perf_counter_ns()
        self.host_spans.begin(t0, self.pipeline.submits + 1)
        try:
            ticket = self._submit_arrays(
                t0, snapshots, has_reads, rb, re, rt, wb, we, wt,
                commit_version, new_oldest_version)
        except BaseException:
            self.host_spans.abort()
            raise
        self.host_spans.end()
        return ticket

    def _submit_arrays(self, t0, snapshots, has_reads, rb, re, rt, wb, we,
                       wt, commit_version, new_oldest_version):
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
        self.pipeline.note_submit(ticket, t0 * 1e-9, self.host_spans)
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
        self.host_spans.switch("versions")
        offsets = self._prepare_versions(
            commit_version, new_oldest_version,
            min([max(self._oldest, new_oldest_version)] + live_snaps))

        self.host_spans.switch("check")
        too_old = np.zeros(n, bool)
        snapshots = np.zeros(n, np.int64)
        for t, tr in enumerate(txns):
            snapshots[t] = tr.read_snapshot
            if tr.read_snapshot < self._oldest and len(tr.read_ranges):
                too_old[t] = True

        self.host_spans.switch("stage")
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
        snapshots = np.ascontiguousarray(snapshots, np.int64)
        has_reads = np.asarray(has_reads)
        if has_reads.dtype.itemsize != 1 or has_reads.dtype.kind not in "biu":
            has_reads = has_reads.astype(bool)
        if has_reads.shape != snapshots.shape:
            has_reads = np.broadcast_to(has_reads, snapshots.shape)
        has_reads = np.ascontiguousarray(has_reads)
        rt, rt_kind = _marshal.ids(rt)
        wt, wt_kind = _marshal.ids(wt)
        code, too_old, floor = _marshal.check(
            self._mlib(), snapshots, has_reads, rt, rt_kind, wt, wt_kind,
            self._oldest, commit_version,
            max(self._oldest, new_oldest_version))
        if code:
            raise ValueError(
                f"per-range txn ids ({'rt' if code == 1 else 'wt'}) must "
                "be non-decreasing: flatten conflict ranges in transaction "
                "order (the kernel reduces per-txn flags as segment sums "
                "over the slot order)")
        self.host_spans.switch("versions")
        offsets = self._prepare_versions(commit_version, new_oldest_version,
                                         floor)
        conflict, _read_hit = self._dispatch(
            snapshots.shape[0], snapshots, too_old, rb, re, rt, wb, we, wt,
            offsets)
        self._last_commit = commit_version  # only after a successful batch
        self._oldest = max(self._oldest, new_oldest_version)
        return conflict, too_old

    def _mlib(self):
        """The library of the native check and fill (ops/marshal.py)."""
        lib = self._marshal_lib
        if lib is None:
            lib = self._marshal_lib = _marshal.lib_for(self._device)
        return lib

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
        self._count_async.append((count, self._rows_since_async,
                                  self.host_spans.seq,
                                  self._capacity_rows()))
        limit = max(2, self.pipeline.depth + 1)
        while len(self._count_async) > limit:
            self._consume_oldest_count()

    def _consume_oldest_count(self) -> bool:
        """Fold the OLDEST pending async count into the hint: its value
        plus every row added since it was taken bounds the current count
        from above (rows only leave via GC)."""
        if not self._count_async:
            return False
        old, rows_after, seq, cap_rows = self._count_async.pop(0)
        if old.is_ready():
            rows = np.asarray(old).ravel().tolist()
        else:
            with self.host_spans.wait("wait.count"):
                rows = np.asarray(old).ravel().tolist()
        self._note_live(rows, seq, cap_rows)
        stale = max(rows)
        bound = stale + (self._rows_since_async - rows_after)
        if bound < self._count_hint:
            self._count_hint = bound
        if not self._count_async:
            # the consumed entry WAS the newest count: the hint is exact
            self._count_dev = None
            self._rows_since_async = 0
        return True

    def _note_live(self, rows: list, seq: int, cap_rows: int) -> None:
        """Fold one batch's exact row count (a shard's each, summed) into
        the live-row totals."""
        live = self._live
        n = sum(rows)
        live["live_rows_sum"] += n
        live["live_samples"] += 1
        live["live_rows_last"] = n
        live["live_rows_last_seq"] = seq
        live["capacity_rows_sum"] += cap_rows

    def _capacity_rows(self) -> int:
        """The rows a step sweeps: the capacity (of every shard)."""
        return self._cap

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
                "pipeline": self.pipeline.stats(),
                # host phases and waits inside submit, the batches that
                # took the one-call submit, the exact live rows (outside
                # `counts`, which the reference matches)
                "host": {**self.host_spans.stats(),
                         "one_call_batches": self._one_call_batches,
                         "live": dict(self._live)}}

    def _run_step(self, fn, *args):
        """One resolve step into the ping-pong partner; returns its
        (count, conflict, read_hit) on the device."""
        hk, hv, count, conflict, read_hit = fn(self._hk, self._hv, *args,
                                               out=self._alt(),
                                               spans=self.host_spans)
        self._swap_in(hk, hv)
        return count, conflict, read_hit

    def _start_copies(self, count, conflict, read_hit):
        """The readback phase: the step's outputs on their way to host
        memory (a count a device when `count` is a list)."""
        self._phase("readback")
        return ((_HostCopies(count) if isinstance(count, list)
                 else _HostCopy(count)), _HostCopy(conflict),
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
        if not ent.is_ready():
            with self.host_spans.wait("wait.staging"):
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
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self._device))
        ent.events = (ev,)
        return dev

    def _packed_fn(self, npad, nrp, nwp, attribute: bool):
        """The shape bucket's profiled, fault-seamed packed step."""
        from ..ops.conflict_kernel import make_resolve_packed_fn
        return make_resolve_packed_fn(self._cap, npad, nrp, nwp,
                                      self._n_words, attribute=attribute)

    def _call_kernel_packed(self, npad, nrp, nwp, dev_buf, attribute: bool):
        return self._run_step(self._packed_fn(npad, nrp, nwp, attribute),
                              dev_buf)

    def _call_kernel(self, npad, nrp, nwp, args, attribute: bool):
        """Run one unpacked batch (its 12 device inputs) through the
        single-shard step (the sharded resolver overrides this)."""
        from ..ops.conflict_kernel import make_resolve_fn
        fn = make_resolve_fn(self._cap, npad, nrp, nwp, self._n_words,
                             attribute=attribute)
        return self._run_step(fn, *args)

    def _h2d(self, a: np.ndarray) -> torch.Tensor:
        """Unpacked-feed transfer: one device tensor per input, copied
        from the fresh host array `a` (pageable, so the copy has read it
        before this returns), counted as one transfer and its bytes."""
        t = torch.from_numpy(np.require(a, requirements="CW"))
        p = self.profile
        p.counter("h2d_transfers").add(1)
        p.counter("h2d_bytes").add(int(t.nbytes))
        return t.to(self._device)

    def _dispatch(self, n, snapshots, too_old, rb, re, rt, wb, we, wt,
                  offsets, attribute: bool = False):
        """Pad one batch to its shape bucket and launch it, through the
        packed feed (INTERVAL_PACKED_FEED=1: the buffer built IN PLACE
        over reused staging, one transfer) or the unpacked one (=0).
        rb/re/wb/we are either flat lists of raw key bytes or
        pre-encoded [n, W+1] arrays; snapshots are int64, too_old bool,
        rt/wt txn ids of a kind in `marshal.ID_KINDS`."""
        commit_off, oldest_off, fixup = offsets
        from ..flow.knobs import SERVER_KNOBS

        nr, nw = len(rt), len(wt)
        npad = next_pow2(max(n, _KERNEL_MIN_TXNS))
        nrp = next_pow2(max(nr, _KERNEL_MIN_RANGES))
        nwp = next_pow2(max(nw, _KERNEL_MIN_RANGES))
        self.host_spans.switch("audit")
        self._audit_capacity(2 * nw)
        self._note_occupancy(n, npad, nr, nrp, nw, nwp)

        self.host_spans.switch("stage")
        if not int(SERVER_KNOBS.interval_packed_feed):
            from ..ops.conflict_kernel import SNAP_CLAMP
            snap_off = np.clip(snapshots - self._base, 0,
                               SNAP_CLAMP).astype(np.int32)
            count, conflict, read_hit = self._dispatch_unpacked(
                n, npad, nrp, nwp, snap_off, too_old, rb, re, rt, wb, we,
                wt, commit_off, oldest_off, fixup, attribute)
            self._note_count(count, 2 * nw)
            return conflict, read_hit
        ent = self._staging_views(npad, nrp, nwp)
        one = self._one_call(npad, nrp, nwp, attribute, fixup)
        if one is not None:
            count, conflict, read_hit = self._submit_one_call(
                one, ent, n, snapshots, too_old, rb, re, rt, wb, we, wt,
                commit_off, oldest_off)
        else:
            f = self._fill_args
            keep = self._stage(f, ent, n, snapshots, too_old, rb, re, rt,
                               wb, we, wt, commit_off, oldest_off)
            self._mlib().fdb_marshal_fill(ctypes.addressof(f))
            del keep
            self._phase("feed", device=True)
            dev_buf = self._feed(ent)
            self._phase("launch", device=True)
            out = self._call_kernel_packed(npad, nrp, nwp, dev_buf, attribute)
            count, conflict, read_hit = self._finish_step(out, fixup)
        self._note_count(count, 2 * nw)
        return conflict, read_hit

    def _stage(self, f, ent: _Staging, n, snapshots, too_old, rb, re, rt,
               wb, we, wt, commit_off, oldest_off) -> list:
        """Set the fill's arguments `f` (`marshal.FillArgs`) for one
        batch into staging entry `ent`: every field but the keys that
        came as raw bytes, which are encoded straight into the entry
        here. Returns the arrays whose memory the fill reads (keep them
        until it has run)."""
        v = ent.views
        nr, nw = len(rt), len(wt)
        snapshots = np.ascontiguousarray(snapshots, np.int64)
        too_old = np.ascontiguousarray(too_old, bool)
        keep = [snapshots, too_old]
        f.buf = ent.addr
        f.n, f.nr, f.nw = n, nr, nw
        f.npad = v.snap.shape[0]
        f.nrp = v.rtxn.shape[0]
        f.nwp = v.wtxn.shape[0]
        f.width = self._n_words + 1
        f.commit_off, f.oldest_off = commit_off, oldest_off
        f.snapshots = _marshal.addr(snapshots)
        f.base = self._base
        f.too_old = _marshal.addr(too_old)
        f.rb = self._key_rows(v.rb, rb, nr, keep)
        f.re = self._key_rows(v.re, re, nr, keep)
        f.wb = self._key_rows(v.wb, wb, nw, keep)
        f.we = self._key_rows(v.we, we, nw, keep)
        rt, f.rt_kind = _marshal.ids(rt)
        wt, f.wt_kind = _marshal.ids(wt)
        keep += (rt, wt)
        f.rt = _marshal.addr(rt)
        f.wt = _marshal.addr(wt)
        return keep

    def _key_rows(self, dst: np.ndarray, src, nsrc: int, keep: list):
        """The address of the key rows the fill copies into `dst`, or
        None where `src` is raw key bytes, encoded into `dst` here.
        Pre-encoded rows of another dtype, layout or shape are put into
        the bucket's rows by NumPy's own cast and broadcast first."""
        if not isinstance(src, np.ndarray):
            self._fill_keys(dst, src, nsrc)
            return None
        if src.dtype != np.uint32 or src.ndim != 2 \
                or src.shape[0] < nsrc or src.shape[1] != dst.shape[1] \
                or not src.flags.c_contiguous:
            rows = np.empty((nsrc, dst.shape[1]), np.uint32)
            rows[:] = src[:nsrc]
            src = rows
        keep.append(src)
        return _marshal.addr(src)

    # -- the one-call submit (csrc/submit.cu) ---------------------------
    def _one_call(self, npad, nrp, nwp, attribute: bool, fixup):
        """The shape bucket's `_OneCall` where this batch takes the
        one-call submit, else None: the batch then takes the same steps
        one call at a time. That is so on the CPU, for a jump fixup
        (applied between the step and the readback), with `time_device`
        on (events between the phases), for one shard a device (its own
        feed and step sequence), and for the first call of a step, which
        its profile fences and times with the build."""
        if fixup is not None or self._spans is not None \
                or self._device.type != "cuda":
            return None
        step = self._one_call_step()
        if step is None:
            return None
        key = (npad, nrp, nwp, attribute)
        one = self._one_calls.get(key)
        if one is None or one.shape != self._hk.shape:
            fn = self._packed_fn(npad, nrp, nwp, attribute)
            if not fn.profiled.compiled:
                return None
            if len(self._one_calls) >= 8:
                self._one_calls.clear()
            one = self._one_calls[key] = self._make_one_call(
                fn, step, npad, nrp, nwp, attribute)
        return one

    def _one_call_step(self):
        """(sharded, lows, highs, shards) of the step the one-call submit
        launches: K3 here."""
        return 0, None, None, 1

    def _make_one_call(self, fn, step, npad, nrp, nwp, attribute):
        from ..ops.conflict_kernel import (_check_bounds, _check_history,
                                           _scratch)
        sharded, lows, highs, shards = step
        hk = self._hk
        dev = self._device
        _check_history(hk, self._hv, hk.dim())
        if sharded:
            _check_bounds(hk, lows, highs)
        width = self._n_words + 1
        one = _OneCall()
        one.shape = hk.shape
        one.fn = fn
        one.npad, one.nrp = npad, nrp
        one.count_shape = tuple(hk.shape[:-2])
        # the launcher's counts a batch: K1, K2 (and K8's K7)
        one.launches = ("resolve_sharded", 3) if sharded else ("resolve", 2)
        feed = torch.empty(self._feed_len(npad, nrp, nwp),
                           dtype=torch.uint32, device=dev)
        count = torch.empty(one.count_shape, dtype=torch.int32, device=dev)
        conflict = torch.empty(npad, dtype=torch.bool, device=dev)
        read_hit = (torch.empty(nrp, dtype=torch.bool, device=dev)
                    if attribute else None)
        scratch = (_scratch(dev, self._cap, npad, nrp, nwp, width,
                            "fdb_resolve_sharded_scratch_bytes", shards)
                   if sharded else
                   _scratch(dev, self._cap, npad, nrp, nwp, width))
        one.tensors = (feed, count, conflict, read_hit, scratch, lows, highs)
        a = one.args = _marshal.SubmitArgs()
        one.addr = ctypes.addressof(a)
        a.feed = feed.data_ptr()
        a.sharded = sharded
        a.lows = None if lows is None else lows.data_ptr()
        a.highs = None if highs is None else highs.data_ptr()
        a.shards, a.cap, a.attribute = shards, self._cap, int(attribute)
        a.count = count.data_ptr()
        a.conflict = conflict.data_ptr()
        a.read_hit = None if read_hit is None else read_hit.data_ptr()
        a.scratch, a.scratch_bytes = scratch.data_ptr(), scratch.numel()
        one.slots = []
        one.slot_idx = 0
        return one

    def _readback_slot(self, one: _OneCall) -> _Slot:
        """The next slot of the bucket's readback ring (pipeline depth +
        2 slots). A slot comes around again only after its event has
        fired (a `wait.readback` when the host has to wait for it) and
        the parts still held from it have been copied out."""
        ring = one.slots
        if len(ring) < max(2, int(self.pipeline.depth) + 2):
            slot = _Slot(self._device, one.count_shape, one.npad, one.nrp)
            ring.append(slot)
            return slot
        i = one.slot_idx
        one.slot_idx = (i + 1) % len(ring)
        slot = ring[i % len(ring)]
        if not slot.event.query():
            with self.host_spans.wait("wait.readback"):
                slot.event.synchronize()
        slot.release()
        return slot

    def _submit_one_call(self, one: _OneCall, ent: _Staging, n, snapshots,
                         too_old, rb, re, rt, wb, we, wt, commit_off,
                         oldest_off):
        """One packed batch's stage, feed, launch and readback as one
        native call (csrc/submit.cu), its profile, seam, counters and
        host spans as the Python sequence keeps them. Returns the
        (count, conflict, read_hit) parts of its readback slot."""
        from ..ops._build import check
        from ..ops.conflict_kernel import _note_launches
        from ..ops.fault_injection import (convert_device_errors,
                                           g_device_faults)
        a = one.args
        keep = self._stage(a.fill, ent, n, snapshots, too_old, rb, re, rt,
                           wb, we, wt, commit_off, oldest_off)
        slot = self._readback_slot(one)
        if ent.event is None:
            ent.event = _made_event(self._device)
        hk_out, hv_out = self._alt()
        a.feed_event = ent.event.cuda_event
        a.hk, a.hv = self._hk.data_ptr(), self._hv.data_ptr()
        a.hk_out, a.hv_out = hk_out.data_ptr(), hv_out.data_ptr()
        a.stream = _device.stream_handle(self._device)
        (a.host_count, a.host_conflict, a.host_read_hit,
         a.result_event) = slot.ptrs
        p = self.profile
        p.counter("h2d_transfers").add(1)
        p.counter("h2d_bytes").add(int(ent.buf.nbytes))
        fn = one.fn
        g_device_faults.check("submit", fn.where)
        timed = fn.profiled.external()
        if timed:
            a.timed_start = timed[0].cuda_event
            a.timed_end = timed[1].cuda_event
        else:
            a.timed_start = a.timed_end = None
        with convert_device_errors("submit", fn.where):
            check(self._mlib().fdb_submit_packed(one.addr), "submit_packed")
        del keep
        if timed:
            fn.profiled.timed(*timed)
        ent.events = (ent.event,)
        name, counted = one.launches
        _note_launches(a.launches[:counted], name)
        t = a.t
        spans = self.host_spans
        spans.switch_at("feed", t[1])
        spans.switch_at("launch", t[2])
        spans.switch_at("readback", t[3])
        self._swap_in(hk_out, hv_out)
        self._one_call_batches += 1
        return (slot.part(slot.count), slot.part(slot.conflict[:n]),
                slot.part(slot.read_hit[:len(rt)]) if a.attribute else None)

    def _finish_step(self, out, fixup):
        """After the step: any jump fixup (a `versions` phase), then the
        readback's copies of `out`."""
        if fixup is not None:
            self._phase("versions", device=True)
            self._apply_fixup(fixup)
        return self._start_copies(*out)

    def _dispatch_unpacked(self, n, npad, nrp, nwp, snap_off, too_old,
                           rb, re, rt, wb, we, wt, commit_off, oldest_off,
                           fixup, attribute: bool):
        """The multi-transfer feed (INTERVAL_PACKED_FEED=0): the step's
        12 inputs padded as the reference pads them, each its own
        counted transfer, then the unpacked step."""
        nr, nw = len(rt), len(wt)
        if not isinstance(rb, np.ndarray):
            keys = encode_keys(list(rb) + list(re) + list(wb) + list(we),
                               self._key_bytes)
            rb, re = keys[:nr], keys[nr:2 * nr]
            wb, we = keys[2 * nr:2 * nr + nw], keys[2 * nr + nw:]
        snap_p = np.zeros(npad, np.int32)
        snap_p[:n] = snap_off
        tooold_p = np.zeros(npad, bool)
        tooold_p[:n] = too_old
        rvalid = np.zeros(nrp, bool)
        rvalid[:nr] = True
        wvalid = np.zeros(nwp, bool)
        wvalid[:nw] = True
        host = (snap_p, tooold_p,
                self._pad_keys(rb, nrp), self._pad_keys(re, nrp),
                self._pad_idx(rt, nrp, npad), rvalid,
                self._pad_keys(wb, nwp), self._pad_keys(we, nwp),
                self._pad_idx(wt, nwp, npad), wvalid,
                np.int32(commit_off), np.int32(oldest_off))
        self._phase("feed", device=True)
        args = tuple(self._h2d(a) for a in host)
        self._phase("launch", device=True)
        out = self._call_kernel(npad, nrp, nwp, args, attribute)
        return self._finish_step(out, fixup)

    def _pad_keys(self, a: np.ndarray, size: int) -> np.ndarray:
        out = np.zeros((size, self._n_words + 1), np.uint32)
        out[:a.shape[0]] = a
        return out

    @staticmethod
    def _pad_idx(a: np.ndarray, size: int, fill: int) -> np.ndarray:
        out = np.full((size,), fill, np.int32)
        out[:a.shape[0]] = a
        return out

    # -- device time of the stream (off unless asked for) ---------------
    def time_device(self, on: bool = True) -> None:
        """Record a pair of CUDA events around each later batch's
        device phases (`_phase`: the feed copy, the resolve step, any
        jump fixup), for `device_ms`. Off by default; a no-op on the CPU.
        A span includes the launch gaps inside the step, so the sum is
        an upper bound on the device's busy time."""
        self._spans = [] if on and self._device.type == "cuda" else None
        self._span_open = None

    def device_ms(self) -> float:
        """Device milliseconds in the spans recorded since `time_device`
        (waits for the last of them)."""
        if not self._spans:
            return 0.0
        self._spans[-1][1].synchronize()
        return sum(a.elapsed_time(b) for a, b in self._spans)

    def _phase(self, name: str, device: bool = False) -> None:
        """Switch the batch's host span to phase `name`. With
        `time_device` on, a pair of CUDA events brackets each `device`
        phase (the feed, the step, a jump fixup) for `device_ms`."""
        self.host_spans.switch(name)
        if self._spans is None:
            return
        ev = None
        if self._span_open is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self._device))
            self._spans.append((self._span_open, ev))
            self._span_open = None
        if device:
            if ev is None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(torch.cuda.current_stream(self._device))
            self._span_open = ev

    # -- host spans inside submit (host_spans.py) -------------------------
    def trace_spans(self, on: bool = True) -> None:
        """Keep each later batch's spans (`submit`, its phases, their
        waits) in a preallocated ring, read by `traced_spans`; off (the
        default) the ring is dropped and only the totals in
        `kernel_stats()["host"]` are kept."""
        self.host_spans.trace(on)

    def traced_spans(self) -> list:
        """The ring's spans, oldest first: (batch seq, span id, parent
        id or -1, name, start ns, end ns) on `time.perf_counter_ns`."""
        return self.host_spans.spans()


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
