"""Key-range sharded conflict resolution on CUDA cards.

The port of the reference's `ShardedTpuConflictSet`, FDB's
multi-resolver deployment (ref: keyResolvers KeyRangeMap,
fdbserver/MasterProxyServer.actor.cpp:204; split points moved by
resolutionBalancing, fdbserver/masterserver.actor.cpp:1008): shard i
owns the keys [split[i-1], split[i]) and holds its own partition of the
history. Every batch is fed to every shard; each shard clips the
conflict ranges to its own interval and resolves against its own
partition. It comes in two forms.

One shard a device (`devices=[...]`, the reference's form, which puts
one shard on each device of a mesh and combines the external verdicts
and every intra-batch fixpoint round with a psum): each device holds
its shard's [cap, W+1] keys and [cap] versions and gets the batch. A
step is K8e on every device (the shard's external read flags, [R]
bytes), an all-gather of those flags (each device's row copied to
every other device), then K8f on every device (ops/conflict_kernel.py
resolve_shard_ext*/resolve_shard_finish*). Only the external flags
depend on the shard: the overlap matrix is one matrix over the
unclipped non-empty ranges (csrc/resolve.cu, K8's note), so every
device reaches the same verdicts from the same feed, and one exchange
of R bytes a device a batch stands for the reference's collective in
every round. The verdicts and attribution are read off the first
device, the counts off every device. The list may name distinct cards
or one card several times (logical devices, which share that card's
stream), or "cpu" entries, which run the kernels' plain versions.

Lockstep on one card (`n_shards=S`, no `devices`): the S shards of a
[S, cap, W+1] history run inside one resolve step (K8, ops/
conflict_kernel.py resolve_step_sharded_packed, or resolve_step_sharded
with INTERVAL_PACKED_FEED=0), which applies the same combine rule.

Either way the verdicts are bit-identical to the single-shard
resolver's, with one capacity for every shard.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

from .. import device as _device
from ..models.cuda_resolver import _MIN_CAP, CudaConflictSet, _host
from ..ops.keys import decode_keys, encode_keys, lt_rows_plain, next_pow2


def default_split_keys(n_shards: int) -> list[bytes]:
    """Evenly spaced single-byte split points over the keyspace. Keys
    whose high bytes are all zero land in shard 0: such a keyspace needs
    split keys of its own."""
    return [bytes([(i * 256) // n_shards]) for i in range(1, n_shards)]


def _resolve_devices(devices) -> list:
    """The per-device form's device list, each entry resolved: all CUDA
    devices (an entry may repeat) or all "cpu"; a mix raises ValueError,
    a CUDA entry on a host without a card NoCudaDeviceError."""
    devices = list(devices)
    if not devices:
        raise ValueError("devices must name at least one device")
    if len({torch.device(d).type for d in devices}) > 1:
        raise ValueError("devices must be all CUDA devices or all 'cpu'")
    return [_device.resolve(d) for d in devices]


class ShardedCudaConflictSet(CudaConflictSet):
    """Drop-in ConflictSet whose history is key-range sharded into
    partitions at `split_keys` (sorted, one fewer than the shards).
    Verdicts, attribution and the stitched checkpoint are bit-identical
    to `CudaConflictSet`'s.

    `devices` (a list of torch devices or names) puts one shard on each
    entry, the counterpart of the reference's `mesh=`. Without it,
    `n_shards` shards run in lockstep on `device`. With neither and no
    `device`, a host with two or more cards gets one shard a card, as
    the reference's `sharded-tpu` gets one a JAX device, and a host with
    one card one shard; `device="cpu"` without `n_shards` is one
    shard."""

    BACKEND = "sharded-cuda"

    def __init__(self, init_version: int = 0, key_bytes: int = 32,
                 capacity: int = _MIN_CAP, device=None,
                 n_shards: Optional[int] = None,
                 split_keys: Optional[Sequence[bytes]] = None,
                 devices: Optional[Sequence] = None):
        if devices is None and n_shards is None and device is None \
                and torch.cuda.is_available() \
                and torch.cuda.device_count() >= 2:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self._devices = None
        if devices is not None:
            self._devices = _resolve_devices(devices)
            if n_shards is not None and n_shards != len(self._devices):
                raise ValueError("n_shards must equal len(devices)")
            dev, n = self._devices[0], len(self._devices)
        else:
            dev = _device.resolve(device)
            n = n_shards or (torch.cuda.device_count()
                             if dev.type == "cuda" else 1)
        self._alts = None
        self._gathered: dict = {}
        self._scratches: dict = {}
        if split_keys is None:
            split_keys = default_split_keys(n)
        if len(split_keys) != n - 1:
            raise ValueError("need n_shards-1 split keys")
        if list(split_keys) != sorted(split_keys):
            raise ValueError("split keys must be sorted")
        self._n_shards = n
        self._split_keys = [b""] + [bytes(k) for k in split_keys]
        super().__init__(init_version=init_version, key_bytes=key_bytes,
                         capacity=capacity, device=dev)
        self._lows, self._highs = self._make_bounds()

    # -- sharded state --------------------------------------------------
    def _initial_state(self, init_version: int):
        """The fresh history of every shard (the reference does this in
        its `_to_device`): shard 0 keeps slot 0 at b"", every other
        shard's slot 0 is its own lower bound at the base version (the
        first boundary must be <= any clipped query begin)."""
        hk, hv = super()._initial_state(init_version)
        s = self._n_shards
        shk = np.broadcast_to(hk, (s,) + hk.shape).copy()
        shv = np.broadcast_to(hv, (s,) + hv.shape).copy()
        shk[1:, 0] = encode_keys(self._split_keys, self._key_bytes)[1:]
        shv[1:, 0] = hv[0]
        return shk, shv

    def _make_bounds(self):
        """[S, W+1] lower and upper bounds of the shards on the device
        (per device: shard i's [W+1] rows on device i); the last shard's
        upper bound is the all-ones row (length word included), above
        every real key."""
        lows = encode_keys(self._split_keys, self._key_bytes)
        highs = np.full_like(lows, 0xFFFFFFFF)
        highs[:-1] = lows[1:]
        if self._devices is not None:
            return ([torch.from_numpy(lows[i].copy()).to(d)
                     for i, d in enumerate(self._devices)],
                    [torch.from_numpy(highs[i].copy()).to(d)
                     for i, d in enumerate(self._devices)])
        return (torch.from_numpy(lows).to(self._device),
                torch.from_numpy(highs).to(self._device))

    # -- per-device state -------------------------------------------------
    def _to_device(self, hk: np.ndarray, hv: np.ndarray):
        """Install [S, cap, ...] host arrays as the history: lockstep as
        one [S, ...] pair on the device, per device as lists whose entry
        i (shard i) lies on device i."""
        if self._devices is None:
            return super()._to_device(hk, hv)
        self._alts = None
        return ([torch.from_numpy(np.ascontiguousarray(hk[i], np.uint32))
                 .to(d) for i, d in enumerate(self._devices)],
                [torch.from_numpy(np.ascontiguousarray(hv[i], np.int32))
                 .to(d) for i, d in enumerate(self._devices)])

    def _host_state(self):
        if self._devices is None:
            return super()._host_state()
        return (np.stack([_host(t) for t in self._hk]),
                np.stack([_host(t) for t in self._hv]))

    def _upkeep(self, fn, *args) -> None:
        """K4 on every shard's versions (per device: once a device)."""
        if self._devices is None:
            return super()._upkeep(fn, *args)
        for i, hv in enumerate(self._hv):
            with self._on(i):
                fn(hv, *args, out=hv)

    def _on(self, i: int):
        """Device i as the current CUDA device while its kernels launch
        (a launch goes to the current device, whose stream it names);
        nothing on the CPU."""
        d = self._devices[i]
        return (torch.cuda.device(d) if d.type == "cuda"
                else contextlib.nullcontext())

    def _capacity_rows(self) -> int:
        return self._n_shards * self._cap

    # -- checkpoint / restore -------------------------------------------
    def _stitched_rows(self):
        """The per-shard states stitched into ONE global history on the
        host: ([n, W+1] uint32 rows, [n] int32 version offsets). Each
        shard's rows are clipped to its key range (slot 0 is the shard's
        lower bound), so concatenating them in shard order is the global
        history. A boundary a shard recorded AT or past its upper bound
        covers keys it never answers for: the next shard's first row is
        authoritative there and replaces it."""
        from ..ops.fault_injection import convert_device_errors
        with convert_device_errors("drain", f"{self.BACKEND}.checkpoint"):
            shk, shv = self._host_state()
        lows = torch.from_numpy(encode_keys(self._split_keys,
                                            self._key_bytes))
        rows, vers = shk[0][:0], shv[0][:0]
        for i in range(self._n_shards):
            if i:
                keep = lt_rows_plain(torch.from_numpy(rows), lows[i])
                rows, vers = rows[keep.numpy()], vers[keep.numpy()]
            real = shk[i][:, -1] != 0xFFFFFFFF
            rows = np.concatenate([rows, shk[i][real]])
            vers = np.concatenate([vers, shv[i][real]])
        return rows, vers

    def _checkpoint_state(self):
        """The stitched history as one global step function."""
        from ..models.conflict_set import checkpoint_from_step
        rows, vers = self._stitched_rows()
        return checkpoint_from_step(decode_keys(rows),
                                    [int(v) + self._base for v in vers],
                                    self._oldest, self._last_commit)

    def _install_step(self, keys, vals) -> None:
        """Re-shard a restored global step function: each shard gets the
        clip to its own [lo, hi) with an explicit boundary at lo (the
        invariant the initial state establishes)."""
        from ..models.conflict_set import clip_step
        s = self._n_shards
        clips = [clip_step(keys, vals, self._split_keys[i],
                           self._split_keys[i + 1] if i + 1 < s else None)
                 for i in range(s)]
        rows = max(len(k) for k, _v in clips)
        self._cap = max(_MIN_CAP, self._cap, next_pow2(rows + 2))
        shk = np.empty((s, self._cap, self._n_words + 1), np.uint32)
        shv = np.empty((s, self._cap), np.int32)
        for i, (k_i, v_i) in enumerate(clips):
            shk[i], shv[i] = self._encode_step(k_i, v_i, self._cap)
        self._hk, self._hv = self._to_device(shk, shv)
        self._count_hint = rows

    # -- the sharded step -----------------------------------------------
    def _call_kernel_packed(self, npad, nrp, nwp, dev_buf, attribute: bool):
        """One packed batch through every shard: one feed, K8's clip,
        per-shard steps and the combined fixpoint; the verdicts and
        attribution come back combined, the counts per shard. Per
        device, `dev_buf` holds each device's copy of the feed."""
        if self._devices is not None:
            return self._device_step([(b,) for b in dev_buf], npad, nrp,
                                     nwp, attribute, packed=True)
        return self._run_step(self._packed_fn(npad, nrp, nwp, attribute),
                              dev_buf, self._lows, self._highs)

    def _packed_fn(self, npad, nrp, nwp, attribute: bool):
        """Lockstep: the shape bucket's profiled, fault-seamed K8."""
        from ..ops.conflict_kernel import make_resolve_sharded_packed_fn
        return make_resolve_sharded_packed_fn(self._n_shards, self._cap,
                                              npad, nrp, nwp, self._n_words,
                                              attribute=attribute)

    def _one_call_step(self):
        """K8 in lockstep for the one-call submit; None per device, whose
        feed and K8e/K8f sequence stay their own."""
        if self._devices is not None:
            return None
        return 1, self._lows, self._highs, self._n_shards

    def _call_kernel(self, npad, nrp, nwp, args, attribute: bool):
        """One unpacked batch (INTERVAL_PACKED_FEED=0: its 12 inputs,
        each its own counted transfer) through every shard, as the
        packed one: K8's unpacked entry. Per device the inputs, sent to
        the first device, are copied on from there (device to device;
        logical devices of one card share them)."""
        if self._devices is not None:
            feeds = [tuple(a.to(d) for a in args) for d in self._devices]
            return self._device_step(feeds, npad, nrp, nwp, attribute,
                                     packed=False)
        from ..ops.conflict_kernel import make_resolve_sharded_fn
        fn = make_resolve_sharded_fn(self._n_shards, self._cap, npad, nrp,
                                     nwp, self._n_words, attribute=attribute)
        return self._run_step(fn, *args, self._lows, self._highs)


    # -- the per-device step --------------------------------------------
    def _feed(self, ent):
        """Per device: the packed buffer copied from the one pinned
        staging entry to every device, one counted transfer each, as the
        reference's per-device puts (its `_feed`); the entry waits for
        the last copy on each card."""
        if self._devices is None:
            return super()._feed(ent)
        n = len(self._devices)
        p = self.profile
        p.counter("h2d_transfers").add(n)
        p.counter("h2d_bytes").add(int(ent.buf.nbytes) * n)
        if self._device.type != "cuda":
            return [ent.host] * n
        bufs, last = [], {}
        for d in self._devices:
            b = torch.empty(ent.host.shape, dtype=torch.uint32, device=d)
            b.copy_(ent.host, non_blocking=True)
            bufs.append(b)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(d))
            last[d] = ev
        ent.events = tuple(last.values())
        return bufs

    def _per_shape(self, cache: dict, key, make) -> list:
        """One buffer a device for a shape, kept for the shapes in use
        (a few buckets); dropping one is stream-ordered, as every use of
        it lies on its device's stream."""
        bufs = cache.get(key)
        if bufs is None:
            if len(cache) >= 4:
                cache.clear()
            bufs = cache[key] = [make(i, d)
                                 for i, d in enumerate(self._devices)]
        return bufs

    def _device_step(self, feeds, npad, nrp, nwp, attribute: bool,
                     packed: bool):
        """One batch on every device: K8e into the device's row of its
        [D, R] flags, the rows copied to every other device (PyTorch's
        cross-card copy orders itself by events on both cards' streams,
        with no host synchronize; logical devices of one card share its
        stream), then K8f. Returns (counts, conflict, read_hit) on the
        devices: a count off each, the verdicts off the first."""
        from ..ops.conflict_kernel import make_resolve_shard_fns, shard_scratch
        from ..ops.fault_injection import convert_device_errors
        n = len(self._devices)
        ext, finish = make_resolve_shard_fns(n, self._cap, npad, nrp, nwp,
                                             self._n_words,
                                             attribute=attribute,
                                             packed=packed)
        gathered = self._per_shape(
            self._gathered, nrp,
            lambda _i, d: torch.zeros((n, nrp), dtype=torch.bool, device=d))
        scratch = self._per_shape(
            self._scratches, (self._cap, npad, nrp, nwp),
            lambda i, _d: shard_scratch(self._hk[i], npad, nrp, nwp))
        for j in range(n):
            with self._on(j):
                ext(self._hk[j], self._hv[j], *feeds[j], self._lows[j],
                    self._highs[j], out=gathered[j][j], scratch=scratch[j],
                    spans=self.host_spans)
        with convert_device_errors("submit", "shard_gather"):
            for i in range(n):
                for j in range(n):
                    if i != j:
                        gathered[i][j].copy_(gathered[j][j],
                                             non_blocking=True)
        alts = self._alt_states()
        outs = []
        for i in range(n):
            with self._on(i):
                outs.append(finish(self._hk[i], self._hv[i], *feeds[i],
                                   self._lows[i], self._highs[i],
                                   gathered[i], out=alts[i],
                                   scratch=scratch[i],
                                   spans=self.host_spans))
        if self._device.type == "cuda":
            self._alts = list(zip(self._hk, self._hv))
        self._hk = [o[0] for o in outs]
        self._hv = [o[1] for o in outs]
        lead = outs[0]
        return [o[2] for o in outs], lead[3], lead[4]

    def _alt_states(self) -> list:
        """Each device's ping-pong partner, the buffers its next K8f
        writes (None on the CPU, whose plain step allocates)."""
        if self._device.type != "cuda":
            return [None] * len(self._devices)
        if self._alts is None or self._alts[0][0].shape != self._hk[0].shape:
            self._alts = [(torch.empty_like(k), torch.empty_like(v))
                          for k, v in zip(self._hk, self._hv)]
        return self._alts


def load_reference_sharded_state(hk, hv, *, base: int, oldest: int,
                                 last_commit: int, init_version: int,
                                 key_bytes: int,
                                 split_keys: Sequence[bytes],
                                 device=None,
                                 devices: Optional[Sequence] = None
                                 ) -> ShardedCudaConflictSet:
    """A ShardedCudaConflictSet that continues another sharded interval
    backend's stream with identical verdicts: `hk`/`hv` are that
    backend's per-shard history arrays (uint32 [S, cap, W+1] and int32
    [S, cap] as numpy, e.g. `np.asarray(sharded_tpu._hk)`), `split_keys`
    its S - 1 split points, and the rest its version bookkeeping
    (`_base`, `_oldest`, `_last_commit`, `_init_version`). With
    `devices` (S entries) shard i goes to devices[i]; without, the S
    shards run in lockstep on `device`."""
    hk = np.array(hk, np.uint32)
    hv = np.array(hv, np.int32)
    if hk.ndim != 3:
        raise ValueError("sharded history arrays are [S, cap, W+1]")
    s, cap, width = hk.shape
    if cap & (cap - 1) or cap < _MIN_CAP or width != key_bytes // 4 + 1 \
            or hv.shape != (s, cap):
        raise ValueError("history arrays do not match the key width or "
                         "a power-of-two capacity")
    if devices is not None and len(devices) != s:
        raise ValueError("one device a shard")
    cs = ShardedCudaConflictSet(init_version=init_version,
                                key_bytes=key_bytes, capacity=cap,
                                device=device, n_shards=s,
                                split_keys=split_keys, devices=devices)
    cs._base = int(base)
    cs._oldest = int(oldest)
    cs._last_commit = int(last_commit)
    cs._hk, cs._hv = cs._to_device(hk, hv)
    cs._count_hint = max(1, int(np.count_nonzero(
        hk[:, :, -1] != 0xFFFFFFFF, axis=1).max()))
    return cs
