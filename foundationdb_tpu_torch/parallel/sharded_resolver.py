"""Key-range sharded conflict resolution on one CUDA card.

The port of the reference's `ShardedTpuConflictSet`, FDB's
multi-resolver deployment (ref: keyResolvers KeyRangeMap,
fdbserver/MasterProxyServer.actor.cpp:204; split points moved by
resolutionBalancing, fdbserver/masterserver.actor.cpp:1008): shard i
owns the keys [split[i-1], split[i]) and holds its own partition of the
history. Every batch is fed once and shared by all shards; each shard
clips the conflict ranges to its own interval and resolves against its
own partition.

Where the reference puts one shard on each device and combines the
external verdicts and every intra-batch fixpoint round with a psum over
the mesh, here the S shards run in lockstep on ONE card inside one
resolve step (K8, ops/conflict_kernel.py resolve_step_sharded_packed):
the external verdicts are ORed over the shards, and the fixpoint runs
once on the OR of the shards' overlap matrices, which K8 builds as one
matrix over the unclipped non-empty ranges. That is the same combine
rule, so the verdicts are bit-identical to the single-shard resolver's.
The state is [S, cap, W+1] keys and [S, cap] versions, one capacity for
every shard.
"""

from __future__ import annotations

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


class ShardedCudaConflictSet(CudaConflictSet):
    """Drop-in ConflictSet whose history is key-range sharded into
    `n_shards` partitions at `split_keys` (sorted, n_shards - 1 of
    them). Verdicts, attribution and the stitched checkpoint are
    bit-identical to `CudaConflictSet`'s. `n_shards=None` is one shard
    per visible CUDA card (one on the CPU path), as the reference's is
    one per JAX device."""

    BACKEND = "sharded-cuda"

    def __init__(self, init_version: int = 0, key_bytes: int = 32,
                 capacity: int = _MIN_CAP, device=None,
                 n_shards: Optional[int] = None,
                 split_keys: Optional[Sequence[bytes]] = None):
        dev = _device.resolve(device)
        n = n_shards or (torch.cuda.device_count() if dev.type == "cuda"
                         else 1)
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
        """[S, W+1] lower and upper bounds of the shards on the device;
        the last shard's upper bound is the all-ones row (length word
        included), above every real key."""
        lows = encode_keys(self._split_keys, self._key_bytes)
        highs = np.full_like(lows, 0xFFFFFFFF)
        highs[:-1] = lows[1:]
        return (torch.from_numpy(lows).to(self._device),
                torch.from_numpy(highs).to(self._device))

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
            shk, shv = _host(self._hk), _host(self._hv)
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
        attribution come back combined, the counts per shard."""
        from ..ops.conflict_kernel import make_resolve_sharded_packed_fn
        fn = make_resolve_sharded_packed_fn(self._n_shards, self._cap, npad,
                                            nrp, nwp, self._n_words,
                                            attribute=attribute)
        return self._run_step(fn, dev_buf, self._lows, self._highs)


def load_reference_sharded_state(hk, hv, *, base: int, oldest: int,
                                 last_commit: int, init_version: int,
                                 key_bytes: int,
                                 split_keys: Sequence[bytes],
                                 device=None) -> ShardedCudaConflictSet:
    """A ShardedCudaConflictSet that continues another sharded interval
    backend's stream with identical verdicts: `hk`/`hv` are that
    backend's per-shard history arrays (uint32 [S, cap, W+1] and int32
    [S, cap] as numpy, e.g. `np.asarray(sharded_tpu._hk)`), `split_keys`
    its S - 1 split points, and the rest its version bookkeeping
    (`_base`, `_oldest`, `_last_commit`, `_init_version`)."""
    hk = np.array(hk, np.uint32)
    hv = np.array(hv, np.int32)
    if hk.ndim != 3:
        raise ValueError("sharded history arrays are [S, cap, W+1]")
    s, cap, width = hk.shape
    if cap & (cap - 1) or cap < _MIN_CAP or width != key_bytes // 4 + 1 \
            or hv.shape != (s, cap):
        raise ValueError("history arrays do not match the key width or "
                         "a power-of-two capacity")
    cs = ShardedCudaConflictSet(init_version=init_version,
                                key_bytes=key_bytes, capacity=cap,
                                device=device, n_shards=s,
                                split_keys=split_keys)
    cs._base = int(base)
    cs._oldest = int(oldest)
    cs._last_commit = int(last_commit)
    cs._hk, cs._hv = cs._to_device(hk, hv)
    cs._count_hint = max(1, int(np.count_nonzero(
        hk[:, :, -1] != 0xFFFFFFFF, axis=1).max()))
    return cs
