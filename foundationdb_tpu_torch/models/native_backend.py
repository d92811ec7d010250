"""The port's conflict-set backend factory (the plugin selection point,
ref: fdbrpc/LoadPlugin.h).

The port serves the pure-Python baseline, the CUDA interval resolver,
the CUDA point-op resolver and the key-range sharded CUDA resolver.
`CONFLICT_BACKENDS` is the port's own authority; the native C++
backend joins it in a later slice. The resolver role reaches the
device backends through `failover.create_resilient_conflict_set`.
"""

from __future__ import annotations

from .conflict_set import ConflictSetBase

CONFLICT_BACKENDS = ("python", "cuda", "cuda-point", "sharded-cuda")


def create_conflict_set(backend: str = "python", init_version: int = 0,
                        device=None, **kwargs) -> ConflictSetBase:
    """Backend factory. `device` (and `key_bytes` / `capacity` in
    `kwargs`, and `n_shards` / `split_keys` for `sharded-cuda`)
    configure the CUDA backends: `device=None` is the card, and a host
    without one raises; `device="cpu"` runs the plain PyTorch versions
    of the kernels."""
    if backend == "python":
        from .conflict_set import PyConflictSet
        return PyConflictSet(init_version)
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
