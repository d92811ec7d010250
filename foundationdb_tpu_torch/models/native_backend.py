"""The port's conflict-set backend factory (the plugin selection point,
ref: fdbrpc/LoadPlugin.h).

The port serves the pure-Python baseline and the CUDA interval
resolver. `CONFLICT_BACKENDS` is the port's own authority; the native
C++ backend, the point resolver and the sharded resolver join it in
later slices.
"""

from __future__ import annotations

from .conflict_set import ConflictSetBase

CONFLICT_BACKENDS = ("python", "cuda")


def create_conflict_set(backend: str = "python", init_version: int = 0,
                        device=None, **kwargs) -> ConflictSetBase:
    """Backend factory. `device` (and `key_bytes` / `capacity` in
    `kwargs`) configure the CUDA backend: `device=None` is the card, and
    a host without one raises; `device="cpu"` runs the plain PyTorch
    versions of the kernels."""
    if backend == "python":
        from .conflict_set import PyConflictSet
        return PyConflictSet(init_version)
    if backend == "cuda":
        from .cuda_resolver import CudaConflictSet
        return CudaConflictSet(init_version, device=device, **kwargs)
    raise ValueError(f"unknown conflict-set backend: {backend}")
