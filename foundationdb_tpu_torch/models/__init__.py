"""Conflict-set backends of the port (ref: fdbserver/ConflictSet.h
behind a plugin boundary)."""

from .conflict_set import (
    COMMITTED,
    CONFLICT,
    TOO_OLD,
    BruteForceConflictSet,
    ConflictSetBase,
    ConflictSetCheckpoint,
    PyConflictSet,
    ResolvePipeline,
    ResolveTicket,
    ResolverTransaction,
)
from .failover import (
    DEVICE_BACKENDS,
    FailoverConflictSet,
    ShadowResolveMismatch,
    create_resilient_conflict_set,
)
from .native_backend import (
    CONFLICT_BACKENDS,
    NativeConflictSet,
    create_conflict_set,
    native_available,
)

__all__ = [
    "COMMITTED", "CONFLICT", "CONFLICT_BACKENDS", "DEVICE_BACKENDS",
    "TOO_OLD", "BruteForceConflictSet", "ConflictSetBase",
    "ConflictSetCheckpoint", "FailoverConflictSet", "NativeConflictSet",
    "PyConflictSet", "ResolvePipeline", "ResolveTicket",
    "ResolverTransaction", "ShadowResolveMismatch", "create_conflict_set",
    "create_resilient_conflict_set", "native_available",
]
