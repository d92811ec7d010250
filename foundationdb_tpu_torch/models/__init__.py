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
from .native_backend import CONFLICT_BACKENDS, create_conflict_set

__all__ = [
    "COMMITTED", "CONFLICT", "CONFLICT_BACKENDS", "TOO_OLD",
    "BruteForceConflictSet", "ConflictSetBase", "ConflictSetCheckpoint",
    "PyConflictSet", "ResolvePipeline", "ResolveTicket",
    "ResolverTransaction", "create_conflict_set",
]
