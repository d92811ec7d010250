"""Layers: stateless client libraries on the KV API (ref: layers/ +
the tuple/subspace/directory machinery in the reference bindings)."""

from . import tuple_layer
from .directory import Directory, DirectoryLayer
from .subspace import Subspace
from .taskbucket import Task, TaskBucket
from .tuple_layer import Versionstamp, pack, range_of, unpack

__all__ = ["tuple_layer", "Subspace", "Versionstamp", "pack", "range_of",
           "unpack", "Directory", "DirectoryLayer", "Task", "TaskBucket"]
