"""Server roles of the port (ref: fdbserver/). So far the resolver
role (`resolver_role.Resolver`) over the port's conflict-set backends,
the log role (`tlog.TLog`) on a `diskqueue.DiskQueue`, the storage
role (`storage.StorageServer`) on the memory and B-tree engines
(`kvstore`, `btree`), the atomic ops, the replication policies, the
chaos stations, and the head of the proxy (`proxy`: its mutation
vocabulary, versionstamps and tag counter), with the message
vocabulary they speak (`types`). The cluster (`SimCluster`) comes with
the control plane."""

from . import types
from .types import (
    CLEAR_RANGE,
    SET_VALUE,
    CommitRequest,
    MutationRef,
)

__all__ = ["types", "CommitRequest", "MutationRef", "SET_VALUE",
           "CLEAR_RANGE"]
