"""Key-range sharded resolution (ref: fdbserver/MasterProxyServer.actor.cpp
keyResolvers map, ResolutionRequestBuilder :265-341; rebalanced by
masterserver.actor.cpp resolutionBalancing :1008). The reference puts
one shard on each device of a JAX mesh and combines them with ICI
collectives; the port puts one shard on each entry of a device list
(K8e, an all-gather of the external read flags, K8f), or runs the
shards in lockstep on one card (K8).
"""

from .dryrun import dryrun_multichip
from .sharded_resolver import (
    ShardedCudaConflictSet,
    default_split_keys,
    load_reference_sharded_state,
)

__all__ = ["ShardedCudaConflictSet", "default_split_keys",
           "dryrun_multichip", "load_reference_sharded_state"]
