"""Server roles of the port: the transaction subsystem (ref: fdbserver/).

The master's version authority, the proxies' commit pipeline, the
resolver over the port's conflict-set backends (the CUDA ones on the
card, or at `device="cpu"` on their plain versions), the tag-partitioned
logs and the versioned storage servers, with the coordinators, the
cluster controller's recruitment and recovery, and the ratekeeper, all
hosted on simulated processes over the deterministic network
(`SimCluster`).
"""

from .cluster import SimCluster
from .types import (
    CLEAR_RANGE,
    SET_VALUE,
    CommitRequest,
    MutationRef,
)

__all__ = ["SimCluster", "CommitRequest", "MutationRef", "SET_VALUE",
           "CLEAR_RANGE"]
