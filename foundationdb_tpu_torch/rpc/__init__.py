"""RPC + deterministic network simulation.

Reference: fdbrpc/ — token-addressed typed endpoints over a swappable
transport (fdbrpc/FlowTransport.actor.cpp:48-113 EndpointMap, :517
deliver), with the simulator implementing the same interface
(fdbrpc/sim2.actor.cpp) so the whole cluster runs single-threaded on
virtual time. The simulated transport is the runtime here; the real
TCP transport and the gateway come with the port's cluster.
"""

from .disk import SimDisk, SimFile
from .network import (
    Endpoint,
    NetworkRef,
    RequestStream,
    SimNetwork,
    SimProcess,
)

__all__ = ["Endpoint", "NetworkRef", "RequestStream", "SimNetwork",
           "SimProcess", "SimDisk", "SimFile"]
