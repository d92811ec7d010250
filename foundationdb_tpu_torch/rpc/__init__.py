"""RPC + deterministic network simulation.

Reference: fdbrpc/ — token-addressed typed endpoints over a swappable
transport (fdbrpc/FlowTransport.actor.cpp:48-113 EndpointMap, :517
deliver), with the simulator implementing the same interface
(fdbrpc/sim2.actor.cpp) so the whole cluster runs single-threaded on
virtual time. The simulated transport is the primary runtime; the real
TCP transport (`tcp.py`) and the gateway (`gateway.py`) slot in behind
the same NetworkRef seam.
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
