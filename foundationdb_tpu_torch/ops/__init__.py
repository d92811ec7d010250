"""Device ops of the port: key encoding, the int32 binary search (K1),
range max (K2), the interval resolve step (K3) and version-window
upkeep (K4). Each kernel wrapper launches its hand-written CUDA kernel
for a CUDA tensor and runs its plain PyTorch version for a CPU tensor.
"""

from .keys import (
    INF_WORD,
    decode_keys,
    encode_keys,
    next_pow2,
    searchsorted_i32,
)
from .rmq import BLOCK, VDEAD, range_max

__all__ = [
    "INF_WORD", "decode_keys", "encode_keys", "next_pow2",
    "searchsorted_i32", "BLOCK", "VDEAD", "range_max",
]
