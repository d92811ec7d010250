"""Device ops of the port: key encoding, the int32 binary search (K1),
range max (K2), the interval resolve step (K3), version-window upkeep
(K4), the point resolve step (K5), the multiword row search (K6), the
row compare and shard clip (K7), the sharded resolve step (K8), and
the bench chains' batch generator (K9) and tally (K10) in
`bench_chain`. Each kernel wrapper launches its hand-written CUDA
kernel for a CUDA tensor and runs its plain PyTorch version for a CPU
tensor.
"""

from .keys import (
    INF_WORD,
    clip_to_shards,
    decode_keys,
    encode_keys,
    le_rows,
    lt_rows,
    next_pow2,
    searchsorted_i32,
    searchsorted_rows,
    searchsorted_rows_mixed,
)
from .rmq import BLOCK, VDEAD, range_max

__all__ = [
    "INF_WORD", "clip_to_shards", "decode_keys", "encode_keys", "next_pow2",
    "le_rows", "lt_rows", "searchsorted_i32", "searchsorted_rows",
    "searchsorted_rows_mixed", "BLOCK", "VDEAD", "range_max",
]
