"""The per-device sharded resolver's dry run over n devices.

The counterpart of the reference's `dryrun_multichip(n)`
(`__graft_entry__.py`), which runs the sharded resolve step over an
n-device mesh: two directed batches, then seeded random batches until
at least 120 transactions, every batch's verdicts held to the
pure-Python baseline.
"""

from __future__ import annotations

import random
from typing import Optional, Sequence

import torch

from .. import device as _device
from ..models import PyConflictSet, ResolverTransaction
from .sharded_resolver import ShardedCudaConflictSet

MWTLV = 5_000_000


def dryrun_multichip(n_devices: int,
                     devices: Optional[Sequence] = None) -> int:
    """Resolve the reference dry run's batches on a ShardedCudaConflictSet
    with one shard a device (capacity 1024) and hold every batch's
    verdicts to `PyConflictSet`'s; raises AssertionError on the first
    difference. `devices=None` is the first `n_devices` cards (fewer
    raise); a list, e.g. ["cpu"] * 8 or [cuda:0] * 4, is taken as it is
    and must hold `n_devices` entries. Returns the transactions run."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not have:
            raise _device.NoCudaDeviceError(
                "no CUDA device: pass devices=['cpu'] * n")
        assert have >= n_devices, (
            f"need {n_devices} devices, have {have}")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    devices = list(devices)
    assert len(devices) == n_devices, (
        f"need {n_devices} devices, given {len(devices)}")
    sharded = ShardedCudaConflictSet(devices=devices, capacity=1024)
    py = PyConflictSet()

    def txn(s, reads=(), writes=()):
        return ResolverTransaction(s, tuple(reads), tuple(writes))

    b1 = [txn(0, writes=[(b"\x10", b"\x11"), (b"\xe0", b"\xf5")]),
          txn(0, reads=[(b"\x10", b"\x11")], writes=[(b"\xf0", b"\xf1")]),
          txn(0, reads=[(b"\xf0", b"\xf1")])]
    b2 = [txn(50, reads=[(b"\x05", b"\xee")]),
          txn(100, reads=[(b"\x10", b"\x11")], writes=[(b"\x20", b"\x21")]),
          txn(100, reads=[(b"\x00", b"\x01")])]
    for v, batch in ((100, b1), (200, b2)):
        got = sharded.resolve(batch, v, 0)
        want = py.resolve(batch, v, 0)
        assert got == want, f"sharded verdicts {got} != baseline {want}"

    # seeded random batches across the shard seams: cross-shard ranges,
    # window expiry, growth and GC
    rng = random.Random(2024)

    def rrange():
        a = bytes([rng.randrange(256), rng.randrange(8)])
        b = bytes([rng.randrange(256), rng.randrange(8)])
        if a > b:
            a, b = b, a
        if a == b:
            b = a + b"\x00"
        return a, b

    version, n_txns = 200, 0
    while n_txns < 120:
        version += rng.randrange(1, 300_000)
        oldest = max(0, version - MWTLV)
        batch = [txn(max(0, version - rng.randrange(0, int(1.2 * MWTLV))),
                     [rrange() for _ in range(rng.randrange(0, 4))],
                     [rrange() for _ in range(rng.randrange(0, 4))])
                 for _ in range(rng.randrange(1, 16))]
        n_txns += len(batch)
        got = sharded.resolve(batch, version, oldest)
        want = py.resolve(batch, version, oldest)
        assert got == want, (
            f"randomized parity diverged at version {version}: "
            f"{got} != {want}")
    return len(b1) + len(b2) + n_txns

