"""The reference's cases of tests/test_write_during_read.py on the port's
SimCluster.

WriteDuringRead-class model checker.

Ref: fdbserver/workloads/WriteDuringRead.actor.cpp:29-143 (random op
mix replayed against an in-memory model, reads asserted mid-txn),
FuzzApiCorrectness (selector/limit/option fuzz), RyowCorrectness.
The op mix must cover the FULL client
surface — selectors, limits, reverse, atomics, range clears, watches —
under faults and BUGGIFY, and the checker must provably catch a seeded
storage bug.
"""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402
from foundationdb_tpu_torch.server.workloads import WriteDuringRead  # noqa: E402

from test_torch_fault_workloads import _attrition  # noqa: E402


@pytest.mark.parametrize("seed", range(20))
def test_wdr_sweep(seed):
    """20-seed clean sweep: ~50 transactions of full-surface ops per
    seed, every read checked against the model, watches verified."""
    c = SimCluster(seed=8000 + seed, durable=(seed % 2 == 0),
                   n_storage=1 + seed % 2, n_proxies=1 + seed % 3,
                   n_resolvers=1 + seed % 2)
    try:
        db = c.client()

        async def main():
            w = WriteDuringRead(db, flow.g_random)
            stats = await w.run(rounds=50)
            assert stats["txns"] == 50
            assert stats["ops"] > 100
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


@pytest.mark.parametrize("seed", (8101, 8102, 8103, 8104))
def test_wdr_under_attrition(seed):
    """The same checker stacked with role kills and link clogs: the
    model must stay exact through retries, recoveries, and
    commit_unknown_result resolution (watch liveness is exempt — a
    dead replica parks a watch legitimately)."""
    c = SimCluster(seed=seed, durable=True, n_storage=2, n_workers=7)
    try:
        db = c.client()
        machines = [f"w{i}" for i in range(c.n_workers)]

        async def main():
            w = WriteDuringRead(db, flow.g_random, check_watches=False)
            at = flow.spawn(_attrition(c, 6, machines))
            stats = await w.run(rounds=60)
            await at
            assert stats["txns"] == 60
            return True

        assert c.run(main(), timeout_time=900)
    finally:
        c.shutdown()


@pytest.mark.parametrize("seed", (8201, 8202))
def test_wdr_with_buggify(seed):
    """BUGGIFY distorts knobs + injects delays under the checker."""
    c = SimCluster(seed=seed, durable=True, buggify=True, n_storage=2,
                   n_workers=6)
    try:
        db = c.client()

        async def main():
            w = WriteDuringRead(db, flow.g_random, check_watches=False)
            stats = await w.run(rounds=40)
            assert stats["txns"] == 40
            return True

        assert c.run(main(), timeout_time=900)
    finally:
        c.shutdown()


def test_wdr_catches_seeded_storage_bug():
    """Prove the checker can fail: corrupt the storage read path (drop
    the newest version of every 7th key) and the model must notice
    within one run (ref: the reference's practice of validating
    workloads by breaking the code under test)."""
    from foundationdb_tpu_torch.server.storage import VersionedMap

    c = SimCluster(seed=8301, n_storage=2)
    try:
        db = c.client()
        import zlib
        orig = VersionedMap.get

        def corrupted(self, key, version):
            val = orig(self, key, version)
            if val is not None and key.startswith(b"wdr/") and \
                    zlib.crc32(key) % 7 == 0:
                return val + b"\x00CORRUPT"
            return val

        VersionedMap.get = corrupted
        try:
            db2 = c.client("canary")

            async def main():
                w = WriteDuringRead(db2, flow.g_random,
                                    check_watches=False)
                with pytest.raises(AssertionError):
                    await w.run(rounds=80)
                return True

            assert c.run(main(), timeout_time=600)
        finally:
            VersionedMap.get = orig
    finally:
        c.shutdown()
