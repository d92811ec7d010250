"""The reference's KeyValueStoreBTree cases (tests/test_btree.py) on the
port's `server.btree`, its cluster case on the port's SimCluster.

KeyValueStoreBTree: randomized model checking + crash recovery via
the shadow-paging superblock flip (ref: fdbserver/VersionedBTree
.actor.cpp + IndirectShadowPager; test style: KVStoreTest workload)."""

import random

import pytest

torch = pytest.importorskip("torch")

import foundationdb_tpu_torch.flow as fl  # noqa: E402
from foundationdb_tpu_torch.rpc import SimNetwork  # noqa: E402
from foundationdb_tpu_torch.server.btree import KeyValueStoreBTree  # noqa: E402


def _env(seed):
    fl.set_seed(seed)
    s = fl.Scheduler(virtual=True)
    fl.set_scheduler(s)
    net = SimNetwork(s, fl.g_random)
    proc = net.new_process("kvs", machine="m")
    return s, net, proc


def _run(s, coro, timeout=600):
    t = s.spawn(coro)
    assert s.run(until=t, timeout_time=timeout)
    return t.get()


def test_basic_ops_and_recovery():
    s, net, proc = _env(21)
    try:
        kv = KeyValueStoreBTree(net.disk("m"), "bt", owner=proc)

        async def main():
            await kv.recover()
            for i in range(200):
                kv.set(b"k%04d" % i, b"v%d" % i)
            await kv.commit()
            assert kv.get(b"k0042") == b"v42"
            assert kv.get(b"nope") is None
            rows = kv.get_range(b"k0010", b"k0013")
            assert rows == [(b"k0010", b"v10"), (b"k0011", b"v11"),
                            (b"k0012", b"v12")]
            kv.clear_range(b"k0010", b"k0190")
            kv.set(b"k0100", b"back")
            await kv.commit()
            # reopen from disk
            kv2 = KeyValueStoreBTree(net.disk("m"), "bt", owner=proc)
            await kv2.recover()
            assert kv2.get(b"k0005") == b"v5"
            assert kv2.get(b"k0050") is None
            assert kv2.get(b"k0100") == b"back"
            assert kv2.get(b"k0195") == b"v195"
            assert len(kv2.get_range(b"", b"\xff")) == \
                len(kv.get_range(b"", b"\xff"))
            return True

        _run(s, main())
    finally:
        fl.set_scheduler(None)


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_randomized_vs_model_with_crashes(seed):
    """Random op batches vs a dict model; a power loss between commits
    must recover EXACTLY the last committed state (the shadow-paging
    guarantee)."""
    s, net, proc = _env(100 + seed)
    try:
        async def main():
            rng = random.Random(seed)
            kv = KeyValueStoreBTree(net.disk("m"), "bt", owner=proc)
            await kv.recover()
            committed = {}
            model = {}
            for _round in range(30):
                for _ in range(rng.randrange(1, 12)):
                    if rng.random() < 0.75:
                        k = b"%03d" % rng.randrange(150)
                        v = b"v%d" % rng.randrange(1000)
                        kv.set(k, v)
                        model[k] = v
                    else:
                        a = b"%03d" % rng.randrange(150)
                        b = b"%03d" % rng.randrange(150)
                        if a > b:
                            a, b = b, a
                        kv.clear_range(a, b)
                        for k in [k for k in model if a <= k < b]:
                            del model[k]
                # reads see staged state
                probe = b"%03d" % rng.randrange(150)
                assert kv.get(probe) == model.get(probe)
                if rng.random() < 0.7:
                    await kv.commit()
                    committed = dict(model)
                if rng.random() < 0.25:
                    # crash: unsynced writes are lost; recover and
                    # compare against the last committed state
                    net.disk("m").power_loss(fl.g_random, owner=proc)
                    kv = KeyValueStoreBTree(net.disk("m"), "bt",
                                            owner=proc)
                    await kv.recover()
                    got = dict(kv.get_range(b"", b"\xff"))
                    assert got == committed, (
                        _round, len(got), len(committed))
                    model = dict(committed)
            return True

        _run(s, main())
    finally:
        fl.set_scheduler(None)


def test_btree_as_storage_engine_in_cluster():
    """The engine slots in behind the storage server like the memory
    engine does."""
    from foundationdb_tpu_torch.client import run_transaction
    from foundationdb_tpu_torch.server import SimCluster

    c = SimCluster(seed=31, durable=True, storage_engine="btree")
    try:
        db = c.client()

        async def main():
            async def body(tr):
                for i in range(50):
                    tr.set(b"bt%02d" % i, b"v%d" % i)
            await run_transaction(db, body)
            c.kill_role("storage")

            async def check(tr):
                got = await tr.get_range(b"bt", b"bu")
                assert len(got) == 50
            await run_transaction(db, check, max_retries=300)
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


def test_reverse_paging_returns_rows_nearest_end():
    """Reverse limited scans must yield the window's LAST rows — the
    contract the storage server's reverse paging depends on."""
    s, net, proc = _env(41)
    try:
        kv = KeyValueStoreBTree(net.disk("m"), "bt", owner=proc)

        async def main():
            await kv.recover()
            for i in range(300):
                kv.set(b"r%04d" % i, b"v")
            await kv.commit()
            page = kv.get_range(b"", b"\xff", limit=64, reverse=True)
            assert page[0][0] == b"r0299"
            assert page[-1][0] == b"r0236"
            # paging backward covers everything exactly once
            seen = []
            cursor = b"\xff"
            while True:
                pg = kv.get_range(b"", cursor, limit=64, reverse=True)
                if not pg:
                    break
                seen.extend(k for k, _ in pg)
                cursor = pg[-1][0]
            assert seen == [b"r%04d" % i for i in range(299, -1, -1)]
            return True

        _run(s, main())
    finally:
        fl.set_scheduler(None)


def test_large_values_split_by_bytes():
    """Values near the per-item limit force byte-aware splits instead
    of page overflow."""
    s, net, proc = _env(43)
    try:
        kv = KeyValueStoreBTree(net.disk("m"), "bt", owner=proc)

        async def main():
            await kv.recover()
            big = b"x" * 1900
            for i in range(60):
                kv.set(b"big%02d" % i, big + b"%02d" % i)
            await kv.commit()
            for i in range(60):
                assert kv.get(b"big%02d" % i) == big + b"%02d" % i
            kv2 = KeyValueStoreBTree(net.disk("m"), "bt", owner=proc)
            await kv2.recover()
            assert len(kv2.get_range(b"", b"\xff")) == 60
            with pytest.raises(ValueError):
                kv.set(b"k", b"y" * 3000)
            with pytest.raises(ValueError):
                kv.set(b"k" * 2000, b"v")
            return True

        _run(s, main())
    finally:
        fl.set_scheduler(None)


def test_free_list_survives_heavy_churn():
    """Large clears free more pages than one superblock holds; the
    overflow stays reusable so the file stops growing under churn."""
    s, net, proc = _env(47)
    try:
        kv = KeyValueStoreBTree(net.disk("m"), "bt", owner=proc)

        async def main():
            await kv.recover()
            sizes = []
            for _cycle in range(6):
                for i in range(800):
                    kv.set(b"c%04d" % i, b"v%d" % i)
                await kv.commit()
                kv.clear_range(b"", b"\xff")
                await kv.commit()
                sizes.append(kv._next_page)
            # allocation reuses freed pages: the page-id high-water mark
            # stabilizes instead of growing every cycle
            assert sizes[-1] == sizes[-2] == sizes[-3], sizes
            return True

        _run(s, main(), timeout=1200)
    finally:
        fl.set_scheduler(None)
