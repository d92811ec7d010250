"""The reference's cases of tests/test_recipes.py on the port's pubsub
and queue layers and its networktest tool.

Layer recipes: pubsub and queues (ref: layers/pubsub +
recipes/python-recipes in the reference)."""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow
from foundationdb_tpu_torch.client import run_transaction
from foundationdb_tpu_torch.layers.pubsub import PubSub
from foundationdb_tpu_torch.layers.queue import PriorityQueue, Queue
from foundationdb_tpu_torch.server import SimCluster


def test_pubsub_fanout_and_watermarks():
    c = SimCluster(seed=210)
    try:
        db = c.client()
        ps = PubSub()

        async def main():
            # two inboxes subscribe; posts BEFORE a subscription are
            # not delivered to it
            async def pre(tr):
                await ps.post(tr, "news", b"ancient history")
            await run_transaction(db, pre)

            async def sub(tr):
                await ps.subscribe(tr, "alice", "news")
                await ps.subscribe(tr, "bob", "news")
                await ps.subscribe(tr, "bob", "sports")
            await run_transaction(db, sub)

            async def post(tr):
                await ps.post(tr, "news", b"headline 1")
                await ps.post(tr, "sports", b"score 2-1")
            await run_transaction(db, post)

            async def read_alice(tr):
                return await ps.read_inbox(tr, "alice")
            got = await run_transaction(db, read_alice)
            assert got == [("news", b"headline 1")]

            # a second read drains nothing new (watermark advanced)
            got = await run_transaction(db, read_alice)
            assert got == []

            async def read_bob(tr):
                return await ps.read_inbox(tr, "bob")
            got = await run_transaction(db, read_bob)
            assert sorted(got) == [("news", b"headline 1"),
                                   ("sports", b"score 2-1")]

            # unsubscribe stops delivery
            async def unsub(tr):
                ps.unsubscribe(tr, "bob", "news")
                await ps.post(tr, "news", b"headline 2")
            await run_transaction(db, unsub)
            got = await run_transaction(db, read_bob)
            assert got == []
            got = await run_transaction(db, read_alice)
            assert got == [("news", b"headline 2")]
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_priority_queue_ordering_and_exactly_once():
    c = SimCluster(seed=211)
    try:
        db = c.client()
        pq = PriorityQueue()

        async def main():
            async def fill(tr):
                await pq.push(tr, b"low-a", priority=5)
                await pq.push(tr, b"hi-a", priority=1)
                await pq.push(tr, b"hi-b", priority=1)
                await pq.push(tr, b"mid", priority=3)
            await run_transaction(db, fill)

            async def peek(tr):
                return await pq.peek(tr)
            assert await run_transaction(db, peek) == (1, b"hi-a")

            async def pop(tr):
                return await pq.pop(tr)
            order = [await run_transaction(db, pop) for _ in range(5)]
            assert order == [b"hi-a", b"hi-b", b"mid", b"low-a", None]

            # exactly-once: two racing pops of one item — one wins, one
            # retries onto emptiness
            async def refill(tr):
                await pq.push(tr, b"only", priority=0)
            await run_transaction(db, refill)
            t1 = db.create_transaction()
            t2 = db.create_transaction()
            r1 = await pq.pop(t1)
            r2 = await pq.pop(t2)
            assert r1 == r2 == b"only"
            await t1.commit()
            with pytest.raises(flow.FdbError):
                await t2.commit()
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_fifo_queue():
    c = SimCluster(seed=212)
    try:
        db = c.client()
        q = Queue()

        async def main():
            async def fill(tr):
                for i in range(5):
                    await q.push(tr, b"item%d" % i)
            await run_transaction(db, fill)

            async def pop(tr):
                return await q.pop(tr)
            got = [await run_transaction(db, pop) for _ in range(6)]
            assert got == [b"item0", b"item1", b"item2", b"item3",
                           b"item4", None]
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_networktest_tool_smoke():
    """The transport microbench runs and reports sane numbers (ref:
    fdbserver -r networktest)."""
    from foundationdb_tpu_torch.tools.networktest import run_networktest

    r = run_networktest(requests=200, parallel=4, payload_bytes=32)
    assert r["requests"] == 200
    assert r["requests_per_second"] > 0
    assert r["p50_ms"] >= 0
