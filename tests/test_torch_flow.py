"""The reference's flow-runtime cases (tests/test_flow.py) on the
port's own runtime, `foundationdb_tpu_torch.flow`: futures, promises,
actors, virtual time, priorities, cancellation, timeouts, streams,
locks, deadlock detection, seeded determinism, the knob reset and
the thread pool. Each case is the reference's, against the port."""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.flow import (  # noqa: E402
    ActorCancelled,
    AsyncVar,
    FdbError,
    FlowLock,
    Future,
    NotifiedVersion,
    Promise,
    PromiseStream,
    Scheduler,
    TaskPriority,
    all_of,
    error,
    first_of,
    set_scheduler,
    timeout,
)


@pytest.fixture()
def sched():
    s = Scheduler()
    set_scheduler(s)
    yield s
    set_scheduler(None)


def test_future_basic():
    p = Promise()
    seen = []
    p.future.on_ready(lambda f: seen.append(f.get()))
    p.send(42)
    assert seen == [42]
    assert p.future.get() == 42


def test_future_error():
    p = Promise()
    p.send_error(error("not_committed"))
    with pytest.raises(FdbError) as ei:
        p.future.get()
    assert ei.value.code == 1020


def test_broken_promise():
    p = Promise()
    p.drop()
    assert p.future.is_error
    assert p.future.exception().code == 1100


def test_actor_returns_value(sched):
    async def actor():
        return 7

    t = sched.spawn(actor())
    assert sched.run(until=t) == 7


def test_actor_awaits_promise(sched):
    p = Promise()

    async def consumer():
        v = await p.future
        return v + 1

    async def producer():
        await flow.delay(1.0)
        p.send(10)

    t = sched.spawn(consumer())
    sched.spawn(producer())
    assert sched.run(until=t) == 11
    assert sched.now() == 1.0


def test_virtual_time_ordering(sched):
    log = []

    async def at(t, label):
        await flow.delay(t)
        log.append((label, sched.now()))

    done = all_of([sched.spawn(at(3.0, "c")), sched.spawn(at(1.0, "a")),
                   sched.spawn(at(2.0, "b"))])
    sched.run(until=done)
    assert log == [("a", 1.0), ("b", 2.0), ("c", 3.0)]


def test_priority_ordering(sched):
    """Higher-priority ready tasks run first (ref: flow/network.h priorities)."""
    log = []

    async def lo():
        log.append("lo")

    async def hi():
        log.append("hi")

    sched.spawn(lo(), TaskPriority.LOW_PRIORITY)
    sched.spawn(hi(), TaskPriority.WRITE_SOCKET)
    sched.run()
    assert log == ["hi", "lo"]


def test_error_propagates_through_actor(sched):
    async def failing():
        raise error("io_error")

    async def caller():
        try:
            await sched.spawn(failing())
        except FdbError as e:
            return e.code

    t = sched.spawn(caller())
    assert sched.run(until=t) == 1510


def test_cancel_actor(sched):
    state = []

    async def victim():
        try:
            await flow.delay(100.0)
        except ActorCancelled:
            state.append("cancelled")
            raise

    t = sched.spawn(victim())
    async def canceller():
        await flow.delay(1.0)
        t.cancel()

    sched.spawn(canceller())
    sched.run()
    assert state == ["cancelled"]
    assert t.is_error


def test_timeout_fires(sched):
    p = Promise()

    async def waiter():
        return await timeout(p.future, 5.0, default="timed")

    t = sched.spawn(waiter())
    assert sched.run(until=t) == "timed"
    assert sched.now() == 5.0


def test_timeout_beaten(sched):
    p = Promise()

    async def waiter():
        return await timeout(p.future, 5.0, default="timed")

    async def sender():
        await flow.delay(1.0)
        p.send("won")

    t = sched.spawn(waiter())
    sched.spawn(sender())
    assert sched.run(until=t) == "won"


def test_first_of(sched):
    a, b = Promise(), Promise()

    async def waiter():
        return await first_of(a.future, b.future)

    async def sender():
        await flow.delay(1.0)
        b.send("bee")

    t = sched.spawn(waiter())
    sched.spawn(sender())
    assert sched.run(until=t) == (1, "bee")


def test_notified_version(sched):
    nv = NotifiedVersion(0)
    log = []

    async def waiter(v):
        await nv.when_at_least(v)
        log.append(v)

    done = all_of([sched.spawn(waiter(5)), sched.spawn(waiter(3)),
                   sched.spawn(waiter(10))])

    async def setter():
        await flow.delay(0.1)
        nv.set(4)
        await flow.delay(0.1)
        nv.set(10)

    sched.spawn(setter())
    sched.run(until=done)
    assert log == [3, 5, 10]


def test_promise_stream(sched):
    ps = PromiseStream()
    got = []

    async def consumer():
        while True:
            try:
                got.append(await ps.stream.pop())
            except FdbError as e:
                assert e.code == 1  # end_of_stream
                return

    async def producer():
        for i in range(5):
            ps.send(i)
            await flow.delay(0.01)
        ps.close()

    t = sched.spawn(consumer())
    sched.spawn(producer())
    sched.run(until=t)
    assert got == [0, 1, 2, 3, 4]


def test_async_var(sched):
    av = AsyncVar(1)

    async def watcher():
        await av.on_change()
        return av.get()

    async def setter():
        await flow.delay(0.5)
        av.set(99)

    t = sched.spawn(watcher())
    sched.spawn(setter())
    assert sched.run(until=t) == 99


def test_flow_lock(sched):
    lock = FlowLock(2)
    order = []

    async def worker(i):
        await lock.take()
        order.append(("start", i))
        await flow.delay(1.0)
        order.append(("end", i))
        lock.release()

    done = all_of([sched.spawn(worker(i)) for i in range(4)])
    sched.run(until=done)
    # only 2 concurrent: workers 2,3 start after 0,1 finish
    assert order[:2] == [("start", 0), ("start", 1)]
    assert set(order[2:4]) == {("end", 0), ("end", 1)}


def test_deadlock_detection(sched):
    p = Promise()

    async def stuck():
        await p.future

    t = sched.spawn(stuck())
    with pytest.raises(FdbError):
        sched.run(until=t)


def test_determinism_same_seed():
    """Same seed => identical execution trace (ref: §4 determinism oracle)."""

    def run_once(seed):
        flow.set_seed(seed)
        s = Scheduler()
        set_scheduler(s)
        log = []

        async def noisy(i):
            for _ in range(5):
                await flow.delay(flow.g_random.random01())
                log.append((i, round(s.now(), 9)))

        done = all_of([s.spawn(noisy(i)) for i in range(4)])
        s.run(until=done)
        set_scheduler(None)
        return log

    assert run_once(1234) == run_once(1234)
    assert run_once(1234) != run_once(99)


def test_flow_lock_cancelled_waiter_no_leak(sched):
    """A cancelled queued taker must not be granted (and leak) permits."""
    lock = FlowLock(1)
    got = []

    async def holder():
        await lock.take()
        await flow.delay(1.0)
        lock.release()

    async def waiter(i):
        await lock.take()
        got.append(i)
        lock.release()

    sched.spawn(holder())
    victim = sched.spawn(waiter(1))
    survivor = sched.spawn(waiter(2))

    async def canceller():
        await flow.delay(0.5)
        victim.cancel()

    sched.spawn(canceller())
    sched.run(until=survivor)
    assert got == [2]
    assert lock.active == 0


def test_delay_priority_resumes_waiter(sched):
    """delay(0, prio) resumes its waiter at the delay's priority (ref: delay(t, taskID))."""
    log = []

    async def a():
        await flow.delay(0.0, TaskPriority.LOW_PRIORITY)
        log.append("low")

    async def b():
        await flow.delay(0.0, TaskPriority.WRITE_SOCKET)
        log.append("high")

    done = all_of([sched.spawn(a()), sched.spawn(b())])
    sched.run(until=done)
    assert log == ["high", "low"]


def test_actor_collection_reaps():
    from foundationdb_tpu_torch.flow import ActorCollection, Scheduler, set_scheduler
    s = Scheduler()
    set_scheduler(s)
    ac = ActorCollection()

    async def quick(i):
        return i

    for i in range(100):
        ac.add(s.spawn(quick(i)))
    s.run()
    assert ac.tasks == []
    set_scheduler(None)


def test_cancel_one_waiter_of_shared_future(sched):
    """Cancelling one waiter must not cancel the shared producer (ref: flow
    cancels only when the last reference drops)."""
    async def producer():
        await flow.delay(2.0)
        return "product"

    p = sched.spawn(producer())

    async def consumer():
        return await p

    a = sched.spawn(consumer())
    b = sched.spawn(consumer())

    async def canceller():
        await flow.delay(1.0)
        a.cancel()

    sched.spawn(canceller())
    assert sched.run(until=b) == "product"
    assert not p.is_error


def test_cancel_all_cancels_every_member(sched):
    from foundationdb_tpu_torch.flow import ActorCollection
    ac = ActorCollection()
    states = []

    async def member(i):
        try:
            await flow.delay(100.0)
        except ActorCancelled:
            states.append(i)
            raise

    for i in range(3):
        ac.add(sched.spawn(member(i)))

    async def canceller():
        await flow.delay(1.0)
        ac.cancel_all()

    sched.spawn(canceller())
    sched.run()
    assert sorted(states) == [0, 1, 2]


def test_run_timeout_does_not_execute_past_deadline(sched):
    fired = []

    async def late():
        await flow.delay(10.0)
        fired.append("late")

    sched.spawn(late())
    with pytest.raises(FdbError) as ei:
        sched.run(until=Future(), timeout_time=5.0)
    assert ei.value.code == 1004
    assert fired == []
    assert sched.now() == 5.0


def test_stream_value_survives_lost_race_with_deadline(sched):
    """A value delivered to a pop() waiter that lost a first_of race must
    be re-queued, not dropped (ADVICE r1: the proxy batcher's
    first_of(nxt, deadline) pattern lost commit requests that tied with
    the batch deadline)."""
    ps = PromiseStream()
    got = []

    async def batcher():
        # round 1: deadline wins; the pending pop is abandoned
        nxt = ps.stream.pop()
        deadline = flow.delay(1.0)
        idx, _ = await first_of(nxt, deadline)
        assert idx == 1  # deadline fired first
        # a value arrives AFTER the deadline won, into the abandoned waiter
        # (the producer below sends at t=2.0)
        await flow.delay(2.0)
        # round 2: the value must still be obtainable
        got.append(await ps.stream.pop())

    async def producer():
        await flow.delay(2.0)
        ps.send("precious")

    t = sched.spawn(batcher())
    sched.spawn(producer())
    sched.run(until=t)
    assert got == ["precious"]


def test_timeout_abandons_stream_waiter(sched):
    """timeout(stream.pop(), ...) hitting the deadline must not eat the
    next value sent into the stream."""
    ps = PromiseStream()

    async def consumer():
        v = await timeout(ps.stream.pop(), 0.5, default="none")
        assert v == "none"
        await flow.delay(1.0)  # value arrives at t=1.0 (after abandon)
        return await ps.stream.pop()

    async def producer():
        await flow.delay(1.0)
        ps.send(41)

    t = sched.spawn(consumer())
    sched.spawn(producer())
    assert sched.run(until=t) == 41


def test_reused_pop_waiter_after_abandon_still_delivers(sched):
    """pop() re-adopts a previously abandoned pending waiter; direct
    delivery into it must work again."""
    ps = PromiseStream()

    async def consumer():
        v = await timeout(ps.stream.pop(), 0.5, default=None)
        assert v is None
        return await ps.stream.pop()  # re-adopted waiter, direct delivery

    async def producer():
        await flow.delay(1.0)
        ps.send("direct")

    t = sched.spawn(consumer())
    sched.spawn(producer())
    assert sched.run(until=t) == "direct"


def test_knob_reset_in_place():
    from foundationdb_tpu_torch.flow import SERVER_KNOBS, reset_server_knobs
    old = SERVER_KNOBS.versions_per_second
    got = reset_server_knobs()
    assert got is SERVER_KNOBS
    assert SERVER_KNOBS.versions_per_second == old


def test_thread_pool_offload():
    """IThreadPool (ref: flow/IThreadPool.h + AsyncFileEIO's pool):
    blocking work runs on worker threads; results and errors arrive as
    futures resolved ON the scheduler thread; the loop keeps running
    while a worker blocks."""
    import threading
    import time as _time

    from foundationdb_tpu_torch import flow
    from foundationdb_tpu_torch.flow.threadpool import ThreadPool

    sched = flow.Scheduler(virtual=False)   # wall clock: real threads
    flow.set_scheduler(sched)
    try:
        pool = ThreadPool(n_threads=2, name="testpool")
        pool.start()
        main_thread = threading.get_ident()
        seen = {}

        async def main():
            def work(x):
                assert threading.get_ident() != main_thread
                _time.sleep(0.15)
                return x * 2

            # two blocking tasks overlap on the pool while the loop
            # stays live: serial execution is >= 0.3s, so finishing
            # well under that proves concurrency with generous margin
            t0 = _time.perf_counter()
            a = pool.run(work, 21)
            b = pool.run(work, 100)
            ra = await a
            rb = await b
            assert (ra, rb) == (42, 200)
            assert _time.perf_counter() - t0 < 0.28

            def boom():
                raise RuntimeError("disk exploded")
            try:
                await pool.run(boom)
            except flow.FdbError as e:
                seen["err"] = e.name
            return True

        task = flow.spawn(main(), name="poolMain")
        assert sched.run(until=task, timeout_time=None) is True
        assert seen["err"] == "io_error"
        pool.close()
    finally:
        flow.set_scheduler(None)
