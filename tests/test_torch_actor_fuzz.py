"""The reference's actor-combinator fuzz (tests/test_actor_fuzz.py) on
the port's runtime: random compositions of delay/all_of/first_of/
timeout/streams/locks under random cancellation must neither
deadlock, leak errors past their handlers, nor diverge across seed
replays (ref: fdbrpc/actorFuzz.py)."""

import pytest

torch = pytest.importorskip("torch")

import foundationdb_tpu_torch.flow as fl  # noqa: E402


def _build_random_actor(rng, depth=0):
    """Compose a random actor-coroutine factory out of delay/all_of/
    first_of/timeout/streams/locks/cancellation."""

    choice = rng.random_int(0, 7 if depth < 3 else 3)

    if choice == 0:
        async def leaf():
            await fl.delay(rng.random01() * 0.01)
            return 1
        return leaf
    if choice == 1:
        async def leaf_err():
            await fl.delay(rng.random01() * 0.01)
            try:
                raise fl.error("operation_failed")
            except fl.FdbError:
                return 1   # handled locally
        return leaf_err
    if choice == 2:
        async def stream_actor():
            ps = fl.PromiseStream()

            async def feeder():
                for i in range(3):
                    await fl.delay(rng.random01() * 0.005)
                    ps.send(i)
            t = fl.spawn(feeder())
            total = 0
            for _ in range(3):
                total += await ps.stream.pop()
            await t
            return 1
        return stream_actor
    if choice == 3:
        async def lock_actor():
            lock = fl.FlowLock()

            async def worker():
                await lock.take()
                await fl.delay(rng.random01() * 0.005)
                lock.release()
                return 1
            ts = [fl.spawn(worker()) for _ in range(3)]
            await fl.wait_for_all(ts)
            return 1
        return lock_actor

    subs = [_build_random_actor(rng, depth + 1)
            for _ in range(rng.random_int(1, 4))]
    if choice == 4:
        async def par():
            await fl.all_of([fl.spawn(sub()) for sub in subs])
            return 1
        return par
    if choice == 5:
        async def race():
            futs = [fl.spawn(sub()) for sub in subs]
            await fl.first_of(*futs)
            for f in futs:
                f.cancel()
            return 1
        return race
    if choice == 6:
        async def timed():
            got = await fl.timeout(fl.spawn(subs[0]()),
                                   rng.random01() * 0.02, default=None)
            return 1 if got is not None else 0   # 0 = the timeout fired
        return timed

    async def cancelled():
        t = fl.spawn(subs[0]())
        await fl.delay(rng.random01() * 0.01)
        t.cancel()
        return 1
    return cancelled


@pytest.mark.parametrize("seed", range(15))
def test_fuzzed_actor_trees_complete(seed):
    def one_run(s_):
        fl.set_seed(s_)
        sched = fl.Scheduler(virtual=True)
        fl.set_scheduler(sched)
        try:
            rng = fl.g_random
            results = []

            async def main():
                for _ in range(8):
                    factory = _build_random_actor(rng)
                    results.append(await fl.spawn(factory()))
                return True

            t = sched.spawn(main())
            assert sched.run(until=t, timeout_time=60)
            return (results, sched.tasks_run, sched.now())
        finally:
            fl.set_scheduler(None)

    a = one_run(5000 + seed)
    b = one_run(5000 + seed)
    assert a == b, "seed replay diverged"
