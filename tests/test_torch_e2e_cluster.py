"""The reference's end-to-end cluster cases (tests/test_e2e_cluster.py)
on the port's SimCluster, its `tpu` case on `cuda` at `device="cpu"`.
End-to-end simulated cluster: the minimum slice running real
transactions through master -> proxy -> resolver -> tlog -> storage on
the deterministic loop (ref test strategy: whole-system simulation,
fdbserver/SimulatedCluster.actor.cpp; workload models: Cycle.actor.cpp,
Increment.actor.cpp, WriteDuringRead.actor.cpp)."""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.client import run_transaction  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402


@pytest.fixture
def cluster():
    c = SimCluster(seed=1)
    yield c
    c.shutdown()


def test_set_get_commit(cluster):
    db = cluster.client()

    async def main():
        tr = db.create_transaction()
        tr.set(b"hello", b"world")
        v = await tr.commit()
        assert v > 0
        tr2 = db.create_transaction()
        got = await tr2.get(b"hello")
        assert got == b"world"
        assert await tr2.get(b"missing") is None
        return True

    assert cluster.run(main(), timeout_time=30)


def test_read_your_writes(cluster):
    db = cluster.client()

    async def main():
        tr = db.create_transaction()
        tr.set(b"a", b"1")
        assert await tr.get(b"a") == b"1"          # uncommitted write visible
        tr.clear(b"a")
        assert await tr.get(b"a") is None
        tr.set(b"b", b"2")
        tr.set(b"d", b"4")
        tr.clear_range(b"c", b"e")
        tr.set(b"d2", b"5")
        got = await tr.get_range(b"a", b"z")
        assert got == [(b"b", b"2"), (b"d2", b"5")]
        await tr.commit()
        tr2 = db.create_transaction()
        assert await tr2.get_range(b"a", b"z") == [(b"b", b"2"), (b"d2", b"5")]
        return True

    assert cluster.run(main(), timeout_time=30)


def test_conflicting_transactions(cluster):
    """Reader's snapshot invalidated by a concurrent write -> not_committed,
    then the retry loop succeeds (ref: OCC contract)."""
    db = cluster.client()

    async def main():
        setup = db.create_transaction()
        setup.set(b"k", b"0")
        await setup.commit()

        t1 = db.create_transaction()
        t2 = db.create_transaction()
        v1 = await t1.get(b"k")
        v2 = await t2.get(b"k")
        assert v1 == v2 == b"0"
        t1.set(b"k", b"t1")
        t2.set(b"k", b"t2")
        await t1.commit()
        with pytest.raises(flow.FdbError) as ei:
            await t2.commit()
        assert ei.value.name == "not_committed"
        return True

    assert cluster.run(main(), timeout_time=30)


def test_snapshot_reads_do_not_conflict(cluster):
    db = cluster.client()

    async def main():
        setup = db.create_transaction()
        setup.set(b"k", b"0")
        await setup.commit()
        t1 = db.create_transaction()
        t2 = db.create_transaction()
        await t1.get(b"k", snapshot=True)
        await t2.get(b"k")
        t1.set(b"k", b"t1")
        t2.set(b"other", b"x")
        await t2.commit()
        await t1.commit()  # snapshot read: no conflict
        return True

    assert cluster.run(main(), timeout_time=30)


def test_increment_workload(cluster):
    """N concurrent clients increment shared counters; the sum must equal
    the number of successful increments (ref: Increment.actor.cpp)."""
    dbs = [cluster.client(f"client{i}") for i in range(5)]
    done = []

    async def incr_loop(db, n):
        for _ in range(n):
            async def body(tr):
                k = b"ctr%d" % (flow.g_random.random_int(0, 3),)
                cur = await tr.get(k)
                tr.set(k, b"%d" % (int(cur or b"0") + 1))
            await run_transaction(db, body)
            done.append(1)

    async def main():
        tasks = [flow.spawn(incr_loop(db, 10)) for db in dbs]
        await flow.wait_for_all(tasks)
        tr = dbs[0].create_transaction()
        kvs = await tr.get_range(b"ctr", b"cts")
        total = sum(int(v) for _, v in kvs)
        assert total == 50, (total, kvs)
        return True

    assert cluster.run(main(), timeout_time=120)


def test_cycle_workload(cluster):
    """The Cycle invariant: keys form a permutation cycle; transactions
    rotate pointers; the cycle stays intact (ref: Cycle.actor.cpp)."""
    n = 8
    db = cluster.client()
    dbs = [cluster.client(f"c{i}") for i in range(3)]

    async def setup():
        tr = db.create_transaction()
        for i in range(n):
            tr.set(b"cyc%02d" % i, b"%02d" % ((i + 1) % n))
        await tr.commit()

    async def swap_loop(db, iters):
        for _ in range(iters):
            async def body(tr):
                # pick a random node a -> b -> c -> d; swap b and c
                a = flow.g_random.random_int(0, n - 1)
                b = int(await tr.get(b"cyc%02d" % a))
                c = int(await tr.get(b"cyc%02d" % b))
                d = int(await tr.get(b"cyc%02d" % c))
                tr.set(b"cyc%02d" % a, b"%02d" % c)
                tr.set(b"cyc%02d" % c, b"%02d" % b)
                tr.set(b"cyc%02d" % b, b"%02d" % d)
            await run_transaction(db, body)

    async def check():
        tr = db.create_transaction()
        kvs = await tr.get_range(b"cyc", b"cyd")
        assert len(kvs) == n
        nxt = {int(k[3:]): int(v) for k, v in kvs}
        seen, cur = set(), 0
        while cur not in seen:
            seen.add(cur)
            cur = nxt[cur]
        assert len(seen) == n, f"cycle broken: {nxt}"

    async def main():
        await setup()
        await flow.wait_for_all([flow.spawn(swap_loop(d, 8)) for d in dbs])
        await check()
        return True

    assert cluster.run(main(), timeout_time=240)


def test_random_ops_vs_model():
    """Sequential random transactions cross-checked against a model dict
    (ref: WriteDuringRead.actor.cpp memoryDatabase replay)."""
    c = SimCluster(seed=7)
    try:
        db = c.client()
        model = {}

        async def main():
            rng = flow.g_random
            for _round in range(40):
                tr = db.create_transaction()
                staged = dict(model)
                for _op in range(rng.random_int(1, 6)):
                    op = rng.random_int(0, 3)
                    k = b"%c" % (0x61 + rng.random_int(0, 9))
                    if op == 0:
                        v = b"v%d" % rng.random_int(0, 99)
                        tr.set(k, v)
                        staged[k] = v
                    elif op == 1:
                        tr.clear(k)
                        staged.pop(k, None)
                    elif op == 2:
                        got = await tr.get(k)
                        assert got == staged.get(k), (k, got, staged.get(k))
                    else:
                        e = b"%c" % (0x61 + rng.random_int(0, 9))
                        if k > e:
                            k, e = e, k
                        got = await tr.get_range(k, e)
                        want = sorted((kk, vv) for kk, vv in staged.items()
                                      if k <= kk < e)
                        assert got == want, (k, e, got, want)
                await tr.commit()
                model.clear()
                model.update(staged)
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_clogged_network_still_correct():
    c = SimCluster(seed=3)
    try:
        db = c.client()

        async def main():
            tr = db.create_transaction()
            tr.set(b"x", b"1")
            await tr.commit()
            # clog links between worker machines mid-run
            c.net.clog_pair("w0", "w1", 2.0)
            c.net.clog_pair("w0", "w2", 1.0)
            tr2 = db.create_transaction()
            tr2.set(b"x", b"2")
            await tr2.commit()
            tr3 = db.create_transaction()
            assert await tr3.get(b"x") == b"2"
            return True

        assert c.run(main(), timeout_time=60)
    finally:
        c.shutdown()


def test_determinism_same_seed_same_schedule():
    """Seed replay: identical task counts, versions, and message counts
    (the determinism oracle, ref: sim2 + DeterministicRandom)."""

    def one_run(seed):
        c = SimCluster(seed=seed)
        try:
            dbs = [c.client(f"c{i}") for i in range(3)]

            async def incr(db, n):
                for _ in range(n):
                    async def body(tr):
                        cur = await tr.get(b"k")
                        tr.set(b"k", b"%d" % (int(cur or b"0") + 1))
                    await run_transaction(db, body)

            async def main():
                await flow.wait_for_all(
                    [flow.spawn(incr(db, 5)) for db in dbs])
                tr = dbs[0].create_transaction()
                val = await tr.get(b"k")
                return (val, c.sched.now(), c.sched.tasks_run,
                        c.net.messages_sent)

            return c.run(main(), timeout_time=120)
        finally:
            c.shutdown()

    a = one_run(42)
    b = one_run(42)
    d = one_run(43)
    assert a == b, f"seed replay diverged: {a} != {b}"
    assert a[0] == b"15" == d[0]
    assert a != d  # different seed explores a different schedule


@pytest.mark.parametrize("backend", ["cuda", "native"])
def test_cluster_with_accelerated_resolver(backend):
    """The same cluster with the CUDA (and native C++) conflict backend
    plugged into the resolver role — the plugin seam working end-to-end
    (ref: LoadPlugin boundary; backend parity is separately fuzzed)."""
    if backend == "native":
        from foundationdb_tpu_torch.models import native_available
        if not native_available():
            pytest.skip("native backend unavailable")
    c = SimCluster(seed=11, conflict_backend=backend, device="cpu")
    try:
        db = c.client()

        async def main():
            setup = db.create_transaction()
            setup.set(b"k", b"0")
            await setup.commit()
            t1 = db.create_transaction()
            t2 = db.create_transaction()
            assert await t1.get(b"k") == b"0"
            assert await t2.get(b"k") == b"0"
            t1.set(b"k", b"t1")
            t2.set(b"k", b"t2")
            await t1.commit()
            try:
                await t2.commit()
                raise AssertionError("expected not_committed")
            except flow.FdbError as e:
                assert e.name == "not_committed"
            # and the retry loop converges
            for i in range(10):
                async def body(tr, i=i):
                    cur = await tr.get(b"k")
                    tr.set(b"k", cur + b".%d" % i)
                await run_transaction(db, body)
            tr = db.create_transaction()
            final = await tr.get(b"k")
            assert final == b"t1" + b"".join(b".%d" % i for i in range(10))
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_multi_resolver_cluster():
    """Key-range split across 3 resolver roles with min-combined verdicts
    (ref: ResolutionRequestBuilder / combine at :585-592): same outcomes
    as single-resolver, including cross-shard conflict ranges."""
    c = SimCluster(seed=17, n_resolvers=3)
    try:
        db = c.client()

        async def main():
            tr = db.create_transaction()
            # keys on different resolver shards (split at 0x55, 0xaa)
            tr.set(b"\x10a", b"1")
            tr.set(b"\x80b", b"2")
            tr.set(b"\xf0c", b"3")
            await tr.commit()
            # cross-shard range read conflicts with a write on shard 2
            t1 = db.create_transaction()
            t2 = db.create_transaction()
            got = await t1.get_range(b"\x00", b"\xff")
            assert len(got) == 3
            await t2.get(b"\x80b")
            t1.set(b"sentinel", b"x")
            t2.set(b"\x10a", b"22")
            await t2.commit()   # invalidates t1's range read
            try:
                await t1.commit()
                raise AssertionError("expected not_committed")
            except flow.FdbError as e:
                assert e.name == "not_committed"
            # increments across shards still converge
            for i in range(6):
                async def body(tr, i=i):
                    k = bytes([40 * i]) + b"k"
                    cur = await tr.get(k)
                    tr.set(k, b"%d" % (int(cur or b"0") + 1))
                await run_transaction(db, body)
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_long_key_rejected_batch_does_not_wedge_cluster():
    """With the cuda conflict backend, a key wider
    than the backend's key bucket used to raise inside the resolver
    actor, dropping the reply and wedging every later batch. Now the
    batch is conflicted (clients retry/fail) and the pipeline advances."""
    c = SimCluster(seed=31, conflict_backend="cuda", device="cpu")
    try:
        db = c.client()

        async def main():
            async def good(tr):
                tr.set(b"ok1", b"v")
            await run_transaction(db, good)

            # wider than the 32-byte cuda bucket: must fail, not wedge
            tr = db.create_transaction()
            tr.set(b"x" * 64, b"v")
            rejected = False
            try:
                await tr.commit()
            except flow.FdbError:
                rejected = True
            assert rejected

            # the pipeline must still be live for later transactions
            async def after(tr):
                tr.set(b"ok2", b"w")
            await run_transaction(db, after)

            async def check(tr):
                return (await tr.get(b"ok1"), await tr.get(b"ok2"))
            assert await run_transaction(db, check) == (b"v", b"w")
            return True

        assert c.run(main(), timeout_time=60)
    finally:
        c.shutdown()


def test_range_limit_clamps_read_conflict():
    """A limited range read only conflicts on the portion actually
    observed (recording the full [begin,end) would produce spurious
    conflicts)."""
    c = SimCluster(seed=32)
    try:
        db = c.client()

        async def main():
            async def seed_data(tr):
                for i in range(5):
                    tr.set(b"rl%02d" % i, b"v")
            await run_transaction(db, seed_data)

            # reader observes only the first row of the range...
            tr = db.create_transaction()
            rows = await tr.get_range(b"rl", b"rm", limit=1)
            assert [k for k, _ in rows] == [b"rl00"]
            # ...while a concurrent write lands far past the observed key
            tr2 = db.create_transaction()
            tr2.set(b"rl04", b"clobber")
            await tr2.commit()
            tr.set(b"unrelated", b"x")
            await tr.commit()  # must NOT conflict

            # control: observing the written key does conflict
            tr3 = db.create_transaction()
            await tr3.get_range(b"rl", b"rm", limit=5)
            tr4 = db.create_transaction()
            tr4.set(b"rl02", b"c2")
            await tr4.commit()
            tr3.set(b"unrelated2", b"y")
            try:
                await tr3.commit()
            except flow.FdbError as e:
                return e.name
            return "committed"

        assert c.run(main(), timeout_time=60) == "not_committed"
    finally:
        c.shutdown()


def test_tlog_tolerates_reordered_pushes():
    """The proxy releases its logging interlock at push time, so two
    TLogCommitRequests can be in flight and the network may deliver the
    LATER one first. The TLog must sequence them via queue_version
    without wedging (a serial commit loop would deadlock here)."""
    from foundationdb_tpu_torch.server.tlog import TLog
    from foundationdb_tpu_torch.server.types import (TLogCommitRequest, MutationRef,
                                           SET_VALUE, TaggedMutation)

    import foundationdb_tpu_torch.flow as fl
    from foundationdb_tpu_torch.rpc import SimNetwork

    s = fl.Scheduler(virtual=True)
    fl.set_scheduler(s)
    try:
        net = SimNetwork(s, fl.g_random)
        proc = net.new_process("tlog", machine="m")
        tlog = TLog(proc)
        tlog.start()

        async def main():
            m = (TaggedMutation((0,), MutationRef(SET_VALUE, b"k", b"v")),)
            # deliver the SECOND batch first
            f2 = tlog.commits.ref().get_reply(
                TLogCommitRequest(100, 200, m), proc)
            await fl.delay(0.01)
            f1 = tlog.commits.ref().get_reply(
                TLogCommitRequest(0, 100, m), proc)
            v2 = await f2
            v1 = await f1
            assert v1 >= 100 and v2 >= 200
            assert [v for v, _m, _s in tlog.entries] == [100, 200]
            return True

        t = s.spawn(main())
        assert s.run(until=t, timeout_time=10)
    finally:
        fl.set_scheduler(None)


def test_commit_batches_close_on_byte_limit():
    """COMMIT_TRANSACTION_BATCH_BYTES_MAX bounds batch payloads: large
    transactions still commit correctly when every batch closes early."""
    c = SimCluster(seed=95)
    flow.SERVER_KNOBS.init("COMMIT_TRANSACTION_BATCH_BYTES_MAX", 2048)
    try:
        db = c.client()

        async def main():
            big = b"B" * 900
            async def body(tr):
                for i in range(8):
                    tr.set(b"byte%02d" % i, big)
            await run_transaction(db, body)

            async def check(tr):
                rows = await tr.get_range(b"byte", b"bytf")
                assert len(rows) == 8
                assert all(v == big for _k, v in rows)
            await run_transaction(db, check)
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()
        flow.reset_server_knobs()


def test_resolver_state_pressure_is_surfaced():
    """A conflict history beyond RESOLVER_STATE_MEMORY_LIMIT (rows,
    here) raises the ResolverStatePressure trace — the GC-behind red
    flag (ref: Resolver.actor.cpp memory back-pressure)."""
    c = SimCluster(seed=96)
    flow.SERVER_KNOBS.init("RESOLVER_STATE_MEMORY_LIMIT", 50)
    try:
        db = c.client()

        async def main():
            async def body(tr):
                for i in range(200):
                    tr.set(b"pr%04d" % i, b"x")
            await run_transaction(db, body)
            for _ in range(40):
                if flow.g_trace.counts.get("ResolverStatePressure", 0):
                    return True
                async def more(tr):
                    tr.set(b"prx", b"y")
                await run_transaction(db, more)
                await flow.delay(0.2)
            raise AssertionError("pressure never traced")

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()
        flow.reset_server_knobs()


def test_sim_validation_catches_broken_maps():
    """The always-on validator (ref: sim_validation.cpp) fails fast on
    a gapped shard map, duplicate tags, or a regressed epoch — and its
    live instance has actually been checking this cluster."""
    from foundationdb_tpu_torch.server.sim_validation import validate_dbinfo

    c = SimCluster(seed=97, n_storage=2)
    try:
        db = c.client()

        async def main():
            await db.info()
            info = c.cc.dbinfo.get()
            validate_dbinfo(info, {})   # the real picture passes

            dup = info._replace(storages=(
                info.storages[0],
                info.storages[1]._replace(tag=info.storages[0].tag)))
            with pytest.raises(AssertionError, match="duplicate"):
                validate_dbinfo(dup, {})

            with pytest.raises(AssertionError, match="seq"):
                validate_dbinfo(info, {"seq": info.seq})

            with pytest.raises(AssertionError, match="epoch"):
                validate_dbinfo(info, {"epoch": info.epoch + 1})

            # THIS cluster's validator is live: it observed the current
            # broadcast sequence (per-cluster state, not a global)
            assert c.validator_state.get("seq") == c.cc.dbinfo.get().seq
            assert c.validator_state.get("checked", 0) > 0
            return True

        assert c.run(main(), timeout_time=60)

        # e2e: a BROKEN publish mid-run fails the simulation itself —
        # the live validator's error surfaces through c.run
        async def poison():
            info = c.cc.dbinfo.get()
            gapped = info._replace(storages=(
                info.storages[0]._replace(end=b"\x40", replicas=tuple(
                    r._replace(end=b"\x40")
                    for r in info.storages[0].replicas)),
                info.storages[1]))
            c.cc.publish(gapped)
            await flow.delay(1.0)
            return True

        with pytest.raises(AssertionError, match="gap"):
            c.run(poison(), timeout_time=30)
    finally:
        c.shutdown()


def test_abandoned_watches_expire():
    """A watch nobody is waiting on (client gone) expires after
    WATCH_TIMEOUT instead of pinning the storage watch map forever
    (ref: the database watch timeout)."""
    c = SimCluster(seed=98)
    flow.SERVER_KNOBS.init("WATCH_TIMEOUT", 5.0)
    try:
        db = c.client()

        async def main():
            tr = db.create_transaction()
            await tr.get(b"wexp")
            w = tr.watch(b"wexp")
            await tr.commit()
            # nothing ever writes the key; the registration must expire
            with pytest.raises(flow.FdbError) as ei:
                await flow.timeout_error(w, 120.0)
            assert ei.value.name == "timed_out"
            info = c.cc.dbinfo.get()
            for s in info.storages:
                for rep in s.replicas:
                    obj = c.cc._storage_objs[rep.name]
                    assert not obj._watch_map, obj._watch_map
            return True

        assert c.run(main(), timeout_time=300)
    finally:
        c.shutdown()
