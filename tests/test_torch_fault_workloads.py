"""The reference's cases of tests/test_fault_workloads.py on the port's
SimCluster.

Stacked fault workloads across many seeds: correctness workloads run
WHILE roles die, links clog, and BUGGIFY distorts timings — the
reference's core test strategy (ref: tests/fast/CycleTest.txt stacking
Cycle + Attrition + RandomClogging; fdbrpc/sim2.actor.cpp:1222-1406;
flow/Knobs.cpp BUGGIFY randomization).
"""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.client import run_transaction  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402
from foundationdb_tpu_torch.server.consistency import check_consistency  # noqa: E402

N = 6  # cycle length


async def _cycle_setup(db):
    tr = db.create_transaction()
    for i in range(N):
        tr.set(b"cyc%02d" % i, b"%02d" % ((i + 1) % N))
    await tr.commit()


async def _cycle_swaps(db, iters):
    for _ in range(iters):
        async def body(tr):
            a = flow.g_random.random_int(0, N)
            b = int(await tr.get(b"cyc%02d" % a))
            c = int(await tr.get(b"cyc%02d" % b))
            d = int(await tr.get(b"cyc%02d" % c))
            tr.set(b"cyc%02d" % a, b"%02d" % c)
            tr.set(b"cyc%02d" % c, b"%02d" % b)
            tr.set(b"cyc%02d" % b, b"%02d" % d)
        await run_transaction(db, body, max_retries=500)


async def _cycle_check(db):
    async def check(tr):
        kvs = await tr.get_range(b"cyc", b"cyd")
        assert len(kvs) == N, kvs
        nxt = {int(k[3:]): int(v) for k, v in kvs}
        seen, cur = set(), 0
        while cur not in seen:
            seen.add(cur)
            cur = nxt[cur]
        assert len(seen) == N, f"cycle broken: {nxt}"
    await run_transaction(db, check, max_retries=200)


async def _attrition(c, kills, machines):
    """Random role kills + link clogs, spaced so recovery can make
    progress between faults (ref: MachineAttrition + RandomClogging)."""
    rng = flow.g_random
    for _ in range(kills):
        await flow.delay(0.2 + rng.random01() * 0.4)
        op = rng.random_int(0, 6)
        try:
            if op == 0:
                c.kill_role("tlog")
            elif op == 1:
                c.kill_role("proxy")
            elif op == 2:
                c.kill_role("resolver")
            elif op == 3:
                c.kill_role("storage")
            else:
                a = machines[rng.random_int(0, len(machines))]
                b = machines[rng.random_int(0, len(machines))]
                c.net.clog_pair(a, b, rng.random01() * 0.5)
        except KeyError:
            pass  # nothing of that kind alive right now


@pytest.mark.parametrize("seed", range(20))
def test_cycle_survives_attrition(seed):
    """20 seeds of Cycle + attrition + BUGGIFY on a durable cluster."""
    c = SimCluster(seed=1000 + seed, durable=True, buggify=True,
                   n_workers=5)
    try:
        db = c.client()
        dbs = [c.client(f"c{i}") for i in range(2)]
        machines = [f"w{i}" for i in range(c.n_workers)]

        async def main():
            await _cycle_setup(db)
            tasks = [flow.spawn(_cycle_swaps(d, 5)) for d in dbs]
            tasks.append(flow.spawn(_attrition(c, 2, machines)))
            await flow.wait_for_all(tasks)
            await _cycle_check(db)
            # post-workload replica sweep (ref: tester.actor.cpp:741
            # running ConsistencyCheck after sim tests)
            await check_consistency(c)
            return True

        assert c.run(main(), timeout_time=900)
    finally:
        c.shutdown()


@pytest.mark.parametrize("backend,seed,device", [
    ("cuda", 4101, "cpu"), ("cuda-point", 4102, "cpu"),
    ("sharded-cuda", 4103, "cpu"),
    pytest.param("cuda", 4101, None, marks=pytest.mark.cuda,
                 id="cuda-card"),
    pytest.param("cuda-point", 4102, None, marks=pytest.mark.cuda,
                 id="cuda-point-card"),
    pytest.param("sharded-cuda", 4103, None, marks=pytest.mark.cuda,
                 id="sharded-cuda-card")])
def test_cycle_survives_device_faults_mid_pipeline(backend, seed, device):
    """Stacked device faults into an accelerator-backed cluster: the
    resolve pipeline runs 4 deep under BUGGIFY while the fault injector
    fires at the submit/materialize/drain seams with seeded
    probability, frequent checkpoints keep the replay log short, and
    shadow validation cross-checks sampled batches throughout. The
    cycle invariant and a full consistency sweep must hold after the
    failover machinery has been exercised — and the shadow must have
    found NOTHING (the device backends are honest; only the fault
    timing is hostile)."""
    if device is None and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = SimCluster(seed=seed, durable=True, buggify=True, n_workers=5,
                   conflict_backend=backend, device=device)
    # knobs AFTER SimCluster re-randomizes them: a 4-deep pipeline with
    # faults mid-window is the scenario under test
    knob_names = ("resolve_pipeline_depth", "device_fault_injection",
                  "conflict_checkpoint_versions", "shadow_resolve_sample")
    prev_knobs = {n: getattr(flow.SERVER_KNOBS, n) for n in knob_names}
    flow.SERVER_KNOBS.set("resolve_pipeline_depth", 4)
    flow.SERVER_KNOBS.set("device_fault_injection", 0.03)
    flow.SERVER_KNOBS.set("conflict_checkpoint_versions", 150_000)
    flow.SERVER_KNOBS.set("shadow_resolve_sample", 3)
    try:
        db = c.client()

        async def main():
            await _cycle_setup(db)
            await _cycle_swaps(db, 8)
            await _cycle_check(db)
            # post-workload replica sweep (ref: tester.actor.cpp:741)
            await check_consistency(c)
            status = await db.get_status()
            return status

        status = c.run(main(), timeout_time=900)
        # the machinery actually ran: every resolver reports failover
        # accounting, sampled shadow batches, zero mismatches
        resolvers = status["cluster"]["resolvers"]
        assert resolvers
        for r in resolvers:
            fo = r["failover"]
            assert fo, "device backend not wrapped"
            assert fo["shadow"]["mismatches"] == 0, fo
            assert fo["shadow"]["errors"] == 0, fo
        assert not any(m["name"] == "shadow_resolve_mismatch"
                       for m in status["cluster"]["messages"])
    finally:
        for n, v in prev_knobs.items():
            flow.SERVER_KNOBS.set(n, v)
        c.shutdown()


@pytest.mark.parametrize("seed", [3, 11])
def test_replicated_sharded_cycle_attrition(seed):
    """The full shape (2 logs, 2 shards, 2 resolvers) under attrition."""
    c = SimCluster(seed=2000 + seed, durable=True, buggify=True,
                   n_logs=2, n_storage=2, n_resolvers=2, n_workers=6)
    try:
        db = c.client()
        machines = [f"w{i}" for i in range(c.n_workers)]

        async def main():
            await _cycle_setup(db)
            tasks = [flow.spawn(_cycle_swaps(db, 6))]
            tasks.append(flow.spawn(_attrition(c, 3, machines)))
            await flow.wait_for_all(tasks)
            await _cycle_check(db)
            # post-workload replica sweep (ref: tester.actor.cpp:741
            # running ConsistencyCheck after sim tests)
            await check_consistency(c)
            return True

        assert c.run(main(), timeout_time=900)
    finally:
        c.shutdown()


@pytest.mark.parametrize("seed", [5, 17])
def test_marker_exactness_under_kills(seed):
    """Atomic all-or-nothing commits under faults: each transaction
    writes a unique marker + increments a counter; on
    commit_unknown_result the client re-reads the marker to learn the
    outcome (the reference's idempotency pattern). The final counter
    must equal the number of markers present."""
    c = SimCluster(seed=3000 + seed, durable=True, buggify=True,
                   n_workers=5)
    try:
        db = c.client()

        async def main():
            applied = 0
            for i in range(15):
                marker = b"mark%04d" % i
                tr = db.create_transaction()
                committed = None
                for _attempt in range(100):
                    try:
                        cur = int(await tr.get(b"counter") or b"0")
                        tr.set(b"counter", b"%d" % (cur + 1))
                        tr.set(marker, b"1")
                        await tr.commit()
                        committed = True
                        break
                    except flow.FdbError as e:
                        if e.name == "commit_unknown_result":
                            # did it actually apply?
                            async def probe(tr2, marker=marker):
                                return await tr2.get(marker)
                            got = await run_transaction(db, probe,
                                                        max_retries=200)
                            if got is not None:
                                committed = True
                                break
                            await tr.on_error(e)
                        else:
                            await tr.on_error(e)
                assert committed is not None, "txn never decided"
                applied += 1
                if i in (4, 9):
                    try:
                        c.kill_role("tlog" if i == 4 else "proxy")
                    except KeyError:
                        pass

            async def check(tr):
                n = int(await tr.get(b"counter") or b"0")
                marks = await tr.get_range(b"mark", b"marl")
                assert n == len(marks) == applied, (n, len(marks), applied)
            await run_transaction(db, check, max_retries=200)
            return True

        assert c.run(main(), timeout_time=900)
    finally:
        c.shutdown()


@pytest.mark.parametrize("seed", range(10))
def test_random_cluster_shapes_survive_attrition(seed):
    """Per-seed random cluster shape — replication, shard count,
    resolvers, proxies, engine, buggify — running Cycle + attrition
    (ref: SimulationConfig::generateNormalConfig,
    SimulatedCluster.actor.cpp:782: random cluster shapes per seed are
    the reference's way of covering the configuration space)."""
    import random as _random

    shape_rng = _random.Random(9000 + seed)
    kw = {
        "durable": True,
        "buggify": shape_rng.random() < 0.5,
        "n_logs": shape_rng.choice([1, 2, 3]),
        "n_storage": shape_rng.choice([1, 2, 3]),
        "n_resolvers": shape_rng.choice([1, 2]),
        "n_proxies": shape_rng.choice([1, 2]),
        "storage_engine": shape_rng.choice(["memory", "btree"]),
    }
    kw["n_workers"] = max(5, kw["n_logs"] + 2, kw["n_storage"] + 1)
    c = SimCluster(seed=9000 + seed, **kw)
    try:
        db = c.client()
        machines = [f"w{i}" for i in range(c.n_workers)]

        async def main():
            await _cycle_setup(db)
            tasks = [flow.spawn(_cycle_swaps(db, 5))]
            tasks.append(flow.spawn(_attrition(c, 2, machines)))
            await flow.wait_for_all(tasks)
            await _cycle_check(db)
            # post-workload replica sweep (ref: tester.actor.cpp:741
            # running ConsistencyCheck after sim tests)
            await check_consistency(c)
            return True

        assert c.run(main(), timeout_time=900), kw
    finally:
        c.shutdown()


@pytest.mark.parametrize("seed", (3301, 3302, 3303))
def test_dd_split_merge_vacate_under_attrition(seed):
    """Data distribution's structural operations — shard SPLITS (fresh
    tags), exclusion VACATES, and cold MERGES — racing role kills and
    link clogs: every acknowledged write survives, and the published
    shard map stays contiguous with unique tags throughout (ref:
    moveKeys + MachineAttrition stacked, the reference's DD churn
    coverage)."""
    c = SimCluster(seed=seed, durable=True, n_storage=1, n_workers=7)
    flow.SERVER_KNOBS.init("DD_SHARD_SPLIT_BYTES", 1000)
    try:
        db = c.client()
        machines = [f"w{i}" for i in range(c.n_workers)]

        def check_map():
            info = c.cc.dbinfo.get()
            tags = [s.tag for s in info.storages]
            assert len(set(tags)) == len(tags), tags
            assert info.storages[0].begin == b""
            assert info.storages[-1].end is None
            for i in range(len(info.storages) - 1):
                assert info.storages[i].end == \
                    info.storages[i + 1].begin, info.storages

        async def main():
            acked = {}

            async def writer(lo, hi):
                for i in range(lo, hi):
                    k, v = b"dd%05d" % i, b"v%d" % i

                    async def body(tr, k=k, v=v):
                        tr.set(k, v)
                    await run_transaction(db, body, max_retries=500)
                    acked[k] = v

            # phase 1: grow a hot shard while killing things — splits
            # happen mid-attrition
            at = flow.spawn(_attrition(c, 6, machines))
            await writer(0, 300)
            await at
            for _ in range(120):
                await flow.delay(0.5)
                check_map()
                if len(c.cc.dbinfo.get().storages) >= 2:
                    break
            else:
                raise AssertionError("no split under attrition")

            # phase 2: exclude a storage-hosting worker mid-churn
            info = c.cc.dbinfo.get()
            victim = None
            for name, wi in c.cc.workers.items():
                if any(rn.startswith("storage") for rn in wi.worker.roles) \
                        and wi.worker.process.alive:
                    victim = name
                    break
            if victim is not None:
                try:
                    await db.exclude(victim)
                except flow.FdbError:
                    pass   # refused exclusions (too few workers) are fine
                at = flow.spawn(_attrition(c, 4, machines))
                await writer(300, 380)
                await at
                if victim in c.cc.excluded:
                    for _ in range(240):
                        await flow.delay(0.5)
                        check_map()
                        hosts = {w for w, wi in c.cc.workers.items()
                                 for s in c.cc.dbinfo.get().storages
                                 for r in s.replicas
                                 if r.name in wi.worker.roles}
                        if victim not in hosts:
                            break
                    else:
                        raise AssertionError("vacate stalled")
                    await db.exclude(victim, exclude=False)

            # phase 3: cool the keyspace — merges fold shards back
            async def wipe(tr):
                tr.clear_range(b"dd", b"de")
            await run_transaction(db, wipe, max_retries=500)
            acked.clear()

            async def keep(tr):
                tr.set(b"keep", b"1")
            await run_transaction(db, keep, max_retries=500)
            for _ in range(240):
                await flow.delay(0.5)
                check_map()
                if len(c.cc.dbinfo.get().storages) == 1:
                    break
            # merge-back is best-effort under churn; the map must still
            # be consistent and every surviving key correct either way
            check_map()

            async def check(tr):
                assert await tr.get(b"keep") == b"1"
                rows = await tr.get_range(b"dd", b"de")
                assert rows == sorted(acked.items()), (
                    len(rows), len(acked))
            await run_transaction(db, check, max_retries=500)
            return True

        assert c.run(main(), timeout_time=1200)
    finally:
        c.shutdown()


@pytest.mark.parametrize("seed", (3401, 3402))
def test_dd_churn_with_buggify(seed):
    """The DD structural operations under BUGGIFY: randomized knobs
    (tiny batch windows, distorted thresholds) + injected delays while
    shards split and roles die (ref: BUGGIFY as the chaos amplifier in
    every simulation run)."""
    c = SimCluster(seed=seed, durable=True, n_storage=1, n_workers=6,
                   buggify=True)
    flow.SERVER_KNOBS.init("DD_SHARD_SPLIT_BYTES", 900)
    try:
        db = c.client()
        machines = [f"w{i}" for i in range(c.n_workers)]

        async def main():
            acked = {}
            at = flow.spawn(_attrition(c, 4, machines))
            for i in range(200):
                async def body(tr, i=i):
                    tr.set(b"bg%05d" % i, b"v%d" % i)
                await run_transaction(db, body, max_retries=800)
                acked[b"bg%05d" % i] = b"v%d" % i
            await at
            for _ in range(200):
                await flow.delay(0.5)
                info = c.cc.dbinfo.get()
                tags = [s.tag for s in info.storages]
                assert len(set(tags)) == len(tags)
                if len(info.storages) >= 2:
                    break

            async def check(tr):
                rows = await tr.get_range(b"bg", b"bh")
                assert rows == sorted(acked.items()), (
                    len(rows), len(acked))
            await run_transaction(db, check, max_retries=800)
            return True

        assert c.run(main(), timeout_time=1800)
    finally:
        c.shutdown()


@pytest.mark.parametrize("seed", (3501, 3502))
def test_multikey_atomicity_under_attrition(seed):
    """Writers update a GROUP of keys to the same stamp in one
    transaction while readers continuously assert the group is always
    internally consistent — atomicity is never violated even while
    roles die and links clog (ref: the Atomic*/WriteDuringRead family
    of consistency workloads)."""
    c = SimCluster(seed=seed, durable=True, n_logs=2, n_storage=2,
                   n_workers=6)
    try:
        writer_db = c.client("writer")
        reader_db = c.client("reader")
        machines = [f"w{i}" for i in range(c.n_workers)]
        GROUP = [b"atom/a", b"atom/b", b"atom/c"]

        async def main():
            async def init(tr):
                for k in GROUP:
                    tr.set(k, b"stamp0")
            await run_transaction(writer_db, init, max_retries=500)

            stop = [False]
            checked = [0]

            async def writer():
                i = 1
                while not stop[0]:
                    async def body(tr, i=i):
                        for k in GROUP:
                            tr.set(k, b"stamp%d" % i)
                    await run_transaction(writer_db, body, max_retries=800)
                    i += 1
                    await flow.delay(0.01)

            async def reader():
                while not stop[0]:
                    async def body(tr):
                        vals = [await tr.get(k) for k in GROUP]
                        assert len(set(vals)) == 1, vals  # all-or-nothing
                    await run_transaction(reader_db, body, max_retries=800)
                    checked[0] += 1
                    await flow.delay(0.01)

            w = flow.spawn(writer())
            r = flow.spawn(reader())
            await _attrition(c, 6, machines)
            await flow.delay(1.0)
            stop[0] = True
            await flow.wait_for_all([w, r])
            assert checked[0] > 20, checked[0]
            return True

        assert c.run(main(), timeout_time=1200)
    finally:
        c.shutdown()
