"""The reference's cases of tests/test_storm_vectorized.py on the port's
SimCluster and `tools/simprof.py` (the million-client cell keeps the
reference's `slow` mark).

Simulator hot-path overhaul: vectorized storm schedules,
pooled client actors, the coalesced-timer helper, the lean timer path,
and the typed bare-payload envelopes.

What is pinned here, in order:

- **Schedule determinism**: a storm's vectorized schedule is a pure
  function of its seed — drawing it twice (same-seeded flow RNG)
  yields byte-identical arrival/key/flag arrays, a different seed a
  different schedule, and searchsorted inversion matches the scalar
  zipf_rank bisect rank-for-rank.
- **Same-seed replay for every refactored storm**: two fresh clusters
  on one seed produce identical outcome counts, identical keyspace
  digests, identical run-loop step and network message counts —
  OpenLoopStorm, ContentionStorm, OverloadStorm (the replay oracle,
  re-pinned across the vectorized/pooled code path).

  Re-baseline note (the one-time schedule move): the pre-refactor
  per-arrival path drew every decision from the SHARED flow RNG,
  interleaved with the network's latency draws — committed as
  SIMPERF_r01.json's deterministic columns (open_loop 30095 steps /
  3923 msgs, contention 52730 / 8624, overload 83374 / 4845 at the
  same seeds). A schedule drawn up front in one pass cannot reproduce
  that interleaving by construction, so those recorded values moved
  once (r02 records the new ones); what this file pins is the oracle
  that must NEVER move again — same seed => same storm, bit-exact.
- **Pooled client actors**: the worker pool reuses at most
  `max_inflight` workers across all arrivals (spawn count == peak
  concurrency, not arrival count), sheds at saturation exactly like
  the old inflight cap, keeps a fixed small task-name set that folds
  into one `<label>-*` family, and propagates worker failures from
  drain() like the old wait_for_all did.
- **WakeSignal + call_at**: the coalesced-timer helper wakes parked
  loops without busy ticking, and call_at callbacks fire in (time,
  seq) order interleaved with ordinary delay() timers.
- **Typed bare payloads**: armed message accounting REJECTS a
  None-payload delivery (lint assert), and a full storm under the
  armed plane shows zero `NoneType` rows.
- **Client multiplexing**: an OverloadStorm block of
  `clients_per_arrival` logical clients walks the whole population
  (distinct_clients == n_clients once draws cover the pools) and
  charges the proxy's admission accounting for the full block weight
  through the GRV wire request.
"""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.flow.scheduler import Scheduler, WakeSignal  # noqa: E402
from foundationdb_tpu_torch.rpc import SimNetwork  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402
from foundationdb_tpu_torch.server.chaos import database_digest  # noqa: E402
from foundationdb_tpu_torch.server.workloads import (ClientActorPool,  # noqa: E402
                                               ContentionStorm,
                                               OpenLoopStorm,
                                               OverloadStorm,
                                               make_zipf_cdf, zipf_rank)


# -- schedule determinism -------------------------------------------------

def _openloop_schedule(seed):
    flow.set_seed(seed)
    storm = OpenLoopStorm([], flow.g_random, duration=2.0, rate=100.0,
                          burst_rate=400.0, burst_start=0.5,
                          burst_len=0.5, repairable_fraction=0.25)
    return storm.draw_schedule()


def test_schedule_is_pure_function_of_seed():
    a = _openloop_schedule(1234)
    b = _openloop_schedule(1234)
    assert a == b, "same seed must draw the identical schedule"
    c = _openloop_schedule(4321)
    assert a[0] != c[0], "a different seed must move the schedule"
    times, keys, batch, repair = a
    assert len(times) == len(keys) == len(batch) == len(repair)
    assert len(times) > 100          # ~100/s * 2s + burst
    assert all(0.0 <= t < 2.0 for t in times)
    assert all(times[i] < times[i + 1] for i in range(len(times) - 1))
    assert any(batch) and not all(batch)
    assert any(repair) and not all(repair)


def test_repair_fraction_leaves_arrivals_untouched():
    """Arming automatic_repair must not move the arrival/key/priority
    schedule (the repair flags are drawn LAST)."""
    flow.set_seed(77)
    off = OpenLoopStorm([], flow.g_random, duration=2.0,
                        rate=120.0).draw_schedule()
    flow.set_seed(77)
    on = OpenLoopStorm([], flow.g_random, duration=2.0, rate=120.0,
                       repairable_fraction=0.5).draw_schedule()
    assert on[0] == off[0] and on[1] == off[1] and on[2] == off[2]
    assert not any(off[3]) and any(on[3])


def test_searchsorted_matches_scalar_zipf_rank():
    import numpy as np
    cdf = make_zipf_cdf(64, 1.2)
    g = np.random.Generator(np.random.PCG64(9))
    us = g.random(2000)
    vec = np.searchsorted(np.asarray(cdf), us, side="left").tolist()
    for u, r in zip(us.tolist(), vec):
        assert r == zipf_rank(cdf, u), (u, r)


def test_overload_schedule_modes():
    flow.set_seed(5150)
    classic = OverloadStorm([], flow.g_random, duration=2.0,
                            n_clients=1000).draw_schedule()
    times, abusive, keys, batch, cids = classic
    assert cids is not None and len(cids) == len(times)
    n_ab = max(1, 1000 // 10)
    for i, cid in enumerate(cids):
        if abusive[i]:
            assert 0 <= cid < n_ab
        else:
            assert n_ab <= cid < 1000
    flow.set_seed(5150)
    mux = OverloadStorm([], flow.g_random, duration=2.0, n_clients=1000,
                        clients_per_arrival=8).draw_schedule()
    assert mux[4] is None            # cursor mode: no cid draws
    assert mux[0] == times           # arrivals unchanged by multiplexing


# -- same-seed replay across the refactored storms ------------------------

def _run_openloop(seed):
    c = SimCluster(seed=seed, durable=True)
    try:
        dbs = [c.client(f"ol{i}") for i in range(3)]
        storm = OpenLoopStorm(dbs, flow.g_random, duration=2.0,
                              rate=60.0, burst_rate=250.0,
                              burst_start=0.5, burst_len=0.5,
                              max_inflight=128)

        async def main():
            rep = await storm.run()
            rep["digest"] = await database_digest(dbs[0])
            return rep

        rep = c.run(main(), timeout_time=600)
        rep["net_messages"] = c.net.messages_sent
        rep["sched_steps"] = c.sched.tasks_run
        return rep
    finally:
        c.shutdown()


def _run_contention(seed):
    c = SimCluster(seed=seed, durable=True)
    try:
        dbs = [c.client(f"ct{i}") for i in range(3)]
        storm = ContentionStorm(dbs, flow.g_random, duration=2.0,
                                rate=80.0)

        async def main():
            rep = await storm.run()
            rep["hot_total"] = await storm.read_hot_total(dbs[0])
            rep["digest"] = await database_digest(dbs[0])
            return rep

        rep = c.run(main(), timeout_time=600)
        rep["net_messages"] = c.net.messages_sent
        rep["sched_steps"] = c.sched.tasks_run
        return rep
    finally:
        c.shutdown()


def _run_overload(seed, armed_stats=False, knobs=None, duration=2.0,
                  **kw):
    c = SimCluster(seed=seed, durable=True, n_proxies=2)
    # knob overrides go AFTER construction: SimCluster re-initializes
    # SERVER_KNOBS in __init__
    for k, v in (knobs or {}).items():
        flow.SERVER_KNOBS.set(k, v)
    if armed_stats:
        c.sched.start_task_stats()
        c.net.arm_message_stats()
    try:
        dbs = [c.client(f"ov{i}") for i in range(4)]
        storm = OverloadStorm(dbs, flow.g_random, duration=duration,
                              fair_rate=40.0, abusive_rate=120.0,
                              n_clients=5000, **kw)

        async def main():
            rep = await storm.run()
            rep["digest"] = await database_digest(dbs[0])
            return rep

        rep = c.run(main(), timeout_time=600)
        rep["net_messages"] = c.net.messages_sent
        rep["sched_steps"] = c.sched.tasks_run
        if armed_stats:
            rep["msg_types"] = dict(c.net.msg_stats)
        return rep
    finally:
        c.shutdown()


_REPLAY_KEYS = ("issued", "completed", "conflicted", "shed",
                "digest", "net_messages", "sched_steps")


def _slice(rep, keys=_REPLAY_KEYS):
    return {k: rep[k] for k in keys if k in rep}


def test_openloop_same_seed_replay(sim_seed):
    seed = sim_seed(2801)
    a, b = _run_openloop(seed), _run_openloop(seed)
    assert _slice(a) == _slice(b), (seed, _slice(a), _slice(b))
    assert a["completed"] > 0


def test_contention_same_seed_replay(sim_seed):
    seed = sim_seed(2802)
    keys = _REPLAY_KEYS + ("committed", "conflicts", "attempts",
                           "hot_total")
    a, b = _run_contention(seed), _run_contention(seed)
    assert _slice(a, keys) == _slice(b, keys), seed
    assert a["committed"] > 0
    # the goodput bit-exactness oracle survives pooling: hot-key sum
    # equals committed (modulo deliberately unsettled unknowns)
    assert a["committed"] <= a["hot_total"] \
        <= a["committed"] + a["unknown"], a


def test_overload_same_seed_replay_and_armed_equivalence(sim_seed):
    seed = sim_seed(2803)
    keys = _REPLAY_KEYS + ("distinct_clients",)
    a, b = _run_overload(seed), _run_overload(seed)
    assert _slice(a, keys) == _slice(b, keys), seed
    # arming the attribution plane must not move a single sim event —
    # and the armed table must show ONLY typed message rows
    armed = _run_overload(seed, armed_stats=True)
    assert _slice(armed, keys) == _slice(a, keys), seed
    assert armed["msg_types"], armed
    assert not any("NoneType" in t for t in armed["msg_types"]), \
        sorted(armed["msg_types"])


# -- pooled client actors -------------------------------------------------

def _pool_env():
    flow.set_seed(31)
    s = Scheduler(virtual=True)
    flow.set_scheduler(s)
    return s


def test_pool_reuses_workers_and_sheds_at_limit():
    s = _pool_env()
    try:
        ran = []

        async def job(i, hold):
            ran.append(i)
            if hold:
                await flow.delay(1.0)

        pool = ClientActorPool(job, limit=2, label="pt")

        async def main():
            # two held jobs fill the pool; the third arrival sheds
            assert pool.dispatch((0, True))
            assert pool.dispatch((1, True))
            assert not pool.dispatch((2, True)), "limit must shed"
            await flow.delay(1.5)      # both workers park idle
            # sequential jobs REUSE the two workers
            for i in range(3, 9):
                assert pool.dispatch((i, False))
                await flow.delay(0.01)
            await pool.drain()

        s.run(s.spawn(main(), name="main"), timeout_time=60)
        assert sorted(ran) == [0, 1, 3, 4, 5, 6, 7, 8]
        assert pool.size == 2, "spawns == peak concurrency, not jobs"
        names = {t.name for t in pool._tasks}
        assert names == {"pt-0", "pt-1"}, names  # fixed small name set
    finally:
        flow.set_scheduler(None)


def test_pool_drain_propagates_worker_failure_without_leaking_slot():
    s = _pool_env()
    try:
        ran = []

        async def job(i):
            if i == 1:
                raise RuntimeError("boom")
            ran.append(i)

        pool = ClientActorPool(job, limit=2)

        async def main():
            pool.dispatch((0,))
            pool.dispatch((1,))       # dies — must NOT leak its slot
            await flow.delay(0.01)
            # both workers still serve (capacity preserved, like the
            # old finally-based inflight decrement)
            assert pool.dispatch((2,))
            assert pool.dispatch((3,))
            await pool.drain()

        with pytest.raises(RuntimeError):
            s.run(s.spawn(main(), name="main"), timeout_time=60)
        assert sorted(ran) == [0, 2, 3]
        assert pool.size == 2
    finally:
        flow.set_scheduler(None)


def test_pool_names_fold_into_one_family():
    s = _pool_env()
    s.start_task_stats()
    try:
        async def job(i):
            await flow.delay(0.001)

        pool = ClientActorPool(job, limit=8, label="storm-txn")

        async def main():
            for i in range(32):
                assert pool.dispatch((i,))
                await flow.delay(0.002)
            await pool.drain()

        s.run(s.spawn(main(), name="main"), timeout_time=60)
        table = {r["task"]: r for r in s.task_stats_report()["tasks"]}
        fams = [n for n in table if n.startswith("storm-txn")]
        assert fams == ["storm-txn-*"], fams
        assert s.task_stats_dropped == 0
    finally:
        flow.set_scheduler(None)


# -- WakeSignal + call_at -------------------------------------------------

def test_wake_signal_parks_and_wakes():
    flow.set_seed(32)
    s = Scheduler(virtual=True)
    flow.set_scheduler(s)
    try:
        sig = WakeSignal()
        log = []

        async def loop():
            while True:
                seen = sig.count
                await sig.wait_beyond(seen)
                log.append((flow.now(), sig.count))
                if sig.count >= 3:
                    return

        async def producer():
            for _ in range(3):
                await flow.delay(1.0)
                sig.touch()

        t = s.spawn(loop(), name="loop")
        s.spawn(producer(), name="prod")
        s.run(until=t, timeout_time=60)
        assert [c for _t, c in log] == [1, 2, 3]
        assert [t for t, _c in log] == [1.0, 2.0, 3.0]
        # a pre-touched signal returns immediately (no park)
        assert sig.wait_beyond(0).is_ready
        assert not sig.wait_beyond(sig.count).is_ready
    finally:
        flow.set_scheduler(None)


def test_call_at_fires_in_time_seq_order_with_delays():
    flow.set_seed(33)
    s = Scheduler(virtual=True)
    flow.set_scheduler(s)
    try:
        order = []
        s.call_at(2.0, order.append, "cb@2")
        s.call_at(1.0, order.append, "cb@1a")
        s.call_at(1.0, order.append, "cb@1b")   # same time: seq order

        async def waiter():
            await flow.delay(1.0)
            order.append("task@1")
            await flow.delay(2.0)
            order.append("task@3")

        t = s.spawn(waiter(), name="w")
        s.run(until=t, timeout_time=60)
        assert order == ["cb@1a", "cb@1b", "task@1", "cb@2", "task@3"], \
            order
        assert s.now() == 3.0
    finally:
        flow.set_scheduler(None)


# -- typed bare payloads --------------------------------------------------

def test_armed_count_msg_rejects_untyped_delivery():
    flow.set_seed(34)
    s = Scheduler(virtual=True)
    net = SimNetwork(s, flow.g_random)
    net.arm_message_stats()
    with pytest.raises(AssertionError):
        net._count_msg("NoneType")
    net._count_msg("PingRequest")     # typed: fine
    assert net.msg_stats["PingRequest"] == 1


def test_wire_cache_serves_fieldless_singletons():
    from foundationdb_tpu_torch.server.types import (GET_RATE_REQUEST,
                                               PING_REQUEST, PingRequest)
    flow.set_seed(35)
    s = Scheduler(virtual=True)
    net = SimNetwork(s, flow.g_random)
    a = net._wire(PING_REQUEST)
    b = net._wire(PING_REQUEST)
    assert type(a) is PingRequest
    assert a is b, "second delivery must hit the per-type cache"
    assert net._wire(None) is None
    assert type(net._wire(GET_RATE_REQUEST)).__name__ == "GetRateRequest"


# -- client multiplexing --------------------------------------------------

def test_multiplexed_overload_covers_whole_population(sim_seed):
    """A multiplexed storm's block cursors walk the entire client
    population: distinct_clients == n_clients once draws cover the
    pools — the 10^6-client path, scaled to test size — and the GRV
    weight charges admission accounting for every logical client."""
    seed = sim_seed(2804)
    # coverage needs the FAIR pool (90% of ids at 25% of the rate)
    # covered too: ~80 fair arrivals x 100 >= 4500-id pool, with margin
    rep = _run_overload(seed, clients_per_arrival=100)
    n = rep["issued"]
    assert rep["others_issued"] * 100 >= 4500, rep["others_issued"]
    assert rep["distinct_clients"] == 5000, rep["distinct_clients"]
    assert rep["clients_per_arrival"] == 100
    assert rep["logical_clients_offered"] == n * 100
    assert rep["completed"] > 0
    # the rotating block leader must not alias the tag modulus: every
    # tenant tag carries traffic even when the stride shares a factor
    # with the tag count (100 % 3 != 0 here, so also pin the aliasing
    # shape directly below)
    assert len(rep["tags_seen"]) == 4, rep["tags_seen"]


def test_armed_stats_with_auto_throttling_storm(sim_seed):
    """The armed-mode untyped-delivery assert must hold on EVERY wire
    path, including the ratekeeper auto-throttler's raw-committed
    probe (a None payload hid there until this combination — armed
    message stats + auto tag throttling under abusive load — ran)."""
    seed = sim_seed(2806)
    try:
        rep = _run_overload(seed, armed_stats=True, duration=4.0,
                            knobs={"grv_admission_control": 1,
                                   "tag_throttling": 1,
                                   "auto_tag_throttling": 1,
                                   "tag_throttle_busy_rate": 0.5,
                                   "tag_throttle_update_interval": 0.25})
        assert not any("NoneType" in t for t in rep["msg_types"]), \
            sorted(rep["msg_types"])
        assert rep["issued"] > 0
        # the throttler must have SURVIVED to enforce (an untyped
        # probe under the armed assert kills the throttler actor
        # before it writes any auto row, so zero rejections here is
        # how that bug manifests end to end)
        assert rep["tag_rejected"] > 0, rep
        assert "RawCommittedRequest" in rep["msg_types"], \
            sorted(rep["msg_types"])
    finally:
        flow.reset_server_knobs(randomize=False)


def test_multiplex_stride_does_not_alias_tags(sim_seed):
    """B divisible by len(tenant_tags) (the overload_million shape,
    B=600): the rotating leader must still spread fair traffic over
    every tenant tag."""
    seed = sim_seed(2805)
    rep = _run_overload(seed, clients_per_arrival=60)
    assert len(rep["tags_seen"]) == 4, rep["tags_seen"]


def test_grv_batch_weight_charges_full_block():
    """One weighted transaction must charge transactions_started for
    the whole block (the wire GetReadVersionRequest carries the
    multiplexed transaction_count)."""
    c = SimCluster(seed=414, durable=True)
    try:
        db = c.client("mux")

        async def main():
            tr = db.create_transaction()
            tr.set_option("grv_batch_weight", 25)
            await tr.get_read_version()
            tr.set(b"mux/k", b"v")
            await tr.commit()
            status = await db.get_status()
            return status["cluster"]["proxies"][0]["counters"]

        counters = c.run(main(), timeout_time=120)
        assert counters["transactions_started"] >= 25, counters
    finally:
        c.shutdown()


def test_grv_batch_weight_rejects_bad_values():
    c = SimCluster(seed=415)
    try:
        db = c.client("muxbad")
        tr = db.create_transaction()
        with pytest.raises(flow.FdbError):
            tr.set_option("grv_batch_weight", 0)
        with pytest.raises(flow.FdbError):
            tr.set_option("grv_batch_weight", "nope")
        tr.set_option("grv_batch_weight", 3)   # legal
    finally:
        c.shutdown()


# -- the 10^6-client acceptance cell (scaled nightly proof runs in CI) ----

@pytest.mark.slow
def test_million_client_storm_cell():
    """The acceptance configuration end to end via the same
    entry point CI uses: 10^6 distinct clients, 10x horizon, zero
    NoneType message rows, inside the nightly budget."""
    from foundationdb_tpu_torch.tools.simprof import run_storm
    rep = run_storm("overload_million")
    stats = rep["stats"]
    assert stats["distinct_clients"] == 1_000_000, stats
    assert stats["completed"] > 0
    types = [r["type"] for r in rep["message_stats"]["types"]]
    assert types and not any("NoneType" in t for t in types), types
    assert rep["sim_perf"]["sim_seconds"] >= 29.0   # 10x horizon


def test_simprof_overrides_reach_the_storm():
    """--clients/--horizon/--multiplex plumb through run_storm so any
    population/horizon cell is reproducible from the CLI."""
    from foundationdb_tpu_torch.tools.simprof import run_storm
    rep = run_storm("overload", duration=1.0, clients=2000,
                    horizon=2.0, multiplex=10)
    stats = rep["stats"]
    assert stats["n_clients"] == 2000
    assert stats["clients_per_arrival"] == 10
    assert rep["sim_perf"]["sim_seconds"] >= 2.0    # 1.0s x 2.0 horizon
