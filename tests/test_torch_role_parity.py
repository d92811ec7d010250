"""Parity of the port's flow runtime, simulated RPC layer and resolver
role with the reference's, on the CPU, each package under its own
scheduler in turn (never both at once), at seeds drawn by numpy and
set with each package's own `flow.set_seed`. Equality is exact
everywhere: times, task names, BUGGIFY draws, bytes, verdicts and
attributed ranges.

  (a) one seeded actor program (delays, cancellation, a timeout,
      PromiseStream traffic, BUGGIFY and g_random draws) runs the same
      (virtual time, task name) sequence of steps and draws the same
      values under both schedulers;
  (b) every NamedTuple the reference registers on its wire from
      `server/types.py` and `models/conflict_set.py` has a counterpart
      registered in the port under the same name, encoding to the same
      bytes from the same field values;
  (c) `SimNetwork` at one seed delivers a request/reply exchange (with
      one-way sends, a clogged link and BUGGIFY'd latencies) in the
      same order at the same virtual times;
  (d) a seeded `ResolveRequest` stream through the port's `Resolver`
      on `cuda`, `cuda-point` and `sharded-cuda` (at `device="cpu"`,
      and again on the card under the `cuda` marker) gives the reply
      stream of the reference's `Resolver` on `tpu`, `tpu-point` and
      `sharded-tpu`: verdicts, `ResolveReply` attributed ranges,
      `key_hist`/`work_units`, the hot-spot rows, the in-flight and
      reply-cache duplicate replies, a rejected batch whose key is
      wider than the key width, and a checkpoint/install handoff to a
      second resolver; at three seeds, one of them buggified so that
      `resolver/small_reply_cache` fires and an old duplicate ages out.
"""

import importlib
import random
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REF, PORT = "foundationdb_tpu", "foundationdb_tpu_torch"


@pytest.fixture(autouse=True)
def default_buggify_rates():
    """Hold both packages' BUGGIFY activation and fire rates at their
    defaults: `flow.set_seed` resets neither, and a test that forces a
    site raises a package's fire rate (the reference's
    `test_resolve_pipeline.py` leaves it at 1.0), which would make the
    two packages draw differently in a later test of the same process."""
    saved = []
    for name in ("foundationdb_tpu", "foundationdb_tpu_torch"):
        b = importlib.import_module(f"{name}.flow.rng").g_buggify
        fresh = type(b)()
        saved.append((b, b.activated_p, b.fire_p))
        b.activated_p, b.fire_p = fresh.activated_p, fresh.fire_p
    yield
    for b, activated_p, fire_p in saved:
        b.activated_p, b.fire_p = activated_p, fire_p


SEEDS = [int(s) for s in np.random.default_rng(20261017).integers(
    1, 2**31 - 1, size=3)]


def pkg(name):
    mod = importlib.import_module
    return SimpleNamespace(
        name=name, flow=mod(f"{name}.flow"),
        future=mod(f"{name}.flow.future"),
        coverage=mod(f"{name}.flow.coverage"),
        rpc=mod(f"{name}.rpc"), wire=mod(f"{name}.rpc.wire"),
        types=mod(f"{name}.server.types"),
        role=mod(f"{name}.server.resolver_role"),
        conflict_set=mod(f"{name}.models.conflict_set"))


def norm(x):
    """A value with its message types named and lists told from
    tuples: what two packages' outputs are compared as."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (type(x).__name__,) + tuple(norm(f) for f in x)
    if isinstance(x, list):
        return ("list",) + tuple(norm(f) for f in x)
    if isinstance(x, tuple):
        return tuple(norm(f) for f in x)
    if isinstance(x, dict):
        return ("dict",) + tuple(sorted((k, norm(v)) for k, v in x.items()))
    return x


def in_scheduler(P, seed, fn, buggify=True):
    """Run `fn(sched)` as the root actor of a fresh virtual scheduler of
    package P, seeded by P's own set_seed; restore P's ambient state."""
    flow = P.flow
    flow.set_seed(seed, buggify_enabled=buggify)
    sched = flow.Scheduler()
    flow.set_scheduler(sched)
    try:
        task = sched.spawn(fn(sched), name="root")
        out = sched.run(until=task, timeout_time=1e6)
        return out, sched.tasks_run, sched.now()
    finally:
        flow.set_scheduler(None)
        flow.set_seed(0, buggify_enabled=False)


# -- (a) the scheduler ------------------------------------------------------

def actor_program(P, seed, monkeypatch):
    flow = P.flow
    steps = []
    orig = P.future.Task._step

    def step(self, value=None, exc=None):
        steps.append((self._sched.now(), self.name))
        return orig(self, value, exc)

    monkeypatch.setattr(P.future.Task, "_step", step)

    async def root(sched):
        draws = [flow.buggify(f"parity/site{j}") for j in range(24)]
        ps = flow.PromiseStream()
        got = []

        async def worker(i):
            for k in range(5):
                await flow.delay(flow.g_random.random01() * 0.01)
                if flow.buggify("parity/worker_stall"):
                    await flow.delay(0.05)
                ps.send((i, k, flow.g_random.random_int(0, 1000)))
            return i

        async def consumer():
            while len(got) < 15:
                got.append(await ps.stream.pop())
            return len(got)

        async def sleeper():
            await flow.delay(100.0)
            return "woke"

        workers = [flow.spawn(worker(i), name=f"worker{i}")
                   for i in range(3)]
        cons = flow.spawn(consumer(), name="consumer")
        victim = flow.spawn(sleeper(), name="victim")
        late = await flow.timeout(flow.spawn(sleeper(), name="late"), 0.03,
                                  default="timed out")
        await flow.delay(0.02)
        victim.cancel()
        first = await flow.first_of(*workers)
        done = await flow.all_of(workers + [cons])
        return (draws, got, late, first, done, victim.is_error,
                [flow.g_random.random01() for _ in range(4)])

    out = in_scheduler(P, seed, root)
    monkeypatch.undo()
    return steps, out


@pytest.mark.parametrize("seed", SEEDS)
def test_actor_program_same_steps_and_draws(seed, monkeypatch):
    steps_ref, out_ref = actor_program(pkg(REF), seed, monkeypatch)
    steps_port, out_port = actor_program(pkg(PORT), seed, monkeypatch)
    assert len(steps_ref) > 30
    assert steps_port == steps_ref
    assert out_port == out_ref
    assert any(out_ref[0][0])     # some BUGGIFY site fired


def test_packages_export_what_the_reference_exports():
    for sub in ("flow", "rpc"):
        ref = importlib.import_module(f"{REF}.{sub}")
        port = importlib.import_module(f"{PORT}.{sub}")
        assert port.__all__ == ref.__all__, sub
        assert all(hasattr(port, n) for n in port.__all__), sub


# -- (b) the wire vocabulary ------------------------------------------------

REGISTERED_FROM = ("server.types", "models.conflict_set")


def _registered(P):
    return {n: c for n, c in P.wire._REGISTRY.items()
            if c.__module__ in {f"{P.name}.{m}" for m in REGISTERED_FROM}}


def _sample_fields(n, salt):
    kinds = [lambda i: i * 1000 + salt, lambda i: b"f%d-%d" % (i, salt),
             lambda i: None, lambda i: ((b"a", b"b%d" % i), (salt, -i)),
             lambda i: [i, 2.5, True], lambda i: "s%d" % i,
             lambda i: {b"k": (i, salt)}, lambda i: -(1 << 70) + i]
    return [kinds[(i + salt) % len(kinds)](i) for i in range(n)]


def test_registered_messages_encode_to_the_same_bytes():
    ref, port = _registered(pkg(REF)), _registered(pkg(PORT))
    assert len(ref) >= 40 and set(port) == set(ref)
    for name, rcls in sorted(ref.items()):
        pcls = port[name]
        assert pcls._fields == rcls._fields, name
        for salt in range(3):
            fields = _sample_fields(len(rcls._fields), salt)
            want = pkg(REF).wire.to_bytes(rcls(*fields))
            assert pkg(PORT).wire.to_bytes(pcls(*fields)) == want, name
            back = pkg(PORT).wire.from_bytes(want, None)
            assert type(back) is pcls and tuple(back) == tuple(
                pkg(REF).wire.from_bytes(want, None)), name
        # defaults: the fields a sender may leave out
        assert pcls._field_defaults == rcls._field_defaults, name


def test_nested_messages_encode_to_the_same_bytes():
    def nested(P):
        t, cs = P.types, P.conflict_set
        txns = tuple(t.CommitRequest(
            7 + i, ((b"a%d" % i, b"b"),), ((b"w", b"w\x00"),),
            (t.MutationRef(t.SET_VALUE, b"k", b"v"),),
            report_conflicting_keys=bool(i % 2), tags=(b"t",))
            for i in range(3))
        piece = cs.ConflictRangePiece(
            *_sample_fields(len(cs.ConflictRangePiece._fields), 1))
        return [t.ResolveRequest(5, 9, txns, (11,)),
                t.ResolveReply((0, 2, 1), ((), ((b"a", b"b"),), ())),
                t.ResolverCheckpointReply(piece, 9),
                t.ResolverInstallRequest(b"a", None, piece),
                t.ResolutionMetricsReply(3, tuple(range(256))),
                t.RESOLUTION_METRICS_REQUEST]

    ref = [pkg(REF).wire.to_bytes(m) for m in nested(pkg(REF))]
    assert [pkg(PORT).wire.to_bytes(m) for m in nested(pkg(PORT))] == ref


# -- (c) the simulated network ----------------------------------------------

def network_exchange(P, seed):
    flow, t = P.flow, P.types
    log = []

    async def root(sched):
        net = P.rpc.SimNetwork(sched, flow.g_random)
        server = net.new_process("server", machine="a")
        clients = [net.new_process(f"c{i}", machine=f"m{i}")
                   for i in range(3)]
        stream = P.rpc.RequestStream(server)
        oneway = P.rpc.RequestStream(server)

        async def serve():
            while True:
                req, reply = await stream.pop()
                log.append(("recv", sched.now(), norm(req)))
                reply.send(t.CommitReply(req.read_snapshot, len(log)))

        async def sink():
            while True:
                req, _reply = await oneway.pop()
                log.append(("oneway", sched.now(), norm(req)))

        async def client(i, proc):
            for k in range(6):
                req = t.CommitRequest(
                    100 * i + k, ((b"r%d" % k, b"r%d\x00" % k),), (),
                    (t.MutationRef(t.SET_VALUE, b"c%d" % i, b"%d" % k),))
                rep = await stream.ref().get_reply(req, proc)
                log.append(("reply", i, sched.now(), norm(rep)))
                oneway.ref().send(t.MutationRef(t.CLEAR_RANGE, b"%d" % i,
                                                b"%d" % k), proc)
                if k == 2 and i == 1:
                    net.clog_pair("m1", "a", 0.01)
                await flow.delay(flow.g_random.random01() * 0.003)

        flow.spawn(serve(), name="serve")
        flow.spawn(sink(), name="sink")
        await flow.all_of([flow.spawn(client(i, p), name=f"client{i}")
                           for i, p in enumerate(clients)])
        await flow.delay(0.1)
        return (net.messages_sent, net.messages_dropped,
                net.messages_duplicated, norm(net.chaos_log))

    out = in_scheduler(P, seed, root)
    return log, out


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_sim_network_same_order_and_latencies(seed):
    log_ref, out_ref = network_exchange(pkg(REF), seed)
    log_port, out_port = network_exchange(pkg(PORT), seed)
    assert sum(1 for e in log_ref if e[0] == "reply") == 18
    assert log_port == log_ref
    assert out_port == out_ref


# -- (d) the resolver role --------------------------------------------------

# the port's backend for each reference backend
BACKENDS = {"cuda": "tpu", "cuda-point": "tpu-point",
            "sharded-cuda": "sharded-tpu"}
N_BATCHES = 12
DEPTH = 4
SITES = ("resolver.reply_cache.inflight_dup", "resolver.reply_cache.hit",
         "resolver.reply_cache.aged_out", "resolver.batch.rejected")


def _small_cache_seed():
    """The first numpy-drawn seed at which the role's first BUGGIFY
    draw, `resolver/small_reply_cache`, fires (set_seed forks the
    BUGGIFY stream off the seeded g_random)."""
    from foundationdb_tpu_torch.flow.rng import Buggifier, DeterministicRandom
    for s in np.random.default_rng(7).integers(1, 2**31 - 1, size=500):
        if Buggifier(DeterministicRandom(int(s)).fork(), enabled=True)(
                "resolver/small_reply_cache"):
            return int(s)
    raise AssertionError("no seed fires resolver/small_reply_cache")


ROLE_SEEDS = [(SEEDS[0], False), (SEEDS[1], False),
              (_small_cache_seed(), True)]


def role_traffic(seed, point):
    """Batches of (snapshot, reads, writes, report) over a small
    keyspace (conflicts, attributions, tooOld snapshots); at most 12
    transactions and 24 ranges a batch, one shape bucket."""
    rng = random.Random(seed)

    def rng_range():
        k = bytes([rng.randrange(0x30, 0x50)])
        if point or rng.random() < 0.5:
            return (k, k + b"\x00")
        e = bytes([rng.randrange(0x30, 0x50)])
        return (min(k, e), max(k, e) + b"\x00")

    batches, v = [], 0
    for _ in range(N_BATCHES + 3):
        v += rng.randrange(1, 1_500_000)
        batches.append((v, [
            (max(0, v - rng.randrange(0, 6_000_000)),
             tuple(rng_range() for _ in range(rng.randrange(0, 3))),
             tuple(rng_range() for _ in range(rng.randrange(0, 3))),
             rng.random() < 0.2)
            for _ in range(rng.randrange(1, 13))]))
    return batches


def role_stream(P, backend, seed, buggified, device):
    """The seeded request stream through P's Resolver over P's SimNetwork,
    as a proxy sends it: DEPTH batches in flight chained by
    prev_version, then a rejected batch, an in-flight duplicate, cached
    and aged duplicates, the metrics poll, and a checkpoint of a key
    span installed into a second resolver that then resolves a batch
    reading it. Returns everything the role answered, in order."""
    flow, t = P.flow, P.types
    point = backend in ("cuda-point", "tpu-point")
    traffic = role_traffic(seed + 1, point)
    wide = b"\x40" * (9 if point else 33)     # wider than the key width
    kw = {} if P.name == REF else {"device": device}
    log = []
    cov0 = {s: P.coverage.hits(s) for s in SITES}

    def request(prev, i):
        v, txns = traffic[i]
        return t.ResolveRequest(prev, v, tuple(
            t.CommitRequest(s, r, w, (), report_conflicting_keys=rep)
            for s, r, w, rep in txns))

    async def root(sched):
        net = P.rpc.SimNetwork(sched, flow.g_random)
        proxy = net.new_process("proxy", machine="p")
        res = P.role.Resolver(net.new_process("resolver", machine="r"),
                              backend, **kw)
        res2 = P.role.Resolver(net.new_process("resolver2", machine="q"),
                               backend, **kw)
        res.start()
        res2.start()
        log.append(("cache cap", res._cache_cap))
        ref = res.resolves.ref()

        async def send(name, req, to=ref):
            try:
                rep = await to.get_reply(req, proxy)
                log.append((name, sched.now(), norm(rep)))
            except flow.FdbError as e:
                log.append((name, sched.now(), "error", e.name))

        reqs, prev = [], 0
        for i in range(N_BATCHES):
            reqs.append(request(prev, i))
            prev = reqs[-1].version
        pending = []
        for i, req in enumerate(reqs):
            pending.append(flow.spawn(send(f"batch {i}", req)))
            if len(pending) >= DEPTH:
                await pending.pop(0)
        await flow.all_of(pending)
        # a key wider than the key width: the whole batch conflicts
        v = traffic[N_BATCHES][0]
        await send("rejected", t.ResolveRequest(prev, v, (
            t.CommitRequest(v - 1, ((wide, wide + b"\x00"),),
                            ((b"\x41", b"\x41\x00"),), ()),
            t.CommitRequest(v - 1, (), ((b"\x42", b"\x42\x00"),), ()))))
        prev = v
        # the in-flight duplicate: both copies of batch b arrive before
        # its predecessor a, wake together, and the second drains the
        # first's ticket
        a = request(prev, N_BATCHES + 1)
        b = request(a.version, N_BATCHES + 2)
        dups = [flow.spawn(send("in-flight copy 1", b)),
                flow.spawn(send("in-flight copy 2", b))]
        await flow.delay(0.1)
        await send("predecessor", a)
        await flow.all_of(dups)
        # duplicates after the fact: the last batches are cached, the
        # first aged out of a small cache
        await send("cached duplicate", b)
        await send("cached duplicate 2", reqs[-1])
        await send("old duplicate", reqs[1])
        await send("metrics", t.RESOLUTION_METRICS_REQUEST,
                   res.metrics.ref())
        # handoff: checkpoint [0x38, 0x48) and graft it into resolver2
        ckpt = await res.handoffs.ref().get_reply(
            t.ResolverCheckpointRequest(b"\x38", b"\x48", b.version), proxy)
        log.append(("checkpoint", norm(ckpt)))
        await send("install", t.ResolverInstallRequest(
            b"\x38", b"\x48", ckpt.piece), res2.handoffs.ref())
        reads = tuple((bytes([k]), bytes([k]) + b"\x00")
                      for k in range(0x34, 0x4c, 2))
        await send("after install", t.ResolveRequest(0, b.version + 10, tuple(
            t.CommitRequest(b.version - d, (r,), (), (),
                            report_conflicting_keys=True)
            for d in (1, 4_000_000) for r in reads)), res2.resolves.ref())
        log.append(("hot spots", norm(res.hot_spots.rows())))
        log.append(("top", norm(res.hot_spots.top())))
        log.append(("work", res.work_units, tuple(res.key_hist)))
        log.append(("stats", norm(res.stats.snapshot())))
        fo = res.failover_stats()
        log.append(("failover", fo.get("failovers"), fo.get("device_faults"),
                    fo.get("checkpoints")))
        log.append(("path", norm(res.path.snapshot())))
        res.stop()
        res2.stop()
        return prev

    out = in_scheduler(P, seed, root, buggify=buggified)
    log.append(("coverage", tuple(P.coverage.hits(s) - cov0[s]
                                  for s in SITES)))
    return log, out


@pytest.fixture
def one_device_reference(monkeypatch):
    """The reference's sharded-tpu spans every visible device: one on a
    one-card host, as the port's sharded-cuda has one shard on one
    card, but eight under the tests' virtual CPU mesh. Its deployment
    on one device is the one to hold the port to (the row count in the
    role's state-pressure counter counts every shard's rows)."""
    ref_parallel = importlib.import_module(f"{REF}.parallel")
    sharded = ref_parallel.ShardedTpuConflictSet
    monkeypatch.setattr(ref_parallel, "ShardedTpuConflictSet",
                        lambda init_version=0: sharded(init_version,
                                                       n_shards=1))


def check_role_parity(backend, seed, buggified, device):
    log_ref, out_ref = role_stream(pkg(REF), BACKENDS[backend], seed,
                                   buggified, None)
    log_port, out_port = role_stream(pkg(PORT), backend, seed, buggified,
                                     device)
    names = [e[0] for e in log_ref]
    assert names.count("metrics") == 1
    for e_port, e_ref in zip(log_port, log_ref):
        assert e_port == e_ref, e_ref[0]
    assert len(log_port) == len(log_ref)
    assert out_port == out_ref
    d = dict((e[0], e[1:]) for e in log_ref)
    cov = d["coverage"][0]
    assert cov[0] >= 1 and cov[3] >= 1     # in-flight dup, rejected
    assert d["cache cap"] == ((2,) if buggified else (256,))
    if buggified:
        assert cov[2] >= 1                  # the old duplicate aged out
    # the duplicates of batch b answer as its first delivery did
    assert d["in-flight copy 1"][1:] == d["in-flight copy 2"][1:] == \
        d["cached duplicate"][1:]
    assert d["failover"][:2] == (0, 0)
    verdicts = [e[2] for e in log_ref if e[0].startswith("batch ")]
    assert any("ResolveReply" in str(v[:1]) for v in verdicts)


@pytest.mark.parametrize("seed,buggified", ROLE_SEEDS)
@pytest.mark.parametrize("backend", list(BACKENDS))
def test_resolver_role_reply_stream(backend, seed, buggified,
                                    one_device_reference):
    check_role_parity(backend, seed, buggified, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("backend", list(BACKENDS))
def test_resolver_role_reply_stream_on_card(backend, one_device_reference):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed, buggified in ROLE_SEEDS:
        check_role_parity(backend, seed, buggified, None)
