"""Resolver split and merge with a live state handoff on the port's
backends: the clip/graft cases and the randomized split-ensemble parity
of tests/test_resolver_splits.py:101-322, one for one, over the port's
`python`, `brute`, `native`, `cuda`, `cuda-point` and `sharded-cuda`
backends on the CPU (the CUDA backends at `device="cpu"` run their
plain PyTorch steps), and again on the card under the `cuda` marker.
The handoff is the port's `clip_checkpoint`/`graft_checkpoint`
(`foundationdb_tpu_torch/models/conflict_set.py`); the routing helper
is the port proxy's `KeyResolverMap`. The cluster cases (the balance
loop off, and a forced split under a skewed workload) run on the port's
SimCluster. Verdicts and attribution are integers: equality is
exact."""

import functools
import random
from bisect import bisect_right

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch.models import (  # noqa: E402
    COMMITTED,
    CONFLICT,
    TOO_OLD,
    BruteForceConflictSet,
    NativeConflictSet,
    PyConflictSet,
    ResolverTransaction,
    create_conflict_set,
    native_available,
)
from foundationdb_tpu_torch.models.conflict_set import (  # noqa: E402
    clip_checkpoint,
    graft_checkpoint,
)
from foundationdb_tpu_torch.server.proxy import KeyResolverMap  # noqa: E402

WINDOW = 5000
# the backends that take ranges; "@card" runs one on the card under the
# `cuda` marker
RANGE_BACKENDS = ("python", "native", "cuda", "sharded-cuda")
CARD = ("cuda@card", "sharded-cuda@card")


def txn(snapshot, reads=(), writes=()):
    return ResolverTransaction(snapshot, tuple(reads), tuple(writes))


def make_factory(name):
    """A constructor of a fresh conflict set, or a skip when the backend
    cannot run here (no native build, no card)."""
    if name == "python":
        return PyConflictSet
    if name == "brute":
        return BruteForceConflictSet
    if name == "native":
        if not native_available():
            pytest.skip("the native backend did not build")
        return NativeConflictSet
    base, _, where = name.partition("@")
    if where == "card" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kw = {"n_shards": 2} if base == "sharded-cuda" else {}
    return functools.partial(create_conflict_set, base,
                             device=None if where == "card" else "cpu", **kw)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain steps run on small tensors: one intra-op thread is
    faster here and leaves the other test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(names):
    return [pytest.param(n, marks=pytest.mark.cuda) if n.endswith("@card")
            else n for n in names]


# ------------------------------------------------------- clip / graft --
@pytest.mark.parametrize("backend", _params(RANGE_BACKENDS + CARD))
def test_clip_graft_roundtrip_and_max_semantics(backend):
    make = make_factory(backend)
    a = make()
    a.resolve([txn(0, writes=[(b"\x20a", b"\x20b"), (b"\x90x", b"\x90y")])],
              100, 0)
    piece = clip_checkpoint(a.checkpoint(), b"\x20", b"\x30")
    assert piece.keys[0] == b"\x20"
    b = make()
    # the recipient already recorded a NEWER write inside the span: the
    # graft's pointwise max must keep it
    b.resolve([txn(0, writes=[(b"\x20a", b"\x20a\x01")])], 300, 0)
    b.restore(graft_checkpoint(b.checkpoint(), piece))
    v = b.resolve([txn(250, reads=[(b"\x20a", b"\x20a\x01")], writes=()),
                   txn(150, reads=[(b"\x20a\x01", b"\x20b")], writes=()),
                   txn(150, reads=[(b"\x90x", b"\x90y")], writes=())],
                  400, 0)
    # newer write (300) survived; piece write (100) grafted; outside the
    # span untouched (no phantom [90x,90y) history)
    assert v == [CONFLICT, COMMITTED, COMMITTED]


@pytest.mark.parametrize("backend", _params(("cuda-point",
                                             "cuda-point@card")))
def test_clip_graft_roundtrip_points(backend):
    """The round trip on the point backend, whose checkpoints hold one
    [k, k+'\\x00') assignment per key: the graft keeps the recipient's
    newer point write, adds the piece's, and leaves the rest alone."""
    make = make_factory(backend)
    a = make()
    a.resolve([txn(0, writes=[(b"\x20a", b"\x20a\x00"),
                              (b"\x20c", b"\x20c\x00"),
                              (b"\x90x", b"\x90x\x00")])], 100, 0)
    piece = clip_checkpoint(a.checkpoint(), b"\x20", b"\x30")
    b = make()
    b.resolve([txn(0, writes=[(b"\x20a", b"\x20a\x00")])], 300, 0)
    b.restore(graft_checkpoint(b.checkpoint(), piece))
    v = b.resolve([txn(250, reads=[(b"\x20a", b"\x20a\x00")]),
                   txn(150, reads=[(b"\x20c", b"\x20c\x00")]),
                   txn(50, reads=[(b"\x20c", b"\x20c\x00")]),
                   txn(50, reads=[(b"\x90x", b"\x90x\x00")])], 400, 0)
    assert v == [CONFLICT, COMMITTED, CONFLICT, COMMITTED]


@pytest.mark.parametrize("backend", _params(RANGE_BACKENDS + CARD))
def test_clip_graft_keyspace_tail(backend):
    make = make_factory(backend)
    a = make()
    a.resolve([txn(0, writes=[(b"\xf0", b"\xf1")])], 100, 0)
    piece = clip_checkpoint(a.checkpoint(), b"\x80", None)
    b = make()
    b.restore(graft_checkpoint(b.checkpoint(), piece))
    assert b.resolve([txn(50, reads=[(b"\xf0", b"\xf1")], writes=())],
                     200, 0) == [CONFLICT]


# ------------------------------------------------- split-ensemble parity --
def _clip_with_index(kmap, ranges, n):
    """clip_per_resolver, but each piece carries its ORIGINAL range
    index: the attribution-union bookkeeping the proxy keeps."""
    out = [[] for _ in range(n)]
    nb = len(kmap.bounds)
    for ri, (b, e) in enumerate(ranges):
        k = max(0, bisect_right(kmap.bounds, b) - 1)
        while k < nb and kmap.bounds[k] < e:
            lo = kmap.bounds[k]
            hi = kmap.bounds[k + 1] if k + 1 < nb else None
            b2 = max(b, lo)
            e2 = e if hi is None else min(e, hi)
            if b2 < e2:
                for idx in kmap.live_owners(k):
                    out[idx].append((b2, e2, ri))
            k += 1
    return out


class SplitEnsemble:
    """Two conflict sets behind a KeyResolverMap, as the reference's
    test builds them: per-resolver clipped sub-transactions, min-combined
    verdicts, attribution mapped back to original range indices and
    unioned, prune per batch."""

    def __init__(self, factory, splits=(b"\x80",)):
        self.n = len(splits) + 1
        self.sets = [factory() for _ in range(self.n)]
        self.map = KeyResolverMap(list(splits), self.n, window=WINDOW)
        self._prev_oldest = 0

    def handoff(self, begin, end, src, dst, at_version,
                release=True) -> None:
        """One live split or merge: move at `at_version`, checkpoint-clip
        the donor, graft the recipient, and (optionally) release the
        donor early."""
        self.map.move(begin, end, dst, at_version)
        piece = clip_checkpoint(self.sets[src].checkpoint(), begin, end)
        self.sets[dst].restore(
            graft_checkpoint(self.sets[dst].checkpoint(), piece))
        if release:
            self.map.release(begin, end, src)

    def resolve_with_attribution(self, txns, version, oldest):
        self.map.prune(version)
        per = [[] for _ in range(self.n)]   # (orig_idx, txn, ri_map)
        withheld = set()
        for idx, t in enumerate(txns):
            if t.read_ranges and t.read_snapshot < self._prev_oldest:
                withheld.add(idx)
                continue
            rr = _clip_with_index(self.map, t.read_ranges, self.n)
            wr = _clip_with_index(self.map, t.write_ranges, self.n)
            placed = False
            for i in range(self.n):
                if rr[i] or wr[i]:
                    per[i].append((idx, ResolverTransaction(
                        t.read_snapshot,
                        tuple((b, e) for b, e, _ in rr[i]),
                        tuple((b, e) for b, e, _ in wr[i])),
                        [ri for _b, _e, ri in rr[i]]))
                    placed = True
            if not placed:
                per[0].append((idx, ResolverTransaction(
                    t.read_snapshot, t.read_ranges, t.write_ranges),
                    list(range(len(t.read_ranges)))))
        verdicts = [TOO_OLD if i in withheld else COMMITTED
                    for i in range(len(txns))]
        attrib = [set() for _ in txns]
        for i in range(self.n):
            batch = [t for _idx, t, _m in per[i]]
            v, a = self.sets[i].resolve_with_attribution(batch, version,
                                                         oldest)
            for (idx, _t, rmap), verdict, idxs in zip(per[i], v, a):
                verdicts[idx] = min(verdicts[idx], verdict)
                for ci in idxs:
                    attrib[idx].add(rmap[ci])
        self._prev_oldest = max(self._prev_oldest, oldest)
        return verdicts, [tuple(sorted(s)) for s in attrib]


def _rand_batches(seed, n_batches, point=False, max_txns=6):
    rng = random.Random(seed)
    out = []
    v = 0

    def key():
        return bytes([rng.randrange(1, 250)]) + b"%02d" % rng.randrange(30)

    def rd():
        k = key()
        if point:
            return (k, k + b"\x00")
        if rng.random() < 0.1:
            return (k, k)            # degenerate (empty) range
        return (k, k + bytes([rng.randrange(1, 8)]))

    for _ in range(n_batches):
        v += rng.randrange(1, 2000)
        batch = []
        for _ in range(rng.randrange(0, max_txns)):
            reads = [rd() for _ in range(rng.randrange(0, 3))]
            writes = [rd() for _ in range(rng.randrange(0, 3))]
            snap = max(0, v - rng.randrange(0, 2 * WINDOW))
            batch.append(txn(snap, reads, writes))
        out.append((batch, v, max(0, v - WINDOW)))
    return out


ENSEMBLE = ("python", "brute-oracle", "native", "cuda", "cuda-point",
            "sharded-cuda", "cuda@card", "cuda-point@card",
            "sharded-cuda@card")


@pytest.mark.parametrize("backend", _params(ENSEMBLE))
def test_split_merge_cycle_attribution_parity(backend):
    """Randomized parity across a dynamic split/merge cycle: verdicts
    and attribution unions bit-identical to a single unsplit resolver at
    every batch, through a static split, a live split with graft and
    early release, a window-mode split (no release, double delivery
    until prune) and a merge back; tooOld and empty-range transactions
    included (point batches on the point backend)."""
    if backend == "brute-oracle":
        # the oracle is the brute-force set (it keeps no checkpoint), the
        # ensemble python sets: parity across models, not only with itself
        oracle, factory = BruteForceConflictSet(), PyConflictSet
    else:
        factory = make_factory(backend)
        oracle = factory()
    ens = SplitEnsemble(factory)
    batches = _rand_batches(31337, 40, point=backend.startswith(
        "cuda-point"))
    phase_at = {10: "split", 20: "window_split", 30: "merge"}
    for bi, (batch, v, oldest) in enumerate(batches):
        phase = phase_at.get(bi)
        if phase == "split":
            ens.handoff(b"\x40", b"\x80", 0, 1, v, release=True)
        elif phase == "window_split":
            ens.handoff(b"\xc0", None, 1, 0, v, release=False)
        elif phase == "merge":
            ens.handoff(b"\x40", b"\x80", 1, 0, v, release=True)
        v1, a1 = oracle.resolve_with_attribution(batch, v, oldest)
        v2, a2 = ens.resolve_with_attribution(batch, v, oldest)
        assert v1 == v2, (backend, bi, phase, v1, v2, batch)
        assert [tuple(x) for x in a1] == list(a2), (
            backend, bi, phase, a1, a2, batch)


# ---------------------------------------------------------- cluster e2e --
def test_off_posture_spawns_nothing_and_counts_nothing():
    """RESOLVER_BALANCE=0 (default): the balance loop is never
    spawned — not one timer event, not one counter — and the status
    rollup reports the off posture."""
    from foundationdb_tpu_torch.client import run_transaction
    from foundationdb_tpu_torch.server import SimCluster
    c = SimCluster(seed=900, n_resolvers=2)
    try:
        db = c.client("off")

        async def main():
            async def body(tr):
                tr.set(b"\x10k", b"v")
            await run_transaction(db, body)
            return await db.get_status()

        status = c.run(main(), timeout_time=120)
        assert c.cc.balance_stats.snapshot() == {}
        bal = status["cluster"]["resolver_balance"]
        assert bal == {"enabled": 0, "splits": 0, "merges": 0,
                       "releases": 0, "handoff_timeouts": 0,
                       "last_split": None}
        aux_names = [t.name for t in c.cc._recovery.aux.tasks]
        assert not any("resolverBalance" in n for n in aux_names), \
            aux_names
        # the legacy work-histogram balancer still runs (unchanged
        # reference behavior)
        assert any("resolutionBalancing" in n for n in aux_names), \
            aux_names
    finally:
        c.shutdown()


@pytest.mark.parametrize("backend", ["python", "cuda"])
def test_forced_split_cluster_end_to_end(backend):
    """Armed + one-shot FORCE on a seeded skewed workload: >=1
    automatic split with live handoff (install + early release), all
    increments exact across the handoff window, and the donor sheds
    owned ranges; on `python` as the reference's case, and on `cuda` at
    `device="cpu"`, whose handoffs checkpoint and graft the plain
    step's history."""
    from foundationdb_tpu_torch import flow
    from foundationdb_tpu_torch.client import run_transaction
    from foundationdb_tpu_torch.server import SimCluster
    c = SimCluster(seed=901, n_resolvers=2, conflict_backend=backend,
                   device="cpu")
    flow.SERVER_KNOBS.set("resolver_balance", 1)
    flow.SERVER_KNOBS.set("resolver_balance_force", 1)
    flow.SERVER_KNOBS.set("resolver_balance_interval", 0.5)
    flow.SERVER_KNOBS.set("resolver_balance_merge_work", -1)
    try:
        dbs = [c.client(f"cl{i}") for i in range(3)]

        async def incr(db, key, n):
            for _ in range(n):
                async def body(tr):
                    cur = await tr.get(key)
                    tr.set(key, b"%d" % (int(cur or b"0") + 1))
                await run_transaction(db, body, max_retries=500)
                await flow.delay(0.05)

        async def main():
            await flow.wait_for_all([
                flow.spawn(incr(dbs[0], b"\x10hot", 30)),
                flow.spawn(incr(dbs[1], b"\x20hot", 30)),
                flow.spawn(incr(dbs[2], b"\x20hot2", 30))])
            vals = []

            async def rd(tr):
                vals.clear()
                for k in (b"\x10hot", b"\x20hot", b"\x20hot2"):
                    vals.append(await tr.get(k))
            await run_transaction(dbs[0], rd)
            return vals, await dbs[0].get_status()

        vals, status = c.run(main(), timeout_time=600)
        assert vals == [b"30", b"30", b"30"], vals
        bal = status["cluster"]["resolver_balance"]
        assert bal["enabled"] == 1
        assert bal["splits"] >= 1, bal
        assert bal["releases"] >= 1, bal
        assert bal["last_split"] is not None
        resolvers = status["cluster"]["resolvers"]
        installs = sum(r["splits"]["installs"] for r in resolvers)
        checkpoints = sum(r["splits"]["checkpoints_served"]
                          for r in resolvers)
        assert installs >= 1 and checkpoints >= 1, resolvers
        owned = [r["splits"].get("owned_ranges") for r in resolvers]
        assert all(o and o >= 1 for o in owned), owned
    finally:
        flow.reset_server_knobs(randomize=False)
        c.shutdown()
