"""Port parity for models/failover.py, on the port's backends built with
device="cpu" (the kernels' plain versions behind the same fault seams):
checkpoints restore across every backend with identical verdicts after;
scheduled device faults at each seam with batches in flight fail over
with a verdict stream identical to the fault-free run and to the
reference's CPU baseline; a device fault that outlasts the retries
raises (no CPU fallback unless one is asked for) and a kernel's own
error is not a device fault; with an explicit fallback, seeded faults
fail over to the CPU and reattach; the fallback enforces the primary's
input contract; attributed batches survive failover; shadow validation
catches a sabotaged backend, passes honest ones, and fail-stops when
armed; and the resilient factory asked for the card raises on a host
without one. The key-range sharded backend (4 shards) takes every
case the other device backends take."""

import random

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch.flow.knobs import SERVER_KNOBS  # noqa: E402
from foundationdb_tpu_torch.flow.rng import set_seed  # noqa: E402
from foundationdb_tpu_torch.models import (  # noqa: E402
    COMMITTED,
    TOO_OLD,
    FailoverConflictSet,
    PyConflictSet,
    ResolverTransaction,
    ShadowResolveMismatch,
    create_resilient_conflict_set,
)
from foundationdb_tpu_torch.models.cuda_resolver import (  # noqa: E402
    CudaConflictSet,
)
from foundationdb_tpu_torch.models.point_resolver import (  # noqa: E402
    CudaPointConflictSet,
)
from foundationdb_tpu_torch.ops._build import CudaKernelError  # noqa: E402
from foundationdb_tpu_torch.parallel import (  # noqa: E402
    ShardedCudaConflictSet,
)
from foundationdb_tpu_torch.ops.fault_injection import (  # noqa: E402
    DeviceFaultError,
    convert_device_errors,
    g_device_faults,
)
from foundationdb_tpu.models.conflict_set import (  # noqa: E402
    PyConflictSet as RefPyConflictSet,
)
from test_backend_failover import (  # noqa: E402
    rand_batches as ref_rand_batches,
)


def txn(snapshot, reads=(), writes=()):
    return ResolverTransaction(snapshot, tuple(reads), tuple(writes))


def rand_batches(*args, **kwargs):
    """The reference's failover stream (keys across the whole byte
    range, empty batches, sub-window snapshots) as port transactions."""
    return [([ResolverTransaction(*t) for t in b], v, o)
            for b, v, o in ref_rand_batches(*args, **kwargs)]


def ref_verdicts(*args, attribute=False, **kwargs):
    """The same stream resolved by the reference's CPU baseline."""
    ref = RefPyConflictSet()
    if attribute:
        return [ref.resolve_with_attribution(b, v, o)
                for b, v, o in ref_rand_batches(*args, **kwargs)]
    return [ref.resolve(b, v, o)
            for b, v, o in ref_rand_batches(*args, **kwargs)]


# what the resilient factory passes each backend beyond the device
BACKEND_KW = {"sharded-cuda": {"n_shards": 4}}


def mk(name, **kw):
    if name == "python":
        return PyConflictSet(**kw)
    if name == "cuda":
        return CudaConflictSet(device="cpu", **kw)
    if name == "sharded-cuda":
        return ShardedCudaConflictSet(device="cpu", **BACKEND_KW[name], **kw)
    return CudaPointConflictSet(device="cpu", **kw)


def _factory(backend):
    return lambda: mk(backend)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain steps run on small tensors: one intra-op thread is
    faster here and leaves the other test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def knobs():
    """Set failover knobs for a test; restore the defaults after."""
    names = ("device_fault_injection", "device_fault_retries",
             "conflict_checkpoint_versions", "conflict_replay_log_max",
             "conflict_device_reattach", "device_reattach_backoff",
             "shadow_resolve_sample", "shadow_resolve_fail_stop",
             "resolve_pipeline_depth")
    prev = {n: getattr(SERVER_KNOBS, n) for n in names}
    yield SERVER_KNOBS.set
    for n, v in prev.items():
        SERVER_KNOBS.set(n, v)
    g_device_faults.clear()


# -- checkpoint / restore parity ---------------------------------------

@pytest.mark.parametrize("producer", ("python", "cuda", "sharded-cuda"))
@pytest.mark.parametrize("restorer", ("python", "cuda", "sharded-cuda"))
def test_checkpoint_restore_cross_backend_parity(producer, restorer):
    batches = rand_batches(3, 30)
    a = mk(producer)
    for b, v, o in batches[:20]:
        a.resolve(b, v, o)
    r = mk(restorer)
    r.restore(a.checkpoint())
    assert r.oldest_version == a.oldest_version
    for b, v, o in batches[20:]:
        assert r.resolve(b, v, o) == a.resolve(b, v, o)


def test_point_checkpoint_roundtrip_and_cross_restore():
    """Point-backend checkpoints restore into every backend; an
    interval checkpoint of a point-shaped history restores back into
    the point backend."""
    batches = rand_batches(7, 30, point=True)
    a = mk("cuda-point")
    for b, v, o in batches[:20]:
        a.resolve(b, v, o)
    ck = a.checkpoint()
    restored = {n: mk(n) for n in ("python", "cuda", "cuda-point")}
    for r in restored.values():
        r.restore(ck)
    iv = mk("cuda")
    for b, v, o in batches[:20]:
        iv.resolve(b, v, o)
    back = mk("cuda-point")
    back.restore(iv.checkpoint())
    for b, v, o in batches[20:]:
        want = a.resolve(b, v, o)
        for name, r in restored.items():
            assert r.resolve(b, v, o) == want, name
        assert back.resolve(b, v, o) == want


def test_checkpoint_drains_inflight_pipeline(knobs):
    knobs("resolve_pipeline_depth", 8)
    batches = rand_batches(9, 8)
    a = mk("cuda")
    tickets = [a.submit(b, v, o) for b, v, o in batches]
    ck = a.checkpoint()
    assert ck.last_commit == batches[-1][1]
    r = mk("python")
    r.restore(ck)
    serial = mk("cuda")
    for b, v, o in batches:
        serial.resolve(b, v, o)
    assert r.checkpoint().assignments == serial.checkpoint().assignments
    drained = [a.drain(t) for t in tickets]
    fresh = mk("cuda")
    assert drained == [fresh.resolve(b, v, o) for b, v, o in batches]


def test_restore_rejects_non_point_checkpoint():
    iv = mk("cuda")
    iv.resolve([txn(0, writes=[(b"a", b"q")])], 100, 0)
    with pytest.raises(ValueError):
        mk("cuda-point").restore(iv.checkpoint())


def test_restore_after_rebase_window():
    mwtlv = 5_000_000
    a, ref = mk("cuda"), mk("python")
    rng = random.Random(13)
    v = 0
    for _ in range(12):
        v += 300_000_000
        batch = [txn(v - rng.randrange(0, mwtlv // 2),
                     reads=[(b"a", b"c")] if rng.random() < 0.5 else [],
                     writes=[(b"b", b"b\x00")] if rng.random() < 0.5 else [])
                 for _ in range(5)]
        assert a.resolve(batch, v, v - mwtlv) == \
            ref.resolve(batch, v, v - mwtlv)
    assert a._base > 0
    r, r2 = mk("cuda"), mk("python")
    r.restore(a.checkpoint())
    r2.restore(a.checkpoint())
    for _ in range(4):
        v += 300_000_000
        batch = [txn(v - rng.randrange(0, mwtlv // 2),
                     reads=[(b"a", b"c")], writes=[(b"d", b"e")])]
        want = a.resolve(batch, v, v - mwtlv)
        assert r.resolve(batch, v, v - mwtlv) == want
        assert r2.resolve(batch, v, v - mwtlv) == want


# -- failover determinism ----------------------------------------------

FAULT_BACKENDS = ("cuda", "cuda-point", "sharded-cuda")


def _run_pipelined(cs, batches, window=4):
    got, pending = [], []
    for b, v, o in batches:
        pending.append(cs.submit(b, v, o))
        if len(pending) >= window:
            got.append(cs.drain(pending.pop(0)))
    got.extend(cs.drain(t) for t in pending)
    return got


@pytest.mark.parametrize("backend", FAULT_BACKENDS)
@pytest.mark.parametrize("point_of_fault",
                         ("submit", "materialize", "drain"))
def test_midwindow_failover_is_bit_identical(backend, point_of_fault,
                                             knobs):
    """Scheduled device faults at each seam with 4 batches in flight:
    the verdict stream equals the fault-free run, the rebuilds land back
    on a fresh primary, and nothing fails over to the CPU."""
    knobs("resolve_pipeline_depth", 4)
    knobs("conflict_checkpoint_versions", 6000)
    knobs("conflict_replay_log_max", 64)
    set_seed(42)
    batches = rand_batches(11, 30, point=backend == "cuda-point")
    plain = mk(backend)
    want = [plain.resolve(b, v, o) for b, v, o in batches]

    fo = FailoverConflictSet(_factory(backend), backend_name=backend)
    got, pending = [], []
    for i, (b, v, o) in enumerate(batches):
        if i in (5, 13, 22):
            g_device_faults.schedule(point_of_fault)
        pending.append(fo.submit(b, v, o))
        if len(pending) >= 4:
            got.append(fo.drain(pending.pop(0)))
    got.extend(fo.drain(t) for t in pending)
    assert got == want
    assert got == ref_verdicts(11, 30, point=backend == "cuda-point")
    st = fo.failover_stats()
    assert st["device_faults"] >= 3 and st["replayed_batches"] > 0, st
    assert st["device_recoveries"] >= 1 and st["failovers"] == 0, st
    assert st["on_primary"] and st["active_backend"] == backend


def test_seeded_faults_failover_to_cpu_and_reattach(knobs):
    """Seeded faults with zero device retries and an explicit CPU
    fallback: the wrapper declares the device dead, serves identical
    verdicts from the fallback, and reattaches once the device is
    healthy."""
    set_seed(7)
    knobs("device_fault_retries", 0)
    knobs("conflict_device_reattach", 0)
    knobs("conflict_checkpoint_versions", 6000)
    batches = rand_batches(11, 30)
    plain = mk("cuda")
    want = [plain.resolve(b, v, o) for b, v, o in batches]
    assert want == ref_verdicts(11, 30)
    fo = FailoverConflictSet(_factory("cuda"), PyConflictSet,
                             backend_name="cuda")
    knobs("device_fault_injection", 0.15)
    assert [fo.resolve(b, v, o) for b, v, o in batches] == want
    st = fo.failover_stats()
    assert st["failovers"] >= 1 and not st["on_primary"], st
    assert st["active_backend"] == "python"

    SERVER_KNOBS.set("device_fault_injection", 0.0)
    SERVER_KNOBS.set("conflict_device_reattach", 1)
    v0 = batches[-1][1]
    tail = [(b, v0 + v, max(0, v0 + v - 5000))
            for b, v, _o in rand_batches(12, 5)]
    ref = RefPyConflictSet()
    for b, v, o in ref_rand_batches(11, 30):
        ref.resolve(b, v, o)
    for (b, v, o), (rb, _v, _o) in zip(tail, ref_rand_batches(12, 5)):
        got = fo.resolve(b, v, o)
        assert got == plain.resolve(b, v, o) == ref.resolve(rb, v, o)
    st = fo.failover_stats()
    assert st["on_primary"] and st["reattaches"] == 1, st


@pytest.mark.parametrize("bad_batch", [
    [(b"x" * 33, b"x" * 33 + b"\x00")],   # key wider than the bucket
    [(b"a", b"z")],                       # non-point range
], ids=["wide-key", "interval-range"])
def test_fallback_enforces_primary_input_contract(bad_batch, knobs):
    knobs("device_fault_retries", 0)
    knobs("conflict_device_reattach", 1)
    knobs("device_reattach_backoff", 0.0)
    fo = FailoverConflictSet(_factory("cuda-point"), PyConflictSet,
                             backend_name="cuda-point")
    fo.resolve([txn(0, writes=[(b"a", b"a\x00")])], 100, 0)
    g_device_faults.schedule("submit")
    fo.resolve([txn(50, writes=[(b"b", b"b\x00")])], 200, 0)
    assert not fo.on_primary
    with pytest.raises(ValueError):
        fo.resolve([txn(150, writes=bad_batch)], 300, 0)
    assert fo.resolve([txn(150, writes=[(b"c", b"c\x00")])], 300, 0) \
        == [COMMITTED]
    st = fo.failover_stats()
    assert st["on_primary"] and st["reattach_failures"] == 0, st


def test_fallback_skips_contract_check_for_too_old(knobs):
    knobs("device_fault_retries", 0)
    knobs("conflict_device_reattach", 0)
    wide = (b"x" * 33, b"x" * 33 + b"\x00")
    want = None
    for faulted in (False, True):
        cs = FailoverConflictSet(_factory("cuda-point"), PyConflictSet,
                                 backend_name="cuda-point")
        cs.resolve([txn(0, writes=[(b"a", b"a\x00")])], 100, 50)
        if faulted:
            g_device_faults.schedule("submit")
        cs.resolve([txn(60, writes=[(b"b", b"b\x00")])], 150, 50)
        assert cs.on_primary is (not faulted)
        got = cs.resolve([txn(10, reads=[wide], writes=[wide])], 200, 50)
        want = got if want is None else want
        assert got == want == [TOO_OLD]


def test_attributed_batches_survive_failover(knobs):
    knobs("conflict_checkpoint_versions", 10 ** 9)
    set_seed(21)
    batches = rand_batches(5, 20)
    plain = mk("cuda")
    want = [plain.resolve_with_attribution(b, v, o) for b, v, o in batches]
    fo = FailoverConflictSet(_factory("cuda"), backend_name="cuda")
    got = []
    for i, (b, v, o) in enumerate(batches):
        if i in (4, 11):
            g_device_faults.schedule("materialize")
        got.append(fo.resolve_with_attribution(b, v, o))
    assert got == want
    assert got == ref_verdicts(5, 20, attribute=True)
    assert fo.failover_stats()["device_faults"] >= 2


@pytest.mark.parametrize("backend", FAULT_BACKENDS)
@pytest.mark.parametrize("retries", (0, 2))
def test_device_fault_past_retries_raises(backend, retries, knobs):
    """The resilient factory's wrapper has no CPU fallback: a fault that
    every fresh device backend repeats raises DeviceFaultError after
    DEVICE_FAULT_RETRIES rebuilds, and no verdict comes from the CPU."""
    knobs("device_fault_retries", retries)
    knobs("conflict_checkpoint_versions", 10 ** 9)
    set_seed(5)
    batches = rand_batches(13, 12, point=backend == "cuda-point")
    fo = create_resilient_conflict_set(backend, device="cpu",
                                       **BACKEND_KW.get(backend, {}))
    for b, v, o in batches[:8]:
        fo.resolve(b, v, o)
    knobs("device_fault_injection", 1.0)
    b, v, o = batches[8]
    with pytest.raises(DeviceFaultError, match="no CPU fallback"):
        fo.resolve(b, v, o)
    st = fo.failover_stats()
    assert st["device_faults"] == 1 and st["failovers"] == 0, st
    assert st["on_primary"] and st["active_backend"] == backend


def test_rebuild_is_one_seam_for_the_injector(knobs):
    """A failover rebuild draws once (`one_seam`) and its replay not at
    all: at rate 1.0 the entry draw faults, inside `quiet` no seeded
    draw does, and a scheduled fault still fires there."""
    knobs("device_fault_injection", 1.0)
    with pytest.raises(DeviceFaultError, match="rebuild"):
        g_device_faults.one_seam("cuda.rebuild")
    with g_device_faults.quiet():
        for point in ("submit", "materialize", "drain"):
            g_device_faults.check(point, "replay")
        g_device_faults.schedule("drain")
        with pytest.raises(DeviceFaultError, match="scheduled"):
            g_device_faults.check("drain", "replay")
    with pytest.raises(DeviceFaultError, match="injected"):
        g_device_faults.check("submit", "after")


def test_faults_in_flight_after_a_recovery_get_their_own_retries(knobs):
    """A fault at drain, then a fault at the next submit before any
    ticket drains from the device: each is its own fault with its own
    rebuilds, so two retries absorb both, on the device."""
    knobs("device_fault_retries", 1)
    knobs("conflict_checkpoint_versions", 10 ** 9)
    knobs("resolve_pipeline_depth", 4)
    set_seed(9)
    batches = rand_batches(14, 12)
    plain = mk("cuda")
    want = [plain.resolve(b, v, o) for b, v, o in batches]
    fo = FailoverConflictSet(_factory("cuda"), backend_name="cuda")
    got, pending = [], []
    for i, (b, v, o) in enumerate(batches):
        if i == 6:
            g_device_faults.schedule("drain")
        if i == 7:
            g_device_faults.schedule("submit")
        pending.append(fo.submit(b, v, o))
        if len(pending) >= 4:
            got.append(fo.drain(pending.pop(0)))
    got.extend(fo.drain(t) for t in pending)
    assert got == want
    st = fo.failover_stats()
    assert st["device_faults"] == 2 and st["device_recoveries"] == 2, st
    assert st["failovers"] == 0 and st["on_primary"], st


class _KernelBugBackend(PyConflictSet):
    """A backend whose kernel reports an error of its own at launch."""

    BACKEND = "kernel-bug"

    def submit(self, txns, commit_version, new_oldest_version,
               attribute=False):
        with convert_device_errors("submit", self.BACKEND):
            raise CudaKernelError("point_resolve: bad arguments (code 1)")


def test_kernel_error_is_not_a_device_fault(knobs):
    """An error the port's kernels report escapes as it is: it is not
    retried, not replayed and not routed around; a lost device (memory
    exhausted) is still a device fault."""
    with pytest.raises(DeviceFaultError):
        with convert_device_errors("submit", "oom"):
            raise torch.cuda.OutOfMemoryError("out of memory")
    fo = FailoverConflictSet(_KernelBugBackend, PyConflictSet,
                             backend_name="kernel-bug")
    with pytest.raises(CudaKernelError):
        fo.resolve([txn(0, writes=[(b"a", b"a\x00")])], 100, 0)
    st = fo.failover_stats()
    assert st["device_faults"] == 0 and st["failovers"] == 0, st
    assert st["on_primary"] and st["active_backend"] == "kernel-bug"


# -- shadow validation --------------------------------------------------

class _SabotagedBackend(PyConflictSet):
    """A backend whose kernel 'went wrong': state evolves by its own
    (wrong) beliefs while verdicts claim everything committed."""

    BACKEND = "sabotaged"

    def _resolve(self, txns, commit_version, new_oldest_version, collect):
        out = super()._resolve(txns, commit_version, new_oldest_version,
                               collect)
        return [COMMITTED for _ in out]


def test_shadow_validation_catches_sabotaged_backend(knobs):
    knobs("shadow_resolve_sample", 1)
    knobs("conflict_checkpoint_versions", 6000)
    set_seed(33)
    fo = FailoverConflictSet(lambda: _SabotagedBackend(),
                             backend_name="sabotaged")
    for b, v, o in rand_batches(3, 30):
        fo.resolve(b, v, o)
    st = fo.failover_stats()["shadow"]
    assert st["sampled"] > 0
    assert st["mismatches"] > 0, st
    assert fo.last_mismatch["got"] != fo.last_mismatch["want"]


@pytest.mark.parametrize("backend", FAULT_BACKENDS)
def test_shadow_validation_passes_honest_backend(backend, knobs):
    knobs("shadow_resolve_sample", 1)
    knobs("conflict_checkpoint_versions", 6000)
    set_seed(34)
    fo = FailoverConflictSet(_factory(backend), backend_name=backend)
    _run_pipelined(fo, rand_batches(4, 25, point=backend == "cuda-point"))
    st = fo.failover_stats()["shadow"]
    assert st["sampled"] > 0
    assert st["mismatches"] == 0, (backend, st)


def test_shadow_fail_stop_halts(knobs):
    knobs("shadow_resolve_sample", 1)
    knobs("shadow_resolve_fail_stop", 1)
    set_seed(35)
    fo = FailoverConflictSet(lambda: _SabotagedBackend(),
                             backend_name="sabotaged")
    with pytest.raises(ShadowResolveMismatch):
        for b, v, o in rand_batches(3, 30):
            fo.resolve(b, v, o)


# -- the cluster surface ------------------------------------------------

def test_cluster_failover_counters_in_status_and_exporter(knobs):
    """A cuda-backed SimCluster (device="cpu") with seeded fault
    injection: every fault is recovered on a fresh device backend, commits
    keep succeeding, and the failover/shadow counters surface in
    status, `status details`, the health messages, and the exporter."""
    from foundationdb_tpu_torch import flow
    from foundationdb_tpu_torch.client import run_transaction
    from foundationdb_tpu_torch.server import SimCluster
    from foundationdb_tpu_torch.tools.cli import Cli
    from foundationdb_tpu_torch.tools.exporter import (parse_prometheus,
                                                       render_prometheus)

    cluster = SimCluster(seed=606, durable=True, conflict_backend="cuda",
                         device="cpu")
    # knobs AFTER SimCluster re-initializes them
    flow.SERVER_KNOBS.set("device_fault_injection", 0.05)
    flow.SERVER_KNOBS.set("conflict_checkpoint_versions", 200_000)
    flow.SERVER_KNOBS.set("shadow_resolve_sample", 2)
    cli = Cli.for_cluster(cluster)
    try:
        db = cluster.client("fo")

        async def main():
            for i in range(25):
                async def body(tr, i=i):
                    await tr.get(b"fo%02d" % (i % 7))
                    tr.set(b"fo%02d" % (i % 7), b"v%d" % i)
                await run_transaction(db, body, max_retries=200)
            return await db.get_status()

        status = cluster.run(main(), timeout_time=600)
        res = status["cluster"]["resolvers"]
        assert res
        fo = res[0]["failover"]
        assert fo, "no failover section for a device backend"
        assert fo["shadow"]["sample"] == 2
        assert fo["shadow"]["sampled"] > 0
        assert fo["shadow"]["mismatches"] == 0, fo
        assert fo["checkpoints"] >= 0
        assert fo["device_faults"] > 0, fo
        assert fo["device_recoveries"] == fo["device_faults"], fo
        assert fo["failovers"] == 0 and fo["on_primary"], fo
        details = cli.execute("status details")
        assert "Backend failover:" in details
        assert "active=" in details
        names = {n for n, _, _ in
                 parse_prometheus(render_prometheus(status))}
        for need in ("fdbtpu_conflict_failover_on_primary",
                     "fdbtpu_conflict_failover_device_faults",
                     "fdbtpu_shadow_resolve_sampled",
                     "fdbtpu_shadow_resolve_mismatches"):
            assert need in names, need
    finally:
        flow.SERVER_KNOBS.set("device_fault_injection", 0.0)
        flow.SERVER_KNOBS.set("shadow_resolve_sample", 0)
        cluster.shutdown()


def test_cluster_fault_past_retries_fails_the_run(knobs):
    """The reference's cluster case with no device retries: the first
    device fault outlasts them, and the port's cluster stops with
    DeviceFaultError instead of resolving on the CPU."""
    from foundationdb_tpu_torch import flow
    from foundationdb_tpu_torch.client import run_transaction
    from foundationdb_tpu_torch.ops.fault_injection import DeviceFaultError
    from foundationdb_tpu_torch.server import SimCluster

    cluster = SimCluster(seed=606, durable=True, conflict_backend="cuda",
                         device="cpu")
    flow.SERVER_KNOBS.set("device_fault_injection", 0.05)
    flow.SERVER_KNOBS.set("device_fault_retries", 0)
    flow.SERVER_KNOBS.set("conflict_checkpoint_versions", 200_000)
    flow.SERVER_KNOBS.set("shadow_resolve_sample", 2)
    try:
        db = cluster.client("fo")

        async def main():
            for i in range(25):
                async def body(tr, i=i):
                    await tr.get(b"fo%02d" % (i % 7))
                    tr.set(b"fo%02d" % (i % 7), b"v%d" % i)
                await run_transaction(db, body, max_retries=200)
            return True

        with pytest.raises(DeviceFaultError, match="no CPU fallback"):
            cluster.run(main(), timeout_time=600)
    finally:
        flow.SERVER_KNOBS.set("device_fault_injection", 0.0)
        flow.SERVER_KNOBS.set("shadow_resolve_sample", 0)
        cluster.shutdown()


# -- the resilient factory ----------------------------------------------

def test_resilient_factory(monkeypatch):
    from foundationdb_tpu_torch import device
    fo = create_resilient_conflict_set("cuda-point", device="cpu",
                                       key_bytes=16)
    assert isinstance(fo, FailoverConflictSet)
    assert isinstance(fo.active, CudaPointConflictSet)
    assert fo.active._key_bytes == 16
    assert isinstance(create_resilient_conflict_set("python"), PyConflictSet)
    fo = create_resilient_conflict_set("sharded-cuda", device="cpu",
                                       n_shards=4, split_keys=[b"1", b"2",
                                                               b"3"])
    assert isinstance(fo.active, ShardedCudaConflictSet)
    assert fo.active._split_keys == [b"", b"1", b"2", b"3"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in FAULT_BACKENDS:
        with pytest.raises(device.NoCudaDeviceError):
            create_resilient_conflict_set(backend)
