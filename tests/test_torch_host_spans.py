"""Host spans inside the port's `submit_arrays`: the phases that tile
each batch's `submit` span, the waits inside them, their totals in
`kernel_stats()["host"]`, the exact live-row totals, and the kernel
profile's unfenced execute timing. The interval (`cuda`) and sharded
(`sharded-cuda`, 4 shards in lockstep) resolvers on their plain CPU
path, on the packed and the unpacked feed; the `cuda`-marked case runs
them on the card."""

import time
import tracemalloc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import host_spans, testing  # noqa: E402
from foundationdb_tpu_torch.flow.knobs import SERVER_KNOBS  # noqa: E402
from foundationdb_tpu_torch.models.cuda_resolver import (  # noqa: E402
    CudaConflictSet,
)
from foundationdb_tpu_torch.ops import conflict_kernel as ck  # noqa: E402
from foundationdb_tpu_torch.ops.keys import encode_keys  # noqa: E402
from foundationdb_tpu_torch.parallel import (  # noqa: E402
    ShardedCudaConflictSet,
)

KEY_BYTES = 8
BACKENDS = ["cuda", "sharded-cuda"]
FEEDS = ["packed", "unpacked"]
# kernel_stats()["counts"]'s keys, as the reference's parity tests hold
COUNT_KEYS = {"txns", "txn_slots", "reads", "read_slots", "writes",
              "write_slots", "h2d_transfers", "h2d_bytes", "staging_allocs"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=FEEDS)
def feed(request):
    prev = int(SERVER_KNOBS.interval_packed_feed)
    SERVER_KNOBS.set("interval_packed_feed",
                     int(request.param == "packed"))
    yield request.param
    SERVER_KNOBS.set("interval_packed_feed", prev)


def make(backend, device="cpu", capacity=1 << 10):
    if backend == "cuda":
        return CudaConflictSet(key_bytes=KEY_BYTES, capacity=capacity,
                               device=device)
    return ShardedCudaConflictSet(
        key_bytes=KEY_BYTES, capacity=capacity, device=device, n_shards=4,
        split_keys=[bytes([64]), bytes([128]), bytes([192])])


def arrays(batch):
    """A batch of transactions as `submit_arrays`' inputs: the ranges
    flattened in transaction order, keys encoded."""
    snaps = np.array([t.read_snapshot for t in batch], np.int64)
    has_reads = np.array([bool(t.read_ranges) for t in batch])
    out = [snaps, has_reads]
    for side in ("read_ranges", "write_ranges"):
        pairs = [(i, b, e) for i, t in enumerate(batch)
                 for b, e in getattr(t, side) if b < e]
        out += [encode_keys([b for _i, b, _e in pairs], KEY_BYTES),
                encode_keys([e for _i, _b, e in pairs], KEY_BYTES),
                np.array([i for i, _b, _e in pairs], np.int32)]
    return out


def stream(seed, n, max_txns=40, shard0=False, **kw):
    """Pre-encoded batches; with `shard0` every key's first byte is
    divided by 4, so all of them fall in the first of 4 shards."""
    out = []
    for b, v, o in testing.rand_batches(seed, n, max_txns=max_txns, **kw):
        if shard0:
            b = [t._replace(**{side: tuple(
                (bytes([k[0] // 4]) + k[1:], bytes([e[0] // 4]) + e[1:])
                for k, e in getattr(t, side))
                for side in ("read_ranges", "write_ranges")}) for t in b]
        if b:
            out.append((arrays(b), v, o))
    return out


def run(cs, batches):
    """Submits every batch (pipeline depth in flight) and drains all."""
    tickets = [cs.submit_arrays(*a, commit_version=v, new_oldest_version=o)
               for a, v, o in batches]
    return [cs.drain_arrays(t) for t in tickets]


def by_batch(spans):
    out = {}
    for s in spans:
        out.setdefault(s[0], []).append(s)
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_phases_tile_each_submit(backend, feed):
    cs = make(backend)
    cs.trace_spans(True)
    batches = stream(3, 14)
    run(cs, batches)
    spans = cs.traced_spans()
    assert spans and {s[3] for s in spans} <= set(host_spans.NAMES)
    groups = by_batch(spans)
    assert sorted(groups) == list(range(1, len(batches) + 1))
    for seq, group in groups.items():
        ids = {s[1]: s for s in group}
        (submit,) = [s for s in group if s[3] == "submit"]
        assert submit[2] == -1
        phases = sorted((s for s in group if s[2] == submit[1]),
                        key=lambda s: s[4])
        assert {s[3] for s in phases} <= set(host_spans.PHASES[1:])
        # the phases tile submit: no gap, no overlap
        assert phases[0][4] == submit[4] and phases[-1][5] == submit[5]
        for a, b in zip(phases, phases[1:]):
            assert a[5] == b[4], (seq, a, b)
        names = [s[3] for s in phases]
        for need in ("check", "versions", "audit", "stage", "feed",
                     "launch", "readback"):
            assert need in names, (seq, names)
        assert names.index("feed") < names.index("launch") \
            < names.index("readback")
        # a wait lies inside the phase it is a child of
        for w in group:
            if w[3].startswith("wait."):
                parent = ids[w[2]]
                assert parent[3] in host_spans.PHASES[1:]
                assert parent[4] <= w[4] <= w[5] <= parent[5]


@pytest.mark.parametrize("backend", BACKENDS)
def test_totals_equal_the_rings_sums(backend, feed):
    prev = int(SERVER_KNOBS.resolve_pipeline_depth)
    SERVER_KNOBS.set("resolve_pipeline_depth", 2)
    try:
        cs = make(backend)
        cs.trace_spans(True)
        run(cs, stream(4, 14))
    finally:
        SERVER_KNOBS.set("resolve_pipeline_depth", prev)
    host = cs.kernel_stats()["host"]
    spans = cs.traced_spans()
    ids = {s[1]: s for s in spans}
    for name, t in host["phases"].items():
        mine = [s for s in spans if s[3] == name]
        assert t["calls"] == len(mine), name
        assert t["ns"] == sum(s[5] - s[4] for s in mine), name
        waits = [s for s in spans if s[3].startswith("wait.")
                 and (name == "submit" or ids[s[2]][3] == name)]
        assert t["wait_ns"] == sum(s[5] - s[4] for s in waits), name
    for name, t in host["waits"].items():
        mine = [s for s in spans if s[3] == name]
        assert t["count"] == len(mine), name
        assert t["ns"] == sum(s[5] - s[4] for s in mine), name
    # at depth 2 the pipeline drains the oldest batch on every submit
    forced = cs.kernel_stats()["pipeline"]["forced_drains"]
    assert forced > 0
    assert host["waits"]["wait.forced_drain"]["count"] == forced
    assert host["phases"]["submit"]["calls"] == len(by_batch(spans))


@pytest.mark.parametrize("backend", BACKENDS)
def test_growth_and_sync_count_as_waits(backend, feed):
    cs = make(backend)
    # versions close together: nothing leaves the window, so the
    # history outgrows its 1,024 rows a shard
    run(cs, stream(5, 30, max_txns=120, shard0=True, version_stride=10,
                   n_keys=90))
    host = cs.kernel_stats()["host"]
    assert cs._cap > 1 << 10
    assert host["grows"] >= 1
    assert host["waits"]["wait.grow"]["count"] == host["grows"]
    assert host["waits"]["wait.grow"]["ns"] > 0
    syncs = host["waits"]["wait.sync"]["count"]
    a, v, o = stream(6, 1, version_stride=10)[0]
    cs.submit_arrays(*a, commit_version=v + 10 ** 6,
                     new_oldest_version=o)
    cs._sync_count()
    assert cs.kernel_stats()["host"]["waits"]["wait.sync"]["count"] \
        == syncs + 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_live_rows_are_the_historys_rows(backend, feed):
    cs = make(backend)
    batches = stream(7, 12)
    run(cs, batches)
    cs._sync_count()
    live = cs.kernel_stats()["host"]["live"]
    hk, _hv = cs._host_state()
    assert live["live_rows_last"] == int(
        np.count_nonzero(hk[..., -1] != 0xFFFFFFFF))
    assert live["live_rows_last_seq"] == len(batches)
    assert 1 <= live["live_samples"] <= len(batches)
    shards = 4 if backend == "sharded-cuda" else 1
    assert live["capacity_rows_sum"] == \
        live["live_samples"] * shards * cs._cap
    assert 0 < live["live_rows_sum"] <= live["capacity_rows_sum"]
    # the upper bound the audit keeps is not below the exact count
    assert cs.kernel_stats()["state_rows"] * shards >= \
        live["live_rows_last"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_ring_off_is_empty_and_allocates_nothing(backend, feed):
    cs = make(backend)
    batches = stream(8, 40)
    run(cs, batches[:10])
    assert cs.host_spans.ring is None and cs.traced_spans() == []
    tracemalloc.start()
    try:
        run(cs, batches[10:])
        held = tracemalloc.take_snapshot().filter_traces(
            [tracemalloc.Filter(True, host_spans.__file__)])
    finally:
        tracemalloc.stop()
    # what the spans hold after 30 more batches is the totals' current
    # values (a few dozen ints), not a record a batch
    assert sum(t.size for t in held.traces) < 4096
    assert cs.traced_spans() == []
    assert cs.kernel_stats()["host"]["phases"]["submit"]["calls"] == \
        len(batches)


@pytest.mark.parametrize("backend", BACKENDS)
def test_counts_and_h2d_do_not_see_the_spans(backend, feed):
    batches = stream(9, 10)
    stats = []
    for ring in (False, True):
        cs = make(backend)
        cs.trace_spans(ring)
        run(cs, batches)
        stats.append(cs.kernel_stats())
    off, on = stats
    # the unpacked feed stages nothing
    assert set(off["counts"]) == COUNT_KEYS - (
        set() if feed == "packed" else {"staging_allocs"})
    for key in ("counts", "h2d", "occupancy", "batches"):
        assert off[key] == on[key], key
    per = 1 if feed == "packed" else 12
    assert off["h2d"]["transfers"] == per * len(batches)


def test_kernel_profile_folds_execute_time_without_a_wait():
    """A timed call on the card leaves its event pair pending: nothing
    waits for it, and a read folds it in only once its end has fired."""
    class Event:
        def __init__(self, fired):
            self.fired = fired

        def query(self):
            return self.fired

        def elapsed_time(self, _end):
            return 2.5               # ms

    counters = ck.KernelCounters("test_kernel")
    end = Event(False)
    counters.pending.append((Event(True), end, "k[1]"))
    assert "k[1].timed_calls" not in counters.snapshot()
    end.fired = True
    snap = counters.snapshot()
    assert snap["k[1].timed_calls"] == 1
    assert snap["k[1].execute_us"] == 2500
    assert not counters.pending


def test_a_wait_outside_a_batch_counts_under_no_phase():
    with host_spans.wait(None, "wait.fence"):   # no spans: times nothing
        pass
    spans = host_spans.HostSpans()
    spans.trace(True)
    with host_spans.wait(spans, "wait.sync"):
        pass
    st = spans.stats()
    assert st["waits"]["wait.sync"]["count"] == 1
    assert st["phases"]["submit"]["wait_ns"] == 0
    assert [s[2:4] for s in spans.spans()] == [(-1, "wait.sync")]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("backend", BACKENDS)
def test_spans_and_unfenced_profile_on_card(backend, feed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = int(SERVER_KNOBS.kernel_profile_every)
    SERVER_KNOBS.set("kernel_profile_every", 1)      # time every call
    try:
        batches = stream(10, 24)
        cpu = run(make(backend), batches)
        cs = make(backend, device=None)
        cs.trace_spans(True)
        got = run(cs, batches)
        host = cs.kernel_stats()["host"]
        spans = cs.traced_spans()
    finally:
        SERVER_KNOBS.set("kernel_profile_every", prev)
    for (c1, t1), (c2, t2) in zip(cpu, got):
        assert np.array_equal(c1, c2) and np.array_equal(t1, t2)
    for seq, group in by_batch(spans).items():
        (submit,) = [s for s in group if s[3] == "submit"]
        phases = sorted((s for s in group if s[2] == submit[1]),
                        key=lambda s: s[4])
        assert phases[0][4] == submit[4] and phases[-1][5] == submit[5]
        for a, b in zip(phases, phases[1:]):
            assert a[5] == b[4]
        # the one-call submit's parts are the same phases, in order
        names = [s[3] for s in phases]
        if feed == "packed":
            assert names[names.index("stage"):] == ["stage", "feed",
                                                     "launch", "readback"]
    # the packed batches after a bucket's first call took the one-call
    # submit (the unpacked feed never does)
    if feed == "packed":
        assert 0 < host["one_call_batches"] <= len(batches)
    else:
        assert host["one_call_batches"] == 0
    # only a shape bucket's first call is fenced; the timed calls after
    # it wait for nothing, and their times reach the profile once read
    assert host["waits"]["wait.fence"]["count"] < len(batches)
    torch.cuda.synchronize()
    snap = ck.g_kernel_counters.snapshot()
    assert sum(v for k, v in snap.items() if k.endswith(".timed_calls")) > 0


def test_switch_at_tiles_with_times_taken_elsewhere():
    """`switch_at` ends a phase at a clock reading taken by other code
    (the one-call submit's, on the same clock): the phases still tile
    the `submit` span."""
    spans = host_spans.HostSpans()
    spans.trace(True)
    t0 = time.perf_counter_ns()
    spans.begin(t0, 1)
    spans.switch("stage")
    t = [time.perf_counter_ns() for _ in range(3)]
    for phase, at in zip(("feed", "launch", "readback"), t):
        spans.switch_at(phase, at)
    spans.end()
    rows = spans.spans()
    (submit,) = [s for s in rows if s[3] == "submit"]
    phases = [s for s in rows if s[3] != "submit"]
    assert [s[3] for s in phases] == ["check", "stage", "feed", "launch",
                                      "readback"]
    assert [s[4] for s in phases[2:]] == t
    assert phases[0][4] == submit[4] and phases[-1][5] == submit[5]
    for a, b in zip(phases, phases[1:]):
        assert a[5] == b[4]
    st = spans.stats()["phases"]
    assert st["submit"]["ns"] == sum(s[5] - s[4] for s in phases)


def test_ring_keeps_the_newest_spans(monkeypatch):
    monkeypatch.setattr(host_spans, "RING", 8)
    spans = host_spans.HostSpans()
    spans.trace(True)
    for seq in range(1, 4):                 # 3 batches of 4 spans
        spans.begin(seq * 100, seq)
        spans.switch("stage")
        spans.switch("launch")
        spans.end()
    got = spans.spans()
    assert len(got) == 8
    assert [s[0] for s in got] == [2] * 4 + [3] * 4
    assert [s[3] for s in got[-4:]] == ["check", "stage", "launch",
                                        "submit"]
    spans.trace(False)
    assert spans.spans() == [] and spans.ring is None
