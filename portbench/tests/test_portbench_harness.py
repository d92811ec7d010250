"""The harness on the port's plain CPU path at a small size: a sound
run comes out correct, and each fault a cell can have, planted under
the timed path, makes it come out not correct."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness, trace
from portbench.gen.batches import key_bytes_of

SMALL = {"txns_per_batch": 64, "version_step": 833_334,
         "pool_past_window": 4, "warmup_past_window": 4,
         "edge_probes": 4}
CELLS = ["skiplist-1r.uniform", "ycsbf-4r.zipf", "ycsbf-4r.uniform"]


def small(cell):
    config = {"keyspace": 3000}
    if cell.startswith("ycsbf"):
        keys = sorted(key_bytes_of(np.arange(3000),
                                   {"key_format": "ycsb", "key_bytes": 24}))
        config["backend_kwargs"] = {
            "n_shards": 4,
            "split_keys": [keys[q * 750].decode() for q in (1, 2, 3)]}
    return {"config": config, "traffic": SMALL}


def run(cell, wrap=None, seed=2 ** 31 + 5, trace_on=False):
    return harness.run_cell(cell, seed, 0.4, trace_on, device="cpu",
                            overrides=small(cell), wrap=wrap)


def test_cells_found_by_name_from_files():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        cell, config, traffic = harness.find_cell(w["name"], bench)
        assert config["name"] == w["config"]
        assert os.path.exists(os.path.join(
            harness.HERE, "gen", traffic["generator"] + ".py"))
    for m in bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
    with pytest.raises(KeyError):
        harness.find_cell("no-such.cell", bench)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"] and r["failed"] == 0
    assert r["checks"]["verdict_mismatches"]["value"] == 0
    assert set(r["metrics"]) == {"txn_per_s", "resolve_p95_ms",
                                 "device_mem_gib", "setup_s"}
    assert list(r)[-1] == "checks"
    json.dumps(r)


def test_run_crosses_a_rebase():
    seen = {}

    def keep(cs):
        seen["cs"] = cs
        return cs
    r = run("skiplist-1r.uniform", wrap=keep)
    assert r["correct"]
    assert seen["cs"]._base > 0        # the history was re-based (K4)


def test_traced_run_reads_host_metrics():
    r = run("skiplist-1r.uniform", trace_on=True)
    assert r["correct"]
    # on the CPU there is no device trace: those metrics are left out
    assert set(r["metrics"]) == {"host.submit_ms", "host.h2d_per_batch"}
    assert r["metrics"]["host.h2d_per_batch"]["value"] == 1.0


class HalfBatch:
    """Resolves only the first half of each batch; the rest reads as
    committed."""

    def __init__(self, cs):
        self.cs = cs

    def submit_arrays(self, snap, has_reads, rb, re, rt, wb, we, wt,
                      **kw):
        h = snap.shape[0] // 2
        return (snap.shape[0], self.cs.submit_arrays(
            snap[:h], has_reads[:h], rb[:h], re[:h], rt[:h], wb[:h],
            we[:h], wt[:h], **kw))

    def drain_arrays(self, ticket):
        n, inner = ticket
        c, t = self.cs.drain_arrays(inner)
        pad = np.zeros(n - c.shape[0], bool)
        return np.concatenate([c, pad]), np.concatenate([t, pad])


class Altered:
    """Flips the first transaction's verdict where it is produced."""

    def __init__(self, cs):
        self.cs = cs

    def submit_arrays(self, *a, **kw):
        return self.cs.submit_arrays(*a, **kw)

    def drain_arrays(self, ticket):
        c, t = self.cs.drain_arrays(ticket)
        c = np.array(c, bool)
        c[0] = not c[0]
        return c, t


class EarlyGC:
    """Moves the window's oldest version a batch ahead of the one
    given: the history's GC runs a batch early."""

    def __init__(self, cs):
        self.cs = cs

    def submit_arrays(self, *a, new_oldest_version, **kw):
        return self.cs.submit_arrays(
            *a, new_oldest_version=new_oldest_version + SMALL["version_step"],
            **kw)

    def drain_arrays(self, ticket):
        return self.cs.drain_arrays(ticket)


def unchanged_state(cs):
    """Each step returns the history it was given."""
    cs._swap_in = lambda hk, hv: None
    return cs


@pytest.mark.parametrize("cell", ["skiplist-1r.uniform", "ycsbf-4r.zipf"])
@pytest.mark.parametrize("fault", [unchanged_state, HalfBatch, Altered,
                                   EarlyGC])
def test_fault_is_caught(cell, fault):
    r = run(cell, wrap=fault)
    assert not r["correct"]
    assert r["checks"]["verdict_mismatches"]["value"] > 0


def test_closed_loop_read_versions():
    cell = "skiplist-1r.uniform"
    _c, config, traffic = harness.find_cell(cell)
    over = small(cell)
    config = {**config, **over["config"]}
    traffic = {**traffic, **over["traffic"]}
    pool = harness.generator(traffic).Pool(config, traffic, 7)
    loop = harness.Loop(harness.NullResolver(), pool, config, traffic)
    loop.run_batches(20)
    for i in range(20):
        # the newest commit drained before the batch, and the oldest
        # version as the batch finds it
        read_version = loop.version(max(i - loop.depth, -1))
        edge = max(0, loop.version(i - 1) - loop.mwtlv) if i else 0
        assert loop.reads[i] == (read_version, edge)


class FakeEvent:
    def __init__(self, name, start, dur, on_card=True):
        self._n, self._s, self._d, self._c = name, start, dur, on_card

    def device_type(self):
        return "DeviceType.CUDA" if self._c else "DeviceType.CPU"

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def test_trace_maps_the_host_clock():
    # the card's clock runs 5 ms ahead of the host's
    off, ms = 5_000_000, 1_000_000
    events = [FakeEvent(trace.MARKER, off + 0, 10), FakeEvent("k", off + 2 * ms,
                                                              3 * ms),
              FakeEvent("cudaLaunchKernel", 1, 1, on_card=False),
              FakeEvent(trace.MARKER, off + 20 * ms, 10)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    spans = [(4 * ms, 6 * ms, "submit"), (8 * ms, 9 * ms, "drain")]
    s = trace.summarize(prof, spans, (1 * ms, 11 * ms), (0, 20 * ms))
    assert s.window_s == pytest.approx(0.010)
    assert s.busy_s == pytest.approx(0.003)        # the marker left out
    assert dict(s.breakdown["idle_gaps"]) == pytest.approx(
        {"submit": 0.001, "drain": 0.001, "loop": 0.005})
    assert s.host["clock_offset_ns"] == off


def test_trace_reduction():
    ms = 1_000_000
    device = [(0, 2 * ms, "k1", "kernel"), (1 * ms, 3 * ms, "k2", "kernel"),
              (5 * ms, 6 * ms, "Memcpy HtoD", "copy"),
              (9 * ms, 12 * ms, "k1", "kernel")]
    spans = [(3 * ms, 5 * ms, "submit"), (6 * ms, 7 * ms, "drain")]
    s = trace.reduce_events(device, spans, (0, 10 * ms))
    assert s.window_s == pytest.approx(0.010)
    assert s.busy_s == pytest.approx(0.005)          # 0-3, 5-6, 9-10
    assert s.kernel_s == pytest.approx(0.005)        # 2 + 2 + 1
    assert dict(s.breakdown["idle_gaps"]) == pytest.approx(
        {"submit": 0.002, "drain": 0.001, "loop": 0.002})
    assert s.breakdown["device_ops"][0][0] == "k1"


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("kind", ["no_intra_batch", "no_history"])
def test_control_is_not_correct(cell, kind):
    from portbench import control
    r = control.run_control(cell, 2 ** 31 + 21, 40, kind,
                            overrides=small(cell))
    assert not r["correct"]
    assert r["checks"]["verdict_mismatches"]["value"] > 0
