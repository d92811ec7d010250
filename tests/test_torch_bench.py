"""The port's bench entry (`python -m foundationdb_tpu_torch.bench`) and
its native C++ baseline: the entry prints one JSON line with every
`all` cross-check met on the plain versions (`--cpu`), its parity gate
passes (`--dry --cpu`) and fails, as the packed mode refuses to publish,
when the unpacked feed diverges; it exits 2 without a card and never falls back
to the CPU; the port's NativeConflictSet gives the reference's
NativeConflictSet and PyConflictSet verdicts and attribution; the
chains' capacity audit raises on a cap that is too small; the entry
imports nothing of JAX or of the JAX package."""

import json
import os
import random
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu.models import PyConflictSet as RefPy  # noqa: E402
from foundationdb_tpu.models import (  # noqa: E402
    ResolverTransaction as RefTxn,
)
from foundationdb_tpu.models.native_backend import (  # noqa: E402
    NativeConflictSet as RefNative,
)
from foundationdb_tpu_torch.models import (  # noqa: E402
    CONFLICT_BACKENDS,
    ResolverTransaction,
    create_conflict_set,
)
from foundationdb_tpu_torch.models.native_backend import (  # noqa: E402
    NativeConflictSet,
    native_available,
)
from foundationdb_tpu_torch.ops import bench_chain as bc  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"FDBTPU_BENCH_TXNS": "64", "FDBTPU_BENCH_BATCHES": "6",
         "FDBTPU_BENCH_KEYS": "3000", "FDBTPU_BENCH_REPEATS": "1"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread is faster here and leaves the
    other test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_entry(*args, env=None):
    """The entry in a subprocess, on one intra-op thread (as above)."""
    e = dict(os.environ, OMP_NUM_THREADS="1")
    e.update(env or {})
    return subprocess.run([sys.executable, "-m", "foundationdb_tpu_torch.bench",
                           *args], cwd=ROOT, env=e, capture_output=True,
                          text=True, timeout=300)


def test_entry_all_prints_one_line_with_every_cross_check():
    r = run_entry("--cpu", env=SMALL)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "resolver_throughput" and rec["value"] > 0
    cfg = rec["config"]
    assert cfg["device"] == {"name": "cpu", "power_limit": None}
    assert (cfg["batch_txns"], cfg["batches"], cfg["keyspace"]) == (64, 6,
                                                                    3000)
    sub = rec["sub_metrics"]
    for mode in ("cuda-point", "cuda", "cuda-streamed",
                 "cuda-streamed-interval", "cuda-packed", "cuda-pipelined",
                 "native", "python", "native-streamed", "transport"):
        assert mode in sub
    checks = sub["cross_checks"]
    chains = set(checks["chains_equal"].values())
    streamed = set(checks["streamed_equal"].values())
    assert len(chains) == 1 and len(streamed) == 1
    assert len(set(checks["pipelined_equal_across_depths"].values())) == 1
    assert len(set(checks["native_rows_equal"].values())) == 1
    assert set(checks["packed_equal"].values()) == streamed
    # the streamed rows, the pipelined sweep and the native rows resolve
    # the same seeded batches (the CPU rows over a capped prefix)
    assert streamed == set(checks["pipelined_equal_across_depths"].values())
    assert cfg["conflicts"] == sub["cuda-streamed"]["conflicts"] > 0
    assert chains.pop() > 0
    assert sub["cuda-pipelined"]["txn_per_s_by_depth"].keys() == {"1", "2",
                                                                 "4", "8"}
    assert sub["cuda-streamed"]["h2d"]["per_batch"] == 1.0
    packed = sub["cuda-packed"]
    assert packed["h2d_packed"]["per_batch"] == 1.0
    assert packed["h2d_unpacked"]["per_batch"] == 12.0
    assert packed["unpacked_txn_per_s"] > 0 and packed["speedup_vs_unpacked"]


@pytest.mark.parametrize("mode", ("cuda-point", "cuda", "cuda-packed",
                                  "native-streamed"))
def test_entry_single_modes(mode):
    r = run_entry("--cpu", env={**SMALL, "FDBTPU_BENCH_BACKEND": mode})
    assert r.returncode == 0, r.stderr
    rec = json.loads(r.stdout.strip())
    assert rec["config"]["backend"] == mode and rec["value"] > 0
    assert mode in rec["sub_metrics"]


def test_entry_rejects_an_unknown_mode():
    r = run_entry("--cpu", env={**SMALL, "FDBTPU_BENCH_BACKEND": "tpu"})
    assert r.returncode != 0 and "FDBTPU_BENCH_BACKEND" in r.stderr


def test_entry_dry_parity_gate():
    r = run_entry("--dry", "--cpu", env={"FDBTPU_BENCH_DRY_BATCHES": "30"})
    assert r.returncode == 0, r.stderr
    rec = json.loads(r.stdout.strip())
    assert rec["ok"] is True and rec["dry"] is True and rec["conflicts"] > 0


def flip_unpacked_verdicts(monkeypatch):
    """Break the unpacked step (every conflict flag inverted), as a
    diverging unpacked feed would."""
    from foundationdb_tpu_torch.ops import conflict_kernel as ck
    real = ck.resolve_step

    def flipped(*a, **k):
        hk, hv, count, conflict, read_hit = real(*a, **k)
        return hk, hv, count, ~conflict, read_hit

    monkeypatch.setattr(ck, "resolve_step", flipped)


def test_dry_gate_fails_when_the_unpacked_feed_diverges(monkeypatch,
                                                        capsys):
    from foundationdb_tpu_torch import bench
    flip_unpacked_verdicts(monkeypatch)
    monkeypatch.setenv("FDBTPU_BENCH_DRY_BATCHES", "6")
    assert bench.run_dry(torch.device("cpu")) == 1
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["ok"] is False and "packed vs unpacked" in rec["error"]


def test_packed_mode_refuses_diverging_counts(monkeypatch):
    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch.flow.knobs import SERVER_KNOBS
    flip_unpacked_verdicts(monkeypatch)
    with pytest.raises(RuntimeError, match="refusing to publish"):
        bench.bench_packed(64, 3, 3000, torch.device("cpu"))
    assert int(SERVER_KNOBS.interval_packed_feed) == 1


@pytest.mark.parametrize("args", ((), ("--dry",)))
def test_entry_without_a_card_exits_2(args):
    r = run_entry(*args, env={**SMALL, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 2
    rec = json.loads(r.stdout.strip())
    assert rec["value"] == 0 and "no CUDA device" in rec["error"]
    assert "sub_metrics" not in rec


def test_chains_without_a_card_raise(monkeypatch):
    from foundationdb_tpu_torch.device import NoCudaDeviceError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kind in ("point", "interval"):
        with pytest.raises(NoCudaDeviceError):
            bc.BenchChain(kind, 64, 1000)


def test_entry_imports_no_jax():
    code = ("import sys, foundationdb_tpu_torch.bench as b, "
            "foundationdb_tpu_torch.ops.bench_chain, "
            "foundationdb_tpu_torch.models.native_backend; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'foundationdb_tpu' "
            "or m.startswith('foundationdb_tpu.')]; "
            "assert not bad, bad; print('clean')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "clean", r.stderr


@pytest.mark.parametrize("kind", ("point", "interval"))
def test_capacity_audit_raises_on_a_small_cap(kind):
    chain = bc.BenchChain(kind, 64, 100_000, device="cpu", cap=256)
    chain.run(4)
    with pytest.raises(RuntimeError, match="capacity overflow"):
        chain.audit()


@pytest.mark.parametrize("kind", ("point", "interval"))
def test_capacity_audit_passes_at_the_reference_cap(kind):
    n, chain = (bc.run_point_chain if kind == "point"
                else bc.run_interval_chain)(64, 4, 100_000, device="cpu")
    assert int(chain.count) <= chain.cap - chain.slack
    assert chain.steps == 4 + (2 if kind == "point" else 1)
    assert 0 <= n <= chain.conflicts()


def test_batches_past_the_int32_window_are_refused():
    with pytest.raises(ValueError, match="too large"):
        bc.run_point_chain(64, 4300, 1000, device="cpu")


# ---------------------------------------------------------------------------
# the native C++ baseline
# ---------------------------------------------------------------------------

def random_batches(seed, n_batches=40):
    rng = random.Random(seed)

    def rrange():
        a = bytes([rng.randrange(256), rng.randrange(8)])
        b = bytes([rng.randrange(256), rng.randrange(8)])
        if a > b:
            a, b = b, a
        if a == b:
            b = a + (b"\x00" if rng.random() < 0.9 else b"")
        return a, b

    version, out = 0, []
    for _ in range(n_batches):
        version += rng.randrange(1, 400_000)
        out.append((version, max(0, version - 5_000_000), [
            (max(0, version - rng.randrange(0, 7_000_000)),
             tuple(rrange() for _ in range(rng.randrange(0, 5))),
             tuple(rrange() for _ in range(rng.randrange(0, 5))))
            for _ in range(rng.randrange(0, 24))]))
    return out


def test_native_is_a_backend():
    assert "native" in CONFLICT_BACKENDS and native_available()
    assert isinstance(create_conflict_set("native"), NativeConflictSet)


@pytest.mark.parametrize("seed", (1, 2, 3))
def test_native_matches_the_reference_native_and_python(seed):
    port, ref, py = NativeConflictSet(), RefNative(), RefPy()
    for v, o, batch in random_batches(seed):
        got = port.resolve_with_attribution(
            [ResolverTransaction(*t) for t in batch], v, o)
        assert got == ref.resolve_with_attribution(
            [RefTxn(*t) for t in batch], v, o)
        assert got == py.resolve_with_attribution(
            [RefTxn(*t) for t in batch], v, o)
    assert port.interval_count == ref.interval_count
    assert port.oldest_version == ref.oldest_version


def test_native_verdicts_and_checkpoint_match_the_reference():
    port, ref = NativeConflictSet(), RefNative()
    for v, o, batch in random_batches(9, 25):
        assert port.resolve([ResolverTransaction(*t) for t in batch], v, o) \
            == ref.resolve([RefTxn(*t) for t in batch], v, o)
    a, b = port.checkpoint(), ref.checkpoint()
    assert (a.oldest_version, a.last_commit, a.baseline_version,
            a.assignments) == (b.oldest_version, b.last_commit,
                               b.baseline_version, b.assignments)
    fresh = NativeConflictSet()
    fresh.restore(a)
    assert fresh.checkpoint() == a
