"""Parity of the port's whole SimCluster with the reference's, on the CPU,
each package under its own scheduler in turn (never both at once), at
seeds drawn by numpy. Equality is exact everywhere.

The workload is `foundationdb_tpu_torch.testing.cluster_run` (one
attempt a transaction): 8 clients at once, each running 6 seeded
read-modify-write transactions over 16-byte keys of 1,000,000 ids, one
of them a clear range and one an atomic add, with the worker that holds
the resolver killed when client 0 reaches its fourth transaction, on
FDB 6.1's default role counts (3 proxies, 3 logs, 1 resolver; 4 storage
teams of 2; durable).

  (a) On `python`, at two seeds (the second buggified, knobs
      randomized), the port equals the reference in every transaction's
      outcome in the order they completed (its versionstamp, or its
      error's name), the final `database_digest`, the epoch count and
      the scheduler's (virtual time, task name) log of every step.
  (b) `cuda`, `cuda-point` (8-byte keys) and `sharded-cuda` at
      `device="cpu"` equal `tpu`, `tpu-point` and `sharded-tpu` in the
      outcomes, the digest, the epoch count and the task log (the
      status document and the `\xff/conf/` rows name the backends, so
      those differ); on the card under the `cuda` marker.
  (c) A reference cluster on a real data directory commits a seeded
      workload (8 clients x 30 transactions, retried until they commit)
      and shuts down; the port's cluster boots from the same
      directory (its coordinators', logs' and storage servers' files)
      and reads back a user keyspace with the reference's digest.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import testing as tg  # noqa: E402

REF, PORT = "foundationdb_tpu", "foundationdb_tpu_torch"
SEEDS = [int(s) for s in np.random.default_rng(20261017 + 12).integers(
    1, 2**31 - 1, size=2)]
CLIENTS, TXNS, IDS, KILL_AT = 8, 6, 1_000_000, 3


@pytest.fixture(autouse=True)
def default_buggify_rates():
    """Hold both packages' BUGGIFY activation and fire rates at their
    defaults: `flow.set_seed` resets neither, and a test that forces a
    site raises a package's fire rate, which would make the two
    packages draw differently in a later test of the same process."""
    saved = []
    for name in (REF, PORT):
        b = importlib.import_module(f"{name}.flow.rng").g_buggify
        fresh = type(b)()
        saved.append((b, b.activated_p, b.fire_p))
        b.activated_p, b.fire_p = fresh.activated_p, fresh.fire_p
    yield
    for b, activated_p, fire_p in saved:
        b.activated_p, b.fire_p = activated_p, fire_p


def pkg(name):
    mod = importlib.import_module
    return SimpleNamespace(
        name=name, flow=mod(f"{name}.flow"),
        future=mod(f"{name}.flow.future"),
        SimCluster=mod(f"{name}.server").SimCluster,
        run_transaction=mod(f"{name}.client").run_transaction,
        database_digest=mod(f"{name}.server.chaos").database_digest,
        ADD_VALUE=mod(f"{name}.server.types").ADD_VALUE)


def run(P, backend, seed, monkeypatch, buggify=False, steps=None,
        **kw):
    """`cluster_run` of package P; with `steps`, every scheduler step's
    (virtual time, task name) is appended to it. Leaves P's knobs and
    seed as a fresh process has them."""
    if steps is not None:
        orig = P.future.Task._step

        def step(self, value=None, exc=None):
            steps.append((self._sched.now(), self.name))
            return orig(self, value, exc)

        monkeypatch.setattr(P.future.Task, "_step", step)
    try:
        return tg.cluster_run(P, backend, seed, CLIENTS, TXNS, IDS,
                              kill_at=KILL_AT, retry=False, mixed=True,
                              buggify=buggify, **kw)
    finally:
        monkeypatch.undo()
        P.flow.reset_server_knobs(randomize=False)
        P.flow.set_seed(0, buggify_enabled=False)


@pytest.mark.parametrize("seed,buggify", [(SEEDS[0], False),
                                          (SEEDS[1], True)],
                         ids=["plain", "buggified"])
def test_python_cluster_matches_reference(seed, buggify, monkeypatch):
    steps_ref, steps_port = [], []
    ref = run(pkg(REF), "python", seed, monkeypatch, buggify, steps_ref)
    port = run(pkg(PORT), "python", seed, monkeypatch, buggify, steps_port)
    assert port["outcomes"] == ref["outcomes"]
    assert len(port["outcomes"]) == CLIENTS * TXNS
    assert port["digest"] == ref["digest"]
    # the kill makes exactly one recovery past the boot's
    assert port["epoch"] == ref["epoch"] == port["kill_epoch"] + 1
    assert len(steps_port) == len(steps_ref)
    assert steps_port == steps_ref


@pytest.mark.parametrize("where", [
    ("cuda", "tpu", 16, "cpu"), ("cuda-point", "tpu-point", 8, "cpu"),
    ("sharded-cuda", "sharded-tpu", 16, "cpu"),
    pytest.param(("cuda", "tpu", 16, None), marks=pytest.mark.cuda,
                 id="cuda-card"),
    pytest.param(("cuda-point", "tpu-point", 8, None),
                 marks=pytest.mark.cuda, id="cuda-point-card"),
    pytest.param(("sharded-cuda", "sharded-tpu", 16, None),
                 marks=pytest.mark.cuda, id="sharded-cuda-card")],
    ids=["cuda", "cuda-point", "sharded-cuda", "cuda-card",
         "cuda-point-card", "sharded-cuda-card"])
def test_device_backends_match_reference(where, monkeypatch):
    backend, ref_backend, key_bytes, device = where
    if device is None and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seed = SEEDS[0]
    steps_ref, steps_port = [], []
    ref = run(pkg(REF), ref_backend, seed, monkeypatch, steps=steps_ref,
              key_bytes=key_bytes)
    port = run(pkg(PORT), backend, seed, monkeypatch, steps=steps_port,
               key_bytes=key_bytes, cluster_kwargs={"device": device})
    assert port["outcomes"] == ref["outcomes"]
    assert port["digest"] == ref["digest"]
    assert port["epoch"] == ref["epoch"] == port["kill_epoch"] + 1
    assert steps_port == steps_ref
    assert port["committed"] > 0
    res = port["status"]["cluster"]["resolvers"]
    assert res and all(r["failover"].get("failovers") == 0 for r in res)


def test_port_boots_from_reference_data_dir(tmp_path, monkeypatch):
    """The disk formats are the same byte for byte: what a reference
    cluster leaves in its data directory, the port's cluster recovers."""
    data = str(tmp_path / "data")
    seed = SEEDS[1]
    R = pkg(REF)
    try:
        ref = tg.cluster_run(R, "python", seed, CLIENTS, 5 * TXNS, IDS,
                             cluster_kwargs={"data_dir": data})
    finally:
        R.flow.reset_server_knobs(randomize=False)
        R.flow.set_seed(0, buggify_enabled=False)
    assert ref["committed"] == ref["rows"] == CLIENTS * 5 * TXNS
    P = pkg(PORT)
    c = P.SimCluster(seed=seed, data_dir=data, **tg.CLUSTER_LAYOUT)
    try:
        db = c.client("reader")

        async def main():
            return await P.database_digest(db)

        digest = c.run(main(), timeout_time=1e5)
        epoch = c.cc.dbinfo.get().epoch
    finally:
        c.shutdown()
        P.flow.reset_server_knobs(randomize=False)
        P.flow.set_seed(0, buggify_enabled=False)
    assert digest == ref["digest"]
    # the port recovered the reference's generations, not a fresh one
    assert epoch > ref["epoch"]
