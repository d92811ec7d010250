"""Parity of the port's simulation tester with the reference's, on the
CPU, each package under its own scheduler in turn (never both at once).
Equality is exact everywhere.

  (a) The reference smoke's contention cell (tools/smoke.py:625-700),
      shortened to 1.0 virtual s: `ContentionStorm` at seed 8383 on
      `SimCluster(seed, durable=True)`, 4 client handles, 150 arrivals
      a second on 2 hot keys (`testing.contention_run`), with the
      conflict scheduler, the client windows and transaction repair
      off, then on. On `python`, and on `cuda` at `device="cpu"`
      against `tpu`, the port equals the reference in the storm's stats
      (without the fields that read the host's clock), the hot keys'
      total, `check_consistency`'s result, the `database_digest` and
      the scheduler's (virtual time, task name) log of every step.
  (b) tests/test_region.py's failover at seed 801
      (`testing.region_run`): a remote region attached, 40 writes, a
      concurrent writer, a primary blackout and `promote()`. On
      `python`, and on `cuda` at `device="cpu"` against `tpu`: the
      committed versions, the primary's and the promoted epoch, the
      recovery version, the router's lag, the keys that survived the
      blackout and those lost, the consistency sweep and the digest
      read through the promoted region, and the task log.
  (c) A cluster with `metric_history` on: the `\\xff\\x02/metrics/`
      rows it persisted, the SLO verdict of the status document, and
      `timekeeper.read_time_map` and `version_at_time` at a few
      timestamps.

The `cuda` cases have twins on the card under the `cuda` marker.
"""

import importlib
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import testing as tg  # noqa: E402

REF, PORT = "foundationdb_tpu", "foundationdb_tpu_torch"
CONTENTION_DURATION = 1.0


@pytest.fixture(autouse=True)
def default_buggify_rates():
    """Hold both packages' BUGGIFY activation and fire rates at their
    defaults (`flow.set_seed` resets neither)."""
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
    """Package `name`'s modules under the names `testing.contention_run`
    and `testing.region_run` read, and a few more for (c)."""
    mod = importlib.import_module
    return SimpleNamespace(
        name=name, flow=mod(f"{name}.flow"),
        future=mod(f"{name}.flow.future"),
        SimCluster=mod(f"{name}.server").SimCluster,
        run_transaction=mod(f"{name}.client").run_transaction,
        database_digest=mod(f"{name}.server.chaos").database_digest,
        check_consistency=mod(
            f"{name}.server.consistency").check_consistency,
        FULLY_RECOVERED=mod(f"{name}.server.dbinfo").FULLY_RECOVERED,
        RemoteRegion=mod(f"{name}.server.region").RemoteRegion,
        ContentionStorm=mod(f"{name}.server.workloads").ContentionStorm,
        sk=mod(f"{name}.server.systemkeys"),
        tk=mod(f"{name}.server.timekeeper"))


def logged(P, monkeypatch, steps, fn, *args, **kw):
    """`fn(P, ...)` with every scheduler step's (virtual time, task name)
    appended to `steps`; leaves P's knobs and seed as a fresh process
    has them."""
    orig = P.future.Task._step

    def step(self, value=None, exc=None):
        steps.append((self._sched.now(), self.name))
        return orig(self, value, exc)

    monkeypatch.setattr(P.future.Task, "_step", step)
    try:
        return fn(P, *args, **kw)
    finally:
        monkeypatch.undo()
        P.flow.reset_server_knobs(randomize=False)
        P.flow.set_seed(0, buggify_enabled=False)


def _device(device):
    if device is None and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return {"device": device}


BACKENDS = [
    ("python", "python", None),
    ("cuda", "tpu", "cpu"),
    pytest.param("cuda", "tpu", None, marks=pytest.mark.cuda,
                 id="cuda-card")]


# -- (a) the contention storm -------------------------------------------

@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("backend,ref_backend,device", BACKENDS)
def test_contention_storm_matches_reference(backend, ref_backend, device,
                                            on, monkeypatch):
    kw = {} if backend == "python" else {"cluster_kwargs": _device(device)}
    steps_ref, steps_port = [], []
    ref = logged(pkg(REF), monkeypatch, steps_ref, tg.contention_run,
                 ref_backend, tg.CONTENTION_SEED, on, CONTENTION_DURATION)
    port = logged(pkg(PORT), monkeypatch, steps_port, tg.contention_run,
                  backend, tg.CONTENTION_SEED, on, CONTENTION_DURATION, **kw)
    assert tg.sim_stats(port["stats"]) == tg.sim_stats(ref["stats"])
    assert port["total"] == ref["total"]
    assert port["consistency"] == ref["consistency"]
    assert port["digest"] == ref["digest"]
    assert port["epoch"] == ref["epoch"]
    assert len(steps_port) == len(steps_ref)
    assert steps_port == steps_ref
    stats = port["stats"]
    assert stats["committed"] > 0 and port["consistency"]["rows"] > 0
    # the off run is a contention storm; the scheduler and repair turn
    # its conflicts into commits
    if on:
        doc = port["status"]["cluster"]["conflict_scheduling"]
        assert doc["deferrals"] > 0 and doc["repair_committed"] > 0, doc
    else:
        assert stats["conflicts"] > 0, stats


# -- (b) the region failover --------------------------------------------

@pytest.mark.parametrize("backend,ref_backend,device", BACKENDS)
def test_region_failover_matches_reference(backend, ref_backend, device,
                                           monkeypatch):
    kw = {} if backend == "python" else {"cluster_kwargs": _device(device)}
    steps_ref, steps_port = [], []
    ref = logged(pkg(REF), monkeypatch, steps_ref, tg.region_run,
                 ref_backend, tg.REGION_SEED)
    port = logged(pkg(PORT), monkeypatch, steps_port, tg.region_run,
                  backend, tg.REGION_SEED, **kw)
    for k in ("committed", "epoch", "promoted_epoch", "recovery_version",
              "lag", "survived", "lost", "consistency", "digest"):
        assert port[k] == ref[k], k
    assert port["blackout"][0] == ref["blackout"][0]
    assert port["recovered"][0] == ref["recovered"][0]
    assert len(steps_port) == len(steps_ref)
    assert steps_port == steps_ref
    # every write the router shipped survived; what was lost is the lag
    assert len(port["survived"]) >= tg.REGION_SHIPPED
    rv = port["recovery_version"]
    assert all(port["committed"][k] > rv for k in port["lost"])


# -- (c) the longitudinal plane -----------------------------------------

def metrics_run(P, seed):
    """A cluster with `metric_history` on, 13 virtual s of one commit
    every 0.25 s; then the persisted metric rows, the status document's
    SLO verdict, the time map and `version_at_time` at its first and
    middle timestamps, past its end and before it."""
    c = P.SimCluster(seed=seed, metric_history=True)
    try:
        db = c.client("lg")

        async def main():
            for i in range(52):
                tr = db.create_transaction()
                tr.set(b"lg/%03d" % (i % 40), b"%d" % i)
                await tr.commit()
                await P.flow.delay(0.25)

            async def rows(tr):
                tr.set_option("read_system_keys")
                return await tr.get_range(P.sk.METRIC_HISTORY_PREFIX,
                                          P.sk.METRIC_HISTORY_END)
            metric_rows = await P.run_transaction(db, rows)
            tmap = await P.tk.read_time_map(db)
            stamps = (tmap[0][0], (tmap[0][0] + tmap[-1][0]) / 2,
                      tmap[-1][0] + 1.5, 0.0)
            at = [await P.tk.version_at_time(db, t) for t in stamps]
            slo = (await db.get_status())["cluster"]["slo"]
            return {"rows": metric_rows, "tmap": tmap, "at": at,
                    "slo": slo, "digest": await P.database_digest(db)}

        return c.run(main(), timeout_time=600)
    finally:
        c.shutdown()


def test_metric_history_matches_reference(monkeypatch):
    steps_ref, steps_port = [], []
    ref = logged(pkg(REF), monkeypatch, steps_ref, metrics_run, 1701)
    port = logged(pkg(PORT), monkeypatch, steps_port, metrics_run, 1701)
    assert port["rows"] == ref["rows"]
    assert port["tmap"] == ref["tmap"]
    assert port["at"] == ref["at"]
    assert port["slo"] == ref["slo"]
    assert port["digest"] == ref["digest"]
    assert steps_port == steps_ref
    assert len(port["rows"]) > 0 and len(port["tmap"]) >= 3
    assert port["slo"]["enabled"] == 1 and port["slo"]["state"] == "ok"
    assert port["at"][0] == port["tmap"][0][1]
