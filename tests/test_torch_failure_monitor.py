"""The reference's cases of tests/test_failure_monitor.py on the port's
SimCluster.

Pushed failure-monitor state (ref: fdbrpc/FailureMonitor.h:123 —
per-address up/down pushed from the cluster controller;
fdbclient/FailureMonitorClient.actor.cpp). Without it
clients discover failures only by RPC timeout, inflating the
failover tail; the CC now heartbeats workers and pushes the failed set
through the dbinfo broadcast, and clients order known-down replicas
last."""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.client import run_transaction  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402


def test_pushed_failure_state_avoids_clogged_replica():
    """A replica that is alive but unreachable (clogged links — a
    liveness flag would miss it) gets pushed as failed; client reads
    then go to the healthy replica FIRST, so with backup requests made
    expensive, reads still complete fast."""
    c = SimCluster(seed=901, n_storage=1, storage_replicas=2,
                   n_workers=5, auto_reboot=False)
    try:
        db = c.client()

        async def main():
            async def put(k, v):
                async def body(tr):
                    tr.set(k, v)
                await run_transaction(db, body, max_retries=500)
            for i in range(5):
                await put(b"k%d" % i, b"v%d" % i)

            # clog EVERY link to one replica's machine, both ways, for
            # a long time: alive but unreachable
            info = c.cc.dbinfo.get()
            victim = info.storages[0].replicas[0].name
            vmachine = None
            for name, w in c.workers.items():
                if victim in w.roles:
                    vmachine = w.process.machine
            assert vmachine is not None
            machines = {w.process.machine for w in c.workers.values()}
            machines.add(c.cc.process.machine)
            machines.add(db.process.machine)
            for m in machines:
                if m != vmachine:
                    c.net.clog_pair(m, vmachine, 1000.0)
                    c.net.clog_pair(vmachine, m, 1000.0)

            # the failure monitor's heartbeat times out and pushes
            deadline = flow.now() + 30
            while victim not in c.cc.dbinfo.get().failed:
                assert flow.now() < deadline, "failure never pushed"
                await flow.delay(0.1)

            # make backup-request masking expensive so first-choice
            # ordering is what the test measures
            flow.SERVER_KNOBS.set("LOAD_BALANCE_BACKUP_DELAY", 2.0)
            db2 = c.client("fresh")   # empty latency model
            t0 = flow.now()
            tr = db2.create_transaction()
            for i in range(5):
                assert await tr.get(b"k%d" % i) == b"v%d" % i
            elapsed = flow.now() - t0
            # without the pushed state, random rotation sends ~half the
            # first attempts into the clog and each pays the 2s backup
            # delay; with it, every read goes healthy-first
            assert elapsed < 1.0, elapsed
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        flow.SERVER_KNOBS.set("LOAD_BALANCE_BACKUP_DELAY", 0.005)
        c.shutdown()


def test_failure_state_clears_when_worker_recovers():
    c = SimCluster(seed=903, n_workers=7)
    try:
        db = c.client()

        async def main():
            async def body(tr):
                tr.set(b"x", b"1")
            await run_transaction(db, body)
            # pick an idle worker and kill it (auto-reboot revives it)
            victim = None
            for name, w in c.workers.items():
                if not w.roles:
                    victim = name
                    break
            assert victim
            c.kill_worker(victim)
            deadline = flow.now() + 30
            while victim not in c.cc.dbinfo.get().failed:
                assert flow.now() < deadline
                await flow.delay(0.1)
            # after the reboot re-registers, the push clears
            deadline = flow.now() + 60
            while victim in c.cc.dbinfo.get().failed:
                assert flow.now() < deadline
                await flow.delay(0.1)
            return True

        assert c.run(main(), timeout_time=600)
    finally:
        c.shutdown()
