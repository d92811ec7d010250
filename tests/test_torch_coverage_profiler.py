"""The reference's tests/test_coverage_profiler.py on the port.

TEST() coverage sites + the run-loop slow-task profiler.

Ref: flow/UnitTest.h TEST(intro) + the coverage tool's "every annotated
rare path must fire in simulation" discipline; flow/Profiler.actor.cpp
and Net2 slow-task sampling surfaced through status.
"""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow
from foundationdb_tpu_torch.client import run_transaction
from foundationdb_tpu_torch.flow import coverage as cov
from foundationdb_tpu_torch.server import SimCluster


def test_coverage_sites_fire_in_simulation():
    """Drive the scenarios behind the annotated rare paths and assert
    each site fired — the in-suite CoverageTool check."""
    cov.reset_hits()

    # -- conflict + retry sites -----------------------------------------
    c = SimCluster(seed=41, durable=True)
    try:
        db = c.client()

        async def main():
            tr1 = db.create_transaction()
            tr2 = db.create_transaction()
            await tr1.get(b"cov")
            await tr2.get(b"cov")
            tr1.set(b"cov", b"1")
            await tr1.commit()
            tr2.set(b"cov", b"2")
            with pytest.raises(flow.FdbError) as ei:
                await tr2.commit()
            await tr2.on_error(ei.value)     # client.retry.conflict

            # -- stale picture + epoch sites: kill the tlog mid-stream
            c.kill_role("tlog")
            async def w(tr):
                tr.set(b"cov2", b"x")
            await run_transaction(db, w, max_retries=300)
            return True

        assert c.run(main(), timeout_time=300)
    finally:
        c.shutdown()

    # -- torn-tail + locked-tlog sites ----------------------------------
    from foundationdb_tpu_torch.rpc import SimNetwork
    from foundationdb_tpu_torch.server.diskqueue import DiskQueue
    from foundationdb_tpu_torch.server.tlog import TLog
    from foundationdb_tpu_torch.server.types import (TLogCommitRequest,
                                                     TLogLockRequest)
    flow.set_seed(7)
    s = flow.Scheduler(virtual=True)
    flow.set_scheduler(s)
    try:
        net = SimNetwork(s, flow.g_random)
        disk = net.disk("m1")
        tl_proc = net.new_process("tl", machine="m1")
        cl_proc = net.new_process("cl", machine="m2")
        tlog = TLog(tl_proc)
        tlog.start()

        async def locked_commit():
            await tlog.locks.ref().get_reply(TLogLockRequest(), cl_proc)
            with pytest.raises(flow.FdbError) as ei:
                await tlog.commits.ref().get_reply(
                    TLogCommitRequest(0, 1, (), 1), cl_proc)
            assert ei.value.name == "tlog_stopped"
            return True

        t = s.spawn(locked_commit())
        assert s.run(until=t, timeout_time=60)

        async def torn():
            dq = DiskQueue(disk, "q")
            await dq.recover()
            for i in range(8):
                await dq.push(b"r%d" % i)
            await dq.commit()
            # corrupt the tail: flip a byte in a live file's durable
            # image (bit-rot — the checksum must catch it)
            for name, f in disk.files.items():
                if name.startswith("q.dq") and len(f._durable) > 40:
                    f._durable[-3] ^= 0xFF
            dq2 = DiskQueue(disk, "q")
            await dq2.recover()              # diskqueue.torn_tail_dropped
            return True

        t = s.spawn(torn())
        assert s.run(until=t, timeout_time=60)
    finally:
        flow.set_scheduler(None)

    rep = cov.report()
    for site in ("proxy.commit.conflict", "client.retry.conflict",
                 "client.refresh_stale_picture", "cc.epoch_failed",
                 "tlog.commit.stopped", "diskqueue.torn_tail_dropped"):
        assert cov.hits(site) > 0, (site, rep)
    # declared-but-unhit sites are visible to the report (the coverage
    # tool's gap list) — they exist but this run didn't take them
    assert "unhit" in rep


def test_slow_task_profiler_samples_hogs():
    """A step that blocks past SLOW_TASK_THRESHOLD emits a SlowTask
    TraceEvent carrying the task's label and elapsed µs, and rolls up
    into the status document's run_loop section (count + threshold)
    and the exporter."""
    import time

    from foundationdb_tpu_torch.tools.exporter import (parse_prometheus,
                                                       render_prometheus)

    c = SimCluster(seed=42)
    try:
        c.sched.slow_task_threshold = 0.01   # pin over the knob
        db = c.client()

        async def main():
            async def hog():
                time.sleep(0.03)   # a blocking step (the anti-pattern)
            await flow.spawn(hog(), name="testHog")
            status = await db.get_status()
            rl = status["cluster"]["run_loop"]
            assert rl["tasks_run"] > 0
            assert rl["busy_seconds"] > 0
            assert rl["slow_task_count"] >= 1, rl
            assert rl["slow_task_threshold"] == 0.01, rl
            assert any(s["seconds"] >= 0.01 for s in rl["slow_tasks"]), rl
            assert flow.g_trace.counts.get("SlowTask", 0) > 0
            evs = [e for e in flow.g_trace.events
                   if e["Type"] == "SlowTask" and e["TaskName"] == "testHog"]
            assert evs and evs[-1]["ElapsedUs"] >= 10_000, evs
            samples = parse_prometheus(render_prometheus(status))
            by_name = {n: v for n, l, v in samples if not l}
            assert by_name["fdbtpu_run_loop_slow_tasks"] >= 1
            assert by_name[
                "fdbtpu_run_loop_slow_task_threshold_seconds"] == 0.01
            assert any(n == "fdbtpu_run_loop_slow_task_seconds"
                       and l.get("task") == "testHog"
                       for n, l, v in samples)
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_slow_task_threshold_follows_knob():
    """Unpinned, the scheduler reads SLOW_TASK_THRESHOLD live; raising
    it suppresses SlowTask sampling for the same hog."""
    import time

    c = SimCluster(seed=43)
    try:
        assert c.sched.slow_task_threshold is None   # knob-following
        old = flow.SERVER_KNOBS.slow_task_threshold
        db = c.client()

        async def main():
            flow.SERVER_KNOBS.set("slow_task_threshold", 0.01)

            async def hog():
                time.sleep(0.02)
            await flow.spawn(hog(), name="knobHog")
            count = c.sched.slow_task_count
            assert count >= 1
            # a sky-high threshold stops further sampling
            flow.SERVER_KNOBS.set("slow_task_threshold", 10.0)
            await flow.spawn(hog(), name="knobHog2")
            assert c.sched.slow_task_count == count
            st = await db.get_status()
            assert st["cluster"]["run_loop"]["slow_task_threshold"] == 10.0
            return True

        assert c.run(main(), timeout_time=120)
        flow.SERVER_KNOBS.set("slow_task_threshold", old)
    finally:
        c.shutdown()


def test_sampling_profiler_captures_actor_stacks():
    """The on-demand sampling profiler (ref: flow/Profiler.actor.cpp's
    SIGPROF sampler, expressed cooperatively): every Nth task step
    records the stepped task's coroutine suspension stack; the report
    ranks (task, stack) pairs by samples."""
    from foundationdb_tpu_torch.client import run_transaction
    from foundationdb_tpu_torch.server import SimCluster

    c = SimCluster(seed=71)
    try:
        db = c.client()

        async def main():
            flow.g().start_profiler(sample_every=2)
            for i in range(30):
                async def body(tr, i=i):
                    tr.set(b"p%d" % i, b"x")
                await run_transaction(db, body)
            report = flow.g().stop_profiler()
            assert report, "no samples"
            total = sum(e["samples"] for e in report)
            assert total >= 20, total
            # stacks name real code locations, not just task labels
            assert any(".py:" in e["stack"] for e in report), report[:3]
            # role actors appear among the sampled tasks
            names = " ".join(e["task"] for e in report)
            assert "batcher" in names or "updateStorage" in names or \
                "resolve" in names, names
            # off after stop: no further accumulation
            before = len(flow.g()._profile_samples)
            async def body2(tr):
                tr.set(b"after", b"x")
            await run_transaction(db, body2)
            assert len(flow.g()._profile_samples) == before
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()
