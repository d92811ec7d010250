"""The reference's tests/test_conflict_observability.py on the port.

End-to-end conflict attribution + cluster health observability.

The acceptance path for this round: a rejected transaction with
report_conflicting_keys enabled surfaces the conflicting key range(s)
through resolver -> proxy -> client; `status details` shows non-empty
conflict hot-spot and latency-probe sections after a conflicting
workload; the health rollup raises messages; the trace file rolls at
trace_roll_size."""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow
from foundationdb_tpu_torch.client import run_transaction
from foundationdb_tpu_torch.server import SimCluster
from foundationdb_tpu_torch.tools.cli import Cli
from foundationdb_tpu_torch.tools.exporter import (parse_prometheus,
                                                   render_prometheus)


async def _conflict_once(db, key=b"hot"):
    """One reported conflict on `key`; returns the transaction."""
    tr = db.create_transaction()
    tr.set_option("report_conflicting_keys")
    await tr.get(key)
    tr.set(b"mine", b"v")

    async def bump(t2, key=key):
        t2.set(key, b"x")
    await run_transaction(db, bump)
    try:
        await tr.commit()
        raise AssertionError("expected not_committed")
    except flow.FdbError as e:
        assert e.name == "not_committed", e.name
    return tr


def test_report_conflicting_keys_end_to_end():
    c = SimCluster(seed=901)
    try:
        db = c.client()

        async def main():
            async def seed(tr):
                tr.set(b"hot", b"0")
            await run_transaction(db, seed)
            tr = await _conflict_once(db)
            assert tr.get_conflicting_ranges() == \
                ((b"hot", b"hot\x00"),)
            # survives on_error's reset (the retry loop reads it)
            await tr.on_error(flow.error("not_committed"))
            assert tr.get_conflicting_ranges() == \
                ((b"hot", b"hot\x00"),)
            # ...and a successful commit clears it
            tr.set(b"fresh", b"1")
            await tr.commit()
            assert tr.get_conflicting_ranges() is None
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_unreported_conflict_keeps_plain_error_path():
    c = SimCluster(seed=902)
    try:
        db = c.client()

        async def main():
            async def seed(tr):
                tr.set(b"k", b"0")
            await run_transaction(db, seed)
            tr = db.create_transaction()
            await tr.get(b"k")
            tr.set(b"m", b"v")

            async def bump(t2):
                t2.set(b"k", b"x")
            await run_transaction(db, bump)
            try:
                await tr.commit()
                raise AssertionError("expected not_committed")
            except flow.FdbError as e:
                assert e.name == "not_committed"
            assert tr.get_conflicting_ranges() is None
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_split_resolvers_union_conflicting_ranges():
    """With key-range split resolvers, a txn conflicting on BOTH sides
    of the split gets the union of each resolver's attribution."""
    c = SimCluster(seed=903, n_resolvers=2, n_workers=4)
    try:
        db = c.client()

        async def main():
            async def seed(tr):
                tr.set(b"a-left", b"0")
                tr.set(b"z-right", b"0")
            await run_transaction(db, seed)
            tr = db.create_transaction()
            tr.set_option("report_conflicting_keys")
            await tr.get(b"a-left")
            await tr.get(b"z-right")
            tr.set(b"mine", b"v")

            async def bump(t2):
                t2.set(b"a-left", b"x")
                t2.set(b"z-right", b"x")
            await run_transaction(db, bump)
            try:
                await tr.commit()
                raise AssertionError("expected not_committed")
            except flow.FdbError as e:
                assert e.name == "not_committed"
            got = set(tr.get_conflicting_ranges())
            assert got == {(b"a-left", b"a-left\x00"),
                           (b"z-right", b"z-right\x00")}, got
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_status_details_and_exporter_after_conflicts():
    c = SimCluster(seed=904, durable=True)
    cli = Cli.for_cluster(c)
    try:
        db = c.client()

        async def main():
            async def seed(tr):
                tr.set(b"hot", b"0")
            await run_transaction(db, seed)
            for _ in range(6):
                await _conflict_once(db)
            await flow.delay(12.0)   # past probe interval + sampler
            return await db.get_status()

        status = c.run(main(), timeout_time=180)
        cl = status["cluster"]
        # acceptance: non-empty hot-spot and probe sections
        assert cl["conflict_hot_spots"]
        assert cl["conflict_hot_spots"][0]["begin"] == b"hot".hex()
        assert cl["latency_probe"].get("rounds", 0) >= 1
        assert cl["latency_probe"]["bands"]["grv"]["total"] >= 1
        assert any(r["hot_spots"] for r in cl["resolvers"])
        assert cl["coverage"]["declared"] > 0
        json.dumps(cl)   # the document stays JSON-serializable

        details = cli.execute("status details")
        assert "Conflict hot spots" in details
        assert b"hot".hex() in details
        assert "Latency probe" in details
        assert "cluster-probe" in details
        top = cli.execute("top")
        assert b"hot".hex() in top

        # exporter covers resolver, proxy, tlog, and kernel metrics
        text = render_prometheus(status)
        samples = parse_prometheus(text)
        kinds = {l.get("kind") for n, l, _ in samples
                 if n == "fdbtpu_role_counter"}
        assert {"proxy", "resolver", "tlog", "storage"} <= kinds
        names = {n for n, _, _ in samples}
        assert "fdbtpu_conflict_hot_spot_score" in names
        assert "fdbtpu_latency_probe_seconds" in names
    finally:
        c.shutdown()


def test_health_messages_fire():
    c = SimCluster(seed=905)
    try:
        db = c.client()

        async def main():
            async def seed(tr):
                tr.set(b"hot", b"0")
            await run_transaction(db, seed)
            # enough conflicts to cross HEALTH_CONFLICT_RATE with >= 10
            # sampled transactions in the tail window; spread across
            # sampler ticks — the rollup measures the WINDOW's deltas,
            # not lifetime totals
            for _ in range(14):
                await _conflict_once(db)
                await flow.delay(0.4)
            await flow.delay(2.0)   # let the metric sampler see them
            st = (await db.get_status())["cluster"]
            names = {m["name"] for m in st["messages"]}
            assert "high_conflict_rate" in names, st["messages"]
            m = next(mm for mm in st["messages"]
                     if mm["name"] == "high_conflict_rate")
            assert m["conflict_rate"] > 0.25
            assert "description" in m and "severity" in m
            return True

        assert c.run(main(), timeout_time=180)
    finally:
        c.shutdown()


def test_saturated_resolver_message():
    c = SimCluster(seed=906)
    try:
        db = c.client()

        async def main():
            async def seed(tr):
                tr.set(b"x", b"1")
            await run_transaction(db, seed)
            # shrink the limit so the live resolver reads as saturated
            old = flow.SERVER_KNOBS.resolver_state_memory_limit
            flow.SERVER_KNOBS.set("resolver_state_memory_limit", 1)
            try:
                st = (await db.get_status())["cluster"]
                names = {m["name"] for m in st["messages"]}
                assert "saturated_resolver" in names, st["messages"]
            finally:
                flow.SERVER_KNOBS.set("resolver_state_memory_limit", old)
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


def test_trace_file_rolls_at_size(tmp_path):
    from foundationdb_tpu_torch.flow.trace import TraceCollector

    path = str(tmp_path / "trace.json")
    col = TraceCollector(path, roll_size=512)
    for i in range(40):
        col.emit({"Severity": 10, "Time": float(i), "Type": "RollTest",
                  "ID": "x", "Filler": "y" * 40})
    col.close()
    assert col.rolled_files, "expected at least one roll"
    # every rolled file exists, is under ~roll_size + one line, and
    # holds intact JSON lines; the live file has the newest events
    total = 0
    for f in col.rolled_files + [path]:
        assert os.path.exists(f), f
        with open(f) as fh:
            lines = fh.read().splitlines()
        total += len(lines)
        for line in lines:
            assert json.loads(line)["Type"] == "RollTest"
        if f != path:
            assert os.path.getsize(f) <= 512 + 120
    assert total == 40


def test_trace_roll_keeps_flush_and_atexit_semantics(tmp_path):
    """After a roll the collector still flushes to the CURRENT file and
    close() (the atexit hook's body) targets it."""
    from foundationdb_tpu_torch.flow.trace import TraceCollector

    path = str(tmp_path / "t.json")
    col = TraceCollector(path, roll_size=256)
    for i in range(10):
        col.emit({"Severity": 10, "Time": 0.0, "Type": "T", "ID": "",
                  "Pad": "z" * 30})
    col.flush()
    assert os.path.exists(path)
    col.emit({"Severity": 10, "Time": 0.0, "Type": "Last", "ID": ""})
    col.close()
    with open(path) as fh:
        tail = fh.read()
    assert "Last" in tail
    # reset() retargets and clears roll history
    col.reset(None)
    assert col._fh is None
