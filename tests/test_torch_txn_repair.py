"""The reference's transaction-repair cases (tests/test_txn_repair.py)
on the port's SimCluster, without the five-backend parity case (its
consistency sweep) and the contention-goodput case (its
ContentionStorm): `server/consistency.py` and `server/workloads.py`
are not ported yet. Server-side transaction repair (server/repair.py):
the eligibility contract, the directed
repaired-commit-without-client-round-trip path, the knob-off /
non-repairable fallbacks, and shadow validation staying green under
the repair paths on the `cuda` backend at `device="cpu"`.

Ref: arXiv:1403.5645 (Transaction Repair) — re-execute only the
invalidated reads instead of aborting.
"""

import struct

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.client import run_transaction  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402
from foundationdb_tpu_torch.server.repair import repair_eligible  # noqa: E402
from foundationdb_tpu_torch.server.types import (ADD_VALUE, CLEAR_RANGE,  # noqa: E402
                                           CommitRequest, MutationRef,
                                           SET_VALUE)

RANGE = ((b"hot", b"hot\x00"),)


def _pack(n):
    return struct.pack("<q", n)


# -- eligibility contract ----------------------------------------------

def test_repair_eligibility_contract():
    flow.set_seed(0)
    flow.reset_server_knobs(randomize=False)

    def req(**kw):
        base = dict(read_snapshot=0, read_conflict_ranges=RANGE,
                    write_conflict_ranges=RANGE,
                    mutations=(MutationRef(ADD_VALUE, b"hot", _pack(1)),),
                    repairable=True)
        base.update(kw)
        return CommitRequest(**base)

    assert repair_eligible(req(), RANGE)
    # the client must have declared the contract
    assert not repair_eligible(req(repairable=False), RANGE)
    # no attribution mask -> cause unknown -> abort
    assert not repair_eligible(req(), ())
    # attempt budget (REPAIR_MAX_ATTEMPTS default 2)
    assert repair_eligible(req(repair_attempt=1), RANGE)
    assert not repair_eligible(req(repair_attempt=2), RANGE)
    # read-only payloads and unknown mutation types never repair
    assert not repair_eligible(req(mutations=()), RANGE)
    assert not repair_eligible(
        req(mutations=(MutationRef(99, b"k", b"v"),)), RANGE)
    # blind sets/clears are value-independent and eligible
    assert repair_eligible(
        req(mutations=(MutationRef(SET_VALUE, b"k", b"v"),
                       MutationRef(CLEAR_RANGE, b"a", b"b"))), RANGE)


# -- directed end-to-end ------------------------------------------------

def _conflicted_repairable(db):
    """A repairable ADD on b"hot" that is guaranteed to conflict: a
    rival commits to b"hot" between the read and the commit."""
    async def scenario():
        async def seed(tr):
            tr.set(b"hot", _pack(0))
        await run_transaction(db, seed)
        tr = db.create_transaction()
        tr.set_option("automatic_repair")
        await tr.get(b"hot")
        tr.atomic_op(b"hot", _pack(5), ADD_VALUE)

        async def bump(t2):
            t2.atomic_op(b"hot", _pack(100), ADD_VALUE)
        await run_transaction(db, bump)
        version = await tr.commit()    # repaired: no exception

        async def read(t3):
            return await t3.get(b"hot")
        final = await run_transaction(db, read)
        status = await db.get_status()
        return version, struct.unpack("<q", final)[0], status
    return scenario


def test_repair_commits_without_client_round_trip():
    c = SimCluster(seed=901, durable=True)
    flow.SERVER_KNOBS.set("txn_repair", 1)
    try:
        db = c.client()
        version, final, status = c.run(_conflicted_repairable(db)(),
                                       timeout_time=120)
        # both effects present exactly once — the repaired commit is
        # the from-scratch re-execution's state, bit-exact
        assert final == 105, final
        assert version > 0
        px = status["cluster"]["proxies"][0]
        rep = px["repair"]
        assert rep["attempts"] == 1 and rep["committed"] == 1, rep
        assert rep["reread_rows"] >= 1, rep   # partial re-execution ran
        assert rep["in_flight"] == 0, rep
        doc = status["cluster"]["conflict_scheduling"]
        assert doc["repair_enabled"] == 1
        assert doc["repair_committed"] == 1, doc
    finally:
        flow.reset_server_knobs(randomize=False)
        c.shutdown()


def test_repair_knob_off_aborts_exactly_as_today():
    c = SimCluster(seed=902, durable=True)
    try:
        db = c.client()

        async def main():
            async def seed(tr):
                tr.set(b"hot", _pack(0))
            await run_transaction(db, seed)
            tr = db.create_transaction()
            tr.set_option("automatic_repair")
            await tr.get(b"hot")
            tr.atomic_op(b"hot", _pack(5), ADD_VALUE)

            async def bump(t2):
                t2.atomic_op(b"hot", _pack(100), ADD_VALUE)
            await run_transaction(db, bump)
            try:
                await tr.commit()
                raise AssertionError("expected not_committed")
            except flow.FdbError as e:
                assert e.name == "not_committed", e.name
            status = await db.get_status()
            return status

        status = c.run(main(), timeout_time=120)
        rep = status["cluster"]["proxies"][0]["repair"]
        assert rep["attempts"] == 0, rep
    finally:
        c.shutdown()


def test_non_repairable_conflict_still_aborts_with_repair_on():
    """Without the client declaration the pipeline is abort-only even
    with TXN_REPAIR armed — the contract is opt-in."""
    c = SimCluster(seed=903, durable=True)
    flow.SERVER_KNOBS.set("txn_repair", 1)
    try:
        db = c.client()

        async def main():
            async def seed(tr):
                tr.set(b"hot", b"0")
            await run_transaction(db, seed)
            tr = db.create_transaction()
            await tr.get(b"hot")
            tr.set(b"mine", b"v")

            async def bump(t2):
                t2.set(b"hot", b"x")
            await run_transaction(db, bump)
            try:
                await tr.commit()
                raise AssertionError("expected not_committed")
            except flow.FdbError as e:
                assert e.name == "not_committed", e.name
            return await db.get_status()

        status = c.run(main(), timeout_time=120)
        rep = status["cluster"]["proxies"][0]["repair"]
        assert rep["attempts"] == 0, rep
    finally:
        flow.reset_server_knobs(randomize=False)
        c.shutdown()


# -- shadow validation stays green under the repair paths --------------

def test_repair_with_shadow_validation_green():
    c = SimCluster(seed=911, durable=True, conflict_backend="cuda", device="cpu")
    flow.SERVER_KNOBS.set("txn_repair", 1)
    flow.SERVER_KNOBS.set("shadow_resolve_sample", 2)
    try:
        db = c.client()
        _v, final, status = c.run(_conflicted_repairable(db)(),
                                  timeout_time=300)
        assert final == 105, final
        res = status["cluster"]["resolvers"][0]
        fo = res.get("failover") or {}
        assert fo, "cuda backend should run under the failover controller"
        sh = fo["shadow"]
        assert sh["sampled"] > 0, sh
        assert sh["mismatches"] == 0, sh
        rep = status["cluster"]["proxies"][0]["repair"]
        assert rep["committed"] == 1, rep
    finally:
        flow.reset_server_knobs(randomize=False)
        c.shutdown()
