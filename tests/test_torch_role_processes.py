"""The reference's tests/test_role_processes.py on the port.

Role-per-process commit pipeline: a REAL externally-
hosted resolver — its own OS process behind fixed TCP tokens
(tools/rolehost.py) — driven over rpc/tcp.py and held bit-identical
to the in-process oracle.

Directed parity: the same randomized batch stream (tooOld, degenerate
and empty ranges included — the test_resolver_splits discipline) is
sent over the wire to the TCP-hosted resolver AND resolved by an
in-process PyConflictSet; verdicts and per-transaction attribution
unions must match exactly at every batch.

Chaos: kill -9 of the live resolver process, respawn on the pinned
port, and the recovery plane (checkpoint + gapless journal replay)
must restore the version chain and the duplicate-delivery reply cache
— a resend of the last pre-kill batch returns the bit-identical
cached payload (the digest-consistency property: no divergent verdict
can ever have been exposed), and the continued chain keeps oracle
parity through the respawn.

Ref: fdbserver Resolver.actor.cpp resolveBatch ordering + the
reference's per-role fdbserver processes (one process per recruited
role); recovery via the failover wrapper's checkpoint/replay
discipline moved across the process boundary.
"""

import random

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow
from foundationdb_tpu_torch.models import PyConflictSet
from foundationdb_tpu_torch.models.conflict_set import ResolverTransaction
from foundationdb_tpu_torch.server.proxy import MWTLV
from foundationdb_tpu_torch.server.types import (CommitRequest, ResolveReply,
                                                 ResolveRequest)
from foundationdb_tpu_torch.tools.clusterbench import RoleProcs
from foundationdb_tpu_torch.tools.rolehost import ExternalRoles


def _rand_batches(seed, n_batches, max_txns=5):
    """Randomized ordered batch stream: versions march far enough to
    move the MVCC window (read snapshots sometimes fall below
    version - MWTLV -> tooOld), ranges sometimes degenerate/empty."""
    rng = random.Random(seed)
    out = []
    v = int(MWTLV)          # window moves from the very first batch

    def key():
        return bytes([rng.randrange(1, 250)]) + b"%02d" % rng.randrange(30)

    def rd():
        k = key()
        if rng.random() < 0.1:
            return (k, k)                   # degenerate (empty) range
        return (k, k + bytes([rng.randrange(1, 8)]))

    prev = 0
    for _ in range(n_batches):
        v += rng.randrange(1, MWTLV // 3)
        batch = []
        for _ in range(rng.randrange(1, max_txns)):
            reads = tuple(rd() for _ in range(rng.randrange(0, 3)))
            writes = tuple(rd() for _ in range(rng.randrange(0, 3)))
            snap = max(0, v - rng.randrange(0, 2 * MWTLV))
            batch.append(CommitRequest(snap, reads, writes, (),
                                       report_conflicting_keys=True))
        out.append((prev, v, tuple(batch)))
        prev = v
    return out


def _oracle_resolve(oracle, batch, version):
    """The resolver role's exact per-batch semantics run in-process:
    same backend, same window advance, attribution mapped to the
    transactions' actual read ranges (resolver_role._build_payload)."""
    txns = [ResolverTransaction(t.read_snapshot, t.read_conflict_ranges,
                                t.write_conflict_ranges) for t in batch]
    oldest = max(0, version - MWTLV)
    verdicts, attr = oracle.resolve_with_attribution(txns, version, oldest)
    ranges = tuple(tuple(batch[i].read_conflict_ranges[j] for j in idxs)
                   for i, idxs in enumerate(attr))
    return list(verdicts), ranges


async def _send(ref, prev, version, batch, timeout=30.0):
    reply = await flow.timeout_error(
        ref.get_reply(ResolveRequest(prev, version, batch)), timeout)
    assert isinstance(reply, ResolveReply), reply
    return reply


def _run(body, timeout=120.0):
    """Wall-clock harness (the networktest discipline): host a real-
    time loop for real sockets, restore the ambient scheduler after."""
    flow.set_seed(0)
    s = flow.Scheduler(virtual=False)
    flow.set_scheduler(s)
    try:
        t = s.spawn(body())
        return s.run(until=t, timeout_time=timeout)
    finally:
        flow.set_scheduler(None)


def test_tcp_resolver_matches_in_process_oracle(tmp_path):
    """Every batch's verdicts AND attribution unions from the
    TCP-hosted resolver process are bit-identical to the in-process
    oracle's — the across-the-wire half of the split-ensemble parity
    contract."""
    roles = RoleProcs(n_resolvers=1, run_dir=str(tmp_path), seed=41)
    ext = None
    try:
        roles.spawn_all().wait_ready()
        ext = roles.external_roles()
        oracle = PyConflictSet()
        batches = _rand_batches(424242, 30)

        async def body():
            resolves, _m, _h = await ext.recruit_resolver(
                0, "parity-r0", recovery_version=0, backend="python")
            for prev, v, batch in batches:
                reply = await _send(resolves, prev, v, batch)
                want_v, want_r = _oracle_resolve(oracle, batch, v)
                assert list(reply.verdicts) == want_v, (v, reply)
                assert tuple(tuple(sorted(r))
                             for r in reply.conflicting_ranges) == \
                    tuple(tuple(sorted(r)) for r in want_r), (v, reply)
            return True

        assert _run(body)
    finally:
        if ext is not None:
            ext.close()
        roles.terminate_all()


def test_kill9_recovers_checkpoint_replay_and_reply_cache(tmp_path):
    """SIGKILL the live resolver process mid-chain: the respawn (same
    port) restores state from checkpoint + journal replay, a duplicate
    delivery of the last pre-kill batch returns the bit-identical
    cached payload, and the continued version chain keeps oracle
    parity — so no client-visible verdict can diverge across the
    crash (the database-digest consistency property, directed)."""
    run_dir = str(tmp_path)
    roles = RoleProcs(n_resolvers=1, run_dir=run_dir,
                      state_root=str(tmp_path / "state"), seed=43,
                      checkpoint_every=0.2)
    ext = None
    try:
        roles.spawn_all().wait_ready()
        assert roles.ready[("resolver", 0)]["recovered"] is False
        ext = roles.external_roles()
        oracle = PyConflictSet()
        batches = _rand_batches(31338, 24)
        pre, post = batches[:16], batches[16:]
        seen = []

        async def phase_a():
            resolves, _m, _h = await ext.recruit_resolver(
                0, "chaos-r0", recovery_version=0, backend="python")
            for prev, v, batch in pre:
                reply = await _send(resolves, prev, v, batch)
                want_v, _r = _oracle_resolve(oracle, batch, v)
                assert list(reply.verdicts) == want_v, (v, reply)
                seen.append(reply)
            # let the wall-clock checkpoint actor land at least one
            # checkpoint with the pipeline idle, so the recovery below
            # exercises checkpoint restore + replay of the tail —
            # not a cold full-journal replay
            await flow.delay(0.6)
            return True

        assert _run(phase_a)
        ext.close()
        ext = None

        # pre-kill evidence: every batch journaled, and the wall-clock
        # checkpoint actor landed at least one checkpoint — so the
        # recovery below restores from checkpoint and replays only the
        # (possibly empty) journal tail above it
        from foundationdb_tpu_torch.tools import exporter
        pre_docs = exporter.fetch_process_docs(
            run_dir, stubs=roles.status_stubs())
        pre_ctr = pre_docs[0]["counters"]
        assert pre_ctr["journaled"] >= len(pre), pre_ctr
        assert pre_ctr["checkpoints"] >= 1, pre_ctr

        dead = roles.kill("resolver", 0)
        roles.respawn("resolver", 0)
        roles.wait_ready()
        rdoc = roles.ready[("resolver", 0)]
        assert rdoc["pid"] != dead
        assert rdoc["recovered"] is True      # journaled state found
        ext = ExternalRoles([rdoc], [])

        async def phase_b():
            resolves = ext._ref(rdoc, "resolves")
            # duplicate delivery of the last pre-kill batch: the
            # recovered reply cache must answer bit-identically
            prev, v, batch = pre[-1]
            dup = await _send(resolves, prev, v, batch)
            assert dup == seen[-1], (dup, seen[-1])
            # the chain continues gaplessly through the respawn
            for prev, v, batch in post:
                reply = await _send(resolves, prev, v, batch)
                want_v, want_r = _oracle_resolve(oracle, batch, v)
                assert list(reply.verdicts) == want_v, (v, reply)
                assert tuple(tuple(sorted(r))
                             for r in reply.conflicting_ranges) == \
                    tuple(tuple(sorted(r)) for r in want_r), (v, reply)
            return True

        assert _run(phase_b)

        # the recovery actually ran the recovery plane: the respawned
        # incarnation (counters reset at boot) reports the restored —
        # and then continued — chain position, and journals the
        # post-kill batches into its own segment
        docs = exporter.fetch_process_docs(run_dir,
                                           stubs=roles.status_stubs())
        assert len(docs) == 1 and docs[0]["up"] == 1, docs
        assert docs[0]["version"] == post[-1][1], docs[0]
        ctr = docs[0]["counters"]
        assert ctr["requests"] >= len(post), ctr
        assert ctr["journaled"] >= len(post), ctr
    finally:
        if ext is not None:
            ext.close()
        roles.terminate_all()


def test_resolver_process_rejects_unknown_control_op(tmp_path):
    """The control endpoint's error path: an unknown op answers
    client_invalid_operation instead of wedging the stream, and the
    process keeps serving afterwards (ping)."""
    roles = RoleProcs(n_resolvers=1, run_dir=str(tmp_path), seed=47)
    ext = None
    try:
        roles.spawn_all().wait_ready()
        ext = roles.external_roles()
        entry = roles.ready[("resolver", 0)]

        async def body():
            ctrl = ext._ref(entry, "control")
            with pytest.raises(flow.FdbError) as ei:
                await flow.timeout_error(
                    ctrl.get_reply({"type": "no_such_op"}), 30.0)
            assert ei.value.name == "client_invalid_operation"
            pong = await flow.timeout_error(
                ctrl.get_reply({"type": "ping"}), 30.0)
            assert pong["ok"] and pong["ready"] is False
            flushed = await flow.timeout_error(
                ctrl.get_reply({"type": "trace_flush"}), 30.0)
            assert flushed["ok"]
            return True

        assert _run(body)
    finally:
        if ext is not None:
            ext.close()
        roles.terminate_all()
