"""ConsistencyCheck: full-database replica comparison + shard
accounting at a quiesced version.

Ref: fdbserver/workloads/ConsistencyCheck.actor.cpp (reads every shard
from every replica and byte-compares), tester.actor.cpp:741-765 (the
sweep runs after sim tests once the database is quiet). Here the sweep
is an async function over a SimCluster: quiesce, then for every shard
read the full range from EVERY replica through the same storage
endpoints clients use and require byte-for-byte agreement, plus check
that the shard map partitions the keyspace exactly.
"""

from __future__ import annotations

from .. import flow
from ..flow import TaskPriority, error
from .types import StorageGetRangeRequest

# the sweep's page size lives in the CONSISTENCY_CHECK_PAGE_ROWS knob:
# chunked like the reference's range reads so a huge shard cannot
# produce an unbounded reply (BUGGIFY shrinks it so paging is exercised)


class ConsistencyError(AssertionError):
    """A replica divergence or shard-accounting violation."""


async def _read_replica(rep, begin: bytes, end, version: int, process):
    """Full contents of [begin, end) from one replica, paged."""
    out = []
    cursor = begin
    page_rows = int(flow.SERVER_KNOBS.consistency_check_page_rows)
    # an open-ended last shard is swept through the stored system rows
    # too (\xff\x02 is replicated data); \xff\xff engine metadata is not
    hard_end = end if end is not None else b"\xff\xff"
    while True:
        rows = await flow.timeout_error(rep.ranges.get_reply(
            StorageGetRangeRequest(cursor, hard_end, version, page_rows),
            process), flow.SERVER_KNOBS.consistency_check_read_timeout)
        out.extend(rows)
        if len(rows) < page_rows:
            return out
        cursor = rows[-1][0] + b"\x00"


async def _quiesce_via_status(db, max_wait: float = 60.0) -> None:
    """Client-surface settling: poll the status document until the
    cluster is recovered and every replica has caught up to the log's
    durable frontier (ref: QuietDatabase's caught-up checks, but
    through StatusClient so a remote tool can run the sweep over TCP —
    the in-sim quiet_database reaches into role objects instead). A
    fully EMPTY log queue is not required: background traffic (the
    latency probe) keeps the tail entry pinned on a live cluster; the
    sweep reads at a GRV, so zero replica lag is the property that
    matters."""
    deadline = flow.now() + max_wait
    while True:
        try:
            st = (await db.get_status())["cluster"]
        except flow.FdbError as e:
            if e.name == "client_invalid_operation":
                # no status endpoint on this connection at all —
                # polling for 60s cannot fix that; fail immediately
                # with the real cause instead of a generic timeout
                raise
            st = {}
        logs = st.get("logs", [])
        reps = [r for s in st.get("storages", []) for r in s["replicas"]]
        frontier = max((l.get("durable_version", 0) for l in logs),
                       default=0)
        if st.get("recovery_state") == "fully_recovered" and logs \
                and reps \
                and all(r.get("version", -1) >= frontier for r in reps):
            return
        if flow.now() > deadline:
            raise error("timed_out")
        await flow.delay(flow.SERVER_KNOBS.quiet_database_poll,
                         TaskPriority.DEFAULT_ENDPOINT)


async def check_consistency(target, quiesce: bool = True) -> dict:
    """Sweep every shard from every replica; raise ConsistencyError on
    any divergence. Returns accounting: shards checked, replicas read,
    total rows (ref: ConsistencyCheck's performQuiescentChecks).

    `target` is a Database — in-sim or a RemoteDatabase over TCP: the
    sweep uses only the client surface (broadcast shard refs, GRVs,
    storage range reads, status), so `consistencycheck` works against
    a tools.server cluster the same as in simulation. A SimCluster is
    also accepted (the test harness shape), which additionally enables
    the stronger in-sim quiesce."""
    cluster = None
    db = target
    if not hasattr(target, "create_transaction"):
        cluster = target
        db = getattr(cluster, "_consistency_db", None)
        if db is None:
            db = cluster._consistency_db = \
                cluster.client("consistency-check")
    if quiesce:
        if cluster is not None:
            await cluster.quiet_database()
        else:
            await _quiesce_via_status(db)
    info = await db.info()
    proc = db.process
    # shard accounting: the shard map must partition [b"", +inf)
    # exactly — no gaps, no overlaps, ordered boundaries
    shards = info.storages
    if not shards:
        raise ConsistencyError("no shards in the published picture")
    if shards[0].begin != b"":
        raise ConsistencyError(
            f"first shard begins at {shards[0].begin!r}, not b''")
    for a, b in zip(shards, shards[1:]):
        if a.end != b.begin:
            raise ConsistencyError(
                f"shard gap/overlap: [..{a.end!r}) then [{b.begin!r}..)")
    if shards[-1].end is not None:
        raise ConsistencyError(
            f"last shard ends at {shards[-1].end!r}, not +inf")

    # read point: a GRV from the commit pipeline — after quiescence it
    # IS the log frontier every replica has reached; replicas slightly
    # behind it block (bounded by the read timeout) rather than serve
    # stale rows (ref: the workload's reads at a transaction version)
    version, _seq = await db.batched_grv()

    n_replicas = 0
    n_rows = 0
    expect_team = None
    for shard in shards:
        if not shard.replicas:
            raise ConsistencyError(
                f"shard [{shard.begin!r}..) has no replicas")
        if expect_team is None:
            expect_team = len(shard.replicas)
        elif len(shard.replicas) != expect_team:
            raise ConsistencyError(
                f"shard [{shard.begin!r}..) has {len(shard.replicas)} "
                f"replicas, others have {expect_team}")
        contents = []
        for rep in shard.replicas:
            try:
                rows = await _read_replica(rep, shard.begin, shard.end,
                                           version, proc)
            except flow.FdbError as e:
                raise ConsistencyError(
                    f"replica {rep.name} of [{shard.begin!r}..) "
                    f"unreadable: {e.name}") from None
            contents.append((rep.name, rows))
            n_replicas += 1
        base_name, base = contents[0]
        for name, rows in contents[1:]:
            if rows != base:
                detail = _first_divergence(base, rows)
                raise ConsistencyError(
                    f"replicas {base_name} and {name} of shard "
                    f"[{shard.begin!r}..{shard.end!r}) diverge: {detail}")
        n_rows += len(base)
    flow.TraceEvent("ConsistencyCheckOK").detail(
        Shards=len(shards), Replicas=n_replicas, Rows=n_rows).log()
    return {"shards": len(shards), "replicas": n_replicas,
            "rows": n_rows, "version": version}


def _first_divergence(a, b) -> str:
    da, db = dict(a), dict(b)
    for k in sorted(set(da) | set(db)):
        if da.get(k) != db.get(k):
            return (f"key {k!r}: {da.get(k)!r} vs {db.get(k)!r}")
    return f"row counts {len(a)} vs {len(b)}"
