"""Continuous backup: a mutation-log tail + snapshot = point-in-time
restore.

Reference: fdbclient/FileBackupAgent.actor.cpp + design/backup.md — a
backup is a range snapshot PLUS a continuous mutation log; restore
applies the snapshot then replays the log to the target version. The
log here comes from a dedicated backup tag the proxies add to every
mutation while a backup is active (ref: the backup mutation-log tags):
one stream preserves exact intra-version mutation order, and the agent
is registered in the TLogs' expected-replica sets so records it has
not yet persisted are never popped away beneath it.

Protocol: enable the tag FIRST, then take the snapshot — every
mutation after the snapshot version is guaranteed present in the tail,
and restore discards log records at or below it.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

from .. import flow
from ..flow import TaskPriority
from ..server.types import MutationRef, TLogPeekRequest, TLogPopRequest
from . import backup as snapshot_backup

LOG_MAGIC = b"FDBTPUML"
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

AGENT_NAME = "backup-agent"


class BackupAgent:
    """Drives one continuous backup of a SimCluster (operator-side
    tool, like the CLI: it holds the cluster handle the way fdbbackup
    holds a cluster file)."""

    def __init__(self, cluster, db,
                 backup_range: Tuple[bytes, bytes] = (b"", b"\xff")):
        self.cluster = cluster
        self.db = db
        # what this backup covers (ref: backupRanges — the default is
        # the whole user keyspace). The tail CLIPS the stream to it, so
        # \xff rows — notably the \xff\x02/backup/ control rows the
        # driver itself writes — never enter the mutation log: a
        # restore must not replay the tool's own state machine into
        # the live control subspace
        self.backup_range = backup_range
        self.base_blob: Optional[bytes] = None
        self.base_version = 0
        self.log_records: List[Tuple[int, Tuple[MutationRef, ...]]] = []
        self._tail_task = None
        self._tailed_to = 0
        self._stop = False
        self._replica_rr = 0
        # identity token for container-held incremental upload state
        self._upload_token = object()

    # -- lifecycle -------------------------------------------------------
    async def _tagging_recovery(self, active: bool) -> None:
        """Flip the backup tag THROUGH an epoch recovery: the next
        epoch's proxies are recruited with the flag and its TLogs with
        the agent in BACKUP_TAG's replica set — nothing pokes live
        roles, so the change also works over a real deployment (ref:
        backup tagging as part of the log system configuration; same
        shape as attaching a region)."""
        cc = self.cluster.cc
        cc.backup_active = active
        cc.backup_agent = self if active else None
        cc._config_dirty = True
        # wait for a SETTLED epoch that advertises the flag — not
        # merely the next epoch: a recovery already past recruitment
        # when the flag flipped publishes the stale value, and the
        # level-triggered config-dirty recovery after it publishes the
        # corrected one (start: a silent log hole otherwise; stop: the
        # tag would pin records forever)
        while True:
            info = cc.dbinfo.get()
            if info.backup_active == active and \
                    info.recovery_state == "fully_recovered":
                return
            await flow.first_of(
                cc.dbinfo.on_change(),
                flow.delay(flow.SERVER_KNOBS.backup_nudge_interval,
                           TaskPriority.DEFAULT_ENDPOINT))

    async def start(self) -> int:
        """Enable the tag via recovery, start tailing at the new
        epoch's recovery version (everything before it is untagged but
        provably below the snapshot), then snapshot; returns the
        snapshot (base) version."""
        cc = self.cluster.cc
        await self._tagging_recovery(True)
        # every commit of the new epoch carries the tag; the snapshot's
        # GRV is above the recovery version, so each untagged (older)
        # transaction is inside the snapshot and each later one is in
        # the tail
        start_v = cc.dbinfo.get().recovery_version
        self._tail_task = flow.spawn(self._tail(start_v),
                                     TaskPriority.DEFAULT_ENDPOINT,
                                     name="backupAgent.tail")
        blob, version, _n = await snapshot_backup.backup(self.db)
        self.base_blob = blob
        self.base_version = version
        return version

    async def stop(self) -> None:
        self._stop = True
        await self._tagging_recovery(False)
        if self._tail_task is not None:
            await flow.catch_errors(self._tail_task)

    # -- the tail (modeled on the storage pull loop) ---------------------
    async def _tail(self, start_version: int) -> None:
        from ..server.proxy import BACKUP_TAG
        version = start_version
        while not self._stop:
            info = self.cluster.cc.dbinfo.get()
            src = self._pick_source(info, version + 1)
            if src is None:
                await flow.delay(
                    flow.SERVER_KNOBS.backup_source_retry_delay,
                    TaskPriority.DEFAULT_ENDPOINT)
                continue
            gen, refs = src
            try:
                reply = await flow.timeout_error(refs.peeks.get_reply(
                    TLogPeekRequest(version + 1, BACKUP_TAG),
                    self.db.process),
                    flow.SERVER_KNOBS.backup_peek_timeout)
            except flow.FdbError:
                self._replica_rr += 1   # rotate off a dead replica
                await flow.delay(flow.SERVER_KNOBS.backup_tail_idle_delay,
                                 TaskPriority.DEFAULT_ENDPOINT)
                continue
            cap = gen.end_version if gen.end_version >= 0 else None
            # never record beyond what is known replicated cluster-wide:
            # a single tlog's durable tail can roll back in a recovery,
            # and the log must only ever contain versions a consistent
            # database state actually had (the storage pull applies the
            # same cap to durability)
            safe = reply.known_committed
            if cap is not None:
                safe = max(safe, cap)   # a locked gen's end IS final
            before = version
            for v, mutations in reply.entries:
                if v <= version:
                    continue
                if cap is not None and v > cap:
                    break
                if v > safe:
                    break
                kept = self._clip(mutations)
                if kept:
                    self.log_records.append((v, kept))
                version = v
            adv = min(reply.committed_version, safe)
            if cap is not None:
                adv = min(adv, cap)
            version = max(version, adv)
            self._tailed_to = version
            if version > before:
                refs.pops.send(TLogPopRequest(version, BACKUP_TAG,
                                              AGENT_NAME), self.db.process)
            elif cap is None:
                # no progress on the open generation: known_committed
                # only advances with fresh commits — nudge one through
                await self._nudge_commit()
                await flow.delay(flow.SERVER_KNOBS.backup_tail_idle_delay,
                                 TaskPriority.DEFAULT_ENDPOINT)

    def _clip(self, mutations) -> Tuple[MutationRef, ...]:
        """Clip a version's mutations to the backup range (ref: the
        backup's backupRanges bounding what the mutation log keeps)."""
        lo, hi = self.backup_range
        from ..server.types import CLEAR_RANGE
        out = []
        for m in mutations:
            if m.type == CLEAR_RANGE:
                b, e = max(m.param1, lo), min(m.param2, hi)
                if b < e:
                    out.append(m if (b, e) == (m.param1, m.param2)
                               else MutationRef(CLEAR_RANGE, b, e))
            elif lo <= m.param1 < hi:
                out.append(m)
        return tuple(out)

    def _pick_source(self, info, needed: int):
        from ..server.dbinfo import pick_log_source
        return pick_log_source(info, needed, self._replica_rr)

    async def _nudge_commit(self) -> None:
        from ..server.types import CommitRequest
        info = self.cluster.cc.dbinfo.get()
        if info.proxies:
            await flow.catch_errors(flow.timeout_error(
                info.proxies[0].commits.get_reply(
                    CommitRequest(0, (), (), ()), self.db.process), 1.0))

    async def _wait_until(self, pred, max_wait: float) -> None:
        """Poll with commit nudges: the tail/apply frontiers only
        advance through known_committed, which needs fresh commits on
        an idle cluster."""
        deadline = flow.now() + max_wait
        while not pred():
            if flow.now() > deadline:
                raise flow.error("timed_out")
            await self._nudge_commit()
            await flow.delay(flow.SERVER_KNOBS.backup_nudge_interval,
                             TaskPriority.DEFAULT_ENDPOINT)

    async def wait_tailed_to(self, version: int, max_wait: float = 30.0):
        await self._wait_until(lambda: self._tailed_to >= version, max_wait)

    # -- container -------------------------------------------------------
    def save_to(self, container, chunk_records: int = None) -> dict:
        """Write this backup into a container using the reference's
        file layout: one snapshot object + chunked mutation-log objects
        whose names carry their version coverage (ref: BackupContainer
        snapshots/ + logs/ naming). INCREMENTAL per container: the
        snapshot and full chunks upload once; only the growing tail
        chunk re-uploads (overlapping coverage is clipped at restore) —
        so the periodic driver upload is O(new records), not O(whole
        history). Returns the container's describe(). Plain sync object
        IO, like fdbbackup writing to its target."""
        from .backup_container import _records_to_log_blob
        if chunk_records is None:
            chunk_records = int(
                flow.SERVER_KNOBS.backup_log_chunk_records)
        if self.base_blob is None:
            raise ValueError("backup has no snapshot yet (start() first)")
        # incremental state lives ON the container (keyed by this
        # agent): it dies with the container, and a fresh container can
        # never inherit another's consumed-record counters
        st = getattr(container, "_agent_upload_state", None)
        if st is None or st.get("agent") is not self._upload_token:
            # keyed by a per-agent token, NOT the agent itself: a
            # container outliving the agent must not pin the agent's
            # whole mutation-log history in memory
            st = {"agent": self._upload_token, "snap": False, "n": 0,
                  "end": self.base_version}
            container._agent_upload_state = st
        if not st["snap"]:
            container.store_snapshot(self.base_blob, self.base_version)
            st["snap"] = True
        recs = [r for r in self.log_records if r[0] > self.base_version]
        i = st["n"]
        # complete chunks: upload once and consume
        while len(recs) - i >= chunk_records:
            chunk = recs[i:i + chunk_records]
            i += chunk_records
            end = chunk[-1][0]
            container.store_log(
                _records_to_log_blob(chunk, self.base_version),
                st["end"], end)
            st["n"], st["end"] = i, end
        # the partial tail: re-upload from the last consumed boundary
        # with coverage out to the tail frontier (versions with no
        # backup-tagged payload are still certified mutation-free)
        tail = recs[i:]
        tail_end = max([r[0] for r in tail] + [self._tailed_to])
        if tail_end > st["end"]:
            container.store_log(
                _records_to_log_blob(tail, self.base_version),
                st["end"], tail_end)
        return container.describe()

    def write_log(self) -> bytes:
        return encode_log(self.log_records, self.base_version)


def encode_log(records, base_version: int) -> bytes:
    """The mutation-log wire format (one encoder, one decoder —
    read_log below): MAGIC, base version, then (version, mutations)
    records."""
    out = [LOG_MAGIC, _U64.pack(base_version), _U64.pack(len(records))]
    for v, mutations in records:
        out.append(_U64.pack(v))
        out.append(_U32.pack(len(mutations)))
        for m in mutations:
            out.append(bytes([m.type]))
            out.append(_U32.pack(len(m.param1)))
            out.append(m.param1)
            out.append(_U32.pack(len(m.param2)))
            out.append(m.param2)
    return b"".join(out)


def read_log(blob: bytes):
    if blob[:8] != LOG_MAGIC:
        raise ValueError("not a mutation log")
    (base_version,) = _U64.unpack_from(blob, 8)
    (n,) = _U64.unpack_from(blob, 16)
    off = 24
    records = []
    for _ in range(n):
        (v,) = _U64.unpack_from(blob, off)
        off += 8
        (nm,) = _U32.unpack_from(blob, off)
        off += 4
        ms = []
        for _ in range(nm):
            t = blob[off]
            off += 1
            (l1,) = _U32.unpack_from(blob, off)
            p1 = bytes(blob[off + 4:off + 4 + l1])
            off += 4 + l1
            (l2,) = _U32.unpack_from(blob, off)
            p2 = bytes(blob[off + 4:off + 4 + l2])
            off += 4 + l2
            ms.append(MutationRef(t, p1, p2))
        records.append((v, tuple(ms)))
    return base_version, records


def _replay_mutations(tr, mutations) -> None:
    """Replay one logged mutation batch into a transaction — the single
    apply switch shared by restore and DR (a replayable type added here
    serves both paths). System-key mutations (the \\xff\\x02 stored
    subspace rides the backup tag like everything else) need the
    option, exactly as the reference's restore does."""
    from ..server.types import (ATOMIC_OPS, CLEAR_RANGE, INERT_OPS,
                                SET_VALUE)
    tr.set_option("access_system_keys")
    for m in mutations:
        if m.type == SET_VALUE:
            tr.set(m.param1, m.param2)
        elif m.type == CLEAR_RANGE:
            tr.clear_range(m.param1, m.param2)
        elif m.type in ATOMIC_OPS:
            tr.atomic_op(m.param1, m.param2, m.type)
        elif m.type in INERT_OPS:
            pass  # debug markers/no-ops ride the log but mutate nothing
        else:
            raise ValueError(f"unreplayable mutation {m.type}")


async def restore_to_version(db, snapshot_blob: bytes, log_blob: bytes,
                             target_version: int,
                             max_retries: int = 300) -> int:
    """Point-in-time restore: the snapshot state plus every logged
    mutation in (base_version, target_version], applied in exact
    commit order (ref: the restore apply loop replaying log files)."""
    from ..client import run_transaction

    base_version, records = read_log(log_blob)
    if target_version < base_version:
        raise ValueError("target predates the snapshot")
    await snapshot_backup.restore(db, snapshot_blob,
                                  max_retries=max_retries)
    applied = 0
    batch: List[MutationRef] = []
    for v, mutations in records:
        if v <= base_version or v > target_version:
            continue
        batch.extend(mutations)
    marker_space = b"\x02restore-mark/"
    for i in range(0, len(batch), 200):
        chunk = batch[i:i + 200]
        marker = marker_space + b"%012d" % i

        async def body(tr, chunk=chunk, marker=marker):
            # chunk marker: atomic ops are NOT idempotent, so a retry
            # after commit_unknown_result must detect an applied chunk
            # instead of re-running it (the reference's idempotency
            # pattern for restore apply)
            if await tr.get(marker) is not None:
                return
            _replay_mutations(tr, chunk)
            tr.set(marker, b"1")
        await run_transaction(db, body, max_retries=max_retries)
        applied += len(chunk)

    async def clear_markers(tr):
        tr.clear_range(marker_space, marker_space + b"\xff")
    await run_transaction(db, clear_markers, max_retries=max_retries)
    return applied


class DrAgent(BackupAgent):
    """Continuous replication to a DESTINATION database (ref:
    fdbclient/DatabaseBackupAgent.actor.cpp — DR is the same mutation
    stream applied to another cluster instead of files). The
    destination converges to each source version in commit order;
    chunk markers make the apply exactly-once across retries."""

    MARKER_SPACE = b"\x02dr-mark/"

    def __init__(self, cluster, db, dest_db):
        super().__init__(cluster, db)
        self.dest_db = dest_db
        self.applied_version = 0
        self._apply_task = None
        self._applied_idx = 0
        self._apply_error: Optional[BaseException] = None

    async def start(self) -> int:
        """Snapshot into the destination, then stream the tail."""
        base = await super().start()
        await snapshot_backup.restore(self.dest_db, self.base_blob)
        self.applied_version = base
        self._apply_task = flow.spawn(self._apply_loop(),
                                      TaskPriority.DEFAULT_ENDPOINT,
                                      name="drAgent.apply")
        return base

    async def stop(self) -> None:
        await super().stop()
        if self._apply_task is not None:
            await flow.catch_errors(self._apply_task)
        if self._apply_error is not None:
            raise self._apply_error
        # the idempotency markers served their purpose: leave the
        # destination byte-identical to the source's replicated range
        from ..client import run_transaction

        async def clear_markers(tr):
            tr.clear_range(self.MARKER_SPACE, self.MARKER_SPACE + b"\xff")
        await run_transaction(self.dest_db, clear_markers, max_retries=300)

    async def wait_applied_to(self, version: int,
                              max_wait: float = 60.0) -> None:
        def pred():
            if self._apply_error is not None:
                raise self._apply_error
            return self.applied_version >= version
        await self._wait_until(pred, max_wait)

    async def _apply_loop(self) -> None:
        try:
            await self._apply_records()
        except flow.ActorCancelled:
            raise
        except BaseException as e:  # noqa: BLE001 — surfaced to waiters
            self._apply_error = e

    async def _apply_records(self) -> None:
        from ..client import run_transaction
        while not (self._stop and
                   self._applied_idx >= len(self.log_records)):
            if self._applied_idx >= len(self.log_records):
                # drained: everything at or below the tail frontier is
                # applied — a version with no backup-tagged record
                # (empty nudge commits) must still become waitable
                self.applied_version = max(self.applied_version,
                                           self._tailed_to)
                await flow.delay(flow.SERVER_KNOBS.backup_agent_poll_delay,
                                 TaskPriority.DEFAULT_ENDPOINT)
                continue
            i = self._applied_idx
            v, mutations = self.log_records[i]
            self._applied_idx += 1
            if v <= self.base_version:
                self.applied_version = max(self.applied_version, v)
                continue
            marker = self.MARKER_SPACE + b"%012d" % i

            async def body(tr, mutations=mutations, marker=marker):
                if await tr.get(marker) is not None:
                    return
                _replay_mutations(tr, mutations)
                tr.set(marker, b"1")
            await run_transaction(self.dest_db, body, max_retries=300)
            self.applied_version = max(self.applied_version, v)
