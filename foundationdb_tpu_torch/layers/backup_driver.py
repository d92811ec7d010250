"""Cluster-side backup runner: watches the \\xff\\x02/backup/ control
rows and drives the continuous-backup agent against their container.

Reference: the backup_agent processes an operator runs alongside
fdbserver (`fdbbackup agent`, fdbbackup/backup.actor.cpp — agent mode
polling the backup config subspace written by `fdbbackup start`). The
split is the point: the fdbtpu-backup TOOL only ever commits control
rows through the ordinary client surface (so it works identically
in-sim and over TCP), while this driver — a process that lives with
the cluster — notices the rows, runs the BackupAgent lifecycle, and
uploads to the container URL the rows name.

Row protocol (server/systemkeys.py BACKUP_*): `dest` = container URL;
`state` walks submitted -> running -> (abort ->) stopped, or error;
`base_version` / `restorable_version` / `error` are driver-written
status the tool polls.
"""

from __future__ import annotations

from .. import flow
from ..flow import TaskPriority
from ..client import run_transaction
from ..server.systemkeys import (BACKUP_END, BACKUP_PREFIX,
                                 BACKUP_STATE_ABORT, BACKUP_STATE_ERROR,
                                 BACKUP_STATE_RUNNING,
                                 BACKUP_STATE_STOPPED,
                                 BACKUP_STATE_SUBMITTED)
from .backup_agent import BackupAgent
from .backup_container import open_container


async def read_backup_rows(db, max_retries: int = 2000) -> dict:
    """The \\xff\\x02/backup/ control rows, prefix-stripped — the ONE
    reader both the driver and the fdbtpu-backup tool use."""
    async def body(tr):
        tr.set_option("read_system_keys")
        return dict(await tr.get_range(BACKUP_PREFIX, BACKUP_END))
    full = await run_transaction(db, body, max_retries=max_retries)
    return {k[len(BACKUP_PREFIX):]: v for k, v in full.items()}


class BackupDriver:
    """One driver per cluster; at most one backup at a time (the
    reference multiplexes tagged backups — this slice has the default
    tag only)."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.db = cluster.client("backup-driver")
        self.agent: BackupAgent = None
        self._container = None
        self._task = None
        self._last_upload = 0.0

    def start(self) -> None:
        self._task = flow.spawn(self._run(), TaskPriority.DEFAULT_ENDPOINT,
                                name="backupDriver")

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    # -- row IO ----------------------------------------------------------
    async def _read_rows(self) -> dict:
        return await read_backup_rows(self.db, max_retries=10000)

    async def _write_rows(self, expect_state=None, **rows) -> None:
        """Commit status rows. With `expect_state`, the write happens
        only if the state row still matches — an operator command
        (abort, resubmit) committed while the driver was mid-transition
        must win, not be clobbered by the driver's stale intention (the
        read rides the same transaction, so the check is atomic). A
        skipped write needs no signal: every caller converges on the
        next poll round by re-reading the rows."""

        async def body(tr):
            tr.set_option("access_system_keys")
            if expect_state is not None:
                cur = await tr.get(BACKUP_PREFIX + b"state")
                if cur != expect_state:
                    return
            for k, v in rows.items():
                tr.set(BACKUP_PREFIX + k.encode(), v)
        await run_transaction(self.db, body, max_retries=10000)

    # -- the state machine ----------------------------------------------
    async def _run(self) -> None:
        while True:
            await flow.delay(
                flow.SERVER_KNOBS.backup_driver_poll_interval,
                TaskPriority.LOW_PRIORITY)
            try:
                rows = await self._read_rows()
            except flow.FdbError:
                continue          # cluster mid-recovery: try again
            state = rows.get(b"state")
            try:
                if state == BACKUP_STATE_SUBMITTED and self.agent is None:
                    await self._begin(rows)
                elif state == BACKUP_STATE_RUNNING and \
                        self.agent is not None:
                    await self._maybe_upload()
                elif state == BACKUP_STATE_RUNNING:
                    # rows say running but nothing is (driver/server
                    # restarted: the tail history died with it) — an
                    # honest error beats a backup frozen in `running`
                    # forever; the operator resubmits (ref: a restarted
                    # reference agent RESUMES from container state —
                    # resumable backups are out of this slice's scope)
                    await self._write_rows(
                        expect_state=BACKUP_STATE_RUNNING,
                        state=BACKUP_STATE_ERROR,
                        error=b"backup driver restarted mid-backup; "
                              b"abort is not needed, resubmit")
                elif state == BACKUP_STATE_ABORT:
                    await self._finish()
            except flow.ActorCancelled:
                raise
            except BaseException as e:  # noqa: BLE001 — surfaced in rows
                # ANY failure — container IO, cluster errors past the
                # transaction retry budget — must tear the agent down
                # (or the backup tag would pin TLog records forever)
                # and surface through the rows, never kill the driver
                flow.TraceEvent("BackupDriverError", "backup-driver",
                                severity=flow.trace.SevWarnAlways).detail(
                    Error=repr(e)).log()
                if self.agent is not None:
                    try:
                        await self.agent.stop()
                    except (flow.FdbError, flow.ActorCancelled):
                        pass
                    self.agent = None
                self._container = None
                try:
                    # compare-and-set against the state this iteration
                    # acted on: an operator command (abort/resubmit)
                    # that committed while we were tearing down wins —
                    # the next poll acts on it instead of finding our
                    # ERROR stamped over it
                    await self._write_rows(expect_state=state,
                                           state=BACKUP_STATE_ERROR,
                                           error=repr(e).encode())
                except flow.FdbError:
                    pass   # cluster unhealthy: rows update next round

    async def _begin(self, rows: dict) -> None:
        dest = rows.get(b"dest", b"").decode()
        self._container = open_container(dest)
        self.agent = BackupAgent(self.cluster, self.db)
        base = await self.agent.start()
        # save_to serializes LIVE agent state (log records the puller
        # actor keeps appending): it must run on the loop, never on a
        # pool thread — a concurrent snapshot could certify a version
        # window while missing a mutation inside it. Its blob retries
        # skip the backoff sleep on the loop (_retry_backoff). Pure
        # container IO (describe) is offloaded via arun.
        self.agent.save_to(self._container)
        self._last_upload = flow.now()
        d = await self._container.arun(self._container.describe)
        # start() spans a full epoch recovery — if an abort committed
        # meanwhile, the abort wins: don't stamp `running` over it (the
        # next poll sees `abort` and finishes the agent)
        await self._write_rows(
            expect_state=BACKUP_STATE_SUBMITTED,
            state=BACKUP_STATE_RUNNING,
            base_version=str(base).encode(),
            restorable_version=str(
                d["max_restorable_version"] or base).encode())

    async def _maybe_upload(self) -> None:
        if flow.now() - self._last_upload < \
                flow.SERVER_KNOBS.backup_driver_upload_interval:
            return
        self._last_upload = flow.now()
        self.agent.save_to(self._container)   # live agent state: on-loop
        d = await self._container.arun(self._container.describe)
        if d["max_restorable_version"] is not None:
            await self._write_rows(
                expect_state=BACKUP_STATE_RUNNING,
                restorable_version=str(d["max_restorable_version"]).encode())

    async def _finish(self) -> None:
        if self.agent is not None:
            await self.agent.stop()
            self.agent.save_to(self._container)   # agent stopped; on-loop
            d = await self._container.arun(self._container.describe)
            extra = {}
            if d["max_restorable_version"] is not None:
                extra["restorable_version"] = str(
                    d["max_restorable_version"]).encode()
            # a fresh submit committed while we were stopping the old
            # agent must not be clobbered with `stopped`
            await self._write_rows(expect_state=BACKUP_STATE_ABORT,
                                   state=BACKUP_STATE_STOPPED, **extra)
            self.agent = None
            self._container = None
        else:
            await self._write_rows(expect_state=BACKUP_STATE_ABORT,
                                   state=BACKUP_STATE_STOPPED)
