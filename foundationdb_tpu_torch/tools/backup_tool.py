"""fdbtpu-backup / fdbtpu-restore: the operator-facing backup driver.

Reference: fdbbackup/backup.actor.cpp:74 — ONE multiplexed binary
(fdbbackup start/status/wait/abort, fdbrestore) that drives backups by
writing the backup config subspace and polling it; the cluster-side
agents do the actual work. Here the same split: every subcommand
speaks ONLY the client surface — control rows under \\xff\\x02/backup/
(server/systemkeys.py) plus container IO — so the tool works
identically against an in-sim cluster and over TCP
(`--connect host:port` dials a tools.server gateway). The cluster must
run a BackupDriver (tools.server does; SimCluster(backup_driver=True)
in-sim) — without one, `start` commits rows nobody serves, exactly
like fdbbackup with no agents running.

    python -m foundationdb_tpu_torch.tools.backup_tool start -d blobstore://h:p -C host:port
    ... status|wait|abort -C host:port
    ... restore -r blobstore://h:p [--version N] -C host:port
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from .. import flow
from ..client import run_transaction
from ..layers.backup_container import (open_container,
                                       restore_from_container)
from ..server.systemkeys import (BACKUP_END, BACKUP_PREFIX,
                                 BACKUP_STATE_ABORT, BACKUP_STATE_ERROR,
                                 BACKUP_STATE_RUNNING,
                                 BACKUP_STATE_STOPPED,
                                 BACKUP_STATE_SUBMITTED)

_ACTIVE = (BACKUP_STATE_SUBMITTED, BACKUP_STATE_RUNNING)


async def _read_rows(db) -> dict:
    from ..layers.backup_driver import read_backup_rows
    return await read_backup_rows(db, max_retries=2000)


async def backup_start(db, url: str) -> dict:
    """Submit a backup: commit dest+state rows; the cluster's driver
    picks them up (ref: fdbbackup start writing the config subspace)."""
    open_container(url)   # fail fast on a bad URL, like the reference
    conflict = []

    async def body(tr):
        tr.set_option("access_system_keys")
        cur = await tr.get(BACKUP_PREFIX + b"state")
        if cur in _ACTIVE:
            conflict.append(cur)
            return
        tr.clear_range(BACKUP_PREFIX, BACKUP_END)
        tr.set(BACKUP_PREFIX + b"dest", url.encode())
        tr.set(BACKUP_PREFIX + b"state", BACKUP_STATE_SUBMITTED)
    await run_transaction(db, body, max_retries=2000)
    if conflict:
        raise RuntimeError(
            f"a backup is already {conflict[0].decode()} — abort it first")
    return {"state": "submitted", "dest": url}


async def backup_status(db) -> dict:
    """Control-row view plus the container's own manifest (ref:
    fdbbackup status / describe)."""
    rows = await _read_rows(db)
    out = {k.decode(): v.decode(errors="replace")
           for k, v in rows.items()}
    dest = rows.get(b"dest")
    if dest:
        try:
            out["container"] = open_container(dest.decode()).describe()
        except (IOError, OSError, ValueError) as e:
            out["container_error"] = repr(e)
    return out


async def backup_wait(db, version: Optional[int] = None,
                      max_wait: float = 120.0) -> dict:
    """Block until the backup is restorable (to `version` if given) —
    ref: fdbbackup wait."""
    deadline = flow.now() + max_wait
    while True:
        rows = await _read_rows(db)
        state = rows.get(b"state", b"")
        if state == BACKUP_STATE_ERROR:
            raise RuntimeError(
                f"backup failed: {rows.get(b'error', b'?').decode()}")
        restorable = int(rows.get(b"restorable_version", b"-1"))
        if state in (BACKUP_STATE_RUNNING, BACKUP_STATE_STOPPED) \
                and restorable >= 0 \
                and (version is None or restorable >= version):
            return {"state": state.decode(),
                    "restorable_version": restorable}
        if flow.now() > deadline:
            raise TimeoutError(
                f"backup not restorable to {version} after {max_wait}s "
                f"(state={state.decode()}, restorable={restorable})")
        await flow.delay(flow.SERVER_KNOBS.backup_tool_poll_delay)


async def backup_abort(db, max_wait: float = 120.0) -> dict:
    """Stop the backup and wait for the driver to finalize the
    container (ref: fdbbackup abort)."""
    async def body(tr):
        tr.set_option("access_system_keys")
        tr.set(BACKUP_PREFIX + b"state", BACKUP_STATE_ABORT)
    await run_transaction(db, body, max_retries=2000)
    deadline = flow.now() + max_wait
    while True:
        rows = await _read_rows(db)
        if rows.get(b"state") == BACKUP_STATE_STOPPED:
            return {"state": "stopped",
                    "restorable_version":
                        int(rows.get(b"restorable_version", b"-1"))}
        if flow.now() > deadline:
            raise TimeoutError("abort did not finalize in time")
        await flow.delay(flow.SERVER_KNOBS.backup_tool_poll_delay)


async def backup_restore(db, url: str,
                         version: Optional[int] = None) -> dict:
    """Restore from a container through ordinary transactions (ref:
    fdbrestore driving the restore from a container URL)."""
    v = await restore_from_container(db, open_container(url), version)
    return {"restored_to_version": v}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="fdbtpu-backup",
        description="backup/restore driver (ref: fdbbackup/fdbrestore)")
    ap.add_argument("command",
                    choices=["start", "status", "wait", "abort",
                             "restore"])
    ap.add_argument("-d", "--dest", help="container URL (start)")
    ap.add_argument("-r", "--source", help="container URL (restore)")
    ap.add_argument("-C", "--connect", required=True,
                    metavar="HOST:PORT",
                    help="cluster gateway (tools.server)")
    ap.add_argument("--version", type=int, default=None)
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args(argv)

    from ..client.remote import RemoteCluster
    host, port = args.connect.rsplit(":", 1)
    rc = RemoteCluster(host, int(port))
    try:
        db = rc.db
        if args.command == "start":
            if not args.dest:
                ap.error("start requires -d/--dest")
            out = rc.call(backup_start(db, args.dest),
                          timeout=args.timeout)
        elif args.command == "status":
            out = rc.call(backup_status(db), timeout=args.timeout)
        elif args.command == "wait":
            out = rc.call(backup_wait(db, args.version, args.timeout),
                          timeout=args.timeout + 10)
        elif args.command == "abort":
            out = rc.call(backup_abort(db, args.timeout),
                          timeout=args.timeout + 10)
        else:
            if not args.source:
                ap.error("restore requires -r/--source")
            out = rc.call(backup_restore(db, args.source, args.version),
                          timeout=args.timeout)
        print(json.dumps(out))
        return 0
    except (RuntimeError, TimeoutError, ValueError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    finally:
        rc.close()


if __name__ == "__main__":
    sys.exit(main())
