"""Backup / restore: snapshot the database to a file and bring it back.

Reference: fdbclient/FileBackupAgent.actor.cpp + design/backup.md — a
backup is a consistent range snapshot (here: one paged read version,
exactly the consistency the reference's snapshot phase provides per
range file) written as length-prefixed kv records behind a versioned
header; restore clears the target range and writes the records back in
batches. The reference's continuous mutation log (for point-in-time
restore) rides the same container format and is future work; this
covers the fdbbackup/fdbrestore snapshot path.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

MAGIC = b"FDBTPUBK"
FORMAT_VERSION = 1
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

PAGE = 1000          # rows per read page
RESTORE_BATCH = 500  # rows per restore transaction


async def backup(db, begin: bytes = b"", end: bytes = b"\xff",
                 max_attempts: int = 50):
    """Snapshot [begin, end) at a single read version; returns
    (blob, version, row_count). A scan that outlives the MVCC window
    (or hits any retryable failure) restarts with a fresh read version
    — the snapshot is consistent at whichever version completes."""
    from ..client import RETRYABLE
    from .. import flow

    last = None
    for _attempt in range(max_attempts):
        tr = db.create_transaction()
        rows: List[Tuple[bytes, bytes]] = []
        cursor = begin
        try:
            while True:
                page = await tr.get_range(cursor, end, limit=PAGE,
                                          snapshot=True)
                rows.extend(page)
                if len(page) < PAGE:
                    break
                cursor = page[-1][0] + b"\x00"
            version = await tr.get_read_version()
            break
        except flow.FdbError as e:
            if e.name not in RETRYABLE:
                raise
            last = e
            await tr.on_error(e)
    else:
        raise last
    out = [MAGIC, bytes([FORMAT_VERSION]), _U64.pack(version),
           _U32.pack(len(begin)), begin, _U32.pack(len(end)), end,
           _U64.pack(len(rows))]
    for k, v in rows:
        out.append(_U32.pack(len(k)))
        out.append(k)
        out.append(_U32.pack(len(v)))
        out.append(v)
    return b"".join(out), version, len(rows)


def backup_to_file(blob: bytes, path: str) -> None:
    with open(path, "wb") as f:
        f.write(blob)


def read_backup(path_or_blob) -> Tuple[bytes, bytes, int,
                                       List[Tuple[bytes, bytes]]]:
    """Parse a backup; returns (begin, end, version, rows)."""
    if isinstance(path_or_blob, (bytes, bytearray)):
        b = bytes(path_or_blob)
    else:
        with open(path_or_blob, "rb") as f:
            b = f.read()
    if b[:8] != MAGIC or b[8] != FORMAT_VERSION:
        raise ValueError("not a backup file (bad magic/version)")
    off = 9
    (version,) = _U64.unpack_from(b, off)
    off += 8
    (lb,) = _U32.unpack_from(b, off)
    off += 4
    begin = b[off:off + lb]
    off += lb
    (le,) = _U32.unpack_from(b, off)
    off += 4
    end = b[off:off + le]
    off += le
    (n,) = _U64.unpack_from(b, off)
    off += 8
    rows = []
    for _ in range(n):
        (lk,) = _U32.unpack_from(b, off)
        off += 4
        k = b[off:off + lk]
        off += lk
        (lv,) = _U32.unpack_from(b, off)
        off += 4
        v = b[off:off + lv]
        off += lv
        rows.append((k, v))
    return begin, end, version, rows


async def restore(db, path_or_blob, max_retries: int = 200) -> int:
    """Clear the backed-up range and write the snapshot back in
    batches (ref: the restore apply loop). Returns rows restored."""
    from ..client import run_transaction

    begin, end, _version, rows = read_backup(path_or_blob)

    async def clear_body(tr):
        tr.clear_range(begin, end)
    await run_transaction(db, clear_body, max_retries=max_retries)

    for i in range(0, len(rows), RESTORE_BATCH):
        batch = rows[i:i + RESTORE_BATCH]

        async def body(tr, batch=batch):
            for k, v in batch:
                tr.set(k, v)
        await run_transaction(db, body, max_retries=max_retries)
    return len(rows)
