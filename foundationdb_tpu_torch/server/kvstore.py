"""IKeyValueStore + the memory engine (log-structured over DiskQueue).

Reference: fdbserver/IKeyValueStore.h:38 (the engine interface) and
KeyValueStoreMemory.actor.cpp (the memory engine: all data in RAM,
durability via an operation log on a DiskQueue, periodically compacted
by snapshotting the whole map into the log). Re-implemented, not
ported: the snapshot here is a single log record carrying the full
sorted map, written when the op-log's live bytes exceed a threshold,
after which everything older is popped.

Engines are machine-scoped (open by name on the machine's SimDisk) so
a rebooted process recovers its predecessor's data.
"""

from __future__ import annotations

import struct
from bisect import bisect_left, insort
from typing import Dict, List, Optional, Tuple

from ..rpc.disk import SimDisk
from .diskqueue import DiskQueue

_OP_SET = 0
_OP_CLEAR = 1
_OP_SNAPSHOT = 2
_OP_BATCH = 3
_U32 = struct.Struct("<I")


def _enc_kv(op: int, a: bytes, b: bytes) -> bytes:
    return bytes([op]) + _U32.pack(len(a)) + a + _U32.pack(len(b)) + b


def _dec_kv(rec: bytes) -> Tuple[int, bytes, bytes]:
    op = rec[0]
    (la,) = _U32.unpack_from(rec, 1)
    a = rec[5:5 + la]
    (lb,) = _U32.unpack_from(rec, 5 + la)
    b = rec[9 + la:9 + la + lb]
    return op, a, b


class IKeyValueStore:
    """Engine contract (ref: IKeyValueStore.h): synchronous in-memory
    reads/staged writes + an async durability barrier."""

    async def recover(self) -> None:
        raise NotImplementedError

    def set(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def clear_range(self, begin: bytes, end: bytes) -> None:
        raise NotImplementedError

    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def get_range(self, begin: bytes, end: bytes, limit: int = 1 << 30,
                  reverse: bool = False) -> List[Tuple[bytes, bytes]]:
        raise NotImplementedError

    async def commit(self) -> None:
        """Make all staged mutations durable."""
        raise NotImplementedError

    def row_count(self) -> int:
        """Approximate stored row count (data-distribution signal)."""
        return len(self.get_range(b"", b"\xff", limit=1 << 20))


class EphemeralKeyValueStore(IKeyValueStore):
    """RAM-only engine for non-durable clusters: the storage server's
    durability loop runs against it unchanged, which keeps the MVCC
    window (and memory) bounded even when nothing persists (a
    non-durable default that skipped it would leak the window)."""

    def __init__(self):
        self._data: Dict[bytes, bytes] = {}
        self._keys: List[bytes] = []

    async def recover(self) -> None:
        return

    def set(self, key: bytes, value: bytes) -> None:
        if key not in self._data:
            insort(self._keys, key)
        self._data[key] = value

    def clear_range(self, begin: bytes, end: bytes) -> None:
        lo = bisect_left(self._keys, begin)
        hi = bisect_left(self._keys, end)
        for k in self._keys[lo:hi]:
            del self._data[k]
        del self._keys[lo:hi]

    def get(self, key: bytes) -> Optional[bytes]:
        return self._data.get(key)

    def get_range(self, begin: bytes, end: bytes, limit: int = 1 << 30,
                  reverse: bool = False) -> List[Tuple[bytes, bytes]]:
        lo = bisect_left(self._keys, begin)
        hi = bisect_left(self._keys, end)
        keys = self._keys[lo:hi]
        if reverse:
            keys = keys[::-1]
        return [(k, self._data[k]) for k in keys[:limit]]

    def row_count(self) -> int:
        return len(self._keys)

    async def commit(self) -> None:
        return


class KeyValueStoreMemory(IKeyValueStore):
    def __init__(self, disk: SimDisk, name: str, owner=None,
                 snapshot_threshold: int = 1 << 20):
        self._dq = DiskQueue(disk, name, owner)
        self._data: Dict[bytes, bytes] = {}
        self._keys: List[bytes] = []  # sorted index over _data
        self._staged: List[bytes] = []  # encoded ops since last commit
        self._threshold = snapshot_threshold

    # -- recovery -------------------------------------------------------
    async def recover(self) -> None:
        """Replay the op log; the newest snapshot (if any) resets the
        map and earlier records are irrelevant."""
        records = await self._dq.recover()
        self._data.clear()
        for rec in records:
            self._replay(rec)
        self._keys = sorted(self._data)

    def _replay(self, rec: bytes) -> None:
        op, a, b = _dec_kv(rec)
        if op == _OP_BATCH:
            # one commit = one record: sub-ops apply all-or-nothing, so a
            # torn tail can never surface half a commit (atomics in the
            # storage durability batch must not double-apply on re-pull)
            off = 0
            while off < len(a):
                (ln,) = _U32.unpack_from(a, off)
                self._replay(a[off + 4:off + 4 + ln])
                off += 4 + ln
        elif op == _OP_SNAPSHOT:
            self._data = dict(_iter_snapshot(a))
        elif op == _OP_SET:
            self._data[a] = b
        else:  # clear range [a, b)
            for k in [k for k in self._data if a <= k < b]:
                del self._data[k]

    # -- staged mutations ----------------------------------------------
    def set(self, key: bytes, value: bytes) -> None:
        if key not in self._data:
            insort(self._keys, key)
        self._data[key] = value
        self._staged.append(_enc_kv(_OP_SET, key, value))

    def clear_range(self, begin: bytes, end: bytes) -> None:
        lo = bisect_left(self._keys, begin)
        hi = bisect_left(self._keys, end)
        for k in self._keys[lo:hi]:
            del self._data[k]
        del self._keys[lo:hi]
        self._staged.append(_enc_kv(_OP_CLEAR, begin, end))

    # -- reads ----------------------------------------------------------
    def get(self, key: bytes) -> Optional[bytes]:
        return self._data.get(key)

    def get_range(self, begin: bytes, end: bytes, limit: int = 1 << 30,
                  reverse: bool = False) -> List[Tuple[bytes, bytes]]:
        lo = bisect_left(self._keys, begin)
        hi = bisect_left(self._keys, end)
        ks = self._keys[lo:hi]
        if reverse:
            ks = ks[::-1]
        return [(k, self._data[k]) for k in ks[:limit]]

    def row_count(self) -> int:
        return len(self._keys)

    # -- durability -----------------------------------------------------
    async def commit(self) -> None:
        staged, self._staged = self._staged, []
        if staged:
            blob = b"".join(_U32.pack(len(r)) + r for r in staged)
            await self._dq.push(_enc_kv(_OP_BATCH, blob, b""))
        await self._dq.commit()
        if self._dq.bytes_used > self._threshold:
            await self._snapshot()

    async def _snapshot(self) -> None:
        """Fold the whole map into one log record and pop the history
        (ref: KeyValueStoreMemory::semiCommit snapshot cycle)."""
        blob = b"".join(_U32.pack(len(k)) + k + _U32.pack(len(v)) + v
                        for k, v in sorted(self._data.items()))
        seq = await self._dq.push(_enc_kv(_OP_SNAPSHOT, blob, b""))
        await self._dq.commit()
        self._dq.pop(seq - 1)


def _iter_snapshot(blob: bytes):
    off = 0
    while off < len(blob):
        (lk,) = _U32.unpack_from(blob, off)
        k = blob[off + 4:off + 4 + lk]
        off += 4 + lk
        (lv,) = _U32.unpack_from(blob, off)
        v = blob[off + 4:off + 4 + lv]
        off += 4 + lv
        yield k, v
