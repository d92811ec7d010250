"""DiskQueue: a durable, poppable FIFO of byte records over two files.

Reference: fdbserver/DiskQueue.actor.cpp / IDiskQueue.h — the write-
ahead log under both the TLog and the memory KV engine. Capabilities
re-implemented (not ported):

  - push(bytes) appends a record; commit() makes everything pushed so
    far durable (one sync) and resolves only after the fsync;
  - pop(up_to) logically discards the oldest records; space is
    reclaimed by truncating a file once every record in it is popped
    (the reference's two-file alternation — a real disk cannot trim a
    file's front);
  - recovery scans both files and yields exactly the records of the
    longest valid committed prefix: each record carries a checksum and
    a monotone sequence number, so a torn tail (power loss mid-write,
    rpc/disk.py semantics) is detected and cut.

Record format (little-endian): [seq u64][len u32][crc32 u32][payload].
A file begins with an 8-byte header: the sequence number of its first
record (so recovery knows which file is older).
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Tuple

from .. import flow
from ..rpc.disk import SimDisk, SimFile

_REC_HDR = struct.Struct("<QII")
_FILE_HDR = struct.Struct("<Q")


def walk_records(raw) -> Tuple[List[Tuple[int, bytes, int, int, int]],
                               int, int]:
    """Walk a file image's valid record chain — THE shared format
    walker: recovery's `_scan` and the chaos corruption helpers
    (server/chaos.py) must agree byte-for-byte on what a committed
    record is, so the walk exists exactly once.

    -> ([(seq, payload, payload_off, length, record_off)...], first_seq,
        stop_off) where stop_off is where the chain ended (EOF, or the
    first record that failed a header/length/CRC check). The payload is
    the bytes the CRC check already materialized — recovery keeps it,
    offset-only callers ignore it."""
    if len(raw) < _FILE_HDR.size:
        return [], 1 << 62, 0
    (first_seq,) = _FILE_HDR.unpack_from(raw, 0)
    off = _FILE_HDR.size
    expect = first_seq
    out: List[Tuple[int, bytes, int, int, int]] = []
    while off + _REC_HDR.size <= len(raw):
        seq, length, crc = _REC_HDR.unpack_from(raw, off)
        payload = bytes(raw[off + _REC_HDR.size:
                            off + _REC_HDR.size + length])
        if seq != expect or len(payload) != length \
                or zlib.crc32(payload) != crc:
            break
        out.append((seq, payload, off + _REC_HDR.size, length, off))
        expect += 1
        off += _REC_HDR.size + length
    return out, first_seq, off


class DiskQueue:
    """Two-file durable FIFO. Single writer, cooperative scheduling."""

    def __init__(self, disk: SimDisk, name: str, owner=None,
                 file_size_limit: int = None):
        self._disk = disk
        self._name = name
        self._owner = owner
        if file_size_limit is None:
            from ..flow import SERVER_KNOBS
            file_size_limit = int(SERVER_KNOBS.disk_queue_file_size)
        self._limit = file_size_limit
        self._files: List[SimFile] = [
            disk.open(f"{name}.dq0", owner), disk.open(f"{name}.dq1", owner)]
        # in-memory mirror of the live queue: (seq, payload); a SPILLED
        # record's payload is None — re-read from file via read(seq)
        # (ref: spill-by-reference, the TLog keeping DiskQueue positions
        # instead of values once memory exceeds the spill threshold)
        self._records: List[Tuple[int, Optional[bytes]]] = []
        self._offsets: dict = {}   # seq -> (file_idx, payload_off, length)
        self._next_seq = 0
        self._popped_seq = -1  # highest seq discarded
        self._cur = 0          # index of the file being appended
        self._append_off = [0, 0]
        self._file_first_seq = [0, 0]
        self._file_last_seq = [-1, -1]
        self._unsynced = False
        self._recovered = False

    # -- recovery -------------------------------------------------------
    async def recover(self) -> List[bytes]:
        """Scan both files; rebuild state; return surviving payloads in
        order (ref: DiskQueue::initializeRecovery + readNext).

        The valid data is the longest strictly-sequential record prefix
        across both files (older file first). Everything past it —
        torn tails AND whole stale files whose sequences fall outside
        the prefix — is physically truncated, so a regrown sequence can
        never collide with stale records at a later recovery.

        DETECTED corruption — a record whose header chain is intact but
        whose payload fails its checksum, with a VALID successor record
        chained right behind it — raises checksum_failed instead of
        silently cutting: records are appended in single writes, so
        power loss can only damage a suffix (drop whole writes / tear
        the final one); an intact chain continuing past a bad checksum
        means the bytes rotted AFTER they were written, i.e. media
        corruption of possibly-acked data. The caller treats that as a
        recoverable role death (the store is lost, replication heals),
        never as a quietly shorter log."""
        scans = [await self._scan(f) for f in self._files]
        if any(corrupt for _recs, _first, corrupt in scans):
            flow.cover("diskqueue.corruption_detected")
            raise flow.error("checksum_failed")
        order = sorted(range(2), key=lambda i: scans[i][1])
        all_recs: List[Tuple[int, bytes, int, int]] = []  # seq,payload,file,end
        for i in order:
            recs, _first, _corrupt = scans[i]
            all_recs.extend((seq, payload, i, end) for seq, payload, end in recs)
        valid: List[Tuple[int, bytes, int, int]] = []
        expect = all_recs[0][0] if all_recs else 0
        for seq, payload, i, end in all_recs:
            if seq != expect:
                break
            valid.append((seq, payload, i, end))
            expect += 1

        # per-file: truncate to the last byte of its last valid record
        # (or wipe entirely if it holds none)
        keep_end = [0, 0]
        self._file_first_seq = [1 << 62, 1 << 62]
        self._file_last_seq = [-1, -1]
        self._offsets = {}
        for seq, payload, i, end in valid:
            keep_end[i] = end
            self._file_first_seq[i] = min(self._file_first_seq[i], seq)
            self._file_last_seq[i] = max(self._file_last_seq[i], seq)
            self._offsets[seq] = (i, end - len(payload), len(payload))
        for i in range(2):
            await self._files[i].truncate(keep_end[i])
            self._append_off[i] = keep_end[i]

        self._records = [(seq, payload) for seq, payload, _i, _e in valid]
        self._next_seq = (valid[-1][0] + 1) if valid else 0
        self._popped_seq = (valid[0][0] - 1) if valid else self._next_seq - 1
        self._cur = valid[-1][2] if valid else 0
        self._recovered = True
        return [p for _s, p in self._records]

    async def _scan(self, f: SimFile):
        """-> ([(seq, payload, end_offset)...], first_seq, corrupted)."""
        size = await f.size()
        if size < _FILE_HDR.size:
            return [], 1 << 62, False
        raw = await f.read(0, size)
        walked, first_seq, stop = walk_records(raw)
        corrupted = False
        if stop + _REC_HDR.size <= size:
            # the chain broke on a parseable header: classify the hole
            seq, length, crc = _REC_HDR.unpack_from(raw, stop)
            payload = bytes(raw[stop + _REC_HDR.size:
                                stop + _REC_HDR.size + length])
            expect = walked[-1][0] + 1 if walked else first_seq
            corrupted = self._is_corruption_hole(
                raw, size, stop, expect, seq, length, payload, crc)
            if not corrupted:
                flow.cover("diskqueue.torn_tail_dropped")
        recs = [(seq, payload, poff + length)
                for seq, payload, poff, length, _off in walked]
        if not recs:
            return [], 1 << 62, corrupted
        return recs, first_seq, corrupted

    @staticmethod
    def _is_corruption_hole(raw, size, off, expect, seq, length, payload,
                            crc) -> bool:
        """Bad record with an intact header AND a valid successor right
        behind it ⇒ mid-log corruption, not tail damage (each record is
        one write, so power loss only damages a suffix of the chain)."""
        if seq != expect or len(payload) != length \
                or zlib.crc32(payload) == crc:
            return False   # header damage or actually fine: tail cases
        nxt = off + _REC_HDR.size + length
        if nxt + _REC_HDR.size > size:
            return False   # nothing behind it: indistinguishable tear
        nseq, nlen, ncrc = _REC_HDR.unpack_from(raw, nxt)
        npay = bytes(raw[nxt + _REC_HDR.size:nxt + _REC_HDR.size + nlen])
        return (nseq == expect + 1 and len(npay) == nlen
                and zlib.crc32(npay) == ncrc)

    # -- writing --------------------------------------------------------
    async def _write_file_header(self, i: int, first_seq: int) -> None:
        await self._files[i].write(0, _FILE_HDR.pack(first_seq))
        self._append_off[i] = _FILE_HDR.size
        self._file_first_seq[i] = first_seq
        self._file_last_seq[i] = -1

    async def push(self, payload: bytes) -> int:
        """Append one record (not yet durable); returns its seq."""
        assert self._recovered, "recover() before use"
        seq = self._next_seq
        self._next_seq += 1
        i = self._cur
        if self._append_off[i] == 0:
            await self._write_file_header(i, seq)
        rec = _REC_HDR.pack(seq, len(payload), zlib.crc32(payload)) + payload
        await self._files[i].write(self._append_off[i], rec)
        self._offsets[seq] = (i, self._append_off[i] + _REC_HDR.size,
                             len(payload))
        self._append_off[i] += len(rec)
        self._file_last_seq[i] = seq
        self._records.append((seq, payload))
        self._unsynced = True
        # roll to the other file when full AND it is free (fully popped)
        other = 1 - i
        if (self._append_off[i] >= self._limit
                and self._file_last_seq[other] <= self._popped_seq):
            await self._files[other].truncate(0)
            self._append_off[other] = 0
            self._file_first_seq[other] = 1 << 62
            self._file_last_seq[other] = -1
            self._cur = other
        return seq

    async def commit(self) -> None:
        """Durability barrier for all pushes so far (ref: doQueueCommit:
        sync both files — header writes may touch the spare)."""
        assert self._recovered
        if not self._unsynced:
            return
        self._unsynced = False
        for f in self._files:
            await f.sync()

    def pop(self, up_to_seq: int) -> None:
        """Logically discard records with seq <= up_to_seq; physical
        space reclaim happens at the next file roll."""
        if up_to_seq <= self._popped_seq:
            return
        self._popped_seq = up_to_seq
        idx = 0
        recs = self._records
        while idx < len(recs) and recs[idx][0] <= up_to_seq:
            self._offsets.pop(recs[idx][0], None)
            idx += 1
        del recs[:idx]

    # -- spill ----------------------------------------------------------
    def spill(self, up_to_seq: int) -> None:
        """Drop the in-memory payloads of committed records with
        seq <= up_to_seq; they remain durable on disk and readable via
        read(seq) (ref: TLog spill-by-reference — updatePersistentData
        keeping DiskQueue locations instead of values)."""
        for k, (seq, payload) in enumerate(self._records):
            if seq > up_to_seq:
                break
            if payload is not None:
                self._records[k] = (seq, None)

    async def read(self, seq: int) -> Optional[bytes]:
        """A committed record's payload straight from its file (the
        spilled-peek path). None if the record is gone — popped before
        the lookup, OR its file truncated by a roll while the read was
        in flight (the header re-validates seq + crc, so a racing
        truncation can never surface as garbage)."""
        loc = self._offsets.get(seq)
        if loc is None:
            return None
        i, off, length = loc
        raw = await self._files[i].read(off - _REC_HDR.size,
                                        _REC_HDR.size + length)
        if len(raw) < _REC_HDR.size + length:
            return None
        got_seq, got_len, crc = _REC_HDR.unpack_from(raw, 0)
        payload = bytes(raw[_REC_HDR.size:])
        if got_seq != seq or got_len != length or \
                zlib.crc32(payload) != crc:
            return None
        return payload

    # -- introspection --------------------------------------------------
    @property
    def records(self) -> List[Tuple[int, bytes]]:
        """Live (unpopped) records, oldest first."""
        return self._records

    @property
    def next_seq(self) -> int:
        return self._next_seq

    @property
    def bytes_used(self) -> int:
        """In-MEMORY bytes (spilled payloads don't count)."""
        return sum(len(p) for _, p in self._records if p is not None)
