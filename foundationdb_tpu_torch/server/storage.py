"""Storage server role: a versioned MVCC window over a durable engine.

Reference: fdbserver/storageserver.actor.cpp — a 5-second MVCC window in
a versioned map (:265-306) updated by pulling the log (`update` :2461,
applyMutation :1664), serving `getValueQ` (:763) and `getKeyValues`
(:1274) at a requested version. Durability (updateStorage): the oldest
window versions are applied to the persistent engine
(IKeyValueStore — kvstore.py), the durable version is persisted with
them, the log is popped up to it, and the window forgets what became
durable, so memory stays bounded at the MVCC window (without it
chains grow forever). Reads below the durable (oldest) version raise
transaction_too_old; reads too far ahead raise future_version.

On reboot the server recovers the engine, resumes from the persisted
durable version, and re-pulls the rest from the TLog.
"""

from __future__ import annotations

import math
import struct
import zlib
from bisect import bisect_left, bisect_right, insort
from typing import Dict, List, Optional, Tuple

from .. import flow
from ..flow import (SERVER_KNOBS, Future, NotifiedVersion, TaskPriority,
                    error)
from ..rpc import NetworkRef, RequestStream, SimProcess
from . import atomic
from .kvstore import IKeyValueStore
from .types import (ADD_VALUE, AND, AND_V2, APPEND_IF_FITS, BYTE_MAX,
                    BYTE_MIN, CLEAR_RANGE, COMPARE_AND_CLEAR, INERT_OPS,
                    KeySelector, MAX, MIN, MIN_V2, MutationRef, OR,
                    SET_VALUE, StorageGetKeyRequest,
                    StorageGetRangeRequest, StorageGetRequest,
                    StorageWatchRequest, TLogPeekRequest, TLogPopRequest,
                    XOR)

DURABLE_VERSION_KEY = b"\xff\xff/storageDurableVersion"
SHARD_META_KEY = b"\xff\xff/shardMeta"   # persisted tag + owned range
_NO_HINT = object()  # sentinel: _get_hinted must consult the base engine


class StorageMetrics:
    """Sampled byte metrics + smoothed write bandwidth for DD
    decisions (ref: storageserver.actor.cpp:310-312 byteSample — each
    entry is sampled with probability min(1, size/factor) and recorded
    at weight max(size, factor), an unbiased estimator of total bytes
    whose memory cost is O(total/factor); StorageMetrics.actor.h:302
    splitMetrics picking byte-balanced split points). Inclusion is a
    deterministic hash of the key so every replica samples
    identically and sim runs replay exactly."""

    __slots__ = ("_sample", "_keys", "_total", "_rate", "_rate_t",
                 "_prefix", "_read_sample", "_read_rate", "_read_ops",
                 "_read_t")

    def __init__(self):
        self._sample: Dict[bytes, int] = {}
        self._keys: List[bytes] = []   # sorted index over the sample
        self._total = 0                # running sum of sampled weights
        self._rate = 0.0               # smoothed write bytes/sec
        self._rate_t: Optional[float] = None
        # lazily rebuilt prefix sums over _keys' weights: range-bytes
        # queries and split_key become two bisects + O(log n) instead
        # of an O(range) sum (the CC split scan calls them per shard
        # per tick). None = stale; any sample mutation invalidates.
        self._prefix: Optional[List[int]] = None
        # -- read side: deterministic crc32-sampled read
        # bandwidth per key + shard-wide leaky read meters. key ->
        # [decayed bytes/sec, last update]; bounded by
        # READ_SAMPLE_MAX_KEYS (lowest decayed rate evicted)
        self._read_sample: Dict[bytes, list] = {}
        self._read_rate = 0.0          # smoothed read bytes/sec
        self._read_ops = 0.0           # smoothed read ops/sec
        self._read_t: Optional[float] = None

    @staticmethod
    def _weight(key: bytes, nbytes: int) -> int:
        factor = SERVER_KNOBS.byte_sample_factor
        if nbytes >= factor:
            return nbytes
        if zlib.crc32(key) / 0xFFFFFFFF < nbytes / factor:
            return factor
        return 0

    def note_set(self, key: bytes, nbytes: int) -> None:
        w = self._weight(key, nbytes)
        old = self._sample.get(key)
        if w:
            self._sample[key] = w
            self._total += w - (old or 0)
            if old is None:
                insort(self._keys, key)
            self._prefix = None
        elif old is not None:
            del self._sample[key]
            self._total -= old
            del self._keys[bisect_left(self._keys, key)]
            self._prefix = None

    def note_clear(self, begin: bytes, end: bytes) -> None:
        i = bisect_left(self._keys, begin)
        j = bisect_left(self._keys, end)
        if i == j:
            return
        for k in self._keys[i:j]:
            self._total -= self._sample.pop(k)
        del self._keys[i:j]
        self._prefix = None

    def apply(self, m: MutationRef) -> None:
        if m.type == CLEAR_RANGE:
            self.note_clear(m.param1, m.param2)
        elif m.type not in INERT_OPS:
            # atomics: the result's size is approximated by the
            # operand's (exact for set, bounded for the fold ops)
            self.note_set(m.param1,
                          len(m.param1) + len(m.param2 or b""))

    def rebuild(self, rows) -> None:
        self._sample.clear()
        self._keys.clear()
        self._total = 0
        self._prefix = None
        for k, v in rows:
            self.note_set(k, len(k) + len(v))

    def _prefix_sums(self) -> List[int]:
        """prefix[i] = sum of sampled weights of _keys[:i]; rebuilt
        lazily after a sample mutation, so a tick's worth of
        sampled_bytes/split_key/read-hot queries share one O(n) pass."""
        ps = self._prefix
        if ps is None or len(ps) != len(self._keys) + 1:
            ps = [0] * (len(self._keys) + 1)
            acc = 0
            sample = self._sample
            for i, k in enumerate(self._keys):
                acc += sample[k]
                ps[i + 1] = acc
            self._prefix = ps
        return ps

    def sampled_bytes(self, begin: bytes = b"",
                      end: Optional[bytes] = None) -> int:
        if begin == b"" and end is None:
            return self._total
        ps = self._prefix_sums()
        i = bisect_left(self._keys, begin)
        j = (bisect_left(self._keys, end) if end is not None
             else len(self._keys))
        return ps[j] - ps[i] if j > i else 0

    def split_key(self, begin: bytes,
                  end: Optional[bytes]) -> Optional[bytes]:
        """First key past half the sampled bytes — the byte-balanced
        split point (ref: splitMetrics). None when the sample is too
        thin to name an interior key. O(log n) over the lazy prefix
        sums instead of the old O(range) accumulation."""
        ps = self._prefix_sums()
        i = bisect_left(self._keys, begin)
        j = (bisect_left(self._keys, end) if end is not None
             else len(self._keys))
        if j - i < 2:
            return None
        total = ps[j] - ps[i]
        # first index m in (i, j) with 2*(ps[m+1]-ps[i]) >= total and
        # _keys[m] > begin — bisect over the monotone prefix, then walk
        # past any boundary-equal keys (at most the begin key itself)
        lo, hi = i, j - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if (ps[mid + 1] - ps[i]) * 2 >= total:
                hi = mid
            else:
                lo = mid + 1
        for m in range(lo, j):
            if self._keys[m] > begin:
                return self._keys[m]
        return None

    def reset_rate(self) -> None:
        """Forget the smoothed rates and the read sample — the meters
        are server-scoped, so after bounds shrink (split/shrink_to) the
        departed range's traffic must not keep counting against this
        shard (reads reset exactly like the write meter)."""
        self._rate = 0.0
        self._rate_t = None
        self._read_rate = 0.0
        self._read_ops = 0.0
        self._read_t = None
        self._read_sample.clear()

    def note_write(self, nbytes: int, now: float) -> None:
        """Leaky-integrator bandwidth: rate decays with time constant
        DD_BANDWIDTH_TAU and each write adds nbytes/tau — steady-state
        equals the true bytes/sec (ref: bytesInput rate smoothing
        feeding SHARD_MAX_BYTES_PER_KSEC splits)."""
        tau = SERVER_KNOBS.dd_bandwidth_tau
        if self._rate_t is not None and tau > 0:
            self._rate *= math.exp(-(now - self._rate_t) / tau)
        self._rate_t = now
        self._rate += nbytes / max(tau, 1e-9)

    def write_bytes_per_sec(self, now: float) -> float:
        tau = SERVER_KNOBS.dd_bandwidth_tau
        if self._rate_t is None or tau <= 0:
            return 0.0
        return self._rate * math.exp(-(now - self._rate_t) / tau)

    # -- read side (ref: StorageMetrics bytesReadSample +
    # getReadHotRanges density math) -----------------------------------

    @staticmethod
    def _read_weight(key: bytes, nbytes: int) -> int:
        """Deterministic inclusion, mirroring the write-side estimator
        with its own READ_SAMPLE_FACTOR: every replica samples the same
        reads and sim replays sample identically."""
        factor = SERVER_KNOBS.read_sample_factor
        if nbytes >= factor:
            return nbytes
        if zlib.crc32(key) / 0xFFFFFFFF < nbytes / factor:
            return factor
        return 0

    def note_read(self, key: bytes, nbytes: int, now: float) -> None:
        """Charge one read of `nbytes` at `key`: the shard-wide leaky
        read meters always, the per-key read-bandwidth sample when the
        crc32 draw includes it."""
        tau = max(SERVER_KNOBS.dd_bandwidth_tau, 1e-9)
        if self._read_t is not None:
            decay = math.exp(-(now - self._read_t) / tau)
            self._read_rate *= decay
            self._read_ops *= decay
        self._read_t = now
        self._read_rate += nbytes / tau
        self._read_ops += 1.0 / tau
        w = self._read_weight(key, nbytes)
        if not w:
            return
        ent = self._read_sample.get(key)
        if ent is None:
            self._read_sample[key] = [w / tau, now]
            if len(self._read_sample) > \
                    int(SERVER_KNOBS.read_sample_max_keys):
                coldest = min(
                    self._read_sample,
                    key=lambda k: self._read_sample[k][0]
                    * math.exp(-(now - self._read_sample[k][1]) / tau))
                del self._read_sample[coldest]
        else:
            ent[0] = ent[0] * math.exp(-(now - ent[1]) / tau) + w / tau
            ent[1] = now

    def read_bytes_per_sec(self, now: float) -> float:
        tau = SERVER_KNOBS.dd_bandwidth_tau
        if self._read_t is None or tau <= 0:
            return 0.0
        return self._read_rate * math.exp(-(now - self._read_t) / tau)

    def read_ops_per_sec(self, now: float) -> float:
        tau = SERVER_KNOBS.dd_bandwidth_tau
        if self._read_t is None or tau <= 0:
            return 0.0
        return self._read_ops * math.exp(-(now - self._read_t) / tau)

    def read_hot_ranges(self, begin: bytes, end: bytes,
                        now: float) -> List[Tuple[bytes, bytes, float,
                                                  float]]:
        """Read-hot sub-ranges of [begin, end) (ref: the
        ReadHotSubRangeRequest density scan): split the shard's sampled
        keys into READ_HOT_SUB_RANGE_CHUNKS byte-balanced buckets and
        flag every bucket whose read-bandwidth ÷ sampled-byte density
        exceeds READ_HOT_RANGE_RATIO × the shard's own density. Rows
        are (begin, end, density_ratio, read_bytes_per_sec), hottest
        first. Pull-computed: nothing here ever runs on the read hot
        path."""
        tau = max(SERVER_KNOBS.dd_bandwidth_tau, 1e-9)
        shard_read = self.read_bytes_per_sec(now)
        shard_bytes = self.sampled_bytes(begin, end)
        if shard_read <= 0 or shard_bytes <= 0:
            return []
        ps = self._prefix_sums()
        i = bisect_left(self._keys, begin)
        j = bisect_left(self._keys, end)
        if j - i < 2:
            return []
        chunks = max(1, int(SERVER_KNOBS.read_hot_sub_range_chunks))
        total = ps[j] - ps[i]
        # byte-balanced bucket boundaries: the first key at or past
        # each total*k/chunks prefix crossing
        bounds = [begin]
        for c in range(1, chunks):
            target = ps[i] + total * c // chunks
            lo, hi = i, j
            while lo < hi:
                mid = (lo + hi) // 2
                if ps[mid + 1] > target:
                    hi = mid
                else:
                    lo = mid + 1
            k = self._keys[min(lo, j - 1)]
            if k > bounds[-1]:
                bounds.append(k)
        bounds.append(end)
        n = len(bounds) - 1
        read_bps = [0.0] * n
        for key, (rate, t) in self._read_sample.items():
            if not (begin <= key < end):
                continue
            b = bisect_right(bounds, key) - 1
            read_bps[min(max(b, 0), n - 1)] += \
                rate * math.exp(-(now - t) / tau)
        shard_density = shard_read / shard_bytes
        ratio = SERVER_KNOBS.read_hot_range_ratio
        out = []
        for b in range(n):
            bi = bisect_left(self._keys, bounds[b])
            bj = bisect_left(self._keys, bounds[b + 1])
            bucket_bytes = ps[bj] - ps[bi]
            if bucket_bytes <= 0 or read_bps[b] <= 0:
                continue
            density = (read_bps[b] / bucket_bytes) / shard_density
            if density >= ratio:
                out.append((bounds[b], bounds[b + 1], round(density, 4),
                            round(read_bps[b], 2)))
        out.sort(key=lambda r: (-r[2], r[0]))
        return out


def encode_shard_meta(tag: int, begin: bytes, end: Optional[bytes],
                      floors=()) -> bytes:
    """Shard identity + fetched-range floors: a floor records that
    [b, e) was installed from a snapshot at `floor` — on re-pull after
    a crash, that range's log mutations at or below the floor are
    already folded into the base and must not re-apply (the atomic-op
    double-apply hazard of fetchKeys; ref: persistent shard assignment
    + fetchedVersion bookkeeping in storageserver)."""
    e = end if end is not None else b""
    has_end = 1 if end is not None else 0
    out = [struct.pack("<HBI", tag, has_end, len(begin)), begin,
           struct.pack("<I", len(e)), e, struct.pack("<I", len(floors))]
    for fb, fe, fv in floors:
        out.append(struct.pack("<I", len(fb)))
        out.append(fb)
        out.append(struct.pack("<I", len(fe)))
        out.append(fe)
        out.append(struct.pack("<q", fv))
    return b"".join(out)


def decode_shard_meta(buf: bytes):
    tag, has_end, lb = struct.unpack_from("<HBI", buf, 0)
    off = 7
    begin = buf[off:off + lb]
    off += lb
    (le,) = struct.unpack_from("<I", buf, off)
    end = buf[off + 4:off + 4 + le] if has_end else None
    off += 4 + le
    floors = []
    if off < len(buf):
        (nf,) = struct.unpack_from("<I", buf, off)
        off += 4
        for _ in range(nf):
            (l1,) = struct.unpack_from("<I", buf, off)
            fb = bytes(buf[off + 4:off + 4 + l1])
            off += 4 + l1
            (l2,) = struct.unpack_from("<I", buf, off)
            fe = bytes(buf[off + 4:off + 4 + l2])
            off += 4 + l2
            (fv,) = struct.unpack_from("<q", buf, off)
            off += 8
            floors.append((fb, fe, fv))
    return tag, bytes(begin), (bytes(end) if end is not None else None), \
        floors

def _split_mutation(m: MutationRef, begin: bytes, end: Optional[bytes]):
    """Split a mutation into (inside, outside) parts relative to
    [begin, end): point mutations go whole to one side; clears clip."""
    hi = end  # None = +inf
    if m.type != CLEAR_RANGE:
        k = m.param1
        if begin <= k and (hi is None or k < hi):
            return [m], []
        return [], [m]
    b, e = m.param1, m.param2
    ib, ie = max(b, begin), (e if hi is None else min(e, hi))
    inside = [MutationRef(CLEAR_RANGE, ib, ie)] if ib < ie else []
    outside = []
    if b < min(begin, e):
        outside.append(MutationRef(CLEAR_RANGE, b, min(begin, e)))
    if hi is not None and max(b, hi) < e:
        outside.append(MutationRef(CLEAR_RANGE, max(b, hi), e))
    return inside, outside


_ATOMIC_APPLY = {
    ADD_VALUE: atomic.add,
    AND: atomic.bit_and,
    OR: atomic.bit_or,
    XOR: atomic.bit_xor,
    APPEND_IF_FITS: atomic.append_if_fits,
    MAX: atomic.vmax,
    MIN: atomic.vmin,
    MIN_V2: atomic.vmin,       # MIN already applies V2 semantics
    AND_V2: atomic.bit_and,    # ...as does AND
    BYTE_MIN: atomic.byte_min,
    BYTE_MAX: atomic.byte_max,
    COMPARE_AND_CLEAR: atomic.compare_and_clear,
}


class _ClearIndex:
    """Versioned range-tombstone index: the keyspace is segmented at
    clear boundaries; each segment carries its stamps sorted by
    (version, seq), so a stabbing query is two bisects instead of a
    scan over every clear ever applied (a linear scan would be
    O(clears) per get)."""

    def __init__(self):
        self._bounds: List[bytes] = [b""]   # segment i = [bounds[i], next)
        self._stamps: List[List[Tuple[int, int]]] = [[]]

    def _split(self, key: bytes) -> int:
        """Ensure a segment boundary at `key`; return its index."""
        i = bisect_right(self._bounds, key) - 1
        if self._bounds[i] == key:
            return i
        self._bounds.insert(i + 1, key)
        self._stamps.insert(i + 1, list(self._stamps[i]))
        return i + 1

    def insert(self, version: int, seq: int, begin: bytes,
               end: bytes) -> None:
        i = self._split(begin)
        j = self._split(end)
        for k in range(i, j):
            self._stamps[k].append((version, seq))

    def query(self, key: bytes,
              version: int) -> Optional[Tuple[int, int]]:
        """Latest (version, seq) clear at or below `version` covering
        `key`, or None. Stamps are appended in (version, seq) order —
        the pull loop applies mutations in commit order."""
        i = bisect_right(self._bounds, key) - 1
        st = self._stamps[i]
        j = bisect_right(st, (version, 1 << 62)) - 1
        return st[j] if j >= 0 else None


class VersionedMap:
    """The in-memory window: per-key version chains + version-stamped
    range clears, overlaid on an optional durable base. Chain lookups
    fall through to the base for versions at or below the window floor
    (ref: fdbclient/VersionedMap.h + storageserver read path)."""

    def __init__(self, base: Optional[IKeyValueStore] = None):
        self._keys: List[bytes] = []           # sorted index of window keys
        # key -> [(version, seq, value)]; seq is a map-wide monotonic
        # stamp so mutations within one version keep their apply order
        # (ref: storageserver.actor.cpp:1664 applyMutation applies the
        # batch strictly in order)
        self._chains: Dict[bytes, List[Tuple[int, int, Optional[bytes]]]] = {}
        self._clears: List[Tuple[int, int, bytes, bytes]] = []
        self._clear_index = _ClearIndex()
        self._base = base
        self._seq = 0

    def _base_get(self, key: bytes) -> Optional[bytes]:
        return self._base.get(key) if self._base is not None else None

    def _set(self, version: int, key: bytes, value: Optional[bytes]) -> None:
        self._seq += 1
        chain = self._chains.get(key)
        if chain is None:
            self._chains[key] = [(version, self._seq, value)]
            insort(self._keys, key)
        else:
            chain.append((version, self._seq, value))

    def apply(self, version: int, m: MutationRef) -> None:
        if m.type == SET_VALUE:
            self._set(version, m.param1, m.param2)
        elif m.type == CLEAR_RANGE:
            # clears are kept as stamped ranges; gets consult them, so
            # base keys need no materialized tombstones
            self._seq += 1
            self._clears.append((version, self._seq, m.param1, m.param2))
            self._clear_index.insert(version, self._seq, m.param1, m.param2)
        elif m.type in _ATOMIC_APPLY:
            # read-modify-write at apply time, in version order (ref:
            # storageserver applyMutation -> Atomic.h apply functions)
            existing = self.get(m.param1, version)
            self._set(version, m.param1, _ATOMIC_APPLY[m.type](existing,
                                                               m.param2))
        elif m.type in INERT_OPS:
            # DebugKeyRange/DebugKey/NoOp ride the commit stream but
            # never change data (ref: applyMutation ignoring them)
            pass
        else:
            raise error("client_invalid_operation")

    def get(self, key: bytes, version: int) -> Optional[bytes]:
        return self._get_hinted(key, version, _NO_HINT)

    def _get_hinted(self, key: bytes, version: int, base_hint):
        """`get` that can skip the base lookup when the caller already
        has the base value in hand (scan paths: the candidate iterator
        fetched it from the engine chunk)."""
        cs = self._clear_index.query(key, version)
        chain = self._chains.get(key)
        if chain:
            for v, s, val in reversed(chain):
                if v <= version:
                    return None if cs is not None and cs > (v, s) else val
        if cs is not None:
            return None
        return self._base_get(key) if base_hint is _NO_HINT else base_hint

    def _candidates(self, begin: bytes, end: bytes, reverse: bool = False):
        """Lazily yield candidate keys in [begin, end) in order (or
        reverse): window keys merged with base-engine chunks, dedup'd.
        Scans stop at \\xff\\xff — the engine's own metadata never
        surfaces in reads; stored system rows under \\xff (conf,
        excluded, backup progress) are real data the CLIENT gates
        (ref: FDBTypes.h normalKeys/systemKeys). Laziness is what keeps
        limited scans and selector walks from materializing the whole
        shard."""
        end = min(end, b"\xff\xff")
        if begin >= end:
            return
        win = self._keys[bisect_left(self._keys, begin):
                         bisect_left(self._keys, end)]
        if reverse:
            win = win[::-1]
        wi = 0
        if self._base is None:
            for k in win:
                yield k, _NO_HINT
            return
        CHUNK = int(SERVER_KNOBS.fetch_block_rows)
        pending: List[Tuple[bytes, bytes]] = []
        pi = 0
        done_base = False
        cursor = begin if not reverse else end
        while True:
            if pi >= len(pending) and not done_base:
                if not reverse:
                    pending = self._base.get_range(cursor, end, limit=CHUNK)
                else:
                    pending = self._base.get_range(begin, cursor, limit=CHUNK,
                                                   reverse=True)
                pi = 0
                if len(pending) < CHUNK:
                    done_base = True
                elif not reverse:
                    cursor = pending[-1][0] + b"\x00"
                else:
                    cursor = pending[-1][0]
            have_b = pi < len(pending)
            have_w = wi < len(win)
            if not have_b and not have_w:
                return
            if not have_b:
                k, hint, wi = win[wi], _NO_HINT, wi + 1
            elif not have_w:
                (k, hint), pi = pending[pi], pi + 1
            else:
                b, w = pending[pi][0], win[wi]
                if b == w:
                    (k, hint), pi, wi = pending[pi], pi + 1, wi + 1
                elif (b < w) != reverse:
                    (k, hint), pi = pending[pi], pi + 1
                else:
                    k, hint, wi = w, _NO_HINT, wi + 1
            yield k, hint

    def get_range(self, begin: bytes, end: bytes, version: int,
                  limit: int, reverse: bool = False) -> List[Tuple[bytes, bytes]]:
        out = []
        for k, hint in self._candidates(begin, end, reverse):
            val = self._get_hinted(k, version, hint)
            if val is not None:
                out.append((k, val))
                if len(out) >= limit:
                    break
        return out

    def resolve_selector(self, sel: KeySelector, version: int,
                         begin: bytes = b"",
                         end: Optional[bytes] = None):
        """Resolve a KeySelector against the keys present at `version`
        within [begin, end) by walking outward from the reference key —
        cost is O(offset) present keys, not O(shard) (ref: storageserver
        findKey / KeySelectorRef semantics: the result is the key
        `offset` present keys past the last key < (or <= when or_equal)
        the reference key).

        Returns (key, leftover): leftover 0 means resolved in-shard;
        a negative leftover means the answer is the |leftover|-th
        present key LEFT of `begin` (1-based); a positive leftover means
        the leftover-th present key RIGHT of `end` — the client walks
        the neighboring shard with a boundary-anchored selector (ref:
        NativeAPI getKey readThrough iteration across shards)."""
        hi = min(end if end is not None else b"\xff\xff", b"\xff\xff")
        key = sel.key
        if sel.offset >= 1:
            # the offset-th present key >= key (> key when or_equal)
            needed = sel.offset
            start = max(key + b"\x00" if sel.or_equal else key, begin)
            found = 0
            for k, hint in self._candidates(start, hi):
                if self._get_hinted(k, version, hint) is not None:
                    found += 1
                    if found == needed:
                        return k, 0
            return b"\xff", needed - found
        # the (1 - offset)-th present key < key (<= key when or_equal)
        needed = 1 - sel.offset
        stop = min(key + b"\x00" if sel.or_equal else key, hi)
        found = 0
        for k, hint in self._candidates(begin, stop, reverse=True):
            if self._get_hinted(k, version, hint) is not None:
                found += 1
                if found == needed:
                    return k, 0
        return b"", -(needed - found)

    def forget(self, up_to: int) -> None:
        """Drop window state at or below `up_to` — it lives in the base
        now (ref: VersionedMap::forgetVersionsBefore via updateStorage)."""
        self._clears = [c for c in self._clears if c[0] > up_to]
        self._clear_index = _ClearIndex()
        for v, s, b, e in self._clears:
            self._clear_index.insert(v, s, b, e)
        dead = []
        for k, chain in list(self._chains.items()):
            keep = [e for e in chain if e[0] > up_to]
            if keep:
                self._chains[k] = keep
            else:
                dead.append(k)
        for k in dead:
            del self._chains[k]
            i = bisect_left(self._keys, k)
            if i < len(self._keys) and self._keys[i] == k:
                del self._keys[i]


class StorageServer:
    def __init__(self, process: SimProcess, tlog_peek: NetworkRef = None,
                 kv: Optional[IKeyValueStore] = None,
                 tlog_pop: Optional[NetworkRef] = None,
                 durability_lag_versions: Optional[int] = None,
                 tag: int = 0, dbinfo=None,
                 shard_begin: bytes = b"",
                 shard_end: Optional[bytes] = None, floors=(),
                 name: Optional[str] = None):
        self.process = process
        # direct log wiring (component tests) or dbinfo-driven discovery
        # of the current log generation (clusters with recovery)
        self.tlog_peek = tlog_peek
        self.tlog_pop = tlog_pop
        self.dbinfo = dbinfo            # AsyncVar[ServerDBInfo] or None
        self.kv = kv
        self.tag = tag
        self.name = name or process.name   # store name = replica identity
        self.shard_begin = shard_begin
        self.shard_end = shard_end
        # fetched-range floors (see encode_shard_meta) + the in-flight
        # incoming range, whose mutations buffer until the snapshot
        # lands (ref: AddingShard, storageserver.actor.cpp:149)
        self._floors: List[Tuple[bytes, bytes, int]] = list(floors)
        # reads below an installed snapshot's version would see future
        # data through the unversioned base: floor them out (clients
        # retry with a fresh GRV, which is always
        # at or above any published install version)
        self._read_floor = max((f[2] for f in self._floors), default=0)
        self._adding: Optional[Tuple[bytes, bytes]] = None
        self._adding_buf: List[Tuple[int, MutationRef]] = []
        self.known_committed = 0  # replicated log-set-wide (peek piggyback)
        self._replica_rr = tag    # peek replica rotation, offset by tag
        self._seen_epoch = 0
        self.data = VersionedMap(base=kv)
        self.version = NotifiedVersion(0)
        self.durable_version = NotifiedVersion(0)
        self._lag = (durability_lag_versions if durability_lag_versions
                     is not None else
                     int(SERVER_KNOBS.storage_durability_lag *
                         SERVER_KNOBS.versions_per_second))
        if durability_lag_versions is None and \
                flow.buggify("storage/short_durability_lag"):
            # near-zero MVCC window: every read races the window floor
            self._lag = 1000
        # read-ahead bound (ref: MAX_READ_TRANSACTION_LIFE_VERSIONS;
        # BUGGIFY shrinks it so future_version paths get exercised)
        self._max_read_ahead = SERVER_KNOBS.max_read_transaction_life_versions
        # raw pulled entries not yet durable: [(version, mutations)]
        self._pending: List[Tuple[int, tuple]] = []
        self.gets = RequestStream(process)
        self.ranges = RequestStream(process)
        self.get_keys = RequestStream(process)
        self.watches = RequestStream(process)
        # key -> list of (value_at_registration, reply, deadline)
        self._watch_map: Dict[bytes, list] = {}
        # (ref: StorageServer::counters — query/mutation accounting)
        self.stats = flow.CounterCollection("storage")
        # banded + sampled point-read latency (ref: LatencyBandConfig's
        # read bands in status)
        self.read_bands = flow.RequestLatency("read")
        # QoS saturation signals (ref: StorageQueuingMetrics — the
        # smoothed queue/lag/rate surface the Ratekeeper polls). Pull
        # model: nothing here updates on the hot paths; qos_sample()
        # reads raw state and smooths it at the collection cadence
        self._qos_queue = flow.SmoothedQueue()
        self._qos_lag = flow.SmoothedQueue()
        self._qos_read_rate = flow.SmoothedRate()
        self._qos_mutation_rate = flow.SmoothedRate()
        # byte sample + write bandwidth for DD sizing decisions
        self.metrics = StorageMetrics()
        # per-storage read-cost tag accounting (ref: fdbserver/
        # TransactionTagCounter ON the storage server — the busiest-tag
        # signal the ratekeeper's storage-aware throttling reads; the
        # proxy-side counter reused, bounded + decaying). Touched only
        # while STORAGE_HEAT_TRACKING is armed.
        from .proxy import TransactionTagCounter
        self.tag_counter = TransactionTagCounter()
        # typed metrics probes (StorageMetricsRequest /
        # ReadHotRangesRequest / SplitMetricsRequest)
        self.metrics_requests = RequestStream(process)
        self._hot_cache = None   # (sim time, rows) read_hot_ranges memo
        self._actors = flow.ActorCollection()
        self.recovered = Future()   # engine recovery complete (fetchKeys
                                    # sources/destinations wait on this)

    def start(self) -> None:
        self._actors.add(flow.spawn(self._run(), TaskPriority.UPDATE_STORAGE,
                                    name=f"{self.process.name}.run"))
        self.process.on_kill(self._actors.cancel_all)

    def retire(self) -> None:
        """End this replica: actors stop and every endpoint breaks with
        broken_promise so stale-map clients refresh their picture
        instead of timing out (ref: storage server removal — endpoint
        death IS the signal the location cache invalidates on)."""
        self._actors.cancel_all()
        # parked watch waiters would otherwise hang forever once the
        # expiry actor dies with the role — fail them like set_bounds does
        # so their clients refresh the location map
        self._fail_watches(lambda k: True)
        for stream in (self.gets, self.ranges, self.get_keys, self.watches,
                       self.metrics_requests):
            stream.close()

    def _fail_watches(self, pred) -> None:
        """Fail every parked watch whose key matches `pred` with
        wrong_shard_server so its client refreshes the location map."""
        for k in [k for k in self._watch_map if pred(k)]:
            for _expected, reply, _deadline in self._watch_map.pop(k):
                reply.send_error(error("wrong_shard_server"))

    async def _run(self) -> None:
        await self._recover()
        if not self.recovered.is_ready:
            self.recovered.send(None)
        for coro, prio, name in (
                (self._pull_loop(), TaskPriority.UPDATE_STORAGE, "pull"),
                (self._durability_loop(), TaskPriority.UPDATE_STORAGE,
                 "updateStorage"),
                (self._get_loop(), TaskPriority.STORAGE, "get"),
                (self._range_loop(), TaskPriority.STORAGE, "getrange"),
                (self._get_key_loop(), TaskPriority.STORAGE, "getkey"),
                (self._metrics_loop(), TaskPriority.LOW_PRIORITY,
                 "storageMetrics"),
                (self._watch_loop(), TaskPriority.STORAGE, "watch"),
                (self._watch_expiry_loop(), TaskPriority.LOW_PRIORITY,
                 "watchExpiry")):
            self._actors.add(flow.spawn(coro, prio,
                                        name=f"{self.process.name}.{name}"))

    async def _recover(self) -> None:
        """Recover the engine; resume pulling after the persisted durable
        version (ref: storageServer recovery from IKeyValueStore +
        byteSample/metadata keys)."""
        if self.kv is None:
            return
        await self.kv.recover()
        raw = self.kv.get(DURABLE_VERSION_KEY)
        if raw is not None:
            (v,) = struct.unpack("<Q", raw)
            self.durable_version.set(v)
            self.version.set(v)
        if self.kv.get(SHARD_META_KEY) is None:
            # first boot of this store: persist the shard identity NOW so
            # a crash before the first durability batch still leaves a
            # self-describing store for the worker's boot scan
            self.kv.set(SHARD_META_KEY,
                        encode_shard_meta(self.tag, self.shard_begin,
                                          self.shard_end))
            await self.kv.commit()
        # re-seed the byte sample from the recovered base (the
        # reference persists its byteSample; a scan-on-boot is the
        # sim-scale equivalent)
        self._rebuild_metrics()

    async def _pull_loop(self):
        """Pull this tag's committed mutations from the log
        (ref: update :2461, peeking the server's own tag). With a
        dbinfo, the source is the generation covering the next needed
        version — old locked generations drain first, then the current
        one; replicas rotate on failure; an epoch change below our
        version triggers a rollback (ref: storageserver rollback +
        peekcursor generation fail-over)."""
        while True:
            if self.dbinfo is None:
                reply = await self.tlog_peek.get_reply(
                    TLogPeekRequest(self.version.get() + 1, self.tag),
                    self.process)
                self._apply_peek(reply, cap=None)
                continue
            self._maybe_rollback()
            needed = self.version.get() + 1
            src = self._pick_source(needed)
            if src is None:
                await flow.first_of(
                    self.dbinfo.on_change(),
                    flow.delay(flow.SERVER_KNOBS.storage_pull_idle_delay,
                               TaskPriority.UPDATE_STORAGE))
                continue
            gen, refs = src
            try:
                reply = await flow.timeout_error(refs.peeks.get_reply(
                    TLogPeekRequest(needed, self.tag), self.process),
                    SERVER_KNOBS.storage_peek_timeout)
            except flow.FdbError:
                self._replica_rr += 1  # rotate to another replica
                await flow.delay(SERVER_KNOBS.storage_rollback_delay,
                                 TaskPriority.UPDATE_STORAGE)
                continue
            cap = gen.end_version if gen.end_version >= 0 else None
            before = self.version.get()
            self._apply_peek(reply, cap)
            # NOTE: pops happen only from the durability loop at the
            # DURABLE version — popping a drained generation at the
            # pulled version would free log data this server still
            # needs if it crashes before persisting
            if cap is not None and self.version.get() == before and \
                    self.version.get() < cap:
                # a locked replica that answered instantly with nothing
                # lacks the generation's tail (it died behind its peers):
                # rotate instead of re-peeking it forever
                self._replica_rr += 1
                await flow.delay(SERVER_KNOBS.storage_rollback_delay,
                                 TaskPriority.UPDATE_STORAGE)

    def _apply_peek(self, reply, cap: Optional[int]) -> None:
        if reply.known_committed > self.known_committed:
            self.known_committed = reply.known_committed
        for version, mutations in reply.entries:
            if version <= self.version.get():
                continue
            if cap is not None and version > cap:
                break  # stale data beyond the generation's locked end
            apply_now = self._partition(version, mutations)
            wbytes = 0
            hi = self.shard_end if self.shard_end is not None else b"\xff"
            for m in apply_now:
                self.data.apply(version, m)
                self.metrics.apply(m)
                # bandwidth counts OWNED-range traffic only: stray
                # parts of shard-spanning mutations must not push this
                # shard over the split ceiling
                if m.type == CLEAR_RANGE:
                    if m.param1 < hi and m.param2 > self.shard_begin:
                        wbytes += len(m.param1) + len(m.param2)
                elif self.shard_begin <= m.param1 < hi:
                    wbytes += len(m.param1) + len(m.param2 or b"")
            if wbytes:
                self.metrics.note_write(wbytes, flow.now())
            self.stats.counter("mutations").add(len(mutations))
            if apply_now:
                self._pending.append((version, apply_now))
            self.version.set(version)
            self._check_watches(version, apply_now)
        adv = reply.committed_version
        if cap is not None:
            adv = min(adv, cap)
        if adv > self.version.get():
            self.version.set(adv)

    def _partition(self, version: int, mutations):
        """Route each mutation part: the in-flight incoming range
        buffers until its snapshot lands; floored ranges drop parts the
        installed snapshot already contains (post-crash replay); the
        rest applies now. Clears are clipped at the range edges.

        Parts outside the owned range apply too — clipping to bounds
        here would be WRONG: a rebooted replica replays history
        against stale persisted bounds (the authoritative clamp
        arrives asynchronously after registration) and would drop
        clears it legitimately owns. Stale out-of-range window state
        left by a shard-spanning mutation is purged when the range is
        (re-)acquired (_purge_window_range at install)."""
        if self._adding is None and not self._floors:
            return tuple(mutations)
        out = []
        for m in mutations:
            if self._adding is not None:
                ab, ae = self._adding
                inside, outside = _split_mutation(m, ab, ae)
                for part in inside:
                    self._adding_buf.append((version, part))
            else:
                outside = [m]
            for part in outside:
                rest = [part]
                for fb, fe, fv in self._floors:
                    if version > fv:
                        continue
                    nxt = []
                    for p in rest:
                        _in, out_parts = _split_mutation(p, fb, fe)
                        nxt.extend(out_parts)   # in-floor parts drop
                    rest = nxt
                out.extend(rest)
        return tuple(out)

    def _pick_source(self, needed: int):
        """The generation that OWNS `needed`, and one of its replicas
        (see dbinfo.pick_log_source for the strict-coverage rule — a
        non-covering generation's durable watermark would silently skip
        records)."""
        from .dbinfo import pick_log_source
        return pick_log_source(self.dbinfo.get(), needed,
                               self._replica_rr)

    def _maybe_rollback(self) -> None:
        """A new epoch whose recovery version is below what we pulled
        means the surplus came from a replica that died un-acked: rebuild
        the window from the durable base plus the surviving prefix
        (ref: storageserver.actor.cpp rollback)."""
        info = self.dbinfo.get()
        if info.epoch == self._seen_epoch:
            return
        self._seen_epoch = info.epoch
        rv = info.recovery_version
        if rv <= 0 or self.version.get() <= rv:
            return
        keep = [(v, ms) for v, ms in self._pending if v <= rv]
        self.data = VersionedMap(base=self.kv)
        self._rebuild_metrics()
        for v, ms in keep:
            for m in ms:
                self.data.apply(v, m)
                self.metrics.apply(m)
        self._pending = keep
        self.version.rollback(rv)
        flow.cover("storage.rollback")
        flow.TraceEvent("StorageRollback", self.process.name).detail(
            To=rv).log()

    async def _durability_loop(self):
        """Apply old window versions to the engine, persist the durable
        version, pop the log, forget the window prefix
        (ref: updateStorage + tLogPop driven by storage durability)."""
        if self.kv is None:
            return
        while True:
            await flow.delay(SERVER_KNOBS.storage_commit_interval,
                             TaskPriority.UPDATE_STORAGE)
            # never make durable a version that could still be rolled
            # back by an epoch recovery: cap at the highest version known
            # replicated across the whole log set (ref: storageserver
            # updateStorage bounded by knownCommittedVersion semantics)
            target = min(self.version.get() - self._lag,
                         max(self.known_committed,
                             self.durable_version.get()))
            if target <= self.durable_version.get():
                continue
            made = self.durable_version.get()
            i = 0
            while i < len(self._pending) and self._pending[i][0] <= target:
                version, mutations = self._pending[i]
                for m in mutations:
                    self._apply_to_kv(m)
                # replayed install entries can sit below the marker:
                # never let it regress
                made = max(made, version)
                i += 1
            del self._pending[:i]
            # nothing may exist below `target` that we haven't applied:
            # advance the marker even with an empty queue so pops keep
            # flowing from idle shards (a stalled marker starved the
            # tag's log records once pops became per-replica)
            made = max(made, target)
            live_floors = [f for f in self._floors if f[2] > made]
            if len(live_floors) != len(self._floors):
                # a floor only filters crash-replay of versions at or
                # below it; once the durable marker passes it, re-pulls
                # start above it and it is dead weight
                self._floors = live_floors
                self._persist_meta()
            self.kv.set(DURABLE_VERSION_KEY, struct.pack("<Q", made))
            await self.kv.commit()
            self.durable_version.set(made)
            self.data.forget(made)
            me = self.name
            if self.tlog_pop is not None:
                self.tlog_pop.send(TLogPopRequest(made, self.tag, me),
                                   self.process)
            elif self.dbinfo is not None:
                info = self.dbinfo.get()
                for lr in info.logs.logs:
                    lr.pops.send(TLogPopRequest(made, self.tag, me),
                                 self.process)
                for gen in info.old_logs:
                    for lr in gen.logs:
                        lr.pops.send(TLogPopRequest(
                            min(made, gen.end_version), self.tag, me),
                            self.process)

    def _apply_to_kv(self, m: MutationRef) -> None:
        if m.type == SET_VALUE:
            self.kv.set(m.param1, m.param2)
        elif m.type == CLEAR_RANGE:
            self.kv.clear_range(m.param1, m.param2)
        elif m.type in _ATOMIC_APPLY:
            self.kv.set(m.param1,
                        _ATOMIC_APPLY[m.type](self.kv.get(m.param1), m.param2)
                        or b"")
        else:
            raise error("client_invalid_operation")

    # -- shard movement (ref: fetchKeys/AddingShard + moveKeys) ---------
    def begin_adding(self, begin: bytes, end: Optional[bytes]) -> None:
        """Start buffering mutations for an incoming range; the dual-tag
        must begin AFTER this so nothing slips through un-buffered."""
        self._adding = (begin, end)
        self._adding_buf = []

    def abort_adding(self) -> None:
        self._adding = None
        self._adding_buf = []

    def snapshot_range(self, begin: bytes, end: Optional[bytes],
                       at_version: int):
        """This shard's view of the range at `at_version` — the
        fetchKeys source side. The caller picks a version at or below
        known_committed so an epoch rollback can never invalidate the
        snapshot after it lands durably on the destination. The bound
        is \\xff\\xff: stored system rows move WITH the shard (engine
        metadata never surfaces through the window's read path)."""
        hi = end if end is not None else b"\xff\xff"
        return self.data.get_range(begin, hi, at_version, 1 << 30)

    async def install_snapshot(self, rows, at_version: int) -> None:
        """Fold the fetched snapshot into the DURABLE base (with its
        floor persisted in the shard meta) before ownership flips, then
        replay buffered mutations above the snapshot version. Making
        the install durable first keeps a crash from resurrecting the
        old ownership after the source has shrunk."""
        begin, end = self._adding
        # purge stale window/pending state for the acquired range at
        # versions <= at_version FIRST: a vacate clear left by an
        # earlier shrink_to would otherwise shadow the installed base
        # rows on reads (its window stamp survives re-acquisition) and
        # clobber them on the durability replay (ref: fetchKeys
        # clearing the fetched range in versioned data before
        # inserting the snapshot, storageserver.actor.cpp fetchKeys)
        self._purge_window_range(begin, end, at_version)
        # the snapshot IS the range's complete state at at_version:
        # wipe the base range first — stale rows from a previous
        # ownership era (whose vacate clear the purge just dropped
        # from the pending queue) must not shine through under the
        # installed data (ref: fetchKeys clear-then-insert)
        hi = end if end is not None else b"\xff\xff"
        self.kv.clear_range(begin, hi)
        self.metrics.note_clear(begin, hi)
        for k, v in rows:
            self.kv.set(k, v)
            self.metrics.note_set(k, len(k) + len(v))
        self._floors.append((begin,
                             end if end is not None else b"\xff\xff",
                             at_version))
        self._read_floor = max(self._read_floor, at_version)
        new_begin = min(self.shard_begin, begin)
        new_end = self.shard_end
        if end is None or (self.shard_end is not None
                           and end > self.shard_end):
            new_end = end
        self.shard_begin, self.shard_end = new_begin, new_end
        self._persist_meta()
        # a WHOLE-shard install (vacate/split newcomer) makes at_version
        # a durable version outright: everything below it is in the
        # snapshot. Without this, a crash before the first durability
        # cycle recovers at version 0 and wedges pulling generations
        # that no longer exist. (Partial installs — boundary moves —
        # must NOT claim it: the old range still needs its own replay.)
        if begin <= new_begin and (
                end is None or (new_end is not None and end >= new_end)):
            if at_version > self.durable_version.get():
                self.kv.set(DURABLE_VERSION_KEY,
                            struct.pack("<Q", at_version))
                self.durable_version.set(at_version)
                if self.version.get() < at_version:
                    self.version.set(at_version)
        await self.kv.commit()
        buf, self._adding_buf = self._adding_buf, []
        self._adding = None
        replay = [(v, m) for v, m in buf if v > at_version]
        for v, m in replay:
            self.data.apply(v, m)
            self.metrics.apply(m)
        if replay:
            self._merge_pending(replay)

    def _purge_window_range(self, begin: bytes, end: Optional[bytes],
                            up_to: int) -> None:
        """Drop window chains, clears, and pending replay covering
        [begin, end) at versions <= up_to — the installed snapshot IS
        that range's state at up_to. Parts outside the range (a clear
        spanning the boundary) are kept. Reads below up_to are already
        rejected by the install's read floor, so no reader can miss
        the removed history."""
        hi = end if end is not None else b"\xff\xff"
        d = self.data
        i = bisect_left(d._keys, begin)
        j = bisect_left(d._keys, hi)
        survivors = []
        for k in d._keys[i:j]:
            chain = [e for e in d._chains[k] if e[0] > up_to]
            if chain:
                d._chains[k] = chain
                survivors.append(k)
            else:
                del d._chains[k]
        d._keys[i:j] = survivors
        kept = []
        for v, s, cb, ce in d._clears:
            if v > up_to or ce <= begin or cb >= hi:
                kept.append((v, s, cb, ce))
                continue
            if cb < begin:
                kept.append((v, s, cb, begin))
            if ce > hi:
                kept.append((v, s, hi, ce))
        d._clears = kept
        d._clear_index = _ClearIndex()
        for v, s, cb, ce in kept:
            d._clear_index.insert(v, s, cb, ce)
        pending = []
        for v, ms in self._pending:
            if v > up_to:
                pending.append((v, ms))
                continue
            keep_ms = []
            for m in ms:
                _inside, outside = _split_mutation(m, begin, end)
                keep_ms.extend(outside)
            if keep_ms:
                pending.append((v, tuple(keep_ms)))
        self._pending = pending

    async def set_bounds(self, begin: bytes, end: Optional[bytes]) -> None:
        """Adopt authoritative bounds (the CC's shard map is ground
        truth; a rebooted server whose persisted meta disagrees — e.g.
        it crashed mid-move — is clamped back on registration). Shrinks
        clear the vacated range versioned and fail its watches so
        stale-map clients refresh."""
        if begin > self.shard_begin or (
                self.shard_end is None and end is not None) or (
                end is not None and self.shard_end is not None
                and end < self.shard_end):
            await self.shrink_to(max(begin, self.shard_begin),
                                 end if end is not None else self.shard_end)
        self.shard_begin, self.shard_end = begin, end
        self._persist_meta()
        if self.kv is not None:
            await self.kv.commit()

    async def shrink_to(self, begin: bytes, end: Optional[bytes]) -> None:
        """Give up ownership outside [begin, end): the vacated range is
        cleared VERSIONED at the current version so stale-map readers at
        older versions still see consistent data (ref: the old team
        keeping data through the move grace)."""
        v = self.version.get()
        clears = []
        if begin > self.shard_begin:
            clears.append(MutationRef(CLEAR_RANGE, self.shard_begin, begin))
        if end is not None and (self.shard_end is None
                                or end < (self.shard_end or b"\xff\xff")):
            clears.append(MutationRef(
                CLEAR_RANGE, end,
                self.shard_end if self.shard_end is not None
                else b"\xff\xff"))
        for m in clears:
            self.data.apply(v, m)
            self.metrics.apply(m)
        if clears:
            self._merge_pending([(v, m) for m in clears])
        # watches on vacated keys will never fire here again: fail them
        # so their clients refresh the location map
        self._fail_watches(
            lambda k: k < begin or (end is not None and k >= end))
        self.shard_begin, self.shard_end = begin, end
        # the departed range's write traffic must not keep this shard
        # over the bandwidth-split ceiling (the meter is server-scoped)
        self.metrics.reset_rate()
        self._persist_meta()
        if self.kv is not None:
            await self.kv.commit()

    def _persist_meta(self) -> None:
        if self.kv is not None:
            self.kv.set(SHARD_META_KEY,
                        encode_shard_meta(self.tag, self.shard_begin,
                                          self.shard_end, self._floors))

    def _merge_pending(self, entries) -> None:
        """Insert (version, mutation) singletons into the durability
        queue, keeping it version-sorted (installs replay versions that
        may be older than the queue tail)."""
        for v, m in entries:
            i = bisect_right([p[0] for p in self._pending], v)
            self._pending.insert(i, (v, (m,)))

    def approx_rows(self) -> int:
        """Row-count estimate (status/observability; DD sizing runs on
        sampled BYTES — see sampled_bytes): the base engine's O(1)
        count plus the window's key-index size."""
        base = self.kv.row_count() if self.kv is not None else 0
        win = len(self.data._keys)
        return base + win

    def _rebuild_metrics(self) -> None:
        """Re-seed the byte sample from the durable base's owned range
        (rollback discarded window state; recovery starts fresh)."""
        if self.kv is None:
            self.metrics.rebuild(())
            return
        hi = self.shard_end if self.shard_end is not None else b"\xff"
        self.metrics.rebuild(self.kv.get_range(self.shard_begin, hi))

    def sampled_bytes(self) -> int:
        """Estimated logical bytes in this shard (ref:
        storageserver.actor.cpp:310 byteSample → getStorageMetrics).
        Capped at \\xff: system-space rows (backup progress, \\xff/conf)
        must not count toward user-shard sizing or split points."""
        return self.metrics.sampled_bytes(
            self.shard_begin,
            self.shard_end if self.shard_end is not None else b"\xff")

    def write_bandwidth(self) -> float:
        """Smoothed write bytes/sec into this shard (ref: bytesInput
        rate driving SHARD_MAX_BYTES_PER_KSEC splits)."""
        return self.metrics.write_bytes_per_sec(flow.now())

    # -- storage heat plane --------------------------------------------
    def _note_read(self, key: bytes, nbytes: int, tags) -> None:
        """Charge one admitted point read: the read sample + leaky
        meters, and read cost against the request's transaction tags.
        Called only behind the STORAGE_HEAT_TRACKING guard — the off
        posture pays exactly one knob read per request."""
        now = flow.now()
        self.metrics.note_read(key, nbytes, now)
        for tag in tags:
            self.tag_counter.record(tag, "started", now,
                                    weight=float(nbytes))

    def _note_range_read(self, rows, tags) -> None:
        """Charge an admitted range read row by row (each returned key
        enters the read sample — a hot scan range heats every key it
        covers, matching the reference's per-key bytesReadSample)."""
        if not rows:
            return
        now = flow.now()
        m = self.metrics
        cost = 0
        for k, v in rows:
            nb = len(k) + len(v)
            cost += nb
            m.note_read(k, nb, now)
        for tag in tags:
            self.tag_counter.record(tag, "started", now,
                                    weight=float(cost))

    def read_bandwidth(self) -> float:
        """Smoothed read bytes/sec out of this shard (ref: the
        bytesReadSample-backed read bandwidth in StorageMetrics)."""
        return self.metrics.read_bytes_per_sec(flow.now())

    def read_ops_rate(self) -> float:
        """Smoothed key reads/sec (point reads + range rows)."""
        return self.metrics.read_ops_per_sec(flow.now())

    def read_hot_ranges(self) -> list:
        """Read-hot sub-ranges of the OWNED range, hottest first:
        (begin, end, density_ratio, read_bytes_per_sec). Capped at
        \\xff like the sizing queries — system-space reads must not
        name user-shard split candidates. Memoized per sim instant:
        the QoS sample and the CC heat rollup both pull within one
        sampler tick, and the bucket scan is pure in (state, now) —
        one scan serves every same-tick consumer."""
        now = flow.now()
        cached = self._hot_cache
        if cached is not None and cached[0] == now:
            return cached[1]
        hi = self.shard_end if self.shard_end is not None else b"\xff"
        rows = self.metrics.read_hot_ranges(self.shard_begin, hi, now)
        self._hot_cache = (now, rows)
        return rows

    def busiest_read_tag(self) -> tuple:
        """(tag bytes | None, decayed read-cost busyness) — the
        per-storage busiest-tag signal the ratekeeper's storage-aware
        throttling reads (ref: TransactionTagCounter::getBusiestTag)."""
        rows = self.tag_counter.top(1)
        if not rows or rows[0]["busyness"] <= 0:
            return None, 0.0
        return bytes.fromhex(rows[0]["tag"]), rows[0]["busyness"]

    async def _metrics_loop(self):
        """Serve the typed metrics probes (ref: the waitMetrics /
        ReadHotSubRangeRequest / SplitMetricsRequest endpoints on
        StorageServerInterface). Pull-computed from the samples — a
        probe never touches the read/write hot paths."""
        from .types import (ReadHotRangesReply, ReadHotRangesRequest,
                            SplitMetricsReply, SplitMetricsRequest,
                            StorageMetricsReply, StorageMetricsRequest)
        while True:
            req, reply = await self.metrics_requests.pop()
            try:
                now = flow.now()
                if isinstance(req, StorageMetricsRequest):
                    tag, busy = self.busiest_read_tag()
                    reply.send(StorageMetricsReply(
                        self.sampled_bytes(),
                        round(self.metrics.write_bytes_per_sec(now), 2),
                        round(self.metrics.read_bytes_per_sec(now), 2),
                        round(self.metrics.read_ops_per_sec(now), 2),
                        tag, round(busy, 4)))
                elif isinstance(req, ReadHotRangesRequest):
                    reply.send(ReadHotRangesReply(
                        tuple(self.read_hot_ranges())))
                elif isinstance(req, SplitMetricsRequest):
                    reply.send(SplitMetricsReply(self.split_key_estimate()))
                else:
                    reply.send_error(error("client_invalid_operation"))
            except flow.FdbError as e:
                reply.send_error(e)

    def qos_sample(self, now: float) -> "QosSample":
        """Saturation-signal snapshot (ref: StorageQueuingMetricsReply
        — the per-storage surface the Ratekeeper's updateRate polls):
        smoothed MVCC-window queue bytes (pulled but not yet durable),
        durable-version lag, and read/mutation rates. Computed on
        demand at the collection cadence — the read/write hot paths
        never touch any of this."""
        from .types import QosSample, mutation_bytes as _mb
        qbytes = sum(_mb(m) for _v, ms in self._pending for m in ms)
        lag = max(0, self.version.get() - self.durable_version.get())
        snap = self.stats.snapshot()
        signals = {
            "queue_bytes": round(self._qos_queue.sample(qbytes, now), 1),
            "durability_lag_versions": round(
                self._qos_lag.sample(lag, now), 1),
            "read_rate": round(self._qos_read_rate.sample_total(
                snap.get("get_queries", 0)
                + snap.get("range_queries", 0), now), 2),
            "mutation_rate": round(self._qos_mutation_rate.sample_total(
                snap.get("mutations", 0), now), 2),
            # folded in from the DD meter so every storage signal flows
            # through the one QosSample path (the CC reads no
            # write_bandwidth out-of-band)
            "write_bandwidth": round(
                self.metrics.write_bytes_per_sec(now), 1),
        }
        if SERVER_KNOBS.storage_heat_tracking:
            # the read-side heat signals, armed-only so the pinned
            # default schema (and the off posture) stay untouched
            _tag, busy = self.busiest_read_tag()
            signals.update(
                read_bytes_per_sec=round(
                    self.metrics.read_bytes_per_sec(now), 1),
                read_ops_per_sec=round(
                    self.metrics.read_ops_per_sec(now), 1),
                read_hot_ranges=len(self.read_hot_ranges()),
                busiest_read_tag_busyness=round(busy, 2))
        return QosSample("storage", self.name, now, signals)

    def split_key_estimate(self) -> Optional[bytes]:
        """A byte-balanced interior key from the sample (ref:
        StorageMetrics.actor.h:302 splitMetrics); the window's row
        median is the fallback while the sample is too thin."""
        hi = self.shard_end if self.shard_end is not None else b"\xff"
        k = self.metrics.split_key(self.shard_begin, hi)
        if k is not None:
            return k
        rows = self.data.get_range(self.shard_begin, hi,
                                   self.version.get(), 5000)
        if len(rows) < 2:
            return None
        return rows[len(rows) // 2][0]

    # -- watches --------------------------------------------------------
    def _check_watches(self, version: int, mutations) -> None:
        """Fire watches whose key's value changed (ref: storageserver
        watch triggering on mutation apply)."""
        if not self._watch_map:
            return
        touched = set()
        for m in mutations:
            if m.type == CLEAR_RANGE:
                touched.update(k for k in self._watch_map
                               if m.param1 <= k < m.param2)
            else:
                if m.param1 in self._watch_map:
                    touched.add(m.param1)
        for k in touched:
            waiters = self._watch_map.get(k, [])
            still = []
            now_val = self.data.get(k, version)
            for expected, reply, deadline in waiters:
                if now_val != expected:
                    reply.send(version)
                else:
                    still.append((expected, reply, deadline))
            if still:
                self._watch_map[k] = still
            else:
                self._watch_map.pop(k, None)

    async def _wait_version(self, version: int):
        """(ref: waitForVersion — future_version when too far ahead,
        transaction_too_old below the window floor)"""
        if version > self.version.get() + self._max_read_ahead:
            raise error("future_version")
        if version < max(self.durable_version.get(), self._read_floor):
            raise error("transaction_too_old")
        await self.version.when_at_least(version)

    async def _get_loop(self):
        while True:
            req, reply = await self.gets.pop()
            flow.spawn(self._serve_get(req, reply), TaskPriority.STORAGE)

    def _check_owned(self, begin: bytes, end: Optional[bytes]) -> None:
        """Reject requests outside the owned range so stale-map clients
        refresh their location picture instead of silently reading a
        vacated range (ref: storageserver wrong_shard_server on
        shard-miss, the location-cache invalidation signal)."""
        if begin < self.shard_begin:
            raise error("wrong_shard_server")
        if self.shard_end is not None:
            probe = end if end is not None else begin + b"\x00"
            if probe > self.shard_end:
                raise error("wrong_shard_server")

    async def _serve_get(self, req: StorageGetRequest, reply):
        t0 = flow.now()
        dbg = getattr(req, "debug_id", None)
        admitted = False
        try:
            self.stats.counter("get_queries").add(1)
            self._check_owned(req.key, None)
            await self._wait_version(req.version)
            if dbg is not None:
                # the storage leg of a sampled read (ref: the
                # GetValueDebug stations in storageserver.actor.cpp
                # getValueQ). Emitted only once the read is actually
                # admitted — a wrong-shard/too-old rejection must not
                # file an unpaired DoRead into the stitching
                flow.g_trace_batch.add_event(
                    "GetValueDebug", dbg,
                    "StorageServer.getValue.DoRead")
                admitted = True
            value = self.data.get(req.key, req.version)
            if SERVER_KNOBS.storage_heat_tracking:
                # armed-only read accounting; off, the whole heat plane
                # costs this one knob read (PERF.md posture table)
                self._note_read(req.key,
                                len(req.key) + len(value or b""),
                                req.tags)
            self.read_bands.record(flow.now() - t0)
            if dbg is not None:
                flow.g_trace_batch.add_event(
                    "GetValueDebug", dbg,
                    "StorageServer.getValue.AfterRead")
            reply.send(value)
        except flow.FdbError as e:
            if admitted:
                # pair-closing error station — only when a DoRead
                # opened the pair (ref: getValueQ's error path tracing)
                flow.g_trace_batch.add_event(
                    "GetValueDebug", dbg, "StorageServer.getValue.Error")
            reply.send_error(e)

    async def _range_loop(self):
        while True:
            req, reply = await self.ranges.pop()
            flow.spawn(self._serve_range(req, reply), TaskPriority.STORAGE)

    async def _serve_range(self, req: StorageGetRangeRequest, reply):
        try:
            self.stats.counter("range_queries").add(1)
            self._check_owned(req.begin, req.end)
            await self._wait_version(req.version)
            rows = self.data.get_range(req.begin, req.end, req.version,
                                       req.limit, req.reverse)
            if SERVER_KNOBS.storage_heat_tracking:
                self._note_range_read(rows, req.tags)
            reply.send(rows)
        except flow.FdbError as e:
            reply.send_error(e)

    async def _get_key_loop(self):
        while True:
            req, reply = await self.get_keys.pop()
            flow.spawn(self._serve_get_key(req, reply), TaskPriority.STORAGE)

    async def _serve_get_key(self, req: StorageGetKeyRequest, reply):
        try:
            await self._wait_version(req.version)
            reply.send(self.data.resolve_selector(
                req.selector, req.version, self.shard_begin, self.shard_end))
        except flow.FdbError as e:
            reply.send_error(e)

    async def _watch_loop(self):
        while True:
            req, reply = await self.watches.pop()
            flow.spawn(self._serve_watch(req, reply), TaskPriority.STORAGE)

    async def _serve_watch(self, req: StorageWatchRequest, reply):
        try:
            self._check_owned(req.key, None)
            await self._wait_version(req.version)
            expected = self.data.get(req.key, req.version)
            current = self.data.get(req.key, self.version.get())
            if current != expected:
                reply.send(self.version.get())
                return
            deadline = flow.now() + SERVER_KNOBS.watch_timeout
            self._watch_map.setdefault(req.key, []).append(
                (expected, reply, deadline))
        except flow.FdbError as e:
            reply.send_error(e)

    async def _watch_expiry_loop(self):
        """Abandoned registrations (a client that timed out and went
        away) must not pin _watch_map forever (ref: the database's
        WATCH timeout, DEFAULT_MAX_WATCHES/timeout handling) — expired
        waiters get timed_out; a live client just re-arms."""
        while True:
            await flow.delay(flow.SERVER_KNOBS.watch_expiry_sweep_interval,
                             TaskPriority.LOW_PRIORITY)
            now = flow.now()
            for k in list(self._watch_map):
                keep = []
                for expected, reply, deadline in self._watch_map.get(k, ()):
                    if deadline <= now:
                        reply.send_error(error("timed_out"))
                    else:
                        keep.append((expected, reply, deadline))
                if keep:
                    self._watch_map[k] = keep
                else:
                    self._watch_map.pop(k, None)
