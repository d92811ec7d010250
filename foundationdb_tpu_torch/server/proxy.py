"""Proxy role, its head: the commit path's mutation vocabulary and the
two tables the proxy shares with other roles.

Reference: fdbserver/MasterProxyServer.actor.cpp. This module holds
what the storage and log roles and the commit path's callers need
before the proxy itself runs:
  - `LEGAL_MUTATIONS`, the mutation types a transaction may carry;
  - `make_versionstamp` / `_apply_versionstamp`, the 10-byte commit
    versionstamp and its rewrite of a versionstamped mutation;
  - `KeyResolverMap`, the versioned key range -> resolver owner map;
  - `TransactionTagCounter`, the decaying per-tag traffic table that
    every storage server also keeps.
The `Proxy` role itself (the GRV path and the pipelined commit
batcher), with its admission, repair, scheduler and system-key
imports, comes with the cluster's control plane.
"""

from __future__ import annotations

from bisect import bisect_right

from .. import flow
from ..flow import SERVER_KNOBS
from .types import (ATOMIC_OPS, CLEAR_RANGE, INERT_OPS, PRIORITY_BATCH,
                    PRIORITY_DEFAULT, PRIORITY_IMMEDIATE, SET_VALUE,
                    SET_VERSIONSTAMPED_KEY, SET_VERSIONSTAMPED_VALUE,
                    MutationRef)


# the mutation types a transaction may carry (ref: the commit path
# asserting isValidMutationType — AvailableForReuse and the
# LogProtocolMessage escape are never legal in a transaction)
LEGAL_MUTATIONS = (frozenset({SET_VALUE, CLEAR_RANGE,
                              SET_VERSIONSTAMPED_KEY,
                              SET_VERSIONSTAMPED_VALUE})
                   | ATOMIC_OPS | INERT_OPS)


def make_versionstamp(version: int, batch_index: int) -> bytes:
    """10-byte versionstamp: 8B big-endian commit version + 2B big-endian
    batch index (ref: Versionstamp encoding, CommitTransaction.h /
    design/tuple.md)."""
    return version.to_bytes(8, "big") + batch_index.to_bytes(2, "big")


def _apply_versionstamp(m: MutationRef, stamp: bytes) -> MutationRef:
    """Rewrite a versionstamped mutation into a plain set (ref:
    MasterProxyServer commitBatch applying transformations before
    logging). The operand's trailing 4 bytes are the little-endian
    offset of the 10-byte placeholder."""
    if m.type == SET_VERSIONSTAMPED_KEY:
        off = int.from_bytes(m.param1[-4:], "little")
        key = m.param1[:-4]
        return MutationRef(SET_VALUE, key[:off] + stamp + key[off + 10:],
                           m.param2)
    off = int.from_bytes(m.param2[-4:], "little")
    val = m.param2[:-4]
    return MutationRef(SET_VALUE, m.param1,
                       val[:off] + stamp + val[off + 10:])


MWTLV = 5_000_000  # fallback window (ref: MAX_WRITE_TRANSACTION_LIFE_VERSIONS)

# every mutation is ALSO routed here while a continuous backup is
# active (ref: the backup mutation-log tags — a single stream preserves
# exact intra-version mutation order for point-in-time restore)
BACKUP_TAG = 0xFFFF
# ...and here while a remote region is attached (ref: the log-router
# tags of a fearless configuration; see server/region.py)
REGION_TAG = 0xFFFE


class KeyResolverMap:
    """keyResolvers: key ranges -> resolver owner HISTORY (newest
    first). After a move, ranges keep routing to the former owner too
    until a full MVCC window has passed — both resolvers then hold
    complete write history for the range, so no conflict can be missed
    across the transition (ref: the keyResolvers
    KeyRangeMap<vector<pair<Version,int>>> in
    MasterProxyServer.actor.cpp:204 and its double-delivery window)."""

    def __init__(self, splits, n_resolvers: int, window: int = None):
        self.bounds = [b""] + list(splits)   # range i = [bounds[i], next)
        self.owners = [[(0, i)] for i in range(n_resolvers)]
        # retention window must track the resolvers' knob-configured
        # MVCC window or a move could drop a former owner while stale
        # snapshots are still resolvable
        self.window = (window if window is not None
                       else SERVER_KNOBS.max_write_transaction_life_versions)

    def _split_at(self, key: bytes) -> int:
        i = bisect_right(self.bounds, key) - 1
        if self.bounds[i] == key:
            return i
        self.bounds.insert(i + 1, key)
        self.owners.insert(i + 1, list(self.owners[i]))
        return i + 1

    def move(self, begin: bytes, end, to_idx: int, at_version: int) -> None:
        """Reassign [begin, end) to `to_idx` from `at_version` on; the
        former owners stay live for one MVCC window."""
        i = self._split_at(begin)
        j = self._split_at(end) if end is not None else len(self.bounds)
        for k in range(i, j):
            if self.owners[k][0][1] != to_idx:
                self.owners[k] = [(at_version, to_idx)] + self.owners[k]

    def expire(self, oldest_version: int) -> None:
        """Drop former owners whose move predates the MVCC window floor
        (the resolver GC watermark: any still-resolvable snapshot is
        >= oldest, so a range whose move landed before it has complete
        write history at the NEW owner). The canonical trim — `prune`
        derives its commit-version form from this — and explicitly
        invokable outside the commit path, so a long-idle map does not
        retain owner history forever (the GRV serve path calls this
        with the confirmed committed version's watermark)."""
        for ow in self.owners:
            while len(ow) > 1 and ow[-2][0] < oldest_version:
                ow.pop()

    def prune(self, commit_version: int) -> None:
        """Drop former owners once one full MVCC window has passed the
        move. No skew slack is needed: moves are versioned through the
        commit stream (Master.register_move), so every proxy applies a
        move at the same effective version."""
        self.expire(commit_version - self.window)

    def release(self, begin: bytes, end, idx: int) -> None:
        """Retire `idx` as a FORMER owner of [begin, end) ahead of the
        window — the live-handoff fast path: once the
        donor's clipped state is installed on the new owner, the master
        registers a release through the version chain and double
        delivery stops immediately instead of after a full MVCC window.
        The CURRENT owner is never dropped (a release racing a newer
        move must not orphan the range)."""
        i = self._split_at(begin)
        j = self._split_at(end) if end is not None else len(self.bounds)
        for k in range(i, j):
            ow = self.owners[k]
            if len(ow) > 1:
                kept = [ow[0]] + [t for t in ow[1:] if t[1] != idx]
                if len(kept) != len(ow):
                    self.owners[k] = kept

    def apply(self, entry) -> None:
        """Apply one version-stamped balance entry off the master's
        move log: 4-tuples are moves (the original vocabulary),
        5-tuples carry an op — "move" or "release"."""
        eff, mb, me, idx = entry[:4]
        if len(entry) > 4 and entry[4] == "release":
            self.release(mb, me, idx)
        else:
            self.move(mb, me, idx, eff)

    def live_owners(self, k: int):
        return [idx for _v, idx in self.owners[k]]

    def owner_of(self, key: bytes) -> int:
        """CURRENT owner of `key` (newest history entry)."""
        k = max(0, bisect_right(self.bounds, key) - 1)
        return self.owners[k][0][1]

    def owned_buckets(self, idx: int) -> list:
        """First-byte buckets whose bucket-start key `idx` currently
        owns — the balance loop's pick set (its moves are whole
        buckets, so bucket starts are ownership-representative)."""
        return [b for b in range(256)
                if self.owner_of(bytes([b])) == idx]

    def owned_ranges(self, n_resolvers: int) -> list:
        """Per-resolver count of ranges currently OWNED (newest entry)
        — the skew surface status/exporter/cli show before and after
        the balancer acts."""
        out = [0] * n_resolvers
        for ow in self.owners:
            if 0 <= ow[0][1] < n_resolvers:
                out[ow[0][1]] += 1
        return out

    def clip_per_resolver(self, txn_ranges, n_resolvers: int):
        """For each resolver, the pieces of `txn_ranges` it must see
        (current + windowed former owners). Bisects to the overlapped
        span — the map can grow toward 257 entries as balancing splits
        buckets, and this sits on the hot commit path."""
        out = [[] for _ in range(n_resolvers)]
        nb = len(self.bounds)
        for b, e in txn_ranges:
            k = max(0, bisect_right(self.bounds, b) - 1)
            while k < nb and self.bounds[k] < e:
                lo = self.bounds[k]
                hi = self.bounds[k + 1] if k + 1 < nb else None
                b2 = max(b, lo)
                e2 = e if hi is None else min(e, hi)
                if b2 < e2:
                    for idx in self.live_owners(k):
                        out[idx].append((b2, e2))
                k += 1
        return out


PRIORITY_NAMES = {PRIORITY_BATCH: "batch", PRIORITY_DEFAULT: "default",
                  PRIORITY_IMMEDIATE: "immediate"}


class TransactionTagCounter:
    """Bounded decaying table of per-tag transaction traffic (ref:
    fdbserver/TransactionTagCounter — the busiest-tag tracking behind
    tag throttling; same decay/eviction shape as ConflictHotSpots).

    Each client-supplied tag accumulates a busyness score that halves
    every QOS_TAG_HALF_LIFE seconds, plus raw started / committed /
    conflicted totals. Bounded at QOS_TAG_MAX_ENTRIES (lowest decayed
    score evicted); `top(k)` is the status/CLI/exporter surface, and
    tag throttling reads the same
    rows to pick which tags to push back on."""

    __slots__ = ("half_life", "max_entries", "_entries")

    def __init__(self, half_life: float = None, max_entries: int = None):
        self.half_life = (half_life if half_life is not None
                          else SERVER_KNOBS.qos_tag_half_life)
        self.max_entries = (max_entries if max_entries is not None
                            else int(SERVER_KNOBS.qos_tag_max_entries))
        # tag -> [decayed score, started, committed, conflicted, last t]
        self._entries: dict = {}

    def _decayed(self, score: float, since: float, now: float) -> float:
        if now <= since or self.half_life <= 0:
            return score
        return score * 0.5 ** ((now - since) / self.half_life)

    def record(self, tag: bytes, outcome: str, now: float,
               weight: float = 1.0) -> None:
        ent = self._entries.get(tag)
        if ent is None:
            ent = self._entries[tag] = [0.0, 0, 0, 0, now]
        ent[0] = self._decayed(ent[0], ent[4], now) + weight
        ent[4] = now
        if outcome == "started":
            ent[1] += 1
        elif outcome == "committed":
            ent[2] += 1
        elif outcome == "conflicted":
            ent[3] += 1
        if len(self._entries) > self.max_entries:
            worst = min(self._entries,
                        key=lambda k: self._decayed(
                            self._entries[k][0], self._entries[k][4], now))
            del self._entries[worst]

    def top(self, k: int = None) -> list:
        """Status-ready rows, busiest first: decayed rate score plus
        the raw per-outcome totals per tag."""
        if k is None:
            k = int(SERVER_KNOBS.qos_tag_top_k)
        now = flow.now()
        rows = [(self._decayed(s, t, now), st, cm, cf, tag)
                for tag, (s, st, cm, cf, t) in self._entries.items()]
        rows.sort(key=lambda r: (-r[0], r[4]))
        return [{"tag": tag.hex(), "busyness": round(score, 4),
                 "started": st, "committed": cm, "conflicted": cf}
                for score, st, cm, cf, tag in rows[:k]]
