"""Plain NumPy MVCC conflict resolution for one read range and one write
range a transaction.

The semantics of FoundationDB's resolver (fdbserver/SkipList.cpp:979
addTransaction, :1163 detectConflicts, :1133 checkIntraBatchConflicts;
Resolver.actor.cpp:155):

  - too old: the read snapshot is below the oldest version as it stood
    before this batch; such a transaction contributes no writes;
  - external conflict: a write committed at a version strictly above
    the snapshot overlaps the read range;
  - intra-batch conflict: in transaction order, an earlier transaction
    of the batch that did not conflict wrote a range that overlaps the
    read range;
  - every transaction that neither conflicts nor is too old commits its
    write at the batch's commit version; then the oldest version
    becomes max(oldest, new_oldest_version).

Ranges are given in units: a range is `length` consecutive unit ids
from `id`, and two ranges overlap exactly when they share a unit. The
generator's ranges are made so: a point is one unit of its own, and a
fixed16 range [key(k), key(k + m)) is the units k .. k + m - 1. The
history is one int32 a unit, the batch of its latest committed write.
`resolve` returns a batch's verdicts as two flag tensors: conflict (and
not too old), and too old; the rest commit.

Plain PyTorch, on any device: a run replays its batches on the card
once the window has closed and the program's state is freed (the same
replay in NumPy on the card's host took three times the window), the
tests on the CPU. `brute_force` is the same semantics as a plain loop.
"""

from __future__ import annotations

import numpy as np
import torch

CONFLICT, TOO_OLD, COMMITTED = 0, 1, 2


def expand(ids: np.ndarray, lengths) -> np.ndarray:
    """The units of every range, range by range. `lengths` None: one
    unit a range."""
    if lengths is None:
        return ids.astype(np.int64)
    starts = np.zeros(ids.shape[0], np.int64)
    np.cumsum(lengths[:-1], out=starts[1:])
    within = np.arange(int(lengths.sum()), dtype=np.int64) \
        - np.repeat(starts, lengths)
    return np.repeat(ids.astype(np.int64), lengths) + within


def padded(ids: np.ndarray, lengths) -> np.ndarray:
    """[n, longest] units of every range, a short range's last unit
    repeated."""
    if lengths is None:
        return ids.astype(np.int64)[:, None]
    width = int(lengths.max())
    return ids[:, None] + np.minimum(np.arange(width), lengths[:, None] - 1)


class BatchShape:
    """What depends only on a batch's ranges, worked out once for a pool
    batch (in NumPy, then held on `device`): the units of each
    transaction's read; the written units with their writers; and the
    read units that an earlier write of the batch can reach (`dep_*`: a
    read unit's transaction, the transactions so reached and each unit's
    place among them, and each unit's group of writers of its unit)."""

    def __init__(self, read_id, read_len, write_id, write_len,
                 device="cpu"):
        n = read_id.shape[0]
        read_units = expand(read_id, read_len)
        reader = np.repeat(np.arange(n, dtype=np.int64),
                           1 if read_len is None else read_len)
        units = expand(write_id, write_len)
        writer = np.repeat(np.arange(n, dtype=np.int64),
                           1 if write_len is None else write_len)
        order = np.lexsort((writer, units))
        ws, wt = units[order], writer[order]
        first = np.ones(ws.shape[0], bool)
        first[1:] = ws[1:] != ws[:-1]
        starts = np.flatnonzero(first)
        sizes = np.diff(np.append(starts, ws.shape[0]))
        ukeys = ws[starts]
        g = np.minimum(np.searchsorted(ukeys, read_units),
                       ukeys.shape[0] - 1)
        dep = (ukeys[g] == read_units) & (wt[starts[g]] < reader)
        dep_txn = reader[dep]
        dep_txns, dep_of = np.unique(dep_txn, return_inverse=True)
        groups, dep_group = np.unique(g[dep], return_inverse=True)
        d_sizes = sizes[groups]
        d_starts = np.concatenate([[0], np.cumsum(d_sizes)[:-1]]
                                  ).astype(np.int64)
        pos = (np.arange(int(d_sizes.sum()))
               - np.repeat(d_starts - starts[groups], d_sizes))

        def on(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(
                device)
        self.n = n
        self.reads = on(padded(read_id, read_len))
        self.write_units, self.write_txn = on(ws), on(wt)
        self.dep_txn, self.dep_txns, self.dep_of = (on(dep_txn),
                                                    on(dep_txns),
                                                    on(dep_of))
        self.dep_group = on(dep_group)
        self.dep_writer = on(wt[pos])
        self.dep_wgroup = on(np.repeat(np.arange(groups.shape[0]), d_sizes))
        self.n_groups = int(groups.shape[0])


class Reference:
    """The history of `n_units` units, all at `init_version`: each
    unit's batch of its latest committed write (slot 0: none yet) and
    each batch's commit version."""

    def __init__(self, n_units: int, init_version: int = 0,
                 intra_batch: bool = True, external: bool = True,
                 device="cpu"):
        self.device = torch.device(device)
        self.oldest = 0
        # the two switches exist for the control: a resolver that breaks
        # the serializability guarantee one way or the other
        self.intra_batch = intra_batch
        self.external = external
        self._slot = torch.zeros(n_units, dtype=torch.int32,
                                 device=self.device)
        self._versions = torch.zeros(1024, dtype=torch.int64,
                                     device=self.device)
        self._versions[0] = init_version
        self._n = 1                     # slots used
        # transactions that conflicted with the history, in the batch,
        # and that came too old, over every batch resolved
        self._counts = torch.zeros(3, dtype=torch.int64, device=self.device)
        self._txns = 0

    @property
    def counts(self) -> dict:
        ext, intra, old = self._counts.tolist()
        return {"external": ext, "intra_batch": intra, "too_old": old,
                "transactions": self._txns}

    def resolve(self, shape: BatchShape, snapshots: torch.Tensor,
                commit_version: int, new_oldest_version: int):
        """(conflict and not too old, too old) flags of one batch."""
        n = shape.n
        too_old = snapshots < self.oldest
        conflict = too_old.clone()
        if self.external:
            newest = self._slot[shape.reads].amax(dim=1)
            conflict |= self._versions[newest.long()] > snapshots
        after_external = conflict.sum()
        if self.intra_batch and shape.dep_txn.shape[0]:
            txns = shape.dep_txns
            base = conflict[txns]
            cur = base
            for _ in range(n + 1):
                cand = torch.where(conflict[shape.dep_writer], n,
                                   shape.dep_writer)
                first_alive = torch.full(
                    (shape.n_groups,), n, dtype=torch.int64,
                    device=self.device).scatter_reduce_(
                        0, shape.dep_wgroup, cand, "amin")
                hit = first_alive[shape.dep_group] < shape.dep_txn
                # a transaction conflicts when any of its units is hit
                nxt = torch.zeros(txns.shape[0], dtype=torch.uint8,
                                  device=self.device).scatter_reduce_(
                    0, shape.dep_of, hit.to(torch.uint8), "amax")
                nxt = base | nxt.bool()
                conflict[txns] = nxt
                if torch.equal(nxt, cur):
                    break
                cur = nxt
        n_old = too_old.sum()
        self._counts += torch.stack([after_external - n_old,
                                     conflict.sum() - after_external, n_old])
        self._txns += n
        s = self._next_slot(int(commit_version))
        # slots only grow: the newest write of a unit is the largest
        mark = (~conflict[shape.write_txn]).to(torch.int32) * s
        self._slot.scatter_reduce_(0, shape.write_units, mark, "amax")
        self.oldest = max(self.oldest, int(new_oldest_version))
        return conflict & ~too_old, too_old

    def _next_slot(self, version: int) -> int:
        s = self._n
        if s >= self._versions.shape[0]:
            self._versions = torch.cat([self._versions,
                                        torch.zeros_like(self._versions)])
        self._versions[s] = version
        self._n = s + 1
        return s

    def history_rows(self, n_shards: int, contiguous: bool) -> int:
        """Rows of the least interval history that holds what is live
        (latest write at or above the oldest version): a first row a
        shard and a row wherever the latest live write changes. Where
        units tile the keyspace (`contiguous`), neighbours written by one
        batch share their rows; points each take a begin and an end."""
        live = self._versions[:self._n] >= self.oldest
        live[0] = False
        on = live[self._slot.long()]
        if not contiguous:
            return n_shards + 2 * int(on.sum())
        g = torch.where(on, self._slot, 0)
        changes = int((g[1:] != g[:-1]).sum())
        return n_shards + changes + int(g[0] != 0) + int(g[-1] != 0)


def brute_force(batches, init_version: int = 0):
    """The same semantics as a plain loop over every transaction and
    every committed write (for the tests): `batches` is a list of
    (reads, writes, snapshots, commit_version, new_oldest_version), a
    read or write a (begin, end) pair of unit ids, end excluded;
    returns one verdict list a batch."""
    writes: list = []            # (begin, end, version)
    oldest = 0
    out = []

    def overlap(a, b):
        return a[0] < b[1] and b[0] < a[1]

    for reads, wranges, snaps, commit, new_oldest in batches:
        verdicts, added = [], []
        for t in range(len(reads)):
            if snaps[t] < oldest:
                verdicts.append(TOO_OLD)
                continue
            r = reads[t]
            hit = init_version > snaps[t]
            hit = hit or any(overlap(r, (b, e)) and v > snaps[t]
                             for b, e, v in writes)
            hit = hit or any(overlap(r, w) for w in added)
            if hit:
                verdicts.append(CONFLICT)
            else:
                verdicts.append(COMMITTED)
                added.append(wranges[t])
        writes += [(b, e, int(commit)) for b, e in added]
        oldest = max(oldest, int(new_oldest))
        out.append(verdicts)
    return out
