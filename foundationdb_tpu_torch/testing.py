"""Seeded adversarial batches for the resolve steps (K3, K8, K5).

`adversarial_batch(rng, kind, cap, T, R, Wr, n_words)` returns a
canonical history (HK, HV) and one padded batch as the 10 host arrays
the marshaller produces (snapshots, tooOld, rb, re, rtxn, rvalid, wb,
we, wtxn, wvalid), for commit offset COMMIT and oldest offset OLDEST.
Every kind aims at a corner of the interval step:

  duplicates       endpoints from a tiny alphabet: equal keys across
                   reads, writes and the history
  empty_inverted   ranges with b == e and b > e, reads and writes
  inf_rows         the +inf row (every word 0xFFFFFFFF) and rows whose
                   key words are all 0xFFFFFFFF as endpoints and in the
                   history
  no_valid_writes  every write slot invalid, its rows left as garbage
  chain            transaction t reads what t-1 writes, so the fixpoint
                   needs one round per link (up to `chain` links)
  nested           ranges around a few shared centres at widths from a
                   quarter of the keyspace down to 1/128, and point
                   ranges between: wide writes contain other writes and
                   whole runs of reads, wide reads span hundreds of
                   write begins at the cell's shape (K8f's range-min
                   and stabbing queries reach the trees' high nodes)
  mixed            all of the above, range by range
  split_edges      the key-range shards' corners (`splits`, the key ids
                   the shards split at; the alphabet's quartiles by
                   default): ranges that begin or end exactly on a split
                   key, span every shard, are clipped to the same lower
                   or upper bound of one shard, or cover exactly one
                   shard (empty in the others); no write reaches the
                   last shard, so it has no survivors
  clip_edges       K8's read clip at the shards' bounds (`splits` as
                   above): ranges that begin or end exactly on a bound,
                   on the key one past it (the bound + b"\x00", a row
                   that ties the bound up to the length word), lie
                   wholly inside one shard (outside every other), are
                   emptied by one shard's clip, cover one shard, the
                   whole keyspace, or are inverted across a bound;
                   the history holds the bounds and the keys one past
                   them

With `splits`, the keys spread over [0, splits[-1] + splits[0]) in every
kind, and the duplicates kind's tiny alphabet straddles the middle
split, so a [S, cap] sharded history (`shard_history`) holds rows in
every shard. `shard_bounds` gives the shards' (lows, highs) rows as the
sharded resolver builds them.

`point_batch(rng, kind, cap, T, R, Wr, n_words)` returns a point state
(SK, SV) and one padded batch as its 8 host arrays (snapshots, tooOld,
rk, rtxn, rvalid, wk, wtxn, wvalid) for K5's corners (POINT_KINDS):

  one_key          every write, and a quarter of the reads, on one key
                   that the state holds several versions of
  invalid_writes   every write slot invalid, its rows left as garbage
  inf_writes       writes and reads of the +inf row and of the longest
                   all-0xFF key
  mixed            keys from a tiny alphabet, some slots invalid

Transaction ids are non-decreasing with pad slots = T, as every
marshaller lays them out. Numpy only: the tests feed the arrays to the
reference package and the port, and chip_smoke.py to the card.

`rand_batches(seed, n_batches, ...)` is the seeded transaction stream
the parity tests resolve through both packages' backends: the
reference's own stream generator (`tests/test_packed_interval.py`),
draw for draw, yielding the port's `ResolverTransaction`s.

`commit_leg(P, backend, ids, versions, step, ...)` is the commit path
as the proxy composes it, over a package handle `P` (`leg_package()`
for the port; a test hands in the reference's modules under the same
names): ResolveRequests through the resolver role, the committed
transactions' mutations logged to a durable TLog and pulled by one
StorageServer a tag, then read back, killed by a power loss, recovered
and read back again, every read held to a plain dict of the verdicts.
"""

from __future__ import annotations

import random
import time
from bisect import bisect_right
from types import SimpleNamespace

import numpy as np

VDEAD = -(1 << 30)
INF = np.uint32(0xFFFFFFFF)
COMMIT, OLDEST = 70, 20
KINDS = ("duplicates", "empty_inverted", "inf_rows", "no_valid_writes",
         "chain", "mixed", "split_edges", "clip_edges", "nested")
POINT_KINDS = ("one_key", "invalid_writes", "inf_writes", "mixed")
N_SHARDS = 4


def key_rows(ids, n_words: int) -> np.ndarray:
    """Rows for integer key ids: the id in the last two key words
    (big-endian), the full key length in the length word."""
    ids = np.asarray(ids, np.int64)
    rows = np.zeros((ids.shape[0], n_words + 1), np.uint32)
    rows[:, n_words - 1] = (ids & 0xFFFFFFFF).astype(np.uint32)
    if n_words > 1:
        rows[:, n_words - 2] = (ids >> 32).astype(np.uint32)
    rows[:, n_words] = 4 * n_words
    return rows


def _special_rows(n_words: int) -> np.ndarray:
    """The empty key, the longest all-0xFF key and the +inf row."""
    near = np.full(n_words + 1, INF, np.uint32)
    near[n_words] = 4 * n_words
    return np.stack([np.zeros(n_words + 1, np.uint32), near,
                     np.full(n_words + 1, INF, np.uint32)])


def history(rng, cap: int, n_words: int, alphabet: int, n_rows: int,
            offset: int = 0):
    """A canonical history: the empty key first, sorted unique rows
    drawn from ids offset + [0, alphabet) (and the all-0xFF key), +inf /
    VDEAD padding; versions in [-5, 60], a few below the window."""
    ids = offset + rng.integers(0, alphabet, n_rows)
    rows = np.concatenate([key_rows(ids, n_words),
                           _special_rows(n_words)[1:2]])
    rows = np.unique(rows, axis=0)[:cap - 2]
    hk = np.full((cap, n_words + 1), INF, np.uint32)
    hk[0] = 0
    hk[1:1 + len(rows)] = rows
    n = 1 + len(rows)
    hv = np.full(cap, VDEAD, np.int32)
    hv[:n] = rng.integers(-5, 60, n)
    hv[:n][rng.random(n) < 0.05] = VDEAD
    return hk, hv


def _ranges(rng, kind: str, n: int, n_words: int, alphabet: int,
            offset: int = 0):
    """n (begin, end) row pairs for one of the range kinds."""
    special = _special_rows(n_words)
    b = key_rows(offset + rng.integers(0, alphabet, n), n_words)
    e = key_rows(offset + rng.integers(0, alphabet, n), n_words)
    if kind in ("plain", "duplicates"):
        lo, hi = np.minimum(b, e), np.maximum(b, e)   # word-wise: same ids
        swap = rng.random(n) < (0.1 if kind == "duplicates" else 0.0)
        b, e = np.where(swap[:, None], hi, lo), np.where(swap[:, None], lo, hi)
    elif kind == "empty_inverted":
        pick = rng.random(n)
        e = np.where((pick < 0.4)[:, None], b, e)          # empty
        inv = (pick >= 0.4) & (pick < 0.7)
        b, e = (np.where(inv[:, None], np.maximum(b, e), b),
                np.where(inv[:, None], np.minimum(b, e), e))
    elif kind == "inf_rows":
        which = rng.integers(0, 3, n)
        sp = special[which]
        pick = rng.random(n)
        b = np.where((pick < 0.3)[:, None], sp, b)
        e = np.where(((pick >= 0.2) & (pick < 0.7))[:, None],
                     special[rng.integers(1, 3, n)], e)
    return b, e


def _nested_ranges(rng, n: int, n_words: int, alphabet: int):
    """n (begin, end) row pairs for the nested kind: half of them wide,
    centred on one of 8 shared centres at a width of alphabet >> (2 +
    level) for a level in [0, 6), so ranges on one centre nest; the
    rest one key wide (the key and the key + 1)."""
    centres = rng.integers(0, alphabet, 8)
    c = centres[rng.integers(0, len(centres), n)]
    half = np.maximum(alphabet >> (2 + rng.integers(0, 6, n)), 1)
    wide = rng.random(n) < 0.5
    point = rng.integers(0, alphabet, n)
    b = np.where(wide, np.maximum(c - half, 0), point)
    e = np.where(wide, np.minimum(c + half, alphabet), point + 1)
    return key_rows(b, n_words), key_rows(e, n_words)


def split_ids(alphabet: int, n_shards: int = N_SHARDS) -> list:
    """The key ids the shards split at: the alphabet's quantiles."""
    return [alphabet * k // n_shards for k in range(1, n_shards)]


def shard_bounds(splits, n_words: int):
    """[S, W+1] (lows, highs) for the shards split at key ids `splits`,
    as the sharded resolver builds them: lows[0] the empty key, highs[k]
    = lows[k+1], highs[-1] the +inf row."""
    lows = np.concatenate([np.zeros((1, n_words + 1), np.uint32),
                           key_rows(splits, n_words)])
    highs = np.full_like(lows, INF)
    highs[:-1] = lows[1:]
    return lows, highs


def _split_ranges(rng, n: int, n_words: int, splits, alphabet: int,
                  writes: bool):
    """n (begin, end) row pairs at the shards' corners (see KINDS); the
    writes end at the last split at the latest."""
    edges = np.asarray(splits, np.int64)
    top = int(edges[-1]) if writes else alphabet
    k = rng.integers(0, len(edges), n)                 # a split per range
    below = rng.integers(0, edges[k])                  # under split k
    above = edges[k] + 1 + rng.integers(0, np.maximum(top - edges[k], 1))
    nxt = np.append(edges[1:], top)[k]                 # the next split
    inside = edges[k] + rng.integers(0, np.maximum(nxt - edges[k], 1))
    lo_all = rng.integers(0, edges[0], n)
    hi_all = edges[-1] + rng.integers(0 if writes else 1,
                                      max(top - edges[-1], 0) + 1, n)
    pick = rng.integers(0, 6, n)
    b = np.choose(pick, [edges[k], below, lo_all, below, inside, edges[k]])
    e = np.choose(pick, [above, edges[k], hi_all, inside, above, nxt])
    e = np.minimum(e, top)
    return key_rows(b, n_words), key_rows(e, n_words)


def _past(rows: np.ndarray) -> np.ndarray:
    """Each row's key + b"\x00": the same words, the length word one
    longer, so it ties the row up to the length word."""
    out = rows.copy()
    out[:, -1] += 1
    return out


def _clip_ranges(rng, n: int, n_words: int, splits, alphabet: int):
    """n (begin, end) row pairs at the shards' bounds (see KINDS)."""
    edges = np.asarray(splits, np.int64)
    k = rng.integers(0, len(edges), n)                 # a bound per range
    at = key_rows(edges[k], n_words)
    past = _past(at)
    below = key_rows(rng.integers(0, edges[k]), n_words)
    above = key_rows(edges[k] + 1 + rng.integers(
        0, np.maximum(alphabet - edges[k] - 1, 1)), n_words)
    nxt = np.append(edges[1:], alphabet)[k]            # the next bound
    inside_b = edges[k] + 1 + rng.integers(0, np.maximum(nxt - edges[k] - 1,
                                                         1))
    inside = key_rows(inside_b, n_words)
    inside_e = key_rows(np.minimum(inside_b + 1 + rng.integers(0, 3, n), nxt),
                        n_words)
    special = _special_rows(n_words)
    empty_key = np.broadcast_to(special[0], at.shape)
    inf_row = np.broadcast_to(special[2], at.shape)
    pick = rng.integers(0, 8, n)[:, None]
    b = np.choose(pick, [at, below, below, past, inside, at, empty_key,
                         above])
    e = np.choose(pick, [past, past, at, above, inside_e,
                         key_rows(nxt, n_words), inf_row, below])
    return b, e


def _with_rows(rng, hk, hv, extra):
    """The history with the rows `extra` added (canonical: sorted unique
    rows after the empty key, +inf / VDEAD padding)."""
    cap = hk.shape[0]
    real = ~(hk == INF).all(axis=1)
    rows = np.unique(np.concatenate([hk[real][1:], extra]), axis=0)
    rows = rows[:cap - 1]
    n = 1 + len(rows)
    out_k = np.full_like(hk, INF)
    out_k[0] = 0
    out_k[1:n] = rows
    out_v = np.full_like(hv, VDEAD)
    out_v[:n] = rng.integers(-5, 60, n)
    return out_k, out_v


def shard_history(hk, hv, lows, highs):
    """A history split into [S, cap] shards as the sharded resolver
    holds it: shard k's rows are its lower bound, at the version the
    history has there, then the history's rows strictly inside (lows[k],
    highs[k]); +inf / VDEAD padding."""
    cap, width = hk.shape
    real = ~(hk == INF).all(axis=1)
    rows, vers = hk[real], hv[real]

    def lt(r):                       # rows < r, lexicographically
        out = np.zeros(len(rows), bool)
        eq = np.ones(len(rows), bool)
        for w in range(width):
            out |= eq & (rows[:, w] < r[w])
            eq &= rows[:, w] == r[w]
        return out, eq

    shk = np.full((len(lows), cap, width), INF, np.uint32)
    shv = np.full((len(lows), cap), VDEAD, np.int32)
    for k, (lo, hi) in enumerate(zip(lows, highs)):
        below, at = lt(lo)
        inside = ~below & ~at & lt(hi)[0]
        n_le = int((below | at).sum())
        part_k = np.concatenate([lo[None], rows[inside]])
        part_v = np.concatenate([[vers[n_le - 1] if n_le else VDEAD],
                                 vers[inside]])
        if len(part_k) > cap:
            raise ValueError("a shard's rows exceed the capacity")
        shk[k, :len(part_k)], shv[k, :len(part_k)] = part_k, part_v
    return shk, shv


def _chain(T: int, n_words: int, links: int, base: int):
    """Transaction t < links reads key base + t and writes key
    base + t + 1: each conflicts with the previous one."""
    t = np.arange(links)
    rb = key_rows(base + t, n_words)
    re = rb.copy()
    re[:, n_words] += 1                                  # key + b"\x00"
    wb = key_rows(base + t + 1, n_words)
    we = wb.copy()
    we[:, n_words] += 1
    return rb, re, wb, we


def adversarial_batch(rng, kind: str, cap: int, T: int, R: int, Wr: int,
                      n_words: int, chain: int = 512, splits=None):
    """(HK, HV, (snap, too_old, rb, re, rtxn, rvalid, wb, we, wtxn,
    wvalid)) for `kind` (see KINDS) at one shape bucket; `splits` are
    the key ids a sharded step splits at (see above)."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    alphabet = max(16, 4 * T)
    if splits is not None:
        alphabet = max(alphabet, splits[-1] + splits[0])
    elif kind in ("split_edges", "clip_edges"):
        splits = split_ids(alphabet)
    offset = 0
    if kind == "duplicates":
        if splits is not None:
            offset = splits[len(splits) // 2] - 3
        alphabet = 6
    hk, hv = history(rng, cap, n_words, alphabet, min(cap // 2, 8 * T),
                     offset)
    nt = T if kind == "chain" else int(rng.integers(max(1, T // 2), T + 1))
    if kind == "mixed":
        kinds = ("duplicates", "empty_inverted", "inf_rows", None)
        parts_r = [_ranges(rng, k or "plain", R, n_words, alphabet)
                   for k in kinds]
        parts_w = [_ranges(rng, k or "plain", Wr, n_words, alphabet)
                   for k in kinds]
        pr = rng.integers(0, len(kinds), R)
        pw = rng.integers(0, len(kinds), Wr)
        rb = np.choose(pr[:, None], [p[0] for p in parts_r])
        re = np.choose(pr[:, None], [p[1] for p in parts_r])
        wb = np.choose(pw[:, None], [p[0] for p in parts_w])
        we = np.choose(pw[:, None], [p[1] for p in parts_w])
    elif kind == "split_edges":
        rb, re = _split_ranges(rng, R, n_words, splits, alphabet, False)
        wb, we = _split_ranges(rng, Wr, n_words, splits, alphabet, True)
    elif kind == "nested":
        rb, re = _nested_ranges(rng, R, n_words, alphabet)
        wb, we = _nested_ranges(rng, Wr, n_words, alphabet)
    elif kind == "clip_edges":
        bounds = key_rows(splits, n_words)
        hk, hv = _with_rows(rng, hk, hv, np.concatenate([bounds,
                                                         _past(bounds)]))
        rb, re = _clip_ranges(rng, R, n_words, splits, alphabet)
        wb, we = _clip_ranges(rng, Wr, n_words, splits, alphabet)
    else:
        rb, re = _ranges(rng, kind, R, n_words, alphabet, offset)
        wb, we = _ranges(rng, kind, Wr, n_words, alphabet, offset)
    rt = np.sort(rng.integers(0, nt, R)).astype(np.int32)
    wt = np.sort(rng.integers(0, nt, Wr)).astype(np.int32)
    snap = rng.integers(0, 70, T).astype(np.int32)
    too_old = rng.random(T) < 0.05
    if kind in ("chain", "mixed"):
        links = min(chain, T, R, Wr) if kind == "chain" else \
            min(chain, T, R, Wr) // 4
        crb, cre, cwb, cwe = _chain(T, n_words, links, 4 * T + 8)
        rb[:links], re[:links], wb[:links], we[:links] = crb, cre, cwb, cwe
        # the chain's transactions own the first slots, in txn order
        rt[:links] = wt[:links] = np.arange(links)
        rt[links:] = np.sort(rng.integers(links, max(nt, links + 1),
                                          R - links))
        wt[links:] = np.sort(rng.integers(links, max(nt, links + 1),
                                          Wr - links))
        snap[:links] = 69                 # above every history version
        too_old[:links] = False
    else:
        links = 0
    rv = rng.random(R) < 0.9
    wv = np.zeros(Wr, bool) if kind == "no_valid_writes" else \
        rng.random(Wr) < 0.9
    rv[:links] = True
    wv[:links] = kind != "no_valid_writes"
    # pad slots past the used ones: txn id T, invalid, garbage rows
    n_r = int(rng.integers(max(links, R // 2), R + 1))
    n_w = int(rng.integers(max(links, Wr // 2), Wr + 1))
    rt[n_r:] = T
    wt[n_w:] = T
    rv &= rt < T
    wv &= wt < T
    snap[nt:] = 0
    too_old[nt:] = False
    return hk, hv, (snap, too_old, rb, re, rt, rv, wb, we, wt, wv)


def point_batch(rng, kind: str, cap: int, T: int, R: int, Wr: int,
                n_words: int):
    """(SK, SV, (snap, too_old, rk, rtxn, rvalid, wk, wtxn, wvalid)) for
    `kind` (see POINT_KINDS): a state sorted by (key, version) with
    duplicate keys and rows below OLDEST, half full, and one batch whose
    txn ids are non-decreasing with pad slots = T. Any Wr >= 1 (the
    reference's step takes powers of two only)."""
    if kind not in POINT_KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    alphabet = 8 if kind == "mixed" else max(16, 2 * T)
    n = cap // 2
    keys = key_rows(rng.integers(0, alphabet, n), n_words)
    if kind == "inf_writes":
        keys[: n // 8] = _special_rows(n_words)[1]
    vers = rng.integers(-5, 60, n).astype(np.int32)
    order = np.lexsort([vers] + [keys[:, w] for w in range(n_words, -1, -1)])
    sk = np.full((cap, n_words + 1), INF, np.uint32)
    sv = np.full(cap, VDEAD, np.int32)
    sk[:n], sv[:n] = keys[order], vers[order]
    rk = key_rows(rng.integers(0, alphabet, R), n_words)
    wk = key_rows(rng.integers(0, alphabet, Wr), n_words)
    if kind == "one_key":
        one = sk[int(rng.integers(0, n))]
        wk[:] = one
        rk[rng.random(R) < 0.25] = one
    elif kind == "inf_writes":
        special = _special_rows(n_words)[1:]
        wk[rng.random(Wr) < 0.5] = special[rng.integers(0, 2)]
        rk[rng.random(R) < 0.25] = special[rng.integers(0, 2)]
    elif kind == "invalid_writes":
        wk[:] = rng.integers(0, 1 << 32, wk.shape, dtype=np.uint64)
    nt = int(rng.integers(max(1, T // 2), T + 1))
    rt = np.sort(rng.integers(0, nt, R)).astype(np.int32)
    wt = np.sort(rng.integers(0, nt, Wr)).astype(np.int32)
    n_r = int(rng.integers(R // 2, R + 1))
    n_w = int(rng.integers((Wr + 1) // 2, Wr + 1))
    rt[n_r:] = T
    wt[n_w:] = T
    rv = (rng.random(R) < (0.8 if kind == "mixed" else 1.0)) & (rt < T)
    wv = (rng.random(Wr) < (0.8 if kind == "mixed" else 1.0)) & (wt < T)
    if kind == "invalid_writes":
        wv[:] = False
    snap = rng.integers(0, 70, T).astype(np.int32)
    too_old = rng.random(T) < 0.05
    snap[nt:] = 0
    too_old[nt:] = False
    return sk, sv, (snap, too_old, rk, rt, rv, wk, wt, wv)


def txn(snapshot, reads=(), writes=()):
    """One transaction as the resolvers take it."""
    from .models.conflict_set import ResolverTransaction
    return ResolverTransaction(snapshot, tuple(reads), tuple(writes))


def rand_batches(seed, n_batches, point=False, n_keys=40, max_txns=10,
                 version_stride=2000, window=5000):
    """[(batch, commit_version, new_oldest_version)]: keys over the
    whole byte range (all sharded splits see traffic), interval widths
    mixed, occasional EMPTY ranges (b == e, must be skipped without a
    slot), empty batches, and snapshots below the window (tooOld)."""
    rng = random.Random(seed)
    out = []
    v = 0

    def key():
        return bytes([rng.randrange(256)]) + b"%02d" % rng.randrange(n_keys)

    def rd():
        k = key()
        if point:
            return (k, k + b"\x00")
        if rng.random() < 0.1:
            return (k, k)          # empty range: contributes no slot
        return (k, k + bytes([rng.randrange(1, 8)]))

    for _ in range(n_batches):
        v += rng.randrange(1, version_stride)
        batch = []
        for _ in range(rng.randrange(0, max_txns)):
            reads = [rd() for _ in range(rng.randrange(0, 3))]
            writes = [rd() for _ in range(rng.randrange(0, 3))]
            snap = max(0, v - rng.randrange(0, 2 * window))
            batch.append(txn(snap, reads, writes))
        out.append((batch, v, max(0, v - window)))
    return out


# -- the commit leg ----------------------------------------------------------

LEG_DEPTH = 4          # ResolveRequests in flight, as a proxy keeps them
LEG_KEY_BYTES = 16
LEG_WAIT = 60.0        # virtual seconds the leg waits for durability


def leg_package():
    """The port's modules under the names `commit_leg` reads."""
    from . import flow, models, rpc
    from .server import kvstore, proxy, resolver_role, storage, tlog, types
    return SimpleNamespace(flow=flow, rpc=rpc, types=types, tlog=tlog,
                           storage=storage, kvstore=kvstore, proxy=proxy,
                           role=resolver_role, models=models)


def leg_keys(ids, key_bytes: int) -> list:
    """Keys of integer ids: zero bytes, then the id big-endian in the
    key's low 8 bytes."""
    pad = bytes(key_bytes - 8)
    raw = np.asarray(ids, np.int64).astype(">u8").tobytes()
    return [pad + raw[j:j + 8] for j in range(0, len(raw), 8)]


def leg_requests(P, ids, versions, step: int, key_bytes: int) -> list:
    """ResolveRequests of the leg's traffic, chained by prev_version from
    0: batch i's transaction t reads ids[i, 2t] and writes ids[i, 2t+1]
    (point ranges [k, k + b"\\x00")), reads at versions[i] - step, asks
    for report_conflicting_keys when t == 0 in every other batch, and
    carries one SET_VALUE of its write key to the versionstamp
    (versions[i], t)."""
    t = P.types
    out, prev = [], 0
    for i, v in enumerate(versions):
        keys = leg_keys(ids[i], key_bytes)
        out.append(t.ResolveRequest(prev, v, tuple(
            t.CommitRequest(
                v - step, ((r, r + b"\x00"),), ((w, w + b"\x00"),),
                (t.MutationRef(t.SET_VALUE, w,
                               P.proxy.make_versionstamp(v, j)),),
                report_conflicting_keys=(j == 0 and i % 2 == 1))
            for j, (r, w) in enumerate(zip(keys[0::2], keys[1::2])))))
        prev = v
    return out


def leg_model(requests, verdicts, committed: int, upto: int) -> dict:
    """The plain model: key -> value after batches 0..upto, from the
    verdicts; within a batch a later transaction's write wins."""
    model = {}
    for req, ver in zip(requests[:upto + 1], verdicts):
        for txn, v in zip(req.transactions, ver):
            if v == committed:
                for m in txn.mutations:
                    model[m.param1] = m.param2
    return model


def commit_leg(P, backend: str, ids, versions, step: int, *,
               resolver_kwargs=None, split_ids=(), read_at: int = None,
               n_sample: int = 4096, page_rows: int = 10_000, seed: int = 0,
               on_resolver=None) -> dict:
    """The commit path on one resolver, one TLog and one StorageServer a
    tag, each on its own machine of a SimNetwork under a virtual
    Scheduler of package `P` (attributes flow, rpc, types, tlog,
    storage, kvstore, proxy, role (the resolver role's module) and
    models).

    A proxy process keeps LEG_DEPTH ResolveRequests (`leg_requests`, at
    LEG_KEY_BYTES-byte keys) in flight to
    `P.role.Resolver(process, backend, **resolver_kwargs)`.
    Each batch, once resolved and once its predecessor was pushed, goes
    to the TLog (on a SimDisk, so durable through a DiskQueue) as one
    TLogCommitRequest(prev_version, version, mutations,
    known_committed): the committed transactions' mutations in
    transaction order, each tagged to the shard of its key (tags split
    at `split_ids`), `known_committed` the highest version acked so far,
    as the proxy sets them. Storage server i pulls tag i into a
    KeyValueStoreMemory on its machine's SimDisk at the default
    durability lag, and pops the log once durable.

    After the stream and the durability it allows, the checks, each
    against `leg_model` (AssertionError on a difference):
      (a) every shard paged with StorageGetRangeRequest at the last
          version equals the model: every acknowledged write is there
          and no write of a conflicted transaction;
      (b) StorageGetRequest point reads of `n_sample` seeded keys of the
          stream's writes at the version of batch `read_at` equal the
          model at that version;
      (c) a power loss (`kill_machine`) of the TLog's machine and every
          storage machine; a new TLog and new StorageServers on the same
          disks recover, re-pull, and answer (a) and (b) as before.

    Returns {"log": what two packages must agree on (verdicts, commit
    replies, reads, durable versions, the log's versions left),
    "wall": per-batch wall seconds by part (the resolve round trip,
    the TLog commit's from its push to its fsync ack, and the storage
    apply lag from the ack to every server's version reaching the
    batch's), "tasks": the scheduler's busy seconds by task name over
    the stream, "stream_s", "reads_s", "recovery_s" (from the boot of
    the new roles to every server at the last version), "resolver",
    "committed", "rows", "sample"}."""
    flow, types, rpc = P.flow, P.types, P.rpc
    COMMITTED = P.models.COMMITTED
    n = len(versions)
    read_at = n - 1 if read_at is None else read_at
    requests = leg_requests(P, ids, versions, step, LEG_KEY_BYTES)
    splits = leg_keys(list(split_ids), LEG_KEY_BYTES)
    n_tags = len(splits) + 1
    bounds = [b""] + splits + [None]
    writes = sorted({k for req in requests for txn in req.transactions
                     for k, _e in txn.write_conflict_ranges})
    pick = np.random.default_rng(seed).choice(
        len(writes), size=min(n_sample, len(writes)), replace=False)
    sample = [writes[j] for j in sorted(pick)]
    log, wall = {}, {k: [0.0] * n for k in ("resolve", "tlog", "apply")}
    flow.set_seed(seed)
    sched = flow.Scheduler()
    flow.set_scheduler(sched)
    try:
        net = rpc.SimNetwork(sched, flow.g_random)
        proxy = net.new_process("proxy", machine="proxy")
        res = P.role.Resolver(net.new_process("resolver", machine="resolver"),
                              backend, **(resolver_kwargs or {}))
        if on_resolver is not None:
            on_resolver(res)

        def boot():
            tl_proc = net.processes.get("tlog")
            tl_proc = (net.reboot("tlog") if tl_proc is not None
                       else net.new_process("tlog", machine="tlog"))
            tl = P.tlog.TLog(tl_proc, disk=net.disk("tlog"), name="tlog")
            tl.start()
            servers = []
            for i in range(n_tags):
                name = f"storage{i}"
                proc = (net.reboot(name) if name in net.processes
                        else net.new_process(name, machine=name))
                kv = P.kvstore.KeyValueStoreMemory(net.disk(name), name,
                                                   owner=proc)
                ss = P.storage.StorageServer(
                    proc, tlog_peek=tl.peeks.ref(), kv=kv,
                    tlog_pop=tl.pops.ref(), tag=i, shard_begin=bounds[i],
                    shard_end=bounds[i + 1], name=name)
                ss.start()
                servers.append(ss)
            return tl, servers

        async def read_back(servers, at):
            pages = []
            for i, ss in enumerate(servers):
                begin = bounds[i]
                end = bounds[i + 1] if bounds[i + 1] is not None else b"\xff"
                rows = []
                while True:
                    page = await ss.ranges.ref().get_reply(
                        types.StorageGetRangeRequest(begin, end, versions[-1],
                                                     page_rows), proxy)
                    rows.extend(page)
                    if len(page) < page_rows:
                        break
                    begin = page[-1][0] + b"\x00"
                pages.append(rows)
            points = []
            for k in sample:
                ss = servers[bisect_right(splits, k)]
                points.append(await ss.gets.ref().get_reply(
                    types.StorageGetRequest(k, versions[at]), proxy))
            return pages, points

        async def run():
            tl, servers = boot()
            await tl.recovered()
            res.start()
            ref, tl_ref = res.resolves.ref(), tl.commits.ref()
            verdicts, acks = [None] * n, [None] * n
            logging = flow.NotifiedVersion(0)
            acked = [0]
            watchers = []

            async def readable(i, t_ack):
                await flow.all_of([ss.version.when_at_least(versions[i])
                                   for ss in servers])
                wall["apply"][i] = time.perf_counter() - t_ack

            async def batch(i):
                req = requests[i]
                t0 = time.perf_counter()
                reply = await ref.get_reply(req, proxy)
                wall["resolve"][i] = time.perf_counter() - t0
                ver = list(getattr(reply, "verdicts", reply))
                verdicts[i] = ver
                tagged = tuple(
                    types.TaggedMutation((bisect_right(splits, m.param1),), m)
                    for txn, v in zip(req.transactions, ver)
                    if v == COMMITTED for m in txn.mutations)
                await logging.when_at_least(i)
                t1 = time.perf_counter()
                done = tl_ref.get_reply(types.TLogCommitRequest(
                    req.prev_version, req.version, tagged, acked[0]), proxy)
                logging.set(i + 1)
                acks[i] = await done
                t2 = time.perf_counter()
                wall["tlog"][i] = t2 - t1
                acked[0] = max(acked[0], req.version)
                watchers.append(flow.spawn(readable(i, t2), name="readable"))

            sched.start_task_stats()
            t0 = time.perf_counter()
            pending = []
            for i in range(n):
                pending.append(flow.spawn(batch(i), name="proxy"))
                while len(pending) >= LEG_DEPTH:
                    await pending.pop(0)
            await flow.all_of(pending)
            await flow.all_of(watchers)
            log["stream_s"] = time.perf_counter() - t0
            log["tasks"] = {r["task"]: r["busy_us"] / 1e6 for r in
                            sched.task_stats_report()["tasks"]}
            res.stop()
            log["verdicts"], log["acks"] = verdicts, acks
            # the durability the lag allows: every server durable at
            # min(its version - lag, the log set's known committed)
            deadline = flow.now() + LEG_WAIT
            for ss in servers:
                target = min(ss.version.get() - ss._lag, tl.known_committed)
                while ss.durable_version.get() < target:
                    if flow.now() > deadline:
                        raise AssertionError(
                            f"commit leg: {ss.name} durable at "
                            f"{ss.durable_version.get()} < {target}")
                    await flow.delay(
                        flow.SERVER_KNOBS.storage_commit_interval)
            await flow.delay(1.0)
            log["durable"] = [ss.durable_version.get() for ss in servers]
            log["log_left"] = list(tl._versions)
            t0 = time.perf_counter()
            log["reads"] = await read_back(servers, read_at)
            log["reads_s"] = time.perf_counter() - t0
            # the power loss, then the roles booted anew on the disks
            for m in ["tlog"] + [f"storage{i}" for i in range(n_tags)]:
                net.kill_machine(m)
            t0 = time.perf_counter()
            tl, servers = boot()
            await tl.recovered()
            await flow.timeout_error(flow.all_of(
                [ss.version.when_at_least(versions[-1]) for ss in servers]),
                LEG_WAIT)
            log["recovery_s"] = time.perf_counter() - t0
            log["recovered_durable"] = [ss.durable_version.get()
                                        for ss in servers]
            log["recovered"] = await read_back(servers, read_at)
            return True

        task = sched.spawn(run(), name="leg")
        sched.run(until=task, timeout_time=1e9)
        sched.stop_task_stats()
        task.get()
    finally:
        flow.set_scheduler(None)
    committed = sum(v.count(COMMITTED) for v in log["verdicts"])
    model = leg_model(requests, log["verdicts"], COMMITTED, n - 1)
    older = leg_model(requests, log["verdicts"], COMMITTED, read_at)
    want = sorted(model.items())
    want_points = [older.get(k) for k in sample]
    for what in ("reads", "recovered"):
        pages, points = log[what]
        got = [kv for rows in pages for kv in rows]
        if got != want:
            raise AssertionError(
                f"commit leg {what}: {len(got)} rows read at the last "
                f"version, {len(want)} in the model, "
                f"{sum(a != b for a, b in zip(got, want))} differ")
        for i, rows in enumerate(pages):
            if rows and (rows[0][0] < bounds[i] or (
                    bounds[i + 1] is not None and rows[-1][0] >= bounds[i + 1])):
                raise AssertionError(f"commit leg {what}: shard {i} "
                                     "answered outside its range")
        if points != want_points:
            raise AssertionError(
                f"commit leg {what}: {sum(a != b for a, b in zip(points, want_points))} "
                f"of {len(sample)} point reads at batch {read_at} differ "
                "from the model")
    return {"log": {k: log[k] for k in ("verdicts", "acks", "durable",
                                        "log_left", "reads", "recovered",
                                        "recovered_durable")},
            "wall": wall, "tasks": log["tasks"],
            "stream_s": log["stream_s"],
            "reads_s": log["reads_s"], "recovery_s": log["recovery_s"],
            "resolver": res, "committed": committed, "rows": len(want),
            "sample": len(sample)}


# -- the whole cluster --------------------------------------------------

# FDB 6.1's default role counts (fdbclient/Knobs.cpp DEFAULT_AUTO_PROXIES,
# DEFAULT_AUTO_LOGS, DEFAULT_AUTO_RESOLVERS) in `double` mode (teams of
# 2) on the memory engine, over 4 storage teams, durable
CLUSTER_LAYOUT = {"n_proxies": 3, "n_logs": 3, "n_resolvers": 1,
                  "n_storage": 4, "storage_replicas": 2, "durable": True}
CLUSTER_KEY_BYTES = 16
CLUSTER_RETRIES = 100     # a transaction's attempts before it gives up
CLUSTER_PAGE_ROWS = 1000


def cluster_package():
    """The port's modules under the names `cluster_run` reads."""
    from . import flow
    from .client import run_transaction
    from .server import SimCluster
    from .server.chaos import database_digest
    from .server.types import ADD_VALUE
    return SimpleNamespace(flow=flow, SimCluster=SimCluster,
                           run_transaction=run_transaction,
                           database_digest=database_digest,
                           ADD_VALUE=ADD_VALUE)


def cluster_keys(ids, key_bytes: int, n_ids: int) -> list:
    """Keys of integer ids in [0, n_ids): the id spread uniformly over
    the first 8 bytes below b"\\xff" (so the default first-byte storage
    and resolver splits divide the ids evenly), big-endian, then zero
    bytes to `key_bytes`."""
    step = np.uint64((0xFF << 56) // n_ids)
    raw = (np.asarray(ids, np.uint64) * step).astype(">u8").tobytes()
    pad = bytes(key_bytes - 8)
    return [raw[j:j + 8] + pad for j in range(0, len(raw), 8)]


def cluster_ops(seed: int, n_clients: int, n_txns: int, n_ids: int,
                key_bytes: int, mixed: bool) -> list:
    """Each client's transactions, drawn by numpy from `seed`: ("rmw",
    read key, write key), a point read and a point write of ids uniform
    over n_ids. With `mixed`, client 0's second transaction clears the
    range between its two keys and client 1's (the last client's, with
    one) third adds 1 to its write key's 8-byte little-endian value."""
    ids = np.random.default_rng(seed).integers(
        0, n_ids, size=(n_clients, n_txns, 2), dtype=np.int64)
    keys = cluster_keys(ids.reshape(-1), key_bytes, n_ids)
    ops = [[("rmw", keys[2 * (c * n_txns + j)],
             keys[2 * (c * n_txns + j) + 1]) for j in range(n_txns)]
           for c in range(n_clients)]
    if mixed:
        if n_txns > 1:
            _k, a, b = ops[0][1]
            ops[0][1] = ("clear", min(a, b), max(a, b))
        if n_txns > 2:
            c = min(1, n_clients - 1)
            ops[c][2] = ("add", None, ops[c][2][2])
    return ops


def _add_le(value, delta: int) -> bytes:
    """ADD_VALUE of an 8-byte little-endian operand (the stored value
    cut or zero-padded to the operand's length)."""
    cur = int.from_bytes((value or b"")[:8].ljust(8, b"\x00"), "little")
    return ((cur + delta) % (1 << 64)).to_bytes(8, "little")


def cluster_model(outcomes) -> dict:
    """The plain model: the committed transactions applied in
    versionstamp order (commit version, then the proxy's batch order)."""
    model = {}
    done = sorted((o for o in outcomes if isinstance(o[3], bytes)),
                  key=lambda o: o[3])
    for _c, _j, op, _vs, written in done:
        kind, a, b = op
        if kind == "rmw":
            model[b] = written
        elif kind == "clear":
            for k in [k for k in model if a <= k < b]:
                del model[k]
        else:
            model[b] = _add_le(model.get(b), 1)
    return model


def cluster_run(P, backend: str, seed: int, n_clients: int, n_txns: int,
                n_ids: int, *, key_bytes: int = CLUSTER_KEY_BYTES,
                kill_at=None, retry: bool = True, mixed: bool = False,
                buggify: bool = False, cluster_kwargs=None,
                on_cluster=None) -> dict:
    """A seeded client workload on a SimCluster of package `P`
    (attributes flow, SimCluster, run_transaction, database_digest,
    ADD_VALUE; `cluster_package()` for the port): `SimCluster(seed,
    conflict_backend=backend, buggify=buggify, **CLUSTER_LAYOUT,
    **cluster_kwargs)` and `n_clients` clients, each running its
    `cluster_ops` transactions one after another, all clients at once.
    A transaction's attempt reads its read key and writes its write key
    to the last 8 bytes of what it read, then "|client.txn.attempt"
    (the clear and the add of `mixed` read nothing). With `retry` a
    failed attempt goes through `on_error` (the retry loop of
    `run_transaction`, whose commit it times) up to CLUSTER_RETRIES
    times; without it each transaction makes one attempt. At client 0's
    transaction `kill_at` the worker that holds the resolver is
    killed, and the run notes when the next epoch is fully recovered.

    After the workload: `database_digest` of the user keyspace, the
    keyspace itself (paged), the epoch, and the status document. Unless
    some transaction ended in commit_unknown_result, the keyspace must
    equal `cluster_model` of the outcomes: every acknowledged write is
    there, and no write of a failed attempt (AssertionError otherwise).
    `on_cluster(cluster)` runs after the cluster is built.

    Returns {"outcomes": (client, txn, versionstamp or error name) in
    the order they completed, "digest", "epoch", "kill_epoch",
    "status", "committed", "latency": (virtual s, wall s) a commit,
    "kill": (virtual, wall) at the kill, "recovered": (virtual, wall)
    when the next epoch was fully recovered, "wall_s": the workload's
    wall seconds, "rows": the keyspace's row count, "tasks": the
    scheduler's per-task report when armed}."""
    flow = P.flow
    ops = cluster_ops(seed, n_clients, n_txns, n_ids, key_bytes, mixed)
    c = P.SimCluster(seed=seed, conflict_backend=backend, buggify=buggify,
                     **CLUSTER_LAYOUT, **(cluster_kwargs or {}))
    out = {"latency": [], "kill": None, "recovered": None}
    written, rows = [], []
    try:
        if on_cluster is not None:
            on_cluster(c)
        dbs = [c.client(f"client{i}") for i in range(n_clients)]

        async def recovered(epoch):
            var = c.cc.dbinfo
            while not (var.get().epoch > epoch and
                       var.get().recovery_state == "fully_recovered"):
                await var.on_change()
            out["recovered"] = (flow.now(), time.perf_counter())

        async def client(ci):
            db = dbs[ci]
            for j, op in enumerate(ops[ci]):
                if ci == 0 and j == kill_at:
                    out["kill"] = (flow.now(), time.perf_counter())
                    out["kill_epoch"] = c.cc.dbinfo.get().epoch
                    flow.spawn(recovered(out["kill_epoch"]),
                               name="recovered")
                    c.kill_role("resolver")
                kind, a, b = op
                tr = db.create_transaction()
                result, value = None, None
                for attempt in range(CLUSTER_RETRIES if retry else 1):
                    try:
                        if kind == "rmw":
                            cur = await tr.get(a)
                            value = ((cur or b"")[-8:]
                                     + b"|%d.%d.%d" % (ci, j, attempt))
                            tr.set(b, value)
                        elif kind == "clear":
                            tr.clear_range(a, b)
                        else:
                            tr.atomic_op(b, _add_le(None, 1), P.ADD_VALUE)
                        t0, w0 = flow.now(), time.perf_counter()
                        await tr.commit()
                        out["latency"].append((flow.now() - t0,
                                               time.perf_counter() - w0))
                        result = tr.get_versionstamp()
                        break
                    except flow.FdbError as e:
                        result = e.name
                        if not retry:
                            break
                        try:
                            await tr.on_error(e)
                        except flow.FdbError as e2:
                            result = e2.name
                            break
                written.append((ci, j, op, result, value))

        async def read_keyspace(db):
            cursor = b""
            while True:
                async def page(tr, cursor=cursor):
                    return await tr.get_range(cursor, b"\xff",
                                              limit=CLUSTER_PAGE_ROWS)
                got = await P.run_transaction(db, page, max_retries=500)
                rows.extend(got)
                if len(got) < CLUSTER_PAGE_ROWS:
                    return
                cursor = got[-1][0] + b"\x00"

        async def main():
            t0 = time.perf_counter()
            await flow.wait_for_all([flow.spawn(client(i), name=f"client{i}")
                                     for i in range(n_clients)])
            out["wall_s"] = time.perf_counter() - t0
            if c.sched.task_stats_armed:
                out["tasks"] = c.sched.task_stats_report()
            out["digest"] = await P.database_digest(dbs[0])
            await read_keyspace(dbs[0])
            out["status"] = await dbs[0].get_status()
            return True

        c.run(main(), timeout_time=1e6)
        out["epoch"] = c.cc.dbinfo.get().epoch
    finally:
        c.shutdown()
    out["outcomes"] = [(ci, j, result) for ci, j, _op, result, _v in written]
    out["committed"] = sum(isinstance(o[2], bytes) for o in out["outcomes"])
    if not any(o[3] == "commit_unknown_result" for o in written):
        model = cluster_model(written)
        got = dict(rows)
        if got != model:
            diff = sorted(set(got) ^ set(model)) + sorted(
                k for k in set(got) & set(model) if got[k] != model[k])
            raise AssertionError(
                f"cluster run: {len(got)} rows read back, {len(model)} in "
                f"the model of the outcomes, {len(diff)} differ, first "
                f"{diff[:3]}")
    out["rows"] = len(rows)
    return out


# -- the simulation tester: a contention storm and a region failover ----

# the reference smoke's contention cell (tools/smoke.py:625-700): 4
# client handles, 150 arrivals a virtual second on 2 hot keys, each a
# read-modify-write through a bounded retry loop, on a durable cluster
CONTENTION_SEED = 8383
CONTENTION_CLIENTS = 4
CONTENTION_RATE = 150.0
CONTENTION_HOT_KEYS = 2
# test_region.py's failover shape: 40 writes over both halves of the
# keyspace, the router caught up to the 30th, then a primary blackout
REGION_SEED = 801
REGION_WRITES = 40
REGION_SHIPPED = 30
REGION_TIMEOUT = 900.0   # virtual s, test_region.py's bound
# the stats fields that read the host's clock (`sim_perf_report`'s wall
# budget, and the task-stats tables when those are armed): they differ
# from run to run in either package, the rest of a storm's stats not
WALL_FIELDS = ("wall_seconds", "sim_per_wall", "tasks_per_wall_sec",
               "top_tasks", "priority_bands")


def tester_package():
    """The port's modules under the names `contention_run` and
    `region_run` read."""
    from . import flow
    from .client import run_transaction
    from .server import SimCluster
    from .server.chaos import database_digest
    from .server.consistency import check_consistency
    from .server.dbinfo import FULLY_RECOVERED
    from .server.region import RemoteRegion
    from .server.workloads import ContentionStorm
    return SimpleNamespace(flow=flow, SimCluster=SimCluster,
                           run_transaction=run_transaction,
                           database_digest=database_digest,
                           check_consistency=check_consistency,
                           FULLY_RECOVERED=FULLY_RECOVERED,
                           RemoteRegion=RemoteRegion,
                           ContentionStorm=ContentionStorm)


def sim_stats(stats: dict) -> dict:
    """A storm's stats without the fields that read the host's clock."""
    out = dict(stats)
    out["sim_perf"] = {k: v for k, v in stats["sim_perf"].items()
                       if k not in WALL_FIELDS}
    return out


def contention_run(P, backend: str, seed: int, on: bool, duration: float,
                   *, cluster_kwargs=None, on_cluster=None) -> dict:
    """The reference smoke's contention cell on package `P` (attributes
    of `tester_package()`): `SimCluster(seed, durable=True,
    conflict_backend=backend, **cluster_kwargs)`, then the conflict
    scheduler, the client conflict windows and transaction repair all
    on or all off (`on`), set after the cluster re-initialized the
    knobs as the smoke sets them, and a `ContentionStorm` of `duration`
    virtual seconds over CONTENTION_CLIENTS handles. After it: the hot keys'
    total, which must lie in [committed, committed + unknown] (every
    committed transaction added exactly 1; an unknown outcome may or
    may not have), `check_consistency` of the cluster, `database_digest`
    and the status document. `on_cluster(cluster)` runs after the
    cluster is built. The knobs are reset after the run.

    Returns {"stats" (the storm's), "total", "consistency", "digest",
    "status", "epoch", "wall_s" (the storm's wall seconds), "tasks"
    (the scheduler's per-task report when armed)}."""
    flow = P.flow
    c = P.SimCluster(seed=seed, durable=True, conflict_backend=backend,
                     **(cluster_kwargs or {}))
    flow.SERVER_KNOBS.set("conflict_scheduling", int(on))
    flow.SERVER_KNOBS.set("client_conflict_windows", int(on))
    flow.SERVER_KNOBS.set("txn_repair", int(on))
    flow.SERVER_KNOBS.set("sched_hot_push_interval", 0.05)
    out = {}
    try:
        if on_cluster is not None:
            on_cluster(c)
        dbs = [c.client(f"cont{i}") for i in range(CONTENTION_CLIENTS)]

        async def main():
            storm = P.ContentionStorm(dbs, flow.g_random, duration=duration,
                                      rate=CONTENTION_RATE,
                                      hot_keys=CONTENTION_HOT_KEYS)
            t0 = time.perf_counter()
            stats = await storm.run()
            out["wall_s"] = time.perf_counter() - t0
            if c.sched.task_stats_armed:
                out["tasks"] = c.sched.task_stats_report()
            total = await storm.read_hot_total(dbs[0])
            if not stats["committed"] <= total <= \
                    stats["committed"] + stats["unknown"]:
                raise AssertionError(f"contention run: hot-key total "
                                     f"{total} outside the oracle {stats}")
            out.update(stats=stats, total=total)
            out["consistency"] = await P.check_consistency(c)
            out["digest"] = await P.database_digest(dbs[0])
            out["status"] = await dbs[0].get_status()
            return True

        c.run(main(), timeout_time=1e6)
        out["epoch"] = c.cc.dbinfo.get().epoch
    finally:
        flow.reset_server_knobs(randomize=False)
        c.shutdown()
    return out


def _region_key(i: int) -> bytes:
    # alternate halves of the keyspace, so the stream feeds both remote
    # shards (split at 0x80)
    return (b"k%03d" if i % 2 else b"\xc8%03d") % i


def region_run(P, backend: str, seed: int, *, cluster_kwargs=None,
               on_blackout=None) -> dict:
    """`tests/test_region.py`'s failover on package `P` (attributes of
    `tester_package()`): `SimCluster(seed, durable=True,
    auto_reboot=False, n_coordinators=5, n_storage=2,
    conflict_backend=backend, **cluster_kwargs)`; a `RemoteRegion`
    attached (a recovery), REGION_WRITES writes, a concurrent writer
    that never stops, the router caught up to the REGION_SHIPPED-th
    write, then a blackout of every primary process and two
    coordinators, and `promote()`: a recovery in the second DC that
    recruits its own master, resolver, proxies and logs. Through the
    promoted region: every write at or below the recovery version must
    read back (the others are the advertised lag, which an async region
    may lose), the writer commits 3 more times, `check_consistency`
    and `database_digest`. `on_blackout(cluster)` runs just before the
    blackout; the run fails at virtual time REGION_TIMEOUT.

    Returns {"committed": {key: commit version}, "epoch" (the primary's
    at the blackout), "promoted_epoch", "recovery_version", "survived"
    (the written keys read back), "lost" (those that were not, each
    above the recovery version), "lag" (the router's advertised lag in
    versions at the blackout), "digest", "consistency", "blackout" and
    "recovered": (virtual s, wall s) at the blackout and when the
    promoted epoch was fully recovered}."""
    flow = P.flow
    c = P.SimCluster(seed=seed, durable=True, auto_reboot=False,
                     n_coordinators=5, n_storage=2, conflict_backend=backend,
                     **(cluster_kwargs or {}))
    out = {}
    try:
        db = c.client()

        async def main():
            region = P.RemoteRegion(c)
            await region.start()
            committed = {}
            for i in range(REGION_WRITES):
                tr = db.create_transaction()
                tr.set(_region_key(i), b"v%d" % i)
                committed[_region_key(i)] = await tr.commit()
                if i % 5 == 0:
                    await flow.delay(0.05)

            progress = {"before": 0, "after": 0}
            phase = ["before"]
            stop = [False]

            async def writer():
                n = 0
                while not stop[0]:
                    async def body(tr, n=n):
                        tr.set(b"live-%04d" % n, b"x")
                    await P.run_transaction(db, body, max_retries=100000)
                    progress[phase[0]] += 1
                    n += 1
                    await flow.delay(0.1)

            writer_task = flow.spawn(writer(), name="concurrentWriter")
            target = committed[_region_key(REGION_SHIPPED - 1)]
            deadline = flow.now() + 60
            while region._pushed_to < target:
                if flow.now() >= deadline:
                    raise AssertionError("region run: the router never "
                                         "caught up")
                tr = db.create_transaction()   # nudges known_committed
                tr.set(b"nudge", b"x")
                await tr.commit()
                await flow.delay(0.05)

            if on_blackout is not None:
                on_blackout(c)
            out["epoch"] = c.cc.dbinfo.get().epoch
            out["lag"] = region.lag()
            out["blackout"] = (flow.now(), time.perf_counter())
            for w in list(c.workers.values()):
                if w.process.alive:
                    c.net.kill(w.process)
            c.net.kill(c.cc.process)
            for i, coord in enumerate(c.coordinators):
                if i not in (2, 3, 4) and coord.process.alive:
                    c.net.kill(coord.process)
            phase[0] = "after"

            promoted = await region.promote()
            out["recovered"] = (flow.now(), time.perf_counter())
            info = promoted.cc.dbinfo.get()
            if not (info.epoch > out["epoch"]
                    and info.recovery_state == P.FULLY_RECOVERED):
                raise AssertionError(f"region run: promoted epoch "
                                     f"{info.epoch}, {info.recovery_state}")
            out["promoted_epoch"] = info.epoch
            rv = out["recovery_version"] = promoted.recovery_version
            pdb = promoted.client()

            async def read_all(tr):
                lo = await tr.get_range(b"k", b"l")
                hi = await tr.get_range(b"\xc8", b"\xc9")
                return list(lo) + list(hi)
            rows = dict(await P.run_transaction(pdb, read_all,
                                                max_retries=500))
            out["survived"] = sorted(k for k in committed if k in rows)
            out["lost"] = sorted(k for k in committed if k not in rows)
            for key, v in committed.items():
                want = b"v%d" % int(key[1:])
                if (v <= rv and rows.get(key) != want) or \
                        (key in rows and rows[key] != want):
                    raise AssertionError(f"region run: {key!r} at version "
                                         f"{v} (recovery version {rv}) "
                                         f"reads {rows.get(key)!r}")
            deadline = flow.now() + 120
            while progress["after"] < 3:
                if flow.now() >= deadline:
                    raise AssertionError("region run: the writer never "
                                         "committed after the failover")
                await flow.delay(0.5)
            stop[0] = True
            await flow.catch_errors(writer_task)
            out["committed"] = committed
            out["consistency"] = await P.check_consistency(
                promoted.client("consistency"))
            out["digest"] = await P.database_digest(pdb)
            return True

        c.run(main(), timeout_time=REGION_TIMEOUT)
    finally:
        c.shutdown()
    return out


# -- out of process: a gatewayed cluster and traffic over TCP ------------

class GatewayedCluster:
    """A wall-clock SimCluster of the port whose client surface a
    TcpGateway serves, on a background thread: `with
    GatewayedCluster(seed=..., **cluster_kwargs) as gc:` then dial
    127.0.0.1:gc.port (`client.remote.RemoteCluster`). An error of the
    cluster's thread is raised at `__enter__` when it comes before the
    port, else at `__exit__`."""

    def __init__(self, **kw):
        import queue
        import threading
        self.kw = kw
        self.q = queue.Queue()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._main, daemon=True)
        self.port = None

    def __enter__(self):
        self.thread.start()
        item = self.q.get(timeout=120)
        if isinstance(item, BaseException):
            raise item
        self.port = item
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=120)
        while not self.q.empty():
            item = self.q.get_nowait()
            if isinstance(item, BaseException) and exc == (None, None, None):
                raise item

    def _main(self):
        from . import flow
        from .rpc.gateway import TcpGateway
        from .server.cluster import SimCluster

        gw = None
        c = None
        try:
            c = SimCluster(virtual=False, **self.kw)
            gw = TcpGateway(c.client("gateway-host"))

            async def main():
                gw.start()
                self.q.put(gw.port)
                while not self.stop.is_set():
                    await flow.delay(0.02)

            c.run(main())
        except BaseException as e:  # noqa: BLE001 — surface to the test
            self.q.put(e)
        finally:
            if gw is not None:
                gw.close()
            if c is not None:
                c.shutdown()


def remote_traffic(rc, seed: int, n_clients: int, n_txns: int, n_ids: int,
                   *, key_bytes: int = CLUSTER_KEY_BYTES,
                   tag: bytes = b"") -> dict:
    """`cluster_ops`' transactions (point read-writes, no `mixed`) over
    a `client.remote.RemoteCluster` `rc`: `n_clients` concurrent clients
    on its loop, each running its transactions one after another
    through `run_transaction`'s retry loop. An attempt reads its read
    key and writes its write key to the last 8 bytes of what it read,
    then b"|" + tag + b"client.txn.attempt".

    Returns {"outcomes": (client, txn, op, versionstamp, written) of
    every acknowledged transaction, "model": `cluster_model` of them
    (every acknowledged write, in commit order), "committed",
    "conflicts" (attempts that did not commit), "latency" (wall s from
    the successful attempt's commit call to its acknowledgement, a
    transaction), "wall_s"}."""
    from .client import run_transaction
    ops = cluster_ops(seed, n_clients, n_txns, n_ids, key_bytes, False)
    written, latency = [], []
    attempts = [0]

    async def client(ci):
        for j, (_kind, a, b) in enumerate(ops[ci]):
            tr = rc.db.create_transaction()
            last = {}

            async def body(tr, ci=ci, j=j, a=a, b=b, last=last):
                n = last["attempt"] = last.get("attempt", -1) + 1
                attempts[0] += 1
                cur = await tr.get(a)
                last["value"] = ((cur or b"")[-8:]
                                 + b"|%s%d.%d.%d" % (tag, ci, j, n))
                tr.set(b, last["value"])
                last["t0"] = time.perf_counter()

            await run_transaction(rc.db, body, max_retries=CLUSTER_RETRIES,
                                  tr=tr)
            latency.append(time.perf_counter() - last["t0"])
            written.append((ci, j, ("rmw", a, b), tr.get_versionstamp(),
                            last["value"]))

    async def main():
        from . import flow
        await flow.wait_for_all([flow.spawn(client(i), name=f"client{i}")
                                 for i in range(n_clients)])

    t0 = time.perf_counter()
    rc.call(main(), timeout=3600)
    wall = time.perf_counter() - t0
    return {"outcomes": written, "model": cluster_model(written),
            "committed": len(written), "conflicts": attempts[0] - len(written),
            "latency": latency, "wall_s": wall}


def remote_read_back(rc, model: dict) -> int:
    """Read every key of `model` back over `rc` (a RemoteCluster),
    CLUSTER_PAGE_ROWS keys a transaction; AssertionError at the first
    key whose value differs. Returns the keys read."""
    from . import flow
    from .client import run_transaction
    keys = sorted(model)
    for i in range(0, len(keys), CLUSTER_PAGE_ROWS):
        chunk = keys[i:i + CLUSTER_PAGE_ROWS]

        async def body(tr, chunk=chunk):
            return await flow.wait_for_all([flow.spawn(tr.get(k))
                                            for k in chunk])

        got = rc.call(run_transaction(rc.db, body, max_retries=500),
                      timeout=600)
        for k, v in zip(chunk, got):
            if v != model[k]:
                raise AssertionError(f"read back: {k!r} is {v!r}, the "
                                     f"acknowledged write {model[k]!r}")
    return len(keys)


# -- role hosts: a resolver in its own OS process -----------------------------

ROLE_HOST_CKPT_AT = 4       # the request after which the host checkpoints
ROLE_HOST_KILL_AT = 8       # the SIGKILL comes after this request's reply
ROLE_HOST_CKPT_EVERY = 6.0  # the host's checkpoint period (wall s)
ROLE_HOST_WAIT = 300.0      # wall s a role host or a reply may take
ROLE_HOST_DEPTH = 4         # requests in flight, as a proxy keeps them
ROLE_CLUSTER_RESOLVERS = 2  # the commit pipeline's resolver hosts
ROLE_CLUSTER_WORKERS = 2    # its proxy worker processes
ROLE_CLUSTER_RATE = 400.0   # arrivals a wall s in all (the soak smoke's)
ROLE_CLUSTER_DURATION = 8.0  # wall s of arrivals
ROLE_CLUSTER_KILL_AT = 0.5  # the share of them offered at the kill


def _wall_scheduler():
    from . import flow
    flow.set_seed(0)
    s = flow.Scheduler(virtual=False)
    flow.set_scheduler(s)
    return s


async def _role_status(ext, entry) -> dict:
    """A role host's status document (its own counters and kernel
    launches) over its status token."""
    from . import flow
    from .server.types import STATUS_REQUEST
    return await flow.timeout_error(
        ext._ref(entry, "status").get_reply(STATUS_REQUEST), 60.0)


def role_launches(doc: dict) -> dict:
    """{kernel: launches} from a role host's status document."""
    return {k[len("launches."):]: n
            for k, n in (doc.get("kernels") or {}).items()
            if k.startswith("launches.")}


def role_host_run(requests, replies, run_dir: str, *,
                  backend: str = "cuda", device=None) -> dict:
    """The resolver role in its own OS process (`tools.rolehost`, spawned
    by `clusterbench.RoleProcs` with `device`), recruited over TCP on
    `backend` (the master's init RPC) and sent `requests` (the
    ResolveRequests of a chain from version 0), ROLE_HOST_DEPTH in
    flight. Every reply must equal `replies[i]`, what the in-process
    role answered.

    After request ROLE_HOST_CKPT_AT this process waits for the host's
    checkpoint (the first tick of its ROLE_HOST_CKPT_EVERY period, with
    the pipeline idle); after request ROLE_HOST_KILL_AT the host is sent
    SIGKILL and respawned on its pinned port: it restores the checkpoint
    onto `device` and replays the journal above it (the count is checked
    against the checkpoint file's version). A resend of request
    ROLE_HOST_KILL_AT must return the byte-identical cached payload; the
    requests after it must equal too. AssertionError at the first
    difference.

    Returns {"kill_to_ready_s", "kill_to_reply_s", "replayed",
    "checkpoint_at" (the request the checkpoint covers), "checkpoints",
    "launches" (each incarnation's {kernel: launches}), "batches" (each
    incarnation's resolve batches, replays included), "requests_s" (the
    first incarnation's wall s for its requests)}."""
    import os
    from . import flow
    from .rpc import wire
    from .tools.clusterbench import RoleProcs
    ckpt_at, kill_at = ROLE_HOST_CKPT_AT, ROLE_HOST_KILL_AT
    os.makedirs(run_dir, exist_ok=True)
    roles = RoleProcs(n_resolvers=1, run_dir=run_dir,
                      state_root=os.path.join(run_dir, "state"),
                      backend=backend, device=device,
                      checkpoint_every=ROLE_HOST_CKPT_EVERY)
    ext = None
    got = {}

    def check(i, reply):
        if reply != replies[i]:
            raise AssertionError(f"role host: reply {i} differs from the "
                                 "in-process role's")
        got[i] = reply

    async def send(resolves, indices):
        """`requests[i]` for i in `indices`, ROLE_HOST_DEPTH in flight;
        each reply checked in order."""
        pending = []
        for i in indices:
            pending.append((i, resolves.get_reply(requests[i])))
            while len(pending) >= ROLE_HOST_DEPTH or \
                    (pending and i == indices[-1]):
                j, fut = pending.pop(0)
                check(j, await flow.timeout_error(fut, ROLE_HOST_WAIT))

    try:
        roles.spawn_all().wait_ready(timeout=ROLE_HOST_WAIT)
        entry = roles.ready[("resolver", 0)]
        s = _wall_scheduler()
        ext = roles.external_roles()
        out = {}

        async def first():
            resolves, _m, _h = await flow.timeout_error(flow.spawn(
                ext.recruit_resolver(0, "role-host-r0", 0, backend)),
                ROLE_HOST_WAIT)
            t0 = time.perf_counter()
            await send(resolves, list(range(ckpt_at + 1)))
            secs = time.perf_counter() - t0
            deadline = time.perf_counter() + ROLE_HOST_WAIT
            while (await _role_status(ext, entry))[
                    "counters"]["checkpoints"] < 1:
                if time.perf_counter() > deadline:
                    raise AssertionError("role host: no checkpoint")
                await flow.delay(0.05)
            t0 = time.perf_counter()
            await send(resolves, list(range(ckpt_at + 1, kill_at + 1)))
            out["requests_s"] = secs + time.perf_counter() - t0
            return await _role_status(ext, entry)

        before = s.run(until=s.spawn(first()),
                       timeout_time=flow.now() + 4 * ROLE_HOST_WAIT)
        t_kill = time.perf_counter()
        roles.kill("resolver", 0)
        with open(os.path.join(run_dir, "state", "ext-resolver-0",
                               "ckpt.bin"), "rb") as fh:
            ck_version = wire.from_bytes(fh.read(), None)["version"]
        covered = [i for i in range(kill_at + 1)
                   if requests[i].version <= ck_version]
        roles.respawn("resolver", 0)
        roles.wait_ready(timeout=ROLE_HOST_WAIT)
        out["kill_to_ready_s"] = time.perf_counter() - t_kill
        entry = roles.ready[("resolver", 0)]

        async def second():
            resolves = ext._ref(entry, "resolves")
            resend = await flow.timeout_error(
                resolves.get_reply(requests[kill_at]), ROLE_HOST_WAIT)
            out["kill_to_reply_s"] = time.perf_counter() - t_kill
            if wire.to_bytes(resend) != wire.to_bytes(got[kill_at]):
                raise AssertionError("role host: the resend of request "
                                     f"{kill_at} is not the cached payload")
            await send(resolves, list(range(kill_at + 1, len(requests))))
            return await _role_status(ext, entry)

        after = s.run(until=s.spawn(second()),
                      timeout_time=flow.now() + 4 * ROLE_HOST_WAIT)
    finally:
        if ext is not None:
            ext.close()
        roles.terminate_all()
        flow.set_scheduler(None)
    replayed = after["counters"]["replayed"]
    if replayed != kill_at + 1 - len(covered) or not covered:
        raise AssertionError(
            f"role host: replayed {replayed} requests; the checkpoint "
            f"covers requests 0-{len(covered) - 1} of 0-{kill_at}")
    out.update(
        replayed=replayed, checkpoint_at=len(covered) - 1,
        checkpoints=before["counters"]["checkpoints"],
        launches=[role_launches(before), role_launches(after)],
        batches=[kill_at + 1, replayed + len(requests) - kill_at - 1])
    return out


def role_cluster_procs(run_dir: str, *, backend: str = "cuda",
                       device=None):
    """`role_cluster_run`'s role hosts, spawned (not waited for): a caller
    may start them early so that their start-up overlaps other work."""
    import os
    from .tools.clusterbench import RoleProcs
    os.makedirs(run_dir, exist_ok=True)
    return RoleProcs(n_resolvers=ROLE_CLUSTER_RESOLVERS, n_tlogs=1,
                     run_dir=run_dir,
                     state_root=os.path.join(run_dir, "state"),
                     backend=backend, device=device).spawn_all()


def role_cluster_run(run_dir: str, *, backend: str = "cuda", device=None,
                     roles=None) -> dict:
    """The commit pipeline with its resolvers and its log in other OS
    processes (`clusterbench.run_tcp_cell(role_processes=True)`'s
    shape): ROLE_CLUSTER_RESOLVERS resolver role hosts and one tlog role
    host (`RoleProcs`, `device` handed to each), a wall-clock SimCluster
    on `backend` with one proxy, one storage server and
    `cc.external_roles` attached before its first epoch, and
    ROLE_CLUSTER_WORKERS proxy worker processes (`clusterbench
    --worker`) that fetch the gateway's peer describe, build their own
    Proxy over TCP and send ROLE_CLUSTER_RATE arrivals a wall s in all
    for ROLE_CLUSTER_DURATION s, each a read-write of its own key.
    `roles`: the role hosts from `role_cluster_procs` (spawned here when
    None). Resolver host 0 is sent SIGKILL once ROLE_CLUSTER_KILL_AT of
    the arrivals are offered (halfway) and respawned on its pinned
    port.

    Checks (AssertionError): every arrival commits (a conflict, a
    too-old or an error is a divergence); after the kill, commits
    resume within CHAOS_RECOVERY_BOUND (`kill_to_commit_s`, None when
    every arrival had committed before the respawn was ready); every
    acknowledged write is read back afterwards (each worker's keys
    0..committed-1, once each).

    Returns {"committed", "offered", "elapsed" (wall s of the
    workers' arrivals and drain), "txn_per_s", "commit" (each worker's
    latency percentiles, ms), "kill_to_ready_s", "kill_to_commit_s",
    "launches" ({host name: {kernel: launches}}, resolver host 0's
    first incarnation as "<name> before the kill"), "read_back"}."""
    import json
    import os
    import subprocess
    import sys
    import threading
    from . import flow
    from .client import run_transaction
    from .rpc.gateway import TcpGateway
    from .rpc.tcp import TcpTransport
    from .server import SimCluster
    from .server import dbinfo as dbi
    from .server.types import STATUS_REQUEST
    from .tools.exporter import read_proc_files
    n_res = ROLE_CLUSTER_RESOLVERS
    rate, duration = ROLE_CLUSTER_RATE, ROLE_CLUSTER_DURATION
    if roles is None:
        roles = role_cluster_procs(run_dir, backend=backend, device=device)
    cluster = gw = ext = probe = None
    results, errors = [], []
    out = {"launches": {}, "kill_to_commit_s": None}
    try:
        roles.wait_ready(timeout=ROLE_HOST_WAIT)
        cluster = SimCluster(seed=0, virtual=False, n_proxies=1,
                             n_resolvers=n_res, n_storage=1, n_logs=1,
                             conflict_backend=backend, device=device)
        ext = roles.external_roles()
        cluster.cc.external_roles = ext
        gw = TcpGateway(cluster.client("rolegw"), cluster=cluster)
        probe = TcpTransport()
        bound = float(flow.SERVER_KNOBS.chaos_recovery_bound)

        def run_worker(idx: int) -> None:
            cfg = {"host": "127.0.0.1", "port": gw.port,
                   "seed": 1000 * (idx + 1), "index": idx,
                   "duration": duration,
                   "rate": rate / ROLE_CLUSTER_WORKERS,
                   "run_dir": run_dir, "trace": 0,
                   "trace_roll_size":
                       int(flow.SERVER_KNOBS.trace_roll_size),
                   "sample_every": 0, "commit_cost": 0.0,
                   "batch_cap": 0, "max_inflight": 2048}
            try:
                p = subprocess.run(
                    [sys.executable, "-m",
                     "foundationdb_tpu_torch.tools.clusterbench",
                     "--worker", json.dumps(cfg)],
                    capture_output=True, text=True,
                    timeout=duration + ROLE_HOST_WAIT)
                lines = [ln for ln in p.stdout.splitlines() if ln.strip()]
                if p.returncode != 0 or not lines:
                    errors.append(f"worker {idx}: rc={p.returncode} "
                                  f"stderr={p.stderr[-2000:]}")
                    return
                results.append(json.loads(lines[-1]))
            except Exception as e:  # noqa: BLE001 — collected, reported
                errors.append(f"worker {idx}: {e!r}")

        async def worker_counts() -> dict:
            """{worker role: counters} over each worker's status token
            (all asked at once), or from its result once it has
            exited."""
            docs = {f"proxy-{r['index']}": r for r in list(results)}

            async def ask(stub):
                ref = probe.ref(stub["host"], int(stub["port"]),
                                int(stub["status_token"]))
                try:
                    doc = await flow.timeout_error(
                        ref.get_reply(STATUS_REQUEST), 5.0)
                    docs.setdefault(stub["role"], doc.get("counters") or {})
                except flow.FdbError:
                    pass

            await flow.wait_for_all([
                flow.spawn(ask(stub)) for stub in read_proc_files(run_dir)
                if stub.get("role", "").startswith("proxy-")
                and stub["role"] not in docs])
            return docs

        def committed(counts) -> int:
            return sum(c.get("committed", 0) for c in counts.values())

        async def kill_at_half() -> None:
            # ROLE_CLUSTER_KILL_AT of the arrivals offered (half: the
            # other half arrive while resolver host 0 is down, however
            # late the workers started), or every worker done
            while len(results) < ROLE_CLUSTER_WORKERS:
                counts = await worker_counts()
                if len(counts) == ROLE_CLUSTER_WORKERS and sum(
                        c.get("offered", 0) for c in counts.values()) \
                        >= ROLE_CLUSTER_KILL_AT * rate * duration:
                    break
                await flow.delay(0.05)
            entry = roles.ready[("resolver", 0)]
            doc = await _role_status(ext, entry)
            out["launches"][f"{entry['name']} before the kill"] = \
                role_launches(doc)
            # no batch resolves without resolver 0 (a proxy sends every
            # batch to every resolver), and the respawn serves none
            # before it writes its ready file: the first advance past
            # the last count taken before that file's time is the
            # pipeline committing again (the commits that land during
            # the outage were resolved before the kill)
            samples = [(time.time(), committed(await worker_counts()))]
            t_kill = time.perf_counter()
            roles.kill("resolver", 0)
            roles.respawn("resolver", 0)
            ready_path = os.path.join(run_dir,
                                      f"ready.{entry['name']}.json")
            while roles.check_ready("resolver", 0) is None:
                if time.perf_counter() - t_kill > ROLE_HOST_WAIT:
                    raise AssertionError("role cluster: the respawn is "
                                         "not ready")
                samples.append((time.time(),
                                committed(await worker_counts())))
                await flow.delay(0.05)
            out["kill_to_ready_s"] = time.perf_counter() - t_kill
            t_ready = os.stat(ready_path).st_mtime
            stalled = max(n for t, n in samples if t < t_ready)
            while True:
                counts = await worker_counts()
                if committed(counts) > stalled:
                    out["kill_to_commit_s"] = time.perf_counter() - t_kill
                    return
                if len(results) == ROLE_CLUSTER_WORKERS:
                    return     # every arrival committed before the kill
                if time.perf_counter() - t_kill > bound:
                    raise AssertionError(
                        f"role cluster: no commit {bound} s after the kill "
                        f"(ready after {out['kill_to_ready_s']:.3f} s, "
                        f"{stalled} committed before)")
                await flow.delay(0.05)

        async def read_back(db) -> dict:
            """Every worker's keys, by index, from a scan of the whole
            keyspace (the lead byte is random, \\xff included). A blind
            write through the host's own proxy first: its read versions
            know only its own commits, and this one's version comes
            after every worker's."""
            async def fence(tr):
                tr.set(b"\x00rolegw-fence", b"")
            await run_transaction(db, fence)
            keys, begin = {}, b""
            while True:
                async def page(tr, begin=begin):
                    tr.set_option("read_system_keys")
                    return await tr.get_range(begin, b"\xff\xff",
                                              limit=CLUSTER_PAGE_ROWS)
                rows = await run_transaction(db, page, max_retries=500)
                for k, v in rows:
                    if k[1:4] == b"sb/":
                        idx, i = k[4:].split(b"/", 1)
                        if v != b"v":
                            raise AssertionError(f"read back: {k!r} is {v!r}")
                        keys.setdefault(int(idx), []).append(int(i))
                if len(rows) < CLUSTER_PAGE_ROWS:
                    return keys
                begin = rows[-1][0] + b"\x00"

        async def main():
            gw.start()
            probe.start()
            while cluster.cc.dbinfo.get().recovery_state != \
                    dbi.FULLY_RECOVERED:
                await flow.delay(0.05)
            threads = [threading.Thread(target=run_worker, args=(i,),
                                        daemon=True)
                       for i in range(ROLE_CLUSTER_WORKERS)]
            for t in threads:
                t.start()
            killer = flow.spawn(kill_at_half())
            while any(t.is_alive() for t in threads):
                if killer.is_ready:
                    killer.get()   # raise its failure at once
                await flow.delay(0.1)
            await killer
            for kind, i in roles.keys:
                entry = roles.ready[(kind, i)]
                out["launches"][entry["name"]] = role_launches(
                    await _role_status(ext, entry))
            return await read_back(cluster.client("readback"))

        found = cluster.run(main(), timeout_time=flow.now()
                            + 4 * ROLE_HOST_WAIT + duration)
        if errors:
            raise AssertionError("role cluster: " + "; ".join(errors))
    finally:
        if probe is not None:
            probe.close()
        if gw is not None:
            gw.close()
        if ext is not None:
            ext.close()
        if cluster is not None:
            cluster.shutdown()
        roles.terminate_all()
        flow.set_scheduler(None)
    for r in results:
        lost = {k: r[k] for k in ("shed", "conflicted", "too_old", "errors")
                if r[k]}
        if lost or r["committed"] != r["offered"]:
            raise AssertionError(f"role cluster: worker {r['index']} "
                                 f"committed {r['committed']} of "
                                 f"{r['offered']}: {lost}")
        if sorted(found.get(r["index"], ())) != list(range(r["committed"])):
            raise AssertionError(f"role cluster: worker {r['index']}'s "
                                 "acknowledged writes not all read back")
    elapsed = max(r["elapsed"] for r in results)
    committed = sum(r["committed"] for r in results)
    out.update(committed=committed,
               offered=sum(r["offered"] for r in results),
               elapsed=elapsed, txn_per_s=committed / elapsed,
               commit=[r["commit"] for r in sorted(
                   results, key=lambda r: r["index"])],
               read_back=sum(len(v) for v in found.values()))
    return out
