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
"""

from __future__ import annotations

import random

import numpy as np

VDEAD = -(1 << 30)
INF = np.uint32(0xFFFFFFFF)
COMMIT, OLDEST = 70, 20
KINDS = ("duplicates", "empty_inverted", "inf_rows", "no_valid_writes",
         "chain", "mixed", "split_edges", "clip_edges")
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
