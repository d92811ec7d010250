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
