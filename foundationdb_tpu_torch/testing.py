"""Seeded adversarial batches for the interval resolve step (K3).

`adversarial_batch(rng, kind, cap, T, R, Wr, n_words)` returns a
canonical history (HK, HV) and one padded batch as the 10 host arrays
the marshaller produces (snapshots, tooOld, rb, re, rtxn, rvalid, wb,
we, wtxn, wvalid), for commit offset COMMIT and oldest offset OLDEST.
Every kind aims at a corner of the step:

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

Transaction ids are non-decreasing with pad slots = T, as every
marshaller lays them out. Numpy only: the tests feed the arrays to the
reference package and the port, and chip_smoke.py to the card.
"""

from __future__ import annotations

import numpy as np

VDEAD = -(1 << 30)
INF = np.uint32(0xFFFFFFFF)
COMMIT, OLDEST = 70, 20
KINDS = ("duplicates", "empty_inverted", "inf_rows", "no_valid_writes",
         "chain", "mixed")


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


def history(rng, cap: int, n_words: int, alphabet: int, n_rows: int):
    """A canonical history: the empty key first, sorted unique rows
    drawn from `alphabet` ids (and the all-0xFF key), +inf / VDEAD
    padding; versions in [-5, 60], a few below the window."""
    ids = rng.integers(0, alphabet, n_rows)
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


def _ranges(rng, kind: str, n: int, n_words: int, alphabet: int):
    """n (begin, end) row pairs for one of the range kinds."""
    special = _special_rows(n_words)
    b = key_rows(rng.integers(0, alphabet, n), n_words)
    e = key_rows(rng.integers(0, alphabet, n), n_words)
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
                      n_words: int, chain: int = 512):
    """(HK, HV, (snap, too_old, rb, re, rtxn, rvalid, wb, we, wtxn,
    wvalid)) for `kind` (see KINDS) at one shape bucket."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    alphabet = 6 if kind == "duplicates" else max(16, 4 * T)
    hk, hv = history(rng, cap, n_words, alphabet, min(cap // 2, 8 * T))
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
    else:
        rb, re = _ranges(rng, kind, R, n_words, alphabet)
        wb, we = _ranges(rng, kind, Wr, n_words, alphabet)
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
