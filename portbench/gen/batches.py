"""The one batch generator: a pool of pre-encoded resolver batches.

A configuration gives the keys (their format, the keyspace) and the
transaction's shape; a traffic mix gives how keys are drawn, the batch
size and the snapshot lags. Everything comes from one seed, so the
same seed gives the same pool.

Key formats:

  fixed16  the upstream conflict-set microbench's keys
           (fdbserver/SkipList.cpp:1412-1551, as the port's bench.py):
           16 bytes, the id big-endian in the low 8. A range's end is
           key + b"\\x00": the same words with length word 17.
  ycsb     YCSB's `"user" + fnvhash64(keynum)` in decimal
           (insertorder=hashed), at most 23 bytes, zero-padded to the
           key width; the end key key + b"\\x00" is the same words with
           length + 1.

Distributions of the key number over [0, keyspace):

  uniform             numpy's uniform integers
  scrambled_zipfian   YCSB's ScrambledZipfianGenerator: a Zipfian rank
                      over `items` (Gray et al.'s draw, YCSB's
                      ZipfianGenerator.nextLong with its precomputed
                      zetan), then fnvhash64(rank) % keyspace

Every transaction reads one range and writes one range. Without
`range_ids` in the configuration a range is the point
[key, key + b"\\x00") (`rmw`: the write is the read); with it, a range
is [key(k), key(k + m)), m drawn uniformly from `range_ids` (fixed16
keys only): the unit ranges [key(k), key(k + 1)) tile the keyspace.

Snapshots are the closed loop's (the harness's `Loop`): every
transaction of a batch reads at the newest commit version whose
verdicts the loop has drained, as a GRV would return it. Only the
`edge_probes` transactions of each batch, spread evenly over it, read
elsewhere: at the MVCC window's edge, every second one version inside
it (the oldest version as it stood before the batch) and the others
one version past it (too old). A probe reads the range that the
transaction after its slot wrote one MVCC window of batches earlier,
the oldest writes that still count, so the window's GC is held to its
edge.
"""

from __future__ import annotations

import math

import numpy as np

FNV_OFFSET_BASIS_64 = 0xCBF29CE484222325
FNV_PRIME_64 = 1099511628211
MAX_DIGITS = 19


def fnvhash64(vals: np.ndarray) -> np.ndarray:
    """YCSB's Utils.fnvhash64 on non-negative int64 values: FNV over the
    eight low-first octets, then Math.abs of the signed result."""
    v = np.asarray(vals, np.int64).astype(np.uint64)
    h = np.full(v.shape, FNV_OFFSET_BASIS_64, np.uint64)
    prime = np.uint64(FNV_PRIME_64)
    with np.errstate(over="ignore"):
        for _ in range(8):
            h ^= v & np.uint64(0xFF)
            h *= prime
            v >>= np.uint64(8)
    return np.abs(h.view(np.int64))


def zipfian_ranks(u: np.ndarray, items: int, theta: float,
                  zetan: float) -> np.ndarray:
    """YCSB's ZipfianGenerator.nextLong(items) with base 0, for the
    uniform doubles `u`."""
    alpha = 1.0 / (1.0 - theta)
    zeta2 = 1.0 + 0.5 ** theta
    eta = (1.0 - (2.0 / items) ** (1.0 - theta)) / (1.0 - zeta2 / zetan)
    uz = u * zetan
    ret = (items * np.power(eta * u - eta + 1.0, alpha)).astype(np.int64)
    ret = np.where(uz < 1.0 + 0.5 ** theta, 1, ret)
    return np.where(uz < 1.0, 0, ret)


def draw_keynums(rng, n: int, keyspace: int, dist: dict) -> np.ndarray:
    kind = dist["kind"]
    if kind == "uniform":
        return rng.integers(0, keyspace, size=n, dtype=np.int64)
    if kind == "scrambled_zipfian":
        ranks = zipfian_ranks(rng.random(n), int(dist["items"]),
                              float(dist["theta"]), float(dist["zetan"]))
        return fnvhash64(ranks) % keyspace
    raise ValueError(f"unknown key distribution {kind!r}")


# "0000" .. "9999" as words whose bytes in memory are the ASCII digits
_DIGITS4 = np.array([b"%04d" % i for i in range(10_000)]).view(np.uint32)
_POW10 = np.array([10 ** k for k in range(1, MAX_DIGITS)], np.uint64)


def ycsb_key_bytes(keynums: np.ndarray, width: int):
    """[n, width] uint8 zero-padded `"user" + decimal(fnvhash64(k))` and
    the [n] lengths."""
    if 4 + MAX_DIGITS > width:
        raise ValueError("ycsb keys need a width of 23 bytes or more")
    h = fnvhash64(keynums)
    if (h < 0).any():
        raise ValueError("fnvhash64 gave Long.MIN_VALUE: its key needs a "
                         "sign, which this format does not hold")
    h = h.astype(np.uint64)
    n = h.shape[0]
    ndig = 1 + np.searchsorted(_POW10, h, side="right")
    # the number right-aligned in 20 zero-padded digits, 4 at a time
    padded = np.empty((n, 5), np.uint32)
    q = h.copy()
    for i in range(4, -1, -1):
        padded[:, i] = _DIGITS4[(q % np.uint64(10_000)).astype(np.int64)]
        q //= np.uint64(10_000)
    digits = padded.view(np.uint8).reshape(n, 20)
    out = np.zeros((n, width), np.uint8)
    out[:, :4] = np.frombuffer(b"user", np.uint8)
    # most hashes have 19 digits: copy those columns for every row, then
    # redo the rows of shorter numbers
    out[:, 4:4 + MAX_DIGITS] = digits[:, 20 - MAX_DIGITS:]
    for length in np.unique(ndig[ndig < MAX_DIGITS]).tolist():
        rows = np.flatnonzero(ndig == length)
        out[rows, 4:4 + length] = digits[rows, 20 - length:]
        out[rows, 4 + length:] = 0
    return out, 4 + ndig


def encode_rows(key_bytes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """[n, width] zero-padded key bytes -> the resolver's [n, W+1]
    uint32 rows: big-endian words, then the length."""
    n, width = key_bytes.shape
    words = width // 4
    rows = np.empty((n, words + 1), np.uint32)
    rows[:, :words] = np.ascontiguousarray(key_bytes).view(">u4")
    rows[:, words] = lengths
    return rows


def key_rows(keynums: np.ndarray, config: dict, lengths=None):
    """(begin rows, end rows) of the ranges of `keynums` under the
    configuration's key format: [key(k), key(k + length)) for fixed16
    keys with `lengths`, else the points [key, key + b"\\x00")."""
    fmt = config["key_format"]
    width = int(config["key_bytes"])
    if fmt == "fixed16":
        if width != 16:
            raise ValueError("fixed16 keys are 16 bytes")
        b = fixed16_rows(keynums)
        if lengths is not None:
            return b, fixed16_rows(keynums + lengths)
    elif fmt == "ycsb":
        if lengths is not None:
            raise ValueError("ycsb keys are hashed: no ranges of them")
        kb, key_len = ycsb_key_bytes(keynums, width)
        b = encode_rows(kb, key_len)
    else:
        raise ValueError(f"unknown key format {fmt!r}")
    e = b.copy()
    e[:, -1] += 1
    return b, e


def fixed16_rows(keynums: np.ndarray) -> np.ndarray:
    n = keynums.shape[0]
    b = np.zeros((n, 5), np.uint32)
    b[:, 2] = (keynums >> 32).astype(np.uint32)
    b[:, 3] = (keynums & 0xFFFFFFFF).astype(np.uint32)
    b[:, 4] = 16
    return b


def key_bytes_of(keynums, config: dict) -> list:
    """The raw byte keys of `keynums` (for split keys and tests)."""
    keynums = np.asarray(keynums, np.int64)
    if config["key_format"] == "fixed16":
        return [bytes(8) + int(k).to_bytes(8, "big") for k in keynums]
    kb, lengths = ycsb_key_bytes(keynums, int(config["key_bytes"]))
    return [kb[i, :lengths[i]].tobytes() for i in range(len(keynums))]


def units(config: dict) -> int:
    """Unit ids a range can touch: a range from the keyspace's last key
    runs past it, as the upstream microbench's do."""
    return int(config["keyspace"]) + int(config.get("range_ids", [0, 0])[1])


def window_batches(config: dict, traffic: dict) -> int:
    """Batches whose versions fit in one MVCC window, rounded up."""
    return math.ceil(int(config["mvcc_window_versions"])
                     / int(traffic["version_step"]))


def draw_lengths(rng, n: int, config: dict):
    """Units a range covers: None for points."""
    if "range_ids" not in config:
        return None
    lo, hi = config["range_ids"]
    return rng.integers(lo, hi + 1, size=n, dtype=np.int64)


class Pool:
    """`n_batches` batches of `n` transactions in flat arrays; batch j is
    rows [j*n, (j+1)*n) of each. `rb`/`re` are the reads' begin and end
    rows, `wb`/`we` the writes' (the same arrays when `rmw`);
    `read_id`/`read_len` and `write_id`/`write_len` the ranges in units
    (key numbers; a length of 1 for points); `units` how many unit ids
    the ranges can touch."""

    def __init__(self, config: dict, traffic: dict, seed: int):
        self.n = int(traffic["txns_per_batch"])
        self.window = window_batches(config, traffic)
        self.units = units(config)
        self.n_batches = self.window + int(traffic["pool_past_window"])
        total = self.n * self.n_batches
        rng = np.random.default_rng(int(seed) % (1 << 64))
        keyspace = int(config["keyspace"])
        dist = traffic["distribution"]
        rmw = bool(config["rmw"])
        self.read_id = draw_keynums(rng, total, keyspace, dist)
        self.read_len = draw_lengths(rng, total, config)
        if rmw:
            self.write_id, self.write_len = self.read_id, self.read_len
        else:
            self.write_id = draw_keynums(rng, total, keyspace, dist)
            self.write_len = draw_lengths(rng, total, config)
        self.probe_slots, self.probe_past = self._place_probes(
            int(traffic["edge_probes"]))
        self.rb, self.re = key_rows(self.read_id, config, self.read_len)
        if rmw:
            self.wb, self.we = self.rb, self.re
        else:
            self.wb, self.we = key_rows(self.write_id, config,
                                        self.write_len)
        self.txn_ids = np.arange(self.n, dtype=np.int32)
        self.has_reads = np.ones(self.n, bool)

    def _place_probes(self, count: int):
        """Probe q of batch j reads what slot + 1 wrote in batch
        j - window (mod the pool): the read range, and for `rmw` the
        write with it."""
        slots = (np.arange(count) * (self.n // max(count, 1))).astype(
            np.int64)
        if count and slots[-1] + 1 >= self.n:
            raise ValueError("too many edge probes for the batch")
        n, nb = self.n, self.n_batches
        for j in range(nb):
            src = ((j - self.window) % nb) * n + slots + 1
            dst = j * n + slots
            self.read_id[dst] = self.write_id[src]
            if self.read_len is not None:
                self.read_len[dst] = self.write_len[src]
        past = (np.arange(count) % 2).astype(np.int64)
        return slots, past

    def snapshots(self, read_version: int, edge: int) -> np.ndarray:
        """A batch's snapshots: `read_version` for all but the probes,
        which read at `edge` (the oldest version before the batch) or
        one version below it."""
        snap = np.full(self.n, read_version, np.int64)
        snap[self.probe_slots] = edge - self.probe_past
        return snap

    def batch(self, j: int):
        """Pool batch j's (rb, re, rt, wb, we, wt)."""
        s = slice(j * self.n, (j + 1) * self.n)
        ids = self.txn_ids
        return (self.rb[s], self.re[s], ids, self.wb[s], self.we[s], ids)

    def ids(self, j: int):
        """Pool batch j's ranges in units: (read_id, read_len, write_id,
        write_len), a length None for points."""
        s = slice(j * self.n, (j + 1) * self.n)

        def part(a):
            return None if a is None else a[s]
        return (self.read_id[s], part(self.read_len), self.write_id[s],
                part(self.write_len))
