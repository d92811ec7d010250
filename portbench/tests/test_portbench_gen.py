"""The batch generator against plain loops."""

import math

import numpy as np
import pytest

from portbench import harness
from portbench.gen import batches as gen


def fnv_loop(val: int) -> int:
    """YCSB's Utils.fnvhash64, line by line, in 64-bit two's complement."""
    h = 0xCBF29CE484222325
    for _ in range(8):
        octet = val & 0xFF
        val >>= 8
        h ^= octet
        h = (h * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    if h >= 1 << 63:
        h -= 1 << 64
    return abs(h)


def zipf_loop(u: float, items: int, theta: float, zetan: float) -> int:
    """YCSB's ZipfianGenerator.nextLong(items), base 0."""
    alpha = 1.0 / (1.0 - theta)
    zeta2 = 1.0 + math.pow(0.5, theta)
    eta = (1 - math.pow(2.0 / items, 1 - theta)) / (1 - zeta2 / zetan)
    uz = u * zetan
    if uz < 1.0:
        return 0
    if uz < 1.0 + math.pow(0.5, theta):
        return 1
    return int(items * math.pow(eta * u - eta + 1, alpha))


def test_fnvhash64_matches_loop():
    vals = [0, 1, 2, 255, 256, 12345678, 9_999_999, 10 ** 10, 2 ** 40 + 7]
    assert gen.fnvhash64(np.array(vals)).tolist() == [fnv_loop(v)
                                                      for v in vals]


def test_zipfian_matches_loop():
    _cell, _cfg, traffic = harness.find_cell("ycsbf-4r.zipf")
    d = traffic["distribution"]
    u = np.random.default_rng(5).random(2000)
    u[:3] = [0.0, 1.0 / d["zetan"], 0.999999]
    got = gen.zipfian_ranks(u, d["items"], d["theta"], d["zetan"])
    want = [zipf_loop(x, d["items"], d["theta"], d["zetan"]) for x in u]
    assert got.tolist() == want
    # the scrambled draw over the record count
    keys = gen.fnvhash64(got) % 10_000_000
    assert keys.tolist() == [fnv_loop(w) % 10_000_000 for w in want]


def test_ycsb_keys_match_string_formatting():
    nums = np.array([0, 1, 7, 123456, 9_999_999] + list(range(200, 400)))
    config = {"key_format": "ycsb", "key_bytes": 24}
    got = gen.key_bytes_of(nums, config)
    assert got == [b"user" + str(fnv_loop(int(k))).encode() for k in nums]
    b, e = gen.key_rows(nums, config)
    for i, k in enumerate(got):
        padded = k + bytes(24 - len(k))
        words = [int.from_bytes(padded[4 * w:4 * w + 4], "big")
                 for w in range(6)]
        assert b[i].tolist() == words + [len(k)]
        assert e[i].tolist() == words + [len(k) + 1]


def test_fixed16_rows():
    b, e = gen.key_rows(np.array([0, 5, (1 << 40) + 3]),
                        {"key_format": "fixed16", "key_bytes": 16})
    assert b.tolist() == [[0, 0, 0, 0, 16], [0, 0, 0, 5, 16],
                          [0, 0, 256, 3, 16]]
    assert (e[:, :4] == b[:, :4]).all() and (e[:, 4] == 17).all()


def test_fixed16_ranges():
    b, e = gen.key_rows(np.array([0, 5]), {"key_format": "fixed16",
                                            "key_bytes": 16},
                        np.array([1, 10]))
    assert b.tolist() == [[0, 0, 0, 0, 16], [0, 0, 0, 5, 16]]
    assert e.tolist() == [[0, 0, 0, 1, 16], [0, 0, 0, 15, 16]]


@pytest.mark.parametrize("cell", ["skiplist-1r.uniform", "ycsbf-4r.zipf"])
def test_same_seed_same_pool(cell):
    _c, config, traffic = harness.find_cell(cell)
    traffic = {**traffic, "txns_per_batch": 64}
    a = gen.Pool(config, traffic, 2 ** 31 + 11)
    b = gen.Pool(config, traffic, 2 ** 31 + 11)
    c = gen.Pool(config, traffic, 2 ** 31 + 12)
    for name in ("read_id", "read_len", "write_id", "write_len", "rb",
                 "re", "wb", "we"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None and y is None) or np.array_equal(x, y)
    assert not np.array_equal(a.read_id, c.read_id)
    assert a.n_batches == a.window + traffic["pool_past_window"]
    assert a.window == math.ceil(config["mvcc_window_versions"]
                                 / traffic["version_step"])
    if "range_ids" in config:
        lo, hi = config["range_ids"]
        assert a.read_len.min() == lo and a.read_len.max() == hi
        assert a.units == config["keyspace"] + hi


def test_edge_probes():
    _c, config, traffic = harness.find_cell("skiplist-1r.uniform")
    traffic = {**traffic, "txns_per_batch": 64, "edge_probes": 4}
    pool = gen.Pool(config, traffic, 2 ** 31 + 3)
    assert pool.probe_slots.tolist() == [0, 16, 32, 48]
    n, nb, w = pool.n, pool.n_batches, pool.window
    for j in (0, 5, nb - 1):
        src = ((j - w) % nb) * n + pool.probe_slots + 1
        dst = j * n + pool.probe_slots
        # a probe reads what the next slot wrote one window earlier
        assert np.array_equal(pool.read_id[dst], pool.write_id[src])
        assert np.array_equal(pool.read_len[dst], pool.write_len[src])
    snap = pool.snapshots(10_000, 500)
    assert snap[pool.probe_slots].tolist() == [500, 499, 500, 499]
    rest = np.delete(snap, pool.probe_slots)
    assert (rest == 10_000).all()


def test_split_keys_are_the_quartiles():
    _c, config, _t = harness.find_cell("ycsbf-4r.zipf")
    n = config["keyspace"]
    kb, lengths = gen.ycsb_key_bytes(np.arange(n), config["key_bytes"])
    keys = np.sort(kb[:, :23].copy().view("S23").ravel())
    assert np.unique(keys).shape[0] == n          # no two records collide
    want = [keys[q * n // 4].decode() for q in (1, 2, 3)]
    assert config["backend_kwargs"]["split_keys"] == want
