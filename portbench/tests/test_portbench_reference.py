"""The plain reference against a brute-force loop over every pair."""

import numpy as np
import pytest
import torch

from portbench.reference.resolver import BatchShape, Reference, brute_force


def random_batches(seed, n_batches, n, units, rmw, step, window, lag_max,
                   longest=1):
    """(reference arguments, brute-force arguments) a batch: ranges of 1
    to `longest` units over `units`, snapshots 1 to `lag_max` batches
    back, versions that cross 2^30 as the program re-bases."""
    rng = np.random.default_rng(seed)
    v0 = (1 << 30) - 5 * step
    out = []
    for b in range(n_batches):
        rl = rng.integers(1, longest + 1, n) if longest > 1 else None
        r = rng.integers(0, units - longest, n)
        w, wl = (r, rl) if rmw else (
            rng.integers(0, units - longest, n),
            rng.integers(1, longest + 1, n) if longest > 1 else None)
        v = v0 + b * step
        snaps = v - rng.integers(1, lag_max + 1, n) * step

        def pairs(ids, lens):
            ends = ids + (1 if lens is None else lens)
            return list(zip(ids.tolist(), ends.tolist()))
        out.append(((BatchShape(r, rl, w, wl), torch.from_numpy(snaps), v,
                     v - window),
                    (pairs(r, rl), pairs(w, wl), snaps, v, v - window)))
    return out


def verdicts_of(conflict, too_old):
    return np.where(too_old.numpy(), 1,
                    np.where(conflict.numpy(), 0, 2)).tolist()


@pytest.mark.parametrize("longest", [1, 4])
@pytest.mark.parametrize("rmw", [False, True])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reference_matches_brute_force(seed, rmw, longest):
    step, window = 1000, 4000        # four batches in the MVCC window
    batches = random_batches(seed, 14, 40, 40, rmw, step, window, 7,
                             longest)
    want = brute_force([b for _a, b in batches])
    ref = Reference(40)
    seen = {0: 0, 1: 0, 2: 0}
    for (args, _b), verdicts in zip(batches, want):
        got = verdicts_of(*ref.resolve(*args))
        assert got == verdicts
        for x in verdicts:
            seen[x] += 1
    assert min(seen.values()) > 0      # conflicts, too old and commits all
    counts = ref.counts
    assert counts["transactions"] == 14 * 40
    assert counts["too_old"] == seen[1]
    assert counts["external"] + counts["intra_batch"] == seen[0]
    assert counts["intra_batch"] > 0 and counts["external"] > 0


def live_steps(batches, want, units):
    """Each unit's latest committed write version, where it is at or
    above the last batch's oldest version; else 0."""
    latest = np.zeros(units, np.int64)
    for (_a, (_r, writes, _s, v, _o)), verdicts in zip(batches, want):
        for t, x in enumerate(verdicts):
            if x == 2:
                b, e = writes[t]
                latest[b:e] = v
    latest[latest < batches[-1][1][4]] = 0
    return latest


@pytest.mark.parametrize("seed", [4, 5])
def test_history_rows(seed):
    batches = random_batches(seed, 12, 30, 60, False, 1000, 4000, 3, 4)
    want = brute_force([b for _a, b in batches])
    ref = Reference(60)
    for args, _b in batches:
        ref.resolve(*args)
    steps = live_steps(batches, want, 60)
    # tiled units: a row at the start and wherever the live step changes
    padded = np.concatenate([[0], steps, [0]])
    assert ref.history_rows(1, True) == 1 + int(
        np.count_nonzero(padded[1:] != padded[:-1]))
    # points: a begin and an end row a live unit, a first row a shard
    assert ref.history_rows(4, False) == 4 + 2 * int(
        np.count_nonzero(steps))


def test_intra_batch_chain():
    # txn 1 reads what txn 0 writes; txn 2 reads what txn 1 writes: 1
    # conflicts, so 2 does not; txn 3 reads what txn 2 writes
    r = np.array([9, 5, 6, 7])
    w = np.array([5, 6, 7, 8])
    snaps = torch.full((4,), 100)
    ref = Reference(10)
    c, t = ref.resolve(BatchShape(r, None, w, None), snaps, 200, 0)
    assert c.tolist() == [False, True, False, True] and not t.any()


def test_ranges_overlap_by_shared_units():
    # txn 0 writes units 3-5; txn 1 reads 6-7 (no overlap), txn 2 reads
    # 5-8 (overlaps at 5) and writes 0; txn 3 reads unit 0
    r, rl = np.array([0, 6, 5, 0]), np.array([1, 2, 4, 1])
    w, wl = np.array([3, 9, 0, 9]), np.array([3, 1, 1, 1])
    ref = Reference(12)
    c, _t = ref.resolve(BatchShape(r, rl, w, wl), torch.full((4,), 100),
                        200, 0)
    assert c.tolist() == [False, False, True, False]


def test_window_edge():
    # a snapshot at the oldest version is valid and sees a write just
    # above it; one version below is too old
    ref = Reference(4)
    one = np.array([1])
    ref.resolve(BatchShape(one, None, one, None), torch.tensor([50]), 101,
                100)
    c, t = ref.resolve(BatchShape(one, None, one, None), torch.tensor([100]),
                       200, 100)
    assert c.tolist() == [True] and not t.any()
    c, t = ref.resolve(BatchShape(one, None, one, None), torch.tensor([99]),
                       300, 100)
    assert t.tolist() == [True] and not c.any()


@pytest.mark.parametrize("switch", [{"intra_batch": False},
                                    {"external": False}])
def test_control_breaks_a_guarantee(switch):
    batches = random_batches(4, 10, 40, 30, False, 1000, 4000, 3, 3)
    want = brute_force([b for _a, b in batches])
    ref = Reference(30, **switch)
    wrong = 0
    for (args, _b), verdicts in zip(batches, want):
        wrong += sum(a != b for a, b in
                     zip(verdicts_of(*ref.resolve(*args)), verdicts))
    assert wrong > 0
