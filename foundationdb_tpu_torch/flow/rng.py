"""Deterministic randomness + BUGGIFY fault-injection sites.

Reference: flow/DeterministicRandom.h, flow/IRandom.h (g_random), and the
BUGGIFY macro (flow/genericactors + Knobs randomization). Determinism is the
backbone of the test strategy: the same seed must reproduce the same run.
"""

from __future__ import annotations

import random as _pyrandom
from typing import Optional, Sequence


class DeterministicRandom:
    """Seeded PRNG with the reference's convenience surface (ref: flow/IRandom.h)."""

    def __init__(self, seed: int):
        self.seed = seed
        self._r = _pyrandom.Random(seed)

    def reseed(self, seed: int) -> None:
        """Re-seed in place (the ambient g_random is shared by reference)."""
        self.seed = seed
        self._r = _pyrandom.Random(seed)

    def random01(self) -> float:
        return self._r.random()

    def random_int(self, lo: int, hi: int) -> int:
        """Uniform in [lo, hi) — half-open like the reference's randomInt."""
        return self._r.randrange(lo, hi)

    def random_choice(self, seq: Sequence):
        return seq[self.random_int(0, len(seq))]

    def random_shuffle(self, seq: list) -> None:
        self._r.shuffle(seq)

    def random_alpha_numeric(self, length: int) -> str:
        chars = "abcdefghijklmnopqrstuvwxyz0123456789"
        return "".join(self.random_choice(chars) for _ in range(length))

    def random_bytes(self, length: int) -> bytes:
        return self._r.randbytes(length)

    def random_unique_id(self) -> str:
        return "%016x%016x" % (self._r.getrandbits(64), self._r.getrandbits(64))

    def random_exp(self, mean: float) -> float:
        return self._r.expovariate(1.0 / mean) if mean > 0 else 0.0

    def coinflip(self) -> bool:
        return self._r.random() < 0.5

    def fork(self) -> "DeterministicRandom":
        """Derive an independent deterministic stream (for per-process RNGs)."""
        return DeterministicRandom(self._r.getrandbits(63))


class Buggifier:
    """Per-site random fault activation (ref: BUGGIFY, flow/Knobs.cpp:37+).

    Each distinct call site (identified by a string) is *activated* once per
    run with probability `activated_p`; an activated site then fires with
    probability `fire_p` on each evaluation.
    """

    def __init__(self, rng: Optional[DeterministicRandom] = None,
                 enabled: bool = False, activated_p: float = 0.25, fire_p: float = 0.25):
        self.rng = rng or DeterministicRandom(0)
        self.enabled = enabled
        self.activated_p = activated_p
        self.fire_p = fire_p
        self._sites: dict[str, bool] = {}

    def __call__(self, site: str) -> bool:
        if not self.enabled:
            return False
        act = self._sites.get(site)
        if act is None:
            act = self.rng.random01() < self.activated_p
            self._sites[site] = act
        return act and self.rng.random01() < self.fire_p


# Ambient instances, reset in place per simulation so that importers holding a
# reference observe the new seed (ref: g_random / g_nondeterministic_random).
g_random = DeterministicRandom(1)
g_buggify = Buggifier()


def set_seed(seed: int, buggify_enabled: bool = False) -> None:
    g_random.reseed(seed)
    g_buggify.rng = g_random.fork()
    g_buggify.enabled = buggify_enabled
    g_buggify._sites.clear()


def buggify(site: str) -> bool:
    return g_buggify(site)


def rng_state() -> tuple:
    """Opaque snapshot of the ambient RNG + BUGGIFY state, for tools
    that call set_seed() inside a process that may already be running
    a seeded simulation (networktest, clusterbench): capture before,
    restore_rng_state() in a finally — or the tool silently desyncs
    the caller's deterministic stream."""
    return (g_random.seed, g_random._r.getstate(), g_buggify.rng,
            g_buggify.enabled, dict(g_buggify._sites))


def restore_rng_state(state: tuple) -> None:
    seed, rstate, brng, benabled, sites = state
    g_random.seed = seed
    g_random._r.setstate(rstate)
    # the displaced fork object was untouched while we ran (set_seed
    # replaced it wholesale), so restoring the reference restores its
    # exact stream position
    g_buggify.rng = brng
    g_buggify.enabled = benabled
    g_buggify._sites.clear()
    g_buggify._sites.update(sites)
