"""Simulation-time invariant validation.

Reference: fdbserver/sim_validation.cpp — debug hooks the simulator
checks continuously (committed-version monotonicity, recovery
uniqueness), failing the run the moment an invariant breaks rather
than when a workload later trips over the damage. Here a validator
actor rides every SimCluster, re-checking the published cluster
picture on each broadcast; the checks run in EVERY simulation test by
default, so a regression anywhere in recovery/DD/recruitment surfaces
at its source.
"""

from __future__ import annotations

from .. import flow


def validate_dbinfo(info, seen_state: dict) -> None:
    """Invariants of one published ServerDBInfo; `seen_state` carries
    cross-broadcast state (monotone sequences). Raises AssertionError
    with a precise message on violation."""
    # broadcast sequence strictly increases
    last_seq = seen_state.get("seq", -1)
    assert info.seq > last_seq, (
        f"dbinfo seq went backwards: {last_seq} -> {info.seq}")
    seen_state["seq"] = info.seq
    # epochs never regress
    last_epoch = seen_state.get("epoch", -1)
    assert info.epoch >= last_epoch, (
        f"epoch went backwards: {last_epoch} -> {info.epoch}")
    seen_state["epoch"] = info.epoch

    if info.storages:
        # the shard map covers the keyspace contiguously
        assert info.storages[0].begin == b"", (
            f"shard map does not start at empty key: "
            f"{info.storages[0].begin!r}")
        assert info.storages[-1].end is None, (
            f"shard map does not end at +inf: {info.storages[-1].end!r}")
        for i in range(len(info.storages) - 1):
            assert info.storages[i].end == info.storages[i + 1].begin, (
                f"shard map gap/overlap at {i}: "
                f"{info.storages[i].end!r} vs "
                f"{info.storages[i + 1].begin!r}")
        # tags are unique; every shard has at least one replica whose
        # advertised bounds match the shard's
        tags = [s.tag for s in info.storages]
        assert len(set(tags)) == len(tags), f"duplicate shard tags: {tags}"
        for s in info.storages:
            assert s.replicas, f"shard tag {s.tag} has no replicas"
            for rep in s.replicas:
                assert rep.begin == s.begin and rep.end == s.end, (
                    f"replica {rep.name} bounds {rep.begin!r}..{rep.end!r}"
                    f" diverge from shard {s.begin!r}..{s.end!r}")

    # old generations precede the current one and are properly closed
    for gen in info.old_logs:
        assert gen.epoch < info.logs.epoch, (
            f"old generation {gen.epoch} not before current "
            f"{info.logs.epoch}")
        assert gen.end_version >= 0, (
            f"old generation {gen.epoch} still open")


async def validator(dbinfo_var, seen: dict) -> None:
    """Actor: re-validate on every broadcast (attach via SimCluster).
    `seen` is caller-owned so tests can assert THIS validator observed
    their broadcasts; a violation error is surfaced by SimCluster.run,
    not swallowed in the detached task."""
    while True:
        info = dbinfo_var.get()
        if info.seq > seen.get("seq", -1):
            validate_dbinfo(info, seen)
            seen["checked"] = seen.get("checked", 0) + 1
            flow.cover("sim_validation.checked")
        await dbinfo_var.on_change()
