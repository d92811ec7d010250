"""TimeKeeper: the persisted version<->wallclock map.

Reference: fdbserver/TimeKeeper.actor.cpp — a cluster-controller actor
that periodically commits (time -> read version) pairs under
\\xff\\x02/timeKeeper/ through the ordinary pipeline, so any tool with
a database handle can translate between the version axis (what the
commit pipeline speaks) and the wallclock axis (what operators and
incident windows speak). The CC loop itself lives in
cluster_controller._timekeeper_loop; this module is the schema's
read/write/trim vocabulary, shared by the CC, the metrics janitor,
and tools/incident.py.

Lookups interpolate linearly between the two adjacent map rows (the
reference's versionFromTime does the same 1e6-versions-per-second
extrapolation off the nearest sample).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .. import flow
from ..client import run_transaction
from .systemkeys import (TIMEKEEPER_END, TIMEKEEPER_PREFIX,
                         TIMEKEEPER_VERSION, parse_timekeeper_key,
                         timekeeper_cutoff_key, timekeeper_key)

# the reference's fallback slope when extrapolating outside the map
VERSIONS_PER_SECOND = 1_000_000


async def commit_time_row(db, ts: float, version: int,
                          max_retries: int = 100) -> None:
    """Commit one (wallclock -> version) row. `version` is the best
    known recent commit version (the CC uses the max proxy committed
    version); the row is a blind set so it can never conflict."""

    async def body(tr):
        tr.set_option("access_system_keys")
        tr.set(timekeeper_key(int(ts * 1000)), b"%d" % version)

    await run_transaction(db, body, max_retries=max_retries)


async def read_time_map(db, start_ts: float = None, end_ts: float = None,
                        limit: int = 10_000
                        ) -> List[Tuple[float, int]]:
    """The stored map as [(wallclock_seconds, version)], time-ordered,
    optionally bounded to [start_ts, end_ts)."""
    b = (timekeeper_key(int(start_ts * 1000)) if start_ts is not None
         else TIMEKEEPER_PREFIX)
    e = (timekeeper_key(int(end_ts * 1000)) if end_ts is not None
         else TIMEKEEPER_END)

    async def body(tr):
        tr.set_option("access_system_keys")
        return await tr.get_range(b, e, limit=limit)

    rows = await run_transaction(db, body)
    out = []
    for k, v in rows:
        parsed = parse_timekeeper_key(k)
        if parsed is None or parsed[0] != TIMEKEEPER_VERSION:
            continue
        try:
            out.append((parsed[1] / 1000.0, int(v)))
        except ValueError:
            continue
    return out


def _interp(x: float, x0: float, y0: float, x1: float, y1: float) -> float:
    if x1 == x0:
        return y0
    return y0 + (y1 - y0) * (x - x0) / (x1 - x0)


def version_at_time_from_map(time_map: List[Tuple[float, int]],
                             ts: float) -> Optional[int]:
    """Pure lookup over an already-read map (tools that read the map
    once and translate many points — the incident bundler — use this).
    Interpolates between adjacent rows; extrapolates at the reference's
    nominal versions/second slope past either end."""
    if not time_map:
        return None
    if ts <= time_map[0][0]:
        t0, v0 = time_map[0]
        return max(0, int(v0 + (ts - t0) * VERSIONS_PER_SECOND))
    if ts >= time_map[-1][0]:
        t1, v1 = time_map[-1]
        return int(v1 + (ts - t1) * VERSIONS_PER_SECOND)
    for i in range(1, len(time_map)):
        if ts <= time_map[i][0]:
            t0, v0 = time_map[i - 1]
            t1, v1 = time_map[i]
            return int(_interp(ts, t0, v0, t1, v1))
    return time_map[-1][1]


def time_at_version_from_map(time_map: List[Tuple[float, int]],
                             version: int) -> Optional[float]:
    """Inverse lookup (versions are monotone in time, so the map is
    monotone on both axes)."""
    if not time_map:
        return None
    if version <= time_map[0][1]:
        t0, v0 = time_map[0]
        return t0 + (version - v0) / VERSIONS_PER_SECOND
    if version >= time_map[-1][1]:
        t1, v1 = time_map[-1]
        return t1 + (version - v1) / VERSIONS_PER_SECOND
    for i in range(1, len(time_map)):
        if version <= time_map[i][1]:
            t0, v0 = time_map[i - 1]
            t1, v1 = time_map[i]
            return _interp(version, v0, t0, v1, t1)
    return time_map[-1][0]


async def version_at_time(db, ts: float) -> Optional[int]:
    return version_at_time_from_map(await read_time_map(db), ts)


async def time_at_version(db, version: int) -> Optional[float]:
    return time_at_version_from_map(await read_time_map(db), version)


async def trim_timekeeper(db, cutoff_ts: float, max_retries: int = 100,
                          scan_limit: int = 10_000) -> int:
    """Delete map rows older than `cutoff_ts`; returns rows trimmed
    (bounded count + one clear_range, the clientlog-janitor shape)."""
    cutoff = timekeeper_cutoff_key(int(cutoff_ts * 1000))

    async def body(tr):
        tr.set_option("access_system_keys")
        rows = await tr.get_range(TIMEKEEPER_PREFIX, cutoff,
                                  limit=scan_limit)
        if rows:
            tr.clear_range(TIMEKEEPER_PREFIX, cutoff)
        return len(rows)

    trimmed = await run_transaction(db, body, max_retries=max_retries)
    if trimmed:
        flow.TraceEvent("TimeKeeperTrimmed").detail(
            Rows=trimmed, CutoffTs=cutoff_ts).log()
    return trimmed
