"""Commit critical-path decomposition.

Reference: the commit-debug station timeline the reference threads
debug ids through (`resolveBatch`, fdbserver/Resolver.actor.cpp:71 and
the g_traceBatch locations in MasterProxyServer.actor.cpp) — grown
into a measurement plane: while CRITICAL_PATH is armed, EVERY commit
batch records consecutive `flow.now()` timestamps at the pipeline
stations, so each transaction's end-to-end latency decomposes into a
telescoping sum of per-station segments:

    proxy_batcher   arrival -> batch close (batcher window + deferral)
    commit_version  batch close -> version assigned (interlock + master)
    resolve         version -> verdicts drained (submit + device + drain)
    tlog_fsync      verdicts -> every log's durability ack
    reply           ack -> client reply sent (incl. injections)

Because the segment boundaries are the SAME clock reads, the segments
sum to the measured end-to-end latency exactly (the residual is float
rounding — bounded by CRITICAL_PATH_TOLERANCE and pinned by test).
The resolver and tlog keep their own queue-vs-service splits (version-
ordering wait vs actual service) in `RolePathRecorder`s; the cluster
controller folds everything into a decaying dominant-station table
(`status.cluster.critical_path`, `cli path`, `fdbtpu_path_*`).

Everything here is inert data structures: no actors, no RNG, no knob
writes — the off posture (knob 0) never constructs a sample.
"""

from __future__ import annotations

from typing import Optional

from .. import flow

#: pipeline stations in path order (the proxy's segment keys)
STATIONS = ("proxy_batcher", "commit_version", "resolve", "tlog_fsync",
            "reply")

#: bound on the arrival-stamp map: commits captured by the admission
#: scheduler and then rejected never reach a batch, so the map must
#: self-trim instead of growing with them
MAX_ARRIVALS = 4096


def dominant_station(segments: dict) -> str:
    """The station that contributed the most seconds (ties break in
    path order, so a uniform batch reads as batcher-bound)."""
    best = STATIONS[0]
    best_v = -1.0
    for s in STATIONS:
        v = segments.get(s, 0.0)
        if v > best_v:
            best, best_v = s, v
    return best


class ProxyPathRecorder:
    """Per-proxy decomposition state: arrival stamps (keyed by the
    reply promise's identity — the one object that survives scheduler
    deferral and re-entry intact), per-station latency bands, dominant
    counts, and a bounded sample buffer the CC loop drains."""

    def __init__(self):
        self._arrivals: dict = {}
        self.bands = {s: flow.LatencyBands(s) for s in STATIONS}
        self.e2e = flow.LatencyBands("end_to_end")
        self.dominant: dict = {s: 0 for s in STATIONS}
        self.seconds: dict = {s: 0.0 for s in STATIONS}
        self.samples = 0
        self.max_residual = 0.0
        self._pending: list = []   # recent samples awaiting the CC fold

    def note_arrival(self, token, now: float) -> None:
        """Stamp a commit's queue entry (batcher pop). setdefault: a
        scheduler-deferred commit re-enters the stream later, and its
        wait in the deferral queue must count as batcher wait."""
        if len(self._arrivals) >= MAX_ARRIVALS and \
                id(token) not in self._arrivals:
            self._arrivals.pop(next(iter(self._arrivals)))
        self._arrivals.setdefault(id(token), now)

    def take_arrival(self, token, default: float) -> float:
        return self._arrivals.pop(id(token), default)

    def record(self, segments: dict, e2e: float) -> None:
        """Fold one transaction's decomposition. `segments` maps every
        station to seconds; their sum equals `e2e` up to rounding."""
        self.samples += 1
        total = 0.0
        for s in STATIONS:
            v = segments.get(s, 0.0)
            total += v
            self.bands[s].record(v)
            self.seconds[s] += v
        self.e2e.record(e2e)
        dom = dominant_station(segments)
        self.dominant[dom] += 1
        residual = abs(total - e2e)
        if residual > self.max_residual:
            self.max_residual = residual
        cap = int(flow.SERVER_KNOBS.critical_path_sample_max)
        if len(self._pending) < cap:
            self._pending.append((dom, segments.get(dom, 0.0), e2e))

    def drain_samples(self) -> list:
        """Hand the buffered (dominant, dominant_seconds, e2e) samples
        to the CC fold and reset the buffer."""
        out, self._pending = self._pending, []
        return out

    def snapshot(self) -> dict:
        return {
            "samples": self.samples,
            "max_residual_seconds": round(self.max_residual, 9),
            "dominant": dict(self.dominant),
            "stations": {s: {"seconds": round(self.seconds[s], 6),
                             "bands": self.bands[s].snapshot()}
                         for s in STATIONS},
            "end_to_end": self.e2e.snapshot(),
        }


class RolePathRecorder:
    """Queue-vs-service split for one serving role (resolver, tlog):
    `wait` is version-ordering / queue time before service starts,
    `service` is the actual work (resolve submit->drain, fsync). The
    tlog also stashes per-request enter stamps here (keyed by request
    identity) to bridge its two-actor accept -> durable path."""

    def __init__(self, name: str):
        self.name = name
        self.wait = flow.LatencyBands("wait")
        self.service = flow.LatencyBands("service")
        self._enter: dict = {}

    def note_enter(self, token, now: float) -> None:
        if len(self._enter) >= MAX_ARRIVALS and \
                id(token) not in self._enter:
            self._enter.pop(next(iter(self._enter)))
        self._enter[id(token)] = now

    def take_enter(self, token, default: float) -> float:
        return self._enter.pop(id(token), default)

    def record(self, wait_s: float, service_s: float) -> None:
        self.wait.record(max(0.0, wait_s))
        self.service.record(max(0.0, service_s))

    def snapshot(self) -> dict:
        return {"wait": self.wait.snapshot(),
                "service": self.service.snapshot()}


class CriticalPathTable:
    """Decaying dominant-station rollup at the cluster controller
    (the ConflictHotSpots shape: exponentially-decayed score + raw
    totals, bounded by construction — the station set is finite)."""

    def __init__(self, half_life: Optional[float] = None):
        self.half_life = half_life
        self._rows: dict = {}   # station -> [score, count, seconds, t]

    def _hl(self) -> float:
        return (self.half_life if self.half_life is not None
                else float(flow.SERVER_KNOBS.critical_path_half_life))

    def _decayed(self, score: float, since: float, now: float) -> float:
        hl = self._hl()
        if now <= since or hl <= 0:
            return score
        return score * 0.5 ** ((now - since) / hl)

    def record(self, station: str, seconds: float, now: float) -> None:
        row = self._rows.get(station)
        if row is None:
            row = self._rows[station] = [0.0, 0, 0.0, now]
        row[0] = self._decayed(row[0], row[3], now) + seconds
        row[1] += 1
        row[2] += seconds
        row[3] = now

    def top(self, now: Optional[float] = None) -> list:
        """Status-ready rows, heaviest decayed cause first."""
        if now is None:
            now = flow.now()
        rows = [(self._decayed(sc, t, now), n, sec, st)
                for st, (sc, n, sec, t) in self._rows.items()]
        rows.sort(key=lambda r: (-r[0], r[3]))
        return [{"station": st, "score": round(score, 6), "count": n,
                 "seconds": round(sec, 6)}
                for score, n, sec, st in rows]
