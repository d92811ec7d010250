"""Conflict prediction & admission scheduling: the decision plane that
turns the resolvers' conflict-attribution telemetry into committed goodput.

Reference: *Intelligent Transaction Scheduling via Conflict Prediction
in OLTP DBMS* (arXiv:2409.01675) — score each transaction's conflict
probability from observed per-range conflict statistics and steer the
likely losers at admission instead of letting them race to a
near-certain abort — and *Early Detection for MVCC Conflicts in
Hyperledger Fabric* (PAPERS.md) — push hot-key conflict windows to
clients so doomed transactions abort before they consume the commit
pipeline.

Three cooperating pieces, all fed by the cluster-merged decaying
`ConflictHotSpots` table the CC pushes at SCHED_HOT_PUSH_INTERVAL:

- `ConflictPredictor`: hot rows -> P(conflict) for a set of conflict
  ranges. Per-range probability is score/(score+SCHED_HOT_SCORE_SCALE)
  and independent ranges combine as 1 - prod(1 - p).
- `AdmissionScheduler` (proxy-side): commits whose probability crosses
  SCHED_CONFLICT_THRESHOLD are captured into a per-hot-range queue and
  released one per SCHED_RELEASE_SPACING, priority-aware (IMMEDIATE
  never defers, BATCH sorts last) and delay-bounded (SCHED_MAX_DELAY —
  a queue that cannot honor the bound admits immediately, counted as
  `sched_overflow`). Serialized releases land in successive commit
  batches at successive versions, so with transaction repair armed
  (server/repair.py) each released rival is repaired at its
  predecessor's version instead of the whole set racing one winner.
- `ConflictWindowCache` (client-side): hot windows piggybacked on GRV
  replies; `Transaction.commit` consults the cache and aborts locally
  (the same not_committed a resolver abort raises, from the same place
  in the commit path) when a read range overlaps a fresh window newer
  than the snapshot. Entries expire after CONFLICT_WINDOW_TTL.

Everything is knob-gated OFF by default: with CONFLICT_SCHEDULING=0,
TXN_REPAIR=0 and CLIENT_CONFLICT_WINDOWS=0 the commit path is
byte-identical to the abort-only pipeline.
"""

from __future__ import annotations

from typing import Optional, Tuple

from .. import flow
from ..flow import SERVER_KNOBS, TaskPriority, error
from .types import PRIORITY_DEFAULT, PRIORITY_IMMEDIATE

#: hot row shape pushed by the CC: (begin, end, decayed score, raw
#: total, last attributed conflict version)
HotRow = Tuple[bytes, bytes, float, int, int]


class ConflictPredictor:
    """Hot-spot rows -> conflict probability (the admission scorer of
    arXiv:2409.01675, with the decaying range table standing in for
    the paper's learned per-type statistics)."""

    __slots__ = ("rows", "updated_at")

    def __init__(self):
        self.rows: Tuple[HotRow, ...] = ()
        self.updated_at = 0.0

    def update(self, rows, now: float) -> None:
        self.rows = tuple(rows)
        self.updated_at = now

    @staticmethod
    def range_probability(score: float) -> float:
        """One hot range's conflict probability from its decayed score
        (saturating map: a range attributed `scale` conflicts per
        half-life sits at 0.5)."""
        scale = float(SERVER_KNOBS.sched_hot_score_scale)
        if scale <= 0:
            return 1.0 if score > 0 else 0.0
        return score / (score + scale)

    def score(self, ranges) -> Tuple[float, Optional[Tuple[bytes, bytes]]]:
        """P(conflict) for a transaction touching `ranges`, plus the
        hottest overlapped hot range (the scheduler's queue key).
        Ranges are treated as independent: 1 - prod(1 - p_range)."""
        p_clear = 1.0
        hottest = None
        hot_score = -1.0
        for hb, he, s, _total, _v in self.rows:
            for b, e in ranges:
                if b < he and hb < e:
                    p_clear *= 1.0 - self.range_probability(s)
                    if s > hot_score:
                        hot_score, hottest = s, (hb, he)
                    break
        return 1.0 - p_clear, hottest


class AdmissionScheduler:
    """Per-hot-range deferral queues at the proxy (the steering half of
    the subsystem). Counters live in the owning proxy's
    CounterCollection (`sched_*`), so the metric sampler, status and
    exporter pick them up like every other proxy counter."""

    def __init__(self, process, stats: "flow.CounterCollection", release):
        self.process = process
        self.stats = stats
        self._release = release          # (req, reply) -> re-enqueue
        self.predictor = ConflictPredictor()
        #: (begin, end) -> [(-priority, seq, req, reply), ...]
        self._queues: dict = {}
        self._runners: dict = {}
        self._released_ids: set = set()
        self._seq = 0
        self._depth = 0
        self._actors = flow.ActorCollection()

    # -- feed ------------------------------------------------------------
    def update_hot_spots(self, rows, now: float) -> None:
        self.predictor.update(rows, now)
        self.stats.counter("sched_pushes").add(1)

    def queue_depth(self) -> int:
        """Deferred commits currently held (the ratekeeper's
        deferral-pressure input)."""
        return self._depth

    # -- admission -------------------------------------------------------
    def consider(self, req, reply) -> bool:
        """True when the commit was captured for deferred release; the
        caller must then NOT batch it — it re-enters the commit stream
        through the release callback."""
        rid = id(reply)
        if rid in self._released_ids:
            # a release coming back through the batcher: admit
            self._released_ids.discard(rid)
            return False
        k = SERVER_KNOBS
        if not k.conflict_scheduling or not self.predictor.rows:
            return False
        if getattr(req, "repair_attempt", 0):
            return False    # repair resubmissions already waited
        if getattr(req, "priority", PRIORITY_DEFAULT) >= PRIORITY_IMMEDIATE:
            return False
        if not req.mutations:
            return False
        prob, hot = self.predictor.score(
            tuple(req.read_conflict_ranges)
            + tuple(req.write_conflict_ranges))
        if hot is None or prob < float(k.sched_conflict_threshold):
            return False
        q = self._queues.setdefault(hot, [])
        spacing = float(k.sched_release_spacing)
        if len(q) >= int(k.sched_queue_max) or \
                (len(q) + 1) * spacing > float(k.sched_max_delay):
            # the bounded-delay contract beats the steering: admit now
            if not q:
                self._queues.pop(hot, None)
            flow.cover("sched.overflow")
            self.stats.counter("sched_overflow").add(1)
            return False
        flow.cover("sched.deferred")
        self._seq += 1
        q.append((-int(getattr(req, "priority", PRIORITY_DEFAULT)),
                  self._seq, req, reply))
        self._depth += 1
        self.stats.counter("sched_deferrals").add(1)
        self.stats.counter("sched_deferred_now").set(self._depth)
        runner = self._runners.get(hot)
        if runner is None or runner.is_ready:
            t = flow.spawn(self._drain(hot),
                           TaskPriority.PROXY_COMMIT_BATCHER,
                           name=f"{self.process.name}.schedDrain")
            self._runners[hot] = t
            self._actors.add(t)
        return True

    async def _drain(self, key) -> None:
        """Serialize one hot range's deferred commits: one release per
        spacing, highest priority first (ties FIFO), so rivals land in
        successive commit batches instead of one racing batch."""
        q = self._queues.get(key)
        while q:
            await flow.delay(float(SERVER_KNOBS.sched_release_spacing),
                             TaskPriority.PROXY_COMMIT_BATCHER)
            q = self._queues.get(key)
            if not q:
                break
            q.sort(key=lambda en: (en[0], en[1]))
            _p, _s, req, reply = q.pop(0)
            self._depth -= 1
            self._released_ids.add(id(reply))
            self.stats.counter("sched_released").add(1)
            self.stats.counter("sched_deferred_now").set(self._depth)
            self._release(req, reply)
        self._queues.pop(key, None)
        self._runners.pop(key, None)   # dead Task must not accumulate

    # -- surfaces --------------------------------------------------------
    def status(self) -> dict:
        snap = self.stats.snapshot()
        return {
            "enabled": int(bool(SERVER_KNOBS.conflict_scheduling)),
            "deferrals": snap.get("sched_deferrals", 0),
            "released": snap.get("sched_released", 0),
            "overflow": snap.get("sched_overflow", 0),
            "pushes": snap.get("sched_pushes", 0),
            "deferred_now": self._depth,
            "queue_ranges": len([q for q in self._queues.values() if q]),
            "hot_rows": len(self.predictor.rows),
        }

    def shutdown(self) -> None:
        """Epoch over: break every held commit so clients fail over
        instead of hanging (same contract as Proxy.stop's GRV drain)."""
        self._actors.cancel_all()
        for q in self._queues.values():
            for _p, _s, _req, reply in q:
                try:
                    reply.send_error(error("broken_promise"))
                except Exception:
                    pass  # already answered
        self._queues.clear()
        self._runners.clear()
        self._released_ids.clear()
        self._depth = 0


# -- client side -------------------------------------------------------

#: process-wide client-cache counters (the client_profile pattern:
#: every simulated client shares one collection, surfaced through
#: status.cluster.conflict_scheduling.client and the exporter)
g_client_window_stats = flow.CounterCollection("client_windows")


def note_windows_cached(n: int) -> None:
    g_client_window_stats.counter("windows_cached").set(n)
    g_client_window_stats.counter("window_updates").add(1)


def note_early_abort() -> None:
    g_client_window_stats.counter("early_aborts").add(1)


def client_window_counters() -> dict:
    return g_client_window_stats.snapshot()


class ConflictWindowCache:
    """Per-Database cache of hot-key conflict windows ridden in on GRV
    replies (the Hyperledger-style early-detection half). A window is
    (begin, end, last_version): the range has been aborting
    transactions, most recently at last_version. A commit whose read
    ranges overlap a LIVE window and whose snapshot predates the
    window's version is near-certain to abort at the resolver — the
    client aborts it locally instead. Entries expire
    CONFLICT_WINDOW_TTL seconds after arrival, so a range that cooled
    off (or a partitioned proxy's stale picture) stops aborting
    traffic without any cluster round trip."""

    __slots__ = ("_rows",)

    def __init__(self):
        #: (begin, end, last_version, expires_at)
        self._rows: tuple = ()

    def update(self, windows, now: float) -> None:
        ttl = float(SERVER_KNOBS.conflict_window_ttl)
        self._rows = tuple((b, e, v, now + ttl) for b, e, v in windows)
        note_windows_cached(len(self._rows))

    def live_rows(self, now: float) -> tuple:
        if self._rows and any(exp <= now for *_x, exp in self._rows):
            self._rows = tuple(r for r in self._rows if r[3] > now)
        return self._rows

    def doomed(self, read_ranges, snapshot: int, now: float) -> tuple:
        """The read ranges a live window dooms at this snapshot
        (empty tuple = submit normally)."""
        rows = self.live_rows(now)
        if not rows:
            return ()
        g_client_window_stats.counter("checks").add(1)
        out = []
        for b, e in read_ranges:
            for wb, we, wv, _exp in rows:
                if b < we and wb < e and snapshot < wv:
                    out.append((b, e))
                    break
        return tuple(out)
