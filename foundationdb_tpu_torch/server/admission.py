"""Enforced GRV admission control: the ratekeeper's budget made real.

Reference: fdbserver/GrvProxyServer.actor.cpp — transactionStarter
releases queued GetReadVersion requests no faster than this proxy's
SHARE of the ratekeeper's rate (GrvTransactionRateInfo: a token budget
refilled per batch window with a bounded burst allowance), with strict
priority classes (SystemImmediate bypasses the gate entirely, Default
pays the normal budget, Batch pays the separate — lower — batch budget
so background work throttles first) and queue-memory bounds that
REJECT overflow with a retryable error instead of letting the queue
grow without bound — and GrvProxyTransactionTagThrottler, which parks
tagged requests in per-tag queues in FRONT of the class gate and
releases them at the rate the \\xff\\x02/throttledTags/ rows command.

Pieces:

- `TokenBucket`: lazy-refill budget bucket with a bounded burst
  allowance and an explicit debt mode (an oversized head request is
  admitted into debt rather than starving forever — the same rule the
  pre-admission batcher applied).
- `TagThrottleTable`: the proxy-side view of the throttledTags rows
  (installed by the poll loop in server/proxy.py). Each live row gets
  a pacing bucket and a bounded FIFO of parked requests; expiry
  releases the parked queue back into the class queues.
- `GrvAdmissionQueues`: per-priority FIFO queues with STRICT class
  ordering — immediate drains first and pays no tokens, batch drains
  last and pays both buckets — plus the depth/wait bounds. One
  `tick()` per GRV_BATCH_INTERVAL window admits a batch that the proxy
  serves with a single causal-confirmation round trip (the GRV
  batching coalesce: N admitted transactions per confirmation ask).

Everything is knob-gated OFF by default (GRV_ADMISSION_CONTROL /
TAG_THROTTLING): with both 0 the proxy never routes a request through
this module and the GRV path is byte-identical to the pre-subsystem
one. BUGGIFY arms the knobs randomly so sim storms run throttled.

Counters live in the owning proxy's CounterCollection (`admission_*`,
`throttle_*`), so the metric sampler, status and exporter pick them up
like every other proxy counter.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

from .. import flow
from ..flow import SERVER_KNOBS, error
from .types import (PRIORITY_BATCH, PRIORITY_DEFAULT, PRIORITY_IMMEDIATE)

#: a queued GRV admission entry, the shape Proxy._serve_grv_batch
#: consumes: (reply, transaction_count, priority, enqueued_at, tags)
Entry = Tuple[object, int, int, float, Tuple[bytes, ...]]

PRIORITY_NAMES = {PRIORITY_BATCH: "batch", PRIORITY_DEFAULT: "default",
                  PRIORITY_IMMEDIATE: "immediate"}


class TokenBucket:
    """Budget-rate token bucket with lazy refill, a bounded burst
    allowance, and debt (ref: GrvTransactionRateInfo — `budget` may go
    negative when an oversized request is force-admitted, and the
    refill pays the debt off before new admissions)."""

    __slots__ = ("rate", "burst", "tokens", "_last")

    def __init__(self, rate: float = 0.0, burst: float = 1.0,
                 now: float = 0.0):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self.tokens = 0.0
        self._last = float(now)

    def set_rate(self, rate: float, burst: float, now: float) -> None:
        """Adopt a new budget; accrued tokens are refilled at the OLD
        rate first, so a rate change never retroactively rewrites the
        past window."""
        self._refill(now)
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))

    def _refill(self, now: float) -> None:
        dt = now - self._last
        if dt > 0:
            if self.rate <= 0:
                # a ZERO rate is a full stop (emergency throttle), not
                # a trickle — accrued tokens are confiscated too
                self.tokens = 0.0
            else:
                self.tokens = min(self.tokens + self.rate * dt, self.burst)
        self._last = now

    def available(self, now: float) -> float:
        self._refill(now)
        return self.tokens

    def try_take(self, n: float, now: float) -> bool:
        self._refill(now)
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def force_take(self, n: float, now: float) -> None:
        """Admit into debt (tokens go negative; refill repays)."""
        self._refill(now)
        self.tokens -= n


class TagThrottleRow:
    """One live throttledTags row as the proxy enforces it."""

    __slots__ = ("tag", "tps", "expiry", "priority", "auto", "bucket",
                 "queue")

    def __init__(self, tag: bytes, tps: float, expiry: float,
                 priority: int, auto: bool, now: float):
        self.tag = tag
        self.tps = float(tps)
        self.expiry = float(expiry)
        self.priority = int(priority)
        self.auto = bool(auto)
        # pacing bucket: one admission immediately, then strictly at
        # the commanded rate (burst 1 — a throttled tag has no burst
        # allowance by design)
        self.bucket = TokenBucket(self.tps, 1.0, now)
        self.bucket.tokens = 1.0
        self.queue: deque = deque()   # parked Entry FIFOs

    def doc(self) -> dict:
        return {"tag": self.tag.hex(), "tps": round(self.tps, 3),
                "expiry": round(self.expiry, 3),
                "priority": PRIORITY_NAMES.get(self.priority, "default"),
                "auto": int(self.auto), "queued": len(self.queue)}


class TagThrottleTable:
    """The proxy's enforcement view of \\xff\\x02/throttledTags/.
    `install` adopts a freshly-polled row set wholesale (pacing buckets
    survive for unchanged tags so a poll never resets accrued debt);
    expiry and rate changes are honored at the next interaction — the
    knobs and rows are read live, never frozen at construction."""

    def __init__(self):
        self.rows: Dict[bytes, TagThrottleRow] = {}

    def install(self, rows, now: float) -> List[Entry]:
        """rows: (tag, tps, expiry, priority, auto). Returns parked
        entries released by rows that vanished (manual `throttle off`)
        — the caller feeds them back into the class queues."""
        released: List[Entry] = []
        fresh: Dict[bytes, TagThrottleRow] = {}
        for tag, tps, expiry, priority, auto in rows:
            if expiry <= now:
                continue
            old = self.rows.get(tag)
            if old is not None:
                old.tps = float(tps)
                old.expiry = float(expiry)
                old.priority = int(priority)
                old.auto = bool(auto)
                old.bucket.set_rate(float(tps), 1.0, now)
                fresh[tag] = old
            else:
                fresh[tag] = TagThrottleRow(tag, tps, expiry, priority,
                                            auto, now)
        for tag, row in self.rows.items():
            if tag not in fresh and row.queue:
                released.extend(row.queue)
                row.queue.clear()
        self.rows = fresh
        return released

    def expire(self, now: float) -> List[Entry]:
        """Drop expired rows; their parked requests are released."""
        released: List[Entry] = []
        for tag in [t for t, r in self.rows.items() if r.expiry <= now]:
            row = self.rows.pop(tag)
            released.extend(row.queue)
            row.queue.clear()
        return released

    def applying(self, tags, priority: int,
                 now: float) -> Optional[TagThrottleRow]:
        """The most restrictive live row throttling this request: a row
        applies to priorities AT OR BELOW its own class (a `default`
        row throttles default and batch; immediate is never
        tag-throttled)."""
        if priority >= PRIORITY_IMMEDIATE or not self.rows:
            return None
        best = None
        for tag in tags:
            row = self.rows.get(tag)
            if row is None or row.expiry <= now:
                continue
            if priority > row.priority:
                continue
            if best is None or row.tps < best.tps:
                best = row
        return best

    def reply_rows(self, tags, now: float) -> Tuple:
        """The (tag, tps, expiry) triples riding the GRV reply so the
        client honors the throttle locally before its next request."""
        out = []
        for tag in tags:
            row = self.rows.get(tag)
            if row is not None and row.expiry > now:
                out.append((tag, row.tps, row.expiry))
        return tuple(out)

    def depth(self) -> int:
        return sum(len(r.queue) for r in self.rows.values())


class GrvAdmissionQueues:
    """Per-priority admission queues at one proxy's GRV stream."""

    def __init__(self, process, stats: "flow.CounterCollection"):
        self.process = process
        self.stats = stats
        self._queues: Dict[int, deque] = {PRIORITY_IMMEDIATE: deque(),
                                          PRIORITY_DEFAULT: deque(),
                                          PRIORITY_BATCH: deque()}
        self._default_bucket = TokenBucket()
        self._batch_bucket = TokenBucket()
        self.tags = TagThrottleTable()

    # -- intake ----------------------------------------------------------
    def submit(self, entry: Entry, now: float) -> None:
        """Queue one GRV request (or reject it, bounded): per-tag gate
        first, then the class FIFO. The reply is answered either by a
        later tick's admission or by a rejection here — never dropped."""
        reply, count, prio, t0, tags = entry
        # normalize foreign priority values onto the three classes the
        # way the rate gate reads them (>= immediate bypasses, <= batch
        # pays the batch bucket)
        if prio >= PRIORITY_IMMEDIATE:
            prio = PRIORITY_IMMEDIATE
        elif prio <= PRIORITY_BATCH:
            prio = PRIORITY_BATCH
        else:
            prio = PRIORITY_DEFAULT
        entry = (reply, count, prio, t0, tags)
        if SERVER_KNOBS.tag_throttling and tags:
            # the tag gate runs FIRST: a pace-limited request parks in
            # its tag's FIFO and only occupies a class queue once the
            # pacing releases it — so the class depth bound below
            # judges only requests actually contending for admission
            row = self.tags.applying(tags, prio, now)
            if row is not None:
                if row.bucket.available(now) < count:
                    # pacing denies: park (or bound-reject) — a full
                    # class queue is irrelevant to a request that was
                    # never going to occupy a class slot yet
                    if len(row.queue) >= int(
                            SERVER_KNOBS.tag_throttle_queue_max):
                        flow.cover("admission.tag_queue_full")
                        self.stats.counter("throttle_rejected").add(1)
                        self._reject(reply, "tag_throttled")
                        return
                    flow.cover("admission.tag_parked")
                    self.stats.counter("throttle_delayed").add(1)
                    row.queue.append(entry)
                    self._note_depth()
                    return
                if not self._class_room(prio):
                    # pacing would admit but the class queue is full:
                    # reject WITHOUT consuming the token — burning the
                    # tag's budget on a request that was never
                    # admitted would cut the tag below its commanded
                    # tps exactly when the proxy is already shedding
                    flow.cover("admission.queue_full")
                    self.stats.counter("admission_rejected").add(1)
                    self._reject(reply, "proxy_memory_limit_exceeded")
                    return
                row.bucket.force_take(count, now)   # peeked: affords
        self._class_enqueue(entry)
        self._note_depth()

    def _class_room(self, prio: int) -> bool:
        """Does the class FIFO have room? Immediate always does: it
        drains every tick, is never shed, and can hold at most one
        window's arrivals."""
        return prio >= PRIORITY_IMMEDIATE or \
            len(self._queues[prio]) < int(SERVER_KNOBS.grv_queue_max)

    def _class_enqueue(self, entry: Entry) -> None:
        """Append to the entry's class FIFO, honoring the depth bound
        — the one gatekeeper for every path into a class queue (fresh
        submits AND tag-queue releases)."""
        if not self._class_room(entry[2]):
            flow.cover("admission.queue_full")
            self.stats.counter("admission_rejected").add(1)
            self._reject(entry[0], "proxy_memory_limit_exceeded")
            return
        self._queues[entry[2]].append(entry)

    @staticmethod
    def _reject(reply, name: str) -> None:
        try:
            reply.send_error(error(name))
        except Exception:
            pass  # already answered

    # -- the per-window admission decision -------------------------------
    def tick(self, now: float, rate: float, batch_rate: float,
             interval: float) -> List[Entry]:
        """One GRV_BATCH_INTERVAL window: release tag-parked requests
        whose pacing allows, shed wait-bound violations, then admit in
        STRICT class order — immediate drains first and pays nothing,
        default pays the default bucket, batch drains last and pays
        BOTH buckets (so batch traffic starves first, exactly the
        separate batch limit's point). The returned batch is served
        with ONE causal-confirmation round trip."""
        k = SERVER_KNOBS
        # tag gate upkeep: expired rows free their parked queues; live
        # rows release at their commanded pace, FIFO (releases pass
        # through the same bounded class enqueue as fresh submits)
        for entry in self.tags.expire(now):
            self._class_enqueue(entry)
            self.stats.counter("throttle_released").add(1)
        # a tag-parked request past the wait bound is shed BEFORE the
        # release pass (never released-and-shed in one tick), and with
        # the TAG error — its wait was designed pacing, and labeling
        # it proxy overload would steer an operator at the wrong knob
        max_wait = float(SERVER_KNOBS.grv_queue_max_wait)
        for row in self.tags.rows.values():
            while row.queue and now - row.queue[0][3] > max_wait:
                flow.cover("admission.tag_wait_bound")
                self.stats.counter("throttle_rejected").add(1)
                self._reject(row.queue.popleft()[0], "tag_throttled")
        for row in self.tags.rows.values():
            while row.queue:
                cnt = row.queue[0][1]
                if not self._class_room(row.queue[0][2]):
                    # class queue full: stay parked (no token spent);
                    # the pacing resumes once admission drains room
                    break
                if row.bucket.try_take(cnt, now):
                    pass
                elif row.bucket.available(now) >= row.bucket.burst - 1e-9:
                    # a head bigger than the burst (a client-coalesced
                    # multi-transaction request) releases into DEBT at
                    # a full bucket — the refill repays it, so the
                    # average stays at the commanded tps and the head
                    # can never wedge the tag queue forever
                    flow.cover("admission.tag_debt")
                    row.bucket.force_take(cnt, now)
                else:
                    break
                entry = row.queue.popleft()
                self._class_enqueue(entry)
                self.stats.counter("throttle_released").add(1)
        # wait bound: a queued request past the bound is shed with the
        # retryable overflow error — bounded wait is the contract that
        # keeps ADMITTED latency meaningful under overload (FIFO, so
        # the head is always the oldest)
        for prio, q in self._queues.items():
            if prio >= PRIORITY_IMMEDIATE:
                continue   # immediate drains every tick; never shed
            while q and now - q[0][3] > max_wait:
                flow.cover("admission.wait_bound")
                self.stats.counter("admission_timed_out").add(1)
                self._reject(q.popleft()[0], "proxy_memory_limit_exceeded")

        burst_ivals = float(k.grv_burst_intervals)
        # the class buckets ALWAYS charge: with tag-throttling-only
        # armed (GRV_ADMISSION_CONTROL=0) these entries bypass the
        # legacy batcher, so the budget gate the batcher would have
        # applied must live here too — the rate fed in is the same
        # ratekeeper budget either way (undivided in that posture)
        self._default_bucket.set_rate(
            rate, rate * burst_ivals * interval, now)
        self._batch_bucket.set_rate(
            batch_rate, batch_rate * burst_ivals * interval, now)
        out: List[Entry] = []
        # immediate: never queued behind anything, never charged
        imm = self._queues[PRIORITY_IMMEDIATE]
        while imm:
            out.append(imm.popleft())
        if out:
            self.stats.counter("admission_admitted_immediate").add(
                sum(e[1] for e in out))
        # default: FIFO while the default bucket affords; an oversized
        # head with at least one token admits into debt (it could
        # never afford its count otherwise and would starve)
        admitted_default = 0
        dq = self._queues[PRIORITY_DEFAULT]
        while dq:
            cnt = dq[0][1]
            if self._default_bucket.try_take(cnt, now):
                pass
            elif not admitted_default and \
                    self._default_bucket.available(now) >= 1.0:
                flow.cover("admission.default_debt")
                self._default_bucket.force_take(cnt, now)
            else:
                break
            admitted_default += cnt
            out.append(dq.popleft())
        if admitted_default:
            self.stats.counter("admission_admitted_default").add(
                admitted_default)
        # batch: last, and pays BOTH buckets
        admitted_batch = 0
        bq = self._queues[PRIORITY_BATCH]
        while bq:
            cnt = bq[0][1]
            if self._batch_bucket.available(now) >= cnt and \
                    self._default_bucket.available(now) >= cnt:
                self._batch_bucket.force_take(cnt, now)
                self._default_bucket.force_take(cnt, now)
            elif not admitted_batch and not admitted_default and \
                    self._batch_bucket.available(now) >= 1.0 and \
                    self._default_bucket.available(now) >= 1.0:
                flow.cover("admission.batch_debt")
                self._batch_bucket.force_take(cnt, now)
                self._default_bucket.force_take(cnt, now)
            else:
                break
            admitted_batch += cnt
            out.append(bq.popleft())
        if admitted_batch:
            self.stats.counter("admission_admitted_batch").add(
                admitted_batch)
        self._note_depth()
        return out

    # -- surfaces --------------------------------------------------------
    def depth(self) -> int:
        return (sum(len(q) for q in self._queues.values())
                + self.tags.depth())

    def _note_depth(self) -> None:
        self.stats.counter("admission_queued_now").set(self.depth())

    def reply_throttles(self, tags, now: float) -> Tuple:
        return self.tags.reply_rows(tags, now)

    def status(self) -> dict:
        k = SERVER_KNOBS
        snap = self.stats.snapshot()
        return {
            "grv_admission_enabled": int(bool(k.grv_admission_control)),
            "tag_throttling_enabled": int(bool(k.tag_throttling)),
            "admitted": {
                name: snap.get(f"admission_admitted_{name}", 0)
                for name in ("immediate", "default", "batch")},
            "queued": {
                PRIORITY_NAMES[p]: len(q)
                for p, q in self._queues.items()},
            "rejected": snap.get("admission_rejected", 0),
            "timed_out": snap.get("admission_timed_out", 0),
            "throttle_delayed": snap.get("throttle_delayed", 0),
            "throttle_released": snap.get("throttle_released", 0),
            "throttle_rejected": snap.get("throttle_rejected", 0),
            "confirm_rounds": snap.get("grv_confirm_rounds", 0),
            "tag_rows": [r.doc() for r in sorted(
                self.tags.rows.values(), key=lambda r: r.tag)],
        }

    def shutdown(self) -> None:
        """Epoch over: break every queued request so stale clients fail
        over instead of hanging (same contract as the proxy's GRV
        drain)."""
        for q in self._queues.values():
            while q:
                self._reject(q.popleft()[0], "broken_promise")
        for row in self.tags.rows.values():
            while row.queue:
                self._reject(row.queue.popleft()[0], "broken_promise")
        self.tags.rows.clear()
