"""Resolver role: ordered conflict-batch processing over a pluggable
conflict-set backend.

Reference: fdbserver/Resolver.actor.cpp `resolveBatch` (:71) — batches
arrive tagged (prev_version, version); processing waits until the
resolver has seen prev_version (NotifiedVersion ordering, :104-115),
runs the ConflictSet (SkipList.cpp; here any backend behind the
create_conflict_set plugin seam: python / native C++ / cuda /
cuda-point / sharded-cuda), advances the window to
version - MAX_WRITE_TRANSACTION_LIFE_VERSIONS (:155), and replies one
verdict per transaction.
"""

from __future__ import annotations

from collections import deque

from .. import flow
from ..flow import SERVER_KNOBS, NotifiedVersion, TaskPriority
from ..models import ResolverTransaction, create_resilient_conflict_set
from ..models.conflict_set import clip_checkpoint, graft_checkpoint
from ..ops.fault_injection import DeviceFaultError
from ..rpc import RequestStream, SimProcess
from .critical_path import RolePathRecorder
from .types import (ResolutionMetricsReply, ResolveReply, ResolveRequest,
                    ResolverCheckpointReply, ResolverCheckpointRequest,
                    ResolverInstallRequest)


class ConflictHotSpots:
    """Decaying top-K table of conflict-causing key ranges (ref: the
    per-range busyness tracking behind FDB's hot-key/hot-shard
    telemetry — TransactionTagCounter / StorageMetrics byteSample style
    exponential decay, applied here to attributed conflict ranges).

    Each attributed range accumulates a score that halves every
    `half_life` seconds of simulated time, so a burst of aborts shows
    up immediately and ages out instead of pinning the table forever.
    Bounded at `max_entries` (lowest decayed score evicted); `top(k)`
    is the status/CLI surface and `rows(k)` the raw feed the CC pushes
    to the proxies' conflict predictors (server/scheduler.py).

    Half-life, capacity and top-K are LIVE-READ from the knobs when
    not pinned at construction, as the Smoother does; a
    construction-time read would freeze a cluster's later knob changes
    out of the decay math."""

    __slots__ = ("_half_life", "_max_entries", "_entries")

    def __init__(self, half_life: float = None, max_entries: int = None):
        self._half_life = half_life      # None -> live knob read
        self._max_entries = max_entries  # None -> live knob read
        # (begin, end) -> [decayed score, raw total, last update time,
        #                  last attributed conflict version]
        self._entries: dict = {}

    @property
    def half_life(self) -> float:
        return (self._half_life if self._half_life is not None
                else SERVER_KNOBS.hot_spot_half_life)

    @property
    def max_entries(self) -> int:
        return int(self._max_entries if self._max_entries is not None
                   else SERVER_KNOBS.hot_spot_max_entries)

    def _decayed(self, score: float, since: float, now: float) -> float:
        if now <= since or self.half_life <= 0:
            return score
        return score * 0.5 ** ((now - since) / self.half_life)

    def record(self, begin: bytes, end: bytes, weight: float = 1.0,
               version: int = 0) -> None:
        now = flow.now()
        ent = self._entries.get((begin, end))
        if ent is None:
            self._entries[(begin, end)] = [float(weight), 1, now, version]
        else:
            ent[0] = self._decayed(ent[0], ent[2], now) + weight
            ent[1] += 1
            ent[2] = now
            ent[3] = max(ent[3], version)
        # while, not if: a live-shrunk capacity knob drains the excess
        # instead of hovering one-in-one-out above the new bound
        while len(self._entries) > self.max_entries:
            worst = min(self._entries,
                        key=lambda k: self._decayed(
                            self._entries[k][0], self._entries[k][2], now))
            del self._entries[worst]

    def rows(self, k: int = None) -> list:
        """Raw decayed rows, hottest first: (begin, end, score, total,
        last attributed conflict version) — the conflict predictor /
        GRV conflict-window feed (bytes, unrounded)."""
        now = flow.now()
        out = [(b, e, self._decayed(s, t, now), total, ver)
               for (b, e), (s, total, t, ver) in self._entries.items()]
        out.sort(key=lambda r: (-r[2], r[0], r[1]))
        return out if k is None else out[:k]

    def top(self, k: int = None) -> list:
        """Status-ready rows, hottest first: decayed rate score + raw
        total per attributed range."""
        if k is None:
            k = int(SERVER_KNOBS.hot_spot_top_k)
        return [{"begin": b.hex(), "end": e.hex(),
                 "score": round(score, 4), "total": total}
                for b, e, score, total, _v in self.rows(k)]


class Resolver:
    def __init__(self, process: SimProcess, backend: str = "python",
                 recovery_version: int = 0, device=None, on_fatal=None,
                 backend_kwargs=None):
        self.process = process
        # called with a DeviceFaultError before it leaves an actor of
        # this role, so that the cluster hosting it stops instead of
        # recruiting a new resolver on the same card
        self.on_fatal = on_fatal
        # device backends arrive wrapped in the failover controller
        # (models/failover.py): checkpoint cadence, replay-log rebuild
        # on device faults, sampled shadow validation. `device=None` is
        # the card and raises NoCudaDeviceError on a host without one;
        # `device="cpu"` runs the kernels' plain versions. There is no
        # CPU failover: a device fault that outlasts the rebuilds
        # raises DeviceFaultError out of the resolve actor.
        # `backend_kwargs` go to the backend's factory (e.g. `devices`
        # for sharded-cuda: one shard a device)
        self.conflict_set = create_resilient_conflict_set(
            backend, recovery_version, device=device,
            **(backend_kwargs or {}))
        # the MVCC window width (ref: Knobs.cpp:35; BUGGIFY shrinks it)
        self._mwtlv = SERVER_KNOBS.max_write_transaction_life_versions
        self.version = NotifiedVersion(recovery_version)
        self.resolves = RequestStream(process)
        # load accounting for resolutionBalancing (ref: the resolver's
        # iopsSample, Resolver.actor.cpp:277-283)
        self.work_units = 0
        self.key_hist = [0] * 256
        self.metrics = RequestStream(process)
        self.stats = flow.CounterCollection("resolver")
        # banded + sampled batch-resolve latency (the resolver stage of
        # the commit pipeline; ref: LatencyBands in status)
        self.resolve_bands = flow.RequestLatency("resolve")
        # critical-path split: version-ordering wait vs
        # actual resolve service, recorded per accepted first delivery
        # while CRITICAL_PATH is armed
        self.path = RolePathRecorder("resolver")
        # decaying top-K table of conflict-causing key ranges, fed by
        # the backend's attribution on every batch (ref: the conflict
        # telemetry report_conflicting_keys exists to provide; the
        # conflict-aware scheduling literature presupposes exactly this
        # per-range signal)
        self.hot_spots = ConflictHotSpots()
        # QoS saturation signals: the resolve pipeline's occupancy and
        # forced-drain counters smoothed into the telemetry
        # plane — the Ratekeeper's pipeline_occupancy throttle input.
        # Pull model: qos_sample() reads pipeline_stats() on demand
        self._qos_forced_rate = flow.SmoothedRate()
        self._qos_batch_rate = flow.SmoothedRate()
        self._qos_txn_rate = flow.SmoothedRate()
        self._pressure_traced = False
        self._actors = flow.ActorCollection()
        # reply cache for duplicate delivery (proxy retry after a broken
        # reply): version -> verdicts, evicted incrementally once a
        # bounded number of newer batches exist
        # (ref: outstandingBatches, Resolver.actor.cpp:159,:241-257)
        self._reply_cache: dict[int, list[int]] = {}
        self._reply_order: deque[int] = deque()
        # batches submitted to the conflict backend but not yet drained
        # (the resolve-pipeline window): version -> (ticket, want_report,
        # txns). A duplicate delivered in this window drains the SAME
        # ticket (idempotent) instead of falling to conflict-everything.
        self._inflight: dict[int, tuple] = {}
        # a tiny cache stresses the duplicate-delivery fallback path
        self._cache_cap = 2 if flow.buggify("resolver/small_reply_cache") \
            else int(SERVER_KNOBS.resolver_reply_cache_size)
        # split/merge state-handoff endpoint: the balance
        # loop checkpoints a donor's clipped interval state here and
        # grafts it into the recipient — live handoff instead of a
        # full-MVCC-window double-delivery wait
        self.handoffs = RequestStream(process)
        self.last_handoff: "dict | None" = None
        # wall-clock deadline pacer for the modeled service cost: in a
        # non-virtual scheduler each sleep overshoots by OS-timer slop,
        # so charging cost per batch as independent delays understates
        # capacity; tracking the server's next-free deadline absorbs the
        # overshoot (virtual schedulers keep the exact flow.delay path)
        self._pace_free = 0.0

    def start(self) -> None:
        self._actors.add(flow.spawn(self._resolve_loop(),
                                    TaskPriority.PROXY_RESOLVER_REPLY,
                                    name=f"{self.process.name}.resolve"))
        self._actors.add(flow.spawn(self._metrics_loop(),
                                    TaskPriority.RESOLUTION_METRICS,
                                    name=f"{self.process.name}.metrics"))
        self._actors.add(flow.spawn(self._handoff_loop(),
                                    TaskPriority.RESOLUTION_METRICS,
                                    name=f"{self.process.name}.handoff"))
        self.process.on_kill(self._actors.cancel_all)

    def stop(self) -> None:
        self._actors.cancel_all()
        self.resolves.close()
        self.metrics.close()
        self.handoffs.close()

    async def _metrics_loop(self):
        while True:
            _req, reply = await self.metrics.pop()
            reply.send(ResolutionMetricsReply(self.work_units,
                                              tuple(self.key_hist)))

    async def _handoff_loop(self):
        while True:
            req, reply = await self.handoffs.pop()
            flow.spawn(self._serve_handoff(req, reply),
                       TaskPriority.RESOLUTION_METRICS)

    async def _serve_handoff(self, req, reply):
        """One state-handoff RPC. Checkpoint: wait out the
        version chain to the move's effective version (every pre-move
        batch is then in backend state — checkpoint() drains the
        resolve pipeline), cut the full checkpoint, clip the span.
        Install: graft the piece into the live state with pointwise max
        (models/conflict_set.graft_checkpoint), so writes this resolver
        already recorded since the move survive. Both run between batch
        submissions on the single-threaded loop, so the state they read
        and replace is never half a batch."""
        try:
            if isinstance(req, ResolverCheckpointRequest):
                if req.min_version:
                    await self.version.when_at_least(req.min_version)
                ckpt = self.conflict_set.checkpoint()
                piece = clip_checkpoint(ckpt, req.begin, req.end)
                self.stats.counter("split_checkpoints").add(1)
                self.last_handoff = {
                    "op": "checkpoint", "begin": req.begin.hex(),
                    "end": req.end.hex() if req.end is not None else "",
                    "version": self.version.get(),
                    "rows": len(piece.keys)}
                reply.send(ResolverCheckpointReply(piece,
                                                   self.version.get()))
            elif isinstance(req, ResolverInstallRequest):
                base = self.conflict_set.checkpoint()
                self.conflict_set.restore(
                    graft_checkpoint(base, req.piece))
                self.stats.counter("range_installs").add(1)
                self.last_handoff = {
                    "op": "install", "begin": req.begin.hex(),
                    "end": req.end.hex() if req.end is not None else "",
                    "version": self.version.get(),
                    "rows": len(req.piece.keys)}
                reply.send(self.version.get())
            else:
                reply.send_error(flow.error("client_invalid_operation"))
        except DeviceFaultError as e:
            # a lost device is not a bad piece: it fails the role
            self._fatal(e)
            raise
        except flow.FdbError as e:
            if e.name == "operation_cancelled":
                raise
            reply.send_error(e)
        except Exception as e:  # noqa: BLE001 — a bad piece fails itself
            flow.TraceEvent("ResolverHandoffFailed", self.process.name,
                            severity=flow.trace.SevWarnAlways).detail(
                Error=repr(e)).log()
            self.stats.counter("handoff_errors").add(1)
            reply.send_error(flow.error("internal_error"))

    def _fatal(self, e: DeviceFaultError) -> None:
        flow.TraceEvent("ResolverDeviceFault", self.process.name,
                        severity=flow.trace.SevError).detail(
            Error=str(e)).log()
        if self.on_fatal is not None:
            self.on_fatal(e)

    @staticmethod
    def _mark(req, location):
        flow.g_trace_batch.add_events(getattr(req, "debug_ids", ()),
                                      "CommitDebug", location)

    async def _resolve_loop(self):
        while True:
            req, reply = await self.resolves.pop()
            flow.spawn(self._resolve_batch(req, reply),
                       TaskPriority.PROXY_RESOLVER_REPLY)

    async def _charge_cost(self, amount: float):
        """Charge modeled service time. Virtual scheduler: the exact
        historical flow.delay (byte-identical sim pins). Wall clock: a
        deadline pacer — the resolver is a serial server whose next-free
        instant advances by `amount` per batch; sleeping to the deadline
        (rather than for the amount) absorbs per-sleep OS overshoot, so
        measured capacity matches the model at 1/cost txn/s."""
        sched = flow.get_scheduler()
        if sched is not None and not sched.virtual:
            now = flow.now()
            self._pace_free = max(self._pace_free, now) + amount
            wait = self._pace_free - now
            if wait > 0:
                await flow.delay(wait, TaskPriority.PROXY_RESOLVER_REPLY)
            return
        await flow.delay(amount, TaskPriority.PROXY_RESOLVER_REPLY)

    async def _resolve_batch(self, req: ResolveRequest, reply):
        t0 = flow.now()
        # order batches by version, whatever the arrival order
        await self.version.when_at_least(req.prev_version)
        if self.version.get() >= req.version:
            # duplicate delivery (e.g. proxy retry): a batch still in
            # the resolve-pipeline window (submitted, version advanced,
            # verdicts not yet read back) drains the same ticket and
            # replies identically; otherwise replay the cached verdicts
            # so a retrying proxy cannot livelock
            # (ref: Resolver.actor.cpp:241-257). Conflict-everything only
            # if the entry aged out of the window.
            pend = self._inflight.get(req.version)
            if pend is not None:
                flow.cover("resolver.reply_cache.inflight_dup")
                ticket, want_report, txns = pend
                verdicts, attributions = \
                    self.conflict_set.drain_with_attribution(ticket)
                reply.send(self._build_payload(
                    txns, verdicts, attributions, want_report,
                    record_hot=False, version=req.version))
                return
            cached = self._reply_cache.get(req.version)
            flow.cover("resolver.reply_cache.hit", cached is not None)
            flow.cover("resolver.reply_cache.aged_out", cached is None)
            reply.send(cached if cached is not None
                       else [0] * len(req.transactions))
            return
        # resolver-leg stations + spans fire only on ACCEPTED first
        # deliveries (after the duplicate check): a proxy retry must
        # not file a phantom second resolver leg — or an unpaired
        # opening station — into the sampled stitching. Named for
        # where it sits (ref: the reference's post-version-ordering
        # AfterQueueSorted station) so a prev_version stall reads as
        # in-resolver ordering wait, not proxy->resolver network time.
        # Spans auto-parent onto the proxy's open commitBatch span.
        self._mark(req, "Resolver.resolveBatch.AfterQueueSorted")
        # wait segment closed: everything before this point was
        # version-ordering; everything after is service
        t_sorted = flow.now() if SERVER_KNOBS.critical_path else t0
        spans = flow.g_trace_batch.begin_spans(
            getattr(req, "debug_ids", ()), "Resolver.resolveBatch")
        try:
            txns = [ResolverTransaction(t.read_snapshot,
                                        t.read_conflict_ranges,
                                        t.write_conflict_ranges)
                    for t in req.transactions]
            for t in txns:
                for b, _e in t.read_ranges:
                    self.key_hist[b[0] if b else 0] += 1
                for b, _e in t.write_ranges:
                    self.key_hist[b[0] if b else 0] += 1
                self.work_units += len(t.read_ranges) + len(t.write_ranges)
            # repairable transactions need the cause mask at the proxy
            # even when the client never asked to SEE it — repair
            # (server/repair.py) keys off exactly the attributed reads.
            # Gated on the knob: with TXN_REPAIR off the declaration
            # rides the wire inert, costing no attribution payload
            repair_on = bool(SERVER_KNOBS.txn_repair)
            want_report = any(
                getattr(t, "report_conflicting_keys", False)
                or (repair_on and getattr(t, "repairable", False))
                for t in req.transactions)
            # modeled resolution service time (SIM_RESOLVE_COST_PER_TXN,
            # default 0 = off): charged BEFORE the version chain
            # advances, so the resolver is a genuine serial server at
            # 1/cost txn/s — the system bench's saturation model
            # (tools/clusterbench.py; resolution cost is the quantity
            # the source paper scales against, arXiv:1804.00947). Only
            # first-delivery batches with transactions pay.
            cost = float(SERVER_KNOBS.sim_resolve_cost_per_txn)
            if cost > 0 and txns:
                await self._charge_cost(cost * len(txns))
            new_oldest = max(0, req.version - self._mwtlv)
            attributions = None
            verdicts = None
            try:
                # split submit/drain: the dispatch is queued WITHOUT
                # blocking on any result, the version chain advances at
                # submit time, and this actor yields once — so successor
                # batches submit while this one's verdict D2H is still
                # in flight. Up to RESOLVE_PIPELINE_DEPTH batches
                # overlap end to end with the proxy's
                # batch_resolving/batch_logging interlocks.
                ticket = self.conflict_set.submit(
                    txns, req.version, new_oldest, attribute=True)
            except (ValueError, OverflowError) as e:
                # A malformed batch (e.g. a key wider than the backend's key
                # bucket) must not wedge the pipeline: conflict the whole
                # batch — clients see not_committed and retry — and still
                # advance the version so later batches proceed.
                flow.cover("resolver.batch.rejected")
                flow.TraceEvent("ResolverBatchRejected", self.process.name,
                                severity=flow.trace.SevWarnAlways).detail(
                    Version=req.version, Error=str(e)).log()
                verdicts = [0] * len(req.transactions)
                self.conflict_set.resolve([], req.version, new_oldest)
                self.version.set(req.version)
            if verdicts is None:
                self._inflight[req.version] = (ticket, want_report, txns)
                self.version.set(req.version)
                await flow.delay(0, TaskPriority.PROXY_RESOLVER_REPLY)
                verdicts, attributions = \
                    self.conflict_set.drain_with_attribution(ticket)
            payload = self._build_payload(txns, verdicts, attributions,
                                          want_report, record_hot=True,
                                          version=req.version)
            self._reply_cache[req.version] = payload
            self._reply_order.append(req.version)
            while len(self._reply_order) > self._cache_cap:
                self._reply_cache.pop(self._reply_order.popleft(), None)
            self._mark(req, "Resolver.resolveBatch.After")
            self.stats.counter("batches_resolved").add(1)
            self.stats.counter("transactions_resolved").add(len(txns))
            done = flow.now()
            self.resolve_bands.record(done - t0)
            if SERVER_KNOBS.critical_path:
                self.path.record(t_sorted - t0, done - t_sorted)
            reply.send(payload)
            self._check_state_pressure(req.version)
        except DeviceFaultError as e:
            self._fatal(e)
            raise
        finally:
            self._inflight.pop(req.version, None)
            flow.g_trace_batch.finish_spans(spans)

    def _build_payload(self, txns, verdicts, attributions, want_report,
                       record_hot: bool, version: int = 0):
        """Attribution -> actual key ranges: feed the hot-spot table
        (first delivery only — a duplicate must not double-count; the
        batch version rides along as the range's last-conflict
        version, the client conflict windows' staleness anchor) and
        build the per-txn reply payload when some txn asked for
        report_conflicting_keys."""
        ranges_per_txn = [()] * len(txns)
        if attributions is not None:
            n_attr = 0
            for t, idxs in enumerate(attributions):
                if not idxs:
                    continue
                rs = tuple(txns[t].read_ranges[i] for i in idxs)
                ranges_per_txn[t] = rs
                if record_hot:
                    n_attr += len(rs)
                    for b, e in rs:
                        self.hot_spots.record(b, e, version=version)
            if record_hot and n_attr:
                self.stats.counter("conflict_ranges_attributed").add(n_attr)
        return (ResolveReply(tuple(verdicts), tuple(ranges_per_txn))
                if want_report else verdicts)

    def kernel_stats(self) -> dict:
        """The conflict backend's device-kernel profile (occupancy,
        compile/execute accounting) for the status document; {} for
        host-only backends."""
        return self.conflict_set.kernel_stats()

    def pipeline_stats(self) -> dict:
        """The resolve pipeline's window accounting (in-flight depth,
        queue occupancy, submit-vs-drain latency bands) — every backend
        has it, so a stalled pipeline is visible in status without a
        bench run."""
        return self.conflict_set.pipeline_stats()

    def failover_stats(self) -> dict:
        """Backend fault-tolerance accounting (checkpoints, device
        faults/recoveries, failovers, replay, shadow validation) —
        populated only when the backend runs under the failover
        controller; {} for bare host backends."""
        fn = getattr(self.conflict_set, "failover_stats", None)
        return fn() if fn is not None else {}

    def qos_sample(self, now: float) -> "QosSample":
        """Saturation-signal snapshot: the resolve pipeline's window
        accounting as smoothed QoS signals — occupancy (mean in-flight
        over depth), in-flight now, the forced-drain rate (submits that
        hit the depth backpressure — the 'device is not draining fast
        enough' signal), batch/txn rates, and the history row count."""
        from .types import QosSample
        pipe = self.pipeline_stats()
        snap = self.stats.snapshot()
        return QosSample("resolver", self.process.name, now, {
            "pipeline_occupancy": pipe.get("occupancy") or 0.0,
            "pipeline_in_flight": pipe.get("in_flight", 0),
            "pipeline_depth": pipe.get("depth", 1),
            "forced_drain_rate": round(self._qos_forced_rate.sample_total(
                pipe.get("forced_drains", 0), now), 2),
            "batch_rate": round(self._qos_batch_rate.sample_total(
                snap.get("batches_resolved", 0), now), 2),
            "txn_rate": round(self._qos_txn_rate.sample_total(
                snap.get("transactions_resolved", 0), now), 2),
            "state_rows": self.state_size(),
        })

    def state_size(self) -> int:
        """Conflict-history row estimate across backends (boundary rows
        for interval backends; a bisect-list length for the Python
        baseline)."""
        cs = self.conflict_set
        ic = getattr(cs, "interval_count", None)
        if ic is not None:
            # a method on the native backend, a property on the device
            # backends (incl. tpu-point) — support both
            return int(ic() if callable(ic) else ic)
        return len(getattr(cs, "_keys", ()))

    def _check_state_pressure(self, version: int) -> None:
        """(ref: the resolver memory back-pressure, Resolver.actor.cpp
        :91-98 — state beyond RESOLVER_STATE_MEMORY_LIMIT is a red
        flag: the window GC is not keeping up with the write rate.
        Interpreted here as a row count; surfaced via trace + counter
        so ratekeeper/status consumers can see it.)"""
        size = self.state_size()
        self.stats.counter("state_rows").set(size)
        limit = flow.SERVER_KNOBS.resolver_state_memory_limit
        if size > limit and not self._pressure_traced:
            self._pressure_traced = True
            flow.TraceEvent("ResolverStatePressure", self.process.name,
                            severity=flow.trace.SevWarnAlways).detail(
                Rows=size, Limit=limit, Version=version).log()
        elif size <= limit:
            self._pressure_traced = False
