"""Ratekeeper: cluster-wide transaction admission control.

Reference: fdbserver/Ratekeeper.actor.cpp — a controller computes the
cluster's transactions-per-second budget from SMOOTHED per-storage
queue bytes, TLog queue bytes, and durability lag (updateRate,
:176-635), with a SEPARATE, lower limit for batch-priority traffic so
background work throttles before interactive work; proxies fetch both
rates periodically (GetRateInfoRequest, MasterProxyServer.actor.cpp:79)
and release batched GRV requests no faster than their share
(transactionStarter :1102).

Per-input controller (the reference's spring-zone shape): each storage
replica's MVCC-window bytes and each TLog's unpopped memory bytes are
exponentially smoothed (ref: fdbrpc/Smoother.h) and mapped through a
spring zone — full speed below (target - spring), linear decay inside
the zone, the survival trickle above target. Durability lag in excess
of the configured intent scales the result quadratically toward the
trickle as it approaches the MVCC window (beyond which reads fail with
transaction_too_old). Batch limits use a fraction of the targets, so
batch admission collapses first. A dead replica pins everything to the
trickle until it rejoins.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

from .. import flow
from ..flow import TaskPriority
# promoted to flow/smoother.py (with the non-increasing-clock clamp);
# re-exported here because the Smoother is historically this module's
# vocabulary and importers reach for it here
from ..flow.smoother import SmoothedRate, Smoother  # noqa: F401
from ..rpc import RequestStream, SimProcess
from .types import mutation_bytes

# limiting_reason vocabulary (ref: limitReason_t in Ratekeeper.actor.cpp
# — the reason string RkUpdate publishes beside the computed rate).
# Pinned by tests/test_qos_telemetry.py and the status.cluster.qos schema.
LIMIT_REASONS = ("none", "storage_queue", "tlog_queue", "durability_lag",
                 "pipeline_occupancy", "conflict_deferrals")


def _camel(s: str) -> str:
    """snake_case signal name -> the CamelCase TraceEvent detail key
    (RkUpdate fields read like the reference's)."""
    return "".join(p.capitalize() for p in s.split("_"))


class GetRateReply(NamedTuple):
    tps: float
    batch_tps: float = -1.0   # -1: pre-batch-limit peer (defaults to tps)


class Ratekeeper:
    def __init__(self, process: SimProcess, cc):
        self.process = process
        self.cc = cc
        self.rate = flow.SERVER_KNOBS.rk_max_rate
        self.batch_rate = flow.SERVER_KNOBS.rk_max_rate
        self.get_rate = RequestStream(process)
        self._storage_smooth: Dict[str, Smoother] = {}
        self._tlog_smooth: Dict[str, Smoother] = {}
        # resolve-pipeline forced-drain rate per resolver (the
        # backpressure counters as a throttle input)
        self._pipeline_smooth: Dict[str, SmoothedRate] = {}
        # admission-scheduler deferred-commit depth per proxy (the
        # conflict-prediction plane's pressure as a throttle input)
        self._sched_smooth: Dict[str, Smoother] = {}
        # the last decision with its input signals and limiting reason
        # — what RkUpdate traces and status.cluster.qos publish
        self.last_decision: dict = {}
        # the storage heat plane's observe-only inputs: the
        # hex tag behind busiest_read_tag_busyness, traced beside the
        # numeric inputs (enforcement is a later step)
        self._busiest_read_tag = ""
        # tag auto-throttler (server/tag_throttler.py):
        # busy tags per the proxies' TransactionTagCounter get throttle
        # rows written into \xff\x02/throttledTags/; idle (one knob
        # read per interval) while AUTO_TAG_THROTTLING is off
        from .tag_throttler import TagThrottler
        self.throttler = TagThrottler(process, cc)
        self._actors = flow.ActorCollection()

    def start(self) -> None:
        for coro, name in ((self._update_loop(), "update"),
                           (self._serve_loop(), "getRate"),
                           (self.throttler.run(), "tagThrottler")):
            self._actors.add(flow.spawn(coro, TaskPriority.RATEKEEPER,
                                        name=f"{self.process.name}.{name}"))
        self.process.on_kill(self._actors.cancel_all)

    def stop(self) -> None:
        self._actors.cancel_all()
        self.get_rate.close()

    def _served_rates(self):
        """What one polling proxy may admit. With enforced admission
        armed, the cluster budget is SPLIT across the current epoch's
        proxies (ref: GetRateInfoReply's transactionRate divided by
        proxy count in Ratekeeper.actor.cpp) — without the split, N
        proxies would each enforce the full budget and the cluster
        would admit N× what the controller computed. Off-posture
        serves the undivided rate, exactly as before."""
        tps, batch_tps = self.rate, self.batch_rate
        if flow.SERVER_KNOBS.grv_admission_control:
            n = max(1, len(self.cc.dbinfo.get().proxies))
            tps = tps / n
            if batch_tps >= 0:
                batch_tps = batch_tps / n
        return tps, batch_tps

    async def _serve_loop(self):
        while True:
            _req, reply = await self.get_rate.pop()
            reply.send(GetRateReply(*self._served_rates()))

    async def _update_loop(self):
        while True:
            await flow.delay(flow.SERVER_KNOBS.rk_update_interval,
                             TaskPriority.RATEKEEPER)
            self.rate, self.batch_rate = self._compute_rates()
            d = self.last_decision
            if d:
                # decision trace every interval (ref: the RkUpdate
                # TraceEvent updateRate emits: the computed rate, every
                # input signal, and WHY the limit is what it is)
                flow.TraceEvent("RkUpdate", self.process.name).detail(
                    TPSLimit=round(d["tps"], 1),
                    BatchTPSLimit=round(d["batch_tps"], 1),
                    LimitingReason=d["limiting_reason"],
                    BusiestReadTag=d.get("busiest_read_tag", ""),
                    **{_camel(kk): vv
                       for kk, vv in d["inputs"].items()}).log()

    @staticmethod
    def _spring_limit(queue: float, target: float, spring: float,
                      max_rate: float, min_rate: float) -> float:
        """Full speed below (target - spring); linear decay through the
        spring zone; the trickle at/above target (ref: the
        storage/tlog limit shape in updateRate)."""
        head = target - queue
        if head >= spring:
            return max_rate
        if head <= 0:
            return min_rate
        return max(min_rate, max_rate * head / spring)

    def _compute_rates(self):
        k = flow.SERVER_KNOBS
        info = self.cc.dbinfo.get()
        now = flow.now()
        window = k.max_write_transaction_life_versions
        min_rate, max_rate = k.rk_min_rate, k.rk_max_rate
        batch_frac = k.rk_batch_target_fraction
        tau = k.rk_smoothing_seconds
        limit, batch_limit = max_rate, max_rate
        # every input signal the decision saw, for RkUpdate + status
        inputs = {"worst_storage_queue_bytes": 0.0,
                  "worst_tlog_queue_bytes": 0.0,
                  "worst_durability_lag_versions": 0,
                  "pipeline_occupancy": 0.0,
                  "pipeline_forced_drain_rate": 0.0,
                  "sched_deferred_depth": 0.0,
                  # storage heat plane, observe-only: the
                  # worst read-hot density ratio and busiest per-SS
                  # read-tag busyness — zeros while the plane is off
                  "worst_read_hot": 0.0,
                  "busiest_read_tag_busyness": 0.0,
                  "dead_replicas": 0}
        self._busiest_read_tag = ""
        reason = "none"
        # the batch bucket has its own binding constraint (its spring
        # zone starts at target*batch_frac, well before the normal
        # one) — track its reason separately so a batch-only throttle
        # is never reported as "none"
        batch_reason = "none"

        def lower(new_limit, new_batch, why):
            nonlocal limit, batch_limit, reason, batch_reason
            if new_limit < limit:
                limit, reason = new_limit, why
            if new_batch < batch_limit:
                batch_limit, batch_reason = new_batch, why

        worst_excess = 0
        # one pass per REPLICA, not per (shard x replica): a server
        # holding many shards appears once (dedupe by name), and the
        # smoother dicts are pruned to the names seen this tick so
        # recoveries/moves cannot grow them without bound
        replicas = {rep.name for s in info.storages for rep in s.replicas}
        for name in sorted(replicas):
            obj = self.cc._storage_objs.get(name)
            if obj is None or not obj.process.alive:
                # a dead replica: lag is unbounded until it rejoins
                inputs["dead_replicas"] += 1
                inputs["worst_durability_lag_versions"] = window
                return self._decide(min_rate, min_rate,
                                    "durability_lag", inputs, now)
            if obj.kv is None:
                continue  # no engine: durability is inert (defensive)
            excess = (obj.version.get() - obj.durable_version.get()
                      - obj._lag)
            worst_excess = max(worst_excess, excess)
            # MVCC-window bytes not yet durable (ref: the smoothed
            # storage queue bytes in StorageQueuingMetrics)
            qbytes = sum(mutation_bytes(m)
                         for _v, ms in obj._pending for m in ms)
            sm = self._storage_smooth.get(name)
            if sm is None:
                sm = self._storage_smooth[name] = Smoother()
            q = sm.sample(qbytes, now, tau)
            inputs["worst_storage_queue_bytes"] = max(
                inputs["worst_storage_queue_bytes"], round(q, 1))
            t = k.rk_target_storage_queue_bytes
            sp = k.rk_spring_storage_queue_bytes
            lower(self._spring_limit(q, t, sp, max_rate, min_rate),
                  self._spring_limit(q, t * batch_frac, sp, max_rate,
                                     min_rate),
                  "storage_queue")
        for stale in set(self._storage_smooth) - replicas:
            del self._storage_smooth[stale]

        # storage heat inputs: observe-only — they ride
        # RkUpdate and status so an operator (and item 3's follow-up
        # enforcement) can SEE which sub-range and tag is hot before
        # any throttle acts on it; never an input to lower(). Read
        # from the CC's rollup (refreshed each QOS_SAMPLE_INTERVAL by
        # _roll_storage_heat) rather than rescanning every replica's
        # sample per ratekeeper tick — the update loop runs ~10x the
        # sampler cadence and must not multiply the scan cost
        if k.storage_heat_tracking:
            heat = getattr(self.cc, "storage_heat", None)
            if heat is not None:
                for row in heat.top():
                    inputs["worst_read_hot"] = max(
                        inputs["worst_read_hot"], row["density"])
            for _srv, (tag_hex, busy) in sorted(
                    getattr(self.cc, "_heat_tags", {}).items()):
                if busy > inputs["busiest_read_tag_busyness"]:
                    inputs["busiest_read_tag_busyness"] = round(busy, 2)
                    self._busiest_read_tag = tag_hex

        live_logs = set()
        for t_obj in self.cc.tlog_objs():
            live_logs.add(t_obj.name)
            sm = self._tlog_smooth.get(t_obj.name)
            if sm is None:
                sm = self._tlog_smooth[t_obj.name] = Smoother()
            q = sm.sample(t_obj.mem_bytes, now, tau)
            inputs["worst_tlog_queue_bytes"] = max(
                inputs["worst_tlog_queue_bytes"], round(q, 1))
            tt = k.rk_target_tlog_queue_bytes
            sp = k.rk_spring_tlog_queue_bytes
            lower(self._spring_limit(q, tt, sp, max_rate, min_rate),
                  self._spring_limit(q, tt * batch_frac, sp, max_rate,
                                     min_rate),
                  "tlog_queue")
            if len(t_obj.entries) > k.rk_tlog_backlog_limit:
                return self._decide(min_rate, min_rate, "tlog_queue",
                                    inputs, now)
        for stale in set(self._tlog_smooth) - live_logs:
            del self._tlog_smooth[stale]

        # resolve-pipeline backpressure (the forced-drain counters):
        # a sustained forced-drain rate means submits outrun the device
        # drain — the same spring-zone shape as the queue-byte inputs
        fd_target = k.rk_pipeline_forced_drain_limit
        if fd_target > 0:
            live_res = set()
            for rn, role in self._resolver_roles(info):
                live_res.add(rn)
                pipe = role.pipeline_stats()
                sm = self._pipeline_smooth.get(rn)
                if sm is None:
                    sm = self._pipeline_smooth[rn] = SmoothedRate()
                # tau per sample, like the storage/tlog smoothers — a
                # construction-time tau would freeze the knob
                fd_rate = sm.sample_total(pipe.get("forced_drains", 0),
                                          now, tau)
                inputs["pipeline_forced_drain_rate"] = max(
                    inputs["pipeline_forced_drain_rate"],
                    round(fd_rate, 2))
                inputs["pipeline_occupancy"] = max(
                    inputs["pipeline_occupancy"],
                    pipe.get("occupancy") or 0.0)
                sp = k.rk_pipeline_forced_drain_spring
                lower(self._spring_limit(fd_rate, fd_target, sp,
                                         max_rate, min_rate),
                      self._spring_limit(fd_rate, fd_target * batch_frac,
                                         sp, max_rate, min_rate),
                      "pipeline_occupancy")
            for stale in set(self._pipeline_smooth) - live_res:
                del self._pipeline_smooth[stale]

        # admission-scheduler deferral pressure: a deep
        # deferred-commit queue means admission is outrunning what the
        # hot ranges can serialize — throttle at the GRV gate BEFORE
        # the per-range queues overflow into racing aborts (same
        # spring-zone shape as the queue-byte inputs; 0 disables)
        sd_target = k.rk_sched_defer_limit
        if sd_target > 0:
            live_px = set()
            for pn, role in self._proxy_roles(info):
                live_px.add(pn)
                sm = self._sched_smooth.get(pn)
                if sm is None:
                    sm = self._sched_smooth[pn] = Smoother()
                q = sm.sample(role.scheduler.queue_depth(), now, tau)
                inputs["sched_deferred_depth"] = max(
                    inputs["sched_deferred_depth"], round(q, 2))
                sp = k.rk_sched_defer_spring
                lower(self._spring_limit(q, sd_target, sp,
                                         max_rate, min_rate),
                      self._spring_limit(q, sd_target * batch_frac, sp,
                                         max_rate, min_rate),
                      "conflict_deferrals")
            for stale in set(self._sched_smooth) - live_px:
                del self._sched_smooth[stale]

        # durability-lag excess scales everything quadratically toward
        # the trickle as it approaches the MVCC window
        inputs["worst_durability_lag_versions"] = max(0, worst_excess)
        target = window // 5    # distress threshold for excess lag
        if worst_excess >= window:
            return self._decide(min_rate, min_rate, "durability_lag",
                                inputs, now)
        if worst_excess > target:
            frac = 1.0 - (worst_excess - target) / max(1, window - target)
            lower(max(min_rate, max_rate * frac * frac), limit,
                  "durability_lag")
            if limit < batch_limit:
                # batch now binds on whatever binds the normal bucket
                batch_limit, batch_reason = limit, reason
        if limit >= max_rate:
            # normal-priority unthrottled — but the batch bucket may
            # still be engaged; report ITS reason rather than claiming
            # the cluster is unlimited while batch traffic is shed
            reason = batch_reason if batch_limit < max_rate else "none"
        return self._decide(limit, min(batch_limit, limit), reason,
                            inputs, now)

    def _epoch_roles(self, info, cls):
        """Live current-epoch roles of `cls` from the CC's registry —
        the shared cluster_controller.epoch_roles walk (lazy import:
        no module cycle, and fake-CC unit tests still only need a
        `workers` dict)."""
        from .cluster_controller import epoch_roles
        return epoch_roles(self.cc.workers, info.epoch, cls)

    def _resolver_roles(self, info):
        from .resolver_role import Resolver
        return self._epoch_roles(info, Resolver)

    def _proxy_roles(self, info):
        """The deferral-pressure input's source."""
        from .proxy import Proxy
        return self._epoch_roles(info, Proxy)

    def _decide(self, tps, batch_tps, reason, inputs, now):
        """Record the decision (rate + batch rate + limiting reason +
        every input signal) for RkUpdate tracing and status.cluster.qos,
        then return the (tps, batch_tps) pair the update loop expects."""
        self.last_decision = {
            "tps": tps, "batch_tps": batch_tps,
            "limiting_reason": reason, "inputs": inputs,
            "busiest_read_tag": self._busiest_read_tag,
            "computed_at": now}
        return tps, batch_tps


from ..rpc import wire as _wire

_wire.register_module(__name__)  # all NamedTuples here are RPC vocabulary
