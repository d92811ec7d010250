"""Tag throttling through the system keyspace: ratekeeper-side
auto-detection, the shared row reader, and the client-honored backoff.

Reference: fdbserver/Ratekeeper.actor.cpp monitorThrottlingChanges +
fdbclient/TagThrottle.actor.cpp — the ratekeeper watches per-tag
busyness reported by the proxies, writes AUTO throttle rows (tag,
priority, tps rate, expiry) under \\xff\\x02/throttledTags/, and
operators write MANUAL rows through `fdbcli throttle on|off|list`;
every GRV proxy watches the range and enforces the rates
(server/admission.py), and clients that receive tag-throttle info on a
GRV reply delay locally before their next request so the server sheds
work it never has to queue.

Three pieces:

- `TagThrottler` (mounted on the Ratekeeper): smooths each tag's
  started-transaction rate from the proxies' TransactionTagCounter
  rows; a tag past TAG_THROTTLE_BUSY_RATE gets an auto row
  cutting it to TAG_THROTTLE_TARGET_FRACTION of its observed rate for
  TAG_THROTTLE_DURATION. Rows are committed BLIND through the
  ordinary pipeline (no conflict ranges — last writer wins, and the
  throttler is the only auto writer), so manual and automatic
  throttles round-trip through the same durable keys. Expired auto
  rows are cleared by their writer; manual rows are never touched.
- `read_throttle_rows`: the proxy poll loop's raw storage-range read
  of the table (dbinfo shard walk, the RepairManager re-read idiom).
- `ClientTagThrottleCache`: per-Database cache of the (tag, tps,
  expiry) triples ridden in on GRV replies; `delay()` paces the next
  tagged GRV at the commanded rate (capped at
  CLIENT_TAG_BACKOFF_MAX), mirroring the conflict-window plumbing.

AUTO_TAG_THROTTLING=0 (default) disables detection; TAG_THROTTLING=0
disables enforcement and backoff. BUGGIFY arms both randomly.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .. import flow
from ..flow import SERVER_KNOBS, TaskPriority
from ..flow.smoother import SmoothedRate
from .systemkeys import (THROTTLED_TAGS_END, THROTTLED_TAGS_PREFIX,
                         encode_tag_throttle_value,
                         parse_tag_throttle_value, parse_throttled_tag_key,
                         throttled_tag_key)
from .types import (COMPARE_AND_CLEAR, SET_VALUE, CommitRequest,
                    MutationRef, PRIORITY_DEFAULT, StorageGetRangeRequest)

#: a parsed throttledTags row: (tag, tps, expiry, priority, auto)
ThrottleRow = Tuple[bytes, float, float, int, bool]


def _overlapping_shards(storages, begin: bytes, end: bytes):
    out = []
    for s in storages:
        if (s.end is None or begin < s.end) and s.begin < end:
            out.append(s)
    return out


async def read_throttle_rows(info, process, version: int) -> List[ThrottleRow]:
    """The throttledTags table read straight from storage at `version`
    (the proxy's committed version — what a client scan would see).
    Unparseable rows are skipped, the same skip-foreign-encodings
    contract every system-keyspace reader honors."""
    rows: List[ThrottleRow] = []
    if info is None or not info.storages:
        return rows
    for s in _overlapping_shards(info.storages, THROTTLED_TAGS_PREFIX,
                                 THROTTLED_TAGS_END):
        b = max(THROTTLED_TAGS_PREFIX, s.begin)
        e = (THROTTLED_TAGS_END if s.end is None
             else min(THROTTLED_TAGS_END, s.end))
        if b >= e or not s.replicas:
            continue
        kvs = await s.replicas[0].ranges.get_reply(
            StorageGetRangeRequest(b, e, version, 1 << 20), process)
        for key, value in kvs:
            tag = parse_throttled_tag_key(key)
            parsed = parse_tag_throttle_value(value)
            if tag is None or parsed is None:
                continue
            tps, expiry, priority, auto = parsed
            rows.append((tag, tps, expiry, priority, auto))
    return rows


class TagThrottler:
    """The ratekeeper's auto-throttler (ref: Ratekeeper's
    autoThrottleTags loop). Counters ride its own CounterCollection so
    the status doc can report detection activity beside the proxies'
    enforcement counters."""

    def __init__(self, process, cc):
        self.process = process
        self.cc = cc
        self.stats = flow.CounterCollection("tag_throttler")
        self._rates: Dict[bytes, SmoothedRate] = {}
        # per-(storage server, tag) read-request rate trackers — the
        # TAG_THROTTLE_STORAGE_BUSYNESS input: the
        # reference's ratekeeper reads tag busyness FROM the storage
        # servers, so a tenant hammering one shard is throttled even
        # when its cluster-wide rate looks modest
        self._ss_rates: Dict[tuple, SmoothedRate] = {}
        #: tag -> (expiry, exact encoded value) of the auto row WE
        #: wrote — the value is kept so expiry cleanup can use
        #: COMPARE_AND_CLEAR and can never delete a manual row an
        #: operator wrote over ours in the meantime
        self._written: Dict[bytes, tuple] = {}

    async def run(self) -> None:
        while True:
            interval = float(SERVER_KNOBS.tag_throttle_update_interval)
            await flow.delay(interval if interval > 0 else 1.0,
                             TaskPriority.RATEKEEPER)
            if not SERVER_KNOBS.auto_tag_throttling:
                continue
            try:
                await self._update()
            except flow.FdbError as e:
                if e.name == "operation_cancelled":
                    raise
                # a mid-recovery commit failure retries next tick

    def _proxy_roles(self, info):
        from .cluster_controller import epoch_roles
        from .proxy import Proxy
        return epoch_roles(self.cc.workers, info.epoch, Proxy)

    async def _update(self) -> None:
        k = SERVER_KNOBS
        info = self.cc.dbinfo.get()
        if not info.proxies:
            return
        now = flow.now()
        # cluster-wide per-tag started totals (the busyness source:
        # the TransactionTagCounter at every proxy)
        totals: Dict[bytes, int] = {}
        for _rn, role in self._proxy_roles(info):
            for row in role.tag_counter.top(1 << 20):
                tag = bytes.fromhex(row["tag"])
                totals[tag] = totals.get(tag, 0) + row["started"]
        tau = float(k.qos_smoothing_tau)
        # per-storage-server tag busyness: with the knob
        # armed, each (server, tag)'s smoothed read-request rate joins
        # the detection — the per-SS MAX is what a single hot shard
        # sees, which cluster-wide proxy rates dilute by design
        ss_busy: Dict[bytes, float] = {}
        if not (k.tag_throttle_storage_busyness
                and k.storage_heat_tracking):
            # disarmed mid-run: drop the accumulated (server, tag)
            # trackers — stale pairs must not pin memory or keep
            # reporting through tracked_ss_pairs
            if self._ss_rates:
                self._ss_rates.clear()
        else:
            live_ss: set = set()
            for name, obj in sorted(self.cc._storage_objs.items()):
                if not obj.process.alive:
                    continue
                for row in obj.tag_counter.top(1 << 20):
                    tag = bytes.fromhex(row["tag"])
                    key = (name, tag)
                    live_ss.add(key)
                    sm = self._ss_rates.get(key)
                    if sm is None:
                        sm = self._ss_rates[key] = SmoothedRate()
                    rate = sm.sample_total(row["started"], now, tau)
                    if rate > ss_busy.get(tag, 0.0):
                        ss_busy[tag] = rate
            for key in [kk for kk in self._ss_rates if kk not in live_ss]:
                del self._ss_rates[key]
        candidates = []   # busy tags due a (re)written auto row:
        #                   (tag, txn rate the tps command derives
        #                   from, the rate that crossed detection)
        for tag in sorted(set(totals) | set(ss_busy)):
            rate = 0.0
            if tag in totals:
                sm = self._rates.get(tag)
                if sm is None:
                    sm = self._rates[tag] = SmoothedRate()
                rate = sm.sample_total(totals[tag], now, tau)
            rate_eff = max(rate, ss_busy.get(tag, 0.0))
            if rate_eff < float(k.tag_throttle_busy_rate):
                continue
            if rate < float(k.tag_throttle_busy_rate):
                # only the per-SS signal crossed the line: the
                # storage-aware detection tag throttling steers by
                flow.cover("tag_throttler.storage_busyness")
            expiry = self._written.get(tag, (0.0, b""))[0]
            if expiry - now > float(k.tag_throttle_duration) / 2:
                continue   # the active row still covers the abuse
            candidates.append((tag, rate, rate_eff))
        # a live MANUAL row takes precedence over auto-throttling: the
        # operator's word stands, however busy the tag reads (ref:
        # manual throttles winning over auto in TagThrottle.actor.cpp)
        # — so the throttler reads what the table ACTUALLY holds
        # before writing, not just its own bookkeeping
        manual_live = set()
        if candidates and info.proxies[0].raw_committed is not None:
            from .types import RAW_COMMITTED_REQUEST
            ver = await flow.timeout_error(
                info.proxies[0].raw_committed.get_reply(
                    RAW_COMMITTED_REQUEST, self.process), 2.0)
            for tag, _tps, expiry, _prio, auto in await read_throttle_rows(
                    info, self.process, ver):
                if not auto and expiry > now:
                    manual_live.add(tag)
        mutations = []
        throttled = []   # (tag, rate, tps, new_expiry, value) pending
        for tag, txn_rate, rate in candidates:
            if tag in manual_live:
                flow.cover("tag_throttler.manual_precedence")
                continue
            # the commanded tps is in TRANSACTIONS/sec (what the
            # proxy's per-tag pacing bucket enforces), so it must
            # derive from the tag's txn rate — a storage-detected
            # read-heavy tenant (high read-request rate, modest txn
            # rate) would otherwise get a row far above its own txn
            # rate that never throttles anything
            tps = max(float(k.tag_throttle_min_tps),
                      txn_rate * float(k.tag_throttle_target_fraction))
            new_expiry = now + float(k.tag_throttle_duration)
            value = encode_tag_throttle_value(tps, new_expiry,
                                              PRIORITY_DEFAULT, auto=True)
            mutations.append(MutationRef(SET_VALUE,
                                         throttled_tag_key(tag), value))
            throttled.append((tag, rate, tps, new_expiry, value))
        # clear expired auto rows we wrote — via COMPARE_AND_CLEAR on
        # the EXACT value we committed, so an operator's manual row
        # written over ours in the meantime survives the cleanup
        # (last-writer-wins for sets; the janitor only ever removes
        # its own writes). A tag being REWRITTEN this very tick (its
        # old row expired while commits were failing, but it is still
        # busy) must not also be cleared — the clear would apply after
        # the set and kill the fresh row
        rewriting = {t for t, _r, _tp, _e, _v in throttled}
        cleared = [t for t, (exp, _v) in self._written.items()
                   if exp <= now and t not in rewriting]
        for tag in cleared:
            mutations.append(MutationRef(COMPARE_AND_CLEAR,
                                         throttled_tag_key(tag),
                                         self._written[tag][1]))
        # prune rate trackers for tags that vanished from the counters
        for tag in [t for t in self._rates
                    if t not in totals and t not in self._written]:
            del self._rates[tag]
        if not mutations:
            return
        # blind write through the ordinary commit pipeline: the rows
        # are durable, replicated data any reader can scan. The
        # bookkeeping applies only AFTER the commit returns — a failed
        # commit (swallowed by run()) must leave state claiming the
        # rows do NOT exist, so the next tick genuinely retries
        # instead of trusting a row that never landed
        await flow.timeout_error(
            info.proxies[0].commits.get_reply(
                CommitRequest(0, (), (), tuple(mutations)),
                self.process), 2.0)
        for tag, rate, tps, new_expiry, value in throttled:
            flow.cover("tag_throttler.auto_throttle")
            self._written[tag] = (new_expiry, value)
            self.stats.counter("auto_throttles").add(1)
            flow.TraceEvent("TagThrottleAuto", self.process.name).detail(
                Tag=tag.hex(), ObservedRate=round(rate, 1),
                ThrottleTps=round(tps, 2),
                Expiry=round(new_expiry, 2)).log()
        for tag in cleared:
            del self._written[tag]
            self._rates.pop(tag, None)
            self.stats.counter("auto_cleared").add(1)

    def status(self) -> dict:
        snap = self.stats.snapshot()
        return {
            "enabled": int(bool(SERVER_KNOBS.auto_tag_throttling)),
            "auto_throttles": snap.get("auto_throttles", 0),
            "auto_cleared": snap.get("auto_cleared", 0),
            "tracked_tags": len(self._rates),
            "active_auto": sorted(t.hex() for t in self._written),
            # storage-aware detection posture
            "storage_busyness_enabled": int(bool(
                SERVER_KNOBS.tag_throttle_storage_busyness)),
            "tracked_ss_pairs": len(self._ss_rates),
        }


# -- client side -------------------------------------------------------

#: process-wide client-backoff counters (the client_profile pattern:
#: every simulated client shares one collection, surfaced through
#: status.cluster.admission_control.client and the exporter)
g_client_throttle_stats = flow.CounterCollection("client_tag_throttle")


def note_backoff(seconds: float) -> None:
    g_client_throttle_stats.counter("backoffs").add(1)
    g_client_throttle_stats.counter("backoff_ms").add(
        int(seconds * 1000))


def client_throttle_counters() -> dict:
    return g_client_throttle_stats.snapshot()


class ClientTagThrottleCache:
    """Per-Database cache of server-advertised tag throttles (the
    client-honored-backoff half). A row is (tag, tps, expiry): until
    expiry, tagged GRVs pace themselves at tps locally — the delayed
    request never reaches the proxy's queue at all. Pacing state
    (`next_slot`) survives row refreshes so a renewed throttle cannot
    be gamed by re-arrival."""

    __slots__ = ("_rows",)

    def __init__(self):
        #: tag -> [tps, expiry, next_slot]
        self._rows: Dict[bytes, list] = {}

    def update(self, rows, now: float) -> None:
        for tag, tps, expiry in rows:
            ent = self._rows.get(tag)
            if ent is None:
                self._rows[tag] = [float(tps), float(expiry), now]
            else:
                ent[0] = float(tps)
                ent[1] = float(expiry)
        g_client_throttle_stats.counter("updates").add(1)
        g_client_throttle_stats.counter("tags_cached").set(len(self._rows))

    def delay(self, tags, now: float) -> float:
        """Seconds this tagged request should wait before its GRV
        (0.0 = go now). Advances the pacing slot — the caller is
        expected to proceed after waiting."""
        d = 0.0
        for tag in tags:
            ent = self._rows.get(tag)
            if ent is None:
                continue
            tps, expiry, nxt = ent
            if expiry <= now:
                del self._rows[tag]
                g_client_throttle_stats.counter("tags_cached").set(
                    len(self._rows))
                continue
            start = max(nxt, now)
            ent[2] = start + 1.0 / max(tps, 1e-6)
            d = max(d, start - now)
        return min(d, float(SERVER_KNOBS.client_tag_backoff_max))
