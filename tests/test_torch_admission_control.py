"""The reference's cases of tests/test_admission_control.py on the port's
SimCluster, the CLI's throttle case and the exporter case among them.

Enforced admission control: GRV token
buckets, strict priority ordering, bounded queues with retryable
rejection, tag throttling through \\xff\\x02/throttledTags/, the
ratekeeper's per-proxy budget split, client-honored backoff, and the
off-posture byte-identical GRV path.

Ref: fdbserver/GrvProxyServer.actor.cpp transactionStarter +
GrvTransactionRateInfo, GrvProxyTransactionTagThrottler,
fdbclient/TagThrottle.actor.cpp.
"""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import flow  # noqa: E402
from foundationdb_tpu_torch.client import run_transaction  # noqa: E402
from foundationdb_tpu_torch.server import SimCluster  # noqa: E402
from foundationdb_tpu_torch.server import systemkeys as sk  # noqa: E402
from foundationdb_tpu_torch.server.admission import (GrvAdmissionQueues,  # noqa: E402
                                               TokenBucket)
from foundationdb_tpu_torch.server.tag_throttler import (  # noqa: E402
    ClientTagThrottleCache, client_throttle_counters)
from foundationdb_tpu_torch.server.types import (GetReadVersionReply,  # noqa: E402
                                           GetReadVersionRequest,
                                           PRIORITY_BATCH,
                                           PRIORITY_DEFAULT,
                                           PRIORITY_IMMEDIATE)
from foundationdb_tpu_torch.tools.cli import Cli  # noqa: E402


def _entry(count=1, prio=PRIORITY_DEFAULT, t0=0.0, tags=()):
    return (flow.Future(), count, prio, t0, tuple(tags))


def _queues():
    return GrvAdmissionQueues(None, flow.CounterCollection("adm_test"))


def _reset():
    flow.reset_server_knobs(randomize=False)


# -- token-bucket math (directed) --------------------------------------

def test_token_bucket_refill_and_burst():
    b = TokenBucket(rate=100.0, burst=50.0, now=0.0)
    assert b.available(0.0) == 0.0
    assert abs(b.available(0.1) - 10.0) < 1e-9
    assert b.try_take(5, 0.1)
    assert abs(b.tokens - 5.0) < 1e-9
    # refill caps at the burst allowance, however long the idle
    assert abs(b.available(10.0) - 50.0) < 1e-9
    assert not b.try_take(51, 10.0)        # over the cap: never
    assert b.try_take(50, 10.0)            # exactly the cap: fine


def test_token_bucket_rate_change_refills_at_old_rate():
    b = TokenBucket(rate=10.0, burst=100.0, now=0.0)
    b.set_rate(1000.0, 100.0, 1.0)
    # the elapsed second accrued at the OLD 10/s, not the new 1000/s
    assert abs(b.tokens - 10.0) < 1e-9


def test_token_bucket_zero_rate_is_full_stop():
    b = TokenBucket(rate=100.0, burst=100.0, now=0.0)
    assert b.available(1.0) == 100.0
    b.set_rate(0.0, 1.0, 1.0)
    # a zero rate confiscates accrued tokens too (emergency throttle)
    assert b.available(2.0) == 0.0
    assert not b.try_take(1, 3.0)


def test_token_bucket_debt_repaid_by_refill():
    b = TokenBucket(rate=10.0, burst=10.0, now=0.0)
    b.force_take(5, 0.0)
    assert b.tokens == -5.0
    assert not b.try_take(1, 0.4)          # -5 + 4 = -1: still in debt
    assert b.try_take(1, 1.0)              # -1 + 6 = 5: repaid


# -- strict priority ordering (directed; the acceptance pin) -----------

def test_immediate_never_queued_behind_default_or_batch():
    """A full default queue and a starved batch queue: an IMMEDIATE
    request submitted LAST is still admitted FIRST, paying no tokens;
    defaults take what the bucket affords; batch gets nothing while
    defaults drain (batch starves first)."""
    flow.SERVER_KNOBS.set("grv_admission_control", 1)
    try:
        q = _queues()
        defaults = [_entry(prio=PRIORITY_DEFAULT, t0=0.0)
                    for _ in range(20)]
        batch = [_entry(prio=PRIORITY_BATCH, t0=0.0) for _ in range(5)]
        for e in defaults + batch:
            q.submit(e, 0.0)
        imm = _entry(prio=PRIORITY_IMMEDIATE, t0=0.0)
        q.submit(imm, 0.0)
        # first tick (cold buckets, zero tokens): the immediate — and
        # ONLY the immediate — is admitted, instantly, uncharged
        out1 = q.tick(0.0, rate=2.0, batch_rate=1.0, interval=1.0)
        assert [e[0] for e in out1] == [imm[0]], out1
        # 2 tokens accrued at 2/s: two defaults admitted, batch starved
        out2 = q.tick(1.0, rate=2.0, batch_rate=1.0, interval=1.0)
        assert [e[2] for e in out2] == [PRIORITY_DEFAULT] * 2, out2
        # a late immediate still never waits, tick after tick, and
        # sorts strictly ahead of any simultaneously admitted class
        imm2 = _entry(prio=PRIORITY_IMMEDIATE, t0=1.0)
        q.submit(imm2, 1.0)
        out3 = q.tick(2.0, rate=2.0, batch_rate=1.0, interval=1.0)
        assert out3[0][0] is imm2[0], out3
        prios = [e[2] for e in out3]
        assert prios == sorted(prios, reverse=True)
    finally:
        _reset()


def test_batch_admits_only_after_defaults_drain():
    flow.SERVER_KNOBS.set("grv_admission_control", 1)
    try:
        q = _queues()
        for _ in range(3):
            q.submit(_entry(prio=PRIORITY_DEFAULT, t0=0.0), 0.0)
        for _ in range(3):
            q.submit(_entry(prio=PRIORITY_BATCH, t0=0.0), 0.0)
        q.tick(0.0, rate=100.0, batch_rate=100.0, interval=1.0)
        out = q.tick(1.0, rate=100.0, batch_rate=100.0, interval=1.0)
        # generous budget: everything admits, defaults strictly first
        prios = [e[2] for e in out]
        assert prios == [PRIORITY_DEFAULT] * 3 + [PRIORITY_BATCH] * 3
    finally:
        _reset()


def test_queue_depth_bound_rejects_retryable():
    flow.SERVER_KNOBS.set("grv_admission_control", 1)
    flow.SERVER_KNOBS.set("grv_queue_max", 2)
    try:
        q = _queues()
        entries = [_entry() for _ in range(3)]
        for e in entries:
            q.submit(e, 0.0)
        assert not entries[0][0].is_ready
        assert not entries[1][0].is_ready
        assert entries[2][0].is_error
        err = entries[2][0].exception()
        assert err.name == "proxy_memory_limit_exceeded"
        assert err.is_retryable()
        # immediate is EXEMPT from the depth bound: it drains every
        # tick and is never shed, whatever the bound says
        imms = [_entry(prio=PRIORITY_IMMEDIATE) for _ in range(5)]
        for e in imms:
            q.submit(e, 0.0)
        assert not any(e[0].is_ready for e in imms)
    finally:
        _reset()


def test_tag_gate_runs_before_class_depth_bound():
    """A pace-limited tagged request parks at the tag gate even while
    the class queue is full — it never occupies a class slot, so the
    depth bound must not judge it."""
    flow.SERVER_KNOBS.set("grv_admission_control", 1)
    flow.SERVER_KNOBS.set("tag_throttling", 1)
    flow.SERVER_KNOBS.set("grv_queue_max", 2)
    try:
        q = _queues()
        q.tags.install([(b"t", 0.001, 1000.0, PRIORITY_DEFAULT, False)],
                       0.0)
        q.submit(_entry(tags=(b"t",)), 0.0)   # burst token, queued
        q.submit(_entry(), 0.0)               # class queue now full
        tagged = _entry(tags=(b"t",))
        q.submit(tagged, 0.0)
        assert not tagged[0].is_ready          # parked, not rejected
        assert q.tags.depth() == 1
    finally:
        _reset()


def test_wait_bound_sheds_queued_but_never_immediate():
    flow.SERVER_KNOBS.set("grv_admission_control", 1)
    flow.SERVER_KNOBS.set("grv_queue_max_wait", 2.0)
    try:
        q = _queues()
        stale = _entry(prio=PRIORITY_DEFAULT, t0=0.0)
        q.submit(stale, 0.0)
        imm = _entry(prio=PRIORITY_IMMEDIATE, t0=0.0)
        q.submit(imm, 0.0)
        out = q.tick(10.0, rate=0.0, batch_rate=0.0, interval=1.0)
        # the default was shed with the retryable overflow error; the
        # immediate (same age) was ADMITTED — never shed, never queued
        assert stale[0].is_error
        assert stale[0].exception().name == "proxy_memory_limit_exceeded"
        assert any(e[0] is imm[0] for e in out)
        # the wait bound is a live-read knob
        flow.SERVER_KNOBS.set("grv_queue_max_wait", 100.0)
        old = _entry(prio=PRIORITY_DEFAULT, t0=5.0)
        q.submit(old, 11.0)
        q.tick(12.0, rate=0.0, batch_rate=0.0, interval=1.0)
        assert not old[0].is_error   # 7s old, bound now 100s
    finally:
        _reset()


# -- tag throttling (directed) -----------------------------------------

def test_tag_bucket_paces_parks_and_releases():
    flow.SERVER_KNOBS.set("tag_throttling", 1)
    try:
        q = _queues()
        q.tags.install([(b"t", 2.0, 100.0, PRIORITY_DEFAULT, True)], 0.0)
        first = _entry(tags=(b"t",), t0=0.0)
        second = _entry(tags=(b"t",), t0=0.0)
        q.submit(first, 0.0)
        q.submit(second, 0.0)
        q.tick(0.0, rate=1e6, batch_rate=1e6, interval=0.001)  # warm up
        # first took the row's single burst token; second is parked
        out = q.tick(0.01, rate=1e6, batch_rate=1e6, interval=0.001)
        assert any(e[0] is first[0] for e in out)
        assert not any(e[0] is second[0] for e in out)
        assert q.tags.depth() == 1
        # at 2 tps the parked request releases after ~0.5s
        out2 = q.tick(0.6, rate=1e6, batch_rate=1e6, interval=0.001)
        assert any(e[0] is second[0] for e in out2)
        assert q.tags.depth() == 0
    finally:
        _reset()


def test_tag_throttle_expiry_frees_parked_requests():
    flow.SERVER_KNOBS.set("tag_throttling", 1)
    try:
        q = _queues()
        q.tags.install([(b"t", 0.001, 1.0, PRIORITY_DEFAULT, False)], 0.0)
        a = _entry(tags=(b"t",), t0=0.0)
        b = _entry(tags=(b"t",), t0=0.0)
        q.submit(a, 0.0)   # takes the burst token
        q.submit(b, 0.0)   # parked at 0.001 tps: effectively forever
        assert q.tags.depth() == 1
        q.tick(0.0, rate=1e6, batch_rate=1e6, interval=0.001)  # warm up
        # the row expires at t=1: the parked request flows immediately
        out = q.tick(1.5, rate=1e6, batch_rate=1e6, interval=0.001)
        assert any(e[0] is b[0] for e in out)
        assert not q.tags.rows
    finally:
        _reset()


def test_tag_queue_bound_is_live_read():
    flow.SERVER_KNOBS.set("tag_throttling", 1)
    flow.SERVER_KNOBS.set("tag_throttle_queue_max", 1)
    try:
        q = _queues()
        q.tags.install([(b"t", 0.001, 100.0, PRIORITY_DEFAULT, False)],
                       0.0)
        q.submit(_entry(tags=(b"t",)), 0.0)   # burst token
        parked = _entry(tags=(b"t",))
        q.submit(parked, 0.0)                 # parked (bound 1)
        rejected = _entry(tags=(b"t",))
        q.submit(rejected, 0.0)
        assert rejected[0].is_error
        assert rejected[0].exception().name == "tag_throttled"
        assert rejected[0].exception().is_retryable()
        # live-read: widen the bound, the next one parks instead
        flow.SERVER_KNOBS.set("tag_throttle_queue_max", 10)
        ok = _entry(tags=(b"t",))
        q.submit(ok, 0.0)
        assert not ok[0].is_ready
        assert q.tags.depth() == 2
    finally:
        _reset()


def test_tag_throttling_only_posture_still_enforces_budget():
    """With TAG_THROTTLING armed but GRV_ADMISSION_CONTROL off, every
    GRV routes through the admission plane INSTEAD of the legacy
    rate-gated batcher — so the class buckets must still charge the
    ratekeeper budget, or arming tag throttling alone would silently
    disable all rate enforcement."""
    flow.SERVER_KNOBS.set("tag_throttling", 1)
    try:
        q = _queues()
        for _ in range(20):
            q.submit(_entry(prio=PRIORITY_DEFAULT, t0=0.0), 0.0)
        q.tick(0.0, rate=2.0, batch_rate=2.0, interval=1.0)
        out = q.tick(1.0, rate=2.0, batch_rate=2.0, interval=1.0)
        assert len(out) == 2, out      # the budget, not the queue
    finally:
        _reset()


def test_oversized_tag_head_releases_into_debt():
    """A client-coalesced GRV carrying several transactions under one
    throttled tag must still release (paced, into bucket debt) — a
    burst-1 bucket that can never afford count>=2 would wedge the tag
    queue until the wait bound sheds it."""
    flow.SERVER_KNOBS.set("tag_throttling", 1)
    flow.SERVER_KNOBS.set("grv_queue_max_wait", 1000.0)
    try:
        q = _queues()
        q.tags.install([(b"t", 2.0, 1000.0, PRIORITY_DEFAULT, False)],
                       0.0)
        q.submit(_entry(count=1, tags=(b"t",)), 0.0)   # burst token
        big = _entry(count=3, tags=(b"t",))
        q.submit(big, 0.0)
        assert q.tags.depth() == 1
        # at 2 tps the bucket refills to its burst (1.0) after 0.5s and
        # the oversized head force-releases into debt
        q.tick(0.0, rate=1e6, batch_rate=1e6, interval=0.001)
        out = q.tick(0.6, rate=1e6, batch_rate=1e6, interval=0.001)
        assert any(e[0] is big[0] for e in out), out
        assert q.tags.depth() == 0
        # the debt keeps the average at the commanded pace: the next
        # single-count request waits out the 3-token debt (~1.5s more)
        nxt = _entry(count=1, tags=(b"t",))
        q.submit(nxt, 0.6)
        out2 = q.tick(1.0, rate=1e6, batch_rate=1e6, interval=0.001)
        assert not any(e[0] is nxt[0] for e in out2)
        out3 = q.tick(2.7, rate=1e6, batch_rate=1e6, interval=0.001)
        assert any(e[0] is nxt[0] for e in out3), out3
    finally:
        _reset()


def test_tag_parked_wait_bound_sheds_with_tag_error():
    """A tag-parked request past the wait bound was waiting on
    DESIGNED pacing, not proxy overload — it must shed with
    tag_throttled and count throttle_rejected, or the counters steer
    an operator at the wrong knob."""
    flow.SERVER_KNOBS.set("tag_throttling", 1)
    flow.SERVER_KNOBS.set("grv_queue_max_wait", 2.0)
    try:
        q = _queues()
        q.tags.install([(b"t", 0.001, 1000.0, PRIORITY_DEFAULT, False)],
                       0.0)
        first = _entry(tags=(b"t",), t0=0.0)
        q.submit(first, 0.0)                       # burst token: queued
        parked = _entry(tags=(b"t",), t0=0.0)
        q.submit(parked, 0.0)
        q.tick(10.0, rate=1e6, batch_rate=1e6, interval=0.001)
        # the CLASS-queued entry aged out of the class queue: proxy
        # overflow is ITS honest label...
        assert first[0].is_error
        assert first[0].exception().name == "proxy_memory_limit_exceeded"
        # ...while the TAG-parked one was waiting on designed pacing:
        # it sheds with the tag error and the throttle counter
        assert parked[0].is_error
        assert parked[0].exception().name == "tag_throttled"
        snap = q.stats.snapshot()
        assert snap.get("throttle_rejected", 0) == 1, snap
        assert snap.get("admission_timed_out", 0) == 1, snap
    finally:
        _reset()


def test_tag_row_priority_scoping():
    """A batch-priority row throttles batch only; default and
    immediate pass untouched (a row applies at and below its class,
    and immediate is NEVER tag-throttled)."""
    flow.SERVER_KNOBS.set("tag_throttling", 1)
    try:
        q = _queues()
        q.tags.install([(b"t", 0.001, 100.0, PRIORITY_BATCH, False)], 0.0)
        assert q.tags.applying((b"t",), PRIORITY_DEFAULT, 0.0) is None
        assert q.tags.applying((b"t",), PRIORITY_IMMEDIATE, 0.0) is None
        assert q.tags.applying((b"t",), PRIORITY_BATCH, 0.0) is not None
        q.tags.install([(b"t", 0.001, 100.0, PRIORITY_DEFAULT, False)],
                       0.0)
        assert q.tags.applying((b"t",), PRIORITY_DEFAULT, 0.0) is not None
        assert q.tags.applying((b"t",), PRIORITY_IMMEDIATE, 0.0) is None
    finally:
        _reset()


def test_shutdown_breaks_all_queued_requests():
    flow.SERVER_KNOBS.set("grv_admission_control", 1)
    flow.SERVER_KNOBS.set("tag_throttling", 1)
    try:
        q = _queues()
        q.tags.install([(b"t", 0.001, 100.0, PRIORITY_DEFAULT, False)],
                       0.0)
        plain = _entry()
        q.submit(plain, 0.0)
        q.submit(_entry(tags=(b"t",)), 0.0)     # burst token
        parked = _entry(tags=(b"t",))
        q.submit(parked, 0.0)
        q.shutdown()
        for e in (plain, parked):
            assert e[0].is_error
            assert e[0].exception().name == "broken_promise"
        assert q.depth() == 0
    finally:
        _reset()


# -- systemkeys schema -------------------------------------------------

def test_throttle_row_schema_round_trip():
    key = sk.throttled_tag_key(b"web")
    assert sk.parse_throttled_tag_key(key) == b"web"
    assert sk.parse_throttled_tag_key(b"zzz") is None
    v = sk.encode_tag_throttle_value(12.5, 99.25, PRIORITY_DEFAULT, True)
    assert sk.parse_tag_throttle_value(v) == (12.5, 99.25,
                                              PRIORITY_DEFAULT, True)
    assert sk.parse_tag_throttle_value(b"garbage") is None
    assert sk.parse_tag_throttle_value(b"9|1|2|3|4") is None  # version
    # the range sits in the STORED system region (real durable rows)
    assert sk.is_stored_system(key)


# -- ratekeeper budget split -------------------------------------------

def test_rate_split_across_proxies():
    from foundationdb_tpu_torch.server.ratekeeper import Ratekeeper

    class _Var:
        def __init__(self, v):
            self._v = v

        def get(self):
            return self._v

    class _Info:
        proxies = (1, 2)

    class _CC:
        pass

    fake = type("_RK", (), {})()
    fake.rate, fake.batch_rate = 100.0, 50.0
    fake.cc = _CC()
    fake.cc.dbinfo = _Var(_Info())
    try:
        # off-posture: the undivided rate, exactly as before
        assert Ratekeeper._served_rates(fake) == (100.0, 50.0)
        flow.SERVER_KNOBS.set("grv_admission_control", 1)
        assert Ratekeeper._served_rates(fake) == (50.0, 25.0)
        # the pre-batch-limit sentinel passes through undivided
        fake.batch_rate = -1.0
        assert Ratekeeper._served_rates(fake) == (50.0, -1.0)
    finally:
        _reset()


# -- client-honored backoff --------------------------------------------

def test_client_cache_paces_and_expires():
    flow.SERVER_KNOBS.set("tag_throttling", 1)
    try:
        cache = ClientTagThrottleCache()
        cache.update([(b"t", 2.0, 10.0)], 0.0)
        assert cache.delay((b"t",), 0.0) == 0.0       # burst-of-one
        d = cache.delay((b"t",), 0.1)
        assert abs(d - 0.4) < 1e-9                    # paced at 2 tps
        # untagged / unknown tags never wait
        assert cache.delay((b"x",), 0.2) == 0.0
        # expiry drops the row
        assert cache.delay((b"t",), 11.0) == 0.0
        assert cache.delay((b"t",), 11.0) == 0.0
        # the local wait is capped by the knob
        flow.SERVER_KNOBS.set("client_tag_backoff_max", 0.25)
        cache.update([(b"s", 0.1, 100.0)], 20.0)
        cache.delay((b"s",), 20.0)
        assert cache.delay((b"s",), 20.0) == 0.25
    finally:
        _reset()


def test_client_backoff_survives_on_error():
    """The backoff consults a DATABASE-scoped cache and the tags
    survive on_error's reset — a conflicted attempt's retry honors the
    throttle exactly like the first attempt did."""
    c = SimCluster(seed=5050, durable=True)
    try:
        flow.SERVER_KNOBS.set("tag_throttling", 1)
        db = c.client("cb")

        async def main():
            cache = ClientTagThrottleCache()
            cache.update([(b"bk", 5.0, flow.now() + 1000.0)], flow.now())
            db._tag_throttle_cache = cache
            before = client_throttle_counters().get("backoffs", 0)
            tr = db.create_transaction()
            tr.set_option("transaction_tag", b"bk")
            await tr.get(b"hot")
            tr.set(b"mine", b"v")

            async def bump(t2):
                t2.set(b"hot", b"x")
            await run_transaction(db, bump)
            try:
                await tr.commit()
                raise AssertionError("expected a conflict")
            except flow.FdbError as e:
                assert e.name == "not_committed", e.name
                await tr.on_error(e)
            assert tr._tags == (b"bk",)     # the tag survived
            await tr.get(b"hot")            # retry GRV: backs off again
            after = client_throttle_counters().get("backoffs", 0)
            assert after >= before + 1, (before, after)
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        _reset()
        c.shutdown()


# -- system-keyspace round trip (manual throttles via cli) -------------


# -- auto-throttler e2e ------------------------------------------------

def test_auto_throttler_writes_row_under_abuse():
    c = SimCluster(seed=7070, durable=True)
    try:
        flow.SERVER_KNOBS.set("tag_throttling", 1)
        flow.SERVER_KNOBS.set("auto_tag_throttling", 1)
        flow.SERVER_KNOBS.set("tag_throttle_update_interval", 0.2)
        flow.SERVER_KNOBS.set("tag_throttle_busy_rate", 5.0)
        flow.SERVER_KNOBS.set("tag_throttle_poll_interval", 0.1)
        db = c.client("auto")

        async def main():
            for i in range(40):        # ~20/s of one tag: abusive
                async def body(tr, i=i):
                    tr.set_option("transaction_tag", b"abuser")
                    tr.set(b"a%03d" % i, b"v")
                await run_transaction(db, body)
                await flow.delay(0.05)

            async def rows(tr):
                tr.set_option("read_system_keys")
                return await tr.get_range(sk.THROTTLED_TAGS_PREFIX,
                                          sk.THROTTLED_TAGS_END)
            got = await run_transaction(db, rows, max_retries=200)
            parsed = {}
            for key, value in got:
                tag = sk.parse_throttled_tag_key(key)
                v = sk.parse_tag_throttle_value(value)
                if tag is not None and v is not None:
                    parsed[tag] = v
            assert b"abuser" in parsed, sorted(parsed)
            tps, _expiry, prio, auto = parsed[b"abuser"]
            assert auto is True and prio == PRIORITY_DEFAULT
            assert tps >= float(flow.SERVER_KNOBS.tag_throttle_min_tps)
            st = await db.get_status()
            auto_doc = (st["cluster"]["admission_control"]
                        ["auto_throttler"])
            assert auto_doc["auto_throttles"] >= 1, auto_doc
            return True

        assert c.run(main(), timeout_time=300)
    finally:
        _reset()
        c.shutdown()


def test_manual_throttle_takes_precedence_over_auto():
    """A live MANUAL row for a busy tag is never overwritten by the
    auto-throttler — the operator's word stands (a blind auto
    SET would replace it)."""
    c = SimCluster(seed=7171, durable=True)
    try:
        flow.SERVER_KNOBS.set("auto_tag_throttling", 1)
        flow.SERVER_KNOBS.set("tag_throttle_update_interval", 0.2)
        flow.SERVER_KNOBS.set("tag_throttle_busy_rate", 5.0)
        db = c.client("mp")

        async def main():
            async def setrow(tr):
                tr.set_option("access_system_keys")
                tr.set(sk.throttled_tag_key(b"abuser"),
                       sk.encode_tag_throttle_value(
                           2.0, flow.now() + 600.0, PRIORITY_DEFAULT,
                           auto=False))
            await run_transaction(db, setrow)
            for i in range(40):        # ~20/s of the tag: reads busy
                async def body(tr, i=i):
                    tr.set_option("transaction_tag", b"abuser")
                    tr.set(b"p%03d" % i, b"v")
                await run_transaction(db, body)
                await flow.delay(0.05)

            async def rows(tr):
                tr.set_option("read_system_keys")
                return await tr.get_range(sk.THROTTLED_TAGS_PREFIX,
                                          sk.THROTTLED_TAGS_END)
            got = await run_transaction(db, rows, max_retries=200)
            parsed = {sk.parse_throttled_tag_key(key):
                      sk.parse_tag_throttle_value(value)
                      for key, value in got}
            tps, _exp, _prio, auto = parsed[b"abuser"]
            assert auto is False and tps == 2.0, parsed
            st = await db.get_status()
            auto_doc = (st["cluster"]["admission_control"]
                        ["auto_throttler"])
            assert auto_doc["auto_throttles"] == 0, auto_doc
            return True

        assert c.run(main(), timeout_time=300)
    finally:
        _reset()
        c.shutdown()


# -- off posture: byte-identical GRV path ------------------------------

def test_off_posture_grv_path_byte_identical():
    """With every admission knob at its default 0: a tagged workload
    runs, the raw GRV reply is exactly the defaulted pre-subsystem
    shape (no windows, no throttle info), no request ever routes
    through the admission queues, and no backoff fires client-side."""
    c = SimCluster(seed=6060, durable=True)
    try:
        db = c.client("off")

        async def main():
            before = client_throttle_counters().get("backoffs", 0)

            async def body(tr):
                tr.set_option("transaction_tag", b"offtag")
                tr.set(b"k", b"v")
            await run_transaction(db, body)
            info = await db.info()
            reply = await info.proxies[0].grvs.get_reply(
                GetReadVersionRequest(1, PRIORITY_DEFAULT), db.process)
            assert reply == GetReadVersionReply(reply.version), reply
            assert reply.conflict_windows == ()
            assert reply.tag_throttles == ()
            st = await db.get_status()
            adm = st["cluster"]["admission_control"]
            assert adm["grv_admission_enabled"] == 0
            assert adm["tag_throttling_enabled"] == 0
            assert adm["queued_now"] == 0
            assert adm["rejected"] == 0 and adm["timed_out"] == 0
            assert sum(adm["admitted"].values()) == 0
            assert adm["throttled_tags"] == []
            assert client_throttle_counters().get("backoffs",
                                                  0) == before
            assert db._tag_throttle_cache is None
            return True

        assert c.run(main(), timeout_time=120)
    finally:
        c.shutdown()


# -- storm honesty + overload workload ---------------------------------

def test_overload_storm_accounting_is_exact():
    from foundationdb_tpu_torch.server.workloads import OverloadStorm
    c = SimCluster(seed=808, durable=True)
    try:
        dbs = [c.client(f"ov{i}") for i in range(3)]

        async def main():
            storm = OverloadStorm(dbs, flow.g_random, duration=1.5,
                                  fair_rate=40.0, abusive_rate=80.0,
                                  n_clients=1000, max_inflight=256)
            return await storm.run()

        stats = c.run(main(), timeout_time=300)
        assert stats["issued"] > 30, stats
        done = (stats["completed"] + stats["conflicted"]
                + stats["grv_rejected"] + stats["tag_rejected"]
                + sum(stats["errors"].values()))
        # every arrival is accounted exactly once: open-loop honesty
        assert done + stats["shed"] == stats["issued"], stats
        assert stats["admitted"] + stats["shed"] == stats["issued"]
        assert 0.0 < stats["attainment"] <= 1.0
        assert stats["abusive_issued"] + stats["others_issued"] == \
            stats["issued"]
        assert stats["late_issued"] <= stats["issued"]
        assert "late_committed_per_sec" in stats
        assert stats["grv"]["others"]["count"] > 0
    finally:
        c.shutdown()


def test_open_loop_storm_reports_attainment():
    from foundationdb_tpu_torch.server.workloads import OpenLoopStorm
    c = SimCluster(seed=809, durable=True)
    try:
        dbs = [c.client("at0")]

        async def main():
            storm = OpenLoopStorm(dbs, flow.g_random, duration=1.0,
                                  rate=2000.0, burst_rate=2000.0,
                                  burst_start=0.0, burst_len=1.0,
                                  keyspace=4, max_inflight=8)
            return await storm.run()

        stats = c.run(main(), timeout_time=300)
        # at saturation the cap converts offered load into shed load —
        # and the report SAYS so instead of silently going closed-loop
        assert stats["shed"] > 0, stats
        assert stats["admitted"] == stats["issued"] - stats["shed"]
        assert stats["attainment"] < 1.0, stats
    finally:
        c.shutdown()


# -- exporter families -------------------------------------------------

def test_admission_exporter_families_round_trip():
    from foundationdb_tpu_torch.tools.exporter import (parse_prometheus,
                                                       render_prometheus)
    status = {"cluster": {
        "epoch": 1, "recovery_state": "fully_recovered",
        "admission_control": {
            "grv_admission_enabled": 1, "tag_throttling_enabled": 1,
            "auto_tag_throttling_enabled": 1,
            "admitted": {"immediate": 2, "default": 40, "batch": 3},
            "queued_now": 1, "rejected": 4, "timed_out": 2,
            "throttle_delayed": 7, "throttle_released": 6,
            "throttle_rejected": 1, "confirm_rounds": 9,
            "throttled_tags": [
                {"tag": "ab", "tps": 5.0, "expiry": 99.0,
                 "priority": "default", "auto": 1, "queued": 2}],
            "auto_throttler": {"enabled": 1, "auto_throttles": 3,
                               "auto_cleared": 1, "tracked_tags": 2,
                               "active_auto": ["ab"]},
            "client": {"backoffs": 11, "backoff_ms": 1200,
                       "updates": 5, "tags_cached": 1},
        },
        "proxies": [{
            "name": "proxy-e1-0", "counters": {},
            "latency_bands": {},
            "admission": {
                "grv_admission_enabled": 1, "tag_throttling_enabled": 1,
                "admitted": {"immediate": 2, "default": 40, "batch": 3},
                "queued": {"immediate": 0, "default": 1, "batch": 0},
                "rejected": 4, "timed_out": 2, "throttle_delayed": 7,
                "throttle_released": 6, "throttle_rejected": 1,
                "confirm_rounds": 9,
                "tag_rows": [{"tag": "ab", "tps": 5.0, "expiry": 99.0,
                              "priority": "default", "auto": 1,
                              "queued": 2}]}}],
    }}
    samples = parse_prometheus(render_prometheus(status))
    names = {n for n, _l, _v in samples}
    for need in ("fdbtpu_admission_enabled", "fdbtpu_admission_admitted",
                 "fdbtpu_admission_queued", "fdbtpu_admission_rejected",
                 "fdbtpu_admission_timed_out",
                 "fdbtpu_admission_confirm_rounds",
                 "fdbtpu_throttle_tags", "fdbtpu_throttle_tag_tps",
                 "fdbtpu_throttle_delayed", "fdbtpu_throttle_released",
                 "fdbtpu_throttle_rejected",
                 "fdbtpu_throttle_auto_written",
                 "fdbtpu_throttle_auto_cleared",
                 "fdbtpu_throttle_client", "fdbtpu_throttle_client_tags"):
        assert need in names, f"exporter missing {need}"
    tps = [(l, v) for n, l, v in samples if n == "fdbtpu_throttle_tag_tps"]
    assert tps == [({"tag": "ab", "priority": "default", "auto": "1"},
                    5.0)]
    admitted = {l["priority"]: v for n, l, v in samples
                if n == "fdbtpu_admission_admitted"}
    assert admitted == {"immediate": 2.0, "default": 40.0, "batch": 3.0}



def test_manual_throttle_roundtrip_through_cli():
    c = SimCluster(seed=4040, durable=True)
    try:
        flow.SERVER_KNOBS.set("tag_throttling", 1)
        flow.SERVER_KNOBS.set("tag_throttle_poll_interval", 0.1)
        cli = Cli.for_cluster(c)
        out = cli.execute("throttle on webtag 5 default 60")
        assert "Throttle set" in out, out
        lst = cli.execute("throttle list")
        assert "webtag" in lst and "tps=5" in lst and "manual" in lst, lst

        db = c.client("mt")

        async def wait_installed():
            for _ in range(60):
                await flow.delay(0.2)
                st = await db.get_status()
                rows = (st["cluster"]["admission_control"]
                        ["throttled_tags"])
                if any(r["tag"] == b"webtag".hex() and not r["auto"]
                       for r in rows):
                    return st
            raise AssertionError("proxy never installed the manual row")

        st = c.run(wait_installed(), timeout_time=120)
        row = [r for r in st["cluster"]["admission_control"]
               ["throttled_tags"] if r["tag"] == b"webtag".hex()][0]
        assert row["tps"] == 5.0 and row["priority"] == "default", row

        assert "cleared" in cli.execute("throttle off webtag")
        assert "webtag" not in cli.execute("throttle list")

        async def wait_gone():
            for _ in range(60):
                await flow.delay(0.2)
                st = await db.get_status()
                rows = (st["cluster"]["admission_control"]
                        ["throttled_tags"])
                if not rows:
                    return True
            raise AssertionError("proxy never dropped the cleared row")

        assert c.run(wait_gone(), timeout_time=120)
    finally:
        _reset()
        c.shutdown()
