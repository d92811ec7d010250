"""Model-checked client workloads.

Reference: fdbserver/workloads/WriteDuringRead.actor.cpp:29-143 — a
random operation mix (sets, clears, range clears, atomics, gets,
selector/limit/reverse range reads, watches) driven through the full
client surface and replayed against an in-memory model database, with
every read asserted against the model mid-transaction (read-your-writes
included); stacked with attrition/BUGGIFY by the callers. Also covers
the FuzzApiCorrectness/RyowCorrectness ground: the model implements
selector resolution and atomic folds locally, so any divergence in the
distributed pipeline (proxy batching, tlog replication, storage MVCC,
shard moves) surfaces as an assertion with the op trace attached.

Retried commits are resolved exactly: every transaction writes a
sequence key, and a commit_unknown_result is settled by reading it
back — the model then applies or discards the staged effects, never
guesses (ref: the reference workloads' use of idempotent markers for
commit_unknown_result).
"""

from __future__ import annotations

import time as _time
from bisect import bisect_left
from typing import Dict, List, Optional, Tuple

from .. import flow
from ..client.transaction import _ATOMIC_APPLY, run_transaction
from .types import (ADD_VALUE, AND_V2, APPEND_IF_FITS, BYTE_MAX, BYTE_MIN,
                    COMPARE_AND_CLEAR, KeySelector, MAX, MIN_V2, OR,
                    SET_VERSIONSTAMPED_VALUE, XOR)

_ATOMIC_CHOICES = (ADD_VALUE, AND_V2, OR, XOR, MAX, MIN_V2, BYTE_MIN,
                   BYTE_MAX, APPEND_IF_FITS, COMPARE_AND_CLEAR)

RETRYABLE = {"not_committed", "transaction_too_old", "future_version",
             "commit_unknown_result", "broken_promise", "timed_out",
             "tlog_stopped", "coordinators_changed",
             "proxy_memory_limit_exceeded", "process_behind",
             "wrong_shard_server", "transaction_timed_out"}

# commit outcomes the client cannot know: the seq key decides
UNKNOWN_OUTCOME = {"commit_unknown_result", "timed_out",
                   "broken_promise", "tlog_stopped"}


def model_select(keys: List[bytes], sel: KeySelector) -> bytes:
    """KeySelector resolution against a sorted key list (the model's
    findKey — mirrors storage resolve_selector + the client's cross-
    shard walk + user-space clamps, storage.py resolve_selector)."""
    anchor = sel.key + b"\x00" if sel.or_equal else sel.key
    if sel.offset >= 1:
        i = bisect_left(keys, anchor) + sel.offset - 1
        return keys[i] if i < len(keys) else b"\xff"
    i = bisect_left(keys, anchor) - (1 - sel.offset)
    return keys[i] if i >= 0 else b""


def model_range(staged: Dict[bytes, bytes], begin: bytes, end: bytes,
                limit: int, reverse: bool) -> List[Tuple[bytes, bytes]]:
    rows = sorted((k, v) for k, v in staged.items() if begin <= k < end)
    if reverse:
        rows.reverse()
    return rows[:limit] if limit else rows


class WriteDuringRead:
    """One seeded run: `await WriteDuringRead(db, rng).run(rounds)`.
    Raises AssertionError (with the failing op) on any divergence."""

    def __init__(self, db, rng, prefix: bytes = b"wdr/",
                 keyspace: int = 24, max_ops: int = 8,
                 check_watches: bool = True):
        self.db = db
        self.rng = rng
        self.prefix = prefix
        self.keyspace = keyspace
        self.max_ops = max_ops
        self.check_watches = check_watches
        self.seq_key = prefix + b"\xfeseq"
        self.model: Dict[bytes, bytes] = {}
        # armed watches: (key, value at arm time, future, seq armed at)
        self.watches: list = []
        self.stats = {"txns": 0, "retries": 0, "unknown_resolved": 0,
                      "ops": 0, "watches_fired": 0}

    # -- op generation ---------------------------------------------------
    def _key(self) -> bytes:
        return self.prefix + b"k%02d" % self.rng.random_int(
            0, self.keyspace - 1)

    def _gen_ops(self) -> list:
        ops = []
        for _ in range(self.rng.random_int(1, self.max_ops)):
            kind = self.rng.random_int(0, 9)
            k = self._key()
            if kind == 0:
                ops.append(("set", k, b"v%d" % self.rng.random_int(0, 999)))
            elif kind == 1:
                ops.append(("clear", k))
            elif kind == 2:
                e = self._key()
                ops.append(("clear_range", min(k, e), max(k, e)))
            elif kind == 3:
                op_type = _ATOMIC_CHOICES[self.rng.random_int(
                    0, len(_ATOMIC_CHOICES) - 1)]
                width = self.rng.random_int(1, 8)
                param = bytes(self.rng.random_int(0, 255)
                              for _ in range(width))
                ops.append(("atomic", k, param, op_type))
            elif kind == 4:
                ops.append(("get", k))
            elif kind in (5, 6):
                e = self._key()
                ops.append(("get_range", min(k, e), max(k, e) + b"\xfe",
                            self.rng.random_int(0, 6),
                            bool(self.rng.random_int(0, 1))))
            elif kind == 7:
                ops.append(("get_key", k,
                            bool(self.rng.random_int(0, 1)),
                            self.rng.random_int(-3, 3)))
            elif kind == 8 and self.check_watches:
                ops.append(("watch", k))
            else:
                ops.append(("get", k))
        return ops

    # -- one transaction -------------------------------------------------
    async def _apply_ops(self, tr, ops, staged: Dict[bytes, bytes],
                         armed: list) -> None:
        for op in ops:
            self.stats["ops"] += 1
            kind = op[0]
            if kind == "set":
                _g, k, v = op
                tr.set(k, v)
                staged[k] = v
            elif kind == "clear":
                tr.clear(op[1])
                staged.pop(op[1], None)
            elif kind == "clear_range":
                _g, b, e = op
                tr.clear_range(b, e)
                for kk in [kk for kk in staged if b <= kk < e]:
                    del staged[kk]
            elif kind == "atomic":
                _g, k, param, op_type = op
                tr.atomic_op(k, param, op_type)
                folded = _ATOMIC_APPLY[op_type](staged.get(k), param)
                if folded is None:
                    staged.pop(k, None)
                else:
                    staged[k] = folded
            elif kind == "get":
                got = await tr.get(op[1])
                want = staged.get(op[1])
                assert got == want, ("get diverged", op, got, want)
            elif kind == "get_range":
                _g, b, e, limit, rev = op
                got = await tr.get_range(b, e, limit=limit or 10 ** 9,
                                         reverse=rev)
                want = model_range(staged, b, e, limit, rev)
                assert got == want, ("get_range diverged", op, got, want)
            elif kind == "get_key":
                _g, k, or_eq, off = op
                sel = KeySelector(k, or_eq, off)
                got = await tr.get_key(sel)
                want = model_select(sorted(staged), sel)
                assert got == want, ("get_key diverged", op, got, want)
            elif kind == "watch":
                # the compare value is resolved at COMMIT version, so
                # the model value is taken at end of txn (run() fixes
                # it up from the final staged dict)
                armed.append((op[1], tr.watch(op[1])))

    async def _resolve_unknown(self, want_seq: bytes) -> bool:
        """After commit_unknown_result: did the transaction land? The
        seq key answers exactly (every txn writes a unique value)."""
        async def body(tr):
            return await tr.get(self.seq_key)
        got = await run_transaction(self.db, body, max_retries=200)
        return got == want_seq

    async def run(self, rounds: int = 50) -> dict:
        for seq in range(rounds):
            ops = self._gen_ops()
            seq_val = b"s%06d" % seq
            while True:
                tr = self.db.create_transaction()
                staged = dict(self.model)
                armed: list = []
                try:
                    await self._apply_ops(tr, ops, staged, armed)
                    tr.set(self.seq_key, seq_val)
                    staged[self.seq_key] = seq_val
                    await tr.commit()
                    self.model = staged
                    self.watches.extend(
                        (k, staged.get(k), f) for k, f in armed)
                    break
                except flow.FdbError as e:
                    if e.name in UNKNOWN_OUTCOME:
                        if await self._resolve_unknown(seq_val):
                            flow.cover("workload.wdr.unknown_committed")
                            self.stats["unknown_resolved"] += 1
                            self.model = staged
                            self.watches.extend(
                                (k, staged.get(k), f) for k, f in armed)
                            break
                    if e.name not in RETRYABLE:
                        raise
                    self.stats["retries"] += 1
                    await flow.delay(
                        flow.SERVER_KNOBS.workload_retry_delay_min
                        + self.rng.random01()
                        * flow.SERVER_KNOBS.workload_retry_delay_span)
            self.stats["txns"] += 1
        if self.check_watches:
            await self._check_watches()
        return self.stats

    async def _check_watches(self) -> None:
        """Every watch armed on a value that LATER changed must fire;
        errors (shard moved, replica died) count as fired — the client
        contract is 'wake up and re-read' either way."""
        for key, val_at_arm, fut in self.watches:
            if self.model.get(key) == val_at_arm:
                continue  # may legitimately stay parked
            try:
                await flow.timeout_error(
                    fut, flow.SERVER_KNOBS.workload_watch_timeout)
                self.stats["watches_fired"] += 1
            except flow.FdbError as e:
                if e.name in ("timed_out",):
                    raise AssertionError(
                        ("watch never fired", key, val_at_arm,
                         self.model.get(key))) from e
                self.stats["watches_fired"] += 1  # woke with an error


class Serializability:
    """External-consistency checker (ref: Serializability.actor.cpp):
    concurrent clients run random read-then-write transactions; every
    committed attempt records its observed reads, its writes, and its
    10-byte versionstamp (commit version + intra-batch index — a TOTAL
    commit order). Afterwards the attempts are replayed in stamp order
    against a model: every recorded read must equal the model state at
    that point, or the history was not serializable in commit order.

    Attempts whose outcome the client could not learn
    (commit_unknown_result and friends) are settled exactly: each
    attempt writes a unique marker key with a VERSIONSTAMPED value, so
    a final scan of the marker subspace decides both whether the
    attempt landed and where it sits in the commit order — the checker
    never guesses (every committed attempt is its own transaction as
    far as serializability is concerned, including double-landings
    from retried unknowns)."""

    def __init__(self, dbs, rng, prefix: bytes = b"ser/",
                 keyspace: int = 16):
        import struct as _struct
        self.dbs = dbs
        self.rng = rng
        self.prefix = prefix
        self.keyspace = keyspace
        self._struct = _struct
        #: (marker_key, reads [(k, v)], writes [(kind, ...)],
        #:  stamp or None — None means "resolve via the marker")
        self.attempts: list = []
        self.stats = {"committed": 0, "aborted": 0, "unknown": 0}

    def _key(self) -> bytes:
        return self.prefix + b"k%02d" % self.rng.random_int(
            0, self.keyspace - 1)

    async def _one_txn(self, db, marker: bytes) -> None:
        while True:
            tr = db.create_transaction()
            reads = []
            writes = []
            try:
                for _ in range(self.rng.random_int(1, 3)):
                    k = self._key()
                    reads.append((k, await tr.get(k)))
                for _ in range(self.rng.random_int(1, 2)):
                    k = self._key()
                    kind = self.rng.random_int(0, 2)
                    if kind == 0:
                        v = b"v%d" % self.rng.random_int(0, 9999)
                        tr.set(k, v)
                        writes.append(("set", k, v))
                    elif kind == 1:
                        tr.clear(k)
                        writes.append(("clear", k))
                    else:
                        p = self._struct.Struct("<q").pack(
                            self.rng.random_int(1, 100))
                        tr.atomic_op(k, p, ADD_VALUE)
                        writes.append(("add", k, p))
                # the attempt's identity + commit-order witness
                val = b"\x00" * 10 + self._struct.Struct("<I").pack(0)
                tr.atomic_op(marker, val, SET_VERSIONSTAMPED_VALUE)
                await tr.commit()
            except flow.FdbError as e:
                if e.name in UNKNOWN_OUTCOME:
                    self.stats["unknown"] += 1
                    self.attempts.append((marker, reads, writes, None))
                    marker = marker + b"r"   # next attempt: fresh marker
                    continue
                if e.name in RETRYABLE:
                    self.stats["aborted"] += 1
                    continue
                raise
            self.stats["committed"] += 1
            self.attempts.append(
                (marker, reads, writes, tr.get_versionstamp()))
            return

    async def run(self, txns_per_client: int = 20) -> dict:
        async def client(db, ci):
            for i in range(txns_per_client):
                await self._one_txn(
                    db, self.prefix + b"\xfem/%d/%d/" % (ci, i))

        await flow.wait_for_all([
            flow.spawn(client(db, ci), name=f"ser-client-{ci}")
            for ci, db in enumerate(self.dbs)])

        # settle unknown-outcome attempts from their markers
        async def read_markers(tr):
            return dict(await tr.get_range(
                self.prefix + b"\xfem/", self.prefix + b"\xfem0",
                limit=1 << 20))
        markers = await run_transaction(self.dbs[0], read_markers,
                                        max_retries=500)
        ordered = []
        for marker, reads, writes, stamp in self.attempts:
            if stamp is None:
                got = markers.get(marker)
                if got is None:
                    continue           # provably never landed
                stamp = got
            ordered.append((stamp, marker, reads, writes))
        assert len({s for s, *_ in ordered}) == len(ordered), \
            "versionstamps must totally order committed attempts"
        ordered.sort()

        # replay in commit order: every observed read must match
        model: Dict[bytes, bytes] = {}
        for stamp, marker, reads, writes in ordered:
            for k, v in reads:
                assert model.get(k) == v, (
                    "serializability violation", marker, k, v, model.get(k))
            for w in writes:
                if w[0] == "set":
                    model[w[1]] = w[2]
                elif w[0] == "clear":
                    model.pop(w[1], None)
                else:
                    folded = _ATOMIC_APPLY[ADD_VALUE](model.get(w[1]), w[2])
                    model[w[1]] = folded
        self.stats["replayed"] = len(ordered)
        return self.stats


def _find_net(dbs):
    """The SimNetwork behind a pool of client handles (for message
    accounting in storm reports); None when unreachable."""
    for db in dbs:
        ref = getattr(db, "cluster_ref", None)
        if ref is not None:
            try:
                return ref.endpoint.process.net
            except AttributeError:
                pass
    return None


def sim_perf_report(wall_t0: float, sim_t0: float, tasks0: int,
                    net=None, top_k: Optional[int] = None) -> dict:
    """The wall-vs-sim budget every storm report carries (the binding
    constraint on 10^6-client storms is simulator
    wall-clock, so every storm measures what its sim-seconds COST):
    sim seconds, real wall seconds, their ratio, run-loop steps and
    step rate — plus, when the SIM_TASK_STATS plane is armed, the
    top-K task types and top-K message types burning that wall time.

    Wall readings feed reports only, never sim decisions, so seeded
    replay determinism is untouched."""
    sched = flow.g()
    if top_k is None:
        top_k = int(flow.SERVER_KNOBS.sim_task_stats_top_k)
    wall = max(_time.monotonic() - wall_t0, 1e-9)
    sim = flow.now() - sim_t0
    tasks = sched.tasks_run - tasks0
    out = {
        "sim_seconds": round(sim, 3),
        "wall_seconds": round(wall, 4),
        "sim_per_wall": round(sim / wall, 3),
        "tasks_run": tasks,
        "tasks_per_wall_sec": round(tasks / wall, 1),
    }
    if sched.task_stats_armed:
        rep = sched.task_stats_report(top_k=top_k)
        out["top_tasks"] = rep["tasks"]
        out["priority_bands"] = rep["bands"]
    if net is not None and net.msg_stats is not None:
        mrep = net.message_stats_report(top_k=top_k)
        out["top_messages"] = mrep["types"]
        out["timers_now"] = mrep["timers_now"]
        out["messages_sent"] = mrep["messages_sent"]
    return out


def make_zipf_cdf(keyspace: int, s: float) -> list:
    """Zipfian CDF over key ranks (weight 1/rank^s), shared by the
    storm workloads; sampling is one random01 + binary search."""
    weights = [1.0 / (r ** s) for r in range(1, keyspace + 1)]
    total = sum(weights)
    acc, cdf = 0.0, []
    for w in weights:
        acc += w / total
        cdf.append(acc)
    return cdf


def zipf_rank(cdf: list, u: float) -> int:
    lo, hi = 0, len(cdf) - 1
    while lo < hi:
        mid = (lo + hi) // 2
        if cdf[mid] < u:
            lo = mid + 1
        else:
            hi = mid
    return lo


# -- vectorized storm schedules -------------------------------------------
# The storms used to draw every per-arrival decision (inter-arrival
# gap, Zipf key, priority/tag/repair flags, client id) one random01()
# at a time from the SHARED flow RNG, interleaved with the simulator's
# own draws — tens of thousands of python-side bisects and RNG calls on
# the measured hot path. Each storm's draw_schedule() now draws its
# ENTIRE randomized schedule up front in bulk numpy passes on an
# independent stream seeded by ONE draw from the storm's flow RNG:
#
#   - replay determinism is preserved (same seed -> one identical fork
#     draw -> identical schedule arrays -> identical arrival sequence),
#     pinned by tests/test_storm_vectorized.py;
#   - the Zipf CDF inverts via vectorized searchsorted (identical rank
#     for identical u as the per-txn zipf_rank bisect);
#   - key bytes render once per RANK, not once per transaction.
#
# Re-baselining note: the one-time schedule change moves each storm's
# sim timeline relative to the pre-vectorization code (the old path's
# draws interleaved with network-latency draws on one shared stream, so
# matching it arrival-for-arrival is impossible by construction). The
# same-seed replay oracle — the contract the sim validation enforces and
# the nightly matrix pins — holds unchanged on the new path.

def _fork_np_rng(rng):
    """An independent numpy stream seeded by ONE draw from the storm's
    flow RNG — the schedule's only footprint on the shared stream."""
    import numpy as np
    return np.random.Generator(np.random.PCG64(rng.random_int(0, 1 << 63)))


def _arrival_offsets(g, duration: float, rate_fn, est_rate: float) -> list:
    """Open-loop exponential arrival offsets in [0, duration) under a
    piecewise rate (same inverse-CDF formula the per-arrival loop
    used), from bulk uniform passes on `g`."""
    import math
    times: list = []
    t = 0.0
    n = max(64, int(est_rate * duration * 5 // 4) + 16)
    u = g.random(n).tolist()
    i = 0
    ln = math.log
    while True:
        if i >= n:
            u = g.random(n).tolist()   # top-up pass (rarely needed)
            i = 0
        r = rate_fn(t)
        t += -ln(max(1e-12, 1.0 - u[i])) / max(r, 1e-9)
        i += 1
        if t >= duration:
            return times
        times.append(t)


def _zipf_ranks(g, cdf: list, n: int) -> list:
    """n Zipf ranks via one uniform pass + vectorized searchsorted
    (identical rank per u as zipf_rank's bisect)."""
    import numpy as np
    if n == 0:
        return []
    ranks = np.searchsorted(np.asarray(cdf), g.random(n), side="left")
    # the float-summed CDF tail sits just below 1.0, so a draw beyond
    # cdf[-1] would index one past the key table — clamp exactly like
    # zipf_rank's hi bound
    return np.minimum(ranks, len(cdf) - 1).tolist()


def _flag_array(g, n: int, fraction: float) -> list:
    """n booleans at `fraction` (a zero fraction draws nothing, so
    arrays drawn before it are unaffected either way)."""
    if fraction <= 0.0 or n == 0:
        return [False] * n
    return (g.random(n) < fraction).tolist()


_POOL_DONE = object()


class ClientActorPool:
    """Bounded, reusable client-actor pool.

    Storms used to spawn one `storm-txn-<i>` task PER ARRIVAL: a fresh
    coroutine, Task object and name string each, with every dead
    one-shot name folding through the sim-task table. The pool spawns
    at most `limit` long-lived workers — lazily, on first concurrent
    demand — and reuses them across arrivals, so the task-name set is
    FIXED and small (`<label>-0..k`, k <= peak concurrency): the task stats'
    trailing-digit folding still attributes every arrival to the same
    `<label>-*` family, and SIM_TASK_STATS_MAX_NAMES slots stop
    leaking to one-shot names.

    `dispatch(job)` hands the job to an idle worker (LIFO — the
    warmest worker runs next) or returns False when all `limit`
    workers are busy: the open-loop shed decision stays at arrival
    time, exactly like the old `_inflight >= max_inflight` cap."""

    def __init__(self, run_job, limit: int, label: str = "storm-txn"):
        self._run_job = run_job
        self._limit = max(1, limit)
        self._label = label
        self._idle: list = []      # parked workers' next-job futures
        self._tasks: list = []
        self._closing = False
        self._error = None         # first job failure, re-raised by drain

    @property
    def size(self) -> int:
        """Workers ever spawned (== peak concurrency)."""
        return len(self._tasks)

    @property
    def busy(self) -> int:
        return len(self._tasks) - len(self._idle)

    def dispatch(self, job: tuple) -> bool:
        """Run `job` now on a pooled worker; False = saturated (shed)."""
        if self._idle:
            self._idle.pop().send(job)
            return True
        if len(self._tasks) < self._limit:
            self._tasks.append(flow.spawn(
                self._worker(job),
                name=f"{self._label}-{len(self._tasks)}"))
            return True
        return False

    async def _worker(self, job: tuple) -> None:
        while True:
            try:
                await self._run_job(*job)
            except flow.ActorCancelled:
                raise
            except BaseException as e:  # noqa: BLE001
                # a dying job must not leak this worker's pool slot
                # (the old per-arrival code's finally-based inflight
                # decrement had the same guarantee): record the first
                # failure for drain() and keep serving
                if self._error is None:
                    self._error = e
            if self._closing:
                return
            f = flow.Future()
            self._idle.append(f)
            job = await f
            if job is _POOL_DONE:
                return

    async def drain(self) -> None:
        """No further dispatches: release idle workers, wait for busy
        ones. Re-raises the first job failure — the same contract as
        the old wait_for_all over per-arrival tasks."""
        self._closing = True
        idle, self._idle = self._idle, []
        for f in idle:
            f.send(_POOL_DONE)
        await flow.wait_for_all(self._tasks)
        if self._error is not None:
            raise self._error


class OpenLoopStorm:
    """Open-loop Zipfian burst workload (ref: the reference's stress
    workloads + the admission-control storm): transaction
    arrivals follow a SEEDED exponential process whose rate is
    independent of completions — closed-loop clients self-throttle when
    the cluster slows, an open-loop storm keeps pushing, which is the
    load shape that exposes saturation and exercises the Ratekeeper.
    Keys are Zipfian (hot keys → real conflicts and hot shards); a
    configurable slice of traffic runs at batch priority and every
    simulated client carries a transaction tag, so one storm drives
    the whole QoS accounting plane (per-role signals, tag/priority
    counts, RkUpdate limiting reasons).

    `dbs` is the pool of client handles standing in for the client
    population; arrivals round-robin across it. In-flight transactions
    are capped at `max_inflight` (arrivals past the cap are counted as
    `shed`, not silently dropped), bounding sim memory while keeping
    the arrival process open-loop."""

    def __init__(self, dbs, rng, duration: float = 4.0,
                 rate: float = 150.0, burst_rate: float = 800.0,
                 burst_start: float = 1.0, burst_len: float = 1.5,
                 keyspace: int = 64, zipf_s: float = 1.2,
                 prefix: bytes = b"storm/", batch_fraction: float = 0.2,
                 tags: tuple = (b"web", b"batchjob", b"mobile"),
                 max_inflight: int = 512,
                 repairable_fraction: float = 0.0):
        self.dbs = list(dbs)
        self.rng = rng
        self.duration = duration
        # fraction of transactions declaring the automatic_repair
        # contract (their get+blind-set shape is value-independent, so
        # the declaration is honest); inert while TXN_REPAIR is off —
        # the chaos storms arm it so BUGGIFY-randomized nightlies run
        # the repair paths under faults. 0 draws no RNG at all, so the
        # default arrival schedule is bit-identical to pre-subsystem.
        self.repairable_fraction = repairable_fraction
        self.rate = rate
        self.burst_rate = burst_rate
        self.burst_start = burst_start
        self.burst_len = burst_len
        self.keyspace = keyspace
        self.prefix = prefix
        self.batch_fraction = batch_fraction
        self.tags = tuple(tags)
        self.max_inflight = max_inflight
        self._zipf_cdf = make_zipf_cdf(keyspace, zipf_s)
        from ..flow.latency import LatencySample
        self.grv_latency = LatencySample("storm_grv", size=4096)
        self.commit_latency = LatencySample("storm_commit", size=4096)
        # admitted vs shed vs completed are counted SEPARATELY: the
        # max_inflight cap exists to bound sim memory, but every
        # arrival it sheds is an arrival the cluster never saw — at
        # saturation that silently turns the storm closed-loop, so the
        # report must say how much of the offered load actually
        # reached the cluster (the `attainment` fraction) for any
        # open-loop assert to be honest about what it measured
        self.stats = {"issued": 0, "admitted": 0, "completed": 0,
                      "conflicted": 0, "shed": 0, "errors": {}}

    def draw_schedule(self):
        """The whole storm schedule in one vectorized pass: arrival
        offsets (burst-windowed piecewise rate), per-arrival key bytes
        (Zipf rank -> prerendered key table), batch-priority flags and
        automatic_repair flags. Deterministic per seed; the shared
        flow RNG pays exactly one fork draw."""
        g = _fork_np_rng(self.rng)
        bs, be = self.burst_start, self.burst_start + self.burst_len
        times = _arrival_offsets(
            g, self.duration,
            lambda t: self.burst_rate if bs <= t < be else self.rate,
            max(self.rate, self.burst_rate))
        n = len(times)
        key_table = [self.prefix + b"k%04d" % r
                     for r in range(self.keyspace)]
        keys = [key_table[r] for r in _zipf_ranks(g, self._zipf_cdf, n)]
        batch = _flag_array(g, n, self.batch_fraction)
        # drawn LAST (and not at all when 0), so arming repair leaves
        # the arrival/key/priority schedule untouched
        repair = _flag_array(g, n, self.repairable_fraction)
        return times, keys, batch, repair

    async def _one_txn(self, i: int, key: bytes, batch: bool,
                       repairable: bool) -> None:
        db = self.dbs[i % len(self.dbs)]
        tr = db.create_transaction()
        try:
            tr.set_option("transaction_tag", self.tags[i % len(self.tags)])
            if batch:
                tr.set_option("priority_batch")
            if repairable:
                tr.set_option("automatic_repair")
            t0 = flow.now()
            await tr.get_read_version()
            self.grv_latency.record(flow.now() - t0)
            await tr.get(key)
            tr.set(key, b"s%06d" % i)
            t1 = flow.now()
            await tr.commit()
            self.commit_latency.record(flow.now() - t1)
            self.stats["completed"] += 1
        except flow.FdbError as e:
            # open-loop: one attempt per arrival, no retry — a conflict
            # or throttle-timeout is an OUTCOME the storm measures, not
            # something to hide inside a retry loop
            if e.name == "not_committed":
                self.stats["conflicted"] += 1
            else:
                errs = self.stats["errors"]
                errs[e.name] = errs.get(e.name, 0) + 1

    async def run(self) -> dict:
        start = flow.now()
        wall0, tasks0 = _time.monotonic(), flow.g().tasks_run
        times, keys, batch, repair = self.draw_schedule()
        pool = ClientActorPool(self._one_txn, self.max_inflight)
        now = flow.now
        for i, t in enumerate(times):
            at = start + t
            if at > now():
                await flow.delay(at - now())
            self.stats["issued"] += 1
            if pool.dispatch((i, keys[i], batch[i], repair[i])):
                self.stats["admitted"] += 1
            else:
                self.stats["shed"] += 1
        await pool.drain()
        out = dict(self.stats)
        out["grv"] = self.grv_latency.snapshot()
        out["commit"] = self.commit_latency.snapshot()
        out["wall_seconds"] = round(flow.now() - start, 3)
        # offered-load attainment: the fraction of the open-loop
        # arrival process that actually reached the cluster (1.0 =
        # genuinely open-loop end to end; below that, the inflight cap
        # was converting offered load into shed load)
        out["attainment"] = round(
            out["admitted"] / max(out["issued"], 1), 4)
        out["sim_perf"] = sim_perf_report(wall0, start, tasks0,
                                          net=_find_net(self.dbs))
        return out


class OverloadStorm:
    """The enforced-admission-control proof storm: a large simulated open-loop client population —
    `n_clients` logical tenants multiplexed over the `dbs` handle pool
    — offering Zipfian-keyed traffic well past the cluster's budget,
    with ONE abusive tenant tag generating a disproportionate share.
    Same seed, knobs off vs on, is the collapse-vs-degrade comparison:

    - disarmed, the GRV queue grows without bound, waits walk toward
      the client timeout, and every tenant's latency collapses
      together;
    - armed (GRV_ADMISSION_CONTROL + TAG_THROTTLING +
      AUTO_TAG_THROTTLING), admission settles at the ratekeeper's
      budget with BOUNDED admitted-GRV latency, the abusive tag gets
      an auto row in \\xff\\x02/throttledTags/ (enforced at every
      proxy, honored by the clients' local backoff), and the other
      tenants' latency recovers.

    Each arrival belongs to a LOGICAL CLIENT drawn from the
    `n_clients` population (the abusive tenant owns the first tenth of
    the ids): the client id picks the handle the arrival multiplexes
    over — so GRV batching groups, the client-honored backoff caches,
    and the tenant tag all follow the population structure rather than
    the arrival order — and the report counts the distinct clients
    actually seen.

    Latency is tracked per tenant group (abusive vs others) so the
    recovery is a measured assert, not a narrative. One attempt per
    arrival, no retries: a rejection (`proxy_memory_limit_exceeded` /
    `tag_throttled`) is a designed OUTCOME the storm counts, exactly
    like the OpenLoopStorm's honesty contract — shed, admitted, and
    completed are reported separately with offered-load attainment.

    `clients_per_arrival > 1` is the 10^6-client scale path: each arrival represents a BLOCK of that many distinct logical
    clients walking the tenant pool behind one wire transaction whose
    GRV carries the whole block's `transaction_count` — admission
    control and the ratekeeper see the full offered load, the report's
    `distinct_clients` counts every logical client (cursor coverage,
    O(1) memory), and the simulator pays one transaction per block."""

    def __init__(self, dbs, rng, duration: float = 4.0,
                 fair_rate: float = 60.0, abusive_rate: float = 240.0,
                 n_clients: int = 100_000, keyspace: int = 64,
                 zipf_s: float = 1.2, prefix: bytes = b"ovl/",
                 abusive_tag: bytes = b"tenant-abuse",
                 tenant_tags: tuple = (b"tenant-web", b"tenant-mobile",
                                       b"tenant-api"),
                 batch_fraction: float = 0.2,
                 max_inflight: int = 4096,
                 clients_per_arrival: int = 1):
        self.dbs = list(dbs)
        self.rng = rng
        self.duration = duration
        self.fair_rate = fair_rate
        self.abusive_rate = abusive_rate
        self.n_clients = n_clients
        self.prefix = prefix
        self.abusive_tag = abusive_tag
        self.tenant_tags = tuple(tenant_tags)
        self.batch_fraction = batch_fraction
        self.max_inflight = max_inflight
        # client multiplexing (the 10^6-client path): each
        # arrival stands in for a BLOCK of `clients_per_arrival`
        # distinct logical clients walking the tenant pool — the block
        # leader runs the wire transaction with a GRV weight of the
        # whole block, so admission control and the ratekeeper are
        # charged for the true offered load while the sim pays one
        # transaction per block. 1 = the classic one-client-per-arrival
        # storm (cid drawn randomly from the population).
        self.clients_per_arrival = max(1, int(clients_per_arrival))
        self._zipf_cdf = make_zipf_cdf(keyspace, zipf_s)
        from ..flow.latency import LatencySample
        #: per tenant group: admitted-GRV latency and whole-txn latency
        self.grv_latency = {"abusive": LatencySample("ovl_grv_ab", 4096),
                            "others": LatencySample("ovl_grv_ot", 4096)}
        self.txn_latency = {"abusive": LatencySample("ovl_txn_ab", 4096),
                            "others": LatencySample("ovl_txn_ot", 4096)}
        self.stats = {"issued": 0, "admitted": 0, "shed": 0,
                      "completed": 0, "conflicted": 0,
                      "grv_rejected": 0, "tag_rejected": 0,
                      "abusive_issued": 0, "abusive_completed": 0,
                      "others_issued": 0, "others_completed": 0,
                      # the settle window: arrivals from the second
                      # half of the storm, past the initial
                      # unthrottled burst — what "the cluster settled
                      # at the budget" is measured over
                      "late_issued": 0, "late_completed": 0,
                      "errors": {}}

    def draw_schedule(self):
        """Vectorized arrival schedule: offsets at the combined rate,
        per-arrival abusive/fair group flags at the rate share, Zipf
        key bytes, batch-priority flags (applied to fair traffic only,
        as before), and — for the classic 1-client-per-arrival shape —
        the logical client id draws. One fork draw on the shared RNG."""
        g = _fork_np_rng(self.rng)
        total = self.fair_rate + self.abusive_rate
        times = _arrival_offsets(g, self.duration, lambda t: total, total)
        n = len(times)
        abusive_frac = self.abusive_rate / max(total, 1e-9)
        abusive = _flag_array(g, n, abusive_frac)
        key_table = [self.prefix + b"k%04d" % r
                     for r in range(len(self._zipf_cdf))]
        keys = [key_table[r] for r in _zipf_ranks(g, self._zipf_cdf, n)]
        batch = _flag_array(g, n, self.batch_fraction)
        # the abusive tenant owns the first tenth of the client ids;
        # the fair tenants split the rest
        n_abusive = max(1, self.n_clients // 10)
        fair_pool = max(1, self.n_clients - n_abusive)
        if self.clients_per_arrival <= 1:
            u = g.random(n) if n else []
            cids = [(min(int(u[i] * n_abusive), n_abusive - 1)
                     if abusive[i]
                     else n_abusive + min(int(u[i] * fair_pool),
                                          fair_pool - 1))
                    for i in range(n)]
        else:
            # multiplexed blocks walk the pools with cursors instead of
            # random draws: coverage of the population is exact, and
            # distinct-client accounting is O(1) instead of a
            # 10^6-entry set
            cids = None
        return times, abusive, keys, batch, cids

    async def _one_txn(self, i: int, cid: int, tag: bytes, group: str,
                       late: bool, key: bytes, batch: bool) -> None:
        db = self.dbs[cid % len(self.dbs)]
        tr = db.create_transaction()
        t0 = flow.now()
        try:
            tr.set_option("transaction_tag", tag)
            if batch and group == "others":
                tr.set_option("priority_batch")
            if self.clients_per_arrival > 1:
                # the block leader's GRV is charged for the whole block
                tr.set_option("grv_batch_weight", self.clients_per_arrival)
            await tr.get_read_version()
            self.grv_latency[group].record(flow.now() - t0)
            await tr.get(key)
            tr.set(key, b"o%06d" % i)
            await tr.commit()
            self.txn_latency[group].record(flow.now() - t0)
            self.stats["completed"] += 1
            self.stats[group + "_completed"] += 1
            if late:
                self.stats["late_completed"] += 1
        except flow.FdbError as e:
            # one attempt per arrival: throttle rejections and
            # timeouts are outcomes the storm measures, never hidden
            # in a retry loop
            if e.name == "not_committed":
                self.stats["conflicted"] += 1
            elif e.name == "proxy_memory_limit_exceeded":
                self.stats["grv_rejected"] += 1
            elif e.name == "tag_throttled":
                self.stats["tag_rejected"] += 1
            else:
                errs = self.stats["errors"]
                errs[e.name] = errs.get(e.name, 0) + 1

    async def run(self) -> dict:
        start = flow.now()
        wall0, tasks0 = _time.monotonic(), flow.g().tasks_run
        times, abusive, keys, batch, cids = self.draw_schedule()
        n_abusive = max(1, self.n_clients // 10)
        fair_pool = max(1, self.n_clients - n_abusive)
        B = self.clients_per_arrival
        pool = ClientActorPool(self._one_txn, self.max_inflight,
                               label="ovl-txn")
        clients_seen: set = set()
        tags_seen: set = set()   # bounded by the tag vocabulary
        # multiplexed mode: per-group block cursors + draw totals
        cursors = {"abusive": 0, "others": 0}
        draws = {"abusive": 0, "others": 0}
        half = self.duration / 2
        now = flow.now
        for i, t in enumerate(times):
            at = start + t
            if at > now():
                await flow.delay(at - now())
            if abusive[i]:
                group = "abusive"
            else:
                group = "others"
            if cids is not None:
                cid = cids[i]
                clients_seen.add(cid)
            else:
                # next block of B distinct ids from the group's pool.
                # The leader is a ROTATING member of the block (offset
                # i % B), not always the first id: a fixed stride of B
                # would alias with len(tenant_tags)/len(dbs) whenever B
                # shares a factor with them, pinning every arrival to
                # one tag and one handle (B=600 once sent all fair
                # traffic to a single tenant)
                psize = n_abusive if group == "abusive" else fair_pool
                base = 0 if group == "abusive" else n_abusive
                cid = base + ((cursors[group] + (i % B)) % psize)
                cursors[group] = (cursors[group] + B) % psize
                draws[group] += B
            tag = (self.abusive_tag if group == "abusive"
                   else self.tenant_tags[cid % len(self.tenant_tags)])
            tags_seen.add(tag)
            late = t >= half
            self.stats["issued"] += 1
            self.stats[group + "_issued"] += 1
            if late:
                self.stats["late_issued"] += 1
            if pool.dispatch((i, cid, tag, group, late, keys[i],
                              batch[i])):
                self.stats["admitted"] += 1
            else:
                self.stats["shed"] += 1
        await pool.drain()
        out = dict(self.stats)
        if cids is not None:
            out["distinct_clients"] = len(clients_seen)
        else:
            # cursor walks cover the pool exactly: distinct ids per
            # group = min(ids drawn, pool size) — O(1), no 10^6 set
            out["distinct_clients"] = (
                min(draws["abusive"], n_abusive)
                + min(draws["others"], fair_pool))
        out["clients_per_arrival"] = B
        out["logical_clients_offered"] = self.stats["issued"] * B
        # which tags actually carried traffic — a multiplexing stride
        # that aliased the tag modulus would show up as a single fair
        # tag here (test-pinned)
        out["tags_seen"] = sorted(tag.decode("latin-1")
                                  for tag in tags_seen)
        wall = flow.now() - start
        out["wall_seconds"] = round(wall, 3)
        out["attainment"] = round(
            out["admitted"] / max(out["issued"], 1), 4)
        out["committed_per_sec"] = round(
            out["completed"] / max(wall, 1e-9), 2)
        out["late_window_seconds"] = round(self.duration / 2, 3)
        out["late_committed_per_sec"] = round(
            out["late_completed"] / max(self.duration / 2, 1e-9), 2)
        out["grv"] = {g: s.snapshot() for g, s in self.grv_latency.items()}
        out["txn"] = {g: s.snapshot() for g, s in self.txn_latency.items()}
        out["n_clients"] = self.n_clients
        out["sim_perf"] = sim_perf_report(wall0, start, tasks0,
                                          net=_find_net(self.dbs))
        return out


class HotShardStorm:
    """Storage-heat proof storm: seeded open-loop READ
    arrivals where one tenant tag concentrates Zipfian point reads on a
    narrow key range at the head of the keyspace (the "hot shard")
    while background tenants read uniformly across all of it. The
    storage heat plane must NAME the hot sub-range (read-hot density
    detection) and the hot tenant (per-SS busiest read tag) — and,
    same seed, must name them bit-identically on replay.

    Every arrival is read-only: the storm heats the read side without
    perturbing the keyspace, so the armed-vs-off digest comparison is
    exact. Every 4th arrival is a short range read (index-determined,
    no extra RNG) so both read paths feed the sample. One attempt per
    arrival, the OpenLoopStorm honesty contract: shed and errored
    arrivals are counted, never hidden."""

    def __init__(self, dbs, rng, duration: float = 3.0,
                 hot_rate: float = 200.0, background_rate: float = 40.0,
                 keyspace: int = 192, hot_keys: int = 8,
                 zipf_s: float = 1.2, prefix: bytes = b"heat/",
                 hot_tag: bytes = b"tenant-hot",
                 background_tags: tuple = (b"tenant-a", b"tenant-b"),
                 value_bytes: int = 96, max_inflight: int = 512):
        self.dbs = list(dbs)
        self.rng = rng
        self.duration = duration
        self.hot_rate = hot_rate
        self.background_rate = background_rate
        self.keyspace = keyspace
        self.hot_keys = max(1, min(hot_keys, keyspace))
        self.prefix = prefix
        self.hot_tag = hot_tag
        self.background_tags = tuple(background_tags)
        self.value_bytes = value_bytes
        self.max_inflight = max_inflight
        self._hot_cdf = make_zipf_cdf(self.hot_keys, zipf_s)
        self.stats = {"issued": 0, "admitted": 0, "completed": 0,
                      "shed": 0, "hot_issued": 0, "background_issued": 0,
                      "rows_read": 0, "errors": {}}

    def key(self, rank: int) -> bytes:
        return self.prefix + b"k%04d" % rank

    @property
    def hot_range(self):
        """The range the hot tag hammers — what the detector must name
        (begin inclusive, end exclusive)."""
        return self.key(0), self.key(self.hot_keys - 1) + b"\x00"

    async def seed(self, db) -> None:
        """Materialize the keyspace (uniform value sizes, so the byte
        sample is flat and any density skew is genuinely READ skew)."""
        val = b"V" * self.value_bytes
        async def body(tr):
            for r in range(self.keyspace):
                tr.set(self.key(r), val)
        await run_transaction(db, body, max_retries=200)

    def draw_schedule(self):
        """Vectorized arrival schedule: offsets at the combined rate,
        hot/background group flags at the rate share, Zipf ranks inside
        the hot range for hot arrivals and uniform ranks for the rest.
        One fork draw on the shared flow RNG (the vectorized storms' idiom)."""
        g = _fork_np_rng(self.rng)
        total = self.hot_rate + self.background_rate
        times = _arrival_offsets(g, self.duration, lambda t: total, total)
        n = len(times)
        hot = _flag_array(g, n, self.hot_rate / max(total, 1e-9))
        hot_ranks = _zipf_ranks(g, self._hot_cdf, n)
        u = g.random(n).tolist() if n else []
        keys = [self.key(hot_ranks[i] if hot[i]
                         else min(int(u[i] * self.keyspace),
                                  self.keyspace - 1))
                for i in range(n)]
        return times, hot, keys

    async def _one_txn(self, i: int, key: bytes, hot: bool) -> None:
        db = self.dbs[i % len(self.dbs)]
        tr = db.create_transaction()
        try:
            tr.set_option(
                "transaction_tag",
                self.hot_tag if hot
                else self.background_tags[i % len(self.background_tags)])
            if i % 4 == 0:
                # short scan: the range-read path feeds the sample too
                rows = await tr.get_range(key, self.prefix + b"\xff",
                                          limit=4)
                self.stats["rows_read"] += len(rows)
            else:
                v = await tr.get(key)
                if v is not None:
                    self.stats["rows_read"] += 1
            self.stats["completed"] += 1
        except flow.FdbError as e:
            errs = self.stats["errors"]
            errs[e.name] = errs.get(e.name, 0) + 1

    async def run(self) -> dict:
        start = flow.now()
        wall0, tasks0 = _time.monotonic(), flow.g().tasks_run
        times, hot, keys = self.draw_schedule()
        pool = ClientActorPool(self._one_txn, self.max_inflight,
                               label="heat-txn")
        now = flow.now
        for i, t in enumerate(times):
            at = start + t
            if at > now():
                await flow.delay(at - now())
            self.stats["issued"] += 1
            self.stats["hot_issued" if hot[i]
                       else "background_issued"] += 1
            if pool.dispatch((i, keys[i], bool(hot[i]))):
                self.stats["admitted"] += 1
            else:
                self.stats["shed"] += 1
        await pool.drain()
        out = dict(self.stats)
        out["wall_seconds"] = round(flow.now() - start, 3)
        out["attainment"] = round(
            out["admitted"] / max(out["issued"], 1), 4)
        hb, he = self.hot_range
        out["hot_range"] = [hb.hex(), he.hex()]
        out["hot_tag"] = self.hot_tag.hex()
        out["sim_perf"] = sim_perf_report(wall0, start, tasks0,
                                          net=_find_net(self.dbs))
        return out


class SplitStorm:
    """Seeded skewed workload proving a LOAD-DRIVEN resolver split
    (driven by `tools/smoke.py --splits`): every key lives
    under a handful of first-byte prefixes owned by ONE resolver of a
    multi-resolver cluster, so the balance loop sees hard skew and —
    armed — must split the donor's hottest bucket and hand its state
    to the recipient live.

    Three oracles ride along: (1) exactness — a slice of the traffic
    is read-modify-write increments through ordinary retry loops, and
    the final counter values must equal the increment counts exactly
    (a lost or phantom conflict across the handoff window would break
    the sums); (2) load share — the donor's share of resolved
    transactions is sampled per window BEFORE and AFTER the first
    split, and must measurably drop; (3) the report carries committed/
    conflicted totals and a keyspace digest for same-seed comparisons."""

    def __init__(self, cluster, dbs, rng, duration: float = 8.0,
                 rate: float = 120.0, hot_prefixes: bytes = b"\x10\x18",
                 counters: int = 3, max_inflight: int = 256,
                 arm_at: "float | None" = None):
        self.cluster = cluster
        self.dbs = list(dbs)
        self.rng = rng
        self.duration = duration
        # drop in the one-shot FORCE mid-storm (sim-seconds from
        # start) so the donor's load share is sampled both BEFORE and
        # AFTER the first split; None = caller manages the knobs
        self.arm_at = arm_at
        self.rate = rate
        self.hot_prefixes = hot_prefixes
        self.counters = counters
        self.max_inflight = max_inflight
        self.stats = {"issued": 0, "admitted": 0, "completed": 0,
                      "conflicted": 0, "shed": 0, "increments": 0}

    def _resolver_roles(self):
        from .resolver_role import Resolver
        info = self.cluster.cc.dbinfo.get()
        from .cluster_controller import epoch_roles
        return sorted(epoch_roles(self.cluster.cc.workers, info.epoch,
                                  Resolver), key=lambda p: p[0])

    def _resolved_counts(self) -> list:
        return [r.stats.snapshot().get("transactions_resolved", 0)
                for _n, r in self._resolver_roles()]

    async def _one(self, i: int, key: bytes, incr_key) -> None:
        from ..client import run_transaction
        db = self.dbs[i % len(self.dbs)]
        try:
            if incr_key is not None:
                async def body(tr):
                    cur = await tr.get(incr_key)
                    tr.set(incr_key, b"%d" % (int(cur or b"0") + 1))
                await run_transaction(db, body, max_retries=500)
                self.stats["increments"] += 1
            else:
                async def body(tr):
                    tr.set(key, b"v%06d" % i)
                await run_transaction(db, body, max_retries=50)
            self.stats["completed"] += 1
        except flow.FdbError as e:
            if e.name == "operation_cancelled":
                raise
            self.stats["conflicted"] += 1
        finally:
            self._inflight -= 1

    async def run(self) -> dict:
        from .chaos import database_digest
        from .consistency import check_consistency
        g = self.rng.fork()
        self._inflight = 0
        incr_keys = [bytes([self.hot_prefixes[0]]) + b"ctr%d" % c
                     for c in range(self.counters)]
        expected = [0] * self.counters
        bal0 = dict(self.cluster.cc.balance_stats.snapshot())
        share_samples: list = []   # (splits_so_far, donor_share)
        last = self._resolved_counts()
        t_end = flow.now() + self.duration
        arm_t = flow.now() + self.arm_at if self.arm_at is not None \
            else None
        next_sample = flow.now() + 1.0
        i = 0
        while flow.now() < t_end:
            if arm_t is not None and flow.now() >= arm_t:
                # the loop itself must already be spawned (the cluster
                # booted with RESOLVER_BALANCE=1 and an unreachable
                # MIN_WORK); dropping in the one-shot FORCE here makes
                # the first split land mid-storm, with load-share
                # samples on both sides of it
                arm_t = None
                flow.SERVER_KNOBS.set("resolver_balance_force", 1)
            self.stats["issued"] += 1
            if self._inflight < self.max_inflight:
                self.stats["admitted"] += 1
                self._inflight += 1
                if g.random01() < 0.25:
                    c = g.random_int(0, self.counters)
                    expected[c] += 1
                    flow.spawn(self._one(i, b"", incr_keys[c]))
                else:
                    pfx = self.hot_prefixes[
                        g.random_int(0, len(self.hot_prefixes))]
                    key = bytes([pfx]) + b"k%06d" % i
                    flow.spawn(self._one(i, key, None))
            else:
                self.stats["shed"] += 1
            i += 1
            await flow.delay(g.random_exp(1.0 / self.rate))
            if flow.now() >= next_sample:
                next_sample = flow.now() + 1.0
                cur = self._resolved_counts()
                delta = [c - l for c, l in zip(cur, last)]
                last = cur
                tot = sum(delta)
                if tot > 0 and delta:
                    splits = self.cluster.cc.balance_stats.snapshot() \
                        .get("splits", 0) - bal0.get("splits", 0)
                    share_samples.append(
                        (splits, round(max(delta) / tot, 4)))
        # drain UNCONDITIONALLY before reading the oracle: a deadline
        # cutoff here would race in-flight increments against the
        # counter read and fail `exact` spuriously (the harness's
        # run(timeout_time=) bounds a genuine wedge)
        while self._inflight > 0:
            await flow.delay(0.1)
        # oracle 1: exact sums
        vals = []
        from ..client import run_transaction
        async def read_all(tr):
            vals.clear()
            for k in incr_keys:
                vals.append(int(await tr.get(k) or b"0"))
        await run_transaction(self.dbs[0], read_all)
        exact = vals == expected
        await check_consistency(self.cluster)
        digest = await database_digest(self.dbs[0])
        bal = self.cluster.cc.balance_stats.snapshot()
        # oracle 2: donor load share before vs after the first split
        before = [s for n, s in share_samples if n == 0]
        after = [s for n, s in share_samples if n > 0]
        report = {
            "stats": dict(self.stats),
            "expected": expected, "observed": vals, "exact": exact,
            "balance": {k: bal.get(k, 0) - bal0.get(k, 0)
                        for k in ("splits", "merges", "releases",
                                  "handoff_timeouts")},
            "share_before": round(sum(before) / len(before), 4)
            if before else None,
            "share_after": round(sum(after) / len(after), 4)
            if after else None,
            "consistency": "ok",
            "digest": digest,
        }
        return report


class ChaosStorm:
    """One named chaos scenario applied mid-flight under open-loop
    traffic, healed, quiesced, and VERIFIED (ref: the reference's
    stacked simulation tests — workload + attrition + clogging — with
    ConsistencyCheck as the closing oracle).

    Shape of a storm: start an OpenLoopStorm (seeded Zipfian
    arrivals) against the cluster, wait `lead_in`, run the scenario
    (server/chaos.py — it applies its faults and heals before
    returning), wait out the traffic, then assert the three oracles:

    - `check_consistency` over the surviving database (the primary, or
      the promoted region when the scenario moved it) is clean;
    - shadow validation reported ZERO mismatches (when a device
      backend with the shadow validator is present);
    - recovery was BOUNDED: scenario-end → quiesced within
      CHAOS_RECOVERY_BOUND sim-seconds.

    The returned report carries the network's full chaos event log and
    a SHA-256 digest of the final keyspace: two runs with the same seed
    must produce identical logs and digests (test-pinned replay)."""

    def __init__(self, cluster, dbs, rng, scenario: str,
                 duration: float = 5.0, rate: float = 40.0,
                 lead_in: float = 1.0, recovery_bound: float = None,
                 keyspace: int = 32):
        from .chaos import get_scenario
        self.cluster = cluster
        self.dbs = list(dbs)
        self.rng = rng
        self.scenario = get_scenario(scenario)
        self.lead_in = lead_in
        if recovery_bound is None:
            recovery_bound = float(flow.SERVER_KNOBS.chaos_recovery_bound)
        self.recovery_bound = recovery_bound
        # steady open-loop pressure, no burst: the scenario IS the storm.
        # A quarter of the traffic declares automatic_repair — inert
        # unless a BUGGIFY-randomized nightly cell armed TXN_REPAIR, in
        # which case the repair paths run under the scenario's faults
        # with the same consistency/shadow/digest oracles watching
        self.storm = OpenLoopStorm(
            self.dbs, rng, duration=duration, rate=rate, burst_rate=rate,
            burst_start=duration, keyspace=keyspace, prefix=b"chaos/",
            max_inflight=256, repairable_fraction=0.25)

    async def run(self) -> dict:
        from .chaos import chaos_status, database_digest, record_scenario
        from .consistency import check_consistency
        net = self.cluster.net
        sim0 = flow.now()
        wall0, tasks0 = _time.monotonic(), flow.g().tasks_run
        record_scenario(net, self.scenario.name)
        traffic = flow.spawn(self.storm.run(),
                             name=f"chaos-traffic-{self.scenario.name}")
        await flow.delay(self.lead_in)
        result = await self.scenario.run(self.cluster, self.rng)
        healed_at = flow.now()
        storm_stats = await traffic

        check_db = result.pop("check_db", None)
        if check_db is None:
            # heal → quiesce within the bound, then sweep every replica
            await self.cluster.quiet_database(max_wait=self.recovery_bound)
            # the bound covers scenario-end → QUIESCED; the consistency
            # sweep below is verification time, not recovery time
            recovery_seconds = flow.now() - healed_at
            consistency = await check_consistency(self.cluster,
                                                  quiesce=False)
            digest_db = self.cluster.client("chaos-digest")
        else:
            # the scenario moved the database (region failover): the
            # promoted epoch already accepts commits, so recovery ended
            # when the scenario returned; verify through the promoted
            # side's own client surface
            recovery_seconds = flow.now() - healed_at
            consistency = await flow.timeout_error(
                flow.spawn(check_consistency(check_db),
                           name="chaos-region-consistency"),
                self.recovery_bound)
            digest_db = check_db
        assert recovery_seconds <= self.recovery_bound, (
            f"{self.scenario.name}: recovery took {recovery_seconds:.1f}s "
            f"(bound {self.recovery_bound}s)")
        digest = await database_digest(digest_db)

        # shadow-validation cleanliness (the shadow's oracle, when present)
        status = await digest_db.get_status()
        cl = status["cluster"]
        for r in cl.get("resolvers", ()):
            sh = (r.get("failover") or {}).get("shadow") or {}
            assert not sh.get("mismatches"), (self.scenario.name, r)
        assert not any(m["name"] == "shadow_resolve_mismatch"
                       for m in cl.get("messages", ())), cl
        chaos = chaos_status(net)
        assert chaos["scenarios"].get(self.scenario.name), chaos

        return {
            "scenario": self.scenario.name,
            "result": result,
            "storm": storm_stats,
            "consistency": consistency,
            "digest": digest,
            "recovery_seconds": round(recovery_seconds, 3),
            "chaos": chaos,
            "events": list(net.chaos_log),
            # wall-vs-sim budget over the WHOLE storm (traffic +
            # scenario + quiesce + verification), message accounting
            # included when the plane is armed
            "sim_perf": sim_perf_report(wall0, sim0, tasks0, net=net),
            # the post-storm status doc, read through the SURVIVING
            # database (after region_failover the primary CC is gone —
            # callers must not have to query it for chaos accounting)
            "status": status,
        }


class ContentionStorm:
    """High-contention goodput workload (the conflict-prediction plane's
    measurement):
    seeded open-loop arrivals at a FIXED offered load, every arrival a
    read-modify-write on one of a few hot keys driven through a
    bounded client retry loop. The measure is COMMITTED GOODPUT —
    transactions that actually committed per second — not verdicts/s:
    under contention the abort-only baseline burns its capacity on
    retries and exhausted attempts, which is exactly the tax the
    scheduler/repair subsystem exists to convert into commits. Two
    runs with the same seed offer the identical arrival schedule, so
    `off vs on` is an apples-to-apples goodput comparison.

    Each transaction: read the hot key (records the read conflict),
    ADD 1 to it atomically, blind-set a unique payload row — a
    value-independent shape, honestly `automatic_repair`-declarable.
    The hot counters double as a bit-exactness oracle: their sum must
    equal the committed count exactly (a repair that double-applied or
    lost a mutation cannot hide), modulo unknown-outcome attempts
    which are counted, not retried."""

    def __init__(self, dbs, rng, duration: float = 4.0,
                 rate: float = 150.0, hot_keys: int = 2,
                 prefix: bytes = b"cont/", max_retries: int = 4,
                 repairable: bool = True, max_inflight: int = 512):
        self.dbs = list(dbs)
        self.rng = rng
        self.duration = duration
        self.rate = rate
        self.hot_keys = hot_keys
        self.prefix = prefix
        self.max_retries = max_retries
        self.repairable = repairable
        self.max_inflight = max_inflight
        from ..flow.latency import LatencySample
        self.txn_latency = LatencySample("contention_txn", size=4096)
        self.stats = {"issued": 0, "committed": 0, "conflicts": 0,
                      "failed": 0, "unknown": 0, "shed": 0,
                      "attempts": 0}

    def _hot_key(self, i: int) -> bytes:
        return self.prefix + b"hot%02d" % (i % self.hot_keys)

    async def _one_txn(self, i: int) -> None:
        import struct
        db = self.dbs[i % len(self.dbs)]
        k = self._hot_key(i)
        t0 = flow.now()
        tr = db.create_transaction()
        attempts = 0
        while True:
            attempts += 1
            self.stats["attempts"] += 1
            try:
                if self.repairable:
                    tr.set_option("automatic_repair")
                await tr.get(k)
                tr.atomic_op(k, struct.pack("<q", 1), ADD_VALUE)
                tr.set(self.prefix + b"r%07d" % i, b"x")
                await tr.commit()
                self.stats["committed"] += 1
                self.txn_latency.record(flow.now() - t0)
                return
            except flow.FdbError as e:
                if e.name in UNKNOWN_OUTCOME:
                    # never retried: the goodput oracle (hot-key
                    # sum == committed) must stay exact, and a
                    # retried unknown could double-apply the ADD
                    self.stats["unknown"] += 1
                    return
                if e.name == "not_committed":
                    self.stats["conflicts"] += 1
                if attempts > self.max_retries or \
                        e.name not in RETRYABLE:
                    self.stats["failed"] += 1
                    return
                try:
                    await tr.on_error(e)
                except flow.FdbError:
                    self.stats["failed"] += 1
                    return

    def draw_schedule(self) -> list:
        """Arrival offsets in one vectorized pass (key and handle per
        arrival are index-deterministic — no other randomness)."""
        g = _fork_np_rng(self.rng)
        return _arrival_offsets(g, self.duration, lambda t: self.rate,
                                self.rate)

    async def run(self) -> dict:
        start = flow.now()
        wall0, tasks0 = _time.monotonic(), flow.g().tasks_run
        times = self.draw_schedule()
        pool = ClientActorPool(self._one_txn, self.max_inflight,
                               label="cont-txn")
        now = flow.now
        for i, t in enumerate(times):
            at = start + t
            if at > now():
                await flow.delay(at - now())
            self.stats["issued"] += 1
            if not pool.dispatch((i,)):
                self.stats["shed"] += 1
        await pool.drain()
        out = dict(self.stats)
        wall = flow.now() - start
        out["wall_seconds"] = round(wall, 3)
        out["goodput_per_sec"] = round(out["committed"] / max(wall, 1e-9),
                                       2)
        out["attempts_per_commit"] = round(
            out["attempts"] / max(out["committed"], 1), 3)
        out["latency"] = self.txn_latency.snapshot()
        out["sim_perf"] = sim_perf_report(wall0, start, tasks0,
                                          net=_find_net(self.dbs))
        return out

    async def read_hot_total(self, db) -> int:
        """Sum of the hot ADD counters — must equal committed (plus at
        most `unknown`, whose outcomes the storm deliberately did not
        settle). The bit-exactness oracle for repaired commits."""
        import struct

        async def body(tr):
            total = 0
            for j in range(self.hot_keys):
                v = await tr.get(self.prefix + b"hot%02d" % j)
                if v is not None:
                    total += struct.unpack("<q", v)[0]
            return total
        return await run_transaction(db, body, max_retries=200)


class FuzzApiCorrectness:
    """API-misuse fuzz (ref: FuzzApiCorrectness.actor.cpp): drive the
    client surface with invalid inputs — oversized keys/values,
    oversized transactions, system-keyspace access without the option,
    extreme selector offsets — and assert the EXACT error every time,
    interleaved with valid operations proving the transaction object
    stays usable afterwards (an invalid argument raises; it must not
    poison the transaction or the process)."""

    def __init__(self, db, rng, prefix: bytes = b"fuzz/"):
        self.db = db
        self.rng = rng
        self.prefix = prefix
        self.stats = {"invalid_ops": 0, "valid_commits": 0}

    def _expect(self, name: str, fn) -> None:
        try:
            fn()
        except flow.FdbError as e:
            assert e.name == name, (e.name, name)
            self.stats["invalid_ops"] += 1
            return
        raise AssertionError(f"expected {name}, got success")

    async def _expect_async(self, name: str, coro) -> None:
        try:
            await coro
        except flow.FdbError as e:
            assert e.name == name, (e.name, name)
            self.stats["invalid_ops"] += 1
            return
        raise AssertionError(f"expected {name}, got success")

    async def run(self, rounds: int = 30) -> dict:
        key_limit = int(flow.SERVER_KNOBS.key_size_limit)
        value_limit = int(flow.SERVER_KNOBS.value_size_limit)
        for i in range(rounds):
            tr = self.db.create_transaction()
            kind = self.rng.random_int(0, 5)
            k = self.prefix + b"k%d" % self.rng.random_int(0, 9)
            if kind == 0:
                big = b"K" * (key_limit + 1 + self.rng.random_int(0, 64))
                self._expect("key_too_large", lambda: tr.set(big, b"v"))
            elif kind == 1:
                big = b"V" * (value_limit + 1 + self.rng.random_int(0, 64))
                self._expect("value_too_large", lambda: tr.set(k, big))
            elif kind == 2:
                # overflow the per-transaction byte budget with legal
                # individual writes
                chunk = b"C" * value_limit
                def overflow():
                    for j in range(
                            2 + int(flow.SERVER_KNOBS.transaction_size_limit)
                            // value_limit):
                        tr.set(self.prefix + b"big%d" % j, chunk)
                self._expect("transaction_too_large", overflow)
            elif kind == 3:
                self._expect("key_outside_legal_range",
                             lambda: tr.set(b"\xff/illegal", b"v"))
            elif kind == 4:
                await self._expect_async(
                    "key_outside_legal_range", tr.get(b"\xff/conf/x"))
            else:
                # extreme selector offsets resolve to the keyspace
                # bounds, never crash or escape the legal range
                sel = KeySelector(k, bool(self.rng.random_int(0, 1)),
                                  self.rng.random_int(500, 4000)
                                  * (1 if self.rng.random_int(0, 1) else -1))
                got = await tr.get_key(sel)
                assert got == b"" or got <= b"\xff", got
                self.stats["invalid_ops"] += 1
            # the transaction (or a fresh one, if the failed op poisoned
            # the byte budget) still works end-to-end
            tr2 = self.db.create_transaction()
            tr2.set(k, b"ok%d" % i)
            await tr2.commit()
            self.stats["valid_commits"] += 1
        return self.stats
