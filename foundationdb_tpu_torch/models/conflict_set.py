"""MVCC conflict resolution — semantics and CPU baseline.

Reference behavior (re-implemented, not ported):
  - fdbserver/ConflictSet.h:37-39  verdict enum {Conflict=0, TooOld=1, Committed=2}
  - fdbserver/SkipList.cpp:979     addTransaction — tooOld iff
        read_snapshot < oldestVersion AND the txn has read conflict ranges;
        a tooOld txn contributes no ranges at all
  - fdbserver/SkipList.cpp:1163    detectConflicts pipeline:
        (1) external check: a read range [b,e) at snapshot s conflicts iff
            max history version over intervals intersecting [b,e) is > s
            (strictly greater; ref CheckMax, SkipList.cpp:789-828)
        (2) intra-batch (ref checkIntraBatchConflicts, :1133): sequential in
            transaction order; txns already conflicted are skipped and their
            writes excluded; a txn conflicts if any of its read ranges
            overlaps a write range of an earlier non-conflicted txn
        (3) non-conflicted txns' write ranges are merged into the history
            as an interval assignment at the batch commit version
            (ref addConflictRanges, SkipList.cpp:511-522 — end keeps the old
            suffix version, [b,e) becomes the new version)
        (4) window GC: oldestVersion = max(oldestVersion, newOldestVersion);
            intervals at version < oldestVersion are semantically dead
  - fdbserver/Resolver.actor.cpp:155  newOldestVersion =
        commitVersion - MAX_WRITE_TRANSACTION_LIFE_VERSIONS

The history is modeled as a *step function* over the keyspace: sorted
boundary keys B[i] with V[i] = max commit version of writes to any key in
[B[i], B[i+1}). This is exactly the information content of the reference's
skiplist (per-node maxVersion); the data-structure choice differs because
each backend optimizes for its hardware (sorted arrays + RMQ on TPU,
std::map in native C++, bisect lists here).
"""

from __future__ import annotations

import time
from bisect import bisect_left, bisect_right
from typing import NamedTuple, Sequence

from .. import host_spans

CONFLICT = 0
TOO_OLD = 1
COMMITTED = 2

VERDICT_NAMES = {CONFLICT: "conflict", TOO_OLD: "too_old", COMMITTED: "committed"}


class ConflictSetCheckpoint(NamedTuple):
    """Backend-agnostic snapshot of a conflict-set's live state.

    The history is a step function over the keyspace (see the module
    docstring); a checkpoint captures it as a BASELINE version covering
    every key not named below, plus sorted disjoint interval
    `assignments` (begin, end, version) overriding the baseline — the
    exact information content of every backend's state, whatever its
    data-structure (bisect lists, std::map, device arrays, per-key
    point map). `oldest_version` and `last_commit` restore the MVCC
    window and the version-ordering floor.

    Restore parity contract: any backend restored from a checkpoint
    yields bit-identical verdicts to the backend that produced it, for
    every subsequent batch — dead intervals (version < oldest) are
    clamped to a dead-equivalent value at capture, which is
    verdict-invariant (no non-tooOld read snapshot is below oldest)."""

    oldest_version: int
    last_commit: int
    baseline_version: int
    assignments: tuple  # of (begin: bytes, end: bytes, version: int)


def checkpoint_from_step(keys: Sequence[bytes], vals: Sequence[int],
                         oldest: int, last_commit: int
                         ) -> ConflictSetCheckpoint:
    """Build a checkpoint from a full-coverage step function (keys[0]
    must be b""; vals[i] covers [keys[i], keys[i+1}) with the last
    interval running to +inf). The tail interval's version becomes the
    baseline, so every emitted assignment has a finite end; dead
    intervals are clamped (verdict-invariant, see ConflictSetCheckpoint)."""
    if not keys or keys[0] != b"":
        raise ValueError("step function must cover the keyspace from b''")
    baseline = int(vals[-1])
    dead_v = min(baseline, int(oldest) - 1)
    out = []
    for i in range(len(keys) - 1):
        v = int(vals[i])
        if v < oldest:
            v = dead_v
        if v != baseline:
            out.append((keys[i], keys[i + 1], v))
    return ConflictSetCheckpoint(int(oldest), int(last_commit),
                                 baseline, tuple(out))


def step_from_checkpoint(ckpt: ConflictSetCheckpoint):
    """Materialize a checkpoint back into a full-coverage step function
    (keys, vals) — the inverse of checkpoint_from_step, also correct
    for point-backend checkpoints (baseline between the points)."""
    keys: list[bytes] = [b""]
    vals: list[int] = [int(ckpt.baseline_version)]
    for b, e, v in sorted(ckpt.assignments):
        if e is None or b >= e:
            raise ValueError(f"malformed checkpoint range [{b!r}, {e!r})")
        if b < keys[-1]:
            raise ValueError("checkpoint assignments overlap")
        if b == keys[-1]:
            vals[-1] = int(v)
        else:
            keys.append(b)
            vals.append(int(v))
        keys.append(e)
        vals.append(int(ckpt.baseline_version))
    # coalesce equal neighbors (pure cosmetics: fewer rows on restore)
    ck: list[bytes] = [keys[0]]
    cv: list[int] = [vals[0]]
    for k, v in zip(keys[1:], vals[1:]):
        if v != cv[-1]:
            ck.append(k)
            cv.append(v)
    return ck, cv


def clip_step(keys: Sequence[bytes], vals: Sequence[int], lo: bytes,
              hi: "bytes | None"):
    """Restrict a full-coverage step function to [lo, hi): the returned
    lists start with an explicit boundary AT lo carrying the covering
    version (the shard-state invariant: slot 0 is the shard's lower
    bound)."""
    i = bisect_right(keys, lo) - 1
    out_k: list[bytes] = [lo]
    out_v: list[int] = [int(vals[i])]
    for j in range(i + 1, len(keys)):
        if hi is not None and keys[j] >= hi:
            break
        out_k.append(keys[j])
        out_v.append(int(vals[j]))
    return out_k, out_v


class ConflictRangePiece(NamedTuple):
    """One key range's slice of a conflict-set checkpoint — the unit of
    resolver state handoff (a balance-driven split moves
    [begin, end) from donor to recipient; the donor's clipped step
    function rides the wire inside this piece and is grafted into the
    recipient with `graft_checkpoint`).

    `keys`/`vals` are a clip_step-shaped step function over [begin,
    end): keys[0] == begin, vals[i] covers [keys[i], keys[i+1}) with
    the last interval running to `end` (None = keyspace tail).
    `oldest_version`/`last_commit` carry the donor's MVCC window so the
    graft can only ever ADVANCE the recipient's floor."""

    begin: bytes
    end: "bytes | None"
    keys: tuple
    vals: tuple
    oldest_version: int
    last_commit: int


def clip_checkpoint(ckpt: ConflictSetCheckpoint, lo: bytes,
                    hi: "bytes | None") -> ConflictRangePiece:
    """The [lo, hi) slice of a checkpoint as a handoff piece."""
    keys, vals = step_from_checkpoint(ckpt)
    ck, cv = clip_step(keys, vals, lo, hi)
    return ConflictRangePiece(lo, hi, tuple(ck), tuple(cv),
                              int(ckpt.oldest_version),
                              int(ckpt.last_commit))


def _step_at(keys: Sequence[bytes], vals: Sequence[int],
             key: bytes) -> int:
    """Value of the covering interval at `key` (keys[0] <= key)."""
    return int(vals[bisect_right(keys, key) - 1])


def graft_checkpoint(base: ConflictSetCheckpoint,
                     piece: ConflictRangePiece) -> ConflictSetCheckpoint:
    """Merge a handoff piece into a full checkpoint: outside the
    piece's span the base is untouched; inside, each interval takes the
    POINTWISE MAX of base and piece. Max — not replace — because step
    values are monotone (assignments only ever raise a key's version),
    so whichever side saw a write later holds the higher version: the
    recipient may already have recorded post-move writes the donor's
    checkpoint predates, and the piece holds pre-move history the
    recipient never saw. The union is exactly the unsplit oracle's
    step function over the span — the bit-exactness the handoff tests
    pin.

    Watermark discipline under in-flight skew (the donor checkpoints
    at/after the move's effective version; the recipient's install may
    land while it is still resolving earlier batches): the recipient's
    GLOBAL `oldest_version` is KEPT — adopting the donor's (possibly
    further-advanced) watermark would flip near-window-boundary reads
    in the recipient's in-flight batches to tooOld verdicts the
    unsplit oracle never issues. Piece values that were DEAD at the
    donor (below the donor's watermark — including the donor's own
    dead-clamp rows) are re-clamped below the RECIPIENT's watermark:
    a donor clamp value can exceed an in-flight batch's legal read
    snapshot, which would manufacture conflicts; dropping such a value
    loses nothing, because during the double-delivery window the donor
    still votes with full history, and after the early release every
    legal snapshot is above the donor's watermark (the release rides
    the version chain behind the checkpoint). `last_commit` takes the
    max — it is restore-replay metadata, and the span carries writes
    up to the donor's chain position."""
    bk, bv = step_from_checkpoint(base)
    lo, hi = piece.begin, piece.end
    pk, pv = list(piece.keys), list(piece.vals)
    if not pk or pk[0] != lo:
        raise ValueError("piece step must start at its own begin key")
    oldest = int(base.oldest_version)
    # dead-equivalent value, floored at 0: no read snapshot is ever
    # negative, so 0 can never out-version a legal read, and device
    # backends need non-negative versions
    dead_v = max(0, oldest - 1)
    piece_oldest = int(piece.oldest_version)
    # candidate boundaries: the base's, the piece's, plus the span
    # edges; value at each = base outside the span, max(base, piece)
    # inside; equal neighbors coalesce
    bounds = set(bk) | set(pk) | {lo}
    if hi is not None:
        bounds.add(hi)
    out_k: list[bytes] = []
    out_v: list[int] = []
    for k in sorted(bounds):
        v = _step_at(bk, bv, k)
        if k >= lo and (hi is None or k < hi):
            p = _step_at(pk, pv, k)
            if p < piece_oldest:
                p = min(p, dead_v)
            v = max(v, p)
        if out_k and out_v[-1] == v:
            continue
        out_k.append(k)
        out_v.append(v)
    last_commit = max(int(base.last_commit), int(piece.last_commit))
    return checkpoint_from_step(out_k, out_v, oldest, last_commit)


class ResolverTransaction(NamedTuple):
    """One transaction's conflict information (ref: CommitTransactionRef,
    fdbclient/CommitTransaction.h:136-168 — read/write conflict ranges +
    read_snapshot)."""

    read_snapshot: int
    read_ranges: tuple  # of (begin: bytes, end: bytes), half-open
    write_ranges: tuple  # of (begin: bytes, end: bytes), half-open


class ResolveTicket:
    """Handle for one submitted conflict batch (ConflictSetBase.submit).

    Holds either the finished result or a `materialize` closure that
    blocks only on THIS batch's verdict readback (the device serializes
    batches, so materializing ticket k implicitly waits for k-1's
    compute but never for k+1's). Draining is idempotent: the first
    drain runs the closure, later drains return the cached result, so
    duplicate deliveries and out-of-order drains are both safe."""

    __slots__ = ("commit_version", "n", "drained", "_result",
                 "_materialize")

    def __init__(self, commit_version: int, n: int, materialize=None,
                 result=None):
        self.commit_version = commit_version
        self.n = n
        self.drained = False
        self._result = result
        self._materialize = materialize

    @property
    def done(self) -> bool:
        """True once the result is host-resident (no blocking left)."""
        return self._materialize is None

    def _force(self):
        if self._materialize is not None:
            # the closure is cleared only AFTER it succeeds: a device
            # fault raised mid-materialize must leave the ticket
            # un-materialized (drainable again / replayable), never
            # "done" with a silent None result
            result = self._materialize()
            self._materialize = None
            self._result = result
        return self._result


class ResolvePipeline:
    """Ticket queue + accounting for the split submit/drain resolve
    path: up to `depth` batches stay in flight between submit and
    drain (ref: the commit-pipeline overlap the proxy's
    latestLocalCommitBatch* interlocks buy for logging, applied to the
    resolver boundary; batch-level pipelining of conflict checks per
    the batched-conflict-resolution literature, arXiv:1804.00947).

    Submitting past `depth` force-drains the OLDEST ticket — the front
    of the device queue, so the stall is one batch's readback, not the
    whole backlog. Latencies are wall-clock (`time.perf_counter`):
    they measure the host/device boundary, not simulated time."""

    __slots__ = ("_depth", "in_flight", "peak_in_flight", "submits",
                 "drains", "forced_drains", "_occ_sum",
                 "submit_latency", "drain_latency")

    def __init__(self, depth: "int | None" = None):
        self._depth = depth          # None: read the knob per submit
        self.in_flight: list = []    # submitted, not yet materialized
        self.peak_in_flight = 0
        self.submits = 0
        self.drains = 0
        self.forced_drains = 0
        self._occ_sum = 0            # sum of in-flight depth at submit
        from ..flow.latency import RequestLatency
        self.submit_latency = RequestLatency("pipeline_submit")
        self.drain_latency = RequestLatency("pipeline_drain")

    @property
    def depth(self) -> int:
        if self._depth is not None:
            return max(1, int(self._depth))
        from ..flow.knobs import SERVER_KNOBS
        return max(1, int(SERVER_KNOBS.resolve_pipeline_depth))

    def note_submit(self, ticket: ResolveTicket, t0: float,
                    spans: "host_spans.HostSpans | None" = None) -> None:
        """Admit `ticket` (submitted at `t0`, perf_counter seconds); a
        forced drain is a wait of the submit's `spans`, if given."""
        self.submits += 1
        self.submit_latency.record(time.perf_counter() - t0)
        if not ticket.done:
            # backpressure BEFORE admitting the new ticket: the window
            # never exceeds depth, and depth 1 degenerates to the
            # serial submit-block-read path
            while len(self.in_flight) >= self.depth:
                self.forced_drains += 1
                with host_spans.wait(spans, "wait.forced_drain"):
                    self.drain(self.in_flight[0])
            self.in_flight.append(ticket)
        self._occ_sum += len(self.in_flight)
        if len(self.in_flight) > self.peak_in_flight:
            self.peak_in_flight = len(self.in_flight)

    def drain(self, ticket: ResolveTicket):
        try:
            self.in_flight.remove(ticket)     # list is <= depth+1 long
        except ValueError:
            pass                              # already materialized
        if not ticket.drained:
            if not ticket.done:
                # a materialize failure (device fault) propagates with
                # the ticket still UNDRAINED — the idempotent-drain
                # contract holds: a later drain retries or returns the
                # replayed result, never a silent None
                t0 = time.perf_counter()
                ticket._force()
                self.drain_latency.record(time.perf_counter() - t0)
            ticket.drained = True
            self.drains += 1
        return ticket._result

    def stats(self) -> dict:
        """Status-ready snapshot: depth/occupancy gauges, submit/drain
        counters, and the submit-vs-drain wall-latency bands."""
        return {"depth": self.depth,
                "in_flight": len(self.in_flight),
                "peak_in_flight": self.peak_in_flight,
                "submits": self.submits,
                "drains": self.drains,
                "forced_drains": self.forced_drains,
                # mean in-flight window over configured depth: ~1 means
                # the pipeline actually runs full, ~0 means serial use
                "occupancy": round(
                    self._occ_sum / (self.submits * self.depth), 4)
                if self.submits else None,
                "latency": {
                    "submit": self.submit_latency.snapshot(),
                    "drain": self.drain_latency.snapshot()}}


class ConflictSetBase:
    """Interface all backends implement; parity across backends is the
    north-star acceptance criterion."""

    BACKEND = "base"

    def resolve(self, txns: Sequence[ResolverTransaction], commit_version: int,
                new_oldest_version: int) -> list[int]:
        raise NotImplementedError

    def resolve_with_attribution(self, txns: Sequence[ResolverTransaction],
                                 commit_version: int,
                                 new_oldest_version: int):
        """Like `resolve`, but additionally attributes each conflicted
        transaction to the read-range indices that CAUSED the conflict
        (ref: report_conflicting_keys — fdbclient grew the option so
        operators can see which keys abort transactions).

        Returns (verdicts, attributions) where attributions[t] is a
        sorted tuple of indices into txns[t].read_ranges, or None in
        place of the whole list when the backend cannot attribute (the
        caller then degrades to verdicts-only). Attribution semantics,
        identical across every backend: a read range is a cause iff it
        conflicts against the pre-batch history at the transaction's
        snapshot, OR it overlaps a write range of an earlier
        NON-conflicted transaction in the same batch — evaluated for
        every non-tooOld transaction, including externally-conflicted
        ones, so the set is order-insensitive. tooOld transactions
        attribute nothing (they contribute no ranges at all)."""
        return self.resolve(txns, commit_version, new_oldest_version), None

    @property
    def oldest_version(self) -> int:
        raise NotImplementedError

    def validate_txns(self, txns: Sequence[ResolverTransaction],
                      oldest_version: "int | None" = None) -> None:
        """Host-side mirror of this backend's input contract: raise the
        same ValueError `submit` would raise for a malformed batch (a
        key wider than the device key bucket, a non-point range on the
        point backend), WITHOUT touching device state. The failover
        wrapper runs the PRIMARY's validator while serving from the
        permissive CPU fallback, so the resolver role's batch-reject
        behavior — and with it the verdict stream — stays bit-identical
        across the failover boundary, and every logged batch stays
        device-replayable for reattach. Host backends accept anything."""

    def input_contract(self):
        """`validate_txns` as a STATE-FREE callable, safe to hold long
        after this backend (and any device buffers) are discarded; call
        it with an explicit `oldest_version`. The base no-op reads no
        state, so the bound method is already safe; the device backends
        hand out a view carrying only their key-bucket config."""
        return self.validate_txns

    # -- split submit/drain pipeline ------------------------------------
    @property
    def pipeline(self) -> ResolvePipeline:
        p = getattr(self, "_pipeline", None)
        if p is None:
            p = self._pipeline = ResolvePipeline()
        return p

    def submit(self, txns: Sequence[ResolverTransaction],
               commit_version: int, new_oldest_version: int,
               attribute: bool = False) -> ResolveTicket:
        """Enqueue one batch without waiting for its verdicts; `drain`
        the returned ticket for the result. Submissions must follow
        commit-version order (the same contract as `resolve`); drains
        may happen in any order. The base implementation resolves
        eagerly — host backends have no device work to overlap — so the
        ticket is born materialized; the device backends override this
        with a genuinely asynchronous dispatch and the pipeline keeps
        up to RESOLVE_PIPELINE_DEPTH batches in flight."""
        t0 = time.perf_counter()
        if attribute:
            result = self.resolve_with_attribution(
                txns, commit_version, new_oldest_version)
        else:
            result = (self.resolve(txns, commit_version,
                                   new_oldest_version), None)
        ticket = ResolveTicket(commit_version, len(txns), result=result)
        self.pipeline.note_submit(ticket, t0)
        return ticket

    def drain(self, ticket: ResolveTicket) -> list:
        """Block until THIS ticket's verdicts are host-resident and
        return them (idempotent)."""
        return self.pipeline.drain(ticket)[0]

    def drain_with_attribution(self, ticket: ResolveTicket):
        """(verdicts, attributions) for a ticket submitted with
        `attribute=True`; attributions is None otherwise."""
        return self.pipeline.drain(ticket)

    def pipeline_stats(self) -> dict:
        """Status-ready pipeline counters (every backend has them; the
        device backends are where the in-flight window matters)."""
        return self.pipeline.stats()

    def kernel_stats(self) -> dict:
        """Device-kernel profile for status; non-device backends have
        none (the TPU backends override with pad/occupancy/compile
        accounting)."""
        return {}

    # -- checkpoint / restore -------------------------------------------
    def checkpoint(self) -> ConflictSetCheckpoint:
        """Serialize the live state (oldest-version watermark + the
        history step function) into a backend-agnostic snapshot. Drains
        the resolve pipeline first: a checkpoint must reflect every
        submitted batch, and the device backends D2H their key/version
        arrays — which blocks behind queued kernels anyway."""
        for t in list(self.pipeline.in_flight):
            self.pipeline.drain(t)
        return self._checkpoint_state()

    def restore(self, ckpt: ConflictSetCheckpoint) -> None:
        """Rebuild this backend's state from a checkpoint (taken from
        ANY backend; cross-backend restores yield bit-identical verdicts
        for every later batch). Existing state is discarded."""
        for t in list(self.pipeline.in_flight):
            self.pipeline.drain(t)
        self._restore_state(ckpt)

    def _checkpoint_state(self) -> ConflictSetCheckpoint:
        raise NotImplementedError(
            f"{self.BACKEND} backend does not support checkpoint()")

    def _restore_state(self, ckpt: ConflictSetCheckpoint) -> None:
        """Default restore: reset to the checkpoint baseline, then
        deterministically REPLAY the assignments as write-only batches
        in version order through the backend's own resolve step — every
        backend reconstructs the identical step function through its
        public contract (the merge assigns exactly [b,e) -> commit
        version; disjoint assignments commute, version order keeps
        non-decreasing-commit backends happy). Backends with a cheaper
        direct path (host array rebuilds) override this."""
        self._reset_state(int(ckpt.baseline_version))
        by_version: dict[int, list] = {}
        for b, e, v in ckpt.assignments:
            by_version.setdefault(int(v), []).append((b, e))
        for v in sorted(by_version):
            self.resolve([ResolverTransaction(v, (), tuple(by_version[v]))],
                         v, 0)
        # advance the window + ordering floor with a rangeless txn (it
        # can never conflict or be tooOld, and — unlike an empty batch —
        # every backend runs it through the full GC step)
        self.resolve([ResolverTransaction(ckpt.last_commit, (), ())],
                     ckpt.last_commit, ckpt.oldest_version)

    def _reset_state(self, baseline_version: int) -> None:
        raise NotImplementedError(
            f"{self.BACKEND} backend does not support restore()")


class PyConflictSet(ConflictSetBase):
    """Pure-Python step-function baseline (sorted boundary list + bisect)."""

    BACKEND = "python"

    def __init__(self, init_version: int = 0):
        # Invariant: _keys[0] == b"" always; _vals[i] covers [_keys[i], _keys[i+1}).
        # init_version baselines the whole keyspace (ref: clearConflictSet /
        # SkipList(v)); oldestVersion starts at 0 regardless (ref: ConflictSet
        # ctor, SkipList.cpp:926).
        self._keys: list[bytes] = [b""]
        self._vals: list[int] = [init_version]
        self._oldest = 0
        self._last_commit = init_version
        self._resolved_batches = 0

    @property
    def oldest_version(self) -> int:
        return self._oldest

    # -- checkpoint / restore ------------------------------------------
    def _checkpoint_state(self) -> ConflictSetCheckpoint:
        return checkpoint_from_step(self._keys, self._vals, self._oldest,
                                    self._last_commit)

    def _restore_state(self, ckpt: ConflictSetCheckpoint) -> None:
        self._keys, self._vals = step_from_checkpoint(ckpt)
        self._oldest = int(ckpt.oldest_version)
        self._last_commit = int(ckpt.last_commit)
        self._resolved_batches = 0

    # -- queries ------------------------------------------------------------
    def _range_max(self, begin: bytes, end: bytes) -> int:
        """Max version over intervals intersecting [begin, end)."""
        lo = bisect_right(self._keys, begin) - 1  # interval containing begin
        hi = bisect_left(self._keys, end)  # first boundary >= end
        return max(self._vals[lo:hi])

    # -- updates ------------------------------------------------------------
    def _assign(self, begin: bytes, end: bytes, version: int) -> None:
        """Set version for all keys in [begin, end) (ref: addConflictRanges)."""
        hi = bisect_right(self._keys, end) - 1
        v_end = self._vals[hi]  # version of the interval containing `end`
        lo = bisect_left(self._keys, begin)
        e_idx = bisect_left(self._keys, end)
        has_end = e_idx < len(self._keys) and self._keys[e_idx] == end
        repl_keys, repl_vals = [begin], [version]
        if not has_end:
            repl_keys.append(end)
            repl_vals.append(v_end)
        self._keys[lo:e_idx] = repl_keys
        self._vals[lo:e_idx] = repl_vals

    def _compact(self) -> None:
        """Collapse adjacent intervals that are both dead (< oldest) or equal.

        Dead intervals (version < oldestVersion) cannot conflict with any
        non-tooOld read, so merging them (keeping the max) is invisible
        (ref: removeBefore, SkipList.cpp:665 — the same window GC)."""
        keys, vals, oldest = self._keys, self._vals, self._oldest
        nk, nv = [keys[0]], [vals[0]]
        for i in range(1, len(keys)):
            v = vals[i]
            if (v < oldest and nv[-1] < oldest) or v == nv[-1]:
                if v > nv[-1]:
                    nv[-1] = v
            else:
                nk.append(keys[i])
                nv.append(v)
        self._keys, self._vals = nk, nv

    # -- the resolve step ---------------------------------------------------
    def resolve(self, txns: Sequence[ResolverTransaction], commit_version: int,
                new_oldest_version: int) -> list[int]:
        return self._resolve(txns, commit_version, new_oldest_version, None)

    def resolve_with_attribution(self, txns: Sequence[ResolverTransaction],
                                 commit_version: int,
                                 new_oldest_version: int):
        collect: list[list[int]] = [[] for _ in txns]
        verdicts = self._resolve(txns, commit_version, new_oldest_version,
                                 collect)
        return verdicts, [tuple(sorted(set(c))) for c in collect]

    def _resolve(self, txns: Sequence[ResolverTransaction],
                 commit_version: int, new_oldest_version: int,
                 collect) -> list[int]:
        n = len(txns)
        too_old = [False] * n
        conflict = [False] * n

        for t, tr in enumerate(txns):
            if tr.read_snapshot < self._oldest and len(tr.read_ranges):
                too_old[t] = True

        # (1) external check against history. Attribution mode checks
        # EVERY range (the short-circuit would under-report causes).
        for t, tr in enumerate(txns):
            if too_old[t]:
                continue
            for ri, (b, e) in enumerate(tr.read_ranges):
                if b < e and self._range_max(b, e) > tr.read_snapshot:
                    conflict[t] = True
                    if collect is None:
                        break
                    collect[t].append(ri)

        # (2) intra-batch, sequential in batch order. Attribution mode
        # also checks the reads of already-conflicted transactions
        # against the written set at their turn (their writes still
        # never join it), so the attributed set covers intra causes of
        # externally-conflicted transactions too.
        written: list[tuple[bytes, bytes]] = []  # sorted by begin, disjoint
        wkeys: list[bytes] = []  # begins, for bisect
        for t, tr in enumerate(txns):
            if conflict[t]:
                if collect is not None and not too_old[t]:
                    for ri, (b, e) in enumerate(tr.read_ranges):
                        if b < e and _overlaps_any(written, wkeys, b, e):
                            collect[t].append(ri)
                continue
            c = too_old[t]
            if not c:
                for ri, (b, e) in enumerate(tr.read_ranges):
                    if b < e and _overlaps_any(written, wkeys, b, e):
                        c = True
                        if collect is None:
                            break
                        collect[t].append(ri)
            conflict[t] = c
            if not c:
                for b, e in tr.write_ranges:
                    if b < e:
                        _interval_union_add(written, wkeys, b, e)

        # (3) merge surviving writes into history at the commit version
        for b, e in written:
            self._assign(b, e, commit_version)

        # (4) window GC
        if new_oldest_version > self._oldest:
            self._oldest = new_oldest_version
        if commit_version > self._last_commit:
            self._last_commit = commit_version
        self._resolved_batches += 1
        from ..flow import SERVER_KNOBS
        if self._resolved_batches % int(
                SERVER_KNOBS.conflict_set_compact_every) == 0:
            self._compact()

        return [TOO_OLD if too_old[t] else (CONFLICT if conflict[t] else COMMITTED)
                for t in range(n)]


def _overlaps_any(written: list, wkeys: list, b: bytes, e: bytes) -> bool:
    """Does [b,e) intersect any interval in the sorted disjoint set?"""
    i = bisect_right(wkeys, b) - 1
    if i >= 0 and written[i][1] > b:
        return True
    i += 1
    return i < len(written) and written[i][0] < e


def _interval_union_add(written: list, wkeys: list, b: bytes, e: bytes) -> None:
    """Insert [b,e) into a sorted disjoint interval set, coalescing overlaps."""
    i = bisect_right(wkeys, b) - 1
    start = i if (i >= 0 and written[i][1] >= b) else i + 1
    j = start
    while j < len(written) and written[j][0] <= e:
        j += 1
    if start < j:
        b = min(b, written[start][0])
        e = max(e, written[j - 1][1])
    written[start:j] = [(b, e)]
    wkeys[start:j] = [b]


class BruteForceConflictSet(ConflictSetBase):
    """O(everything) model for randomized cross-checks (ref test model:
    workloads/ConflictRange.actor.cpp:30 — exact conflict-or-not vs a model).

    Keeps every committed write range with its version; no GC compaction, so
    it is the ground truth the optimized backends must match bit-for-bit.
    """

    def __init__(self, init_version: int = 0):
        # \xff*64 stands in for the end of the keyspace; tests stay below it.
        self._writes: list[tuple[bytes, bytes, int]] = [(b"", b"\xff" * 64, init_version)]
        self._oldest = 0

    @property
    def oldest_version(self) -> int:
        return self._oldest

    def resolve(self, txns, commit_version, new_oldest_version):
        return self._resolve(txns, commit_version, new_oldest_version,
                             None)

    def resolve_with_attribution(self, txns, commit_version,
                                 new_oldest_version):
        collect: list[list[int]] = [[] for _ in txns]
        verdicts = self._resolve(txns, commit_version, new_oldest_version,
                                 collect)
        return verdicts, [tuple(sorted(set(c))) for c in collect]

    def _resolve(self, txns, commit_version, new_oldest_version, collect):
        n = len(txns)
        verdicts = [COMMITTED] * n
        added: list[tuple[bytes, bytes]] = []
        for t, tr in enumerate(txns):
            if tr.read_snapshot < self._oldest and len(tr.read_ranges):
                verdicts[t] = TOO_OLD
                continue
            bad = False
            for ri, (b, e) in enumerate(tr.read_ranges):
                if b >= e:
                    continue
                hit = any(wb < e and b < we and wv > tr.read_snapshot
                          for wb, we, wv in self._writes)
                hit = hit or any(wb < e and b < we for wb, we in added)
                if hit:
                    bad = True
                    if collect is None:
                        break
                    collect[t].append(ri)
            if bad:
                verdicts[t] = CONFLICT
            else:
                for b, e in tr.write_ranges:
                    if b < e:
                        added.append((b, e))
        for b, e in added:
            self._writes.append((b, e, commit_version))
        if new_oldest_version > self._oldest:
            self._oldest = new_oldest_version
        return verdicts



# ConflictRangePiece (and the checkpoint it slices) cross the wire in
# the resolver split/merge handoff RPCs (server/resolver_role.py), so
# both are RPC vocabulary; rpc.wire imports nothing from models, so
# the targeted registration is cycle-free.
from ..rpc import wire as _wire  # noqa: E402

_wire.register_message(ConflictSetCheckpoint)
_wire.register_message(ConflictRangePiece)
