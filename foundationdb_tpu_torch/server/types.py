"""Shared transaction-subsystem types.

Reference: fdbclient/CommitTransaction.h — `MutationRef` (:49-109, the
full 21-type vocabulary) and `CommitTransactionRef` (:136-168:
read/write conflict ranges + mutations + read_snapshot).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

SET_VALUE = 0
CLEAR_RANGE = 1
ADD_VALUE = 2
DEBUG_KEY_RANGE = 3     # tracing marker: carried, never mutates data
DEBUG_KEY = 4           # tracing marker
NO_OP = 5
AND = 6                 # applied with V2 (absent -> operand) semantics
OR = 7
XOR = 8
APPEND_IF_FITS = 9
AVAILABLE_FOR_REUSE = 10        # never legal in a transaction
RESERVED_LOG_PROTOCOL = 11      # LogProtocolMessage escape, server-only
MAX = 12
MIN = 13                # applied with V2 semantics
SET_VERSIONSTAMPED_KEY = 14
SET_VERSIONSTAMPED_VALUE = 15
BYTE_MIN = 16
BYTE_MAX = 17
MIN_V2 = 18             # explicit V2 code (MIN already applies V2)
AND_V2 = 19
COMPARE_AND_CLEAR = 20

ATOMIC_OPS = frozenset({ADD_VALUE, AND, OR, XOR, APPEND_IF_FITS, MAX, MIN,
                        BYTE_MIN, BYTE_MAX, MIN_V2, AND_V2,
                        COMPARE_AND_CLEAR})
# inert through the pipeline: logged and shipped but mutate nothing
# (ref: DebugKeyRange/DebugKey/NoOp in applyMutation)
INERT_OPS = frozenset({DEBUG_KEY_RANGE, DEBUG_KEY, NO_OP})

Range = Tuple[bytes, bytes]


class KeySelector(NamedTuple):
    """(ref: fdbclient/FDBTypes.h KeySelectorRef — resolves to the key
    `offset` keys past the first key `>=`/`>` the reference key)."""

    key: bytes
    or_equal: bool
    offset: int

    @classmethod
    def last_less_than(cls, key: bytes) -> "KeySelector":
        return cls(key, False, 0)

    @classmethod
    def last_less_or_equal(cls, key: bytes) -> "KeySelector":
        return cls(key, True, 0)

    @classmethod
    def first_greater_than(cls, key: bytes) -> "KeySelector":
        return cls(key, True, 1)

    @classmethod
    def first_greater_or_equal(cls, key: bytes) -> "KeySelector":
        return cls(key, False, 1)


class MutationRef(NamedTuple):
    type: int
    param1: bytes  # key / range begin
    param2: bytes  # value / range end


def mutation_bytes(m: "MutationRef") -> int:
    """Payload-size estimate for batching/spill/chunking decisions (one
    shared formula so byte limits can't silently diverge)."""
    return len(m.param1) + len(m.param2) + 16


class CommitRequest(NamedTuple):
    """One transaction's commit payload (ref: CommitTransactionRequest)."""

    read_snapshot: int
    read_conflict_ranges: Tuple[Range, ...]
    write_conflict_ranges: Tuple[Range, ...]
    mutations: Tuple[MutationRef, ...]
    # sampled-transaction stitching token (ref: debugTransaction /
    # the debugID riding CommitTransactionRequest)
    debug_id: Optional[int] = None
    # surface the conflicting key ranges on abort (ref: the
    # REPORT_CONFLICTING_KEYS transaction option,
    # fdbclient/CommitTransaction.h report_conflicting_keys flag)
    report_conflicting_keys: bool = False
    # admission priority class + client-supplied transaction tags (ref:
    # TransactionPriority and the TagSet riding
    # CommitTransactionRequest — the proxy's per-tag/priority traffic
    # accounting, and later tag throttling, keys off these)
    priority: int = 1          # PRIORITY_DEFAULT
    tags: Tuple[bytes, ...] = ()
    # transaction-repair contract (server/repair.py): the client
    # declares a covered read-set and value-independent writes, so a
    # conflicted commit may be repaired server-side — the invalidated
    # reads re-read at the conflict version and the commit revalidated
    # — instead of aborting. repair_attempt counts server-side
    # resubmissions (bounded by REPAIR_MAX_ATTEMPTS; also tells the
    # admission scheduler a resubmission already waited its turn)
    repairable: bool = False
    repair_attempt: int = 0


class CommitReply(NamedTuple):
    version: int       # the commit version
    batch_index: int   # transaction's index within the commit batch
                       # (second half of the versionstamp)


class CommitConflictReply(NamedTuple):
    """Reply to a CONFLICTED transaction that asked for
    report_conflicting_keys: the proxy answers with the attributed key
    ranges instead of a bare not_committed error, and the client raises
    not_committed itself after recording them (ref: the conflicting-keys
    special keyspace \\xff\\xff/transaction/conflicting_keys/ the
    reference exposes after a reported conflict)."""

    conflicting_ranges: Tuple[Range, ...]


class MetadataMutations(NamedTuple):
    """Committed mutations under the management system keys
    (\\xff/conf/, \\xff/excluded/), forwarded one-way by the proxy to
    the CC after the log push — the proxy-side applyMetadataMutation
    analogue (ref: fdbserver/ApplyMetadataMutation.h interpreting
    system-key mutations during commit)."""

    version: int
    mutations: tuple   # MutationRefs touching management keys


PRIORITY_BATCH = 0
PRIORITY_DEFAULT = 1
PRIORITY_IMMEDIATE = 2


class GetReadVersionRequest(NamedTuple):
    """(ref: GetReadVersionRequest — carries the number of transactions
    the (client-batched) request admits, so the ratekeeper debit is
    per-transaction, not per-RPC, and the priority class:
    BATCH is throttled first, IMMEDIATE bypasses the rate gate —
    TransactionPriority in fdbclient/FDBTypes.h)"""

    transaction_count: int = 1
    priority: int = PRIORITY_DEFAULT
    # transaction tags for the proxy's per-tag admission gate (ref: the
    # TagSet riding GetReadVersionRequest once tag throttling is on);
    # attached only while TAG_THROTTLING is armed — the request is
    # byte-identical to the pre-subsystem one otherwise
    tags: Tuple[bytes, ...] = ()


class GetReadVersionReply(NamedTuple):
    version: int
    # hot-key conflict windows piggybacked for the client-side early
    # abort (server/scheduler.py ConflictWindowCache): rows of
    # (begin, end, last_conflict_version), shipped only while
    # CLIENT_CONFLICT_WINDOWS is armed — the reply is byte-identical
    # to the pre-subsystem one otherwise
    conflict_windows: Tuple = ()
    # tag-throttle info for the requesting transaction's tags (ref:
    # GetReadVersionReply.tagThrottleInfo): rows of (tag, tps, expiry)
    # the client honors by delaying locally before its next GRV
    # (server/tag_throttler.py ClientTagThrottleCache). Shipped only
    # while TAG_THROTTLING is armed — defaulted empty otherwise, so
    # the reply stays byte-identical
    tag_throttles: Tuple = ()


class ResolveRequest(NamedTuple):
    """Ordered batch for a resolver (ref: ResolveTransactionBatchRequest,
    fdbserver/ResolverInterface.h)."""

    prev_version: int
    version: int
    transactions: Tuple[CommitRequest, ...]
    debug_ids: Tuple[int, ...] = ()


class ResolveReply(NamedTuple):
    """Resolver reply when the batch carried a report_conflicting_keys
    request: verdicts plus, per transaction, the read conflict ranges
    attributed as the conflict's cause (empty for committed/tooOld).
    Batches with no reporting request reply a bare verdict list — the
    common path stays a flat array (ref: ResolveTransactionBatchReply
    growing conflictingKeyRangeMap for this feature)."""

    verdicts: Tuple[int, ...]
    conflicting_ranges: Tuple[Tuple[Range, ...], ...]


class StorageGetRequest(NamedTuple):
    key: bytes
    version: int
    # sampled-read stitching token (ref: the debugID on GetValueRequest
    # driving the GetValueDebug trace-batch stations)
    debug_id: Optional[int] = None
    # transaction tags for the storage server's read-cost accounting
    # (ref: the TagSet on GetValueRequest feeding the per-SS
    # TransactionTagCounter); attached only while STORAGE_HEAT_TRACKING
    # is armed — the request is byte-identical to the pre-plane one
    # otherwise
    tags: Tuple[bytes, ...] = ()


class StorageGetRangeRequest(NamedTuple):
    begin: bytes
    end: bytes
    version: int
    limit: int
    reverse: bool = False
    # read-cost tags, same contract as StorageGetRequest.tags
    tags: Tuple[bytes, ...] = ()


class StorageGetKeyRequest(NamedTuple):
    selector: "KeySelector"
    version: int


class StorageWatchRequest(NamedTuple):
    """Fire when the key's value differs from its value at `version`
    (ref: storageserver watches / fdbclient watch semantics)."""

    key: bytes
    version: int


class TaggedMutation(NamedTuple):
    """A mutation routed to the storage tags that own its keys (ref:
    fdbserver/LogSystem.h LogPushData tag routing — each mutation is
    tagged per destination storage server; clears spanning shards carry
    several tags)."""

    tags: Tuple[int, ...]
    mutation: MutationRef


class TLogCommitRequest(NamedTuple):
    """(ref: TLogCommitRequest, fdbserver/TLogInterface.h — versioned
    tagged mutation payload; known_committed is the highest version the
    proxy knows is replicated on the whole log set, bounding what
    storage may safely make durable.)"""

    prev_version: int
    version: int
    mutations: Tuple[TaggedMutation, ...]
    known_committed: int = 0
    # sampled txns in the batch (ref: the debugID on TLogCommitRequest
    # driving the TLog commit-debug stations)
    debug_ids: Tuple[int, ...] = ()


class TLogPeekRequest(NamedTuple):
    """(ref: TLogPeekRequest :1138 — per-tag long poll). with_tags
    returns TaggedMutations (original tag vectors preserved) instead of
    bare mutations — the region log router needs the full vocabulary to
    re-partition the stream across the remote DC's storage tags (ref:
    LogRouter shipping per-tag streams to the remote log set)."""

    begin_version: int
    tag: int = 0
    with_tags: bool = False


class TLogPopRequest(NamedTuple):
    """Discard this tag's log entries at or below version (ref:
    TLogPopRequest, fdbserver/TLogInterface.h — sent by each replica
    once durable; the tag's effective pop is the MIN across its
    replicas so a lagging replica never loses unpulled data)."""

    version: int
    tag: int = 0
    replica: str = ""


class TLogPeekReply(NamedTuple):
    entries: Tuple[Tuple[int, Tuple[MutationRef, ...]], ...]
    committed_version: int
    known_committed: int = 0


class TLogLockRequest(NamedTuple):
    """Stop the log and report how far it got (ref: TLogLockResult /
    epochEnd locking, TagPartitionedLogSystem.actor.cpp:1265 — a locked
    tlog accepts no further commits but keeps serving peeks so storage
    servers can finish pulling the old generation)."""


class ResolutionMetricsReply(NamedTuple):
    """(ref: ResolutionMetricsRequest — cumulative work + key-space
    sample so the master can pick split points)"""

    work_units: int
    key_hist: Tuple[int, ...]   # 256 first-byte buckets


# -- resolver split/merge handoff ---------------------------------------
# The balance loop's state-handoff RPCs: checkpoint-and-clip on the
# donor, graft-install on the recipient (models/conflict_set.py
# clip_checkpoint / graft_checkpoint). Both are served by the resolver
# role's `splits` endpoint.


class ResolverCheckpointRequest(NamedTuple):
    """Donor side: checkpoint the conflict-set state and return the
    [begin, end) slice as a ConflictRangePiece. `min_version` gates the
    checkpoint on the resolver's version chain — the donor first
    resolves every batch below the move's effective version, so the
    piece provably covers all pre-move writes in the span."""

    begin: bytes
    end: Optional[bytes]     # None = keyspace tail
    min_version: int = 0


class ResolverCheckpointReply(NamedTuple):
    piece: tuple             # ConflictRangePiece (wire-registered)
    version: int             # donor's version when the piece was cut


class ResolverInstallRequest(NamedTuple):
    """Recipient side: graft the piece into the live conflict-set state
    (pointwise max over the span — exact whatever post-move writes the
    recipient already recorded). Replies the recipient's version."""

    begin: bytes
    end: Optional[bytes]
    piece: tuple             # ConflictRangePiece


class TLogLockReply(NamedTuple):
    end_version: int        # highest durable version in this log
    known_committed: int    # highest version known replicated log-set-wide


class QosSample(NamedTuple):
    """One role's saturation-signal snapshot for the QoS telemetry
    plane (ref: the StorageQueuingMetricsReply / TLogQueuingMetricsReply
    the reference Ratekeeper polls — smoothed queue bytes, durability
    lag, input rates). `signals` maps signal name -> smoothed value;
    the signal inventory per role kind is pinned by
    tests/test_qos_telemetry.py and documented in README's QoS
    telemetry section."""

    kind: str          # storage | tlog | proxy | resolver
    name: str          # role instance name
    sampled_at: float  # sim time of this sample
    signals: dict      # signal name -> value (floats/ints)

# -- typed bare-payload envelopes ---------------------------------------
# Every request that used to ship a bare ``None`` payload (ratekeeper
# rate polls, failure-monitor pings, raw-committed/durable-frontier
# probes, resolution-metrics polls, status fetches) gets a field-less
# typed envelope instead: the sim network's per-type message accounting
# then attributes them (no more anonymous `NoneType` rows — enforced by
# an armed-mode assert in SimNetwork._count_msg), and the wire layer
# serves field-less messages from a per-type round-trip cache, so the
# typed envelope is CHEAPER than the None it replaces. Send the module
# singletons below; receivers that dispatch match on the type.


class GetRateRequest(NamedTuple):
    """Proxy -> ratekeeper GetRateInfo poll (ref: GetRateInfoRequest)."""


class PingRequest(NamedTuple):
    """CC failure monitor -> worker liveness ping."""


class RawCommittedRequest(NamedTuple):
    """Proxy -> peer proxy raw committed-version probe (GRV causal
    confirmation, ref: getLiveCommittedVersion)."""


class DurableFrontierRequest(NamedTuple):
    """Proxy -> TLog durable-frontier probe (degraded-GRV fallback)."""


class ResolutionMetricsRequest(NamedTuple):
    """Master -> resolver work/key-histogram poll (ref:
    ResolutionMetricsRequest)."""


class StatusRequest(NamedTuple):
    """Client -> CC status-document fetch (ref: StatusRequest)."""


# -- storage heat plane -------------------------------------------------
# Field-less probes served by the storage role's metrics endpoint —
# module singletons per the envelope convention above (typed, so the
# sim network's message accounting attributes them and the wire layer
# round-trip cache applies).


class StorageMetricsRequest(NamedTuple):
    """-> StorageMetricsReply: the shard's sampled bytes + smoothed
    read/write bandwidth + busiest read tag (ref: GetStorageMetrics /
    StorageQueuingMetrics read-side fields)."""


class ReadHotRangesRequest(NamedTuple):
    """-> ReadHotRangesReply: read-hot sub-ranges of the owned shard
    (ref: ReadHotSubRangeRequest density math)."""


class SplitMetricsRequest(NamedTuple):
    """-> SplitMetricsReply: the byte-balanced interior split key
    (ref: SplitMetricsRequest / splitMetrics)."""


class StorageMetricsReply(NamedTuple):
    sampled_bytes: int
    write_bytes_per_sec: float
    read_bytes_per_sec: float
    read_ops_per_sec: float
    busiest_read_tag: Optional[bytes]
    busiest_read_tag_rate: float


class ReadHotRangesReply(NamedTuple):
    """Rows of (begin, end, density_ratio, read_bytes_per_sec) — the
    sub-ranges whose read-bandwidth ÷ sampled-byte density exceeds
    READ_HOT_RANGE_RATIO × the shard's own density."""

    ranges: Tuple = ()


class SplitMetricsReply(NamedTuple):
    split_key: Optional[bytes]


GET_RATE_REQUEST = GetRateRequest()
STORAGE_METRICS_REQUEST = StorageMetricsRequest()
READ_HOT_RANGES_REQUEST = ReadHotRangesRequest()
SPLIT_METRICS_REQUEST = SplitMetricsRequest()
PING_REQUEST = PingRequest()
RAW_COMMITTED_REQUEST = RawCommittedRequest()
DURABLE_FRONTIER_REQUEST = DurableFrontierRequest()
RESOLUTION_METRICS_REQUEST = ResolutionMetricsRequest()
STATUS_REQUEST = StatusRequest()

from ..rpc import wire as _wire

_wire.register_module(__name__)  # all NamedTuples here are RPC vocabulary
