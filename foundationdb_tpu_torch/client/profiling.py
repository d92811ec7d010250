"""Sampled transaction profiling: typed ClientLogEvents persisted into
the database itself.

Reference: fdbclient/ClientLogEvents.h (the GetVersion / Get / GetRange
/ Commit / error event vocabulary) + NativeAPI's transaction sampling
(`TRANSACTION_LOGGING_ENABLE` per transaction, the CSI_SAMPLING
database knob) and the \\xff\\x02/fdbClientInfo/client_latency/
keyspace the contrib transaction_profiling_analyzer consumes. The
client records one event per operation on a SAMPLED transaction, wire-
serializes the stream, and writes it back into the cluster in
size-limited chunks so the profile data rides the same replication,
backup, and retention machinery as user data.

Sampling is deterministic: the decision hashes a per-database
transaction sequence number with a salt derived from the seeded RNG,
so the same seed samples the same transactions — reruns reproduce the
profile byte for byte. With PROFILE_SAMPLE_RATE at 0 and no per-txn
option, `Database._maybe_sample` is never called and transactions
carry `_profile = None`: the hot paths pay one attribute test, no
event allocation, no extra keyspace traffic.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

from .. import flow
from ..flow.stats import CounterCollection
from ..rpc import wire
from ..server.systemkeys import (CLIENT_LATENCY_VERSION,
                                 client_latency_key)

# -- event vocabulary (ref: ClientLogEvents.h EventType) ----------------
# Every event is a wire-registered NamedTuple: the record blob is the
# wire encoding of the tuple of events, so the round-trip property
# (client emits == analyzer reads) is the serializer's own contract.


class GetVersionEvent(NamedTuple):
    """GRV latency (ref: EventGetVersion)."""
    time: float
    latency: float
    priority: int


class GetEvent(NamedTuple):
    """Point-read latency + key (ref: EventGet)."""
    time: float
    latency: float
    key: bytes
    value_size: int       # -1 = key absent


class GetRangeEvent(NamedTuple):
    """Range-read latency + bounds (ref: EventGetRange)."""
    time: float
    latency: float
    begin: bytes
    end: bytes
    rows: int


class CommitEvent(NamedTuple):
    """Commit outcome: latency, payload size, the write-conflict
    ranges (what the analyzer folds into hottest-written keys — the
    reference's EventCommit ships the whole CommitTransactionRequest),
    and the conflict verdict (reusing the resolver's attribution:
    conflicting_ranges carries the attributed causes when the client
    asked for them)."""
    time: float
    latency: float
    mutation_count: int
    mutation_bytes: int
    write_ranges: Tuple[Tuple[bytes, bytes], ...]
    verdict: str          # "committed" | "conflicted"
    version: int          # commit version (0 when conflicted)
    conflicting_ranges: Tuple[Tuple[bytes, bytes], ...]


class ErrorEvent(NamedTuple):
    """A failed operation (ref: EventGetError / EventCommitError)."""
    time: float
    op: str               # "grv" | "get" | "get_range" | "commit"
    error_name: str


wire.register_module(__name__)

# process-wide sampler counters (surfaced through status + the
# exporter, like the jitted-kernel profile): how much the sampler is
# doing is itself an observability signal
g_profile_counters = CounterCollection("client_profiler")
_c_sampled = g_profile_counters.counter("transactions_sampled")
_c_events = g_profile_counters.counter("events_recorded")
_c_chunks = g_profile_counters.counter("chunks_written")
_c_records = g_profile_counters.counter("records_written")
_c_flush_failed = g_profile_counters.counter("flushes_failed")
_c_trimmed = g_profile_counters.counter("records_trimmed")


def _mix64(x: int) -> int:
    """splitmix64 finalizer — a stable integer hash (python's hash() is
    identity on small ints, useless for rate thresholding)."""
    x &= (1 << 64) - 1
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return x ^ (x >> 31)


def sample_decision(salt: int, seq: int, rate: float) -> bool:
    """Deterministic hash-based sampling: the (salt, seq) hash lands
    uniformly in [0, 2^64); sample when it falls under rate. The same
    seed therefore samples the same transactions on every run."""
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    return _mix64(salt ^ _mix64(seq)) < int(rate * (1 << 64))


class TransactionProfile:
    """One sampled transaction's accumulating event stream. Events
    survive retries (each attempt's operations append — the retried
    attempt is usually the interesting one), and each commit outcome
    drains the buffer into one chunked record."""

    __slots__ = ("rec_id", "start_ts", "events", "flushes")

    def __init__(self, rec_id: str, start_ts: float):
        self.rec_id = rec_id
        self.start_ts = start_ts
        self.events: List[tuple] = []
        self.flushes = 0

    def add(self, event: tuple) -> None:
        self.events.append(event)
        _c_events.add(1)


# -- record encoding -----------------------------------------------------

def encode_events(events) -> bytes:
    """The record blob: wire encoding of the event tuple."""
    return wire.to_bytes(tuple(events))


def decode_events(blob: bytes) -> Tuple[tuple, ...]:
    """Inverse of encode_events (bit-identical round trip)."""
    return wire.from_bytes(blob, None)


def split_chunks(blob: bytes, chunk_bytes: Optional[int] = None) -> List[bytes]:
    """Size-limited chunks (ref: the analyzer's chunk-number/num-chunks
    suffix pair — values stay under the value size limit no matter how
    chatty the transaction was)."""
    if chunk_bytes is None:
        chunk_bytes = int(flow.SERVER_KNOBS.profile_chunk_bytes)
    chunk_bytes = max(1, chunk_bytes)
    return [blob[i:i + chunk_bytes]
            for i in range(0, len(blob), chunk_bytes)] or [b""]


def record_rows(profile: TransactionProfile, events,
                chunk_bytes: Optional[int] = None) -> List[Tuple[bytes, bytes]]:
    """The (key, value) rows for one drained event stream. The record
    id is suffixed with the flush ordinal so a retried transaction's
    successive outcomes never collide."""
    rec_id = f"{profile.rec_id}{profile.flushes:04x}"
    start_us = int(profile.start_ts * 1e6)
    chunks = split_chunks(encode_events(events), chunk_bytes)
    n = len(chunks)
    return [(client_latency_key(start_us, rec_id, i + 1, n,
                                CLIENT_LATENCY_VERSION), c)
            for i, c in enumerate(chunks)]


async def run_unsampled(db, body, max_retries: int = 100):
    """run_transaction over a transaction that is never itself sampled
    — the retry loop for every piece of profiling infrastructure (the
    flush writer, the janitor, the analyzer's scan): the profiler
    observing the workload must not observe itself."""
    from .transaction import Transaction, run_transaction
    return await run_transaction(db, body, max_retries=max_retries,
                                 tr=Transaction(db, sampled=False))


async def flush_profile(db, profile: TransactionProfile,
                        max_retries: int = 32) -> bool:
    """Drain the profile's events into one chunked record, committed
    through an UNSAMPLED system-keys transaction (a sampled flush would
    recurse). Returns False — and counts — when the write ultimately
    fails; profiling must never fail the workload."""
    if not profile.events:
        return True
    events, profile.events = profile.events, []
    rows = record_rows(profile, events)
    profile.flushes += 1

    async def body(tr):
        tr.set_option("access_system_keys")
        for k, v in rows:
            tr.set(k, v)

    try:
        await run_unsampled(db, body, max_retries=max_retries)
    except flow.FdbError:
        _c_flush_failed.add(1)
        return False
    _c_records.add(1)
    _c_chunks.add(len(rows))
    return True


def note_sampled() -> None:
    _c_sampled.add(1)


def note_trimmed(n: int) -> None:
    _c_trimmed.add(n)


def profiler_counters() -> dict:
    """Snapshot for status/exporter surfacing."""
    return g_profile_counters.snapshot()
