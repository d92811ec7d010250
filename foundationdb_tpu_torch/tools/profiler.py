"""Transaction-profiling analyzer: read the sampled ClientLogEvent
records back out of the database and report where the time went.

Reference: contrib/transaction_profiling_analyzer.py — the tool that
scans \\xff\\x02/fdbClientInfo/client_latency/, reassembles each
record's chunk run, decodes the client's event stream, and prints the
top offenders. Same shape here: `scan_records` pages the keyspace with
ordinary range reads (chunked records reassemble across page
boundaries; a record missing chunks is SKIPPED and counted, never a
crash), `analyze` folds the event streams into top-N slowest
transactions, per-operation latency histograms, and the hottest
read/written keys, and `format_report` renders the operator view the
cli's `profile analyze` prints.
"""

from __future__ import annotations

import sys
from typing import List, NamedTuple, Optional, Tuple

from ..client.profiling import (CommitEvent, ErrorEvent, GetEvent,
                                GetRangeEvent, GetVersionEvent,
                                decode_events)
from ..flow.latency import LatencyBands
from ..rpc.wire import WireError
from ..server.systemkeys import (CLIENT_LATENCY_END,
                                 CLIENT_LATENCY_PREFIX,
                                 CLIENT_LATENCY_VERSION,
                                 parse_client_latency_key)

SCAN_PAGE_ROWS = 512


class TxnRecord(NamedTuple):
    """One reassembled profile record."""
    start_ts: float           # seconds (sim clock)
    rec_id: str
    events: Tuple[tuple, ...]


def _finish_group(records: List[TxnRecord], stats: dict, meta,
                  chunks: dict) -> None:
    """Close out one (start_ts, rec_id) chunk run: reassemble when
    complete, otherwise count the skip."""
    if meta is None:
        return
    start_us, rec_id, num = meta
    if len(chunks) != num or set(chunks) != set(range(1, num + 1)):
        stats["skipped_missing_chunks"] += 1
        return
    blob = b"".join(chunks[i] for i in range(1, num + 1))
    try:
        events = decode_events(blob)
    except (WireError, IndexError, ValueError):
        stats["skipped_undecodable"] += 1
        return
    records.append(TxnRecord(start_us / 1e6, rec_id, events))


async def scan_records(tr, limit_rows: int = 200_000,
                       page_rows: int = SCAN_PAGE_ROWS):
    """-> (records, stats) from one transaction's view of the profiling
    keyspace. `tr` must already be readable for system keys (the
    callers set read_system_keys). Chunk runs are contiguous by key
    order, so reassembly is a single pass with carry across pages — a
    record whose chunks straddle a page boundary reassembles exactly
    like one that doesn't (`page_rows` is a parameter so the tests can
    force the straddle)."""
    stats = {"chunks_seen": 0, "records": 0,
             "skipped_missing_chunks": 0, "skipped_undecodable": 0,
             "skipped_foreign_version": 0}
    records: List[TxnRecord] = []
    meta = None          # (start_us, rec_id, num_chunks) of the open run
    chunks: dict = {}
    begin = CLIENT_LATENCY_PREFIX
    scanned = 0
    while scanned < limit_rows:
        page = await tr.get_range(begin, CLIENT_LATENCY_END,
                                  limit=page_rows, snapshot=True)
        for k, v in page:
            scanned += 1
            parsed = parse_client_latency_key(k)
            if parsed is None:
                continue
            version, start_us, rec_id, chunk, num = parsed
            if version != CLIENT_LATENCY_VERSION:
                stats["skipped_foreign_version"] += 1
                continue
            stats["chunks_seen"] += 1
            if meta != (start_us, rec_id, num):
                _finish_group(records, stats, meta, chunks)
                meta, chunks = (start_us, rec_id, num), {}
            chunks[chunk] = v
        if len(page) < page_rows:
            break
        begin = page[-1][0] + b"\x00"
    _finish_group(records, stats, meta, chunks)
    stats["records"] = len(records)
    return records, stats


# -- analysis ------------------------------------------------------------

_OP_NAMES = {GetVersionEvent: "grv", GetEvent: "get",
             GetRangeEvent: "get_range", CommitEvent: "commit"}


def _txn_latency(rec: TxnRecord) -> float:
    """A transaction's cost: the sum of its operation latencies (the
    events carry per-op latency, not wall extent — retries interleave
    with user code the client can't see)."""
    return sum(getattr(e, "latency", 0.0) for e in rec.events)


def analyze(records: List[TxnRecord], top_n: int = 10) -> dict:
    """Fold decoded records into the operator report: outcome counts,
    top-N slowest transactions, per-op latency histograms, and the
    hottest read/written keys."""
    per_op = {name: LatencyBands(name) for name in _OP_NAMES.values()}
    read_keys: dict = {}
    written_keys: dict = {}
    committed = conflicted = errored = 0
    scored = []
    for rec in records:
        verdicts = [e.verdict for e in rec.events
                    if isinstance(e, CommitEvent)]
        if "conflicted" in verdicts:
            conflicted += 1
        if "committed" in verdicts:
            committed += 1
        if any(isinstance(e, ErrorEvent) for e in rec.events):
            errored += 1
        scored.append((_txn_latency(rec), rec))
        for e in rec.events:
            op = _OP_NAMES.get(type(e))
            if op is not None:
                per_op[op].record(e.latency)
            if isinstance(e, GetEvent):
                read_keys[e.key] = read_keys.get(e.key, 0) + 1
            elif isinstance(e, GetRangeEvent):
                read_keys[e.begin] = read_keys.get(e.begin, 0) + 1
            elif isinstance(e, CommitEvent):
                for b, _e2 in e.write_ranges:
                    written_keys[b] = written_keys.get(b, 0) + 1
    scored.sort(key=lambda p: (-p[0], p[1].rec_id))

    def _top(d: dict) -> list:
        return sorted(d.items(), key=lambda kv: (-kv[1], kv[0]))[:top_n]

    return {
        "records": len(records),
        "committed": committed,
        "conflicted": conflicted,
        "errored": errored,
        "slowest": [{
            "rec_id": rec.rec_id, "start_ts": round(rec.start_ts, 6),
            "latency": round(score, 6), "events": len(rec.events),
            "verdict": next((e.verdict for e in rec.events
                             if isinstance(e, CommitEvent)), "none"),
        } for score, rec in scored[:top_n]],
        "per_op": {name: bands.snapshot()
                   for name, bands in per_op.items() if bands.total},
        "hottest_keys": [{"key": k.hex(), "reads": n}
                         for k, n in _top(read_keys)],
        "hottest_written": [{"key": k.hex(), "writes": n}
                            for k, n in _top(written_keys)],
    }


def format_report(analysis: dict, stats: Optional[dict] = None) -> str:
    lines = [f"Transaction profile: {analysis['records']} records "
             f"({analysis['committed']} committed, "
             f"{analysis['conflicted']} conflicted, "
             f"{analysis['errored']} errored)"]
    if stats:
        lines.append(
            f"  chunks={stats['chunks_seen']} "
            f"skipped_missing={stats['skipped_missing_chunks']} "
            f"skipped_undecodable={stats['skipped_undecodable']}")
    if analysis["slowest"]:
        lines.append("Slowest transactions:")
        for row in analysis["slowest"]:
            lines.append(
                f"  {row['latency']:<10g} {row['verdict']:<10} "
                f"events={row['events']:<4} id={row['rec_id']}")
    if analysis["per_op"]:
        lines.append("Per-op latency:")
        for op, snap in sorted(analysis["per_op"].items()):
            lines.append(
                f"  {op:<10} n={snap['total']:<6} "
                f"sum={snap['sum_seconds']:<10g} "
                f"max={snap['max_seconds']:<10g}")
    if analysis["hottest_keys"]:
        lines.append("Hottest read keys:")
        for row in analysis["hottest_keys"]:
            lines.append(f"  {row['reads']:>6}x  {row['key']}")
    if analysis["hottest_written"]:
        lines.append("Hottest written keys:")
        for row in analysis["hottest_written"]:
            lines.append(f"  {row['writes']:>6}x  {row['key']}")
    return "\n".join(lines)


async def profile_analysis(db, top_n: int = 10):
    """One-shot scan + analyze over a Database handle -> (analysis,
    stats). The scan runs in a read-only, UNSAMPLED system-keys
    transaction — the analyzer must not profile its own scan."""
    from ..client.profiling import run_unsampled

    async def body(tr):
        tr.set_option("read_system_keys")
        return await scan_records(tr)

    records, stats = await run_unsampled(db, body)
    return analyze(records, top_n=top_n), stats


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    connect = None
    top_n = 10
    while argv:
        a = argv.pop(0)
        if a == "--connect":
            connect = argv.pop(0)
        elif a == "--top":
            top_n = int(argv.pop(0))
    if connect is None:
        print("usage: profiler --connect host:port [--top N]",
              file=sys.stderr)
        return 2
    from ..client.remote import RemoteCluster
    host, _, port = connect.partition(":")
    remote = RemoteCluster(host or "127.0.0.1", int(port))
    try:
        analysis, stats = remote.call(
            profile_analysis(remote.db, top_n=top_n))
        print(format_report(analysis, stats))
        return 0
    finally:
        remote.close()


if __name__ == "__main__":
    sys.exit(main())
