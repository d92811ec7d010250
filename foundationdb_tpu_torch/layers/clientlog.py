"""Client-log janitor: retention trimming for the sampled-transaction
profiling keyspace.

Reference: the ClientTransactionProfileCorrectness workload's cleanup
of \\xff\\x02/fdbClientInfo/client_latency/ and the TaskBucket-style
periodic maintenance agents (fdbclient/TaskBucket.actor.cpp): profile
records are ordinary replicated rows, so without a trimmer a 100%
sample rate grows the system keyspace without bound. The janitor is a
cluster-side actor (like the BackupDriver) that periodically deletes
every record older than PROFILE_RETENTION_SECONDS.

Record keys are ordered by start timestamp (server/systemkeys.py), so
the trim is one bounded scan (to COUNT what dies — the analyzer's
`records_trimmed` signal) followed by a single clear_range.
"""

from __future__ import annotations

from .. import flow
from ..flow import TaskPriority
from ..server.systemkeys import (CLIENT_LATENCY_PREFIX,
                                 CLIENT_LATENCY_VERSION,
                                 client_latency_cutoff_key,
                                 parse_client_latency_key)


async def trim_client_log(db, cutoff_ts: float, max_retries: int = 100,
                          scan_limit: int = 10_000) -> int:
    """Delete every profile record that STARTED before `cutoff_ts`
    (sim seconds); returns how many distinct records died. The count
    comes from scanning the doomed prefix (bounded — a pathological
    backlog still trims, it just under-counts), the deletion from one
    clear_range over the same bound."""
    cutoff = client_latency_cutoff_key(int(cutoff_ts * 1e6),
                                       CLIENT_LATENCY_VERSION)

    async def body(tr):
        tr.set_option("access_system_keys")
        rows = await tr.get_range(CLIENT_LATENCY_PREFIX, cutoff,
                                  limit=scan_limit)
        seen = set()
        for k, _v in rows:
            parsed = parse_client_latency_key(k)
            if parsed is not None:
                seen.add((parsed[1], parsed[2]))   # (start_ts, rec_id)
        if rows:
            tr.clear_range(CLIENT_LATENCY_PREFIX, cutoff)
        return len(seen)

    from ..client import profiling
    trimmed = await profiling.run_unsampled(db, body,
                                            max_retries=max_retries)
    if trimmed:
        profiling.note_trimmed(trimmed)
        flow.TraceEvent("ClientLogTrimmed").detail(
            Records=trimmed, CutoffTs=cutoff_ts).log()
    return trimmed


class ClientLogJanitor:
    """One janitor per cluster (ref: the BackupDriver lifecycle): wakes
    every PROFILE_JANITOR_INTERVAL and trims the profiling keyspace to
    the PROFILE_RETENTION_SECONDS window."""

    def __init__(self, cluster, retention: float = None,
                 interval: float = None):
        self.cluster = cluster
        self.db = cluster.client("clientlog-janitor")
        self.retention = retention
        self.interval = interval
        self.records_trimmed = 0
        self.rounds = 0
        self._task = None

    def start(self) -> None:
        self._task = flow.spawn(self._run(), TaskPriority.LOW_PRIORITY,
                                name="clientLogJanitor")

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _run(self) -> None:
        while True:
            await flow.delay(
                self.interval if self.interval is not None
                else flow.SERVER_KNOBS.profile_janitor_interval,
                TaskPriority.LOW_PRIORITY)
            retention = (self.retention if self.retention is not None
                         else flow.SERVER_KNOBS.profile_retention_seconds)
            try:
                self.records_trimmed += await trim_client_log(
                    self.db, flow.now() - retention)
                self.rounds += 1
            except flow.FdbError as e:
                if e.name == "operation_cancelled":
                    raise
                # a trim round losing to a recovery just waits for the
                # next interval — retention is best-effort maintenance
