"""ServerDBInfo: the broadcast picture of the current transaction
subsystem.

Reference: fdbserver/ServerDBInfo.h — the ClusterController assembles a
struct naming the master, proxies, resolvers, log system and recovery
state, and broadcasts it to every worker; roles and clients act on
changes (new epochs re-point storage pull loops and client endpoints).
Here the broadcast seam is a flow AsyncVar owned by the
ClusterController — the simulated stand-in for the CC's push RPC; a
real transport would ship the same tuple as bytes.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

# recovery states (ref: fdbserver/RecoveryState.h)
UNINITIALIZED = "uninitialized"
READING_CSTATE = "reading_coordinated_state"
LOCKING_CSTATE = "locking_coordinated_state"
RECRUITING = "recruiting_transaction_servers"
ACCEPTING_COMMITS = "accepting_commits"
FULLY_RECOVERED = "fully_recovered"


class LogRefs(NamedTuple):
    """One TLog replica's endpoints (ref: TLogInterface.h)."""

    store: str            # durable store name, stable across reboots
    machine: str
    commits: object       # NetworkRef
    peeks: object
    pops: object
    locks: object


class LogSetInfo(NamedTuple):
    """One log generation (ref: LogSystemConfig / OldTLogConf)."""

    epoch: int
    begin_version: int    # first version this generation may contain
    end_version: int      # last version (locked gens; -1 = open)
    logs: Tuple[LogRefs, ...]
    # EVERY member store's (name, machine), including ones unreachable
    # when this picture was built — a store that reboots later rejoins
    # its generation by name (losing the name would orphan its records:
    # readers would skip the generation and silently lose data)
    stores: Tuple[Tuple[str, str], ...] = ()


class ProxyRefs(NamedTuple):
    """(ref: MasterProxyInterface.h)"""

    name: str
    grvs: object
    commits: object
    raw_committed: object = None   # getRawCommittedVersion (peer GRV)


class StorageRefs(NamedTuple):
    """One storage REPLICA's endpoints
    (ref: StorageServerInterface.h)."""

    name: str
    tag: int
    begin: bytes
    end: bytes            # None = +inf
    gets: object
    ranges: object
    get_keys: object
    watches: object


class StorageShard(NamedTuple):
    """A key-range shard: the team of replicas serving it (ref: the
    keyServers map entry — a range and its server team; every replica
    pulls the SAME tag, so the replicated stream keeps them identical
    and reads load-balance across them, fdbrpc/LoadBalance.actor.h)."""

    tag: int
    begin: bytes
    end: bytes            # None = +inf
    replicas: Tuple[StorageRefs, ...]


class ServerDBInfo(NamedTuple):
    epoch: int
    recovery_state: str
    recovery_version: int
    proxies: Tuple[ProxyRefs, ...]
    logs: LogSetInfo                      # current generation
    old_logs: Tuple[LogSetInfo, ...]      # locked gens still draining
    storages: Tuple[StorageShard, ...]    # shard map ordered by begin
    seq: int = 0                          # broadcast sequence number
    # process/role names the CC's failure monitor currently considers
    # down — PUSHED to clients through this broadcast so they stop
    # trying known-dead endpoints first (ref: FailureMonitor state
    # pushed from the cluster controller, fdbrpc/FailureMonitor.h:123 +
    # fdbclient/FailureMonitorClient.actor.cpp)
    failed: Tuple[str, ...] = ()
    # what this epoch was RECRUITED with: backup tagging / region
    # shipping on every proxy+TLog. Observers (backup agent, region
    # attach) wait on these rather than poking roles — a recovery that
    # raced past their flag change publishes the stale value here and
    # the level-triggered config-dirty recovery that follows publishes
    # the corrected one (ref: the log system configuration carried in
    # the LogSystemConfig the CC broadcasts)
    backup_active: bool = False
    region_attached: bool = False


EMPTY_DBINFO = ServerDBInfo(0, UNINITIALIZED, 0, (), LogSetInfo(0, 0, -1, ()),
                            (), (), 0)

from ..rpc import wire as _wire

_wire.register_module(__name__)  # all NamedTuples here are RPC vocabulary


def pick_log_source(info: "ServerDBInfo", needed: int, rr: int):
    """The generation-chasing cursor shared by every log tail (backup
    agent, region log router, storage pull): the oldest generation
    COVERING `needed` serves first, then the current one; `rr` rotates
    replicas on failure (ref: LogSystemPeekCursor merging old
    generations before the live set). Returns (generation, log refs)
    or None.

    Coverage is strict: a generation serves `needed` only if
    begin_version < needed <= end_version. Picking a LATER generation
    when the covering one is temporarily unreachable (e.g. its store's
    worker is mid-reboot) would let the reply's durable watermark
    advance the reader past records it never saw — silent data loss.
    The caller must wait and retry until the covering store
    re-registers."""
    gens = sorted(info.old_logs, key=lambda g: g.end_version)
    for gen in gens:
        if gen.begin_version < needed <= gen.end_version:
            if not gen.logs:
                return None   # covering gen unreachable: wait, never skip
            return gen, gen.logs[rr % len(gen.logs)]
    cur = info.logs
    if cur.logs and needed > cur.begin_version:
        return cur, cur.logs[rr % len(cur.logs)]
    return None
