"""The cluster file: `description:id@host:port[,host:port]...`

Ref: fdbclient/MonitorLeader.actor.cpp:185 (connection-string parsing
tests) and the fdb.cluster conventions (documentation/): a cluster is
named by `description:id` (description is operator-chosen, id changes
when the coordinator set changes) followed by the coordinator
addresses. Here the addresses name the cluster's TCP gateway(s) — the
seam an out-of-process client actually dials — and tools accept
`--cluster-file` (or the FDB_TPU_CLUSTER_FILE environment variable)
anywhere they accept `--connect host:port`.
"""

from __future__ import annotations

import os
import re
from typing import List, NamedTuple, Tuple

_KEY_RE = re.compile(r"^[A-Za-z0-9_]+$")


class ClusterConnectionString(NamedTuple):
    description: str
    cluster_id: str
    addresses: Tuple[Tuple[str, int], ...]

    def __str__(self) -> str:
        hosts = ",".join(f"{h}:{p}" for h, p in self.addresses)
        return f"{self.description}:{self.cluster_id}@{hosts}"


def parse_connection_string(s: str) -> ClusterConnectionString:
    """Parse `description:id@host:port,...` (whitespace/comment
    tolerant the way the reference's parser is)."""
    # strip comments and whitespace: the reference accepts a file with
    # leading '#' comment lines and surrounding blanks
    lines = [ln.strip() for ln in s.splitlines()]
    lines = [ln for ln in lines if ln and not ln.startswith("#")]
    if len(lines) != 1:
        raise ValueError(
            f"cluster file must hold exactly one connection string, "
            f"got {len(lines)} lines")
    body = lines[0]
    if "@" not in body:
        raise ValueError("missing '@' in connection string")
    name, hosts = body.split("@", 1)
    if ":" not in name:
        raise ValueError("missing ':' between description and id")
    desc, cid = name.split(":", 1)
    if not _KEY_RE.match(desc) or not _KEY_RE.match(cid):
        raise ValueError(
            f"description/id must be alphanumeric: {name!r}")
    addrs: List[Tuple[str, int]] = []
    for part in hosts.split(","):
        addrs.append(parse_address(part.strip()))
    return ClusterConnectionString(desc, cid, tuple(addrs))


def parse_address(part: str) -> Tuple[str, int]:
    """`host:port` with the port validated to the TCP range."""
    host, _, port = part.rpartition(":")
    if not host or not port.isdigit() or not 0 < int(port) < 65536:
        raise ValueError(f"bad address {part!r} (expected host:port)")
    return host, int(port)


def read_cluster_file(path: str) -> ClusterConnectionString:
    with open(path, "r") as f:
        return parse_connection_string(f.read())


def write_cluster_file(path: str, conn: ClusterConnectionString) -> None:
    """Atomic replace, like the reference rewriting fdb.cluster after a
    coordinators change."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(conn) + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def resolve_connect(connect: str | None,
                    cluster_file: str | None) -> Tuple[str, int] | None:
    """The address tools dial: an explicit --connect host:port wins;
    otherwise the first address of --cluster-file or
    $FDB_TPU_CLUSTER_FILE; None means local/in-sim mode."""
    if connect is not None:
        return parse_address(connect)
    path = cluster_file or os.environ.get("FDB_TPU_CLUSTER_FILE")
    if path:
        conn = read_cluster_file(path)
        return conn.addresses[0]
    return None
