"""MultiVersion client: select the protocol-versioned C library that
matches the cluster.

Reference: fdbclient/MultiVersionTransaction.h:351 (MultiVersionApi) —
the reference ships every release's libfdb_c side by side; the
multi-version layer dlopens them all, discovers the cluster's protocol
version, and routes the application's API calls through the matching
client, so an application built before a cluster upgrade keeps working
after it. Here the same shape over this framework's wire protocol:

- every connection starts with an 8-byte protocol tag
  (rpc/tcp.py PROTOCOL_VERSION); a server answers a recognizable but
  mismatched tag with ITS OWN tag before closing (the
  getServerProtocol analogue), so discovery needs no compatible
  library at all;
- versioned copies of the C library are built with
  `c_client.build_library(protocol="fdbtpuNN")` (the Makefile's
  `versioned` target), each exporting fdb_tpu_get_protocol();
- MultiVersionClient dlopens every copy it is given, probes the
  cluster, and hands out CDatabase handles backed by the matching
  library.
"""

from __future__ import annotations

import socket
from typing import Dict, Optional

from ..rpc.tcp import _read_exact
from .c_client import CDatabase, load_library_at

#: a tag with the right magic but a version no release ever shipped:
#: every server mismatches it and answers with its own tag
PROBE_TAG = b"fdbtpu??"


def probe_cluster_protocol(host: str, port: int,
                           timeout: float = 10.0) -> Optional[bytes]:
    """Discover the cluster's wire-protocol tag (ref:
    getServerProtocol): send a never-matching probe tag; the server
    replies with its own tag and closes. Returns None when the peer
    gives nothing back (pre-versioning server or not our protocol)."""
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.sendall(PROBE_TAG)
        s.settimeout(timeout)
        got = _read_exact(s, len(PROBE_TAG))
    return got


class MultiVersionClient:
    """Holds protocol-versioned C libraries and opens databases through
    whichever one speaks the cluster's protocol (ref: MultiVersionApi
    + MultiVersionDatabase routing to the matching external client)."""

    def __init__(self, library_paths):
        """`library_paths`: iterable of .so paths (each a versioned
        build of bindings/c). Tags are read from the libraries
        themselves via fdb_tpu_get_protocol()."""
        self.libs: Dict[bytes, object] = {}
        #: (path, reason) for libraries that could not be versioned —
        #: a pre-versioning build has no discoverable protocol, so it
        #: can never be route target; keep the evidence for errors
        self.skipped: list = []
        for path in library_paths:
            lib = load_library_at(path)
            try:
                tag = lib.fdb_tpu_get_protocol()
            except AttributeError:
                self.skipped.append(
                    (path, "predates protocol versioning "
                           "(no fdb_tpu_get_protocol export)"))
                continue
            self.libs[tag] = lib

    def protocols(self):
        return sorted(self.libs)

    def open(self, host: str, port: int) -> CDatabase:
        """Probe the cluster, select the matching library, connect.
        Raises RuntimeError when no loaded library speaks the
        cluster's protocol (the reference surfaces the same as an
        incompatible-client error)."""
        tag = probe_cluster_protocol(host, port)
        if tag is None:
            raise RuntimeError(
                "cluster protocol undiscoverable (peer answered the "
                "probe with nothing)")
        lib = self.libs.get(tag)
        if lib is None:
            extra = "".join(f"; skipped {p} ({why})"
                            for p, why in self.skipped)
            raise RuntimeError(
                f"no client library for cluster protocol {tag!r}; "
                f"loaded: {self.protocols()}{extra}")
        return CDatabase(host, port, lib=lib)
