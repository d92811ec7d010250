"""The reference's tests/test_multiversion.py on the port.

MultiVersion client: a client built against protocol N connects to
an N+1 cluster via the shim.

Ref: fdbclient/MultiVersionTransaction.h:351 — MultiVersionApi dlopens
versioned libfdb_c copies, discovers the cluster's protocol, and
routes through the matching one, so applications survive cluster
upgrades. The contract under test: protocol discovery works with NO
compatible library (the probe), a mismatched library alone cannot
connect, and the shim picks the right copy and runs real transactions
through it.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_c_binding import GatewayedCluster


def _build_versioned(tag: str) -> str:
    # the port builds its versioned copies into its own _kbuild/ (the
    # reference's `make versioned` writes bindings/c/build/)
    from foundationdb_tpu_torch.bindings.c_client import build_library
    return build_library(tag)


def test_multiversion_client_connects_across_protocols():
    lib01 = _build_versioned("fdbtpu01")
    lib02 = _build_versioned("fdbtpu02")

    from foundationdb_tpu_torch.bindings.c_client import (CClientError,
                                                          load_library_at)
    from foundationdb_tpu_torch.bindings.multiversion import (
        MultiVersionClient, probe_cluster_protocol)

    # the libraries report their build-time tags
    assert load_library_at(lib01).fdb_tpu_get_protocol() == b"fdbtpu01"
    assert load_library_at(lib02).fdb_tpu_get_protocol() == b"fdbtpu02"

    # an "upgraded" cluster speaking protocol 02
    with GatewayedCluster(gateway_protocol=b"fdbtpu02", seed=41) as gc:
        # discovery needs no compatible library at all
        assert probe_cluster_protocol("127.0.0.1", gc.port) == b"fdbtpu02"

        # the protocol-01 library alone CANNOT connect (a handshake
        # rejection looks like connection death, so the client's
        # bounded connect-retry runs out rather than erroring instantly)
        from foundationdb_tpu_torch.bindings.c_client import CDatabase
        with pytest.raises(CClientError):
            CDatabase("127.0.0.1", gc.port,
                      lib=load_library_at(lib01), connect_timeout=1.0)

        # the shim holds both and selects 02
        mv = MultiVersionClient([lib01, lib02])
        assert mv.protocols() == [b"fdbtpu01", b"fdbtpu02"]
        db = mv.open("127.0.0.1", gc.port)
        try:
            tr = db.create_transaction()
            tr.set(b"mv-key", b"via-02")
            v = tr.commit()
            assert v > 0
            tr.reset()
            assert tr.get(b"mv-key") == b"via-02"
            tr.destroy()
        finally:
            db.close()

        # no matching library -> the incompatible-client error
        mv01 = MultiVersionClient([lib01])
        with pytest.raises(RuntimeError, match="no client library"):
            mv01.open("127.0.0.1", gc.port)


def test_default_protocol_unchanged():
    """The default build still speaks fdbtpu01 — existing peers are
    unaffected by the versioning seam."""
    with GatewayedCluster(seed=42) as gc:
        from foundationdb_tpu_torch.bindings.c_client import CDatabase
        from foundationdb_tpu_torch.bindings.multiversion import \
            probe_cluster_protocol
        assert probe_cluster_protocol("127.0.0.1", gc.port) == b"fdbtpu01"
        db = CDatabase("127.0.0.1", gc.port)
        try:
            tr = db.create_transaction()
            tr.set(b"plain", b"ok")
            assert tr.commit() > 0
            tr.destroy()
        finally:
            db.close()
