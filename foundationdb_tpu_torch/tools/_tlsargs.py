"""Shared --tls-cert/--tls-key/--tls-ca handling for the CLI tools."""

from __future__ import annotations

from typing import Dict, Optional

TLS_FLAGS = {"--tls-cert": "certfile", "--tls-key": "keyfile",
             "--tls-ca": "cafile"}


def tls_from_args(tls_args: Dict[str, str]):
    """TlsConfig from collected flag values; None when no flags given.
    Raises ValueError when only some of the three are present."""
    if not tls_args:
        return None
    if set(tls_args) != {"certfile", "keyfile", "cafile"}:
        raise ValueError(
            "--tls-cert, --tls-key, and --tls-ca must all be given")
    from ..rpc.tcp import TlsConfig
    return TlsConfig(**tls_args)
