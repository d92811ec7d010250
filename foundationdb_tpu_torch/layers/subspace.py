"""Subspace: a tuple-prefixed partition of the keyspace.

Reference: fdbclient/Subspace.cpp — a fixed key prefix + the tuple
layer: `subspace.pack(t)` prepends the prefix, `unpack` strips it,
`range()` covers everything under the subspace. Directory-style
composition comes from nesting subspaces.
"""

from __future__ import annotations

from typing import Tuple

from ..flow import error
from . import tuple_layer


class Subspace:
    def __init__(self, prefix_tuple: Tuple = (), raw_prefix: bytes = b""):
        self._prefix = raw_prefix + tuple_layer.pack(prefix_tuple)

    @property
    def key(self) -> bytes:
        return self._prefix

    def pack(self, t: Tuple = ()) -> bytes:
        return self._prefix + tuple_layer.pack(t)

    def unpack(self, key: bytes) -> Tuple:
        if not key.startswith(self._prefix):
            raise error("key_outside_legal_range")
        return tuple_layer.unpack(key[len(self._prefix):])

    def contains(self, key: bytes) -> bool:
        return key.startswith(self._prefix)

    def range(self, t: Tuple = ()) -> Tuple[bytes, bytes]:
        p = self._prefix + tuple_layer.pack(t)
        return p + b"\x00", p + b"\xff"

    def subspace(self, t: Tuple) -> "Subspace":
        return Subspace((), self.pack(t))

    def __getitem__(self, item) -> "Subspace":
        return self.subspace((item,))
