"""Atomic mutation semantics.

Reference: fdbclient/Atomic.h — apply functions for the read-modify-write
mutation types carried in MutationRef (fdbclient/CommitTransaction.h:49-109).
Semantics re-implemented from the reference behavior, V2 variants (the
API-520 fixes) for And/Min: an absent existing value behaves as the
operand itself rather than as empty.

Little-endian arithmetic: operands are unsigned little-endian integers;
the result is truncated/zero-padded to the operand's length (the operand
defines the width, ref doLittleEndianAdd).
"""

from __future__ import annotations

from typing import Optional

VALUE_SIZE_LIMIT = 100_000  # ref: CLIENT_KNOBS->VALUE_SIZE_LIMIT


def _le_int(b: bytes) -> int:
    return int.from_bytes(b, "little")


def _le_bytes(v: int, length: int) -> bytes:
    return (v & ((1 << (8 * length)) - 1)).to_bytes(length, "little") \
        if length else b""


def add(existing: Optional[bytes], param: bytes) -> bytes:
    if not param:
        return b""
    if not existing:
        return param
    return _le_bytes(_le_int(existing) + _le_int(param), len(param))


def bit_and(existing: Optional[bytes], param: bytes) -> bytes:
    if existing is None:
        return param  # V2 semantics (ref: AndV2)
    ex = existing.ljust(len(param), b"\x00")
    return bytes(a & b for a, b in zip(ex, param))


def bit_or(existing: Optional[bytes], param: bytes) -> bytes:
    ex = (existing or b"").ljust(len(param), b"\x00")
    return bytes(a | b for a, b in zip(ex, param))


def bit_xor(existing: Optional[bytes], param: bytes) -> bytes:
    ex = (existing or b"").ljust(len(param), b"\x00")
    return bytes(a ^ b for a, b in zip(ex, param))


def vmax(existing: Optional[bytes], param: bytes) -> bytes:
    if not existing or not param:
        return param
    return _le_bytes(max(_le_int(existing), _le_int(param)), len(param))


def vmin(existing: Optional[bytes], param: bytes) -> bytes:
    if existing is None:
        return param  # V2 semantics (ref: MinV2)
    if not param:
        return param
    width = len(param)
    return _le_bytes(min(_le_int(existing), _le_int(param)), width)


def byte_min(existing: Optional[bytes], param: bytes) -> bytes:
    if existing is None:
        return param
    return min(existing, param)


def byte_max(existing: Optional[bytes], param: bytes) -> bytes:
    if existing is None:
        return param
    return max(existing, param)


def append_if_fits(existing: Optional[bytes], param: bytes) -> bytes:
    ex = existing or b""
    return ex + param if len(ex) + len(param) <= VALUE_SIZE_LIMIT else ex


def compare_and_clear(existing: Optional[bytes],
                      param: bytes) -> Optional[bytes]:
    """Returns None (clear) when equal, else the existing value."""
    return None if existing == param else existing
