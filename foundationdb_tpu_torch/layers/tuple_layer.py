"""Tuple layer: order-preserving encoding of mixed-type tuples.

Reference: fdbclient/Tuple.cpp + the cross-binding tuple spec
(design/tuple.md; bindings/python/fdb/tuple.py) — the SAME type codes
and byte transforms, so keys packed here sort exactly like the
reference's and interoperate with its bindings:

  0x00 null; 0x01 bytes (0x00 escaped as 0x00 0xFF, 0x00 terminator);
  0x02 utf-8 string (same escaping); 0x05 nested tuple (null inside is
  escaped 0x00 0xFF, 0x00 terminates); 0x0C..0x1C integers (0x14 zero,
  0x14+n n-byte big-endian positive, 0x14-n n-byte negative stored
  complemented); 0x21 double (big-endian IEEE, sign-flipped transform);
  0x26 false; 0x27 true; 0x30 UUID (16 bytes); 0x33 versionstamp.

The ordering property — pack(a) < pack(b) iff a < b under the layer's
type ordering — is what makes tuples usable as keys.
"""

from __future__ import annotations

import struct
import uuid as _uuid
from typing import Any, Tuple

from ..flow import error

_NULL = 0x00
_BYTES = 0x01
_STRING = 0x02
_NESTED = 0x05
_INT_ZERO = 0x14
_DOUBLE = 0x21
_FALSE = 0x26
_TRUE = 0x27
_UUID = 0x30
_VERSIONSTAMP = 0x33

_size_limits = [(1 << (i * 8)) - 1 for i in range(9)]


class Versionstamp:
    """(ref: the 12-byte versionstamp type: 10 bytes transaction
    version + 2 bytes user version)"""

    __slots__ = ("bytes_",)

    def __init__(self, bytes_: bytes):
        if len(bytes_) != 12:
            raise ValueError("versionstamp is 12 bytes")
        self.bytes_ = bytes(bytes_)

    def __eq__(self, other):
        return isinstance(other, Versionstamp) and \
            self.bytes_ == other.bytes_

    def __lt__(self, other):
        return self.bytes_ < other.bytes_

    def __hash__(self):
        return hash(self.bytes_)

    def __repr__(self):
        return f"Versionstamp({self.bytes_.hex()})"


def _encode_escaped(out: list, b: bytes) -> None:
    out.append(b.replace(b"\x00", b"\x00\xff"))
    out.append(b"\x00")


def _encode_one(out: list, v: Any, nested: bool) -> None:
    if v is None:
        out.append(b"\x00\xff" if nested else b"\x00")
    elif v is True:
        out.append(bytes([_TRUE]))
    elif v is False:
        out.append(bytes([_FALSE]))
    elif isinstance(v, (bytes, bytearray)):
        out.append(bytes([_BYTES]))
        _encode_escaped(out, bytes(v))
    elif isinstance(v, str):
        out.append(bytes([_STRING]))
        _encode_escaped(out, v.encode("utf-8"))
    elif isinstance(v, int):
        if v == 0:
            out.append(bytes([_INT_ZERO]))
        elif v > 0:
            n = (v.bit_length() + 7) // 8
            if n > 8:
                raise error("client_invalid_operation")
            out.append(bytes([_INT_ZERO + n]))
            out.append(v.to_bytes(n, "big"))
        else:
            n = ((-v).bit_length() + 7) // 8
            if n > 8:
                raise error("client_invalid_operation")
            out.append(bytes([_INT_ZERO - n]))
            out.append((v + _size_limits[n]).to_bytes(n, "big"))
    elif isinstance(v, float):
        out.append(bytes([_DOUBLE]))
        raw = struct.pack(">d", v)
        # order-preserving transform: flip the sign bit for positives,
        # complement everything for negatives (ref: Tuple.cpp float code)
        if raw[0] & 0x80:
            raw = bytes(x ^ 0xFF for x in raw)
        else:
            raw = bytes([raw[0] ^ 0x80]) + raw[1:]
        out.append(raw)
    elif isinstance(v, _uuid.UUID):
        out.append(bytes([_UUID]))
        out.append(v.bytes)
    elif isinstance(v, Versionstamp):
        out.append(bytes([_VERSIONSTAMP]))
        out.append(v.bytes_)
    elif isinstance(v, (tuple, list)):
        out.append(bytes([_NESTED]))
        for item in v:
            _encode_one(out, item, nested=True)
        out.append(b"\x00")
    else:
        raise error("client_invalid_operation")


def pack(t: Tuple) -> bytes:
    out: list = []
    for v in t:
        _encode_one(out, v, nested=False)
    return b"".join(out)


def _find_terminator(b: bytes, off: int) -> int:
    while True:
        i = b.index(b"\x00", off)
        if i + 1 < len(b) and b[i + 1] == 0xFF:
            off = i + 2
            continue
        return i


def _decode_one(b: bytes, off: int, nested: bool):
    code = b[off]
    if code == _NULL:
        if nested and off + 1 < len(b) and b[off + 1] == 0xFF:
            return None, off + 2
        return None, off + 1
    if code == _BYTES or code == _STRING:
        end = _find_terminator(b, off + 1)
        raw = b[off + 1:end].replace(b"\x00\xff", b"\x00")
        return (raw if code == _BYTES else raw.decode("utf-8")), end + 1
    if code == _NESTED:
        items = []
        off += 1
        while True:
            if b[off] == 0x00 and not (off + 1 < len(b)
                                       and b[off + 1] == 0xFF):
                return tuple(items), off + 1
            v, off = _decode_one(b, off, nested=True)
            items.append(v)
    if _INT_ZERO - 8 <= code <= _INT_ZERO + 8:
        n = code - _INT_ZERO
        if n == 0:
            return 0, off + 1
        if n > 0:
            return int.from_bytes(b[off + 1:off + 1 + n], "big"), \
                off + 1 + n
        n = -n
        return int.from_bytes(b[off + 1:off + 1 + n], "big") - \
            _size_limits[n], off + 1 + n
    if code == _DOUBLE:
        raw = b[off + 1:off + 9]
        if raw[0] & 0x80:
            raw = bytes([raw[0] ^ 0x80]) + raw[1:]
        else:
            raw = bytes(x ^ 0xFF for x in raw)
        return struct.unpack(">d", raw)[0], off + 9
    if code == _FALSE:
        return False, off + 1
    if code == _TRUE:
        return True, off + 1
    if code == _UUID:
        return _uuid.UUID(bytes=bytes(b[off + 1:off + 17])), off + 17
    if code == _VERSIONSTAMP:
        return Versionstamp(b[off + 1:off + 13]), off + 13
    raise error("client_invalid_operation")


def unpack(b: bytes) -> Tuple:
    out = []
    off = 0
    while off < len(b):
        v, off = _decode_one(b, off, nested=False)
        out.append(v)
    return tuple(out)


def range_of(t: Tuple) -> Tuple[bytes, bytes]:
    """The key range of every tuple extending `t` (ref: Tuple::range /
    fdb.tuple.range)."""
    p = pack(t)
    return p + b"\x00", p + b"\xff"
