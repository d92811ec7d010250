"""RPC wire format: every message that crosses the (simulated or real)
network serializes to bytes and back.

Reference: flow/serialize.h — the `serializer(ar, ...)` templates give
every RPC struct a byte encoding, and because the real FlowTransport
runs over simulated connections in sim, serialization bugs are caught
by ordinary simulation runs (SURVEY §4: "There is no mock-RPC layer").
This module plays both parts: a compact tagged encoding for the
framework's message vocabulary (NamedTuples over primitives), with
endpoints serialized as (process name, token) the way the reference
ships (address, token) pairs, and a round-trip hook the simulated
network applies to every delivery so nothing unserializable can sneak
into an interface.

Messages that are deliberately NOT wire-safe (the worker registration
carrying the recruitment seam object) opt out via ``__no_wire__``.
"""

from __future__ import annotations

import struct
from typing import Dict, Type

_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")

# type tags
_NONE, _FALSE, _TRUE, _INT, _BIGINT, _FLOAT, _BYTES, _STR, _TUPLE, \
    _LIST, _NT, _REF, _DICT = range(13)

_REGISTRY: Dict[str, Type] = {}

# encode hot path: the wire round-trip runs on EVERY simulated
# delivery, so the codec is dispatch-table-driven instead of an
# isinstance chain — type(obj) keys straight to its encoder, and each
# registered NamedTuple class precomputes its constant header bytes
# (tag + name + arity) once at registration. Byte format unchanged.
_ENCODERS: Dict[type, object] = {}
_NT_HEADER: Dict[type, bytes] = {}


def _nt_header(cls: Type) -> bytes:
    nb = cls.__name__.encode()
    return (bytes([_NT]) + _U32.pack(len(nb)) + nb
            + _U32.pack(len(cls._fields)))


def _encode_nt(obj, out) -> None:
    out.append(_NT_HEADER[type(obj)])
    for f in obj:
        encode(f, out)


def register_message(cls: Type) -> Type:
    """Register a NamedTuple message type for the wire (decorator)."""
    _REGISTRY[cls.__name__] = cls
    _NT_HEADER[cls] = _nt_header(cls)
    _ENCODERS[cls] = _encode_nt
    return cls


def register_all(module) -> None:
    """Register every NamedTuple class defined in a module."""
    for name in dir(module):
        obj = getattr(module, name)
        if isinstance(obj, type) and issubclass(obj, tuple) and \
                hasattr(obj, "_fields") and obj.__module__ == module.__name__:
            register_message(obj)


def register_module(module_name: str) -> None:
    """One-line footer for RPC-vocabulary modules:
    ``wire.register_module(__name__)``."""
    import sys
    register_all(sys.modules[module_name])


class WireError(TypeError):
    pass


_B_NONE = bytes([_NONE])
_B_FALSE = bytes([_FALSE])
_B_TRUE = bytes([_TRUE])
_B_INT = bytes([_INT])
_B_BIGINT = bytes([_BIGINT])
_B_FLOAT = bytes([_FLOAT])
_B_BYTES = bytes([_BYTES])
_B_STR = bytes([_STR])
_B_TUPLE = bytes([_TUPLE])
_B_LIST = bytes([_LIST])
_B_REF = bytes([_REF])
_B_DICT = bytes([_DICT])


def _encode_none(obj, out):
    out.append(_B_NONE)


def _encode_bool(obj, out):
    out.append(_B_TRUE if obj else _B_FALSE)


def _encode_int(obj, out):
    if -(1 << 63) <= obj < (1 << 63):
        out.append(_B_INT)
        out.append(_I64.pack(obj))
    else:
        b = obj.to_bytes((obj.bit_length() + 15) // 8, "big", signed=True)
        out.append(_B_BIGINT)
        out.append(_U32.pack(len(b)))
        out.append(b)


def _encode_float(obj, out):
    out.append(_B_FLOAT)
    out.append(_F64.pack(obj))


def _encode_bytes(obj, out):
    out.append(_B_BYTES)
    out.append(_U32.pack(len(obj)))
    out.append(bytes(obj))


def _encode_str(obj, out):
    b = obj.encode()
    out.append(_B_STR)
    out.append(_U32.pack(len(b)))
    out.append(b)


def _encode_tuple(obj, out):
    out.append(_B_TUPLE)
    out.append(_U32.pack(len(obj)))
    for f in obj:
        encode(f, out)


def _encode_list(obj, out):
    out.append(_B_LIST)
    out.append(_U32.pack(len(obj)))
    for f in obj:
        encode(f, out)


def _encode_dict(obj, out):
    out.append(_B_DICT)
    out.append(_U32.pack(len(obj)))
    for k, v in obj.items():
        encode(k, out)
        encode(v, out)


_ENCODERS.update({
    type(None): _encode_none,
    bool: _encode_bool,
    int: _encode_int,
    float: _encode_float,
    bytes: _encode_bytes,
    bytearray: _encode_bytes,
    str: _encode_str,
    tuple: _encode_tuple,
    list: _encode_list,
    dict: _encode_dict,
})


def _encode_ref(obj, out):
    ep = obj.endpoint
    nb = ep.process.name.encode()
    out.append(_B_REF)
    out.append(_U32.pack(len(nb)))
    out.append(nb)
    out.append(_I64.pack(ep.token))


def encode(obj, out: list) -> None:
    f = _ENCODERS.get(type(obj))
    if f is not None:
        f(obj, out)
    else:
        _encode_slow(obj, out)


def _encode_slow(obj, out: list) -> None:
    """Types outside the dispatch table: subclasses of the primitives,
    NamedTuples that never registered, NetworkRefs."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        if type(obj).__name__ not in _REGISTRY:
            raise WireError(
                f"unregistered message type {type(obj).__name__}")
        # a registered class reaching here was registered under another
        # class object of the same name (module reload): encode by name
        nb = type(obj).__name__.encode()
        out.append(bytes([_NT]))
        out.append(_U32.pack(len(nb)))
        out.append(nb)
        out.append(_U32.pack(len(obj)))
        for f in obj:
            encode(f, out)
    elif isinstance(obj, bool):
        _encode_bool(obj, out)
    elif isinstance(obj, int):
        _encode_int(obj, out)
    elif isinstance(obj, float):
        _encode_float(obj, out)
    elif isinstance(obj, (bytes, bytearray)):
        _encode_bytes(obj, out)
    elif isinstance(obj, str):
        _encode_str(obj, out)
    elif isinstance(obj, tuple):
        _encode_tuple(obj, out)
    elif isinstance(obj, list):
        _encode_list(obj, out)
    elif isinstance(obj, dict):
        _encode_dict(obj, out)
    elif type(obj).__name__ == "NetworkRef":
        # self-installs into the dispatch table on first sight (wire.py
        # cannot import rpc.network at load time — module cycle)
        _ENCODERS[type(obj)] = _encode_ref
        _encode_ref(obj, out)
    else:
        raise WireError(
            f"type {type(obj).__name__} has no wire encoding — register "
            f"the message or mark the request __no_wire__")


def _decode_none(buf, off, net):
    return None, off


def _decode_false(buf, off, net):
    return False, off


def _decode_true(buf, off, net):
    return True, off


def _decode_int(buf, off, net):
    return _I64.unpack_from(buf, off)[0], off + 8


def _decode_bigint(buf, off, net):
    (ln,) = _U32.unpack_from(buf, off)
    off += 4
    return int.from_bytes(buf[off:off + ln], "big", signed=True), off + ln


def _decode_float(buf, off, net):
    return _F64.unpack_from(buf, off)[0], off + 8


def _decode_bytes(buf, off, net):
    (ln,) = _U32.unpack_from(buf, off)
    off += 4
    return bytes(buf[off:off + ln]), off + ln


def _decode_str(buf, off, net):
    (ln,) = _U32.unpack_from(buf, off)
    off += 4
    return buf[off:off + ln].decode(), off + ln


def _decode_tuple(buf, off, net):
    (n,) = _U32.unpack_from(buf, off)
    off += 4
    items = []
    for _ in range(n):
        v, off = decode(buf, off, net)
        items.append(v)
    return tuple(items), off


def _decode_list(buf, off, net):
    (n,) = _U32.unpack_from(buf, off)
    off += 4
    items = []
    for _ in range(n):
        v, off = decode(buf, off, net)
        items.append(v)
    return items, off


def _decode_dict(buf, off, net):
    (n,) = _U32.unpack_from(buf, off)
    off += 4
    d = {}
    for _ in range(n):
        k, off = decode(buf, off, net)
        v, off = decode(buf, off, net)
        d[k] = v
    return d, off


def _decode_nt(buf, off, net):
    (ln,) = _U32.unpack_from(buf, off)
    off += 4
    name = buf[off:off + ln].decode()
    off += ln
    (n,) = _U32.unpack_from(buf, off)
    off += 4
    fields = []
    for _ in range(n):
        v, off = decode(buf, off, net)
        fields.append(v)
    cls = _REGISTRY.get(name)
    if cls is None:
        raise WireError(f"unregistered message type {name} in decode")
    return cls(*fields), off


def _decode_ref(buf, off, net):
    (ln,) = _U32.unpack_from(buf, off)
    off += 4
    name = buf[off:off + ln].decode()
    off += ln
    (token,) = _I64.unpack_from(buf, off)
    return net.resolve_ref(name, token), off + 8


_DECODERS = [None] * 13
_DECODERS[_NONE] = _decode_none
_DECODERS[_FALSE] = _decode_false
_DECODERS[_TRUE] = _decode_true
_DECODERS[_INT] = _decode_int
_DECODERS[_BIGINT] = _decode_bigint
_DECODERS[_FLOAT] = _decode_float
_DECODERS[_BYTES] = _decode_bytes
_DECODERS[_STR] = _decode_str
_DECODERS[_TUPLE] = _decode_tuple
_DECODERS[_LIST] = _decode_list
_DECODERS[_NT] = _decode_nt
_DECODERS[_REF] = _decode_ref
_DECODERS[_DICT] = _decode_dict


def decode(buf: bytes, off: int, net):
    tag = buf[off]
    if tag > 12:
        raise WireError(f"bad wire tag {tag}")
    return _DECODERS[tag](buf, off + 1, net)


def to_bytes(obj) -> bytes:
    out: list = []
    encode(obj, out)
    return b"".join(out)


def from_bytes(buf: bytes, net):
    v, _off = decode(buf, 0, net)
    return v


def roundtrip(obj, net):
    """encode+decode — the simulated delivery hook."""
    return from_bytes(to_bytes(obj), net)


def wire_safe(obj) -> bool:
    return not getattr(obj, "__no_wire__", False)
