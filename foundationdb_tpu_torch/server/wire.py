"""Binary encoding of mutations and log entries.

Reference: flow/serialize.h — byte-identical, versioned archives; the
TLog's persisted format and (later) the RPC wire format both build on
this. Little-endian, length-prefixed; a one-byte protocol version
leads every entry so future formats can evolve (ref: IncludeVersion,
flow/serialize.h:276).
"""

from __future__ import annotations

import struct
from typing import Tuple

from ..flow import error
from .types import MutationRef, TaggedMutation

PROTOCOL_VERSION = 2
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


def encode_mutation(m: MutationRef) -> bytes:
    return b"".join((bytes([m.type]), _U32.pack(len(m.param1)), m.param1,
                     _U32.pack(len(m.param2)), m.param2))


def decode_mutation(buf: bytes, off: int):
    t = buf[off]
    off += 1
    (l1,) = _U32.unpack_from(buf, off)
    p1 = bytes(buf[off + 4:off + 4 + l1])
    off += 4 + l1
    (l2,) = _U32.unpack_from(buf, off)
    p2 = bytes(buf[off + 4:off + 4 + l2])
    off += 4 + l2
    return MutationRef(t, p1, p2), off


def encode_mutations(mutations) -> bytes:
    out = [_U32.pack(len(mutations))]
    for m in mutations:
        out.append(encode_mutation(m))
    return b"".join(out)


def decode_mutations(buf: bytes, off: int = 0):
    (n,) = _U32.unpack_from(buf, off)
    off += 4
    out = []
    for _ in range(n):
        m, off = decode_mutation(buf, off)
        out.append(m)
    return tuple(out), off


def encode_tagged_mutations(tagged) -> bytes:
    out = [_U32.pack(len(tagged))]
    for tm in tagged:
        out.append(_U16.pack(len(tm.tags)))
        for t in tm.tags:
            out.append(_U16.pack(t))
        out.append(encode_mutation(tm.mutation))
    return b"".join(out)


def decode_tagged_mutations(buf: bytes, off: int = 0):
    (n,) = _U32.unpack_from(buf, off)
    off += 4
    out = []
    for _ in range(n):
        (ntags,) = _U16.unpack_from(buf, off)
        off += 2
        tags = []
        for _t in range(ntags):
            (tag,) = _U16.unpack_from(buf, off)
            tags.append(tag)
            off += 2
        m, off = decode_mutation(buf, off)
        out.append(TaggedMutation(tuple(tags), m))
    return tuple(out), off


def encode_log_entry(version: int, tagged_mutations) -> bytes:
    """One TLog record: [proto u8][version u64][tagged mutations]."""
    return bytes([PROTOCOL_VERSION]) + _U64.pack(version) + \
        encode_tagged_mutations(tagged_mutations)


def decode_log_entry(buf: bytes) -> Tuple[int, Tuple[TaggedMutation, ...]]:
    if not buf or buf[0] != PROTOCOL_VERSION:
        raise error("incompatible_protocol_version")
    (version,) = _U64.unpack_from(buf, 1)
    tagged, _ = decode_tagged_mutations(buf, 9)
    return version, tagged
