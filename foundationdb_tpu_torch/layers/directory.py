"""Directory layer: a hierarchy of named subspaces with allocated
short prefixes.

Reference: the directory layer shipped with every reference binding
(bindings/python/fdb/directory_impl.py; Subspace/Tuple in fdbclient) —
paths map to compact allocated prefixes via a node tree stored in the
database itself, so layers address data by name without embedding long
paths in every key. Prefix allocation uses a windowed high-contention
allocator (candidates drawn randomly inside a window that advances as
it fills — the HCA pattern) so concurrent creates rarely conflict.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .. import flow
from ..flow import error
from . import tuple_layer
from .subspace import Subspace

_NODE_ROOT = b"\xfe"       # node-tree home (ref: DirectoryLayer defaults)
_SUB_DIRS = 0              # node field: child name -> child node key
_SUB_LAYER = b"layer"


class Directory:
    """A handle to an opened directory: a Subspace plus its path."""

    def __init__(self, layer: "DirectoryLayer", path: Tuple[str, ...],
                 prefix: bytes, layer_tag: bytes):
        self.directory_layer = layer
        self.path = path
        self.subspace = Subspace((), prefix)
        self.layer_tag = layer_tag

    def pack(self, t: Tuple = ()) -> bytes:
        return self.subspace.pack(t)

    def unpack(self, key: bytes) -> Tuple:
        return self.subspace.unpack(key)

    def range(self, t: Tuple = ()) -> Tuple[bytes, bytes]:
        return self.subspace.range(t)


class DirectoryLayer:
    def __init__(self, node_prefix: bytes = _NODE_ROOT,
                 content_prefix: bytes = b""):
        self._nodes = Subspace((), node_prefix)
        self._content_prefix = content_prefix
        self._alloc = _Allocator(self._nodes.subspace(("alloc",)))

    def _node_key(self, path: Tuple[str, ...]) -> bytes:
        return self._nodes.pack(("node",) + path)

    async def create_or_open(self, tr, path, layer: bytes = b"") -> Directory:
        return await self._open(tr, tuple(path), layer, create=True)

    async def open(self, tr, path, layer: bytes = b"") -> Directory:
        return await self._open(tr, tuple(path), layer, create=False)

    async def _open(self, tr, path: Tuple[str, ...], layer: bytes,
                    create: bool) -> Directory:
        if not path:
            raise error("client_invalid_operation")
        # parents must exist (created on demand under create=True)
        for i in range(1, len(path)):
            await self._open(tr, path[:i], b"", create=create)
        raw = await tr.get(self._node_key(path))
        if raw is not None:
            prefix, existing_layer = _decode_node(raw)
            if layer and existing_layer and layer != existing_layer:
                raise error("client_invalid_operation")
            return Directory(self, path, prefix, existing_layer)
        if not create:
            raise error("key_outside_legal_range")  # directory_not_exists
        prefix = self._content_prefix + await self._alloc.allocate(tr)
        tr.set(self._node_key(path), _encode_node(prefix, layer))
        return Directory(self, path, prefix, layer)

    async def exists(self, tr, path) -> bool:
        return await tr.get(self._node_key(tuple(path))) is not None

    async def list(self, tr, path=()) -> List[str]:
        base = ("node",) + tuple(path)
        b, e = self._nodes.range(base)
        out = []
        depth = len(base)
        rows = await tr.get_range(b, e)
        for k, _v in rows:
            t = self._nodes.unpack(k)
            if len(t) == depth + 1:
                out.append(t[-1])
        return out

    async def remove(self, tr, path) -> None:
        """Remove the directory, its children, and its contents."""
        path = tuple(path)
        raw = await tr.get(self._node_key(path))
        if raw is None:
            return
        prefix, _layer = _decode_node(raw)
        # contents
        tr.clear_range(prefix, prefix + b"\xff")
        # node subtree (the node itself + all descendants)
        b, e = self._nodes.range(("node",) + path)
        for k, v in await tr.get_range(b, e):
            child_prefix, _cl = _decode_node(v)
            tr.clear_range(child_prefix, child_prefix + b"\xff")
        tr.clear_range(b, e)
        tr.clear(self._node_key(path))

    async def move(self, tr, old_path, new_path) -> Directory:
        """Re-point a directory node (contents keep their prefix, so a
        move never rewrites data — ref: directory move semantics)."""
        old_path, new_path = tuple(old_path), tuple(new_path)
        raw = await tr.get(self._node_key(old_path))
        if raw is None:
            raise error("key_outside_legal_range")
        if await tr.get(self._node_key(new_path)) is not None:
            raise error("client_invalid_operation")
        for i in range(1, len(new_path)):
            if not await self.exists(tr, new_path[:i]):
                raise error("client_invalid_operation")
        # move the whole node subtree
        b, e = self._nodes.range(("node",) + old_path)
        for k, v in await tr.get_range(b, e):
            sub = self._nodes.unpack(k)[1 + len(old_path):]
            tr.set(self._nodes.pack(("node",) + new_path + sub), v)
        tr.set(self._node_key(new_path), raw)
        tr.clear_range(b, e)
        tr.clear(self._node_key(old_path))
        prefix, layer = _decode_node(raw)
        return Directory(self, new_path, prefix, layer)


def _encode_node(prefix: bytes, layer: bytes) -> bytes:
    return tuple_layer.pack((prefix, layer))


def _decode_node(raw: bytes):
    prefix, layer = tuple_layer.unpack(raw)
    return prefix, layer


class _Allocator:
    """Windowed high-contention prefix allocator (ref: the binding
    directory layer's HCA: counters advance a window; allocators pick
    random candidates inside it so concurrent transactions usually
    claim distinct slots and conflicts stay rare)."""

    WINDOW = 64

    def __init__(self, space: Subspace):
        self._counter = space.pack(("counter",))
        self._claims = space.subspace(("claims",))

    async def allocate(self, tr) -> bytes:
        raw = await tr.get(self._counter, snapshot=True)
        start = int(raw) if raw is not None else 0
        for _ in range(64):
            slot = start + flow.g_random.random_int(0, self.WINDOW)
            claim_key = self._claims.pack((slot,))
            if await tr.get(claim_key, snapshot=True) is None:
                # claiming writes the slot; OCC on the claim key makes
                # two same-slot allocations conflict at commit
                tr.set(claim_key, b"")
                self._bump(tr, start, slot)
                return tuple_layer.pack((slot,))
            start += 1  # window drifts forward as slots fill
        raise error("operation_failed")

    def _bump(self, tr, start: int, slot: int) -> None:
        tr.set(self._counter, b"%d" % max(start, slot + 1))
