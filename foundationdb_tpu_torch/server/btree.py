"""KeyValueStoreBTree: a page-based copy-on-write B-tree engine.

Reference: fdbserver/VersionedBTree.actor.cpp (Redwood) +
IndirectShadowPager — the design re-expressed, not translated: 4KiB
checksummed pages, copy-on-write updates (modified paths are written to
FRESH pages), and a dual-slot superblock whose atomic flip commits the
new tree — a torn commit leaves the previous superblock (and therefore
the previous tree) fully intact, which is the crash-consistency story
(ref: IndirectShadowPager's shadowed page map; KeyValueStoreSQLite's
journaled btree plays this role for the ssd engine). Pages freed by
commit N re-enter circulation only after superblock N lands, so the
previous tree stays readable throughout.

The page set is write-through cached in RAM (reads are synchronous per
the IKeyValueStore contract; Redwood's page cache plays this role) and
the disk is the durability story.
"""

from __future__ import annotations

import struct
import zlib
from bisect import bisect_left, bisect_right, insort
from typing import Dict, List, Optional, Tuple

from ..rpc.disk import SimDisk
from .kvstore import IKeyValueStore

PAGE_SIZE = 4096
_SUPER = struct.Struct("<IQQQQ")      # crc, commit_seq, root, next_page, nfree
_PHDR = struct.Struct("<IBH")         # crc, kind, n_items
_LEAF, _INNER, _FREE = 0, 1, 2
MAX_FANOUT = 32        # split threshold (items per page)
# per-item limits keep any two items fitting one page, so byte-aware
# splits always converge (the reference stores oversized values via
# overflow pages; this engine enforces limits instead — fdbcli-visible
# as key_too_large / value_too_large)
MAX_KEY = 1500
MAX_VALUE = 2000
_PAGE_BUDGET = PAGE_SIZE - _PHDR.size - 16


def _leaf_bytes(keys, vals) -> int:
    return sum(6 + len(k) + len(v) for k, v in zip(keys, vals))


def _inner_bytes(keys) -> int:
    return 8 + sum(10 + len(k) for k in keys)


class _Node:
    __slots__ = ("kind", "keys", "vals", "children")

    def __init__(self, kind, keys=None, vals=None, children=None):
        self.kind = kind
        self.keys: List[bytes] = keys if keys is not None else []
        # leaf: vals parallel to keys; inner: children = keys+1 page ids
        self.vals: List[bytes] = vals if vals is not None else []
        self.children: List[int] = children if children is not None else []


def _encode_node(n: _Node) -> bytes:
    out = []
    if n.kind == _LEAF:
        for k, v in zip(n.keys, n.vals):
            out.append(struct.pack("<HI", len(k), len(v)))
            out.append(k)
            out.append(v)
    else:
        out.append(struct.pack("<Q", n.children[0]))
        for k, c in zip(n.keys, n.children[1:]):
            out.append(struct.pack("<HQ", len(k), c))
            out.append(k)
    body = b"".join(out)
    hdr = _PHDR.pack(0, n.kind, len(n.keys))
    page = hdr + body
    if len(page) > PAGE_SIZE:
        raise ValueError("btree page overflow — lower MAX_FANOUT")
    page = page + b"\x00" * (PAGE_SIZE - len(page))
    crc = zlib.crc32(page[4:])
    return struct.pack("<I", crc) + page[4:]


def _decode_node(page: bytes) -> _Node:
    crc, kind, n_items = _PHDR.unpack_from(page, 0)
    if zlib.crc32(page[4:]) != crc:
        raise ValueError("btree page checksum mismatch")
    off = _PHDR.size
    node = _Node(kind)
    if kind == _LEAF:
        for _ in range(n_items):
            kl, vl = struct.unpack_from("<HI", page, off)
            off += 6
            node.keys.append(bytes(page[off:off + kl]))
            off += kl
            node.vals.append(bytes(page[off:off + vl]))
            off += vl
    else:
        (c0,) = struct.unpack_from("<Q", page, off)
        off += 8
        node.children.append(c0)
        for _ in range(n_items):
            kl, c = struct.unpack_from("<HQ", page, off)
            off += 10
            node.keys.append(bytes(page[off:off + kl]))
            off += kl
            node.children.append(c)
    return node


class KeyValueStoreBTree(IKeyValueStore):
    def __init__(self, disk: SimDisk, name: str, owner=None):
        self._file = disk.open(f"{name}.btree", owner)
        self._cache: Dict[int, _Node] = {}    # page id -> node (resident)
        self._root = 0
        self._next_page = 2                   # 0,1 are superblock slots
        self._free: List[int] = []            # reusable page ids
        self._pending_free: List[int] = []    # freed by the open commit
        self._commit_seq = 0
        self._staged: List[Tuple[int, bytes, bytes]] = []  # (op, a, b)
        self._dirty: Dict[int, _Node] = {}    # pages to write at commit
        self._rows = 0                        # committed row count

    # -- recovery --------------------------------------------------------
    async def recover(self) -> None:
        size = await self._file.size()
        best = None
        for slot in (0, 1):
            if size < (slot + 1) * PAGE_SIZE:
                continue
            raw = await self._file.read(slot * PAGE_SIZE, PAGE_SIZE)
            try:
                crc, seq, root, nxt, nfree = _SUPER.unpack_from(raw, 0)
            except struct.error:
                continue
            if zlib.crc32(raw[4:]) != crc:
                continue
            if best is None or seq > best[0]:
                best = (seq, root, nxt, nfree, raw)
        self._cache.clear()
        if best is None:
            self._root = 0
            self._next_page = 2
            self._free = []
            self._commit_seq = 0
            return
        seq, root, nxt, nfree, raw = best
        self._commit_seq = seq
        self._root = root
        self._next_page = nxt
        off = _SUPER.size
        self._free = list(struct.unpack_from(f"<{nfree}Q", raw, off))
        # load the reachable tree into the resident cache
        self._rows = 0
        if root:
            await self._load(root)

    async def _load(self, page_id: int) -> None:
        raw = await self._file.read(page_id * PAGE_SIZE, PAGE_SIZE)
        node = _decode_node(raw)
        self._cache[page_id] = node
        if node.kind == _INNER:
            for c in node.children:
                await self._load(c)
        else:
            self._rows += len(node.keys)

    # -- staged mutations -------------------------------------------------
    def set(self, key: bytes, value: bytes) -> None:
        if len(key) > MAX_KEY:
            raise ValueError("btree key exceeds engine limit")
        if len(value) > MAX_VALUE:
            raise ValueError("btree value exceeds engine limit")
        self._staged.append((0, key, value))

    def clear_range(self, begin: bytes, end: bytes) -> None:
        self._staged.append((1, begin, end))

    # -- reads (resident tree + staged overlay) ---------------------------
    def _tree_get(self, key: bytes) -> Optional[bytes]:
        pid = self._root
        if not pid:
            return None
        while True:
            node = self._cache[pid]
            if node.kind == _LEAF:
                i = bisect_left(node.keys, key)
                if i < len(node.keys) and node.keys[i] == key:
                    return node.vals[i]
                return None
            pid = node.children[bisect_right(node.keys, key)]

    def get(self, key: bytes) -> Optional[bytes]:
        found, val = self._overlay(key)
        return val if found else self._tree_get(key)

    def _overlay(self, key: bytes):
        for op, a, b in reversed(self._staged):
            if op == 0 and a == key:
                return True, b
            if op == 1 and a <= key < b:
                return True, None
        return False, None

    def _tree_scan(self, begin: bytes, end: bytes, out: List,
                   pid: int, limit: int) -> None:
        node = self._cache[pid]
        if node.kind == _LEAF:
            lo = bisect_left(node.keys, begin)
            hi = bisect_left(node.keys, end)
            for i in range(lo, hi):
                out.append((node.keys[i], node.vals[i]))
                if len(out) >= limit:
                    return
            return
        lo = bisect_right(node.keys, begin)
        hi = bisect_left(node.keys, end)
        for i in range(lo - 1 if lo else 0, min(hi, len(node.keys)) + 1):
            self._tree_scan(begin, end, out, node.children[i], limit)
            if len(out) >= limit:
                return

    def _tree_scan_rev(self, begin: bytes, end: bytes, out: List,
                       pid: int, limit: int) -> None:
        """Descending scan yielding the rows nearest `end` first — the
        contract reverse paging callers rely on."""
        node = self._cache[pid]
        if node.kind == _LEAF:
            lo = bisect_left(node.keys, begin)
            hi = bisect_left(node.keys, end)
            for i in range(hi - 1, lo - 1, -1):
                out.append((node.keys[i], node.vals[i]))
                if len(out) >= limit:
                    return
            return
        lo = bisect_right(node.keys, begin)
        hi = bisect_left(node.keys, end)
        first = lo - 1 if lo else 0
        last = min(hi, len(node.keys))
        for i in range(last, first - 1, -1):
            self._tree_scan_rev(begin, end, out, node.children[i], limit)
            if len(out) >= limit:
                return

    def row_count(self) -> int:
        return self._rows

    def get_range(self, begin: bytes, end: bytes, limit: int = 1 << 30,
                  reverse: bool = False) -> List[Tuple[bytes, bytes]]:
        rows: List[Tuple[bytes, bytes]] = []
        if self._root and not self._staged:
            if reverse:
                self._tree_scan_rev(begin, end, rows, self._root, limit)
            else:
                self._tree_scan(begin, end, rows, self._root, limit)
            return rows[:limit]
        if self._root:
            # staged clears/sets can alter the window: fetch it all
            self._tree_scan(begin, end, rows, self._root, 1 << 30)
        merged = dict(rows)
        for op, a, b in self._staged:
            if op == 0:
                if begin <= a < end:
                    merged[a] = b
            else:
                for k in [k for k in merged if a <= k < b]:
                    del merged[k]
        rows = sorted(merged.items())
        if reverse:
            rows = rows[::-1]
        return rows[:limit]

    # -- commit: apply staged ops copy-on-write, flip the superblock ------
    def _alloc(self) -> int:
        if self._free:
            return self._free.pop()
        pid = self._next_page
        self._next_page += 1
        return pid

    def _free_page(self, pid: int) -> None:
        self._pending_free.append(pid)
        self._cache.pop(pid, None)
        self._dirty.pop(pid, None)

    def _write_node(self, node: _Node) -> int:
        pid = self._alloc()
        self._cache[pid] = node
        self._dirty[pid] = node
        return pid

    def _apply_set(self, pid: int, key: bytes, value: bytes) -> List:
        """Returns [(sep_key?, new_pid), ...] (1 entry, or 2 on split)."""
        if not pid:
            return [(None, self._write_node(_Node(_LEAF, [key], [value])))]
        node = self._cache[pid]
        if node.kind == _LEAF:
            keys, vals = list(node.keys), list(node.vals)
            i = bisect_left(keys, key)
            if i < len(keys) and keys[i] == key:
                vals[i] = value
            else:
                keys.insert(i, key)
                vals.insert(i, value)
                self._rows += 1
            self._free_page(pid)
            return self._maybe_split(_Node(_LEAF, keys, vals))
        ci = bisect_right(node.keys, key)
        parts = self._apply_set(node.children[ci], key, value)
        return self._replace_child(node, pid, ci, parts)

    def _replace_child(self, node: _Node, pid: int, ci: int,
                       parts: List) -> List:
        keys = list(node.keys)
        children = list(node.children)
        children[ci] = parts[0][1]
        for sep, new_pid in parts[1:]:
            keys.insert(ci, sep)
            children.insert(ci + 1, new_pid)
            ci += 1
        self._free_page(pid)
        return self._maybe_split(_Node(_INNER, keys, None, children))

    def _maybe_split(self, node: _Node) -> List:
        over_bytes = (_leaf_bytes(node.keys, node.vals) if node.kind == _LEAF
                      else _inner_bytes(node.keys)) > _PAGE_BUDGET
        if len(node.keys) <= MAX_FANOUT and not over_bytes:
            return [(None, self._write_node(node))]
        if len(node.keys) < 2:
            # a single item always fits (enforced at set())
            return [(None, self._write_node(node))]
        mid = len(node.keys) // 2
        if node.kind == _LEAF:
            left = _Node(_LEAF, node.keys[:mid], node.vals[:mid])
            right = _Node(_LEAF, node.keys[mid:], node.vals[mid:])
            sep = right.keys[0]
        else:
            left = _Node(_INNER, node.keys[:mid], None,
                         node.children[:mid + 1])
            right = _Node(_INNER, node.keys[mid + 1:], None,
                          node.children[mid + 1:])
            sep = node.keys[mid]
        # recurse: a half of few-but-large items may still exceed the
        # byte budget (item limits guarantee convergence)
        lp = self._maybe_split(left)
        rp = self._maybe_split(right)
        return lp + [(sep, rp[0][1])] + rp[1:]

    def _apply_clear(self, begin: bytes, end: bytes) -> None:
        """Rebuild-free range clear: collect survivors per overlapping
        leaf and rewrite those paths (simple COW delete; underfull
        leaves are tolerated — Redwood also defers rebalancing)."""
        doomed = []
        if self._root:
            self._tree_scan(begin, end, doomed, self._root, 1 << 30)
        for k, _v in doomed:
            self._root = self._delete_key(self._root, k)

    def _delete_key(self, pid: int, key: bytes) -> int:
        node = self._cache[pid]
        if node.kind == _LEAF:
            keys, vals = list(node.keys), list(node.vals)
            i = bisect_left(keys, key)
            if i < len(keys) and keys[i] == key:
                del keys[i]
                del vals[i]
                self._rows -= 1
            self._free_page(pid)
            return self._write_node(_Node(_LEAF, keys, vals))
        ci = bisect_right(node.keys, key)
        new_child = self._delete_key(node.children[ci], key)
        children = list(node.children)
        children[ci] = new_child
        # collapse empty leaves out of the inner node
        child_node = self._cache[new_child]
        keys = list(node.keys)
        if child_node.kind == _LEAF and not child_node.keys and \
                len(children) > 1:
            self._free_page(new_child)
            del children[ci]
            del keys[max(0, ci - 1)]
        self._free_page(pid)
        if not keys and len(children) == 1:
            return children[0]
        return self._write_node(_Node(_INNER, keys, None, children))

    async def commit(self) -> None:
        staged, self._staged = self._staged, []
        for op, a, b in staged:
            if op == 0:
                parts = self._apply_set(self._root, a, b)
                while len(parts) > 1:   # grow new root levels as needed
                    keys = [sep for sep, _ in parts[1:]]
                    children = [pid for _, pid in parts]
                    parts = self._maybe_split(
                        _Node(_INNER, keys, None, children))
                self._root = parts[0][1]
            else:
                self._apply_clear(a, b)
        # write dirty pages, sync, then flip the superblock
        dirty, self._dirty = self._dirty, {}
        for pid, node in dirty.items():
            await self._file.write(pid * PAGE_SIZE, _encode_node(node))
        await self._file.sync()
        self._commit_seq += 1
        all_free = self._free + self._pending_free
        cap_entries = (PAGE_SIZE - _SUPER.size) // 8
        # the superblock lists as many free pages as fit; the remainder
        # stays reusable in RAM and gets another shot at durability on
        # the next commit — only a crash while the overflow is non-empty
        # leaks those pages (bounded, unlike silent truncation; the
        # reference chains its free list through pages instead)
        durable_free = all_free[:cap_entries]
        body = _SUPER.pack(0, self._commit_seq, self._root,
                           self._next_page, len(durable_free))
        body += struct.pack(f"<{len(durable_free)}Q", *durable_free)
        body += b"\x00" * (PAGE_SIZE - len(body))
        crc = zlib.crc32(body[4:])
        page = struct.pack("<I", crc) + body[4:]
        slot = self._commit_seq % 2
        await self._file.write(slot * PAGE_SIZE, page)
        await self._file.sync()
        # the old tree is no longer referenced: recycle its pages
        self._free = all_free
        self._pending_free = []
