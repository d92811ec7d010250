"""The reference's VersionedMap cases (tests/test_storage.py) on the
port's `server.storage`: intra-version mutation ordering, the window's
`forget`, and bounded read work over a 100k-key base.

Ref: fdbserver/storageserver.actor.cpp:1664 (applyMutation applies a
version's mutations strictly in order) and fdbclient/VersionedMap.h.
"""

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch.server.storage import VersionedMap  # noqa: E402
from foundationdb_tpu_torch.server.types import (CLEAR_RANGE, MutationRef,  # noqa: E402
                                                 SET_VALUE)


def _set(vm, v, k, val):
    vm.apply(v, MutationRef(SET_VALUE, k, val))


def _clear(vm, v, b, e):
    vm.apply(v, MutationRef(CLEAR_RANGE, b, e))


def test_set_then_clear_same_version_hides_key():
    vm = VersionedMap()
    _set(vm, 5, b"a", b"1")
    _clear(vm, 5, b"a", b"b")
    assert vm.get(b"a", 5) is None
    assert vm.get(b"a", 10) is None


def test_clear_then_set_same_version_keeps_key():
    vm = VersionedMap()
    _clear(vm, 5, b"a", b"z")
    _set(vm, 5, b"a", b"1")
    assert vm.get(b"a", 5) == b"1"
    assert vm.get(b"a", 10) == b"1"


def test_set_clear_set_same_version():
    vm = VersionedMap()
    _set(vm, 5, b"k", b"old")
    _clear(vm, 5, b"a", b"z")
    _set(vm, 5, b"k", b"new")
    assert vm.get(b"k", 5) == b"new"
    # another key in the cleared range stays hidden
    _set(vm, 4, b"m", b"x")  # applied earlier in a lower version
    assert vm.get(b"m", 5) is None
    assert vm.get(b"m", 4) == b"x"


def test_clear_hides_older_version_set():
    vm = VersionedMap()
    _set(vm, 3, b"a", b"1")
    _clear(vm, 5, b"a", b"b")
    assert vm.get(b"a", 3) == b"1"
    assert vm.get(b"a", 4) == b"1"
    assert vm.get(b"a", 5) is None
    _set(vm, 7, b"a", b"2")
    assert vm.get(b"a", 7) == b"2"


def test_get_range_respects_same_version_clear():
    vm = VersionedMap()
    _set(vm, 2, b"a", b"1")
    _set(vm, 2, b"b", b"2")
    _set(vm, 4, b"c", b"3")
    _clear(vm, 4, b"a", b"c")  # clears a,b but not c (set earlier at v4)
    out = vm.get_range(b"", b"\xff", 4, 100)
    assert out == [(b"c", b"3")]
    out = vm.get_range(b"", b"\xff", 3, 100)
    assert out == [(b"a", b"1"), (b"b", b"2")]


def test_forget_drops_window_prefix():
    vm = VersionedMap()
    _set(vm, 2, b"a", b"1")
    _set(vm, 5, b"a", b"2")
    _clear(vm, 3, b"b", b"c")
    vm.forget(3)
    assert vm.get(b"a", 5) == b"2"
    assert not any(c[0] <= 3 for c in vm._clears)


class _CountingKV:
    """Base-engine wrapper counting get_range rows served (the unit of
    scan work a storage read costs)."""

    def __init__(self, inner):
        self.inner = inner
        self.rows = 0

    def get(self, key):
        return self.inner.get(key)

    def get_range(self, begin, end, limit=1 << 30, reverse=False):
        out = self.inner.get_range(begin, end, limit=limit, reverse=reverse)
        self.rows += len(out)
        return out


def test_scalability_bounded_work_at_100k_keys():
    """Selectors, limited range reads, and gets on a 100k-key base must
    not enumerate the keyspace."""
    from foundationdb_tpu_torch.server.kvstore import EphemeralKeyValueStore
    from foundationdb_tpu_torch.server.types import KeySelector

    base = EphemeralKeyValueStore()
    for i in range(100_000):
        base.set(b"k%06d" % i, b"v")
    counting = _CountingKV(base)
    vm = VersionedMap(base=counting)
    # window activity: some sets and stamped clears
    for i in range(50):
        _set(vm, 10 + i, b"k%06d" % (i * 1000), b"w")
        _clear(vm, 10 + i, b"k%06d" % (i * 2000 + 500),
               b"k%06d" % (i * 2000 + 510))

    counting.rows = 0
    # point get: no base range scan at all
    assert vm.get(b"k050000", 100) == b"v"
    assert counting.rows == 0

    # limited range read: rows served bounded by ~limit + chunk
    got = vm.get_range(b"k000100", b"k099999", 100, 10)
    assert len(got) == 10
    assert counting.rows <= 200, counting.rows

    # selector with small offset: bounded walk, not a shard enumeration
    counting.rows = 0
    k, leftover = vm.resolve_selector(KeySelector(b"k050000", False, 5), 100)
    assert leftover == 0 and k == b"k050004"
    assert counting.rows <= 200, counting.rows

    counting.rows = 0
    k, leftover = vm.resolve_selector(KeySelector(b"k050000", False, -3), 100)
    assert leftover == 0 and k == b"k049996"
    assert counting.rows <= 200, counting.rows

    # many stamped clears stay cheap per get (indexed, not scanned)
    counting.rows = 0
    for i in range(100):
        vm.get(b"k%06d" % (i * 7), 100)
    assert counting.rows == 0
