"""TaskBucket: a persistent task queue stored in the database.

Reference: fdbclient/TaskBucket.actor.cpp — the backup system's
execution framework: tasks are key-space entries claimed by workers
with leases; a crashed worker's lease expires and the task becomes
available again; `is_empty`/`check_active` drive agents. Re-designed to
this framework's async client: add/claim/extend/finish as transactions
on a Subspace, with random claim keys for contention spread.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from .. import flow
from . import tuple_layer
from .subspace import Subspace




class Task:
    __slots__ = ("key", "params", "lease_until")

    def __init__(self, key: bytes, params: Dict[str, bytes],
                 lease_until: float):
        self.key = key
        self.params = params
        self.lease_until = lease_until


class TaskBucket:
    def __init__(self, subspace: Subspace, lease: float = None):
        if lease is None:
            lease = flow.SERVER_KNOBS.taskbucket_lease_seconds
        self._available = subspace.subspace(("avail",))
        self._claimed = subspace.subspace(("claimed",))
        self._lease = lease

    async def add(self, tr, params: Dict[str, bytes]) -> bytes:
        """Enqueue a task; returns its id."""
        tid = flow.g_random.random_bytes(12)
        tr.set(self._available.pack((tid,)), _encode_params(params))
        return tid

    async def claim_one(self, tr) -> Optional[Task]:
        """Claim an available task (or reclaim one whose lease
        expired). The claim is transactional: two workers claiming the
        same task conflict at commit and one retries onto another."""
        b, e = self._available.range()
        rows = await tr.get_range(b, e, limit=8)
        for k, v in rows:
            (tid,) = self._available.unpack(k)
            lease_until = flow.now() + self._lease
            tr.clear(k)
            tr.set(self._claimed.pack((tid,)),
                   tuple_layer.pack((lease_until,)) + v)
            return Task(self._claimed.pack((tid,)), _decode_params(v),
                        lease_until)
        # reclaim expired leases (ref: requeuing timed-out tasks)
        b, e = self._claimed.range()
        now = flow.now()
        for k, v in await tr.get_range(b, e, limit=8):
            lease_until, off = tuple_layer._decode_one(v, 0, False)
            if lease_until < now:
                params_blob = v[off:]
                tr.set(k, tuple_layer.pack((now + self._lease,))
                       + params_blob)
                return Task(k, _decode_params(params_blob),
                            now + self._lease)
        return None

    async def extend(self, tr, task: Task) -> None:
        raw = await tr.get(task.key)
        if raw is None:
            raise flow.error("operation_failed")
        _lease, off = tuple_layer._decode_one(raw, 0, False)
        task.lease_until = flow.now() + self._lease
        tr.set(task.key, tuple_layer.pack((task.lease_until,)) + raw[off:])

    async def finish(self, tr, task: Task) -> None:
        tr.clear(task.key)

    async def is_empty(self, tr) -> bool:
        for space in (self._available, self._claimed):
            b, e = space.range()
            if await tr.get_range(b, e, limit=1):
                return False
        return True


def _encode_params(params: Dict[str, bytes]) -> bytes:
    return tuple_layer.pack(tuple(x for kv in sorted(params.items())
                                  for x in kv))


def _decode_params(blob: bytes) -> Dict[str, bytes]:
    flat = tuple_layer.unpack(blob)
    return {flat[i]: flat[i + 1] for i in range(0, len(flat), 2)}
