"""Queue recipes: FIFO queue and priority queue over the tuple layer.

Reference: recipes/python-recipes (Queue / PriorityQueue) — the classic
FDB patterns: items keyed by (priority, sequencer, random tiebreak) so
pops take the head transactionally and concurrent pushers never
conflict with each other.
"""

from __future__ import annotations

from typing import Optional, Tuple

from .. import flow
from .subspace import Subspace


class PriorityQueue:
    """Lower priority value pops first; FIFO within a priority."""

    def __init__(self, subspace: Subspace = None):
        self.ss = subspace if subspace is not None else Subspace(("pq",))

    async def push(self, tr, item: bytes, priority: int = 0) -> None:
        """Keyed (priority, next-index, random): pushers only read a
        snapshot of their priority's tail, so they don't conflict."""
        b, e = self.ss.range((priority,))
        last = await tr.get_range(b, e, limit=1, reverse=True,
                                  snapshot=True)
        idx = self.ss.unpack(last[0][0])[1] + 1 if last else 0
        tie = flow.g_random.random_int(0, 1 << 30)
        tr.set(self.ss.pack((priority, idx, tie)), item)

    async def pop(self, tr) -> Optional[bytes]:
        """Take the head (lowest priority, oldest index); None if
        empty. Pops DO conflict with a racing pop of the same head —
        exactly-once delivery."""
        b, e = self.ss.range()
        head = await tr.get_range(b, e, limit=1)
        if not head:
            return None
        tr.clear(head[0][0])
        return head[0][1]

    async def peek(self, tr) -> Optional[Tuple[int, bytes]]:
        b, e = self.ss.range()
        head = await tr.get_range(b, e, limit=1)
        if not head:
            return None
        return self.ss.unpack(head[0][0])[0], head[0][1]


class Queue(PriorityQueue):
    """Plain FIFO: a PriorityQueue with one priority."""

    def __init__(self, subspace: Subspace = None):
        super().__init__(subspace if subspace is not None
                         else Subspace(("queue",)))

    async def push(self, tr, item: bytes) -> None:  # noqa: D102
        await super().push(tr, item, 0)
