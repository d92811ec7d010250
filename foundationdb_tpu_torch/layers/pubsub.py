"""PubSub layer: feeds, inboxes, fan-out message delivery.

Reference: layers/pubsub (the in-tree Python recipe) and
fdbserver/pubsub.actor.cpp — feeds post messages; inboxes subscribe to
feeds; a read drains each subscribed feed from the inbox's last-seen
watermark. Everything is ordinary transactions over the tuple layer,
so delivery inherits the database's ACID guarantees: a post is either
visible to every subscriber or none.

Layout (all under one Subspace):
  ("feed", feed_id, seq)        -> message bytes
  ("feedmeta", feed_id)         -> next seq (little-endian, atomic ADD)
  ("sub", inbox_id, feed_id)    -> last-read seq (versionless watermark)
"""

from __future__ import annotations

from typing import List, Tuple

from .subspace import Subspace


class PubSub:
    def __init__(self, subspace: Subspace = None):
        self.ss = subspace if subspace is not None else Subspace(("pubsub",))

    # -- feeds -----------------------------------------------------------
    async def post(self, tr, feed: str, message: bytes) -> None:
        """Append a message to the feed. The sequencer read carries a
        CONFLICT range: concurrent posters to the same feed serialize
        through OCC retry, so no post can overwrite another (a
        snapshot read here would silently drop messages)."""
        meta = self.ss.pack(("feedmeta", feed))
        raw = await tr.get(meta)
        seq = int.from_bytes(raw or b"", "little")
        tr.set(self.ss.pack(("feed", feed, seq)), message)
        tr.set(meta, (seq + 1).to_bytes(8, "little"))

    # -- subscriptions ---------------------------------------------------
    async def subscribe(self, tr, inbox: str, feed: str) -> None:
        """New subscribers start at the feed's current tail — they see
        messages posted after the subscription (the recipe's choice)."""
        raw = await tr.get(self.ss.pack(("feedmeta", feed)))
        tr.set(self.ss.pack(("sub", inbox, feed)), raw or b"")

    def unsubscribe(self, tr, inbox: str, feed: str) -> None:
        tr.clear(self.ss.pack(("sub", inbox, feed)))

    async def read_inbox(self, tr, inbox: str,
                         limit: int = 100) -> List[Tuple[str, bytes]]:
        """Drain un-read messages across every subscribed feed, oldest
        first per feed, advancing the watermarks."""
        b, e = self.ss.range(("sub", inbox))
        subs = await tr.get_range(b, e)
        out: List[Tuple[str, bytes]] = []
        for sk, sv in subs:
            feed = self.ss.unpack(sk)[2]
            mark = int.from_bytes(sv or b"", "little")
            fb = self.ss.pack(("feed", feed, mark))
            _b2, fe = self.ss.range(("feed", feed))
            msgs = await tr.get_range(fb, fe, limit=limit - len(out))
            last = mark
            for mk, mv in msgs:
                seq = self.ss.unpack(mk)[2]
                out.append((feed, mv))
                last = seq + 1
            if last != mark:
                tr.set(sk, last.to_bytes(8, "little"))
            if len(out) >= limit:
                break
        return out
