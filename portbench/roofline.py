"""The least bytes a resolve step moves, and the card's peaks.

A step reads the live history once and writes the history it leaves
once, reads the batch's feed and writes the verdict flags. A history
row is a key (W words and a length word) and its version (one int32).
The feed is what the batch holds, unpadded: each transaction's snapshot
(int32) and too-old flag (a byte), each range's begin and end rows and
transaction id (int32), the commit and oldest versions. Nothing of a
buffer's capacity or of padding is counted, so the count is the same
whatever implements the step."""

from __future__ import annotations

import json
import os

PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "peaks.json")


def step_bytes(rows_before: int, rows_after: int, n_txns: int,
               n_reads: int, n_writes: int, key_words: int) -> int:
    key = 4 * (key_words + 1)
    row = key + 4
    feed = (n_txns * (4 + 1) + (n_reads + n_writes) * (2 * key + 4) + 8)
    return row * (rows_before + rows_after) + feed + n_txns


def peaks(device_kind: str):
    """The card's row of peaks.json, or None for a card it lacks."""
    with open(PEAKS) as f:
        return json.load(f).get(device_kind)
