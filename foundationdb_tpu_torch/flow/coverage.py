"""TEST() coverage macro: marking and counting rare-path hits.

Reference: flow/UnitTest.h `TEST(intro)` — annotates a rarely-taken
code path; every build collects the annotated sites and the coverage
tool (tests in CI) verifies important ones actually fire across
simulation runs, because an untested error path is where bugs live.

Python sites self-declare at import time via ``declare()`` (the
compile-time registration analogue) and mark hits with ``cover()``;
``report()`` yields hit/unhit site sets for the suite-level coverage
assertion (tests/test_coverage.py).
"""

from __future__ import annotations

from typing import Dict, Set

_declared: Set[str] = set()
_hits: Dict[str, int] = {}


def declare(*comments: str) -> None:
    """Register coverage sites (module import time), hit or not."""
    _declared.update(comments)


def cover(comment: str, condition: bool = True) -> bool:
    """TEST() — count a hit when `condition` holds; returns it so the
    macro can wrap an if-expression the way the reference's does."""
    _declared.add(comment)
    if condition:
        _hits[comment] = _hits.get(comment, 0) + 1
    return condition


def hits(comment: str) -> int:
    return _hits.get(comment, 0)


def report() -> dict:
    return {
        "declared": sorted(_declared),
        "hit": {c: n for c, n in sorted(_hits.items())},
        "unhit": sorted(_declared - set(_hits)),
    }


def reset_hits() -> None:
    _hits.clear()


# The framework's annotated rare paths (the compile-time site registry
# the reference's coverage tool extracts from TEST() macros). A site
# added via cover() without a listing here still registers on first
# execution; listing it keeps it visible in report()["unhit"] for runs
# that never take the path.
declare(
    "proxy.commit.conflict",
    "proxy.commit.too_old",
    "proxy.commit.report_conflicting",
    "resolver.reply_cache.hit",
    "resolver.reply_cache.aged_out",
    "resolver.batch.rejected",
    "tlog.commit.stopped",
    "storage.rollback",
    "diskqueue.torn_tail_dropped",
    "client.retry.conflict",
    "client.refresh_stale_picture",
    "cc.epoch_failed",
)
