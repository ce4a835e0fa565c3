"""Blocking host↔device sync-point accounting.

Copy of okvis_tpu.utils.syncstats. Each blocking device-to-host fetch is a
round trip that gates pipeline latency, so the per-frame budget is a small
integer of them. Every known blocking site in the hot path calls bump(tag);
bench and profiling code reads snapshot() deltas to count the syncs a frame
makes.
"""

from __future__ import annotations

import threading
from collections import Counter

_lock = threading.Lock()
_counts: Counter = Counter()


def bump(tag: str, n: int = 1) -> None:
    with _lock:
        _counts[tag] += n


def snapshot() -> dict:
    with _lock:
        return dict(_counts)


def reset() -> None:
    with _lock:
        _counts.clear()
