"""Blocking host↔device sync-point accounting.

Copy of okvis_tpu.utils.syncstats. Each blocking device-to-host fetch is a
round trip that gates pipeline latency, so the per-frame budget is a small
integer of them. Every known blocking site in the hot path runs its fetch
inside ``with sync(tag):``, which bumps the tag's counter, adds the wait to
the Timer ``sync.<tag>`` and, in a traced pipeline frame (utils.timing),
records a ``sync.<tag>`` span around it; bench and profiling code reads
snapshot() deltas to count the syncs a frame makes.
"""

from __future__ import annotations

import threading
from collections import Counter

from .timing import Timer

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


class sync(Timer):
    """``with sync("optimize_fetch"): host = x.cpu()``: one blocking fetch
    (or `n`), counted under `tag` as bump does, timed as the Timer
    ``sync.<tag>`` (its Timing total is the host's wait on the card), and a
    span of the current traced frame (with its `n` when more than one)."""

    def __init__(self, tag: str, n: int = 1):
        super().__init__("sync." + tag, start=False)
        self.tag, self.n = tag, n

    def __enter__(self) -> "sync":
        bump(self.tag, self.n)
        super().__enter__()
        if self.n != 1 and self._span is not None:
            self._span.attrs = {"n": self.n}
        return self
