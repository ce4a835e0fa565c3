"""Process-global monotonically increasing id provider (copy of
okvis_tpu.utils.ids; the reference okvis IdProvider, IdProvider.hpp:50-68)."""

from __future__ import annotations

import itertools
import threading


class IdProvider:
    _counter = itertools.count(1)
    _lock = threading.Lock()

    @classmethod
    def new_id(cls) -> int:
        with cls._lock:
            return next(cls._counter)

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._counter = itertools.count(1)

    @classmethod
    def advance_past(cls, max_seen: int) -> None:
        """Ensure future ids exceed `max_seen` (checkpoint resume: restored
        state/landmark ids must never collide with fresh ones)."""
        with cls._lock:
            nxt = next(cls._counter)
            cls._counter = itertools.count(max(nxt, max_seen + 1))
