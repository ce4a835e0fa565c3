"""Thread-safe bounded queues with the reference's backpressure semantics
(copy of okvis_tpu.pipeline.queues).

The reference's okvis_multisensor_processing threadsafe/ThreadsafeQueue.hpp
:74-347: push_blocking_if_full (backpressure),
push_nonblocking_dropping_if_full (drop-oldest), pop_blocking, shutdown
wakes all blocked threads. Host code only.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Optional


class ShutdownError(Exception):
    pass


class ThreadSafeQueue:
    def __init__(self, maxsize: int = 0):
        self._dq = collections.deque()
        self._maxsize = maxsize
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._shutdown = False

    def push_blocking_if_full(self, item: Any, maxsize: Optional[int] = None) -> bool:
        limit = maxsize if maxsize is not None else self._maxsize
        with self._not_full:
            while limit and len(self._dq) >= limit and not self._shutdown:
                self._not_full.wait(0.1)
            if self._shutdown:
                return False
            self._dq.append(item)
            self._not_empty.notify()
            return True

    def push_nonblocking_dropping_if_full(
        self, item: Any, maxsize: Optional[int] = None
    ) -> bool:
        """Returns True if an old element was dropped."""
        limit = maxsize if maxsize is not None else self._maxsize
        with self._lock:
            dropped = False
            while limit and len(self._dq) >= limit:
                self._dq.popleft()
                dropped = True
            self._dq.append(item)
            self._not_empty.notify()
            return dropped

    def pop_blocking(self, timeout: Optional[float] = None) -> Any:
        with self._not_empty:
            while not self._dq and not self._shutdown:
                if not self._not_empty.wait(timeout=timeout or 0.1) and timeout:
                    raise TimeoutError
            if self._shutdown and not self._dq:
                raise ShutdownError
            item = self._dq.popleft()
            self._not_full.notify()
            return item

    def pop_nonblocking(self) -> Optional[Any]:
        with self._lock:
            if not self._dq:
                return None
            item = self._dq.popleft()
            self._not_full.notify()
            return item

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)
