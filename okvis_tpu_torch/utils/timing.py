"""Hierarchical named-timer registry.

Copy of okvis_tpu.utils.timing, the reference profiler's behavior
(okvis_timing Timer.hpp:70-178): a global registry of named timers with
mean/min/max/stddev and a rolling mean over the last 50 samples, printed as a
table at shutdown. Device-side time is measured by synchronising on the
result (CUDA launches are asynchronous); use `torch.profiler` for kernel
traces.
"""

from __future__ import annotations

import math
import os
import threading
import time as _time
from collections import deque
from typing import Dict, Optional


class _Accumulator:
    __slots__ = ("count", "total", "min", "max", "m2", "mean", "window")

    def __init__(self, window_size: int = 50):
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.mean = 0.0
        self.m2 = 0.0  # Welford
        self.window = deque(maxlen=window_size)

    def add(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        d = v - self.mean
        self.mean += d / self.count
        self.m2 += d * (v - self.mean)
        self.window.append(v)

    @property
    def std(self) -> float:
        return math.sqrt(self.m2 / self.count) if self.count > 1 else 0.0

    @property
    def rolling_mean(self) -> float:
        return sum(self.window) / len(self.window) if self.window else 0.0


class Timing:
    """Process-global registry (ref okvis::timing::Timing singleton).

    Disable with OKVIS_TPU_DEACTIVATE_TIMERS=1 (ref compile-time
    DEACTIVATE_TIMERS switch -> DummyTimer)."""

    _lock = threading.Lock()
    _timers: Dict[str, _Accumulator] = {}
    enabled = os.environ.get("OKVIS_TPU_DEACTIVATE_TIMERS", "0") != "1"

    @classmethod
    def add(cls, name: str, seconds: float) -> None:
        if not cls.enabled:
            return
        with cls._lock:
            acc = cls._timers.get(name)
            if acc is None:
                acc = cls._timers[name] = _Accumulator()
            acc.add(seconds)

    @classmethod
    def mean(cls, name: str) -> float:
        return cls._timers[name].mean

    @classmethod
    def total(cls, name: str) -> float:
        return cls._timers[name].total

    @classmethod
    def count(cls, name: str) -> int:
        return cls._timers[name].count

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._timers.clear()

    @classmethod
    def print(cls) -> str:
        """Shutdown table (ref Timing::print): name, count, total, mean(std), min/max, rolling."""
        lines = ["{:<42s} {:>7s} {:>10s} {:>18s} {:>21s} {:>10s}".format(
            "timer", "count", "total[s]", "mean(std)[s]", "[min,max][s]", "roll50[s]")]
        with cls._lock:
            for name in sorted(cls._timers):
                a = cls._timers[name]
                lines.append(
                    "{:<42s} {:>7d} {:>10.4f} {:>10.6f}({:.6f}) [{:>9.6f},{:>9.6f}] {:>10.6f}".format(
                        name, a.count, a.total, a.mean, a.std, a.min, a.max, a.rolling_mean
                    )
                )
        table = "\n".join(lines)
        return table


class Timer:
    """Context-manager timer: ``with Timer("2.4 matching"): ...``.

    Matches the reference's construct/stop usage; also usable via explicit
    start()/stop().
    """

    def __init__(self, name: str, start: bool = True):
        self.name = name
        self._t0: Optional[float] = None
        if start:
            self.start()

    def start(self) -> None:
        self._t0 = _time.perf_counter()

    def stop(self) -> float:
        if self._t0 is None:
            return 0.0
        dt = _time.perf_counter() - self._t0
        self._t0 = None
        Timing.add(self.name, dt)
        return dt

    def __enter__(self) -> "Timer":
        if self._t0 is None:
            self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
