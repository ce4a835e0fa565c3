"""Timestamps as int64 nanoseconds (copy of okvis_tpu.utils.time).

The reference's ROS-style {sec, nsec} Time/Duration classes
(okvis_time Time.hpp:126-204, Duration.hpp:82-142) become one int64
nanosecond count: it keeps the exact ordering and arithmetic the
synchronizers rely on, vectorizes as numpy arrays of timestamps, and
round-trips EuRoC filename timestamps exactly.
"""

from __future__ import annotations

import numpy as np

NSEC_PER_SEC = 1_000_000_000


def ns_from_sec(sec: float) -> np.int64:
    """Seconds (float) -> int64 ns, rounding to nearest (ref Time::fromSec)."""
    return np.int64(round(float(sec) * NSEC_PER_SEC))


def sec_from_ns(ns) -> float:
    """int64 ns -> float seconds (ref Time::toSec); arrays map elementwise."""
    return np.asarray(ns, dtype=np.int64) / NSEC_PER_SEC if np.ndim(ns) else int(ns) / NSEC_PER_SEC


def duration_from_sec(sec: float) -> np.int64:
    return ns_from_sec(sec)
