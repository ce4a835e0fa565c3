"""Host utilities: time, id provider, timing registry, sync counters,
program capture (copies of okvis_tpu.utils)."""

from .ids import IdProvider  # noqa: F401
from .time import NSEC_PER_SEC, duration_from_sec, ns_from_sec, sec_from_ns  # noqa: F401
from .timing import Timer, Timing  # noqa: F401
