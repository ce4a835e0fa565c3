"""Host utilities: id provider, timing registry, sync counters, program
capture (copies of okvis_tpu.utils)."""

from .ids import IdProvider  # noqa: F401
from .timing import Timer, Timing  # noqa: F401
