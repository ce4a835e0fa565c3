"""Steady-state program capture for device-time benchmarking (copy of
okvis_tpu.utils.capture).

When `enabled` (bench harnesses only; no cost otherwise), each big per-frame
launch records its latest (callable, args, kwargs) here: torch callables and
tensors on the card. A harness replays them after the run to measure device
time per frame without the host's bookkeeping.

Capture sites (tag -> program):
  propagate    add_states' IMU propagation to the new state
  optimize     the full window solve (LM/dogleg + Schur)
  marginalize  the FEJ marginalization step

No captured program writes into its inputs, so replaying captured arguments
is safe; the registry keeps the captured tensors alive.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Tuple

enabled = False

_lock = threading.Lock()
_programs: Dict[str, Tuple[Callable, tuple, dict]] = {}


def record(tag: str, fn: Callable, *args: Any, **kwargs: Any) -> None:
    """Stash the latest invocation of a tagged program (bench mode only)."""
    if not enabled:
        return
    with _lock:
        _programs[tag] = (fn, args, kwargs)


def programs() -> Dict[str, Tuple[Callable, tuple, dict]]:
    with _lock:
        return dict(_programs)


def reset() -> None:
    with _lock:
        _programs.clear()
