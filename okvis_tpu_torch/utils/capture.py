"""Steady-state program capture for device-time benchmarking (copy of
okvis_tpu.utils.capture).

When `enabled` (bench harnesses only; no cost otherwise), each big per-frame
launch records its latest (callable, args, kwargs) here, with the outputs of
that call beside them: torch callables and tensors on the pipeline's device.
A harness replays them after the run to measure device time per frame
without the host's bookkeeping, and holds each replay to the recorded
outputs.

Capture sites (tag -> program), the JAX package's:
  detect       detection + description of all cameras in one batched call
  propagate    add_states' IMU propagation to the new state
  associate    the fused association round (3D-2D gate, rig RANSAC, 2D-2D,
               triangulation, stereo; all sources x cameras)
  optimize     the full window solve (LM/dogleg + Schur)
  marginalize  the FEJ marginalization step

Tensors are recorded as detached clones: the pipeline updates some of its
tensors in place after a call (JAX arrays never change, torch tensors may),
and a replay must see the inputs the captured call saw. No captured program
writes into its inputs.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils import _pytree as pytree

enabled = False

_lock = threading.Lock()
_programs: Dict[str, Tuple[Callable, tuple, dict]] = {}
_outputs: Dict[str, Any] = {}


def _cloned(tree):
    return pytree.tree_map(lambda x: x.detach().clone() if isinstance(x, torch.Tensor) else x, tree)


def record(tag: str, fn: Callable, *args: Any, **kwargs: Any) -> None:
    """Stash the latest invocation of a tagged program (bench mode only)."""
    if not enabled:
        return
    entry = (fn, _cloned(args), _cloned(kwargs))
    with _lock:
        _programs[tag] = entry
        _outputs.pop(tag, None)


def record_output(tag: str, out: Any) -> None:
    """Stash the outputs of the invocation just recorded under `tag`."""
    if not enabled:
        return
    out = _cloned(out)
    with _lock:
        _outputs[tag] = out


def programs() -> Dict[str, Tuple[Callable, tuple, dict]]:
    with _lock:
        return dict(_programs)


def outputs() -> Dict[str, Any]:
    """Each tag's recorded outputs (a tag recorded without them is absent)."""
    with _lock:
        return dict(_outputs)


def reset() -> None:
    with _lock:
        _programs.clear()
        _outputs.clear()
