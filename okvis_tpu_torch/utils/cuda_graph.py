"""Recording a function of tensors on the card as one CUDA graph.

The captured forms of the per-frame programs (the preintegration's
PreintegrationGraph, the window solve's OptimizeGraph) run their eager
function on the capture stream once per input shape (`run`, the warm-up),
record it there (`record`) and replay it after.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

# one capture stream per device, shared by every recording, so that the
# cuBLAS workspace of a stream is made once
_streams: Dict[torch.device, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    side = _streams.get(device)
    if side is None:
        side = _streams[device] = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    return side


def run(fn: Callable, *args, device: torch.device) -> Any:
    """``fn(*args)`` run eagerly on `device`'s capture stream, after the
    work the current stream holds and before the work it is given next.
    It is the warm-up `record` needs: the kernels for these shapes are
    loaded and the handles and workspaces the function uses exist."""
    side = _capture_stream(device)
    with torch.cuda.stream(side):
        out = fn(*args)
    torch.cuda.current_stream(device).wait_stream(side)
    return out


def record(fn: Callable, *args, device: torch.device) -> Tuple[torch.cuda.CUDAGraph, Any]:
    """Record ``fn(*args)`` as a CUDA graph on `device`'s capture stream,
    where `run` has run it on the same shapes: (graph, outputs). The capture
    is thread-local: the caller's other threads may keep launching
    meanwhile. `args` are the graph's static inputs and the returned outputs
    its static outputs: a replay reads the former and overwrites the latter
    in place."""
    side = _capture_stream(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
        out = fn(*args)
    torch.cuda.current_stream(device).wait_stream(side)
    return graph, out
