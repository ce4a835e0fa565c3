"""The card's kernels under torch.profiler, read from the raw trace events.

prof.events() and key_averages() read the same numbers but first build an
event object for every trace event: 30-90 s of host time for a profiled
window of a few estimator frames (~40,000 launches a frame;
scripts/torch_profiler_cost.py). The raw events give the launches and the
summed kernel time in a second or two. chip_smoke.py and the bench tools
(okvis_tpu_torch.bench) share these readers.
"""

from __future__ import annotations

from typing import Callable


def device_kernels(prof) -> tuple:
    """(launches, summed device ms) of the kernels a finished torch.profiler
    run traced, read from its raw trace events."""
    import torch

    kern = [e for e in prof.profiler.kineto_results.events() if e.device_type() == torch.autograd.DeviceType.CUDA]
    return len(kern), sum(e.duration_ns() for e in kern) / 1e6


def profile_summary(prof, frames: int, wall_ms: float) -> dict:
    """A profiled window's device busy share and launches a frame."""
    launches, kernel_ms = device_kernels(prof)
    return dict(frames=frames, wall_ms=wall_ms, kernel_ms=kernel_ms, device_busy_share=kernel_ms / wall_ms,
                launches_per_frame=launches / frames)


def profile_call(fn: Callable, top: int = 0) -> dict:
    """One call under torch.profiler on the card: its device kernels' summed
    time, their launches, and the `top` kernels by device time (the only
    reader here that builds key_averages(); keep `top` to short calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches, kernel_ms = device_kernels(prof)
    out = dict(kernel_ms=kernel_ms, launches=launches)
    if top:
        kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        kernels.sort(key=lambda e: -e.self_device_time_total)
        out["top"] = [dict(kernel=e.key[:80], device_ms=e.self_device_time_total / 1e3, calls=e.count)
                      for e in kernels[:top]]
    return out


def kernel_ms_per_call(fn: Callable, reps: int = 3) -> dict:
    """`reps` back-to-back calls of `fn` under the profiler: the summed
    kernel time and the launches of one call (their means)."""
    res = profile_call(lambda: [fn() for _ in range(reps)])
    return dict(kernel_ms=res["kernel_ms"] / reps, launches=res["launches"] / reps)
