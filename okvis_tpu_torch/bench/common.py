"""Helpers the bench tools share: the command line's device, the BA windows
they solve, timing with the card waited for, the card's name."""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Callable, Optional

import torch

from ..device import resolve_device

# bench.py:50-62's EuRoC window (8 states, 2 cameras, 512 landmark slots,
# 2048 observation slots, 3 iterations, 24 IMU samples a link, 7 links)
EUROC_WINDOW = dict(num_frames=8, frame_stride=20, n_landmarks=400, duration=2.0,
                    cfg_kwargs=dict(max_landmarks=512, max_observations=2048, max_iterations=3, imu_samples=24,
                                    max_imu_links=7))
# scripts/bench_big_window.py's 4x window (S 32, L 2048, O 16,384, 31 links)
BIG_WINDOW = dict(num_frames=32, frame_stride=20, n_landmarks=1200, duration=4.5,
                  cfg_kwargs=dict(max_landmarks=2048, max_observations=16384, max_iterations=3, imu_samples=24,
                                  max_imu_links=31))


def parser(description: str) -> argparse.ArgumentParser:
    """An argument parser with --device (the card unless "cpu" is given)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    return ap


def build_window(device=None, dtype=torch.float32, spec: dict = EUROC_WINDOW, **overrides):
    """(cfg, imu_params, intrinsics, problem, truth) of a window spec built
    directly on `device` in `dtype`; `overrides` replace entries of its
    cfg_kwargs (e.g. max_iterations)."""
    from ..datasets.synthetic import build_ba_problem

    kw = dict(spec, cfg_kwargs=dict(spec["cfg_kwargs"], **overrides))
    return build_ba_problem(**kw, device=resolve_device(device), dtype=dtype)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def wall_ms(fn: Callable, device, n: int = 20) -> float:
    """Host ms a call over `n` back-to-back calls, the card waited for at the
    end: the dispatch-inclusive time a caller pays."""
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync(device)
    return 1e3 * (time.perf_counter() - t0) / n


def call_ms(fn: Callable, device) -> tuple:
    """(result, host ms) of one call that ends in a wait for the card."""
    sync(device)
    t0 = time.perf_counter()
    res = fn()
    sync(device)
    return res, 1e3 * (time.perf_counter() - t0)


def kernel_ms(fn: Callable, device, reps: int = 3) -> Optional[dict]:
    """The card's summed kernel ms and launches a call over `reps` profiled
    calls (utils.profiling); None off the card."""
    if torch.device(device).type != "cuda":
        return None
    from ..utils.profiling import kernel_ms_per_call

    return kernel_ms_per_call(fn, reps)


def device_name(device) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def card_line() -> Optional[str]:
    """nvidia-smi's name and power limit of the card, or None without it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.detach().reshape(-1).contiguous().view(torch.uint8)


def tree_equal(a, b) -> bool:
    """Bitwise equality of two trees of tensors (None leaves match None)."""
    from torch.utils import _pytree as pytree

    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            if not (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and x.shape == y.shape and torch.equal(_bits(x), _bits(y))):
                return False
        elif x != y:
            return False
    return True


def emit(result: dict, out: Optional[str] = None) -> None:
    """Print the result as one JSON line; also write it to `out` if given."""
    line = json.dumps(result)
    print(line, flush=True)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")
