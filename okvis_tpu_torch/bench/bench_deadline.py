"""The wall-clock optimization budget, measured (port of scripts/bench_deadline.py).

The reference stops its solver at `timeLimit` once minIterations ran
(CeresIterationCallback). The port's form (solver.optimize_window with
trust0, as the Estimator's deadline loop runs it): the min-iteration solve,
then 1-iteration continuations from the carried damping while the elapsed
time plus the EMA cost of one more chunk fits the budget; the first
prediction is the elapsed time itself. This runs that contract `n_trials`
times on the EuRoC window in float32 and reports the wall latency p50 /
p99 / max, the iterations reached, the overruns, and each program's
kernel ms.

    python -m okvis_tpu_torch.bench.bench_deadline [n_trials] [time_limit_s] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from . import common

MIN_ITERS, MAX_ITERS = 3, 10  # the reference's EuRoC configuration


def deadline_loop(run_min: Callable, run_chunk: Callable, time_limit: float, min_iters: int = MIN_ITERS,
                  max_iters: int = MAX_ITERS, clock: Callable = time.perf_counter) -> tuple:
    """The budget contract (scripts/bench_deadline.py:81-104): `run_min()`
    gives the state after min_iters iterations, `run_chunk(state)` the
    state one iteration on, each returning once its result is on the host.
    Returns (state, iterations, elapsed seconds by `clock`)."""
    t0 = clock()
    state = run_min()
    iters, chunk_cost = min_iters, None
    while iters < max_iters:
        elapsed = clock() - t0
        predicted = chunk_cost if chunk_cost is not None else elapsed
        if elapsed + predicted > time_limit:
            break
        tc = clock()
        state = run_chunk(state)
        dt = clock() - tc
        chunk_cost = dt if chunk_cost is None else 0.5 * chunk_cost + 0.5 * dt
        iters += 1
    return state, iters, clock() - t0


def programs(cfg, imu, intr, problem):
    """(run_min, run_chunk) of the contract on a window: each call reads its
    final cost to the host (one sync), as the Estimator's loop does."""
    from ..solver import optimize_window

    cfg_min = dataclasses.replace(cfg, max_iterations=MIN_ITERS)
    cfg1 = dataclasses.replace(cfg, max_iterations=1)

    def run_min():
        states, diag = optimize_window(cfg_min, imu, intr, problem)
        diag.final_cost.cpu()
        return states, diag

    def run_chunk(state):
        states, diag = state
        states, diag = optimize_window(cfg1, imu, intr, problem._replace(states=states), trust0=diag.final_lambda)
        diag.final_cost.cpu()
        return states, diag

    return run_min, run_chunk


def run(n_trials: int = 100, time_limit: float = 0.035, device=None, dtype=torch.float32,
        verbose: bool = True) -> dict:
    dev = common.resolve_device(device)
    cfg, imu, intr, problem, _ = common.build_window(dev, dtype, max_iterations=MIN_ITERS)
    run_min, run_chunk = programs(cfg, imu, intr, problem)
    state = run_chunk(run_min())  # warm-up
    k_min = common.kernel_ms(run_min, dev)
    k_1 = common.kernel_ms(lambda: run_chunk(state), dev)
    wall_min = common.wall_ms(run_min, dev, 5)
    wall_1 = common.wall_ms(lambda: run_chunk(state), dev, 5)
    lat, iters = [], []
    for _ in range(n_trials):
        _, n, elapsed = deadline_loop(run_min, run_chunk, time_limit)
        lat.append(elapsed)
        iters.append(n)
    lat = np.asarray(lat)
    out = dict(metric="deadline_contract", device=common.device_name(dev), trials=n_trials,
               budget_ms=1e3 * time_limit, min_iterations=MIN_ITERS, max_iterations=MAX_ITERS,
               p50_ms=1e3 * float(np.percentile(lat, 50)), p99_ms=1e3 * float(np.percentile(lat, 99)),
               max_ms=1e3 * float(lat.max()), iterations_mean=float(np.mean(iters)), iterations_min=min(iters),
               iterations_max=max(iters), overruns=int((lat > time_limit).sum()),
               min_program_wall_ms=wall_min, chunk_wall_ms=wall_1,
               min_program_kernel_ms=None if k_min is None else k_min["kernel_ms"],
               chunk_kernel_ms=None if k_1 is None else k_1["kernel_ms"])
    if k_min is not None:
        # the iterations that would fit if a call cost only its kernels
        out["kernel_only_projection_iterations"] = MIN_ITERS + max(
            0, int((1e3 * time_limit - k_min["kernel_ms"]) // k_1["kernel_ms"]))
    if verbose:
        print(f"deadline contract ({n_trials} trials, budget {1e3 * time_limit:.0f} ms, iters "
              f"{MIN_ITERS}..{MAX_ITERS}): p50 {out['p50_ms']:.1f} ms, p99 {out['p99_ms']:.1f} ms, max "
              f"{out['max_ms']:.1f} ms; iterations mean {out['iterations_mean']:.1f}; over budget "
              f"{out['overruns']}/{n_trials}; min program {wall_min:.2f} ms wall ({out['min_program_kernel_ms']} "
              f"ms kernels), chunk {wall_1:.2f} ms wall ({out['chunk_kernel_ms']} ms kernels)", flush=True)
    return out


def main(argv=None):
    ap = common.parser(__doc__.splitlines()[0])
    ap.add_argument("n_trials", nargs="?", type=int, default=100)
    ap.add_argument("time_limit", nargs="?", type=float, default=0.035)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    common.emit(run(args.n_trials, args.time_limit, args.device), args.out)


if __name__ == "__main__":
    main()
