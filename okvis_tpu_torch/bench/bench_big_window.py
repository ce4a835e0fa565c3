"""The EuRoC window and a window 4x its size (port of scripts/bench_big_window.py).

euroc: S 8, L 512, O 2048, 7 links; big: S 32, L 2048, O 16,384, 31 links
(1,200 landmarks over 4.5 s). Each built on the device in float32 and
optimized (3 LM iterations): the first call's ms, wall ms a call over
`reps`, summed kernel ms a call, and the costs before and after.

    python -m okvis_tpu_torch.bench.bench_big_window [--windows euroc big] [--reps 20] [--device cpu]
"""

from __future__ import annotations

import time

import torch

from . import common

WINDOWS = {"euroc": common.EUROC_WINDOW, "big": common.BIG_WINDOW}


def run(windows=("euroc", "big"), reps: int = 20, device=None, dtype=torch.float32, verbose: bool = True) -> dict:
    from ..solver import evaluate, optimize_window

    dev = common.resolve_device(device)
    rows = {}
    for name in windows:
        t0 = time.perf_counter()
        cfg, imu, intr, problem, _ = common.build_window(dev, dtype, WINDOWS[name])
        build_s = time.perf_counter() - t0
        opt = lambda: optimize_window(cfg, imu, intr, problem)  # noqa: E731
        (_, diag), first_ms = common.call_ms(opt, dev)
        k = common.kernel_ms(opt, dev, 1)
        rows[name] = dict(S=cfg.num_states, L=cfg.max_landmarks, O=cfg.max_observations, D=cfg.dense_dim,
                          links=cfg.max_imu_links, observations=int(problem.obs.mask.sum()), build_s=build_s,
                          first_call_ms=first_ms, ms_per_optimize=common.wall_ms(opt, dev, reps),
                          kernel_ms=None if k is None else k["kernel_ms"],
                          launches=None if k is None else k["launches"],
                          initial_cost=float(evaluate(cfg, imu, intr, problem, problem.states).cost),
                          final_cost=float(diag.final_cost))
        if verbose:
            r = rows[name]
            print(f"{name} (S={r['S']}, L={r['L']}, O={r['O']}, D={r['D']}): {r['ms_per_optimize']:8.2f} ms/optimize, "
                  f"kernels {r['kernel_ms']} ms, cost {r['initial_cost']:.1f} -> {r['final_cost']:.1f}", flush=True)
    return dict(metric="big_window", device=common.device_name(dev), dtype=str(dtype).split(".")[-1], windows=rows)


def main(argv=None):
    ap = common.parser(__doc__.splitlines()[0])
    ap.add_argument("--windows", nargs="+", choices=list(WINDOWS), default=list(WINDOWS))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    common.emit(run(args.windows, args.reps, args.device), args.out)


if __name__ == "__main__":
    main()
