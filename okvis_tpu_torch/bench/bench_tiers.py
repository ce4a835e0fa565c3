"""Does optimize time scale with the padded capacity at a fixed active size?
(port of scripts/bench_tiers.py).

One synthetic world (8 states, 100 landmarks), whose active counts fit the
smallest tier, built at each padded capacity (L, O) of TIERS; each tier's
optimize (3 iterations) is timed: wall ms a call (the card waited for) and
the summed kernel ms. The final cost must not depend on the capacity.

    python -m okvis_tpu_torch.bench.bench_tiers [--reps 10] [--device cpu]
"""

from __future__ import annotations

import torch

from . import common

TIERS = ((512, 2048), (256, 1024), (128, 512))
TIER_WINDOW = dict(num_frames=8, frame_stride=20, n_landmarks=100, duration=2.0,
                   cfg_kwargs=dict(max_iterations=3, imu_samples=24, max_imu_links=7))


def tier_window(L: int, O: int, device=None, dtype=torch.float32):
    return common.build_window(device, dtype, TIER_WINDOW, max_landmarks=L, max_observations=O)


def run(reps: int = 10, device=None, dtype=torch.float32, tiers=TIERS, verbose: bool = True) -> dict:
    from ..solver import optimize_window

    dev = common.resolve_device(device)
    rows = []
    for L, O in tiers:
        cfg, imu, intr, problem, _ = tier_window(L, O, dev, dtype)
        opt = lambda: optimize_window(cfg, imu, intr, problem)  # noqa: E731
        _, diag = opt()
        k = common.kernel_ms(opt, dev)
        row = dict(L=L, O=O, active_observations=int(problem.obs.mask.sum()),
                   active_landmarks=int(problem.lm_mask.sum()), wall_ms=common.wall_ms(opt, dev, reps),
                   kernel_ms=None if k is None else k["kernel_ms"], launches=None if k is None else k["launches"],
                   final_cost=float(diag.final_cost))
        rows.append(row)
        if verbose:
            print(f"L={L:4d} O={O:5d} (active obs={row['active_observations']}): {row['wall_ms']:8.3f} ms wall, "
                  f"{row['kernel_ms']} ms kernels, cost {row['final_cost']:.6f}", flush=True)
    full = rows[0]
    costs = [r["final_cost"] for r in rows]
    return dict(metric="capacity_tiers", device=common.device_name(dev), dtype=str(dtype).split(".")[-1], tiers=rows,
                wall_speedup=[full["wall_ms"] / r["wall_ms"] for r in rows],
                kernel_speedup=None if full["kernel_ms"] is None
                else [full["kernel_ms"] / r["kernel_ms"] for r in rows],
                max_cost_rel_diff=max(abs(c - costs[0]) for c in costs) / abs(costs[0]))


def main(argv=None):
    ap = common.parser(__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    common.emit(run(args.reps, args.device), args.out)


if __name__ == "__main__":
    main()
