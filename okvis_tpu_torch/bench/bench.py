"""The port's headline bench (port of bench.py).

1. ba_bench: optimize steps a second on bench.py's EuRoC window (8 states,
   2 cameras, 512 landmark slots, 2048 observation slots, 3 LM iterations,
   24 IMU samples a link, 7 links), float32, host wall clock with the card
   waited for at the end of `n_iter` back-to-back calls.
2. The pipeline bench (bench_pipeline) at 35 frames, and the host table of
   that same run (bench_host.host_table).
3. One final JSON line. The headline `value` is the pipeline's steady wall
   frames/s, the rate a user sees; `vs_baseline` is taken against the
   reference's 20 frames/s real-time operating point. The device ceiling
   (device_fps_ceiling: 1000 / the per-frame programs' summed kernel ms) and
   the window's optimize steps/s sit beside it.

    python -m okvis_tpu_torch.bench.bench [--device cpu] [--frames N] [--ba-iters N] [--out PATH]
"""

from __future__ import annotations

import torch

from . import common

BASELINE_FPS = 20.0


def ba_bench(device=None, n_iter: int = 50, dtype=torch.float32, verbose: bool = True) -> dict:
    """Optimize steps a second on the EuRoC window; returns the reading
    (steps/s, ms a step, the first call's costs)."""
    from ..solver import evaluate, optimize_window

    dev = common.resolve_device(device)
    cfg, imu, intr, problem, _ = common.build_window(dev, dtype)
    _, diag = optimize_window(cfg, imu, intr, problem)  # warm-up: allocator, cuBLAS handles
    ms = common.wall_ms(lambda: optimize_window(cfg, imu, intr, problem), dev, n_iter)
    out = dict(steps_per_s=1e3 / ms, ms_per_step=ms, n_iter=n_iter, iterations=cfg.max_iterations,
               initial_cost=float(evaluate(cfg, imu, intr, problem, problem.states).cost),
               cost_history=diag.cost_history.cpu().tolist(), final_cost=float(diag.final_cost),
               window=dict(S=cfg.num_states, L=cfg.max_landmarks, O=cfg.max_observations, K=cfg.max_imu_links))
    if verbose:
        print(f"ba_window_optimize: {out['steps_per_s']:.2f} steps/s ({ms:.2f} ms a step)", flush=True)
    return out


def main(argv=None):
    from .bench_host import host_table, print_table
    from .bench_pipeline import WARMUP, run_pipeline_bench

    ap = common.parser(__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=35)
    ap.add_argument("--ba-iters", type=int, default=50)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = common.resolve_device(args.device)
    pipeline = run_pipeline_bench(args.frames, device=dev, warmup=min(WARMUP, args.frames // 2))
    table = host_table(pipeline)
    print_table(table)
    ba = ba_bench(dev, args.ba_iters)
    value = pipeline["value"]
    common.emit(dict(
        metric="pipeline_frames_per_s", value=value, unit="frames/s", vs_baseline=value / BASELINE_FPS,
        device_fps_ceiling=pipeline["device_fps_ceiling"], device_fps_ceiling_rt=pipeline["device_fps_ceiling_rt"],
        device_ms_per_frame=pipeline["device_ms_per_frame"], device_ms_per_frame_rt=pipeline["device_ms_per_frame_rt"],
        ceiling_note=pipeline["ceiling_note"], ate_m=pipeline["ate_m"], frames=pipeline["frames"],
        frames_fed=pipeline["frames_fed"], blocking_syncs_per_frame=pipeline["blocking_syncs_per_frame"],
        median_frame_ms=pipeline["median_frame_ms"], host_bookkeeping_ms_per_frame=table["bookkeeping_ms_per_frame"],
        ba_optimize_steps_per_s=ba["steps_per_s"], device=pipeline["device"], card=common.card_line()), args.out)


if __name__ == "__main__":
    main()
