"""The window solve on the card: the captured graph
(`solver.optimize.OptimizeGraph`) against the eager `optimize_window` at each
capacity tier, and the graph's use in the benchmark's window.

    python3 scripts/torch_optimize_graph.py [--cells c ...] [--seeds n ...] [--seconds s] [--trace 0|1]

Needs a CUDA card. First, at the benchmark's window (5 keyframes + 3 frames
+ the new one, both cameras, L = 512, O = 2048, 10 LM iterations, float32),
on the problems of an 8-frame synthetic flight whose solves pass through the
three capacity tiers, for each tier: the host ms of a key's first call
(eager, on the capture stream) and second (the capture and a replay), each
up to the card's end, of a graph call (copies, replay, clones)
and of an eager call, each up to its return (the enqueue) and up to the
card's end; the device ms of one replay (CUDA events over back-to-back
replays); the device operations the profiler records in a replay and in an
eager call; and the two bitwise equal. One `tier` JSON line each. Then a run
of each cell (vio_bench.harness.run, traced with --trace 1) in a process of
its own, with the Timing counts of `3.1 optimization`, `optimize.capture`
and `optimize.replay` over the window (replays over optimizations is the
graph's engagement share), the frames, `correct`, `ate_m`, and the run's
metrics; one `window` JSON line a run.
"""

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tier_problems(device) -> tuple:
    """The Estimator on the card over an 8-frame synthetic flight (700
    landmarks, 3-8 m), and the last problem its optimize built in each
    capacity tier: {(L, O): (graph, problem)}."""
    import torch

    from okvis_tpu_torch.cameras.ncamera import NCameraSystem
    from okvis_tpu_torch.datasets.synthetic import (
        estimator_scenario, euroc_stereo_rig, feed_estimator_frame, make_landmarks, simulate_trajectory)
    from okvis_tpu_torch.estimator import Estimator
    from okvis_tpu_torch.imu.preintegration import ImuParams
    from okvis_tpu_torch.utils import capture

    def rig(dev):
        specs, T_SC, intr = euroc_stereo_rig(device=dev)
        return NCameraSystem(specs=specs, T_SC=T_SC, intrinsics=intr)

    traj = simulate_trajectory(duration=1.2, seed=13, motion_scale=0.5)
    frames, init = estimator_scenario(traj, make_landmarks(traj, 700, seed=14, radius=(3.0, 8.0)), rig("cpu"), 8,
                                      seed=13)
    est = Estimator(rig(device), ImuParams.euroc(torch.float32, device), dtype=torch.float32, device=device)
    found = {}
    capture.reset()
    capture.enabled = True
    try:
        for f in frames:
            feed_estimator_frame(est, f, init)
            est.optimize()
            fn, (problem,), _ = capture.programs()["optimize"]
            found[(fn.cfg.max_landmarks, fn.cfg.max_observations)] = (fn, problem)
    finally:
        capture.enabled = False
        capture.reset()
    return est, found


def tier_line(est, LO, graphed, problem, reps: int = 20) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from okvis_tpu_torch.solver import OptimizeGraph, optimize_window
    from okvis_tpu_torch.utils.profiling import device_operations

    eager = functools.partial(optimize_window, graphed.cfg, est.imu_params, est.intrinsics)
    fresh = OptimizeGraph(graphed.cfg, est.imu_params, est.intrinsics)
    first_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh(problem)
        torch.cuda.synchronize()
        first_ms.append(1e3 * (time.perf_counter() - t0))

    got, want = graphed(problem), eager(problem)
    bitwise = all((a is None and b is None) or torch.equal(a, b)
                  for g, w in zip(got, want) for a, b in zip(g, w))

    def host_ms(fn, n):
        """Medians of the ms to fn's return and to the card's end."""
        enq, done = [], []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            enq.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
            done.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(enq), statistics.median(done)

    graph_enq, graph_done = host_ms(lambda: graphed(problem), reps)
    eager_enq, eager_done = host_ms(lambda: eager(problem), 5)
    ((graph, *_),) = graphed.graphs.values()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    replay_ms = start.elapsed_time(end) / reps

    ops = {}
    for name, fn in (("replay", graph.replay), ("eager", lambda: eager(problem))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev_ops = device_operations(prof)
        ops[name] = dict(operations=len(dev_ops), kernel_ms=sum(e - s for _, s, e, *_ in dev_ops) / 1e6)
    return dict(line="tier", device=torch.cuda.get_device_name(0), L=LO[0], O=LO[1],
                iterations=graphed.cfg.max_iterations, live_landmarks=int(problem.lm_mask.sum()),
                live_observations=int(problem.obs.mask.sum()), bitwise_equal=bitwise, first_call_ms=first_ms[0],
                capture_call_ms=first_ms[1],
                graph_call_host_ms=graph_enq, graph_call_done_ms=graph_done, eager_call_host_ms=eager_enq,
                eager_call_done_ms=eager_done, replay_device_ms=replay_ms, profiled=ops)


def window_line(cell: str, seed: int, seconds: float, traced: bool) -> dict:
    # as vio_bench.run: one thread for the host's numpy and torch ops, set
    # before torch is loaded (its OpenMP pool reads it then)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    import torch

    from okvis_tpu_torch.utils.timing import Timing
    from vio_bench import harness

    result, _ = harness.run(cell, seed, seconds, traced, time.perf_counter(), device="cuda")
    # the window's Timing entries (reset at its start; a traced run's
    # profiled frames after it count too)
    count = lambda name: Timing._timers[name].count if name in Timing._timers else 0  # noqa: E731
    calls, replays = count("3.1 optimization"), count("optimize.replay")
    return dict(line="window", cell=cell, seed=seed, traced=traced, device=torch.cuda.get_device_name(0),
                frames=result["attempted"], correct=result["correct"],
                ate_m=result["checks"].get("ate_m", {}).get("value"), optimizations=calls,
                captures=count("optimize.capture"), replays=replays,
                engagement_share=replays / calls if calls else None,
                metrics={k: v["value"] for k, v in result["metrics"].items()},
                memory_peak_bytes=result["device"]["memory_peak_bytes"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="*", default=["euroc_stereo.lap", "euroc_mono.lap", "euroc_stereo.spin",
                                                   "euroc_stereo_loop.revisit"])
    ap.add_argument("--seeds", nargs="+", type=int, default=[2147181001])
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--one", nargs=2, metavar=("CELL", "SEED"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.one:
        print(json.dumps(window_line(args.one[0], int(args.one[1]), args.seconds, bool(args.trace))), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_optimize_graph: needs a CUDA card", file=sys.stderr)
        return 2
    est, found = tier_problems(torch.device("cuda"))
    for LO, (graphed, problem) in sorted(found.items()):
        print(json.dumps(tier_line(est, LO, graphed, problem)), flush=True)
    for cell in args.cells:
        for seed in args.seeds:
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--seconds", str(args.seconds),
                                  "--trace", str(args.trace), "--one", cell, str(seed)], cwd=ROOT,
                                 capture_output=True, text=True)
            if out.returncode != 0:
                print(out.stderr[-3000:], file=sys.stderr)
                return out.returncode
            print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
