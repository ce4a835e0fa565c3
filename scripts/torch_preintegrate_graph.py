"""The window's IMU preintegration on the card: the captured graph
(`imu.preintegration.PreintegrationGraph`) against the eager call, and the
graph's use in the benchmark's window.

    python3 scripts/torch_preintegrate_graph.py [--cells c ...] [--seeds n ...] [--seconds s]

Needs a CUDA card. First, at the benchmark's window (K = 8 links of P = 32
samples of a synthetic flight, float32): the device ms of one replay (CUDA
events over back-to-back replays), the host ms of a graph call (copies,
replay, clones) and of an eager call, the device operations the profiler
records for each, and the two bitwise equal; one `graph` JSON line. Then an
untraced run of each cell (vio_bench.harness.run) in a process of its own,
with the Timing counts of `preintegrate`, `preintegrate.capture` and
`preintegrate.replay` over the window (replays over calls is the hit share);
one `window` JSON line a run.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, P = 8, 32


def link_tables(device, dtype, seed=5):
    """preintegrate's padded arguments for K consecutive 0.1 s links."""
    import numpy as np
    import torch

    from okvis_tpu_torch.datasets.synthetic import simulate_trajectory

    traj = simulate_trajectory(duration=0.1 * K + 0.2, seed=seed, motion_scale=0.5)
    ts, gy, ac = np.zeros((K, P)), np.zeros((K, P, 3)), np.zeros((K, P, 3))
    for i in range(K):
        lo, hi = 20 * i, 20 * i + 22
        n = hi - lo
        ts[i, :n], gy[i, :n], ac[i, :n] = traj.ts[lo:hi] - traj.ts[lo], traj.gyro[lo:hi], traj.acc[lo:hi]
        ts[i, n:], gy[i, n:], ac[i, n:] = ts[i, n - 1], gy[i, n - 1], ac[i, n - 1]
    sb = np.zeros((K, 9))
    sb[:, 3:9] = np.random.default_rng(seed).normal(0.0, 0.02, (K, 6))
    t = lambda x: torch.from_numpy(x).to(device=device, dtype=dtype)  # noqa: E731
    return t(ts), t(gy), t(ac), t(np.zeros(K)), t(np.full(K, 0.1)), t(sb)


def graph_line(reps: int = 50) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from okvis_tpu_torch.imu.preintegration import ImuParams, PreintegrationGraph, preintegrate
    from okvis_tpu_torch.utils.profiling import device_operations

    dev = torch.device("cuda")
    params = ImuParams.euroc(torch.float32, dev)
    args = link_tables(dev, torch.float32)
    graphed = PreintegrationGraph(params)
    t0 = time.perf_counter()
    got = graphed(*args)
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    want = preintegrate(params, *args)
    bitwise = all(torch.equal(a, b) for a, b in zip(got, want))

    def host_ms(fn, n=20):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            out.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        return statistics.median(out)

    graph_host = host_ms(lambda: graphed(*args))
    eager_host = host_ms(lambda: preintegrate(params, *args), n=5)
    ((graph, _, _),) = graphed.graphs.values()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    replay_ms = start.elapsed_time(end) / reps

    ops = {}
    for name, fn in (("replay", graph.replay), ("eager", lambda: preintegrate(params, *args))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev_ops = device_operations(prof)
        ops[name] = dict(operations=len(dev_ops), kernel_ms=sum(e - s for _, s, e, *_ in dev_ops) / 1e6)
    return dict(line="graph", device=torch.cuda.get_device_name(0), K=K, P=P, bitwise_equal=bitwise,
                first_call_ms=first_ms, replay_device_ms=replay_ms, graph_call_host_ms=graph_host,
                eager_call_host_ms=eager_host, profiled=ops)


def window_line(cell: str, seed: int, seconds: float) -> dict:
    import torch

    from okvis_tpu_torch.utils.timing import Timing
    from vio_bench import harness

    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    result, _ = harness.run(cell, seed, seconds, False, time.perf_counter(), device="cuda")
    # the untraced window's Timing entries (reset at its start; no frame after it)
    count = lambda name: Timing._timers[name].count if name in Timing._timers else 0  # noqa: E731
    calls, replays = count("preintegrate"), count("preintegrate.replay")
    return dict(line="window", cell=cell, seed=seed, device=torch.cuda.get_device_name(0),
                frames=result["attempted"], correct=result["correct"],
                frames_per_s=result["metrics"]["frames_per_s"]["value"], preintegrate_calls=calls,
                captures=count("preintegrate.capture"), replays=replays,
                hit_share=replays / calls if calls else None,
                preintegrate_ms_per_frame=1e3 * Timing._timers["preintegrate"].total / result["attempted"]
                if calls else None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="*", default=["euroc_stereo.lap", "euroc_mono.lap", "euroc_stereo.spin"])
    ap.add_argument("--seeds", nargs="+", type=int, default=[2147181001])
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--one", nargs=2, metavar=("CELL", "SEED"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.one:
        print(json.dumps(window_line(args.one[0], int(args.one[1]), args.seconds)), flush=True)
        return 0
    print(json.dumps(graph_line()), flush=True)
    for cell in args.cells:
        for seed in args.seeds:
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--seconds", str(args.seconds),
                                  "--one", cell, str(seed)], cwd=ROOT, capture_output=True, text=True)
            if out.returncode != 0:
                print(out.stderr[-3000:], file=sys.stderr)
                return out.returncode
            print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
