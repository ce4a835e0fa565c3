"""Worker of the two-process sharded BA of okvis_tpu_torch (the port's
counterpart of tests/multiproc_worker.py).

Each OS process joins a torch.distributed group over TCP on localhost with
the gloo backend and holds one row of a ("host", "map") mesh of
n_proc x devices_per_host shards: the map axis is summed inside the
process, the host axis crosses the processes through all_reduce. The
sharded solve must equal the single-device solve (optimize_window) to
1e-8.

    python tests/torch_multiproc_worker.py <rank> <n_proc> <port> [device] [devices_per_host]

`device` is "cpu" (default) or "cuda": the shards then sit on cuda:0,
all of them (gloo takes CUDA tensors; NCCL refuses two ranks on one card).
Prints "MULTIPROC_OK cost=<c> step_ms=<t> max_dr=<d>" on success (rank 0).
"""

import os
import sys
import time


def main() -> None:
    rank, n_proc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    device = sys.argv[4] if len(sys.argv) > 4 else "cpu"
    per_host = int(sys.argv[5]) if len(sys.argv) > 5 else 2

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    from okvis_tpu_torch.datasets.synthetic import build_ba_problem
    from okvis_tpu_torch.parallel import make_mesh2d, make_sharded_optimizer, shard_problem
    from okvis_tpu_torch.solver import optimize_window

    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=n_proc,
                                         rank=rank)
    try:
        cfg, imu, intr, problem, _truth = build_ba_problem(
            num_frames=6, frame_stride=20, n_landmarks=48, duration=1.5, device=device,
            cfg_kwargs=dict(max_landmarks=64, max_observations=256, max_iterations=4, imu_samples=24,
                            max_imu_links=5))
        ref_states, ref_diag = optimize_window(cfg, imu, intr, problem)
        ref_cost, ref_r = float(ref_diag.final_cost), ref_states.r_WS.cpu().numpy()

        mesh = make_mesh2d(n_proc, per_host, devices=[device] * per_host)
        opt = make_sharded_optimizer(cfg, imu, intr, mesh, axis=("host", "map"))
        local = shard_problem(problem, n_proc * per_host)
        states, (cost, _hist, _acc, _lam) = opt(local)
        n_rep = 3
        t0 = time.perf_counter()
        for _ in range(n_rep):
            states, (cost, _hist, _acc, _lam) = opt(local)
        float(cost)
        step_ms = (time.perf_counter() - t0) / n_rep * 1e3

        cost_v, r_WS = float(cost), states.r_WS.cpu().numpy()
        assert abs(cost_v - ref_cost) <= 1e-8 * max(1.0, abs(ref_cost)), (
            f"sharded cost {cost_v} != single-device {ref_cost}")
        np.testing.assert_allclose(r_WS, ref_r, rtol=0, atol=1e-8)
        if rank == 0:
            print(f"MULTIPROC_OK cost={cost_v:.9f} step_ms={step_ms:.1f} "
                  f"max_dr={float(np.abs(r_WS - ref_r).max()):.3e}", flush=True)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
