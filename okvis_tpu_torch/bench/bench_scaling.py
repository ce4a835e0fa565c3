"""Sharded BA step time against the shard count (port of bench_scaling.py).

The sharded optimize step (parallel.make_sharded_optimizer) on the EuRoC
window (L 512, O 2048, divisible by 1, 2, 4 and 8, so the same problem at
every count), its landmark slots laid out round robin over the shards as
Estimator.enable_distributed hands them out (so shard_problem sheds
nothing). Each shard count's mesh repeats the one device: the card stands
for n devices, and the shards run as one batch, so this measures the
sharded arithmetic's cost, not the speed of several cards.

Prints one JSON line: {"metric": "sharded_ba_scaling", "platform", "device",
"points": [...]}.

    python -m okvis_tpu_torch.bench.bench_scaling [--counts 1 2 4 8] [--n-iter 20] [--device cpu]
"""

from __future__ import annotations

import time

import torch

from . import common


def round_robin_slots(problem, n: int):
    """The window with its landmark slots laid out round robin over n shard
    blocks (old slot k to new slot rr[k]), as Estimator.enable_distributed
    hands slots out: the same problem under another slot numbering.
    Returns (problem, rr)."""
    L = problem.lm_mask.shape[0]
    Ls = L // n
    rr = torch.tensor([b * Ls + i for i in range(Ls) for b in range(n)], device=problem.lm_mask.device)
    st = problem.states
    hp, lm = torch.empty_like(st.hp_W), torch.empty_like(problem.lm_mask)
    hp[rr], lm[rr] = st.hp_W, problem.lm_mask
    obs = problem.obs._replace(lm_idx=rr[problem.obs.lm_idx.long()].to(problem.obs.lm_idx.dtype))
    return problem._replace(states=st._replace(hp_W=hp), lm_mask=lm, obs=obs), rr


def measure(n_devices: int, n_iter: int = 20, device=None, dtype=torch.float32, window=None, mesh=None,
            axis="map") -> float:
    """Seconds a sharded step over `n_iter` back-to-back calls after one
    warm-up call. `window` is (cfg, imu, intrinsics, problem) (default: the
    EuRoC window on `device` in `dtype`); `mesh` defaults to n_devices
    shards on that device."""
    from ..parallel import make_mesh, make_sharded_optimizer, shard_problem

    dev = common.resolve_device(device)
    cfg, imu, intr, problem = window[:4] if window is not None else common.build_window(dev, dtype)[:4]
    mesh = mesh if mesh is not None else make_mesh(devices=[dev] * n_devices)
    opt = make_sharded_optimizer(cfg, imu, intr, mesh, axis)
    sharded = shard_problem(round_robin_slots(problem, mesh.size)[0], mesh.size)
    opt(sharded)
    common.sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_iter):
        opt(sharded)
    common.sync(dev)
    return (time.perf_counter() - t0) / n_iter


def run(counts=(1, 2, 4, 8), n_iter: int = 20, device=None, dtype=torch.float32) -> dict:
    dev = common.resolve_device(device)
    window = common.build_window(dev, dtype)
    points, t1 = [], None
    for n in counts:
        dt = measure(n, n_iter, dev, window=window)
        t1 = t1 if t1 is not None else dt
        points.append(dict(devices=n, step_ms=1e3 * dt, speedup=t1 / dt, efficiency_vs_1dev=t1 / dt))
    return dict(metric="sharded_ba_scaling", platform="gpu" if dev.type == "cuda" else "cpu",
                device=common.device_name(dev), mesh="one device repeated", dtype=str(dtype).split(".")[-1],
                points=points)


def main(argv=None):
    ap = common.parser(__doc__.splitlines()[0])
    ap.add_argument("--counts", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--n-iter", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    common.emit(run(args.counts, args.n_iter, args.device), args.out)


if __name__ == "__main__":
    main()
