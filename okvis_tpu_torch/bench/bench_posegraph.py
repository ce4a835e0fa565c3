"""Pose-graph layer bench (port of scripts/bench_posegraph.py): the SE(3)
pose-graph solve and keyframe retrieval on the card.

The drifting circle (datasets.synthetic.circle_pose_graph: odometry drift
and one loop edge) at each node count, solved by PCG and by the dense
Cholesky path through PoseGraph.optimize (8 LM iterations, 60 PCG
iterations), ms a solve over `reps` repeats after a first call; then a
frames x 400-keypoint KeyframeDatabase of random descriptors (numpy seed
0) queried with a random 400-keypoint frame: ms a query. The query runs
the Hamming kernel once at (400, frames * 400).

    python -m okvis_tpu_torch.bench.bench_posegraph [--nodes 256 1024] [--frames 1024] [--reps 10] [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np

from . import common


def pgo_bench(n: int, solver: str, reps: int = 10, device=None, max_iterations: int = 8,
              pcg_iters: int = 60) -> dict:
    """One circle of n nodes through PoseGraph.optimize with `solver`, as
    the JAX tool runs it: the first call, then `reps` more on the same graph
    (each writes its poses back)."""
    from ..datasets.synthetic import circle_pose_graph, fill_pose_graph
    from ..posegraph.graph import PoseGraph

    dev = common.resolve_device(device)
    g = fill_pose_graph(PoseGraph(node_capacity=n, edge_capacity=2 * n, device=dev), circle_pose_graph(n))
    kw = dict(max_iterations=max_iterations, pcg_iters=pcg_iters, solver=solver)
    res, first_ms = common.call_ms(lambda: g.optimize(**kw), dev)
    row = dict(nodes=n, solver=solver, max_iterations=max_iterations, pcg_iters=pcg_iters if solver == "pcg" else None,
               first_call_ms=first_ms, initial_cost=float(res.initial_cost), final_cost=float(res.final_cost))
    row["ms"] = common.wall_ms(lambda: g.optimize(**kw), dev, reps)
    k = common.kernel_ms(lambda: g.optimize(**kw), dev, 1)
    row.update(kernel_ms=None if k is None else k["kernel_ms"], launches=None if k is None else k["launches"])
    return row


def database(frames: int = 1024, kp: int = 400, device=None, seed: int = 0):
    """(the database, the query's descriptors and mask): `frames` keyframes of
    `kp` random 512-bit descriptors each, then a random query frame."""
    from ..posegraph.place_recognition import KeyframeDatabase

    rng = np.random.default_rng(seed)
    db = KeyframeDatabase(frame_capacity=frames, kp_capacity=kp, device=common.resolve_device(device))
    brg, lmk, val = np.zeros((kp, 3)), np.zeros((kp, 3)), np.ones(kp, bool)
    for i in range(frames):
        db.insert(i, rng.integers(0, 256, (kp, 64), dtype=np.uint8), np.ones(kp, bool), brg, lmk, val)
    return db, rng.integers(0, 256, (kp, 64), dtype=np.uint8), np.ones(kp, bool)


def query_bench(frames: int = 1024, kp: int = 400, reps: int = 20, device=None) -> dict:
    """ms a query of the database (after one warm-up query) and its answer."""
    dev = common.resolve_device(device)
    t0 = time.perf_counter()
    db, q, m = database(frames, kp, dev)
    build_s = time.perf_counter() - t0
    cand, score, _ = db.query(q, m, exclude_ids=set())
    ms = common.wall_ms(lambda: db.query(q, m, exclude_ids=set()), dev, reps)
    return dict(frames=frames, keypoints=kp, hamming_shape=[kp, frames * kp], ms=ms, build_s=build_s,
                candidate=cand, score=score)


def run(nodes=(256, 1024), solvers=("pcg", "dense"), reps: int = 10, frames: int = 1024, query_reps: int = 20,
        device=None, verbose: bool = True) -> dict:
    dev = common.resolve_device(device)
    rows = []
    for n in nodes:
        for solver in solvers:
            row = pgo_bench(n, solver, reps, dev)
            rows.append(row)
            if verbose:
                print(f"PGO n={n:5d} nodes [{solver:5s}]: {row['ms']:8.2f} ms/solve (first call "
                      f"{row['first_call_ms']:.0f} ms, kernels {row['kernel_ms']} ms)", flush=True)
    q = query_bench(frames, 400, query_reps, dev)
    if verbose:
        print(f"place recognition: 400-kp query vs {frames}-keyframe database: {q['ms']:.2f} ms", flush=True)
    return dict(metric="posegraph_bench", device=common.device_name(dev), pgo=rows, query=q)


def main(argv=None):
    ap = common.parser(__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, nargs="+", default=[256, 1024])
    ap.add_argument("--frames", type=int, default=1024, help="keyframes in the database")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--query-reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    common.emit(run(args.nodes, reps=args.reps, frames=args.frames, query_reps=args.query_reps,
                    device=args.device), args.out)


if __name__ == "__main__":
    main()
