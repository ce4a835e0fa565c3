"""The readings that the limits of `correct` are set from (not run by the
benchmark's own runs): for a cell, the program's numbers over many seeds,
the control's, and each planted fault's, each seed a short window at the
cell's own size, all in one process.

    python3 -m vio_bench.control --workload <cell> --seeds 11,12,... [--control-seeds 21,22,23]
        [--fault-seeds 31,32,33] [--faults optimize_unchanged] [--seconds 10] [--fault-seconds 51]

The control is the reference put in the program's place one precision
below the configuration's float32: its Harris arithmetic (no matmul) in
bfloat16, its descriptors' blur matmuls in TF32 on the card, judged against
the reference's full float32 keypoints and descriptors by the same
comparison. Where the pose-graph layer runs (in float64), its control is
the reference's solve in float32 put in the program's place: planted like
a fault (`posegraph_solve_float32` in POSEGRAPH_FAULTS), so that the run's
own `correct` judges it. The faults break the timed path underneath the
benchmark's taps (see FAULTS, and POSEGRAPH_FAULTS for a configuration
with the pose-graph layer on). Prints one JSON line a run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from . import check, harness
from .reference import detect, posegraph

MAX_DIST = 10_000


def tf32_describe(img, uv, angle):
    """The reference's descriptors computed on the card with TF32 matmuls."""
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return detect.describe(torch.as_tensor(img, dtype=torch.float32, device="cuda"),
                               torch.as_tensor(uv), angle).numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def control_readings(outputs, stream, config) -> dict:
    """The control's keypoints_unmatched and descriptor_bits_differ over the
    run's sampled frames."""
    det = config["detection_options"]
    unmatched = total = 0
    for n, _, cams in outputs.detections:
        for c in range(len(cams)):
            img = torch.as_tensor(stream.frame_images(n)[c], dtype=torch.float32)[None]
            ref = detect.keypoints(img, det["threshold"], det["maxNoKeypoints"])[0].numpy()
            low = detect.keypoints(img, det["threshold"], det["maxNoKeypoints"], torch.bfloat16)[0].numpy()
            _, miss = check.match_keypoints(low, ref)
            unmatched += miss
            total += len(low) + len(ref)
    _, bits = check.detection_numbers(outputs.detections, stream, config, describe=tf32_describe)
    return {"keypoints_unmatched": unmatched / total if total else None, "descriptor_bits_differ": bits}


def _optimize_unchanged(vio, restore: list):
    """A solve that returns the window as it found it."""
    vio.estimator.optimize = lambda *a, **k: None


class _FrozenTrajectory(list):
    """The published trajectory with every state's pose replaced by the
    first one's."""

    def append(self, state) -> None:
        super().append(state if not self else dataclasses.replace(state, T_WS=self[0].T_WS))


def _pose_frozen(vio, restore: list):
    """A published pose that never moves: every state ThreadedVio publishes
    carries the pose of the first one, while tracking runs on."""
    vio.trajectory = _FrozenTrajectory()


def _patch_module(restore: list, module, name, make):
    """module.name = make(the original); (module, name, original) goes on
    `restore`."""
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    restore.append((module, name, orig))


def _hamming_half_batch(vio, restore: list):
    """Distance matrices of which only the first half of the batch is
    computed; the rest reads as no match."""
    from okvis_tpu_torch.frontend import kernels as fk

    def make(orig):
        def broken(a, b, ma=None, mb=None):
            out = orig(a, b, ma, mb)
            if out.dim() == 3 and out.shape[0] > 1:
                out = out.clone()
                out[out.shape[0] // 2:] = MAX_DIST
            return out
        return broken

    _patch_module(restore, fk, "masked_distance_matrix", make)


def _descriptor_altered(vio, restore: list):
    """Every descriptor's first word inverted where the frontend produces it."""
    from okvis_tpu_torch.frontend import frontend as ff

    def make(orig):
        def broken(*a, **k):
            kps, desc = orig(*a, **k)
            desc = desc.clone()
            desc[..., 0] = ~desc[..., 0]
            return kps, desc
        return broken

    _patch_module(restore, ff, "detect_and_describe_batch", make)


FAULTS = {"optimize_unchanged": _optimize_unchanged, "hamming_half_batch": _hamming_half_batch,
          "descriptor_altered": _descriptor_altered, "pose_frozen": _pose_frozen}


def _retrieval_vote_shifted(vio, restore: list):
    """Keyframe retrieval that counts a vote below a threshold 8 higher
    than the one it is given."""
    from okvis_tpu_torch.posegraph import place_recognition as pr

    def make(orig):
        def broken(desc_q, mask_q, db_desc, db_mask, allowed, vote_threshold=60):
            return orig(desc_q, mask_q, db_desc, db_mask, allowed, vote_threshold=vote_threshold + 8)
        return broken

    _patch_module(restore, pr, "score_against_database", make)


def _loop_edge_altered(restore: list, alter):
    """Every verified loop's relative pose (r, q) replaced by alter(r, q)
    where the verification produces it."""
    from okvis_tpu_torch.posegraph import loop_closure as lc

    def make(orig):
        def broken(*a, **k):
            rel = orig(*a, **k)
            return None if rel is None else alter(*rel)
        return broken

    _patch_module(restore, lc, "relative_pose_from_verification", make)


def _loop_edge_perturbed(vio, restore: list):
    """Every verified loop's relative pose 0.2 m off along the candidate's x."""
    _loop_edge_altered(restore, lambda r, q: (r + np.array([0.2, 0.0, 0.0]), q))


def _loop_edge_turned(vio, restore: list):
    """Every verified loop's relative orientation turned by 2 degrees about
    the candidate's z."""
    from okvis_tpu_torch.kinematics import np_se3

    half = np.radians(2.0) / 2.0
    turn = np.array([0.0, 0.0, np.sin(half), np.cos(half)])
    _loop_edge_altered(restore, lambda r, q: (r, np_se3.quat_multiply(turn, q)))


def _posegraph_solve_skipped(vio, restore: list):
    """A pose-graph solve whose poses are never written back to the graph."""
    from okvis_tpu_torch.posegraph import graph as pg
    from okvis_tpu_torch.posegraph import optimize as pgo

    def make(orig):
        def skipped(self, max_iterations=10, pcg_iters=50, dtype=None, solver="auto"):
            return pgo.optimize_pose_graph(self.to_arrays(dtype), max_iterations=max_iterations,
                                           pcg_iters=pcg_iters, solver=solver)
        return skipped

    _patch_module(restore, pg.PoseGraph, "optimize", make)


def _posegraph_solve_float32(vio, restore: list):
    """The pose graph's control: the reference's solve, in float32, in place
    of the program's, its poses written back to the graph as the program's
    are."""
    from okvis_tpu_torch.posegraph import graph as pg

    def make(orig):
        def low(self, max_iterations=10, pcg_iters=50, dtype=None, solver="auto"):
            r, q = posegraph.solve(**{name: getattr(self, name) for name in harness.GRAPH_ARRAYS},
                                   max_iterations=max_iterations, dtype=torch.float32)
            occ = self.node_mask
            self.node_r[occ], self.node_q[occ] = r[occ], q[occ]
        return low

    _patch_module(restore, pg.PoseGraph, "optimize", make)


POSEGRAPH_FAULTS = {"retrieval_vote_shifted": _retrieval_vote_shifted, "loop_edge_perturbed": _loop_edge_perturbed,
                    "loop_edge_turned": _loop_edge_turned, "posegraph_solve_skipped": _posegraph_solve_skipped,
                    "posegraph_solve_float32": _posegraph_solve_float32}


def run_fault(workload: str, fault: str, seed: int, seconds: float, device="cuda", warmup_frames=None) -> dict:
    """A run with `fault` planted; module patches are put back after."""
    restore = []
    plant = {**FAULTS, **POSEGRAPH_FAULTS}[fault]
    try:
        result, _ = harness.run(workload, seed, seconds, False, time.perf_counter(), device=device,
                                warmup_frames=warmup_frames, prepare=lambda vio: plant(vio, restore))
    finally:
        for module, name, orig in restore:
            setattr(module, name, orig)
    return result


def values(result: dict) -> dict:
    return {k: c["value"] for k, c in result["checks"].items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--faults", default="optimize_unchanged")
    ap.add_argument("--seconds", type=float, default=10.0, help="window of the program's and the control's runs")
    ap.add_argument("--fault-seconds", type=float, default=51.0, help="window of the fault runs")
    args = ap.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    for seed in ints(args.seeds):
        r, _ = harness.run(args.workload, seed, args.seconds, False, time.perf_counter())
        print(json.dumps(dict(kind="program", seed=seed, correct=r["correct"], attempted=r["attempted"],
                              values=values(r), metrics=r["metrics"])), flush=True)
    for seed in ints(args.control_seeds):
        r, _ = harness.run(args.workload, seed, args.seconds, False, time.perf_counter(), control=control_readings)
        print(json.dumps(dict(kind="control", seed=seed, program=values(r), control=r["control"])), flush=True)
    for fault in [f for f in args.faults.split(",") if f]:
        for seed in ints(args.fault_seeds):
            r = run_fault(args.workload, fault, seed, args.fault_seconds)
            print(json.dumps(dict(kind="fault", fault=fault, seed=seed, correct=r["correct"], values=values(r))),
                  flush=True)


if __name__ == "__main__":
    main()
