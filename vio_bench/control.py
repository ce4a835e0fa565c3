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
comparison. The faults
break the timed path underneath the benchmark's taps (see FAULTS). Prints
one JSON line a run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from . import check, harness
from .reference import detect

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


def run_fault(workload: str, fault: str, seed: int, seconds: float, device="cuda", warmup_frames=None) -> dict:
    """A run with `fault` planted; module patches are put back after."""
    restore = []
    try:
        result, _ = harness.run(workload, seed, seconds, False, time.perf_counter(), device=device,
                                warmup_frames=warmup_frames, prepare=lambda vio: FAULTS[fault](vio, restore))
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
