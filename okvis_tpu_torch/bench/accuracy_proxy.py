"""Accuracy proxy: long synthetic scenarios through the whole vision pipeline
(port of scripts/accuracy_proxy.py).

No EuRoC sequence is at hand, so these scenarios exercise the same failure
surfaces at the reference's scale: 300+ frames each (marginalization and
keyframe churn far beyond the window), a revisiting loop, photometric
nuisance (brightness drift, blur, pixel noise) and a near-planar wall (the
absolute-pose solver's planar degeneracy). Each run feeds ThreadedVio in
blocking mode, float32, on the card, at 200 keypoints a camera and
detection threshold 15, and reports its ATE (Umeyama-aligned).

Configurations (the JAX package's BASELINE.json configs[0..4]):
  stereo       the 2-camera rig
  mono         camera 0 alone, 2D-2D RANSAC initialization
  extrinsics   online camera-IMU calibration from a perturbed rig
  distributed8 the window sharded over 8 shards (on one card: a mesh that
               repeats the card; in this process)
  loopclosure  the pose-graph / loop-closure layer on

Bounds are on the median ATE over the seed draws (BOUNDS_M times
CONFIG_BOUND_SCALE), with at least 95 % of the frames tracked.

    python -m okvis_tpu_torch.bench.accuracy_proxy [scenario ...] [--frames N] [--seeds N] [--device cpu]
    python -m okvis_tpu_torch.bench.accuracy_proxy --cell CONFIG SCENARIO SEED [--frames N]
    python -m okvis_tpu_torch.bench.accuracy_proxy --matrix [config ...] [scenario ...] --out PATH

--cell prints one `CELL {json}` line; --matrix runs every cell in a
subprocess of its own and writes the table to --out. Exits non-zero if a
row misses its bound.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from . import common

NS = 1_000_000_000
FRAME_DT = 0.1


def _box_blur(img: np.ndarray, k: int = 3) -> np.ndarray:
    """Separable box blur via zero-prepended cumsum."""
    pad = k // 2

    def blur_axis0(a):
        p = np.pad(a, ((pad, pad), (0, 0)), mode="edge")
        c = np.vstack([np.zeros((1, p.shape[1])), np.cumsum(p, axis=0)])
        return (c[k:] - c[:-k]) / k

    out = blur_axis0(img)
    out = blur_axis0(out.T).T
    return out


def scenario_loop(n_frames=320, seed=41, seed_offset=0):
    """Revisiting loop: a periodic excitation of period 8 s brings the
    platform back near its start; a seed-dependent phase makes each seed
    draw a distinct trajectory."""
    from ..datasets.synthetic import make_landmarks, simulate_trajectory

    w = 2 * np.pi / 8.0
    ph = 0.4 * seed_offset
    traj = simulate_trajectory(
        duration=(n_frames + 2) * FRAME_DT,
        seed=seed + 10 * seed_offset,
        omega_fn=lambda t: 0.25 * np.array([np.sin(w * t + ph), np.cos(w * t - ph), np.sin(2 * w * t + ph)]),
        acc_w_fn=lambda t: np.array([0.9 * np.sin(w * t + ph), 0.9 * np.cos(w * t - ph),
                                     0.4 * np.sin(2 * w * t + ph)]),
    )
    lms = make_landmarks(traj, 300, seed=seed + 1 + seed_offset, radius=(4.0, 9.0))
    return traj, lms, None


def scenario_photometric(n_frames=300, seed=43, seed_offset=0):
    """Nominal motion with photometric nuisance: a slow exposure drift, a
    3x3 box blur every frame and extra pixel noise."""
    from ..datasets.synthetic import make_landmarks, simulate_trajectory

    traj = simulate_trajectory(duration=(n_frames + 2) * FRAME_DT, seed=seed + 10 * seed_offset, motion_scale=0.3)
    lms = make_landmarks(traj, 300, seed=seed + 1, radius=(4.0, 9.0))
    rng = np.random.default_rng(seed + 2)

    def nuisance(img, fi, cam):
        gain = 1.0 + 0.25 * np.sin(2 * np.pi * fi / 90.0)  # exposure drift
        offs = 12.0 * np.sin(2 * np.pi * fi / 47.0 + cam)
        out = _box_blur(img.astype(np.float64), 3)
        out = gain * out + offs + rng.normal(0, 2.5, img.shape)
        return np.clip(out, 0, 255)

    return traj, lms, nuisance


def scenario_planar_wall(n_frames=300, seed=47, seed_offset=0):
    """Every landmark on one plane, a wall 4 m ahead (12 x 8 m): the
    absolute-pose minimal solver must stay non-degenerate."""
    from ..datasets.synthetic import simulate_trajectory

    traj = simulate_trajectory(duration=(n_frames + 2) * FRAME_DT, seed=seed + 10 * seed_offset, motion_scale=0.25)
    rng = np.random.default_rng(seed + 1)
    center = traj.r.mean(axis=0)
    n_lms = 320
    lms = np.stack([center[0] + rng.uniform(-6, 6, n_lms), center[1] + rng.uniform(-4, 4, n_lms),
                    np.full(n_lms, center[2] + 4.0)], axis=1)
    return traj, lms, None


SCENARIOS = {
    "loop": scenario_loop,
    "photometric": scenario_photometric,
    "planar_wall": scenario_planar_wall,
}

CONFIG_VARIANTS = {
    "stereo": {},
    "mono": {"mono": True},
    "extrinsics": {"extrinsics": True},
    "distributed8": {"distributed": 8},
    "loopclosure": {"loop_closure": True},
}

# Bounds on the median ATE over the seed draws (the JAX package's, set from
# its observed stability envelope in float32; a single draw's ATE on these
# scenarios moves with the pipeline's discrete decisions)
BOUNDS_M = {"loop": 0.45, "photometric": 0.20, "planar_wall": 0.70}

# Per-config multipliers on the scenario bounds: mono scale is only IMU
# observable; online extrinsics starts from a miscalibrated rig, so its
# cells include the convergence transient
CONFIG_BOUND_SCALE = {
    "stereo": 1.0,
    "mono": 2.5,
    "extrinsics": 3.0,
    "distributed8": 1.0,
    "loopclosure": 1.0,
}


def scenario_params(config: str, pgo_min_inliers: Optional[int] = None):
    """The cell's VioParameters, built in code (the EuRoC defaults, 200
    keypoints a camera, threshold 15, and the configuration's settings)."""
    from .bench_pipeline import bench_params

    variant = CONFIG_VARIANTS[config]
    params = bench_params(200)
    if variant.get("extrinsics"):
        # priors of ~2 sigma of the rig perturbation drawn in scenario_rigs
        params.camera_params.sigma_absolute_translation = 0.012
        params.camera_params.sigma_absolute_orientation = 0.010
    if variant.get("loop_closure"):
        params.posegraph.enabled = True
        if pgo_min_inliers:
            params.posegraph.min_inliers = int(pgo_min_inliers)
    return params


def scenario_rigs(config: str, seed_offset: int, device):
    """(the true rig on the CPU, which renders; the rig fed to the pipeline,
    on `device`): the extrinsics cells feed one perturbed by 5 mm / ~0.3 deg
    a camera (numpy seed 90 + seed_offset)."""
    from .. import kinematics as kin
    from ..cameras.ncamera import NCameraSystem
    from .bench_pipeline import euroc_rig

    variant = CONFIG_VARIANTS[config]
    n_cams = 1 if variant.get("mono") else 2
    rig_true = euroc_rig("cpu", n_cams)
    if not variant.get("extrinsics"):
        return rig_true, euroc_rig(device, n_cams)
    prng = np.random.default_rng(90 + seed_offset)
    dr = torch.from_numpy(prng.normal(0, 0.005, (n_cams, 3)))
    dq = torch.from_numpy(prng.normal(0, 0.005, (n_cams, 3)))
    q_pert = kin.quat_normalize(torch.cat([dq, torch.ones((n_cams, 1), dtype=torch.float64)], dim=1))
    T = kin.compose(kin.SE3(r=rig_true.T_SC.r, q=rig_true.T_SC.q), kin.SE3(r=dr, q=q_pert))
    dev = torch.device(device)
    rig_vio = NCameraSystem(specs=tuple(rig_true.specs), T_SC=kin.SE3(r=T.r.to(dev), q=T.q.to(dev)),
                            intrinsics=[i.to(dev) for i in rig_true.intrinsics])
    rig_vio.compute_overlaps()
    return rig_true, rig_vio


def run_scenario(name: str, seed_offset: int = 0, config: str = "stereo", n_frames: Optional[int] = None,
                 device=None, pgo_min_inliers: Optional[int] = None, dtype=torch.float32,
                 verbose: bool = True) -> dict:
    """One (config, scenario, seed) run: frames tracked of fed, ATE, wall s,
    the frames' median and max host ms, RANSAC-degenerate frames."""
    from ..parallel import make_mesh
    from ..pipeline import ThreadedVio
    from ..utils.ids import IdProvider
    from .bench_pipeline import feed_frame, render_frame, trajectory_ate

    dev = common.resolve_device(device)
    variant = CONFIG_VARIANTS[config]
    kw = {"seed_offset": seed_offset}
    if n_frames:
        kw["n_frames"] = n_frames
    traj, lms, nuisance = SCENARIOS[name](**kw)
    fed = int(traj.ts[-1] / FRAME_DT) - 2
    params = scenario_params(config, pgo_min_inliers)
    rig_true, rig_vio = scenario_rigs(config, seed_offset, dev)
    IdProvider.reset()
    vio = ThreadedVio(params, rig=rig_vio, blocking=True, dtype=dtype, device=dev)
    if variant.get("distributed"):
        vio.estimator.enable_distributed(mesh=make_mesh(devices=[dev] * variant["distributed"]))
    imu_i, frame_s = 0, []
    t0 = time.perf_counter()
    try:
        for fi in range(fed):
            images = render_frame(rig_true, traj, lms, fi, nuisance)
            imu_i, dt = feed_frame(vio, traj, fi, images, imu_i, timeout=600.0)
            frame_s.append(dt)
            if verbose and fi % 50 == 49:
                print(f"  [{config}/{name}] {fi + 1}/{fed} frames", flush=True)
        wall = time.perf_counter() - t0
    finally:
        vio.shutdown()
    pg = vio.posegraph
    return dict(config=config, scenario=name, seed=seed_offset, frames=len(vio.trajectory), fed=fed,
                ate_m=trajectory_ate(vio, traj), wall_s=wall, median_frame_ms=1e3 * float(np.median(frame_s)),
                max_frame_ms=1e3 * float(np.max(frame_s)),
                ransac_degenerate_frames=vio.frontend.ransac_degenerate_frames,
                loop_events=None if pg is None else len(pg.loop_events),
                loops_accepted=None if pg is None else sum(e.accepted for e in pg.loop_events),
                device=common.device_name(dev))


def _gate(config, scenario, runs):
    """(median, bound, ok) for one cell's seed draws."""
    ates = [r["ate_m"] for r in runs if r["ate_m"] is not None]
    med = float(np.median(ates)) if ates else float("nan")
    bound = BOUNDS_M[scenario] * CONFIG_BOUND_SCALE[config]
    frames_ok = bool(runs) and all(r["frames"] >= 0.95 * r["fed"] for r in runs)
    ok = bool(ates) and med < bound and frames_ok
    return med, bound, ok


def _print_row(config, scenario, runs, med, bound, ok):
    ates = [r["ate_m"] for r in runs if r["ate_m"] is not None]
    rng_s = f"{min(ates):.3f}..{max(ates):.3f}" if ates else "-"
    degen = sum(r["ransac_degenerate_frames"] for r in runs)
    wall = sum(r["wall_s"] for r in runs)
    fr = f"{runs[0]['frames']}/{runs[0]['fed']}x{len(runs)}" if runs else "-"
    print(f"{config:<13s} {scenario:<12s} {fr:>9s} {med:>11.4f} {rng_s:>15s} {bound:>7.2f} {degen:>6d} {wall:>9.1f}"
          + ("" if ok else "   <-- FAIL"), flush=True)


_HDR = (f"\n{'config':<13s} {'scenario':<12s} {'frames':>9s} {'ATE med [m]':>11s} "
        f"{'range':>15s} {'bound':>7s} {'degen':>6s} {'wall [s]':>9s}")


def _write(out: Optional[str], results: dict) -> None:
    if out:
        with open(out, "w") as f:
            json.dump(results, f, indent=1)


def main_rows(names, seeds: int, n_frames, device, out: Optional[str], pgo_min_inliers=None) -> int:
    """The stereo row of each scenario, in this process."""
    print(_HDR)
    failed, results = False, {}
    for n in names:
        runs = [run_scenario(n, s, "stereo", n_frames, device, pgo_min_inliers) for s in range(seeds)]
        med, bound, ok = _gate("stereo", n, runs)
        failed |= not ok
        _print_row("stereo", n, runs, med, bound, ok)
        results[f"stereo/{n}"] = dict(runs=runs, median_ate_m=med, bound_m=bound, ok=ok)
        _write(out, results)
    print(json.dumps(dict(rows={k: {x: v[x] for x in ("median_ate_m", "bound_m", "ok")} for k, v in results.items()},
                          ok=not failed)))
    return 1 if failed else 0


def cell_command(config: str, scenario: str, seed: int, n_frames=None, device=None, pgo_min_inliers=None) -> list:
    """The command line of one --cell subprocess."""
    cmd = [sys.executable, "-m", "okvis_tpu_torch.bench.accuracy_proxy", "--cell", config, scenario, str(seed)]
    if n_frames:
        cmd += ["--frames", str(n_frames)]
    if device:
        cmd += ["--device", str(device)]
    if pgo_min_inliers:
        cmd += ["--pgo-min-inliers", str(pgo_min_inliers)]
    return cmd


def run_cell(config: str, scenario: str, seed: int, n_frames=None, device=None, pgo_min_inliers=None,
             timeout: float = 3600.0) -> tuple:
    """One cell in a subprocess of its own: (its CELL record or None, the
    return code, the end of its standard error)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    try:
        p = subprocess.run(cell_command(config, scenario, seed, n_frames, device, pgo_min_inliers), env=env,
                           capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return None, None, "timed out"
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("CELL ")]
    return (json.loads(lines[-1][5:]) if lines else None), p.returncode, p.stderr[-2000:]


def main_matrix(scenarios, configs, seeds: int, n_frames, device, out: Optional[str], pgo_min_inliers=None,
                timeout: float = 3600.0) -> int:
    """Config x scenario; every cell (each seed) a subprocess of its own, so
    one crash loses one draw. Results are written to `out` after each row."""
    print(_HDR)
    failed, results = False, {}
    for config in configs:
        for scen in scenarios:
            runs = []
            for seed in range(seeds):
                rec, rc, err = run_cell(config, scen, seed, n_frames, device, pgo_min_inliers, timeout)
                if rec is None:
                    print(f"cell {config}/{scen}/seed{seed} failed (rc={rc}): {err}", flush=True)
                else:
                    runs.append(rec)
            med, bound, ok = _gate(config, scen, runs)
            failed |= not ok
            _print_row(config, scen, runs, med, bound, ok)
            results[f"{config}/{scen}"] = dict(runs=runs, median_ate_m=med, bound_m=bound, ok=ok)
            _write(out, results)
    print(f"\nmatrix {'PASS' if not failed else 'FAIL'}" + (f"; details {out}" if out else ""))
    return 1 if failed else 0


def main(argv=None) -> int:
    ap = common.parser(__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", help="scenarios (and, with --matrix, configurations)")
    ap.add_argument("--cell", nargs=3, metavar=("CONFIG", "SCENARIO", "SEED"))
    ap.add_argument("--matrix", action="store_true")
    ap.add_argument("--frames", type=int, default=None, help="scenario length (default: the scenario's own)")
    ap.add_argument("--seeds", type=int, default=3, help="seed draws a cell")
    ap.add_argument("--pgo-min-inliers", type=int, default=None)
    ap.add_argument("--out", default=None, help="write the rows' results (JSON) here")
    args = ap.parse_args(argv)
    if args.cell:
        config, scen, seed = args.cell
        rec = run_scenario(scen, int(seed), config, args.frames, args.device, args.pgo_min_inliers)
        print("CELL " + json.dumps(rec), flush=True)
        return 0
    unknown = [n for n in args.names if n not in SCENARIOS and n not in CONFIG_VARIANTS]
    if unknown:
        ap.error(f"unknown scenario or configuration: {unknown}")
    scens = [n for n in args.names if n in SCENARIOS] or list(SCENARIOS)
    if args.matrix:
        configs = [n for n in args.names if n in CONFIG_VARIANTS] or list(CONFIG_VARIANTS)
        return main_matrix(scens, configs, args.seeds, args.frames, args.device, args.out, args.pgo_min_inliers)
    return main_rows(scens, args.seeds, args.frames, args.device, args.out, args.pgo_min_inliers)


if __name__ == "__main__":
    sys.exit(main())
