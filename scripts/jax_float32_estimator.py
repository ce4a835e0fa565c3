#!/usr/bin/env python3
"""The JAX package's Estimator in float32 on the CPU, on the scenario that
chip_smoke.py's estimator phase runs on the card: simulate_trajectory(
duration=4.0, seed=3, motion_scale=0.6), 600 landmarks at 3-9 m (seed 4),
39 frames 0.1 s apart, every second a keyframe, pixel noise 0.6 (scenario
seed 11), the EuRoC stereo rig and the Estimator's default window (S = 9,
L = 512, O = 2048, P = 32, K = 8, 10 iterations). The frames come from the
port's estimator_scenario, so both packages see the same numpy inputs.

For LM + Newton-Schulz (the JAX default) and LM + Cholesky it prints one
JSON line: the per-frame position and orientation errors of the newest
state, their maxima over the last 10 frames (the reference gates: 0.1 m,
2e-2 rad), and the final window's size. chip_smoke.py's estimator gates
for the card's float32 run are set from these numbers:

    JAX_PLATFORMS=cpu python scripts/jax_float32_estimator.py

A few minutes on a CPU, most of them compiling the capacity tiers.
"""

import dataclasses
import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")  # float32: x64 stays off

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from okvis_tpu import kinematics as kin  # noqa: E402
from okvis_tpu.cameras import NCameraSystem  # noqa: E402
from okvis_tpu.datasets.synthetic import euroc_stereo_rig  # noqa: E402
from okvis_tpu.estimator import Estimator  # noqa: E402
from okvis_tpu.imu import ImuParams  # noqa: E402
from okvis_tpu_torch.cameras.ncamera import NCameraSystem as TorchRig  # noqa: E402
from okvis_tpu_torch.datasets import synthetic as port_synthetic  # noqa: E402

# chip_smoke.py's ESTIMATOR_SCENARIO
SCENARIO = dict(duration=4.0, traj_seed=3, motion_scale=0.6, n_landmarks=600, lm_seed=4,
                radius=(3.0, 9.0), n_frames=39, seed=11, pixel_noise=0.6)


def scenario():
    s = SCENARIO
    traj = port_synthetic.simulate_trajectory(duration=s["duration"], seed=s["traj_seed"],
                                              motion_scale=s["motion_scale"])
    lms = port_synthetic.make_landmarks(traj, s["n_landmarks"], seed=s["lm_seed"], radius=s["radius"])
    specs, T_SC, intr = port_synthetic.euroc_stereo_rig(device="cpu")
    frames, init = port_synthetic.estimator_scenario(
        traj, lms, TorchRig(specs=specs, T_SC=T_SC, intrinsics=intr), s["n_frames"], seed=s["seed"],
        pixel_noise=s["pixel_noise"])
    return frames, init


def main() -> None:
    frames, init = scenario()
    specs, T_SC, intr = euroc_stereo_rig()
    rig = NCameraSystem(specs=tuple(specs), T_SC=T_SC, intrinsics=intr)
    for solver in ("newton", "cholesky"):
        est = Estimator(rig, ImuParams.euroc(dtype=jnp.float32), 5, 3, dtype=jnp.float32)
        est.cfg = dataclasses.replace(est.cfg, dense_solver=solver)
        pos, ang = [], []
        for f in frames:
            sid = port_synthetic.feed_estimator_frame(est, f, init)
            est.optimize()
            est.apply_marginalization_strategy()
            T = est.get_T_WS(sid)
            pos.append(float(np.linalg.norm(np.asarray(T.r, np.float64) - f.r_WS)))
            dq = kin.quat_multiply(kin.quat_conjugate(jnp.asarray(T.q, jnp.float32)),
                                   jnp.asarray(f.q_WS, jnp.float32))
            ang.append(float(2 * np.arccos(min(1.0, abs(float(dq[3]))))))
        print(json.dumps(dict(
            dtype="float32", dense_solver=solver, frames=len(frames), position=pos, orientation=ang,
            last10_position=max(pos[-10:]), last10_orientation=max(ang[-10:]),
            num_frames=est.num_frames(), imu_links=len(est.imu_links), marg_valid=bool(est.marg_valid))),
            flush=True)


if __name__ == "__main__":
    main()
