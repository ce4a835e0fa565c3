"""Slow analog of tests/test_vision_textured.py for the port: the camera
flies 3 m above a textured plane and the port's ThreadedVio tracks it, on
the CPU in float64, with the JAX test's bounds (at least 10 of 12 frames,
ATE < 0.15 m, more than 30 landmarks) and its feed (timestamps as int(t *
1e9)).

The JAX test textures the plane with the reference repository's test
image, which is not in this repository; this one builds its texture in
code (datasets.synthetic.noise_texture, 1,024 x 1,024, seed 7, as
chip_smoke.py's textured part). The parameters are built in code (the
EuRoC defaults, 200 keypoints, threshold 25).
"""

import numpy as np
import pytest
import torch

from okvis_tpu_torch import kinematics as kin
from okvis_tpu_torch.cameras.ncamera import NCameraSystem
from okvis_tpu_torch.config import VioParameters
from okvis_tpu_torch.datasets.synthetic import (euroc_stereo_rig, noise_texture, render_textured_plane,
                                                simulate_trajectory)
from okvis_tpu_torch.eval.ate import ate_rmse
from okvis_tpu_torch.pipeline import ThreadedVio

NS = 1_000_000_000


@pytest.mark.slow
def test_vio_over_textured_plane():
    params = VioParameters()
    params.optimization.max_num_keypoints = 200
    params.optimization.detection_threshold = 25.0
    specs, T_SC, intrinsics = euroc_stereo_rig(device="cpu")
    rig = NCameraSystem(specs=specs, T_SC=T_SC, intrinsics=intrinsics)
    rig.compute_overlaps()
    texture = noise_texture(1024, seed=7)

    # gentle downward-looking flight 3 m above the plane: a 180° roll about x
    # turns the cameras' +z to the plane
    traj = simulate_trajectory(duration=1.6, seed=81, motion_scale=0.2)
    q_down = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64)
    vio = ThreadedVio(params, rig=rig, blocking=True, dtype=torch.float64, device="cpu")
    frame_dt, n_frames, imu_i, gt = 0.1, 12, 0, []
    for fi in range(n_frames):
        t_ns = int(fi * frame_dt * NS)
        idx = int(round(fi * frame_dt * 200))
        while imu_i < len(traj.ts) and int(traj.ts[imu_i] * NS) <= t_ns + 25_000_000:
            # body-frame measurements in the flipped body frame: y and z negate
            g = traj.gyro[imu_i] * np.asarray([1.0, -1.0, -1.0])
            a = traj.acc[imu_i] * np.asarray([1.0, -1.0, -1.0])
            vio.add_imu_measurement(int(traj.ts[imu_i] * NS), g, a)
            imu_i += 1
        T_WS = kin.SE3(r=torch.from_numpy(traj.r[idx] + np.asarray([0.0, 0.0, 3.0])),
                       q=kin.quat_multiply(torch.from_numpy(traj.q[idx]), q_down))
        gt.append((t_ns, T_WS.r.numpy()))
        for cam in range(2):
            img = render_textured_plane(rig.specs[cam], rig.intrinsics[cam], kin.compose(T_WS, rig.camera_T_SC(cam)),
                                        texture, plane_scale=150.0)
            vio.add_image(t_ns, cam, img)
        vio.wait_idle(timeout=300)
    vio.shutdown()

    assert len(vio.trajectory) >= n_frames - 2
    est_ts = np.asarray([s.timestamp_ns for s in vio.trajectory])
    est_p = np.stack([s.T_WS.r.numpy() for s in vio.trajectory])
    ate = ate_rmse(est_ts, est_p, np.asarray([t for t, _ in gt]), np.stack([p for _, p in gt]))
    assert ate is not None
    assert ate < 0.15, f"textured-plane ATE {ate:.4f} m"
    assert vio.estimator.num_landmarks() > 30
