"""The port's Frontend + Estimator against the JAX package's over an
8-frame run, in float64 on the CPU: the runtime's per-frame loop
(add_states with deferred fetch, data_association_and_initialization,
set_keyframe, optimize, apply_marginalization_strategy) on projected
landmarks, each landmark with its own descriptor and 6 bits flipped per
view (datasets.synthetic.keypoint_frames, trajectory seed 31, 600 landmarks
at 4-8 m, K = 64), on the EuRoC rig, L = 256, O = 1024 (the observation
table holds the window's ~500 observations). Both packages get
the same numpy frames; the JAX frontend's RANSAC keys are replayed into the
port's Frontend._draw.

Tolerances are those of test_torch_frontend.py: after every frame the
keypoint-to-landmark ids, keyframe decisions, is_initialized, the landmark
and observation tables exactly; states to 1e-8 [<= 3e-12], landmark
positions to 1e-8 [<= 5e-10], landmark quality to 1e-7 [1.1e-8], the
marginal prior's b0 and c0 as in test_torch_estimator.py and its H to 1e-8
of its largest entry [1.14e-9: eight marginalizations of a 1,000-observation
window sum more rounding than the estimator runs' 2e-11].
"""

import dataclasses

import numpy as np
import pytest
import torch

from okvis_tpu.frontend.frame import MultiFrame as JMultiFrame
from okvis_tpu.frontend.frontend import Frontend as JFrontend
from okvis_tpu.frontend.frontend import FrontendConfig as JFrontendConfig
from okvis_tpu.utils.ids import IdProvider as JIds
from okvis_tpu_torch import convert
from okvis_tpu_torch.datasets.synthetic import keypoint_frames, make_landmarks, simulate_trajectory, vio_imu_slice
from okvis_tpu_torch.frontend.frame import MultiFrame
from okvis_tpu_torch.frontend.frontend import Frontend
from okvis_tpu_torch.utils.ids import IdProvider as TIds
from okvis_tpu.estimator import Estimator as JEstimator
from okvis_tpu.imu import ImuParams as JImuParams
from okvis_tpu.solver import WindowConfig as JWindowConfig
from test_torch_estimator import assert_same_window, jax_rig, port_estimator, port_rig, snapshot
from test_torch_frontend import TOL_QUALITY, jax_frame, port_frame, replay_draws

torch.set_num_threads(2)
TOL_MARG_H = 1e-8

N_FRAMES, K_SEQ = 8, 64


def _run_loop(est, fe, frames, traj, make_frame, MF, ids):
    """The runtime's per-frame loop, blocking: add_states (deferred fetch),
    the multiframe, data_association_and_initialization, set_keyframe,
    optimize, apply_marginalization_strategy. A snapshot a frame."""
    ids.reset()
    out = []
    for f in frames:
        mf = MF(id=ids.new_id(), timestamp=f.t,
                frames=[make_frame(f.uv[c], f.mask[c], f.descriptors[c], np.zeros(K_SEQ, np.int64), K_SEQ)
                        for c in range(2)])
        last_t = est._last_state().timestamp if est.states else f.t
        sid = est.add_states(f.t, *vio_imu_slice(traj, min(last_t, f.t), f.t, f.t + 0.025), as_keyframe=False,
                             frame_id=mf.id, defer_fetch=True)
        est.multiframes[mf.id] = mf
        T_prop, sb_prop = est.last_prop_device()
        kf = fe.data_association_and_initialization(est, T_prop, mf, sb_prop=sb_prop)
        est.set_keyframe(sid, kf)
        est.optimize()
        s = snapshot(est, est.apply_marginalization_strategy())
        s.update(keyframe=kf, initialized=fe.is_initialized,
                 lids=[np.array(fr.landmark_ids) for fr in mf.frames],
                 degenerate=fe.ransac_degenerate_frames)
        out.append(s)
    return out


@pytest.fixture(scope="module")
def run():
    traj = simulate_trajectory(duration=1.2, seed=31, motion_scale=0.25)
    lms = make_landmarks(traj, 600, seed=32, radius=(4.0, 8.0))
    frames = keypoint_frames(traj, lms, port_rig(), N_FRAMES, K_SEQ, seed=3)
    jcfg = JWindowConfig(num_states=9, num_cameras=2, max_landmarks=256, max_observations=1024, imu_samples=32,
                         max_imu_links=8, max_iterations=5, camera_specs=tuple(jax_rig().specs))
    cfg = convert.window_config_from_dict(dataclasses.asdict(jcfg))
    jfe = JFrontend(jax_rig(), JFrontendConfig(max_keypoints=K_SEQ))
    tfe = Frontend(port_rig(), convert.frontend_config_from_dict(
        dataclasses.asdict(JFrontendConfig(max_keypoints=K_SEQ))))
    keys = replay_draws(jfe, tfe)
    want = _run_loop(JEstimator(jax_rig(), JImuParams.euroc(), 5, 3, cfg=jcfg), jfe, frames, traj, jax_frame, JMultiFrame, JIds)
    got = _run_loop(port_estimator(cfg), tfe, frames, traj, port_frame, MultiFrame, TIds)
    return dict(jax=want, port=got, keys=keys, frames=frames)


def assert_same_vio_window(got, want, what, tol_landmark=1e-8):
    """A window after a frame of the loop against the JAX one: landmark
    quality to TOL_QUALITY, the prior's H to TOL_MARG_H of its largest entry,
    landmark positions to `tol_landmark`, the rest at
    test_torch_estimator.py's tolerances."""
    np.testing.assert_allclose([lm["quality"] for lm in got["landmarks"]],
                               [lm["quality"] for lm in want["landmarks"]], rtol=0, atol=TOL_QUALITY, err_msg=what)
    scale = np.abs(want["marg_H"]).max()
    np.testing.assert_allclose(got["marg_H"], want["marg_H"], rtol=0, atol=TOL_MARG_H * scale, err_msg=what)
    # the two quantities checked above taken from the JAX window
    strip = lambda s: {**s, "landmarks": [{**lm, "quality": 0.0} for lm in s["landmarks"]],  # noqa: E731
                       "marg_H": want["marg_H"]}
    assert_same_window(strip(got), strip(want), what)
    np.testing.assert_allclose(got["hp_W"], want["hp_W"], rtol=0, atol=tol_landmark, err_msg=what)


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_vio_loop_matches_jax_after_frame(run, frame):
    got, want = run["port"][frame], run["jax"][frame]
    what = f"frame {frame + 1}"
    assert (got["keyframe"], got["initialized"], got["degenerate"]) == \
        (want["keyframe"], want["initialized"], want["degenerate"]), what
    for a, b in zip(got["lids"], want["lids"]):
        np.testing.assert_array_equal(a, b, err_msg=what)
    assert_same_vio_window(got, want, what)


def test_vio_loop_exercises_association(run):
    """The run initializes at the second frame (its first association
    round), binds most keypoints to landmarks, marginalizes, and replays
    every JAX RANSAC draw (one rig RANSAC a round)."""
    port = run["port"]
    assert [s["initialized"] for s in port] == [False] + [True] * (N_FRAMES - 1)
    assert port[-1]["marg_valid"] and len(port[-1]["states"]) < N_FRAMES
    for s, f in zip(port[1:], run["frames"][1:]):
        bound = sum(int((lid[m] != 0).sum()) for lid, m in zip(s["lids"], f.mask))
        assert bound > 0.6 * f.mask.sum()
    assert len(run["keys"]) >= N_FRAMES - 1
