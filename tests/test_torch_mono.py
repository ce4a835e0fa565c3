"""The monocular rig (camera 0 of the EuRoC rig alone) in the port against
the JAX package, in float64 on the CPU.

Parity: the runtime's per-frame loop of test_torch_vio_loop.py (add_states
with deferred fetch, data_association_and_initialization, set_keyframe,
optimize, apply_marginalization_strategy) over 8 frames of projected
landmarks (datasets.synthetic.keypoint_frames on the one-camera rig; the
trajectory and landmarks of tests/test_pipeline.py:255: seed 61, motion
0.6, 240 landmarks at 3-9 m; K = 64), L = 256, O = 1024: the 2D-2D
bootstrap (rotation-only against relative pose), bearing-only landmarks
anchored at the world origin as in the JAX package, and the association's
(P·C) batch with C = 1. The JAX frontend's RANSAC keys are replayed into
the port. Tolerances are test_torch_vio_loop.py's: after every frame the
keypoint-to-landmark ids, keyframe decisions, is_initialized, the
bearing-only set, the landmark and observation tables exactly; states to
1e-8 [<= 8.5e-10], the prior's H to 1e-8 of its largest entry [<= 6.3e-10];
and, looser than there because the 18-24 bearing-only landmarks of the
window have near-singular 3x3 blocks, landmark positions to 1e-6 of
max(1, |p|) [<= 1.2e-7], the prior's b0 to 1e-6 of its largest entry
[<= 1.2e-7] and c0 to 1e-6 relative [<= 1.3e-7].

Slow, as the JAX tests are: analogs of tests/test_pipeline.py:255 (stub
detector, 30 frames, mono ATE < 0.25 m), tests/test_vision_e2e.py:130
(rendered stereo, detection_octaves = 2, 14 frames, ATE < 0.15 m, more than
30 landmarks, keypoint sizes recorded) and :158 (rendered gentle-motion
mono, 60 frames, ATE < 0.6 m), each with the JAX package's ATE printed
beside the port's; their RANSAC draws are the port's own.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis_tpu import kinematics as jkin
from okvis_tpu.cameras import NCameraSystem as JRig
from okvis_tpu.config.parameters import VioParameters as JVioParameters
from okvis_tpu.estimator import Estimator as JEstimator
from okvis_tpu.frontend.frame import MultiFrame as JMultiFrame
from okvis_tpu.frontend.frontend import Frontend as JFrontend
from okvis_tpu.frontend.frontend import FrontendConfig as JFrontendConfig
from okvis_tpu.imu import ImuParams as JImuParams
from okvis_tpu.pipeline import ThreadedVio as JThreadedVio
from okvis_tpu.solver import WindowConfig as JWindowConfig
from okvis_tpu.utils.ids import IdProvider as JIds
from okvis_tpu_torch import convert
from okvis_tpu_torch import kinematics as kin
from okvis_tpu_torch.cameras.ncamera import NCameraSystem
from okvis_tpu_torch.config import VioParameters
from okvis_tpu_torch.datasets.synthetic import (
    euroc_stereo_rig, gentle_mono_trajectory, keypoint_frames, make_landmarks, render_scenario,
    simulate_trajectory, vio_imu_slice)
from okvis_tpu_torch.estimator import Estimator
from okvis_tpu_torch.frontend.frame import MultiFrame
from okvis_tpu_torch.frontend.frontend import Frontend
from okvis_tpu_torch.pipeline import ThreadedVio
from okvis_tpu_torch.utils.ids import IdProvider as TIds
from test_torch_estimator import jax_rig, port_imu, snapshot
from test_torch_frontend import jax_frame, port_frame, replay_draws
from test_torch_runtime_e2e import _ate
from test_torch_threaded_vio import Harness
from test_torch_vio_loop import assert_same_vio_window

torch.set_num_threads(2)
N_FRAMES, K_SEQ = 8, 64
TOL_MONO = 1e-6


def mono_rigs():
    """Camera 0 of the EuRoC rig alone, in both packages (overlaps
    computed: the single camera overlaps itself)."""
    j = jax_rig()
    jrig = JRig(specs=(j.specs[0],), T_SC=jkin.SE3(r=j.T_SC.r[:1], q=j.T_SC.q[:1]), intrinsics=[j.intrinsics[0]])
    specs, T_SC, intr = euroc_stereo_rig(device="cpu")
    trig = NCameraSystem(specs=(specs[0],), T_SC=kin.SE3(r=T_SC.r[:1], q=T_SC.q[:1]), intrinsics=[intr[0]])
    jrig.compute_overlaps()
    trig.compute_overlaps()
    return jrig, trig


def _run_loop(est, fe, frames, traj, make_frame, MF, ids):
    """test_torch_vio_loop.py's loop on a one-camera multiframe."""
    ids.reset()
    out = []
    for f in frames:
        mf = MF(id=ids.new_id(), timestamp=f.t,
                frames=[make_frame(f.uv[0], f.mask[0], f.descriptors[0], np.zeros(K_SEQ, np.int64), K_SEQ)])
        last_t = est._last_state().timestamp if est.states else f.t
        sid = est.add_states(f.t, *vio_imu_slice(traj, min(last_t, f.t), f.t, f.t + 0.025), as_keyframe=False,
                             frame_id=mf.id, defer_fetch=True)
        est.multiframes[mf.id] = mf
        T_prop, sb_prop = est.last_prop_device()
        kf = fe.data_association_and_initialization(est, T_prop, mf, sb_prop=sb_prop)
        est.set_keyframe(sid, kf)
        est.optimize()
        s = snapshot(est, est.apply_marginalization_strategy())
        s.update(keyframe=kf, initialized=fe.is_initialized, lids=np.array(mf.frames[0].landmark_ids),
                 degenerate=fe.ransac_degenerate_frames,
                 bearing=[lm.id for lm in est.landmarks.values() if not lm.initialized])
        out.append(s)
    return out


@pytest.fixture(scope="module")
def run():
    traj = simulate_trajectory(duration=1.2, seed=61, motion_scale=0.6)
    lms = make_landmarks(traj, 240, seed=62, radius=(3.0, 9.0))
    jrig, trig = mono_rigs()
    frames = keypoint_frames(traj, lms, trig, N_FRAMES, K_SEQ, seed=3)
    jcfg = JWindowConfig(num_states=9, num_cameras=1, max_landmarks=256, max_observations=1024, imu_samples=32,
                         max_imu_links=8, max_iterations=5, camera_specs=tuple(jrig.specs))
    cfg = convert.window_config_from_dict(dataclasses.asdict(jcfg))
    jfe = JFrontend(jrig, JFrontendConfig(max_keypoints=K_SEQ))
    tfe = Frontend(trig, convert.frontend_config_from_dict(dataclasses.asdict(JFrontendConfig(max_keypoints=K_SEQ))))
    keys = replay_draws(jfe, tfe)
    want = _run_loop(JEstimator(jrig, JImuParams.euroc(), 5, 3, cfg=jcfg), jfe, frames, traj, jax_frame,
                     JMultiFrame, JIds)
    got = _run_loop(Estimator(trig, port_imu(), 5, 3, cfg=cfg, device="cpu", dtype=torch.float64), tfe, frames,
                    traj, port_frame, MultiFrame, TIds)
    return dict(jax=want, port=got, keys=keys, frames=frames)


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_mono_loop_matches_jax_after_frame(run, frame):
    got, want = run["port"][frame], run["jax"][frame]
    what = f"frame {frame + 1}"
    assert (got["keyframe"], got["initialized"], got["degenerate"], got["bearing"]) == \
        (want["keyframe"], want["initialized"], want["degenerate"], want["bearing"]), what
    np.testing.assert_array_equal(got["lids"], want["lids"], err_msg=what)
    # the bearing-only landmarks' near-singular 3x3 blocks amplify rounding
    # in the landmark positions and, through the marginalization's
    # pseudo-inverse, in the prior's b0 and c0 (TOL_MONO)
    scale = np.maximum(1.0, np.abs(want["hp_W"][:, :3]).max(axis=1, keepdims=True))
    np.testing.assert_allclose(got["hp_W"][:, :3] / scale, want["hp_W"][:, :3] / scale, rtol=0, atol=TOL_MONO,
                               err_msg=what)
    np.testing.assert_allclose(got["marg_b0"], want["marg_b0"], rtol=0,
                               atol=TOL_MONO * max(np.abs(want["marg_b0"]).max(), 1e-300), err_msg=what)
    assert abs(got["marg_c0"] - want["marg_c0"]) <= TOL_MONO * max(abs(want["marg_c0"]), 1e-300), what
    assert_same_vio_window(got, {**want, **{k: got[k] for k in ("hp_W", "marg_b0", "marg_c0")}}, what)


def test_mono_loop_bootstraps_and_associates(run):
    """The one-camera run creates landmarks from the 2D-2D bootstrap, binds
    keypoints of later frames to them and replays every JAX draw."""
    port = run["port"]
    assert port[-1]["landmarks"] and any(s["initialized"] for s in port)
    bound = [int((s["lids"][f.mask[0]] != 0).sum()) for s, f in zip(port[1:], run["frames"][1:])]
    assert max(bound) > 0.3 * run["frames"][1].mask.sum(), bound
    assert len(run["keys"]) >= 1


# ------------------------------------------------------------------ slow analogs


def _vio_pair(jrig, trig, n_keypoints, threshold=None, octaves=0):
    jp, p = JVioParameters(), VioParameters()
    for params in (jp, p):
        params.optimization.max_num_keypoints = n_keypoints
        params.optimization.detection_octaves = octaves
        if threshold is not None:
            params.optimization.detection_threshold = threshold
    return (JThreadedVio(jp, rig=jrig, blocking=True, dtype=jnp.float64),
            ThreadedVio(p, rig=trig, blocking=True, dtype=torch.float64, device="cpu"))


@pytest.mark.slow
def test_mono_vio_tracking():
    """tests/test_pipeline.py:255: a stub detector on the one-camera rig, 30
    frames; tracking initializes and the mono ATE stays under 0.25 m."""
    traj = simulate_trajectory(duration=3.5, seed=61, motion_scale=0.6)
    lms = make_landmarks(traj, 240, seed=62, radius=(3.0, 9.0))
    jrig, trig = mono_rigs()
    n_frames = 30
    frames = keypoint_frames(traj, lms, trig, n_frames, 96, seed=0, pixel_noise=0.4)
    jvio, tvio = _vio_pair(jrig, trig, 96)
    blank = (np.zeros((480, 752), np.float32),)
    for vio, make_frame in ((jvio, jax_frame), (tvio, port_frame)):
        h = Harness(vio, frames, make_frame)
        for fi in range(n_frames):
            h.feed(traj, fi, images=blank)
        vio.shutdown()
        assert len(vio.trajectory) >= n_frames - 3
    ate, jate = _ate(tvio, traj), _ate(jvio, traj)
    print(f"mono stub ATE: port {ate:.5f} m, JAX {jate:.5f} m")
    assert tvio.frontend.is_initialized
    assert ate < 0.25, f"mono ATE {ate:.4f} m (JAX {jate:.4f} m)"


def _rendered_run(jrig, trig, scene, n_keypoints, threshold, octaves=0):
    jvio, tvio = _vio_pair(jrig, trig, n_keypoints, threshold, octaves)
    for vio in (jvio, tvio):
        h = Harness(vio)
        for fi, images in enumerate(scene.images):
            h.feed(scene.traj, fi, images=images)
        vio.shutdown()
        assert len(vio.trajectory) >= len(scene.images) - 3, f"tracked {len(vio.trajectory)} frames"
    return jvio, tvio, _ate(tvio, scene.traj), _ate(jvio, scene.traj)


@pytest.mark.slow
def test_full_vision_multi_octave_detection():
    """tests/test_vision_e2e.py:130: detection_octaves = 2 on rendered
    stereo frames (trajectory seed 37, 260 landmarks at 4-8 m, seed 38), 200
    keypoints at threshold 15, 14 frames."""
    j = jax_rig()
    j.compute_overlaps()
    specs, T_SC, intr = euroc_stereo_rig(device="cpu")
    trig = NCameraSystem(specs=specs, T_SC=T_SC, intrinsics=intr)
    trig.compute_overlaps()
    traj = simulate_trajectory(duration=2.0, seed=37, motion_scale=0.25)
    scene = render_scenario(trig, traj, make_landmarks(traj, 260, seed=38, radius=(4.0, 8.0)), 14)
    jvio, tvio, ate, jate = _rendered_run(j, trig, scene, 200, 15.0, octaves=2)
    print(f"multi-octave ATE: port {ate:.5f} m, JAX {jate:.5f} m; landmarks port "
          f"{tvio.estimator.num_landmarks()}, JAX {jvio.estimator.num_landmarks()}")
    assert ate < 0.15, f"multi-octave ATE {ate:.4f} m (JAX {jate:.4f} m)"
    assert tvio.estimator.num_landmarks() > 30
    sizes = [f.sizes for mf in tvio.estimator.multiframes.values() for f in mf.frames if f.sizes is not None]
    assert sizes and max(float(np.max(s)) for s in sizes) > 8.0


@pytest.mark.slow
def test_mono_gentle_motion_bootstrap():
    """tests/test_vision_e2e.py:158: camera 0 alone on rendered frames of the
    gentle periodic trajectory (seed 41, 300 landmarks at 4-9 m, seed 42),
    60 frames; the JAX test's bound, ATE < 0.6 m."""
    n_frames = 60
    jrig, trig = mono_rigs()
    traj = gentle_mono_trajectory(n_frames)
    scene = render_scenario(trig, traj, make_landmarks(traj, 300, seed=42, radius=(4.0, 9.0)), n_frames)
    jvio, tvio, ate, jate = _rendered_run(jrig, trig, scene, 200, 15.0)
    print(f"gentle mono ATE: port {ate:.5f} m, JAX {jate:.5f} m; initialized port {tvio.frontend.is_initialized}, "
          f"JAX {jvio.frontend.is_initialized}")
    assert ate < 0.6, f"gentle-motion mono ATE {ate:.3f} m (JAX {jate:.3f} m)"
