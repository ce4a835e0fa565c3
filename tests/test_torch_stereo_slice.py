"""The port's stereo slice as a whole against the JAX package, at a cut size
(376x240 images with halved intrinsics, 128 keypoints): rendering,
Frontend.detect_and_describe_multi, and the stereo match + triangulation
launch; plus the triangulation helpers and the convert.py round trip.
Images and Harris in float32, geometry and triangulation in float64."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis_tpu import kinematics as jkin
from okvis_tpu.cameras import CameraSpec as JCameraSpec
from okvis_tpu.cameras import NCameraSystem as JNCameraSystem
from okvis_tpu.datasets import synthetic as jsyn
from okvis_tpu.frontend import kernels as jker
from okvis_tpu.frontend import triangulation as jtri
from okvis_tpu.frontend.frontend import Frontend as JFrontend
from okvis_tpu.frontend.frontend import FrontendConfig as JFrontendConfig
from okvis_tpu_torch import kinematics as tkin
from okvis_tpu_torch.convert import frontend_config_from_dict, rig_from_numpy, rig_to_numpy
from okvis_tpu_torch.datasets import synthetic as tsyn
from okvis_tpu_torch.frontend import kernels as tker
from okvis_tpu_torch.frontend import triangulation as ttri
from okvis_tpu_torch.frontend.frame import FrameData, MultiFrame
from okvis_tpu_torch.frontend.frontend import Frontend as TFrontend

torch.set_num_threads(2)
K = 128


def _rigs():
    """The EuRoC-like rig at half resolution, in both packages."""
    _, T_SC, intr = jsyn.euroc_stereo_rig()
    half = np.asarray(intr[0]).copy()
    half[:4] *= 0.5
    spec = JCameraSpec(376, 240, "radtan")
    jrig = JNCameraSystem(specs=(spec, spec), T_SC=T_SC, intrinsics=[jnp.asarray(half)] * 2)
    jrig.compute_overlaps()
    trig = rig_from_numpy([(376, 240, "radtan")] * 2, np.asarray(T_SC.r), np.asarray(T_SC.q),
                          [half, half], device="cpu")
    return jrig, trig


@pytest.fixture(scope="module")
def scene():
    jrig, trig = _rigs()
    traj = jsyn.simulate_trajectory(duration=1.2, seed=71, motion_scale=0.3)
    lms = jsyn.make_landmarks(traj, 260, seed=72, radius=(4.0, 8.0))
    i = 200  # t = 1.0 s: the camera is tilted, gravity angles are well conditioned
    jT = jkin.SE3(r=jnp.asarray(traj.r[i]), q=jnp.asarray(traj.q[i]))
    tT = tkin.SE3(r=torch.from_numpy(traj.r[i]), q=torch.from_numpy(traj.q[i]))
    jimgs = [jsyn.render_world_image(jrig.specs[c], jrig.intrinsics[c],
                                     jkin.compose(jT, jrig.camera_T_SC(c)), lms) for c in range(2)]
    timgs = [tsyn.render_world_image(trig.specs[c], trig.intrinsics[c],
                                     tkin.compose(tT, trig.camera_T_SC(c)), lms) for c in range(2)]
    cfg = dict(detection_threshold=15.0, max_keypoints=K)
    jfe = JFrontend(jrig, JFrontendConfig(**cfg))
    tfe = TFrontend(trig, frontend_config_from_dict(dataclasses.asdict(JFrontendConfig(**cfg))))
    return dict(jrig=jrig, trig=trig, jT=jT, tT=tT, jimgs=jimgs, timgs=timgs, jfe=jfe, tfe=tfe,
                lms=lms, jframes=jfe.detect_and_describe_multi(jimgs, jT),
                tframes=tfe.detect_and_describe_multi(timgs, tT))


def test_rendered_images_match_jax(scene):
    for a, b in zip(scene["timgs"], scene["jimgs"]):
        assert a.shape == b.shape == (240, 376)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)


def test_detect_and_describe_multi_matches_jax(scene):
    for ft, fj in zip(scene["tframes"], scene["jframes"]):
        mt, mj = ft.mask_np, fj.mask_np
        assert mt.sum() == mj.sum() > 20
        ot = np.lexsort((ft.uv_np[mt][:, 1], ft.uv_np[mt][:, 0]))
        oj = np.lexsort((fj.uv_np[mj][:, 1], fj.uv_np[mj][:, 0]))
        np.testing.assert_allclose(ft.uv_np[mt][ot], fj.uv_np[mj][oj], atol=1e-3)
        dt = ft.descriptors.numpy().view(np.uint32)[mt][ot]
        dj = np.asarray(fj.descriptors).astype(np.uint32)[mj][oj]
        flips = np.unpackbits((dt ^ dj).view(np.uint8)).sum()
        print(f"descriptor bit flips vs JAX: {flips} of {dt.size * 32}")
        assert flips / (dt.size * 32) <= 0.005


def _jax_stereo(scene, f0, f1):
    """The JAX package's stereo launch on the frames' keypoints, with uv in
    float64 as the port feeds them (the JAX frontend passes float32 uv and
    promotes; the cast only moves the ray sigma by one float32 rounding)."""
    jrig = scene["jrig"]
    T0 = jkin.compose(scene["jT"], jrig.camera_T_SC(0))
    T1 = jkin.compose(scene["jT"], jrig.camera_T_SC(1))
    std = jnp.full((K,), 0.8 / 12.0 * 8.0)
    return jax.device_get(jker.stereo_match_triangulate(
        jrig.specs[0], jrig.specs[1], jrig.intrinsics[0], jrig.intrinsics[1],
        f0.descriptors, f1.descriptors, jnp.asarray(f0.mask_np), jnp.asarray(f1.mask_np),
        jnp.asarray(f0.uv_np, jnp.float64), jnp.asarray(f1.uv_np, jnp.float64), T0, T1, std, std,
        threshold=60))


def test_stereo_launch_matches_jax_on_jax_keypoints(scene):
    """JAX descriptors and keypoints through the port's Frontend.match_stereo:
    identical assignment and flags, hp to 1e-9."""
    frames = []
    for fj in scene["jframes"]:
        kp = type(scene["tframes"][0].keypoints)(
            uv=torch.from_numpy(np.array(fj.keypoints.uv)),
            score=torch.from_numpy(np.array(fj.keypoints.score)),
            mask=torch.from_numpy(np.array(fj.keypoints.mask)))
        desc = torch.from_numpy(np.asarray(fj.descriptors).astype(np.uint32).view(np.int32))
        frames.append(FrameData(keypoints=kp, descriptors=desc, landmark_ids=np.zeros(K, np.int64)))
    (ca, cb, assign, hp, valid, par, can_init), = scene["tfe"].match_stereo(
        MultiFrame(0, 0.0, frames), scene["tT"])
    assert (ca, cb) == (0, 1)
    want = _jax_stereo(scene, *scene["jframes"])
    np.testing.assert_array_equal(assign, np.asarray(want[0]))
    np.testing.assert_allclose(hp, np.asarray(want[1]), rtol=0, atol=1e-9)
    for got, w in zip((valid, par, can_init), want[2:]):
        np.testing.assert_array_equal(got, np.asarray(w))
    assert (assign >= 0).sum() > 10 and valid.sum() > 10


def test_port_slice_end_to_end_triangulates_landmarks(scene):
    """The port's own detections through its stereo launch: the valid
    non-parallel triangulations lie near a true landmark's depth. At half
    resolution the disparity is halved, so the bound is 20 % (chip_smoke.py
    holds the full-resolution run to 10 %)."""
    (ca, _, assign, hp, valid, par, _), = scene["tfe"].match_stereo(
        MultiFrame(0, 0.0, scene["tframes"]), scene["tT"])
    ok = valid & (assign >= 0) & ~par
    assert ok.sum() > 10
    pts = hp[ok, :3] / hp[ok, 3:4]
    lms = scene["lms"]
    cen = tkin.compose(scene["tT"], scene["trig"].camera_T_SC(ca)).r.numpy()
    nn = np.linalg.norm(pts[:, None] - lms[None], axis=-1).argmin(axis=1)
    d_true = np.linalg.norm(lms[nn] - cen, axis=1)
    rel = np.abs(np.linalg.norm(pts - cen, axis=1) - d_true) / d_true
    assert (rel < 0.2).mean() > 0.9


def test_triangulate_fast_matches_jax():
    rng = np.random.default_rng(8)
    n = 64
    p1, p2 = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    e1 = rng.normal(size=(n, 3))
    e2 = e1 + rng.normal(size=(n, 3)) * np.logspace(-9, 0, n)[:, None]  # down to parallel
    e2[:4] = e1[:4]
    sigma = rng.uniform(1e-4, 1e-2, n)
    want = jtri.triangulate_fast(*(jnp.asarray(x) for x in (p1, e1, p2, e2, sigma)))
    got = ttri.triangulate_fast(*(torch.from_numpy(x) for x in (p1, e1, p2, e2, sigma)))
    np.testing.assert_allclose(got.hp.numpy(), np.asarray(want.hp), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.parallel.numpy(), np.asarray(want.parallel))
    assert got.parallel.numpy().any() and not got.parallel.numpy().all()


def test_refine_triangulation_matches_jax():
    from okvis_tpu.cameras import pinhole as jph

    from okvis_tpu_torch.cameras import pinhole as tph

    intr = np.asarray([458.654, 457.296, 367.215, 248.375, -0.2834, 0.0739, 2e-4, 1.76e-5])
    spec = (752, 480, "radtan")
    poses = [(np.zeros(3), np.asarray([0.0, 0.0, 0.0, 1.0])),
             (np.asarray([0.2, 0.05, 0.0]), np.asarray([0.01, -0.02, 0.005, 1.0]) / np.linalg.norm([0.01, -0.02, 0.005, 1.0]))]
    p_true = np.asarray([0.5, -0.3, 5.0])

    def residual_fn(kin, ph, arr, spec_obj, noise):
        ii = arr(intr)
        Ts = [kin.SE3(r=arr(r), q=arr(q)) for r, q in poses]
        obs = [ph.project(spec_obj, ii, kin.transform_point(kin.inverse(T), arr(p_true)))[0] for T in Ts]
        cat = jnp.concatenate if arr is jnp.asarray else torch.cat

        def res(hp):
            rs = []
            for T, uv in zip(Ts, obs):
                u, _ = ph.project_homogeneous(spec_obj, ii, kin.transform_hpoint(kin.inverse(T), hp))
                rs.append(uv - u)
            return cat(rs) + arr(noise)
        return res

    hp0 = np.asarray([0.3, -0.1, 3.5, 1.0])
    for noise in (np.zeros(4), np.asarray([30.0, 0.0, -30.0, 0.0])):
        want = jtri.refine_triangulation(residual_fn(jkin, jph, jnp.asarray, JCameraSpec(*spec), noise),
                                         jnp.asarray(hp0))
        got = ttri.refine_triangulation(
            residual_fn(tkin, tph, lambda x: torch.as_tensor(np.asarray(x, np.float64)),
                        tph.CameraSpec(*spec), noise), torch.from_numpy(hp0))
        np.testing.assert_allclose(got.hp.numpy(), np.asarray(want.hp), rtol=0, atol=1e-9)
        assert bool(got.valid) == bool(want.valid)


def test_projection_helpers_match_jax(scene):
    jrig, trig = scene["jrig"], scene["trig"]
    rng = np.random.default_rng(9)
    p_W = scene["lms"][:64]
    hp_W = np.concatenate([p_W, rng.uniform(0.2, 1.0, (64, 1))], axis=1)
    jT = jkin.inverse(jkin.compose(scene["jT"], jrig.camera_T_SC(0)))
    tT = tkin.inverse(tkin.compose(scene["tT"], trig.camera_T_SC(0)))
    for jf, tf, x in ((jker.project_points, tker.project_points, p_W),
                      (jker.project_hpoints, tker.project_hpoints, hp_W)):
        uv_j, ok_j = jf(jrig.specs[0], jrig.intrinsics[0], jT, jnp.asarray(x))
        uv_t, ok_t = tf(trig.specs[0], trig.intrinsics[0], tT, torch.from_numpy(x))
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-12, atol=1e-9)
    uv = rng.uniform(0, 300, (32, 2))
    np.testing.assert_allclose(
        tker.back_project_batch(trig.specs[0], trig.intrinsics[0], torch.from_numpy(uv)).numpy(),
        np.asarray(jker.back_project_batch(jrig.specs[0], jrig.intrinsics[0], jnp.asarray(uv))),
        rtol=0, atol=1e-12)


def test_convert_round_trip():
    jrig, trig = _rigs()
    again = rig_from_numpy(**rig_to_numpy(trig), device="cpu")
    assert again.specs == trig.specs
    for a, b in ((again.T_SC.r, trig.T_SC.r), (again.T_SC.q, trig.T_SC.q), *zip(again.intrinsics, trig.intrinsics)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(again.overlaps, jrig.overlaps)
    jcfg = JFrontendConfig(detection_threshold=40.0, matching_threshold=55, gate_extra_px=1.5)
    tcfg = frontend_config_from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    with pytest.raises(ValueError, match="unknown fields"):
        frontend_config_from_dict({"not_a_field": 1})
