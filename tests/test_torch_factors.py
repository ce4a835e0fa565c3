"""The port's factors and local parameterizations against the JAX package,
in float64 on the CPU: the port's batched calls against ``jax.vmap`` of the
JAX functions on the same seeded inputs, to 1e-10; and the port's own
numeric-Jacobian checks at the tolerances of tests/test_factors.py,
tests/test_imu.py and tests/test_local_parameterization.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis_tpu import factors as jfac
from okvis_tpu import imu as jimu
from okvis_tpu import kinematics as jkin
from okvis_tpu.cameras import CameraSpec as JCameraSpec
from okvis_tpu.kinematics import local_parameterization as jlp
from okvis_tpu_torch import factors as tfac
from okvis_tpu_torch import kinematics as tkin
from okvis_tpu_torch.cameras import pinhole
from okvis_tpu_torch.cameras.pinhole import CameraSpec
from okvis_tpu_torch.datasets.synthetic import simulate_trajectory
from okvis_tpu_torch.imu import ImuParams, preintegrate, propagate
from okvis_tpu_torch.kinematics import local_parameterization as tlp

torch.set_num_threads(2)
SPEC = CameraSpec(752, 480, "radtan")
INTR = np.asarray([458.654, 457.296, 367.215, 248.375, -0.2834, 0.0739, 2e-4, 1.76e-5])
N = 16  # observations of the batched reprojection case


def _t(a):
    return torch.from_numpy(np.array(a, np.float64))


def _j(a):
    return jnp.asarray(np.asarray(a), jnp.float64)


def _rand_q(rng, n=None):
    q = rng.normal(size=(4,) if n is None else (n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _se3(r, q):
    return tkin.SE3(r=_t(r), q=_t(q))


def _close(got, want, atol=1e-10, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol, err_msg=err_msg)


# ------------------------------------------------------------------ reprojection


@pytest.fixture(scope="module")
def obs():
    """N observations of landmarks in front of the camera, the last three
    invalid (behind the camera, or 10 cm in front)."""
    rng = np.random.default_rng(11)
    r_WS, q_WS = rng.normal(size=(N, 3)), _rand_q(rng, N)
    r_SC, q_SC = np.asarray([0.05, 0.01, -0.02]), _rand_q(np.random.default_rng(3)) * 0.1 + [0, 0, 0, 1]
    q_SC /= np.linalg.norm(q_SC)
    uv = rng.uniform([50, 50], [700, 430], (N, 2))
    depth = rng.uniform(1.0, 8.0, N)
    depth[-3:] = [-1.0, -3.0, 0.1]
    ray = pinhole.back_project(SPEC, _t(INTR), _t(uv)) * _t(depth)[:, None]
    T_WC = tkin.compose(_se3(r_WS, q_WS), _se3(r_SC, q_SC))
    p_W = tkin.transform_point(T_WC, ray).numpy()
    scale = rng.uniform(0.5, 2.0, N)
    hp_W = np.concatenate([p_W * scale[:, None], scale[:, None]], axis=1)
    kp = uv + rng.normal(size=(N, 2))
    W22 = np.asarray([[2.0, 0.1], [0.0, 1.7]]) + 0.1 * rng.normal(size=(N, 2, 2))
    return dict(r_WS=r_WS, q_WS=q_WS, r_SC=r_SC, q_SC=q_SC, hp_W=hp_W, kp=kp,
                iso=rng.uniform(0.5, 2.0, N), W22=W22)


def _jax_reprojection(o, sqrt_info):
    spec = JCameraSpec(752, 480, "radtan")

    def one(kp, w, r, q, hp):
        return jfac.reprojection_error(spec, _j(INTR), kp, w, jkin.SE3(r=r, q=q), hp,
                                       jkin.SE3(r=_j(o["r_SC"]), q=_j(o["q_SC"])))

    return jax.jit(jax.vmap(one))(_j(o["kp"]), _j(sqrt_info), _j(o["r_WS"]), _j(o["q_WS"]), _j(o["hp_W"]))


@pytest.mark.parametrize("weight", ["iso", "W22"])
def test_reprojection_error_matches_jax(obs, weight):
    res, J, valid = tfac.reprojection_error(SPEC, _t(INTR), _t(obs["kp"]), _t(obs[weight]),
                                            _se3(obs["r_WS"], obs["q_WS"]), _t(obs["hp_W"]),
                                            _se3(obs["r_SC"], obs["q_SC"]))
    jres, jJ, jvalid = _jax_reprojection(obs, obs[weight])
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert valid[:-3].all() and not valid[-3:].any()
    _close(res, jres, atol=1e-9)
    for name in ("J_pose", "J_hp", "J_ext"):
        _close(getattr(J, name), getattr(jJ, name), atol=1e-9, err_msg=name)


def test_reprojection_invalid_points_zero_the_jacobians_keep_the_residual(obs):
    res, J, valid = tfac.reprojection_error(SPEC, _t(INTR), _t(obs["kp"]), 1.0,
                                            _se3(obs["r_WS"], obs["q_WS"]), _t(obs["hp_W"]),
                                            _se3(obs["r_SC"], obs["q_SC"]))
    assert not valid[-3:].any()
    for name in ("J_pose", "J_hp", "J_ext"):
        assert float(getattr(J, name)[-3:].abs().max()) == 0.0
        assert float(getattr(J, name)[:-3].abs().max()) > 0.0
    assert float(res[-3:].abs().max()) > 0.0


def _num_jac_pose(apply, T, h=1e-7):
    eye = torch.eye(6, dtype=torch.float64)
    return torch.stack([(apply(tkin.oplus(T, h * eye[k])) - apply(tkin.oplus(T, -h * eye[k]))) / (2 * h)
                        for k in range(6)], dim=-1)


def _num_jac_vec(apply, x, h=1e-7):
    eye = torch.eye(x.shape[-1], dtype=torch.float64)
    return torch.stack([(apply(x + h * eye[k]) - apply(x - h * eye[k])) / (2 * h)
                        for k in range(x.shape[-1])], dim=-1)


def test_reprojection_jacobians_numeric(obs):
    """Analytic against central differences for one valid observation with
    a full 2x2 weight (tests/test_factors.py's tolerances)."""
    i = 0
    kp, W, hp = _t(obs["kp"][i]), _t(obs["W22"][i]), _t(obs["hp_W"][i])
    T_WS, T_SC = _se3(obs["r_WS"][i], obs["q_WS"][i]), _se3(obs["r_SC"], obs["q_SC"])

    def res(T_ws, T_sc, h):
        return tfac.reprojection_error(SPEC, _t(INTR), kp, W, T_ws, h, T_sc)[0]

    _, J, valid = tfac.reprojection_error(SPEC, _t(INTR), kp, W, T_WS, hp, T_SC)
    assert bool(valid)
    checks = dict(J_pose=_num_jac_pose(lambda T: res(T, T_SC, hp), T_WS),
                  J_ext=_num_jac_pose(lambda T: res(T_WS, T, hp), T_SC),
                  J_hp=_num_jac_vec(lambda d: res(T_WS, T_SC, torch.cat([hp[:3] + d, hp[3:]])),
                                    torch.zeros(3, dtype=torch.float64)))
    for name, Jn in checks.items():
        np.testing.assert_allclose(getattr(J, name).numpy(), Jn.numpy(), atol=1e-4, rtol=1e-5, err_msg=name)


# ------------------------------------------------------------------ IMU factor


@pytest.fixture(scope="module")
def links():
    """K = 4 links of the synthetic trajectory preintegrated by the port in
    float64 (linearized 0.002 away from sb0, so the bias correction is live),
    with random states around them."""
    traj = simulate_trajectory(duration=1.0, seed=9)
    rng = np.random.default_rng(5)
    K, P = 4, 42
    lo = np.arange(K) * 40
    ts = np.stack([traj.ts[a:a + P] - traj.ts[a] for a in lo])
    args = (_t(ts), _t(np.stack([traj.gyro[a:a + P] for a in lo])),
            _t(np.stack([traj.acc[a:a + P] for a in lo])), _t(np.zeros(K)), _t(ts[:, 40]))
    sb0 = np.concatenate([rng.normal(size=(K, 3)), 0.05 * rng.normal(size=(K, 6))], axis=1)
    sb1 = np.concatenate([rng.normal(size=(K, 3)), 0.05 * rng.normal(size=(K, 6))], axis=1)
    sb_ref = sb0.copy()
    sb_ref[:, 3:] += 0.002
    params = ImuParams.euroc(device="cpu")
    return dict(params=params, args=args, pre=preintegrate(params, *args, _t(sb_ref)),
                T0=(rng.normal(size=(K, 3)), _rand_q(rng, K)), T1=(rng.normal(size=(K, 3)), _rand_q(rng, K)),
                sb0=sb0, sb1=sb1)


def test_imu_error_matches_jax(links):
    pre = links["pre"]
    res, J = tfac.imu_error(links["params"], pre, _se3(*links["T0"]), _t(links["sb0"]),
                            _se3(*links["T1"]), _t(links["sb1"]))
    jpre = jimu.PreintegratedImu(*(_j(x) for x in pre))
    jres, jJ = jax.jit(jax.vmap(lambda p, r0, q0, s0, r1, q1, s1: jfac.imu_error(
        jimu.ImuParams.euroc(jnp.float64), p, jkin.SE3(r=r0, q=q0), s0, jkin.SE3(r=r1, q=q1), s1)))(
        jpre, *map(_j, links["T0"]), _j(links["sb0"]), *map(_j, links["T1"]), _j(links["sb1"]))
    scale = float(np.abs(np.asarray(jres)).max())
    _close(res, jres, atol=1e-10 * max(1.0, scale))
    for name in J._fields:
        want = np.asarray(getattr(jJ, name))
        _close(getattr(J, name), want, atol=1e-10 * max(1.0, np.abs(want).max()), err_msg=name)


def test_imu_error_jacobians_numeric(links):
    """Analytic minimal Jacobians against central differences over oplus
    perturbations (tests/test_imu.py's tolerances), for one link."""
    k = 1
    pre = type(links["pre"])(*(x[k] for x in links["pre"]))
    p = links["params"]
    T0, T1 = _se3(links["T0"][0][k], links["T0"][1][k]), _se3(links["T1"][0][k], links["T1"][1][k])
    sb0, sb1 = _t(links["sb0"][k]), _t(links["sb1"][k])
    res0, J = tfac.imu_error(p, pre, T0, sb0, T1, sb1)
    Jn = dict(J_pose0=_num_jac_pose(lambda T: tfac.imu_error(p, pre, T, sb0, T1, sb1)[0], T0),
              J_sb0=_num_jac_vec(lambda x: tfac.imu_error(p, pre, T0, x, T1, sb1)[0], sb0),
              J_pose1=_num_jac_pose(lambda T: tfac.imu_error(p, pre, T0, sb0, T, sb1)[0], T1),
              J_sb1=_num_jac_vec(lambda x: tfac.imu_error(p, pre, T0, sb0, T1, x)[0], sb1))
    scale = max(1.0, float(res0.abs().max()))
    for name, want in Jn.items():
        np.testing.assert_allclose(getattr(J, name).numpy(), want.numpy(), atol=2e-4 * scale, rtol=2e-4,
                                   err_msg=name)


def test_imu_residual_is_zero_at_the_propagated_state(links):
    p = links["params"]
    T0 = _se3([0.1, -0.2, 0.3], np.asarray([0.1, 0.2, -0.1, 0.9]) / np.linalg.norm([0.1, 0.2, -0.1, 0.9]))
    sb0 = _t([0.5, -0.3, 0.2, 0, 0, 0, 0, 0, 0])
    one = [a[0] for a in links["args"]]
    T1, sb1 = propagate(p, T0, sb0, *one, mean_only=False)
    res, _ = tfac.imu_error(p, preintegrate(p, *one, sb0), T0, sb0, T1, sb1)
    assert float(res.abs().max()) < 1e-6


# ------------------------------------------------------------------ priors


@pytest.fixture(scope="module")
def poses():
    rng = np.random.default_rng(4)
    M = 5
    T_a, T_b = (rng.normal(size=(M, 3)), _rand_q(rng, M)), (rng.normal(size=(M, 3)), _rand_q(rng, M))
    info6 = np.stack([np.diag(rng.uniform(1, 100, 6)) for _ in range(M)])
    return dict(T_a=T_a, T_b=T_b, info6=info6, sb=rng.normal(size=(2, M, 9)), hp=rng.normal(size=(2, M, 4)))


def test_sqrt_information_matches_jax(poses):
    info = poses["info6"] + 0.5
    _close(tfac.sqrt_information(_t(info)), jax.vmap(jfac.sqrt_information)(_j(info)), atol=1e-12)


def test_pose_and_relative_pose_errors_match_jax(poses):
    W = tfac.sqrt_information(_t(poses["info6"]))
    jW = _j(W.numpy())
    res, J = tfac.pose_error(_se3(*poses["T_a"]), W, _se3(*poses["T_b"]))
    jres, jJ = jax.vmap(lambda ra, qa, w, rb, qb: jfac.pose_error(jkin.SE3(r=ra, q=qa), w, jkin.SE3(r=rb, q=qb)))(
        *map(_j, poses["T_a"]), jW, *map(_j, poses["T_b"]))
    _close(res, jres)
    _close(J, jJ)
    res, J0, J1 = tfac.relative_pose_error(W, _se3(*poses["T_a"]), _se3(*poses["T_b"]))
    want = jax.vmap(lambda w, ra, qa, rb, qb: jfac.relative_pose_error(w, jkin.SE3(r=ra, q=qa), jkin.SE3(r=rb, q=qb)))(
        jW, *map(_j, poses["T_a"]), *map(_j, poses["T_b"]))
    for got, w in zip((res, J0, J1), want):
        _close(got, w)


def test_speed_bias_and_point_priors_match_jax(poses):
    W9 = tfac.sqrt_information(_t(np.eye(9) * 4.0 + 0.1))
    res, J = tfac.speed_and_bias_error(_t(poses["sb"][0]), W9, _t(poses["sb"][1]))
    jres, jJ = jax.vmap(jfac.speed_and_bias_error, in_axes=(0, None, 0))(
        _j(poses["sb"][0]), _j(W9.numpy()), _j(poses["sb"][1]))
    _close(res, jres)
    _close(J, jJ)
    W3 = tfac.sqrt_information(_t(np.eye(3) * 9.0))
    res, J = tfac.homogeneous_point_error(_t(poses["hp"][0]), W3, _t(poses["hp"][1]))
    jres, jJ = jax.vmap(jfac.homogeneous_point_error, in_axes=(0, None, 0))(
        _j(poses["hp"][0]), _j(W3.numpy()), _j(poses["hp"][1]))
    _close(res, jres)
    _close(J, jJ)


def test_pose_prior_jacobians_numeric(poses):
    T_meas, T_est = _se3(poses["T_a"][0][0], poses["T_a"][1][0]), _se3(poses["T_b"][0][0], poses["T_b"][1][0])
    W = tfac.sqrt_information(_t(poses["info6"][0]))
    _, J = tfac.pose_error(T_meas, W, T_est)
    Jn = _num_jac_pose(lambda T: tfac.pose_error(T_meas, W, T)[0], T_est)
    np.testing.assert_allclose(J.numpy(), Jn.numpy(), atol=1e-5)
    res0, _ = tfac.pose_error(T_meas, W, T_meas)
    np.testing.assert_allclose(res0.numpy(), np.zeros(6), atol=1e-12)
    T1 = tkin.oplus(T_meas, 0.05 * _t(np.random.default_rng(2).normal(size=6)))
    W25 = tfac.sqrt_information(_t(np.eye(6) * 25.0))
    _, J0, J1 = tfac.relative_pose_error(W25, T_meas, T1)
    np.testing.assert_allclose(J0.numpy(), _num_jac_pose(
        lambda T: tfac.relative_pose_error(W25, T, T1)[0], T_meas).numpy(), atol=1e-5)
    np.testing.assert_allclose(J1.numpy(), _num_jac_pose(
        lambda T: tfac.relative_pose_error(W25, T_meas, T)[0], T1).numpy(), atol=1e-5)


# ------------------------------------------------------------------ local parameterizations

POSES = [("PoseLocalParameterization", "Pose6d"), ("PoseLocalParameterization3d", "Pose3d"),
         ("PoseLocalParameterization4d", "Pose4d"), ("PoseLocalParameterization2d", "Pose2d")]


def _pose_vecs(rng, n=5):
    return np.concatenate([rng.normal(size=(n, 3)), _rand_q(rng, n)], axis=1)


@pytest.mark.parametrize("name,label", POSES, ids=[p[1] for p in POSES])
def test_pose_parameterization_matches_jax(name, label):
    tp, jp = getattr(tlp, name), getattr(jlp, name)
    assert (tp.name, tp.selection, tp.global_size, tp.local_size) == (label, jp.selection, 7, jp.local_size)
    np.testing.assert_array_equal(tp.tangent_mask(), jp.tangent_mask())
    rng = np.random.default_rng(len(label) + tp.local_size)
    x, d = _pose_vecs(rng), 1e-2 * rng.normal(size=(5, tp.local_size))
    _close(tp.plus(_t(x), _t(d)), jp.plus(_j(x), _j(d)), atol=1e-12)
    xp = tp.plus(_t(x), _t(d)).numpy()
    _close(tp.minus(_t(x), _t(xp)), jp.minus(_j(x), _j(xp)), atol=1e-12)
    _close(tp.plus_jacobian(_t(x)), jp.plus_jacobian(_j(x)), atol=1e-12)
    _close(tp.lift_jacobian(_t(x)), jp.lift_jacobian(_j(x)), atol=1e-12)
    for xi in x:  # the numeric self-check, and lift o plus = I
        assert tp.verify(_t(xi))
        np.testing.assert_allclose((tp.lift_jacobian(_t(xi)) @ tp.plus_jacobian(_t(xi))).numpy(),
                                   np.eye(tp.local_size), atol=1e-10)


def test_pose_parameterization_subsets_freeze_their_dims():
    """3d freezes translation; 4d freezes roll/pitch; 2d freezes translation
    and yaw: read in the full minimal difference."""
    x = _t(_pose_vecs(np.random.default_rng(42), 1)[0])

    def full_minus(xp):
        return tkin.minus(tkin.SE3(r=x[:3], q=x[3:]), tkin.SE3(r=xp[:3], q=xp[3:])).numpy()

    d3 = full_minus(tlp.PoseLocalParameterization3d.plus(x, _t([1e-3, 2e-3, -1e-3])))
    np.testing.assert_allclose(d3[:3], 0.0, atol=1e-12)
    d4 = full_minus(tlp.PoseLocalParameterization4d.plus(x, _t([1e-3, 2e-3, -1e-3, 5e-4])))
    np.testing.assert_allclose(d4[3:5], 0.0, atol=1e-9)
    d2 = full_minus(tlp.PoseLocalParameterization2d.plus(x, _t([1e-3, -2e-3])))
    np.testing.assert_allclose(d2[:3], 0.0, atol=1e-12)
    np.testing.assert_allclose(d2[5], 0.0, atol=1e-9)


def test_homogeneous_point_parameterization_matches_jax():
    p, jp = tlp.HomogeneousPointLocalParameterization, jlp.HomogeneousPointLocalParameterization
    assert (p.global_size, p.local_size) == (4, 3)
    rng = np.random.default_rng(8)
    hp, d = np.concatenate([rng.normal(size=(3, 3)), np.ones((3, 1))], axis=1), rng.normal(size=(3, 3))
    hp2 = p.plus(_t(hp), _t(d))
    _close(hp2, jp.plus(_j(hp), _j(d)), atol=0)
    _close(p.minus(_t(hp), hp2), d, atol=1e-12)
    _close(p.plus_jacobian(_t(hp)), jp.plus_jacobian(_j(hp)), atol=0)
    _close(p.lift_jacobian(_t(hp)), jp.lift_jacobian(_j(hp)), atol=0)
    np.testing.assert_allclose((p.lift_jacobian(_t(hp)) @ p.plus_jacobian(_t(hp))).numpy(),
                               np.broadcast_to(np.eye(3), (3, 3, 3)), atol=1e-14)
