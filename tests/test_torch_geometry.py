"""okvis_tpu_torch geometry against the JAX package, float64 on the CPU:
SO(3)/SE(3) ops, the four distortion models with their Gauss-Newton undistort,
pinhole projection, its Jacobians, back-projection and rig overlaps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis_tpu import kinematics as jkin
from okvis_tpu.cameras import distortion as jdist
from okvis_tpu.cameras import pinhole as jph
from okvis_tpu.cameras.ncamera import NCameraSystem as JNCameraSystem
from okvis_tpu_torch import kinematics as tkin
from okvis_tpu_torch.cameras import distortion as tdist
from okvis_tpu_torch.cameras import pinhole as tph
from okvis_tpu_torch.cameras.ncamera import NCameraSystem as TNCameraSystem

torch.set_num_threads(2)
TOL = 1e-10  # float64 on both sides; only summation order differs


def _j(x):
    return jnp.asarray(np.asarray(x, np.float64))


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=tol)


def _rand_quat(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _inputs():
    rng = np.random.default_rng(0)
    n = 24
    # rotation vectors from 1e-9 rad (series branches) to 3 rad
    phi = rng.normal(size=(n, 3)) * np.logspace(-9, 0.5, n)[:, None]
    return dict(
        q1=_rand_quat(rng, n), q2=_rand_quat(rng, n), v=rng.normal(size=(n, 3)),
        phi=phi, r1=rng.normal(size=(n, 3)), r2=rng.normal(size=(n, 3)),
        hp=np.concatenate([rng.normal(size=(n, 3)), rng.uniform(-1, 1, (n, 1))], axis=1),
        delta=np.concatenate([rng.normal(size=(n, 3)), phi], axis=1),
    )


# name -> fn(kin module, arr converter, inputs); both packages share the names
SO3_CASES = {
    "sinc": lambda m, a, x: m.sinc(a(x["phi"][:, 0])),
    "quat_multiply": lambda m, a, x: m.quat_multiply(a(x["q1"]), a(x["q2"])),
    "quat_conjugate": lambda m, a, x: m.quat_conjugate(a(x["q1"])),
    "quat_normalize": lambda m, a, x: m.quat_normalize(3.0 * a(x["q1"])),
    "quat_to_matrix": lambda m, a, x: m.quat_to_matrix(a(x["q1"])),
    "matrix_to_quat": lambda m, a, x: m.matrix_to_quat(m.quat_to_matrix(a(x["q1"]))),
    "quat_rotate": lambda m, a, x: m.quat_rotate(a(x["q1"]), a(x["v"])),
    "delta_q": lambda m, a, x: m.delta_q(a(x["phi"])),
    "cross_matrix": lambda m, a, x: m.cross_matrix(a(x["v"])),
    "quat_left": lambda m, a, x: m.quat_left(a(x["q1"])),
    "quat_right": lambda m, a, x: m.quat_right(a(x["q1"])),
    "right_jacobian": lambda m, a, x: m.right_jacobian(a(x["phi"])),
}


@pytest.mark.parametrize("name", sorted(SO3_CASES))
def test_so3_matches_jax(name):
    x = _inputs()
    _close(SO3_CASES[name](tkin, _t, x), SO3_CASES[name](jkin, _j, x))


def _se3(m, a, r, q):
    return m.SE3(r=a(r), q=a(q))


SE3_CASES = {
    "compose": lambda m, a, x: tuple(m.compose(_se3(m, a, x["r1"], x["q1"]), _se3(m, a, x["r2"], x["q2"]))),
    "inverse": lambda m, a, x: tuple(m.inverse(_se3(m, a, x["r1"], x["q1"]))),
    "transform_point": lambda m, a, x: m.transform_point(_se3(m, a, x["r1"], x["q1"]), a(x["v"])),
    "transform_hpoint": lambda m, a, x: m.transform_hpoint(_se3(m, a, x["r1"], x["q1"]), a(x["hp"])),
    "oplus": lambda m, a, x: tuple(m.oplus(_se3(m, a, x["r1"], x["q1"]), a(x["delta"]))),
    "minus": lambda m, a, x: m.minus(_se3(m, a, x["r1"], x["q1"]), _se3(m, a, x["r2"], x["q2"])),
    "oplus_jacobian": lambda m, a, x: m.oplus_jacobian(_se3(m, a, x["r1"], x["q1"])),
    "lift_jacobian": lambda m, a, x: m.lift_jacobian(_se3(m, a, x["r1"], x["q1"])),
    "matrix": lambda m, a, x: _se3(m, a, x["r1"], x["q1"]).matrix(),
    "from_matrix": lambda m, a, x: tuple(m.from_matrix(_se3(m, a, x["r1"], x["q1"]).matrix())),
}


@pytest.mark.parametrize("name", sorted(SE3_CASES))
def test_se3_matches_jax(name):
    x = _inputs()
    got, want = SE3_CASES[name](tkin, _t, x), SE3_CASES[name](jkin, _j, x)
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        _close(g, w)


DIST_PARAMS = {
    "none": [],
    "radtan": [-0.28, 0.07, 2.0e-4, 1.8e-5],
    "radtan8": [-0.3, 0.09, 1.0e-4, -2.0e-4, 0.01, 0.02, 0.004, 0.001],
    "equidistant": [-0.012, 0.021, -0.006, 0.001],
}


def _camera(dist_type):
    spec = (752, 480, dist_type)
    intr = np.asarray([461.4, 460.2, 363.0, 248.1, *DIST_PARAMS[dist_type]])
    return jph.CameraSpec(*spec), tph.CameraSpec(*spec), intr


def _points(rng, n=64):
    z = rng.uniform(0.5, 10.0, n)
    p = np.stack([rng.uniform(-0.7, 0.7, n) * z, rng.uniform(-0.5, 0.5, n) * z, z], axis=1)
    p[:4, 2] *= -1.0  # behind the camera
    p[4:8, :2] *= 4.0  # outside the image
    return p


@pytest.mark.parametrize("dist_type", sorted(DIST_PARAMS))
def test_projection_and_jacobians_match_jax(dist_type):
    jspec, tspec, intr = _camera(dist_type)
    rng = np.random.default_rng(1)
    p = _points(rng)
    hp = np.concatenate([p, rng.uniform(-1.0, 1.0, (len(p), 1))], axis=1)
    ji, ti = _j(intr), _t(intr)

    uv_j, fl_j = jax.jit(jax.vmap(lambda x: jph.project(jspec, ji, x)))(_j(p))
    uv_t, fl_t = tph.project(tspec, ti, _t(p))
    _close(uv_t, uv_j)
    np.testing.assert_array_equal(_np(fl_t), _np(fl_j))
    uvh_j, flh_j = jax.jit(jax.vmap(lambda x: jph.project_homogeneous(jspec, ji, x)))(_j(hp))
    uvh_t, flh_t = tph.project_homogeneous(tspec, ti, _t(hp))
    _close(uvh_t, uvh_j)
    np.testing.assert_array_equal(_np(flh_t), _np(flh_j))

    front = p[8:]  # Jacobians where the projection is defined
    _close(tph.project_jacobian_point(tspec, ti, _t(front)),
           jax.jit(jax.vmap(lambda x: jph.project_jacobian_point(jspec, ji, x)))(_j(front)))
    _close(tph.project_homogeneous_jacobian(tspec, ti, _t(hp[8:])),
           jax.jit(jax.vmap(lambda x: jph.project_homogeneous_jacobian(jspec, ji, x)))(_j(hp[8:])))
    _close(tph.project_jacobian_intrinsics(tspec, ti, _t(front)),
           jax.jit(jax.vmap(lambda x: jph.project_jacobian_intrinsics(jspec, ji, x)))(_j(front)))


@pytest.mark.parametrize("dist_type", sorted(DIST_PARAMS))
def test_undistort_and_back_project_match_jax(dist_type):
    jspec, tspec, intr = _camera(dist_type)
    rng = np.random.default_rng(2)
    uv = np.stack([rng.uniform(0, 752, 96), rng.uniform(0, 480, 96)], axis=1)
    ji, ti = _j(intr), _t(intr)
    _close(tph.back_project(tspec, ti, _t(uv)),
           jax.jit(jax.vmap(lambda x: jph.back_project(jspec, ji, x)))(_j(uv)))
    xy = rng.uniform(-0.6, 0.6, (96, 2))
    dp = intr[4:]
    _close(tdist.distort(dist_type, _t(dp), _t(xy)),
           jax.jit(jax.vmap(lambda x: jdist.distort(dist_type, _j(dp), x)))(_j(xy)))
    _close(tdist.undistort(dist_type, _t(dp), _t(xy)),
           jax.jit(jax.vmap(lambda x: jdist.undistort(dist_type, _j(dp), x)))(_j(xy)))
    _close(tdist.distort_jacobian(dist_type, _t(dp), _t(xy)),
           jax.jit(jax.vmap(lambda x: jdist.distort_jacobian(dist_type, _j(dp), x)))(_j(xy)))
    _close(tdist.distort_param_jacobian(dist_type, _t(dp), _t(xy)),
           jax.jit(jax.vmap(lambda x: jax.jacfwd(lambda k: jdist.distort(dist_type, k, x))(_j(dp))))(_j(xy)))


def test_rig_overlaps_match_jax():
    from okvis_tpu.datasets.synthetic import euroc_stereo_rig

    from okvis_tpu_torch.convert import rig_from_numpy

    specs, T_SC, intr = euroc_stereo_rig()
    jrig = JNCameraSystem(specs=tuple(specs), T_SC=T_SC, intrinsics=intr)
    jrig.compute_overlaps()
    trig = rig_from_numpy([(s.width, s.height, s.dist_type) for s in specs],
                          np.asarray(T_SC.r), np.asarray(T_SC.q),
                          [np.asarray(i) for i in intr], device="cpu")
    assert isinstance(trig, TNCameraSystem)
    np.testing.assert_array_equal(trig.overlaps, jrig.overlaps)
    for a in range(2):
        for b in range(2):
            np.testing.assert_array_equal(trig.overlap_mats[a][b], jrig.overlap_mats[a][b])
