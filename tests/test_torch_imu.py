"""The port's IMU preintegration, propagation and RK4 integration against the
JAX package, in float64 on the CPU: the same synthetic IMU stream (the
fine-integration world of tests/test_imu.py) through both. Increments and
covariances to 1e-10, sqrt_info to 1e-8 relative; the port's own properties
(padding invariance, boundary interpolation, saturation, mean-only form)
as tests/test_imu.py holds them for the JAX package."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis_tpu import kinematics as jkin
from okvis_tpu import imu as jimu
from okvis_tpu.imu.ode import propagate_rk4 as jpropagate_rk4
from okvis_tpu_torch import kinematics as tkin
from okvis_tpu_torch.convert import imu_params_from_numpy
from okvis_tpu_torch.imu import init_pose_from_imu, preintegrate, propagate
from okvis_tpu_torch.imu.ode import propagate_rk4
from okvis_tpu_torch.imu.preintegration import quat_prefix_product

from test_imu import simulate_imu

torch.set_num_threads(2)
P = 48  # samples a link in the batched cases
FIELDS = ("delta_q", "C_integral", "C_doubleintegral", "acc_integral", "acc_doubleintegral",
          "dalpha_db_g", "dv_db_g", "dp_db_g", "P_delta", "delta_t", "sb_ref")


def _t(a):
    return torch.from_numpy(np.array(a, np.float64))


def _links(ts, gyro, acc, rng):
    """Four links of P samples: clipped end, both ends between samples, a
    saturated gyro sample, and a padded tail (the last sample repeated)."""
    cases = []
    for k, (lo, t0, t1) in enumerate([(0, 0.0, ts[40]), (10, ts[13] + 0.4 / 200, ts[50] + 0.7 / 200),
                                      (60, ts[60], ts[100]), (120, ts[120], ts[164])]):
        T, G, A = ts[lo:lo + P].copy(), gyro[lo:lo + P].copy(), acc[lo:lo + P].copy()
        if k == 2:
            G[10] = [10.0, 0.0, 0.0]  # beyond g_max = 7.8
        if k == 3:
            T[45:], G[45:], A[45:] = T[44], G[44], A[44]
        sb = np.concatenate([rng.normal(0, 0.3, 3), rng.normal(0, 0.01, 3), rng.normal(0, 0.05, 3)])
        cases.append((T, G, A, t0, t1, sb))
    return [np.stack(x) for x in zip(*cases)]


@pytest.fixture(scope="module")
def world():
    """The JAX side once: batched full and mean-only preintegration,
    propagate, RK4."""
    ts, gyro, acc, states = simulate_imu(fine_dt=1e-4)  # midpoint truth, 50 steps a sample
    jparams = jimu.ImuParams.euroc(jnp.float64)
    links = _links(ts, gyro, acc, np.random.default_rng(7))
    batched = jax.jit(jax.vmap(jimu.preintegrate, in_axes=(None, 0, 0, 0, 0, 0, 0, None)),
                      static_argnums=7)
    T0 = jkin.SE3(r=jnp.asarray([0.1, -0.2, 0.3]), q=jkin.quat_normalize(jnp.asarray([0.1, 0.2, -0.1, 0.9])))
    sb0 = jnp.asarray([0.5, -0.3, 0.2, 0.01, -0.02, 0.01, 0.05, -0.04, 0.02])
    whole = (jnp.asarray(ts), jnp.asarray(gyro), jnp.asarray(acc), jnp.asarray(0.0), jnp.asarray(ts[-1]))
    return dict(
        ts=ts, gyro=gyro, acc=acc, states=states, links=links, T0=T0, sb0=sb0,
        tparams=imu_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu"),
        full=batched(jparams, *map(jnp.asarray, links), False),
        mean=batched(jparams, *map(jnp.asarray, links), True),
        prop=jax.jit(functools.partial(jimu.propagate, jparams))(T0, sb0, *whole),
        rk4=jpropagate_rk4(jparams, T0, sb0, *whole),
    )


def _port_links(world, mean_only=False):
    return preintegrate(world["tparams"], *map(_t, world["links"]), mean_only=mean_only)


def test_preintegrate_full_batched_matches_jax(world):
    got, want = _port_links(world), world["full"]
    for name in FIELDS:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-10, err_msg=name)
    # sqrt_info spans many decades: relative to each link's largest entry
    si, sj = got.sqrt_info.numpy(), np.asarray(want.sqrt_info)
    scale = np.abs(sj).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(si / scale, sj / scale, rtol=0, atol=1e-8)


def test_preintegrate_mean_only_matches_jax(world):
    got, want = _port_links(world, mean_only=True), world["mean"]
    for name in ("delta_q", "acc_integral", "acc_doubleintegral", "delta_t"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-10, err_msg=name)
    assert not got.P_delta.any() and not got.sqrt_info.any()


def test_mean_only_prefix_form_matches_sequential_full(world):
    """The log-depth quaternion doubling (in place of lax.associative_scan)
    reproduces the sequential scan's mean quantities, with clipped bounds
    and padded intervals."""
    full, mean = _port_links(world), _port_links(world, mean_only=True)
    for name in ("delta_q", "acc_integral", "acc_doubleintegral", "delta_t"):
        np.testing.assert_allclose(getattr(mean, name).numpy(), getattr(full, name).numpy(),
                                   rtol=0, atol=1e-10, err_msg=name)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 31])
def test_quat_prefix_product_equals_sequential(n):
    q = tkin.quat_normalize(torch.from_numpy(np.random.default_rng(n).normal(size=(2, n, 4))))
    want = [q[:, 0]]
    for i in range(1, n):
        want.append(tkin.quat_multiply(want[-1], q[:, i]))
    np.testing.assert_allclose(quat_prefix_product(q).numpy(), torch.stack(want, 1).numpy(), atol=1e-14)


def test_preintegrate_one_link_equals_its_batch_row(world):
    batch = _port_links(world)
    one = preintegrate(world["tparams"], *(_t(x[1]) for x in world["links"]))
    for name in FIELDS + ("sqrt_info",):
        np.testing.assert_allclose(getattr(one, name).numpy(), getattr(batch, name)[1].numpy(),
                                   rtol=1e-12, atol=1e-12, err_msg=name)


def test_padding_invariance(world):
    """Padded trailing samples do not change the result."""
    ts, gyro, acc = world["ts"], world["gyro"], world["acc"]
    t0, t1 = 0.0, float(ts[40])
    p = world["tparams"]
    pre_a = preintegrate(p, _t(ts[:45]), _t(gyro[:45]), _t(acc[:45]), t0, t1, torch.zeros(9, dtype=torch.float64))
    pad = lambda x: np.concatenate([x[:45], np.repeat(x[44:45], 20, axis=0)])  # noqa: E731
    pre_b = preintegrate(p, _t(pad(ts)), _t(pad(gyro)), _t(pad(acc)), t0, t1, torch.zeros(9, dtype=torch.float64))
    np.testing.assert_allclose(pre_a.delta_q.numpy(), pre_b.delta_q.numpy(), atol=1e-12)
    np.testing.assert_allclose(pre_a.P_delta.numpy(), pre_b.P_delta.numpy(), atol=1e-12)
    np.testing.assert_allclose(float(pre_a.delta_t), t1, atol=1e-12)


def test_boundary_interpolation(world):
    """t0 and t1 strictly between samples: delta_t equals t1 - t0."""
    ts = world["ts"]
    t0, t1 = float(ts[3]) + 0.4 / 200.0, float(ts[50]) + 0.7 / 200.0
    pre = preintegrate(world["tparams"], _t(ts), _t(world["gyro"]), _t(world["acc"]), t0, t1,
                       torch.zeros(9, dtype=torch.float64))
    np.testing.assert_allclose(float(pre.delta_t), t1 - t0, atol=1e-12)


def test_saturation_inflates_covariance(world):
    ts, gyro, acc = world["ts"], world["gyro"], world["acc"]
    args = lambda g: (world["tparams"], _t(ts), _t(g), _t(acc), 0.0, float(ts[30]),  # noqa: E731
                      torch.zeros(9, dtype=torch.float64))
    gyro_sat = gyro.copy()
    gyro_sat[10] = [10.0, 0.0, 0.0]  # beyond g_max = 7.8
    pre, pre_sat = preintegrate(*args(gyro)), preintegrate(*args(gyro_sat))
    assert float(torch.trace(pre_sat.P_delta[3:6, 3:6])) > 10 * float(torch.trace(pre.P_delta[3:6, 3:6]))


def _whole(world):
    ts = world["ts"]
    return (_t(ts), _t(world["gyro"]), _t(world["acc"]), 0.0, float(ts[-1]))


def _pose0(world):
    return tkin.SE3(r=_t(world["T0"].r), q=_t(world["T0"].q)), _t(world["sb0"])


def test_propagate_matches_jax(world):
    T0, sb0 = _pose0(world)
    T1, sb1 = propagate(world["tparams"], T0, sb0, *_whole(world))
    jT1, jsb1 = world["prop"]
    np.testing.assert_allclose(T1.r.numpy(), np.asarray(jT1.r), atol=1e-10)
    np.testing.assert_allclose(T1.q.numpy(), np.asarray(jT1.q), atol=1e-10)
    np.testing.assert_allclose(sb1.numpy(), np.asarray(jsb1), atol=1e-10)


def test_propagation_matches_ground_truth(world):
    """200 Hz trapezoid against fine integration over 1 s of aggressive motion
    (the tolerances of tests/test_imu.py)."""
    ts = world["ts"]
    r1, q1, v1 = world["states"][round(ts[-1], 9)]
    T0 = tkin.identity(device="cpu")
    T1, sb1 = propagate(world["tparams"], T0, torch.zeros(9, dtype=torch.float64), *_whole(world))
    np.testing.assert_allclose(T1.r.numpy(), r1, atol=2e-3)
    np.testing.assert_allclose(sb1[:3].numpy(), v1, atol=2e-3)
    dq = tkin.quat_multiply(tkin.quat_conjugate(T1.q), _t(q1))
    assert abs(float(dq[3])) > 1 - 1e-5


def test_propagate_rk4_matches_jax_and_the_trapezoid(world):
    T0, sb0 = _pose0(world)
    T_rk, sb_rk = propagate_rk4(world["tparams"], T0, sb0, *_whole(world))
    jT, jsb = world["rk4"]
    np.testing.assert_allclose(T_rk.r.numpy(), np.asarray(jT.r), atol=1e-10)
    np.testing.assert_allclose(T_rk.q.numpy(), np.asarray(jT.q), atol=1e-10)
    np.testing.assert_allclose(sb_rk.numpy(), np.asarray(jsb), atol=1e-10)
    T_tr, sb_tr = propagate(world["tparams"], T0, sb0, *_whole(world))
    np.testing.assert_allclose(T_rk.r.numpy(), T_tr.r.numpy(), atol=3e-3)
    np.testing.assert_allclose(sb_rk[:3].numpy(), sb_tr[:3].numpy(), atol=3e-3)


@pytest.mark.parametrize("acc", [[1.0, 0.5, 9.5], [0.0, 0.0, 9.81], [-2.0, 3.0, -8.0]])
def test_init_pose_from_imu_matches_jax(acc):
    T = init_pose_from_imu(_t(acc))
    jT = jimu.init_pose_from_imu(jnp.asarray(acc, jnp.float64))
    np.testing.assert_allclose(T.q.numpy(), np.asarray(jT.q), atol=1e-12)
    np.testing.assert_allclose(T.r.numpy(), np.zeros(3), atol=0)
    # the measured specific force, expressed in W, points along +z
    a_W = tkin.quat_rotate(T.q, _t(acc))
    np.testing.assert_allclose(a_W[:2].numpy(), np.zeros(2), atol=1e-9)
    assert float(a_W[2]) > 0
