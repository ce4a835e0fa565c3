"""The port's RANSAC, five-point solver, keyframe heuristic, numpy SE(3)
helpers and ATE against the JAX package, in float64 on the CPU.

Each case gives both packages the same numpy inputs; the JAX draws are
replayed into the port (`_u`: the uniforms that jax.random.uniform makes of
the key the JAX function consumes). Integer outputs (inliers, counts,
success) must be equal. Tolerances: models and roots to 1e-9 (the gap is
rounding of the same float64 arithmetic, <= 1e-11 measured), essential
matrices up to sign (an eigenvector's sign is LAPACK's choice), quartic
roots as a set of real parts and |imaginary| parts (conjugate pairs may
come out in either order), the numpy copies exactly. The truth checks of
tests/test_frontend.py (:164, :183, :203, :229, :236, :1042, :1096, :1128)
and tests/test_fivepoint.py run on the port's results as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis_tpu import kinematics as jkin
from okvis_tpu.datasets.synthetic import euroc_stereo_rig as jeuroc_stereo_rig
from okvis_tpu.eval import ate as jate
from okvis_tpu.frontend import fivepoint as jfive
from okvis_tpu.frontend import keyframe as jkf
from okvis_tpu.frontend import ransac as jr
from okvis_tpu.kinematics import np_se3 as jnp_se3
from okvis_tpu_torch.eval import ate as tate
from okvis_tpu_torch.frontend import fivepoint as tfive
from okvis_tpu_torch.frontend import keyframe as tkf
from okvis_tpu_torch.frontend import ransac as tr
from okvis_tpu_torch.kinematics import np_se3 as tnp_se3

torch.set_num_threads(2)
TOL = 1e-9


def _u(key, shape):
    """The uniforms the JAX function draws from `key`: (n_hyp, k), or for
    the rig (C, n_hyp, 3) from jax.random.split(key, C)."""
    if len(shape) == 3:
        return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, shape[1:]))
                                          for k in jax.random.split(key, shape[0])]))
    return torch.from_numpy(np.array(jax.random.uniform(key, shape)))


def _t(x):
    return torch.from_numpy(np.array(x))


def _same_result(got, want, model_up_to_sign=False):
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.num_inliers) == int(want.num_inliers)
    assert bool(got.success) == bool(want.success)
    g, w = got.model.numpy(), np.asarray(want.model)
    if model_up_to_sign:
        assert min(np.abs(g - w).max(), np.abs(g + w).max()) <= TOL
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


# ---------------------------------------------------------------- the mirrors


def test_ransac_rotation_only_matches_jax(rng):
    """:164: 30 % outliers; the rotation within 1e-4."""
    n = 100
    f_b = rng.normal(size=(n, 3))
    f_b /= np.linalg.norm(f_b, axis=1, keepdims=True)
    q_true = jkin.quat_normalize(jnp.asarray([0.1, -0.2, 0.15, 1.0]))
    f_a = np.array(jkin.quat_rotate(q_true[None], jnp.asarray(f_b)))
    out_idx = rng.choice(n, 30, replace=False)
    f_a[out_idx] = rng.normal(size=(30, 3))
    f_a /= np.linalg.norm(f_a, axis=1, keepdims=True)
    key = jax.random.PRNGKey(0)
    want = jr.ransac_rotation_only(key, jnp.asarray(f_a), jnp.asarray(f_b), jnp.ones(n, bool))
    got = tr.ransac_rotation_only(_u(key, (64, 2)), _t(f_a), _t(f_b), torch.ones(n, dtype=torch.bool))
    _same_result(got, want, model_up_to_sign=True)
    assert bool(got.success) and int(got.num_inliers) >= 65
    dq = jkin.quat_multiply(jkin.quat_conjugate(jnp.asarray(got.model.numpy())), q_true)
    assert abs(float(dq[3])) > 1 - 1e-4


def _absolute_scene(rng, planar):
    n = 120
    if planar:
        pts_W = np.concatenate([rng.uniform(-3, 3, (n, 2)), np.full((n, 1), 5.0)], axis=1)
    else:
        pts_W = rng.uniform(-3, 3, (n, 3)) + [0, 0, 8]
    q = jkin.quat_normalize(jnp.asarray([0.05, 0.1, -0.05, 1.0]))
    t = jnp.asarray([0.3, -0.2, 0.5])
    p_C = np.array(jkin.quat_rotate(q[None], jnp.asarray(pts_W))) + np.asarray(t)
    bear = p_C / np.linalg.norm(p_C, axis=1, keepdims=True)
    out_idx = rng.choice(n, 30, replace=False)
    noise = rng.normal(size=(30, 3))
    bear[out_idx] = np.abs(noise) if planar else noise
    bear /= np.linalg.norm(bear, axis=1, keepdims=True)
    return pts_W, bear, out_idx, q, t


@pytest.mark.parametrize("planar,seed", [(False, 1), (True, 5)])
def test_ransac_absolute_pose_matches_jax(rng, planar, seed):
    """:183 and :1096 (a strictly coplanar scene): the pose within 1e-3 rad
    and 5e-3 m of the truth, outliers rejected."""
    pts_W, bear, out_idx, q, t = _absolute_scene(rng, planar)
    n = len(pts_W)
    key = jax.random.PRNGKey(seed)
    want = jr.ransac_absolute_pose(key, jnp.asarray(pts_W), jnp.asarray(bear), jnp.ones(n, bool))
    got = tr.ransac_absolute_pose(_u(key, (64, 3)), _t(pts_W), _t(bear), torch.ones(n, dtype=torch.bool))
    _same_result(got, want)
    assert bool(got.success) and int(got.num_inliers) >= (85 if planar else 80)
    if planar:
        assert (~got.inliers.numpy()[out_idx]).sum() >= 28
    M = got.model.numpy().reshape(3, 4)
    np.testing.assert_allclose(M[:, :3], np.asarray(jkin.quat_to_matrix(q)), atol=1e-3)
    np.testing.assert_allclose(M[:, 3], np.asarray(t), atol=5e-3)


def test_ransac_relative_pose_matches_jax(rng):
    """:203: 35 of 150 outliers; the recovered inliers are > 90 % true."""
    n = 150
    pts = rng.uniform(-2, 2, (n, 3)) + [0, 0, 6]
    q = jkin.quat_normalize(jnp.asarray([0.02, 0.08, -0.03, 1.0]))
    t = np.asarray([0.5, 0.1, -0.2])
    f_a = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    p_B = np.array(jkin.quat_rotate(jkin.quat_conjugate(q)[None], jnp.asarray(pts - t)))
    f_b = p_B / np.linalg.norm(p_B, axis=1, keepdims=True)
    out_idx = rng.choice(n, 35, replace=False)
    f_b[out_idx] = rng.normal(size=(35, 3))
    f_b /= np.linalg.norm(f_b, axis=1, keepdims=True)
    key = jax.random.PRNGKey(2)
    want = jr.ransac_relative_pose(key, jnp.asarray(f_a), jnp.asarray(f_b), jnp.ones(n, bool))
    got = tr.ransac_relative_pose(_u(key, (64, 8)), _t(f_a), _t(f_b), torch.ones(n, dtype=torch.bool))
    _same_result(got, want, model_up_to_sign=True)
    assert bool(got.success) and int(got.num_inliers) >= 90
    true_inl = np.ones(n, bool)
    true_inl[out_idx] = False
    rec = got.inliers.numpy()
    assert (rec & true_inl).sum() / rec.sum() > 0.9


def test_sample_indices_match_jax_nonzero_lookup(rng):
    """The sync-free stable-argsort lookup gives the JAX package's
    nonzero(size=N, fill_value=0) indices wherever a draw can land, with a
    sparse mask, a full one and an empty one (index 0)."""
    for mask in (rng.uniform(size=50) < 0.3, np.ones(50, bool), np.zeros(50, bool)):
        key = jax.random.PRNGKey(int(mask.sum()))
        u = jax.random.uniform(key, (64, 8))
        n = max(int(mask.sum()), 1)
        idx = np.minimum((np.asarray(u) * n).astype(np.int32), 49)
        want = np.asarray(jnp.nonzero(jnp.asarray(mask), size=50, fill_value=0)[0])[idx]
        np.testing.assert_array_equal(tr._sample_indices(_t(u), _t(mask)).numpy(), want)


def test_convex_hull_and_area_match_jax():
    """:229."""
    sq = np.asarray([[0, 0], [2, 0], [2, 2], [0, 2], [1, 1]], np.float64)
    hull = tkf.convex_hull(sq)
    np.testing.assert_array_equal(hull, jkf.convex_hull(sq))
    assert len(hull) == 4 and abs(tkf.polygon_area(hull) - 4.0) < 1e-12


def test_need_new_keyframe_logic_matches_jax(rng):
    """:236, and the point-in-hull test on the same points."""
    pts = rng.uniform(0, 100, (200, 2))
    corner = (pts[:, 0] < 20) & (pts[:, 1] < 20)
    cases = [
        (np.ones(200, bool), {}), (np.zeros(200, bool), {}), (corner, {}),
        (np.ones(200, bool), dict(num_frames=1)), (np.zeros(200, bool), dict(is_initialized=False)),
    ]
    want_expected = [False, True, True, True, False]
    for (matched, kw), expected in zip(cases, want_expected):
        got = tkf.need_new_keyframe([pts], [matched], **kw)
        assert got == jkf.need_new_keyframe([pts], [matched], **kw) == expected
    hull = tkf.convex_hull(pts[corner])
    np.testing.assert_array_equal(tkf.points_in_polygon(pts, hull), jkf.points_in_polygon(pts, hull))


def _rig_case(rng, planar):
    """:1042 (8 and 5 correspondences; cam 1 alone cannot form a hypothesis)
    and :1128 (a wall of 40 a camera); one cam-1 bearing rotated ~1 deg."""
    _, T_SC, intrinsics = jeuroc_stereo_rig()
    r_SC, q_SC = np.asarray(T_SC.r), np.asarray(T_SC.q)
    C = 2
    K, counts = (64, [40, 40]) if planar else (16, [8, 5])
    pts, bear, sel = np.zeros((C, K, 3)), np.zeros((C, K, 3)), np.zeros((C, K), bool)
    jitter = rng.uniform(-0.7, 0.7, (C, K))
    for c in range(C):
        T = jkin.SE3(r=jnp.asarray(r_SC[c]), q=jnp.asarray(q_SC[c]))
        for i in range(counts[c]):
            if planar:
                p_C = np.asarray([((i % 8) - 3.5) * 0.4, ((i // 8) - 2.0) * 0.35, 4.0])
            else:
                p_C = np.asarray([((i % 4) - 1.5) * 0.5, ((i // 4) - 1.0) * 0.45, 4.0 + 0.35 * i + jitter[c, i]])
            pts[c, i] = np.asarray(jkin.transform_point(T, jnp.asarray(p_C)))
            bear[c, i] = p_C / np.linalg.norm(p_C)
            sel[c, i] = True
    bad = 7 if planar else 2
    ang = 0.02 if planar else 0.018
    v = bear[1, bad]
    perp = np.cross(v, [0.0, 0.0, 1.0])
    perp /= np.linalg.norm(perp)
    bear[1, bad] = v * np.cos(ang) + perp * np.sin(ang)
    focal = np.asarray([float(intrinsics[c][0]) for c in range(C)])
    return r_SC, q_SC, pts, bear, sel, focal, counts, bad


@pytest.mark.parametrize("planar,seed", [(False, 11), (True, 13)])
def test_rig_ransac_matches_jax(rng, planar, seed):
    """:1042 and :1128: the pooled RANSAC catches the cam-1 outlier."""
    r_SC, q_SC, pts, bear, sel, focal, counts, bad = _rig_case(rng, planar)
    key = jax.random.PRNGKey(seed)
    want = jr.ransac_absolute_rig(key, *(jnp.asarray(x) for x in (r_SC, q_SC, pts, bear, sel, focal)),
                                  threshold_px2=jnp.asarray(9.0))
    got = tr.ransac_absolute_rig(_u(key, (2, 64, 3)), *(_t(x) for x in (r_SC, q_SC, pts, bear, sel, focal)),
                                 threshold_px2=9.0)
    _same_result(got, want)
    inl = got.inliers.numpy()
    assert bool(got.success) and int(got.num_inliers) == sum(counts) - 1
    assert not inl[1, bad]


def test_dlt_models_match_jax_up_to_the_eigenvector_sign(rng):
    """The 6-point DLT kept for study: its model depends on the sign of the
    null vector LAPACK returns, so each package's model must be one of the
    two that the two signs give (computed here in numpy from the same
    samples) wherever the sample has a one-dimensional null space, and
    where both packages picked the same sign they agree."""
    n = 40
    pts = rng.uniform(-3, 3, (n, 3)) + [0, 0, 8]
    uv = pts[:, :2] / pts[:, 2:3] + rng.normal(0, 1e-3, (n, 2))
    mask = rng.uniform(size=n) < 0.8
    key = jax.random.PRNGKey(3)
    want = np.asarray(jr._dlt_absolute_models(key, jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(mask), 64))
    u = _u(key, (64, 6))
    got = tr._dlt_absolute_models(u, _t(pts), _t(uv), _t(mask)).numpy()
    idx = tr._sample_indices(u, _t(mask)).numpy()

    def model(p):
        U, s, Vt = np.linalg.svd(p[:, :3])
        d = np.sign(np.linalg.det(U @ Vt))
        R = U @ np.diag([1.0, 1.0, d]) @ Vt
        scale = np.mean(s) * d
        return np.concatenate([R, (p[:, 3] / (1.0 if abs(scale) < 1e-12 else scale))[:, None]], axis=1)

    same = checked = 0
    for h in range(64):
        P, x = pts[idx[h]], uv[idx[h]]
        Ph = np.concatenate([P, np.ones((6, 1))], axis=1)
        A = np.concatenate([np.concatenate([Ph, 0 * Ph, -x[:, :1] * Ph], 1),
                            np.concatenate([0 * Ph, Ph, -x[:, 1:] * Ph], 1)])
        w, V = np.linalg.eigh(A.T @ A)
        if len(set(idx[h])) < 6 or w[1] < 1e-6 * w[-1]:
            continue  # a repeated index leaves a null space of more than one dimension
        checked += 1
        p = V[:, 0].reshape(3, 4)
        both = (model(p), model(-p))
        for m in (got[h], want[h]):
            assert min(np.abs(m - b).max() for b in both) < 1e-6, h
        if np.abs(got[h] - want[h]).max() < 1e-6:
            same += 1
    assert checked >= 20 and same > 0


# ---------------------------------------------------------------- quartic, decomposition


def test_solve_quartic_matches_jax(rng):
    """The Ferrari roots of random quartics: real parts and |imaginary|
    parts as sets, in float64 (complex128) and float32 (complex64, to
    1e-3 relative)."""
    co = rng.normal(size=(5, 200))
    for dt, tol in ((np.float64, TOL), (np.float32, 1e-3)):
        want = np.asarray(jr._solve_quartic(*(jnp.asarray(c.astype(dt)) for c in co)))
        got = tr._solve_quartic(*(_t(c.astype(dt)) for c in co)).numpy()
        assert got.dtype == want.dtype == (np.complex128 if dt == np.float64 else np.complex64)
        key = lambda r: np.sort(r.real + 1j * np.abs(r.imag), axis=-1)  # noqa: E731
        scale = np.maximum(1.0, np.abs(want))
        np.testing.assert_allclose(key(got).real, key(want).real, rtol=0, atol=tol * scale.max())
        np.testing.assert_allclose(np.abs(key(got).imag), np.abs(key(want).imag), rtol=0, atol=tol * scale.max())


def test_p3p_kneip_matches_jax(rng):
    """The four candidate poses of a batch of samples, and the true pose
    among them."""
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    R *= np.sign(np.linalg.det(R))
    c = np.asarray([0.1, 0.2, 0.3])
    for _ in range(5):
        P = rng.normal(size=(3, 3)) + [0, 0, 5]
        f = (P - c) @ R
        f /= np.linalg.norm(f, axis=1, keepdims=True)
        want = np.asarray(jr._p3p_kneip(jnp.asarray(P), jnp.asarray(f)))
        got = tr._p3p_kneip(_t(P), _t(f)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)
        err = [np.abs(g[:, :3] - R).max() + np.abs(g[:, 3] - c).max() for g in got if np.isfinite(g).all()]
        assert min(err) < 1e-6


def test_decompose_essential_matches_jax(rng):
    """The cheirality vote picks the true (R, t) in both packages."""
    n = 60
    pts = rng.uniform(-2, 2, (n, 3)) + [0, 0, 6]
    ang = 0.1
    R = np.asarray(jkin.quat_to_matrix(jkin.quat_normalize(jnp.asarray([0.0, np.sin(ang / 2), 0.0,
                                                                        np.cos(ang / 2)]))))
    t = np.asarray([0.4, 0.05, -0.1])
    f_b = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    p_a = pts @ R.T + t
    f_a = p_a / np.linalg.norm(p_a, axis=1, keepdims=True)
    tx = np.asarray([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = tx @ R
    mask = np.ones(n, bool)
    want_R, want_t = jr.decompose_essential(*(jnp.asarray(x) for x in (E, f_a, f_b, mask)))
    got_R, got_t = tr.decompose_essential(*(_t(x) for x in (E, f_a, f_b, mask)))
    np.testing.assert_allclose(got_R.numpy(), np.asarray(want_R), rtol=0, atol=TOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=0, atol=TOL)
    np.testing.assert_allclose(got_R.numpy(), R, atol=1e-9)
    np.testing.assert_allclose(got_t.numpy(), t / np.linalg.norm(t), atol=1e-9)


# ---------------------------------------------------------------- numpy copies


def test_five_point_copy_matches_jax():
    """tests/test_fivepoint.py's cases on the port's copy: the same
    candidates and RANSAC results as the JAX package's module."""
    import test_fivepoint as tf

    rng = np.random.default_rng(7)
    for _ in range(5):
        fa, fb, E_gt = tf._make_pair(rng, 5)
        xa, xb = fa[:, :2] / fa[:, 2:3], fb[:, :2] / fb[:, 2:3]
        got, want = tfive.essential_five_point(xa, xb), jfive.essential_five_point(xa, xb)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert min(tf._e_dist(E / np.linalg.norm(E), E_gt) for E in got) < 1e-6
    rng = np.random.default_rng(3)
    fa, fb, _ = tf._make_pair(rng, 60, noise=0.001, n_out=15)
    args = (fa, fb, np.ones(60, bool))
    kw = dict(focal=460.0, threshold_px2=9.0, n_iters=50, seed=5)
    got, want = tfive.ransac_relative_pose_5pt(*args, **kw), jfive.ransac_relative_pose_5pt(*args, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and got[3] == want[3] and got[3]
    np.testing.assert_array_equal(got[2], want[2])
    assert got[0][:15].sum() <= 2 and got[0][15:].sum() >= 0.85 * 45


def test_np_se3_copy_matches_jax(rng):
    for _ in range(5):
        r1, r2 = rng.normal(size=3), rng.normal(size=3)
        q1, q2 = (q / np.linalg.norm(q) for q in rng.normal(size=(2, 4)))
        for name, args in (("compose", (r1, q1, r2, q2)), ("inverse", (r1, q1)), ("relative", (r1, q1, r2, q2))):
            for a, b in zip(getattr(tnp_se3, name)(*args), getattr(jnp_se3, name)(*args)):
                np.testing.assert_array_equal(a, b)
        C = tnp_se3.quat_to_matrix(q1)
        np.testing.assert_array_equal(C, jnp_se3.quat_to_matrix(q1))
        np.testing.assert_array_equal(tnp_se3.matrix_to_quat(C), jnp_se3.matrix_to_quat(C))


def test_ate_copy_matches_jax(rng):
    """The Umeyama-aligned ATE of a rotated, shifted, noisy trajectory, with
    and without scale, and the timestamp association."""
    n = 50
    gt = np.cumsum(rng.normal(size=(n, 3)), axis=0)
    ang = 0.3
    R = np.asarray([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    est = gt @ R.T + [1.0, -2.0, 0.5] + rng.normal(0, 0.05, (n, 3))
    ts = np.arange(n, dtype=np.int64) * 50_000_000
    for with_scale in (False, True):
        got = tate.ate_rmse(ts + 3_000_000, est, ts, gt, with_scale=with_scale)
        assert got == jate.ate_rmse(ts + 3_000_000, est, ts, gt, with_scale=with_scale)
        assert 0.03 < got < 0.15
    for a, b in zip(tate.associate(ts[::2], ts + 1), jate.associate(ts[::2], ts + 1)):
        np.testing.assert_array_equal(a, b)
