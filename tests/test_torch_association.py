"""The port's association programs (frontend/kernels.py) against the JAX
package's, in float64 on the CPU.

Inputs are numpy, made from a seed, and go to both packages: the random
inputs of tests/test_frontend.py's fused-kernel cases, and a structured
scene of projected landmarks (datasets.synthetic.keypoint_frames: sources
with half their keypoints carrying true landmarks, the current frame at a
slightly perturbed pose). RANSAC draws: the uniforms the JAX function draws
from its key are passed to the port. Integer outputs (assignments, flags,
inliers, counts) must be equal; floats (homogeneous points, projections,
covariances, chi², bearings) to 1e-12 relative plus 1e-9 absolute
[measured <= 6e-16 relative]. Mirrors tests/test_frontend.py :616, :652, :674, :711,
:748; the batched mutual_best_assignment against jax.vmap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis_tpu import kinematics as jkin
from okvis_tpu.cameras import pinhole as jph
from okvis_tpu.cameras.pinhole import CameraSpec as JCameraSpec
from okvis_tpu.datasets.synthetic import euroc_stereo_rig as jeuroc_stereo_rig
from okvis_tpu.frontend import kernels as jker
from okvis_tpu.ops import hamming as jham
from okvis_tpu_torch import kinematics as tkin
from okvis_tpu_torch.cameras.pinhole import CameraSpec
from okvis_tpu_torch.datasets.synthetic import association_scene
from okvis_tpu_torch.frontend import kernels as tker
from okvis_tpu_torch.ops import hamming as tham
from test_torch_estimator import port_rig

torch.set_num_threads(2)
TOL = 1e-9
RTOL = 1e-12


def _t(x, dtype=None):
    x = np.array(x)
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    t = torch.from_numpy(x)
    return t if dtype is None else t.to(dtype)


def _jse3(r, q):
    return jkin.SE3(r=jnp.asarray(r), q=jnp.asarray(q))


def _tse3(r, q):
    return tkin.SE3(r=_t(r), q=_t(q))


def _u(key, C, n_hyp=64):
    return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, (n_hyp, 3)))
                                      for k in jax.random.split(key, C)]))


def _close(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=TOL, err_msg=what)


# ---------------------------------------------------------------- inputs


def random_inputs(rng, P=2, C=2, K=24):
    """tests/test_frontend.py's _random_assoc_inputs as numpy."""
    d = dict(
        spec=(640, 480, "radtan"),
        intr=np.tile([460.0, 455.0, 320.0, 240.0, -0.28, 0.07, 1e-4, -2e-5], (C, 1)),
        desc_a=rng.integers(0, 2**32, (P, C, K, 16), dtype=np.uint32),
        desc_b=rng.integers(0, 2**32, (C, K, 16), dtype=np.uint32),
    )
    d["sel3d"] = rng.random((P, C, K)) < 0.4
    d["free2"] = ~d["sel3d"] & (rng.random((P, C, K)) < 0.6)
    d["free_b"] = rng.random((C, K)) < 0.8
    d["hp"] = np.concatenate([rng.normal(0, 2, (P, C, K, 3)) + [0, 0, 6.0], np.ones((P, C, K, 1))], axis=-1)
    d["uv_a"] = rng.uniform(100, 500, (P, C, K, 2))
    d["uv_b"] = rng.uniform(100, 500, (C, K, 2))

    def rand_pose(shape):
        q = rng.normal(0, 1, shape + (4,))
        return rng.normal(0, 0.5, shape + (3,)), q / np.linalg.norm(q, axis=-1, keepdims=True)

    d["T_WS_b"] = rand_pose(())
    d["T_WC_a"] = rand_pose((P, C))
    d["T_SC"] = (np.zeros((C, 3)), np.tile([0.0, 0, 0, 1.0], (C, 1)))
    d["sb_b"] = np.zeros(9)
    d["std_b"] = np.full((C, K), 0.8 * 8.0 / 12.0)
    d["std_a"] = np.full((P, C, K), 0.8 * 8.0 / 12.0)
    d["sel_prev"] = np.zeros((C, K), bool)
    d["pts_prev"] = np.zeros((C, K, 3))
    return d


def scene_inputs(P=2, K=48, seed=3, pose_noise=0.02):
    return association_scene(port_rig(), P, K, seed=seed, pose_noise=pose_noise)


ORDER = ("desc_a", "sel3d", "hp", "free2", "uv_a", "std_a", "T_WS_b", "sb_b", "T_WC_a", "desc_b", "free_b", "uv_b",
         "std_b", "sel_prev", "pts_prev", "T_SC")


def jax_args(d):
    spec = JCameraSpec(*d["spec"])
    args = [jnp.asarray(d[k]) if not k.startswith("T_") else _jse3(*d[k]) for k in ORDER]
    return spec, jnp.asarray(d["intr"]), args


def port_args(d):
    spec = CameraSpec(*d["spec"])
    args = [_t(d[k]) if not k.startswith("T_") else _tse3(*d[k]) for k in ORDER]
    return spec, _t(d["intr"]), args


def _camera(args, c):
    """The per-camera slice of the association inputs (associate_onecam's)."""
    out = []
    for k, a in zip(ORDER, args):
        if k in ("T_WS_b", "sb_b"):
            out.append(a)
        elif k == "T_WC_a":
            out.append(type(a)(r=a.r[:, c], q=a.q[:, c]))
        elif k == "T_SC":
            out.append(type(a)(r=a.r[c], q=a.q[c]))
        elif k in ("desc_a", "sel3d", "hp", "free2", "uv_a", "std_a"):
            out.append(a[:, c])
        else:
            out.append(a[c])
    return out


def _same_round(got, want, stereo=True):
    names = ("assign3", "assign2", "hp", "valid", "parallel", "can_init", "ransac_inliers", "ransac_num",
             "ransac_success")
    for name, g, w in zip(names, got, want):
        _close(g, w, name)
    if stereo:
        for name, g, w in zip(("assign", "hp", "valid", "parallel", "can_init"), got[9], want[9]):
            _close(g, w, f"stereo {name}")


# ---------------------------------------------------------------- assignment


@pytest.mark.parametrize("ratio", [0.0, 0.8])
def test_batched_assignment_matches_jax_vmap(rng, ratio):
    """(2, 3, 40, 30) distance matrices of values 0..5 (ties everywhere) and
    of Hamming distances: each slice equals jax.vmap of the JAX function."""
    d = rng.integers(0, 6, (2, 3, 40, 30)).astype(np.int32)
    want = jax.vmap(jax.vmap(lambda x: jham.mutual_best_assignment(x, 4, distance_ratio=ratio)))(jnp.asarray(d))
    _close(tham.mutual_best_assignment(_t(d), 4, distance_ratio=ratio), want)
    a = rng.integers(0, 2**32, (6, 50, 16), dtype=np.uint32)
    b = a[:, rng.permutation(50)] ^ (rng.random((6, 50, 16)) < 0.01).astype(np.uint32)
    ma, mb = rng.random((6, 50)) < 0.9, rng.random((6, 50)) < 0.9
    jd = jax.vmap(jham.masked_distance_matrix)(*(jnp.asarray(x) for x in (a, b, ma, mb)))
    want = jax.vmap(lambda x: jham.mutual_best_assignment(x, 60, distance_ratio=ratio))(jd)
    got = tham.match_descriptors(_t(a), _t(b), _t(ma), _t(mb), threshold=60) if ratio == 0 else \
        tham.mutual_best_assignment(tham.masked_distance_matrix(_t(a), _t(b), _t(ma), _t(mb)), 60,
                                    distance_ratio=ratio)
    _close(got, want)
    assert (got >= 0).sum() > 100


# ---------------------------------------------------------------- the gate


def test_project_with_cov_and_chi2_gate_match_jax():
    """The predicted projections, their covariance and the chi² matrix of
    the 3D-2D gate: the port's batch over (source, camera) against the JAX
    function a slice at a time."""
    d = scene_inputs(P=2, K=32)
    spec_j, intr_j, _ = jax_args(d)
    spec_t = CameraSpec(*d["spec"])
    r, q = d["T_WS_b"]
    for c in range(2):
        T_CW = jkin.inverse(jkin.compose(_jse3(r, q), _jse3(d["T_SC"][0][c], d["T_SC"][1][c])))
        T_CW_t = _tse3(np.asarray(T_CW.r), np.asarray(T_CW.q))
        got = tker._project_hpoints_with_cov(spec_t, _t(d["intr"][c]), tkin.SE3(r=T_CW_t.r, q=T_CW_t.q),
                                             _t(d["hp"][:, c]), 0.01)
        gate_ok = d["sel3d"][:, c] & got[2].numpy()
        chi2 = tker._chi2_gate(got[0], got[1], _t(d["uv_b"][c]), _t(d["std_b"][c]), _t(gate_ok))
        for p in range(2):
            want = jker._project_hpoints_with_cov(spec_j, intr_j[c], T_CW, jnp.asarray(d["hp"][p, c]),
                                                  jnp.asarray(0.01))
            for g, w in zip(got, want):
                _close(g[p], w)
            want_chi2 = jker._chi2_gate(want[0], want[1], jnp.asarray(d["uv_b"][c]), jnp.asarray(d["std_b"][c]),
                                        jnp.asarray(gate_ok[p]))
            _close(chi2[p], want_chi2)
        assert np.isfinite(chi2.numpy()).any() and (chi2.numpy() < 4).sum() > 10


def test_gated_match_pairs_matches_jax():
    """The recovery round: 3 sources of camera 0 against the current frame."""
    d = scene_inputs(P=3, K=48)
    spec_j, intr_j, _ = jax_args(d)
    T_CW = jkin.inverse(jkin.compose(_jse3(*d["T_WS_b"]), _jse3(d["T_SC"][0][0], d["T_SC"][1][0])))
    T_CW_P = jkin.SE3(r=jnp.tile(T_CW.r[None], (3, 1)), q=jnp.tile(T_CW.q[None], (3, 1)))
    c = 0
    want = jker.gated_match_pairs(
        spec_j, intr_j[c], jnp.asarray(d["desc_a"][:, c]), jnp.asarray(d["sel3d"][:, c]), jnp.asarray(d["hp"][:, c]),
        T_CW_P, jnp.asarray(d["desc_b"][c]), jnp.asarray(d["free_b"][c]), jnp.asarray(d["uv_b"][c]),
        jnp.asarray(d["std_b"][c]), jnp.asarray(0.01), jnp.asarray(40.0), threshold=60)
    got = tker.gated_match_pairs(
        CameraSpec(*d["spec"]), _t(d["intr"][c]), _t(d["desc_a"][:, c]), _t(d["sel3d"][:, c]), _t(d["hp"][:, c]),
        _tse3(np.asarray(T_CW_P.r), np.asarray(T_CW_P.q)), _t(d["desc_b"][c]), _t(d["free_b"][c]),
        _t(d["uv_b"][c]), _t(d["std_b"][c]), 0.01, 40.0, threshold=60)
    _close(got[0], want[0])
    _close(got[1], want[1])
    assert (got[0].numpy() >= 0).sum() > 20


# ---------------------------------------------------------------- the fused round


def test_associate_multicam_matches_jax_on_a_scene():
    """A whole round on the scene, with the stereo pair riding it: every
    output equal to JAX's, most matches right, the RANSAC keeps them."""
    d = scene_inputs(P=3, K=48)
    spec_j, intr_j, ja = jax_args(d)
    spec_t, intr_t, ta = port_args(d)
    key = jax.random.PRNGKey(3)
    want = jker.associate_multicam(spec_j, key, intr_j, *ja, jnp.asarray(40.0), jnp.asarray(9.0), threshold=60,
                                   stereo_pairs=((0, 1),))
    got = tker.associate_multicam(spec_t, _u(key, 2), intr_t, *ta, 40.0, 9.0, threshold=60, stereo_pairs=((0, 1),))
    _same_round(got, want)
    assign3 = got[0].numpy()
    assert (assign3 >= 0).sum() > 60 and (got[1].numpy() >= 0).sum() > 30
    assert bool(got[8]) and int(got[7]) > 40
    # :652 on the scene: 2D-2D never targets a keypoint a 3D-2D match claimed
    a2 = got[1].numpy()
    for c in range(2):
        assert not set(assign3[:, c][assign3[:, c] >= 0].tolist()) & set(a2[:, c][a2[:, c] >= 0].tolist())


def test_associate_multicam_random_inputs_match_jax(rng):
    """:616's random inputs at a threshold of 262 (random descriptors lie
    256 ± 11 bits apart, so about 70 % of pairs are candidates), with the
    stereo pair."""
    d = random_inputs(rng)
    spec_j, intr_j, ja = jax_args(d)
    spec_t, intr_t, ta = port_args(d)
    key = jax.random.PRNGKey(3)
    want = jker.associate_multicam(spec_j, key, intr_j, *ja, jnp.asarray(40.0), jnp.asarray(9.0), threshold=262,
                                   stereo_pairs=((0, 1),))
    got = tker.associate_multicam(spec_t, _u(key, 2), intr_t, *ta, 40.0, 9.0, threshold=262, stereo_pairs=((0, 1),))
    _same_round(got, want)
    assert (got[1].numpy() >= 0).sum() > 5 and (got[9][0].numpy() >= 0).sum() > 5


def test_associate_multicam_equals_per_camera(rng):
    """:616: the camera-batched round equals the single-camera round slice
    by slice on the matching and triangulation outputs; associate_onecam
    equals JAX's, its per-camera RANSAC included."""
    d = scene_inputs(P=2, K=32)
    spec_t, intr_t, ta = port_args(d)
    spec_j, intr_j, ja = jax_args(d)
    key = jax.random.PRNGKey(3)
    multi = tker.associate_multicam(spec_t, _u(key, 2), intr_t, *ta, 40.0, 9.0, threshold=60)
    for c in range(2):
        one = tker.associate_onecam(spec_t, _u(key, 1), intr_t[c], *_camera(ta, c), 40.0, 9.0, threshold=60)
        for m, o in list(zip(multi, one))[:6]:
            np.testing.assert_allclose(m[:, c].numpy(), o.numpy(), rtol=0, atol=TOL)
        want = jker.associate_onecam(spec_j, key, intr_j[c], *_camera(ja, c), jnp.asarray(40.0), jnp.asarray(9.0),
                                     threshold=60)
        for i, (g, w) in enumerate(zip(one, want)):
            _close(g, w, f"onecam output {i}")


def test_associate_respects_device_claims(rng):
    """:652: with a huge gate no 2D-2D assignment targets a keypoint that a
    3D-2D assignment of any source claimed in the same round; as JAX."""
    d = random_inputs(rng, P=3, C=1, K=32)
    d["sb_b"] = np.zeros(9)
    d["sb_b"][0] = 1e4
    spec_j, intr_j, ja = jax_args(d)
    spec_t, intr_t, ta = port_args(d)
    key = jax.random.PRNGKey(4)
    want = jker.associate_multicam(spec_j, key, intr_j, *ja, jnp.asarray(1e6), jnp.asarray(9.0), threshold=512)
    got = tker.associate_multicam(spec_t, _u(key, 1), intr_t, *ta, 1e6, 9.0, threshold=512)
    _same_round(got, want, stereo=False)
    a3, a2 = got[0].numpy(), got[1].numpy()
    assert not (set(a3[a3 >= 0].tolist()) & set(a2[a2 >= 0].tolist()))


def test_newest_source_claim_wins():
    """Where several sources claim one current keypoint, the RANSAC
    candidate point is the newest source's (lowest index), resolved without
    relying on the order of duplicate writes."""
    P, C, K = 4, 2, 5
    rng = np.random.default_rng(0)
    # one-to-one within a source, as an assignment is
    assign = np.stack([np.stack([np.where(rng.random(K) < 0.7, rng.permutation(K), -1) for _ in range(C)])
                       for _ in range(P)])
    hp = np.concatenate([rng.normal(size=(P, C, K, 3)), rng.uniform(0.5, 2, (P, C, K, 1))], -1)
    got = tker._newest_claim_points(_t(assign), _t(hp), K).numpy()
    want = np.zeros((C, K, 3))
    for p in range(P - 1, -1, -1):  # oldest first: the newest writes last
        for c in range(C):
            for ia in range(K):
                if assign[p, c, ia] >= 0:
                    want[c, assign[p, c, ia]] = hp[p, c, ia, :3] / hp[p, c, ia, 3]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


# ---------------------------------------------------------------- triangulation


def test_stereo_match_triangulate_matches_composition_and_jax(rng):
    """:674: the stereo program equals plain_match + triangulate_pairs, and
    JAX's."""
    spec = (640, 480, "none")
    K = 16
    intr = np.asarray([460.0, 460.0, 320.0, 240.0])
    desc_a = rng.integers(0, 2**32, (K, 16), dtype=np.uint32)
    desc_b = rng.integers(0, 2**32, (K, 16), dtype=np.uint32)
    free_a, free_b = rng.random(K) < 0.8, rng.random(K) < 0.8
    uv_a, uv_b = rng.uniform(100, 500, (K, 2)), rng.uniform(100, 500, (K, 2))
    Ta = (np.zeros(3), np.asarray([0.0, 0, 0, 1]))
    Tb = (np.asarray([0.2, 0.0, 0.0]), np.asarray([0.0, 0, 0, 1]))
    std = np.full(K, 0.8 * 8.0 / 12.0)
    got = tker.stereo_match_triangulate(CameraSpec(*spec), CameraSpec(*spec), _t(intr), _t(intr), _t(desc_a),
                                        _t(desc_b), _t(free_a), _t(free_b), _t(uv_a), _t(uv_b), _tse3(*Ta),
                                        _tse3(*Tb), _t(std), _t(std), threshold=512)
    want = jker.stereo_match_triangulate(JCameraSpec(*spec), JCameraSpec(*spec), jnp.asarray(intr),
                                         jnp.asarray(intr), *(jnp.asarray(x) for x in (desc_a, desc_b, free_a, free_b,
                                                                                      uv_a, uv_b)),
                                         _jse3(*Ta), _jse3(*Tb), jnp.asarray(std), jnp.asarray(std), threshold=512)
    for g, w in zip(got, want):
        _close(g, w)
    assign = tker.plain_match(_t(desc_a), _t(desc_b), _t(free_a), _t(free_b), threshold=512)
    _close(got[0], assign.numpy())
    ib = torch.where(assign >= 0, assign, 0)
    ref = tker.triangulate_pairs(CameraSpec(*spec), CameraSpec(*spec), _t(intr), _t(intr), _tse3(*Ta), _tse3(*Tb),
                                 _t(uv_a), _t(uv_b)[ib], assign >= 0, _t(std), _t(std)[ib],
                                 torch.tensor(4e-8, dtype=torch.float64))
    for g, r in zip(got[1:], ref):
        _close(g, r.numpy())


def test_triangulate_pairs_batch_equals_slices(rng):
    """The (G, K) batch of triangulate_pairs (per-slice poses and
    intrinsics) equals one call a slice."""
    spec = CameraSpec(752, 480, "radtan")
    G, K = 3, 20
    intr = np.stack([[460.0 + g, 455.0, 370.0, 250.0, -0.28, 0.07, 1e-4, -2e-5] for g in range(G)])
    uv_a, uv_b = rng.uniform(100, 600, (G, K, 2)), rng.uniform(100, 400, (G, K, 2))
    r_a, r_b = rng.normal(0, 0.3, (G, 3)), rng.normal(0, 0.3, (G, 3))
    q = np.tile([0.0, 0, 0, 1.0], (G, 1))
    std = np.full((G, K), 0.6)
    m = rng.random((G, K)) < 0.8
    T = lambda r: tkin.SE3(r=_t(r)[:, None], q=_t(q)[:, None])  # noqa: E731
    batch = tker.triangulate_pairs(spec, spec, _t(intr)[:, None], _t(intr)[:, None], T(r_a), T(r_b), _t(uv_a),
                                   _t(uv_b), _t(m), _t(std), _t(std), torch.tensor(0.01, dtype=torch.float64))
    for g in range(G):
        one = tker.triangulate_pairs(spec, spec, _t(intr[g]), _t(intr[g]), _tse3(r_a[g], q[g]), _tse3(r_b[g], q[g]),
                                     _t(uv_a[g]), _t(uv_b[g]), _t(m[g]), _t(std[g]), _t(std[g]),
                                     torch.tensor(0.01, dtype=torch.float64))
        for b, o in zip(batch, one):
            _close(b[g], o.numpy())


def test_triangulation_gate_pose_uncertainty():
    """:711: a 4 px perpendicular error is rejected under a near-certain
    relative pose (4e-8 m²) and admitted under an uncertain one (0.09 m²),
    in both packages."""
    spec = (640, 480, "none")
    intr = np.asarray([460.0, 460.0, 320.0, 240.0])
    Ta = (np.zeros(3), np.asarray([0.0, 0, 0, 1]))
    Tb = (np.asarray([0.2, 0.0, 0.0]), np.asarray([0.0, 0, 0, 1]))
    p_W = np.asarray([0.3, -0.2, 6.0])
    uv_a = np.asarray(jph.project(JCameraSpec(*spec), jnp.asarray(intr), jnp.asarray(p_W))[0])
    uv_b = np.asarray(jph.project(JCameraSpec(*spec), jnp.asarray(intr), jnp.asarray(p_W - Tb[0]))[0]) + [0.0, 4.0]
    std_a, std_b = np.asarray([0.8 * 24.0 / 12.0]), np.asarray([0.8 * 8.0 / 12.0])
    for s2, expect in ((4e-8, False), (0.09, True)):
        got = tker.triangulate_pairs(CameraSpec(*spec), CameraSpec(*spec), _t(intr), _t(intr), _tse3(*Ta),
                                     _tse3(*Tb), _t(uv_a[None]), _t(uv_b[None]), torch.ones(1, dtype=torch.bool),
                                     _t(std_a), _t(std_b), torch.tensor(s2, dtype=torch.float64))
        want = jker.triangulate_pairs(JCameraSpec(*spec), JCameraSpec(*spec), jnp.asarray(intr), jnp.asarray(intr),
                                      _jse3(*Ta), _jse3(*Tb), jnp.asarray(uv_a[None]), jnp.asarray(uv_b[None]),
                                      jnp.ones(1, bool), jnp.asarray(std_a), jnp.asarray(std_b), jnp.asarray(s2))
        for g, w in zip(got, want):
            _close(g, w)
        assert bool(got[1][0]) == expect


def test_triangulation_depth_observability():
    """:748: a 2 mm baseline cannot initialize, a 0.5 m one can, in both
    packages."""
    spec = (640, 480, "none")
    intr = np.asarray([460.0, 460.0, 320.0, 240.0])
    std = np.asarray([0.8 * 8.0 / 12.0])
    p_W = np.asarray([0.1, -0.1, 8.0])
    Ta = (np.zeros(3), np.asarray([0.0, 0, 0, 1]))
    uv_a = np.asarray(jph.project(JCameraSpec(*spec), jnp.asarray(intr), jnp.asarray(p_W))[0])
    for baseline, expect in ((0.002, False), (0.5, True)):
        Tb = (np.asarray([baseline, 0.0, 0.0]), np.asarray([0.0, 0, 0, 1]))
        uv_b = np.asarray(jph.project(JCameraSpec(*spec), jnp.asarray(intr), jnp.asarray(p_W - Tb[0]))[0])
        got = tker.triangulate_pairs(CameraSpec(*spec), CameraSpec(*spec), _t(intr), _t(intr), _tse3(*Ta),
                                     _tse3(*Tb), _t(uv_a[None]), _t(uv_b[None]), torch.ones(1, dtype=torch.bool),
                                     _t(std), _t(std), torch.tensor(4e-8, dtype=torch.float64))
        want = jker.triangulate_pairs(JCameraSpec(*spec), JCameraSpec(*spec), jnp.asarray(intr), jnp.asarray(intr),
                                      _jse3(*Ta), _jse3(*Tb), jnp.asarray(uv_a[None]), jnp.asarray(uv_b[None]),
                                      jnp.ones(1, bool), jnp.asarray(std), jnp.asarray(std), jnp.asarray(4e-8))
        for g, w in zip(got, want):
            _close(g, w)
        # parallel rays never initialize
        assert (not expect) if bool(got[2][0]) else bool(got[3][0]) == expect


# ---------------------------------------------------------------- 2D-2D RANSAC


def test_ransac_2d2d_px_matches_jax():
    """The bootstrap's rotation-only and relative-pose RANSAC in pixels on a
    two-view scene (40 points at 4-8 m, a 0.4 m baseline, 10 outliers):
    inliers and counts equal, models up to sign, bearings to 1e-9; the
    relative model wins."""
    rng = np.random.default_rng(12)
    K = 48
    spec = CameraSpec(752, 480, "radtan")
    _, _, intr = jeuroc_stereo_rig()
    intr_t = _t(np.asarray(intr[0]))
    p_A = np.concatenate([rng.uniform(-2, 2, (40, 2)), rng.uniform(4, 8, (40, 1))], axis=1)
    T_BA = _tse3([-0.4, -0.05, 0.02], np.asarray([0.01, -0.02, 0.005, 1.0]) / np.linalg.norm([0.01, -0.02, 0.005, 1]))
    p_B = tkin.transform_point(T_BA, _t(p_A)).numpy()
    uv_a, uv_b, mask = np.zeros((K, 2)), np.zeros((K, 2)), np.zeros(K, bool)
    uv_a[:40] = tker.project_points(spec, intr_t, tkin.identity(device="cpu"), _t(p_A))[0].numpy()
    uv_b[:40] = tker.project_points(spec, intr_t, tkin.identity(device="cpu"), _t(p_B))[0].numpy()
    uv_b[:10] += rng.uniform(20, 40, (10, 2))
    mask[:40] = True
    k_rot, k_rel = jax.random.split(jax.random.PRNGKey(9))
    want = jker.ransac_2d2d_px(k_rot, k_rel, JCameraSpec(752, 480, "radtan"), jnp.asarray(intr[0]),
                               jnp.asarray(uv_a), jnp.asarray(uv_b), jnp.asarray(mask), 460.0, 9.0)
    got = tker.ransac_2d2d_px(_t(np.asarray(jax.random.uniform(k_rot, (64, 2)))),
                              _t(np.asarray(jax.random.uniform(k_rel, (64, 8)))), spec, intr_t, _t(uv_a), _t(uv_b),
                              _t(mask), 460.0, 9.0)
    for g, w in zip(got[:2], want[:2]):
        _close(g.inliers, w.inliers)
        assert int(g.num_inliers) == int(w.num_inliers) and bool(g.success) == bool(w.success)
        gm, wm = g.model.numpy(), np.asarray(w.model)
        assert min(np.abs(gm - wm).max(), np.abs(gm + wm).max()) <= TOL
    _close(got[2], want[2])
    _close(got[3], want[3])
    assert int(got[1].num_inliers) >= 28 > int(got[0].num_inliers)
