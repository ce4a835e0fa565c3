"""The port's Frontend (association, RANSAC, initialization) against the
JAX package's, in float64 on the CPU.

Both packages get the same numpy inputs: the estimator worlds and frames of
tests/test_frontend.py's cases (:443, :780, :847, :938, :1170), built once
in numpy and handed to each package, with explicit state ids. The JAX
frontend's RANSAC keys are recorded and replayed into the port's
Frontend._draw. The 8-frame Frontend + Estimator run is in
test_torch_vio_loop.py, which uses the helpers here.

Tolerances (measured gaps in brackets): keypoint-to-landmark ids, keyframe
decisions, is_initialized, the landmark table (ids, slots, initialized) and
the observation table exactly; states (poses, speed/bias, FEJ points, the
priors) to 1e-8 [<= 3e-12], landmark positions to 1e-8 [<= 5e-10], the
marginal prior as in test_torch_estimator.py. Landmark quality, a derived
ill-conditioned number for points at infinity (~1e-8 there, ~1e-2 for
initialized ones), to 1e-7 [1.1e-8].
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from okvis_tpu import kinematics as jkin
from okvis_tpu.cameras import NCameraSystem as JRig
from okvis_tpu.cameras import pinhole as jph
from okvis_tpu.cameras.pinhole import CameraSpec as JCameraSpec
from okvis_tpu.datasets.synthetic import euroc_stereo_rig as jeuroc_stereo_rig
from okvis_tpu.datasets.synthetic import simulate_trajectory as jsimulate_trajectory
from okvis_tpu.estimator import Estimator as JEstimator
from okvis_tpu.frontend import kernels as jker
from okvis_tpu.frontend.detection import Keypoints as JKeypoints
from okvis_tpu.frontend.frame import FrameData as JFrameData
from okvis_tpu.frontend.frame import MultiFrame as JMultiFrame
from okvis_tpu.frontend.frontend import Frontend as JFrontend
from okvis_tpu.frontend.frontend import FrontendConfig as JFrontendConfig
from okvis_tpu.imu import ImuParams as JImuParams
from okvis_tpu.solver import WindowConfig as JWindowConfig
from okvis_tpu_torch import convert
from okvis_tpu_torch import kinematics as tkin
from okvis_tpu_torch.estimator import Estimator
from okvis_tpu_torch.frontend import kernels as tker
from okvis_tpu_torch.frontend.frame import MultiFrame
from okvis_tpu_torch.frontend.frontend import Frontend
from test_torch_estimator import jax_rig, port_imu, port_rig

torch.set_num_threads(2)
TOL_QUALITY = 1e-7


# ---------------------------------------------------------------- harness


def replay_draws(jfe, tfe):
    """Record the keys the JAX frontend splits off, and make the port's
    _draw return the uniforms (or the integer) the JAX consumer of each key
    draws: split into C keys for the rig RANSAC's (C, n_hyp, 3), one
    uniform block otherwise."""
    keys = []
    orig = jfe._next_key

    def record():
        k = orig()
        keys.append(k)
        return k

    jfe._next_key = record
    it = iter(keys)

    def draw(shape, high=None):
        k = next(it)
        if high is not None:
            return int(jax.random.randint(k, (), 0, high))
        if len(shape) == 3:
            u = np.stack([np.asarray(jax.random.uniform(kc, shape[1:])) for kc in jax.random.split(k, shape[0])])
        else:
            u = np.array(jax.random.uniform(k, shape))
        return torch.from_numpy(u)

    tfe._draw = draw
    return keys


def jax_frame(uv, mask, desc, lids, K):
    fd = JFrameData(keypoints=JKeypoints(uv=jnp.asarray(uv), score=jnp.ones(K), mask=jnp.asarray(mask)),
                    descriptors=jnp.asarray(desc), landmark_ids=np.array(lids, np.int64))
    fd.set_host_mirrors(np.asarray(uv), np.asarray(mask))
    return fd


def port_frame(uv, mask, desc, lids, K):
    return convert.frame_from_numpy(uv, np.ones(K), mask, desc, lids, device="cpu", dtype=torch.float64)


class Pair:
    """The same estimator world in both packages: states from a static IMU
    trajectory (ids 1, 2, ...), landmarks, observations and multiframes
    from numpy values."""

    def __init__(self, n_states, seed, specs=None, intrinsics=None, K=16, **fe_kw):
        _, T_SC, intr = jeuroc_stereo_rig()
        specs = specs or (JCameraSpec(752, 480, "radtan"),) * 2
        intr = [np.asarray(i) for i in (intrinsics or intr)]
        self.jrig = JRig(specs=tuple(specs), T_SC=T_SC, intrinsics=[jnp.asarray(i) for i in intr])
        self.trig = convert.rig_from_numpy([(s.width, s.height, s.dist_type) for s in specs], np.asarray(T_SC.r),
                                           np.asarray(T_SC.q), intr, device="cpu", compute_overlaps=False)
        jcfg = JWindowConfig(num_states=9, num_cameras=2, max_landmarks=64, max_observations=256, imu_samples=32,
                             max_imu_links=8, camera_specs=tuple(specs))
        self.jest = JEstimator(self.jrig, JImuParams.euroc(), cfg=jcfg)
        self.test = Estimator(self.trig, port_imu(), cfg=convert.window_config_from_dict(dataclasses.asdict(jcfg)),
                              device="cpu")
        traj = jsimulate_trajectory(duration=1.0, seed=seed, motion_scale=0.0)
        self.sids = []
        for fi in range(n_states):
            idx = fi * 20
            lo, hi = max(0, idx - 24), idx + 5
            args = (fi * 0.1, traj.ts[lo:hi], traj.gyro[lo:hi], traj.acc[lo:hi])
            self.sids.append(self.jest.add_states(*args, as_keyframe=True, frame_id=fi + 1))
            assert self.test.add_states(*args, as_keyframe=True, frame_id=fi + 1) == fi + 1
        self.K = K
        self.jfe = JFrontend(self.jrig, JFrontendConfig(max_keypoints=K, **fe_kw))
        self.tfe = Frontend(self.trig, convert.frontend_config_from_dict(
            dataclasses.asdict(JFrontendConfig(max_keypoints=K, **fe_kw))))
        replay_draws(self.jfe, self.tfe)
        self.mfs = {}

    def T_WC(self, sid, cam):
        return jkin.compose(self.jest.get_T_WS(sid), self.jrig.camera_T_SC(cam))

    def project(self, cam, p_C):
        uv, flag = jph.project(self.jrig.specs[cam], self.jest.intrinsics[cam], jnp.asarray(p_C))
        assert int(flag) == 0
        return np.asarray(uv)

    def each(self, name, *args, **kw):
        return getattr(self.jest, name)(*args, **kw), getattr(self.test, name)(*args, **kw)

    def set_T_WS(self, sid, r, q):
        self.jest.set_T_WS(sid, jkin.SE3(r=jnp.asarray(r), q=jnp.asarray(q)))
        self.test.set_T_WS(sid, tkin.SE3(r=torch.from_numpy(np.asarray(r)), q=torch.from_numpy(np.asarray(q))))

    def multiframe(self, sid, cams):
        """cams: per camera a list of (uv, descriptor, landmark id) rows."""
        K = self.K
        out = []
        for make, MF in ((jax_frame, JMultiFrame), (port_frame, MultiFrame)):
            frames = []
            for rows in cams:
                uv, mask = np.zeros((K, 2)), np.zeros(K, bool)
                desc, lids = np.zeros((K, 16), np.uint32), np.zeros(K, np.int64)
                for j, (u, d, lm) in enumerate(rows):
                    uv[j], desc[j], lids[j], mask[j] = u, d, lm, True
                frames.append(make(uv, mask, desc, lids, K))
            out.append(MF(id=sid, timestamp=0.0, frames=frames))
        self.jest.multiframes[sid], self.test.multiframes[sid] = out
        self.mfs[sid] = out
        return out

    def associate(self, src_sids, cur_sid, T_sid=None, **kw):
        """_associate_batched in both packages (JAX first); the port's
        result, after checking that both packages agree."""
        T_sid = cur_sid if T_sid is None else T_sid
        jT = self.jest.get_T_WS(T_sid)
        want = self.jfe._associate_batched(self.jest, [self.mfs[s][0] for s in src_sids], self.mfs[cur_sid][0],
                                           jT, **kw)
        got = self.tfe._associate_batched(self.test, [self.mfs[s][1] for s in src_sids], self.mfs[cur_sid][1],
                                          self.test.get_T_WS(T_sid), **kw)
        assert got == want
        self.assert_same()
        return got

    def assert_same(self):
        for sid, (jm, tm) in self.mfs.items():
            for jf, tf in zip(jm.frames, tm.frames):
                np.testing.assert_array_equal(tf.landmark_ids, jf.landmark_ids)
        assert_same_tables(self.test, self.jest)


def assert_same_tables(test, jest):
    got, want = convert.estimator_to_numpy(test), convert.estimator_to_numpy(jest)
    assert [(lm["id"], lm["slot"], lm["initialized"]) for lm in got["landmarks"]] == \
        [(lm["id"], lm["slot"], lm["initialized"]) for lm in want["landmarks"]]
    ids = ("lm_id", "pose_id", "cam_idx", "keypoint_idx")
    assert [tuple(o[k] for k in ids) for o in got["observations"]] == \
        [tuple(o[k] for k in ids) for o in want["observations"]]
    np.testing.assert_allclose(got["hp_W"], want["hp_W"], rtol=0, atol=1e-8)
    for key in ("r_WS", "q_WS", "sb"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-8)


# ---------------------------------------------------------------- the mirrors


def test_conflict_loser_rematches_in_second_round(rng):
    """:443: two keyframe sources best-match the same current keypoint; the
    newer wins and the loser re-matches in the recovery round."""
    w = Pair(3, seed=3, gate_radius_px=40.0)
    p1_C, p2_C = np.asarray([0.10, 0.05, 4.0]), np.asarray([0.15, 0.05, 4.0])
    T_WC = w.T_WC(w.sids[2], 0)
    p1, p2 = (np.asarray(jkin.transform_point(T_WC, jnp.asarray(p))) for p in (p1_C, p2_C))
    uv1, uv2 = w.project(0, p1_C), w.project(0, p2_C)
    L1, L2 = 501, 502
    w.each("add_landmark", L1, p1)
    w.each("add_landmark", L2, p2)
    for lm in (L1, L2):
        w.each("add_observation", lm, w.sids[0], 0, uv1, keypoint_idx=0)
        w.each("add_observation", lm, w.sids[1], 0, uv1, keypoint_idx=0)
    d0 = rng.integers(0, 2**32, (16,), dtype=np.uint32)
    d1 = d0.copy()
    d1[0] ^= np.uint32(0b11)
    w.multiframe(w.sids[0], [[(uv1, d0, L2)], []])
    w.multiframe(w.sids[1], [[(uv1, d0, L1)], []])
    cur = w.multiframe(w.sids[2], [[(uv1, d0, 0), (uv2, d1, 0)], []])[1]
    n3d, _ = w.associate([w.sids[1], w.sids[0]], w.sids[2])
    assert n3d == 2
    assert int(cur.frames[0].landmark_ids[0]) == L1 and int(cur.frames[0].landmark_ids[1]) == L2


def test_associate_batched_single_fused_call(rng, monkeypatch):
    """:780: a stereo association round is one associate_multicam call (and
    no per-camera fallback), counted the same way in both packages."""
    calls = {"jax": 0, "port": 0}
    for name, mod in (("jax", jker), ("port", tker)):
        orig = mod.associate_multicam

        def counting(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, "associate_multicam", counting)
        monkeypatch.setattr(mod, "associate_onecam",
                            lambda *a, **kw: (_ for _ in ()).throw(AssertionError("fallback used")))
    w = Pair(2, seed=3, K=8)

    def rows():
        return [(rng.uniform(100, 500, 2), rng.integers(0, 2**32, 16, dtype=np.uint32), 0) for _ in range(8)]

    w.multiframe(w.sids[0], [rows(), rows()])
    w.multiframe(w.sids[1], [rows(), rows()])
    w.associate([w.sids[0]], w.sids[1])
    assert calls == {"jax": 1, "port": 1}


def test_uninitialized_landmark_upgraded_via_2d2d(rng):
    """:847: a source keyframe carrying an uninitialized landmark routes it
    through the 2D-2D pool; the parallax match re-triangulates and upgrades
    it, with the current-frame observation."""
    w = Pair(2, seed=5)
    T0 = w.jest.get_T_WS(w.sids[0])
    w.set_T_WS(w.sids[1], np.asarray(T0.r) + [0.2, 0.0, 0.0], np.asarray(T0.q))
    p_W = np.asarray(jkin.transform_point(w.T_WC(w.sids[0], 0), jnp.asarray([0.0, 0.0, 4.0])))
    uvs = [w.project(0, np.asarray(jkin.transform_point(jkin.inverse(w.T_WC(s, 0)), jnp.asarray(p_W))))
           for s in w.sids]
    L = 901
    ray = p_W / np.linalg.norm(p_W)
    w.each("add_landmark", L, np.concatenate([ray, [1e-3]]), initialized=False)
    w.each("add_observation", L, w.sids[0], 0, uvs[0], keypoint_idx=0)
    d0 = rng.integers(0, 2**32, (16,), dtype=np.uint32)
    w.multiframe(w.sids[0], [[(uvs[0], d0, L)], []])
    cur = w.multiframe(w.sids[1], [[(uvs[1], d0, 0)], []])[1]
    n3d, _ = w.associate([w.sids[0]], w.sids[1])
    assert n3d == 0 and int(cur.frames[0].landmark_ids[0]) == L
    assert w.test.landmarks[L].initialized
    hp = w.test.get_landmark(L)
    assert np.linalg.norm(hp[:3] / hp[3] - p_W) < 0.2
    assert sum(1 for o in w.test.observations if o.lm_id == L) == 2


def test_folded_ransac_removes_outlier_association(rng):
    """:938: the rig RANSAC folded into the round strips a gross outlier
    that passes the chi² gate, and keeps the 11 inliers."""
    w = Pair(2, seed=9)
    T_WC = w.T_WC(w.sids[1], 0)
    jitter = rng.uniform(-0.8, 0.8, 12)
    pts_C = np.stack([np.asarray([x, y, 4.0 + 0.3 * i + jitter[i]]) for i, (x, y) in enumerate(
        [(dx * 0.5, dy * 0.4) for dx in (-2, -1, 0, 1) for dy in (-1, 0, 1)])])
    n = len(pts_C)
    lm_ids = list(range(700, 700 + n))
    uvs = np.stack([w.project(0, p) for p in pts_C])
    for i in range(n):
        p_W = np.asarray(jkin.transform_point(T_WC, jnp.asarray(pts_C[i])))
        w.each("add_landmark", lm_ids[i], p_W)
        w.each("add_observation", lm_ids[i], w.sids[0], 0, uvs[i], keypoint_idx=i)
        w.each("add_observation", lm_ids[i], w.sids[0], 1, uvs[i], keypoint_idx=i)
    bad = 5
    kp_uv = uvs.copy()
    kp_uv[bad] += [8.0, 0.0]
    descs = rng.integers(0, 2**32, (n, 16), dtype=np.uint32)
    w.multiframe(w.sids[0], [list(zip(uvs, descs, lm_ids)), []])
    cur = w.multiframe(w.sids[1], [list(zip(kp_uv, descs, [0] * n)), []])[1]
    n3d, _ = w.associate([w.sids[0]], w.sids[1], apply_ransac=True)
    assert n3d == n
    lids = cur.frames[0].landmark_ids
    assert int(lids[bad]) == 0 and sum(int(lids[i]) != 0 for i in range(n)) == n - 1
    assert not any(o.lm_id == lm_ids[bad] and o.pose_id == w.sids[1] for o in w.test.observations)


def test_mixed_model_rig_takes_the_per_camera_path(rng, monkeypatch):
    """:1170: a rig of two camera models runs one associate_onecam round a
    camera and finds the 3D-2D match in each."""
    calls = {"jax": 0, "port": 0}
    for name, mod in (("jax", jker), ("port", tker)):
        monkeypatch.setattr(mod, "associate_multicam",
                            lambda *a, **kw: (_ for _ in ()).throw(AssertionError("multicam used")))
        orig = mod.associate_onecam

        def counting(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, "associate_onecam", counting)
    specs = (JCameraSpec(752, 480, "radtan"), JCameraSpec(752, 480, "none"))
    intr = [np.asarray([461.4, 460.2, 363.0, 248.1, -0.28, 0.07, 2.0e-4, 1.8e-5]),
            np.asarray([458.0, 457.0, 370.0, 250.0])]
    w = Pair(2, seed=3, specs=specs, intrinsics=intr, K=8)
    lm_of, uv_of = {}, {}
    for c in range(2):
        p_C = np.asarray([0.1 * (c + 1), 0.05, 4.0])
        p_W = np.asarray(jkin.transform_point(w.T_WC(w.sids[1], c), jnp.asarray(p_C)))
        uv = w.project(c, p_C)
        lm = 800 + c
        w.each("add_landmark", lm, p_W)
        w.each("add_observation", lm, w.sids[0], c, uv, keypoint_idx=0)
        w.each("add_observation", lm, w.sids[0], 1 - c, uv, keypoint_idx=1)
        lm_of[c], uv_of[c] = lm, uv
    d = rng.integers(0, 2**32, (2, 16), dtype=np.uint32)
    w.multiframe(w.sids[0], [[(uv_of[c], d[c], lm_of[c])] for c in range(2)])
    cur = w.multiframe(w.sids[1], [[(uv_of[c], d[c], 0)] for c in range(2)])[1]
    n3d, _ = w.associate([w.sids[0]], w.sids[1])
    assert calls == {"jax": 2, "port": 2} and n3d == 2
    assert [int(cur.frames[c].landmark_ids[0]) for c in range(2)] == [lm_of[0], lm_of[1]]


def test_detect_and_describe_single_camera_matches_jax():
    """detect_and_describe on one camera's rendered image (376x240, 128
    keypoints, gravity-aligned): the keypoints of the JAX package, and the
    port's own batched call's keypoints and descriptors."""
    from test_torch_stereo_slice import K, _rigs
    from okvis_tpu.datasets import synthetic as jsyn
    from okvis_tpu_torch.datasets import synthetic as tsyn

    jrig, trig = _rigs()
    traj = jsyn.simulate_trajectory(duration=1.2, seed=71, motion_scale=0.3)
    lms = jsyn.make_landmarks(traj, 260, seed=72, radius=(4.0, 8.0))
    i = 200
    jT = jkin.compose(jkin.SE3(r=jnp.asarray(traj.r[i]), q=jnp.asarray(traj.q[i])), jrig.camera_T_SC(0))
    tT_WS = tkin.SE3(r=torch.from_numpy(traj.r[i]), q=torch.from_numpy(traj.q[i]))
    tT = tkin.compose(tT_WS, trig.camera_T_SC(0))
    img = tsyn.render_world_image(trig.specs[0], trig.intrinsics[0], tT, lms)
    cfg = dict(detection_threshold=15.0, max_keypoints=K)
    jf = JFrontend(jrig, JFrontendConfig(**cfg)).detect_and_describe(0, jnp.asarray(img), jT)
    tfe = Frontend(trig, convert.frontend_config_from_dict(dataclasses.asdict(JFrontendConfig(**cfg))))
    tf = tfe.detect_and_describe(0, img, tT)
    m = tf.mask_np
    assert m.sum() == np.asarray(jf.keypoints.mask).sum() > 20
    ot = np.lexsort((tf.uv_np[m][:, 1], tf.uv_np[m][:, 0]))
    jm = np.asarray(jf.keypoints.mask)
    ju = np.asarray(jf.keypoints.uv)[jm]
    np.testing.assert_allclose(tf.uv_np[m][ot], ju[np.lexsort((ju[:, 1], ju[:, 0]))], atol=1e-3)
    multi = tfe.detect_and_describe_multi([img], tT_WS)[0]
    np.testing.assert_array_equal(multi.uv_np, tf.uv_np)
    np.testing.assert_array_equal(multi.descriptors.numpy(), tf.descriptors.numpy())


def test_propagation_matches_jax():
    """Frontend.propagation: the IMU prediction of both packages."""
    traj = jsimulate_trajectory(duration=0.5, seed=4, motion_scale=0.5)
    ts, gy, ac = traj.ts[:30], traj.gyro[:30], traj.acc[:30]
    sb = np.zeros(9)
    sb[:3] = traj.v[0]
    jT, jsb = JFrontend(jax_rig()).propagation(
        JImuParams.euroc(), jkin.SE3(r=jnp.asarray(traj.r[0]), q=jnp.asarray(traj.q[0])), sb, ts, gy, ac,
        ts[0], ts[-1])
    tT, tsb = Frontend(port_rig()).propagation(
        port_imu(), tkin.SE3(r=torch.from_numpy(traj.r[0]), q=torch.from_numpy(traj.q[0])), sb, ts, gy, ac,
        ts[0], ts[-1])
    np.testing.assert_allclose(tT.r.numpy(), np.asarray(jT.r), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tT.q.numpy(), np.asarray(jT.q), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tsb.numpy(), np.asarray(jsb), rtol=0, atol=1e-10)


def test_frames_and_config_carry_across(rng):
    """convert.py carries FrontendConfig, FrameData and MultiFrame both
    ways: a JAX multiframe (uint32 descriptors, landmark ids, sizes)
    through multiframe_to_numpy into the port and back to the same numpy."""
    K = 8
    frames = []
    for _ in range(2):
        fd = jax_frame(rng.uniform(0, 400, (K, 2)), rng.random(K) < 0.7,
                       rng.integers(0, 2**32, (K, 16), dtype=np.uint32), rng.integers(0, 50, K), K)
        fd.sizes = rng.uniform(6, 12, K)
        frames.append(fd)
    values = convert.multiframe_to_numpy(JMultiFrame(id=4, timestamp=0.3, frames=frames))
    back = convert.multiframe_to_numpy(convert.multiframe_from_numpy(values, device="cpu", dtype=torch.float64))
    assert (back["id"], back["timestamp"]) == (4, 0.3)
    for a, b in zip(back["frames"], values["frames"]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        assert a["descriptors"].dtype == np.uint32
    cfg = JFrontendConfig(max_keypoints=K, gate_extra_px=1.5)
    assert dataclasses.asdict(convert.frontend_config_from_dict(dataclasses.asdict(cfg))) == \
        dataclasses.asdict(cfg)
