"""The port's Estimator against the JAX package's, and the contracts of
tests/test_estimator.py, in float64 on the CPU.

Both packages get the same numpy inputs: the synthetic frontend of
okvis_tpu_torch.datasets.synthetic.estimator_scenario (the JAX estimator
tests' frontend, with explicit frame ids so both packages number their
states alike). The JAX side runs in module fixtures.

Mirrors: tests/test_estimator.py :239 (first-frame initialization), :420
(add_extrinsics_prior over a device-resident prior, here a torch tensor),
:454 (the wall-clock budget contract), :472, :500 and :511 (capacity tiers
against full capacity), and, marked slow as the JAX test is, :25 (the long
run's gates). The multi-frame parity runs live in
test_torch_estimator_parity.py and test_torch_estimator_extrinsics.py,
which import the helpers below.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from okvis_tpu.cameras import NCameraSystem as JRig
from okvis_tpu.datasets.synthetic import euroc_stereo_rig as jeuroc_stereo_rig
from okvis_tpu.estimator import Estimator as JEstimator
from okvis_tpu.imu import ImuParams as JImuParams
from okvis_tpu.solver import WindowConfig as JWindowConfig
from okvis_tpu_torch import convert
from okvis_tpu_torch import kinematics as kin
from okvis_tpu_torch.cameras.ncamera import NCameraSystem
from okvis_tpu_torch.datasets.synthetic import (
    estimator_scenario, euroc_stereo_rig, feed_estimator_frame, make_landmarks, simulate_trajectory)
from okvis_tpu_torch.estimator import Estimator

torch.set_num_threads(2)

# Tolerances of the port against JAX after every frame (float64, the same
# inputs; measured gaps in brackets): slots, ids, records, removed landmark
# ids and triage exactly; poses, speed/bias, FEJ points and landmark quality
# to 1e-8 absolute [<= 1.2e-10]; landmark positions to 1e-7 [<= 5.8e-9];
# the marginal prior's H to 1e-9 of its largest entry [<= 2e-11], b0 to
# 1e-7 of its largest entry [<= 2e-8], c0 to 1e-7 relative [<= 1.2e-8].
# LM + Newton-Schulz, the JAX default, holds over the run.
TOL_STATE = 1e-8
TOL_LANDMARK = 1e-7
TOL_PRIOR = dict(marg_H=1e-9, marg_b0=1e-7, marg_c0=1e-7)


# --------------------------------------------------------------- helpers


def jax_rig():
    specs, T_SC, intr = jeuroc_stereo_rig()
    return JRig(specs=tuple(specs), T_SC=T_SC, intrinsics=intr)


def port_rig():
    specs, T_SC, intr = euroc_stereo_rig(device="cpu")
    return NCameraSystem(specs=specs, T_SC=T_SC, intrinsics=intr)


def port_imu():
    return convert.imu_params_from_numpy(jax.tree_util.tree_map(np.asarray, JImuParams.euroc()), device="cpu")


def world(seed, n_frames, n_landmarks, keep=1.0, duration=1.5, motion_scale=0.5, radius=(3.0, 8.0)):
    """tests/helpers.py::build_estimator_world's world (trajectory seed,
    landmarks seed + 1, noise seed), as numpy frames."""
    traj = simulate_trajectory(duration=duration, seed=seed, motion_scale=motion_scale)
    lms = make_landmarks(traj, n_landmarks, seed=seed + 1, radius=radius)
    return estimator_scenario(traj, lms, port_rig(), n_frames, seed=seed, keep=keep)


def window_config(**kw):
    """build_estimator_world's window: S = 9, L = 128, O = 512, 5 LM
    iterations; the JAX config and the port's."""
    rig = jax_rig()
    jcfg = JWindowConfig(num_states=9, num_cameras=2, max_landmarks=128, max_observations=512, imu_samples=32,
                         max_imu_links=8, max_iterations=5, camera_specs=tuple(rig.specs), **kw)
    return jcfg, convert.window_config_from_dict(dataclasses.asdict(jcfg))


def jax_estimator(jcfg):
    return JEstimator(jax_rig(), JImuParams.euroc(), 5, 3, cfg=jcfg)


def port_estimator(cfg, dtype=torch.float64):
    return Estimator(port_rig(), port_imu(), 5, 3, cfg=cfg, device="cpu", dtype=dtype)


def step(est, frame, init):
    """One frame of the loop: add_states + observations, optimize,
    marginalize. Returns (state id, removed landmark ids)."""
    sid = feed_estimator_frame(est, frame, init)
    est.optimize()
    return sid, est.apply_marginalization_strategy()


def snapshot(est, removed):
    """The host state after a frame, with the removed ids and the capacity
    tier the next optimize would select."""
    snap = convert.estimator_to_numpy(est)
    tier = est._select_tier()
    snap["removed"] = list(removed)
    snap["tier"] = None if tier is None else (tier["L"], tier["O"])
    return snap


def assert_same_window(got, want, what=""):
    """The port's snapshot against the JAX one at the tolerances above."""
    for key in ("removed", "tier", "states", "_lm_slot_to_id", "_free_state_slots", "_free_lm_slots",
                "marg_valid", "fej_ext_frozen", "num_keyframes", "num_imu_frames"):
        assert got[key] == want[key], (what, key)
    assert [(lm["id"], lm["slot"], lm["initialized"]) for lm in got["landmarks"]] == \
        [(lm["id"], lm["slot"], lm["initialized"]) for lm in want["landmarks"]], what
    np.testing.assert_allclose([lm["quality"] for lm in got["landmarks"]],
                               [lm["quality"] for lm in want["landmarks"]], rtol=0, atol=TOL_STATE, err_msg=what)
    ids = ("lm_id", "pose_id", "cam_idx", "keypoint_idx")
    assert [tuple(o[k] for k in ids) for o in got["observations"]] == \
        [tuple(o[k] for k in ids) for o in want["observations"]], what
    assert [(l["id_a"], l["id_b"]) for l in got["imu_links"]] == [(l["id_a"], l["id_b"]) for l in want["imu_links"]]
    for key in ("pose_priors", "sb_priors"):
        assert [p["pose_id"] for p in got[key]] == [p["pose_id"] for p in want[key]], (what, key)
        for p, q in zip(got[key], want[key]):
            for k in p:
                np.testing.assert_allclose(p[k], q[k], rtol=0, atol=TOL_STATE * max(1.0, np.abs(q[k]).max()),
                                           err_msg=f"{what} {key} {k}")
    for key in ("r_WS", "q_WS", "sb", "r_SC", "q_SC", "fej_r_WS", "fej_q_WS", "fej_sb", "fej_r_SC", "fej_q_SC"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=TOL_STATE, err_msg=f"{what} {key}")
    np.testing.assert_allclose(got["hp_W"], want["hp_W"], rtol=0, atol=TOL_LANDMARK, err_msg=f"{what} hp_W")
    for key in ("marg_H", "marg_b0"):
        scale = max(np.abs(want[key]).max(), 1e-300)
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=TOL_PRIOR[key] * scale, err_msg=f"{what} {key}")
    assert abs(got["marg_c0"] - want["marg_c0"]) <= TOL_PRIOR["marg_c0"] * max(abs(want["marg_c0"]), 1e-300), what


def run_parity(seed, n_frames, n_landmarks, keep, **cfg_kw):
    """Both packages through the same frames; per frame the two snapshots,
    the JAX state after frame n_frames - 1 (for the round trip) and the
    last frame with its landmark initial positions."""
    frames, init = world(seed, n_frames, n_landmarks, keep=keep)
    jcfg, cfg = window_config(**cfg_kw)
    jest, est = jax_estimator(jcfg), port_estimator(cfg)
    out = dict(jax=[], port=[], cfg=cfg, last=frames[-1], init=init)
    for i, f in enumerate(frames):
        if i == n_frames - 1:
            out["jax_before_last"] = convert.estimator_to_numpy(jest)
        out["jax"].append(snapshot(jest, step(jest, f, init)[1]))
        out["port"].append(snapshot(est, step(est, f, init)[1]))
    return out


def round_trip(run):
    """The JAX window before the last frame carried into the port, which
    then runs the last frame: the same window as JAX after it."""
    est = convert.estimator_from_numpy(run["jax_before_last"], port_rig(), port_imu(), run["cfg"], device="cpu",
                                       dtype=torch.float64)
    removed = step(est, run["last"], run["init"])[1]
    assert_same_window(snapshot(est, removed), run["jax"][-1], "round trip")


# ------------------------------------------------------------ the mirrors


def test_first_frame_initialization_matches_jax():
    """:239: a stationary tilted IMU; the first state is gravity-aligned,
    with one pose prior and one speed/bias prior, as in JAX."""
    n = 20
    ts = np.arange(n) / 200.0
    gyro = np.zeros((n, 3))
    acc = np.tile([1.0, 0.0, 9.7], (n, 1))
    jest = JEstimator(jax_rig(), JImuParams.euroc())
    est = Estimator(port_rig(), port_imu(), device="cpu")
    jsid = jest.add_states(ts[-1], ts, gyro, acc, as_keyframe=True, frame_id=7)
    sid = est.add_states(ts[-1], ts, gyro, acc, as_keyframe=True, frame_id=7)
    assert sid == jsid == 7
    T = est.get_T_WS(sid)
    a_W = kin.quat_rotate(T.q, torch.tensor([1.0, 0.0, 9.7], dtype=torch.float64))
    np.testing.assert_allclose(a_W[:2].numpy(), 0, atol=1e-9)
    assert len(est.pose_priors) == 1 and len(est.sb_priors) == 1
    assert_same_window(snapshot(est, []), snapshot(jest, []), "first frame")


def test_extrinsics_prior_after_device_resident_marginal():
    """:420: add_extrinsics_prior materializes the whole device-resident
    prior (H, b0, c0 as tensors) as numpy, so states_slot_reset takes its
    numpy branch."""
    _, cfg = window_config(estimate_extrinsics=True)
    cfg = dataclasses.replace(cfg, num_states=4, max_landmarks=16, max_observations=32, imu_samples=16,
                              max_imu_links=3)
    est = port_estimator(cfg)
    D = cfg.dense_dim
    est.marg_H = torch.zeros((D, D), dtype=torch.float64)
    est.marg_b0 = torch.zeros((D,), dtype=torch.float64)
    est.marg_c0 = torch.zeros((), dtype=torch.float64)
    est.marg_valid = True
    est.add_extrinsics_prior(0.1, 0.05)
    assert isinstance(est.marg_H, np.ndarray) and isinstance(est.marg_b0, np.ndarray)
    assert isinstance(est.marg_c0, float)
    est.states_slot_reset(0)
    assert est.marg_H[0, 0] == 0.0
    i0 = cfg.num_states * 15
    assert est.marg_H[i0, i0] == pytest.approx(100.0)


def test_marginalization_redoes_a_failed_float32_eigh_in_float64(monkeypatch):
    """Where the float32 eigh fails to converge (LAPACK's ssyevd does at
    the full window for some thread counts), pinv_sym decomposes in float64
    and returns float32: the float64 pseudo-inverse, rounded."""
    from okvis_tpu_torch.estimator import marginalization

    rng = np.random.default_rng(3)
    J = rng.normal(size=(20, 6))
    A = torch.from_numpy(J.T @ J)
    eigh = torch.linalg.eigh

    def failing_in_float32(x):
        if x.dtype == torch.float32:
            raise torch.linalg.LinAlgError("linalg.eigh: The algorithm failed to converge")
        return eigh(x)

    monkeypatch.setattr(torch.linalg, "eigh", failing_in_float32)
    got = marginalization.pinv_sym(A.float())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.linalg.inv(J.T @ J), rtol=1e-5, atol=1e-7)


def test_device_resident_prior_slot_reset_zeroes_in_place():
    """The device branch of states_slot_reset: a tensor prior keeps its
    storage and loses the slot's rows and columns."""
    _, cfg = window_config()
    est = port_estimator(cfg)
    D = cfg.dense_dim
    est.marg_H = torch.ones((D, D), dtype=torch.float64)
    est.marg_b0 = torch.ones((D,), dtype=torch.float64)
    storage = est.marg_H.data_ptr()
    est.states_slot_reset(2)
    assert est.marg_H.data_ptr() == storage
    assert float(est.marg_H[30:45].abs().sum()) == 0.0 and float(est.marg_H[:, 30:45].abs().sum()) == 0.0
    assert float(est.marg_b0[30:45].abs().sum()) == 0.0 and float(est.marg_H.sum()) == (D - 15) ** 2


@pytest.fixture(scope="module")
def budget_estimator():
    """:454's _run_estimator_case({}, n_frames=6) world: trajectory seed 3,
    120 landmarks at 3-9 m (seed 4), L = 256, O = 1024, 5 iterations."""
    traj = simulate_trajectory(duration=1.2, seed=3, motion_scale=0.6)
    lms = make_landmarks(traj, 120, seed=4, radius=(3.0, 9.0))
    frames, init = estimator_scenario(traj, lms, port_rig(), 6, seed=5)
    _, cfg = window_config()
    est = port_estimator(dataclasses.replace(cfg, max_landmarks=256, max_observations=1024))
    for f in frames:
        step(est, f, init)
    return est


def test_optimize_wall_clock_budget_contract(budget_estimator):
    """:454: optimize(time_limit=...) always runs >= min_iterations and
    tops up toward max_iterations only while under budget; the topped-up
    solve is no worse than the min-iteration one."""
    est = budget_estimator
    d0 = est.optimize(time_limit=0.0, min_iterations=2, max_iterations=5)
    assert d0.cost_history.shape[0] == 2
    d1 = est.optimize(time_limit=1e9, min_iterations=2, max_iterations=5)
    assert d1.cost_history.shape[0] == 5
    assert float(d1.final_cost) <= float(d0.final_cost) + 1e-9


def _world_estimator(seed, n_frames, n_landmarks, tiers=True):
    """build_estimator_world(seed, n_frames, n_landmarks): states,
    landmarks and observations added, not optimized."""
    frames, init = world(seed, n_frames, n_landmarks)
    _, cfg = window_config()
    est = port_estimator(cfg if tiers else dataclasses.replace(cfg, capacity_tiers=False))
    for f in frames:
        feed_estimator_frame(est, f, init)
    return est


def test_capacity_tiered_optimize_matches_full():
    """:472: the tiered solve (compact landmark table, reduced padding) is
    the same math as the full-capacity program."""
    est_full = _world_estimator(13, 5, 60, tiers=False)
    assert est_full._select_tier() is None
    est_full.optimize()
    est_tier = _world_estimator(13, 5, 60)
    tier = est_tier._select_tier()
    assert tier is not None and tier["L"] < est_tier.cfg.max_landmarks
    est_tier.optimize()
    for name in ("r_WS", "q_WS", "sb", "hp_W"):
        np.testing.assert_allclose(getattr(est_tier, name), getattr(est_full, name), atol=1e-9, err_msg=name)
    for lid, lm in est_full.landmarks.items():
        assert abs(est_tier.landmarks[lid].quality - lm.quality) < 1e-6


def test_capacity_tiered_deadline_contract():
    """:500: the wall-clock budget path runs the tiered programs (the min
    program and 1-iteration continuation chunks at the tier's shapes)."""
    est = _world_estimator(14, 5, 60)
    tier = est._select_tier()
    assert tier is not None
    d = est.optimize(time_limit=1e9, min_iterations=2, max_iterations=4)
    assert d.cost_history.shape[0] == 4
    LO = (tier["L"], tier["O"])
    assert ("opt", 2, False, LO) in est._jit_cache and ("opt_cont", 1, LO) in est._jit_cache


def test_capacity_tiered_marginalization_matches_full():
    """:511: the tiered marginalization launch gives the same marginal
    prior as the full-capacity program, and the next optimize agrees."""
    results = []
    for tiers_on in (False, True):
        est = _world_estimator(21, 7, 60, tiers=tiers_on)
        est.optimize()
        est.apply_marginalization_strategy()
        assert est.marg_valid
        est.optimize()
        results.append((np.array(est.marg_H), np.array(est.marg_b0), float(est.marg_c0), est.r_WS.copy(),
                        est.hp_W.copy()))
    (H0, b0, c0, r0, hp0), (H1, b1, c1, r1, hp1) = results
    np.testing.assert_allclose(H1, H0, atol=1e-7 * max(1.0, np.abs(H0).max()))
    np.testing.assert_allclose(b1, b0, atol=1e-7 * max(1.0, np.abs(b0).max()))
    assert abs(c1 - c0) < 1e-6 * max(1.0, abs(c0))
    np.testing.assert_allclose(r1, r0, atol=1e-8)
    np.testing.assert_allclose(hp1, hp0, atol=1e-8)


def test_program_cache_keeps_the_jax_keys():
    """The device programs are cached callables under the JAX package's
    _jit_cache keys (a captured form can replace one)."""
    est = _world_estimator(21, 7, 60)
    est.optimize()
    est.apply_marginalization_strategy()
    keys = set(est._jit_cache)
    assert "pre" in keys and "prop" in keys
    assert any(isinstance(k, tuple) and k[0] == "opt" and k[1] is None and k[2] is False for k in keys)
    assert any(isinstance(k, tuple) and k[0] == "marg" for k in keys)
    assert callable(est._landmark_quality_fn) and "lmq" in est._jit_cache
    assert est._empty_pre_template().delta_q.shape == (est.cfg.max_imu_links, 4)


@pytest.mark.slow
def test_estimator_long_run():
    """:25: 39 frames of the long-run scenario (140 landmarks at 3-9 m,
    L = 256, O = 1024) through add_states / optimize / marginalize; the
    window stays bounded and the last 10 frames meet the reference gates."""
    traj = simulate_trajectory(duration=4.0, seed=3, motion_scale=0.6)
    lms = make_landmarks(traj, 140, seed=4, radius=(3.0, 9.0))
    frames, init = estimator_scenario(traj, lms, port_rig(), 39, seed=11)
    _, cfg = window_config()
    est = port_estimator(dataclasses.replace(cfg, max_landmarks=256, max_observations=1024, max_iterations=10))
    pos, ang = [], []
    for f in frames:
        sid = step(est, f, init)[0]
        assert est.num_frames() <= 9 and len(est.imu_links) <= 8
        T = est.get_T_WS(sid)
        pos.append(float(np.linalg.norm(T.r.numpy() - f.r_WS)))
        dq = kin.quat_multiply(kin.quat_conjugate(T.q), torch.from_numpy(f.q_WS))
        ang.append(2 * np.arccos(min(1.0, abs(float(dq[3])))))
    assert max(pos[-10:]) < 0.1 and max(ang[-10:]) < 2e-2, (pos[-10:], ang[-10:])
    assert est.marg_valid and est.num_frames() == 8


def test_deferred_propagation_commits_the_blocking_result():
    """add_states(defer_fetch=True) keeps the propagated state on the
    device until fetch_with_pending, which returns the caller's tree and
    commits the same state as a blocking add_states; last_prop_device hands
    out the pending values meanwhile. The propagation equals JAX's."""
    frames, init = world(13, 2, 20)
    _, cfg = window_config()
    jcfg, _ = window_config()
    blocking, deferred, jest = port_estimator(cfg), port_estimator(cfg), jax_estimator(jcfg)
    for est in (blocking, deferred, jest):
        feed_estimator_frame(est, frames[0], init)
    f = frames[1]
    blocking.add_states(f.t, *f.imu, as_keyframe=f.keyframe, frame_id=f.frame_id)
    jest.add_states(f.t, *f.imu, as_keyframe=f.keyframe, frame_id=f.frame_id)
    deferred.add_states(f.t, *f.imu, as_keyframe=f.keyframe, frame_id=f.frame_id, defer_fetch=True)
    T, sb = deferred.last_prop_device()
    np.testing.assert_allclose(T.r.numpy(), blocking.r_WS[1], rtol=0, atol=0)
    tree = deferred.fetch_with_pending({"x": torch.arange(3.0)})
    np.testing.assert_array_equal(tree["x"], [0.0, 1.0, 2.0])
    assert deferred._pending_prop is None
    for name in ("r_WS", "q_WS", "sb"):
        np.testing.assert_array_equal(getattr(deferred, name), getattr(blocking, name))
        np.testing.assert_allclose(getattr(blocking, name), getattr(jest, name), rtol=0, atol=1e-12, err_msg=name)
