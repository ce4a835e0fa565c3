"""Per-state extrinsics (one T_SC block a state and camera, linked by
relative-pose drift factors) in the port against the JAX package, in
float64 on the CPU.

The run mirrors tests/test_estimator.py:204: the estimators believe a
camera-1 translation 4, -3, 2 mm off the truth that generated the
observations (0.3 px noise), with relative sigmas 1e-3 m/sqrt(s) and 1e-4
rad/sqrt(s), absolute sigmas 0.05 m and 0.01 rad, a window of S = 9,
L = 256, O = 1024 and 5 LM iterations (D = 255), over 7 frames of the
estimator tests' synthetic frontend (trajectory seed 3, motion 0.6, 120
landmarks at 3-9 m, seed 4). Both packages get the same numpy frames.

Tolerances: the window after every frame as test_torch_estimator.py holds
it (ids, records, drift links and FEJ flags exactly; states, the per-state
extrinsics and their FEJ points to 1e-8; the prior's H to 1e-9 of its
largest entry); one per-state window's normal equations (H, b to 1e-8 of
their largest entry), marg_delta_chi to 1e-10 and an LM optimize's states
to 1e-8; a checkpoint restored exactly. Then the ThreadedVio wiring of
tests/test_pipeline.py:455, with parameters built in code.
"""

import dataclasses
import io
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis_tpu.cameras import NCameraSystem as JRig
from okvis_tpu.config.parameters import VioParameters as JVioParameters
from okvis_tpu.estimator import Estimator as JEstimator
from okvis_tpu.imu import ImuParams as JImuParams
from okvis_tpu.kinematics import SE3 as JSE3
from okvis_tpu.pipeline import ThreadedVio as JThreadedVio
from okvis_tpu.solver import WindowConfig as JWindowConfig
from okvis_tpu.solver import evaluate as jevaluate
from okvis_tpu.solver import optimize_window as joptimize_window
from okvis_tpu.solver.assemble import marg_delta_chi as jmarg_delta_chi
from okvis_tpu_torch import convert
from okvis_tpu_torch import kinematics as kin
from okvis_tpu_torch.cameras.ncamera import NCameraSystem
from okvis_tpu_torch.datasets.synthetic import (
    estimator_scenario, euroc_stereo_rig, feed_estimator_frame, make_landmarks, simulate_trajectory)
from okvis_tpu_torch.estimator import Estimator
from okvis_tpu_torch.solver import evaluate, marg_delta_chi, optimize_window
from test_torch_estimator import TOL_STATE, assert_same_window, jax_rig, port_imu, snapshot
from test_torch_pipeline import _params, _vio

torch.set_num_threads(2)

N_FRAMES = 7
OFFSET = np.asarray([0.004, -0.003, 0.002])  # camera 1's translation error (test_estimator.py:204)
PER_STATE = dict(extrinsics_per_state=True, sigma_c_relative_translation=1e-3, sigma_c_relative_orientation=1e-4,
                 sigma_absolute_translation=0.05, sigma_absolute_orientation=0.01)
PER_STATE_FIELDS = ("r_SC_t", "q_SC_t", "fej_r_SC_t", "fej_q_SC_t")


def perturbed_rigs():
    """The estimators' rig (camera 1 moved by OFFSET) in both packages."""
    specs, T_SC, intr = euroc_stereo_rig(device="cpu")
    r_bad = T_SC.r.clone()
    r_bad[1] += torch.from_numpy(OFFSET)
    trig = NCameraSystem(specs=specs, T_SC=kin.SE3(r=r_bad, q=T_SC.q), intrinsics=intr)
    j = jax_rig()
    jrig = JRig(specs=j.specs, T_SC=JSE3(r=jnp.asarray(r_bad.numpy()), q=j.T_SC.q), intrinsics=j.intrinsics)
    return jrig, trig


def per_state_config():
    rig = jax_rig()
    jcfg = JWindowConfig(num_states=9, num_cameras=2, max_landmarks=256, max_observations=1024, imu_samples=32,
                         max_imu_links=8, max_iterations=5, camera_specs=tuple(rig.specs), **PER_STATE)
    return jcfg, convert.window_config_from_dict(dataclasses.asdict(jcfg))


def _same(a, b) -> bool:
    """Exact equality of nested plain values and numpy arrays."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return bool(np.array_equal(a, b))
    return a == b


def assert_same_per_state(got, want, what):
    """The per-state tables beside assert_same_window's fields."""
    assert got["ext_links"] == want["ext_links"], what
    np.testing.assert_array_equal(got["fej_ext_t_frozen"], want["fej_ext_t_frozen"], err_msg=what)
    for key in PER_STATE_FIELDS:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=TOL_STATE, err_msg=f"{what} {key}")


@pytest.fixture(scope="module")
def run():
    specs, T_SC, intr = euroc_stereo_rig(device="cpu")
    truth = NCameraSystem(specs=specs, T_SC=T_SC, intrinsics=intr)
    traj = simulate_trajectory(duration=1.2, seed=3, motion_scale=0.6)
    lms = make_landmarks(traj, 120, seed=4, radius=(3.0, 9.0))
    frames, init = estimator_scenario(traj, lms, truth, N_FRAMES, seed=5, pixel_noise=0.3)
    jcfg, cfg = per_state_config()
    jrig, trig = perturbed_rigs()
    jest = JEstimator(jrig, JImuParams.euroc(), 5, 3, cfg=jcfg)
    est = Estimator(trig, port_imu(), 5, 3, cfg=cfg, device="cpu", dtype=torch.float64)
    out = dict(jax=[], port=[], frames=frames, init=init, cfg=cfg, jcfg=jcfg, trig=trig, true_r1=T_SC.r[1].numpy())
    for i, f in enumerate(frames):
        for e, key in ((jest, "jax"), (est, "port")):
            sid = feed_estimator_frame(e, f, init)
            if key == "jax" and i == 4:
                # a per-state window with a prior, drift links and FEJ points
                # away from the current states, before its optimize
                out["jproblem"] = jax.tree_util.tree_map(np.asarray, e._build_problem())
            e.optimize()
            out[key].append(snapshot(e, e.apply_marginalization_strategy()))
            out[key][-1]["sid"] = sid
        if i == 4:
            out["port_before_5"] = convert.estimator_to_numpy(est)
    out["est"], out["jest"] = est, jest
    return out


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_window_matches_jax_after_frame(run, frame):
    assert_same_window(run["port"][frame], run["jax"][frame], f"frame {frame + 1}")
    assert_same_per_state(run["port"][frame], run["jax"][frame], f"frame {frame + 1}")


def test_per_state_blocks_links_and_calibration(run):
    """The drift links join states of the window (the links of removed
    frames went into the prior), camera 1's newest block moved toward the
    truth, and the shared tables mirror the newest state's."""
    est, last = run["est"], run["port"][-1]
    assert est.cfg.dense_dim == 9 * 15 + 2 * 6 + 9 * 2 * 6 == 255
    assert est.ext_links and all(l["id_a"] in est.states and l["id_b"] in est.states for l in est.ext_links)
    slot = est.states[last["sid"]].slot
    np.testing.assert_array_equal(est.r_SC, est.r_SC_t[slot])
    err0 = np.linalg.norm(OFFSET)
    err1 = np.linalg.norm(est.r_SC_t[slot, 1] - run["true_r1"])
    jslot = run["jest"].states[last["sid"]].slot
    jerr1 = np.linalg.norm(run["jest"].r_SC_t[jslot, 1] - run["true_r1"])
    print(f"camera-1 calibration error: {err0:.6f} -> port {err1:.6f}, JAX {jerr1:.6f}")
    assert err1 < err0
    T = est.get_extrinsics(1, last["sid"])
    np.testing.assert_array_equal(T.r.numpy(), est.r_SC_t[slot, 1])


@pytest.fixture(scope="module")
def window(run):
    """The JAX estimator's per-state problem before frame 5's optimize, in
    both packages, and the JAX results on it."""
    jp = run["jproblem"]
    jcfg, cfg = run["jcfg"], run["cfg"]
    jtree = jax.tree_util.tree_map(jnp.asarray, jp)
    intr_j = [jnp.asarray(np.asarray(i)) for i in run["jest"].intrinsics]
    imu_j = run["jest"].imu_params
    problem = convert.problem_from_numpy(jp, device="cpu")
    return dict(
        problem=problem, cfg=cfg, intr=run["est"].intrinsics, imu=run["est"].imu_params,
        jeqs=jevaluate(jcfg, imu_j, intr_j, jtree, jtree.states),
        jdchi=np.asarray(jmarg_delta_chi(jcfg, jtree.states, jtree.marg)),
        jopt=joptimize_window(jcfg, imu_j, intr_j, jtree))


def test_per_state_window_has_links_prior_and_fej_points(window):
    p = window["problem"]
    assert int(p.ext_links.mask.sum()) >= 2 and bool(p.marg.valid)
    assert p.states.r_SC_t.shape == (9, 2, 3) and p.marg.q_SC_t_lin.shape == (9, 2, 4)


def test_marg_delta_chi_matches_jax(window):
    p = window["problem"]
    got = marg_delta_chi(window["cfg"], p.states, p.marg).numpy()
    assert got.shape == (255,) and np.abs(window["jdchi"][147:]).max() > 0
    np.testing.assert_allclose(got, window["jdchi"], rtol=0, atol=1e-10)


def test_evaluate_matches_jax(window):
    p = window["problem"]
    eqs = evaluate(window["cfg"], window["imu"], window["intr"], p, p.states)
    for name in ("H_dd", "b_d", "H_ll", "b_l", "W", "cost"):
        got, want = getattr(eqs, name).numpy(), np.asarray(getattr(window["jeqs"], name))
        scale = max(np.abs(want).max(), 1e-300)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-8 * scale, err_msg=name)
    # the per-state columns are populated: reprojection, links and prior
    assert np.abs(eqs.H_dd[147:, 147:].numpy()).max() > 0


def test_optimize_matches_jax(window):
    p = window["problem"]
    states, diag = optimize_window(window["cfg"], window["imu"], window["intr"], p)
    jstates, jdiag = window["jopt"]
    np.testing.assert_array_equal(diag.accepted.numpy(), np.asarray(jdiag.accepted))
    np.testing.assert_allclose(diag.cost_history.numpy(), np.asarray(jdiag.cost_history), rtol=1e-8)
    for name in states._fields:
        np.testing.assert_allclose(getattr(states, name).numpy(), np.asarray(getattr(jstates, name)), rtol=0,
                                   atol=1e-7 if name == "hp_W" else 1e-8, err_msg=name)


def test_checkpoint_round_trip_and_resume(run, tmp_path):
    """A per-state estimator saved after frame 5 and loaded into a fresh one
    holds the same window exactly; both then run the last two frames to the
    same window as the JAX package."""
    est = convert.estimator_from_numpy(run["port_before_5"], run["trig"], port_imu(), run["cfg"], device="cpu",
                                       dtype=torch.float64)
    path = str(tmp_path / "per_state.ckpt")
    est.save_checkpoint(path)
    fresh = Estimator(run["trig"], port_imu(), 5, 3, cfg=run["cfg"], device="cpu", dtype=torch.float64)
    fresh.load_checkpoint(path)
    a, b = convert.estimator_to_numpy(est), convert.estimator_to_numpy(fresh)
    assert a.keys() == b.keys()
    for k in a:
        assert _same(a[k], b[k]), k
    assert a["ext_links"] and a["fej_ext_t_frozen"].any()
    for i in (5, 6):
        for e in (est, fresh):
            feed_estimator_frame(e, run["frames"][i], run["init"])
            e.optimize()
            removed = e.apply_marginalization_strategy()
        assert_same_window(snapshot(fresh, removed), run["jax"][i], f"resumed frame {i + 1}")
        assert_same_per_state(snapshot(fresh, removed), run["jax"][i], f"resumed frame {i + 1}")


def test_threaded_vio_wiring_matches_jax():
    """tests/test_pipeline.py:455: both relative sigmas switch the estimator
    to per-state extrinsics (D = S 15 + C 6 (1 + S)) with the sigmas in its
    config and the first state's blocks anchored; a single nonzero relative
    sigma warns and leaves the extrinsics shared."""
    kw = dict(sigma_c_relative_translation=1e-4, sigma_c_relative_orientation=1e-5,
              sigma_absolute_translation=0.05, sigma_absolute_orientation=0.02)
    jp = JVioParameters()
    for k, v in kw.items():
        setattr(jp.camera_params, k, v)
    jrig = jax_rig()
    jrig.overlaps = np.ones((2, 2), bool)
    jvio = JThreadedVio(jp, rig=jrig, blocking=True, dtype=jnp.float64)
    vio = _vio(_params(**kw))
    try:
        cfg, jcfg = vio.estimator.cfg, jvio.estimator.cfg
        assert cfg.extrinsics_per_state and jcfg.extrinsics_per_state
        assert not cfg.estimate_extrinsics and not jcfg.estimate_extrinsics
        assert cfg.sigma_c_relative_translation == 1e-4 and cfg.sigma_absolute_translation == 0.05
        assert cfg.dense_dim == jcfg.dense_dim == cfg.num_states * 15 + cfg.num_cameras * 6 * (1 + cfg.num_states)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(convert.window_config_from_dict(dataclasses.asdict(jcfg)))
        assert vio.frontend.cfg.gate_extra_px == jvio.frontend.cfg.gate_extra_px > 0
    finally:
        vio.shutdown()
        jvio.shutdown()

    h = logging.StreamHandler(io.StringIO())
    logging.getLogger("okvis_tpu_torch").addHandler(h)
    try:
        vio2 = _vio(_params(sigma_c_relative_translation=1e-4))
        assert not vio2.estimator.cfg.extrinsics_per_state
        assert "sigma_c_relative" in h.stream.getvalue()
        vio2.shutdown()
    finally:
        logging.getLogger("okvis_tpu_torch").removeHandler(h)
