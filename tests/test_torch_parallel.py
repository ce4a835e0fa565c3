"""The port's batched and sharded BA against the JAX package's, in float64
on the CPU: mirrors of tests/test_parallel.py case for case, of
tests/test_solver.py:238 (optimize_windows_batched, whose JAX side runs
per window here: the vmapped JAX solve crashes XLA:CPU late in a long
process, tests/_batched_windows_check.py), of tests/test_multiprocess.py
(two processes joined by torch.distributed over gloo) and of
tests/test_pipeline.py:606 (ThreadedVio with distributed_devices = 8).

The JAX side runs on the 8-device virtual CPU mesh of tests/conftest.py;
the port's CPU meshes are virtual too (n shards on the one CPU device, one
batch over a leading shard axis). The JAX results are computed once, in
module fixtures. Tolerances are the JAX tests': poses 1e-8, the cost 1e-8
relative, hp_W 1e-7; batched against per-window 1e-9; shard_problem's
arrays exactly.
"""

import dataclasses
import functools
import os
import socket
import subprocess
import sys
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from helpers import build_synthetic_problem
from okvis_tpu.parallel import make_mesh as jmake_mesh
from okvis_tpu.parallel import make_sharded_optimizer as jmake_sharded_optimizer
from okvis_tpu.parallel import problem_specs as jproblem_specs
from okvis_tpu.parallel import shard_problem as jshard_problem
from okvis_tpu.solver import optimize_window as joptimize_window
from okvis_tpu_torch import convert
from okvis_tpu_torch.config import VioParameters
from okvis_tpu_torch.datasets.synthetic import feed_estimator_frame, keypoint_frames, make_landmarks, \
    simulate_trajectory
from okvis_tpu_torch.eval.ate import ate_rmse
from okvis_tpu_torch.parallel import make_mesh, make_mesh2d, make_sharded_optimizer, problem_specs, shard_problem
from okvis_tpu_torch.pipeline import ThreadedVio
from okvis_tpu_torch.solver import optimize_window, optimize_windows_batched
from okvis_tpu_torch.utils.ids import IdProvider
from test_parallel import perturb
from test_solver import perturb_problem
from test_torch_estimator import jax_estimator, port_estimator, port_rig, step, window_config, world
from test_torch_frontend import port_frame
from test_torch_threaded_vio import Harness

torch.set_num_threads(2)
NS = 1_000_000_000


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_side(jcfg, jimu, jintr, jproblem):
    cfg = convert.window_config_from_dict(dataclasses.asdict(jcfg))
    imu = convert.imu_params_from_numpy(_np(jimu), device="cpu")
    intr = [torch.from_numpy(np.array(i)) for i in jintr]
    return cfg, imu, intr, convert.problem_from_numpy(_np(jproblem), device="cpu")


@pytest.fixture(scope="module")
def world8():
    """tests/test_parallel.py's world, perturbed as it perturbs it, in both
    packages, with the JAX single-device and 8-shard solves."""
    jcfg, jimu, jintr, jproblem, truth = build_synthetic_problem(
        num_frames=4, n_landmarks=96,
        cfg_kwargs=dict(max_landmarks=128, max_observations=1024, max_iterations=6))
    jpert = perturb(jproblem, truth)
    jsingle = jax.jit(functools.partial(joptimize_window, jcfg, jimu, jintr))(jpert)
    jsharded = jmake_sharded_optimizer(jcfg, jimu, jintr, jmake_mesh(8))(jshard_problem(jpert, 8))
    return dict(jcfg=jcfg, jproblem=jproblem, jpert=jpert, truth=truth, single=_np(jsingle), sharded=_np(jsharded),
                port=_port_side(jcfg, jimu, jintr, jpert), port_truth=_port_side(jcfg, jimu, jintr, jproblem)[3])


def _assert_solution(states, cost, ref_states, ref_cost, what):
    np.testing.assert_allclose(states.r_WS.numpy(), ref_states.r_WS, rtol=0, atol=1e-8, err_msg=what)
    np.testing.assert_allclose(states.q_WS.numpy(), ref_states.q_WS, rtol=0, atol=1e-8, err_msg=what)
    np.testing.assert_allclose(float(cost), float(ref_cost), rtol=1e-8, err_msg=what)
    # the sharded layout keeps the landmark slots in place
    np.testing.assert_allclose(states.hp_W.numpy(), ref_states.hp_W, rtol=0, atol=1e-7, err_msg=what)


def test_sharded_matches_single_device(world8):
    """:48: the 8-shard solve against the single-device one: the port's
    against JAX's single-device and JAX's sharded solves, and against the
    port's own optimize_window."""
    cfg, imu, intr, problem = world8["port"]
    states, (cost, hist, acc, lam) = make_sharded_optimizer(cfg, imu, intr, make_mesh(8))(shard_problem(problem, 8))
    jstates, jdiag = world8["single"]
    _assert_solution(states, cost, jstates, jdiag.final_cost, "against JAX single-device")
    jsh_states, (jcost, jhist, jacc, jlam) = world8["sharded"]
    _assert_solution(states, cost, jsh_states, jcost, "against JAX sharded")
    np.testing.assert_allclose(hist.numpy(), jhist, rtol=1e-8)
    assert acc.tolist() == jacc.tolist()
    pstates, pdiag = optimize_window(cfg, imu, intr, problem)
    _assert_solution(states, cost, _np(pstates), pdiag.final_cost, "against the port's optimize_window")


def test_shard_problem_layout(world8):
    """:77: every active observation's local landmark index stays inside its
    block, and none is lost; the arrays equal JAX's exactly."""
    cfg, problem = world8["port"][0], world8["port_truth"]
    sharded = shard_problem(problem, 8)
    jsharded = jshard_problem(world8["jproblem"], 8)
    for name in sharded.obs._fields:
        got, want = getattr(sharded.obs, name).numpy(), np.asarray(getattr(jsharded.obs, name))
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    Os, Ls = cfg.max_observations // 8, cfg.max_landmarks // 8
    lm_idx, mask = sharded.obs.lm_idx.numpy(), sharded.obs.mask.numpy()
    for s in range(8):
        blk = slice(s * Os, (s + 1) * Os)
        assert np.all(lm_idx[blk][mask[blk]] < Ls)
    assert mask.sum() == problem.obs.mask.numpy().sum()


def test_problem_specs_match_jax(world8):
    """The sharded leaves (the observation table, lm_mask, states.hp_W) are
    JAX's, for one axis and for the ("host", "map") pair."""
    cfg = world8["port"][0]
    for axis in ("map", ("host", "map")):
        got = [s for s in pytree.tree_leaves(problem_specs(cfg, axis)) if s is not None]
        want = jax.tree_util.tree_leaves(jproblem_specs(world8["jcfg"], axis),
                                         is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert [bool(s.axes) for s in got] == [len(p) > 0 for p in want]
        assert {s.axes for s in got if s.axes} == {tuple(axis) if isinstance(axis, tuple) else (axis,)}


def test_multihost_2d_mesh_matches_single_device(world8):
    """:93: the 2 x 4 ("host", "map") mesh, its hierarchical sum (the map
    axis first, then the host axis), against the single-device solve."""
    cfg, imu, intr, problem = world8["port"]
    mesh = make_mesh2d(2, 4)
    assert mesh.shape == {"host": 2, "map": 4} and mesh.process_axis is None
    opt = make_sharded_optimizer(cfg, imu, intr, mesh, axis=("host", "map"))
    states, (cost, _hist, _acc, _lam) = opt(shard_problem(problem, 8))
    jstates, jdiag = world8["single"]
    _assert_solution(states, cost, jstates, jdiag.final_cost, "2 x 4 against JAX single-device")


def test_estimator_enable_distributed_matches_single():
    """:123: Estimator.optimize() with enable_distributed(8) equals the
    single-device optimize (landmarks compared by id: the slots go round
    robin over the shards) and JAX's distributed estimator on
    build_estimator_world's frames; then, over test_torch_estimator_parity's
    run (landmarks leave the window and are removed), the free-slot order
    that _rebalance_free_lm_slots leaves and the window equal JAX's after
    every frame."""
    frames, init = world(5, 4, 80)
    jcfg, cfg = window_config()
    jest, est, single = jax_estimator(jcfg), port_estimator(cfg), port_estimator(cfg)
    jest.enable_distributed(n_devices=8)
    est.enable_distributed(n_devices=8)
    assert est._mesh.size == 8 and est._select_tier() is None
    assert est._free_lm_slots == jest._free_lm_slots
    for e in (jest, est, single):
        for f in frames:
            feed_estimator_frame(e, f, init)
        e.optimize()
    np.testing.assert_allclose(est.r_WS, single.r_WS, atol=1e-7)
    np.testing.assert_allclose(est.q_WS, single.q_WS, atol=1e-7)
    assert set(est.landmarks) == set(single.landmarks)
    for lm_id in est.landmarks:
        np.testing.assert_allclose(est.get_landmark(lm_id), single.get_landmark(lm_id), atol=1e-6)
        assert abs(est.landmarks[lm_id].quality - single.landmarks[lm_id].quality) < 1e-6
    np.testing.assert_allclose(est.r_WS, np.asarray(jest.r_WS), atol=1e-8)
    np.testing.assert_allclose(est.hp_W, np.asarray(jest.hp_W), atol=1e-7)

    frames, init = world(13, 7, 150, keep=0.5)
    jest, est = jax_estimator(jcfg), port_estimator(cfg)
    jest.enable_distributed(n_devices=8)
    est.enable_distributed(n_devices=8)
    removed = []
    for f in frames:
        jremoved = step(jest, f, init)[1]
        assert sorted(step(est, f, init)[1]) == sorted(jremoved)
        removed += jremoved
        assert est._free_lm_slots == jest._free_lm_slots
        assert {i: r.slot for i, r in est.landmarks.items()} == {i: r.slot for i, r in jest.landmarks.items()}
        np.testing.assert_allclose(est.r_WS, np.asarray(jest.r_WS), atol=1e-7)
        np.testing.assert_allclose(est.hp_W, np.asarray(jest.hp_W), atol=1e-6)
    assert removed, "no landmark was removed: the slots never churned"


def test_enable_distributed_refuses_an_indivisible_capacity():
    """The divisibility check raises ValueError, as JAX's does."""
    _, cfg = window_config()
    est = port_estimator(dataclasses.replace(cfg, max_landmarks=120))
    with pytest.raises(ValueError, match="not divisible by mesh size 16"):
        est.enable_distributed(n_devices=16)


def test_shard_problem_overflow_policies(world8):
    """:148: one shard's landmarks over its O/n block: 'drop' sheds the
    excess (JAX's arrays exactly), 'raise' raises."""
    problem, jproblem = world8["port_truth"], world8["jproblem"]
    O = problem.obs.mask.shape[0]
    bad = problem._replace(obs=problem.obs._replace(lm_idx=torch.zeros_like(problem.obs.lm_idx)))
    jbad = jproblem._replace(obs=jproblem.obs._replace(lm_idx=jnp.zeros_like(jproblem.obs.lm_idx)))
    assert int(problem.obs.mask.sum()) > O // 8  # an overflow at 8 shards
    with pytest.raises(RuntimeError, match="overflow"):
        shard_problem(bad, 8, on_overflow="raise")
    with pytest.raises(RuntimeError, match="overflow"):
        jshard_problem(jbad, 8, on_overflow="raise")
    shed, jshed = shard_problem(bad, 8), jshard_problem(jbad, 8)
    for name in shed.obs._fields:
        assert np.array_equal(getattr(shed.obs, name).numpy(), np.asarray(getattr(jshed.obs, name))), name
    m = shed.obs.mask.numpy()
    assert m.sum() == O // 8 and not m[O // 8:].any()
    assert (shed.obs.lm_idx.numpy()[m] == 0).all()


def test_mesh_construction():
    """On the CPU a mesh of any size is virtual; a device list may repeat a
    device; make_mesh2d lays out hosts x map."""
    mesh = make_mesh(3)
    assert mesh.devices == (torch.device("cpu"),) * 3 and mesh.axis_names == ("map",) and mesh.size == 3
    assert make_mesh(devices=["cpu", "cpu"]).shape == {"map": 2}
    with pytest.raises(ValueError):
        make_mesh(4, devices=["cpu"] * 2)
    mesh2 = make_mesh2d(2, 3)
    assert mesh2.axis_names == ("host", "map") and mesh2.size == 6 and mesh2.first_shard == 0


def test_batched_windows_match_individual():
    """tests/test_solver.py:238: optimize_windows_batched on 3 perturbed
    copies of the world equals each window's optimize_window, the port's
    and JAX's, to 1e-9; no op falls back to vmap's per-window loop."""
    jcfg, jimu, jintr, jproblem, truth = build_synthetic_problem()
    rng = np.random.default_rng(1234)
    jprobs = [perturb_problem(jproblem, truth, rng) for _ in range(3)]
    jopt = jax.jit(functools.partial(joptimize_window, jcfg, jimu, jintr))
    sides = [_port_side(jcfg, jimu, jintr, p) for p in jprobs]
    cfg, imu, intr = sides[0][:3]
    probs = [s[3] for s in sides]
    batched = pytree.tree_map(lambda *xs: None if xs[0] is None else torch.stack(xs), *probs)
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            states_b, diag_b = optimize_windows_batched(cfg, imu, intr, batched)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    fallbacks = [str(w.message) for w in caught if "batching rule" in str(w.message)]
    assert not fallbacks, fallbacks
    assert states_b.r_WS.shape == (3, cfg.num_states, 3) and diag_b.cost_history.shape == (3, cfg.max_iterations)
    for i, (p, jp) in enumerate(zip(probs, jprobs)):
        s_i, d_i = optimize_window(cfg, imu, intr, p)
        js_i, jd_i = jopt(jp)
        for ref_r, ref_cost in ((s_i.r_WS.numpy(), float(d_i.final_cost)),
                                (np.asarray(js_i.r_WS), float(jd_i.final_cost))):
            np.testing.assert_allclose(states_b.r_WS[i].numpy(), ref_r, rtol=1e-9, atol=1e-9, err_msg=str(i))
            np.testing.assert_allclose(float(diag_b.final_cost[i]), ref_cost, rtol=1e-9, err_msg=str(i))
        np.testing.assert_allclose(diag_b.landmark_quality[i].numpy(), d_i.landmark_quality.numpy(), atol=1e-9)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_ba_equals_single_device():
    """tests/test_multiprocess.py: two OS processes, each one host row of a
    2 x 2 ("host", "map") mesh, joined by torch.distributed over gloo on
    localhost; the host axis's all_reduce crosses the processes, and the
    sharded solve equals the single-device one to 1e-8. Each worker is
    killed when its timeout expires."""
    worker = os.path.join(os.path.dirname(__file__), "torch_multiproc_worker.py")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, worker, str(i), "2", str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for i in range(2)]
    outs = []
    try:
        for i, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                pytest.fail(f"multi-process worker {i} timed out")
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {i} failed (rc={rc})\nstdout:\n{out}\nstderr:\n{err[-3000:]}"
    assert "MULTIPROC_OK" in outs[0][1], outs[0][1]


def test_threaded_vio_distributed_ba():
    """tests/test_pipeline.py:606: the pipeline with the BA sharded over an
    8-shard CPU mesh (config `distributed: devices: 8`), fed by a stub
    detector (datasets.synthetic.keypoint_frames), 8 frames; it tracks
    within the JAX test's ATE bound and the window equals that of the
    single-device pipeline on the same frames."""
    traj = simulate_trajectory(duration=2.0, seed=21, motion_scale=0.5)
    lms = make_landmarks(traj, 220, seed=22, radius=(3.0, 10.0))
    n_frames = 8
    frames = keypoint_frames(traj, lms, port_rig(), n_frames, 96, seed=0, pixel_noise=0.4)
    runs = []
    for devices in (8, 0):
        p = VioParameters()
        p.optimization.max_num_keypoints = 96
        p.optimization.distributed_devices = devices
        rig = port_rig()
        rig.compute_overlaps()
        n_threads = threading.active_count()
        IdProvider.reset()
        vio = ThreadedVio(p, rig=rig, blocking=True, dtype=torch.float64, device="cpu")
        assert (vio.estimator._mesh is not None) == bool(devices)
        h = Harness(vio, frames, port_frame)
        for fi in range(n_frames):
            h.feed(traj, fi)
        vio.shutdown()
        assert threading.active_count() == n_threads
        runs.append(vio)
    dist, single = runs
    assert len(dist.trajectory) >= n_frames - 3
    ts = np.asarray([s.timestamp_ns for s in dist.trajectory])
    ate = ate_rmse(ts, np.stack([s.T_WS.r.numpy() for s in dist.trajectory]), (traj.ts * NS).astype(np.int64),
                   traj.r)
    assert ate is not None and ate < 0.05, f"distributed-pipeline ATE {ate}"
    assert [s.timestamp_ns for s in single.trajectory] == ts.tolist()
    np.testing.assert_allclose(np.stack([s.T_WS.r.numpy() for s in dist.trajectory]),
                               np.stack([s.T_WS.r.numpy() for s in single.trajectory]), atol=1e-6)
    assert set(dist.estimator.landmarks) == set(single.estimator.landmarks)


@pytest.mark.slow
def test_full_vision_tracking_distributed_matches_jax():
    """tests/test_torch_runtime_e2e.py::test_full_vision_tracking with the
    window sharded over 8 shards in both packages: rendered frames through
    real detection, the JAX RANSAC keys replayed into the port, float64 on
    the CPU. The two runs take the same discrete decisions (landmarks and
    keyframe flags after every frame) and their ATEs agree to 1e-6 m."""
    from okvis_tpu.config.parameters import VioParameters as JVioParameters
    from okvis_tpu.pipeline import ThreadedVio as JThreadedVio
    from okvis_tpu_torch.datasets.synthetic import vio_scenario
    from test_torch_estimator import jax_rig
    from test_torch_frontend import replay_draws

    rig = port_rig()
    rig.compute_overlaps()
    scene = vio_scenario(rig, 14)
    jp, p = JVioParameters(), VioParameters()
    for params in (jp, p):
        params.optimization.max_num_keypoints = 200
        params.optimization.detection_threshold = 15.0
        params.optimization.distributed_devices = 8
    jrig = jax_rig()
    jrig.compute_overlaps()
    jvio = JThreadedVio(jp, rig=jrig, blocking=True, dtype=jnp.float64)
    tvio = ThreadedVio(p, rig=rig, blocking=True, dtype=torch.float64, device="cpu")
    assert jvio.estimator._n_shards == tvio.estimator._n_shards == 8
    replay_draws(jvio.frontend, tvio.frontend)
    per_frame = {}
    for vio in (jvio, tvio):
        h = Harness(vio)
        for fi, images in enumerate(scene.images):
            h.feed(scene.traj, fi, images=images)
        vio.shutdown()
        assert len(vio.trajectory) >= 11, f"tracked {len(vio.trajectory)} frames"
        per_frame[vio is tvio] = [(len(s["landmarks"]), [st["is_keyframe"] for st in s["states"]])
                                  for s in h.snapshots]
    ts = (scene.traj.ts * NS).astype(np.int64)
    ate, jate = (ate_rmse(np.asarray([s.timestamp_ns for s in v.trajectory]),
                          np.stack([np.asarray(s.T_WS.r, np.float64) for s in v.trajectory]), ts, scene.traj.r)
                 for v in (tvio, jvio))
    print(f"distributed full-vision ATE: port {ate:.6f} m, JAX {jate:.6f} m; landmarks port "
          f"{tvio.estimator.num_landmarks()}, JAX {jvio.estimator.num_landmarks()}")
    assert per_frame[True] == per_frame[False]
    assert abs(ate - jate) < 1e-6
    assert ate < 0.15
