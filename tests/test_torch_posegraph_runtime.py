"""The port's ThreadedVio with the pose-graph layer on, against the JAX
package's, in float64 on the CPU.

Both runtimes run test_torch_threaded_vio.py's 9 stub frames (K = 64) with
posegraph.enabled, min_gap = 1 (every keyframe but the newest is a
candidate), node capacity 64 and edge capacity 128, so the keyframe
database is 64 x 64, and the frontends' keyframe overlap threshold raised
from 0.6 to KEYFRAME_OVERLAP, so that most frames become keyframes (at 0.6
only the first is one in these 9 frames). The JAX frontend's RANSAC keys
are replayed into the port's Frontend._draw and the JAX manager's
verification keys into the port manager's _draw. The port runs a second time with the pose graph off.

Tolerances (measured gaps in brackets): after every frame the graph's slots,
edge ends, kinds and masks and the loop events (ids, scores, inlier counts,
decisions) exactly; node poses and edge measurements to 1e-8, the
ThreadedVio states' tolerance [node poses 3e-12]; the correction to 1e-8;
the database's landmark positions, read from the estimator's window, to
test_torch_threaded_vio.py's 5e-8 for them [1.1e-8, 7 m out].
The states of the run with the pose graph on equal those of the run with it
off bit for bit: the layer reads the estimator and never writes it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis_tpu.pipeline import ThreadedVio as JThreadedVio
from okvis_tpu.utils.ids import IdProvider as JIds
from okvis_tpu_torch import convert
from okvis_tpu_torch.datasets.synthetic import keypoint_frames, make_landmarks, simulate_trajectory
from okvis_tpu_torch.pipeline import ThreadedVio
from okvis_tpu_torch.utils.ids import IdProvider as TIds
from test_torch_frontend import KeyReplay, jax_frame, port_frame, replay_draws
from test_torch_posegraph import JaxManagerDraws
from test_torch_threaded_vio import K_SEQ, N_FRAMES, TOL_LANDMARK, Harness, _rigs, jax_params, port_params

torch.set_num_threads(2)
TOL = 1e-8
KEYFRAME_OVERLAP = 0.95


def with_posegraph(p, enabled=True):
    p.posegraph.enabled = enabled
    p.posegraph.min_gap = 1
    p.posegraph.node_capacity = 64
    p.posegraph.edge_capacity = 128
    return p


def graph_state(mgr) -> dict:
    """The manager's state after a frame (convert.posegraph_to_numpy)."""
    return convert.posegraph_to_numpy(mgr) if mgr is not None else None


def run_port(traj, frames, keys, trig, posegraph: bool):
    TIds.reset()
    vio = ThreadedVio(with_posegraph(port_params(), posegraph), rig=trig, blocking=True, dtype=torch.float64,
                      device="cpu")
    h = Harness(vio, frames, port_frame)
    vio.frontend.cfg.keyframe_overlap = KEYFRAME_OVERLAP
    vio.frontend._draw = KeyReplay(keys)
    loops = []
    if posegraph:
        vio.posegraph._draw = JaxManagerDraws(vio.posegraph.cfg.seed)
        vio.loop_closure_callback = loops.append
    states = []
    for fi in range(N_FRAMES):
        h.feed(traj, fi)
        states.append(graph_state(vio.posegraph))
    vio.shutdown()
    return dict(vio=vio, states=states, loops=loops)


@pytest.fixture(scope="module")
def runs():
    traj = simulate_trajectory(duration=1.2, seed=31, motion_scale=0.25)
    lms = make_landmarks(traj, 600, seed=32, radius=(4.0, 8.0))
    jrig, trig = _rigs()
    frames = keypoint_frames(traj, lms, trig, N_FRAMES, K_SEQ, seed=3)

    JIds.reset()
    jvio = JThreadedVio(with_posegraph(jax_params()), rig=jrig, blocking=True, dtype=jnp.float64)
    jh = Harness(jvio, frames, jax_frame)
    jvio.frontend.cfg.keyframe_overlap = KEYFRAME_OVERLAP
    jloops = []
    jvio.loop_closure_callback = jloops.append
    probe = ThreadedVio(port_params(), rig=trig, blocking=True, dtype=torch.float64, device="cpu")
    keys = replay_draws(jvio.frontend, probe.frontend)
    probe.shutdown()
    jstates = []
    for fi in range(N_FRAMES):
        jh.feed(traj, fi)
        jstates.append(graph_state(jvio.posegraph))
    jvio.shutdown()
    return dict(jax=dict(vio=jvio, states=jstates, loops=jloops),
                on=run_port(traj, frames, keys, trig, True), off=run_port(traj, frames, keys, trig, False))


def _split(values, floats, ints, prefix=""):
    """Flatten nested state into float arrays and everything else."""
    if isinstance(values, dict):
        for k, v in values.items():
            _split(v, floats, ints, f"{prefix}.{k}")
    elif isinstance(values, (list, tuple)):
        for i, v in enumerate(values):
            _split(v, floats, ints, f"{prefix}[{i}]")
    elif isinstance(values, np.ndarray) and values.dtype == np.float64:
        floats[prefix] = values
    else:
        ints[prefix] = values.tolist() if isinstance(values, np.ndarray) else values


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_graph_and_loop_events_match_jax_after_frame(runs, frame):
    got, want = runs["on"]["states"][frame], runs["jax"]["states"][frame]
    fg, ig, fw, iw = {}, {}, {}, {}
    _split({k: v for k, v in got.items() if k != "cfg"}, fg, ig)
    _split({k: v for k, v in want.items() if k != "cfg"}, fw, iw)
    assert ig == iw
    assert fg.keys() == fw.keys()
    for k in fg:
        tol = TOL_LANDMARK if k.startswith(".db.landmarks") else TOL
        np.testing.assert_allclose(fg[k], fw[k], rtol=0, atol=tol, err_msg=k)


def test_the_layer_saw_every_keyframe_and_verified_candidates(runs):
    vio = runs["on"]["vio"]
    keyframes = [s.timestamp_ns for s in vio.trajectory if s.is_keyframe]
    assert vio.posegraph.graph.n_nodes == len(keyframes) >= 3
    assert [t for _, t, _, _ in vio.posegraph.trajectory()] == keyframes
    assert len(vio.posegraph.loop_events) >= 1
    assert dataclasses.asdict(vio.posegraph.cfg) == {**dataclasses.asdict(runs["jax"]["vio"].posegraph.cfg),
                                                      "desc_dtype": np.uint32}


def test_loop_closure_callback_fires_for_each_accepted_loop(runs):
    for r in (runs["on"], runs["jax"]):
        accepted = [e for e in r["vio"].posegraph.loop_events if e.accepted]
        assert [dataclasses.asdict(e) for e in r["loops"]] == [dataclasses.asdict(e) for e in accepted]
    assert len(runs["on"]["loops"]) == len(runs["jax"]["loops"]) >= 1


def test_states_are_those_of_the_run_without_the_pose_graph(runs):
    on, off = runs["on"]["vio"].trajectory, runs["off"]["vio"].trajectory
    assert runs["off"]["vio"].posegraph is None and len(on) == len(off) == N_FRAMES
    for a, b in zip(on, off):
        assert (a.timestamp_ns, a.is_keyframe) == (b.timestamp_ns, b.is_keyframe)
        assert torch.equal(a.T_WS.r, b.T_WS.r) and torch.equal(a.T_WS.q, b.T_WS.q)
        assert np.array_equal(a.speed_and_bias, b.speed_and_bias)
