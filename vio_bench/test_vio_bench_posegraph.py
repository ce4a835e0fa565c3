"""CPU tests of the benchmark's pose-graph side: the layer's settings come
from the configuration file, its taps are installed only where the layer
runs and put back by `close`, and the plain reference's retrieval scores,
solve and loop-edge number agree with the program where it is sound and
disagree where a fault is planted.

    python -m pytest vio_bench/test_vio_bench_posegraph.py -q
"""

from __future__ import annotations

import dataclasses
import json
import time
import types

import numpy as np
import pytest
import torch

from vio_bench import check, control, harness, world

POSEGRAPH_CHECKS = ("posegraph_scores_differ", "loop_edge_err_m", "loop_edge_err_deg", "posegraph_solve_err_m",
                    "posegraph_solve_err_rad")
# the numbers of which each planted fault, and the control, has to fail one
FAULT_NUMBERS = {"retrieval_vote_shifted": ("posegraph_scores_differ",), "loop_edge_perturbed": ("loop_edge_err_m",),
                 "loop_edge_turned": ("loop_edge_err_deg",), "posegraph_solve_skipped": ("posegraph_solve_err_m",),
                 "posegraph_solve_float32": ("posegraph_solve_err_m", "posegraph_solve_err_rad")}
# the float64 solves agree to rounding (1e-15 here); the reference's own
# solve in float32 departs by 1e-7 m and more
SOLVE_TOL = 1e-9


def _config(posegraph) -> dict:
    config = harness.load_json(harness.config_file("euroc_stereo"))
    return dict(config, name="euroc_stereo_loop", posegraph=posegraph)


def _fake_vio(manager=None):
    """What Taps wraps of a ThreadedVio, with the given pose-graph manager."""
    noop = lambda *a, **k: None  # noqa: E731
    return types.SimpleNamespace(
        frontend=types.SimpleNamespace(detect_and_describe_multi=noop, data_association_and_initialization=noop),
        estimator=types.SimpleNamespace(add_states=noop, optimize=noop, apply_marginalization_strategy=noop),
        posegraph=manager)


def _module_names():
    from okvis_tpu_torch.frontend import detection
    from okvis_tpu_torch.frontend import kernels as fkernels
    from okvis_tpu_torch.posegraph import place_recognition

    return {(m, n): getattr(m, n) for m, n in ((fkernels, "masked_distance_matrix"),
                                              (detection, "harris_suppressed"),
                                              (place_recognition, "masked_distance_matrix"),
                                              (place_recognition, "score_against_database"))}


def test_settings_reach_the_manager():
    from okvis_tpu_torch.pipeline import ThreadedVio

    settings = dict(enabled=True, score_threshold=0.3, min_gap=4, min_inliers=12, node_capacity=16,
                    edge_capacity=40, cull_redundant=True)
    params = harness.vio_parameters(_config(settings))
    assert dataclasses.asdict(params.posegraph) == settings
    vio = ThreadedVio(params, blocking=True, dtype=torch.float32, device="cpu")
    try:
        cfg = vio.posegraph.cfg
        assert (cfg.score_threshold, cfg.min_gap, cfg.min_inliers, cfg.node_capacity, cfg.edge_capacity) == (
            0.3, 4, 12, 16, 40)
        assert vio.params.posegraph.cull_redundant is True
    finally:
        vio.shutdown()
    assert harness.vio_parameters(_config(False)).posegraph.enabled is False
    with pytest.raises(ValueError, match="vote_threshold"):
        harness.vio_parameters(_config(dict(enabled=True, vote_threshold=50)))


def _manager(capacity: int = 16):
    from okvis_tpu_torch.posegraph.manager import PoseGraphConfig, PoseGraphManager

    return PoseGraphManager(PoseGraphConfig(node_capacity=capacity, edge_capacity=2 * capacity, db_kp_capacity=64,
                                            desc_words=16, desc_dtype=np.uint32), device="cpu")


@pytest.mark.parametrize("with_layer", [False, True])
def test_taps_only_where_the_layer_runs_and_put_back(with_layer):
    before = _module_names()
    manager = _manager() if with_layer else None
    methods = None if manager is None else (manager.db.query, manager.graph.optimize)
    taps = harness.Taps(_fake_vio(manager), 5, count_shapes=True)
    assert hasattr(taps, "retrieval") == with_layer and hasattr(taps, "solves") == with_layer
    assert ("hamming_db" in taps.shapes) == with_layer
    if not with_layer:
        from okvis_tpu_torch.posegraph import place_recognition

        assert place_recognition.masked_distance_matrix is before[(place_recognition, "masked_distance_matrix")]
    taps.close()
    assert _module_names() == before
    if with_layer:
        assert (manager.db.query, manager.graph.optimize) == methods


def _flipped(desc: np.ndarray, n_bits: np.ndarray, rng) -> np.ndarray:
    """Each 512-bit row of `desc` with n_bits[k] bits flipped."""
    bits = np.unpackbits(desc.view(np.uint8), axis=1)
    for k, n in enumerate(n_bits):
        bits[k, rng.choice(512, int(n), replace=False)] ^= 1
    return np.packbits(bits, axis=1).view(np.uint32)


def _fill_database(manager, taps, rng, queries: int = 6):
    """Keyframes of random descriptors, each query a copy of an earlier
    keyframe with 40-80 bits of each descriptor flipped (so distances fall
    on both sides of the vote threshold); the queries sampled."""
    K = manager.db.kp_cap
    geometry = dict(bearings_C=np.tile([0.0, 0.0, 1.0], (K, 1)), landmarks_W=np.zeros((K, 3)),
                    lm_valid=np.zeros(K, bool))
    pose = (np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]))
    kept = []
    for kf in range(12):
        desc = rng.integers(0, 2**32, (K, 16), dtype=np.uint32)
        mask = rng.random(K) < 0.9
        manager.add_keyframe(kf, kf, *pose, descriptors=desc, desc_mask=mask, **geometry)
        kept.append(desc)
    taps.active = True
    for i in range(queries):
        desc = _flipped(kept[i], rng.integers(40, 80, K), rng)
        manager.add_keyframe(100 + i, 100 + i, *pose, descriptors=desc, desc_mask=rng.random(K) < 0.95, **geometry)
    taps.active = False


@pytest.mark.parametrize("fault", [None, "retrieval_vote_shifted"])
def test_reference_scores(fault):
    restore = []
    if fault:
        control.POSEGRAPH_FAULTS[fault](None, restore)
    try:
        manager = _manager()
        manager.cfg.score_threshold = 2.0  # no candidate verified: retrieval alone
        taps = harness.Taps(_fake_vio(manager), 7, count_shapes=False)
        _fill_database(manager, taps, np.random.default_rng(3))
        taps.close()
    finally:
        for module, name, orig in restore:
            setattr(module, name, orig)
    retrievals = taps.retrieval.items
    assert len(retrievals) == harness.SAMPLES and taps.retrieval.n == 6
    differ = check.scores_number(retrievals)
    if fault:
        assert differ > 0
    else:
        assert differ == 0
        assert all(r["scores"][r["best"]] > 0.2 for r in retrievals)  # each query found its keyframe


def _graph(rng, n: int = 30):
    """A chain of odometry edges with loop edges every third node, the
    first node fixed, the poses perturbed from the truth."""
    from okvis_tpu_torch.kinematics import np_se3
    from okvis_tpu_torch.posegraph.graph import PoseGraph

    g = PoseGraph(32, 64, device="cpu")
    true_r = np.cumsum(rng.normal(size=(n, 3)) * 0.3, 0)
    true_q = np.stack([np_se3.quat_normalize(np.append(rng.normal(size=3) * 0.4, 1.0)) for _ in range(n)])
    for k in range(n):
        q = np_se3.quat_normalize(true_q[k] + rng.normal(size=4) * 0.01)
        g.add_node(k, true_r[k] + rng.normal(size=3) * 0.05, q, fixed=k == 0)

    def edge(i, j, kind, L):
        t, q = np_se3.relative(true_r[i], true_q[i], true_r[j], true_q[j])
        g.add_edge(i, j, t + rng.normal(size=3) * 0.01, q, L, kind)

    for k in range(1, n):
        edge(k - 1, k, 0, np.diag([100.0] * 3 + [333.0] * 3))
    for k in range(10, n, 3):
        edge(k - 10, k, 1, np.diag([30.0] * 3 + [100.0] * 3))
    return g


@pytest.mark.parametrize("case", ["program", "posegraph_solve_skipped", "posegraph_solve_float32"])
def test_reference_solve(case):
    restore = []
    if case != "program":
        control.POSEGRAPH_FAULTS[case](None, restore)
    try:
        g = _graph(np.random.default_rng(11))
        manager = types.SimpleNamespace(db=types.SimpleNamespace(query=None), graph=g)
        taps = harness.Taps(_fake_vio(manager), 3, count_shapes=False)
        taps.active = True
        g.optimize(max_iterations=10)
        taps.close()
    finally:
        for module, name, orig in restore:
            setattr(module, name, orig)
    m, rad = check.solve_numbers(taps.solves.items)
    if case == "program":
        assert m < SOLVE_TOL and rad < SOLVE_TOL
    else:
        assert m > SOLVE_TOL or rad > SOLVE_TOL


def test_loop_edge_number():
    m = world.draw_motion(harness.load_json(harness.traffic_file("spin")), 17)
    stream = types.SimpleNamespace(truth=lambda t_ns: (m.position(np.asarray(t_ns) / 1e9),
                                                       m.rotation(np.asarray(t_ns) / 1e9), None))
    from okvis_tpu_torch.kinematics import np_se3

    t_c = np.array([0, 150, 400, 1000]) * 1_000_000
    t_q = np.array([2000, 2300, 2450, 3900]) * 1_000_000
    pc, Rc, _ = stream.truth(t_c)
    pq, Rq, _ = stream.truth(t_q)
    true = [np_se3.relative(pc[k], np_se3.matrix_to_quat(Rc[k]), pq[k], np_se3.matrix_to_quat(Rq[k]))
            for k in range(len(t_c))]
    edges = [(t_c[k], t_q[k], r, q) for k, (r, q) in enumerate(true)]
    m_err, deg_err = check.loop_edge_numbers(edges, stream)
    assert m_err < 1e-9 and deg_err < 1e-6
    planted = [(a, b, r + np.array([0.2, 0.0, 0.0]), q) for a, b, r, q in edges]
    assert check.loop_edge_numbers(planted, stream)[0] == pytest.approx(0.2, abs=1e-9)
    turn = np.array([0.0, 0.0, np.sin(np.radians(1.0)), np.cos(np.radians(1.0))])  # 2 degrees about z
    turned = [(a, b, r, np_se3.quat_multiply(turn, q)) for a, b, r, q in edges]
    assert check.loop_edge_numbers(turned, stream)[1] == pytest.approx(2.0, abs=1e-6)
    assert check.loop_edge_numbers([], stream) == (None, None)


@pytest.mark.parametrize("fault", [None, *sorted(control.POSEGRAPH_FAULTS)])
def test_cpu_run_of_a_posegraph_cell(tmp_path, monkeypatch, fault):
    """A short run of a temporary cell, the harness's look for a card
    skipped: the stereo rig with the layer on (a small database, loops
    allowed one keyframe back) on the lap, whose next keyframes close a
    loop with its first. Sound, it reports the five numbers within their
    limits and the Timing counts; with a fault, or the float32 control,
    planted underneath the taps, it is not correct."""
    config = _config(dict(enabled=True, min_gap=1, node_capacity=8, edge_capacity=16))
    (tmp_path / "config.json").write_text(json.dumps(config))
    limits = dict(harness.load_json(harness.limits_file("euroc_stereo.lap")), posegraph_scores_differ=0,
                  loop_edge_err_m=0.06, loop_edge_err_deg=1.0, posegraph_solve_err_m=SOLVE_TOL,
                  posegraph_solve_err_rad=SOLVE_TOL)
    (tmp_path / "limits.json").write_text(json.dumps(limits))
    cell = dict(name="euroc_stereo_loop.lap", config="euroc_stereo_loop", traffic="lap", chips=1)
    monkeypatch.setattr(harness, "find_cell", lambda name: cell)
    monkeypatch.setattr(harness, "config_file", lambda name: tmp_path / "config.json")
    monkeypatch.setattr(harness, "limits_file", lambda name: tmp_path / "limits.json")
    records = []
    monkeypatch.setattr(harness, "cell_metrics", lambda name, kind: [dict(name="probe", unit="1")])
    monkeypatch.setattr(harness, "metric_reader", lambda name: records.append)
    torch.set_num_threads(4)
    restore = []
    prepare = None if fault is None else (lambda vio: control.POSEGRAPH_FAULTS[fault](vio, restore))
    try:
        result, _ = harness.run(cell["name"], 2**31 + 11, 4.0, True, time.perf_counter(), device="cpu",
                                    warmup_frames=3, prepare=prepare)
    finally:
        for module, name, orig in restore:
            setattr(module, name, orig)
    checks = result["checks"]
    assert list(checks)[-len(POSEGRAPH_CHECKS):] == list(POSEGRAPH_CHECKS)
    if fault is not None:
        assert result["correct"] is False, checks
        assert any(checks[k]["value"] > checks[k]["limit"] for k in FAULT_NUMBERS[fault]), checks
        return
    assert all(checks[k]["value"] is not None and checks[k]["value"] <= checks[k]["limit"] for k in POSEGRAPH_CHECKS)
    (record,) = records
    assert record["stages_n"]["3.3 posegraph"] >= 1
    assert set(record["stages_n"]) == set(record["stages_s"])
