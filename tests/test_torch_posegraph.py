"""The port's pose-graph layer (okvis_tpu_torch.posegraph) against the JAX
package's, in float64 on the CPU.

Each case of tests/test_posegraph.py runs through both packages on the same
numpy inputs (the drifting circle, culling, retrieval, verification, the
square manager loop, stationary culling), and the JAX test's own assertions
are made of the port's result as well. The managers' configs are the JAX
test's with db_kp_capacity = 64 (the JAX default is 512; its 60 keypoints
fit), so a query is a (64, 64·64) distance matrix on the CPU. The JAX
manager's RANSAC keys (one split a verification, from PRNGKey(cfg.seed))
are replayed into the port manager's _draw as the uniforms they give.

Tolerances (measured gaps in brackets): edge residuals and the analytic
Jacobian blocks against the JAX package's vmap(jacfwd) to 1e-10 absolute
[residuals 9e-15, blocks 1e-13 on entries up to 114]; diagonal blocks and
the dense Hessian to 1e-10 relative to their largest entry [1e-15];
optimize_pose_graph, dense and PCG: costs to rtol 1e-9, poses to 1e-9
[8e-15], iterations equal; retrieval scores exactly; verification with
JAX's key: inliers, matches and success exactly, the model to 1e-9; the
manager: every event, the graph's slots, edges and masks exactly or (poses
after a solve) to 1e-9, the correction to 1e-9; culling and the composed
edges exactly (the same numpy arithmetic).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis_tpu.kinematics import np_se3
from okvis_tpu.posegraph import loop_closure as jlc
from okvis_tpu.posegraph import optimize as jopt
from okvis_tpu.posegraph.graph import PoseGraph as JPoseGraph
from okvis_tpu.posegraph.manager import PoseGraphConfig as JConfig
from okvis_tpu.posegraph.manager import PoseGraphManager as JManager
from okvis_tpu.posegraph.place_recognition import KeyframeDatabase as JDatabase
from okvis_tpu_torch import convert
from okvis_tpu_torch.datasets.synthetic import circle_pose_graph, fill_pose_graph, square_loop_keyframes
from okvis_tpu_torch.posegraph import loop_closure as tlc
from okvis_tpu_torch.posegraph import optimize as topt
from okvis_tpu_torch.posegraph.graph import PoseGraph
from okvis_tpu_torch.posegraph.manager import PoseGraphConfig, PoseGraphManager
from okvis_tpu_torch.posegraph.place_recognition import KeyframeDatabase, as_words
from test_posegraph import bearings_of, build_drifting_circle, circle_poses, make_world, random_descriptors

torch.set_num_threads(2)
TOL = 1e-9
TOL_JAC = 1e-10
TOL_COST = 1e-20
GRAPH_FIELDS = convert.GRAPH_ARRAYS


def port_graph(jg) -> PoseGraph:
    """A port PoseGraph holding a JAX PoseGraph's state."""
    return convert.graph_from_numpy(convert.graph_to_numpy(jg), device="cpu")


def assert_same_graph(g, jg, tol=0.0, what=""):
    """Slots, masks and edge ends exactly; poses and measurements (a loop
    edge's comes from the RANSAC model) to `tol`."""
    assert (g.slot_of, g.id_of, g._free_slots, g.n_nodes, g.n_edges) == (
        jg.slot_of, jg.id_of, jg._free_slots, jg.n_nodes, jg.n_edges), what
    for k in GRAPH_FIELDS:
        a, b = getattr(g, k), getattr(jg, k)
        if a.dtype == np.float64:
            np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")


def assert_same_result(res, jres):
    # costs at the rounding floor (a chain built from its own measurements)
    # are compared to TOL_COST
    np.testing.assert_allclose(float(res.initial_cost), float(jres.initial_cost), rtol=TOL, atol=TOL_COST)
    np.testing.assert_allclose(float(res.final_cost), float(jres.final_cost), rtol=TOL, atol=TOL_COST)
    assert int(res.iterations) == int(jres.iterations)
    np.testing.assert_allclose(res.node_r.numpy(), np.asarray(jres.node_r), rtol=0, atol=TOL)
    np.testing.assert_allclose(res.node_q.numpy(), np.asarray(jres.node_q), rtol=0, atol=TOL)


def closed_circle(rng, n):
    jg, gt = build_drifting_circle(rng, n)
    r_l, q_l = np_se3.relative(*gt[n - 1], *gt[0])
    jg.add_edge(n - 1, 0, r_l, q_l, np.eye(6) * 100.0, kind=1)
    return jg, gt


def culled_circle(rng, n):
    jg, gt = build_drifting_circle(rng, n)
    jg.remove_node(7)
    jg.remove_node(13)
    return jg, gt


# ------------------------------------------------------------------ solver


@pytest.mark.parametrize("make", [closed_circle, culled_circle], ids=["closed_circle", "culled_circle"])
def test_residuals_jacobians_and_hessian_match_jax(rng, make):
    jg, _ = make(rng, 20)
    ja, ta = jg.to_arrays(), port_graph(jg).to_arrays()
    d = np.random.default_rng(1).normal(0, 0.01, (ta.node_r.shape[0], 6))
    np.testing.assert_allclose(topt._all_residuals(ta, torch.from_numpy(d)).numpy(),
                               np.asarray(jopt._all_residuals(ja, jnp.asarray(d))), rtol=0, atol=TOL_JAC)
    Ji, Jj = topt._edge_jacobians(ta)
    jJi, jJj = jopt._edge_jacobians(ja)
    np.testing.assert_allclose(Ji.numpy(), np.asarray(jJi), rtol=0, atol=TOL_JAC)
    np.testing.assert_allclose(Jj.numpy(), np.asarray(jJj), rtol=0, atol=TOL_JAC)
    B, jB = topt._diag_blocks(ta, Ji, Jj).numpy(), np.asarray(jopt._diag_blocks(ja))
    np.testing.assert_allclose(B, jB, rtol=0, atol=TOL_JAC * np.abs(jB).max())
    eye = np.eye(6)
    B_damped = np.where(np.asarray(ja.free_mask)[:, None, None], jB + 1e-3 * np.diagonal(jB, axis1=1, axis2=2)[
        :, :, None] * eye + 1e-9 * eye, eye)
    H = topt._dense_hessian(ta, Ji, Jj, torch.from_numpy(B_damped)).numpy()
    jH = np.asarray(jopt._dense_hessian(ja, jnp.asarray(B_damped)))
    np.testing.assert_allclose(H, jH, rtol=0, atol=TOL_JAC * np.abs(jH).max())
    np.testing.assert_allclose(topt._spd_inverse_6x6(torch.from_numpy(B_damped)).numpy(),
                               np.asarray(jopt._spd_inverse_6x6(jnp.asarray(B_damped))), rtol=1e-9, atol=1e-12)


def test_incidence_table_lists_live_edge_sides_in_order(rng):
    jg, _ = culled_circle(rng, 20)
    g = port_graph(jg)
    table = topt.incidence_table(g.edge_i, g.edge_j, g.edge_mask, g._node_cap)
    E = len(g.edge_i)
    for n in range(g._node_cap):
        want = [row for e in range(E) if g.edge_mask[e]
                for row, side in ((e, g.edge_i), (E + e, g.edge_j)) if side[e] == n]
        assert [int(x) for x in table[n] if x != 2 * E] == want, n


def test_loop_closure_removes_drift(rng):
    n = 40
    jg, gt = closed_circle(rng, n)
    g = port_graph(jg)
    drift = np.linalg.norm(g.get_pose(n - 1)[0] - gt[n - 1][0])
    assert drift > 0.3
    res = g.optimize(max_iterations=15, pcg_iters=100)
    assert_same_result(res, jg.optimize(max_iterations=15, pcg_iters=100))
    assert_same_graph(g, jg, TOL)
    assert float(res.final_cost) < 0.01 * float(res.initial_cost)
    errs = [np.linalg.norm(g.get_pose(i)[0] - gt[i][0]) for i in range(n)]
    assert max(errs) < 0.5 * drift


@pytest.mark.parametrize("n,solver", [(20, "auto"), (16, "dense"), (20, "pcg")])
def test_gauge_node_stays_fixed(rng, n, solver):
    jg, _ = build_drifting_circle(rng, n)
    g = port_graph(jg)
    before = g.get_pose(0)
    res = g.optimize(max_iterations=5, solver=solver)
    assert_same_result(res, jg.optimize(max_iterations=5, solver=solver))
    after = g.get_pose(0)
    np.testing.assert_allclose(after[0], before[0], atol=1e-12)
    np.testing.assert_allclose(after[1], before[1], atol=1e-12)


def test_dense_equals_pcg(rng):
    """The dense Cholesky and matrix-free PCG paths compute the same LM
    step; each equals its JAX twin, and the two agree as in the JAX test."""
    n = 30
    jg, _ = closed_circle(rng, n)
    g, g2 = port_graph(jg), port_graph(jg)
    res_d = g.optimize(max_iterations=12, solver="dense")
    res_p = g2.optimize(max_iterations=12, pcg_iters=300, solver="pcg")
    jg2 = port_graph(jg)  # a copy of the JAX state before it is solved
    assert_same_result(res_d, jg.optimize(max_iterations=12, solver="dense"))
    jg_p = JPoseGraph(jg2._node_cap, jg2._edge_cap)
    for k in GRAPH_FIELDS:
        setattr(jg_p, k, getattr(jg2, k).copy())
    jg_p.slot_of, jg_p.n_nodes, jg_p.n_edges = dict(jg2.slot_of), jg2.n_nodes, jg2.n_edges
    assert_same_result(res_p, jg_p.optimize(max_iterations=12, pcg_iters=300, solver="pcg"))
    assert float(res_d.final_cost) <= 1.001 * float(res_p.final_cost) + 1e-9
    np.testing.assert_allclose(float(res_d.initial_cost), float(res_p.initial_cost), rtol=1e-9)
    for i in range(n):
        np.testing.assert_allclose(g.get_pose(i)[0], g2.get_pose(i)[0], atol=1e-3)


def test_perfect_odometry_zero_cost():
    gt = circle_poses(12)
    g = PoseGraph(node_capacity=16, edge_capacity=32, device="cpu")
    jg = JPoseGraph(node_capacity=16, edge_capacity=32)
    for graph in (g, jg):
        graph.add_node(0, *gt[0], fixed=True)
        for i in range(1, 12):
            graph.add_node(i, *gt[i])
            graph.add_edge(i - 1, i, *np_se3.relative(*gt[i - 1], *gt[i]), np.eye(6), kind=0)
    res = g.optimize(max_iterations=3)
    assert_same_result(res, jg.optimize(max_iterations=3))
    assert float(res.initial_cost) < 1e-12


def test_bench_circle_graph_matches_jax():
    """scripts/bench_posegraph.py's circle (the card phase's graph) at 32
    nodes, dense and PCG, built through both packages' PoseGraph."""
    spec = circle_pose_graph(32)
    for solver in ("dense", "pcg"):
        g = fill_pose_graph(PoseGraph(32, 64, device="cpu"), spec)
        jg = fill_pose_graph(JPoseGraph(32, 64), spec)
        res = g.optimize(max_iterations=8, pcg_iters=60, solver=solver)
        assert_same_result(res, jg.optimize(max_iterations=8, pcg_iters=60, solver=solver))
        assert float(res.final_cost) < float(res.initial_cost)


def test_solver_choice_and_refusal():
    assert topt.resolve_solver(341, "auto") == "dense" and topt.resolve_solver(342, "auto") == "pcg"
    with pytest.raises(ValueError, match="solver='pcg'"):
        topt.resolve_solver(1366, "dense")
    with pytest.raises(ValueError, match="unknown"):
        topt.resolve_solver(8, "qr")


# ----------------------------------------------------------------- culling


def test_remove_node_composes_chain():
    gt = circle_poses(8)
    g = PoseGraph(node_capacity=16, edge_capacity=32, device="cpu")
    jg = JPoseGraph(node_capacity=16, edge_capacity=32)
    for graph in (g, jg):
        graph.add_node(0, *gt[0], fixed=True)
        for i in range(1, 8):
            graph.add_node(i, *gt[i])
            graph.add_edge(i - 1, i, *np_se3.relative(*gt[i - 1], *gt[i]), np.eye(6), kind=0)
        graph.remove_node(3)
        graph.add_node(8, *gt[3])  # reuses the freed slot
    assert_same_graph(g, jg)
    assert not g.has_node(3) and g.slot_of[8] == 3
    live = np.nonzero(g.edge_mask[: g.n_edges])[0]
    s2, s4 = g.slot_of[2], g.slot_of[4]
    comp = [e for e in live if {int(g.edge_i[e]), int(g.edge_j[e])} == {s2, s4}]
    assert len(comp) == 1
    r_true, q_true = np_se3.relative(*gt[2], *gt[4])
    np.testing.assert_allclose(g.meas_r[comp[0]], r_true, atol=1e-10)


def test_optimize_after_cull_and_growth(rng):
    jg, _ = culled_circle(rng, 20)
    g = port_graph(jg)
    res = g.optimize(max_iterations=5)
    assert_same_result(res, jg.optimize(max_iterations=5))
    assert np.isfinite(float(res.final_cost))
    # past both capacities: the arrays double as in JAX
    for graph in (g, jg):
        for i in range(100, 160):
            graph.add_node(i, np.full(3, 0.1 * i), np.array([0.0, 0, 0, 1.0]))
            graph.add_edge(i - 1 if i > 100 else 19, i, np.full(3, 0.1), np.array([0.0, 0, 0, 1.0]), np.eye(6))
    assert g._node_cap == jg._node_cap == 128 and g._edge_cap == jg._edge_cap
    assert_same_graph(g, jg, TOL)


# ------------------------------------------------------- place recognition


def _databases(frames, kp, words=False):
    kw = dict(desc_words=16, desc_dtype=np.uint32) if words else {}
    return (KeyframeDatabase(frame_capacity=frames, kp_capacity=kp, device="cpu", **kw),
            JDatabase(frame_capacity=frames, kp_capacity=kp, **kw))


def _same_query(db, jdb, q, mask, exclude):
    got, want = db.query(q, mask, exclude_ids=exclude), jdb.query(q, mask, exclude_ids=exclude)
    assert got[0] == want[0] and got[1] == want[1]
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    return got


def test_retrieves_matching_keyframe(rng):
    db, jdb = _databases(32, 64)
    K = 50
    descs = [random_descriptors(rng, K) for _ in range(12)]
    geo = (np.zeros((K, 3)), np.zeros((K, 3)), np.ones(K, bool))
    for d in (db, jdb):
        for i, desc in enumerate(descs):
            d.insert(i, desc, np.ones(K, bool), *geo)
    q = descs[4] ^ (rng.integers(0, 256, descs[4].shape, dtype=np.uint8) & 0x01)
    best, score, _ = _same_query(db, jdb, q, np.ones(K, bool), set())
    assert best == 4 and score > 0.9


def test_exclusion_and_no_false_positive(rng):
    db, jdb = _databases(16, 64)
    K = 40
    geo = (np.zeros((K, 3)), np.zeros((K, 3)), np.ones(K, bool))
    descs = [random_descriptors(rng, K) for _ in range(6)]
    for d in (db, jdb):
        for i, desc in enumerate(descs):
            d.insert(i, desc, np.ones(K, bool), *geo)
    _, score, _ = _same_query(db, jdb, descs[2], np.ones(K, bool), {2})
    assert score < 0.1


def test_ring_eviction(rng):
    db, jdb = _databases(4, 16)
    K = 10
    geo = (np.zeros((K, 3)), np.zeros((K, 3)), np.ones(K, bool))
    for i in range(6):
        desc = random_descriptors(rng, K)
        for d in (db, jdb):
            d.insert(i, desc, np.ones(K, bool), *geo)
    db.remove(3)
    jdb.remove(3)
    assert len(db) == len(jdb) == 3 and db.slot_of == jdb.slot_of and db._order == jdb._order
    np.testing.assert_array_equal(db.desc, jdb.desc)
    np.testing.assert_array_equal(db.device_desc.numpy(), as_words(jdb.desc))
    assert 0 not in db.slot_of and 1 not in db.slot_of and 5 in db.slot_of


def test_word_descriptors_and_partial_masks_score_as_jax(rng):
    """The pipeline's (K, 16) uint32 words, with masked query and database
    entries (the JAX package's 512 for masked database entries against the
    kernel's clamped MAX_DIST) and frames of fewer keypoints than the
    capacity."""
    db, jdb = _databases(16, 48, words=True)
    base = rng.integers(0, 2**32, (40, 16), dtype=np.uint32)
    for i in range(10):
        k = 30 + i
        desc = base[:k].copy()
        desc[:, i % 16] ^= rng.integers(0, 2**32, k, dtype=np.uint32) & np.uint32(0x0F0F0F0F)
        mask = rng.uniform(size=k) < 0.7
        for d in (db, jdb):
            d.insert(i, desc, mask, np.zeros((k, 3)), np.zeros((k, 3)), np.ones(k, bool))
    q_mask = rng.uniform(size=40) < 0.8
    for threshold in (40, 60, 90):
        for exclude in (set(), {0, 9}, set(range(10))):
            got, want = (d.query(base, q_mask, exclude, vote_threshold=threshold) for d in (db, jdb))
            assert got[:2] == want[:2]
            np.testing.assert_array_equal(got[2], np.asarray(want[2]))


# ------------------------------------------------------------ verification


def _verify_both(key, desc_c, pts_W, desc_q, brg_q, K):
    jver = jlc.verify_loop_candidate(key, jnp.asarray(desc_c), jnp.ones(K, bool), jnp.asarray(pts_W),
                                     jnp.asarray(desc_q), jnp.ones(K, bool), jnp.asarray(brg_q), focal=460.0,
                                     min_inliers=20)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (tlc.N_HYP, 3))))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    ver = tlc.verify_loop_candidate(u, t(as_words(desc_c)), torch.ones(K, dtype=torch.bool), t(pts_W),
                                    t(as_words(desc_q)), torch.ones(K, dtype=torch.bool), t(brg_q), focal=460.0,
                                    min_inliers=20)
    for k in ("success", "num_inliers", "num_matches"):
        assert int(getattr(ver, k)) == int(getattr(jver, k)), k
    np.testing.assert_allclose(ver.R_CW.numpy(), np.asarray(jver.R_CW), rtol=0, atol=TOL)
    np.testing.assert_allclose(ver.t_C.numpy(), np.asarray(jver.t_C), rtol=0, atol=TOL)
    return ver, jver


def test_verification_recovers_relative_pose(rng):
    pts_W = make_world(rng)
    K = len(pts_W)
    desc = random_descriptors(rng, K)
    cand = (np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]))
    dq = np.array([0.02, -0.01, 0.03, 1.0])
    query = (np.array([0.4, -0.3, 0.2]), dq / np.linalg.norm(dq))
    ver, jver = _verify_both(jax.random.PRNGKey(0), desc, pts_W, desc, bearings_of(pts_W, *query), K)
    assert bool(ver.success) and int(ver.num_inliers) >= 0.8 * K
    T_SC = (np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]))
    rel = tlc.relative_pose_from_verification(ver, cand, T_SC)
    jrel = jlc.relative_pose_from_verification(jver, cand, T_SC)
    for a, b in zip(rel, jrel):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    r_true, q_true = np_se3.relative(*cand, *query)
    np.testing.assert_allclose(rel[0], r_true, atol=0.02)
    assert min(np.linalg.norm(rel[1] - q_true), np.linalg.norm(rel[1] + q_true)) < 0.02
    np.testing.assert_array_equal(tlc.loop_edge_sqrt_info(int(ver.num_inliers)),
                                  jlc.loop_edge_sqrt_info(int(jver.num_inliers)))


def test_verification_rejects_random_garbage(rng):
    K = 60
    desc_c, pts_W, desc_q = random_descriptors(rng, K), make_world(rng), random_descriptors(rng, K)
    brg = bearings_of(make_world(rng), np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]))
    ver, _ = _verify_both(jax.random.PRNGKey(1), desc_c, pts_W, desc_q, brg, K)
    assert not bool(ver.success)
    assert tlc.relative_pose_from_verification(ver, (np.zeros(3), np.array([0.0, 0, 0, 1])),
                                               (np.zeros(3), np.array([0.0, 0, 0, 1]))) is None


# ----------------------------------------------------------------- manager


class JaxManagerDraws:
    """The port manager's _draw giving the uniforms the JAX manager's keys
    give: PRNGKey(seed), one split a verification."""

    def __init__(self, seed):
        self.key, self.calls = jax.random.PRNGKey(seed), 0

    def __call__(self, shape):
        self.key, sub = jax.random.split(self.key)
        self.calls += 1
        return torch.from_numpy(np.array(jax.random.uniform(sub, shape)))


def managers(**cfg):
    jm = JManager(JConfig(**cfg))
    m = PoseGraphManager(PoseGraphConfig(**cfg), device="cpu")
    m._draw = JaxManagerDraws(m.cfg.seed)
    return m, jm


def same_event(ev, jev) -> bool:
    return (ev is None) == (jev is None) and (ev is None or dataclasses.asdict(ev) == dataclasses.asdict(jev))


def assert_same_manager(m, jm, what=""):
    assert [dataclasses.asdict(e) for e in m.loop_events] == [dataclasses.asdict(e) for e in jm.loop_events], what
    assert_same_graph(m.graph, jm.graph, TOL, what)
    np.testing.assert_allclose(m.corr_r, jm.corr_r, rtol=0, atol=TOL, err_msg=what)
    np.testing.assert_allclose(m.corr_q, jm.corr_q, rtol=0, atol=TOL, err_msg=what)
    assert m.insert_order == jm.insert_order and m.db.slot_of == jm.db.slot_of, what


def square_loop(rng, warm_up=False):
    """test_posegraph.py::TestManagerEndToEnd's run through both managers,
    compared after every keyframe; with `warm_up`, the port manager's
    warm_up runs first."""
    m, jm = managers(min_gap=8, score_threshold=0.2, min_inliers=15, node_capacity=64, edge_capacity=128,
                     db_kp_capacity=64)
    if warm_up:
        state = m._gen.get_state()
        m.warm_up()
        assert torch.equal(m._gen.get_state(), state)
    kfs = square_loop_keyframes(rng, 60)
    for i, kf in enumerate(kfs):
        args = dict(kf_id=i, timestamp_ns=i * 10**8, r_WS_vio=kf["vio"][0], q_WS_vio=kf["vio"][1],
                    descriptors=kf["descriptors"], desc_mask=np.ones(60, bool), bearings_C=kf["bearings"],
                    landmarks_W=kf["landmarks_W"], lm_valid=np.ones(60, bool))
        ev, jev = m.add_keyframe(**args), jm.add_keyframe(**args)
        assert same_event(ev, jev), i
        assert_same_manager(m, jm, f"keyframe {i}")
    return m, jm, kfs


def test_manager_loop_closure_reduces_drift(rng):
    m, jm, kfs = square_loop(rng)
    accepted = [e for e in m.loop_events if e.accepted]
    assert len(accepted) == 1 and accepted[0].candidate_id == 0 and m._draw.calls == len(m.loop_events)
    gt, vio = kfs[-1]["gt"], kfs[-1]["vio"]
    vio_err = np.linalg.norm(vio[0] - gt[0])
    r_corr, _ = m.graph.get_pose(len(kfs) - 1)
    assert np.linalg.norm(r_corr - gt[0]) < 0.3 * vio_err
    r_live, _ = m.apply_correction(*vio)
    assert np.linalg.norm(r_live - gt[0]) < 0.3 * vio_err
    traj, jtraj = m.trajectory(), jm.trajectory()
    assert [t[:2] for t in traj] == [t[:2] for t in jtraj]
    for a, b in zip(traj, jtraj):
        np.testing.assert_allclose(np.concatenate(a[2:]), np.concatenate(b[2:]), rtol=0, atol=TOL)


def test_warm_up_leaves_the_manager_as_it_was(rng):
    """warm_up (a verification and a solve on scratch data, which
    ThreadedVio runs on a CUDA card) draws nothing from the manager's RANSAC
    generator and leaves its database, graph and events as they were: the
    square loop after it still gives the JAX manager's every event, graph
    and correction."""
    m, _, _ = square_loop(rng, warm_up=True)
    assert [e.accepted for e in m.loop_events].count(True) == 1 and m._draw.calls == len(m.loop_events)


def test_manager_state_round_trips_through_convert(rng):
    """posegraph_to_numpy of a JAX manager after the square loop, loaded into
    a port manager, reads back the same; both then take one more keyframe
    (the revisit again, verified with the same draws) and stay equal."""
    _, jm, kfs = square_loop(rng)
    values = convert.posegraph_to_numpy(jm)
    m = convert.posegraph_from_numpy(values, device="cpu")
    again = convert.posegraph_to_numpy(m)
    from chip_smoke import same_values
    assert same_values(again, values)
    np.testing.assert_array_equal(m.db.device_desc.numpy(), as_words(jm.db.desc))
    m._draw = JaxManagerDraws(m.cfg.seed)
    m._draw.key = jm._key
    kf = kfs[0]
    args = dict(kf_id=99, timestamp_ns=99 * 10**8, r_WS_vio=kf["vio"][0], q_WS_vio=kf["vio"][1],
                descriptors=kf["descriptors"], desc_mask=np.ones(60, bool), bearings_C=kf["bearings"],
                landmarks_W=kf["landmarks_W"], lm_valid=np.ones(60, bool))
    assert same_event(m.add_keyframe(**args), jm.add_keyframe(**args))
    assert_same_manager(m, jm, "after the round trip")


def test_cull_redundant_stationary(rng):
    m, jm = managers(node_capacity=64, edge_capacity=128, db_kp_capacity=64)
    K = 20
    geo_b = np.zeros((K, 3))
    for i in range(6):
        args = (i, i * 10**8, np.array([0.001 * i, 0.0, 0.0]), np.array([0.0, 0, 0, 1.0]),
                random_descriptors(rng, K), np.ones(K, bool), geo_b, geo_b, np.zeros(K, bool))
        assert same_event(m.add_keyframe(*args), jm.add_keyframe(*args))
    culled = m.cull_redundant()
    assert culled == jm.cull_redundant() and len(culled) >= 3
    assert_same_manager(m, jm)
    assert m.graph.has_node(0) and m.graph.has_node(5)
    res = m.graph.optimize(max_iterations=3)
    assert_same_result(res, jm.graph.optimize(max_iterations=3))
    assert np.isfinite(float(res.final_cost))
