"""The port's keyframe retrieval (KeyframeDatabase.query) and pose-graph
solve (PoseGraph.optimize) against the benchmark's plain reference
(vio_bench/reference/posegraph.py: XOR, popcount and votes in NumPy; a
float64 Levenberg-Marquardt with an autodiff Jacobian in plain torch), on
seeded random data at a small size on the CPU. Imports no JAX.

Tolerances: the retrieval's scores and best slot exactly (a score is a
ratio of two counts rounded once to float32); the dense solve's poses to
1e-9 m and 1e-9 rad, the limits `correct` holds the benchmark's solves to
(both sides take the exact LM step in float64: they agree to rounding,
~1e-15). The PCG solve (block-Jacobi CG, frozen once the residual is below
1e-6 of the right-hand side) takes an inexact step in each LM iteration;
PCG_TOL (below) says why it is held to the same limit.
"""

import numpy as np
import pytest
import torch

from okvis_tpu_torch.kinematics import np_se3
from okvis_tpu_torch.posegraph.graph import PoseGraph
from okvis_tpu_torch.posegraph.place_recognition import KeyframeDatabase
from vio_bench.reference import posegraph as ref

torch.set_num_threads(2)
SOLVE_TOL = 1e-9  # float64 on both sides: rounding only
# PCG's step is inexact (CG frozen once |r| <= 1e-6 |b|), but each LM
# iteration linearises again where the last step left the poses, so the
# error of one step is corrected by the next and both solves end at the
# same minimum; the last accepted steps are millimetres and less, so what
# is left of their error is far below the benchmark's 1e-9 [4.9e-13 m,
# 3.9e-13 rad here]. The same limit as the dense solve's.
PCG_TOL = 1e-9
GRAPH_ARRAYS = ("node_r", "node_q", "node_mask", "fixed", "edge_i", "edge_j", "meas_r", "meas_q", "sqrt_info",
                "edge_mask")


def _flipped(desc: np.ndarray, n_bits: np.ndarray, rng) -> np.ndarray:
    """Each 512-bit row of `desc` with n_bits[k] bits flipped."""
    bits = np.unpackbits(desc.view(np.uint8), axis=1)
    for k, n in enumerate(n_bits):
        bits[k, rng.choice(512, int(n), replace=False)] ^= 1
    return np.packbits(bits, axis=1).view(np.uint32)


@pytest.fixture(scope="module")
def database():
    """A 12-slot database of 64 keypoints holding 8 keyframes (ids 10-17)
    of random descriptors, about a fifth of each keyframe's masked out,
    and a query of 64 descriptors: 32 from keyframe 12 and 20 from
    keyframe 15, each with 10-70 of its bits flipped (distances on both
    sides of the vote threshold of 60), and 12 random, a tenth masked out."""
    rng = np.random.default_rng(20)
    K = 64
    db = KeyframeDatabase(12, K, desc_words=16, desc_dtype=np.uint32, device="cpu")
    kept = {}
    for kf in range(10, 18):
        desc = rng.integers(0, 2**32, (K, 16), dtype=np.uint32)
        db.insert(kf, desc, rng.random(K) < 0.8, np.tile([0.0, 0.0, 1.0], (K, 1)), np.zeros((K, 3)),
                  np.zeros(K, bool))
        kept[kf] = desc
    src = np.concatenate([kept[12][:32], kept[15][32:52], rng.integers(0, 2**32, (12, 16), dtype=np.uint32)])
    desc_q = _flipped(src, rng.integers(10, 70, K), rng)
    return db, desc_q, rng.random(K) < 0.9


@pytest.mark.parametrize("exclude, best", [(set(), 12), ({12}, 15), ({12, 15, 99}, None)])
def test_retrieval_scores_and_best_slot_equal_the_reference(database, exclude, best):
    db, desc_q, mask_q = database
    kf_id, score, scores = db.query(desc_q, mask_q, exclude, vote_threshold=60)
    slots = np.nonzero(db.occupied)[0]
    allowed = db.occupied.copy()
    allowed[[db.slot_of[i] for i in exclude if i in db.slot_of]] = False
    want, want_best = ref.scores(desc_q, mask_q, db.desc[slots], db.mask[slots], slots, allowed, db.frame_cap, 60)
    assert scores.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(scores, want)
    assert db.slot_of[kf_id] == want_best and score == want[want_best]
    assert (scores[~db.occupied] == -1).all() and len(slots) == 8  # four empty slots
    if best is not None:
        assert kf_id == best and score > 0.1  # its 20 or 32 query rows, less the masked ones
    else:  # random descriptors lie ~256 bits apart: every score left is 0, the first allowed slot wins
        assert score == 0.0 and want_best == int(np.nonzero(allowed)[0][0])


def _circle_graph(seed: int) -> tuple:
    """12 keyframes on a circle of 3 m, each turned to face along it, the
    first fixed (the gauge); odometry edges carrying the true relative
    pose with 2 cm and 0.5 degree of noise, two loop edges (11 -> 0 and
    8 -> 2), and the nodes started from the noisy odometry chained from
    node 0. Returns the graph and the true poses."""
    rng = np.random.default_rng(seed)
    n = 12
    ang = 2 * np.pi * np.arange(n) / n
    true_r = np.stack([3 * np.cos(ang), 3 * np.sin(ang), 0.2 * np.sin(2 * ang)], 1)
    true_q = np.stack([np.array([0.0, 0.0, np.sin((a + np.pi / 2) / 2), np.cos((a + np.pi / 2) / 2)]) for a in ang])
    g = PoseGraph(16, 32, device="cpu")

    def noisy(i, j):
        t, q = np_se3.relative(true_r[i], true_q[i], true_r[j], true_q[j])
        dq = np_se3.quat_normalize(np.append(rng.normal(size=3) * np.radians(0.5) / 2, 1.0))
        return t + rng.normal(size=3) * 0.02, np_se3.quat_multiply(q, dq)

    r, q = true_r[0], true_q[0]
    odo = [noisy(k - 1, k) for k in range(1, n)]
    g.add_node(0, r, q, fixed=True)
    for k, (t, dq) in enumerate(odo, start=1):
        r, q = np_se3.compose(r, q, t, dq)
        g.add_node(k, r, q)
    L_odo = np.diag([1 / 0.02] * 3 + [1 / np.radians(0.5)] * 3)
    for k, (t, dq) in enumerate(odo, start=1):
        g.add_edge(k - 1, k, t, dq, L_odo, kind=0)
    for i, j in ((0, 11), (2, 8)):
        t, dq = noisy(i, j)
        g.add_edge(i, j, t, dq, L_odo * 2, kind=1)
    return g, true_r, true_q


@pytest.mark.parametrize("solver, tol", [("dense", SOLVE_TOL), ("pcg", PCG_TOL)])
def test_solve_equals_the_reference(solver, tol):
    g, true_r, true_q = _circle_graph(7)
    before = {name: getattr(g, name).copy() for name in GRAPH_ARRAYS}
    drift, _ = ref.pose_differences(g.node_r[:12], g.node_q[:12], true_r, true_q)
    res = g.optimize(max_iterations=10, pcg_iters=60, solver=solver)
    want_r, want_q = ref.solve(**before, max_iterations=10)
    m, rad = ref.pose_differences(g.node_r, g.node_q, want_r, want_q)
    assert m < tol and rad < tol, (m, rad)
    # the solve did real work: the loop edges pulled the chained odometry's drift in
    assert float(res.final_cost) < 1e-2 * float(res.initial_cost)
    after, _ = ref.pose_differences(g.node_r[:12], g.node_q[:12], true_r, true_q)
    assert after < 0.5 * drift
    assert np.array_equal(g.node_r[0], before["node_r"][0]) and np.array_equal(g.node_q[0], before["node_q"][0])
    assert np.array_equal(g.node_r[12:], before["node_r"][12:])  # unoccupied slots as they were
