"""SE(3) pose-graph solver: Levenberg-Marquardt with a dense Cholesky or a
block-Jacobi preconditioned CG step (port of okvis_tpu.posegraph.optimize).

The graph is a fixed-capacity SoA: node poses (N, 7) and edges (E,) of
(i, j, measured T_ij, 6x6 sqrt-information, mask). An edge measures
``T_ij = T_WS_i^-1 * T_WS_j``; its residual is the minimal-coordinates
difference ``minus(T_ij_pred, T_ij_meas)`` weighted by the sqrt-information.
Gauge freedom is removed by a per-node ``free`` mask: fixed nodes get zero
update and an identity preconditioner block.

Departures in form, not in result, from the JAX package:

- The per-edge 6x6 Jacobian blocks are analytic (``_edge_jacobians``), held
  to the JAX package's ``vmap(jacfwd)`` by a test, as cameras/distortion.py
  does for the same reason: one batched expression instead of autodiff.
  The Gauss-Newton matvec ``v -> J^T J v`` (``jax.linearize`` + ``jax.vjp``
  in JAX) is built from the same blocks.
- Every sum over the edges incident to a node (J^T r, J^T J v, the diagonal
  blocks) gathers from a per-node table of incident edge sides
  (``PoseGraphArrays.incident``, built on the host with the graph) and sums
  in its fixed order; the dense Hessian is one matrix product of a
  never-repeating block Jacobian. No scatter-add, so reruns on the card are
  bitwise equal.
- Both ``lax.while_loop``s (LM and PCG) run their full count as Python loops
  whose carry is frozen by ``torch.where`` once done, as solver/optimize.py
  ports ``lax.scan``: no host read, the same poses and the same iteration
  count.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kinematics import so3
from ..kinematics.se3 import SE3, compose, inverse, minus, oplus
from ..linalg import cholesky

DENSE_AUTO_DIMS = 2048  # "auto" solves densely up to this many unknowns


class PoseGraphArrays(NamedTuple):
    """Device-side padded pose graph."""

    node_r: torch.Tensor  # (N, 3)
    node_q: torch.Tensor  # (N, 4) xyzw
    node_mask: torch.Tensor  # (N,) bool: slot occupied
    free_mask: torch.Tensor  # (N,) bool: node is optimized (gauge: fix >= 1)
    edge_i: torch.Tensor  # (E,) int64 node slot of frame i
    edge_j: torch.Tensor  # (E,) int64 node slot of frame j
    meas_r: torch.Tensor  # (E, 3) measured T_ij translation
    meas_q: torch.Tensor  # (E, 4) measured T_ij quaternion
    sqrt_info: torch.Tensor  # (E, 6, 6) sqrt information
    edge_mask: torch.Tensor  # (E,) bool
    incident: torch.Tensor  # (N, D) int64 rows of the (2E + 1) edge sides; see incidence_table


class PgoResult(NamedTuple):
    node_r: torch.Tensor
    node_q: torch.Tensor
    final_cost: torch.Tensor
    initial_cost: torch.Tensor
    iterations: torch.Tensor


def incidence_table(edge_i: np.ndarray, edge_j: np.ndarray, edge_mask: np.ndarray, n_nodes: int) -> np.ndarray:
    """(N, D) int64: per node, the rows of its live incident edge sides in
    edge order (row e: edge e's side i, row E + e: its side j), padded with
    the zero row 2E to the largest degree D (at least 1)."""
    E = len(edge_i)
    rows = [[] for _ in range(n_nodes)]
    for e in np.nonzero(edge_mask)[0]:
        rows[int(edge_i[e])].append(int(e))
        rows[int(edge_j[e])].append(E + int(e))
    D = max([1] + [len(r) for r in rows])
    table = np.full((n_nodes, D), 2 * E, np.int64)
    for n, r in enumerate(rows):
        table[n, : len(r)] = r
    return table


def _node_sum(g: PoseGraphArrays, side_i: torch.Tensor, side_j: torch.Tensor) -> torch.Tensor:
    """Per-node sums of per-edge terms (E, ...) at the edges' i and j nodes,
    in the fixed order of g.incident: (N, ...)."""
    rows = torch.cat([side_i, side_j, torch.zeros_like(side_i[:1])])
    return rows[g.incident].sum(dim=1)


def _edge_residual(T_i: SE3, T_j: SE3, T_meas: SE3, sqrt_info: torch.Tensor) -> torch.Tensor:
    """Weighted minimal-coordinates error of a batch of edges, (..., 6)."""
    e = minus(compose(inverse(T_i), T_j), T_meas)
    return torch.einsum("...ij,...j->...i", sqrt_info, e)


def _all_residuals(g: PoseGraphArrays, deltas: torch.Tensor) -> torch.Tensor:
    """(E, 6) residuals after applying deltas (N, 6) to the nodes."""
    d = deltas * g.free_mask[:, None].to(deltas.dtype)
    nodes = oplus(SE3(g.node_r, g.node_q), d)
    T_i = SE3(nodes.r[g.edge_i], nodes.q[g.edge_i])
    T_j = SE3(nodes.r[g.edge_j], nodes.q[g.edge_j])
    r = _edge_residual(T_i, T_j, SE3(g.meas_r, g.meas_q), g.sqrt_info)
    return r * g.edge_mask[:, None].to(r.dtype)


def _edge_jacobians(g: PoseGraphArrays) -> tuple:
    """Per-edge 6x6 residual Jacobian blocks (Ji, Jj) at zero update,
    edge-masked, analytic. With C_i = C(q_i), v = r_j - r_i and
    M = [quat_left(q_meas q_j^-1) quat_right(q_i)]_{3x3}:
    Ji = L [[C_i^T, -C_i^T [v]x], [0, M]], Jj = L [[-C_i^T, 0], [0, -M]]."""
    r_i, q_i = g.node_r[g.edge_i], g.node_q[g.edge_i]
    r_j, q_j = g.node_r[g.edge_j], g.node_q[g.edge_j]
    CiT = so3.quat_to_matrix(q_i).transpose(-1, -2)
    A = so3.quat_multiply(g.meas_q, so3.quat_conjugate(q_j))
    M = (so3.quat_left(A) @ so3.quat_right(q_i))[..., :3, :3]
    zero = torch.zeros_like(CiT)
    Ji = torch.cat([torch.cat([CiT, -CiT @ so3.cross_matrix(r_j - r_i)], dim=-1),
                    torch.cat([zero, M], dim=-1)], dim=-2)
    Jj = torch.cat([torch.cat([-CiT, zero], dim=-1), torch.cat([zero, -M], dim=-1)], dim=-2)
    w = g.edge_mask[:, None, None].to(Ji.dtype)
    return (g.sqrt_info @ Ji) * w, (g.sqrt_info @ Jj) * w


def _diag_blocks(g: PoseGraphArrays, Ji: torch.Tensor, Jj: torch.Tensor) -> torch.Tensor:
    """Per-node 6x6 diagonal Hessian blocks, (N, 6, 6)."""
    Hii = torch.einsum("eki,ekj->eij", Ji, Ji)
    Hjj = torch.einsum("eki,ekj->eij", Jj, Jj)
    return _node_sum(g, Hii, Hjj)


def _dense_hessian(g: PoseGraphArrays, Ji: torch.Tensor, Jj: torch.Tensor, B_damped: torch.Tensor) -> torch.Tensor:
    """The damped Gauss-Newton Hessian as one dense (6N, 6N): J^T J of the
    free-masked block Jacobian (each edge's blocks in their own rows, so
    nothing is summed twice into one place), with the block diagonal replaced
    by ``B_damped`` (identity at fixed nodes)."""
    N = g.node_r.shape[0]
    E = g.edge_i.shape[0]
    nodes = torch.arange(N, device=g.edge_i.device)
    free = g.free_mask.to(Ji.dtype)
    at_i = (g.edge_i[:, None] == nodes).to(Ji.dtype) * free  # (E, N)
    at_j = (g.edge_j[:, None] == nodes).to(Ji.dtype) * free
    J = (torch.einsum("en,eab->eanb", at_i, Ji) + torch.einsum("en,eab->eanb", at_j, Jj)).reshape(6 * E, 6 * N)
    H = (J.T @ J).reshape(N, 6, N, 6)
    eye = torch.eye(N, dtype=Ji.dtype, device=Ji.device)
    diag = torch.einsum("nm,nab->namb", eye, B_damped)
    H = torch.where(eye.to(torch.bool)[:, None, :, None], diag, H)
    return H.reshape(6 * N, 6 * N)


def _spd_inverse_6x6(A: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverse of (..., 6, 6) blocks through their Cholesky
    factor (the JAX package unrolls the same factorization for the TPU)."""
    return torch.cholesky_inverse(cholesky(A))


def _pcg(matvec, b, Minv_blocks, free, iters: int, tol: float):
    """Block-Jacobi preconditioned CG on the (N, 6) system: `iters` rounds,
    frozen once |r| <= tol |b|."""

    def apply_precond(r):
        return torch.einsum("nij,nj->ni", Minv_blocks, r) * free[:, None]

    tiny = torch.full((), 1e-30, dtype=b.dtype, device=b.device)
    x = torch.zeros_like(b)
    r = b
    p = apply_precond(r)
    rz = torch.sum(r * p)
    stop = tol * tol * torch.maximum(torch.sum(b * b), tiny)
    for _ in range(iters):
        active = torch.sum(r * r) > stop
        Ap = matvec(p)
        denom = torch.sum(p * Ap)
        alpha = rz / torch.where(denom.abs() < 1e-30, tiny, denom)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z = apply_precond(r_n)
        rz_n = torch.sum(r_n * z)
        beta = rz_n / torch.where(rz.abs() < 1e-30, tiny, rz)
        p_n = z + beta * p
        x, r, p, rz = (torch.where(active, new, old) for new, old in ((x_n, x), (r_n, r), (p_n, p), (rz_n, rz)))
    return x


def resolve_solver(n_nodes: int, solver: str) -> str:
    """"auto" is "dense" when 6N <= DENSE_AUTO_DIMS, else "pcg"; an explicit
    "dense" beyond 4x that is refused."""
    if solver == "auto":
        return "dense" if n_nodes * 6 <= DENSE_AUTO_DIMS else "pcg"
    if solver == "dense" and n_nodes * 6 > 4 * DENSE_AUTO_DIMS:
        raise ValueError(
            f"solver='dense' at {n_nodes} nodes would materialize a {n_nodes * 6}^2 Hessian "
            "per LM iteration; use solver='pcg' or 'auto'")
    if solver not in ("dense", "pcg"):
        raise ValueError(f"unknown pose-graph solver {solver!r}")
    return solver


def optimize_pose_graph(
    g: PoseGraphArrays,
    max_iterations: int = 10,
    pcg_iters: int = 50,
    lambda0: float = 1e-4,
    pcg_tol: float = 1e-6,
    cost_tol: float = 1e-9,
    solver: str = "auto",
) -> PgoResult:
    """Levenberg-Marquardt over the pose graph, `max_iterations` rounds with
    the carry frozen once converged.

    ``solver``: "pcg" (block-Jacobi PCG, matrix-free), "dense" (the dense
    Hessian and Cholesky: the exact LM step) or "auto" (dense when 6N <=
    2048, else pcg). ``pcg_iters`` / ``pcg_tol`` apply only when the
    resolved solver is "pcg". "dense" beyond 4 x 2048 unknowns is refused.
    """
    solver = resolve_solver(g.node_r.shape[0], solver)
    dtype, dev = g.node_r.dtype, g.node_r.device
    free = g.free_mask.to(dtype)
    eye = torch.eye(6, dtype=dtype, device=dev)

    def cost_of(rr):
        return 0.5 * torch.sum(rr * rr)

    c_init = cost_of(_all_residuals(g, g.node_r.new_zeros(g.node_r.shape[0], 6)))
    node_r, node_q = g.node_r, g.node_q
    lam = torch.full((), lambda0, dtype=dtype, device=dev)
    cost = c_init
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(max_iterations):
        g_now = g._replace(node_r=node_r, node_q=node_q)
        Ji, Jj = _edge_jacobians(g_now)
        r0 = _all_residuals(g_now, node_r.new_zeros(node_r.shape[0], 6))
        grad = _node_sum(g, torch.einsum("eki,ek->ei", Ji, r0), torch.einsum("eki,ek->ei", Jj, r0)) * free[:, None]
        B = _diag_blocks(g, Ji, Jj)
        diagB = torch.diagonal(B, dim1=1, dim2=2)  # (N, 6)
        damp = lam * 1e-8 + 1e-12

        # keep this operator's damping identical to B_damped below: "dense"
        # and "pcg" solve the same damped system
        def matvec(v):
            vf = v * free[:, None]
            u = torch.einsum("eij,ej->ei", Ji, vf[g.edge_i]) + torch.einsum("eij,ej->ei", Jj, vf[g.edge_j])
            jtjv = _node_sum(g, torch.einsum("eki,ek->ei", Ji, u), torch.einsum("eki,ek->ei", Jj, u)) * free[:, None]
            return (jtjv + lam * diagB * v + damp * v) * free[:, None]

        B_damped = B + lam * diagB[:, :, None] * eye + damp * eye
        B_damped = torch.where(g.free_mask[:, None, None], B_damped, eye)  # fixed nodes: identity
        b = -grad * free[:, None]
        if solver == "dense":
            L = cholesky(_dense_hessian(g, Ji, Jj, B_damped))
            delta = torch.cholesky_solve(b.reshape(-1, 1), L).reshape(b.shape) * free[:, None]
        else:
            delta = _pcg(matvec, b, _spd_inverse_6x6(B_damped), free, pcg_iters, pcg_tol)
        cost_new = cost_of(_all_residuals(g_now, delta))
        run = ~done
        accept = run & (cost_new < cost)
        nodes_new = oplus(SE3(node_r, node_q), delta * free[:, None])
        node_r = torch.where(accept, nodes_new.r, node_r)
        node_q = torch.where(accept, nodes_new.q, node_q)
        cost_next = torch.where(accept, cost_new, cost)
        lam_next = torch.where(accept, torch.clamp(lam * 0.5, min=1e-10), torch.clamp(lam * 4.0, max=1e8))
        rel_drop = (cost - cost_next) / torch.clamp(cost, min=1e-30)
        done = done | (accept & (rel_drop < cost_tol))
        lam = torch.where(run, lam_next, lam)
        cost = cost_next
        iters = iters + run.to(torch.int32)
    return PgoResult(node_r=node_r, node_q=node_q, final_cost=cost, initial_cost=c_init, iterations=iters)
