"""The pose-graph layer's keyframe retrieval and SE(3) solve, in plain NumPy
and torch on the CPU.

Retrieval (`database_votes`, `scores`): per occupied database keyframe, XOR
and popcount of the query's 512-bit descriptors against each of the
keyframe's valid ones, the minimum over the keyframe, a vote for each valid
query descriptor whose minimum is below the vote threshold, and the score
votes / valid query descriptors in float32 (a keyframe that is not allowed
scores -1); the best slot is the first of the highest score. Only the
occupied slots are computed, in chunks of slots spread over the cores.

Solve (`solve`): Levenberg-Marquardt over SE(3) poses (r, q xyzw Hamilton,
p_W = C(q) p_S + r). An edge (i, j) measures T_ij = T_i^-1 T_j; its
residual is L (measured minus predicted) in minimal coordinates,
[r_meas - r_pred; 2 vec(q_meas q_pred^-1)]. A node moves by r += dr,
q = exp(dalpha) q; fixed nodes never move (the gauge). Each iteration
linearises at the current poses (the Jacobian by reverse-mode autodiff of
the residual), forms J^T J with the Marquardt damping lambda diag(J^T J)
+ (1e-8 lambda + 1e-12) on every free node's block, takes the dense
Cholesky step, accepts it only if the cost falls (lambda halved, floor
1e-10) and otherwise rejects it (lambda times 4, ceiling 1e8), and stops
once an accepted step lowers the cost by less than 1e-9 of it; lambda
starts at 1e-4. Departures from the program's description
(okvis_tpu_torch/posegraph/optimize.py): the Jacobian comes from autodiff,
not analytic blocks; unoccupied slots and masked edges are dropped, not
carried as identity rows; the step is always the dense one (the program
takes a PCG step past 2048 unknowns).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

BITS = 512
SLOTS_PER_CHUNK = 4


def database_votes(desc_q: np.ndarray, mask_q: np.ndarray, db_desc: np.ndarray, db_mask: np.ndarray,
                   vote_threshold: int) -> np.ndarray:
    """(M,) votes of (Kq, 16) query descriptors with (Kq,) mask against
    (M, K, 16) keyframes with (M, K) masks (words of any 32-bit type)."""
    q = np.ascontiguousarray(desc_q).view(np.uint64)  # (Kq, 8)
    db = np.ascontiguousarray(db_desc).view(np.uint64)  # (M, K, 8)
    valid_q = np.asarray(mask_q, bool)

    def chunk(lo: int) -> np.ndarray:
        d = np.bitwise_count(q[None, :, None, :] ^ db[lo:lo + SLOTS_PER_CHUNK, None, :, :]).sum(-1, dtype=np.int32)
        d = np.where(np.asarray(db_mask[lo:lo + SLOTS_PER_CHUNK], bool)[:, None, :], d, BITS)
        best = d.min(-1)  # (chunk, Kq): 512 where the keyframe holds no valid descriptor
        return ((best < vote_threshold) & valid_q[None]).sum(-1)

    workers = len(os.sched_getaffinity(0))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        parts = list(pool.map(chunk, range(0, len(db), SLOTS_PER_CHUNK)))
    return np.concatenate(parts) if parts else np.zeros(0, np.int64)


def scores(desc_q, mask_q, db_desc, db_mask, slots, allowed, capacity: int, vote_threshold: int) -> tuple:
    """((capacity,) float32 scores, best slot) of a query against the
    keyframes held in `slots` of a database of `capacity` slots; `allowed`
    (capacity,) bool."""
    votes = database_votes(desc_q, mask_q, db_desc, db_mask, vote_threshold)
    nq = np.float32(max(int(np.asarray(mask_q, bool).sum()), 1))
    out = np.full(capacity, -1.0, np.float32)
    out[slots] = votes.astype(np.float32) / nq
    out = np.where(allowed, out, np.float32(-1.0))
    return out, int(np.argmax(out))


# ----------------------------------------------------------------- SE(3)
def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (..., 4) xyzw quaternions."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw,
                        aw * bw - ax * bx - ay * by - az * bz], -1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], -1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """C(q) v, as q (v, 0) q^-1."""
    return quat_mul(quat_mul(q, torch.cat([v, torch.zeros_like(v[..., :1])], -1)), quat_conj(q))[..., :3]


def quat_exp(d: torch.Tensor) -> torch.Tensor:
    """exp of a rotation vector (..., 3): [sin(|d|/2) d / |d|; cos(|d|/2)]."""
    th = torch.linalg.norm(d, dim=-1, keepdim=True)
    s = torch.where(th > 1e-12, torch.sin(0.5 * th) / torch.where(th > 1e-12, th, 1.0), 0.5)
    return torch.cat([s * d, torch.cos(0.5 * th)], -1)


def _move(r, q, delta, exact: bool):
    """The nodes moved by `delta` (N, 6); to first order (differentiable at
    0) or by the exact exponential."""
    dq = quat_exp(delta[:, 3:]) if exact else torch.cat([0.5 * delta[:, 3:], torch.ones_like(delta[:, :1])], -1)
    q_new = quat_mul(dq, q)
    return r + delta[:, :3], q_new / torch.linalg.norm(q_new, dim=-1, keepdim=True)


def edge_residuals(ri, qi, rj, qj, meas_r, meas_q, L) -> torch.Tensor:
    """(E, 6) weighted residuals of edges between poses (ri, qi) and (rj, qj)."""
    qi_inv = quat_conj(qi)
    pred_r = quat_rotate(qi_inv, rj - ri)
    pred_q = quat_mul(qi_inv, qj)
    e = torch.cat([meas_r - pred_r, 2.0 * quat_mul(meas_q, quat_conj(pred_q))[..., :3]], -1)
    return torch.einsum("eij,ej->ei", L, e)


def residuals(r, q, free, ei, ej, meas_r, meas_q, L, delta) -> torch.Tensor:
    """(E, 6) weighted edge residuals after moving the free nodes by delta."""
    r, q = _move(r, q, delta * free[:, None], exact=True)
    return edge_residuals(r[ei], q[ei], r[ej], q[ej], meas_r, meas_q, L)


def jacobian(r, q, free, ei, ej, meas_r, meas_q, L) -> torch.Tensor:
    """(6E, 6N) Jacobian of the residuals at zero motion, by reverse-mode
    autodiff: an edge's residual depends on its own two nodes only, so one
    backward pass of a residual component summed over the edges gives that
    row of every edge's two blocks; fixed nodes' columns 0."""
    E, n = len(ei), len(r)
    di = torch.zeros(E, 6, dtype=r.dtype, requires_grad=True)
    dj = torch.zeros(E, 6, dtype=r.dtype, requires_grad=True)
    with torch.enable_grad():
        res = edge_residuals(*_move(r[ei], q[ei], di, False), *_move(r[ej], q[ej], dj, False), meas_r, meas_q, L)
        rows = [torch.autograd.grad(res[:, k].sum(), (di, dj), retain_graph=k < 5) for k in range(6)]
    Ji = torch.stack([g for g, _ in rows], 1) * free[ei][:, None, None]  # (E, 6 residual, 6 motion)
    Jj = torch.stack([g for _, g in rows], 1) * free[ej][:, None, None]
    J = torch.zeros(E, 6, n, 6, dtype=r.dtype)
    at = torch.arange(E)
    J[at, :, ei] = Ji
    J[at, :, ej] = Jj
    return J.reshape(6 * E, 6 * n)


def solve(node_r, node_q, node_mask, fixed, edge_i, edge_j, meas_r, meas_q, sqrt_info, edge_mask,
          max_iterations: int = 10, dtype=torch.float64) -> tuple:
    """(r (N, 3), q (N, 4)) float64 numpy of every slot after the solve
    (unoccupied slots as given), from the graph's host arrays; the
    arithmetic in `dtype` (float64; float32 is the control's)."""
    occ = np.nonzero(node_mask)[0]
    live = np.nonzero(edge_mask)[0]
    index = np.full(len(node_mask), -1, np.int64)
    index[occ] = np.arange(len(occ))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)  # noqa: E731
    r, q = t(node_r[occ]), t(node_q[occ])
    free = t(~np.asarray(fixed, bool)[occ])
    ei, ej = torch.as_tensor(index[edge_i[live]]), torch.as_tensor(index[edge_j[live]])
    args = (ei, ej, t(meas_r[live]), t(meas_q[live]), t(sqrt_info[live]))
    n = len(occ)
    zero = torch.zeros(n, 6, dtype=dtype)
    cost_of = lambda rr: 0.5 * torch.sum(rr * rr)  # noqa: E731
    cost = cost_of(residuals(r, q, free, *args, zero))
    lam = 1e-4
    f = free.repeat_interleave(6) > 0  # (6N,) unknowns of free nodes
    for _ in range(max_iterations):
        J = jacobian(r, q, free, *args)
        res = residuals(r, q, free, *args, zero).reshape(-1)
        H = (J.T @ J) * (f[:, None] & f[None, :])
        g = (J.T @ res) * f
        # Marquardt damping on the free unknowns; a fixed node's rows are the identity
        H = H + torch.diag(torch.where(f, lam * torch.diagonal(H) + (lam * 1e-8 + 1e-12), 1.0))
        delta = torch.cholesky_solve(-g[:, None], torch.linalg.cholesky(H))[:, 0].reshape(n, 6) * free[:, None]
        cost_new = cost_of(residuals(r, q, free, *args, delta))
        if cost_new < cost:
            r, q = _move(r, q, delta, exact=True)
            drop = (cost - cost_new) / max(float(cost), 1e-30)
            cost, lam = cost_new, max(lam * 0.5, 1e-10)
            if drop < 1e-9:
                break
        else:
            lam = min(lam * 4.0, 1e8)
    out_r = np.array(node_r, np.float64)
    out_q = np.array(node_q, np.float64)
    out_r[occ] = r.double().numpy()
    out_q[occ] = q.double().numpy()
    return out_r, out_q


def pose_differences(r_a, q_a, r_b, q_b) -> tuple:
    """(largest position difference, largest rotation angle in radians)
    between two sets of poses, row for row."""
    dr = np.linalg.norm(np.asarray(r_a, np.float64) - np.asarray(r_b, np.float64), axis=-1)
    qa, qb = torch.as_tensor(np.asarray(q_a, np.float64)), torch.as_tensor(np.asarray(q_b, np.float64))
    rel = quat_mul(qa, quat_conj(qb))
    ang = 2.0 * torch.atan2(torch.linalg.norm(rel[..., :3], dim=-1), rel[..., 3].abs())
    return (float(dr.max()) if dr.size else 0.0), (float(ang.max()) if ang.numel() else 0.0)
