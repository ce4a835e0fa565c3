"""Five-point relative pose (Stewenius) + host-side RANSAC (a copy of
okvis_tpu.frontend.fivepoint).

The reference initializes relative pose with OpenGV's Stewenius 5-point
inside its RANSAC (okvis_frontend/src/Frontend.cpp:645-810); the device
path uses the batched 8-point essential (frontend/ransac.py), which needs
more correspondences per hypothesis and is weaker under noise at low
overlap. This module is the minimal solver for that regime. The 2D-2D
RANSAC runs only until initialization succeeds, a cold path, and the
action matrix needs a nonsymmetric 10x10 eigendecomposition, so it stays a
host numpy solver.

Method (Stewenius et al., "Recent developments on direct relative
orientation", 2006):
  1. null space of the 5x9 epipolar constraint matrix -> E(x,y,z) =
     x X + y Y + z Z + W.
  2. ten cubic constraints: det(E)=0 and 2 E Et E - tr(E Et) E = 0.
     Their 20 monomial coefficients are recovered numerically by evaluating
     the constraints at fixed generic sample points and solving a
     precomputed least-squares system.
  3. Gauss-Jordan to [I | CR]; action matrix of multiplication by x on the
     quotient-ring basis [x2, xy, xz, y2, yz, z2, x, y, z, 1]; right
     eigenvectors give up to 10 (x, y, z) solutions.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# degree-3 monomial exponents in (x, y, z), eliminated monomials first:
# [x3, x2y, x2z, xy2, xyz, xz2, y3, y2z, yz2, z3 | x2, xy, xz, y2, yz, z2,
#  x, y, z, 1]
_EXPONENTS = np.array(
    [
        (3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1), (1, 0, 2),
        (0, 3, 0), (0, 2, 1), (0, 1, 2), (0, 0, 3),
        (2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1), (0, 0, 2),
        (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0),
    ],
    dtype=np.int64,
)

# fixed generic sample points for coefficient interpolation; the pseudo-
# inverse is precomputed once (module import)
_rng = np.random.default_rng(123456789)
_SAMPLES = _rng.uniform(-1.0, 1.0, (40, 3))
_MONO = np.prod(_SAMPLES[:, None, :] ** _EXPONENTS[None, :, :], axis=2)  # (40, 20)
_MONO_PINV = np.linalg.pinv(_MONO)  # (20, 40)


def _constraints(E: np.ndarray) -> np.ndarray:
    """The 10 cubic constraint values for a given 3x3 E candidate."""
    EEt = E @ E.T
    trace = np.trace(EEt)
    mat = 2.0 * EEt @ E - trace * E
    return np.concatenate([[np.linalg.det(E)], mat.ravel()])


def essential_five_point(
    xa: np.ndarray, xb: np.ndarray
) -> List[np.ndarray]:
    """Up to 10 essential matrices from 5 normalized-image correspondences.

    Constraint convention matches frontend/ransac.py's 8-point:
    ha^T E hb = 0 with h = (x, y, 1).
    """
    x1, y1 = xa[:, 0], xa[:, 1]
    x2, y2 = xb[:, 0], xb[:, 1]
    A = np.stack(
        [x1 * x2, x1 * y2, x1, y1 * x2, y1 * y2, y1, x2, y2, np.ones_like(x1)],
        axis=1,
    )  # (5, 9)
    # 4-dim null space
    _, _, Vt = np.linalg.svd(A)
    X, Y, Z, W = (Vt[i].reshape(3, 3) for i in (5, 6, 7, 8))

    # numeric coefficient recovery: evaluate the 10 constraints at the fixed
    # sample points, then least-squares against the monomial matrix
    vals = np.empty((len(_SAMPLES), 10))
    for i, (sx, sy, sz) in enumerate(_SAMPLES):
        vals[i] = _constraints(sx * X + sy * Y + sz * Z + W)
    C = (_MONO_PINV @ vals).T  # (10, 20)

    C1, C2 = C[:, :10], C[:, 10:]
    try:
        # plain partial-pivot LU even when cond(C1) is huge: on degenerate
        # strata (e.g. exactly zero rotation) the error lands in directions
        # RANSAC scoring rejects, while rcond-truncated least squares
        # destroys the quotient-ring structure entirely (measured) —
        # OpenGV's Stewenius makes the same choice
        CR = np.linalg.solve(C1, C2)  # (10, 10)
    except np.linalg.LinAlgError:
        return []
    if not np.all(np.isfinite(CR)):
        return []

    # action matrix of multiplication by x on
    # B = [x2, xy, xz, y2, yz, z2, x, y, z, 1]
    At = np.zeros((10, 10))
    At[0] = -CR[0]  # x*x2 = x3
    At[1] = -CR[1]  # x*xy = x2y
    At[2] = -CR[2]  # x*xz = x2z
    At[3] = -CR[3]  # x*y2 = xy2
    At[4] = -CR[4]  # x*yz = xyz
    At[5] = -CR[5]  # x*z2 = xz2
    At[6, 0] = 1.0  # x*x = x2
    At[7, 1] = 1.0  # x*y = xy
    At[8, 2] = 1.0  # x*z = xz
    At[9, 6] = 1.0  # x*1 = x
    _, vecs = np.linalg.eig(At)

    Es: List[np.ndarray] = []
    for j in range(10):
        v = vecs[:, j]
        if abs(v[9]) < 1e-12:
            continue
        v = v / v[9]
        if np.max(np.abs(v.imag)) > 1e-6 * max(1.0, np.max(np.abs(v.real))):
            continue
        sx, sy, sz = v[6].real, v[7].real, v[8].real
        E = sx * X + sy * Y + sz * Z + W
        n = np.linalg.norm(E)
        if n < 1e-12 or not np.isfinite(n):
            continue
        Es.append(E / n)
    return Es


def _sampson_px2(
    Es: np.ndarray, ha: np.ndarray, hb: np.ndarray, focal: float
) -> np.ndarray:
    """(M, N) Sampson distances in pixel^2 (same scoring as the 8-point)."""
    Exb = np.einsum("mij,nj->mni", Es, hb)
    Eta = np.einsum("mji,nj->mni", Es, ha)
    num = np.einsum("ni,mni->mn", ha, Exb) ** 2
    den = Exb[..., 0] ** 2 + Exb[..., 1] ** 2 + Eta[..., 0] ** 2 + Eta[..., 1] ** 2
    return num / np.maximum(den, 1e-12) * focal * focal


def ransac_relative_pose_5pt(
    f_a: np.ndarray,  # (N, 3) unit bearings, frame A
    f_b: np.ndarray,  # (N, 3) unit bearings, frame B
    mask: np.ndarray,  # (N,) bool
    focal: float = 460.0,
    threshold_px2: float = 9.0,
    n_iters: int = 50,
    seed: int = 0,
) -> Tuple[np.ndarray, int, np.ndarray, bool]:
    """Host 5-point RANSAC (reference Frontend.cpp:645-810 parity: 50
    iterations, focal-scaled threshold). Returns (inliers, num_inliers,
    E_best, success) mirroring ransac.RansacResult."""
    mask = np.asarray(mask, bool)
    valid = np.nonzero(mask)[0]
    if valid.size < 5:
        return np.zeros(len(f_a), bool), 0, np.eye(3), False
    rng = np.random.default_rng(seed)

    za = np.maximum(np.abs(f_a[:, 2:3]), 1e-6) * np.sign(
        np.where(f_a[:, 2:3] == 0, 1.0, f_a[:, 2:3])
    )
    zb = np.maximum(np.abs(f_b[:, 2:3]), 1e-6) * np.sign(
        np.where(f_b[:, 2:3] == 0, 1.0, f_b[:, 2:3])
    )
    xa = f_a[:, :2] / za
    xb = f_b[:, :2] / zb
    ha = np.concatenate([xa, np.ones_like(xa[:, :1])], axis=1)
    hb = np.concatenate([xb, np.ones_like(xb[:, :1])], axis=1)

    models = []
    for _ in range(n_iters):
        pick = valid[rng.choice(valid.size, size=5, replace=False)]
        models.extend(essential_five_point(xa[pick], xb[pick]))
    if not models:
        return np.zeros(len(f_a), bool), 0, np.eye(3), False
    Es = np.stack(models)
    err = _sampson_px2(Es, ha, hb, focal)
    inl = (err < threshold_px2) & mask[None, :]
    counts = inl.sum(axis=1)
    best = int(np.argmax(counts))
    return inl[best], int(counts[best]), Es[best], counts[best] >= 5
