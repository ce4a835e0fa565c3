"""Marginalization: absorb factors into a dense first-estimate prior by Schur
complement (port of okvis_tpu.estimator.marginalization).

- The joint system arrives as NormalEqs from one ``evaluate`` at the
  first-estimate points (the estimator selects the absorbed factors).
- Landmark blocks are eliminated with a batched 3x3 eigendecomposition
  pseudo-inverse (tolerance eps * dim * lmax, diagonal-sqrt
  preconditioning), then the removed dense dims with one dense Schur.
- The prior is kept as (H, b0 = -J^T e0, c0 = |e0|^2) over the dense vector,
  projected to PSD with b0 in range(H).

The selection arrives as masks; shapes never change. ``torch.linalg.eigh``
checks its result on the host, so each call synchronises with the card
three times (the landmark batch, the dense block, the PSD projection).
Where the float32 decomposition fails to converge on a finite symmetric
matrix (LAPACK's ssyevd does so at the estimator's full window, depending
on its thread count), it is redone in float64; the JAX package's eigh
returns NaN there instead.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..solver.assemble import NormalEqs
from ..solver.structure import WindowConfig
from ..utils import syncstats


def _eigh(A: torch.Tensor):
    """torch.linalg.eigh, redone in float64 (and cast back) where it fails
    to converge. Its check of the result waits for the card (syncstats
    `marg_eigh`)."""
    with syncstats.sync("marg_eigh"):
        try:
            return torch.linalg.eigh(A)
        except torch.linalg.LinAlgError:
            w, V = torch.linalg.eigh(A.to(torch.float64))
            return w.to(A.dtype), V.to(A.dtype)


def pinv_sym(A: torch.Tensor, active_mask: torch.Tensor = None) -> torch.Tensor:
    """Eigendecomposition pseudo-inverse of symmetric PSD matrices (..., n, n)
    with tolerance eps * n * lmax and diagonal-sqrt preconditioning.

    active_mask (..., n) restricts to a principal submatrix: inactive
    rows/cols are replaced by identity before the eigh and zeroed after."""
    dtype, n = A.dtype, A.shape[-1]
    if active_mask is not None:
        m = active_mask.to(dtype)
        A = A * m[..., :, None] * m[..., None, :] + torch.diag_embed(1.0 - m)
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    p = torch.where(diag > 1e-9, torch.sqrt(diag.abs() + 1e-300), torch.full_like(diag, 1e-3))
    p_inv = 1.0 / p
    As = A * p_inv[..., :, None] * p_inv[..., None, :]
    w, V = _eigh(0.5 * (As + As.mT))
    tol = torch.finfo(dtype).eps * n * w.amax(dim=-1, keepdim=True)
    keep = w > tol
    w_pinv = torch.where(keep, 1.0 / torch.where(keep, w, torch.ones_like(w)), torch.zeros_like(w))
    Ainv = ((V * w_pinv[..., None, :]) @ V.mT) * p_inv[..., :, None] * p_inv[..., None, :]
    if active_mask is not None:
        Ainv = Ainv * m[..., :, None] * m[..., None, :]
    return Ainv


class MargResult(NamedTuple):
    H: torch.Tensor  # (D, D) prior information over the kept dense dims
    b0: torch.Tensor  # (D,)
    c0: torch.Tensor  # ()


def marginalize_system(
    cfg: WindowConfig,
    eqs: NormalEqs,
    marg_dense_mask: torch.Tensor,  # (D,) dims to eliminate
    keep_dense_mask: torch.Tensor,  # (D,) dims the prior will cover
    marg_lm_mask: torch.Tensor,  # (L,) landmarks to eliminate
    c0_in: torch.Tensor,
) -> MargResult:
    """Schur-eliminate the landmarks (blockwise 3x3 pseudo-inverse), then the
    dense dims. `eqs` must be the first-estimate joint system of the absorbed
    factors and the existing prior; the W/H_ll rows of the landmarks in
    marg_lm_mask must only involve absorbed observations."""
    dtype = eqs.H_dd.dtype
    D = cfg.dense_dim

    # landmark elimination (blockwise)
    V_pinv = pinv_sym(eqs.H_ll) * marg_lm_mask.to(dtype)[:, None, None]  # (L, 3, 3)
    WV = eqs.W @ V_pinv
    H = eqs.H_dd - torch.einsum("ldb,leb->de", WV, eqs.W)
    b = eqs.b_d - torch.einsum("ldb,lb->d", WV, eqs.b_l)
    c0 = c0_in - torch.einsum("la,lab,lb->", eqs.b_l, V_pinv, eqs.b_l)

    # dense elimination
    mm, km = marg_dense_mask.to(dtype), keep_dense_mask.to(dtype)
    H_mm_pinv = pinv_sym(H, active_mask=marg_dense_mask)
    H_km = H * km[:, None] * mm[None, :]
    b_m = b * mm
    H_new = H * km[:, None] * km[None, :] - H_km @ H_mm_pinv @ H_km.T
    b_new = b * km - H_km @ (H_mm_pinv @ b_m)
    c0_new = c0 - b_m @ H_mm_pinv @ b_m
    H_new = 0.5 * (H_new + H_new.T)

    # PSD sanitization: in float32 the Schur complement can come out slightly
    # indefinite and b can leave range(H), and the prior cost then has
    # unbounded-below directions. Project H to PSD, b onto range(H), and
    # make c0 >= b^T H^+ b, so the prior is exactly |e0 + J dchi|^2 / 2.
    w, V = _eigh(H_new)
    keep = w > torch.finfo(dtype).eps * D * torch.clamp(w.max(), min=0.0)
    w_pos = torch.where(keep, w, torch.zeros_like(w))
    coeff_in = torch.where(keep, V.T @ b_new, torch.zeros_like(w))
    quad = torch.sum(torch.where(keep, coeff_in * coeff_in / torch.where(keep, w_pos, torch.ones_like(w)),
                                 torch.zeros_like(w)))
    return MargResult(H=(V * w_pos) @ V.T, b0=V @ coeff_in, c0=torch.maximum(c0_new, quad))
