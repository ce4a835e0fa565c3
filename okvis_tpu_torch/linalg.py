"""Dense linear algebra with the JAX package's failure semantics and no host
sync.

``torch.linalg.cholesky`` checks the factorization on the host (a sync on
CUDA) and raises; ``cholesky_ex`` does not check, and leaves a factor that
is not defined where the matrix is not positive definite. ``jnp.linalg
.cholesky`` returns NaN there instead, so a failed dense solve gives a NaN
step that the trust-region loop rejects. The port keeps that.
"""

from __future__ import annotations

import torch


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of batched matrices (..., n, n); all NaN for a
    matrix that is not positive definite."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))
