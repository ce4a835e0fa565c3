"""Matching ops and the hand-written CUDA kernels (port of okvis_tpu.ops)."""

from .hamming import (  # noqa: F401
    hamming_matrix,
    hamming_matrix_mxu,
    masked_distance_matrix,
    match_descriptors,
    mutual_best_assignment,
)
