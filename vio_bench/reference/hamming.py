"""Hamming distance matrices in NumPy: XOR and popcount of 512-bit strings
held as 16 int32 words, with 10,000 where a row or column is masked out
(the value the port's matcher reads as no match)."""

from __future__ import annotations

import numpy as np

MASKED = 10_000
_POP = np.array([bin(i).count("1") for i in range(256)], np.int32)


def distances(a: np.ndarray, b: np.ndarray, mask_a=None, mask_b=None) -> np.ndarray:
    """(G, NA, NB) from (G or 1, NA, 16), (G or 1, NB, 16) and (G or 1, N)
    bool masks or None (all valid)."""
    ua = np.ascontiguousarray(a).view(np.uint8)  # (Ga, NA, 64)
    ub = np.ascontiguousarray(b).view(np.uint8)
    x = ua[:, :, None, :] ^ ub[:, None, :, :]
    d = _POP[x].sum(-1, dtype=np.int32)
    valid = np.ones(d.shape, bool)
    if mask_a is not None:
        valid = valid & np.asarray(mask_a, bool)[:, :, None]
    if mask_b is not None:
        valid = valid & np.asarray(mask_b, bool)[:, None, :]
    return np.where(valid, d, MASKED).astype(np.int32)
