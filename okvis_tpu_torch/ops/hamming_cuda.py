"""Wrapper of the hand-written CUDA Hamming kernel (``csrc/hamming.cu``).

Replaces ``okvis_tpu/ops/hamming_pallas.py::hamming_matrix_pallas`` and, with
the masks, ``okvis_tpu/ops/hamming.py::masked_distance_matrix`` under
``jax.vmap``: the (G, NA, NB) int32 matrices of popcount(a XOR b) summed over
16 packed words, MAX_DIST where ``mask_a[i] & mask_b[j]`` is false, in one
launch whatever G is. ``ops.hamming`` routes CUDA tensors here and CPU
tensors to the plain version; this function itself only launches the kernel.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .hamming import DESCRIPTOR_WORDS

_TILE_ROWS = 32  # output rows of a block in okvis_hamming_matrix (csrc/hamming.cu)
_MAX_ROWS = 65535 * _TILE_ROWS  # grid.y limit times the tile
_MAX_BATCH = 65535  # grid.z limit
_MAX_ELEMENTS = 2**31  # the kernel's offsets are 32-bit


def _batched(name: str, desc: torch.Tensor, mask: torch.Tensor | None):
    """Check one side; return its (Gd, N, 16) descriptors and (Gm, N) mask views."""
    where = f"hamming_matrix_cuda: {name}"
    if desc.device.type != "cuda":
        raise ValueError(f"{where} must be a CUDA tensor, got {desc.device}")
    if desc.dtype != torch.int32 or desc.dim() not in (2, 3) or desc.shape[-1] != DESCRIPTOR_WORDS:
        raise ValueError(f"{where} must be (N, {DESCRIPTOR_WORDS}) or (G, N, {DESCRIPTOR_WORDS}) "
                         f"int32, got {tuple(desc.shape)} {desc.dtype}")
    if not desc.is_contiguous():
        raise ValueError(f"{where} must be contiguous")
    n = desc.shape[-2]
    desc = desc if desc.dim() == 3 else desc[None]
    if mask is None:
        return desc, None
    if mask.device != desc.device or mask.dtype != torch.bool:
        raise ValueError(f"{where}: its mask must be a torch.bool tensor on {desc.device}, "
                         f"got {mask.dtype} on {mask.device}")
    if mask.dim() not in (1, 2) or mask.shape[-1] != n or not mask.is_contiguous():
        raise ValueError(f"{where}: its mask must be a contiguous (N,) or (G, N) with N = {n}, "
                         f"got {tuple(mask.shape)}")
    return desc, mask if mask.dim() == 2 else mask[None]


def hamming_matrix_cuda(desc_a: torch.Tensor, desc_b: torch.Tensor,
                        mask_a: torch.Tensor | None = None,
                        mask_b: torch.Tensor | None = None) -> torch.Tensor:
    """(G, NA, NB) int32 Hamming distances of (G, N, 16) int32 descriptors, on
    the card, with MAX_DIST wherever mask_a[g, i] & mask_b[g, j] is false.

    Each of desc_a, desc_b, mask_a, mask_b may have a batch of 1, which is
    broadcast, or none: (N, 16) descriptors and (N,) masks. The result is
    (NA, NB) when no input has a batch. A mask of None is all true."""
    a, ma = _batched("desc_a", desc_a, mask_a)
    b, mb = _batched("desc_b", desc_b, mask_b)
    if b.device != a.device:
        raise ValueError("hamming_matrix_cuda: descriptors on different devices")
    (ga, na, _), (gb, nb, _) = a.shape, b.shape
    batches = [t.shape[0] for t in (a, b, ma, mb) if t is not None]
    g = max(batches)
    if any(x not in (1, g) for x in batches):
        raise ValueError(f"hamming_matrix_cuda: batches {batches} do not broadcast")
    if na > _MAX_ROWS or g > _MAX_BATCH:
        raise ValueError(f"hamming_matrix_cuda: at most {_MAX_ROWS} rows in desc_a "
                         f"and a batch of {_MAX_BATCH}")
    if max(g * na * nb, ga * na * DESCRIPTOR_WORDS, gb * nb * DESCRIPTOR_WORDS) >= _MAX_ELEMENTS:
        raise ValueError(f"hamming_matrix_cuda: {g} x {na} x {nb} outputs exceed the kernel's "
                         "32-bit offsets")
    out = torch.empty((g, na, nb), dtype=torch.int32, device=a.device)
    if g and na and nb:
        stride = lambda t, n: n if t is not None and t.shape[0] > 1 else 0  # noqa: E731
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        lib = cuda_lib.load_library()
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = lib.okvis_hamming_matrix(
                a.data_ptr(), b.data_ptr(), ptr(ma), ptr(mb), out.data_ptr(), g, na, nb,
                stride(a, na), stride(b, nb), stride(ma, na), stride(mb, nb), stream)
        cuda_lib.check(lib, err, "hamming kernel launch")
        hamming_matrix_cuda.launches += 1
    unbatched = desc_a.dim() == desc_b.dim() == 2 and all(
        m is None or m.dim() == 1 for m in (mask_a, mask_b))
    return out[0] if unbatched else out


hamming_matrix_cuda.launches = 0
