"""Wrapper of the hand-written CUDA Hamming kernel (``csrc/hamming.cu``).

Replaces ``okvis_tpu/ops/hamming_pallas.py::hamming_matrix_pallas``: the
(NA, NB) int32 matrix of popcount(a XOR b) summed over 16 packed words.
``ops.hamming.hamming_matrix`` routes CUDA tensors here and CPU tensors to
the plain version; this function itself only launches the kernel.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .hamming import DESCRIPTOR_WORDS

_MAX_ROWS = 65535 * 16  # grid.y limit times the 16-row tile


def _check_desc(name: str, d: torch.Tensor) -> None:
    if d.device.type != "cuda":
        raise ValueError(f"hamming_matrix_cuda: {name} must be a CUDA tensor, got {d.device}")
    if d.dtype != torch.int32 or d.dim() != 2 or d.shape[1] != DESCRIPTOR_WORDS:
        raise ValueError(
            f"hamming_matrix_cuda: {name} must be (N, {DESCRIPTOR_WORDS}) int32, "
            f"got {tuple(d.shape)} {d.dtype}")
    if not d.is_contiguous():
        raise ValueError(f"hamming_matrix_cuda: {name} must be contiguous")


def hamming_matrix_cuda(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(NA, NB) int32 Hamming distances of (N, 16) int32 descriptors, on the card."""
    _check_desc("desc_a", desc_a)
    _check_desc("desc_b", desc_b)
    if desc_a.device != desc_b.device:
        raise ValueError("hamming_matrix_cuda: descriptors on different devices")
    na, nb = desc_a.shape[0], desc_b.shape[0]
    if na > _MAX_ROWS:
        raise ValueError(f"hamming_matrix_cuda: at most {_MAX_ROWS} rows in desc_a")
    out = torch.empty((na, nb), dtype=torch.int32, device=desc_a.device)
    if na == 0 or nb == 0:
        return out
    lib = cuda_lib.load_library()
    with torch.cuda.device(desc_a.device):
        stream = torch.cuda.current_stream(desc_a.device).cuda_stream
        err = lib.okvis_hamming_matrix(
            desc_a.data_ptr(), desc_b.data_ptr(), out.data_ptr(), na, nb, stream)
    cuda_lib.check(lib, err, "hamming kernel launch")
    hamming_matrix_cuda.launches += 1
    return out


hamming_matrix_cuda.launches = 0
