"""Wrapper of the hand-written CUDA Harris+NMS kernel (``csrc/harris_nms.cu``).

Replaces ``okvis_tpu/ops/detection_pallas.py::harris_suppressed_pallas``:
(raw Harris response, suppressed score) for a (C, H, W) batch of images in
one launch. ``frontend.detection.harris_suppressed`` routes CUDA tensors
here and CPU tensors to the plain version; this function itself only
launches the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import cuda_lib

# (blur radius, nms radius) pairs the kernel is compiled for (csrc/harris_nms.cu)
KERNEL_RADII = ((5, 4), (5, 2))


def gauss_taps(sigma: float, radius: int = None) -> Tuple[float, ...]:
    """Normalized Gaussian taps, computed in float64 and rounded once to
    float32 (the taps of the Pallas kernel's ``_gauss_taps``). Radius
    defaults to int(3σ+0.5): 11 taps for σ=1.5."""
    radius = radius or max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return tuple(float(v) for v in (k / k.sum()).astype(np.float32))


def harris_suppressed_cuda(
    img: torch.Tensor,  # (C, H, W) float32
    inb: torch.Tensor,  # (C, H, W) float32 1/0 validity (border & user mask)
    k_harris: float = 0.04,
    nms_radius: int = 4,
    sigma: float = 1.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(raw_response, suppressed_score), each (C, H, W) float32, on the card."""
    for name, t in (("img", img), ("inb", inb)):
        if t.device.type != "cuda":
            raise ValueError(f"harris_suppressed_cuda: {name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32 or t.dim() != 3:
            raise ValueError(
                f"harris_suppressed_cuda: {name} must be (C, H, W) float32, "
                f"got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"harris_suppressed_cuda: {name} must be contiguous")
    if inb.shape != img.shape or inb.device != img.device:
        raise ValueError("harris_suppressed_cuda: inb must match img in shape and device")
    taps = gauss_taps(sigma)
    radius = (len(taps) - 1) // 2
    if (radius, nms_radius) not in KERNEL_RADII:
        raise ValueError(
            f"harris_suppressed_cuda: (blur radius, nms radius) ({radius}, {nms_radius}) "
            f"not among the compiled {KERNEL_RADII}")
    C, H, W = img.shape
    if H * W >= 2**31:
        raise ValueError(f"harris_suppressed_cuda: {H} x {W} images exceed the kernel's 32-bit offsets")
    raw = torch.empty_like(img)
    sup = torch.empty_like(img)
    if img.numel() == 0:
        return raw, sup
    lib = cuda_lib.load_library()
    taps_c = (ctypes.c_float * len(taps))(*taps)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.okvis_harris_nms(
            img.data_ptr(), inb.data_ptr(), raw.data_ptr(), sup.data_ptr(),
            C, H, W, ctypes.cast(taps_c, ctypes.c_void_p), radius, int(nms_radius),
            float(k_harris), stream)
    cuda_lib.check(lib, err, "harris_nms kernel launch")
    harris_suppressed_cuda.launches += 1
    return raw, sup


harris_suppressed_cuda.launches = 0
