"""BRISK-style binary descriptor with gravity-aligned extraction direction
(port of okvis_tpu.frontend.brisk).

A radially-symmetric sampling pattern of smoothed intensity points; short-
distance point pairs compare into a 512-bit binary string. The pattern is
rotated by one per-frame angle (the gravity direction projected into the
image) instead of a per-keypoint orientation, so extraction is one batched
gather + compare.

Pattern: 4 concentric rings (+ center), 60 points (N per ring, radius,
per-ring smoothing sigma); pairs are the 512 shortest point pairs.
Descriptors are (..., 16) int32 tensors holding the packed uint32 words.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..device import set_full_precision
from .detection import Keypoints, detect_keypoints

DESCRIPTOR_BITS = 512
DESCRIPTOR_WORDS = DESCRIPTOR_BITS // 32


def _build_pattern() -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (points (60,2), point_sigma (60,), pair_i (512,), pair_j (512,)).

    Ring layout (radius in px at scale 1, #points, sigma): BRISK-like."""
    rings = [
        (0.0, 1, 0.7),
        (2.9, 10, 0.8),
        (4.9, 14, 1.1),
        (7.4, 15, 1.6),
        (10.8, 20, 2.3),
    ]
    pts, sig = [], []
    for r, n, s in rings:
        for k in range(n):
            a = 2 * np.pi * k / n + (0.5 if r > 0 else 0.0) * np.pi / n
            pts.append([r * np.cos(a), r * np.sin(a)])
            sig.append(s)
    pts = np.asarray(pts, dtype=np.float32)
    sig = np.asarray(sig, dtype=np.float32)
    # all pairs sorted by distance; take the 512 shortest
    n = len(pts)
    ii, jj = np.triu_indices(n, k=1)
    d = np.linalg.norm(pts[ii] - pts[jj], axis=1)
    order = np.argsort(d, kind="stable")
    sel = order[:DESCRIPTOR_BITS]
    return pts, sig, ii[sel].astype(np.int32), jj[sel].astype(np.int32)


_PATTERN_PTS, _PATTERN_SIG, _PAIR_I, _PAIR_J = _build_pattern()
# distinct smoothing sigmas -> blur pyramid levels
_SIGMAS = np.unique(_PATTERN_SIG)
_PT_LEVEL = np.searchsorted(_SIGMAS, _PATTERN_SIG).astype(np.int32)
# static grouping of pattern points by blur level: each point is gathered
# from its own level only
_LEVEL_ORDER = np.argsort(_PT_LEVEL, kind="stable")
_LEVEL_INV = np.argsort(_LEVEL_ORDER)
_LEVEL_COUNTS = np.bincount(_PT_LEVEL, minlength=len(_SIGMAS))


def _multi_sigma_kernels(sigmas: np.ndarray) -> Tuple[np.ndarray, int]:
    """Zero-padded Gaussian taps, one row per sigma (L, 2·rad+1); per-sigma
    radius int(3σ+0.5). The zero taps change no output value."""
    rads = [max(1, int(3.0 * s + 0.5)) for s in sigmas]
    rad = max(rads)
    taps = np.zeros((len(sigmas), 2 * rad + 1), np.float32)
    for i, (s, r) in enumerate(zip(sigmas, rads)):
        x = np.arange(-r, r + 1, dtype=np.float64)
        k = np.exp(-0.5 * (x / s) ** 2)
        taps[i, rad - r:rad + r + 1] = (k / k.sum()).astype(np.float32)
    return taps, rad


_BLUR_TAPS, _BLUR_RAD = _multi_sigma_kernels(_SIGMAS)


@functools.lru_cache(maxsize=None)
def _blur_toeplitz_bank(n: int) -> np.ndarray:
    """(L, n, n) banded Toeplitz matrices: column w of level l holds the
    level's taps centered at w, out-of-range taps folded onto the clamped
    border row (edge-replicate conv: out[w] = Σ_t k[t]·img[clamp(w+t−r)])."""
    L, taps = _BLUR_TAPS.shape
    r = _BLUR_RAD
    T = np.zeros((L, n, n), np.float32)
    for lvl in range(L):
        for t in range(taps):
            w = np.arange(n)
            src = np.clip(w + t - r, 0, n - 1)
            np.add.at(T[lvl], (src, w), _BLUR_TAPS[lvl, t])
    return T


@functools.lru_cache(maxsize=8)
def _toeplitz_on_device(n: int, device: torch.device) -> torch.Tensor:
    """The bank as a device tensor, copied once per (size, device)."""
    return torch.from_numpy(_blur_toeplitz_bank(n)).to(device)


def blur_pyramid(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W) → (B, L, H, W) float32: every pattern-sigma blur of every
    image as two banded-Toeplitz contractions (horizontal, then vertical),
    in full float32 (TF32 off: descriptor bits compare smoothed intensities)."""
    set_full_precision()
    B, H, W = images.shape
    x = images.to(torch.float32)
    Tw = _toeplitz_on_device(W, x.device)  # (L, W, W)
    Th = _toeplitz_on_device(H, x.device)  # (L, H, H)
    out = torch.einsum("bhw,lwv->blhv", x, Tw)
    return torch.einsum("blhv,lhg->blgv", out, Th)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 512) bool -> (..., 16) int32 bit patterns, bit b of word w =
    bits[32w + b] (an OR of distinct bits, formed in int64 so bit 31 lands
    in the sign bit only at the final narrowing)."""
    words = bits.reshape(*bits.shape[:-1], DESCRIPTOR_WORDS, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    v = (words << shifts).sum(dim=-1)  # in [0, 2^32)
    v = v - ((v >> 31) << 32)  # two's complement int32 value of the same bits
    return v.to(torch.int32)


def _describe_from_levels(
    levels: torch.Tensor,  # (C, L, H, W) blur pyramid per camera
    uv: torch.Tensor,  # (C, K, 2)
    angles: torch.Tensor,  # (C,)
    sizes: torch.Tensor = None,  # (C, K) keypoint sizes; None = base (8 px)
) -> torch.Tensor:
    """(C, K, 16) packed descriptors via one flat gather per bilinear corner
    and blur level."""
    C, L, H, W = levels.shape
    dev = levels.device
    flat = levels.reshape(-1)
    ca, sa = torch.cos(angles), torch.sin(angles)  # (C,)
    p = torch.from_numpy(_PATTERN_PTS).to(dev)  # (60, 2)
    # rotated offsets per camera: (C, 60)
    px = ca[:, None] * p[None, :, 0] - sa[:, None] * p[None, :, 1]
    py = sa[:, None] * p[None, :, 0] + ca[:, None] * p[None, :, 1]
    if sizes is not None:
        # the sampling pattern scales with keypoint size (8·2^octave)
        s = (sizes / 8.0)[:, :, None]  # (C, K, 1)
        xs = uv[:, :, 0][:, :, None] + px[:, None, :] * s  # (C, K, 60)
        ys = uv[:, :, 1][:, :, None] + py[:, None, :] * s
    else:
        xs = uv[:, :, 0][:, :, None] + px[:, None, :]  # (C, K, 60)
        ys = uv[:, :, 1][:, :, None] + py[:, None, :]
    cam_off = (torch.arange(C, device=dev) * (L * H * W))[:, None, None]

    groups, start = [], 0
    for lvl, cnt in enumerate(_LEVEL_COUNTS):
        sel = torch.from_numpy(_LEVEL_ORDER[start:start + cnt]).to(dev)
        start += cnt
        x = xs[:, :, sel]
        y = ys[:, :, sel]
        x0 = torch.floor(x).to(torch.int64).clamp(0, W - 2)
        y0 = torch.floor(y).to(torch.int64).clamp(0, H - 2)
        fx = (x - x0).clamp(0.0, 1.0)
        fy = (y - y0).clamp(0.0, 1.0)
        base = cam_off + lvl * (H * W) + y0 * W + x0  # (C, K, cnt)
        v00 = flat[base]
        v01 = flat[base + 1]
        v10 = flat[base + W]
        v11 = flat[base + W + 1]
        groups.append(
            v00 * (1 - fx) * (1 - fy)
            + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy
            + v11 * fx * fy
        )
    samples = torch.cat(groups, dim=-1)[:, :, torch.from_numpy(_LEVEL_INV).to(dev)]
    pi = torch.from_numpy(_PAIR_I).to(dev).long()
    pj = torch.from_numpy(_PAIR_J).to(dev).long()
    return _pack_bits(samples[:, :, pi] < samples[:, :, pj])


def describe_keypoints(
    img: torch.Tensor,  # (H, W) float
    keypoints: Keypoints,
    extraction_angle: torch.Tensor = None,  # scalar radians; gravity-aligned
    sizes: torch.Tensor = None,  # (K,) keypoint sizes (scale-space detection)
) -> torch.Tensor:
    """(K, 16) int32 packed 512-bit descriptors of one image."""
    img = img.to(torch.float32)
    if extraction_angle is None:
        extraction_angle = torch.zeros((), dtype=torch.float32, device=img.device)
    angle = torch.as_tensor(extraction_angle, device=img.device).reshape(1)
    levels = blur_pyramid(img[None])  # (1, L, H, W)
    return _describe_from_levels(
        levels, keypoints.uv[None], angle, None if sizes is None else sizes[None],
    )[0]


def gravity_extraction_angle(g_in_camera: torch.Tensor) -> torch.Tensor:
    """Angle of the gravity direction projected into the image plane:
    g_in_camera (..., 3) is C_CW @ [0,0,-1]."""
    return torch.atan2(g_in_camera[..., 1], g_in_camera[..., 0])


def detect_and_describe_batch(
    images: torch.Tensor,  # (C, H, W)
    extraction_angles: torch.Tensor,  # (C,)
    threshold: float = 30.0,
    max_keypoints: int = 400,
    nms_radius: int = 4,
    border: int = 20,
):
    """Detection + description for a whole multiframe, the camera axis as
    the batch dimension. Returns (Keypoints (C, K, ...), descriptors (C, K, 16))."""
    images = images.to(torch.float32)
    kps = detect_keypoints(
        images, threshold=threshold, max_keypoints=max_keypoints,
        nms_radius=nms_radius, border=border,
    )
    levels = blur_pyramid(images)  # (C, L, H, W)
    desc = _describe_from_levels(levels, kps.uv, extraction_angles)
    return kps, desc
