"""Keypoint detection: Harris corner score + NMS + top-K selection
(port of okvis_tpu.frontend.detection).

Everything is fixed-shape: detection returns `max_keypoints` slots per
camera with a validity mask. The camera batch is the leading dimension
where the JAX package vmapped.

``harris_suppressed`` is the (raw, suppressed) stage: on CUDA tensors it
launches the hand-written kernel (``ops/detection_cuda.py``), on CPU tensors
it runs ``harris_suppressed_plain`` — the JAX package's XLA-path semantics in
torch ops. ``detect_keypoints_pyramid`` (scale-space detection) runs that
stage once per octave on the whole (C, H/2^o, W/2^o) camera stack.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..ops.detection_cuda import gauss_taps


class Keypoints(NamedTuple):
    uv: torch.Tensor  # (..., K, 2) float pixel coordinates (x, y)
    score: torch.Tensor  # (..., K)
    mask: torch.Tensor  # (..., K) bool


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Circularly shifted copy, as jnp.roll: out[y, x] = img[y - dy, x - dx]."""
    return torch.roll(img, (dy, dx), dims=(-2, -1))


def _sep_blur(img: torch.Tensor, taps) -> torch.Tensor:
    """Separable blur of (..., H, W), vertical then horizontal, with edge
    padding; each pass is a left-to-right sum of tap·shifted-copy terms (the
    CUDA kernel repeats exactly these roundings)."""
    r = (len(taps) - 1) // 2
    H, W = img.shape[-2:]
    xp = torch.cat([img[..., :1, :].expand(*img.shape[:-2], r, W), img,
                    img[..., -1:, :].expand(*img.shape[:-2], r, W)], dim=-2)
    acc = taps[0] * xp[..., 0:H, :]
    for i in range(1, len(taps)):
        acc = acc + taps[i] * xp[..., i:i + H, :]
    xp = torch.cat([acc[..., :1].expand(*acc.shape[:-1], r), acc,
                    acc[..., -1:].expand(*acc.shape[:-1], r)], dim=-1)
    out = taps[0] * xp[..., 0:W]
    for i in range(1, len(taps)):
        out = out + taps[i] * xp[..., i:i + W]
    return out


def gaussian_kernel(sigma: float, radius: int = None, device=None) -> torch.Tensor:
    """Normalized float32 Gaussian taps, computed in float64 and rounded once.

    The JAX XLA path computes these in float32 (at most one ulp apart); the
    Pallas kernel rounds from float64 as here. Plain version and CUDA kernel
    use the same taps."""
    return torch.tensor(gauss_taps(sigma, radius), dtype=torch.float32, device=device)


def harris_response(img: torch.Tensor, k: float = 0.04, sigma: float = 1.5) -> torch.Tensor:
    """Harris corner response on (..., H, W) float images in [0, 255]."""
    img = img.to(torch.float32)
    S = lambda dy, dx: _shift(img, dy, dx)  # noqa: E731
    # Scharr gradients (better rotational symmetry than Sobel)
    gx = (
        3.0 * (S(-1, -1) - S(-1, 1))
        + 10.0 * (S(0, -1) - S(0, 1))
        + 3.0 * (S(1, -1) - S(1, 1))
    ) / 32.0
    gy = (
        3.0 * (S(-1, -1) - S(1, -1))
        + 10.0 * (S(-1, 0) - S(1, 0))
        + 3.0 * (S(-1, 1) - S(1, 1))
    ) / 32.0
    taps = gauss_taps(sigma)
    Ixx = _sep_blur(gx * gx, taps)
    Iyy = _sep_blur(gy * gy, taps)
    Ixy = _sep_blur(gx * gy, taps)
    det = Ixx * Iyy - Ixy * Ixy
    tr = Ixx + Iyy
    return det - k * tr * tr


def nms(score: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Keep pixels that are the max of their (2r+1)² window (ties survive);
    the window is padded with -inf (reduce_window SAME semantics)."""
    shape = score.shape
    s4 = score.reshape(-1, 1, shape[-2], shape[-1])
    m = F.max_pool2d(s4, kernel_size=2 * radius + 1, stride=1, padding=radius).reshape(shape)
    return torch.where(score >= m, score, float("-inf"))


def harris_suppressed_plain(
    img: torch.Tensor, inb: torch.Tensor, k_harris: float = 0.04, nms_radius: int = 4,
    sigma: float = 1.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the Harris+NMS kernel: (raw, suppressed) of (..., H, W)."""
    raw = harris_response(img, k_harris, sigma)
    score = torch.where(inb > 0, raw, float("-inf"))
    return raw, nms(score, nms_radius)


def harris_suppressed(
    img: torch.Tensor, inb: torch.Tensor, k_harris: float = 0.04, nms_radius: int = 4,
    sigma: float = 1.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(raw, suppressed) of a (C, H, W) float32 batch: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if img.device.type == "cuda":
        from ..ops.detection_cuda import harris_suppressed_cuda

        return harris_suppressed_cuda(img, inb, k_harris, nms_radius, sigma)
    if img.device.type == "cpu":
        return harris_suppressed_plain(img, inb, k_harris, nms_radius, sigma)
    raise ValueError(f"harris_suppressed: unsupported device {img.device}")


def border_mask(H: int, W: int, border: int, device) -> torch.Tensor:
    """(H, W) bool, True at least `border` px inside the image."""
    ys = torch.arange(H, device=device)[:, None]
    xs = torch.arange(W, device=device)[None, :]
    return (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)


def select_keypoints(
    raw: torch.Tensor,  # (C, H, W) raw response
    sup: torch.Tensor,  # (C, H, W) suppressed score
    threshold: float,
    max_keypoints: int,
    nms_radius: int,
) -> Keypoints:
    """Top-K of the suppressed map with subpixel refinement on the raw map."""
    C, H, W = sup.shape
    dev = sup.device
    if nms_radius >= 3 and ((H + 3) // 4) * ((W + 3) // 4) >= max_keypoints:
        # NMS survivors are > nms_radius apart (Chebyshev), so a 4x4
        # non-overlapping max-pool keeps EVERY survivor and shrinks the top-k
        # input 16x
        cell = 4
        Hp = -(-H // cell) * cell
        Wp = -(-W // cell) * cell
        sp = F.pad(sup, (0, Wp - W, 0, Hp - H), value=float("-inf"))
        cell_max = sp.reshape(C, Hp // cell, cell, Wp // cell, cell).amax(dim=(2, 4))
        Wc = Wp // cell
        vals, cidx = torch.topk(cell_max.reshape(C, -1), max_keypoints, dim=1)
        cy = cidx // Wc
        cx = cidx % Wc
        # within-cell argmax via one flat gather (C, K, 16)
        dyx = (torch.arange(cell, device=dev)[:, None] * Wp
               + torch.arange(cell, device=dev)[None, :]).reshape(-1)
        base = (cy * cell) * Wp + cx * cell  # (C, K)
        idx = (base[:, :, None] + dyx).reshape(C, -1)
        patch = torch.gather(sp.reshape(C, -1), 1, idx).reshape(C, max_keypoints, cell * cell)
        sub = torch.argmax(patch, dim=-1)
        yy = (cy * cell + sub // cell).to(torch.float32)
        xx = (cx * cell + sub % cell).to(torch.float32)
    else:
        vals, idx = torch.topk(sup.reshape(C, -1), max_keypoints, dim=1)
        yy = (idx // W).to(torch.float32)
        xx = (idx % W).to(torch.float32)

    # subpixel quadratic refinement on the raw (un-masked) response: the
    # 5-point stencil of every keypoint in one flat gather (C, K, 5)
    yi = yy.to(torch.int64).clamp(1, H - 2)
    xi = xx.to(torch.int64).clamp(1, W - 2)
    base = yi * W + xi
    offs = torch.tensor([0, 1, -1, W, -W], dtype=torch.int64, device=dev)
    v = torch.gather(raw.reshape(C, -1), 1, (base[:, :, None] + offs).reshape(C, -1))
    c, vr, vl, vd, vu = v.reshape(C, max_keypoints, 5).unbind(-1)
    dx = 0.5 * (vr - vl)
    dy = 0.5 * (vd - vu)
    dxx = vr + vl - 2 * c
    dyy = vd + vu - 2 * c
    ox = torch.where(dxx.abs() > 1e-6, -dx / dxx, 0.0).clamp(-0.5, 0.5)
    oy = torch.where(dyy.abs() > 1e-6, -dy / dyy, 0.0).clamp(-0.5, 0.5)
    uv = torch.stack([xx + ox, yy + oy], dim=-1)
    mask = (vals > threshold) & torch.isfinite(vals)
    return Keypoints(uv=uv, score=vals, mask=mask)


def detect_keypoints(
    img: torch.Tensor,
    threshold: float = 30.0,
    max_keypoints: int = 400,
    nms_radius: int = 4,
    border: int = 20,
    mask: torch.Tensor = None,
) -> Keypoints:
    """Detect up to max_keypoints Harris corners per image, with subpixel
    refinement, on an (H, W) image or a (C, H, W) batch.

    `border` excludes the image rim where the descriptor pattern would leave
    the image; an optional (H, W) or (C, H, W) boolean `mask` suppresses
    detections outside it. The response+NMS stage runs on the CUDA kernel
    for CUDA images and on the plain version for CPU images."""
    single = img.dim() == 2
    images = (img[None] if single else img).to(torch.float32).contiguous()
    C, H, W = images.shape
    inb = border_mask(H, W, border, images.device).expand(C, H, W)
    if mask is not None:
        inb = inb & mask
    raw, sup = harris_suppressed(images, inb.to(torch.float32).contiguous(), nms_radius=nms_radius)
    kps = select_keypoints(raw, sup, threshold, max_keypoints, nms_radius)
    if single:
        return Keypoints(*(t[0] for t in kps))
    return kps


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x area downsample (average pooling) of (..., H, W): each output is
    ((a00 + a01) + a10) + a11, then / 4, the JAX package's reduction order."""
    H, W = img.shape[-2:]
    x = img[..., : H - H % 2, : W - W % 2]
    a00, a01 = x[..., 0::2, 0::2], x[..., 0::2, 1::2]
    a10, a11 = x[..., 1::2, 0::2], x[..., 1::2, 1::2]
    return (((a00 + a01) + a10) + a11) / 4.0


def _top_k_stable(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, ties in index
    order (jax.lax.top_k's rule), by a stable descending sort."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def detect_keypoints_pyramid(
    img: torch.Tensor,
    threshold: float = 30.0,
    max_keypoints: int = 400,
    nms_radius: int = 4,
    border: int = 20,
    octaves: int = 2,
    mask: torch.Tensor = None,
) -> Tuple[Keypoints, torch.Tensor]:
    """Scale-space detection over `octaves` + 1 pyramid levels of an (H, W)
    image or a (C, H, W) batch, with an optional (H, W) or (C, H, W) bool
    detection mask.

    Per level: Harris + NMS + per-level top-K (one Harris launch for the
    camera stack), the border halved per octave (at least 4 px) and the mask
    subsampled [::2, ::2]; coordinates are scaled back to the base image by
    uv 2^o + (2^o - 1)/2. A detection with a strictly stronger one within
    nms_radius base-image pixels at any level is dropped, and the strongest
    max_keypoints survive. Returns (Keypoints, sizes) with sizes 8 2^o."""
    single = img.dim() == 2
    images = (img[None] if single else img).to(torch.float32)
    C = images.shape[0]
    if mask is not None and mask.dim() == 2:
        mask = mask.expand(C, *mask.shape)
    levels, masks = [images], [mask]
    for _ in range(octaves):
        levels.append(_downsample2(levels[-1]))
        masks.append(None if masks[-1] is None else masks[-1][:, ::2, ::2])

    uvs, scores, valids, sizes = [], [], [], []
    for o, (im, m) in enumerate(zip(levels, masks)):
        kps = detect_keypoints(im, threshold=threshold, max_keypoints=max_keypoints,
                               nms_radius=nms_radius, border=max(4, border // (2 ** o)),
                               mask=None if m is None else m.contiguous())
        scale = float(2 ** o)
        uvs.append(kps.uv * scale + (scale - 1.0) / 2.0)
        scores.append(kps.score)
        valids.append(kps.mask)
        sizes.append(torch.full_like(kps.score, 8.0 * scale))
    uv = torch.cat(uvs, dim=1)  # (C, (o+1) K, 2)
    score = torch.cat(scores, dim=1)
    valid = torch.cat(valids, dim=1)
    size = torch.cat(sizes, dim=1)
    # cross-scale suppression: drop a detection with a strictly stronger one
    # within nms_radius (base-image pixels) at any level
    d2 = torch.sum((uv[:, :, None, :] - uv[:, None, :, :]) ** 2, dim=-1)
    neg_all = torch.where(valid, score, float("-inf"))
    stronger = (neg_all[:, None, :] > neg_all[:, :, None]) & (d2 < float(nms_radius) ** 2) & valid[:, None, :]
    valid = valid & ~torch.any(stronger, dim=2)
    # the global strongest max_keypoints
    vals, idx = _top_k_stable(torch.where(valid, score, float("-inf")), max_keypoints)
    kps = Keypoints(
        uv=torch.gather(uv, 1, idx[..., None].expand(C, max_keypoints, 2)),
        score=torch.gather(score, 1, idx),
        mask=torch.gather(valid, 1, idx) & torch.isfinite(vals),
    )
    size = torch.gather(size, 1, idx)
    if single:
        return Keypoints(*(t[0] for t in kps)), size[0]
    return kps, size
