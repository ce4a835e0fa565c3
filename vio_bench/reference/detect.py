"""Harris keypoints and gravity-aligned BRISK descriptors, in plain torch.

The same semantics as the port's frontend (a copy of the plain arithmetic
of `okvis_tpu_torch/frontend/detection.py` and `brisk.py`, written anew):
a Scharr gradient, an 11-tap Gaussian window (sigma 1.5) with edge padding,
the Harris score det - 0.04 tr^2, a 9 x 9 non-maximum suppression, the
strongest `max_keypoints` above the threshold at least 20 px inside the
image, each refined by a quadratic on the raw score; then a 60-point
pattern on 5 rings, each point smoothed at its ring's sigma by a banded
Toeplitz matmul, rotated by the angle of gravity in the image, 512 pair
comparisons packed into 16 int32 words.

The top-K takes the whole suppressed map (the port pools 4 x 4 cells
first, which keeps every survivor). The blur is the matmul whose precision
the control lowers: `describe` runs on any device under the caller's TF32
setting.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

BITS = 512
WORDS = 16


def gauss_taps(sigma: float) -> np.ndarray:
    radius = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur_edge(img: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Separable blur of (C, H, W), rows then columns, edge padded; each pass
    a left-to-right sum of tap x shifted copy."""
    r = (len(taps) - 1) // 2
    H, W = img.shape[-2:]
    xp = F.pad(img[:, None], (0, 0, r, r), mode="replicate")[:, 0]
    acc = float(taps[0]) * xp[:, 0:H]
    for i in range(1, len(taps)):
        acc = acc + float(taps[i]) * xp[:, i:i + H]
    xp = F.pad(acc[:, None], (r, r, 0, 0), mode="replicate")[:, 0]
    out = float(taps[0]) * xp[..., 0:W]
    for i in range(1, len(taps)):
        out = out + float(taps[i]) * xp[..., i:i + W]
    return out


def harris(img: torch.Tensor, border: int = 20) -> tuple:
    """(raw score, suppressed score) of (C, H, W) images, in their dtype: -inf
    outside the border and wherever a 9 x 9 neighbour is larger."""
    S = lambda dy, dx: torch.roll(img, (dy, dx), dims=(-2, -1))  # noqa: E731  out[y, x] = img[y - dy, x - dx]
    gx = (3.0 * (S(-1, -1) - S(-1, 1)) + 10.0 * (S(0, -1) - S(0, 1)) + 3.0 * (S(1, -1) - S(1, 1))) / 32.0
    gy = (3.0 * (S(-1, -1) - S(1, -1)) + 10.0 * (S(-1, 0) - S(1, 0)) + 3.0 * (S(-1, 1) - S(1, 1))) / 32.0
    taps = gauss_taps(1.5)
    ixx, iyy, ixy = _blur_edge(gx * gx, taps), _blur_edge(gy * gy, taps), _blur_edge(gx * gy, taps)
    tr = ixx + iyy
    raw = (ixx * iyy - ixy * ixy) - 0.04 * tr * tr
    C, H, W = img.shape
    ys = torch.arange(H)[:, None]
    xs = torch.arange(W)[None, :]
    inside = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    score = torch.where(inside, raw, float("-inf"))
    peak = F.max_pool2d(score[:, None], 9, stride=1, padding=4)[:, 0]
    return raw, torch.where(score >= peak, score, float("-inf"))


def keypoints(img: torch.Tensor, threshold: float, max_keypoints: int, dtype=torch.float32) -> list:
    """Per image of (C, H, W): the (n, 2) float32 (x, y) of its keypoints,
    the arithmetic in `dtype` (float32; bfloat16 is the control's)."""
    raw, sup = harris(img.to(dtype))
    C, H, W = img.shape
    out = []
    for c in range(C):
        vals, idx = torch.topk(sup[c].reshape(-1), max_keypoints)
        y, x = idx // W, idx % W
        yi, xi = y.clamp(1, H - 2), x.clamp(1, W - 2)
        r = raw[c]
        cen, vr, vl, vd, vu = r[yi, xi], r[yi, xi + 1], r[yi, xi - 1], r[yi + 1, xi], r[yi - 1, xi]
        dxx, dyy = vr + vl - 2 * cen, vd + vu - 2 * cen
        ox = torch.where(dxx.abs() > 1e-6, -(0.5 * (vr - vl)) / dxx, 0.0).clamp(-0.5, 0.5)
        oy = torch.where(dyy.abs() > 1e-6, -(0.5 * (vd - vu)) / dyy, 0.0).clamp(-0.5, 0.5)
        keep = (vals > threshold) & torch.isfinite(vals)
        out.append(torch.stack([x.float() + ox.float(), y.float() + oy.float()], -1)[keep])
    return out


@functools.lru_cache(maxsize=1)
def pattern() -> tuple:
    """(points (60, 2), point sigma (60,), pair i (512,), pair j (512,)):
    the centre and rings of (radius, count, sigma) (2.9, 10, 0.8), (4.9, 14,
    1.1), (7.4, 15, 1.6), (10.8, 20, 2.3), every ring turned by half a step,
    and the 512 shortest point pairs (ties in index order)."""
    rings = [(0.0, 1, 0.7), (2.9, 10, 0.8), (4.9, 14, 1.1), (7.4, 15, 1.6), (10.8, 20, 2.3)]
    pts, sig = [], []
    for r, n, s in rings:
        for k in range(n):
            a = 2 * np.pi * k / n + (0.5 if r > 0 else 0.0) * np.pi / n
            pts.append([r * np.cos(a), r * np.sin(a)])
            sig.append(s)
    pts, sig = np.asarray(pts, np.float32), np.asarray(sig, np.float32)
    ii, jj = np.triu_indices(len(pts), k=1)
    order = np.argsort(np.linalg.norm(pts[ii] - pts[jj], axis=1), kind="stable")[:BITS]
    return pts, sig, ii[order], jj[order]


@functools.lru_cache(maxsize=4)
def toeplitz(n: int) -> np.ndarray:
    """(L, n, n): per distinct sigma, out[w] = sum_t k[t] img[clamp(w + t - r)]
    as a matrix (column w)."""
    sig = np.unique(pattern()[1])
    out = np.zeros((len(sig), n, n), np.float32)
    w = np.arange(n)
    for lvl, s in enumerate(sig):
        r = max(1, int(3.0 * s + 0.5))
        x = np.arange(-r, r + 1, dtype=np.float64)
        k = np.exp(-0.5 * (x / s) ** 2)
        k = (k / k.sum()).astype(np.float32)
        for t in range(2 * r + 1):
            np.add.at(out[lvl], (np.clip(w + t - r, 0, n - 1), w), k[t])
    return out


def describe(img: torch.Tensor, uv: torch.Tensor, angle: float) -> torch.Tensor:
    """(n, 16) int32 descriptors of one (H, W) image at keypoints `uv` (n, 2),
    the pattern turned by `angle` (float32 radians); computed on img's
    device."""
    dev = img.device
    H, W = img.shape
    pts, sig, pi, pj = pattern()
    level = np.searchsorted(np.unique(sig), sig)
    Tw = torch.from_numpy(toeplitz(W)).to(dev)
    Th = torch.from_numpy(toeplitz(H)).to(dev)
    rows = torch.matmul(img.float()[None], Tw)  # (L, H, W): every row blurred
    levels = torch.matmul(Th.transpose(1, 2), rows)  # (L, H, W): then every column
    a = torch.tensor(angle, dtype=torch.float32, device=dev)
    ca, sa = torch.cos(a), torch.sin(a)
    p = torch.from_numpy(pts).to(dev)
    px, py = ca * p[:, 0] - sa * p[:, 1], sa * p[:, 0] + ca * p[:, 1]
    uv = uv.to(dev)
    xs, ys = uv[:, 0:1] + px[None], uv[:, 1:2] + py[None]  # (n, 60)
    x0 = torch.floor(xs).long().clamp(0, W - 2)
    y0 = torch.floor(ys).long().clamp(0, H - 2)
    fx, fy = (xs - x0).clamp(0.0, 1.0), (ys - y0).clamp(0.0, 1.0)
    lv = torch.from_numpy(level).to(dev)[None].expand_as(x0)
    g = lambda dy, dx: levels[lv, y0 + dy, x0 + dx]  # noqa: E731
    s = g(0, 0) * (1 - fx) * (1 - fy) + g(0, 1) * fx * (1 - fy) + g(1, 0) * (1 - fx) * fy + g(1, 1) * fx * fy
    bits = (s[:, torch.from_numpy(pi).long().to(dev)] < s[:, torch.from_numpy(pj).long().to(dev)]).cpu()
    words = (bits.reshape(-1, WORDS, 32).long() << torch.arange(32)).sum(-1)
    return (words - ((words >> 31) << 32)).to(torch.int32)


def gravity_angles(q_WS: np.ndarray, T_SC: np.ndarray) -> np.ndarray:
    """Per camera, the angle of gravity projected into the image, float32,
    from the body orientation (x, y, z, w) and the rig's (C, 4, 4) T_SC."""
    x, y, z, w = q_WS
    R_WS = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    out = []
    for T in T_SC:
        g_C = (R_WS @ T[:3, :3]).T @ np.array([0.0, 0.0, -1.0])
        out.append(np.float32(np.arctan2(g_C[1], g_C[0])))
    return np.asarray(out, np.float32)
