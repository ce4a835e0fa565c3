"""Detection on the card (port of scripts/bench_detect.py).

A (480, 752) image of uniform noise (numpy seed 0) and a stereo pair (it
and it + 1): detect_keypoints on one image and on the pair (threshold 40,
400 keypoints), the Harris+NMS stage alone by the route the device picks
(the CUDA kernel for a CUDA image) against harris_suppressed_plain on the
same pair, and detect + describe of the pair in one call
(detect_and_describe_batch, gravity angles 0.1 and 0.2). Wall ms a call
(the card waited for) and summed kernel ms a call.

    python -m okvis_tpu_torch.bench.bench_detect [--reps 50] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from . import common


def run(reps: int = 50, device=None, verbose: bool = True) -> dict:
    from ..frontend.brisk import detect_and_describe_batch
    from ..frontend.detection import border_mask, detect_keypoints, harris_suppressed, harris_suppressed_plain

    dev = common.resolve_device(device)
    H, W = 480, 752
    img = torch.from_numpy(np.random.default_rng(0).uniform(0, 255, (H, W))).to(dev, torch.float32)
    imgs = torch.stack([img, img + 1.0]).contiguous()
    inb = border_mask(H, W, 20, dev).expand(2, H, W).to(torch.float32).contiguous()
    angles = torch.tensor([0.1, 0.2], device=dev)
    calls = {
        "detect_keypoints (1 image)": lambda: detect_keypoints(img, threshold=40.0, max_keypoints=400),
        "detect_keypoints (stereo pair)": lambda: detect_keypoints(imgs, threshold=40.0, max_keypoints=400),
        "harris+nms, the device's route (pair)": lambda: harris_suppressed(imgs, inb),
        "harris_suppressed_plain (pair)": lambda: harris_suppressed_plain(imgs, inb),
        "detect+describe (pair, one call)": lambda: detect_and_describe_batch(imgs, angles, threshold=40.0,
                                                                              max_keypoints=400),
    }
    rows = {}
    for name, fn in calls.items():
        fn()
        k = common.kernel_ms(fn, dev, 5)
        rows[name] = dict(wall_ms=common.wall_ms(fn, dev, reps), kernel_ms=None if k is None else k["kernel_ms"],
                          launches=None if k is None else k["launches"])
        if verbose:
            print(f"{name:40s} {rows[name]['wall_ms']:9.3f} ms wall  {rows[name]['kernel_ms']} ms kernels", flush=True)
    (raw_k, sup_k), (raw_p, sup_p) = harris_suppressed(imgs, inb), harris_suppressed_plain(imgs, inb)
    fin = torch.isfinite(sup_p)
    equal = bool(torch.equal(raw_k, raw_p) and torch.equal(torch.isfinite(sup_k), fin)
                 and torch.equal(sup_k[fin], sup_p[fin]))
    kps = detect_keypoints(img, threshold=40.0, max_keypoints=400)
    return dict(metric="detect_bench", device=common.device_name(dev), route="cuda kernel" if dev.type == "cuda"
                else "plain (CPU)", calls=rows, keypoints=int(kps.mask.sum()), route_equals_plain=equal)


def main(argv=None):
    ap = common.parser(__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    common.emit(run(args.reps, args.device), args.out)


if __name__ == "__main__":
    main()
