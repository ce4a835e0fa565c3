#!/usr/bin/env python3
"""Time Harris+NMS kernel sources against each other on one CUDA card, in
turns, at the shapes of the pyramid's octaves, and hold each to the plain
version over the whole image.

    python3 scripts/torch_harris_compare.py OLD.cu NEW.cu [...]

Each source is a complete csrc/harris_nms.cu (for an earlier commit's:
`git show <commit>:okvis_tpu_torch/csrc/harris_nms.cu > build/old.cu`),
built by nvcc for sm_90a into its own library under build/ and launched
through its C entry point. The shapes are a 2 x 480 x 752 multiframe and
its two octaves, with chip_smoke.py's modes-phase mask (the left 64 columns
and the bottom 48 rows blanked, subsampled) and the octave's border, then
odd shapes for the equality check alone. Times are CUDA-event medians of 21
rounds of 10 back-to-back launches behind a sleep kernel, taken in the
order given and then in reverse. Prints one JSON line with the card.
"""

import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from okvis_tpu_torch.frontend import detection  # noqa: E402
from okvis_tpu_torch.ops import cuda_lib  # noqa: E402
from okvis_tpu_torch.ops.detection_cuda import gauss_taps  # noqa: E402

BUILD = os.path.join(os.path.dirname(__file__), "..", "build", "harris_compare")
ODD_SHAPES = ((1, 96, 128, 20), (1, 37, 41, 10), (2, 481, 753, 20), (3, 61, 83, 20), (1, 446, 300, 5))


def build(sources):
    """One library a source, the nvcc processes started together."""
    os.makedirs(BUILD, exist_ok=True)
    nvcc = cuda_lib.find_nvcc()
    outs = [os.path.join(BUILD, f"{i}_{os.path.basename(src)}.so") for i, src in enumerate(sources)]
    procs = [subprocess.Popen([nvcc, *cuda_lib.COMPILE_FLAGS, "-shared", src, "-o", out],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, out in zip(sources, outs)]
    libs = []
    for src, out, proc in zip(sources, outs, procs):
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed on {src}:\n{log}")
        lib = ctypes.CDLL(out)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.okvis_harris_nms.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, ptr, i32, i32, f32, ptr]
        libs.append(lib)
    return libs


def launch(lib, img, inb, taps):
    raw, sup = torch.empty_like(img), torch.empty_like(img)
    C, H, W = img.shape
    err = lib.okvis_harris_nms(img.data_ptr(), inb.data_ptr(), raw.data_ptr(), sup.data_ptr(), C, H, W,
                               ctypes.cast(taps, ctypes.c_void_p), 5, 4, 0.04, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"harris_nms launch: CUDA error {err}")
    return raw, sup


def device_us(fn, reps: int = 21, inner: int = 10) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(1e3 * start.elapsed_time(end) / inner)
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_harris_compare: no CUDA device")
    sources = sys.argv[1:]
    libs = build(sources)
    taps_t = gauss_taps(1.5)
    taps = (ctypes.c_float * len(taps_t))(*taps_t)
    rng = np.random.default_rng(0)
    timed, odd = [], []
    for o in range(3):
        H, W = 480 >> o, 752 >> o
        img = torch.from_numpy(rng.uniform(0, 255, (2, H, W)).astype(np.float32)).cuda()
        mask = torch.ones(2, 480, 752, dtype=torch.bool, device="cuda")
        mask[:, :, :64] = False
        mask[:, -48:] = False
        mask = mask[:, :: 1 << o, :: 1 << o]
        inb = (detection.border_mask(H, W, max(4, 20 >> o), "cuda") & mask).float().contiguous()
        timed.append((f"2x{H}x{W}", img, inb))
    for C, H, W, border in ODD_SHAPES:
        img = torch.from_numpy(rng.uniform(0, 255, (C, H, W)).astype(np.float32)).cuda()
        odd.append((f"{C}x{H}x{W}", img, detection.border_mask(H, W, border, "cuda").expand(C, H, W).float()
                    .contiguous()))
    us = {src: {name: [] for name, _, _ in timed} for src in sources}
    equal = {src: {} for src in sources}
    for i in list(range(len(sources))) + list(reversed(range(len(sources)))):
        for name, img, inb in timed:
            us[sources[i]][name].append(device_us(lambda: launch(libs[i], img, inb, taps)))
    for src, lib in zip(sources, libs):
        for name, img, inb in timed + odd:
            raw_k, sup_k = launch(lib, img, inb, taps)
            raw_p, sup_p = detection.harris_suppressed_plain(img, inb)
            torch.cuda.synchronize()
            equal[src][name] = bool(torch.equal(raw_k, raw_p) and torch.equal(torch.isfinite(sup_k), torch.isfinite(sup_p)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(card=smi, order="as given, then reversed", us=us, whole_image_equal=equal)), flush=True)


if __name__ == "__main__":
    main()
