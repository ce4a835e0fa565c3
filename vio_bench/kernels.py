"""The card's peaks and the two hand kernels' operations and bytes, for
their roofline shares (copied from chip_smoke.py's kernels line).

A kernel's bound is the larger of its bytes over the memory rate and its
operations over the fastest route the card offers; its roofline share is
the bound over its measured time. Bytes count each input read once and
each output written once.
"""

from __future__ import annotations

H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA data sheet (SXM)
# Operations a second by class, without FMA. The data sheet's 67 TFLOP/s in
# float32 counts an FMA as two: 128 lanes an SM and clock. Per SM and clock
# the CUDA C++ Programming Guide's throughput table (compute capability 9.0)
# gives 128 float32 adds or multiplies, 64 integer adds, XORs, compares and
# maxima, 16 population counts. An SM issues at most 128 thread instructions
# a clock, whatever their class. The tensor cores' dense int8 rate is the
# data sheet's 1,979 TOP/s.
H100_OPS_PER_S = {
    "issue": 67e12 / 2,
    "f32": 67e12 / 2,
    "alu": 67e12 / 2 * 64 / 128,
    "popc": 67e12 / 2 * 16 / 128,
    "int8_mma": 1979e12,
}
# Harris + NMS per pixel: Scharr 18, products 3, blur 2 x 63, score 7 (f32);
# mask 1, 9 x 9 window max 16, suppression 1 (alu). Bytes: the image and the
# border mask in, the raw and suppressed scores out, 4 bytes each.
HARRIS_OPS_PER_PIXEL = {"f32": 154, "alu": 18}
HARRIS_BYTES_PER_PIXEL = 16
# Two routes to one 512-bit Hamming distance: 16 words of xor, popcount and
# add on the CUDA cores, or 512 +-1 int8 multiply-adds on the tensor cores
HAMMING_ROUTES = ({"alu": 2 * 16, "popc": 16}, {"int8_mma": 2 * 512})


def route_seconds(ops: dict) -> float:
    """One route's operations over their rates: each class alone, and the
    CUDA cores' classes together over the issue rate."""
    core = sum(n for c, n in ops.items() if c != "int8_mma")
    return max([core / H100_OPS_PER_S["issue"]] + [n / H100_OPS_PER_S[c] for c, n in ops.items()])


def bound_seconds(n_bytes: float, *routes: dict) -> float:
    return max(n_bytes / H100_BYTES_PER_S, min(route_seconds(r) for r in routes))


def harris_bound_s(c: int, h: int, w: int) -> float:
    px = c * h * w
    return bound_seconds(HARRIS_BYTES_PER_PIXEL * px, {k: n * px for k, n in HARRIS_OPS_PER_PIXEL.items()})


def hamming_bound_s(g: int, na: int, nb: int, input_bytes: int) -> float:
    """(g, na, nb) int32 distances from inputs of `input_bytes`."""
    out = g * na * nb
    return bound_seconds(input_bytes + 4 * out, *({k: n * out for k, n in r.items()} for r in HAMMING_ROUTES))
