"""Hamming-distance descriptor matching (port of okvis_tpu.ops.hamming).

Descriptors are 512-bit strings packed into 16 words. Inside the port they
are carried as int32 tensors holding the uint32 bit patterns (torch's uint32
support on CUDA is partial); ``.view`` converts at the numpy boundary.

Two forms of the distance matrix, which give the same integers:

1. XOR + popcount on the packed words: ``hamming_matrix_plain`` in torch ops,
   the plain version the CPU runs. On CUDA tensors ``masked_distance_matrix``
   and ``hamming_matrix`` launch the hand-written kernel instead
   (``ops/hamming_cuda.py``, ``csrc/hamming.cu``), which takes the same
   popcounts from the tensor cores' one-bit AND+popc product.
2. ``hamming_matrix_mxu``: each descriptor becomes a ±1 vector v and
   popcount(a XOR b) = (512 - v_a·v_b)/2, one matmul. The JAX package's
   TPU default (it suits the matrix unit); here a plain version, exact in
   float32 because every partial sum is an integer below 2^24.

The JAX package's ``use_mxu`` switch is dropped: the device of the tensors
picks the route, so the port has no option the JAX main path lacks.
Masked entries of ``masked_distance_matrix`` are MAX_DIST. It takes a
leading batch (the JAX package's ``jax.vmap`` of it), in which a batch of 1
broadcasts, and makes one kernel launch on the card whatever the batch.
"""

from __future__ import annotations

import torch

DESCRIPTOR_BITS = 512
DESCRIPTOR_WORDS = DESCRIPTOR_BITS // 32
MAX_DIST = 10_000


def unpack_to_pm1(packed: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(N, W) int32 packed bits -> (N, W*32) ±1 vectors."""
    n, w = packed.shape
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1  # arithmetic shift; & 1 keeps bit 31 right
    return bits.reshape(n, w * 32).to(dtype) * 2.0 - 1.0


def hamming_matrix_mxu(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Full Hamming distance matrix as one ±1 float32 matmul: (NA, NB) int32."""
    bits = desc_a.shape[1] * 32
    dots = unpack_to_pm1(desc_a) @ unpack_to_pm1(desc_b).T
    return ((bits - dots) * 0.5).to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 bit patterns (SWAR bit counting in
    int64, so no step overflows or shifts in a sign bit)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_matrix_plain(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """XOR+popcount in torch ops — the counterpart of the JAX
    ``hamming_matrix_xla``: (..., NA, NB) int32 from (..., NA, 16) and
    (..., NB, 16) descriptors, leading batches broadcast."""
    x = desc_a[..., :, None, :] ^ desc_b[..., None, :, :]  # (..., NA, NB, W)
    return popcount32(x).sum(dim=-1).to(torch.int32)


def masked_distance_matrix_plain(desc_a, desc_b, mask_a=None, mask_b=None) -> torch.Tensor:
    """The plain version of the CUDA kernel: ``hamming_matrix_plain`` with
    MAX_DIST wherever mask_a[..., i] & mask_b[..., j] is false (None: all
    true)."""
    d = hamming_matrix_plain(desc_a, desc_b)
    valid = torch.ones((), dtype=torch.bool, device=d.device)
    if mask_a is not None:
        valid = valid & mask_a[..., :, None]
    if mask_b is not None:
        valid = valid & mask_b[..., None, :]
    return torch.where(valid, d, MAX_DIST)


def masked_distance_matrix(
    desc_a: torch.Tensor,
    desc_b: torch.Tensor,
    mask_a: torch.Tensor | None = None,
    mask_b: torch.Tensor | None = None,
) -> torch.Tensor:
    """Distance matrix with invalid rows/cols set to MAX_DIST: (NA, NB) from
    (NA, 16) descriptors and (NA,) masks, or (G, NA, NB) from (G, NA, 16) and
    (G, NA) (a batch of 1 broadcasts). One kernel launch for CUDA tensors,
    the plain version for CPU tensors. The inputs must be contiguous on
    either device, since the kernel reads its rows at fixed strides: a CPU
    run then refuses what the card would refuse."""
    for name, t in (("desc_a", desc_a), ("desc_b", desc_b), ("mask_a", mask_a), ("mask_b", mask_b)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"masked_distance_matrix: {name} must be contiguous")
    if desc_a.device.type == "cuda":
        from .hamming_cuda import hamming_matrix_cuda

        return hamming_matrix_cuda(desc_a, desc_b, mask_a, mask_b)
    if desc_a.device.type == "cpu":
        return masked_distance_matrix_plain(desc_a, desc_b, mask_a, mask_b)
    raise ValueError(f"masked_distance_matrix: unsupported device {desc_a.device}")


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(NA, NB) int32 Hamming distances, no mask: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    return masked_distance_matrix(desc_a, desc_b)


def mutual_best_assignment(
    dist: torch.Tensor,
    threshold: int,
    rounds: int = 3,
    distance_ratio: float = 0.0,
) -> torch.Tensor:
    """One-to-one assignment from a distance matrix by iterative mutual best
    ("auction"): each round every unmatched A proposes its best remaining B,
    and each B accepts its best proposer; ties break to the lowest index, as
    ``argmin`` does. If distance_ratio > 0, Lowe's ratio test best /
    second-best gates the proposals.

    dist is (..., NA, NB): leading dims are independent problems, solved in
    one batch (the JAX package's ``jax.vmap`` of it). Returns (..., NA)
    int64: matched B index per A, -1 if unmatched."""
    *lead, NA, NB = dist.shape
    big = MAX_DIST
    dev = dist.device
    d = dist.reshape(-1, NA, NB)
    G = d.shape[0]
    if distance_ratio > 0:
        top2 = torch.topk(d, 2, dim=2, largest=False).values  # (G, NA, 2) two smallest
        ratio_ok = top2[..., 0].to(torch.float32) < distance_ratio * top2[..., 1].to(torch.float32)
    else:
        ratio_ok = torch.ones((G, NA), dtype=torch.bool, device=dev)

    rows = torch.arange(NA, device=dev)
    # flat offsets of each problem's rows and columns for the OR-scatters
    off_a = torch.arange(G, device=dev)[:, None] * NA
    off_b = torch.arange(G, device=dev)[:, None] * NB
    match_a = torch.full((G, NA), -1, dtype=torch.int64, device=dev)
    taken_b = torch.zeros((G, NB), dtype=torch.bool, device=dev)
    for _ in range(rounds):
        best_b = torch.argmin(d, dim=2)  # (G, NA) first index on ties
        best_d = torch.gather(d, 2, best_b[..., None])[..., 0]
        want = (match_a < 0) & (best_d < threshold) & ratio_ok
        # B chooses its best proposer: every A's proposal sits in its best
        # B's column, everything else is big
        prop_d = torch.where(want, best_d, big)
        prop_to_b = torch.full((G, NA, NB), big, dtype=dist.dtype, device=dev)
        prop_to_b.scatter_(2, best_b[..., None], prop_d[..., None])
        min_per_b = torch.amin(prop_to_b, dim=1)  # (G, NB)
        winner_a = torch.argmin(prop_to_b, dim=1)  # (G, NB)
        b_accepts = (min_per_b < big) & ~taken_b
        # additive int32 scatters (order-free): duplicate indices must OR,
        # not overwrite
        a_wins = torch.zeros(G * NA, dtype=torch.int32, device=dev).index_add_(
            0, (winner_a + off_a).reshape(-1), b_accepts.to(torch.int32).reshape(-1)).view(G, NA) > 0
        a_wins = a_wins & want & (torch.gather(winner_a, 1, best_b) == rows)
        match_a = torch.where(a_wins, best_b, match_a)
        taken_b = taken_b | (torch.zeros(G * NB, dtype=torch.int32, device=dev).index_add_(
            0, (best_b + off_b).reshape(-1), a_wins.to(torch.int32).reshape(-1)).view(G, NB) > 0)
        # matched rows/cols leave the market
        d = torch.where(a_wins[:, :, None] | taken_b[:, None, :], big, d)
    return match_a.reshape(*lead, NA)


def match_descriptors(desc_a, desc_b, mask_a, mask_b, threshold: int = 60, rounds: int = 3
                      ) -> torch.Tensor:
    """Distance matrix + one-to-one assignment, over the same leading batch
    as masked_distance_matrix. threshold=60 is the reference's BRISK
    matching threshold."""
    d = masked_distance_matrix(desc_a, desc_b, mask_a, mask_b)
    return mutual_best_assignment(d, threshold, rounds=rounds)
