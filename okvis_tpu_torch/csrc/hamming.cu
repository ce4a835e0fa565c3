// Masked, batched Hamming distance matrices of packed 512-bit descriptors,
// on the tensor cores.
//
// Replaces the TPU kernel okvis_tpu/ops/hamming_pallas.py::hamming_matrix_pallas
// (body _hamming_kernel), and with it okvis_tpu/ops/hamming.py::
// masked_distance_matrix under jax.vmap: out[g][i][j] is the sum over the 16
// words of popcount(a[g][i][w] XOR b[g][j][w]), int32, or MAX_DIST (10,000)
// wherever mask_a[g][i] & mask_b[g][j] is false. Descriptors arrive as int32
// bit patterns and are read as uint32, masks as one byte each (torch.bool).
// A, B and either mask may have a batch of 1, read with a batch stride of 0.
//
// What bounds it on the H100: the int32 output write. On the tensor cores the
// 512 one-bit products an output needs are far cheaper than its 4 bytes:
// 400 x 400 x 512 int8 multiply-adds take 0.08 us at 1,979 TOP/s, while the
// 0.64 MB write and 51 KB of descriptors take 0.21 us at 3.35 TB/s; 1.60 us
// at 400 x 3200 and at (8, 400, 400). A popcount design (16 a clock an SM)
// could not go below 0.61 us and 4.89 us there. At the stereo shape the
// launch itself is the larger share.
//
// Design: popc(a XOR b) from the b1 tensor-core product, mma.sync
// m16n8k256 .and.popc, on the packed words as they are: popc(a XOR b) =
// popc(a AND NOT b) + popc(NOT a AND b), two products a k-step of 256 bits
// and two k-steps a descriptor. (The .xor.popc form, one product, is not
// used: the PTX ISA may refuse it for sm_90a.) Only packed words cross
// memory, 64 B a descriptor, and nothing is expanded: a lane's fragment
// registers are the words themselves. A lane holds words 4q..4q+3 (one
// 16-byte load) of each of its fragment rows; A and B map every bit to the
// same k, so the sum is exact. A warp computes a 16 x 32 output tile from
// registers alone (no barrier; the 4 warps of a block share nothing but the
// L1), and a block 32 x 64: 91 blocks at 400 x 400, 650 at 400 x 3200, 728
// at (8, 400, 400). Masks: a row masked out, or past NA or NB, adds kInvalid
// to its distances and one min turns them into MAX_DIST in registers; a lane
// gets its two columns' flags with two shuffles. Epilogue: the warp's tile
// goes through shared memory (padded rows, conflict-free 8-byte writes) and
// out as 16-byte row stores, 4 full 128-byte lines a warp store; where NB is
// not a multiple of 4 the stores are scalar. One launch covers the whole
// (G, NA, NB) batch, blockIdx.z being the batch; ragged NA and NB are masked
// here, the caller pads nothing. Offsets are 32-bit: the wrapper rejects
// G*NA*NB, G*NA*16 or G*NB*16 of 2^31 or more. PERF.md ranks the designs
// measured against this one (the ±1 s8 m16n8k32 form, one AND product with
// the rows' popcounts, direct stores from the fragments, other tiles).
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxDist = 10000;  // MAX_DIST of okvis_tpu/ops/hamming.py
constexpr int kInvalid = 1 << 20;  // added to the distances of a masked-out row
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTiles = 4;                // m16n8 tiles of a warp, side by side: 16 x 32
constexpr int kWarpCols = 8 * kTiles;    // 32
constexpr int kBlockRows = 2 * 16;       // 2 x 2 warps a block: 32 x 64
constexpr int kBlockCols = 2 * kWarpCols;
constexpr int kThreads = 4 * 32;
constexpr int kStride = kWarpCols + 8;   // staged row, padded: conflict-free 8-byte writes

struct Args {
  const uint4* a;         // (Ga, na, 16) words: a row is 4 uint4
  const uint4* b;         // (Gb, nb, 16)
  const uint8_t* mask_a;  // (Gma, na) or null: every row valid
  const uint8_t* mask_b;  // (Gmb, nb) or null
  int32_t* out;           // (g, na, nb)
  int g, na, nb;
  int a_batch, b_batch, ma_batch, mb_batch;  // rows a batch: n, or 0 to broadcast
};

__device__ __forceinline__ uint32_t word(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// D += popc(A AND B) over 16 x 8 x 256 bits (mma.m16n8k256 b1 fragments)
__device__ __forceinline__ void mma_b1(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A lane's part of one descriptor row: words 4q..4q+3, and kInvalid for a
// row masked out or past n (never stored), else 0. Loads only; nothing waits
// for them here.
struct Row {
  uint4 w;
  int term;
};

__device__ __forceinline__ Row fetch_row(const uint4* rows, const uint8_t* mask, int r, int n,
                                         int q) {
  Row x{make_uint4(0u, 0u, 0u, 0u), kInvalid};
  if (r < n) {
    x.w = __ldg(rows + r * 4 + q);
    x.term = (mask && !mask[r]) ? kInvalid : 0;
  }
  return x;
}

__global__ void __launch_bounds__(kThreads) hamming_kernel(const Args p) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;  // fragment row (A) or column (B) within 8
  const int q = lane & 3;     // the lane's quarter of a row: words 4q..4q+3
  const int g = blockIdx.z;
  const int row0 = blockIdx.y * kBlockRows + (warp >> 1) * 16;
  const int col0 = blockIdx.x * kBlockCols + (warp & 1) * kWarpCols;
  if (row0 >= p.na || col0 >= p.nb) return;  // uniform over the warp

  const uint4* a = p.a + g * p.a_batch * 4;
  const uint4* b = p.b + g * p.b_batch * 4;
  const uint8_t* ma = p.mask_a ? p.mask_a + g * p.ma_batch : nullptr;
  const uint8_t* mb = p.mask_b ? p.mask_b + g * p.mb_batch : nullptr;
  Row ra[2], rb[kTiles];
#pragma unroll
  for (int h = 0; h < 2; ++h) ra[h] = fetch_row(a, ma, row0 + 8 * h + gid, p.na, q);
#pragma unroll
  for (int j = 0; j < kTiles; ++j) rb[j] = fetch_row(b, mb, col0 + 8 * j + gid, p.nb, q);

  int acc[kTiles][4] = {};
  // k-step s: the fragment halves take words 4q + 2s and 4q + 2s + 1
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const uint32_t a0 = word(ra[0].w, 2 * s), a1 = word(ra[1].w, 2 * s);
    const uint32_t a2 = word(ra[0].w, 2 * s + 1), a3 = word(ra[1].w, 2 * s + 1);
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      const uint32_t b0 = word(rb[j].w, 2 * s), b1 = word(rb[j].w, 2 * s + 1);
      mma_b1(acc[j], a0, a1, a2, a3, ~b0, ~b1);
      mma_b1(acc[j], ~a0, ~a1, ~a2, ~a3, b0, b1);
    }
  }

  // Epilogue. Accumulator e of m16n8 tile j sits at row 8(e/2) + gid, column
  // 8j + 2q + e%2; the terms of those two columns are held by the lanes of
  // rows gid = 2q and 2q + 1 of B. A distance with a kInvalid term is far
  // above MAX_DIST, so one min masks it. The warp's tile goes through shared
  // memory, then out as 16-byte row stores.
  __shared__ __align__(16) int stage[kThreads / 32][16][kStride];
  auto& t = stage[warp];
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    const int tb0 = __shfl_sync(kFull, rb[j].term, 8 * q);
    const int tb1 = __shfl_sync(kFull, rb[j].term, 8 * q + 4);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<int2*>(&t[8 * h + gid][8 * j + 2 * q]) =
          make_int2(min(acc[j][2 * h] + ra[h].term + tb0, kMaxDist),
                    min(acc[j][2 * h + 1] + ra[h].term + tb1, kMaxDist));
  }
  __syncwarp();
  int32_t* out = p.out + g * p.na * p.nb;
  const bool quads = (p.nb & 3) == 0;  // every (row, 4k column) is 16-byte aligned
#pragma unroll
  for (int k = lane; k < 16 * kWarpCols / 4; k += 32) {
    const int lr = k / (kWarpCols / 4), lc = 4 * (k % (kWarpCols / 4));
    const int r = row0 + lr, c = col0 + lc;
    if (r >= p.na) continue;
    int32_t* o = out + r * p.nb + c;
    const int4 v = *reinterpret_cast<const int4*>(&t[lr][lc]);
    if (quads && c + 3 < p.nb) {
      *reinterpret_cast<int4*>(o) = v;
    } else {
      if (c < p.nb) o[0] = v.x;
      if (c + 1 < p.nb) o[1] = v.y;
      if (c + 2 < p.nb) o[2] = v.z;
      if (c + 3 < p.nb) o[3] = v.w;
    }
  }
}

}  // namespace

// a: (Ga, na, 16) int32, b: (Gb, nb, 16) int32, mask_a: (Gma, na) and
// mask_b: (Gmb, nb) bytes or null, out: (g, na, nb) int32, all contiguous on
// the current device. *_batch: rows between batches, 0 where that input has
// a batch of 1. stream: the caller's cudaStream_t. The output tile is 32
// rows: at most 65535 x 32 rows in A, and g at most 65535.
extern "C" int okvis_hamming_matrix(const void* a, const void* b, const void* mask_a,
                                    const void* mask_b, void* out, int g, int na, int nb,
                                    int a_batch, int b_batch, int ma_batch, int mb_batch,
                                    void* stream) {
  const Args p{static_cast<const uint4*>(a), static_cast<const uint4*>(b),
               static_cast<const uint8_t*>(mask_a), static_cast<const uint8_t*>(mask_b),
               static_cast<int32_t*>(out), g, na, nb, a_batch, b_batch, ma_batch, mb_batch};
  const dim3 grid((nb + kBlockCols - 1) / kBlockCols, (na + kBlockRows - 1) / kBlockRows, g);
  hamming_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
