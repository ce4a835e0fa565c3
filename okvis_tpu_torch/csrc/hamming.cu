// Hamming distance matrix of packed 512-bit descriptors by XOR + popcount.
//
// Replaces the TPU kernel okvis_tpu/ops/hamming_pallas.py::hamming_matrix_pallas
// (body _hamming_kernel). out[i][j] = sum over the 16 words of
// popcount(a[i][w] XOR b[j][w]), int32. Descriptors arrive as int32 bit
// patterns and are read as uint32.
//
// What bounds it on the H100: the population count. Each output element
// needs 16 popcounts, and an SM retires 16 a clock against 64 integer XORs
// or adds and 128 float32 operations (CUDA C++ Programming Guide, throughput
// of arithmetic instructions, compute capability 9.0): about 4.2 T popcounts
// a second on the card. At the main path's 400 x 400 that is 0.61 us against
// 0.21 us for the bytes (a 0.64 MB int32 output write and 51 KB of input);
// at 400 x 3200, 4.9 us against 1.6 us. The bytes never bound it: each
// 4-byte output costs 16 popcounts, which take longer than its write. At the
// stereo shape the launch itself is the larger share.
//
// Design: one thread per output element in 16 x 16 tiles. The block stages
// its 16 A rows and 16 B rows (16 words each) in shared memory, padded to a
// stride of 17 words so the column reads hit 16 different banks. Rows past
// NA or NB load zeros and their outputs are not written: the ragged edge is
// masked here, the caller pads nothing (the Pallas version needed padding to
// whole 128-row tiles). Neighbouring threads write neighbouring columns, so
// the output stores coalesce.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWords = 16;  // 512 bits
constexpr int kTile = 16;   // output tile edge; blockDim = (kTile, kTile)

__global__ void hamming_kernel(const uint32_t* __restrict__ a,
                               const uint32_t* __restrict__ b,
                               int32_t* __restrict__ out, int na, int nb) {
  __shared__ uint32_t sa[kTile][kWords + 1];
  __shared__ uint32_t sb[kTile][kWords + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  // thread (ty, tx) stages word tx of tile row ty of A and of B
  const int ra = row0 + ty;
  const int rb = col0 + ty;
  sa[ty][tx] = ra < na ? a[static_cast<size_t>(ra) * kWords + tx] : 0u;
  sb[ty][tx] = rb < nb ? b[static_cast<size_t>(rb) * kWords + tx] : 0u;
  __syncthreads();
  const int row = row0 + ty;
  const int col = col0 + tx;
  if (row < na && col < nb) {
    int acc = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) acc += __popc(sa[ty][w] ^ sb[tx][w]);
    out[static_cast<size_t>(row) * nb + col] = acc;
  }
}

}  // namespace

// a: (na, 16) int32, b: (nb, 16) int32, out: (na, nb) int32, all contiguous
// on the current device; stream: the caller's cudaStream_t.
extern "C" int okvis_hamming_matrix(const void* a, const void* b, void* out,
                                    int na, int nb, void* stream) {
  const dim3 block(kTile, kTile);
  const dim3 grid((nb + kTile - 1) / kTile, (na + kTile - 1) / kTile);
  hamming_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<int32_t*>(out), na, nb);
  return static_cast<int>(cudaGetLastError());
}
