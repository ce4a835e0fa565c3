// Fused Harris corner response + non-maximum suppression for a batch of
// camera images, in one launch.
//
// Replaces the TPU kernel okvis_tpu/ops/detection_pallas.py::harris_suppressed_pallas
// (body _harris_nms_kernel):
//   Scharr/32 gradients -> structure tensor gx², gy², gx·gy -> separable
//   Gaussian blur (vertical, then horizontal) -> raw = det - k·tr²;
//   score = raw where inb > 0, else -inf; sup = score where score >= the
//   max of its (2·NR+1)² window, else -inf.
// Outputs raw (needed by the subpixel step) and sup, both (C, H, W) float32.
//
// What bounds it on the H100: per pixel it must read img and inb and write
// raw and sup, 16 bytes (11.6 MB for a 2 x 480 x 752 multiframe, 3.45 us at
// 3.35 TB/s), and it does 172 operations, none of them fused: 154 float32
// adds and multiplies (Scharr 18, products 3, blur 126, score 7) and 18
// compares and maxima (mask, 9x9 window max, suppression). Issued at one
// warp instruction per scheduler and clock (33.5 T/s, the card's float32
// rate without FMA) that is 3.71 us: the operations bound it.
//
// Design: a block of 256 threads computes a 64 x 44 output tile of one camera
// (camera = grid z): 12 x 11 x 2 = 264 blocks for 2 x 480 x 752, and two
// blocks fit an SM (95 KB of shared memory each, under 128 registers a
// thread), so the batch runs in one wave with every SM holding two. 44 rows
// rather than 48 is what evens the wave: 48 gives 240 blocks, and 24 SMs
// then hold one while the rest hold two. Wider or taller tiles (128 x 44, 64
// x 64, 64 x 96) halve the blocks an SM holds and were slower on the card;
// smaller ones (32 x 32, 64 x 32) recompute more halo. Stages, with a block
// barrier after each:
//   A. image tile + 1 + R + NR halo -> shared memory (reads clamped at the
//      image edge); warps on rows, lanes on columns, every load issued before
//      the first store;
//   B. a thread walks a column segment of 18 rows: Scharr from a 3 x 3 window
//      slid down the column, the three products, and the vertical blur as 33
//      running sums in registers (no product leaves the thread). The thread
//      also copies its column of the mask, loads issued first so that they
//      land while it computes;
//   C. a thread takes 8 outputs of one row: the horizontal blur of the three
//      planes from 16-byte shared loads, the Harris score and the mask;
//   D, E. the separable 9 x 9 window max (a doubling max in registers: 16
//      outputs of a row, then 11 of a column), suppression, and raw and sup
//      written with lanes on consecutive columns.
// Against the first design (16 x 32 tiles, every tap a shared load): shared
// traffic falls from about 211 words a pixel to 36, float32 operations from
// about 367 a pixel to 237 (halo: products 2.45x, vertical blur 1.57x,
// horizontal blur 1.33x the tile; 154 is the floor), and 1,440 blocks in 2.2
// waves become 264 in one. What remains is issue: a thread of stage B does
// 1,642 float32 operations and one of stage C 1,120 (two tasks of 560),
// beside their loads, stores and index arithmetic, plus the floor of a
// launch (chip_smoke.py prints it as launch_floor).
//
// Arithmetic: every operation is written with the round-to-nearest
// intrinsics (__fmul_rn, __fadd_rn, ...) in the same order as the plain
// torch version (frontend/detection.py::harris_response), so nvcc cannot
// contract them into FMAs and the two agree bit for bit wherever their
// inputs agree. Register blocking changes where a value is computed, not how
// it is rounded: each blur output still sums taps 0 .. 2R left to right, a
// row difference reused by three products is the same rounded value, and the
// gradients' /32 is a multiply by 2^-5, which rounds to the same float.
// Boundaries: the plain version rolls the image circularly for Scharr and
// pads with edge values for the blur, the kernel clamps its reads; the two
// agree from 1 + R + NR = 10 px inside the image (the detection border is
// 20 px). Outside the image the window max sees -inf. Ties keep >=, so equal
// maxima on a plateau all survive, as in the Pallas kernel.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstring>

namespace {

constexpr int kTileW = 64;  // output columns of a block
constexpr int kTileH = 44;  // output rows of a block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 2;
constexpr int kHSeg = 8;  // horizontal-blur outputs of a thread (two float4)
constexpr int kMSeg = 16;  // horizontal window-max outputs of a thread

template <int R>
struct Taps {
  float t[2 * R + 1];
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int round4(int n) { return cdiv(n, 4) * 4; }
__host__ __device__ constexpr int ilog2(int n) { return n > 1 ? 1 + ilog2(n / 2) : 0; }

// The least row stride >= n that is four times an odd number: eight lanes
// on eight consecutive rows then reach eight distinct bank quads with their
// 16-byte loads and stores, so no quarter-warp conflicts.
constexpr int quad_stride(int n) { return (round4(n) / 4) % 2 ? round4(n) : round4(n) + 4; }

// Segments to cut a column of n rows into, for `cols` columns on kThreads
// threads: the fewest thread rounds x (segment rows + `extra`), where extra
// weighs the rows of input a segment reads beyond its outputs.
constexpr int best_segments(int n, int cols, int extra) {
  int best = 1, best_cost = 1 << 30;
  for (int s = 1; s <= 8; ++s) {
    const int cost = cdiv(cols * s, kThreads) * (cdiv(n, s) + extra);
    if (cost < best_cost) best = s, best_cost = cost;
  }
  return best;
}

// Regions of one block for blur radius R and NMS radius NR, in floats.
template <int R, int NR>
struct Geometry {
  static constexpr int kHalo = 1 + R + NR;  // Scharr + blur + window max
  // image: local (iy, ix) is global (y0 - kHalo + iy, x0 - kHalo + ix)
  static constexpr int IH = kTileH + 2 * kHalo, IW = kTileW + 2 * kHalo;
  // product (py, px) is centred on image local (py + 1, px + 1); vertical
  // blur v (vy, vx) sums product rows vy .. vy + 2R
  static constexpr int PW = kTileW + 2 * (R + NR), VH = kTileH + 2 * NR;
  // score (sy, sx) is global (y0 - NR + sy, x0 - NR + sx) and sums v
  // columns sx .. sx + 2R; output (oy, ox) is score (oy + NR, ox + NR)
  static constexpr int SH = VH, SW = kTileW + 2 * NR;
  // a horizontal-blur thread reads whole float4 from its first column on
  static constexpr int kHLoad = round4(kHSeg + 2 * R);
  static constexpr int VS = quad_stride(cmax(PW, SW - kHSeg + kHLoad));  // v rows
  static constexpr int VP = VH * VS;                                     // v plane
  static constexpr int SS = quad_stride(SW);   // score and mask rows
  static constexpr int RS = kTileW + 1;        // raw rows: odd, lanes on rows store freely
  static constexpr int MS = quad_stride(kTileW);  // horizontal window-max rows
  static constexpr int kVSegs = best_segments(VH, PW, 3), kVSeg = cdiv(VH, kVSegs);
  static constexpr int kHSegs = cdiv(SW, kHSeg), kMSegs = cdiv(kTileW, kMSeg);
  static constexpr int kOSegs = best_segments(kTileH, kTileW, 1), kOSeg = cdiv(kTileH, kOSegs);
  // [image | score, raw] [v: xx, yy, xy] [mask | horizontal window max]
  static constexpr int kRawAt = round4(SH * SS);
  static constexpr int kVAt = round4(cmax(IH * IW, kRawAt + kTileH * RS));
  static constexpr int kMaskAt = kVAt + 3 * VP;
  static constexpr int kFloats = kMaskAt + cmax(SH * SS, SH * MS);
  static_assert(kTileW % 4 == 0 && NR % 2 == 0, "float4 rows need 4 | kTileW and 2 | NR");
  static_assert((NR & (NR - 1)) == 0, "window_max doubles to 2 NR");
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <int N>
__device__ __forceinline__ void load4(const float* p, float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 q = reinterpret_cast<const float4*>(p)[i];
    x[4 * i] = q.x, x[4 * i + 1] = q.y, x[4 * i + 2] = q.z, x[4 * i + 3] = q.w;
  }
}

template <int N>
__device__ __forceinline__ void store4(float* p, const float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    reinterpret_cast<float4*>(p)[i] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
  }
}

// Scharr gradients, their products and the vertical blur of one column
// segment: N blurred rows from N + 2R product rows, all in registers. `im`
// is the image at the top-left of the first product's 3x3 neighbourhood, `v`
// the first output of the xx plane. The gradients are the plain version's
// expressions; a row's difference r - l and its 3(r - l) serve the three
// products that read the row, computed once with the same roundings.
template <int R, int N, int IW, int VS, int VP>
__device__ __forceinline__ void products_vertical_blur(const float* im, float* v, const Taps<R>& taps) {
  float l0 = im[0], m0 = im[1], r0 = im[2];
  float l1 = im[IW], m1 = im[IW + 1], r1 = im[IW + 2];
  float e1 = __fsub_rn(r1, l1);
  float t0 = __fmul_rn(3.f, __fsub_rn(r0, l0)), t1 = __fmul_rn(3.f, e1);
  float axx[N], ayy[N], axy[N];
#pragma unroll
  for (int j = 0; j < N + 2 * R; ++j) {
    const float* row = im + (j + 2) * IW;
    const float l2 = row[0], m2 = row[1], r2 = row[2];
    const float e2 = __fsub_rn(r2, l2);
    const float t2 = __fmul_rn(3.f, e2);
    const float gx = __fmul_rn(__fadd_rn(__fadd_rn(t2, __fmul_rn(10.f, e1)), t0), 0.03125f);
    const float gy = __fmul_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(3.f, __fsub_rn(r2, r0)), __fmul_rn(10.f, __fsub_rn(m2, m0))),
                  __fmul_rn(3.f, __fsub_rn(l2, l0))),
        0.03125f);
    const float pxx = __fmul_rn(gx, gx), pyy = __fmul_rn(gy, gy), pxy = __fmul_rn(gx, gy);
#pragma unroll
    for (int o = 0; o < N; ++o) {
      const int t = j - o;  // this product is tap t of output o
      if (t < 0 || t > 2 * R) continue;
      if (t == 0) {
        axx[o] = __fmul_rn(taps.t[0], pxx);
        ayy[o] = __fmul_rn(taps.t[0], pyy);
        axy[o] = __fmul_rn(taps.t[0], pxy);
      } else {
        axx[o] = __fadd_rn(axx[o], __fmul_rn(taps.t[t], pxx));
        ayy[o] = __fadd_rn(ayy[o], __fmul_rn(taps.t[t], pyy));
        axy[o] = __fadd_rn(axy[o], __fmul_rn(taps.t[t], pxy));
      }
      if (t == 2 * R) {
        v[o * VS] = axx[o];
        v[VP + o * VS] = ayy[o];
        v[2 * VP + o * VS] = axy[o];
      }
    }
    l0 = l1, m0 = m1, r0 = r1, l1 = l2, m1 = m2, r1 = r2;
    t0 = t1, t1 = t2, e1 = e2;
  }
}

// N outputs of the horizontal blur from one row of a v plane, taps summed
// left to right.
template <int R, int N, int LOAD>
__device__ __forceinline__ void horizontal_blur(const float* row, const Taps<R>& taps, float (&out)[N]) {
  float x[LOAD];
  load4(row, x);
#pragma unroll
  for (int o = 0; o < N; ++o) {
    float a = __fmul_rn(taps.t[0], x[o]);
#pragma unroll
    for (int t = 1; t <= 2 * R; ++t) a = __fadd_rn(a, __fmul_rn(taps.t[t], x[o + t]));
    out[o] = a;
  }
}

// p[i] = max(p[i .. i + W - 1]) for W = 2^L, by doubling; W is a template
// argument at every level, so every index is a constant and p stays in
// registers.
template <int L, int M>
__device__ __forceinline__ void doubling_max(float (&p)[M]) {
  if constexpr (L > 0) {
    doubling_max<L - 1, M>(p);
    constexpr int w = 1 << (L - 1);
#pragma unroll
    for (int i = 0; i + 2 * w <= M; ++i) p[i] = fmaxf(p[i], p[i + w]);
  }
}

// out[i] = max(x[i .. i + K]), a window of K + 1 values, K a power of two.
template <int N, int K>
__device__ __forceinline__ void window_max(const float (&x)[N + K], float (&out)[N]) {
  float p[N + K];
#pragma unroll
  for (int i = 0; i < N + K; ++i) p[i] = x[i];
  doubling_max<ilog2(K), N + K>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = fmaxf(p[i], x[i + K]);
}

template <int R, int NR>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
harris_nms_kernel(const float* __restrict__ img, const float* __restrict__ inb,
                  float* __restrict__ raw_out, float* __restrict__ sup_out,
                  int H, int W, Taps<R> taps, float k_harris) {
  using G = Geometry<R, NR>;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float* const s_img = smem;
  float* const s_score = smem;  // over the image once the vertical blur is done
  float* const s_raw = smem + G::kRawAt;
  float* const s_v = smem + G::kVAt;
  float* const s_mask = smem + G::kMaskAt;
  float* const s_hmax = s_mask;  // over the mask once the score is done
  const size_t plane = static_cast<size_t>(H) * W;
  const float* im = img + blockIdx.z * plane;
  const float* valid = inb + blockIdx.z * plane;
  float* raw = raw_out + blockIdx.z * plane;
  float* sup = sup_out + blockIdx.z * plane;
  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // A. image tile + halo, reads clamped at the edge. Warps on rows, lanes on
  //    columns; clamps are computed once a row and once a column, and every
  //    load of a thread is issued before its first store. Only the last row
  //    and column of a thread's grid can fall outside the region.
  {
    constexpr int kIR = cdiv(G::IH, kWarps), kIC = cdiv(G::IW, 32);
    const bool last_row = warp + (kIR - 1) * kWarps < G::IH, last_col = lane + 32 * (kIC - 1) < G::IW;
    float a[kIR][kIC];
    int col[kIC];
#pragma unroll
    for (int j = 0; j < kIC; ++j) col[j] = clampi(x0 - G::kHalo + lane + 32 * j, 0, W - 1);
#pragma unroll
    for (int i = 0; i < kIR; ++i) {
      const int row = clampi(y0 - G::kHalo + warp + i * kWarps, 0, H - 1) * W;
#pragma unroll
      for (int j = 0; j < kIC; ++j) {
        if ((i < kIR - 1 || last_row) && (j < kIC - 1 || last_col)) a[i][j] = im[row + col[j]];
      }
    }
#pragma unroll
    for (int i = 0; i < kIR; ++i) {
#pragma unroll
      for (int j = 0; j < kIC; ++j) {
        if ((i < kIR - 1 || last_row) && (j < kIC - 1 || last_col)) {
          s_img[(warp + i * kWarps) * G::IW + lane + 32 * j] = a[i][j];
        }
      }
    }
  }
  __syncthreads();

  // B. products and vertical blur: a column segment a thread, lanes on
  //    columns. The thread also copies the mask of its column and rows (score
  //    rows are v rows) to shared memory, 0 outside the image (the window
  //    max's -inf padding): the loads are issued first and land while the
  //    blur runs.
  for (int task = tid; task < G::PW * G::kVSegs; task += kThreads) {
    const int px = task % G::PW, seg = task / G::PW;
    const int vy0 = min(seg * G::kVSeg, G::VH - G::kVSeg);  // the last segment overlaps
    const int gx = x0 - NR + px, gy0 = y0 - NR + vy0;
    const bool mask_col = px < G::SW && gx >= 0 && gx < W;
    float mask[G::kVSeg];
#pragma unroll
    for (int k = 0; k < G::kVSeg; ++k) {
      const bool in = mask_col && gy0 + k >= 0 && gy0 + k < H;
      mask[k] = in ? valid[(gy0 + k) * W + gx] : 0.f;
    }
    products_vertical_blur<R, G::kVSeg, G::IW, G::VS, G::VP>(
        s_img + vy0 * G::IW + px, s_v + vy0 * G::VS + px, taps);
    if (px < G::SW) {
#pragma unroll
      for (int k = 0; k < G::kVSeg; ++k) s_mask[(vy0 + k) * G::SS + px] = mask[k];
    }
  }
  __syncthreads();

  // C. horizontal blur, Harris score and mask: a row segment a thread,
  //    lanes on rows (conflict-free float4)
  for (int task = tid; task < G::SH * G::kHSegs; task += kThreads) {
    const int sy = task % G::SH, seg = task / G::SH;
    const int sx0 = min(seg * kHSeg, G::SW - kHSeg);
    float ixx[kHSeg], iyy[kHSeg], ixy[kHSeg], mask[kHSeg], score[kHSeg];
    const float* vrow = s_v + sy * G::VS + sx0;
    horizontal_blur<R, kHSeg, G::kHLoad>(vrow, taps, ixx);
    horizontal_blur<R, kHSeg, G::kHLoad>(vrow + G::VP, taps, iyy);
    horizontal_blur<R, kHSeg, G::kHLoad>(vrow + 2 * G::VP, taps, ixy);
    load4(s_mask + sy * G::SS + sx0, mask);
    const int oy = sy - NR;
    const bool raw_row = oy >= 0 && oy < kTileH;
#pragma unroll
    for (int o = 0; o < kHSeg; ++o) {
      const float det = __fsub_rn(__fmul_rn(ixx[o], iyy[o]), __fmul_rn(ixy[o], ixy[o]));
      const float tr = __fadd_rn(ixx[o], iyy[o]);
      const float r = __fsub_rn(det, __fmul_rn(__fmul_rn(k_harris, tr), tr));
      score[o] = mask[o] > 0.f ? r : -CUDART_INF_F;
      const int ox = sx0 + o - NR;
      if (raw_row && ox >= 0 && ox < kTileW) s_raw[oy * G::RS + ox] = r;
    }
    store4(s_score + sy * G::SS + sx0, score);
  }
  __syncthreads();

  // D. separable window max. Horizontal: a row segment a thread, lanes on rows.
  for (int task = tid; task < G::SH * G::kMSegs; task += kThreads) {
    const int sy = task % G::SH, seg = task / G::SH;
    const int ox0 = min(seg * kMSeg, kTileW - kMSeg);
    float x[kMSeg + 2 * NR], m[kMSeg];
    load4(s_score + sy * G::SS + ox0, x);
    window_max<kMSeg, 2 * NR>(x, m);
    store4(s_hmax + sy * G::MS + ox0, m);
  }
  __syncthreads();

  // E. vertical window max, suppression, raw and sup out: a column segment a
  //    thread, lanes on columns (coalesced stores)
  for (int task = tid; task < kTileW * G::kOSegs; task += kThreads) {
    const int ox = task % kTileW, seg = task / kTileW;
    const int oy0 = min(seg * G::kOSeg, kTileH - G::kOSeg);
    const int gx = x0 + ox;
    if (gx >= W) continue;
    float x[G::kOSeg + 2 * NR], m[G::kOSeg];
#pragma unroll
    for (int i = 0; i < G::kOSeg + 2 * NR; ++i) x[i] = s_hmax[(oy0 + i) * G::MS + ox];
    window_max<G::kOSeg, 2 * NR>(x, m);
#pragma unroll
    for (int o = 0; o < G::kOSeg; ++o) {
      const int gy = y0 + oy0 + o;
      if (gy >= H) break;
      const float s = s_score[(oy0 + o + NR) * G::SS + ox + NR];
      const int g = gy * W + gx;
      raw[g] = s_raw[(oy0 + o) * G::RS + ox];
      sup[g] = s >= m[o] ? s : -CUDART_INF_F;
    }
  }
}

template <int R, int NR>
int launch(const void* img, const void* inb, void* raw, void* sup, int C, int H, int W,
           const void* taps, float k_harris, cudaStream_t stream) {
  Taps<R> t;
  std::memcpy(t.t, taps, sizeof(t.t));
  constexpr size_t bytes = sizeof(float) * Geometry<R, NR>::kFloats;
  const cudaError_t err = cudaFuncSetAttribute(
      harris_nms_kernel<R, NR>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cdiv(W, kTileW), cdiv(H, kTileH), C);
  harris_nms_kernel<R, NR><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(img), static_cast<const float*>(inb),
      static_cast<float*>(raw), static_cast<float*>(sup), H, W, t, k_harris);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img, inb, raw, sup: (C, H, W) float32, contiguous, on the current device.
// taps: 2·radius+1 host floats; stream: the caller's cudaStream_t. Only the
// instantiated (radius, nms_radius) pairs run, on images of fewer than 2^31
// pixels (offsets within an image are 32-bit); anything else returns
// cudaErrorInvalidValue.
extern "C" int okvis_harris_nms(const void* img, const void* inb, void* raw, void* sup,
                                int C, int H, int W, const void* taps, int radius,
                                int nms_radius, float k_harris, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(H) * W > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (radius == 5 && nms_radius == 4) {
    return launch<5, 4>(img, inb, raw, sup, C, H, W, taps, k_harris, s);
  }
  if (radius == 5 && nms_radius == 2) {
    return launch<5, 2>(img, inb, raw, sup, C, H, W, taps, k_harris, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory a block of the (radius, nms_radius) instantiation
// launches with, in bytes (ptxas reports only static shared memory); -1 for
// radii that are not compiled.
extern "C" int okvis_harris_nms_shared_bytes(int radius, int nms_radius) {
  if (radius == 5 && nms_radius == 4) return static_cast<int>(sizeof(float) * Geometry<5, 4>::kFloats);
  if (radius == 5 && nms_radius == 2) return static_cast<int>(sizeof(float) * Geometry<5, 2>::kFloats);
  return -1;
}
