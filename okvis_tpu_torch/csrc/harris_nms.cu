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
// rate without FMA) that is 3.71 us, so at the full power limit the
// operations, not the bytes, bound it, by a few percent. At these sizes the
// halo recomputation and the launch are the rest.
//
// Design: one block per 16 x 32 output tile of one camera (camera = grid z).
// The blur radius R and the NMS radius NR are template parameters, as the
// Pallas kernel fixes them at compile time: every loop unrolls and the taps
// stay in registers. The entry point instantiates the radii the system uses
// (R = 5 for sigma 1.5; NR = 4, and 2) and rejects any other. The block
// stages the image tile plus a halo of 1 (Scharr) + R (blur) + NR pixels in
// shared memory, with reads clamped at the image edge, and runs every stage
// in shared memory: products over the tile + R + NR, the vertical blur pass,
// the horizontal pass with the Harris score and the mask, then a separable
// window max. Only raw and sup leave the chip. The score map reuses the
// image's shared buffer.
//
// Arithmetic: every operation is written with the round-to-nearest
// intrinsics (__fmul_rn, __fadd_rn, ...) in the same order as the plain
// torch version (frontend/detection.py::harris_response), so nvcc cannot
// contract them into FMAs and the two agree bit for bit wherever their
// inputs agree (the gradients' /32 is a multiply by 2^-5, which rounds to the
// same float). Boundaries: the plain version rolls the image circularly for
// Scharr and pads with edge values for the blur, the kernel clamps its
// reads; the two agree from 1 + R + NR = 10 px inside the image (the
// detection border is 20 px). Ties keep >=, so equal maxima on a plateau all
// survive, as in the Pallas kernel.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstring>

namespace {

constexpr int kTileH = 16;
constexpr int kTileW = 32;
constexpr int kThreads = 256;

template <int R>
struct Taps {
  float t[2 * R + 1];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Shared-memory layout of one block for blur radius R and NMS radius NR:
// [image tile | score + vertical max] (aliased), three product planes, three
// vertically blurred planes.
template <int R, int NR>
struct Layout {
  static constexpr int halo = 1 + R + NR;
  static constexpr int iw = kTileW + 2 * halo, ih = kTileH + 2 * halo;          // image
  static constexpr int pw = kTileW + 2 * (R + NR), ph = kTileH + 2 * (R + NR);  // products
  static constexpr int vh = kTileH + 2 * NR;  // vertical blur (width pw)
  static constexpr int sw = kTileW + 2 * NR, sh = vh;  // score
  static constexpr int score_region = sh * sw + kTileH * sw;
  static constexpr int img_region = ih * iw > score_region ? ih * iw : score_region;
  static constexpr int floats = img_region + 3 * ph * pw + 3 * vh * pw;
};

template <int R, int NR>
__global__ void __launch_bounds__(kThreads)
harris_nms_kernel(const float* __restrict__ img, const float* __restrict__ inb,
                  float* __restrict__ raw_out, float* __restrict__ sup_out,
                  int H, int W, Taps<R> taps, float k_harris) {
  using L = Layout<R, NR>;
  constexpr int iw = L::iw, ih = L::ih, pw = L::pw, ph = L::ph, vh = L::vh;
  constexpr int sw = L::sw, sh = L::sh, halo = L::halo;
  extern __shared__ float smem[];
  const size_t plane = static_cast<size_t>(H) * W;
  const float* im = img + blockIdx.z * plane;
  const float* valid = inb + blockIdx.z * plane;
  float* raw = raw_out + blockIdx.z * plane;
  float* sup = sup_out + blockIdx.z * plane;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;

  float* s_img = smem;
  float* s_score = smem;  // reuses the image buffer once the products exist
  float* s_vmax = smem + sh * sw;
  float* s_xx = smem + L::img_region;
  float* s_yy = s_xx + ph * pw;
  float* s_xy = s_yy + ph * pw;
  float* v_xx = s_xy + ph * pw;
  float* v_yy = v_xx + vh * pw;
  float* v_xy = v_yy + vh * pw;
  const int tid = threadIdx.x;

  // 1. image tile + halo; local (ly, lx) is global (y0 - halo + ly, x0 - halo + lx)
  for (int i = tid; i < ih * iw; i += kThreads) {
    const int ly = i / iw, lx = i - ly * iw;
    const int gy = clampi(y0 - halo + ly, 0, H - 1);
    const int gx = clampi(x0 - halo + lx, 0, W - 1);
    s_img[i] = im[static_cast<size_t>(gy) * W + gx];
  }
  __syncthreads();

  // 2. Scharr gradients and products; product (py, px) is image local (py+1, px+1)
  for (int i = tid; i < ph * pw; i += kThreads) {
    const int py = i / pw, px = i - py * pw;
    const float* c = s_img + (py + 1) * iw + (px + 1);  // c[dy*iw + dx] = I(y+dy, x+dx)
    const float gx = __fmul_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(3.f, __fsub_rn(c[iw + 1], c[iw - 1])),
                            __fmul_rn(10.f, __fsub_rn(c[1], c[-1]))),
                  __fmul_rn(3.f, __fsub_rn(c[-iw + 1], c[-iw - 1]))),
        0.03125f);
    const float gy = __fmul_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(3.f, __fsub_rn(c[iw + 1], c[-iw + 1])),
                            __fmul_rn(10.f, __fsub_rn(c[iw], c[-iw]))),
                  __fmul_rn(3.f, __fsub_rn(c[iw - 1], c[-iw - 1]))),
        0.03125f);
    s_xx[i] = __fmul_rn(gx, gx);
    s_yy[i] = __fmul_rn(gy, gy);
    s_xy[i] = __fmul_rn(gx, gy);
  }
  __syncthreads();

  // 3. vertical blur; v (vy, vx) sums product rows vy .. vy + 2R
  for (int i = tid; i < vh * pw; i += kThreads) {
    const int vy = i / pw, vx = i - vy * pw;
    const int base = vy * pw + vx;
    float axx = __fmul_rn(taps.t[0], s_xx[base]);
    float ayy = __fmul_rn(taps.t[0], s_yy[base]);
    float axy = __fmul_rn(taps.t[0], s_xy[base]);
#pragma unroll
    for (int t = 1; t <= 2 * R; ++t) {
      const int j = base + t * pw;
      axx = __fadd_rn(axx, __fmul_rn(taps.t[t], s_xx[j]));
      ayy = __fadd_rn(ayy, __fmul_rn(taps.t[t], s_yy[j]));
      axy = __fadd_rn(axy, __fmul_rn(taps.t[t], s_xy[j]));
    }
    v_xx[i] = axx;
    v_yy[i] = ayy;
    v_xy[i] = axy;
  }
  __syncthreads();

  // 4. horizontal blur, Harris score, mask; score (sy, sx) is global
  //    (y0 - NR + sy, x0 - NR + sx) and sums v columns sx .. sx + 2R
  for (int i = tid; i < sh * sw; i += kThreads) {
    const int sy = i / sw, sx = i - sy * sw;
    const int base = sy * pw + sx;
    float ixx = __fmul_rn(taps.t[0], v_xx[base]);
    float iyy = __fmul_rn(taps.t[0], v_yy[base]);
    float ixy = __fmul_rn(taps.t[0], v_xy[base]);
#pragma unroll
    for (int t = 1; t <= 2 * R; ++t) {
      ixx = __fadd_rn(ixx, __fmul_rn(taps.t[t], v_xx[base + t]));
      iyy = __fadd_rn(iyy, __fmul_rn(taps.t[t], v_yy[base + t]));
      ixy = __fadd_rn(ixy, __fmul_rn(taps.t[t], v_xy[base + t]));
    }
    const float det = __fsub_rn(__fmul_rn(ixx, iyy), __fmul_rn(ixy, ixy));
    const float tr = __fadd_rn(ixx, iyy);
    const float r = __fsub_rn(det, __fmul_rn(__fmul_rn(k_harris, tr), tr));
    const int gy = y0 - NR + sy, gx = x0 - NR + sx;
    float score = -CUDART_INF_F;  // outside the image: the window max's -inf padding
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const size_t g = static_cast<size_t>(gy) * W + gx;
      if (valid[g] > 0.f) score = r;
      if (sy >= NR && sy < NR + kTileH && sx >= NR && sx < NR + kTileW) raw[g] = r;
    }
    s_score[i] = score;
  }
  __syncthreads();

  // 5. vertical window max over the tile rows
  for (int i = tid; i < kTileH * sw; i += kThreads) {
    const int my = i / sw, mx = i - my * sw;
    const float* col = s_score + (my + NR) * sw + mx;
    float m = col[0];
#pragma unroll
    for (int d = 1; d <= NR; ++d) m = fmaxf(m, fmaxf(col[-d * sw], col[d * sw]));
    s_vmax[i] = m;
  }
  __syncthreads();

  // 6. horizontal window max and suppression
  for (int i = tid; i < kTileH * kTileW; i += kThreads) {
    const int oy = i / kTileW, ox = i - oy * kTileW;
    const int gy = y0 + oy, gx = x0 + ox;
    if (gy >= H || gx >= W) continue;
    const float* row = s_vmax + oy * sw + ox + NR;
    float m = row[0];
#pragma unroll
    for (int d = 1; d <= NR; ++d) m = fmaxf(m, fmaxf(row[-d], row[d]));
    const float s = s_score[(oy + NR) * sw + ox + NR];
    sup[static_cast<size_t>(gy) * W + gx] = s >= m ? s : -CUDART_INF_F;
  }
}

template <int R, int NR>
int launch(const void* img, const void* inb, void* raw, void* sup, int C, int H, int W,
           const void* taps, float k_harris, cudaStream_t stream) {
  Taps<R> t;
  std::memcpy(t.t, taps, sizeof(t.t));
  constexpr size_t bytes = sizeof(float) * Layout<R, NR>::floats;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        harris_nms_kernel<R, NR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, C);
  harris_nms_kernel<R, NR><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(img), static_cast<const float*>(inb),
      static_cast<float*>(raw), static_cast<float*>(sup), H, W, t, k_harris);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img, inb, raw, sup: (C, H, W) float32, contiguous, on the current device.
// taps: 2·radius+1 host floats; stream: the caller's cudaStream_t. Only the
// instantiated (radius, nms_radius) pairs run; any other returns
// cudaErrorInvalidValue.
extern "C" int okvis_harris_nms(const void* img, const void* inb, void* raw, void* sup,
                                int C, int H, int W, const void* taps, int radius,
                                int nms_radius, float k_harris, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (radius == 5 && nms_radius == 4) {
    return launch<5, 4>(img, inb, raw, sup, C, H, W, taps, k_harris, s);
  }
  if (radius == 5 && nms_radius == 2) {
    return launch<5, 2>(img, inb, raw, sup, C, H, W, taps, k_harris, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
