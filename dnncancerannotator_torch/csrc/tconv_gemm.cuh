// The tiled f32 GEMM shared by the NHWC transposed-conv kernels
// (tconv2x2_nhwc.cu, tconv2x2_nhwc_bwd.cu).
//
// ConvTranspose(kernel 2, stride 2) of x [B, H, W, Ci] with w [Ci, Co, 2, 2]
// writes every output pixel from exactly one input pixel, so with the
// phases p = 2 * dy + dx packed beside the channels it is one product:
//   fwd:   out[pix(m, p), co] = bias[co] + sum_ci x[m, ci] * wp[ci, p*Co + co]
//   dgrad: dx[m, ci] = sum_{p, co} g[pix(m, p), co] * wpt[p*Co + co, ci]
//   wgrad: dwp[ci, p*Co + co] = sum_m x[m, ci] * g[pix(m, p), co]
// where m runs over the B*H*W input pixels and pix(m, p) is the output pixel
// (b, 2y+dy, 2x+dx) of input pixel m = (b, y, x). The phase interleave is only
// an address: the A and B loads of dgrad and wgrad gather g rows by it, and
// the forward's epilogue scatters by it, each run of channels contiguous.
//
// Tiles of 128 x 128 outputs, 8 deep, 256 threads each holding 8 x 8 sums in
// registers (rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns likewise
// from tx, so a warp's shared-memory reads and its stores are contiguous
// runs). Plain f32 FMAs, not TF32: the JAX kernel this replaces accumulates
// in f32 and is held against lax.conv_transpose at full precision. Two
// shared-memory stages: the next tile's global loads are in flight in
// registers while the current tile is multiplied. At most 128 registers a
// thread, so that two blocks share an SM.
//
// Needs Ci % 128 == 0 and Co % 128 == 0 (the JAX kernel's eligibility): then
// a 128-column tile lies inside one phase and every 8-deep slice of K does
// too, and the wrapper checks it. Any B, H, W.
#pragma once

#include "common.cuh"

namespace dnnca {
namespace tgemm {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 8;
constexpr int kThreads = 256;
// padded k-major row of the A tile: a transposed store of two k offsets 4
// apart lands in other banks, and rows stay 16-byte aligned
constexpr int kLda = kBM + 4;

enum Mode { kFwd, kDgrad, kWgrad };

struct Params {
  const float* a;     // fwd, wgrad: x [B*H*W, Ci]; dgrad: g [B, 2H, 2W, Co]
  const float* b;     // fwd: wp [Ci, 4Co]; dgrad: wpt [4Co, Ci]; wgrad: g
  const float* bias;  // fwd only: [Co]
  float* out;         // fwd: [B, 2H, 2W, Co]; dgrad: dx; wgrad: [splits][Ci][4Co]
  int B, H, W, Ci, Co;
  int chunk;          // wgrad: input pixels per split of the reduction
};

// Offset in floats of channel 0 of the output pixel of input pixel m at
// phase p.
__device__ __forceinline__ size_t phase_pixel(const Params& q, int m, int p) {
  const int hw = q.H * q.W;
  const int b = m / hw, r = m - b * hw;
  const int y = r / q.W, x = r - y * q.W;
  return ((static_cast<size_t>(b) * 2 * q.H + 2 * y + (p >> 1)) * 2 * q.W +
          2 * x + (p & 1)) *
         static_cast<size_t>(q.Co);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

struct Tile {
  float4 a, b;  // this thread's share of the next A and B tiles
};

// This thread's share of the A and B tiles at depth k0 (a k-slice of 8).
template <int M>
__device__ __forceinline__ Tile load(const Params& q, int m0, int n0, int k0,
                                     int k_end, int rows) {
  const int t = threadIdx.x;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  Tile v;
  if constexpr (M == kWgrad) {
    // A = x^T: k is an input pixel, the tile's rows are channels ci
    const int k = t >> 5, c = (t & 31) * 4;
    const int pix = k0 + k;
    v.a = pix < k_end ? ld4(q.a + static_cast<size_t>(pix) * q.Ci + m0 + c)
                      : zero;
    const int p = n0 / q.Co, co = n0 - p * q.Co + c;
    v.b = pix < k_end ? ld4(q.b + phase_pixel(q, pix, p) + co) : zero;
  } else {
    // A row-major by input pixel: two threads a row, 4 deep each
    const int row = t >> 1, kq = (t & 1) * 4;
    const int m = m0 + row;
    if (m < rows) {
      if constexpr (M == kFwd) {
        v.a = ld4(q.a + static_cast<size_t>(m) * q.Ci + k0 + kq);
      } else {
        const int kk = k0 + kq, p = kk / q.Co;
        v.a = ld4(q.a + phase_pixel(q, m, p) + (kk - p * q.Co));
      }
    } else {
      v.a = zero;
    }
    const int k = t >> 5, c = (t & 31) * 4;
    const int n = M == kFwd ? 4 * q.Co : q.Ci;
    v.b = ld4(q.b + static_cast<size_t>(k0 + k) * n + n0 + c);
  }
  return v;
}

template <int M>
__device__ __forceinline__ void store(const Tile& v, float* as, float* bs) {
  const int t = threadIdx.x;
  if constexpr (M == kWgrad) {
    *reinterpret_cast<float4*>(as + (t >> 5) * kLda + (t & 31) * 4) = v.a;
  } else {
    const int row = t >> 1, kq = (t & 1) * 4;
    as[(kq + 0) * kLda + row] = v.a.x;
    as[(kq + 1) * kLda + row] = v.a.y;
    as[(kq + 2) * kLda + row] = v.a.z;
    as[(kq + 3) * kLda + row] = v.a.w;
  }
  *reinterpret_cast<float4*>(bs + (t >> 5) * kBN + (t & 31) * 4) = v.b;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <int M>
__global__ void __launch_bounds__(kThreads, 2)
gemm_kernel(Params q) {
  __shared__ __align__(16) float as[2][kBK * kLda];
  __shared__ __align__(16) float bs[2][kBK * kBN];
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int pixels = q.B * q.H * q.W;
  int rows, k0, k_end;
  if constexpr (M == kWgrad) {
    rows = q.Ci;
    k0 = blockIdx.z * q.chunk;
    k_end = min(k0 + q.chunk, pixels);
  } else {
    rows = pixels;
    k0 = 0;
    k_end = M == kFwd ? q.Ci : 4 * q.Co;
  }
  const int n_k = (k_end - k0 + kBK - 1) / kBK;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  Tile next = load<M>(q, m0, n0, k0, k_end, rows);
  store<M>(next, as[0], bs[0]);
  __syncthreads();
  for (int kt = 0; kt < n_k; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < n_k)
      next = load<M>(q, m0, n0, k0 + (kt + 1) * kBK, k_end, rows);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float* ak = as[cur] + k * kLda;
      const float* bk = bs[cur] + k * kBN;
      const float4 a0 = ld4(ak + ty * 4), a1 = ld4(ak + 64 + ty * 4);
      const float4 b0 = ld4(bk + tx * 4), b1 = ld4(bk + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < n_k) store<M>(next, as[cur ^ 1], bs[cur ^ 1]);
    __syncthreads();
  }

  // epilogue: row i of this thread is ty*4 + i (i < 4) or 64 + ty*4 + i - 4
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= rows) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + h * 64 + tx * 4;
      float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                             acc[i][4 * h + 2], acc[i][4 * h + 3]);
      float* dst;
      if constexpr (M == kFwd) {
        const int p = c / q.Co, co = c - p * q.Co;
        v = add4(v, ld4(q.bias + co));
        dst = q.out + phase_pixel(q, r, p) + co;
      } else if constexpr (M == kDgrad) {
        dst = q.out + static_cast<size_t>(r) * q.Ci + c;
      } else {
        dst = q.out + (static_cast<size_t>(blockIdx.z) * q.Ci + r) * 4 * q.Co +
              c;
      }
      *reinterpret_cast<float4*>(dst) = v;
    }
  }
}

template <int M>
inline cudaError_t launch(const Params& q, int splits, cudaStream_t stream) {
  const int n = M == kDgrad ? q.Ci : 4 * q.Co;
  const int rows = M == kWgrad ? q.Ci : q.B * q.H * q.W;
  const dim3 grid(n / kBN, (rows + kBM - 1) / kBM, M == kWgrad ? splits : 1);
  gemm_kernel<M><<<grid, kThreads, 0, stream>>>(q);
  return cudaGetLastError();
}

}  // namespace tgemm
}  // namespace dnnca
