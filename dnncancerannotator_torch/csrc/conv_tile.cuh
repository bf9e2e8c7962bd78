// Tile helpers shared by the conv chain's forward and data-gradient kernels
// (conv_chain.cu, conv_chain_bwd.cu).
//
// A block computes a stride-1 "same" conv over a 2D tile of pixels from an
// input tile staged in shared memory. Each thread keeps the output channels
// of one pixel in registers; C is a template bucket (4, 8, 16 or 32) and the
// weights sit in shared memory as [in channel][tap][C], zero-padded past the
// real outputs, so each tap is C/4 float4 broadcasts and C FMAs with no
// per-channel guard.
#pragma once

#include "common.cuh"

namespace dnnca {
namespace tile {

constexpr int kTileW = 32;
constexpr int kThreads = 256;

// Stage a K x K weight as [n_in][K*K][C], zero-padded past n_out.
// FLIP = false: w is [n_out][n_in][K*K] (OIHW), staged as it is.
// FLIP = true: w is [n_in][n_out][K*K], the OIHW weight of the conv that
// runs the other way; it is staged transposed and spatially flipped, so a
// "same" conv with it is that conv's data gradient.
template <int C, bool FLIP = false>
__device__ void stage_weights(float* dst, const float* w, int n_out,
                              int n_in, int KK) {
  const int n = n_in * KK * C;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int o = i % C, t = (i / C) % KK, c = i / (C * KK);
    float v = 0.f;
    if (o < n_out)
      v = FLIP ? w[(c * n_out + o) * KK + (KK - 1 - t)]
               : w[(o * n_in + c) * KK + t];
    dst[i] = v;
  }
}

// acc[o] += v * w[o] for the C weights of one (input channel, tap).
template <int C>
__device__ __forceinline__ void tap(float (&acc)[C], float v,
                                    const float4* w) {
#pragma unroll
  for (int q = 0; q < C / 4; ++q) {
    const float4 wq = w[q];
    acc[4 * q + 0] = fmaf(v, wq.x, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(v, wq.y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(v, wq.z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(v, wq.w, acc[4 * q + 3]);
  }
}

// One pixel of a conv: acc += sum over input channels and taps of the
// window at src (a [n_in][rows][row_w] tile) times ws ([n_in][K*K][C]).
// KT > 0 unrolls a KT x KT stencil; KT = 0 runs K x K with a runtime loop.
template <int C, int KT>
__device__ __forceinline__ void conv_pixel(float (&acc)[C], const float* src,
                                           int plane, int row_w,
                                           const float* ws, int n_in, int K) {
  const int KK = K * K;
  for (int c = 0; c < n_in; ++c) {
    const float* s = src + c * plane;
    const float4* wc = reinterpret_cast<const float4*>(ws) + c * KK * (C / 4);
    if constexpr (KT > 0) {
#pragma unroll
      for (int t = 0; t < KT * KT; ++t)
        tap<C>(acc, s[(t / KT) * row_w + t % KT], wc + t * (C / 4));
    } else {
      for (int t = 0; t < KK; ++t)
        tap<C>(acc, s[(t / K) * row_w + t % K], wc + t * (C / 4));
    }
  }
}

}  // namespace tile
}  // namespace dnnca
