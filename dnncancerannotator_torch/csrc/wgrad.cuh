// Weight and bias gradient of a stride-1 convolution (wgrad.cu), shared by
// the conv chain's and the stencil conv's backward entry points.
#pragma once

#include "common.cuh"

namespace dnnca {

// dw[o][c][ky][kx] = sum_{b, y, x} A[b][o][y][x] * X[b][c][y - pt + ky][x - pl + kx]
// db[o]            = sum_{b, y, x} A[b][o][y][x]
// with X zero outside [0, H) x [0, W), and A = g * (mask > 0) when mask is
// given (the relu of the forward, read from its saved output).
// A and mask are [B][O][OH][OW], X is [B][Cin][H][W], all NCHW f32.
// out is [O*Cin*KH*KW + O]: dw in OIHW order, then db.
// partial is scratch of [out size][blocks] floats: each of the ``blocks``
// blocks writes its own partial sums there, and a second kernel adds them in
// a fixed order, so the result does not change from run to run.
struct WgradArgs {
  const float* A;
  const float* mask;  // may be null
  const float* X;
  float* partial;
  float* out;
  int B, O, Cin, OH, OW, H, W, KH, KW, pt, pl, blocks;
};

cudaError_t launch_wgrad(const WgradArgs& a, cudaStream_t stream);

// out[e] = sum_{i < blocks} partial[e * blocks + i], summed in a fixed
// order (one block per entry e, a tree over its threads).
cudaError_t launch_sum_partials(const float* partial, float* out, int n,
                                int blocks, cudaStream_t stream);

}  // namespace dnnca
