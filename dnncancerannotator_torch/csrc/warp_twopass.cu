// Two-pass bilinear resample of an NHWC image at a dense flow, the resample
// of the warp augmentation:
//   f      = clip(flow, -d, d)
//   vertical pass at column x':   qy = clip(y - fy(y, x'), 0, H-1), y0 = floor(qy),
//       mid(y, x') = img(y0, x') * (1 - ry) + img(min(y0+1, H-1), x') * ry,  ry = qy - y0
//   horizontal pass:              qx = clip(x - fx(y, x), 0, W-1), x0 = floor(qx),
//       out(y, x)  = mid(y, x0) * (1 - rx) + mid(y, min(x0+1, W-1)) * rx
// so the vertical pass uses fy at the source columns x0 and x0+1, not at
// the target column (the composition the coarse flow is corrected for,
// ops/warp.py).
//
// Replaces warp_kernel.dense_image_warp_twopass_pallas
// (dnncancerannotator_tpu/ops/pallas/warp_kernel.py:242), which runs both
// passes as 2 * (2d + 2) shift-select terms over one image in VMEM, with the
// horizontal pass on a transposed intermediate. None of that is needed on
// the GPU: one thread computes the 2 x 2 taps of its output pixel directly,
// with fy read at (y, x0) and (y, x0+1). The blends keep the exact form
// lo * (1 - r) + hi * r with rounded, uncontracted operations, so the kernel
// returns the same floats as the plain version.
//
// Layout: NHWC f32, image [B, H, W, C], flow [B, H, W, 2] as (dy, dx); NHWC
// because the augmentation chain (crop, flip, contrast, the label split)
// runs on NHWC batches as in the JAX package, and one thread then owns all
// C channels of a pixel, so the tap coordinates are computed once for all
// of them.
//
// What bounds it on the H100: 4 taps x C reads of 4 bytes per output
// element, mostly from L1/L2 since neighbouring pixels share taps; device
// memory moves about (2 C + 2) * 4 bytes a pixel, so it is bound by memory
// bytes and load issue.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Taps {
  int lo, hi;  // row (or column) of the two taps
  float r;     // weight of hi
};

__device__ __forceinline__ Taps taps_at(int g, float f, float d, int n) {
  const float fc = fminf(fmaxf(f, -d), d);
  const float q = fminf(fmaxf(__fsub_rn(static_cast<float>(g), fc), 0.f),
                        static_cast<float>(n - 1));
  const float q0 = floorf(q);
  const int lo = static_cast<int>(q0);
  return Taps{lo, lo + 1 < n ? lo + 1 : n - 1, __fsub_rn(q, q0)};
}

__device__ __forceinline__ float blend(float lo, float hi, float r) {
  return __fadd_rn(__fmul_rn(lo, __fsub_rn(1.f, r)), __fmul_rn(hi, r));
}

__global__ void __launch_bounds__(kThreads)
warp_twopass_kernel(const float* __restrict__ img,
                    const float* __restrict__ flow, float* __restrict__ out,
                    int B, int H, int W, int C, float d) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t plane = static_cast<size_t>(H) * W;
  if (idx >= static_cast<size_t>(B) * plane) return;
  const int b = static_cast<int>(idx / plane);
  const int y = static_cast<int>(idx % plane / W);
  const int x = static_cast<int>(idx % W);
  const float* fb = flow + static_cast<size_t>(b) * plane * 2;
  const size_t row = static_cast<size_t>(y) * W;

  const Taps tx = taps_at(x, fb[(row + x) * 2 + 1], d, W);
  const Taps ty0 = taps_at(y, fb[(row + tx.lo) * 2], d, H);
  const Taps ty1 = taps_at(y, fb[(row + tx.hi) * 2], d, H);

  const float* ib = img + static_cast<size_t>(b) * plane * C;
  const float* p00 = ib + (static_cast<size_t>(ty0.lo) * W + tx.lo) * C;
  const float* p01 = ib + (static_cast<size_t>(ty0.hi) * W + tx.lo) * C;
  const float* p10 = ib + (static_cast<size_t>(ty1.lo) * W + tx.hi) * C;
  const float* p11 = ib + (static_cast<size_t>(ty1.hi) * W + tx.hi) * C;
  float* o = out + idx * C;
  for (int c = 0; c < C; ++c) {
    const float mid0 = blend(p00[c], p01[c], ty0.r);
    const float mid1 = blend(p10[c], p11[c], ty1.r);
    o[c] = blend(mid0, mid1, tx.r);
  }
}

}  // namespace

extern "C" int dnnca_warp_twopass(const float* img, const float* flow,
                                  float* out, int B, int H, int W, int C,
                                  int max_displacement, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t n = static_cast<size_t>(B) * H * W;
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  warp_twopass_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      img, flow, out, B, H, W, C, static_cast<float>(max_displacement));
  return cudaGetLastError();
}
