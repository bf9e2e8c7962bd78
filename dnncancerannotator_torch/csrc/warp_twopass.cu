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
// horizontal pass on a transposed intermediate: TPU machinery, not
// semantics. The blends keep the exact form lo * (1 - r) + hi * r with
// rounded, uncontracted operations, so both routes return the same floats
// as the plain version (ops/kernels/warp_twopass.py).
//
// Layout: NHWC f32, image [B, H, W, C], flow [B, H, W, 2] as (dy, dx); NHWC
// because the augmentation chain (crop, flip, contrast, the label split)
// runs on NHWC batches as in the JAX package.
//
// Two routes (ops/kernels/warp_twopass.py: route):
// - tile: the halo-tile kernel of warp_tile.cuh, at offset 0 with fy and fx
//   read from the interleaved flow. Every main-path shape takes it.
// - direct: one thread an output pixel and all its C channels, the 2 x 2
//   taps read straight from device memory, with fy read at (y, x0) and
//   (y, x0+1). It stays for shapes whose halo tile does not fit shared
//   memory or would re-read the image too often.
//
// What bounds it on the H100: device memory, (2 C + 2) * 4 bytes a pixel
// read and written. The direct route loses to its access pattern: 4 taps
// x C scalar loads a pixel from interleaved pixels, C scalar stores at a
// 4 C-byte stride, and the dependent flow reads fx -> fy; the tile stages
// the image with coalesced 16-byte copies and writes with 16-byte stores.
#include "warp_tile.cuh"

namespace warp = dnnca::warp;

namespace {

constexpr int kThreads = 256;

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

  const warp::Taps tx = warp::taps_at(x, fb[(row + x) * 2 + 1], d, W);
  const warp::Taps ty0 = warp::taps_at(y, fb[(row + tx.lo) * 2], d, H);
  const warp::Taps ty1 = warp::taps_at(y, fb[(row + tx.hi) * 2], d, H);

  const float* ib = img + static_cast<size_t>(b) * plane * C;
  const float* p00 = ib + (static_cast<size_t>(ty0.lo) * W + tx.lo) * C;
  const float* p01 = ib + (static_cast<size_t>(ty0.hi) * W + tx.lo) * C;
  const float* p10 = ib + (static_cast<size_t>(ty1.lo) * W + tx.hi) * C;
  const float* p11 = ib + (static_cast<size_t>(ty1.hi) * W + tx.hi) * C;
  float* o = out + idx * C;
  for (int c = 0; c < C; ++c) {
    const float mid0 = warp::blend(p00[c], p01[c], ty0.r);
    const float mid1 = warp::blend(p10[c], p11[c], ty1.r);
    o[c] = warp::blend(mid0, mid1, tx.r);
  }
}

}  // namespace

// tile: 1 for the tile route with the plan (tw ... smem), 0 for the
// direct route (the plan unused).
extern "C" int dnnca_warp_twopass(const float* img, const float* flow,
                                  float* out, int B, int H, int W, int C,
                                  int max_displacement, int tile, int tw,
                                  int seg, int th, int rb, int rs, int fs,
                                  int os, int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile)
    return warp::launch_tile<false>(img, flow, nullptr, nullptr, out,
                                    warp::Frame{B, H, W, H, W, C},
                                    warp::Plan{tw, seg, th, rb, rs, fs, os},
                                    max_displacement, smem, st);
  const size_t n = static_cast<size_t>(B) * H * W;
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  warp_twopass_kernel<<<grid, kThreads, 0, st>>>(
      img, flow, out, B, H, W, C, static_cast<float>(max_displacement));
  return dnnca::launched(cudaGetLastError());
}
