// Crop-fused two-pass bilinear resample of an NHWC window: the fused
// augmentation chain's resample (crop at a per-image integer offset, then
// the two-pass warp of the crop), without the crop ever being written.
//
// For image b with crop offset (oy, ox), clamped into [0, in - out], and
// output pixel (y, x) of the h_out x w_out crop:
//   horizontal taps:  qx = clip(x - clip(fx(y, x), -d, d), 0, w_out-1),
//                     x0 = floor(qx), x1 = min(x0+1, w_out-1), rx = qx - x0
//   vertical taps at crop column j in {x0, x1}, with fy read at the source
//   column in the window's frame, fy_ext(y, ox + j):
//                     qy = clip(y - clip(fy_ext(y, ox+j), -d, d), 0, h_out-1),
//                     y0 = floor(qy), y1 = min(y0+1, h_out-1), ry = qy - y0
//       mid(j)    = img(oy+y0, ox+j) * (1 - ry) + img(oy+y1, ox+j) * ry
//   out(y, x)     = mid(x0) * (1 - rx) + mid(x1) * rx
// which is the crop followed by csrc/warp_twopass.cu on it. The hi tap at
// the last crop row or column is clamped into the crop (as the composed
// path's edge replication does); the TPU kernel reads the window row or
// column past the crop there, at weight 0, which gives the same result, but
// clamping keeps every read inside the crop, and so never past h_in / w_in.
//
// Replaces warp_kernel.dense_image_warp_crop_pallas
// (dnncancerannotator_tpu/ops/pallas/warp_kernel.py:194, _kernel_crop :121,
// _resample_rows_crop :86). The TPU kernel cannot take an unaligned dynamic
// slice, so it folds the crop offset into the tap masks and runs
// 2 * (2d + 2 + in - out) shift-select terms over the whole window in VMEM.
// Here only the crop region and the crop columns of fy_ext are read. The
// blends keep the exact form lo * (1 - r) + hi * r with rounded,
// uncontracted operations, so both routes return the same floats as the
// plain version (ops/kernels/warp_crop.py).
//
// Layout: NHWC f32, image [B, h_in, w_in, C], fy_ext [B, h_out, w_in],
// fx [B, h_out, w_out], off [B, 2] int32 (oy, ox), out [B, h_out, w_out, C].
//
// Two routes (ops/kernels/warp_twopass.py: route, on the crop's shape):
// - tile: the halo-tile kernel of warp_tile.cuh in the crop frame, the
//   block's (oy, ox) added where it stages rows. Every main-path shape
//   takes it.
// - direct: one thread an output pixel and all its C channels, the taps
//   read straight from device memory at the offset, for shapes whose halo
//   tile does not fit shared memory or would re-read the crop too often.
//
// What bounds it on the H100: device memory; it moves the crop region, the
// two flow planes and the output, about (2 C + 2) * 4 bytes a pixel.
#include "warp_tile.cuh"

namespace warp = dnnca::warp;

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
warp_crop_kernel(const float* __restrict__ img,
                 const float* __restrict__ fy_ext,
                 const float* __restrict__ fx, const int* __restrict__ off,
                 float* __restrict__ out, int B, int Hin, int Win, int Hout,
                 int Wout, int C, float d) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t plane = static_cast<size_t>(Hout) * Wout;
  if (idx >= static_cast<size_t>(B) * plane) return;
  const int b = static_cast<int>(idx / plane);
  const int y = static_cast<int>(idx % plane / Wout);
  const int x = static_cast<int>(idx % Wout);
  const int oy = min(max(off[2 * b], 0), Hin - Hout);
  const int ox = min(max(off[2 * b + 1], 0), Win - Wout);

  const warp::Taps tx = warp::taps_at(x, fx[idx], d, Wout);
  const float* fy_row =
      fy_ext + (static_cast<size_t>(b) * Hout + y) * Win + ox;
  const warp::Taps ty0 = warp::taps_at(y, fy_row[tx.lo], d, Hout);
  const warp::Taps ty1 = warp::taps_at(y, fy_row[tx.hi], d, Hout);

  // the crop's origin in the window
  const float* ib = img + ((static_cast<size_t>(b) * Hin + oy) * Win + ox) * C;
  const float* p00 = ib + (static_cast<size_t>(ty0.lo) * Win + tx.lo) * C;
  const float* p01 = ib + (static_cast<size_t>(ty0.hi) * Win + tx.lo) * C;
  const float* p10 = ib + (static_cast<size_t>(ty1.lo) * Win + tx.hi) * C;
  const float* p11 = ib + (static_cast<size_t>(ty1.hi) * Win + tx.hi) * C;
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
extern "C" int dnnca_warp_crop(const float* img, const float* fy_ext,
                               const float* fx, const int* off, float* out,
                               int B, int Hin, int Win, int Hout, int Wout,
                               int C, int max_displacement, int tile, int tw,
                               int seg, int th, int rb, int rs, int fs, int os,
                               int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile)
    return warp::launch_tile<true>(img, fy_ext, fx, off, out,
                                   warp::Frame{B, Hin, Win, Hout, Wout, C},
                                   warp::Plan{tw, seg, th, rb, rs, fs, os},
                                   max_displacement, smem, st);
  const size_t n = static_cast<size_t>(B) * Hout * Wout;
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  warp_crop_kernel<<<grid, kThreads, 0, st>>>(
      img, fy_ext, fx, off, out, B, Hin, Win, Hout, Wout, C,
      static_cast<float>(max_displacement));
  return dnnca::launched(cudaGetLastError());
}
