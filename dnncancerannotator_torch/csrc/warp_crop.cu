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
// On the GPU one thread computes the 2 x 2 taps of its output pixel
// directly, with the offset added to its addresses: only the crop region
// and the crop columns of fy_ext are read. The blends keep the exact form
// lo * (1 - r) + hi * r with rounded, uncontracted operations, so the kernel
// returns the same floats as the plain version (ops/kernels/warp_crop.py).
//
// Layout: NHWC f32, image [B, h_in, w_in, C], fy_ext [B, h_out, w_in],
// fx [B, h_out, w_out], off [B, 2] int32 (oy, ox), out [B, h_out, w_out, C];
// one thread owns all C channels of an output pixel.
//
// What bounds it on the H100: device memory. Each output value takes 4
// reads of 4 bytes, mostly from L1/L2 (neighbouring pixels share taps);
// device memory moves the crop region, the two flow planes and the output,
// about (2 C + 2) * 4 bytes a pixel.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Taps {
  int lo, hi;  // row (or column) of the two taps, in the crop frame
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

  const Taps tx = taps_at(x, fx[idx], d, Wout);
  const float* fy_row =
      fy_ext + (static_cast<size_t>(b) * Hout + y) * Win + ox;
  const Taps ty0 = taps_at(y, fy_row[tx.lo], d, Hout);
  const Taps ty1 = taps_at(y, fy_row[tx.hi], d, Hout);

  // the crop's origin in the window
  const float* ib = img + ((static_cast<size_t>(b) * Hin + oy) * Win + ox) * C;
  const float* p00 = ib + (static_cast<size_t>(ty0.lo) * Win + tx.lo) * C;
  const float* p01 = ib + (static_cast<size_t>(ty0.hi) * Win + tx.lo) * C;
  const float* p10 = ib + (static_cast<size_t>(ty1.lo) * Win + tx.hi) * C;
  const float* p11 = ib + (static_cast<size_t>(ty1.hi) * Win + tx.hi) * C;
  float* o = out + idx * C;
  for (int c = 0; c < C; ++c) {
    const float mid0 = blend(p00[c], p01[c], ty0.r);
    const float mid1 = blend(p10[c], p11[c], ty1.r);
    o[c] = blend(mid0, mid1, tx.r);
  }
}

}  // namespace

extern "C" int dnnca_warp_crop(const float* img, const float* fy_ext,
                               const float* fx, const int* off, float* out,
                               int B, int Hin, int Win, int Hout, int Wout,
                               int C, int max_displacement, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t n = static_cast<size_t>(B) * Hout * Wout;
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  warp_crop_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, fy_ext, fx, off, out, B, Hin, Win, Hout, Wout, C,
      static_cast<float>(max_displacement));
  return cudaGetLastError();
}
