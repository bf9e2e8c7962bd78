// Backward of the 2x2 / stride-2 NHWC max pool (pool2x2_nhwc.cu) with the
// JAX package's tie rule: at each level of the two-level max tree the
// cotangent goes to the input that equals the max, split 0.5 / 0.5 at an
// exact tie (jnp.maximum's and torch.maximum's gradient). A window tied on
// both levels gives each input 1/4. Every product is g * 1, g * 0.5 or
// g * 0.25, exact in f32, and a loser gets +0, so dx equals the plain
// version bit for bit.
//
// Replaces the backward of pool_kernel.max_pool2x2_nhwc
// (dnncancerannotator_tpu/ops/pallas/pool_kernel.py:120, _bwd_kernel :66,
// _balanced :49). C % 4 == 0.
//
// What bounds it on the H100: device-memory bytes (x and g read, dx
// written): 151 / 75.5 / 37.7 MB at the unet_big pool sites (B=8), 45 /
// 22.5 / 11.3 us at 3.35 TB/s. One thread per output pixel and 4 channels:
// it reads the window and its cotangent as float4s, recomputes the two
// levels and writes the four float4s of dx.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The share of g that input a of max(a, b) == ans receives.
__device__ __forceinline__ float share(float a, float ans, float b, float g) {
  return a == ans ? (b == ans ? g * 0.5f : g) : 0.f;
}

struct Window {
  float dx00, dx01, dx10, dx11;  // (row, column) in the window
};

__device__ __forceinline__ Window window(float a00, float a01, float a10,
                                         float a11, float g) {
  const float m0 = max_nan(a00, a10), m1 = max_nan(a01, a11);
  const float out = max_nan(m0, m1);
  const float d0 = share(m0, out, m1, g), d1 = share(m1, out, m0, g);
  return {share(a00, m0, a10, d0), share(a01, m1, a11, d1),
          share(a10, m0, a00, d0), share(a11, m1, a01, d1)};
}

__global__ void __launch_bounds__(kThreads)
pool_bwd_kernel(const float4* __restrict__ x, const float4* __restrict__ g,
                float4* __restrict__ dx, int B, int H, int W, int C4) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<size_t>(B) * H * W * C4) return;
  const int c = static_cast<int>(idx % C4);
  const size_t pix = idx / C4;
  const int xo = static_cast<int>(pix % W);
  const int yo = static_cast<int>(pix / W % H);
  const int b = static_cast<int>(pix / W / H);
  const size_t row = static_cast<size_t>(2 * W) * C4;
  const size_t o =
      ((static_cast<size_t>(b) * 2 * H + 2 * yo) * 2 * W + 2 * xo) * C4 + c;
  const float4 a00 = x[o], a01 = x[o + C4], a10 = x[o + row],
               a11 = x[o + row + C4];
  const float4 gv = g[idx];
  const Window wx = window(a00.x, a01.x, a10.x, a11.x, gv.x);
  const Window wy = window(a00.y, a01.y, a10.y, a11.y, gv.y);
  const Window wz = window(a00.z, a01.z, a10.z, a11.z, gv.z);
  const Window ww = window(a00.w, a01.w, a10.w, a11.w, gv.w);
  dx[o] = make_float4(wx.dx00, wy.dx00, wz.dx00, ww.dx00);
  dx[o + C4] = make_float4(wx.dx01, wy.dx01, wz.dx01, ww.dx01);
  dx[o + row] = make_float4(wx.dx10, wy.dx10, wz.dx10, ww.dx10);
  dx[o + row + C4] = make_float4(wx.dx11, wy.dx11, wz.dx11, ww.dx11);
}

}  // namespace

// x and dx [B, 2H, 2W, C], g [B, H, W, C]; C % 4 == 0, 16-byte aligned.
extern "C" int dnnca_pool2x2_nhwc_bwd(const float* x, const float* g,
                                      float* dx, int B, int H, int W, int C,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t n = static_cast<size_t>(B) * H * W * (C / 4);
  pool_bwd_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                    kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(g),
      reinterpret_cast<float4*>(dx), B, H, W, C / 4);
  return cudaGetLastError();
}
