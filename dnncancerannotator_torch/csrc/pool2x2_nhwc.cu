// 2x2 / stride-2 max pool, NHWC f32, in the JAX package's order:
//   m(2x + j)   = max(x[2y, 2x + j], x[2y + 1, 2x + j])     (row pair first)
//   out[y, x]   = max(m(2x), m(2x + 1))
// with torch.maximum's NaN rule, so the values equal the plain pairwise tree
// bit for bit.
//
// Replaces pool_kernel.max_pool2x2_nhwc
// (dnncancerannotator_tpu/ops/pallas/pool_kernel.py:120, forward
// _fwd_kernel :57), which de-interleaves the column pair with a lane-tile
// reshape ([2W, C] -> [W, 2C], hence C % 128 == 0 there). Here the column
// pair is only an address. C % 4 == 0.
//
// What bounds it on the H100: device-memory bytes (4 reads and 1 write per
// output, no arithmetic to speak of): 84 / 42 / 21 MB at the unet_big pool
// sites (B=8), 25 / 12.5 / 6.3 us at 3.35 TB/s. The design: one thread per
// output pixel and 4 channels, every access a float4, neighbouring threads
// on neighbouring channels, so each warp reads and writes contiguous runs.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// torch.maximum: a NaN in either wins
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(max_nan(a.x, b.x), max_nan(a.y, b.y), max_nan(a.z, b.z),
                     max_nan(a.w, b.w));
}

__global__ void __launch_bounds__(kThreads)
pool_kernel(const float4* __restrict__ x, float4* __restrict__ out, int B,
            int H, int W, int C4) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<size_t>(B) * H * W * C4) return;
  const int c = static_cast<int>(idx % C4);
  const size_t pix = idx / C4;
  const int xo = static_cast<int>(pix % W);
  const int yo = static_cast<int>(pix / W % H);
  const int b = static_cast<int>(pix / W / H);
  const size_t row = static_cast<size_t>(2 * W) * C4;  // one input row
  const float4* p =
      x + ((static_cast<size_t>(b) * 2 * H + 2 * yo) * 2 * W + 2 * xo) * C4 + c;
  const float4 m0 = max4(p[0], p[row]);        // column 2x
  const float4 m1 = max4(p[C4], p[row + C4]);  // column 2x + 1
  out[idx] = max4(m0, m1);
}

}  // namespace

// x [B, 2H, 2W, C], out [B, H, W, C]; C % 4 == 0, both 16-byte aligned.
extern "C" int dnnca_pool2x2_nhwc(const float* x, float* out, int B, int H,
                                  int W, int C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t n = static_cast<size_t>(B) * H * W * (C / 4);
  pool_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out), B,
      H, W, C / 4);
  return cudaGetLastError();
}
