// Backward of the stride-1 stencil conv (stencil_conv.cu):
//   dx[b, c, y, x] = sum_{o, ky, kx} g[b, o, y + pt - ky, x + pl - kx] * w[o, c, ky, kx]
//   dw, db         = wgrad of (g, x) (wgrad.cu)
// g arrives already masked by the forward's output when the relu is fused
// (the wrapper does it, as fastconv.py:200-201 does in the JAX package).
//
// Replaces conv_kernel.stencil_conv2d_bwd_pallas
// (dnncancerannotator_tpu/ops/pallas/conv_kernel.py:175). NCHW f32,
// w [Co, Ci, KH, KW], any pads; Ci, Co <= 32. On the model's path it is the
// 1 x 1, 3 -> 1 logits head.
//
// What bounds it on the H100: at the head, 3 FMAs per pixel of dx against
// 16 bytes of device memory, so device-memory bytes, as for the forward.
//
// Design: dx is one thread per input pixel with the Ci gradients in
// registers (a template bucket CI) and the weights in shared memory as
// [Co][KH][KW][CI] float4 broadcasts; the output window is a bounds test on
// the index of g, never a padded copy. dw and db go through the shared
// wgrad kernel and its fixed-order partial sum.
#include "conv_tile.cuh"
#include "wgrad.cuh"

namespace {

using dnnca::tile::tap;

constexpr int kThreads = 256;

template <int CI>
__global__ void __launch_bounds__(kThreads)
stencil_dgrad_kernel(const float* __restrict__ g, const float* __restrict__ w,
                     float* __restrict__ dx, int B, int Ci, int Co, int H,
                     int W, int KH, int KW, int pt, int pl, int OH, int OW) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [Co][KH][KW][CI]
  const int taps = KH * KW;
  for (int i = threadIdx.x; i < Co * taps * CI; i += kThreads) {
    const int c = i % CI, t = (i / CI) % taps, o = i / (CI * taps);
    ws[i] = c < Ci ? w[(o * Ci + c) * taps + t] : 0.f;
  }
  __syncthreads();

  const size_t plane = static_cast<size_t>(H) * W;
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<size_t>(B) * plane) return;
  const int b = static_cast<int>(idx / plane);
  const size_t pix = idx % plane;
  const int iy = static_cast<int>(pix / W), ix = static_cast<int>(pix % W);

  float acc[CI];
#pragma unroll
  for (int c = 0; c < CI; ++c) acc[c] = 0.f;
  const size_t oplane = static_cast<size_t>(OH) * OW;
  const float* gb = g + static_cast<size_t>(b) * Co * oplane;
  const float4* ws4 = reinterpret_cast<const float4*>(ws);
  for (int o = 0; o < Co; ++o) {
    for (int ky = 0; ky < KH; ++ky) {
      const int oy = iy + pt - ky;
      if (oy < 0 || oy >= OH) continue;
      for (int kx = 0; kx < KW; ++kx) {
        const int ox = ix + pl - kx;
        if (ox < 0 || ox >= OW) continue;
        tap<CI>(acc, gb[o * oplane + static_cast<size_t>(oy) * OW + ox],
                ws4 + ((o * KH + ky) * KW + kx) * (CI / 4));
      }
    }
  }
  float* dxb = dx + static_cast<size_t>(b) * Ci * plane + pix;
#pragma unroll
  for (int c = 0; c < CI; ++c)
    if (c < Ci) dxb[c * plane] = acc[c];
}

template <int CI>
cudaError_t launch_dgrad(const float* g, const float* w, float* dx, int B,
                         int Ci, int Co, int H, int W, int KH, int KW, int pt,
                         int pl, int OH, int OW, cudaStream_t stream) {
  const size_t smem_bytes = static_cast<size_t>(Co) * KH * KW * CI * 4;
  cudaError_t err = dnnca::allow_smem(stencil_dgrad_kernel<CI>, smem_bytes);
  if (err != cudaSuccess) return err;
  const size_t n = static_cast<size_t>(B) * H * W;
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  stencil_dgrad_kernel<CI><<<grid, kThreads, smem_bytes, stream>>>(
      g, w, dx, B, Ci, Co, H, W, KH, KW, pt, pl, OH, OW);
  return cudaGetLastError();
}

}  // namespace

// dx may be null (no data gradient). dwb is [Co*Ci*KH*KW + Co] (dw then
// db); partial is [size of dwb * wgrad_blocks] scratch.
extern "C" int dnnca_stencil_conv_bwd(
    const float* x, const float* g, const float* w, float* dx, float* dwb,
    float* partial, int B, int Ci, int Co, int H, int W, int KH, int KW,
    int pt, int pl, int OH, int OW, int wgrad_blocks, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dx != nullptr) {
#define DNNCA_DGRAD(CI) \
  launch_dgrad<CI>(g, w, dx, B, Ci, Co, H, W, KH, KW, pt, pl, OH, OW, s)
    err = Ci <= 4    ? DNNCA_DGRAD(4)
          : Ci <= 8  ? DNNCA_DGRAD(8)
          : Ci <= 16 ? DNNCA_DGRAD(16)
                     : DNNCA_DGRAD(32);
#undef DNNCA_DGRAD
    if (err != cudaSuccess) return err;
  }
  const dnnca::WgradArgs wg{g,  nullptr, x,  partial, dwb, B,  Co, Ci, OH,
                            OW, H,       W,  KH,      KW,  pt, pl, wgrad_blocks};
  return dnnca::launch_wgrad(wg, s);
}
