// Stride-1 convolution with explicit pads, bias and an optional fused relu:
//   out[b, o, y, x] = bias[o] + sum_{c, ky, kx} xpad[b, c, y+ky, x+kx] * w[o, c, ky, kx]
// where xpad is x zero-padded by (pt, pb) rows and (pl, pr) columns;
// OH = H + pt + pb - KH + 1 and OW likewise (the wrapper passes both).
//
// Replaces conv_kernel.stencil_conv2d_pallas
// (dnncancerannotator_tpu/ops/pallas/conv_kernel.py:84), which keeps a
// whole padded image in VMEM and reads the weights as SMEM scalars.
// NCHW f32, w [Co, Ci, KH, KW] (PyTorch OIHW), Ci, Co <= 32. On the model's
// path it runs the 1 x 1, 3 -> 1 logits head.
//
// What bounds it on the H100: for the head, 3 FMAs per output pixel against
// 16 bytes of device memory (12 read, 4 written), so device-memory bytes.
// Wider stencils at these widths do at most a few hundred FMAs per pixel
// and stay near that bound.
//
// Design: one thread per output pixel, all Co accumulators in registers
// (a template bucket of Co), weights and bias in shared memory (broadcast
// reads). Neighbouring threads take neighbouring x, so every input and
// output access is coalesced; the padding is a bounds test on the input
// index, never a padded copy.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// CO: the output-channel bucket (1, 4, 8, 16 or 32, the smallest that holds
// Co). Weights are staged as [Ci][KH][KW][CO], zero-padded, so each tap
// runs CO FMAs with no per-channel guard.
template <int CO>
__global__ void __launch_bounds__(kThreads)
stencil_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int B, int Ci, int Co, int H, int W, int KH, int KW,
                    int pt, int pl, int OH, int OW, int relu) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int taps = KH * KW;
  const int n_w = Ci * taps * CO;
  float* ws = smem;         // [Ci][KH][KW][CO]
  float* bs = smem + n_w;   // [CO]
  for (int i = threadIdx.x; i < n_w; i += kThreads) {
    const int o = i % CO, t = (i / CO) % taps, c = i / (CO * taps);
    ws[i] = o < Co ? w[(o * Ci + c) * taps + t] : 0.f;
  }
  for (int i = threadIdx.x; i < CO; i += kThreads)
    bs[i] = i < Co ? bias[i] : 0.f;
  __syncthreads();

  const size_t oplane = static_cast<size_t>(OH) * OW;
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<size_t>(B) * oplane) return;
  const int b = static_cast<int>(idx / oplane);
  const size_t pix = idx % oplane;
  const int oy = static_cast<int>(pix / OW), ox = static_cast<int>(pix % OW);

  float acc[CO];
#pragma unroll
  for (int o = 0; o < CO; ++o) acc[o] = bs[o];
  const size_t plane = static_cast<size_t>(H) * W;
  const float* xb = x + static_cast<size_t>(b) * Ci * plane;
  for (int c = 0; c < Ci; ++c) {
    for (int ky = 0; ky < KH; ++ky) {
      const int iy = oy - pt + ky;
      if (iy < 0 || iy >= H) continue;
      for (int kx = 0; kx < KW; ++kx) {
        const int ix = ox - pl + kx;
        if (ix < 0 || ix >= W) continue;
        const float v = xb[c * plane + static_cast<size_t>(iy) * W + ix];
        const float* wt = ws + ((c * KH + ky) * KW + kx) * CO;
#pragma unroll
        for (int o = 0; o < CO; ++o) acc[o] = fmaf(v, wt[o], acc[o]);
      }
    }
  }
  float* ob = out + static_cast<size_t>(b) * Co * oplane + pix;
#pragma unroll
  for (int o = 0; o < CO; ++o)
    if (o < Co) ob[o * oplane] = relu ? fmaxf(acc[o], 0.f) : acc[o];
}

template <int CO>
cudaError_t launch(const float* x, const float* w, const float* bias,
                   float* out, int B, int Ci, int Co, int H, int W, int KH,
                   int KW, int pt, int pl, int OH, int OW, int relu,
                   cudaStream_t stream) {
  const size_t smem_bytes = (static_cast<size_t>(Ci) * KH * KW + 1) * CO * 4;
  cudaError_t err = dnnca::allow_smem(stencil_conv_kernel<CO>, smem_bytes);
  if (err != cudaSuccess) return err;
  const size_t n = static_cast<size_t>(B) * OH * OW;
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  stencil_conv_kernel<CO><<<grid, kThreads, smem_bytes, stream>>>(
      x, w, bias, out, B, Ci, Co, H, W, KH, KW, pt, pl, OH, OW, relu);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dnnca_stencil_conv(const float* x, const float* w,
                                  const float* bias, float* out, int B,
                                  int Ci, int Co, int H, int W, int KH,
                                  int KW, int pt, int pl, int OH, int OW,
                                  int relu, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DNNCA_STENCIL(CO)                                                  \
  launch<CO>(x, w, bias, out, B, Ci, Co, H, W, KH, KW, pt, pl, OH, OW, relu, \
             s)
  if (Co <= 1) return DNNCA_STENCIL(1);
  if (Co <= 4) return DNNCA_STENCIL(4);
  if (Co <= 8) return DNNCA_STENCIL(8);
  if (Co <= 16) return DNNCA_STENCIL(16);
  return DNNCA_STENCIL(32);
#undef DNNCA_STENCIL
}
