// ConvTranspose with kernel 2, stride 2, plus bias:
//   out[b, co, 2y+dy, 2x+dx] = bias[co] + sum_ci x[b, ci, y, x] * w[ci, co, dy, dx]
//
// Replaces flattconv.conv_transpose2x2_flat_nchw
// (dnncancerannotator_tpu/ops/pallas/flattconv.py:200), whose kernel
// interleaves the phases with permutation-matrix dots on the MXU because a
// TPU has no cheap strided store. It also serves the decoder's two smaller
// upsamples, which the JAX package computes as a plain einsum
// (fastconv.stencil_conv_transpose2d) because its kernel needs W % 128 == 0.
//
// Weight layout: PyTorch's ConvTranspose2d [Ci, Co, 2, 2], applied without
// a flip. The flax HWIO kernel is applied flipped by lax.conv_transpose
// (out[2y+dy, 2x+dx] uses k[1-dy, 1-dx]); convert.py does that flip once
// when it carries the weights across. NCHW f32, Ci, Co <= 64, any H, W.
//
// What bounds it on the H100: 2 * Ci FLOPs per output element against
// 4 bytes written per output and Ci * 4 read per input pixel, so it is
// bound by device-memory bytes at every width the model uses.
//
// Design: one thread per input pixel. It loads the pixel's Ci inputs into
// registers once, then for each output channel writes the 2 x 2 output
// block as two float2 stores (rows 2y and 2y+1). Neighbouring threads take
// neighbouring x, so each store is one coalesced run of 8-byte pairs; the
// phase interleave is just the store address, with no shuffle or copy.
// Weights and bias sit in shared memory; the four taps of one (ci, co) are
// one float4 broadcast.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// CI: the input-channel bucket (4 .. 64, the smallest that holds Ci). The
// inputs and weights are zero-padded to it, so the inner loop runs CI
// iterations with no per-channel guard.
template <int CI>
__global__ void __launch_bounds__(kThreads)
tconv2x2_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ out,
                int B, int Ci, int Co, int H, int W) {
  extern __shared__ float4 smem4[];
  float4* ws = smem4;                                  // [CI][Co] x (2x2)
  float* bs = reinterpret_cast<float*>(smem4 + CI * Co);  // [Co]
  for (int i = threadIdx.x; i < CI * Co; i += kThreads)
    ws[i] = i < Ci * Co ? reinterpret_cast<const float4*>(w)[i]
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < Co; i += kThreads) bs[i] = bias[i];
  __syncthreads();

  const size_t plane = static_cast<size_t>(H) * W;
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<size_t>(B) * plane) return;
  const int b = static_cast<int>(idx / plane);
  const size_t pix = idx % plane;
  const int y = static_cast<int>(pix / W), xx = static_cast<int>(pix % W);

  float xv[CI];
  const float* xb = x + static_cast<size_t>(b) * Ci * plane + pix;
#pragma unroll
  for (int c = 0; c < CI; ++c) xv[c] = c < Ci ? xb[c * plane] : 0.f;

  const int OW = 2 * W;
  const size_t oplane = 4 * plane;
  float* ob = out + static_cast<size_t>(b) * Co * oplane +
              static_cast<size_t>(2 * y) * OW + 2 * xx;
  for (int o = 0; o < Co; ++o) {
    float a00 = bs[o], a01 = bs[o], a10 = bs[o], a11 = bs[o];
#pragma unroll
    for (int c = 0; c < CI; ++c) {
      const float4 wq = ws[c * Co + o];   // (dy, dx) = 00, 01, 10, 11
      a00 = fmaf(xv[c], wq.x, a00);
      a01 = fmaf(xv[c], wq.y, a01);
      a10 = fmaf(xv[c], wq.z, a10);
      a11 = fmaf(xv[c], wq.w, a11);
    }
    float* op = ob + o * oplane;
    *reinterpret_cast<float2*>(op) = make_float2(a00, a01);
    *reinterpret_cast<float2*>(op + OW) = make_float2(a10, a11);
  }
}

template <int CI>
cudaError_t launch(const float* x, const float* w, const float* bias,
                   float* out, int B, int Ci, int Co, int H, int W,
                   cudaStream_t stream) {
  const size_t smem_bytes = (static_cast<size_t>(CI) * Co * 4 + Co) * 4;
  cudaError_t err = dnnca::allow_smem(tconv2x2_kernel<CI>, smem_bytes);
  if (err != cudaSuccess) return err;
  const size_t n = static_cast<size_t>(B) * H * W;
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  tconv2x2_kernel<CI><<<grid, kThreads, smem_bytes, stream>>>(
      x, w, bias, out, B, Ci, Co, H, W);
  return dnnca::launched(cudaGetLastError());
}

}  // namespace

extern "C" int dnnca_tconv2x2(const float* x, const float* w,
                              const float* bias, float* out, int B, int Ci,
                              int Co, int H, int W, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Ci <= 4) return launch<4>(x, w, bias, out, B, Ci, Co, H, W, s);
  if (Ci <= 8) return launch<8>(x, w, bias, out, B, Ci, Co, H, W, s);
  if (Ci <= 16) return launch<16>(x, w, bias, out, B, Ci, Co, H, W, s);
  if (Ci <= 32) return launch<32>(x, w, bias, out, B, Ci, Co, H, W, s);
  return launch<64>(x, w, bias, out, B, Ci, Co, H, W, s);
}
