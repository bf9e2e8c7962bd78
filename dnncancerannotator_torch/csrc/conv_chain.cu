// Fused conv chain: c1 = relu(conv(x, w1) + b1), c2 = relu(conv(c1, w2) + b2).
//
// Replaces two Pallas kernels of the JAX package that compute this one
// function: conv_kernel.conv_chain_pallas
// (dnncancerannotator_tpu/ops/pallas/conv_kernel.py:340, the scalar stencil
// chain) and flatchain.conv_chain_flat_nchw
// (dnncancerannotator_tpu/ops/pallas/flatchain.py:416, the MXU "flatland"
// chain). Both are TPU layout work-arounds (lane rolls, im2col scratch,
// SMEM scalars); none of that is carried over.
//
// Layout: NCHW f32; w1 [Cm, Ci, K, K], w2 [Co, Cm, K, K] (PyTorch OIHW);
// stride 1, odd K, symmetric "same" pads K/2, so both convs keep H x W.
// Ci, Cm, Co <= 32.
//
// What bounds it on the H100: at the model's widths (3 to 24 channels) one
// output pixel costs 0.2k to 4.4k FMAs while its bytes in device memory are
// (Ci + Co) * 4, so the kernel is not bound by DRAM but by shared-memory
// loads: each input value is one load, and the weights of one (input
// channel, tap) are a warp-wide broadcast.
//
// Design: one block per (image, 16 x 32 output tile; 8 x 32 or 4 x 32 when
// the channels are wide). The block stages the input tile with a 2-pixel
// halo (for K = 3) and both weight sets in shared memory, computes c1 over
// the tile plus a 1-pixel halo into shared memory (zero outside the image,
// which is conv2's zero padding), then c2 over the tile. c1 never goes to
// device memory unless the caller passes a buffer for it (a backward pass
// needs it as a residual; prediction does not). The halo recompute costs
// about 20% extra conv1 work at 16 x 32.
//
// Each thread keeps the output channels of one pixel in registers, with the
// weights staged as float4 broadcasts (conv_tile.cuh). K = 3 is a template
// case with the taps unrolled; other odd K run the same code with a runtime
// tap loop.
#include "conv_tile.cuh"

namespace {

using dnnca::tile::conv_pixel;
using dnnca::tile::kThreads;
using dnnca::tile::kTileW;
using dnnca::tile::stage_weights;

struct ChainArgs {
  const float* x;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  float* c1_out;  // may be null
  float* c2;
  int B, Ci, Cm, Co, H, W, K, tile_h;
};

template <int C, int KT>
__global__ void __launch_bounds__(kThreads) conv_chain_kernel(ChainArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int K = KT > 0 ? KT : a.K;
  const int p = K / 2, KK = K * K;
  const int Ci = a.Ci, Cm = a.Cm, Co = a.Co, H = a.H, W = a.W;
  const int tile_h = a.tile_h;
  const int xs_h = tile_h + 4 * p, xs_w = kTileW + 4 * p;
  const int cs_h = tile_h + 2 * p, cs_w = kTileW + 2 * p;
  const int xs_plane = xs_h * xs_w, cs_plane = cs_h * cs_w;
  float* w1s = smem;                  // [Ci][KK][C]
  float* w2s = w1s + Ci * KK * C;     // [Cm][KK][C]
  float* b1s = w2s + Cm * KK * C;     // [C]
  float* b2s = b1s + C;               // [C]
  float* xs = b2s + C;                // [Ci][xs_h][xs_w]
  float* cs = xs + Ci * xs_plane;     // [Cm][cs_h][cs_w]

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * tile_h, x0 = blockIdx.x * kTileW;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* xb = a.x + static_cast<size_t>(b) * Ci * plane;

  stage_weights<C>(w1s, a.w1, Cm, Ci, KK);
  stage_weights<C>(w2s, a.w2, Co, Cm, KK);
  for (int i = tid; i < C; i += kThreads) {
    b1s[i] = i < Cm ? a.b1[i] : 0.f;
    b2s[i] = i < Co ? a.b2[i] : 0.f;
  }
  for (int i = tid; i < Ci * xs_plane; i += kThreads) {
    const int c = i / xs_plane, r = (i % xs_plane) / xs_w, col = i % xs_w;
    const int gy = y0 - 2 * p + r, gx = x0 - 2 * p + col;
    xs[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                ? xb[c * plane + static_cast<size_t>(gy) * W + gx]
                : 0.f;
  }
  __syncthreads();

  // conv1 over the tile plus its p-pixel halo
  for (int pos = tid; pos < cs_plane; pos += kThreads) {
    const int r = pos / cs_w, col = pos % cs_w;
    const int gy = y0 - p + r, gx = x0 - p + col;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    float acc[C];
#pragma unroll
    for (int m = 0; m < C; ++m) acc[m] = b1s[m];
    if (inside)
      conv_pixel<C, KT>(acc, xs + r * xs_w + col, xs_plane, xs_w, w1s, Ci,
                        K);
#pragma unroll
    for (int m = 0; m < C; ++m)
      if (m < Cm) cs[m * cs_plane + pos] = inside ? fmaxf(acc[m], 0.f) : 0.f;
  }
  __syncthreads();

  // conv2 over the tile
  const int n_out = tile_h * kTileW;
  for (int pos = tid; pos < n_out; pos += kThreads) {
    const int r = pos / kTileW, col = pos % kTileW;
    const int gy = y0 + r, gx = x0 + col;
    if (gy >= H || gx >= W) continue;
    float acc[C];
#pragma unroll
    for (int o = 0; o < C; ++o) acc[o] = b2s[o];
    conv_pixel<C, KT>(acc, cs + r * cs_w + col, cs_plane, cs_w, w2s, Cm, K);
    const size_t pix = static_cast<size_t>(gy) * W + gx;
    float* c2b = a.c2 + static_cast<size_t>(b) * Co * plane + pix;
#pragma unroll
    for (int o = 0; o < C; ++o)
      if (o < Co) c2b[o * plane] = fmaxf(acc[o], 0.f);
    if (a.c1_out != nullptr) {
      float* c1b = a.c1_out + static_cast<size_t>(b) * Cm * plane + pix;
      for (int m = 0; m < Cm; ++m)
        c1b[m * plane] = cs[m * cs_plane + (r + p) * cs_w + col + p];
    }
  }
}

template <int C, int KT>
cudaError_t launch(const ChainArgs& a, int smem_bytes, cudaStream_t stream) {
  cudaError_t err = dnnca::allow_smem(conv_chain_kernel<C, KT>, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.W + kTileW - 1) / kTileW,
                  (a.H + a.tile_h - 1) / a.tile_h, a.B);
  conv_chain_kernel<C, KT><<<grid, kThreads, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int KT>
cudaError_t dispatch(const ChainArgs& a, int smem_bytes, cudaStream_t s) {
  const int c = a.Cm > a.Co ? a.Cm : a.Co;
  if (c <= 4) return launch<4, KT>(a, smem_bytes, s);
  if (c <= 8) return launch<8, KT>(a, smem_bytes, s);
  if (c <= 16) return launch<16, KT>(a, smem_bytes, s);
  return launch<32, KT>(a, smem_bytes, s);
}

}  // namespace

// c1 may be null. smem_bytes is computed by the wrapper from the layout
// above (ops/kernels/conv_chain.py: _smem_bytes).
extern "C" int dnnca_conv_chain(const float* x, const float* w1,
                                const float* b1, const float* w2,
                                const float* b2, float* c1, float* c2, int B,
                                int Ci, int Cm, int Co, int H, int W, int K,
                                int tile_h, int smem_bytes, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const ChainArgs a{x, w1, b1, w2, b2, c1, c2, B, Ci, Cm, Co, H, W, K, tile_h};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return K == 3 ? dispatch<3>(a, smem_bytes, s) : dispatch<0>(a, smem_bytes, s);
}
