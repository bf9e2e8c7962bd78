// Backward of the fused conv chain c1 = relu(conv(x, w1) + b1),
// c2 = relu(conv(c1, w2) + b2) (conv_chain.cu):
//   g2  = g * (c2 > 0)
//   dw2, db2 from (g2, c1);  dc1 = conv(g2, flip(w2)^T) * (c1 > 0)
//   dw1, db1 from (dc1, x);  dx  = conv(dc1, flip(w1)^T)   (optional)
// The relu masks come from the saved post-relu outputs c1 and c2, as in the
// JAX kernels; the pre-activations are never recomputed.
//
// Replaces the backward kernels of both chain formulations of the JAX
// package: conv_kernel.conv_chain_bwd_pallas
// (dnncancerannotator_tpu/ops/pallas/conv_kernel.py:487) and flatchain's
// _bwd_call_im2col / _bwd_call (flatchain.py:293, :372). ``dx == nullptr``
// is need_dx=False there: the first chain of the model skips its dx stencil.
//
// Layout: NCHW f32; w1 [Cm, Ci, K, K], w2 [Co, Cm, K, K]; stride 1, odd K,
// "same" pads K/2; Ci, Cm, Co <= 32.
//
// One entry point, five launches on the caller's stream:
// 1. dgrad (this file): one block per (image, tile_h x 32 tile). It stages
//    g2 over the tile with a 2-pixel halo (for K = 3), computes dc1 over the
//    tile plus a 1-pixel halo into shared memory (zero outside the image and
//    where c1 <= 0), writes the tile's dc1 to device memory for step 3, and
//    then dx over the tile from that shared dc1. It is the forward chain's
//    structure (conv_tile.cuh) with the weights flipped and transposed.
//    Bound by shared-memory loads, as the forward is.
// 2. wgrad of conv2 from (g masked by c2, c1), and 3. wgrad of conv1 from
//    (dc1, x), each followed by its fixed-order partial sum (wgrad.cu).
#include "conv_tile.cuh"
#include "wgrad.cuh"

namespace {

using dnnca::tile::conv_pixel;
using dnnca::tile::kThreads;
using dnnca::tile::kTileW;
using dnnca::tile::stage_weights;

struct DgradArgs {
  const float* g;
  const float* c1;
  const float* c2;
  const float* w1;
  const float* w2;
  float* dc1;
  float* dx;  // may be null
  int B, Ci, Cm, Co, H, W, K, tile_h;
};

template <int C, int KT>
__global__ void __launch_bounds__(kThreads) chain_dgrad_kernel(DgradArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int K = KT > 0 ? KT : a.K;
  const int p = K / 2, KK = K * K;
  const int Ci = a.Ci, Cm = a.Cm, Co = a.Co, H = a.H, W = a.W;
  const bool need_dx = a.dx != nullptr;
  const int tile_h = a.tile_h;
  const int gs_w = kTileW + 4 * p, ds_w = kTileW + 2 * p;
  const int gs_plane = (tile_h + 4 * p) * gs_w;
  const int ds_plane = (tile_h + 2 * p) * ds_w;
  float* w2s = smem;                                 // [Co][KK][C]
  float* w1s = w2s + Co * KK * C;                    // [Cm][KK][C]
  float* gs = w1s + (need_dx ? Cm * KK * C : 0);     // [Co][..][gs_w]
  float* ds = gs + Co * gs_plane;                    // [Cm][..][ds_w]

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * tile_h, x0 = blockIdx.x * kTileW;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* gb = a.g + static_cast<size_t>(b) * Co * plane;
  const float* c2b = a.c2 + static_cast<size_t>(b) * Co * plane;
  const float* c1b = a.c1 + static_cast<size_t>(b) * Cm * plane;

  stage_weights<C, true>(w2s, a.w2, Cm, Co, KK);
  if (need_dx) stage_weights<C, true>(w1s, a.w1, Ci, Cm, KK);
  for (int i = tid; i < Co * gs_plane; i += kThreads) {
    const int c = i / gs_plane, r = i % gs_plane / gs_w, col = i % gs_w;
    const int gy = y0 - 2 * p + r, gx = x0 - 2 * p + col;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const size_t idx = c * plane + static_cast<size_t>(gy) * W + gx;
      v = c2b[idx] > 0.f ? gb[idx] : 0.f;
    }
    gs[i] = v;
  }
  __syncthreads();

  // dc1 over the tile plus its p-pixel halo
  for (int pos = tid; pos < ds_plane; pos += kThreads) {
    const int r = pos / ds_w, col = pos % ds_w;
    const int gy = y0 - p + r, gx = x0 - p + col;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    float acc[C];
#pragma unroll
    for (int m = 0; m < C; ++m) acc[m] = 0.f;
    if (inside)
      conv_pixel<C, KT>(acc, gs + r * gs_w + col, gs_plane, gs_w, w2s, Co,
                        K);
    const size_t pix = inside ? static_cast<size_t>(gy) * W + gx : 0;
#pragma unroll
    for (int m = 0; m < C; ++m)
      if (m < Cm)
        ds[m * ds_plane + pos] =
            inside && c1b[m * plane + pix] > 0.f ? acc[m] : 0.f;
  }
  __syncthreads();

  // the tile's dc1 (for the conv1 wgrad), then dx
  const int n_out = tile_h * kTileW;
  for (int pos = tid; pos < n_out; pos += kThreads) {
    const int r = pos / kTileW, col = pos % kTileW;
    const int gy = y0 + r, gx = x0 + col;
    if (gy >= H || gx >= W) continue;
    const size_t pix = static_cast<size_t>(gy) * W + gx;
    float* dc1b = a.dc1 + static_cast<size_t>(b) * Cm * plane + pix;
    for (int m = 0; m < Cm; ++m)
      dc1b[m * plane] = ds[m * ds_plane + (r + p) * ds_w + col + p];
    if (!need_dx) continue;
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    conv_pixel<C, KT>(acc, ds + r * ds_w + col, ds_plane, ds_w, w1s, Cm, K);
    float* dxb = a.dx + static_cast<size_t>(b) * Ci * plane + pix;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (c < Ci) dxb[c * plane] = acc[c];
  }
}

template <int C, int KT>
cudaError_t launch_dgrad(const DgradArgs& a, int smem_bytes,
                         cudaStream_t stream) {
  cudaError_t err = dnnca::allow_smem(chain_dgrad_kernel<C, KT>, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.W + kTileW - 1) / kTileW,
                  (a.H + a.tile_h - 1) / a.tile_h, a.B);
  chain_dgrad_kernel<C, KT><<<grid, kThreads, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int KT>
cudaError_t dispatch_dgrad(const DgradArgs& a, int smem_bytes,
                           cudaStream_t s) {
  int c = a.Cm;
  if (a.dx != nullptr && a.Ci > c) c = a.Ci;
  if (c <= 4) return launch_dgrad<4, KT>(a, smem_bytes, s);
  if (c <= 8) return launch_dgrad<8, KT>(a, smem_bytes, s);
  if (c <= 16) return launch_dgrad<16, KT>(a, smem_bytes, s);
  return launch_dgrad<32, KT>(a, smem_bytes, s);
}

}  // namespace

// dx may be null (no data gradient). dw1b is [Cm*Ci*K*K + Cm] (dw1 then
// db1), dw2b is [Co*Cm*K*K + Co]; dc1 is [B, Cm, H, W] scratch and partial
// is [max(size of dw1b, size of dw2b) * wgrad_blocks] scratch. smem_bytes and
// tile_h come from the wrapper (ops/kernels/conv_chain_bwd.py).
extern "C" int dnnca_conv_chain_bwd(
    const float* x, const float* c1, const float* c2, const float* g,
    const float* w1, const float* w2, float* dx, float* dc1, float* dw1b,
    float* dw2b, float* partial, int B, int Ci, int Cm, int Co, int H, int W,
    int K, int tile_h, int smem_bytes, int wgrad_blocks, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DgradArgs d{g, c1, c2, w1, w2, dc1, dx, B, Ci, Cm, Co, H, W, K,
                    tile_h};
  err = K == 3 ? dispatch_dgrad<3>(d, smem_bytes, s)
               : dispatch_dgrad<0>(d, smem_bytes, s);
  if (err != cudaSuccess) return err;
  const int p = K / 2;
  const dnnca::WgradArgs w2g{g,  c2, c1, partial, dw2b, B, Co, Cm, H, W, H,
                             W,  K,  K,  p,       p,    wgrad_blocks};
  err = dnnca::launch_wgrad(w2g, s);
  if (err != cudaSuccess) return err;
  const dnnca::WgradArgs w1g{dc1, nullptr, x, partial, dw1b, B, Cm, Ci, H, W,
                             H,   W,       K, K,       p,    p, wgrad_blocks};
  return dnnca::launch_wgrad(w1g, s);
}
