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
// (Ci + Co) * 4, so the f32 FMA rate bounds it, and in practice the issue
// slots: every shared-memory load is an instruction that does no FMA.
//
// Design: one block per (image, tile_h x tile_w output tile); the tile and
// the block size are chosen per shape by the wrapper
// (ops/kernels/conv_chain.py: plan). The block stages both weight sets and
// the input tile with a 2p halo with cp.async (8-byte copies where W is
// even, zero-filled outside the image: the halo's 2p offset leaves the
// rows 8-byte aligned at best), computes c1 over the tile plus a p halo
// into shared memory (zero outside the image, which is conv2's zero
// padding), then c2 over the tile. Blocks that each walk several tiles,
// staging the next tile's input while computing on this one, measured
// slower (twice the input buffer leaves fewer blocks an SM; PERF.md), so a
// block takes one tile. c1 goes to device memory only when the caller
// passes a buffer for it (training keeps it for the backward's relu mask).
//
// Each conv is register-blocked (conv_tile.cuh): a work item is a run of 4
// or 8 pixels along a row for a group of CPT output channels, with the
// window of each input row loaded once as float4s and reused across the K
// taps. CPT is the exact channel count (3, 6 or 12 at the model's sites),
// so no FMA multiplies padding. Tensor cores are not the lever here: with
// 3-12 output channels an mma tile is mostly padding, and f32 accuracy
// needs the 3xTF32 split, which the tconv GEMM's first design measured as
// issue-bound (PERF.md): under 2x the FMA rate at best.
#include "conv_tile.cuh"

namespace {

using dnnca::tile::conv_run;
using dnnca::tile::pad4;
using dnnca::tile::run_px;
using dnnca::tile::stage_weights;
using dnnca::tile::stage_window;
using dnnca::tile::store_run;

struct ChainArgs {
  const float* x;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  float* c1_out;  // may be null
  float* c2;
  int B, Ci, Cm, Co, H, W, K;
  // geometry from the wrapper: the output tile, the width of the c1 tile
  // (a multiple of the run length), and the row strides of the c1 and the
  // input tile (4 mod 8 floats: the float4 loads of eight lanes on eight
  // consecutive rows hit distinct banks)
  int tile_h, tile_w, c1_w, c1_s, xs_w;
};

template <int CPT, int KT>
__global__ void __launch_bounds__(256, 2) conv_chain_kernel(ChainArgs a) {
  constexpr int PX = run_px(CPT), CP = pad4(CPT);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int K = KT > 0 ? KT : a.K;
  const int p = K / 2, KK = K * K;
  const int Ci = a.Ci, Cm = a.Cm, Co = a.Co, H = a.H, W = a.W;
  const int th = a.tile_h, tw = a.tile_w, c1_w = a.c1_w, xs_w = a.xs_w;
  const int c1_s = a.c1_s;
  const int g1 = (Cm + CPT - 1) / CPT, g2 = (Co + CPT - 1) / CPT;
  const int w1_row = g1 * CP, w2_row = g2 * CP;
  const int c1_h = th + 2 * p, xs_h = th + 4 * p;
  const int c1_plane = c1_h * c1_s, xs_plane = xs_h * xs_w;
  float* w1s = smem;                  // [Ci][KK][w1_row]
  float* w2s = w1s + Ci * KK * w1_row;  // [Cm][KK][w2_row]
  float* b1s = w2s + Cm * KK * w2_row;  // [w1_row]
  float* b2s = b1s + w1_row;            // [w2_row]
  float* xs = b2s + w2_row;             // [Ci][xs_h][xs_w]
  float* cs = xs + Ci * xs_plane;       // [Cm][c1_h][c1_s]

  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * th, x0 = blockIdx.x * tw;
  const size_t plane = static_cast<size_t>(H) * W;

  stage_window(xs, a.x + static_cast<size_t>(b) * Ci * plane, Ci, xs_h,
               c1_w + 2 * p, xs_w, y0 - 2 * p, x0 - 2 * p, H, W);
  stage_weights<false>(w1s, a.w1, Cm, Ci, KK, CPT, g1);
  stage_weights<false>(w2s, a.w2, Co, Cm, KK, CPT, g2);
  dnnca::tile::stage_bias(b1s, a.b1, Cm, CPT, g1);
  dnnca::tile::stage_bias(b2s, a.b2, Co, CPT, g2);
  dnnca::tile::cp_async_wait_all();
  __syncthreads();
  {
    // conv1 over the tile plus its p halo: c1_w / PX runs of c1_h rows,
    // the rows fastest across the lanes
    const int per_g1 = c1_h * (c1_w / PX);
    for (int it = tid; it < g1 * per_g1; it += nt) {
      const int g = it / per_g1, rem = it - g * per_g1;
      const int run = rem / c1_h, r = rem - run * c1_h, col = run * PX;
      float acc[PX][CPT];
#pragma unroll
      for (int j = 0; j < PX; ++j)
#pragma unroll
        for (int o = 0; o < CPT; ++o) acc[j][o] = b1s[g * CP + o];
      conv_run<CPT, KT>(acc, xs + r * xs_w + col, xs_plane, xs_w,
                        w1s + g * CP, w1_row, Ci, K);
      const int gy = y0 - p + r, gx = x0 - p + col;
      const bool row_in = gy >= 0 && gy < H;
#pragma unroll
      for (int o = 0; o < CPT; ++o) {
        if (g * CPT + o >= Cm) break;
        float4* dst = reinterpret_cast<float4*>(
            cs + (g * CPT + o) * c1_plane + r * c1_s + col);
#pragma unroll
        for (int q = 0; q < PX / 4; ++q) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = gx + 4 * q + e;
            v[e] = row_in && x >= 0 && x < W ? fmaxf(acc[4 * q + e][o], 0.f)
                                             : 0.f;
          }
          dst[q] = make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
    __syncthreads();

    if (a.c1_out != nullptr) {  // the tile's c1, one warp a row
      float* c1b = a.c1_out + static_cast<size_t>(b) * Cm * plane;
      for (int pr = tid >> 5; pr < Cm * th; pr += nt >> 5) {
        const int m = pr / th, r = pr - m * th, gy = y0 + r;
        if (gy >= H) continue;
        for (int c = tid & 31; c < tw && x0 + c < W; c += 32)
          c1b[m * plane + static_cast<size_t>(gy) * W + x0 + c] =
              cs[m * c1_plane + (r + p) * c1_s + c + p];
      }
    }

    // conv2 over the tile
    const int per_g2 = th * (tw / PX);
    float* c2b = a.c2 + static_cast<size_t>(b) * Co * plane;
    for (int it = tid; it < g2 * per_g2; it += nt) {
      const int g = it / per_g2, rem = it - g * per_g2;
      const int run = rem / th, r = rem - run * th, col = run * PX;
      const int gy = y0 + r, gx = x0 + col;
      if (gy >= H || gx >= W) continue;
      float acc[PX][CPT];
#pragma unroll
      for (int j = 0; j < PX; ++j)
#pragma unroll
        for (int o = 0; o < CPT; ++o) acc[j][o] = b2s[g * CP + o];
      conv_run<CPT, KT>(acc, cs + r * c1_s + col, c1_plane, c1_s,
                        w2s + g * CP, w2_row, Cm, K);
#pragma unroll
      for (int o = 0; o < CPT; ++o) {
        if (g * CPT + o >= Co) break;
        float v[PX];
#pragma unroll
        for (int j = 0; j < PX; ++j) v[j] = fmaxf(acc[j][o], 0.f);
        store_run<PX>(c2b + (g * CPT + o) * plane +
                          static_cast<size_t>(gy) * W + gx,
                      v, W - gx);
      }
    }
  }
}

template <int CPT, int KT>
cudaError_t launch(const ChainArgs& a, int threads, int smem_bytes,
                   cudaStream_t stream) {
  cudaError_t err = dnnca::allow_smem(conv_chain_kernel<CPT, KT>, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.W + a.tile_w - 1) / a.tile_w,
                  (a.H + a.tile_h - 1) / a.tile_h, a.B);
  conv_chain_kernel<CPT, KT><<<grid, threads, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int KT>
cudaError_t dispatch(const ChainArgs& a, int cpt, int threads, int smem,
                     cudaStream_t s) {
  switch (cpt) {
    case 3: return launch<3, KT>(a, threads, smem, s);
    case 4: return launch<4, KT>(a, threads, smem, s);
    case 6: return launch<6, KT>(a, threads, smem, s);
    case 8: return launch<8, KT>(a, threads, smem, s);
    case 12: return launch<12, KT>(a, threads, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// c1 may be null. cpt, the tile, the row widths, threads and smem_bytes
// come from the wrapper's plan (ops/kernels/conv_chain.py).
extern "C" int dnnca_conv_chain(const float* x, const float* w1,
                                const float* b1, const float* w2,
                                const float* b2, float* c1, float* c2, int B,
                                int Ci, int Cm, int Co, int H, int W, int K,
                                int cpt, int tile_h, int tile_w, int c1_w,
                                int c1_s, int xs_w, int threads,
                                int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const ChainArgs a{x, w1, b1, w2, b2, c1, c2, B, Ci, Cm, Co, H, W, K,
                    tile_h, tile_w, c1_w, c1_s, xs_w};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return K == 3 ? dispatch<3>(a, cpt, threads, smem_bytes, s)
                : dispatch<0>(a, cpt, threads, smem_bytes, s);
}
