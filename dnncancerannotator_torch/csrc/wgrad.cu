// Weight and bias gradient of a stride-1 convolution (contract in wgrad.cuh).
//
// This is the dw/db half of the backward kernels the port replaces:
// conv_kernel.conv_chain_bwd_pallas and stencil_conv2d_bwd_pallas
// (dnncancerannotator_tpu/ops/pallas/conv_kernel.py:487, :175) and the
// flatchain backward (flatchain.py:293, :372). Those accumulate dw in SMEM
// or VMEM across a grid that runs in order on one core. Here the blocks run
// in parallel, so each block writes its own partial sums and a second kernel
// adds them in a fixed order: the result is the same from run to run.
//
// What bounds it on the H100: per output pixel it reads O + Cin values and
// does O * Cin * KH * KW FMAs (135 to 2592 at the model's sites), so it is
// bound by shared-memory loads and FMA issue, not by device memory.
//
// Design: a block walks tiles of 8 x 32 output pixels (tile = blockIdx.x,
// then += gridDim.x). Per tile it stages A, masked, as [pixel][C] and X with
// its KH-1 x KW-1 halo as [Cin][rows][cols]. A work item is one (input
// channel, tap) pair, or the bias pair whose X is 1, and one slice of the
// tile's pixels; it keeps the O gradients of its pair in registers (a
// template bucket C of O) and reads A's C values of a pixel as float4
// broadcasts. With fewer pairs than threads the pixels are split into
// slices so that every thread works; with more, the block makes one pass
// over its tiles per group of pairs. The slices are summed in shared
// memory, and the block writes one partial per output entry.
#include "conv_tile.cuh"
#include "wgrad.cuh"

namespace {

using dnnca::tile::tap;

constexpr int kThreads = 256;
constexpr int kTileH = 8;
constexpr int kTileW = 32;
constexpr int kPix = kTileH * kTileW;

template <int C>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(dnnca::WgradArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int taps = a.KH * a.KW;
  const int xs_w = kTileW + a.KW - 1;
  const int xs_plane = (kTileH + a.KH - 1) * xs_w;
  const int n_pairs = a.Cin * taps + 1;  // the last pair is the bias
  const int per_pass = n_pairs < kThreads ? n_pairs : kThreads;
  const int slices = kThreads / per_pass;
  const int span = (kPix + slices - 1) / slices;
  float* as = smem;                      // [kPix][C]
  float* xs = as + kPix * C;             // [Cin][xs_h][xs_w]
  float* red = xs + a.Cin * xs_plane;    // [slices][per_pass][C]
  const float4* as4 = reinterpret_cast<const float4*>(as);

  const int tiles_x = (a.OW + kTileW - 1) / kTileW;
  const int tiles_y = (a.OH + kTileH - 1) / kTileH;
  const int n_tiles = a.B * tiles_y * tiles_x;
  const int n_w = a.O * a.Cin * taps;
  const size_t oplane = static_cast<size_t>(a.OH) * a.OW;
  const size_t iplane = static_cast<size_t>(a.H) * a.W;
  const int tid = threadIdx.x;
  const int j = tid % per_pass, slice = tid / per_pass;

  for (int p0 = 0; p0 < n_pairs; p0 += per_pass) {
    const int pair = p0 + j;
    const bool active = slice < slices && pair < n_pairs;
    float acc[C];
#pragma unroll
    for (int o = 0; o < C; ++o) acc[o] = 0.f;

    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int b = t / (tiles_y * tiles_x);
      const int oy0 = t / tiles_x % tiles_y * kTileH;
      const int ox0 = t % tiles_x * kTileW;
      __syncthreads();  // every thread is done with the previous tile
      for (int i = tid; i < C * kPix; i += kThreads) {
        const int o = i / kPix, pix = i % kPix;
        const int oy = oy0 + pix / kTileW, ox = ox0 + pix % kTileW;
        float v = 0.f;
        if (o < a.O && oy < a.OH && ox < a.OW) {
          const size_t idx = (static_cast<size_t>(b) * a.O + o) * oplane +
                             static_cast<size_t>(oy) * a.OW + ox;
          v = a.A[idx];
          if (a.mask != nullptr && !(a.mask[idx] > 0.f)) v = 0.f;
        }
        as[pix * C + o] = v;
      }
      for (int i = tid; i < a.Cin * xs_plane; i += kThreads) {
        const int c = i / xs_plane, r = i % xs_plane / xs_w, col = i % xs_w;
        const int iy = oy0 - a.pt + r, ix = ox0 - a.pl + col;
        xs[i] = (iy >= 0 && iy < a.H && ix >= 0 && ix < a.W)
                    ? a.X[(static_cast<size_t>(b) * a.Cin + c) * iplane +
                          static_cast<size_t>(iy) * a.W + ix]
                    : 0.f;
      }
      __syncthreads();
      if (!active) continue;
      const int lo = slice * span;
      const int hi = lo + span < kPix ? lo + span : kPix;
      if (pair == n_pairs - 1) {
        for (int pix = lo; pix < hi; ++pix)
          tap<C>(acc, 1.f, as4 + pix * (C / 4));
      } else {
        const int c = pair / taps, k = pair % taps;
        const float* xc = xs + c * xs_plane + (k / a.KW) * xs_w + k % a.KW;
        for (int pix = lo; pix < hi; ++pix)
          tap<C>(acc, xc[(pix / kTileW) * xs_w + pix % kTileW],
                 as4 + pix * (C / 4));
      }
    }

    if (active) {
#pragma unroll
      for (int o = 0; o < C; ++o) red[(slice * per_pass + j) * C + o] = acc[o];
    }
    __syncthreads();
    for (int i = tid; i < per_pass * a.O; i += kThreads) {
      const int jj = i / a.O, o = i % a.O, pr = p0 + jj;
      if (pr >= n_pairs) continue;
      float s = 0.f;
      for (int sl = 0; sl < slices; ++sl)
        s += red[(sl * per_pass + jj) * C + o];
      const int e = pr == n_pairs - 1
                        ? n_w + o
                        : (o * a.Cin + pr / taps) * taps + pr % taps;
      a.partial[static_cast<size_t>(e) * a.blocks + blockIdx.x] = s;
    }
    __syncthreads();  // red is reused by the next pass
  }
}

__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ out,
                    int blocks) {
  __shared__ float buf[kThreads];
  const float* row = partial + static_cast<size_t>(blockIdx.x) * blocks;
  float s = 0.f;
  for (int i = threadIdx.x; i < blocks; i += kThreads) s += row[i];
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w /= 2) {
    if (threadIdx.x < w) buf[threadIdx.x] += buf[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = buf[0];
}

template <int C>
cudaError_t launch(const dnnca::WgradArgs& a, cudaStream_t stream) {
  const int n_pairs = a.Cin * a.KH * a.KW + 1;
  const int per_pass = n_pairs < kThreads ? n_pairs : kThreads;
  const int slices = kThreads / per_pass;
  const size_t smem_bytes =
      4 * (static_cast<size_t>(kPix) * C +
           static_cast<size_t>(a.Cin) * (kTileH + a.KH - 1) *
               (kTileW + a.KW - 1) +
           static_cast<size_t>(slices) * per_pass * C);
  cudaError_t err = dnnca::allow_smem(wgrad_kernel<C>, smem_bytes);
  if (err != cudaSuccess) return err;
  wgrad_kernel<C><<<a.blocks, kThreads, smem_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return dnnca::launch_sum_partials(a.partial, a.out,
                                    a.O * a.Cin * a.KH * a.KW + a.O,
                                    a.blocks, stream);
}

}  // namespace

namespace dnnca {

cudaError_t launch_sum_partials(const float* partial, float* out, int n,
                                int blocks, cudaStream_t stream) {
  sum_partials_kernel<<<n, kThreads, 0, stream>>>(partial, out, blocks);
  return cudaGetLastError();
}

cudaError_t launch_wgrad(const WgradArgs& a, cudaStream_t stream) {
  if (a.O <= 4) return launch<4>(a, stream);
  if (a.O <= 8) return launch<8>(a, stream);
  if (a.O <= 16) return launch<16>(a, stream);
  return launch<32>(a, stream);
}

}  // namespace dnnca
