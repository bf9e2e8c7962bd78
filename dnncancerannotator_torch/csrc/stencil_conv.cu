// Stride-1 convolution with explicit pads, bias and an optional fused relu:
//   out[b, o, y, x] = bias[o] + sum_{c, ky, kx} xpad[b, c, y+ky, x+kx] * w[o, c, ky, kx]
// where xpad is x zero-padded by (pt, pb) rows and (pl, pr) columns;
// OH = H + pt + pb - KH + 1 and OW likewise (the wrapper passes both).
//
// Replaces conv_kernel.stencil_conv2d_pallas
// (dnncancerannotator_tpu/ops/pallas/conv_kernel.py:84), which keeps a
// whole padded image in VMEM and reads the weights as SMEM scalars, with
// ``nchw=True``; its NHWC form is stencil_conv_nhwc.cu. w [Co, Ci, KH, KW]
// (PyTorch OIHW), Ci, Co <= 32, f32. Three routes, chosen from the shape
// alone (ops/kernels/stencil_conv.py: route):
//
// - pointwise (1 x 1, zero pads): unet.yaml's 1 x 1, 3 -> 1 logits head.
//   A pure stream of Ci reads and Co writes a pixel, 16 bytes a pixel at
//   the head against 3 FMAs, so device-memory bytes bound it, and the rate
//   of HBM needs many bytes in flight on every SM. The grid is (pixel
//   chunk, batch) with 32-bit offsets inside a batch item and no division
//   per pixel; each thread takes V groups of 4 consecutive pixels as
//   float4 and issues all Ci x V loads before its first FMA (Ci a
//   compile-time constant: exact up to 4, buckets above). The weights and
//   bias are read with uniform read-only loads (one transaction a warp),
//   with no shared memory and no barrier: they live on the device and
//   change every step, so passing them by value would cost a copy to the
//   host and a sync a call. Streaming loads where the call exceeds L2; a
//   scalar form where H*W % 4 != 0 or a plane is not 16-byte aligned.
// - tile (every other shape whose tile fits a block's shared memory): the
//   convs that run alone. Under leakyReLU.yaml no chain fuses (a chain
//   fuses relu only), so every conv of unet.yaml with kh*kw*Ci*Co <= 1024
//   runs here: nine a forward, 3 x 3 at 3-12 channels, three of them at
//   256 x 256; under bf16.yaml the split down_2 chain's first conv (3 x 3
//   6 -> 12 with relu at 64 x 64). At these widths a pixel costs 81-648
//   FMAs against 24-72 bytes in f32, so device-memory bytes bound the
//   256 x 256 sites and the FMA rate up_1's 12 -> 6 (PERF.md §6). At B=8
//   each call is a few microseconds of one wave, where the staging's
//   latency is much of it. Register-blocked over conv_tile.cuh's helpers,
//   a single-conv form of the chain forward (conv_chain.cu): a block owns
//   ``rows`` whole output rows of one image (as many as give its 256
//   threads one work item each) and stages their input rows with the halo,
//   zero where the padding lies, so no tap tests a bound, with
//   conv_tile.cuh's stage_window (f32 by cp.async, bf16 converted on
//   load); the weights with no division an index. A work item is a run
//   of PX pixels along a row for CPT output channels (an exact group, 3 or
//   6 at these sites: no FMA multiplies padding); per (input channel,
//   kernel row) it loads its window of PX + KW - 1 staged values once as
//   float4s and reuses it across the taps, and each weight load is a
//   float4 broadcast. The lanes of a warp take consecutive runs of one row
//   (PX = 4) or of a row pair (PX = 8; the rows' stride is 4 mod 8
//   floats), so their window reads hit distinct banks; each output
//   channel is stored as float4 runs, a warp's stores one contiguous
//   stretch of the plane. Where a call has few items (B=8 at 128 x 128
//   and 64 x 64) two lanes take each, half the input channels apiece, and
//   a shuffle adds their sums: twice the warps to hide the shared-memory
//   latency of the sums. The plan (ops/kernels/stencil_conv.py: plan;
//   CPT x PX the most sums, at most 24, that leave six warps an SM) comes
//   from the wrapper; a thread of those items holds at most 64 registers
//   (four blocks an SM).
// - stencil (direct; a shape whose tile does not fit, one staged row with
//   its halo too wide for a block): one thread per output pixel, all Co
//   accumulators in registers (a template bucket of Co), weights and bias
//   in shared memory (broadcast reads). Neighbouring threads take
//   neighbouring x, so every input and output access is coalesced; the
//   padding is a bounds test on the input index, never a padded copy.
//   Until the tile it ran the bf16 down_2 site (PERF.md §6, row "4 bf16,
//   stencil route", on an H100 80GB HBM3 at 700 W).
//
// The sums of the tile (one lane an item) and the direct kernel run in one
// order: the bias, then the taps by (c, ky, kx), each an fmaf in f32; with
// two lanes an item, the bias and the first half of the input channels,
// plus the second half's sum.
// bf16 forms (entries dnnca_stencil_conv_bf16, dnnca_stencil_conv_tile_bf16,
// dnnca_pointwise_conv_bf16): x, w and the bias in bf16, each value
// converted to f32 as it is loaded or staged (four at a time as 8 bytes
// where the f32 form reads a float4), the sums the f32 form's in its
// order, and the output rounded to bf16 (nearest-even) on its store: equal
// to the f32 form's on the upcast inputs, rounded. stencil_conv2d_pallas
// takes bf16 the same way: it upcasts, computes in f32, and its caller
// rounds.
#include "conv_tile.cuh"

namespace {

constexpr int kThreads = 256;

// CO: the output-channel bucket (1, 4, 8, 16 or 32, the smallest that holds
// Co). Weights are staged as [Ci][KH][KW][CO], zero-padded, so each tap
// runs CO FMAs with no per-channel guard.
using dnnca::put;
using dnnca::store4;
using dnnca::to_f32;

template <int CO, typename T>
__global__ void __launch_bounds__(kThreads)
stencil_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ bias, T* __restrict__ out,
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
    ws[i] = o < Co ? to_f32(w[(o * Ci + c) * taps + t]) : 0.f;
  }
  for (int i = threadIdx.x; i < CO; i += kThreads)
    bs[i] = i < Co ? to_f32(bias[i]) : 0.f;
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
  const T* xb = x + static_cast<size_t>(b) * Ci * plane;
  for (int c = 0; c < Ci; ++c) {
    for (int ky = 0; ky < KH; ++ky) {
      const int iy = oy - pt + ky;
      if (iy < 0 || iy >= H) continue;
      for (int kx = 0; kx < KW; ++kx) {
        const int ix = ox - pl + kx;
        if (ix < 0 || ix >= W) continue;
        const float v =
            to_f32(xb[c * plane + static_cast<size_t>(iy) * W + ix]);
        const float* wt = ws + ((c * KH + ky) * KW + kx) * CO;
#pragma unroll
        for (int o = 0; o < CO; ++o) acc[o] = fmaf(v, wt[o], acc[o]);
      }
    }
  }
  T* ob = out + static_cast<size_t>(b) * Co * oplane + pix;
#pragma unroll
  for (int o = 0; o < CO; ++o)
    if (o < Co) put(ob + o * oplane, relu ? fmaxf(acc[o], 0.f) : acc[o]);
}

template <int CO, typename T>
cudaError_t launch(const T* x, const T* w, const T* bias, T* out, int B,
                   int Ci, int Co, int H, int W, int KH, int KW, int pt,
                   int pl, int OH, int OW, int relu, cudaStream_t stream) {
  const size_t smem_bytes = (static_cast<size_t>(Ci) * KH * KW + 1) * CO * 4;
  cudaError_t err =
      dnnca::allow_smem(stencil_conv_kernel<CO, T>, smem_bytes);
  if (err != cudaSuccess) return err;
  const size_t n = static_cast<size_t>(B) * OH * OW;
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  stencil_conv_kernel<CO, T><<<grid, kThreads, smem_bytes, stream>>>(
      x, w, bias, out, B, Ci, Co, H, W, KH, KW, pt, pl, OH, OW, relu);
  return dnnca::launched(cudaGetLastError());
}



// -- the tile route -----------------------------------------------------------
using dnnca::bf16;
using dnnca::tile::pad4;
using dnnca::tile::stage_window;
using dnnca::tile::store_run;

constexpr int kTileThreads = 256;  // ops/kernels/stencil_conv.py: THREADS

// Blocks of kTileThreads an SM the register cap leaves room for: four (64
// registers a thread) where a work item keeps at most 24 sums, else two.
__host__ __device__ constexpr int tile_min_blocks(int sums) {
  return sums <= 24 ? 4 : 2;
}

// Stage w [Co][Ci][KK] (OIHW) as [Ci * KK][groups * pad4(CPT)] f32, zero
// in the padding slots. The block's threads take the n * w_row slots in
// turn (one division a slot), so each issues a few copies; a slot's
// weight is w[o * n + (input channel, tap)]. f32: cp.async (the caller
// waits); bf16: kBatch loads issued before their stores.
constexpr int kBatch = 4;

template <int CPT, typename T>
__device__ __forceinline__ void stage_tile_weights(float* dst, const T* w,
                                                   int Co, int n, int w_row) {
  constexpr int CP = pad4(CPT);
  const int total = n * w_row;
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * blockDim.x) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      const int ct = i / w_row, slot = i - ct * w_row;
      const int g = slot / CP, r = slot - g * CP, o = g * CPT + r;
      const bool ok = i < total && r < CPT && o < Co;
      const T* src = ok ? w + o * n + ct : w;
      if constexpr (std::is_same_v<T, float>) {
        if (i < total) dnnca::tile::cp_async4(dst + i, src, ok);
      } else {
        v[u] = ok ? to_f32(*src) : 0.f;
      }
    }
    if constexpr (!std::is_same_v<T, float>) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (i0 + u * blockDim.x < total) dst[i0 + u * blockDim.x] = v[u];
    }
  }
}

template <typename T>
struct TileArgs {
  const T* x;
  const T* w;
  const T* bias;
  T* out;
  int Ci, Co, H, W, KH, KW, pt, pl, OH, OW, relu;
  // from the wrapper's plan: output rows a tile, tiles an image, the row
  // pair interleave of the lanes (1 or 2), the staged columns of a row
  // (the outputs' taps and the last run's float4 window) and their stride
  int rows, tiles_y, ri, cols, xs_w;
  // lanes an item (1, or 2: the input channels split in halves)
  int ks;
};

// CPT output channels x PX pixels a work item; KX = 3 unrolls a 3-wide
// kernel row over a window held in registers, KX = 0 runs any width with
// scalar reads. Shared memory: the weights [Ci][KH * KW][groups *
// pad4(CPT)] and bias (conv_tile.cuh's group slots), then the input rows
// [Ci][rows + KH - 1][xs_w], staged column d holding the image's column
// d - pl.
template <int CPT, int PX, int KX, typename T>
__global__ void __launch_bounds__(kTileThreads, tile_min_blocks(CPT * PX))
stencil_tile_kernel(TileArgs<T> a) {
  constexpr int CP = pad4(CPT), NQ = CP / 4;
  constexpr int NW = KX > 0 ? (PX + KX - 1 + 3) / 4 : 1;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int KH = a.KH, KW = KX > 0 ? KX : a.KW, KK = KH * KW;
  const int groups = (a.Co + CPT - 1) / CPT, w_row = groups * CP;
  const int xs_w = a.xs_w, srows = a.rows + KH - 1, plane = srows * xs_w;
  float* ws = smem;                     // [Ci][KK][w_row]
  float* bs = ws + a.Ci * KK * w_row;   // [w_row]
  float* xs = bs + w_row;               // [Ci][srows][xs_w]

  const int b = blockIdx.x / a.tiles_y;
  const int y0 = (blockIdx.x - b * a.tiles_y) * a.rows;
  const size_t in_plane = static_cast<size_t>(a.H) * a.W;
  const size_t out_plane = static_cast<size_t>(a.OH) * a.OW;
  stage_tile_weights<CPT>(ws, a.w, a.Co, a.Ci * KK, w_row);
  dnnca::tile::stage_bias<T>(bs, a.bias, a.Co, CPT, groups);
  const T* xb = a.x + static_cast<size_t>(b) * a.Ci * in_plane;
  // each value to its column (f32: a 4-byte cp.async, zero-filled outside
  // the image; bf16: loaded and converted). Rows copied as they lie and
  // moved to their columns after (16-byte cp.async, or bulk copies) ran
  // 5-20% slower at most of the sites on an H100, as did a persistent
  // grid staging its next tile while computing one (PERF.md §6).
  stage_window(xs, xb, a.Ci, srows, a.cols, xs_w, y0 - a.pt, -a.pl, a.H,
               a.W);
  dnnca::tile::cp_async_wait_all();
  __syncthreads();

  // item -> (group, row, run): the rows' pair index fastest where ri = 2,
  // then the runs of a row, then the rows, then the groups. With ks = 2
  // two lanes take an item, lane l < 16 of a warp the first half of the
  // input channels (and the bias) and lane l + 16 the rest, their sums
  // added by a shuffle: twice the warps where a call has few items.
  const int runs = (a.OW + PX - 1) / PX, per_g = a.rows * runs;
  const int shift = a.ri - 1, items = groups * per_g;
  const int work = a.ks == 2 ? (items + 15) / 16 * 32 : items;
  const int c_mid = a.ks == 2 ? (a.Ci + 1) / 2 : a.Ci;
  T* ob = a.out + static_cast<size_t>(b) * a.Co * out_plane;
  for (int w0 = threadIdx.x; w0 < work; w0 += blockDim.x) {
    const int half = a.ks == 2 ? (w0 >> 4) & 1 : 0;
    const int it = a.ks == 2 ? (w0 >> 5) * 16 + (w0 & 15) : w0;
    const int g = it / per_g, rem = it - g * per_g;
    const int rl = rem & shift, t = rem >> shift;
    const int rh = t / runs, run = t - rh * runs;
    const int r = (rh << shift) + rl, gy = y0 + r, col = run * PX;
    const bool ok = it < items && gy < a.OH;
    float acc[PX][CPT];
#pragma unroll
    for (int j = 0; j < PX; ++j)
#pragma unroll
      for (int o = 0; o < CPT; ++o)
        acc[j][o] = half || !ok ? 0.f : bs[g * CP + o];
    const float* src = xs + r * xs_w + col;
    const float* wg = ws + g * CP;
    const int c_end = ok ? (half ? a.Ci : c_mid) : 0;
    for (int c = half ? c_mid : 0; c < c_end; ++c) {
      for (int ky = 0; ky < KH; ++ky) {
        const float* s = src + c * plane + ky * xs_w;
        const float* wt = wg + (c * KK + ky * KW) * w_row;
        if constexpr (KX > 0) {
          float win[NW * 4];
          const float4* s4 = reinterpret_cast<const float4*>(s);
#pragma unroll
          for (int q = 0; q < NW; ++q) {
            const float4 v = s4[q];
            win[4 * q] = v.x;
            win[4 * q + 1] = v.y;
            win[4 * q + 2] = v.z;
            win[4 * q + 3] = v.w;
          }
#pragma unroll
          for (int kx = 0; kx < KX; ++kx) {
            const float4* w4 =
                reinterpret_cast<const float4*>(wt + kx * w_row);
            float wv[CP];
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
              const float4 v = w4[q];
              wv[4 * q] = v.x;
              wv[4 * q + 1] = v.y;
              wv[4 * q + 2] = v.z;
              wv[4 * q + 3] = v.w;
            }
#pragma unroll
            for (int o = 0; o < CPT; ++o)
#pragma unroll
              for (int j = 0; j < PX; ++j)
                acc[j][o] = fmaf(win[j + kx], wv[o], acc[j][o]);
          }
        } else {
          for (int kx = 0; kx < KW; ++kx) {
            const float4* w4 =
                reinterpret_cast<const float4*>(wt + kx * w_row);
            float wv[CP];
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
              const float4 v = w4[q];
              wv[4 * q] = v.x;
              wv[4 * q + 1] = v.y;
              wv[4 * q + 2] = v.z;
              wv[4 * q + 3] = v.w;
            }
#pragma unroll
            for (int j = 0; j < PX; ++j) {
              const float v = s[j + kx];
#pragma unroll
              for (int o = 0; o < CPT; ++o)
                acc[j][o] = fmaf(v, wv[o], acc[j][o]);
            }
          }
        }
      }
    }
    if (a.ks == 2) {
#pragma unroll
      for (int j = 0; j < PX; ++j)
#pragma unroll
        for (int o = 0; o < CPT; ++o)
          acc[j][o] += __shfl_xor_sync(0xffffffffu, acc[j][o], 16);
    }
    if (!ok || half) continue;
#pragma unroll
    for (int o = 0; o < CPT; ++o) {
      if (g * CPT + o >= a.Co) break;
      float v[PX];
#pragma unroll
      for (int j = 0; j < PX; ++j)
        v[j] = a.relu ? fmaxf(acc[j][o], 0.f) : acc[j][o];
      store_run<PX>(ob + (g * CPT + o) * out_plane +
                        static_cast<size_t>(gy) * a.OW + col,
                    v, a.OW - col);
    }
  }
}

template <int CPT, int PX, typename T>
cudaError_t launch_tile(const TileArgs<T>& a, int B, int threads, int smem,
                        cudaStream_t stream) {
  const auto kernel = a.KW == 3 ? stencil_tile_kernel<CPT, PX, 3, T>
                                : stencil_tile_kernel<CPT, PX, 0, T>;
  cudaError_t err = dnnca::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>(B) * a.tiles_y;
  kernel<<<grid, threads, smem, stream>>>(a);
  return dnnca::launched(cudaGetLastError());
}

// The (CPT, PX) pairs the plan takes (ops/kernels/stencil_conv.py: TILES).
template <typename T>
int tile_entry(const TileArgs<T>& a, int B, int cpt, int px, int threads,
               int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cpt * 100 + px) {
    case 304: return launch_tile<3, 4>(a, B, threads, smem, s);
    case 308: return launch_tile<3, 8>(a, B, threads, smem, s);
    case 404: return launch_tile<4, 4>(a, B, threads, smem, s);
    case 408: return launch_tile<4, 8>(a, B, threads, smem, s);
    case 604: return launch_tile<6, 4>(a, B, threads, smem, s);
    case 608: return launch_tile<6, 8>(a, B, threads, smem, s);
    case 804: return launch_tile<8, 4>(a, B, threads, smem, s);
    case 1204: return launch_tile<12, 4>(a, B, threads, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

// The tile's arguments, tiles_y from the shape and the plan's rows.
template <typename T>
TileArgs<T> tile_args(const T* x, const T* w, const T* bias, T* out, int Ci,
                      int Co, int H, int W, int KH, int KW, int pt, int pl,
                      int OH, int OW, int relu, int ri, int rows, int cols,
                      int xs_w, int ks) {
  return TileArgs<T>{x,  w,    bias, out, Ci,   Co,   H,
                     W,  KH,   KW,   pt,  pl,   OH,   OW,
                     relu, rows, (OH + rows - 1) / rows, ri, cols, xs_w,
                     ks};
}

// -- the pointwise route ------------------------------------------------------
constexpr int kPwThreads = 256;

__device__ __forceinline__ float4 splat(float v, float4) {
  return make_float4(v, v, v, v);
}
__device__ __forceinline__ float splat(float v, float) { return v; }
__device__ __forceinline__ float4 fma_(float a, float4 x, float4 acc) {
  return make_float4(fmaf(a, x.x, acc.x), fmaf(a, x.y, acc.y),
                     fmaf(a, x.z, acc.z), fmaf(a, x.w, acc.w));
}
__device__ __forceinline__ float fma_(float a, float x, float acc) {
  return fmaf(a, x, acc);
}
__device__ __forceinline__ float4 relu_(float4 v) {
  return make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f),
                     fmaxf(v.w, 0.f));
}
__device__ __forceinline__ float relu_(float v) { return fmaxf(v, 0.f); }
// V4 groups of 4 pixels: f32 as one float4 load, bf16 as one 8-byte load
// (unpacked to a float4); streaming loads evict first.
template <typename T>
__device__ __forceinline__ float4 load_(const T* p, bool streaming, float4) {
  if constexpr (std::is_same_v<T, float>) {
    const float4* q = reinterpret_cast<const float4*>(p);
    return streaming ? __ldcs(q) : __ldg(q);
  } else {
    const uint2* q = reinterpret_cast<const uint2*>(p);
    const uint2 u = streaming ? __ldcs(q) : __ldg(q);
    return dnnca::unpack4(u);
  }
}
template <typename T>
__device__ __forceinline__ float load_(const T* p, bool streaming, float) {
  if constexpr (std::is_same_v<T, float>)
    return streaming ? __ldcs(p) : __ldg(p);
  else
    return dnnca::ldg_f32(p);
}
__device__ __forceinline__ void store_(float* p, float4 v) { store4(p, v); }
__device__ __forceinline__ void store_(dnnca::bf16* p, float4 v) {
  store4(p, v);
}
__device__ __forceinline__ void store_(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_(dnnca::bf16* p, float v) { put(p, v); }

// VT: float4 (groups of 4 pixels) or float (single pixels); T: the element
// type of x, w, bias and out; CI: Ci exactly (1-4) or a bucket (8, 16, 32:
// channels past Ci are skipped); V: groups a thread. P is H * W, in
// pixels; the grid's y walks the batch.
template <typename VT, typename T, int CI, int V>
__global__ void __launch_bounds__(kPwThreads)
pointwise_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const T* __restrict__ bias, T* __restrict__ out,
                      int B, int Ci, int Co, int P, int relu, int streaming) {
  constexpr int kPx = sizeof(VT) / sizeof(float);
  const int groups = P / kPx;
  const int q0 = blockIdx.x * (kPwThreads * V) + threadIdx.x;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const T* xb = x + static_cast<size_t>(b) * Ci * P;
    T* ob = out + static_cast<size_t>(b) * Co * P;
    VT v[V][CI];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int q = q0 + k * kPwThreads;
#pragma unroll
      for (int c = 0; c < CI; ++c)
        v[k][c] = q < groups && (CI <= 4 || c < Ci)
                      ? load_(xb + (c * groups + q) * kPx, streaming != 0,
                              VT())
                      : splat(0.f, VT());
    }
    for (int o = 0; o < Co; ++o) {
      float wr[CI];
#pragma unroll
      for (int c = 0; c < CI; ++c)
        wr[c] = CI <= 4 || c < Ci ? dnnca::ldg_f32(w + o * Ci + c) : 0.f;
      const float bo = dnnca::ldg_f32(bias + o);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int q = q0 + k * kPwThreads;
        if (q >= groups) continue;
        VT acc = splat(bo, VT());
#pragma unroll
        for (int c = 0; c < CI; ++c) acc = fma_(wr[c], v[k][c], acc);
        store_(ob + (o * groups + q) * kPx, relu ? relu_(acc) : acc);
      }
    }
  }
}

template <typename VT, typename T, int CI, int V>
cudaError_t launch_pointwise(const T* x, const T* w, const T* bias, T* out,
                             int B, int Ci, int Co, int P, int relu,
                             int streaming, cudaStream_t stream) {
  constexpr int kPx = sizeof(VT) / sizeof(float);
  const int groups = P / kPx;
  const dim3 grid((groups + kPwThreads * V - 1) / (kPwThreads * V),
                  B < 65535 ? B : 65535);
  pointwise_conv_kernel<VT, T, CI, V><<<grid, kPwThreads, 0, stream>>>(
      x, w, bias, out, B, Ci, Co, P, relu, streaming);
  return dnnca::launched(cudaGetLastError());
}

template <typename VT, typename T>
cudaError_t pointwise(const T* x, const T* w, const T* bias, T* out, int B,
                      int Ci, int Co, int P, int relu, int streaming,
                      cudaStream_t s) {
#define DNNCA_PW(CI, V)                                                 \
  launch_pointwise<VT, T, CI, V>(x, w, bias, out, B, Ci, Co, P, relu, \
                                 streaming, s)
  switch (Ci) {
    case 1: return DNNCA_PW(1, 2);
    case 2: return DNNCA_PW(2, 2);
    case 3: return DNNCA_PW(3, 2);
    case 4: return DNNCA_PW(4, 2);
    default:
      return Ci <= 8 ? DNNCA_PW(8, 2) : Ci <= 16 ? DNNCA_PW(16, 1)
                                             : DNNCA_PW(32, 1);
  }
#undef DNNCA_PW
}


template <typename T>
int stencil_entry(const T* x, const T* w, const T* bias, T* out, int B,
                  int Ci, int Co, int H, int W, int KH, int KW, int pt,
                  int pl, int OH, int OW, int relu, int device,
                  void* stream) {
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

template <typename T>
int pointwise_entry(const T* x, const T* w, const T* bias, T* out, int B,
                    int Ci, int Co, int P, int relu, int streaming, int vec,
                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? pointwise<float4>(x, w, bias, out, B, Ci, Co, P, relu,
                                 streaming, s)
             : pointwise<float>(x, w, bias, out, B, Ci, Co, P, relu,
                                streaming, s);
}

}  // namespace

using dnnca::bf16;

extern "C" int dnnca_stencil_conv(const float* x, const float* w,
                                  const float* bias, float* out, int B,
                                  int Ci, int Co, int H, int W, int KH,
                                  int KW, int pt, int pl, int OH, int OW,
                                  int relu, int device, void* stream) {
  return stencil_entry(x, w, bias, out, B, Ci, Co, H, W, KH, KW, pt, pl, OH,
                       OW, relu, device, stream);
}

// The bf16 form: x, w, bias and out bf16.
extern "C" int dnnca_stencil_conv_bf16(const bf16* x, const bf16* w,
                                       const bf16* bias, bf16* out, int B,
                                       int Ci, int Co, int H, int W, int KH,
                                       int KW, int pt, int pl, int OH, int OW,
                                       int relu, int device, void* stream) {
  return stencil_entry(x, w, bias, out, B, Ci, Co, H, W, KH, KW, pt, pl, OH,
                       OW, relu, device, stream);
}

// The tile route; cpt, px, ri, rows, cols, xs_w, ks, threads and
// smem_bytes come from the wrapper's plan (ops/kernels/stencil_conv.py:
// plan).
extern "C" int dnnca_stencil_conv_tile(const float* x, const float* w,
                                       const float* bias, float* out, int B,
                                       int Ci, int Co, int H, int W, int KH,
                                       int KW, int pt, int pl, int OH, int OW,
                                       int relu, int cpt, int px, int ri,
                                       int rows, int cols, int xs_w, int ks,
                                       int threads, int smem_bytes,
                                       int device, void* stream) {
  return tile_entry(tile_args(x, w, bias, out, Ci, Co, H, W, KH, KW, pt, pl,
                              OH, OW, relu, ri, rows, cols, xs_w, ks),
                    B, cpt, px, threads, smem_bytes, device, stream);
}

// The bf16 form of the tile route (x, w, bias and out bf16).
extern "C" int dnnca_stencil_conv_tile_bf16(
    const bf16* x, const bf16* w, const bf16* bias, bf16* out, int B, int Ci,
    int Co, int H, int W, int KH, int KW, int pt, int pl, int OH, int OW,
    int relu, int cpt, int px, int ri, int rows, int cols, int xs_w, int ks,
    int threads, int smem_bytes, int device, void* stream) {
  return tile_entry(tile_args(x, w, bias, out, Ci, Co, H, W, KH, KW, pt, pl,
                              OH, OW, relu, ri, rows, cols, xs_w, ks),
                    B, cpt, px, threads, smem_bytes, device, stream);
}

// The pointwise route: a 1 x 1 conv with zero pads over P = H * W pixels a
// plane. vec: P % 4 == 0 and x, out aligned to 4 elements (float4 groups);
// streaming: the call exceeds L2 (evict-first loads).
extern "C" int dnnca_pointwise_conv(const float* x, const float* w,
                                    const float* bias, float* out, int B,
                                    int Ci, int Co, int P, int relu,
                                    int streaming, int vec, int device,
                                    void* stream) {
  return pointwise_entry(x, w, bias, out, B, Ci, Co, P, relu, streaming, vec,
                         device, stream);
}

// The bf16 form of the pointwise route (x, w, bias and out bf16).
extern "C" int dnnca_pointwise_conv_bf16(const bf16* x, const bf16* w,
                                         const bf16* bias, bf16* out, int B,
                                         int Ci, int Co, int P, int relu,
                                         int streaming, int vec, int device,
                                         void* stream) {
  return pointwise_entry(x, w, bias, out, B, Ci, Co, P, relu, streaming, vec,
                         device, stream);
}
