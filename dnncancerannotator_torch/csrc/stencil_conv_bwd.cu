// Backward of the stride-1 stencil conv (stencil_conv.cu):
//   dx[b, c, y, x] = sum_{o, ky, kx} g[b, o, y + pt - ky, x + pl - kx] * w[o, c, ky, kx]
//   dw[o, c, ky, kx] = sum_{b, y, x} g[b, o, y, x] * xpad[b, c, y + ky, x + kx]
//   db[o]           = sum_{b, y, x} g[b, o, y, x]
// g arrives already masked by the forward's output when the relu is fused
// (the wrapper does it, as fastconv.py:200-201 does in the JAX package).
//
// Replaces conv_kernel.stencil_conv2d_bwd_pallas
// (dnncancerannotator_tpu/ops/pallas/conv_kernel.py:175) with
// ``nchw=True``, which returns dx and the packed [dw, db] from one call.
// NCHW f32, w [Co, Ci, KH, KW], any pads; Ci, Co <= 32. On the model's path
// it is unet.yaml's 1 x 1, 3 -> 1 logits head (the pointwise route) and,
// under bf16 compute (bf16.yaml), the first conv of the split down_2
// chain, 3 x 3 6 -> 12 with relu at 64 x 64 (the stencil route). The
// routes are the forward's (ops/kernels/stencil_conv.py: route), the
// stencil route's in two forms (ops/kernels/stencil_conv_bwd.py: route).
//
// What bounds it on the H100: at the head, 3 FMAs for dx and 4 for dw and
// db a pixel against 28 bytes of device memory (x and g read, dx written),
// so device-memory bytes. At down_2's first conv, 216 FMAs a pixel against
// 36 bytes in bf16: about 85 MFLOP a call at B=8, ~1.3 us at the H100
// SXM's published 67 TFLOP/s of f32 FMAs outside the tensor cores (700 W),
// so a call is a few microseconds of work, and each launch, gap and pass
// over device memory is a large share of it.
//
// - pointwise (1 x 1, zero pads: the head): one launch a call. Each block
//   stages the x and g planes of its tiles (whole runs of one plane, the
//   plan's) in shared memory with 16-byte cp.async, every copy of a tile in
//   flight at once; computes dx there (skipped without dx) and the
//   dw / db items: f32 over runs of 16 pixels, f64 from there on, over
//   the slices of a tile in a fixed butterfly of warp shuffles and in tile
//   order; writes one f64 partial a block. The last block to arrive (a ticket taken after a
//   __threadfence, one counter a device, left at 0) adds the partials in
//   block order (chunks of 16, then the chunks in order) in f64 and writes
//   [dw, db] rounded once. The plan (ops/kernels/stencil_conv_bwd.py:
//   plan) is a function of the shape alone, so dw and db are the same bits
//   on every card and every call.
// - stencil, tile form (any other shape whose tile fits): one launch a
//   call, the pointwise route's pattern over 2-D tiles. A block of 512
//   threads walks consecutive tiles of whole rows of one image
//   (tile_plan); for each it stages g with the halo dx needs as [pixel][CO]
//   four-channel chunks, XOR-swizzled by pixel so that a warp's reads of
//   32 neighbouring pixels hit every bank once, and x with the halo dw
//   needs as zero-padded planes (16-byte reads where the rows allow), so no
//   tap tests a bound. Then two groups of threads work at once: 128
//   threads compute dx, two pixels each, their CI sums over (ky, kx, o)
//   from the staged g and the weights in shared memory as [KH][KW][CO][CI]
//   float4 broadcasts (each read serving both pixels); the other 384
//   compute dw and db, a work unit being one input channel, one kernel
//   row and up to three of its taps (or the bias) over one slice of the
//   tile's output pixels, 3 x CO sums in f32 in registers from a window of
//   x and float4 broadcasts of g. The slices add up in order in f64 into
//   the block's partial in shared memory; a thread-block cluster (2
//   blocks: larger clusters did not all fit the card at once) adds its
//   blocks' partials in rank order through distributed shared memory;
//   the cluster takes the device's ticket, and the last cluster's blocks
//   add the clusters' partials in order in f64, each a slice of the items,
//   and write [dw, db] rounded once. dw and db are the same bits on every
//   call; the scratch and the ticket are kept per device. What bounds it
//   at down_2's first conv is latency in series: the staging's reads,
//   dx's 2.3 K FMAs a thread, the cluster's sums and the finish over 64
//   partials (PERF.md §6, by tools/probe_torch_stencil.py).
// - stencil, split form (a shape whose tile or partial does not fit
//   shared memory): dx is one thread per input pixel with the Ci gradients
//   in registers (a template bucket CI) and the weights in shared memory
//   as [Co][KH][KW][CI] float4 broadcasts; the output window is a bounds
//   test on the index of g, never a padded copy. dw and db go through the
//   shared wgrad kernel and its fixed-order partial sum: three launches.
//
// bf16 forms (entries dnnca_stencil_conv_bwd_bf16,
// dnnca_pointwise_conv_bwd_bf16): x, g and w in bf16, converted to f32 as
// they are read or staged, the sums the f32 form's in its order, and dx,
// dw and db rounded to bf16 (nearest-even) from the f32 form's f32
// results, as fastconv.py:213 casts stencil_conv2d_bwd_pallas's: equal to
// the f32 form's on the upcast inputs, rounded.
#include <cooperative_groups.h>

#include "conv_tile.cuh"
#include "wgrad.cuh"

namespace {

using dnnca::tile::tap;

constexpr int kThreads = 256;

using dnnca::put;
using dnnca::to_f32;

template <int CI, typename T>
__global__ void __launch_bounds__(kThreads)
stencil_dgrad_kernel(const T* __restrict__ g, const T* __restrict__ w,
                     T* __restrict__ dx, int B, int Ci, int Co, int H,
                     int W, int KH, int KW, int pt, int pl, int OH, int OW) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [Co][KH][KW][CI]
  const int taps = KH * KW;
  for (int i = threadIdx.x; i < Co * taps * CI; i += kThreads) {
    const int c = i % CI, t = (i / CI) % taps, o = i / (CI * taps);
    ws[i] = c < Ci ? to_f32(w[(o * Ci + c) * taps + t]) : 0.f;
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
  const T* gb = g + static_cast<size_t>(b) * Co * oplane;
  const float4* ws4 = reinterpret_cast<const float4*>(ws);
  for (int o = 0; o < Co; ++o) {
    for (int ky = 0; ky < KH; ++ky) {
      const int oy = iy + pt - ky;
      if (oy < 0 || oy >= OH) continue;
      for (int kx = 0; kx < KW; ++kx) {
        const int ox = ix + pl - kx;
        if (ox < 0 || ox >= OW) continue;
        tap<CI>(acc,
                to_f32(gb[o * oplane + static_cast<size_t>(oy) * OW + ox]),
                ws4 + ((o * KH + ky) * KW + kx) * (CI / 4));
      }
    }
  }
  T* dxb = dx + static_cast<size_t>(b) * Ci * plane + pix;
#pragma unroll
  for (int c = 0; c < CI; ++c)
    if (c < Ci) put(dxb + c * plane, acc[c]);
}

template <int CI, typename T>
cudaError_t launch_dgrad(const T* g, const T* w, T* dx, int B, int Ci, int Co,
                         int H, int W, int KH, int KW, int pt, int pl, int OH,
                         int OW, cudaStream_t stream) {
  const size_t smem_bytes = static_cast<size_t>(Co) * KH * KW * CI * 4;
  cudaError_t err =
      dnnca::allow_smem(stencil_dgrad_kernel<CI, T>, smem_bytes);
  if (err != cudaSuccess) return err;
  const size_t n = static_cast<size_t>(B) * H * W;
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  stencil_dgrad_kernel<CI, T><<<grid, kThreads, smem_bytes, stream>>>(
      g, w, dx, B, Ci, Co, H, W, KH, KW, pt, pl, OH, OW);
  return dnnca::launched(cudaGetLastError());
}


// -- the pointwise route ------------------------------------------------------
using dnnca::tile::cp_async4;
using dnnca::tile::cp_async16;
using dnnca::tile::cp_async_wait_all;

constexpr int kPwThreads = 256;  // ops/kernels/stencil_conv_bwd.py: THREADS
constexpr int kRun = 4;          // float4 groups an f32 run (16 pixels): RUN
constexpr int kChunk = 16;       // block partials a finish unit adds: CHUNK

template <typename T>
struct PwArgs {
  const T* x;         // [B][Ci][P]
  const T* g;         // [B][Co][P]
  const T* w;         // [Co][Ci]
  T* dx;              // [B][Ci][P] or null
  T* dw;              // [Co][Ci]
  T* db;              // [Co]
  double* partial;    // [blocks][Co * Ci + Co]: dw, then db
  unsigned* ticket;   // 0 between calls
  int Ci, Co, P;
  int tile;           // pixels a tile, a multiple of 4
  int chunks;         // tiles a plane
  int tiles;          // B * chunks
  int per_block;      // tiles a block (the last block may have fewer)
  int slices;         // slices of a tile an item, a power of two
  int vec;            // P % 4 == 0 and x, g, dx 16-byte aligned
  int smem;           // dynamic shared memory, bytes
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Shared memory: xs [Ci][tile], gs [Co][tile], ws [Co][Ci] (to a whole
// float4), red [warps] and part [items] doubles; the finish reuses it from
// the start as [items a batch][K] doubles.
template <typename T>
__global__ void __launch_bounds__(kPwThreads)
pointwise_bwd_kernel(const PwArgs<T> a) {
  extern __shared__ float4 smem4[];
  const int Ci = a.Ci, Co = a.Co, P = a.P, TP = a.tile, TQ = TP / 4;
  const int n_w = Co * Ci, n = n_w + Co, S = a.slices, tid = threadIdx.x;
  float* xs = reinterpret_cast<float*>(smem4);
  float* gs = xs + Ci * TP;
  float* ws = gs + Co * TP;
  double* red = reinterpret_cast<double*>(ws + (n_w + 3) / 4 * 4);
  double* part = red + kPwThreads / 32;
  const float4* xs4 = reinterpret_cast<const float4*>(xs);
  const float4* gs4 = reinterpret_cast<const float4*>(gs);

  for (int i = tid; i < n_w; i += kPwThreads) ws[i] = to_f32(a.w[i]);
  for (int i = tid; i < n; i += kPwThreads) part[i] = 0.0;
  const int t0 = blockIdx.x * a.per_block;
  const int t1 = min(a.tiles, t0 + a.per_block);
  for (int t = t0; t < t1; ++t) {
    const int b = t / a.chunks, p0 = (t - b * a.chunks) * TP;
    const int valid = min(TP, P - p0);   // pixels of the tile in the plane
    const T* xb = a.x + static_cast<size_t>(b) * Ci * P + p0;
    const T* gb = a.g + static_cast<size_t>(b) * Co * P + p0;
    // stage every x and g plane of the tile, zero past the plane (the bf16
    // form converts as it stores: four values from 8 bytes where vec)
    for (int ch = 0; ch < Ci + Co; ++ch) {
      const T* src = ch < Ci ? xb + ch * P : gb + (ch - Ci) * P;
      float* dst = xs + ch * TP;   // gs follows xs
      if (a.vec) {
        for (int q = tid; q < TQ; q += kPwThreads) {
          if constexpr (std::is_same_v<T, float>)
            cp_async16(dst + 4 * q, 4 * q < valid ? src + 4 * q : src,
                       4 * q < valid);
          else
            reinterpret_cast<float4*>(dst)[q] =
                4 * q < valid ? dnnca::load4(src + 4 * q)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        for (int j = tid; j < TP; j += kPwThreads) {
          if constexpr (std::is_same_v<T, float>)
            cp_async4(dst + j, j < valid ? src + j : src, j < valid);
          else
            dst[j] = j < valid ? to_f32(src[j]) : 0.f;
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // dx = sum_o g_o w[o, c]
    if (a.dx != nullptr) {
      T* dxb = a.dx + static_cast<size_t>(b) * Ci * P + p0;
      for (int q = tid; q < TQ && 4 * q < valid; q += kPwThreads) {
        for (int c = 0; c < Ci; ++c) {
          float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int o = 0; o < Co; ++o) {
            const float wv = ws[o * Ci + c];
            const float4 gv = gs4[o * TQ + q];
            acc.x = fmaf(wv, gv.x, acc.x);
            acc.y = fmaf(wv, gv.y, acc.y);
            acc.z = fmaf(wv, gv.z, acc.z);
            acc.w = fmaf(wv, gv.w, acc.w);
          }
          T* dst = dxb + c * P + 4 * q;
          if (a.vec) {
            dnnca::store4(dst, acc);
          } else {
            const float v[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (4 * q + e < valid) put(dst + e, v[e]);
          }
        }
      }
    }

    // the items: unit u is slice s of item i; a slice takes groups s,
    // s + S, s + 2S, ... (conflict-free float4 reads), f32 a run of kRun
    // groups, f64 across runs. S == 1: a thread's units are whole items,
    // added to part directly. S > 1: one unit a thread (the plan keeps
    // n S <= kPwThreads); the slices of an item add up in a butterfly of
    // warp shuffles over segments of min(S, 32) lanes (every lane of a
    // segment ends with the same sum, since a + b == b + a), and past 32
    // slices the warps' sums add in order.
    const int lanes = S < 32 ? S : 32;
    for (int u = tid; u < (S > 1 ? kPwThreads : n); u += kPwThreads) {
      const int i = u / S, s = u - i * S;
      double sum = 0.0;
      if (u < n * S) {
        const int o = i < n_w ? i / Ci : i - n_w;
        const float4* gq = gs4 + o * TQ;
        const float4* xq = i < n_w ? xs4 + (i - o * Ci) * TQ : nullptr;
        for (int q0 = s; q0 < TQ; q0 += kRun * S) {
          float r = 0.f;
#pragma unroll
          for (int k = 0; k < kRun; ++k) {
            const int q = q0 + k * S;
            if (q >= TQ) break;
            const float4 gv = gq[q];
            if (xq != nullptr) {
              const float4 xv = xq[q];
              r = fmaf(gv.x, xv.x, r);
              r = fmaf(gv.y, xv.y, r);
              r = fmaf(gv.z, xv.z, r);
              r = fmaf(gv.w, xv.w, r);
            } else {
              r += (gv.x + gv.y) + (gv.z + gv.w);
            }
          }
          sum += r;
        }
      }
      if (S == 1) {
        part[u] += sum;
        continue;
      }
      for (int off = lanes / 2; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (S <= 32) {
        if (s == 0 && u < n * S) part[i] += sum;
      } else if ((tid & 31) == 0) {
        red[u / 32] = sum;
      }
    }
    if (S > 32) {
      __syncthreads();
      const int warps = S / 32;
      for (int i = tid; i < n; i += kPwThreads) {
        double sum = 0.0;
        for (int k = 0; k < warps; ++k) sum += red[i * warps + k];
        part[i] += sum;
      }
    }
    __syncthreads();   // the next tile overwrites xs, gs and red
  }

  for (int i = tid; i < n; i += kPwThreads)
    a.partial[static_cast<size_t>(blockIdx.x) * n + i] = part[i];
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (tid == 0) last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block: unit (item, k) adds the partials of blocks 16 k ..
  // 16 k + 15 in order (all its loads in flight); each item then adds its
  // K chunk sums in order. Items go in batches that fit shared memory.
  const int G = gridDim.x, K = (G + kChunk - 1) / kChunk;
  const int batch = (a.smem / 8) / K;   // >= 1 (the plan)
  double* fin = reinterpret_cast<double*>(smem4);
  for (int i0 = 0; i0 < n; i0 += batch) {
    const int ni = min(batch, n - i0);
    for (int u = tid; u < ni * K; u += kPwThreads) {
      const int il = u / K, k = u - il * K;
      double v[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int blk = k * kChunk + j;
        v[j] = blk < G ? __ldcg(a.partial + static_cast<size_t>(blk) * n +
                                i0 + il)
                       : 0.0;
      }
      double sum = 0.0;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) sum += v[j];
      fin[u] = sum;
    }
    __syncthreads();
    for (int il = tid; il < ni; il += kPwThreads) {
      double sum = 0.0;
      for (int k = 0; k < K; ++k) sum += fin[il * K + k];
      const int i = i0 + il;
      put(i < n_w ? a.dw + i : a.db + (i - n_w), static_cast<float>(sum));
    }
    __syncthreads();   // fin is reused by the next batch
  }
  if (tid == 0) *a.ticket = 0u;
}

// -- the tile route (the stencil route in one launch) -----------------------
// ops/kernels/stencil_conv_bwd.py: TILE_THREADS, DX_THREADS, KX. The first
// kDxThreads threads of a block compute dx (two pixels a thread, so that a
// weight read from shared memory serves both) while the others compute dw
// and db, so that the two loops overlap.
constexpr int kTileThreads = 512;
constexpr int kDxThreads = 128;
constexpr int kDwThreads = kTileThreads - kDxThreads;
constexpr int kKx = 3;   // taps of a kernel row a dw work unit sums

template <typename T>
struct TileArgs {
  const T* x;         // [B][Ci][H][W]
  const T* g;         // [B][Co][OH][OW]
  const T* w;         // [Co][Ci][KH][KW]
  T* dx;              // [B][Ci][H][W] or null
  T* dwb;             // [Co * Ci * KH * KW + Co]: dw, then db
  double* partial;    // [clusters][n2]
  unsigned* ticket;   // 0 between calls
  int B, Ci, Co, H, W, KH, KW, pt, pl, OH, OW;
  int rows;           // rows a tile: dx's input rows, dw's output rows
  int per_block;      // tiles a block (the last block may have fewer)
  int vec;            // OW % 4 == 0, W % 4 == 0, x and g aligned to 4
                      // values: rows read four values a load
  int smem;           // dynamic shared memory, bytes (the plan's)
};

// Where the CC four-channel chunks of staged pixel p lie: chunk q at
// p * CC + (q ^ swizzle(p)); for CC = 2, 4 or 8 any 8 consecutive pixels
// read at one q land on 8 different 16-byte bank groups.
__device__ __forceinline__ int swizzle(int p, int cc) {
  return cc == 2 ? (p >> 2) & 1 : cc == 4 ? (p >> 1) & 3 : cc == 8 ? p & 7 : 0;
}

// The tile's shared-memory layout from the shape (the wrapper's
// ``tile_plan`` computes the same numbers). CI, CO: the channel buckets of
// dx's and dw's sums.
template <int CI, int CO>
struct TileLayout {
  int taps, n_w, n, n2;      // dw items, then db; n2: n to a whole pair
  int kxc;                   // chunks of kKx taps a kernel row
  int units, per_pass, slices;   // dw's work units: (channel, kernel row,
                                 // chunk of taps), then the bias
  int tiles_y;               // tiles an image
  int g_lo, gc_lo, gr, gw;   // staged g: rows r0 + g_lo + [0, gr),
                             // columns gc_lo + [0, gw)
  int xr, xw;                // staged x: rows r0 - pt + [0, xr),
                             // columns -pl + [0, xw)
  int ws_f, g_f, x_f, red_f, part_f;   // floats before each region's end
  __host__ __device__ TileLayout(int Ci, int Co, int H, int W, int KH,
                                 int KW, int pt, int pl, int OH, int OW,
                                 int rows) {
    taps = KH * KW;
    n_w = Co * Ci * taps;
    n = n_w + Co;
    n2 = n + (n & 1);
    kxc = (KW + kKx - 1) / kKx;
    units = Ci * KH * kxc + 1;
    per_pass = units < kDwThreads ? units : kDwThreads;
    slices = kDwThreads / per_pass;
    tiles_y = ((H > OH ? H : OH) + rows - 1) / rows;
    g_lo = pt - KH + 1 < 0 ? pt - KH + 1 : 0;
    gc_lo = pl - KW + 1 < 0 ? pl - KW + 1 : 0;
    gr = rows + pt - g_lo;
    gw = (OW - 1 > W - 1 + pl ? OW - 1 : W - 1 + pl) - gc_lo + 1;
    xr = rows + KH - 1;
    xw = OW + KW - 1;
    ws_f = taps * CO * CI;
    g_f = ws_f + gr * gw * CO;
    x_f = g_f + Ci * xr * xw;
    red_f = x_f + slices * per_pass * kKx * CO;
    part_f = dnnca::tile::pad4(red_f);
  }
  __host__ __device__ size_t smem_bytes() const {
    return 4 * static_cast<size_t>(part_f) + 8 * static_cast<size_t>(n);
  }
};

// Stage ``rows`` rows of one column unit: row r reads src_of(r) (or
// nothing, zero-filled, where it returns null) into dst_of(r). f32 copies
// with cp.async (``base``, a valid address, stands for a null source); bf16
// reads four rows before it stores any.
template <typename T, typename Src, typename Dst>
__device__ __forceinline__ void stage_column(int rows, const T* base,
                                             Src src_of, Dst dst_of) {
  constexpr int kU = 4;
  for (int r0 = 0; r0 < rows; r0 += kU) {
    float v[kU];
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      const int r = r0 + k;
      if (r >= rows) break;
      const T* src = src_of(r);
      if constexpr (std::is_same_v<T, float>)
        cp_async4(dst_of(r), src != nullptr ? src : base, src != nullptr);
      else
        v[k] = src != nullptr ? to_f32(*src) : 0.f;
    }
    if constexpr (!std::is_same_v<T, float>) {
#pragma unroll
      for (int k = 0; k < kU; ++k) {
        const int r = r0 + k;
        if (r >= rows) break;
        *dst_of(r) = v[k];
      }
    }
  }
}

// Stage ``rows`` rows of four consecutive values (one 16-byte f32 or
// 8-byte bf16 read each, all of a unit's rows read before any is stored):
// row r reads src_of(r), or zeros where it returns null, and store(r, v)
// puts them.
template <typename T, typename Src, typename Store>
__device__ __forceinline__ void stage_quads(int rows, Src src_of,
                                            Store store) {
  constexpr int kR = 8;
  for (int r0 = 0; r0 < rows; r0 += kR) {
    float4 v[kR];
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      if (r0 + k >= rows) break;
      const T* src = src_of(r0 + k);
      v[k] = src != nullptr ? dnnca::load4(src)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      if (r0 + k >= rows) break;
      store(r0 + k, v[k]);
    }
  }
}

// One launch: a block walks ``per_block`` consecutive tiles of ``rows``
// rows of one image. For each it stages g (the tile's output rows with the
// halo dx needs, as [pixel][CO] in swizzled four-channel chunks) and x (the
// rows dw needs, [Ci][rows][columns], zero-padded), computes dx of the
// tile's input rows (one pixel a thread, CI sums) and adds each dw / db
// item's sum over the tile's output pixels to its f64 partial in shared
// memory (a work unit: one input channel, one kernel row and up to kKx of
// its taps, over one slice of the pixels, kKx x CO sums in registers); then
// the cluster adds its blocks' partials, takes the device's ticket, and
// the last cluster adds the clusters' partials.
template <int CI, int CO, typename T>
__global__ void __launch_bounds__(kTileThreads)
stencil_tile_bwd_kernel(const TileArgs<T> a) {
  constexpr bool kF32 = std::is_same_v<T, float>;
  constexpr int GC = CO / 4;   // chunks of a staged g pixel
  const TileLayout<CI, CO> lay(a.Ci, a.Co, a.H, a.W, a.KH, a.KW, a.pt, a.pl,
                               a.OH, a.OW, a.rows);
  const int Ci = a.Ci, Co = a.Co, KW = a.KW, taps = lay.taps;
  const int tid = threadIdx.x;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);   // [KH][KW][CO][CI]
  float* gs = ws + lay.ws_f;                     // [gr * gw][CO], chunked
  float* xs = ws + lay.g_f;                      // [Ci][xr][xw]
  float* red = ws + lay.x_f;   // [kKx][CO][slices][per_pass]
  double* part = reinterpret_cast<double*>(ws + lay.part_f);   // [n]
  const float4* ws4 = reinterpret_cast<const float4*>(ws);
  const float4* gs4 = reinterpret_cast<const float4*>(gs);

  // the weights, zero past Co and Ci: f32 by cp.async, waited for with
  // the first tile's copies; bf16 read into registers now (the first kWU a
  // thread; any past them one by one) and stored after the first tile's
  // staging is issued, so that the two latencies overlap
  auto w_src = [&](int i, bool& ok) -> const T* {
    const int c = i % CI, o = (i / CI) % CO, t = i / (CI * CO);
    ok = c < Ci && o < Co;
    return ok ? a.w + (o * Ci + c) * taps + t : a.w;
  };
  constexpr int kWU = 4;
  float wv[kWU];
  if constexpr (kF32) {
    for (int i = tid; i < lay.ws_f; i += kTileThreads) {
      bool ok;
      const T* src = w_src(i, ok);
      cp_async4(ws + i, src, ok);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kWU; ++k) {
      const int i = tid + k * kTileThreads;
      bool ok = false;
      const T* src = i < lay.ws_f ? w_src(i, ok) : a.w;
      wv[k] = ok ? to_f32(*src) : 0.f;
    }
    for (int i = tid + kWU * kTileThreads; i < lay.ws_f; i += kTileThreads) {
      bool ok;
      const T* src = w_src(i, ok);
      ws[i] = ok ? to_f32(*src) : 0.f;
    }
  }
  for (int i = tid; i < lay.n; i += kTileThreads) part[i] = 0.0;

  const int xplane = lay.xr * lay.xw;
  const int tiles = a.B * lay.tiles_y;
  const int t0 = blockIdx.x * a.per_block;
  const int t1 = min(tiles, t0 + a.per_block);
  for (int t = t0; t < t1; ++t) {
    const int b = t / lay.tiles_y, r0 = (t - b * lay.tiles_y) * a.rows;
    __syncthreads();   // every read of the previous tile is done
    const T* gb = a.g + static_cast<size_t>(b) * Co * a.OH * a.OW;
    const T* xb = a.x + static_cast<size_t>(b) * Ci * a.H * a.W;
    const int oy0 = r0 + lay.g_lo, iy0 = r0 - a.pt;
    auto g_slot = [&](int p, int o) {
      return gs + 4 * (p * GC + ((o >> 2) ^ swizzle(p, GC))) + (o & 3);
    };
    if (a.vec) {
      // g: a unit is (channel o < CO, four output columns), its gr rows
      // below it; x: (channel c, four input columns), its xr rows; zero
      // past Co and outside the rows; then the staged columns outside the
      // output (for g) and the image (for x), zero
      const int gq = a.OW / 4, xq = a.W / 4;
      for (int u = tid; u < CO * gq; u += kTileThreads) {
        const int o = u / gq, col = 4 * (u - o * gq) - lay.gc_lo;
        const T* src0 = gb + static_cast<size_t>(o < Co ? o : 0) * a.OH *
                                 a.OW + (col + lay.gc_lo);
        stage_quads<T>(
            lay.gr,
            [&](int r) -> const T* {
              const int oy = oy0 + r;
              return o < Co && oy >= 0 && oy < a.OH
                         ? src0 + static_cast<size_t>(oy) * a.OW
                         : nullptr;
            },
            [&](int r, float4 v) {
              const int p = r * lay.gw + col;
              *g_slot(p, o) = v.x;
              *g_slot(p + 1, o) = v.y;
              *g_slot(p + 2, o) = v.z;
              *g_slot(p + 3, o) = v.w;
            });
      }
      for (int u = tid; u < Ci * xq; u += kTileThreads) {
        const int c = u / xq, col = 4 * (u - c * xq) + a.pl;
        const T* src0 =
            xb + static_cast<size_t>(c) * a.H * a.W + (col - a.pl);
        float* dst0 = xs + c * xplane + col;
        stage_quads<T>(
            lay.xr,
            [&](int r) -> const T* {
              const int iy = iy0 + r;
              return iy >= 0 && iy < a.H
                         ? src0 + static_cast<size_t>(iy) * a.W
                         : nullptr;
            },
            [&](int r, float4 v) {
              float* d = dst0 + r * lay.xw;
              d[0] = v.x;
              d[1] = v.y;
              d[2] = v.z;
              d[3] = v.w;
            });
      }
      // the border columns: left of column 0 (k < left) and right of the
      // last (k >= left: column width + k)
      const int g_left = -lay.gc_lo, g_pad = lay.gw - a.OW;
      for (int u = tid; u < CO * lay.gr * g_pad; u += kTileThreads) {
        const int o = u / (lay.gr * g_pad), rk = u - o * lay.gr * g_pad;
        const int r = rk / g_pad, k = rk - r * g_pad;
        *g_slot(r * lay.gw + (k < g_left ? k : a.OW + k), o) = 0.f;
      }
      const int x_pad = lay.xw - a.W;
      for (int u = tid; u < Ci * lay.xr * x_pad; u += kTileThreads) {
        const int cr = u / x_pad, k = u - cr * x_pad;
        xs[cr * lay.xw + (k < a.pl ? k : a.W + k)] = 0.f;
      }
    } else {
      // a unit is (channel, staged column), its rows below it, value by
      // value; neighbouring threads take neighbouring columns
      for (int u = tid; u < CO * lay.gw; u += kTileThreads) {
        const int o = u / lay.gw, col = u - o * lay.gw, ox = lay.gc_lo + col;
        const bool col_ok = o < Co && ox >= 0 && ox < a.OW;
        const T* src0 = gb + static_cast<size_t>(col_ok ? o : 0) * a.OH *
                                 a.OW + (col_ok ? ox : 0);
        stage_column<T>(
            lay.gr, a.g,
            [&](int r) -> const T* {
              const int oy = oy0 + r;
              return col_ok && oy >= 0 && oy < a.OH
                         ? src0 + static_cast<size_t>(oy) * a.OW
                         : nullptr;
            },
            [&](int r) -> float* { return g_slot(r * lay.gw + col, o); });
      }
      for (int u = tid; u < Ci * lay.xw; u += kTileThreads) {
        const int c = u / lay.xw, col = u - c * lay.xw, ix = col - a.pl;
        const bool col_ok = ix >= 0 && ix < a.W;
        const T* src0 =
            xb + static_cast<size_t>(c) * a.H * a.W + (col_ok ? ix : 0);
        float* dst0 = xs + c * xplane + col;
        stage_column<T>(
            lay.xr, a.x,
            [&](int r) -> const T* {
              const int iy = iy0 + r;
              return col_ok && iy >= 0 && iy < a.H
                         ? src0 + static_cast<size_t>(iy) * a.W
                         : nullptr;
            },
            [&](int r) -> float* { return dst0 + r * lay.xw; });
      }
    }
    if constexpr (!kF32) {
      if (t == t0) {
#pragma unroll
        for (int k = 0; k < kWU; ++k) {
          const int i = tid + k * kTileThreads;
          if (i < lay.ws_f) ws[i] = wv[k];
        }
      }
    }
    if constexpr (kF32) cp_async_wait_all();
    __syncthreads();

    // dx of the tile's input rows (threads below kDxThreads): two pixels a
    // thread, i and i + kDxThreads, each with CI sums over (ky, kx, o),
    // four outputs a chunk (the weights past Co are zero); each weight read
    // serves both pixels
    if (a.dx != nullptr && tid < kDxThreads) {
      const int n_px = min(a.rows, a.H - r0) * a.W;
      for (int i = tid; i < n_px; i += 2 * kDxThreads) {
        const int i1 = i + kDxThreads < n_px ? i + kDxThreads : i;
        const int ly0 = i / a.W, ix0 = i - ly0 * a.W;
        const int ly1 = i1 / a.W, ix1 = i1 - ly1 * a.W;
        float acc[2][CI];
#pragma unroll
        for (int c = 0; c < CI; ++c) acc[0][c] = acc[1][c] = 0.f;
        for (int ky = 0; ky < a.KH; ++ky) {
          const int g0 = (ly0 + a.pt - ky - lay.g_lo) * lay.gw + ix0 + a.pl -
                         lay.gc_lo;
          const int g1 = (ly1 + a.pt - ky - lay.g_lo) * lay.gw + ix1 + a.pl -
                         lay.gc_lo;
          for (int kx = 0; kx < KW; ++kx) {
            const int p0 = g0 - kx, p1 = g1 - kx;
            const int s0 = swizzle(p0, GC), s1 = swizzle(p1, GC);
            const float4* wq = ws4 + (ky * KW + kx) * CO * (CI / 4);
#pragma unroll
            for (int q = 0; q < GC; ++q) {
              if (4 * q >= Co) break;   // the weights past Co are zero
              const float4 v0 = gs4[p0 * GC + (q ^ s0)];
              const float4 v1 = gs4[p1 * GC + (q ^ s1)];
              const float e0[4] = {v0.x, v0.y, v0.z, v0.w};
              const float e1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const float4* w4 = wq + (4 * q + j) * (CI / 4);
#pragma unroll
                for (int k = 0; k < CI / 4; ++k) {
                  const float4 wk = w4[k];
                  const float wvk[4] = {wk.x, wk.y, wk.z, wk.w};
#pragma unroll
                  for (int m = 0; m < 4; ++m) {
                    acc[0][4 * k + m] = fmaf(e0[j], wvk[m], acc[0][4 * k + m]);
                    acc[1][4 * k + m] = fmaf(e1[j], wvk[m], acc[1][4 * k + m]);
                  }
                }
              }
            }
          }
        }
        const size_t plane = static_cast<size_t>(a.H) * a.W;
        T* dst0 = a.dx + (static_cast<size_t>(b) * Ci * a.H + r0 + ly0) * a.W +
                  ix0;
        T* dst1 = a.dx + (static_cast<size_t>(b) * Ci * a.H + r0 + ly1) * a.W +
                  ix1;
#pragma unroll
        for (int c = 0; c < CI; ++c) {
          if (c < Ci) {
            put(dst0 + c * plane, acc[0][c]);
            if (i1 != i) put(dst1 + c * plane, acc[1][c]);
          }
        }
      }
    }

    // dw and db: work unit (channel c, kernel row ky, taps kx0 .. kx0 + 2;
    // or the bias) over a slice of the tile's output pixels, its kKx x CO
    // sums in f32 from a window of x and float4 broadcasts of g; the slices
    // of each item add up in order in f64 into the block's partial
    const int n_out = max(0, min(a.rows, a.OH - r0)) * a.OW;
    const int span = (n_out + lay.slices - 1) / lay.slices;
    // the dw threads: d = tid - kDxThreads
    const int d = tid - kDxThreads;
    const int j = d % lay.per_pass, sl = d / lay.per_pass;
    const int per_c = a.KH * lay.kxc;
    for (int p0 = 0; p0 < lay.units; p0 += lay.per_pass) {
      const int unit = p0 + j;
      if (d >= 0 && sl < lay.slices && unit < lay.units) {
        float acc[kKx][CO];
#pragma unroll
        for (int k = 0; k < kKx; ++k)
#pragma unroll
          for (int o = 0; o < CO; ++o) acc[k][o] = 0.f;
        const bool bias = unit == lay.units - 1;
        const int c = unit / per_c, rest = unit - c * per_c;
        const int ky = rest / lay.kxc, kx0 = (rest - ky * lay.kxc) * kKx;
        const int nk = bias ? 0 : min(kKx, KW - kx0);
        const float* xrow = xs + (bias ? 0 : c * xplane + ky * lay.xw + kx0);
        const int lo = sl * span, hi = min(lo + span, n_out);
        // the slice's pixels in order, (ly, ox) stepped without a division
        int ly = lo / a.OW, ox = lo - ly * a.OW;
        for (int px = lo; px < hi; ++px, ++ox) {
          if (ox == a.OW) {
            ox = 0;
            ++ly;
          }
          const int p = (ly - lay.g_lo) * lay.gw + ox - lay.gc_lo;
          const int s = swizzle(p, GC);
          const float* xp = xrow + ly * lay.xw + ox;
          float v[kKx];
#pragma unroll
          for (int k = 0; k < kKx; ++k)
            v[k] = k < nk ? xp[k] : bias && k == 0 ? 1.f : 0.f;
#pragma unroll
          for (int q = 0; q < GC; ++q) {
            if (4 * q >= Co) break;   // g past Co is zero
            const float4 t4 = gs4[p * GC + (q ^ s)];
            const float gq[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
            for (int k = 0; k < kKx; ++k)
#pragma unroll
              for (int m = 0; m < 4; ++m)
                acc[k][4 * q + m] = fmaf(v[k], gq[m], acc[k][4 * q + m]);
          }
        }
        // consecutive threads write consecutive words (no bank conflict)
        const int sp = lay.slices * lay.per_pass;
#pragma unroll
        for (int k = 0; k < kKx; ++k)
#pragma unroll
          for (int o = 0; o < CO; ++o) red[(k * CO + o) * sp + d] = acc[k][o];
      }
      __syncthreads();
      for (int i = tid; i < lay.per_pass * kKx * Co; i += kTileThreads) {
        const int jj = i / (kKx * Co), ko = i - jj * kKx * Co;
        const int k = ko / Co, o = ko - k * Co, u2 = p0 + jj;
        if (u2 >= lay.units) continue;
        int e;
        if (u2 == lay.units - 1) {
          if (k != 0) continue;
          e = lay.n_w + o;
        } else {
          const int c2 = u2 / per_c, rest2 = u2 - c2 * per_c;
          const int ky2 = rest2 / lay.kxc;
          const int kx = (rest2 - ky2 * lay.kxc) * kKx + k;
          if (kx >= KW) continue;
          e = ((o * Ci + c2) * a.KH + ky2) * KW + kx;
        }
        const float* rs = red + (k * CO + o) * lay.slices * lay.per_pass + jj;
        double sum = 0.0;
        for (int s2 = 0; s2 < lay.slices; ++s2) sum += rs[s2 * lay.per_pass];
        part[e] += sum;
      }
      __syncthreads();   // red is reused by the next pass
    }
  }

  // the cluster's partial: block r of the cluster adds slice r of the items
  // over the cluster's blocks in rank order (f64, from their shared
  // memory) and writes it; the second sync keeps every block's shared
  // memory alive until the others have read it
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nc = static_cast<int>(cluster.num_blocks());
  const int cid = blockIdx.x / nc;
  cluster.sync();
  {
    const int per = (lay.n2 + nc - 1) / nc;
    const int lo = rank * per, hi = min(lay.n2, lo + per);
    for (int e = lo + tid; e < hi; e += kTileThreads) {
      double v[8];   // every block's value read before the first add
#pragma unroll
      for (int r = 0; r < 8; ++r)
        v[r] = r < nc && e < lay.n ? cluster.map_shared_rank(part, r)[e] : 0.0;
      double sum = 0.0;
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (r < nc) sum += v[r];
      a.partial[static_cast<size_t>(cid) * lay.n2 + e] = sum;
    }
  }
  __threadfence();
  cluster.sync();
  // the cluster's first block takes the device's ticket and writes its
  // flag into every block of the cluster
  __shared__ bool last;
  if (rank == 0 && tid == 0) {
    const bool l = atomicAdd(a.ticket, 1u) == gridDim.x / nc - 1;
    for (int r = 0; r < nc; ++r) *cluster.map_shared_rank(&last, r) = l;
  }
  cluster.sync();
  if (!last) return;
  __threadfence();

  // the last cluster: block r adds slice r of the item pairs; unit (item
  // pair, k) adds the pairs of clusters 16 k .. 16 k + 15 in order (all its
  // loads in flight); each pair then adds its K chunk sums in order. Pairs
  // go in batches that fit shared memory.
  const int G = gridDim.x / nc, K = (G + kChunk - 1) / kChunk;
  const int n_pair = lay.n2 / 2, per = (n_pair + nc - 1) / nc;
  const int p_hi = min(n_pair, (rank + 1) * per);
  const int batch = (a.smem / 16) / K;   // >= 1 (the plan)
  double2* fin = reinterpret_cast<double2*>(smem4);
  const double2* part2 = reinterpret_cast<const double2*>(a.partial);
  for (int i0 = rank * per; i0 < p_hi; i0 += batch) {
    const int ni = min(batch, p_hi - i0);
    for (int u = tid; u < ni * K; u += kTileThreads) {
      const int il = u / K, k = u - il * K;
      double2 v[kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int blk = k * kChunk + jj;
        v[jj] = blk < G ? __ldcg(part2 + static_cast<size_t>(blk) * n_pair +
                                 i0 + il)
                        : make_double2(0.0, 0.0);
      }
      double2 sum = make_double2(0.0, 0.0);
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        sum.x += v[jj].x;
        sum.y += v[jj].y;
      }
      fin[u] = sum;
    }
    __syncthreads();
    for (int il = tid; il < ni; il += kTileThreads) {
      double sx = 0.0, sy = 0.0;
      for (int k = 0; k < K; ++k) {
        sx += fin[il * K + k].x;
        sy += fin[il * K + k].y;
      }
      const int i = 2 * (i0 + il);
      put(a.dwb + i, static_cast<float>(sx));
      if (i + 1 < lay.n) put(a.dwb + i + 1, static_cast<float>(sy));
    }
    __syncthreads();   // fin is reused by the next batch
  }
  if (rank == 0 && tid == 0) *a.ticket = 0u;
}

template <int CI, int CO, typename T>
cudaError_t launch_tile(const TileArgs<T>& a, int blocks, int cluster_size,
                        cudaStream_t stream) {
  const TileLayout<CI, CO> lay(a.Ci, a.Co, a.H, a.W, a.KH, a.KW, a.pt, a.pl,
                               a.OH, a.OW, a.rows);
  const int G = blocks / (cluster_size > 0 ? cluster_size : 1);
  const int K = (G + kChunk - 1) / kChunk;
  // the plan's shared memory holds the layout and one finish unit a pair
  // of one batch; its tiles, a.per_block a block, cover the images; the
  // grid is whole clusters of 1 to 8 blocks
  if (a.smem < 0 || static_cast<size_t>(a.smem) < lay.smem_bytes() ||
      a.smem < 16 * K || a.smem > dnnca::kMaxDynamicSmemBytes ||
      a.rows < 1 || a.per_block < 1 || cluster_size < 1 || cluster_size > 8 ||
      blocks % cluster_size != 0 ||
      static_cast<long long>(blocks) * a.per_block <
          static_cast<long long>(a.B) * lay.tiles_y)
    return cudaErrorInvalidValue;
  const auto kernel = stencil_tile_bwd_kernel<CI, CO, T>;
  cudaError_t err = dnnca::allow_smem(kernel, a.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(kTileThreads);
  config.dynamicSmemBytes = a.smem;
  config.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = cluster_size;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  return dnnca::launched(cudaLaunchKernelEx(&config, kernel, a));
}

template <int CO, typename T>
cudaError_t tile_ci(const TileArgs<T>& a, int blocks, int cluster,
                    cudaStream_t s) {
  if (a.Ci <= 4) return launch_tile<4, CO>(a, blocks, cluster, s);
  if (a.Ci <= 8) return launch_tile<8, CO>(a, blocks, cluster, s);
  if (a.Ci <= 16) return launch_tile<16, CO>(a, blocks, cluster, s);
  return launch_tile<32, CO>(a, blocks, cluster, s);
}

template <typename T>
int tile_bwd(const T* x, const T* g, const T* w, T* dx, T* dwb,
             double* partial, unsigned* ticket, int B, int Ci, int Co, int H,
             int W, int KH, int KW, int pt, int pl, int OH, int OW, int rows,
             int per_block, int blocks, int cluster, int vec, int smem,
             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TileArgs<T> a{x,  g,  w,  dx, dwb, partial, ticket, B,    Ci,
                      Co, H,  W,  KH, KW,  pt,      pl,     OH,   OW,
                      rows, per_block, vec, smem};
  if (Co <= 4) return tile_ci<4>(a, blocks, cluster, s);
  if (Co <= 8) return tile_ci<8>(a, blocks, cluster, s);
  if (Co <= 16) return tile_ci<16>(a, blocks, cluster, s);
  return tile_ci<32>(a, blocks, cluster, s);
}

template <typename T>
int stencil_bwd(const T* x, const T* g, const T* w, T* dx, T* dwb,
                float* partial, int B, int Ci, int Co, int H, int W, int KH,
                int KW, int pt, int pl, int OH, int OW, int wgrad_blocks,
                int device, void* stream) {
  constexpr bool kBf16 = !std::is_same_v<T, float>;
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
  const dnnca::WgradArgs wg{g,  nullptr, x,  partial, dwb, B,  Co,
                            Ci, OH,      OW, H,       W,   KH, KW,
                            pt, pl,      wgrad_blocks, kBf16, kBf16, kBf16};
  return dnnca::launch_wgrad(wg, s);
}

template <typename T>
int pointwise_bwd(const T* x, const T* g, const T* w, T* dx, T* dw, T* db,
                  double* partial, unsigned* ticket, int B, int Ci, int Co,
                  int P, int tile, int per_block, int blocks, int slices,
                  int vec, int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = dnnca::allow_smem(pointwise_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int chunks = (P + tile - 1) / tile;
  const PwArgs<T> a{x,      g,      w,          dx,        dw,     db,
                    partial, ticket, Ci,         Co,        P,      tile,
                    chunks,  B * chunks, per_block, slices, vec,    smem};
  pointwise_bwd_kernel<T><<<blocks, kPwThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return dnnca::launched(cudaGetLastError());
}

}  // namespace

using dnnca::bf16;

// dx may be null (no data gradient). dwb is [Co*Ci*KH*KW + Co] (dw then
// db); partial is [size of dwb * wgrad_blocks] scratch.
extern "C" int dnnca_stencil_conv_bwd(
    const float* x, const float* g, const float* w, float* dx, float* dwb,
    float* partial, int B, int Ci, int Co, int H, int W, int KH, int KW,
    int pt, int pl, int OH, int OW, int wgrad_blocks, int device,
    void* stream) {
  return stencil_bwd(x, g, w, dx, dwb, partial, B, Ci, Co, H, W, KH, KW, pt,
                     pl, OH, OW, wgrad_blocks, device, stream);
}

// The bf16 form: x, g, w, dx and dwb bf16; partial f32.
extern "C" int dnnca_stencil_conv_bwd_bf16(
    const bf16* x, const bf16* g, const bf16* w, bf16* dx, bf16* dwb,
    float* partial, int B, int Ci, int Co, int H, int W, int KH, int KW,
    int pt, int pl, int OH, int OW, int wgrad_blocks, int device,
    void* stream) {
  return stencil_bwd(x, g, w, dx, dwb, partial, B, Ci, Co, H, W, KH, KW, pt,
                     pl, OH, OW, wgrad_blocks, device, stream);
}

// The tile route (any other shape whose tile fits) in one launch of
// ``blocks`` blocks in clusters of ``cluster`` with the plan of
// ops/kernels/stencil_conv_bwd.py (tile_plan); vec: OW % 4 == 0, W % 4 ==
// 0 and x, g aligned to 4 values (four-value reads); dx may be null. dwb is
// [Co*Ci*KH*KW + Co] (dw then db); partial is [blocks / cluster][n2]
// doubles of scratch (n2: Co*Ci*KH*KW + Co to a whole pair); ticket is one
// unsigned that is 0 before the call and is left at 0.
extern "C" int dnnca_stencil_conv_bwd_tile(
    const float* x, const float* g, const float* w, float* dx, float* dwb,
    double* partial, unsigned* ticket, int B, int Ci, int Co, int H, int W,
    int KH, int KW, int pt, int pl, int OH, int OW, int rows, int per_block,
    int blocks, int cluster, int vec, int smem, int device, void* stream) {
  return tile_bwd(x, g, w, dx, dwb, partial, ticket, B, Ci, Co, H, W, KH, KW,
                  pt, pl, OH, OW, rows, per_block, blocks, cluster, vec, smem,
                  device, stream);
}

// The bf16 form of the tile route: x, g, w, dx and dwb bf16.
extern "C" int dnnca_stencil_conv_bwd_tile_bf16(
    const bf16* x, const bf16* g, const bf16* w, bf16* dx, bf16* dwb,
    double* partial, unsigned* ticket, int B, int Ci, int Co, int H, int W,
    int KH, int KW, int pt, int pl, int OH, int OW, int rows, int per_block,
    int blocks, int cluster, int vec, int smem, int device, void* stream) {
  return tile_bwd(x, g, w, dx, dwb, partial, ticket, B, Ci, Co, H, W, KH, KW,
                  pt, pl, OH, OW, rows, per_block, blocks, cluster, vec, smem,
                  device, stream);
}

// The pointwise route (1 x 1, zero pads) in one launch of ``blocks``
// blocks with the plan of ops/kernels/stencil_conv_bwd.py; dx may be null.
// partial is [blocks][Co * Ci + Co] doubles of scratch; ticket is one
// unsigned that is 0 before the call and is left at 0.
extern "C" int dnnca_pointwise_conv_bwd(
    const float* x, const float* g, const float* w, float* dx, float* dw,
    float* db, double* partial, unsigned* ticket, int B, int Ci, int Co, int P,
    int tile, int per_block, int blocks, int slices, int vec, int smem,
    int device, void* stream) {
  return pointwise_bwd(x, g, w, dx, dw, db, partial, ticket, B, Ci, Co, P,
                       tile, per_block, blocks, slices, vec, smem, device,
                       stream);
}

// The bf16 form of the pointwise route: x, g, w, dx, dw and db bf16 (vec:
// P % 4 == 0 and x, g, dx aligned to 4 elements).
extern "C" int dnnca_pointwise_conv_bwd_bf16(
    const bf16* x, const bf16* g, const bf16* w, bf16* dx, bf16* dw,
    bf16* db, double* partial, unsigned* ticket, int B, int Ci, int Co, int P,
    int tile, int per_block, int blocks, int slices, int vec, int smem,
    int device, void* stream) {
  return pointwise_bwd(x, g, w, dx, dw, db, partial, ticket, B, Ci, Co, P,
                       tile, per_block, blocks, slices, vec, smem, device,
                       stream);
}
