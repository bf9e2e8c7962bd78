// Backward of the stride-1 stencil conv (stencil_conv.cu):
//   dx[b, c, y, x] = sum_{o, ky, kx} g[b, o, y + pt - ky, x + pl - kx] * w[o, c, ky, kx]
//   dw[o, c, ky, kx] = sum_{b, y, x} g[b, o, y, x] * xpad[b, c, y + ky, x + kx]
//   db[o]           = sum_{b, y, x} g[b, o, y, x]
// g arrives already masked by the forward's output when the relu is fused
// (the wrapper does it, as fastconv.py:200-201 does in the JAX package).
//
// Replaces conv_kernel.stencil_conv2d_bwd_pallas
// (dnncancerannotator_tpu/ops/pallas/conv_kernel.py:175), which returns dx
// and the packed [dw, db] from one call. NCHW f32, w [Co, Ci, KH, KW], any
// pads; Ci, Co <= 32. On the model's path it is the 1 x 1, 3 -> 1 logits
// head. The routes are the forward's (ops/kernels/stencil_conv.py: route).
//
// What bounds it on the H100: at the head, 3 FMAs for dx and 4 for dw and
// db a pixel against 28 bytes of device memory (x and g read, dx written),
// so device-memory bytes.
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
// - stencil (any other shape): dx is one thread per input pixel with the
//   Ci gradients in registers (a template bucket CI) and the weights in
//   shared memory as [Co][KH][KW][CI] float4 broadcasts; the output window
//   is a bounds test on the index of g, never a padded copy. dw and db go
//   through the shared wgrad kernel and its fixed-order partial sum.
//
// bf16 forms (entries dnnca_stencil_conv_bwd_bf16,
// dnnca_pointwise_conv_bwd_bf16): x, g and w in bf16, converted to f32 as
// they are read or staged, the sums the f32 form's in its order, and dx,
// dw and db rounded to bf16 (nearest-even) from the f32 form's f32
// results, as fastconv.py:213 casts stencil_conv2d_bwd_pallas's: equal to
// the f32 form's on the upcast inputs, rounded.
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
