// NHWC stride-1 convolution with explicit pads, bias and an optional fused
// relu (the NHWC form of stencil_conv.cu):
//   out[b, y, x, o] = bias[o] + sum_{ky, kx, c} xpad[b, y+ky, x+kx, c] * w[o, c, ky, kx]
// with xpad x zero-padded by (pt, pb) rows and (pl, pr) columns. x's pixels
// lie ``xs`` elements apart (xs >= Ci, its Ci channels contiguous): an
// encoder of MulmoUNet reads its channel of the [B, H, W, 5] batch in
// place, with no copy. out is a contiguous [B, OH, OW, Co]; w is OIHW,
// Ci, Co <= 32.
//
// Replaces conv_kernel.stencil_conv2d_pallas with ``nchw=False``
// (dnncancerannotator_tpu/ops/pallas/conv_kernel.py:84). On MulmoUNet's
// path it runs each encoder's first conv (3 x 3 SAME, 1 -> 16, relu; xs =
// 5 in f32, 1 in bf16, where the encoder casts its channel) and the 1 x 1,
// 16 -> 1 head.
//
// What bounds it on the H100: device-memory bytes. Both sites move 68
// bytes a pixel in f32 (the encoder writes 64 of them) for at most 144
// FMAs. The encoder's output is a stream of 64 bytes a pixel and its input
// a 4-byte read at a 20-byte pixel stride; the head reads 64 bytes a pixel
// and writes 4.
//
// Two routes (ops/kernels/stencil_conv_nhwc.py: route, a function of the
// shape):
//
// - tile: a block owns ``rows`` whole output rows of one image (the plan's,
//   ~1024 pixels), so its output is one contiguous run of rows * OW * Co
//   values. It stages the input rows the tile needs, halo included, in
//   shared memory once (f32: cp.async; bf16: ordinary loads, all of a
//   column's rows in flight at once, converted), zero-filled where the padding
//   lies, so no tap tests a bound; the weights' loads are issued before
//   the staging's and stored after them. The weights and bias sit in
//   shared memory as [KH][KW][Ci][CO] f32 broadcasts. Three forms (KX):
//   a one-channel 3-wide stencil (the encoder) has a thread compute P
//   horizontally adjacent pixels from a window of P + 2 staged values a
//   row, reused across the three taps; a 1 x 1 conv with zero pads (the
//   head) has no halo to share, so nothing is staged and a thread reads
//   its pixel's channels straight into registers; any other shape takes
//   one pixel a thread.
//   The results go to shared memory: as 16-byte chunks of a thread's P *
//   Co outputs (one chunk of padding after each thread's run where its
//   chunk count is even, so a warp's writes hit every bank once), else
//   value by value. Then consecutive threads store consecutive 16-byte
//   chunks of the tile's run (8 bf16 a chunk), a contiguous stream; a run
//   that does not start or end on 16 bytes takes its edge chunks value by
//   value. A thread holds at most 64 registers, so that four blocks share
//   an SM: a block's staging and stores are latency that only the other
//   blocks hide (at three a SM, register-bound, the bf16 encoder ran
//   10-27% slower on an H100 80GB HBM3 at 700 W; PERF.md §6).
// - direct: one thread an output pixel, all Co sums in registers, its
//   inputs read from device memory (four channels a read where aligned)
//   and its Co outputs written from registers. Only for a shape whose one
//   output row does not fit a block's shared memory.
//
// The sum of a pixel runs in one order on both routes: the bias, then the
// taps by (ky, kx, c), each an fmaf in f32. The bf16 form (entry
// dnnca_stencil_conv_nhwc_bf16) stages x, w and the bias converted to f32
// (exact) and rounds each output to bf16 (nearest-even) as it is written:
// equal to the f32 form on the upcast inputs, rounded. stencil_conv2d_pallas
// takes bf16 the same way: it upcasts, computes in f32, and its caller
// rounds.
#include "conv_tile.cuh"

namespace {

constexpr int kThreads = 256;  // ops/kernels/stencil_conv_nhwc.py: THREADS
// tile blocks resident on an SM at the least: the registers a thread may
// hold are capped so that this many fit (64 a thread), since a block's
// staging and stores are latency that only other blocks hide
constexpr int kTileMinBlocks = 4;

using dnnca::bf16;
using dnnca::put;
using dnnca::store4;
using dnnca::to_f32;
using dnnca::tile::cp_async4;
using dnnca::tile::cp_async_wait_all;
using dnnca::tile::pad4;

// Four consecutive values (16-byte aligned f32, 8-byte aligned bf16) and
// one value, read only, as f32.
template <typename T>
__device__ __forceinline__ float4 ld4(const T* p) {
  if constexpr (std::is_same_v<T, float>)
    return __ldg(reinterpret_cast<const float4*>(p));
  else
    return dnnca::unpack4(__ldg(reinterpret_cast<const uint2*>(p)));
}

// -- the direct route ----------------------------------------------------------
// CO: the output-channel bucket (1, 4, 8, 16 or 32); VI: 4 to read a pixel's
// Ci inputs four at a time (Ci % 4 == 0, xs % 4 == 0, x aligned), else 1;
// VO: 4 to write its Co outputs four at a time (Co == CO, CO % 4 == 0),
// else 1.
template <int CO, int VI, int VO, typename T>
__global__ void __launch_bounds__(kThreads)
stencil_nhwc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ bias, T* __restrict__ out,
                    int B, int Ci, int Co, int H, int W, int xs, int KH,
                    int KW, int pt, int pl, int OH, int OW, int relu) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int taps = KH * KW;
  const int n_w = taps * Ci * CO;
  float* ws = smem;         // [KH][KW][Ci][CO]
  float* bs = smem + n_w;   // [CO]
  for (int i = threadIdx.x; i < n_w; i += kThreads) {
    const int o = i % CO, c = (i / CO) % Ci, t = i / (CO * Ci);
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
  const T* xb = x + static_cast<size_t>(b) * H * W * xs;
  for (int ky = 0; ky < KH; ++ky) {
    const int iy = oy - pt + ky;
    if (iy < 0 || iy >= H) continue;
    for (int kx = 0; kx < KW; ++kx) {
      const int ix = ox - pl + kx;
      if (ix < 0 || ix >= W) continue;
      const T* px = xb + (static_cast<size_t>(iy) * W + ix) * xs;
      const float* wt = ws + (ky * KW + kx) * Ci * CO;
      for (int c = 0; c < Ci; c += VI) {
        float v[VI];
        if constexpr (VI == 4) {
          const float4 q = ld4(px + c);
          v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        } else {
          v[0] = dnnca::ldg_f32(px + c);
        }
#pragma unroll
        for (int j = 0; j < VI; ++j) {
          const float* wc = wt + (c + j) * CO;
#pragma unroll
          for (int o = 0; o < CO; ++o) acc[o] = fmaf(v[j], wc[o], acc[o]);
        }
      }
    }
  }
  if (relu) {
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[o] = fmaxf(acc[o], 0.f);
  }
  T* ob = out + idx * Co;
  if constexpr (VO == 4) {
#pragma unroll
    for (int o = 0; o < CO; o += 4)
      store4(ob + o, make_float4(acc[o], acc[o + 1], acc[o + 2], acc[o + 3]));
  } else {
#pragma unroll
    for (int o = 0; o < CO; ++o)
      if (o < Co) put(ob + o, acc[o]);
  }
}

template <int CO, int VI, int VO, typename T>
cudaError_t launch_direct(const T* x, const T* w, const T* bias, T* out,
                          int B, int Ci, int Co, int H, int W, int xs, int KH,
                          int KW, int pt, int pl, int OH, int OW, int relu,
                          cudaStream_t stream) {
  const size_t smem_bytes = (static_cast<size_t>(KH) * KW * Ci + 1) * CO * 4;
  cudaError_t err =
      dnnca::allow_smem(stencil_nhwc_kernel<CO, VI, VO, T>, smem_bytes);
  if (err != cudaSuccess) return err;
  const size_t n = static_cast<size_t>(B) * OH * OW;
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  stencil_nhwc_kernel<CO, VI, VO, T><<<grid, kThreads, smem_bytes, stream>>>(
      x, w, bias, out, B, Ci, Co, H, W, xs, KH, KW, pt, pl, OH, OW, relu);
  return dnnca::launched(cudaGetLastError());
}

template <int CO, typename T>
cudaError_t direct_co(const T* x, const T* w, const T* bias, T* out, int B,
                      int Ci, int Co, int H, int W, int xs, int KH, int KW,
                      int pt, int pl, int OH, int OW, int relu, int vec_in,
                      cudaStream_t s) {
#define DNNCA_DIRECT(VI, VO)                                                 \
  launch_direct<CO, VI, VO>(x, w, bias, out, B, Ci, Co, H, W, xs, KH, KW, pt, \
                            pl, OH, OW, relu, s)
  constexpr int kVo = CO % 4 == 0 ? 4 : 1;
  if (Co == CO) return vec_in ? DNNCA_DIRECT(4, kVo) : DNNCA_DIRECT(1, kVo);
  return vec_in ? DNNCA_DIRECT(4, 1) : DNNCA_DIRECT(1, 1);
#undef DNNCA_DIRECT
}


// -- the tile route ------------------------------------------------------------
// The tile's forms (ops/kernels/stencil_conv_nhwc.py: form): KX = 3 for a
// one-channel 3-wide stencil, whose staged window of P + 2 values a thread
// reuses across the three taps; KX = 1 for a 1 x 1 conv with zero pads,
// which has no halo to share, so a thread reads its pixel's channels from
// device memory straight into registers and nothing is staged; KX = 0 for
// any other shape. Pixels a thread computes along a row: for KX = 3 as
// many as keep P * CO <= 32 sums in registers (at most 4), else one
// (ops/kernels/stencil_conv_nhwc.py: pixels).
__host__ __device__ constexpr int tile_px(int co, int kx) {
  return kx == 3 ? (co >= 32 ? 1 : co >= 16 ? 2 : 4) : 1;
}

template <typename T>
struct TileArgs {
  const T* x;      // [B][H][W] pixels xs elements apart, Ci channels each
  const T* w;      // [Co][Ci][KH][KW]
  const T* bias;   // [Co]
  T* out;          // [B][OH][OW][Co], 16-byte aligned
  int B, Ci, Co, H, W, xs, KH, KW, pt, pl, OH, OW, relu;
  int vec_in;      // four channels a read: Ci % 4 == 0, xs % 4 == 0, x aligned
  int rows;        // output rows a tile (the plan's)
  int vec_out;     // a thread's P * Co outputs as 16-byte chunks
};

// The tile's layout, from the shape and the plan (the wrapper's
// ``plan`` computes the same numbers).
template <int CO, int KX, typename T>
struct TileLayout {
  static constexpr int P = tile_px(CO, KX);
  static constexpr int V = 16 / sizeof(T);   // elements a 16-byte chunk
  // vec_out: chunks a group (P * CO values), and their stride in shared
  // memory (a chunk of padding after an even count)
  static constexpr int gc = P * CO / V;
  static constexpr int gs = gc + (gc % 2 == 0 ? 1 : 0);
  int gpr;        // pixel groups a row
  int sw;         // staged pixels a row: gpr * P + KW - 1
  int in_row;     // floats a staged row (to a whole 16 bytes)
  int in_rows;    // staged rows: rows + KH - 1 (none for KX = 1)
  int w_floats;   // weights and bias (to a whole 16 bytes)
  __device__ __host__ TileLayout(const TileArgs<T>& a) {
    gpr = (a.OW + P - 1) / P;
    sw = gpr * P + a.KW - 1;
    in_row = pad4(sw * a.Ci);
    in_rows = KX == 1 ? 0 : a.rows + a.KH - 1;
    w_floats = pad4(a.KH * a.KW * a.Ci * CO + CO);
  }
  __device__ __host__ size_t out_bytes(const TileArgs<T>& a) const {
    if (a.vec_out) return 16 * static_cast<size_t>(a.rows) * gpr * gs;
    const size_t n = static_cast<size_t>(a.rows) * a.OW * a.Co + V;
    return (n * sizeof(T) + 15) / 16 * 16;
  }
  __device__ __host__ size_t smem_bytes(const TileArgs<T>& a) const {
    return 4 * (static_cast<size_t>(w_floats) +
                static_cast<size_t>(in_rows) * in_row) +
           out_bytes(a);
  }
};

// acc[p][o] += v[p] * wt[o] for the CO weights of one (tap, channel): CO
// % 4 == 0 reads them as float4 broadcasts.
template <int P, int CO>
__device__ __forceinline__ void fma_tap(float (&acc)[P][CO],
                                        const float (&v)[P],
                                        const float* wt) {
  float wv[CO];
  if constexpr (CO % 4 == 0) {
#pragma unroll
    for (int q = 0; q < CO / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(wt)[q];
      wv[4 * q] = t.x;
      wv[4 * q + 1] = t.y;
      wv[4 * q + 2] = t.z;
      wv[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int o = 0; o < CO; ++o) wv[o] = wt[o];
  }
#pragma unroll
  for (int o = 0; o < CO; ++o)
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p][o] = fmaf(v[p], wv[o], acc[p][o]);
}

// CO: the output-channel bucket (1, 4, 8, 16 or 32); KX: the form (3, 1 or
// 0, above). The staged rows hold each pixel's Ci values in order.
template <int CO, int KX, typename T>
__global__ void __launch_bounds__(kThreads, kTileMinBlocks)
stencil_nhwc_tile_kernel(const TileArgs<T> a) {
  constexpr bool kF32 = std::is_same_v<T, float>;
  using L = TileLayout<CO, KX, T>;
  constexpr int P = L::P, V = L::V;
  const L lay(a);
  const int Ci = a.Ci, Co = a.Co, KH = a.KH, KW = a.KW, OW = a.OW;
  const int taps = KH * KW, n_w = taps * Ci * CO, tid = threadIdx.x;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);   // [KH][KW][Ci][CO]
  float* bs = ws + n_w;                          // [CO]
  float* in_s = ws + lay.w_floats;               // [in_rows][in_row]
  T* out_s = reinterpret_cast<T*>(in_s + lay.in_rows * lay.in_row);

  const int tiles_y = (a.OH + a.rows - 1) / a.rows;
  const int b = blockIdx.x / tiles_y;
  const int oy0 = (blockIdx.x - b * tiles_y) * a.rows;
  const int nr = min(a.rows, a.OH - oy0);   // output rows of the tile

  // the weights and bias (bs follows ws): the loads of the first kWU a
  // thread are issued before the staging's and stored after them, so that
  // their latencies overlap
  auto w_val = [&](int i) -> float {
    if (i >= n_w) return i - n_w < Co ? to_f32(a.bias[i - n_w]) : 0.f;
    const int o = i % CO, c = (i / CO) % Ci, t = i / (CO * Ci);
    return o < Co ? to_f32(a.w[(o * Ci + c) * taps + t]) : 0.f;
  };
  constexpr int kWU = 4;
  float wv[kWU];
#pragma unroll
  for (int k = 0; k < kWU; ++k) {
    const int i = tid + k * kThreads;
    wv[k] = i < n_w + CO ? w_val(i) : 0.f;
  }

  // the input rows oy0 - pt + [0, in_rows) and columns -pl + [0, sw), zero
  // outside the image. A unit is one value of a staged row; a thread takes
  // units tid, tid + kThreads, .. of the row and copies each down every
  // staged row, so its division by the row's layout is made once a unit,
  // not once a copy. The bf16 form reads kU rows of a unit before it
  // stores any.
  const T* xb = a.x + static_cast<size_t>(b) * a.H * a.W * a.xs;
  const size_t x_row = static_cast<size_t>(a.W) * a.xs;
  const int iy0 = oy0 - a.pt, per_row = lay.sw * Ci;
  constexpr int kU = 8;
  for (int u = tid; u < (KX == 1 ? 0 : per_row); u += kThreads) {
    const int col = u / Ci, c = u - col * Ci, ix = col - a.pl;
    const bool col_ok = ix >= 0 && ix < a.W;
    const size_t off = static_cast<size_t>(col_ok ? ix : 0) * a.xs + c;
    float* dst0 = in_s + u;
    for (int r0 = 0; r0 < lay.in_rows; r0 += kU) {
      float v[kU];
#pragma unroll
      for (int k = 0; k < kU; ++k) {
        const int r = r0 + k, iy = iy0 + r;
        if (r >= lay.in_rows) break;
        const bool ok = col_ok && iy >= 0 && iy < a.H;
        const T* src = ok ? xb + iy * x_row + off : a.x;
        if constexpr (kF32)
          cp_async4(dst0 + r * lay.in_row, src, ok);
        else
          v[k] = ok ? to_f32(*src) : 0.f;
      }
      if constexpr (!kF32) {
#pragma unroll
        for (int k = 0; k < kU; ++k) {
          const int r = r0 + k;
          if (r >= lay.in_rows) break;
          dst0[r * lay.in_row] = v[k];
        }
      }
    }
  }
  // the weights and bias (bs follows ws), read before the staging
#pragma unroll
  for (int k = 0; k < kWU; ++k) {
    const int i = tid + k * kThreads;
    if (i < n_w + CO) ws[i] = wv[k];
  }
  for (int i = tid + kWU * kThreads; i < n_w + CO; i += kThreads)
    ws[i] = w_val(i);

  if constexpr (kF32) cp_async_wait_all();
  __syncthreads();

  // P pixels a thread: group g is row g / gpr, columns x0 .. x0 + P - 1
  const size_t n_out = static_cast<size_t>(nr) * OW * Co;
  const size_t g0 = (static_cast<size_t>(b) * a.OH + oy0) * OW * Co;
  const int shift = a.vec_out ? 0 : static_cast<int>(g0 % V);
  for (int g = tid; g < nr * lay.gpr; g += kThreads) {
    const int r = g / lay.gpr, x0 = (g - r * lay.gpr) * P;
    float acc[P][CO];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int o = 0; o < CO; ++o) acc[p][o] = bs[o];
    if constexpr (KX == 1) {
      // the pixel's values, 16 channels at a time, every load of a group
      // issued before its first FMA
      const T* px =
          xb + (static_cast<size_t>(oy0 + r) * a.W + x0) * a.xs;
      for (int c0 = 0; c0 < Ci; c0 += 16) {
        float v[16];
        if (a.vec_in) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (c0 + 4 * q >= Ci) break;
            const float4 t = ld4(px + c0 + 4 * q);
            v[4 * q] = t.x;
            v[4 * q + 1] = t.y;
            v[4 * q + 2] = t.z;
            v[4 * q + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < 16; ++c) {
            if (c0 + c >= Ci) break;
            v[c] = dnnca::ldg_f32(px + c0 + c);
          }
        }
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          if (c0 + c >= Ci) break;
          const float vc[1] = {v[c]};
          fma_tap<1, CO>(acc, vc, ws + (c0 + c) * CO);
        }
      }
    }
    for (int ky = 0; ky < (KX == 1 ? 0 : KH); ++ky) {
      const float* row = in_s + (r + ky) * lay.in_row;
      if constexpr (KX == 3) {
        // the window x0 .. x0 + P + 1 (Ci == 1), pairs where P is even
        float win[P + 2];
        if constexpr (P % 2 == 0) {
#pragma unroll
          for (int j = 0; j < P + 2; j += 2) {
            const float2 t = *reinterpret_cast<const float2*>(row + x0 + j);
            win[j] = t.x;
            win[j + 1] = t.y;
          }
        } else {
#pragma unroll
          for (int j = 0; j < P + 2; ++j) win[j] = row[x0 + j];
        }
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          float v[P];
#pragma unroll
          for (int p = 0; p < P; ++p) v[p] = win[p + kx];
          fma_tap<P, CO>(acc, v, ws + (ky * 3 + kx) * CO);
        }
      } else {
        for (int kx = 0; kx < KW; ++kx) {
          const float* px = row + (x0 + kx) * Ci;
          const float* wt = ws + (ky * KW + kx) * Ci * CO;
          for (int c = 0; c < Ci; ++c) {
            const float v[1] = {px[c]};
            fma_tap<1, CO>(acc, v, wt + c * CO);
          }
        }
      }
    }
    if (a.relu) {
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int o = 0; o < CO; ++o) acc[p][o] = fmaxf(acc[p][o], 0.f);
    }
    if (a.vec_out) {
      // Co == CO and P * CO % V == 0: the group's P * CO outputs in order
      // as gc chunks at chunk g * gs
      if constexpr (P * CO % V == 0) {
        uint4* dst = reinterpret_cast<uint4*>(out_s) +
                     static_cast<size_t>(g) * L::gs;
#pragma unroll
        for (int k = 0; k < P * CO / V; ++k) {
          float e[V];
#pragma unroll
          for (int j = 0; j < V; ++j)
            e[j] = acc[(k * V + j) / CO][(k * V + j) % CO];
          uint4 u;
          if constexpr (kF32) {
            u = make_uint4(__float_as_uint(e[0]), __float_as_uint(e[1]),
                           __float_as_uint(e[2]), __float_as_uint(e[3]));
          } else {
            unsigned h[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const __nv_bfloat162 pr =
                  __floats2bfloat162_rn(e[2 * j], e[2 * j + 1]);
              memcpy(&h[j], &pr, 4);
            }
            u = make_uint4(h[0], h[1], h[2], h[3]);
          }
          dst[k] = u;
        }
      }
    } else {
      T* dst = out_s + shift + (static_cast<size_t>(r) * OW + x0) * Co;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (x0 + p >= OW) break;
#pragma unroll
        for (int o = 0; o < CO; ++o)
          if (o < Co) put(dst + p * Co + o, acc[p][o]);
      }
    }
  }
  __syncthreads();

  // the tile's run of n_out values, 16 bytes a thread a store; in the
  // value-by-value layout the run starts ``shift`` values into its first
  // chunk, so that staged and device chunks align
  T* run = a.out + g0 - shift;
  const uint4* src4 = reinterpret_cast<const uint4*>(out_s);
  uint4* dst4 = reinterpret_cast<uint4*>(run);
  if (a.vec_out) {
    const int n4 = static_cast<int>(n_out / V);
    for (int j = tid; j < n4; j += kThreads)
      dst4[j] = src4[j + (j / L::gc) * (L::gs - L::gc)];
  } else {
    const int end = shift + static_cast<int>(n_out);
    const int n4 = (end + V - 1) / V;
    for (int j = tid; j < n4; j += kThreads) {
      const int e0 = j * V;
      if (e0 >= shift && e0 + V <= end) {
        dst4[j] = src4[j];
      } else {
        for (int e = max(e0, shift); e < min(e0 + V, end); ++e)
          run[e] = out_s[e];
      }
    }
  }
}

template <int CO, int KX, typename T>
cudaError_t launch_tile(const TileArgs<T>& a, cudaStream_t stream) {
  using L = TileLayout<CO, KX, T>;
  const L lay(a);
  const size_t smem = lay.smem_bytes(a);
  // the plan's vec_out only where a group's outputs are whole chunks
  const bool chunks = a.Co == CO && L::P * CO % L::V == 0 &&
                      lay.gpr * L::P == a.OW;
  if (smem > static_cast<size_t>(dnnca::kMaxDynamicSmemBytes) ||
      (a.vec_out && !chunks) || a.rows < 1)
    return cudaErrorInvalidValue;
  cudaError_t err =
      dnnca::allow_smem(stencil_nhwc_tile_kernel<CO, KX, T>, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid =
      static_cast<unsigned>(a.B) * ((a.OH + a.rows - 1) / a.rows);
  stencil_nhwc_tile_kernel<CO, KX, T><<<grid, kThreads, smem, stream>>>(a);
  return dnnca::launched(cudaGetLastError());
}

template <int CO, typename T>
cudaError_t tile_co(const TileArgs<T>& a, cudaStream_t s) {
  if (a.Ci == 1 && a.KW == 3) return launch_tile<CO, 3>(a, s);
  if (a.KH == 1 && a.KW == 1 && a.pt == 0 && a.pl == 0 && a.OH == a.H &&
      a.OW == a.W)
    return launch_tile<CO, 1>(a, s);
  return launch_tile<CO, 0>(a, s);
}

template <typename T>
int nhwc_entry(const T* x, const T* w, const T* bias, T* out, int B, int Ci,
               int Co, int H, int W, int xs, int KH, int KW, int pt, int pl,
               int OH, int OW, int relu, int vec_in, int tile, int rows,
               int vec_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile) {
    const TileArgs<T> a{x,  w,  bias, out, B,  Ci,   Co,     H,    W,
                        xs, KH, KW,   pt,  pl, OH,   OW,     relu, vec_in,
                        rows, vec_out};
    if (Co <= 1) return tile_co<1>(a, s);
    if (Co <= 4) return tile_co<4>(a, s);
    if (Co <= 8) return tile_co<8>(a, s);
    if (Co <= 16) return tile_co<16>(a, s);
    return tile_co<32>(a, s);
  }
#define DNNCA_DIRECT_CO(CO)                                                  \
  direct_co<CO>(x, w, bias, out, B, Ci, Co, H, W, xs, KH, KW, pt, pl, OH, OW, \
                relu, vec_in, s)
  if (Co <= 1) return DNNCA_DIRECT_CO(1);
  if (Co <= 4) return DNNCA_DIRECT_CO(4);
  if (Co <= 8) return DNNCA_DIRECT_CO(8);
  if (Co <= 16) return DNNCA_DIRECT_CO(16);
  return DNNCA_DIRECT_CO(32);
#undef DNNCA_DIRECT_CO
}

}  // namespace

// x [B, H, W, *] with its pixels xs elements apart (its Ci channels
// contiguous), out [B, OH, OW, Co] contiguous and 16-byte aligned. vec_in:
// Ci % 4 == 0, xs % 4 == 0 and x aligned to 4 elements (four-value reads).
// tile: the tile route with ``rows`` output rows a block and, where
// vec_out, a thread's outputs staged as 16-byte chunks (the plan of
// ops/kernels/stencil_conv_nhwc.py); else the direct route.
extern "C" int dnnca_stencil_conv_nhwc(const float* x, const float* w,
                                       const float* bias, float* out, int B,
                                       int Ci, int Co, int H, int W, int xs,
                                       int KH, int KW, int pt, int pl, int OH,
                                       int OW, int relu, int vec_in, int tile,
                                       int rows, int vec_out, int device,
                                       void* stream) {
  return nhwc_entry(x, w, bias, out, B, Ci, Co, H, W, xs, KH, KW, pt, pl, OH,
                    OW, relu, vec_in, tile, rows, vec_out, device, stream);
}

// The bf16 form (x, w, bias and out bf16).
extern "C" int dnnca_stencil_conv_nhwc_bf16(
    const bf16* x, const bf16* w, const bf16* bias, bf16* out, int B, int Ci,
    int Co, int H, int W, int xs, int KH, int KW, int pt, int pl, int OH,
    int OW, int relu, int vec_in, int tile, int rows, int vec_out, int device,
    void* stream) {
  return nhwc_entry(x, w, bias, out, B, Ci, Co, H, W, xs, KH, KW, pt, pl, OH,
                    OW, relu, vec_in, tile, rows, vec_out, device, stream);
}
