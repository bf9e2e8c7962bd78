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
// What bounds it on the H100: three convs' worth of FMAs a pixel (dc1, dw2,
// dw1; four with dx) against (Ci + Cm + 2 Co) * 4 bytes read, so the FMA
// rate and the issue slots, not device memory; at B=8 the training sites
// are small (a whole site's bytes move in 3-17 us), so launches and grid
// fill count as much as the arithmetic.
//
// Design: two launches.
// 1. One persistent kernel (a grid of a few blocks an SM walks the
//    tile_h x tile_w tiles) computes, per tile, everything from shared
//    memory: g and c2 over the tile with a 2p halo, c1 and x with a p halo
//    (all staged with cp.async), g2 = g * (c2 > 0), dc1 over the tile plus
//    its p halo (register-blocked runs of conv_tile.cuh with the weights flipped
//    and transposed, masked by the staged c1), dx over the tile from that
//    shared dc1, and the tile's contribution to dw2, db2 (from g2 and c1)
//    and dw1, db1 (from dc1 and x). dc1 never goes to device memory. For
//    the weight gradients each thread owns one item, (one input channel or
//    the bias) x (a group of CPT output channels), over every tap, for one
//    slice of the tile's runs, and keeps its CPT x K x K sums in registers
//    across all the block's tiles: for a fixed kernel row the window of a
//    run is loaded once and serves the K horizontal taps. At the end the
//    block sums its slices in shared memory in a fixed order and writes one
//    partial per entry of dw1 | db1 | dw2 | db2.
// 2. One finish kernel adds the partials of every entry in a fixed order
//    (a warp an entry), in f64 as the block's slice sums are, rounding
//    once: dw and db are the same bits from run to run and within about
//    half an ulp of the f64 result.
// Where the items outnumber the threads (32 channels) or K != 3, the first
// kernel writes dc1 to device memory instead and the weight gradients go
// through wgrad.cu, two launches each (five in all).
#include "conv_tile.cuh"
#include "wgrad.cuh"

namespace {

using dnnca::tile::conv_run;
using dnnca::tile::pad4;
using dnnca::tile::run_px;
using dnnca::tile::stage_weights;
using dnnca::tile::stage_window;
using dnnca::tile::store_run;

struct BwdArgs {
  const float* g;
  const float* c1;
  const float* c2;
  const float* x;
  const float* w1;
  const float* w2;
  float* dx;       // may be null
  float* dc1;      // the five-launch path only
  float* partial;  // [n_out][gridDim.x], the two-launch path only
  int B, Ci, Cm, Co, H, W, K;
  // geometry from the wrapper: the tile, the width of the dc1 tile (a
  // multiple of the run length), the row strides of the c1, dc1 and x
  // tiles and of the g2 tile (4 mod 8 floats: conflict-free float4 loads
  // on consecutive rows), and the pixel slices of each weight-gradient item
  int tile_h, tile_w, c1_w, c1_s, gs_w, slices;
};

// N aligned float4s from shared memory into registers.
template <int N>
__device__ __forceinline__ void load_row(float (&dst)[N * 4],
                                         const float* src) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const float4 v = s4[q];
    dst[4 * q] = v.x;
    dst[4 * q + 1] = v.y;
    dst[4 * q + 2] = v.z;
    dst[4 * q + 3] = v.w;
  }
}

// One unit of a weight-gradient item: for the run of PX pixels at column
// ``col`` of the tile and rows r0 .. r1 - 1,
//   wacc[o][ky][kx] += sum_j A[o][r][col + j] * X[r + ky][col + j + kx]
// summed in fresh registers and added to wacc at the end, so that no sum
// runs long in one register (f32 rounding grows with its length); for the
// bias, bacc[o] += sum_j A[o][r][col + j] in f64: a bias gradient sums a
// whole plane of cancelling terms, and the few entries of db show every
// bit of that rounding (PERF.md). A's values sit SH
// columns right of ``col`` in its buffer (the halo of g2 or dc1): its rows
// are read as aligned float4s and shifted in registers. Walking down the
// rows, the KT - 1 window rows of X that the next row shares stay in
// registers, so each row loads one new window row.
template <int CPT, int KT, int SH>
__device__ __forceinline__ void wgrad_strip(float (&wacc)[CPT * KT * KT],
                                            double (&bacc)[CPT],
                                            const float* A, int a_plane,
                                            int a_row, const float* X,
                                            int x_row, int col, int r0,
                                            int r1, int n_a, bool bias) {
  constexpr int PX = run_px(CPT), KKT = KT * KT;
  constexpr int NA = (PX + SH + 3) / 4, NW = (PX + KT - 1 + 3) / 4;
  float xw[KT][NW * 4], part[CPT * KKT];
#pragma unroll
  for (int e = 0; e < CPT * KKT; ++e) part[e] = 0.f;
  if (!bias) {
#pragma unroll
    for (int ky = 0; ky < KT - 1; ++ky)
      load_row<NW>(xw[ky], X + (r0 + ky) * x_row + col);
  }
  for (int r = r0; r < r1; ++r) {
    if (!bias) load_row<NW>(xw[KT - 1], X + (r + KT - 1) * x_row + col);
#pragma unroll
    for (int o = 0; o < CPT; ++o) {
      if (o >= n_a) break;
      float av[NA * 4];
      load_row<NA>(av, A + o * a_plane + r * a_row + col);
      if (bias) {  // the row's PX values summed pairwise, then added
        float t[PX];
#pragma unroll
        for (int j = 0; j < PX; ++j) t[j] = av[j + SH];
#pragma unroll
        for (int w = PX / 2; w > 0; w /= 2)
#pragma unroll
          for (int j = 0; j < w; ++j) t[j] += t[j + w];
        bacc[o] += t[0];
      } else {
#pragma unroll
        for (int ky = 0; ky < KT; ++ky)
#pragma unroll
          for (int kx = 0; kx < KT; ++kx)
#pragma unroll
            for (int j = 0; j < PX; ++j)
              part[o * KKT + ky * KT + kx] = fmaf(
                  av[j + SH], xw[ky][j + kx], part[o * KKT + ky * KT + kx]);
      }
    }
#pragma unroll
    for (int ky = 0; ky < KT - 1; ++ky)
#pragma unroll
      for (int e = 0; e < NW * 4; ++e) xw[ky][e] = xw[ky + 1][e];
  }
#pragma unroll
  for (int e = 0; e < CPT * KKT; ++e) wacc[e] += part[e];
}

template <int CPT, int KT, bool WGRAD>
__global__ void __launch_bounds__(256, 2) chain_bwd_kernel(BwdArgs a) {
  constexpr int PX = run_px(CPT), CP = pad4(CPT);
  constexpr int KKT = KT > 0 ? KT * KT : 1;  // taps of the dw sums
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int K = KT > 0 ? KT : a.K;
  const int p = K / 2, KK = K * K;
  const int Ci = a.Ci, Cm = a.Cm, Co = a.Co, H = a.H, W = a.W;
  const bool need_dx = a.dx != nullptr;
  const int th = a.tile_h, tw = a.tile_w, c1_w = a.c1_w, gs_w = a.gs_w;
  const int c1_s = a.c1_s;
  const int gm = (Cm + CPT - 1) / CPT, gx = (Ci + CPT - 1) / CPT;
  const int gm_row = gm * CP, gx_row = gx * CP;
  const int c1_h = th + 2 * p, gs_h = th + 4 * p;
  const int c1_plane = c1_h * c1_s, gs_plane = gs_h * gs_w;
  float* w2f = smem;                                // [Co][KK][gm_row]
  float* w1f = w2f + Co * KK * gm_row;              // [Cm][KK][gx_row]
  float* gs = w1f + (need_dx ? Cm * KK * gx_row : 0);  // [Co][gs_h][gs_w]
  float* c2s = gs + Co * gs_plane;                  // [Co][gs_h][gs_w]
  float* c1s = c2s + Co * gs_plane;                 // [Cm][c1_h][c1_s]
  float* ds = c1s + Cm * c1_plane;                  // [Cm][c1_h][c1_s]
  float* xs = ds + Cm * c1_plane;                   // [Ci][c1_h][c1_s]
  float* red = gs;  // [threads][CPT * KK], after the last tile

  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, nw = nt >> 5;
  const size_t plane = static_cast<size_t>(H) * W;
  const int tiles_x = (W + tw - 1) / tw, tiles_y = (H + th - 1) / th;
  const int n_tiles = a.B * tiles_y * tiles_x;

  stage_weights<true>(w2f, a.w2, Cm, Co, KK, CPT, gm);
  if (need_dx) stage_weights<true>(w1f, a.w1, Ci, Cm, KK, CPT, gx);

  // this thread's weight-gradient item: (input channel or the bias, group)
  // of dw2 (input c1, groups over Co) or of dw1 (input x, groups over Cm)
  const int items2 = (Cm + 1) * ((Co + CPT - 1) / CPT);
  const int items1 = (Ci + 1) * gm;
  const int S = a.slices;
  int role = 0, item = 0, slice = 0;  // role 2: dw2, 1: dw1, 0: none
  if (WGRAD) {
    if (tid < items2 * S) {
      role = 2, item = tid % items2, slice = tid / items2;
    } else if (tid - items2 * S < items1 * S) {
      role = 1, item = (tid - items2 * S) % items1;
      slice = (tid - items2 * S) / items1;
    }
  }
  const int n_in = role == 2 ? Cm : Ci;
  const int wg = item / (n_in + 1), wc = item % (n_in + 1);  // group, input
  const int wc_out = role == 2 ? Co : Cm;  // channels the groups split
  const int n_a = min(CPT, wc_out - wg * CPT);
  float wacc[WGRAD ? CPT * KKT : 1];
  double bacc[CPT];  // the bias item's sums (wgrad_strip)
#pragma unroll
  for (int e = 0; e < (WGRAD ? CPT * KKT : 1); ++e) wacc[e] = 0.f;
#pragma unroll
  for (int o = 0; o < CPT; ++o) bacc[o] = 0.0;

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int b = t / (tiles_y * tiles_x);
    const int y0 = t / tiles_x % tiles_y * th, x0 = t % tiles_x * tw;
    __syncthreads();  // every thread is done with the previous tile
    stage_window(c1s, a.c1 + static_cast<size_t>(b) * Cm * plane, Cm, c1_h,
                 c1_w, c1_s, y0 - p, x0 - p, H, W);
    if (WGRAD)
      stage_window(xs, a.x + static_cast<size_t>(b) * Ci * plane, Ci, c1_h,
                   tw + 2 * p, c1_s, y0 - p, x0 - p, H, W);
    // g and c2 over the tile with its 2p halo, zero outside the image
    stage_window(gs, a.g + static_cast<size_t>(b) * Co * plane, Co, gs_h,
                 c1_w + 2 * p, gs_w, y0 - 2 * p, x0 - 2 * p, H, W);
    stage_window(c2s, a.c2 + static_cast<size_t>(b) * Co * plane, Co, gs_h,
                 c1_w + 2 * p, gs_w, y0 - 2 * p, x0 - 2 * p, H, W);
    dnnca::tile::cp_async_wait_all();
    __syncthreads();
    // g2 = g * (c2 > 0), in place
    for (int i = tid; i < Co * gs_plane / 4; i += nt) {
      const float4 v = reinterpret_cast<const float4*>(gs)[i];
      const float4 m = reinterpret_cast<const float4*>(c2s)[i];
      reinterpret_cast<float4*>(gs)[i] =
          make_float4(m.x > 0.f ? v.x : 0.f, m.y > 0.f ? v.y : 0.f,
                      m.z > 0.f ? v.z : 0.f, m.w > 0.f ? v.w : 0.f);
    }
    __syncthreads();

    // dc1 over the tile plus its p halo, masked by c1 (zero outside the
    // image, where c1 was staged as zero)
    const int per_g1 = c1_h * (c1_w / PX);   // rows fastest across lanes
    for (int it = tid; it < gm * per_g1; it += nt) {
      const int g = it / per_g1, rem = it - g * per_g1;
      const int run = rem / c1_h, r = rem - run * c1_h, col = run * PX;
      float acc[PX][CPT];
#pragma unroll
      for (int j = 0; j < PX; ++j)
#pragma unroll
        for (int o = 0; o < CPT; ++o) acc[j][o] = 0.f;
      conv_run<CPT, KT>(acc, gs + r * gs_w + col, gs_plane, gs_w,
                        w2f + g * CP, gm_row, Co, K);
#pragma unroll
      for (int o = 0; o < CPT; ++o) {
        if (g * CPT + o >= Cm) break;
        const int off = (g * CPT + o) * c1_plane + r * c1_s + col;
#pragma unroll
        for (int q = 0; q < PX / 4; ++q) {
          const float4 m = reinterpret_cast<const float4*>(c1s + off)[q];
          reinterpret_cast<float4*>(ds + off)[q] = make_float4(
              m.x > 0.f ? acc[4 * q][o] : 0.f,
              m.y > 0.f ? acc[4 * q + 1][o] : 0.f,
              m.z > 0.f ? acc[4 * q + 2][o] : 0.f,
              m.w > 0.f ? acc[4 * q + 3][o] : 0.f);
        }
      }
    }
    __syncthreads();

    if (!WGRAD) {  // the tile's dc1 for wgrad.cu, one warp a row
      float* db = a.dc1 + static_cast<size_t>(b) * Cm * plane;
      for (int pr = tid >> 5; pr < Cm * th; pr += nw) {
        const int m = pr / th, r = pr - m * th, gy = y0 + r;
        if (gy >= H) continue;
        for (int c = lane; c < tw && x0 + c < W; c += 32)
          db[m * plane + static_cast<size_t>(gy) * W + x0 + c] =
              ds[m * c1_plane + (r + p) * c1_s + c + p];
      }
    }

    if (need_dx) {  // dx over the tile from the shared dc1
      const int per_g2 = th * (tw / PX);
      float* dxb = a.dx + static_cast<size_t>(b) * Ci * plane;
      for (int it = tid; it < gx * per_g2; it += nt) {
        const int g = it / per_g2, rem = it - g * per_g2;
        const int run = rem / th, r = rem - run * th, col = run * PX;
        const int gy = y0 + r, gxx = x0 + col;
        if (gy >= H || gxx >= W) continue;
        float acc[PX][CPT];
#pragma unroll
        for (int j = 0; j < PX; ++j)
#pragma unroll
          for (int o = 0; o < CPT; ++o) acc[j][o] = 0.f;
        conv_run<CPT, KT>(acc, ds + r * c1_s + col, c1_plane, c1_s,
                          w1f + g * CP, gx_row, Cm, K);
#pragma unroll
        for (int o = 0; o < CPT; ++o) {
          if (g * CPT + o >= Ci) break;
          float v[PX];
#pragma unroll
          for (int j = 0; j < PX; ++j) v[j] = acc[j][o];
          store_run<PX>(dxb + (g * CPT + o) * plane +
                            static_cast<size_t>(gy) * W + gxx,
                        v, W - gxx);
        }
      }
    }

    if constexpr (WGRAD) if (role != 0) {
      // A: the output-side gradient over the tile (g2 or dc1, zero outside
      // the image), from its row at the tile's first row; X: the input
      // window (c1 or x with its p halo)
      const float* A = role == 2 ? gs + wg * CPT * gs_plane + 2 * p * gs_w
                                 : ds + wg * CPT * c1_plane + p * c1_s;
      const float* X = (role == 2 ? c1s : xs) + wc * c1_plane;
      const bool bias = wc == n_in;
      // a unit is a column of runs over a segment of the tile's rows
      const int runs = tw / PX;
      const int nseg = min(th, (S + runs - 1) / runs);
      const int seg_rows = (th + nseg - 1) / nseg;
      for (int u = slice; u < runs * nseg; u += S) {
        const int col = u % runs * PX, r0 = u / runs * seg_rows;
        const int r1 = min(min(th, r0 + seg_rows), H - y0);
        if (x0 + col >= W || r0 >= r1) continue;
        if (role == 2)
          wgrad_strip<CPT, KT, 2 * (KT / 2)>(wacc, bacc, A, gs_plane, gs_w,
                                             X, c1_s, col, r0, r1, n_a, bias);
        else
          wgrad_strip<CPT, KT, KT / 2>(wacc, bacc, A, c1_plane, c1_s, X,
                                       c1_s, col, r0, r1, n_a, bias);
      }
    }
  }

  if constexpr (!WGRAD) return;
  // the block's partial of every entry: its slices summed in a fixed order,
  // in f64 and rounded once. A bias item's f64 sums go in as two floats, the
  // rounded sum at tap 0 and what the rounding dropped at tap 1 (a bias has
  // no other taps).
  constexpr int NE = WGRAD ? CPT * KKT : 1;
  __syncthreads();  // the tile buffers become the reduction buffer
  if (role != 0) {
#pragma unroll
    for (int e = 0; e < NE; ++e) red[tid * NE + e] = wacc[e];
    if (wc == n_in) {
#pragma unroll
      for (int o = 0; o < CPT; ++o) {
        const float hi = static_cast<float>(bacc[o]);
        red[tid * NE + o * KKT] = hi;
        red[tid * NE + o * KKT + 1] = static_cast<float>(bacc[o] - hi);
      }
    }
  }
  __syncthreads();
  const int n1 = Cm * Ci * KK, n2 = Co * Cm * KK;
  const int n_slots = (items2 + items1) * NE;
  for (int i = tid; i < n_slots; i += nt) {
    const int it = i / NE, e = i - it * NE;
    const bool is2 = it < items2;
    const int item_ = is2 ? it : it - items2;
    const int base = is2 ? 0 : items2 * S;
    const int items = is2 ? items2 : items1;
    const int nin = is2 ? Cm : Ci, cout = is2 ? Co : Cm;
    const int g = item_ / (nin + 1), c = item_ % (nin + 1);
    const int o = g * CPT + e / KKT, tap = e % KKT;
    if (o >= cout || (c == nin && tap != 0)) continue;
    double s = 0.0;
    for (int sl = 0; sl < S; ++sl) {
      const float* r = red + (base + sl * items + item_) * NE + e;
      s += r[0];
      if (c == nin) s += r[1];
    }
    int entry;
    if (is2)
      entry = c == nin ? n1 + Cm + n2 + o : n1 + Cm + (o * Cm + c) * KK + tap;
    else
      entry = c == nin ? n1 + o : (o * Ci + c) * KK + tap;
    a.partial[static_cast<size_t>(entry) * gridDim.x + blockIdx.x] =
        static_cast<float>(s);
  }
}

// out[e] = sum over i < blocks of partial[e * blocks + i], a warp an entry,
// summed in a fixed order in f64 and rounded once: the last additions of
// an f32 sum round at the total's magnitude, a bias gradient of ~1e3 then
// lands an ulp or more from the f64 result, where a plain f32 sum that
// happens to round well lands within a fraction of one.
__global__ void __launch_bounds__(256)
chain_bwd_finish_kernel(const float* __restrict__ partial,
                        float* __restrict__ out, int n, int blocks) {
  const int e = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (e >= n) return;
  const float* row = partial + static_cast<size_t>(e) * blocks;
  double s = 0.0;
  for (int i = lane; i < blocks; i += 32) s += row[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(~0u, s, off);
  if (lane == 0) out[e] = static_cast<float>(s);
}

template <int CPT, int KT, bool WGRAD>
cudaError_t launch(const BwdArgs& a, int blocks, int threads, int smem_bytes,
                   cudaStream_t stream) {
  cudaError_t err =
      dnnca::allow_smem(chain_bwd_kernel<CPT, KT, WGRAD>, smem_bytes);
  if (err != cudaSuccess) return err;
  chain_bwd_kernel<CPT, KT, WGRAD><<<blocks, threads, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch(const BwdArgs& a, int cpt, bool fused, int blocks,
                     int threads, int smem, cudaStream_t s) {
  if (fused && a.K == 3) {
    switch (cpt) {
      case 3: return launch<3, 3, true>(a, blocks, threads, smem, s);
      case 4: return launch<4, 3, true>(a, blocks, threads, smem, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (fused) return cudaErrorInvalidValue;
#define DNNCA_CHAIN_DGRAD(C)                                        \
  (a.K == 3 ? launch<C, 3, false>(a, blocks, threads, smem, s)     \
            : launch<C, 0, false>(a, blocks, threads, smem, s))
  switch (cpt) {
    case 3: return DNNCA_CHAIN_DGRAD(3);
    case 4: return DNNCA_CHAIN_DGRAD(4);
    case 6: return DNNCA_CHAIN_DGRAD(6);
    case 8: return DNNCA_CHAIN_DGRAD(8);
    default: return cudaErrorInvalidValue;
  }
#undef DNNCA_CHAIN_DGRAD
}

}  // namespace

// dx may be null (no data gradient). out is the result, [dw1 | db1 | dw2 |
// db2] (n_out floats); scratch is the wrapper's other buffer
// (ops/kernels/conv_chain_bwd.py: geometry):
//   fused: the partials, [n_out][blocks];
//   else:  wgrad.cu's partials, [max(n1 + Cm, n2 + Co)][wgrad_blocks], and
//          dc1, [B, Cm, H, W].
extern "C" int dnnca_conv_chain_bwd(
    const float* x, const float* c1, const float* c2, const float* g,
    const float* w1, const float* w2, float* dx, float* out, float* scratch,
    int B, int Ci, int Cm, int Co, int H, int W, int K, int cpt, int tile_h,
    int tile_w, int c1_w, int c1_s, int gs_w, int slices, int threads,
    int blocks, int fused, int smem_bytes, int wgrad_blocks, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int KK = K * K, n1 = Cm * Ci * KK, n2 = Co * Cm * KK;
  const int n_out = n1 + Cm + n2 + Co;
  float* partial = scratch;
  const int wg_rows = n1 + Cm > n2 + Co ? n1 + Cm : n2 + Co;
  float* dc1 = fused ? nullptr
                     : partial + static_cast<size_t>(wg_rows) * wgrad_blocks;
  const BwdArgs a{g,  c1, c2, x, w1, w2, dx,     dc1,    partial, B,     Ci,
                  Cm, Co, H,  W, K,  tile_h, tile_w, c1_w, c1_s, gs_w, slices};
  err = dispatch(a, cpt, fused != 0, blocks, threads, smem_bytes, s);
  if (err != cudaSuccess) return err;
  if (fused) {
    chain_bwd_finish_kernel<<<(n_out + 7) / 8, 256, 0, s>>>(partial, out,
                                                             n_out, blocks);
    return cudaGetLastError();
  }
  const int p = K / 2;
  const dnnca::WgradArgs w2g{g, c2, c1, partial, out + n1 + Cm, B, Co, Cm, H,
                             W, H,  W,  K, K,       p,  p, wgrad_blocks};
  err = dnnca::launch_wgrad(w2g, s);
  if (err != cudaSuccess) return err;
  const dnnca::WgradArgs w1g{dc1, nullptr, x, partial, out, B, Cm, Ci, H, W,
                             H,   W,       K, K,       p,   p, wgrad_blocks};
  return dnnca::launch_wgrad(w1g, s);
}
