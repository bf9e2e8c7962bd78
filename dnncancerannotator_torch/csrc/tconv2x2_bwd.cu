// Backward of ConvTranspose(kernel 2, stride 2) plus bias (tconv2x2.cu):
//   dx[b, ci, y, x]    = sum_{co, dy, dx} g[b, co, 2y+dy, 2x+dx] * w[ci, co, dy, dx]
//   dw[ci, co, dy, dx] = sum_{b, y, x} x[b, ci, y, x] * g[b, co, 2y+dy, 2x+dx]
//   db[co]             = sum_{b, Y, X} g[b, co, Y, X]
// w in PyTorch's ConvTranspose2d layout [Ci, Co, 2, 2], unflipped, as the
// forward applies it (convert.py does the flax flip once).
//
// Replaces flattconv's backward kernel (_bwd_call,
// dnncancerannotator_tpu/ops/pallas/flattconv.py:156), which de-interleaves
// the phases with permutation-matrix dots on the MXU. Here a phase is only
// an index. NCHW f32, Ci, Co <= 64.
//
// What bounds it on the H100: device-memory bytes in principle (x and g
// read, dx written; 4 * Co * Ci FMAs a pixel for each of dx and dw), but at
// the unet.yaml decoder sites (B=8) a whole call moves 2.4-12.6 MB, 0.7-3.8
// us at 3.35 TB/s: the launch, the latency of one round of loads, the
// issue of the weight-gradient sums and their reduction across blocks
// decide its time.
//
// Design: one launch a call, blocks of 512 threads, about one an SM at the
// sites. A block owns one tile of tile_h x tile_w input pixels of one image
// (the wrapper's plan, ops/kernels/tconv2x2_bwd.py) and stages, with
// cp.async (16-byte copies where rows allow; one contiguous chunk a plane
// for whole rows), its x tile [Ci][tile_h][tile_w], the matching 2x tile of
// g [Co][2 tile_h][2 tile_w] and the weight. g is read from device memory
// once. From the staged tiles, at the same time:
// - the last 256 threads compute dx of the tile's pixels: a
//   work item is one pixel and a group of CPT input channels (CPT divides
//   Ci: the exact widths, no padding), the four taps of one (ci, co) one
//   float4 broadcast from shared memory;
// - the first 256 threads compute the block's partial dw and db: a
//   thread owns an item (a group of CPT input channels, one co; its
//   4 * CPT dw sums and, for the first group, the db sum) over one share
//   of the tile's pixels. dw is summed in f32 over runs of 16 pixels and
//   the runs in f64, db in f64 a pixel (an f32 product is exact in f64: the
//   long sums round once, at the end); the shares are added in order in
//   shared memory. No warp shuffles: an SM of compute capability 9.0 gives
//   32 shuffle results and 16 f32-to-f64 conversions a clock (the CUDA
//   guide's throughput table), and a shuffle tree of f64 sums over 32 lanes
//   was the slowest step of a first version.
// Then the blocks of a thread-block cluster (2 or 4, the plan's) add their
// partials in rank order through distributed shared memory, each block one
// slice of the entries, and write the cluster's partial. The cluster takes
// a ticket (an atomic add after __threadfence); the last cluster to arrive
// adds every cluster's partial in order in f64 (chunks of 16 clusters, four
// dw entries a float4 load, every load of a chunk in flight at once, then
// the chunks in order), writes dw and db rounded once, and sets the ticket
// counter back to 0 for the next call. dw and db are the same bits from
// call to call, with no second launch.
#include <cstdint>

#include <cooperative_groups.h>

#include "conv_tile.cuh"

namespace {

using dnnca::tile::cp_async4;
using dnnca::tile::cp_async16;
using dnnca::tile::cp_async_wait_all;

constexpr int kThreads = 512;
// cluster partials one unit of the finish adds (all loads in flight), and
// the units of one batch of the finish (32 bytes each in shared memory)
constexpr int kChunk = 16;
constexpr int kFinUnits = 1024;
// pixels a thread sums in f32 before adding the run in f64, and the
// threads on the weight gradient while the others compute dx (256 of 512
// measured faster than 128 at every unet.yaml site)
constexpr int kRun = 16;
constexpr int kDwThreads = 256;

struct Args {
  const float* x;
  const float* g;
  const float* w;
  float* dx;          // may be null (no data gradient)
  float* dwb;         // [Ci * Co * 4 + Co]: dw in [Ci, Co, 2, 2] order, db
  float* w_partial;   // [clusters][Ci * Co * 4]
  double* b_partial;  // [clusters][Co]
  unsigned* ticket;   // 0 between calls
  int B, Ci, Co, H, W, tile_h, tile_w;
};

__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }

// Copy rows [r0, r0 + rows) x columns [c0, c0 + cols) of n planes of an
// [n][SH][SW] image into dst [n][rows][cols] with cp.async, zero outside
// the image. A warp a row; 16-byte copies where the row, the window and the
// source allow them (each 4-float chunk then lies wholly inside or outside
// the image), else 4-byte copies.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int n, int rows, int cols, int SH,
                                           int SW, int r0, int c0) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const bool vec = ((SW | c0 | cols) & 3) == 0 &&
                   (reinterpret_cast<std::uintptr_t>(src) & 15) == 0;
  for (int pr = threadIdx.x >> 5; pr < n * rows; pr += nw) {
    const int c = pr / rows, y = r0 + pr - c * rows;
    const bool row_ok = y < SH;
    const float* srow =
        src + (static_cast<size_t>(c) * SH + (row_ok ? y : 0)) * SW;
    float* drow = dst + static_cast<size_t>(pr) * cols;
    if (vec) {
      for (int col = 4 * lane; col < cols; col += 128) {
        const bool ok = row_ok && c0 + col < SW;
        cp_async16(drow + col, ok ? srow + c0 + col : src, ok);
      }
    } else {
      for (int col = lane; col < cols; col += 32) {
        const bool ok = row_ok && c0 + col < SW;
        cp_async4(drow + col, ok ? srow + c0 + col : src, ok);
      }
    }
  }
}

// Copy n planes' chunks of `chunk` floats, src + c * plane + off .. (the
// tile's whole rows), into dst [n][chunk] with 16-byte cp.async; past
// `valid` floats (rows below the image) zero. chunk, valid, plane and off
// are multiples of 4 and src is 16-byte aligned.
__device__ __forceinline__ void stage_planes(float* dst, const float* src,
                                             int n, int chunk, size_t plane,
                                             size_t off, int valid) {
  const int c4 = chunk / 4;
  for (int i = threadIdx.x; i < n * c4; i += blockDim.x) {
    const int c = i / c4, j = 4 * (i - c * c4);
    const bool ok = j < valid;
    cp_async16(dst + c * chunk + j, ok ? src + c * plane + off + j : src, ok);
  }
}

template <int CPT>
__global__ void __launch_bounds__(kThreads) tconv_bwd_kernel(Args a) {
  constexpr int NE = 4 * CPT + 1;  // a work item's sums: dw, then db
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Ci = a.Ci, Co = a.Co, H = a.H, W = a.W;
  const int th = a.tile_h, tw = a.tile_w, P = th * tw;
  const bool need_dx = a.dx != nullptr;
  const int n_w = 4 * Ci * Co;
  float* ws = smem;                                      // [Ci][Co] float4
  float* xs = ws + (need_dx ? 4 * Ci * Co : 0);          // [Ci][th][tw]
  float* gs = xs + pad4(Ci * P);                         // [Co][2th][2tw]
  // after the tiles: the shares of the items [kDwThreads][NE] in f64,
  // then the block's partial, dw [n_w] in f32 and db [Co] in f64, which
  // the blocks of its cluster read
  double* wred = reinterpret_cast<double*>(gs + 4 * Co * P);
  float* wpart = reinterpret_cast<float*>(wred + kDwThreads * NE);
  double* bpart = reinterpret_cast<double*>(wpart + pad4(n_w));
  const int tid = threadIdx.x;
  const int tiles_x = (W + tw - 1) / tw, tiles_y = (H + th - 1) / th;
  const int t = blockIdx.x;
  // the grid is padded to whole clusters: a block past the tiles adds 0
  const bool has_tile = t < a.B * tiles_y * tiles_x;
  const int b = t / (tiles_y * tiles_x);
  const int y0 = t / tiles_x % tiles_y * th, x0 = t % tiles_x * tw;
  const size_t plane = static_cast<size_t>(H) * W;
  const int groups = Ci / CPT, items = groups * Co;
  // a weight-gradient unit is one item (j = group cg, output o), or one of
  // the `parts` shares of an item's pixels that give every one of the
  // kDwThreads threads a unit
  const int parts = items < kDwThreads ? kDwThreads / items : 1;
  const int units = items * parts;

  if (has_tile) {
    if (need_dx)
      for (int i = tid; i < Ci * Co; i += kThreads)
        cp_async16(ws + 4 * i, a.w + 4 * i, true);
    const float* xb = a.x + static_cast<size_t>(b) * Ci * plane;
    const float* gb = a.g + static_cast<size_t>(b) * Co * 4 * plane;
    if (tw == W && (W & 3) == 0 &&
        ((reinterpret_cast<std::uintptr_t>(xb) |
          reinterpret_cast<std::uintptr_t>(gb)) & 15) == 0) {
      // whole rows: each plane's tile is one contiguous chunk
      const int rows = min(th, H - y0);
      stage_planes(xs, xb, Ci, P, plane, static_cast<size_t>(y0) * W,
                   rows * W);
      stage_planes(gs, gb, Co, 4 * P, 4 * plane,
                   static_cast<size_t>(4 * y0) * W, 4 * rows * W);
    } else {
      stage_rows(xs, xb, Ci, th, tw, H, W, y0, x0);
      stage_rows(gs, gb, Co, 2 * th, 2 * tw, 2 * H, 2 * W, 2 * y0, 2 * x0);
    }
    cp_async_wait_all();
    __syncthreads();

    // g of tile pixel p = (ty, tx) in plane o: the float2s at rows 2ty and
    // 2ty + 1, column 2tx, of [2th][2tw]. The first kDwThreads threads
    // take the weight gradient, the others dx, at once.
    if (tid >= kDwThreads && need_dx) {
      const float4* w4 = reinterpret_cast<const float4*>(ws);
      for (int it = tid - kDwThreads; it < groups * P;
           it += kThreads - kDwThreads) {
        const int cg = it / P, p = it - cg * P;
        const int ty = p / tw, tx = p - ty * tw;
        const int y = y0 + ty, xx = x0 + tx;
        if (y >= H || xx >= W) continue;
        const float* gp = gs + 4 * ty * tw + 2 * tx;
        const float4* wq = w4 + cg * CPT * Co;
        float acc[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[c] = 0.f;
        for (int o = 0; o < Co; ++o) {
          const float2 top = *reinterpret_cast<const float2*>(gp + o * 4 * P);
          const float2 bot =
              *reinterpret_cast<const float2*>(gp + o * 4 * P + 2 * tw);
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const float4 wv = wq[c * Co + o];  // (dy, dx) = 00, 01, 10, 11
            acc[c] = fmaf(top.x, wv.x, acc[c]);
            acc[c] = fmaf(top.y, wv.y, acc[c]);
            acc[c] = fmaf(bot.x, wv.z, acc[c]);
            acc[c] = fmaf(bot.y, wv.w, acc[c]);
          }
        }
        float* dst = a.dx + (static_cast<size_t>(b) * Ci + cg * CPT) * plane +
                     static_cast<size_t>(y) * W + xx;
#pragma unroll
        for (int c = 0; c < CPT; ++c) dst[c * plane] = acc[c];
      }
    }

    // dw, db: a thread owns one unit and takes every parts-th pixel of the
    // tile from its share; dw summed in f32 over runs of kRun pixels, each
    // run's sum added in f64 (a run of kRun products rounds little; every
    // longer sum is f64), db (the first group only) in f64 a pixel: a sum
    // of a plane of cancelling terms, whose rounding the few db entries
    // show (PERF.md). No shuffles: a double shuffle and an f32-to-f64
    // conversion each issue at one warp in two clocks an SM.
    if (tid < kDwThreads) {
      for (int u = tid; u < units; u += kDwThreads) {
        const int j = u / parts, q = u - j * parts;
        const int cg = j / Co, o = j - cg * Co;
        const float* xg = xs + cg * CPT * P;
        const float* gp = gs + o * 4 * P;
        double acc[NE];
#pragma unroll
        for (int e = 0; e < NE; ++e) acc[e] = 0.0;
        int p = q;
        while (p < P) {
          float run[4 * CPT];
#pragma unroll
          for (int e = 0; e < 4 * CPT; ++e) run[e] = 0.f;
          for (int k = 0; k < kRun && p < P; ++k, p += parts) {
            const int ty = p / tw, tx = p - ty * tw;
            const float2 top =
                *reinterpret_cast<const float2*>(gp + 4 * ty * tw + 2 * tx);
            const float2 bot = *reinterpret_cast<const float2*>(
                gp + (4 * ty + 2) * tw + 2 * tx);
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              const float xv = xg[c * P + p];
              run[4 * c] = fmaf(xv, top.x, run[4 * c]);
              run[4 * c + 1] = fmaf(xv, top.y, run[4 * c + 1]);
              run[4 * c + 2] = fmaf(xv, bot.x, run[4 * c + 2]);
              run[4 * c + 3] = fmaf(xv, bot.y, run[4 * c + 3]);
            }
            if (cg == 0)
              acc[4 * CPT] += (static_cast<double>(top.x) + top.y) +
                              (static_cast<double>(bot.x) + bot.y);
          }
#pragma unroll
          for (int e = 0; e < 4 * CPT; ++e) acc[e] += run[e];
        }
        if (parts > 1) {
#pragma unroll
          for (int e = 0; e < NE; ++e) wred[u * NE + e] = acc[e];
          continue;
        }
#pragma unroll
        for (int c = 0; c < CPT; ++c)
#pragma unroll
          for (int ph = 0; ph < 4; ++ph)
            wpart[((cg * CPT + c) * Co + o) * 4 + ph] =
                static_cast<float>(acc[4 * c + ph]);
        if (cg == 0) bpart[o] = acc[4 * CPT];
      }
    }
    if (parts > 1) {  // the shares of each item, added in order
      __syncthreads();
      for (int i = tid; i < items * NE; i += kThreads) {
        const int j = i / NE, e = i - j * NE;
        const int cg = j / Co, o = j - cg * Co;
        if (e == 4 * CPT && cg != 0) continue;
        double sum = 0.0;
        for (int q = 0; q < parts; ++q) sum += wred[(j * parts + q) * NE + e];
        if (e == 4 * CPT)
          bpart[o] = sum;
        else
          wpart[((cg * CPT + e / 4) * Co + o) * 4 + e % 4] =
              static_cast<float>(sum);
      }
    }
  } else {
    for (int i = tid; i < n_w; i += kThreads) wpart[i] = 0.f;
    for (int o = tid; o < Co; o += kThreads) bpart[o] = 0.0;
  }

  // the cluster's partial: block r of the cluster adds slice r of the
  // entries over the cluster's blocks in rank order, from their shared
  // memory, and writes it; the second sync keeps every block's shared
  // memory alive until the others have read it
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nc = static_cast<int>(cluster.num_blocks());
  const int cid = blockIdx.x / nc;
  cluster.sync();
  {
    const int n_out = n_w + Co, per = (n_out + nc - 1) / nc;
    const int lo = rank * per, hi = min(n_out, lo + per);
    for (int e = lo + tid; e < hi; e += kThreads) {
      double sum = 0.0;
      for (int r = 0; r < nc; ++r) {
        const float* rw = cluster.map_shared_rank(wpart, r);
        const double* rb = cluster.map_shared_rank(bpart, r);
        sum += e < n_w ? static_cast<double>(rw[e]) : rb[e - n_w];
      }
      if (e < n_w)
        a.w_partial[static_cast<size_t>(cid) * n_w + e] =
            static_cast<float>(sum);
      else
        a.b_partial[static_cast<size_t>(cid) * Co + e - n_w] = sum;
    }
  }
  __threadfence();
  cluster.sync();
  if (rank != 0) return;

  // the last cluster to arrive adds the clusters' partials
  __shared__ bool last;
  if (tid == 0)
    last = atomicAdd(a.ticket, 1u) == gridDim.x / nc - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // a unit is 4 dw entries (one float4 of a partial row) or one db entry,
  // over one chunk of kChunk clusters; every unit's loads are in flight at
  // once and its sum runs in cluster order in f64; then each entry adds its
  // chunks' sums in order. Rows of units go in batches of at most
  // kFinUnits units, their sums in shared memory.
  const int G = gridDim.x / nc, quads = n_w / 4, rows = quads + Co;
  const int K = (G + kChunk - 1) / kChunk;
  const int batch = kFinUnits / K;  // rows a batch (G <= kChunk * kFinUnits)
  const float4* wp4 = reinterpret_cast<const float4*>(a.w_partial);
  double* fin = reinterpret_cast<double*>(smem4);  // [batch * K][4]
  for (int r0 = 0; r0 < rows; r0 += batch) {
    const int nr = min(batch, rows - r0);
    for (int u = tid; u < nr * K; u += kThreads) {
      const int r = r0 + u / K, k = u % K, i0 = k * kChunk;
      double s4[4] = {0.0, 0.0, 0.0, 0.0};
      if (r < quads) {
        float4 v[kChunk];
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
          v[i] = i0 + i < G
                     ? __ldcg(wp4 + static_cast<size_t>(i0 + i) * quads + r)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          s4[0] += v[i].x;
          s4[1] += v[i].y;
          s4[2] += v[i].z;
          s4[3] += v[i].w;
        }
      } else {
        double v[kChunk];
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
          v[i] = i0 + i < G
                     ? __ldcg(a.b_partial + static_cast<size_t>(i0 + i) * Co +
                              (r - quads))
                     : 0.0;
#pragma unroll
        for (int i = 0; i < kChunk; ++i) s4[0] += v[i];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) fin[u * 4 + e] = s4[e];
    }
    __syncthreads();
    for (int i = tid; i < nr * 4; i += kThreads) {
      const int r = r0 + i / 4, e = i % 4;
      if (r >= quads && e != 0) continue;
      double sum = 0.0;
      for (int k = 0; k < K; ++k) sum += fin[((i / 4) * K + k) * 4 + e];
      a.dwb[r < quads ? 4 * r + e : n_w + (r - quads)] =
          static_cast<float>(sum);
    }
    __syncthreads();  // fin is reused by the next batch
  }
  if (tid == 0) *a.ticket = 0u;
}

template <int CPT>
cudaError_t launch(const Args& a, int blocks, int cluster_size,
                   int smem_bytes, cudaStream_t stream) {
  cudaError_t err = dnnca::allow_smem(tconv_bwd_kernel<CPT>, smem_bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem_bytes;
  config.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = cluster_size;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  return dnnca::launched(
      cudaLaunchKernelEx(&config, tconv_bwd_kernel<CPT>, a));
}

}  // namespace

// dx may be null (no data gradient). dwb is [Ci*Co*4 + Co] (dw in
// [Ci, Co, 2, 2] order, then db); w_partial [clusters][Ci*Co*4] floats and
// b_partial [clusters][Co] doubles are scratch; ticket is one unsigned that
// is 0 before the call and after it. The geometry (the tile, CPT, the
// blocks: B * tiles padded to whole clusters, the cluster size (1 to 8),
// the shared memory) is the wrapper's plan (ops/kernels/tconv2x2_bwd.py:
// plan).
extern "C" int dnnca_tconv2x2_bwd(const float* x, const float* g,
                                  const float* w, float* dx, float* dwb,
                                  float* w_partial, double* b_partial,
                                  unsigned* ticket, int B, int Ci, int Co,
                                  int H, int W, int tile_h, int tile_w,
                                  int cpt, int blocks, int cluster,
                                  int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (cluster < 1 || cluster > 8 || blocks % cluster != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{x, g, w, dx, dwb, w_partial, b_partial, ticket,
               B, Ci, Co, H, W, tile_h, tile_w};
  switch (cpt) {
    case 1: return launch<1>(a, blocks, cluster, smem_bytes, s);
    case 2: return launch<2>(a, blocks, cluster, smem_bytes, s);
    case 3: return launch<3>(a, blocks, cluster, smem_bytes, s);
    case 4: return launch<4>(a, blocks, cluster, smem_bytes, s);
    case 6: return launch<6>(a, blocks, cluster, smem_bytes, s);
    case 8: return launch<8>(a, blocks, cluster, smem_bytes, s);
    default: return cudaErrorInvalidValue;
  }
}
