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
// What bounds it on the H100: dx does 4 * Co FMAs per input pixel against
// (4 * Co + Ci) * 4 bytes, dw the same FMAs, so both are bound by
// device-memory bytes at the model's widths.
//
// Design:
// - dx: one thread per input pixel, the Ci gradients in registers (a
//   template bucket CI), the four taps of one (ci, co) one float4 broadcast
//   from shared memory, as in the forward.
// - dw/db: a block walks tiles of 4 x 32 input pixels and stages x as
//   [pixel][CI] and the matching 8 x 64 block of g as [Co][row][col]. A work
//   item is one (co, phase) pair and one slice of the tile's pixels; it
//   keeps the CI gradients of its pair, and the sum of its g for db, in
//   registers. The slices are summed in shared memory, each block writes one
//   partial per output entry, and a second kernel adds the partials in a
//   fixed order (wgrad.cu), so the result is the same from run to run.
#include "conv_tile.cuh"
#include "wgrad.cuh"

namespace {

using dnnca::tile::tap;

constexpr int kThreads = 256;
constexpr int kTileH = 4;
constexpr int kTileW = 32;
constexpr int kPix = kTileH * kTileW;
// g rows of one tile are 2 * kTileW wide; one float of padding per row and
// per channel plane spreads the (co, phase) items over the banks
constexpr int kGRow = 2 * kTileW + 1;
constexpr int kGPlane = 2 * kTileH * kGRow + 1;

template <int CI>
__global__ void __launch_bounds__(kThreads)
tconv_dgrad_kernel(const float* __restrict__ g, const float* __restrict__ w,
                   float* __restrict__ dx, int B, int Ci, int Co, int H,
                   int W) {
  extern __shared__ float4 smem4[];
  float4* ws = smem4;  // [CI][Co] x (2x2)
  for (int i = threadIdx.x; i < CI * Co; i += kThreads)
    ws[i] = i < Ci * Co ? reinterpret_cast<const float4*>(w)[i]
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const size_t plane = static_cast<size_t>(H) * W;
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<size_t>(B) * plane) return;
  const int b = static_cast<int>(idx / plane);
  const size_t pix = idx % plane;
  const int y = static_cast<int>(pix / W), xx = static_cast<int>(pix % W);

  const int OW = 2 * W;
  const size_t oplane = 4 * plane;
  const float* gb = g + static_cast<size_t>(b) * Co * oplane +
                    static_cast<size_t>(2 * y) * OW + 2 * xx;
  float acc[CI];
#pragma unroll
  for (int c = 0; c < CI; ++c) acc[c] = 0.f;
  for (int o = 0; o < Co; ++o) {
    const float* gp = gb + o * oplane;
    const float g00 = gp[0], g01 = gp[1], g10 = gp[OW], g11 = gp[OW + 1];
#pragma unroll
    for (int c = 0; c < CI; ++c) {
      const float4 wq = ws[c * Co + o];  // (dy, dx) = 00, 01, 10, 11
      acc[c] = fmaf(g00, wq.x, acc[c]);
      acc[c] = fmaf(g01, wq.y, acc[c]);
      acc[c] = fmaf(g10, wq.z, acc[c]);
      acc[c] = fmaf(g11, wq.w, acc[c]);
    }
  }
  float* dxb = dx + static_cast<size_t>(b) * Ci * plane + pix;
#pragma unroll
  for (int c = 0; c < CI; ++c)
    if (c < Ci) dxb[c * plane] = acc[c];
}

template <int CI>
__global__ void __launch_bounds__(kThreads)
tconv_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ g,
                   float* __restrict__ partial, int B, int Ci, int Co, int H,
                   int W, int blocks) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* xs = smem;              // [kPix][CI]
  float* gs = xs + kPix * CI;    // [Co][kGPlane]
  float* red = smem;             // [slices][n_pairs][CI + 1], after the tiles
  const float4* xs4 = reinterpret_cast<const float4*>(xs);
  const int n_pairs = 4 * Co;    // (co, phase); <= kThreads as Co <= 64
  const int slices = kThreads / n_pairs;
  const int span = (kPix + slices - 1) / slices;
  const int tid = threadIdx.x;
  const int j = tid % n_pairs, slice = tid / n_pairs;
  const bool active = slice < slices;
  const int co = j / 4, dy = j / 2 % 2, dxp = j % 2;

  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const int n_tiles = B * tiles_y * tiles_x;
  const size_t plane = static_cast<size_t>(H) * W;
  const int OH = 2 * H, OW = 2 * W;
  float acc[CI];
#pragma unroll
  for (int c = 0; c < CI; ++c) acc[c] = 0.f;
  float accb = 0.f;

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int b = t / (tiles_y * tiles_x);
    const int y0 = t / tiles_x % tiles_y * kTileH;
    const int x0 = t % tiles_x * kTileW;
    __syncthreads();  // every thread is done with the previous tile
    for (int i = tid; i < CI * kPix; i += kThreads) {
      const int c = i / kPix, pix = i % kPix;
      const int y = y0 + pix / kTileW, xx = x0 + pix % kTileW;
      xs[pix * CI + c] =
          (c < Ci && y < H && xx < W)
              ? x[(static_cast<size_t>(b) * Ci + c) * plane +
                  static_cast<size_t>(y) * W + xx]
              : 0.f;
    }
    const int g_tile = 2 * kTileH * 2 * kTileW;
    for (int i = tid; i < Co * g_tile; i += kThreads) {
      const int o = i / g_tile, r = i % g_tile / (2 * kTileW);
      const int col = i % (2 * kTileW);
      const int oy = 2 * y0 + r, ox = 2 * x0 + col;
      gs[o * kGPlane + r * kGRow + col] =
          (oy < OH && ox < OW)
              ? g[(static_cast<size_t>(b) * Co + o) * 4 * plane +
                  static_cast<size_t>(oy) * OW + ox]
              : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    const int lo = slice * span;
    const int hi = lo + span < kPix ? lo + span : kPix;
    const float* gc = gs + co * kGPlane + dy * kGRow + dxp;
    for (int pix = lo; pix < hi; ++pix) {
      const float v = gc[2 * (pix / kTileW) * kGRow + 2 * (pix % kTileW)];
      accb += v;
      tap<CI>(acc, v, xs4 + pix * (CI / 4));
    }
  }

  __syncthreads();  // red overwrites the tile buffers
  if (active) {
    float* r = red + (slice * n_pairs + j) * (CI + 1);
#pragma unroll
    for (int c = 0; c < CI; ++c) r[c] = acc[c];
    r[CI] = accb;
  }
  __syncthreads();
  for (int i = tid; i < n_pairs * Ci; i += kThreads) {
    const int jj = i / Ci, c = i % Ci;
    float s = 0.f;
    for (int sl = 0; sl < slices; ++sl)
      s += red[(sl * n_pairs + jj) * (CI + 1) + c];
    const int e = (c * Co + jj / 4) * 4 + jj % 4;
    partial[static_cast<size_t>(e) * blocks + blockIdx.x] = s;
  }
  for (int o = tid; o < Co; o += kThreads) {
    float s = 0.f;
    for (int sl = 0; sl < slices; ++sl)
      for (int ph = 0; ph < 4; ++ph)
        s += red[(sl * n_pairs + 4 * o + ph) * (CI + 1) + CI];
    partial[static_cast<size_t>(Ci * Co * 4 + o) * blocks + blockIdx.x] = s;
  }
}

template <int CI>
cudaError_t launch(const float* x, const float* g, const float* w, float* dx,
                   float* dwb, float* partial, int B, int Ci, int Co, int H,
                   int W, int blocks, cudaStream_t stream) {
  cudaError_t err;
  if (dx != nullptr) {
    const size_t smem_bytes = static_cast<size_t>(CI) * Co * 16;
    err = dnnca::allow_smem(tconv_dgrad_kernel<CI>, smem_bytes);
    if (err != cudaSuccess) return err;
    const size_t n = static_cast<size_t>(B) * H * W;
    const unsigned grid =
        static_cast<unsigned>((n + kThreads - 1) / kThreads);
    tconv_dgrad_kernel<CI><<<grid, kThreads, smem_bytes, stream>>>(
        g, w, dx, B, Ci, Co, H, W);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int n_pairs = 4 * Co;
  const size_t tiles = static_cast<size_t>(kPix) * CI +
                       static_cast<size_t>(Co) * kGPlane;
  const size_t reduce =
      static_cast<size_t>(kThreads / n_pairs) * n_pairs * (CI + 1);
  const size_t smem_bytes = 4 * (tiles > reduce ? tiles : reduce);
  err = dnnca::allow_smem(tconv_wgrad_kernel<CI>, smem_bytes);
  if (err != cudaSuccess) return err;
  tconv_wgrad_kernel<CI><<<blocks, kThreads, smem_bytes, stream>>>(
      x, g, partial, B, Ci, Co, H, W, blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return dnnca::launch_sum_partials(partial, dwb, Ci * Co * 4 + Co, blocks,
                                    stream);
}

}  // namespace

// dx may be null (no data gradient). dwb is [Ci*Co*4 + Co] (dw in
// [Ci, Co, 2, 2] order, then db); partial is [size of dwb * wgrad_blocks]
// scratch.
extern "C" int dnnca_tconv2x2_bwd(const float* x, const float* g,
                                  const float* w, float* dx, float* dwb,
                                  float* partial, int B, int Ci, int Co,
                                  int H, int W, int wgrad_blocks, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DNNCA_TCONV_BWD(CI) \
  launch<CI>(x, g, w, dx, dwb, partial, B, Ci, Co, H, W, wgrad_blocks, s)
  if (Ci <= 4) return DNNCA_TCONV_BWD(4);
  if (Ci <= 8) return DNNCA_TCONV_BWD(8);
  if (Ci <= 16) return DNNCA_TCONV_BWD(16);
  if (Ci <= 32) return DNNCA_TCONV_BWD(32);
  return DNNCA_TCONV_BWD(64);
#undef DNNCA_TCONV_BWD
}
