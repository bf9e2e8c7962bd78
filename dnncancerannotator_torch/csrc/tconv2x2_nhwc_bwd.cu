// Backward of the NHWC transposed conv (tconv2x2_nhwc.cu):
//   dx[b, y, x, ci]    = sum_{co, dy, dx} g[b, 2y+dy, 2x+dx, co] * w[ci, co, dy, dx]
//   dw[ci, co, dy, dx] = sum_{b, y, x} x[b, y, x, ci] * g[b, 2y+dy, 2x+dx, co]
//   db[co]             = sum_{b, Y, X} g[b, Y, X, co]
//
// Replaces the backward of tconv_kernel.conv_transpose2x2_nhwc
// (dnncancerannotator_tpu/ops/pallas/tconv_kernel.py:161, _bwd_kernel :70,
// _bwd_call :123), which carries dw and db across its sequential grid.
// Blocks on Hopper run in no order, so here:
// - dx is one GEMM [B*H*W, 4*Co] x [4*Co, Ci] whose A rows gather the four
//   phase pixels of each input pixel (tconv_gemm.cuh, dgrad);
// - dw splits the reduction over the B*H*W input pixels into chunks: each
//   block writes the [128 x 128] tile of its chunk's partial sums
//   (tconv_gemm.cuh, wgrad), and a second kernel adds the chunks in a fixed
//   order, so dw is the same from run to run;
// - db sums column chunks of g the same way.
// No atomics.
//
// What bounds it on the H100: the two products, 2 x the forward's FLOPs
// (8.6 to 17.2 GFLOP at the unet_big decoder sites, B=8), in f32 FMAs; the
// partials add 4 * splits * Ci * 4Co bytes of traffic.
#include "tconv_gemm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kDbCols = 128;

// partial[chunk][Co]: the sum of g over one chunk of output pixels
__global__ void __launch_bounds__(kDbCols)
db_partial_kernel(const float* __restrict__ g, float* __restrict__ partial,
                  int rows, int Co, int chunk) {
  const int co = blockIdx.y * kDbCols + threadIdx.x;
  const int r0 = blockIdx.x * chunk;
  const int r1 = min(r0 + chunk, rows);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += g[static_cast<size_t>(r) * Co + co];
  partial[static_cast<size_t>(blockIdx.x) * Co + co] = s;
}

// out[e] = sum_{r < n_rows} partial[r][e], in order. With co > 0 the entries
// are dw packed as [Ci][4][Co] and go to [Ci][Co][4].
__global__ void __launch_bounds__(kThreads)
sum_rows_kernel(const float* __restrict__ partial, float* __restrict__ out,
                int n, int n_rows, int co) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int r = 0; r < n_rows; ++r) s += partial[static_cast<size_t>(r) * n + e];
  int dst = e;
  if (co > 0) {
    const int ci = e / (4 * co), p = e / co % 4, o = e % co;
    dst = (ci * co + o) * 4 + p;
  }
  out[dst] = s;
}

}  // namespace

// dx may be null (no data gradient). wpt is the weight packed as
// [(2*dy + dx)*Co + co][ci]. dw is [Ci, Co, 2, 2], db [Co]. partial holds
// wgrad_splits * Ci * 4 * Co floats, db_partial db_chunks * Co floats.
extern "C" int dnnca_tconv2x2_nhwc_bwd(
    const float* x, const float* g, const float* wpt, float* dx, float* dw,
    float* db, float* partial, float* db_partial, int B, int H, int W, int Ci,
    int Co, int wgrad_chunk, int wgrad_splits, int db_chunk, int db_chunks,
    int device, void* stream) {
  namespace tg = dnnca::tgemm;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dx != nullptr) {
    err = tg::launch<tg::kDgrad>(
        tg::Params{g, wpt, nullptr, dx, B, H, W, Ci, Co, 0}, 1, s);
    if (err != cudaSuccess) return err;
  }
  err = tg::launch<tg::kWgrad>(
      tg::Params{x, g, nullptr, partial, B, H, W, Ci, Co, wgrad_chunk},
      wgrad_splits, s);
  if (err != cudaSuccess) return err;
  const int n_w = Ci * 4 * Co;
  sum_rows_kernel<<<(n_w + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      partial, dw, n_w, wgrad_splits, Co);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  db_partial_kernel<<<dim3(db_chunks, Co / kDbCols), kDbCols, 0, s>>>(
      g, db_partial, 4 * B * H * W, Co, db_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_rows_kernel<<<(Co + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      db_partial, db, Co, db_chunks, 0);
  return cudaGetLastError();
}
