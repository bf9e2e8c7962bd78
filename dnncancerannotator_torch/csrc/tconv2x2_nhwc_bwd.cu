// Backward of the NHWC transposed conv (tconv2x2_nhwc.cu):
//   dx[b, y, x, ci]    = sum_{co, dy, dx} g[b, 2y+dy, 2x+dx, co] * w[ci, co, dy, dx]
//   dw[ci, co, dy, dx] = sum_{b, y, x} x[b, y, x, ci] * g[b, 2y+dy, 2x+dx, co]
//   db[co]             = sum_{b, Y, X} g[b, Y, X, co]
//
// Replaces the backward of tconv_kernel.conv_transpose2x2_nhwc
// (dnncancerannotator_tpu/ops/pallas/tconv_kernel.py:161, _bwd_kernel :70,
// _bwd_call :123), which carries dw and db across its sequential grid.
// Blocks on Hopper run in no order, so here, in three launches:
// - dx is the GEMM [B*H*W, 4*Co] x [4*Co, Ci] whose A rows gather the four
//   phase pixels of each input pixel (tconv_gemm.cuh, dgrad). Where its
//   tiles alone would leave SMs idle, K is split by phase (dgrad_splits of
//   1, 2 or 4) and each split writes its partial dx;
// - dw splits the reduction over the B*H*W input pixels into chunks: each
//   block writes the [128 x 128] tile of its chunk's partial sums
//   (tconv_gemm.cuh, wgrad), and the blocks of the first Ci tile write the
//   column sums of their g tiles, db's partials, beside them;
// - a third kernel adds the partials of dw, db and dx in a fixed order.
// No atomics: dx, dw and db are the same from run to run.
//
// What bounds it on the H100: the two products, 2 x the forward's FLOPs
// (8.6 to 17.2 GFLOP at the unet_big decoder sites, B=8): 128-256 us on f32
// FMAs, 52-104 us on the tensor cores in 3xTF32; the partials add a few MB
// of traffic (the wrapper's plan keeps them to one wave of blocks).
#include "tconv_gemm.cuh"

namespace {

constexpr int kThreads = 256;

// Blocks [0, w_blocks): dw[ci, co, :] from the wgrad partials, one (ci, co)
// a thread, the four phases as one float4; then db_blocks for db[co]; then
// dx as float4 sums of the dgrad partials (only with dx_splits > 1).
__global__ void __launch_bounds__(kThreads)
finish_kernel(const float* __restrict__ w_partial,
              const float* __restrict__ db_partial,
              const float4* __restrict__ dx_partial, float4* __restrict__ dw,
              float* __restrict__ db, float4* __restrict__ dx, int Ci, int Co,
              int w_splits, long long dx_n4, int dx_splits, int w_blocks,
              int db_blocks) {
  const int blk = blockIdx.x;
  if (blk < w_blocks) {
    const int e = blk * kThreads + threadIdx.x;
    if (e >= Ci * Co) return;
    const int ci = e / Co, co = e - ci * Co;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z = 0; z < w_splits; ++z) {
      const float* src =
          w_partial + (static_cast<size_t>(z) * Ci + ci) * 4 * Co + co;
      s.x += src[0];
      s.y += src[Co];
      s.z += src[2 * Co];
      s.w += src[3 * Co];
    }
    dw[e] = s;
  } else if (blk < w_blocks + db_blocks) {
    const int co = (blk - w_blocks) * kThreads + threadIdx.x;
    if (co >= Co) return;
    float s = 0.f;
    for (int z = 0; z < w_splits; ++z)
      for (int p = 0; p < 4; ++p)
        s += db_partial[(static_cast<size_t>(z) * 4 + p) * Co + co];
    db[co] = s;
  } else {
    const long long e =
        static_cast<long long>(blk - w_blocks - db_blocks) * kThreads +
        threadIdx.x;
    if (e >= dx_n4) return;
    float4 s = dx_partial[e];
    for (int z = 1; z < dx_splits; ++z) {
      const float4 v = dx_partial[z * dx_n4 + e];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    dx[e] = s;
  }
}

}  // namespace

// dx may be null (no data gradient); wpt (the weight packed as
// [(2*dy + dx)*Co + co][ci]) is read only for dx. dw is [Ci, Co, 2, 2], db
// [Co]. w_partial holds wgrad_splits * Ci * 4 * Co floats, db_partial
// wgrad_splits * 4 * Co, dx_partial dgrad_splits * B*H*W * Ci when
// dgrad_splits > 1 (else it is not read and may be null).
extern "C" int dnnca_tconv2x2_nhwc_bwd(
    const float* x, const float* g, const float* wpt, float* dx, float* dw,
    float* db, float* w_partial, float* db_partial, float* dx_partial, int B,
    int H, int W, int Ci, int Co, int dgrad_splits, int wgrad_chunk,
    int wgrad_splits, int device, void* stream) {
  namespace tg = dnnca::tgemm;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pixels = B * H * W;
  const int dx_splits = dx != nullptr && dgrad_splits > 1 ? dgrad_splits : 0;
  if (dx != nullptr) {
    err = tg::launch<tg::kDgrad>(
        tg::Params{g, wpt, nullptr, dx_splits ? dx_partial : dx, nullptr, B,
                   H, W, Ci, Co, 4 * Co / dgrad_splits},
        dgrad_splits, s);
    if (err != cudaSuccess) return err;
  }
  err = tg::launch<tg::kWgrad>(
      tg::Params{x, g, nullptr, w_partial, db_partial, B, H, W, Ci, Co,
                 wgrad_chunk},
      wgrad_splits, s);
  if (err != cudaSuccess) return err;
  const long long dx_n4 = static_cast<long long>(pixels) * Ci / 4;
  const int w_blocks = (Ci * Co + kThreads - 1) / kThreads;
  const int db_blocks = (Co + kThreads - 1) / kThreads;
  const long long dx_blocks = dx_splits ? (dx_n4 + kThreads - 1) / kThreads
                                        : 0;
  finish_kernel<<<static_cast<unsigned>(w_blocks + db_blocks + dx_blocks),
                  kThreads, 0, s>>>(
      w_partial, db_partial, reinterpret_cast<const float4*>(dx_partial),
      reinterpret_cast<float4*>(dw), db, reinterpret_cast<float4*>(dx), Ci, Co,
      wgrad_splits, dx_n4, dx_splits, w_blocks, db_blocks);
  return dnnca::launched(cudaGetLastError());
}
