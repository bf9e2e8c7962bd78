// Stride-1 convolution with explicit pads, bias and an optional fused relu:
//   out[b, o, y, x] = bias[o] + sum_{c, ky, kx} xpad[b, c, y+ky, x+kx] * w[o, c, ky, kx]
// where xpad is x zero-padded by (pt, pb) rows and (pl, pr) columns;
// OH = H + pt + pb - KH + 1 and OW likewise (the wrapper passes both).
//
// Replaces conv_kernel.stencil_conv2d_pallas
// (dnncancerannotator_tpu/ops/pallas/conv_kernel.py:84), which keeps a
// whole padded image in VMEM and reads the weights as SMEM scalars, with
// ``nchw=True``; its NHWC form is stencil_conv_nhwc.cu. w [Co, Ci, KH, KW]
// (PyTorch OIHW), Ci, Co <= 32, f32. Two routes
// (ops/kernels/stencil_conv.py: route):
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
// - stencil (any other KH x KW or pads): under bf16 compute (bf16.yaml)
//   unet.yaml's down_2 chain is split, and its first conv, 3 x 3 6 -> 12
//   with relu at 64 x 64, runs here in its bf16 form. One thread per
//   output pixel, all Co accumulators in registers (a template bucket of
//   Co), weights and bias in shared memory (broadcast reads). Neighbouring
//   threads take neighbouring x, so every input and output access is
//   coalesced; the padding is a bounds test on the input index, never a
//   padded copy. Its time at that site sits far above its bound (PERF.md
//   §6, rows 4 bf16, on an H100 80GB HBM3 at 700 W); its redesign is the
//   next one queued (ROADMAP.md, queue 2).
//
// bf16 forms (entries dnnca_stencil_conv_bf16, dnnca_pointwise_conv_bf16):
// x, w and the bias in bf16, each value converted to f32 as it is loaded
// (four at a time as 8 bytes where the f32 form reads a float4), the sums
// the f32 form's in its order, and the output rounded to bf16
// (nearest-even) on its store: equal to the f32 form's on the upcast
// inputs, rounded. stencil_conv2d_pallas takes bf16 the same way: it
// upcasts, computes in f32, and its caller rounds.
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
