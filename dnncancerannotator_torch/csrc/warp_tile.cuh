// The two-pass bilinear resample's device code, shared by warp_twopass.cu
// (the image frame, fy and fx interleaved in one flow array) and
// warp_crop.cu (a per-image crop of a window, fy_ext and fx planes): the
// tap arithmetic, and the halo-tile kernel both wrappers route their main
// path's shapes to. The semantics are in the two files' headers.
//
// What the tile rests on: the flow is clamped to +-d with d an integer, and
// q = g - f rounds monotonically, so every tap of output rows [y0, y1) and
// columns [x0, x1) lies in rows [y0 - d, y1 + d] and columns [x0 - d,
// x1 + d] of the frame (each clipped to it), and fy is read at the output
// rows over the same columns (tests/test_torch_warp_plan.py holds this).
//
// A block owns a strip of tw output columns and seg output rows of one
// image and walks down it th rows a step, one output pixel a thread (th =
// 512 / tw). Shared memory keeps a ring of rb = 2 th + 2d + 1 image
// rows over the strip's halo columns [c_lo, c_hi]: the rows of the step
// being computed and those of the next step, in flight meanwhile. So each
// image byte of a strip is staged once, every tap, wherever the flow sends
// it, is a shared-memory read, and the three flow reads of a pixel (fx,
// then fy at its two source columns) no longer form a chain to device
// memory.
//
// Copies. Rows move with the Tensor Memory Accelerator: one bulk copy a
// row segment, issued by lane 0 of the warp that owns the row and expected
// on the step's mbarrier, and each warp writes its own run of output
// pixels back by a bulk store from shared memory, so a step needs one
// block barrier, after which the next step's copies go into the ring
// slots and the flow slot the last step freed. A bulk copy wants 16-byte
// aligned ends, so each segment keeps its global address mod 16 bytes in
// shared memory (its lead), the whole aligned quads between go by bulk
// copy, and the at most 3 + 3 floats before and after them by 4-byte
// cp.async (loads) or plain stores. (Each slower or no faster on the H100,
// tools/profile_torch_sites.py: per-thread cp.async staging, 16 bytes a
// lane; all of a step's bulk copies issued from one warp; one arrival a
// step expecting the step's bytes; a store phase run by one warp after a
// second block barrier; float4 stores by the warps for the bulk stores.)
//
// What bounds it on the H100: not the bytes. With the bulk and edge copies
// after the first step switched off the kernel keeps most of its time
// (tools/probe_torch_warp.py --no-loads --no-edges; PERF.md): the step's
// compute phase, a dependent chain of shared-memory reads (fx, then fy at
// the two source columns, then 4 x C taps) and ~200 instructions a pixel
// at 16 or 32 warps an SM, and the first step, which waits for th + 2d + 1
// rows before any pixel is computed.
//
// Layout in shared memory, 16-byte aligned sections and rows:
//   bar  [2] u64, padded to 16 bytes: the steps' mbarriers (step k: k % 2)
//   ring [rb][rs] floats: frame row r in slot r % rb, its S = c_hi - c_lo + 1
//        pixels NHWC-interleaved as in device memory, lead(r) floats in.
//        Lanes on neighbouring pixels read 8-byte pairs at a 24-byte
//        stride (C = 6): each half-warp meets all 32 banks once.
//   flow [2][th][fs]: a step's flow rows over the same columns: (dy, dx)
//        interleaved (warp_twopass), or fy_ext and fx fs / 2 floats on
//        (warp_crop), each at its lead.
//   out  [th][os]: the step's output rows, each at its global lead.
// The wrapper computes the layout (ops/kernels/warp_twopass.py: plan) and
// passes it in.
#pragma once

#include <cstdint>

#include "conv_tile.cuh"

namespace dnnca {
namespace warp {

constexpr int kThreads = 512;  // a block; two share an SM where they fit

struct Taps {
  int lo, hi;  // row (or column) of the two taps
  float r;     // weight of hi
};

// The taps of output coordinate g at flow f along an axis of n: the flow
// clamped to +-d, the position clipped to [0, n - 1], the hi tap clamped
// into it.
__device__ __forceinline__ Taps taps_at(int g, float f, float d, int n) {
  const float fc = fminf(fmaxf(f, -d), d);
  const float q = fminf(fmaxf(__fsub_rn(static_cast<float>(g), fc), 0.f),
                        static_cast<float>(n - 1));
  const float q0 = floorf(q);
  const int lo = static_cast<int>(q0);
  return Taps{lo, lo + 1 < n ? lo + 1 : n - 1, __fsub_rn(q, q0)};
}

// lo * (1 - r) + hi * r, rounded and not contracted, as the plain version.
__device__ __forceinline__ float blend(float lo, float hi, float r) {
  return __fadd_rn(__fmul_rn(lo, __fsub_rn(1.f, r)), __fmul_rn(hi, r));
}

// The output's size and the window it is cropped from (the image itself for
// warp_twopass: Hin = H, Win = W).
struct Frame {
  int B, Hin, Win, H, W, C;
};

// The launch (ops/kernels/warp_twopass.py: plan).
struct Plan {
  int tw, seg, th;     // strip width, rows a block, rows a step
  int rb, rs, fs, os;  // ring rows; ring, flow and out row strides (floats)
};

__device__ __forceinline__ int lead_of(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Rows of ``stride`` floats from ``base``, each read or written as one
// segment: row r at base + r * stride, its lead from base's and the stride's.
template <typename T>
struct Rows {
  T* base;
  size_t stride;
  int lead0, dlead;
  __device__ Rows(T* b, size_t s)
      : base(b), stride(s), lead0(lead_of(b)), dlead(static_cast<int>(s & 3)) {}
  __device__ T* at(int r) const { return base + r * stride; }
  __device__ int lead(int r) const { return (lead0 + r * dlead) & 3; }
};

// A segment of n floats at lead ``lead``: its floats [a, e) are whole
// 16-byte quads, [0, a) and [e, n) the at most 3 + 3 around them.
struct Span {
  int a, e;
  __device__ Span(int n, int lead) {
    a = min(n, (4 - lead) & 3);
    e = a + (n - a) / 4 * 4;
  }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

// Adds ``bytes`` to the bytes the current phase of ``bar`` awaits.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// Waits for the phase of ``parity`` to complete; traps (a launch error)
// rather than hang if it has not after 2^26 polls.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  for (unsigned polls = 0; !done; ++polls) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (polls == (1u << 26)) __trap();
  }
}

// Bulk copy of ``bytes`` (a multiple of 16, both ends 16-byte aligned) from
// device memory into shared memory, completing on ``bar``.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Bulk copy from shared memory to device memory, in this thread's bulk group.
__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// This thread's bulk stores have read their shared memory (kRead) or are
// done.
template <bool kRead>
__device__ __forceinline__ void bulk_wait() {
  if (kRead)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's shared-memory accesses before later bulk copies.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A segment of n floats from ``src`` to ``dst`` + lead.
struct Segment {
  float* dst;
  const float* src;
  int n, lead;
};

// kCrop = false: fa is the flow [B, H, W, 2] (dy, dx), fb and off unused.
// kCrop = true: fa is fy_ext [B, H, Win], fb is fx [B, H, W], off [B, 2].
// kC = C; kPairs: C is even and img and out are 8-byte aligned, so a
// pixel's channels load and store as float2s. th * tw = kThreads.
template <bool kCrop, int kC, bool kPairs>
__global__ void __launch_bounds__(kThreads, 2)
warp_tile_kernel(const float* __restrict__ img, const float* __restrict__ fa,
                 const float* __restrict__ fb, const int* __restrict__ off,
                 float* __restrict__ out, Frame f, Plan p, int di) {
  extern __shared__ float4 smem4[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem4);
  float* ring = reinterpret_cast<float*>(smem4 + 1);
  float* flow = ring + p.rb * p.rs;
  float* outs = flow + 2 * p.th * p.fs;
  constexpr int warps = kThreads / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float d = static_cast<float>(di);
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * p.tw, x1 = min(f.W, x0 + p.tw);
  const int ya = blockIdx.y * p.seg, yb = min(f.H, ya + p.seg);
  int oy = 0, ox = 0;
  if (kCrop) {
    oy = min(max(off[2 * b], 0), f.Hin - f.H);
    ox = min(max(off[2 * b + 1], 0), f.Win - f.W);
  }
  const int c_lo = max(0, x0 - di), c_hi = min(f.W - 1, x1 + di);
  const int S = c_hi - c_lo + 1, n_img = S * kC;
  const int steps = (yb - ya + p.th - 1) / p.th;
  const size_t bh = static_cast<size_t>(b) * f.H;
  // frame row r's halo segment, and output row y from column x0
  const Rows<const float> img_rows(
      img + ((static_cast<size_t>(b) * f.Hin + oy) * f.Win + ox + c_lo) * kC,
      static_cast<size_t>(f.Win) * kC);
  const Rows<float> out_rows(out + (bh * f.W + x0) * kC,
                             static_cast<size_t>(f.W) * kC);
  // flow row y over the halo columns: (dy, dx) pairs, or the two planes
  const Rows<const float> fa_rows(
      kCrop ? fa + bh * f.Win + ox + c_lo : fa + (bh * f.W + c_lo) * 2,
      kCrop ? static_cast<size_t>(f.Win) : static_cast<size_t>(f.W) * 2);
  const Rows<const float> fb_rows(kCrop ? fb + bh * f.W + c_lo : fa,
                                  static_cast<size_t>(f.W));
  const int n_fa = kCrop ? S : 2 * S;
  // this thread's output pixel in a step
  const int px = threadIdx.x % p.tw, py = threadIdx.x / p.tw;
  const int x = x0 + px;

  if (threadIdx.x == 0) {
    mbar_init(bar, warps);
    mbar_init(bar + 1, warps);
    fence_async_smem();
  }
  __syncthreads();

  // the next frame row to stage and its ring slot
  int next_row = max(0, ya - di), next_slot = next_row % p.rb;
  // Step s's new image rows and its flow rows, a warp a segment: lane 0
  // the bulk copy of its quads, expected on bar[s % 2], at which every warp
  // arrives once a step; lanes 0-2 and 4-6 its edges by cp.async, one
  // commit group a step.
  auto stage = [&](int s) {
    if (s < steps) {
      uint64_t* sb = bar + (s & 1);
      const int y0 = ya + s * p.th, y1 = min(yb, y0 + p.th);
      const int count = max(0, min(f.H - 1, y1 + di) + 1 - next_row);
      float* fl = flow + (s & 1) * p.th * p.fs;
      constexpr int kPlanes = kCrop ? 2 : 1;
      const int nseg = count + (y1 - y0) * kPlanes;
      auto segment = [&](int j) -> Segment {
        if (j < count) {
          const int r = next_row + j;
          const int slot = next_slot + j - (next_slot + j >= p.rb ? p.rb : 0);
          return {ring + slot * p.rs, img_rows.at(r), n_img, img_rows.lead(r)};
        }
        const int row = (j - count) / kPlanes, y = y0 + row;
        if (kCrop && (j - count) % 2)
          return {fl + row * p.fs + p.fs / 2, fb_rows.at(y), S,
                  fb_rows.lead(y)};
        return {fl + row * p.fs, fa_rows.at(y), n_fa, fa_rows.lead(y)};
      };
      for (int j = warp; j < nseg; j += warps) {
        const Segment g = segment(j);
        const Span sp(g.n, g.lead);
        if (lane == 0 && sp.e > sp.a) {
          mbar_expect_tx(sb, 4 * (sp.e - sp.a));
          bulk_load(g.dst + g.lead + sp.a, g.src + sp.a, 4 * (sp.e - sp.a),
                    sb);
        }
        const int i = lane < 4 ? lane : sp.e + lane - 4;
        if ((lane < 4 && i < sp.a) || (lane >= 4 && i < g.n))
          tile::cp_async4(g.dst + g.lead + i, g.src + i, true);
      }
      if (lane == 0) mbar_arrive(sb);
      next_row += count;
      next_slot += count - (next_slot + count >= p.rb ? p.rb : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // the first row of the step computed and its ring slot
  int lo = max(0, ya - di), lo_slot = lo % p.rb;
  // this thread writes back the warp's run of pixels in its row
  const bool leader = px % 32 == 0;
  stage(0);
  for (int k = 0; k < steps; ++k) {
    mbar_wait(bar + (k & 1), (k >> 1) & 1);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // the out tile's last bulk stores have read it
    if (leader) bulk_wait<true>();
    __syncthreads();
    // the ring slots it overwrites hold rows below this step's lo, the
    // flow slot is step k - 1's: both free since the barrier
    stage(k + 1);
    const int y0 = ya + k * p.th, rows = min(p.th, yb - y0);
    const int lo_k = max(0, y0 - di);
    lo_slot += lo_k - lo - (lo_slot + lo_k - lo >= p.rb ? p.rb : 0);
    lo = lo_k;
    if (py < rows && x < x1) {
      const float* fl = flow + (k & 1) * p.th * p.fs + py * p.fs;
      const int y = y0 + py;
      const float* fr = fl + fa_rows.lead(y);
      Taps tx, ty0, ty1;
      if (kCrop) {
        const float* fxr = fl + p.fs / 2 + fb_rows.lead(y);
        tx = taps_at(x, fxr[x - c_lo], d, f.W);
        ty0 = taps_at(y, fr[tx.lo - c_lo], d, f.H);
        ty1 = taps_at(y, fr[tx.hi - c_lo], d, f.H);
      } else {
        tx = taps_at(x, fr[2 * (x - c_lo) + 1], d, f.W);
        ty0 = taps_at(y, fr[2 * (tx.lo - c_lo)], d, f.H);
        ty1 = taps_at(y, fr[2 * (tx.hi - c_lo)], d, f.H);
      }
      // frame pixel (r, c) in the ring; r lies in [lo, lo + rb)
      auto pixel = [&](int r, int c) {
        const int i = lo_slot + r - lo;
        return ring + (i - (i >= p.rb ? p.rb : 0)) * p.rs + img_rows.lead(r) +
               (c - c_lo) * kC;
      };
      const float* t0 = pixel(ty0.lo, tx.lo);
      const float* t1 = pixel(ty0.hi, tx.lo);
      const float* t2 = pixel(ty1.lo, tx.hi);
      const float* t3 = pixel(ty1.hi, tx.hi);
      float* o = outs + py * p.os + out_rows.lead(y) + px * kC;
      if constexpr (kPairs) {
        float2 v[4][kC / 2];
#pragma unroll
        for (int c = 0; c < kC / 2; ++c) {
          v[0][c] = reinterpret_cast<const float2*>(t0)[c];
          v[1][c] = reinterpret_cast<const float2*>(t1)[c];
          v[2][c] = reinterpret_cast<const float2*>(t2)[c];
          v[3][c] = reinterpret_cast<const float2*>(t3)[c];
        }
        // every tap load issued before the first blend uses one
        asm volatile("" ::: "memory");
#pragma unroll
        for (int c = 0; c < kC / 2; ++c)
          reinterpret_cast<float2*>(o)[c] = make_float2(
              blend(blend(v[0][c].x, v[1][c].x, ty0.r),
                    blend(v[2][c].x, v[3][c].x, ty1.r), tx.r),
              blend(blend(v[0][c].y, v[1][c].y, ty0.r),
                    blend(v[2][c].y, v[3][c].y, ty1.r), tx.r));
      } else {
        float v[4][kC];
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          v[0][c] = t0[c];
          v[1][c] = t1[c];
          v[2][c] = t2[c];
          v[3][c] = t3[c];
        }
        asm volatile("" ::: "memory");
#pragma unroll
        for (int c = 0; c < kC; ++c)
          o[c] = blend(blend(v[0][c], v[1][c], ty0.r),
                       blend(v[2][c], v[3][c], ty1.r), tx.r);
      }
    }
    // the leader of each run of up to 32 pixels of a row writes it back:
    // the quads by a bulk store, the edges by plain stores
    fence_async_smem();
    __syncwarp();
    if (leader && py < rows && x < x1) {
      const int y = y0 + py, n = min(32, min(p.tw - px, x1 - x)) * kC;
      const int lead = (out_rows.lead(y) + px * kC) & 3;
      float* dst = out_rows.at(y) + px * kC;
      const float* src = outs + py * p.os + out_rows.lead(y) + px * kC;
      const Span sp(n, lead);
      if (sp.e > sp.a) bulk_store(dst + sp.a, src + sp.a, 4 * (sp.e - sp.a));
      for (int i = 0; i < sp.a; ++i) dst[i] = src[i];
      for (int i = sp.e; i < n; ++i) dst[i] = src[i];
    }
  }
  if (leader) bulk_wait<false>();
}

template <bool kCrop, int kC>
cudaError_t launch_c(const float* img, const float* fa, const float* fb,
                     const int* off, float* out, Frame f, Plan p, int di,
                     int smem, cudaStream_t stream, bool pairs) {
  auto kernel = warp_tile_kernel<kCrop, kC, false>;
  if constexpr (kC % 2 == 0)
    if (pairs) kernel = warp_tile_kernel<kCrop, kC, true>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((f.W + p.tw - 1) / p.tw, (f.H + p.seg - 1) / p.seg, f.B);
  kernel<<<grid, kThreads, smem, stream>>>(img, fa, fb, off, out, f, p, di);
  return dnnca::launched(cudaGetLastError());
}

// Launch the tile kernel over a grid of (strips, segments, images), its
// instance for C (1 to 8: ops/kernels/warp_twopass.py: MAX_CHANNELS),
// float2 pairs where C is even and img and out are 8-byte aligned.
template <bool kCrop>
cudaError_t launch_tile(const float* img, const float* fa, const float* fb,
                        const int* off, float* out, Frame f, Plan p, int di,
                        int smem, cudaStream_t stream) {
  const bool pairs = reinterpret_cast<uintptr_t>(img) % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 8 == 0;
  switch (f.C) {
#define DNNCA_WARP_C(c)                                                     \
  case c:                                                                   \
    return launch_c<kCrop, c>(img, fa, fb, off, out, f, p, di, smem,       \
                              stream, pairs);
    DNNCA_WARP_C(1)
    DNNCA_WARP_C(2)
    DNNCA_WARP_C(3)
    DNNCA_WARP_C(4)
    DNNCA_WARP_C(5)
    DNNCA_WARP_C(6)
    DNNCA_WARP_C(7)
    DNNCA_WARP_C(8)
#undef DNNCA_WARP_C
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace warp
}  // namespace dnnca
