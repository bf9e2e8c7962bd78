// The f32 GEMM shared by the NHWC transposed-conv kernels
// (tconv2x2_nhwc.cu, tconv2x2_nhwc_bwd.cu), on the tensor cores at f32
// accuracy (3xTF32).
//
// ConvTranspose(kernel 2, stride 2) of x [B, H, W, Ci] with w [Ci, Co, 2, 2]
// writes every output pixel from exactly one input pixel, so with the
// phases p = 2 * dy + dx packed beside the channels it is one product. With
// the weight packed once as wpt[p*Co + co][ci] (ops/kernels/tconv2x2_nhwc.py
// pack):
//   fwd:   out[pix(m, p), co] = bias[co] + sum_ci x[m, ci] * wpt[p*Co + co, ci]
//   dgrad: dx[m, ci] = sum_{p, co} g[pix(m, p), co] * wpt[p*Co + co, ci]
//   wgrad: dwp[ci, p*Co + co] = sum_m x[m, ci] * g[pix(m, p), co]
// where m runs over the B*H*W input pixels and pix(m, p) is the output pixel
// (b, 2y+dy, 2x+dx) of input pixel m = (b, y, x). With r = b*H + y that
// pixel is 2 * (m + r*W) + 2W*dy + dx: a thread computes the first term
// once per row it loads and adds the phase's term per K slice.
//
// Replaces the MXU dots of tconv_kernel.conv_transpose2x2_nhwc
// (dnncancerannotator_tpu/ops/pallas/tconv_kernel.py:161, _fwd_kernel :58)
// and of its backward (_bwd_call :123, _bwd_kernel :70), which run at
// `highest` precision as multi-pass bf16 products.
//
// What bounds it on the H100: 2 * Ci FLOPs an output value, 4.3 to 8.6
// GFLOP a product at the unet_big decoder sites (B=8) against 4 to 67 MB, so
// arithmetic: 64-128 us a product on the 67 TFLOP/s of f32 FMAs, 26-52 us on
// the tensor cores at 3 x 495 TFLOP/s of TF32. The design:
// - 3xTF32: each operand value a splits into big = tf32(a) and small =
//   tf32(a - big); the tile sums small*big' + big*small' + big*big' (the
//   small*small' term, ~2^-22 of a product, is dropped), as warpgroup
//   wgmma.m64n128k8 tf32 products with f32 accumulation. The tensor cores'
//   own accumulation is not rounded to nearest, so each 32-deep K slice
//   sums into fresh registers that are then added to the running f32 sums
//   with plain adds (the error of a 32-deep blocked f32 sum, not of one long
//   truncated sum). TF32 stays off everywhere else in the port
//   (engine.resolve_device).
// - A ring of kStages = 3 raw K slices in dynamic shared memory, filled by
//   cp.async (16 bytes a thread, zero fill past the ragged edge) and
//   completed with cp.async.wait_group: two slices are in flight while one
//   is multiplied. The phase gather is an address: no per-load division for
//   x and the weight, one division by W per g row and slice.
// - A split pass turns the landed slice into the big and small halves of A
//   and B, written K-major in 8-row x 16-byte core matrices without swizzle
//   (wgmma's tf32 operands must be K-major: this pass also transposes the
//   wgrad's x and g and the dgrad's weight), then a proxy fence and one
//   barrier; each warpgroup issues 12 wgmma a slice from shared-memory
//   descriptors. The pass and the products do not overlap: a variant that
//   split one 16-deep half while the other was multiplied (two half
//   buffers, three accumulator sets, more barriers) ran slower on the H100
//   (PERF.md, Findings).
// - Tiles of 128 x 128 outputs, two warpgroups of 64 rows; one block an SM
//   (184 KB of shared memory). Blocks to fill 132 SMs: the wrapper splits
//   the dgrad over its phases and the wgrad over its pixels
//   (ops/kernels/tconv2x2_nhwc_bwd.py plan); the partial sums are added in a
//   fixed order by a second kernel. No atomics: every result is the same
//   from run to run.
// - The wgrad blocks of the first Ci tile also sum their g tiles' columns,
//   which are db's partial sums: no separate pass over g.
//
// Needs Ci % 128 == 0 and Co % 128 == 0 (the JAX kernel's eligibility): then
// a 128-column tile lies inside one phase and so does every 32-deep K slice,
// and the wrapper checks it. Any B, H, W.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace dnnca {
namespace tgemm {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kStages = 3;     // cp.async ring of raw K slices
constexpr int kThreads = 256;  // two warpgroups, 64 output rows each
constexpr int kLdK = kBK + 8;  // raw K-major tile [128][kLdK]
constexpr int kLdMN = kBM + 4; // raw M/N-major tile [kBK][kLdMN]
constexpr int kTileFloats = kBM * kLdK;
constexpr int kStageFloats = 2 * kTileFloats;
// the split slice: A big, A small, B big, B small, each [128][kBK] in core
// matrices of 8 rows x 4 floats
constexpr int kSplitFloats = kBM * kBK;
constexpr int kSmemBytes = (kStages * kStageFloats + 4 * kSplitFloats) * 4;
static_assert(kBK * kLdMN <= kTileFloats, "an M/N-major tile must fit");
static_assert(kSmemBytes <= kMaxDynamicSmemBytes, "shared memory");

enum Mode { kFwd, kDgrad, kWgrad };

struct Params {
  const float* a;     // fwd, wgrad: x [B*H*W, Ci]; dgrad: g [B, 2H, 2W, Co]
  const float* b;     // fwd, dgrad: wpt [4Co, Ci]; wgrad: g
  const float* bias;  // fwd: [Co]
  float* out;         // fwd: [B, 2H, 2W, Co]; dgrad: [splits][B*H*W][Ci];
                      // wgrad: [splits][Ci][4Co]
  float* db;          // wgrad: [splits][4Co], the column sums of g
  int B, H, W, Ci, Co;
  int k_split;        // dgrad: K a split (a multiple of Co); wgrad: pixels
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros where !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Output pixel (b, 2y, 2x) of input pixel m = (b, y, x), in pixels.
__device__ __forceinline__ size_t out_pixel(int m, int W) {
  const int r = m / W;
  return 2 * (static_cast<size_t>(m) + static_cast<size_t>(r) * W);
}

// What phase p adds to out_pixel, in pixels.
__device__ __forceinline__ int phase_offset(int p, int W) {
  return (p >> 1) * 2 * W + (p & 1);
}

// big = tf32(v), small = tf32(v - big), both rounded to nearest
__device__ __forceinline__ void split(float v, uint32_t& big,
                                      uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(v));
  const float rest = v - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// The K range of block z: fwd all of Ci; dgrad its phases; wgrad its
// chunk of input pixels.
template <int M>
__device__ __forceinline__ void k_range(const Params& q, int z, int pixels,
                                        int& k_begin, int& k_end) {
  if constexpr (M == kFwd) {
    k_begin = 0;
    k_end = q.Ci;
  } else if constexpr (M == kDgrad) {
    k_begin = z * q.k_split;
    k_end = k_begin + q.k_split;
  } else {
    k_begin = z * q.k_split;
    k_end = min(k_begin + q.k_split, pixels);
  }
}

// This thread's share of the cp.async copies of one K slice: A is K-major
// for fwd and dgrad ([128][kLdK], rows (t >> 3) + 32 i, 4 floats at kq),
// M-major for wgrad ([kBK][kLdMN], K rows (t >> 5) + 8 i, 4 floats at cq);
// B is K-major for fwd, N-major for dgrad and wgrad. Row addresses are
// computed once.
template <int M>
struct Loader {
  static constexpr bool kAK = M != kWgrad;
  static constexpr bool kBK_ = M == kFwd;
  const float* a_row[4];
  bool a_ok[4];
  const float* b_row[4];
  int kq, kr, cq, m0, n0, k_end, wg_off, wco0;

  __device__ __forceinline__ Loader(const Params& q, int t, int m0_, int n0_,
                                    int rows, int k_end_)
      : kq((t & 7) * 4), kr(t >> 5), cq((t & 31) * 4), m0(m0_), n0(n0_),
        k_end(k_end_) {
    if constexpr (kAK) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + (t >> 3) + 32 * i;
        a_ok[i] = m < rows;
        const int mc = a_ok[i] ? m : 0;
        a_row[i] = M == kFwd ? q.a + static_cast<size_t>(mc) * q.Ci + kq
                             : q.a + out_pixel(mc, q.W) * q.Co + kq;
      }
    }
    if constexpr (kBK_) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        b_row[i] =
            q.b + static_cast<size_t>(n0 + (t >> 3) + 32 * i) * q.Ci + kq;
    }
    // wgrad: the phase and first channel of this block's g columns
    const int p = n0 / q.Co;
    wg_off = phase_offset(p, q.W);
    wco0 = n0 - p * q.Co;
  }

  __device__ __forceinline__ void operator()(const Params& q, int t, float* as,
                                             float* bs, int k0) const {
    if constexpr (M == kFwd) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (t >> 3) + 32 * i;
        cp_async16(as + r * kLdK + kq, a_row[i] + k0, a_ok[i]);
        cp_async16(bs + r * kLdK + kq, b_row[i] + k0, true);
      }
    } else if constexpr (M == kDgrad) {
      const int p = k0 / q.Co;
      const size_t off =
          static_cast<size_t>(phase_offset(p, q.W)) * q.Co + (k0 - p * q.Co);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (t >> 3) + 32 * i;
        cp_async16(as + r * kLdK + kq, a_row[i] + off, a_ok[i]);
        const int k = kr + 8 * i;
        cp_async16(bs + k * kLdMN + cq,
                   q.b + static_cast<size_t>(k0 + k) * q.Ci + n0 + cq, true);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = kr + 8 * i, pix = k0 + k;
        const bool ok = pix < k_end;
        const int pc = ok ? pix : 0;
        cp_async16(as + k * kLdMN + cq,
                   q.a + static_cast<size_t>(pc) * q.Ci + m0 + cq, ok);
        cp_async16(bs + k * kLdMN + cq,
                   q.b + (out_pixel(pc, q.W) + wg_off) * q.Co + wco0 + cq, ok);
      }
    }
  }
};

// Where output row m of block (n0, z) starts, at its first column n0: the
// phase's output pixel (fwd), dx or its split's partial (dgrad), the
// split's dw partial (wgrad).
template <int M>
__device__ __forceinline__ float* out_row(const Params& q, int m, int n0,
                                          int z, int pixels) {
  if constexpr (M == kFwd) {
    const int p = n0 / q.Co;
    return q.out + (out_pixel(m, q.W) + phase_offset(p, q.W)) * q.Co +
           (n0 - p * q.Co);
  } else if constexpr (M == kDgrad) {
    return q.out + (static_cast<size_t>(z) * pixels + m) * q.Ci + n0;
  } else {
    return q.out + (static_cast<size_t>(z) * q.Ci + m) * 4 * q.Co + n0;
  }
}

// wgrad, first Ci tile: this thread's column (t & 127) of the g tile over
// half the K rows, added to a compensated (Kahan) running sum
__device__ __forceinline__ void db_add(const float* bs, int t, float& sum,
                                       float& lost) {
  const float* col = bs + (t >> 7) * (kBK / 2) * kLdMN + (t & 127);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kBK / 2; ++j) s += col[j * kLdMN];
  const float y = s - lost, next = sum + y;
  lost = (next - sum) - y;
  sum = next;
}

// after the main loop: the two halves' sums to db[z][n0 + column]
__device__ __forceinline__ void db_store(const Params& q, float* smem, int t,
                                         int z, int n0, float sum) {
  __syncthreads();   // every warp is done with the shared tiles
  smem[t] = sum;
  __syncthreads();
  if (t < kBN)
    q.db[static_cast<size_t>(z) * 4 * q.Co + n0 + t] = smem[t] + smem[t + kBN];
}

// Shared-memory matrix descriptor of a K-major tile without swizzle: core
// matrices of 8 rows x 16 bytes, ``lbo`` bytes apart along K, ``sbo`` apart
// along M (N).
__device__ __forceinline__ uint64_t gmma_desc(const float* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = smem_addr(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

template <int M>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const Params q) {
  extern __shared__ __align__(128) float smem[];
  float* halves = smem + kStages * kStageFloats;   // the split slice
  constexpr bool kAK = Loader<M>::kAK;
  constexpr bool kBKmaj = Loader<M>::kBK_;
  const int t = threadIdx.x, lane = t & 31, wg = t >> 7, w4 = (t >> 5) & 3;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM, z = blockIdx.z;
  const int pixels = q.B * q.H * q.W;
  const int rows = M == kWgrad ? q.Ci : pixels;
  int k_begin, k_end;
  k_range<M>(q, z, pixels, k_begin, k_end);
  const int n_k = (k_end - k_begin + kBK - 1) / kBK;
  const Loader<M> load(q, t, m0, n0, rows, k_end);
  // split pass: this thread's K column and row within each 8-row group;
  // element (r, k) of a converted tile sits in core matrix (r / 8, k / 4)
  const int sk = 4 * (t >> 5) + (t & 3), sr = (t >> 2) & 7;

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const bool do_db = M == kWgrad && blockIdx.y == 0;
  float db_sum = 0.f, db_lost = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k)
      load(q, t, smem + s * kStageFloats, smem + s * kStageFloats + kTileFloats,
           k_begin + s * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // the raw slice landed; both warpgroups left halves
    const int pre = kt + kStages - 1;
    if (pre < n_k) {
      float* as = smem + (pre % kStages) * kStageFloats;
      load(q, t, as, as + kTileFloats, k_begin + pre * kBK);
    }
    cp_async_commit();

    const float* as = smem + (kt % kStages) * kStageFloats;
    const float* bs = as + kTileFloats;
    if (do_db) db_add(bs, t, db_sum, db_lost);
#pragma unroll
    for (int i = 0; i < kBM / 8; ++i) {
      const int r = 8 * i + sr, c = t + 256 * i;
      const float a = kAK ? as[r * kLdK + sk] : as[sk * kLdMN + r];
      const float b = kBKmaj ? bs[r * kLdK + sk] : bs[sk * kLdMN + r];
      uint32_t big, small;
      split(a, big, small);
      halves[c] = __uint_as_float(big);
      halves[kSplitFloats + c] = __uint_as_float(small);
      split(b, big, small);
      halves[2 * kSplitFloats + c] = __uint_as_float(big);
      halves[3 * kSplitFloats + c] = __uint_as_float(small);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      // A: this warpgroup's 64 rows (core-matrix rows 8 wg .. 8 wg + 7);
      // B: all 128 columns; the k8 step is core-matrix columns 2 kk, 2 kk + 1
      const float* a0 = halves + (64 * wg + 2 * kk) * 32;
      const float* b0 = halves + 2 * kSplitFloats + (2 * kk) * 32;
      const uint64_t a_big = gmma_desc(a0, 128, 1024);
      const uint64_t a_small = gmma_desc(a0 + kSplitFloats, 128, 1024);
      const uint64_t b_big = gmma_desc(b0, 128, 1024);
      const uint64_t b_small = gmma_desc(b0 + kSplitFloats, 128, 1024);
      wgmma_tf32(part, a_small, b_big, kk > 0);
      wgmma_tf32(part, a_big, b_small, 1);
      wgmma_tf32(part, a_big, b_big, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      asm volatile("" : "+f"(part[i])::"memory");
      acc[i] += part[i];
    }
  }
  cp_async_wait<0>();

  if (do_db) db_store(q, smem, t, z, n0, db_sum);

  // epilogue: d[4 j + 2 h + e] is row 16 w4 + gid + 8 h, column 8 j + 2 tig + e
  int co0 = 0;
  if constexpr (M == kFwd) co0 = n0 - n0 / q.Co * q.Co;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + 64 * wg + 16 * w4 + gid + 8 * h;
    if (m >= rows) continue;
    float* dst = out_row<M>(q, m, n0, z, pixels);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * tig;
      float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      if constexpr (M == kFwd) {
        const float2 bb = *reinterpret_cast<const float2*>(q.bias + co0 + col);
        v.x += bb.x;
        v.y += bb.y;
      }
      *reinterpret_cast<float2*>(dst + col) = v;
    }
  }
}

// grid (N tiles, M tiles, splits): the N tiles of one M tile run together,
// so the A tile is read once from device memory and then from L2
template <int M>
inline cudaError_t launch(const Params& q, int splits, cudaStream_t stream) {
  const int n = M == kDgrad ? q.Ci : 4 * q.Co;
  const int rows = M == kWgrad ? q.Ci : q.B * q.H * q.W;
  cudaError_t err = allow_smem(gemm_kernel<M>, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(n / kBN, (rows + kBM - 1) / kBM, splits);
  gemm_kernel<M><<<grid, kThreads, kSmemBytes, stream>>>(q);
  return dnnca::launched(cudaGetLastError());
}

}  // namespace tgemm
}  // namespace dnnca
