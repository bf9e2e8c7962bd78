// Tile helpers shared by the conv chain's forward and backward kernels
// (conv_chain.cu, conv_chain_bwd.cu); ``tap`` also serves wgrad.cu,
// stencil_conv_bwd.cu and tconv2x2_bwd.cu.
//
// A block computes a stride-1 "same" conv over a 2D tile from an input tile
// staged in shared memory. Register blocking: one work item is a run of PX
// consecutive pixels along a row for CPT output channels, so a thread keeps
// PX x CPT sums. Per (input channel, kernel row) it loads the run's window
// of PX + K - 1 inputs once, as float4s, and reuses it across the K
// horizontal taps; each weight load (a float4 broadcast: every lane of a
// warp reads the same weights) feeds all PX pixels. CPT is the exact
// channel count of a group (3, 6 or 12 at the model's sites), so no FMA
// multiplies padding there; generic widths take CPT = 4 or 8 and pad the
// last group with zero weights.
//
// Weights sit in shared memory as [in channel][tap][groups * pad4(CPT)]:
// output o is slot (o / CPT) * pad4(CPT) + o % CPT, so a group's weights of
// one tap are pad4(CPT) / 4 aligned float4s.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace dnnca {
namespace tile {

// pixels a work item computes along a row for CPT channels
__host__ __device__ constexpr int run_px(int cpt) { return cpt <= 4 ? 8 : 4; }
__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }

// 4-byte asynchronous copy from device memory into shared memory; when
// ``valid`` is false nothing is read and the word is zero-filled.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

// 8-byte form of cp_async4: dst and src 8-byte aligned.
__device__ __forceinline__ void cp_async8(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Stage a K x K weight as [n_in][KK][groups * pad4(cpt)], zero in the
// padding slots, with cp.async (no thread waits on a load here; the caller
// waits before its barrier). FLIP = false: w is [n_out][n_in][KK] (OIHW),
// staged as it is. FLIP = true: w is [n_in][n_out][KK], the OIHW weight of
// the conv that runs the other way; it is staged transposed and spatially
// flipped, so a "same" conv with it is that conv's data gradient.
template <bool FLIP>
__device__ void stage_weights(float* dst, const float* w, int n_out,
                              int n_in, int KK, int cpt, int groups) {
  const int cp = pad4(cpt), row = groups * cp, n = n_in * KK * row;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int s = i % row, t = (i / row) % KK, c = i / (row * KK);
    const int r = s % cp, o = s / cp * cpt + r;
    const bool ok = r < cpt && o < n_out;
    cp_async4(dst + i,
              ok ? w + (FLIP ? (c * n_out + o) * KK + (KK - 1 - t)
                             : (o * n_in + c) * KK + t)
                 : w,
              ok);
  }
}

// The bias of n_out outputs into ``groups`` slots of pad4(cpt), zero in
// the padding, with cp.async.
__device__ __forceinline__ void stage_bias(float* dst, const float* b,
                                           int n_out, int cpt, int groups) {
  const int cp = pad4(cpt);
  for (int i = threadIdx.x; i < groups * cp; i += blockDim.x) {
    const int o = i / cp * cpt + i % cp;
    const bool ok = i % cp < cpt && o < n_out;
    cp_async4(dst + i, ok ? b + o : b, ok);
  }
}


// Copy the window rows [y0, y0 + rows) x cols [x0, x0 + cols) of n_ch
// planes of an NCHW image (src: [n_ch][H][W]) into dst
// ([n_ch][rows][row_w]) with cp.async, zero outside the image. One warp a
// row, one lane a column pair (8-byte copies) where W, x0 and cols are even
// (every pair then lies wholly inside or outside the image), else one lane
// a column; no division per element.
__device__ __forceinline__ void stage_window(float* dst, const float* src,
                                             int n_ch, int rows, int cols,
                                             int row_w, int y0, int x0,
                                             int H, int W) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const bool pairs = ((W | x0 | cols) & 1) == 0;
  for (int pr = threadIdx.x >> 5; pr < n_ch * rows; pr += nw) {
    const int c = pr / rows, gy = y0 + pr - c * rows;
    const bool row_ok = gy >= 0 && gy < H;
    const float* srow =
        src + (static_cast<size_t>(c) * H + (row_ok ? gy : 0)) * W;
    float* drow = dst + static_cast<size_t>(pr) * row_w;
    if (pairs) {
      for (int col = 2 * lane; col < cols; col += 64) {
        const int gx = x0 + col;
        const bool ok = row_ok && gx >= 0 && gx < W;
        cp_async8(drow + col, ok ? srow + gx : src, ok);
      }
    } else {
      for (int col = lane; col < cols; col += 32) {
        const int gx = x0 + col;
        const bool ok = row_ok && gx >= 0 && gx < W;
        cp_async4(drow + col, ok ? srow + gx : src, ok);
      }
    }
  }
}

// acc[j][o] += sum over c < n_in, ky, kx of
//   src[c * plane + ky * row_w + j + kx]
//     * w[(c * KK + ky * K + kx) * w_row + o]
// for the PX = run_px(CPT) pixels j of one run. src and w are 16-byte
// aligned (row_w and plane multiples of 4, the run's start a multiple of 4,
// w_row a multiple of 4). KT > 0 unrolls a KT x KT stencil and reads each
// window row as float4s (up to 3 floats past the window: the callers'
// rows leave room); KT = 0 runs K x K with runtime loops and scalar loads.
template <int CPT, int KT>
__device__ __forceinline__ void conv_run(float (&acc)[run_px(CPT)][CPT],
                                         const float* src, int plane,
                                         int row_w, const float* w,
                                         int w_row, int n_in, int K) {
  constexpr int PX = run_px(CPT);
  constexpr int NQ = (CPT + 3) / 4;
  if constexpr (KT > 0) {
    constexpr int NW = (PX + KT - 1 + 3) / 4;
    for (int c = 0; c < n_in; ++c) {
#pragma unroll
      for (int ky = 0; ky < KT; ++ky) {
        float win[NW * 4];
        const float4* s4 = reinterpret_cast<const float4*>(
            src + c * plane + ky * row_w);
#pragma unroll
        for (int q = 0; q < NW; ++q) {
          const float4 v = s4[q];
          win[4 * q] = v.x;
          win[4 * q + 1] = v.y;
          win[4 * q + 2] = v.z;
          win[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int kx = 0; kx < KT; ++kx) {
          const float4* w4 = reinterpret_cast<const float4*>(
              w + ((c * KT + ky) * KT + kx) * w_row);
          float wv[NQ * 4];
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            const float4 t = w4[q];
            wv[4 * q] = t.x;
            wv[4 * q + 1] = t.y;
            wv[4 * q + 2] = t.z;
            wv[4 * q + 3] = t.w;
          }
#pragma unroll
          for (int o = 0; o < CPT; ++o)
#pragma unroll
            for (int j = 0; j < PX; ++j)
              acc[j][o] = fmaf(win[j + kx], wv[o], acc[j][o]);
        }
      }
    }
  } else {
    const int KK = K * K;
    for (int c = 0; c < n_in; ++c) {
      for (int t = 0; t < KK; ++t) {
        const float* s = src + c * plane + (t / K) * row_w + t % K;
        const float4* w4 =
            reinterpret_cast<const float4*>(w + (c * KK + t) * w_row);
        float wv[NQ * 4];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float4 v = w4[q];
          wv[4 * q] = v.x;
          wv[4 * q + 1] = v.y;
          wv[4 * q + 2] = v.z;
          wv[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < PX; ++j) {
          const float v = s[j];
#pragma unroll
          for (int o = 0; o < CPT; ++o) acc[j][o] = fmaf(v, wv[o], acc[j][o]);
        }
      }
    }
  }
}

// Write PX values of one channel at dst (a pixel of an NCHW plane):
// float4 stores when the whole run lies inside the row and dst is aligned,
// else the first n_valid values one by one.
template <int PX>
__device__ __forceinline__ void store_run(float* dst, const float (&v)[PX],
                                          int n_valid) {
  if (n_valid >= PX && (reinterpret_cast<std::uintptr_t>(dst) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < PX / 4; ++q)
      reinterpret_cast<float4*>(dst)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < PX; ++j)
      if (j < n_valid) dst[j] = v[j];
  }
}

// acc[o] += v * w[o] for the C weights of one (input channel, tap); the
// one-pixel form of the older kernels.
template <int C>
__device__ __forceinline__ void tap(float (&acc)[C], float v,
                                    const float4* w) {
#pragma unroll
  for (int q = 0; q < C / 4; ++q) {
    const float4 wq = w[q];
    acc[4 * q + 0] = fmaf(v, wq.x, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(v, wq.y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(v, wq.z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(v, wq.w, acc[4 * q + 3]);
  }
}

}  // namespace tile
}  // namespace dnnca
