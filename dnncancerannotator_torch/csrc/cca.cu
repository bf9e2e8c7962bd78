// Raw 4-connected component labels of a batch of masks: [N, H, W] uint8
// (0 = background) -> [N, H, W] int32, each mask pixel holding the minimum
// row-major index r * W + c of its component within its plane, and every
// background pixel H * W.
//
// Replaces cca_kernel.cca_raw_labels_pallas
// (dnncancerannotator_tpu/ops/pallas/cca_kernel.py:105), which iterates
// row and column run-min sweeps to a fixed point, each sweep a doubling-shift
// segmented scan over a whole plane in VMEM, with a "changed" flag read
// after every sweep. Here the labels are a union-find forest (label
// equivalence in the style of Playne and Hawick), built in three steps with
// no host round trip:
//
//   1. runs: each mask pixel points at the first pixel of its horizontal
//      run, the run start at itself (the global route: a warp a row, a
//      ballot over 32 columns at a time, the run start carried from chunk
//      to chunk).
//   2. merge: every mask pixel whose upper neighbour is a mask pixel, and
//      that starts such a vertical contact (its left neighbour and the left
//      neighbour's upper neighbour are not both mask pixels), unites the two
//      trees: the larger root is hooked under the smaller with an atomic
//      min, retried until a hook lands on a live root or the roots agree.
//   3. flatten: every mask pixel follows its pointers to the root.
//
// A pointer never exceeds the index it is stored at and always names a pixel
// of the same component, so each component's minimum index stays a root and
// the only one, whatever order the atomics take: the result is the Pallas
// fixed point bit for bit. That holds on both routes below.
//
// What bounds it on the H100: device-memory bytes, 1 read and 4 written a
// pixel, and on a plane in shared memory the instructions issued a pixel.
// The evaluate path's region metrics label chunks of 20 images x 100
// thresholds, [2000, 128, 128] planes a call (metrics/region.py:
// PIXEL_BUDGET), 164 MB: 0.049 ms at 3.35 TB/s. Two routes, chosen by the
// wrapper by plane size and count (ops/kernels/cca.py: route):
//
// - shared: one block of 1024 threads a plane, the whole forest in shared
//   memory (32-bit labels up to 32768 pixels, 68 KB at 128 x 128, with a
//   native atomicMin; 16-bit labels up to 65536 pixels, 144 KB at 256 x 256,
//   the atomic min a CAS on the label's 32-bit word). The block loads its
//   plane's mask once (16-byte loads where the plane is 16-byte aligned)
//   into a bitmask and writes the int32 labels once, coalesced: device
//   traffic is the bound's 5 bytes a pixel. In between it works on 32-pixel
//   words with bit operations, and the forest holds only the run starts:
//   a word's run starts and its vertical-contact starts are a few shifts
//   and masks, the runs step writes one node a run, the merge unites the
//   runs of each contact start, the flatten walks one chain a run, and the
//   output reads a pixel's label at its run start (the last set bit at or
//   before it in a second bitmask). A first design that labelled every
//   pixel took over three times as long at [2000, 128, 128].
// - global: the forest in device memory, one launch per step (runs, merge,
//   flatten as above, a pixel a thread); the merge and flatten walk pointer
//   chains through L2, three full passes over the labels. It spreads a few
//   large planes over the whole card, where one block a plane would leave
//   it idle.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Reads through L2, which the atomics update; L1 is not coherent with them.
__device__ __forceinline__ int load_label(const int* L, int i) {
  return __ldcg(L + i);
}

__device__ __forceinline__ int find_root(const int* L, int i) {
  int next = load_label(L, i);
  while (next != i) {
    i = next;
    next = load_label(L, i);
  }
  return i;
}

__device__ void unite(int* L, int a, int b) {
  while (true) {
    a = find_root(L, a);
    b = find_root(L, b);
    if (a == b) return;
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    // hook the larger root a under b; if a stopped being a root meanwhile,
    // atomicMin still only lowers its pointer within the component, and the
    // loop goes on from what a pointed at
    const int old = atomicMin(L + a, b);
    if (old == a) return;
    a = old;
  }
}

__global__ void __launch_bounds__(kThreads)
runs_kernel(const unsigned char* __restrict__ masks, int* __restrict__ L,
            long long rows, int H, int W) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps +
                        threadIdx.x / 32;
  if (row >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x % 32;
  const int hw = H * W;
  const int r = static_cast<int>(row % H);
  const size_t base = static_cast<size_t>(row) * W;
  int carry = -1;  // run start carried in from the previous chunk, or -1
  for (int c0 = 0; c0 < W; c0 += 32) {
    const int c = c0 + lane;
    const bool m = c < W && masks[base + c] != 0;
    const unsigned bits = __ballot_sync(0xffffffffu, m);
    // background lanes below this one; the run starts after the highest
    const unsigned below = ~bits & ((1u << lane) - 1u);
    int start;
    if (below != 0) {
      start = c0 + (31 - __clz(below)) + 1;
    } else {
      start = carry >= 0 ? carry : c0;
    }
    if (c < W) L[base + c] = m ? r * W + start : hw;
    const int last = __shfl_sync(0xffffffffu, start, 31);
    carry = (bits >> 31) & 1u ? last : -1;
  }
}

__global__ void __launch_bounds__(kThreads)
merge_kernel(const unsigned char* __restrict__ masks, int* __restrict__ L,
             long long n_pixels, int H, int W) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  if (idx >= n_pixels) return;
  const long long hw = static_cast<long long>(H) * W;
  const int p = static_cast<int>(idx % hw);
  const int r = p / W;
  const int c = p % W;
  if (r == 0 || !masks[idx] || !masks[idx - W]) return;
  if (c > 0 && masks[idx - 1] && masks[idx - 1 - W]) return;  // same contact
  unite(L + (idx - p), p, p - W);
}

__global__ void __launch_bounds__(kThreads)
flatten_kernel(const unsigned char* __restrict__ masks, int* __restrict__ L,
               long long n_pixels, int H, int W) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  if (idx >= n_pixels || !masks[idx]) return;
  const long long hw = static_cast<long long>(H) * W;
  const int p = static_cast<int>(idx % hw);
  int* plane = L + (idx - p);
  // other threads may already have pointed their pixels at final roots,
  // which only shortens this walk
  plane[p] = find_root(plane, p);
}

// -- the shared route: one block a plane -----------------------------------

constexpr int kPlaneMax = 65536;  // 16-bit indices
// threads a block: 1024 measured within 2% of 512 at [2000, 128, 128] and
// faster on fewer or larger planes (one block a plane leaves the SM's
// latency to its own warps)
constexpr int kSharedThreads = 1024;

// Shared memory of one plane: two bitmasks (the mask, the run starts) in
// whole 16-byte rows, then the labels of LB bytes, rounded up to 16 bytes
// (the CAS word of the last 16-bit label stays inside).
__host__ __device__ inline int shared_bytes(int hw, int lb) {
  return 2 * 16 * ((hw + 127) / 128) + 16 * ((lb * hw + 15) / 16);
}

// 4 bits, one a byte of v: set where the byte is not 0
__device__ __forceinline__ unsigned nonzero_bytes(unsigned v) {
  const unsigned m = __vcmpne4(v, 0u);
  return ((m >> 7) & 1u) | ((m >> 14) & 2u) | ((m >> 21) & 4u) |
         ((m >> 28) & 8u);
}

// Bits of pixels q .. q + 31 (pixels before 0 read as background).
__device__ __forceinline__ unsigned word_at(const unsigned* bits, int q) {
  if (q <= -32) return 0u;
  if (q < 0) return bits[0] << -q;
  const int w = q >> 5, sh = q & 31;
  return sh == 0 ? bits[w] : __funnelshift_r(bits[w], bits[w + 1], sh);
}

// Bits of the pixels base .. base + 31 that start a row.
__device__ __forceinline__ unsigned row_starts(int base, int W) {
  unsigned r = 0u;
  for (int q = (base + W - 1) / W * W; q < base + 32; q += W)
    r |= 1u << (q - base);
  return r;
}

// The first pixel of the run of mask pixel p: the last run start at or
// before p.
__device__ __forceinline__ int run_of(const unsigned* starts, int p) {
  int w = p >> 5;
  unsigned v = starts[w] & (0xffffffffu >> (31 - (p & 31)));
  while (v == 0u) v = starts[--w];
  return (w << 5) + 31 - __clz(v);
}

// atomicMin of a label, returning its old value: native for 32-bit labels;
// for 16-bit ones a CAS loop on the label's 32-bit word (the other half may
// change under it: then the CAS fails and the loop reads again)
__device__ __forceinline__ int atomic_min_label(int* lab, int v) {
  return atomicMin(lab, v);
}

__device__ __forceinline__ int atomic_min_label(unsigned short* lab, int v) {
  unsigned* word = reinterpret_cast<unsigned*>(
      reinterpret_cast<std::uintptr_t>(lab) & ~std::uintptr_t{3});
  const int shift =
      (reinterpret_cast<std::uintptr_t>(lab) & 2u) ? 16 : 0;
  unsigned old = *reinterpret_cast<volatile unsigned*>(word);
  while (true) {
    const int cur = static_cast<int>((old >> shift) & 0xffffu);
    if (cur <= v) return cur;
    const unsigned next =
        (old & ~(0xffffu << shift)) | (static_cast<unsigned>(v) << shift);
    const unsigned seen = atomicCAS(word, old, next);
    if (seen == old) return cur;
    old = seen;
  }
}

template <typename L>
__device__ __forceinline__ int find_root_s(const volatile L* lab, int i) {
  int next = lab[i];
  while (next != i) {
    i = next;
    next = lab[i];
  }
  return i;
}

// The root of i, pointing every node of the walk at its grandparent on the
// way (path splitting). Such a pointer still names an earlier run start of
// the same component, so the invariant above holds; a store that lands over
// a concurrent hook undoes only that shortcut, and the hooking thread goes
// on from what it replaced (unite_s). Only while the forest is being
// merged: a shortcut stored over a root that flatten wrote meanwhile would
// stay.
template <typename L>
__device__ __forceinline__ int find_split(volatile L* lab, int i) {
  int next = lab[i];
  while (next != i) {
    const int after = lab[next];
    if (after != next) lab[i] = static_cast<L>(after);
    i = next;
    next = after;
  }
  return i;
}

template <typename L>
__device__ void unite_s(L* lab, int a, int b) {
  volatile L* V = lab;
  while (true) {
    a = find_split(V, a);
    b = find_split(V, b);
    if (a == b) return;
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    // as unite: a hook that misses a live root only lowers a's pointer
    // within the component, and the loop goes on from what a pointed at
    const int old = atomic_min_label(lab + a, b);
    if (old == a) return;
    a = old;
  }
}

// The forest holds only the run starts: a run's pixels share its label, so
// the runs step writes one node a run, the merge unites the runs of each
// vertical contact's first pixel, the flatten walks one chain a run, and
// the output reads each pixel's label at its run start (run_of). The first
// three steps work on 32-pixel words of the bitmasks, with bit operations.
template <typename L>
__global__ void __launch_bounds__(kSharedThreads)
shared_kernel(const unsigned char* __restrict__ masks, int* __restrict__ out,
              int H, int W) {
  extern __shared__ uint4 smem_rows[];
  const int hw = H * W, nw = (hw + 31) / 32;
  unsigned* bits = reinterpret_cast<unsigned*>(smem_rows);
  unsigned* starts = bits + 4 * ((hw + 127) / 128);
  L* lab = reinterpret_cast<L*>(starts + 4 * ((hw + 127) / 128));
  const int tid = threadIdx.x, lane = tid & 31;
  const unsigned char* src = masks + static_cast<size_t>(blockIdx.x) * hw;
  int* dst = out + static_cast<size_t>(blockIdx.x) * hw;

  // 1. the mask into the bitmask: bit p of word p / 32 is pixel p, and the
  // bits past the plane are 0
  if ((hw & 15) == 0 &&
      (reinterpret_cast<std::uintptr_t>(src) & 15) == 0) {
    // a lane a 16-byte chunk; lane pairs fill one word (every trip is taken
    // by every lane, so the shuffle sees the whole warp)
    const int n16 = hw / 16;
    for (int base = 0; base < n16; base += kSharedThreads) {
      const int t = base + tid;
      unsigned v = 0;
      if (t < n16) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(src) + t);
        v = nonzero_bytes(q.x) | (nonzero_bytes(q.y) << 4) |
            (nonzero_bytes(q.z) << 8) | (nonzero_bytes(q.w) << 12);
      }
      const unsigned hi = __shfl_down_sync(0xffffffffu, v, 1);
      if ((lane & 1) == 0 && t < n16) bits[t >> 1] = v | (hi << 16);
    }
  } else {
    // a lane a byte, a warp ballot a word (base is a multiple of 32)
    for (int base = 0; base < hw; base += kSharedThreads) {
      const int p = base + tid;
      const unsigned word =
          __ballot_sync(0xffffffffu, p < hw && src[p] != 0);
      if (lane == 0 && p < hw) bits[p >> 5] = word;
    }
  }
  __syncthreads();

  // 2. runs: the run starts are the mask pixels whose left neighbour in the
  // row is background; each points at itself
  for (int w = tid; w < nw; w += kSharedThreads) {
    const int base = w << 5;
    const unsigned m = bits[w];
    const unsigned left = (m << 1) | (w > 0 ? bits[w - 1] >> 31 : 0u);
    const unsigned st = m & ~(left & ~row_starts(base, W));
    starts[w] = st;
    for (unsigned v = st; v != 0u; v &= v - 1u) {
      const int p = base + __ffs(v) - 1;
      lab[p] = static_cast<L>(p);
    }
  }
  __syncthreads();

  // 3. merge: the vertical contacts are the mask pixels over a mask pixel;
  // the first of each horizontal stretch of them unites its run with the
  // run above, as merge_kernel
  for (int w = tid; w < nw; w += kSharedThreads) {
    const int base = w << 5;
    const unsigned c = bits[w] & word_at(bits, base - W);
    if (c == 0u) continue;
    const unsigned prev = base > 0 && base - 1 >= W
                              ? (word_at(bits, base - 1) &
                                 word_at(bits, base - 1 - W) & 1u)
                              : 0u;
    const unsigned cs = c & ~(((c << 1) | prev) & ~row_starts(base, W));
    for (unsigned v = cs; v != 0u; v &= v - 1u) {
      const int p = base + __ffs(v) - 1;
      unite_s(lab, run_of(starts, p), run_of(starts, p - W));
    }
  }
  __syncthreads();

  // 4. flatten: each run start takes its root (a thread writes only its
  // own run starts; a root written in place only shortens others' walks)
  {
    volatile L* V = lab;
    for (int w = tid; w < nw; w += kSharedThreads)
      for (unsigned v = starts[w]; v != 0u; v &= v - 1u) {
        const int p = (w << 5) + __ffs(v) - 1;
        V[p] = static_cast<L>(find_root_s(V, p));
      }
  }
  __syncthreads();

  // 5. the int32 labels, once: a mask pixel takes its run start's label;
  // 16-byte stores where the plane allows them
  if ((hw & 3) == 0 && (reinterpret_cast<std::uintptr_t>(dst) & 15) == 0) {
    for (int q = tid; q < hw / 4; q += kSharedThreads) {
      const int p = 4 * q;
      const unsigned m4 = bits[p >> 5] >> (p & 31);
      int4 v = make_int4(hw, hw, hw, hw);
      if (m4 & 1u) v.x = lab[run_of(starts, p)];
      if (m4 & 2u) v.y = lab[run_of(starts, p + 1)];
      if (m4 & 4u) v.z = lab[run_of(starts, p + 2)];
      if (m4 & 8u) v.w = lab[run_of(starts, p + 3)];
      reinterpret_cast<int4*>(dst)[q] = v;
    }
  } else {
    for (int p = tid; p < hw; p += kSharedThreads)
      dst[p] = (bits[p >> 5] >> (p & 31)) & 1u
                   ? static_cast<int>(lab[run_of(starts, p)])
                   : hw;
  }
}

unsigned blocks_for(long long n, int per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

template <typename L>
cudaError_t launch_shared(const unsigned char* masks, int* labels, int N,
                          int H, int W, cudaStream_t s) {
  const int bytes = shared_bytes(H * W, sizeof(L));
  cudaError_t err = dnnca::allow_smem(shared_kernel<L>, bytes);
  if (err != cudaSuccess) return err;
  shared_kernel<L><<<N, kSharedThreads, bytes, s>>>(masks, labels, H, W);
  return dnnca::launched(cudaGetLastError());
}

}  // namespace

// shared: 0 for the global route's three launches, 1 for the shared route
// (one block a plane; H * W <= 65536) with labels of label_bytes (4, or 2
// for 16-bit indices).
extern "C" int dnnca_cca(const unsigned char* masks, int* labels, int N,
                         int H, int W, int shared, int label_bytes,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shared) {
    if (static_cast<long long>(H) * W > kPlaneMax) return cudaErrorInvalidValue;
    if (label_bytes == 4)
      return launch_shared<int>(masks, labels, N, H, W, s);
    if (label_bytes == 2)
      return launch_shared<unsigned short>(masks, labels, N, H, W, s);
    return cudaErrorInvalidValue;
  }
  const long long rows = static_cast<long long>(N) * H;
  const long long n = rows * W;
  runs_kernel<<<blocks_for(rows, kWarps), kThreads, 0, s>>>(masks, labels,
                                                            rows, H, W);
  if ((err = dnnca::launched(cudaGetLastError())) != cudaSuccess) return err;
  merge_kernel<<<blocks_for(n, kThreads), kThreads, 0, s>>>(masks, labels, n,
                                                            H, W);
  if ((err = dnnca::launched(cudaGetLastError())) != cudaSuccess) return err;
  flatten_kernel<<<blocks_for(n, kThreads), kThreads, 0, s>>>(masks, labels,
                                                              n, H, W);
  return dnnca::launched(cudaGetLastError());
}
