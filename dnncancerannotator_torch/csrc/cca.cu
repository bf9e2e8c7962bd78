// Raw 4-connected component labels of a batch of masks: [N, H, W] uint8
// (0 = background) -> [N, H, W] int32, each mask pixel holding the minimum
// row-major index r * W + c of its component within its plane, and every
// background pixel H * W.
//
// Replaces cca_kernel.cca_raw_labels_pallas
// (dnncancerannotator_tpu/ops/pallas/cca_kernel.py:105), which iterates
// row and column run-min sweeps to a fixed point, each sweep a doubling-shift
// segmented scan over a whole plane in VMEM, with a "changed" flag read
// after every sweep. Here the labels are a union-find forest in device
// memory (label equivalence in the style of Playne and Hawick), in three
// launches with no host round trip and no limit on the plane size:
//
//   1. runs: one warp per row. Each mask pixel points at the first pixel of
//      its horizontal run (a ballot over 32 columns at a time, the run start
//      carried from chunk to chunk), the run start at itself; background
//      gets H * W.
//   2. merge: every mask pixel whose upper neighbour is a mask pixel, and
//      that starts such a vertical contact (its left neighbour and the left
//      neighbour's upper neighbour are not both mask pixels), unites the two
//      trees: the larger root is hooked under the smaller with atomicMin,
//      retried until a hook lands on a live root or the roots agree.
//   3. flatten: every mask pixel follows its pointers to the root.
//
// A pointer never exceeds the index it is stored at and always names a pixel
// of the same component, so each component's minimum index stays a root and
// the only one, whatever order the atomics take: the result is the Pallas
// fixed point bit for bit.
//
// What bounds it on the H100: memory traffic. The runs pass reads 1 byte and
// writes 4 bytes a pixel; the merge reads the mask and two labels a pixel
// and walks short pointer chains (mostly in L2); the flatten reads and writes
// 4 bytes a pixel plus the chain. A plane of 128 x 128 is 64 KB of labels,
// so the evaluation batches (up to 6,400 such planes) stream through L2.
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

unsigned blocks_for(long long n, int per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

}  // namespace

extern "C" int dnnca_cca(const unsigned char* masks, int* labels, int N,
                         int H, int W, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(N) * H;
  const long long n = rows * W;
  runs_kernel<<<blocks_for(rows, kWarps), kThreads, 0, s>>>(masks, labels,
                                                            rows, H, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  merge_kernel<<<blocks_for(n, kThreads), kThreads, 0, s>>>(masks, labels, n,
                                                            H, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flatten_kernel<<<blocks_for(n, kThreads), kThreads, 0, s>>>(masks, labels,
                                                              n, H, W);
  return cudaGetLastError();
}
