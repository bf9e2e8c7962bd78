// Shared helpers for the port's hand-written Hopper kernels.
//
// Every entry point has a plain C interface (raw pointers, ints, the
// stream), launches on the caller's stream, never synchronises and
// returns cudaGetLastError() so that a refused launch (too much shared
// memory, a bad grid) is reported to the Python wrapper, which raises.
// Every launch site passes that error through ``launched``, which counts
// the launches the card accepted (``dnnca_launches`` reads the count, so
// a caller counts a call's kernels without a profiler).
#pragma once

#include <cuda_runtime.h>

namespace dnnca {

// Dynamic shared memory one block may use on sm_90 (227 KB).
constexpr int kMaxDynamicSmemBytes = 232448;

// Launches with more than 48 KB of dynamic shared memory must raise the
// kernel's limit first; without it the launch is refused.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Adds one to the library's launch count when ``err`` is cudaSuccess;
// returns ``err``.
cudaError_t launched(cudaError_t err);

}  // namespace dnnca
