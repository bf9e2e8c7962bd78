// Error text for the codes the kernel entry points return, and the count
// of kernel launches the card accepted.
#include <atomic>

#include "common.cuh"

namespace {
std::atomic<long long> g_launches{0};
}  // namespace

namespace dnnca {
cudaError_t launched(cudaError_t err) {
  if (err == cudaSuccess) g_launches.fetch_add(1, std::memory_order_relaxed);
  return err;
}
}  // namespace dnnca

extern "C" long long dnnca_launches() {
  return g_launches.load(std::memory_order_relaxed);
}

extern "C" const char* dnnca_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
