// Error text for the codes the kernel entry points return.
#include "common.cuh"

extern "C" const char* dnnca_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
