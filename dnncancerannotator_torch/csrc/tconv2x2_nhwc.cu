// ConvTranspose with kernel 2, stride 2, plus bias, NHWC f32:
//   out[b, 2y+dy, 2x+dx, co] = bias[co] + sum_ci x[b, y, x, ci] * w[ci, co, dy, dx]
//
// Replaces tconv_kernel.conv_transpose2x2_nhwc
// (dnncancerannotator_tpu/ops/pallas/tconv_kernel.py:161, forward
// _fwd_kernel :58), which runs one MXU dot per row phase against a
// lane-packed weight and places the phases by reshape and BlockSpec rows.
// Here the whole op is one GEMM [B*H*W, Ci] x [Ci, 4*Co] on the tensor cores
// in 3xTF32 (tconv_gemm.cuh) whose epilogue adds the bias and stores each
// phase's channels at out[b, 2y+dy, 2x+dx, :], contiguous along Co: the
// interleave is the store address, with no copy. The weight is PyTorch's
// [Ci, Co, 2, 2], applied unflipped (convert.py flips the flax kernel once);
// the caller packs it once to wpt[(2*dy + dx)*Co + co][ci], the layout the
// backward's dgrad reads too. Ci % 128 == 0 and Co % 128 == 0.
//
// What bounds it on the H100: 2 * Ci FLOPs per output element, 4.3 to 8.6
// GFLOP at the unet_big decoder sites (B=8) against 25 to 42 MB, so
// arithmetic: 64-128 us on f32 FMAs, 26-52 us on the tensor cores in
// 3xTF32 (3 TF32 products a product at 495 TFLOP/s). See tconv_gemm.cuh.
#include "tconv_gemm.cuh"

extern "C" int dnnca_tconv2x2_nhwc(const float* x, const float* wpt,
                                   const float* bias, float* out, int B, int H,
                                   int W, int Ci, int Co, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  dnnca::tgemm::Params q{x, wpt, bias, out, nullptr, B, H, W, Ci, Co, 0};
  return dnnca::tgemm::launch<dnnca::tgemm::kFwd>(
      q, 1, static_cast<cudaStream_t>(stream));
}
