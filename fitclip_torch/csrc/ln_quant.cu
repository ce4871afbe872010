// ln_quant: row-wise fp32 LayerNorm, then clip(rint(y * inv), -127, 127) -> int8.
//
// Replaces the LN + static-quantize prologues of each half of the TPU layer
// kernel (fitclip_tpu/ops/block.py:_layer_kernel, via _ln and _quant). On the
// H100 it is bound by memory: it reads a row of W bf16 or fp32 values and
// writes W bytes. The simple design gives each row to one warp and reads it
// three times (mean, variance, normalize); the row (at most 4 KB) stays in L1
// between the passes, so device memory sees one read and one write.
#include "common.cuh"

using namespace fitclip;

namespace {

constexpr int kWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
ln_quant_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, int8_t* __restrict__ out,
                int rows, int width, float inv, float eps) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * width;

  float sum = 0.f;
  for (int i = lane; i < width; i += 32) sum += to_float(xr[i]);
  const float mean = div(warp_sum(sum), static_cast<float>(width));

  float sq = 0.f;
  for (int i = lane; i < width; i += 32) {
    const float c = sub(to_float(xr[i]), mean);
    sq += c * c;
  }
  const float var = div(warp_sum(sq), static_cast<float>(width));
  const float r = rsqrtf(add(var, eps));

  int8_t* orow = out + static_cast<size_t>(row) * width;
  for (int i = lane; i < width; i += 32) {
    const float y = add(mul(mul(sub(to_float(xr[i]), mean), r), gamma[i]), beta[i]);
    orow[i] = quant_rint(mul(y, inv));
  }
}

}  // namespace

extern "C" int fitclip_ln_quant(const void* x, int x_dtype, const void* gamma,
                                const void* beta, void* out, int rows, int width,
                                float inv, float eps, void* stream) {
  const dim3 grid((rows + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kBFloat16) {
    ln_quant_kernel<__nv_bfloat16><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<int8_t*>(out), rows, width, inv, eps);
  } else if (x_dtype == kFloat32) {
    ln_quant_kernel<float><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<int8_t*>(out), rows, width, inv, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fitclip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
