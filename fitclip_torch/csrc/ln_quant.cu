// ln_quant and ln_cast: row-wise fp32 LayerNorm, then
//   ln_quant  clip(rint(y * inv), -127, 127) -> int8 (the int8 layer, K1), or
//   ln_cast   y rounded to bf16, the float layer's compute dtype (K2).
//
// Replaces the LN prologues of each half of the TPU layer kernels
// (fitclip_tpu/ops/block.py:_layer_kernel via _ln and _quant, and
// _bf16_layer_kernel via _ln and the dense's h.astype(x.dtype)). On the H100 it is
// bound by memory: it reads a row of W bf16 or fp32 values and writes W bytes
// (int8) or W bf16 values. The simple design gives each row to one warp and reads it
// three times (mean, variance, normalize); the row (at most 4 KB) stays in L1
// between the passes, so device memory sees one read and one write.
#include <type_traits>

#include "common.cuh"

using namespace fitclip;

namespace {

constexpr int kWarps = 8;

template <typename T, typename OutT>
__global__ void __launch_bounds__(kWarps * 32)
ln_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
          const float* __restrict__ beta, OutT* __restrict__ out,
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

  OutT* orow = out + static_cast<size_t>(row) * width;
  for (int i = lane; i < width; i += 32) {
    const float y = add(mul(mul(sub(to_float(xr[i]), mean), r), gamma[i]), beta[i]);
    if constexpr (std::is_same_v<OutT, int8_t>) {
      orow[i] = quant_rint(mul(y, inv));
    } else {
      orow[i] = from_float<OutT>(y);
    }
  }
}

template <typename T, typename OutT>
int launch(const void* x, const void* gamma, const void* beta, void* out, int rows, int width,
           float inv, float eps, cudaStream_t s) {
  const dim3 grid((rows + kWarps - 1) / kWarps);
  ln_kernel<T, OutT><<<grid, kWarps * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<OutT*>(out), rows, width, inv, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int dispatch_input(const void* x, int x_dtype, const void* gamma, const void* beta, void* out,
                   int rows, int width, float inv, float eps, cudaStream_t s) {
  if (x_dtype == kBFloat16) {
    return launch<__nv_bfloat16, OutT>(x, gamma, beta, out, rows, width, inv, eps, s);
  }
  if (x_dtype == kFloat32) return launch<float, OutT>(x, gamma, beta, out, rows, width, inv, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int fitclip_ln_quant(const void* x, int x_dtype, const void* gamma,
                                const void* beta, void* out, int rows, int width,
                                float inv, float eps, void* stream) {
  return dispatch_input<int8_t>(x, x_dtype, gamma, beta, out, rows, width, inv, eps,
                                static_cast<cudaStream_t>(stream));
}

// The LayerNorm's output rounded to bf16, K2's compute dtype.
extern "C" int fitclip_ln_cast(const void* x, int x_dtype, const void* gamma, const void* beta,
                               void* out, int rows, int width, float eps, void* stream) {
  return dispatch_input<__nv_bfloat16>(x, x_dtype, gamma, beta, out, rows, width, 0.f, eps,
                                       static_cast<cudaStream_t>(stream));
}

extern "C" const char* fitclip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
