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
//
// ln_quant's other modes are the LN prologues of the TPU ablation bench
// scripts/bench_block_layer.py:make_run (S1):
//   one   a single-pass variance E[x^2] - E[x]^2 (`lnvar`);
//   fold  inv folded into the affine: rint(n * (gamma * inv) + beta * inv) (`lnfold`);
//   cast  LN(x) truncated toward zero to int8, no inv (`noquant`), saturated.
#include <type_traits>

#include "common.cuh"

using namespace fitclip;

namespace {

constexpr int kWarps = 8;

enum LnMode : int { kTwo = 0, kOne = 1, kFold = 2, kCast = 3 };

template <typename T, typename OutT, int kMode>
__global__ void __launch_bounds__(kWarps * 32)
ln_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
          const float* __restrict__ beta, OutT* __restrict__ out,
          int rows, int width, float inv, float eps) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * width;

  float sum = 0.f, sq = 0.f;
  for (int i = lane; i < width; i += 32) {
    const float v = to_float(xr[i]);
    sum += v;
    if (kMode == kOne) sq += v * v;
  }
  const float mean = div(warp_sum(sum), static_cast<float>(width));

  float var;
  if (kMode == kOne) {
    var = sub(div(warp_sum(sq), static_cast<float>(width)), mul(mean, mean));
  } else {
    for (int i = lane; i < width; i += 32) {
      const float c = sub(to_float(xr[i]), mean);
      sq += c * c;
    }
    var = div(warp_sum(sq), static_cast<float>(width));
  }
  const float r = rsqrtf(add(var, eps));

  OutT* orow = out + static_cast<size_t>(row) * width;
  for (int i = lane; i < width; i += 32) {
    const float n = mul(sub(to_float(xr[i]), mean), r);
    if constexpr (std::is_same_v<OutT, int8_t>) {
      if (kMode == kFold) {
        orow[i] = quant_rint(add(mul(n, mul(gamma[i], inv)), mul(beta[i], inv)));
      } else if (kMode == kCast) {
        orow[i] = trunc_int8(add(mul(n, gamma[i]), beta[i]));
      } else {
        orow[i] = quant_rint(mul(add(mul(n, gamma[i]), beta[i]), inv));
      }
    } else {
      orow[i] = from_float<OutT>(add(mul(n, gamma[i]), beta[i]));
    }
  }
}

template <typename T, typename OutT, int kMode>
int launch(const void* x, const void* gamma, const void* beta, void* out, int rows, int width,
           float inv, float eps, cudaStream_t s) {
  const dim3 grid((rows + kWarps - 1) / kWarps);
  ln_kernel<T, OutT, kMode><<<grid, kWarps * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<OutT*>(out), rows, width, inv, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT, int kMode>
int dispatch_input(const void* x, int x_dtype, const void* gamma, const void* beta, void* out,
                   int rows, int width, float inv, float eps, cudaStream_t s) {
  if (x_dtype == kBFloat16) {
    return launch<__nv_bfloat16, OutT, kMode>(x, gamma, beta, out, rows, width, inv, eps, s);
  }
  if (x_dtype == kFloat32) {
    return launch<float, OutT, kMode>(x, gamma, beta, out, rows, width, inv, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// mode: kTwo (the shipped two-pass LN), or the S1 modes kOne, kFold, kCast.
extern "C" int fitclip_ln_quant(const void* x, int x_dtype, const void* gamma,
                                const void* beta, void* out, int rows, int width,
                                float inv, float eps, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kTwo: return dispatch_input<int8_t, kTwo>(x, x_dtype, gamma, beta, out, rows, width, inv, eps, s);
    case kOne: return dispatch_input<int8_t, kOne>(x, x_dtype, gamma, beta, out, rows, width, inv, eps, s);
    case kFold: return dispatch_input<int8_t, kFold>(x, x_dtype, gamma, beta, out, rows, width, inv, eps, s);
    case kCast: return dispatch_input<int8_t, kCast>(x, x_dtype, gamma, beta, out, rows, width, inv, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The LayerNorm's output rounded to bf16, K2's compute dtype.
extern "C" int fitclip_ln_cast(const void* x, int x_dtype, const void* gamma, const void* beta,
                               void* out, int rows, int width, float eps, void* stream) {
  return dispatch_input<__nv_bfloat16, kTwo>(x, x_dtype, gamma, beta, out, rows, width, 0.f, eps,
                                             static_cast<cudaStream_t>(stream));
}

extern "C" const char* fitclip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
