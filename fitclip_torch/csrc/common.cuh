// Shared device helpers for the fitclip_torch kernels.
//
// The kernels are held bit for bit against plain PyTorch versions wherever
// the arithmetic allows it, so the element-wise steps use explicitly rounded
// intrinsics: nvcc would otherwise contract a*b+c into one fma, while PyTorch
// rounds after every operation. Dot products and reductions are free to use
// fma: their summation order differs from PyTorch's anyway.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fitclip {

// dtype codes shared with the Python wrappers (fitclip_torch/_build.py).
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// clip(rint(v), -127, 127) as int8. rintf rounds half to even, like
// torch.round and jnp.round; roundf would round half away from zero.
__device__ __forceinline__ int8_t quant_rint(float v) {
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(rintf(v), -127.f), 127.f)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  return v;
}

}  // namespace fitclip
