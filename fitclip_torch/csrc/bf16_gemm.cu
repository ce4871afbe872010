// bf16_gemm: C[M, N] = A[M, K] (bf16, row-major) x W[N, K]^T (bf16, row-major),
// fp32 accumulation on the tensor cores, with one of three fp32 epilogues.
//
// Replaces the four float contractions of the TPU float layer kernel
// (fitclip_tpu/ops/block.py:_bf16_layer_kernel, its `dense` helper:
// acc + bias after the fp32 accumulate):
//   kBias      acc + bias                         -> bf16 (QKV projection)
//   kResidual  residual + (acc + bias)            -> out dtype (out-projection into the
//              fp32 mid-layer residual, and the MLP projection rounded once to x's dtype)
//   kGelu      h = acc + bias, then QuickGELU h * sigmoid(1.702 h) or the exact GELU of
//              block.py:_exact_gelu (A&S 7.1.26 erf with an exact divide and exp(-az^2))
//              -> bf16, the MLP projection's input
//
// On the H100 these products are bound by compute: at M = B * L >= 6k rows the
// ViT-B/16 shapes do several hundred bf16 operations per byte moved. The
// mainloop is gemm_wgmma.cuh's, shared with int8_gemm.cu: wgmma.m64n128k16
// (bf16 x bf16 -> fp32) on 128 x 128 tiles, a stage being 64 bf16 of K (the
// same 128 bytes as int8's 128 values), fed by TMA through a six-stage mbarrier
// ring on a persistent grid. This file holds the epilogues, applied straight
// from the accumulator registers.
#include "gemm_wgmma.cuh"

using namespace fitclip;

namespace {

using bf16 = __nv_bfloat16;

enum Site : int { kBias = 0, kResidual = 1, kGelu = 2 };

// The float layer's activations, each rounding step explicit, on four values
// at once: each step is written for all four before the next (the same
// operations on each value, in the same order), the four divides in one
// gemm::div4 (the IEEE divide's result without its per-quotient branch), so
// that the steps overlap across the values.
#define FITCLIP_EACH _Pragma("unroll") for (int i = 0; i < 4; ++i)

template <bool kQuick>
__device__ __forceinline__ void gelu(float (&h)[4]) {
  constexpr float kOnes[4] = {1.f, 1.f, 1.f, 1.f};
  float d[4], q[4];
  if constexpr (kQuick) {  // h * sigmoid(1.702 h), sigmoid(v) = 1 / (1 + exp(-v))
    FITCLIP_EACH d[i] = add(1.f, expf(-mul(1.702f, h[i])));
    gemm::div4(kOnes, d, q);
    FITCLIP_EACH h[i] = mul(h[i], q[i]);
  } else {
    float z[4];  // z, then t = 1 / (1 + 0.3275911 |z|) in q
    FITCLIP_EACH z[i] = mul(h[i], 0.7071067811865475f);
    FITCLIP_EACH d[i] = add(1.f, mul(0.3275911f, fabsf(z[i])));
    gemm::div4(kOnes, d, q);
    FITCLIP_EACH {
      const float az = fabsf(z[i]), t = q[i];
      const float poly = mul(t, add(0.254829592f, mul(t, add(-0.284496736f, mul(t, add(
          1.421413741f, mul(t, add(-1.453152027f, mul(t, 1.061405429f)))))))));
      const float erf_abs = sub(1.f, mul(poly, expf(-mul(az, az))));
      const float erf = z[i] < 0.f ? -erf_abs : erf_abs;
      h[i] = mul(mul(h[i], 0.5f), add(1.f, erf));
    }
  }
}

#undef FITCLIP_EACH

// The epilogue of csrc/gemm_wgmma.cuh's mainloop: y = acc + bias, then y
// (kBias), residual + y (kResidual) or gelu<kQuick>(y) (kGelu).
template <int kEpi, typename ResT, typename OutT, bool kQuick>
struct Epilogue {
  const float* __restrict__ bias;
  const ResT* __restrict__ residual;
  OutT* __restrict__ out;

  using Column = gemm::Four;
  using Input = std::conditional_t<kEpi == kResidual, gemm::Four, gemm::None>;
  static constexpr bool kHeavy = kEpi == kGelu;

  __device__ __forceinline__ Column column(int col, int count) const {
    return gemm::load4(bias, col, count, count == 4);
  }

  __device__ __forceinline__ Input input(size_t o, int count, bool vec) const {
    if constexpr (kEpi == kResidual) {
      return gemm::load4(residual, o, count, vec);
    } else {
      return {};
    }
  }

  __device__ __forceinline__ void store(const Column& b, const Input& in, size_t o,
                                        const gemm::Quad<float>& v, int count, bool vec) const {
    float t[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) t[i] = add(v.v[i], b.v[i]);
    if constexpr (kEpi == kGelu) gelu<kQuick>(t);
    gemm::Quad<OutT> y;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (kEpi == kResidual) {
        y.v[i] = from_float<OutT>(add(in.v[i], t[i]));
      } else {
        y.v[i] = from_float<OutT>(t[i]);
      }
    }
    gemm::store4(out, o, y, count, vec);
  }
};

template <int kEpi, typename ResT, typename OutT, bool kQuick>
__global__ void __launch_bounds__(gemm::kThreads, 1)
bf16_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap a, const __grid_constant__ CUtensorMap w,
                       int m, int n, int k, int cm, int cn, const float* __restrict__ bias,
                       const ResT* __restrict__ residual, OutT* __restrict__ out) {
  gemm::run<gemm::BF16>(a, w, m, n, k, cm, cn, Epilogue<kEpi, ResT, OutT, kQuick>{bias, residual, out});
}

template <int kEpi, typename ResT, typename OutT, bool kQuick>
int launch(const void* a, const void* w, int m, int n, int k, const void* bias,
           const void* residual, void* out, cudaStream_t s) {
  return gemm::launch<gemm::BF16, bf16_gemm_wgmma_kernel<kEpi, ResT, OutT, kQuick>>(
      a, w, m, n, k, s, static_cast<const float*>(bias), static_cast<const ResT*>(residual),
      static_cast<OutT*>(out));
}

}  // namespace

// epilogue: kBias | kResidual | kGelu. res_dtype and out_dtype are DType codes:
// kBias and kGelu write bf16; kResidual takes the layer's two sites, a bf16
// residual into fp32 (out-projection) and an fp32 residual into bf16 (MLP
// projection). K must be a positive multiple of 8 (16-byte rows) and a and w
// 16-byte aligned (TMA's rule); any other call returns cudaErrorInvalidValue
// without a launch.
extern "C" int fitclip_bf16_gemm(const void* a, const void* w, int m, int n, int k, int epilogue,
                                 const void* bias, const void* residual, int res_dtype, void* out,
                                 int out_dtype, int quick_gelu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (epilogue == kBias && out_dtype == kBFloat16) {
    return launch<kBias, float, bf16, false>(a, w, m, n, k, bias, nullptr, out, s);
  } else if (epilogue == kResidual && res_dtype == kBFloat16 && out_dtype == kFloat32) {
    return launch<kResidual, bf16, float, false>(a, w, m, n, k, bias, residual, out, s);
  } else if (epilogue == kResidual && res_dtype == kFloat32 && out_dtype == kBFloat16) {
    return launch<kResidual, float, bf16, false>(a, w, m, n, k, bias, residual, out, s);
  } else if (epilogue == kGelu && out_dtype == kBFloat16) {
    return quick_gelu ? launch<kGelu, float, bf16, true>(a, w, m, n, k, bias, nullptr, out, s)
                      : launch<kGelu, float, bf16, false>(a, w, m, n, k, bias, nullptr, out, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
