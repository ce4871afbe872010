// int8_gemm: C[M, N] = A[M, K] (int8, row-major) x W[N, K]^T (int8, row-major),
// int32 accumulation on the tensor cores, with one of three fp32 epilogues.
//
// Replaces the four int8 x int8 -> int32 MXU contractions of the TPU layer
// kernel (fitclip_tpu/ops/block.py:_layer_kernel, via _int8_dense and the
// folded fc epilogue):
//   kBias      acc * scale + bias                 -> out dtype (QKV projection)
//   kResidual  residual + (acc * scale + bias)    -> out dtype (out-projection into
//              the fp32 mid-layer residual, and the final projection back to x's dtype)
//   kGelu      t = acc * fs2 + fb2, QuickGELU t / (1 + exp2(t * kv)) or the exact
//              GELU through the A&S 7.1.26 erf polynomial, then rint/clip -> int8
//
// On the H100 these products are bound by compute: at M = B * L >= 6k rows the
// ViT-B/16 shapes do ~100 int8 operations per byte moved. The mainloop is
// gemm_wgmma.cuh's: wgmma.m64n128k32 (s8 x s8 -> s32) on 128 x 128 tiles fed
// by TMA through a six-stage mbarrier ring, on a persistent grid. This file
// holds the epilogues, applied straight from the accumulator registers. The
// int32 sum is exact in any order, so each output is the one the epilogue's
// fp32 steps give, whatever the summation order.
#include "gemm_wgmma.cuh"

using namespace fitclip;

namespace {

enum Site : int { kBias = 0, kResidual = 1, kGelu = 2 };

// The fc epilogues: acc -> int8. kExact and kQuick are the folded epilogues of
// block.py:_layer_kernel, with its exact divides: t = acc * fs2 + fb2, then the
// exact GELU (erf argument t * kv) or QuickGELU t / (1 + exp2(t * kv)). The
// others are the MLP epilogues of the TPU ablation bench
// scripts/bench_block_layer.py:make_run (S1):
//   kSigmoid      unfolded: h = acc * fs + fb, h * sigmoid(1.702 h), rint(g * inv_p)
//                 with kv = inv_p (`full`);
//   kSigmoidCast  the same g truncated to int8, no inv (`noquant`);
//   kBf16         dequant, QuickGELU and the inv_p multiply in bf16 arithmetic, one
//                 rounding per operation, only the round in fp32 (`bf16gelu`);
//   kFold         kQuick with rcp.approx in place of the divide (`mlpfold`);
//   kFold16       kQuick in bf16 arithmetic, the round in fp32 (`mlpfold16`).
enum Act : int { kExact = 0, kQuick = 1, kSigmoid = 2, kBf16 = 3, kFold = 4, kFold16 = 5,
                 kSigmoidCast = 6 };

// quant_rint(v) with one conversion where quant_rint takes two (rint, then the
// truncating convert): cvt.rni rounds half to even as rintf does and saturates,
// the clip is done on the integer, and NaN, which quant_rint's fmaxf sends to
// -127, goes there too. The same int8 for every float.
__device__ __forceinline__ int8_t quant_rn(float v) {
  return static_cast<int8_t>(v != v ? -127 : min(max(__float2int_rn(v), -127), 127));
}

// Four outputs at once, each step written for all four before the next (the
// same operations on each output, in the same order), the four divides in one
// gemm::div4 (the IEEE divide's result without its per-quotient branch): the
// steps overlap across the outputs instead of waiting on one output's chain of
// exp, divide and round.
#define FITCLIP_EACH _Pragma("unroll") for (int i = 0; i < 4; ++i)

template <int kAct>
__device__ __forceinline__ gemm::Quad<int8_t> gelu_quant(const gemm::Quad<int>& acc,
                                                        const gemm::Four& scale,
                                                        const gemm::Four& bias, float kv) {
  constexpr float kOnes[4] = {1.f, 1.f, 1.f, 1.f};
  gemm::Quad<int8_t> y;
  float t[4], d[4], q[4];
  if constexpr (kAct == kBf16) {  // h in t, then 1 + exp(-z) in d, sg in q
    FITCLIP_EACH t[i] = bf16_round(add(bf16_round(mul(bf16_round(__int2float_rn(acc.v[i])),
                                                       bf16_round(scale.v[i]))),
                                        bf16_round(bias.v[i])));
    FITCLIP_EACH d[i] = bf16_round(add(1.f, bf16_round(expf(-bf16_round(mul(bf16_round(1.702f), t[i]))))));
    gemm::div4(kOnes, d, q);
    FITCLIP_EACH y.v[i] = quant_rn(bf16_round(mul(bf16_round(mul(t[i], bf16_round(q[i]))), bf16_round(kv))));
  } else if constexpr (kAct == kFold16) {
    FITCLIP_EACH t[i] = bf16_round(add(bf16_round(mul(bf16_round(__int2float_rn(acc.v[i])),
                                                       bf16_round(scale.v[i]))),
                                        bf16_round(bias.v[i])));
    FITCLIP_EACH d[i] = bf16_round(add(1.f, bf16_round(exp2f(bf16_round(mul(t[i], bf16_round(kv)))))));
    gemm::div4(kOnes, d, q);
    FITCLIP_EACH y.v[i] = quant_rn(bf16_round(mul(t[i], bf16_round(q[i]))));
  } else {
    FITCLIP_EACH t[i] = add(mul(__int2float_rn(acc.v[i]), scale.v[i]), bias.v[i]);
    if constexpr (kAct == kSigmoid || kAct == kSigmoidCast) {
      FITCLIP_EACH d[i] = add(1.f, expf(-mul(1.702f, t[i])));
      gemm::div4(kOnes, d, q);
      FITCLIP_EACH {
        const float g = mul(t[i], q[i]);
        y.v[i] = kAct == kSigmoid ? quant_rn(mul(g, kv)) : trunc_int8(g);
      }
    } else if constexpr (kAct == kQuick || kAct == kFold) {
      FITCLIP_EACH d[i] = add(1.f, exp2f(mul(t[i], kv)));
      if constexpr (kAct == kQuick) {
        gemm::div4(t, d, q);
      } else {
        FITCLIP_EACH q[i] = mul(t[i], rcp_approx(d[i]));
      }
      FITCLIP_EACH y.v[i] = quant_rn(q[i]);
    } else {  // kExact: z = t * kv, then u = 1 / (1 + 0.3275911 |z|) in q
      float z[4];
      FITCLIP_EACH z[i] = mul(t[i], kv);
      FITCLIP_EACH d[i] = add(1.f, mul(0.3275911f, fabsf(z[i])));
      gemm::div4(kOnes, d, q);
      FITCLIP_EACH {
        const float az = fabsf(z[i]), u = q[i];
        const float poly = mul(u, add(0.254829592f, mul(u, add(-0.284496736f, mul(u, add(
            1.421413741f, mul(u, add(-1.453152027f, mul(u, 1.061405429f)))))))));
        const float pe = mul(poly, exp2f(mul(mul(-1.4426950408889634f, az), az)));
        const float erf = z[i] < 0.f ? sub(pe, 1.f) : sub(1.f, pe);
        y.v[i] = quant_rn(mul(mul(0.5f, t[i]), add(1.f, erf)));
      }
    }
  }
  return y;
}

#undef FITCLIP_EACH

// The epilogue of csrc/gemm_wgmma.cuh's mainloop: acc * scale + bias (kBias),
// residual + that (kResidual), or the fc epilogue gelu_quant<kAct> (kGelu).
template <int kEpi, typename ResT, typename OutT, int kAct>
struct Epilogue {
  const float* __restrict__ scale;
  const float* __restrict__ bias;
  const ResT* __restrict__ residual;
  OutT* __restrict__ out;
  float kv;

  struct Column { gemm::Four scale, bias; };
  using Input = std::conditional_t<kEpi == kResidual, gemm::Four, gemm::None>;
  static constexpr bool kHeavy = kEpi == kGelu;

  __device__ __forceinline__ Column column(int col, int count) const {
    return {gemm::load4(scale, col, count, count == 4), gemm::load4(bias, col, count, count == 4)};
  }

  __device__ __forceinline__ Input input(size_t o, int count, bool vec) const {
    if constexpr (kEpi == kResidual) {
      return gemm::load4(residual, o, count, vec);
    } else {
      return {};
    }
  }

  __device__ __forceinline__ void store(const Column& c, const Input& in, size_t o,
                                        const gemm::Quad<int>& v, int count, bool vec) const {
    if constexpr (kEpi == kGelu) {
      gemm::store4(out, o, gelu_quant<kAct>(v, c.scale, c.bias, kv), count, vec);
    } else {
      gemm::Quad<OutT> y;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float t = add(mul(__int2float_rn(v.v[i]), c.scale.v[i]), c.bias.v[i]);
        if constexpr (kEpi == kResidual) {
          y.v[i] = from_float<OutT>(add(in.v[i], t));
        } else {
          y.v[i] = from_float<OutT>(t);
        }
      }
      gemm::store4(out, o, y, count, vec);
    }
  }
};

template <int kEpi, typename ResT, typename OutT, int kAct>
__global__ void __launch_bounds__(gemm::kThreads, 1)
int8_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap a, const __grid_constant__ CUtensorMap w,
                       int m, int n, int k, int cm, int cn, const float* __restrict__ scale,
                       const float* __restrict__ bias, const ResT* __restrict__ residual,
                       OutT* __restrict__ out, float kv) {
  gemm::run<gemm::S8>(a, w, m, n, k, cm, cn, Epilogue<kEpi, ResT, OutT, kAct>{scale, bias, residual, out, kv});
}

template <int kEpi, typename ResT, typename OutT, int kAct = kExact>
int launch(const void* a, const void* w, int m, int n, int k, const void* scale, const void* bias,
           const void* residual, void* out, float kv, cudaStream_t s) {
  return gemm::launch<gemm::S8, int8_gemm_wgmma_kernel<kEpi, ResT, OutT, kAct>>(
      a, w, m, n, k, s, static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const ResT*>(residual), static_cast<OutT*>(out), kv);
}

}  // namespace

// epilogue: kBias | kResidual | kGelu. res_dtype and out_dtype are DType codes
// (out_dtype is ignored by kGelu, which writes int8). act: kGelu's Act. K must be
// a positive multiple of 16 and a and w 16-byte aligned (TMA's rule); any other
// call returns cudaErrorInvalidValue without a launch.
extern "C" int fitclip_int8_gemm(const void* a, const void* w, int m, int n, int k, int epilogue,
                                 const void* scale, const void* bias, const void* residual,
                                 int res_dtype, void* out, int out_dtype, float kv, int act,
                                 void* stream) {
  using bf16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (epilogue == kBias && out_dtype == kBFloat16) {
    return launch<kBias, float, bf16>(a, w, m, n, k, scale, bias, nullptr, out, kv, s);
  } else if (epilogue == kBias && out_dtype == kFloat32) {
    return launch<kBias, float, float>(a, w, m, n, k, scale, bias, nullptr, out, kv, s);
  } else if (epilogue == kResidual && res_dtype == kBFloat16 && out_dtype == kFloat32) {
    return launch<kResidual, bf16, float>(a, w, m, n, k, scale, bias, residual, out, kv, s);
  } else if (epilogue == kResidual && res_dtype == kFloat32 && out_dtype == kBFloat16) {
    return launch<kResidual, float, bf16>(a, w, m, n, k, scale, bias, residual, out, kv, s);
  } else if (epilogue == kResidual && res_dtype == kFloat32 && out_dtype == kFloat32) {
    return launch<kResidual, float, float>(a, w, m, n, k, scale, bias, residual, out, kv, s);
  } else if (epilogue == kResidual && res_dtype == kBFloat16 && out_dtype == kBFloat16) {
    return launch<kResidual, bf16, bf16>(a, w, m, n, k, scale, bias, residual, out, kv, s);
  } else if (epilogue == kGelu) {
    switch (act) {
#define FITCLIP_ACT(A) \
  case A: return launch<kGelu, float, int8_t, A>(a, w, m, n, k, scale, bias, nullptr, out, kv, s);
      FITCLIP_ACT(kExact)
      FITCLIP_ACT(kQuick)
      FITCLIP_ACT(kSigmoid)
      FITCLIP_ACT(kBf16)
      FITCLIP_ACT(kFold)
      FITCLIP_ACT(kFold16)
      FITCLIP_ACT(kSigmoidCast)
#undef FITCLIP_ACT
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
