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
// ViT-B/16 shapes do ~100 int8 operations per byte moved. The simple design
// uses mma.sync.m16n8k32 (s8 x s8 -> s32): 128 x 128 output tiles, eight warps
// of 64 x 32 each, K in steps of 64 bytes through a two-stage cp.async ring in
// shared memory (rows padded to 80 bytes, so the fragment loads hit 32 banks).
// wgmma and TMA are later work.
#include "common.cuh"

using namespace fitclip;

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64, kThreads = 256;
constexpr int kLds = kBK + 16;  // shared-memory row stride in bytes
enum Epilogue : int { kBias = 0, kResidual = 1, kGelu = 2 };

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The folded fc epilogue of block.py:_layer_kernel, with its exact divides.
template <bool kQuick>
__device__ __forceinline__ int8_t gelu_quant(float t, float kv) {
  float g;
  if (kQuick) {
    const float e = exp2f(mul(t, kv));
    g = div(t, add(1.f, e));
  } else {
    const float z = mul(t, kv);
    const float az = fabsf(z);
    const float u = div(1.f, add(1.f, mul(0.3275911f, az)));
    const float poly = mul(u, add(0.254829592f, mul(u, add(-0.284496736f, mul(u, add(
        1.421413741f, mul(u, add(-1.453152027f, mul(u, 1.061405429f)))))))));
    const float pe = mul(poly, exp2f(mul(mul(-1.4426950408889634f, az), az)));
    const float erf = z < 0.f ? sub(pe, 1.f) : sub(1.f, pe);
    g = mul(mul(0.5f, t), add(1.f, erf));
  }
  return quant_rint(g);
}

template <int kEpi, typename ResT, typename OutT, bool kQuick>
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w, int m, int n, int k,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 const ResT* __restrict__ residual, OutT* __restrict__ out, float kv) {
  __shared__ __align__(16) int8_t as[2][kBM * kLds];
  __shared__ __align__(16) int8_t ws[2][kBN * kLds];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int g = lane >> 2, t = lane & 3;

  // Each stage is 128 rows x 64 bytes of A and of W: 512 chunks of 16 bytes each.
  auto load = [&](int stage, int k0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int c = tid + r * kThreads;
      const int row = c >> 2, col = (c & 3) * 16;
      const int kc = k0 + col;
      const bool k_in = kc < k;
      const int am = m0 + row, wr = n0 + row;
      cp_async16(&as[stage][row * kLds + col],
                 a + static_cast<size_t>(am < m ? am : 0) * k + (k_in ? kc : 0), am < m && k_in);
      cp_async16(&ws[stage][row * kLds + col],
                 w + static_cast<size_t>(wr < n ? wr : 0) * k + (k_in ? kc : 0), wr < n && k_in);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int ktiles = (k + kBK - 1) / kBK;
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < ktiles) load(cur ^ 1, (kt + 1) * kBK);
    cp_async_commit();  // possibly empty, so that "all but the newest group" is tile kt
    cp_async_wait_one();
    __syncthreads();
    const int8_t* at = as[cur];
    const int8_t* wt = ws[cur];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* p0 = at + (wm + mi * 16 + g) * kLds + kk + t * 4;
        const int8_t* p1 = p0 + 8 * kLds;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(p0);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(p1);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(p0 + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(p1 + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* q = wt + (wn + ni * 8 + g) * kLds + kk + t * 4;
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(q);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(q + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  // Accumulator fragment: registers 0,1 hold row g, columns 2t and 2t+1;
  // registers 2,3 the same columns of row g + 8.
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm + mi * 16 + g + (r >= 2 ? 8 : 0);
        const int col = n0 + wn + ni * 8 + t * 2 + (r & 1);
        if (row < m && col < n) {
          const size_t o = static_cast<size_t>(row) * n + col;
          const float y = add(mul(__int2float_rn(acc[mi][ni][r]), scale[col]), bias[col]);
          if constexpr (kEpi == kBias) {
            out[o] = from_float<OutT>(y);
          } else if constexpr (kEpi == kResidual) {
            out[o] = from_float<OutT>(add(to_float(residual[o]), y));
          } else {
            out[o] = gelu_quant<kQuick>(y, kv);
          }
        }
      }
}

template <int kEpi, typename ResT, typename OutT, bool kQuick>
void launch(const void* a, const void* w, int m, int n, int k, const void* scale,
            const void* bias, const void* residual, void* out, float kv, cudaStream_t s) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  int8_gemm_kernel<kEpi, ResT, OutT, kQuick><<<grid, kThreads, 0, s>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(w), m, n, k,
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const ResT*>(residual), static_cast<OutT*>(out), kv);
}

}  // namespace

// epilogue: kBias | kResidual | kGelu. res_dtype and out_dtype are DType codes
// (out_dtype is ignored by kGelu, which writes int8).
extern "C" int fitclip_int8_gemm(const void* a, const void* w, int m, int n, int k, int epilogue,
                                 const void* scale, const void* bias, const void* residual,
                                 int res_dtype, void* out, int out_dtype, float kv,
                                 int quick_gelu, void* stream) {
  using bf16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (epilogue == kBias && out_dtype == kBFloat16) {
    launch<kBias, float, bf16, false>(a, w, m, n, k, scale, bias, nullptr, out, kv, s);
  } else if (epilogue == kBias && out_dtype == kFloat32) {
    launch<kBias, float, float, false>(a, w, m, n, k, scale, bias, nullptr, out, kv, s);
  } else if (epilogue == kResidual && res_dtype == kBFloat16 && out_dtype == kFloat32) {
    launch<kResidual, bf16, float, false>(a, w, m, n, k, scale, bias, residual, out, kv, s);
  } else if (epilogue == kResidual && res_dtype == kFloat32 && out_dtype == kBFloat16) {
    launch<kResidual, float, bf16, false>(a, w, m, n, k, scale, bias, residual, out, kv, s);
  } else if (epilogue == kResidual && res_dtype == kFloat32 && out_dtype == kFloat32) {
    launch<kResidual, float, float, false>(a, w, m, n, k, scale, bias, residual, out, kv, s);
  } else if (epilogue == kResidual && res_dtype == kBFloat16 && out_dtype == kBFloat16) {
    launch<kResidual, bf16, bf16, false>(a, w, m, n, k, scale, bias, residual, out, kv, s);
  } else if (epilogue == kGelu && quick_gelu) {
    launch<kGelu, float, int8_t, true>(a, w, m, n, k, scale, bias, nullptr, out, kv, s);
  } else if (epilogue == kGelu) {
    launch<kGelu, float, int8_t, false>(a, w, m, n, k, scale, bias, nullptr, out, kv, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
