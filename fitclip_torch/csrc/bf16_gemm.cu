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
// ViT-B/16 shapes do several hundred bf16 operations per byte moved. The simple
// design is int8_gemm.cu's with mma.sync.m16n8k16 (bf16 x bf16 -> fp32): 128 x 128
// output tiles, eight warps of 64 x 32 each, K in steps of 32 elements (64 bytes)
// through a two-stage cp.async ring in shared memory (rows padded to 80 bytes, so
// the fragment loads hit 32 banks). A bf16 k16 fragment sits at the same byte
// offsets as an s8 k32 one. wgmma and TMA are later work.
#include "common.cuh"

using namespace fitclip;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBN = 128, kBK = 32, kThreads = 256;  // kBK in elements
constexpr int kLds = kBK + 8;  // shared-memory row stride in elements (80 bytes)
enum Epilogue : int { kBias = 0, kResidual = 1, kGelu = 2 };

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The float layer's activations, each rounding step explicit.
template <bool kQuick>
__device__ __forceinline__ float gelu(float h) {
  if (kQuick) {  // h * sigmoid(1.702 h), sigmoid(v) = 1 / (1 + exp(-v))
    return mul(h, div(1.f, add(1.f, expf(-mul(1.702f, h)))));
  }
  const float z = mul(h, 0.7071067811865475f);
  const float az = fabsf(z);
  const float t = div(1.f, add(1.f, mul(0.3275911f, az)));
  const float poly = mul(t, add(0.254829592f, mul(t, add(-0.284496736f, mul(t, add(
      1.421413741f, mul(t, add(-1.453152027f, mul(t, 1.061405429f)))))))));
  const float erf_abs = sub(1.f, mul(poly, expf(-mul(az, az))));
  const float erf = z < 0.f ? -erf_abs : erf_abs;
  return mul(mul(h, 0.5f), add(1.f, erf));
}

template <int kEpi, typename ResT, typename OutT, bool kQuick>
__global__ void __launch_bounds__(kThreads)
bf16_gemm_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w, int m, int n, int k,
                 const float* __restrict__ bias, const ResT* __restrict__ residual,
                 OutT* __restrict__ out) {
  __shared__ __align__(16) bf16 as[2][kBM * kLds];
  __shared__ __align__(16) bf16 ws[2][kBN * kLds];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int g = lane >> 2, t = lane & 3;

  // Each stage is 128 rows x 32 elements of A and of W: 512 chunks of 8 elements each.
  auto load = [&](int stage, int k0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int c = tid + r * kThreads;
      const int row = c >> 2, col = (c & 3) * 8;
      const int kc = k0 + col;
      const bool k_in = kc < k;
      const int am = m0 + row, wr = n0 + row;
      cp_async16(&as[stage][row * kLds + col],
                 a + static_cast<size_t>(am < m ? am : 0) * k + (k_in ? kc : 0), am < m && k_in);
      cp_async16(&ws[stage][row * kLds + col],
                 w + static_cast<size_t>(wr < n ? wr : 0) * k + (k_in ? kc : 0), wr < n && k_in);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int ktiles = (k + kBK - 1) / kBK;
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < ktiles) load(cur ^ 1, (kt + 1) * kBK);
    cp_async_commit();  // possibly empty, so that "all but the newest group" is tile kt
    cp_async_wait_one();
    __syncthreads();
    const bf16* at = as[cur];
    const bf16* wt = ws[cur];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const bf16* p0 = at + (wm + mi * 16 + g) * kLds + kk + t * 2;
        const bf16* p1 = p0 + 8 * kLds;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(p0);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(p1);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const bf16* q = wt + (wn + ni * 8 + g) * kLds + kk + t * 2;
        bfr[ni][0] = *reinterpret_cast<const uint32_t*>(q);
        bfr[ni][1] = *reinterpret_cast<const uint32_t*>(q + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
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
          const float y = add(acc[mi][ni][r], bias[col]);
          if constexpr (kEpi == kBias) {
            out[o] = from_float<OutT>(y);
          } else if constexpr (kEpi == kResidual) {
            out[o] = from_float<OutT>(add(to_float(residual[o]), y));
          } else {
            out[o] = from_float<OutT>(gelu<kQuick>(y));
          }
        }
      }
}

template <int kEpi, typename ResT, typename OutT, bool kQuick>
void launch(const void* a, const void* w, int m, int n, int k, const void* bias,
            const void* residual, void* out, cudaStream_t s) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  bf16_gemm_kernel<kEpi, ResT, OutT, kQuick><<<grid, kThreads, 0, s>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(w), m, n, k,
      static_cast<const float*>(bias), static_cast<const ResT*>(residual),
      static_cast<OutT*>(out));
}

}  // namespace

// epilogue: kBias | kResidual | kGelu. res_dtype and out_dtype are DType codes:
// kBias and kGelu write bf16; kResidual takes the layer's two sites, a bf16
// residual into fp32 (out-projection) and an fp32 residual into bf16 (MLP
// projection). K must be a multiple of 8 (16-byte rows).
extern "C" int fitclip_bf16_gemm(const void* a, const void* w, int m, int n, int k, int epilogue,
                                 const void* bias, const void* residual, int res_dtype, void* out,
                                 int out_dtype, int quick_gelu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (epilogue == kBias && out_dtype == kBFloat16) {
    launch<kBias, float, bf16, false>(a, w, m, n, k, bias, nullptr, out, s);
  } else if (epilogue == kResidual && res_dtype == kBFloat16 && out_dtype == kFloat32) {
    launch<kResidual, bf16, float, false>(a, w, m, n, k, bias, residual, out, s);
  } else if (epilogue == kResidual && res_dtype == kFloat32 && out_dtype == kBFloat16) {
    launch<kResidual, float, bf16, false>(a, w, m, n, k, bias, residual, out, s);
  } else if (epilogue == kGelu && out_dtype == kBFloat16) {
    if (quick_gelu) {
      launch<kGelu, float, bf16, true>(a, w, m, n, k, bias, nullptr, out, s);
    } else {
      launch<kGelu, float, bf16, false>(a, w, m, n, k, bias, nullptr, out, s);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
