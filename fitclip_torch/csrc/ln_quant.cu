// ln_quant and ln_cast: row-wise fp32 LayerNorm, then
//   ln_quant  clip(rint(y * inv), -127, 127) -> int8 (the int8 layer, K1), or
//   ln_cast   y rounded to bf16, the float layer's compute dtype (K2).
//
// Replaces the LN prologues of each half of the TPU layer kernels
// (fitclip_tpu/ops/block.py:_layer_kernel via _ln and _quant, and
// _bf16_layer_kernel via _ln and the dense's h.astype(x.dtype)). On the H100 it is
// bound by memory: it reads a row of W bf16 or fp32 values once and writes W bytes
// (int8) or W bf16 values; the statistics and the affine are a few operations a byte.
//
// Design (ln_rows_kernel): one warp per row, a persistent grid (as many CTAs of
// four warps as the SMs hold at once) whose warps walk the rows with a stride of
// the grid's warp count, so that the warps together stream the rows in address
// order. Each lane owns whole 8-element vectors of the row (vector j = 32 v +
// lane, v < kVecs = ceil(W / 256)): one 16-byte load each for bf16 (no L1
// allocation: nothing is read twice), two adjacent 16-byte loads for fp32, and
// one 8-byte (int8) or 16-byte (bf16) store. The row stays in registers: the
// mean, the centered sum of squares (kOne: the sum of squares) and the
// normalize read it from there, so device memory sees it once. gamma and beta
// (kFold: gamma * inv and beta * inv) are loaded into registers once per warp,
// not once per row. Bytes in flight: each warp loads its next row while it
// reduces the current one, so a warp keeps one row in flight; at W = 768
// ptxas gives the bf16 -> int8 kernel 96 registers, so an SM holds 20 warps
// (1.5 KB a row: 30 KB in flight), and the fp32 one 128, 16 warps (3 KB a row:
// 48 KB), against the ~25 KB per SM that 3.35 TB/s needs at HBM's idle
// latency. The fp32 rows reach 80-84% of the bytes bound on an H100, the bf16
// rows 69-77% (PERF.md).
//
// Numerics: the row sums run in another order than the plain version's; the
// elementwise steps (the mean's divide, the centering, the normalize, the
// affine and the quantize multiplier) are rounded one by one (common.cuh's
// mul/add/sub/div, no contraction into fma), rsqrtf as before.
//
// ln_quant's other modes are the LN prologues of the TPU ablation bench
// scripts/bench_block_layer.py:make_run (S1):
//   one   a single-pass variance E[x^2] - E[x]^2 (`lnvar`);
//   fold  inv folded into the affine: rint(n * (gamma * inv) + beta * inv) (`lnfold`);
//   cast  LN(x) truncated toward zero to int8, no inv (`noquant`), saturated.
//
// Widths: every multiple of 8 up to kMaxWidth (1024, ViT-L/14); the C entries
// refuse any other, and the Python wrappers raise first.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

using namespace fitclip;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kVecElems = 8;                    // elements of one lane's vector
constexpr int kMaxVecs = 4;                     // vectors per lane: W <= 1024
constexpr int kMaxWidth = kMaxVecs * 32 * kVecElems;
constexpr int kAhead = 1;                       // rows a warp loads ahead of the one it reduces

enum LnMode : int { kTwo = 0, kOne = 1, kFold = 2, kCast = 3 };

// Eight consecutive input values as loaded: one 16-byte vector of bf16, two of fp32.
template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(raw.x), "=r"(raw.y), "=r"(raw.z), "=r"(raw.w) : "l"(p));
  }
  __device__ __forceinline__ float get(int i) const {
    const uint32_t w = i < 2 ? raw.x : i < 4 ? raw.y : i < 6 ? raw.z : raw.w;
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};
template <> struct Vec<float> {
  float4 lo, hi;
  __device__ __forceinline__ void load(const float* p) {
    // The second load finds the sectors of the first in L1: one HBM read.
    lo = __ldg(reinterpret_cast<const float4*>(p));
    hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ float get(int i) const {
    const float4& h = i < 4 ? lo : hi;
    switch (i & 3) {
      case 0: return h.x;
      case 1: return h.y;
      case 2: return h.z;
      default: return h.w;
    }
  }
};

__device__ __forceinline__ uint32_t pack_int8x4(int8_t a, int8_t b, int8_t c, int8_t d) {
  return static_cast<uint32_t>(static_cast<uint8_t>(a)) |
         static_cast<uint32_t>(static_cast<uint8_t>(b)) << 8 |
         static_cast<uint32_t>(static_cast<uint8_t>(c)) << 16 |
         static_cast<uint32_t>(static_cast<uint8_t>(d)) << 24;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(a));
  const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(b));
  return lo | hi << 16;
}

template <typename T, typename OutT, int kMode, int kVecs>
__global__ void __launch_bounds__(kThreads)
ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, OutT* __restrict__ out, int rows, int width,
               float inv, float eps) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps;
  const int vecs = width / kVecElems;
  const float fwidth = static_cast<float>(width);

  // This lane's columns of gamma and beta (kFold: times inv), once per warp.
  float g[kVecs][kVecElems], b[kVecs][kVecElems];
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
    const int j = v * 32 + lane;
    float4 g0 = make_float4(0.f, 0.f, 0.f, 0.f), g1 = g0, b0 = g0, b1 = g0;
    if (j < vecs) {
      g0 = __ldg(reinterpret_cast<const float4*>(gamma) + 2 * j);
      g1 = __ldg(reinterpret_cast<const float4*>(gamma) + 2 * j + 1);
      b0 = __ldg(reinterpret_cast<const float4*>(beta) + 2 * j);
      b1 = __ldg(reinterpret_cast<const float4*>(beta) + 2 * j + 1);
    }
    const float gs[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float bs[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < kVecElems; ++i) {
      g[v][i] = kMode == kFold ? mul(gs[i], inv) : gs[i];
      b[v][i] = kMode == kFold ? mul(bs[i], inv) : bs[i];
    }
  }

  auto load_row = [&](Vec<T> (&dst)[kVecs], int r) {
    if (r >= rows) return;
    const T* xr = x + static_cast<size_t>(r) * width;
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const int j = v * 32 + lane;
      if (j < vecs) dst[v].load(xr + j * kVecElems);
    }
  };

  auto reduce_row = [&](const Vec<T> (&cur)[kVecs], int row) {
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      if (v * 32 + lane < vecs) {
#pragma unroll
        for (int i = 0; i < kVecElems; ++i) {
          const float e = cur[v].get(i);
          sum += e;
          if (kMode == kOne) sq += e * e;
        }
      }
    }
    const float mean = div(warp_sum(sum), fwidth);
    float var;
    if (kMode == kOne) {
      var = sub(div(warp_sum(sq), fwidth), mul(mean, mean));
    } else {
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        if (v * 32 + lane < vecs) {
#pragma unroll
          for (int i = 0; i < kVecElems; ++i) {
            const float c = sub(cur[v].get(i), mean);
            sq += c * c;
          }
        }
      }
      var = div(warp_sum(sq), fwidth);
    }
    const float r = rsqrtf(add(var, eps));

    OutT* orow = out + static_cast<size_t>(row) * width;
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const int j = v * 32 + lane;
      if (j >= vecs) continue;
      float y[kVecElems];
#pragma unroll
      for (int i = 0; i < kVecElems; ++i) {
        const float n = mul(sub(cur[v].get(i), mean), r);
        y[i] = add(mul(n, g[v][i]), b[v][i]);
      }
      if constexpr (std::is_same_v<OutT, int8_t>) {
        int8_t q[kVecElems];
#pragma unroll
        for (int i = 0; i < kVecElems; ++i) {
          q[i] = kMode == kCast ? trunc_int8(y[i]) : quant_rint(kMode == kFold ? y[i]
                                                                             : mul(y[i], inv));
        }
        *reinterpret_cast<uint2*>(orow + j * kVecElems) =
            make_uint2(pack_int8x4(q[0], q[1], q[2], q[3]), pack_int8x4(q[4], q[5], q[6], q[7]));
      } else {
        *reinterpret_cast<uint4*>(orow + j * kVecElems) =
            make_uint4(pack_bf16x2(y[0], y[1]), pack_bf16x2(y[2], y[3]),
                       pack_bf16x2(y[4], y[5]), pack_bf16x2(y[6], y[7]));
      }
    }
  };

  // A ring of kAhead + 1 row buffers that rotate by name, not by copy (a copy
  // of a buffer still in flight would wait for its load): at step p the warp
  // loads the row kAhead strides ahead into buf[(p + kAhead) % (kAhead + 1)]
  // and reduces buf[p].
  Vec<T> buf[kAhead + 1][kVecs];
  int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
#pragma unroll
  for (int a = 0; a < kAhead; ++a) load_row(buf[a], row + a * stride);
  while (row < rows) {
#pragma unroll
    for (int p = 0; p <= kAhead; ++p) {
      if (row >= rows) break;
      load_row(buf[(p + kAhead) % (kAhead + 1)], row + kAhead * stride);
      reduce_row(buf[p], row);
      row += stride;
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  return sms;
}

template <typename T, typename OutT, int kMode, int kVecs>
int launch(const void* x, const void* gamma, const void* beta, void* out, int rows, int width,
           float inv, float eps, cudaStream_t s) {
  auto kernel = ln_rows_kernel<T, OutT, kMode, kVecs>;
  static int per_sm = 0;  // resident CTAs per SM, from the kernel's registers
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                          kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // As many warps as the SMs hold, or fewer, so that every warp takes the same
  // number of rows (but for the remainder): no warp's last row runs alone.
  const int resident_warps = sm_count() * per_sm * kWarps;
  const int per_warp = (rows + resident_warps - 1) / resident_warps;
  const int grid = ((rows + per_warp - 1) / per_warp + kWarps - 1) / kWarps;
  kernel<<<grid, kThreads, 0, s>>>(static_cast<const T*>(x), static_cast<const float*>(gamma),
                                   static_cast<const float*>(beta), static_cast<OutT*>(out), rows,
                                   width, inv, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename OutT, int kMode>
int dispatch_width(const void* x, const void* gamma, const void* beta, void* out, int rows,
                   int width, float inv, float eps, cudaStream_t s) {
  switch ((width + 32 * kVecElems - 1) / (32 * kVecElems)) {
    case 1: return launch<T, OutT, kMode, 1>(x, gamma, beta, out, rows, width, inv, eps, s);
    case 2: return launch<T, OutT, kMode, 2>(x, gamma, beta, out, rows, width, inv, eps, s);
    case 3: return launch<T, OutT, kMode, 3>(x, gamma, beta, out, rows, width, inv, eps, s);
    case 4: return launch<T, OutT, kMode, 4>(x, gamma, beta, out, rows, width, inv, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename OutT, int kMode>
int dispatch_input(const void* x, int x_dtype, const void* gamma, const void* beta, void* out,
                   int rows, int width, float inv, float eps, cudaStream_t s) {
  if (width <= 0 || width % kVecElems != 0 || width > kMaxWidth || rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  if (x_dtype == kBFloat16) {
    return dispatch_width<__nv_bfloat16, OutT, kMode>(x, gamma, beta, out, rows, width, inv, eps,
                                                      s);
  }
  if (x_dtype == kFloat32) {
    return dispatch_width<float, OutT, kMode>(x, gamma, beta, out, rows, width, inv, eps, s);
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
