// bench_arms: the kernels of the TPU ablation benches that no shipped kernel
// computes in one of its modes.
//
//   slice_requant  round(qkv[:, rows, :W] * inv) -> int8: the attention core
//                  replaced by a slice of q, requantized for the out-projection.
//                  Replaces the `noattn` arm of scripts/bench_block_layer.py:make_run
//                  (S1, `att = qkv[:, :, :width]`, then _quant) and the `noattn`,
//                  `notime`, `nospace` and `nocls` arms of
//                  scripts/bench_fit_block.py:make_variant (S3, `qkv[:, :, :width]
//                  * inv_out`, then round and clip). Bound by memory: it reads W
//                  of each row's 3W values and writes W bytes.
//   attn_amax      per block of `block` frames, max(|x|) over every head's q, k
//                  and v (floored at 1e-6, NaN propagated): the dynamic
//                  per-block scales of the int8 arms of
//                  scripts/bench_attn_int8.py:_variant_kernel (S2, q_amax,
//                  k_amax, v_amax). Bound by memory: one streaming read of qkv
//                  with 16-byte loads, four rows in flight a thread, the max
//                  taken on the bf16 bit patterns two at a time (__vmaxu2), each
//                  frame block spread over enough CTAs to fill the SMs and
//                  combined with atomicMax.
//   attention_s8   S2's `i8qk` and `i8qkav` cores. q and k are quantized on the
//                  way into shared memory, rint(x * (127 / amax)) clipped to +-127,
//                  and QK^T runs on the tensor cores as s8 mma.sync.m16n8k32 with
//                  int32 accumulation; logits = acc * (q_amax * k_amax * scale /
//                  127^2). fp32 softmax, weights exps / denom. i8qk: weights cast
//                  to bf16, P.V on the CUDA cores in fp32. i8qkav: weights
//                  rint(exps / denom * 127) as int8, v quantized with v_amax, P.V
//                  on s8 mma.sync, out = acc * (v_amax / 127^2). Output bf16.
//                  One block of four warps per (64 query rows, head, frame); each
//                  warp owns 16 rows. K (L x 64 bytes) and Q (64 x 64 bytes) sit in
//                  shared memory with 80-byte rows (int8_gemm.cu's fragment
//                  layout), the fp32 logits of a warp's 16 rows in a row buffer.
//                  At ViT-B/16 (L = 197, D = 64) the row buffers make ~100 KB per
//                  block of 4 warps, so an SM holds 8 warps; the softmax and the
//                  CUDA-core P.V walk each warp's rows serially, and the kernel is
//                  bound by that latency, not by its 31 G int8 products per 512
//                  frames (it reads 1.5x the bf16 qkv mode's time on an H100).
#include <algorithm>

#include "common.cuh"

using namespace fitclip;

namespace {

constexpr int kHeadDim = 64;
constexpr int kRowBytes = kHeadDim + 16;  // shared-memory row stride of K and Q
constexpr int kS8Warps = 4;
constexpr int kS8Rows = 16 * kS8Warps;   // query rows per block

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

// --- slice_requant --------------------------------------------------------------

template <typename T>
__global__ void slice_requant_kernel(const T* __restrict__ qkv, int8_t* __restrict__ out, int n,
                                     int row0, int rows, int width, float inv, size_t total) {
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t r = e / width;  // clip * rows + row
    const int col = static_cast<int>(e % width);
    const size_t row = (r / rows) * n + row0 + r % rows;
    out[row * width + col] = quant_rint(mul(to_float(qkv[row * 3 * width + col]), inv));
  }
}

// --- attn_amax ------------------------------------------------------------------

constexpr int kAmaxUnroll = 4;         // rows in flight per thread
constexpr int kAmaxMinRows = 16;       // fewest rows a CTA takes
constexpr unsigned kAmaxFloor = 0x358637bdu;  // the bits of 1e-6f

// |x| of two bf16 values as their bit patterns: sign cleared. As unsigned
// integers these order like the magnitudes, and a NaN (0x7f81-0x7fff) lies
// above +inf (0x7f80), so an integer max propagates NaN as jnp.max does.
__device__ __forceinline__ unsigned abs_bf16x2(unsigned w) { return w & 0x7fff7fffu; }

__device__ __forceinline__ unsigned max_abs(unsigned m, const uint4& v) {
  return __vmaxu2(__vmaxu2(m, __vmaxu2(abs_bf16x2(v.x), abs_bf16x2(v.y))),
                  __vmaxu2(abs_bf16x2(v.z), abs_bf16x2(v.w)));
}

__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// CTA (frame block, chunk) reads its chunk of the block's rows in address order;
// thread t owns the row's 16-byte vector t (of 3W / 8), so its part (q, k or v)
// is fixed: one divide per thread, none per element. The per-part maxima meet
// in shared memory, then in `scales` (zeroed by the C entry) through atomicMax
// on the bits of non-negative floats: max is exact in any order. Every CTA
// brings the 1e-6 floor.
__global__ void amax_rows_kernel(const __nv_bfloat16* __restrict__ qkv,
                                 unsigned* __restrict__ scales, int frames, int seq, int width,
                                 int block, int chunks) {
  const int fb = blockIdx.x / chunks, chunk = blockIdx.x - fb * chunks;
  const int vrow = 3 * width / 8;  // 16-byte vectors per row
  const long long r0 = static_cast<long long>(fb) * block * seq;
  const long long n = static_cast<long long>(min(block, frames - fb * block)) * seq;
  const long long begin = r0 + n * chunk / chunks, end = r0 + n * (chunk + 1) / chunks;
  const int t = threadIdx.x;
  __shared__ unsigned part_max[3];
  if (t < 3) part_max[t] = kAmaxFloor;
  __syncthreads();
  if (t < vrow) {
    const uint4* p = reinterpret_cast<const uint4*>(qkv) + begin * vrow + t;
    unsigned m = 0;
    long long r = begin;
    for (; r + kAmaxUnroll <= end; r += kAmaxUnroll, p += kAmaxUnroll * vrow) {
      uint4 v[kAmaxUnroll];
#pragma unroll
      for (int u = 0; u < kAmaxUnroll; ++u) v[u] = load_stream(p + u * vrow);
#pragma unroll
      for (int u = 0; u < kAmaxUnroll; ++u) m = max_abs(m, v[u]);
    }
    for (; r < end; ++r, p += vrow) m = max_abs(m, load_stream(p));
    const unsigned half = max(m & 0xffffu, m >> 16);  // bf16 bits -> fp32 bits
    atomicMax(&part_max[t / (width / 8)], half << 16);
  }
  __syncthreads();
  if (t < 3) atomicMax(&scales[fb * 3 + t], part_max[t]);
}

// --- attention_s8 ---------------------------------------------------------------

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment (16 x 32 bytes, row-major) and B fragment (32 x 8, columns
// contiguous) of m16n8k32 from shared memory with the given row strides.
__device__ __forceinline__ void load_a(uint32_t* a, const int8_t* base, int stride, int g, int t) {
  const int8_t* p0 = base + g * stride + t * 4;
  const int8_t* p1 = p0 + 8 * stride;
  a[0] = *reinterpret_cast<const uint32_t*>(p0);
  a[1] = *reinterpret_cast<const uint32_t*>(p1);
  a[2] = *reinterpret_cast<const uint32_t*>(p0 + 16);
  a[3] = *reinterpret_cast<const uint32_t*>(p1 + 16);
}

__device__ __forceinline__ void load_b(uint32_t* b, const int8_t* base, int stride, int g, int t) {
  const int8_t* q = base + g * stride + t * 4;
  b[0] = *reinterpret_cast<const uint32_t*>(q);
  b[1] = *reinterpret_cast<const uint32_t*>(q + 16);
}

struct S8Layout {
  int keys8;    // keys rounded up to the 8 of an n-tile
  int keys32;   // keys rounded up to the 32 of a k-step (P.V on the tensor cores)
  int lp;       // row-buffer pitch (fp32)
  int vstride;  // bytes per row of V^T and of the int8 weights
  size_t k_off, q_off, rows_off, v_off, w_off, total;
};

__host__ __device__ inline S8Layout s8_layout(int seq, bool av8) {
  S8Layout s;
  s.keys8 = (seq + 7) / 8 * 8;
  s.keys32 = (seq + 31) / 32 * 32;
  s.lp = s.keys8;
  s.vstride = s.keys32 + 16;
  s.k_off = 0;
  s.q_off = align16(static_cast<size_t>(s.keys8) * kRowBytes);
  s.rows_off = s.q_off + align16(static_cast<size_t>(kS8Rows) * kRowBytes);
  s.v_off = s.rows_off + align16(sizeof(float) * kS8Rows * s.lp);
  // i8qkav: V^T int8 (64 x vstride) and each warp's int8 weights (16 x vstride);
  // i8qk: V bf16 (seq x 64).
  s.w_off = s.v_off + align16(av8 ? static_cast<size_t>(kHeadDim) * s.vstride
                                  : sizeof(__nv_bfloat16) * static_cast<size_t>(seq) * kHeadDim);
  s.total = s.w_off + (av8 ? static_cast<size_t>(kS8Rows) * s.vstride : 0);
  return s;
}

template <bool kAV8>
__global__ void __launch_bounds__(kS8Warps * 32)
attention_s8_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ scales,
                    __nv_bfloat16* __restrict__ out, int seq, int heads, int block, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const S8Layout lay = s8_layout(seq, kAV8);
  int8_t* ks = reinterpret_cast<int8_t*>(smem + lay.k_off);
  int8_t* qs = reinterpret_cast<int8_t*>(smem + lay.q_off);
  float* rows = reinterpret_cast<float*>(smem + lay.rows_off);
  int8_t* vt = reinterpret_cast<int8_t*>(smem + lay.v_off);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + lay.v_off);
  int8_t* ws = reinterpret_cast<int8_t*>(smem + lay.w_off);

  const int width = heads * kHeadDim;
  const int q0 = blockIdx.x * kS8Rows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* base = qkv + static_cast<size_t>(b) * seq * 3 * width + h * kHeadDim;
  const float* sc = scales + (b / block) * 3;
  const float q_amax = sc[0], k_amax = sc[1], v_amax = sc[2];
  const float inv_q = div(127.f, q_amax), inv_k = div(127.f, k_amax), inv_v = div(127.f, v_amax);
  const float logit_scale = div(mul(mul(q_amax, k_amax), scale), 16129.f);

  // Quantize K (keys8 rows, zero past L) and this tile's Q rows into shared memory.
  for (int idx = tid; idx < lay.keys8 * kHeadDim; idx += kS8Warps * 32) {
    const int j = idx / kHeadDim, d = idx % kHeadDim;
    ks[j * kRowBytes + d] = j < seq ? quant_rint(mul(__bfloat162float(
        base[static_cast<size_t>(j) * 3 * width + width + d]), inv_k)) : 0;
  }
  for (int idx = tid; idx < kS8Rows * kHeadDim; idx += kS8Warps * 32) {
    const int r = idx / kHeadDim, d = idx % kHeadDim, i = q0 + r;
    qs[r * kRowBytes + d] = i < seq ? quant_rint(mul(__bfloat162float(
        base[static_cast<size_t>(i) * 3 * width + d]), inv_q)) : 0;
  }
  if (kAV8) {
    for (int idx = tid; idx < lay.keys32 * kHeadDim; idx += kS8Warps * 32) {
      const int j = idx / kHeadDim, d = idx % kHeadDim;
      vt[d * lay.vstride + j] = j < seq ? quant_rint(mul(__bfloat162float(
          base[static_cast<size_t>(j) * 3 * width + 2 * width + d]), inv_v)) : 0;
    }
  } else {
    for (int idx = tid; idx < seq * kHeadDim; idx += kS8Warps * 32) {
      const int j = idx / kHeadDim, d = idx % kHeadDim;
      vs[idx] = base[static_cast<size_t>(j) * 3 * width + 2 * width + d];
    }
  }
  __syncthreads();

  // QK^T: this warp's 16 rows against every key, 8 keys per n-tile.
  const int8_t* qw = qs + warp * 16 * kRowBytes;
  float* p = rows + warp * 16 * lay.lp;
  uint32_t af[2][4];
  load_a(af[0], qw, kRowBytes, g, t);
  load_a(af[1], qw + 32, kRowBytes, g, t);
  for (int n0 = 0; n0 < lay.keys8; n0 += 8) {
    int c[4] = {0, 0, 0, 0};
    uint32_t bf[2];
    load_b(bf, ks + n0 * kRowBytes, kRowBytes, g, t);
    mma_s8(c, af[0], bf);
    load_b(bf, ks + n0 * kRowBytes + 32, kRowBytes, g, t);
    mma_s8(c, af[1], bf);
    // c[0], c[1]: row g, keys n0 + 2t, + 1; c[2], c[3]: row g + 8.
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      p[(g + (r >= 2 ? 8 : 0)) * lay.lp + n0 + 2 * t + (r & 1)] =
          mul(__int2float_rn(c[r]), logit_scale);
    }
  }
  __syncwarp();

  // Softmax of each of the 16 rows, lanes over the keys.
  int8_t* ww = ws + warp * 16 * lay.vstride;
  for (int r = 0; r < 16; ++r) {
    float* pr = p + r * lay.lp;
    float peak = -INFINITY;
    for (int j = lane; j < seq; j += 32) peak = fmaxf(peak, pr[j]);
    peak = warp_max(peak);
    float denom = 0.f;
    for (int j = lane; j < seq; j += 32) {
      const float e = expf(sub(pr[j], peak));
      pr[j] = e;
      denom += e;
    }
    denom = warp_sum(denom);
    if (kAV8) {
      for (int j = lane; j < lay.keys32; j += 32) {
        ww[r * lay.vstride + j] = j < seq ? static_cast<int8_t>(static_cast<int>(
            rintf(mul(div(pr[j], denom), 127.f)))) : 0;
      }
    } else {
      for (int j = lane; j < seq; j += 32) pr[j] = bf16_round(div(pr[j], denom));
    }
  }
  __syncwarp();

  const size_t out_base = static_cast<size_t>(b) * seq * width + h * kHeadDim;
  if (kAV8) {
    // P.V on the tensor cores: (16 x keys32) int8 weights x (keys32 x 64) int8 V.
    int acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[nt][r] = 0;
    for (int k0 = 0; k0 < lay.keys32; k0 += 32) {
      uint32_t a[4];
      load_a(a, ww + k0, lay.vstride, g, t);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t bf[2];
        load_b(bf, vt + nt * 8 * lay.vstride + k0, lay.vstride, g, t);
        mma_s8(acc[nt], a, bf);
      }
    }
    const float out_scale = div(v_amax, 16129.f);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = q0 + warp * 16 + g + (r >= 2 ? 8 : 0);
        if (i < seq) {
          out[out_base + static_cast<size_t>(i) * width + nt * 8 + 2 * t + (r & 1)] =
              __float2bfloat16_rn(mul(__int2float_rn(acc[nt][r]), out_scale));
        }
      }
  } else {
    // P.V on the CUDA cores, lanes over the 64 output columns (two each).
    for (int r = 0; r < 16; ++r) {
      const int i = q0 + warp * 16 + r;
      if (i >= seq) break;
      const float* pr = p + r * lay.lp;
      float o0 = 0.f, o1 = 0.f;
      for (int j = 0; j < seq; ++j) {
        o0 = fmaf(pr[j], __bfloat162float(vs[j * kHeadDim + lane]), o0);
        o1 = fmaf(pr[j], __bfloat162float(vs[j * kHeadDim + lane + 32]), o1);
      }
      out[out_base + static_cast<size_t>(i) * width + lane] = __float2bfloat16_rn(o0);
      out[out_base + static_cast<size_t>(i) * width + lane + 32] = __float2bfloat16_rn(o1);
    }
  }
}

}  // namespace

// out (clips, n, W) int8, rows [row0, row0 + rows) of each clip, from qkv (clips, n, 3W).
extern "C" int fitclip_slice_requant(const void* qkv, int dtype, void* out, int clips, int n,
                                     int row0, int rows, int width, float inv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t total = static_cast<size_t>(clips) * rows * width;
  const int threads = 256;
  const size_t blocks = (total + threads - 1) / threads;
  const int grid = static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
  int8_t* o = static_cast<int8_t*>(out);
  if (dtype == kBFloat16) {
    slice_requant_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(qkv), o, n, row0, rows, width, inv, total);
  } else if (dtype == kFloat32) {
    slice_requant_kernel<float><<<grid, threads, 0, s>>>(static_cast<const float*>(qkv), o, n, row0,
                                                         rows, width, inv, total);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// scales (ceil(frames / block), 3) fp32 from bf16 qkv (frames, seq, 3 * width):
// width a multiple of 8 with 3 * width / 8 <= 1024 (one thread per 16-byte
// vector of a row). The grid spreads each frame block over enough CTAs to fill
// the SMs (at least kAmaxMinRows rows a CTA).
extern "C" int fitclip_attn_amax(const void* qkv, void* scales, int frames, int seq, int width,
                                 int block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vrow = 3 * width / 8;
  if (width <= 0 || width % 8 != 0 || vrow > 1024 || frames <= 0 || seq <= 0 || block <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (frames + block - 1) / block;
  cudaError_t err = cudaMemsetAsync(scales, 0, sizeof(float) * 3 * blocks, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = (vrow + 31) / 32 * 32;
  static int resident = 0;  // CTAs the card holds at once at this CTA size
  static int resident_threads = 0;
  if (resident_threads != threads) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, amax_rows_kernel, threads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = sms * per_sm;
    resident_threads = threads;
  }
  const long long rows = static_cast<long long>(std::min(block, frames)) * seq;
  const int chunks = static_cast<int>(
      std::max(1LL, std::min((resident + blocks - 1LL) / blocks, rows / kAmaxMinRows)));
  amax_rows_kernel<<<blocks * chunks, threads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<unsigned*>(scales), frames, seq, width,
      block, chunks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" size_t fitclip_attention_s8_smem_bytes(int seq, int av8) {
  return s8_layout(seq, av8 != 0).total;
}

// bf16 qkv (frames, seq, 3 * heads * 64), scales from fitclip_attn_amax -> bf16 out
// (frames, seq, heads * 64). av8: the i8qkav arm, else i8qk.
extern "C" int fitclip_attention_s8(const void* qkv, const void* scales, void* out, int frames,
                                    int seq, int heads, int block, float scale, int av8,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = s8_layout(seq, av8 != 0).total;
  const dim3 grid((seq + kS8Rows - 1) / kS8Rows, heads, frames);
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* sc = static_cast<const float*>(scales);
  auto* o = static_cast<__nv_bfloat16*>(out);
  cudaError_t err;
  if (av8) {
    err = cudaFuncSetAttribute(attention_s8_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_s8_kernel<true><<<grid, kS8Warps * 32, smem, s>>>(q, sc, o, seq, heads, block, scale);
  } else {
    err = cudaFuncSetAttribute(attention_s8_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_s8_kernel<false><<<grid, kS8Warps * 32, smem, s>>>(q, sc, o, seq, heads, block, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
