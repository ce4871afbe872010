// attention: multi-head self-attention over the unsplit (B, L, 3 * H * D) QKV
// projection output, head_dim D = 32 or 64, one block per (query tile, head,
// batch row).
//
// Replaces the attention of four TPU kernels:
//   int8 mode   the per-head core of fitclip_tpu/ops/block.py:_layer_kernel
//               (_attention_core with out_mul): weights = exps * (out_mul / denom),
//               fp32 output rounded and clipped to int8, the out-projection's input;
//   qkv mode    fitclip_tpu/ops/attention.py:_packed_kernel (fused_attention_qkv,
//               forward) and the attention of _int8_qkv_attention_kernel (K8):
//               weights = exps / denom, output in qkv's dtype;
//   block mode  the core of fitclip_tpu/ops/block.py:_bf16_layer_kernel (K2,
//               _attention_core without out_mul): weights = exps * (1 / denom), the
//               fp32 output rounded to qkv's dtype, as the out-projection casts it.
// and the attention cores of the TPU ablation benches (bf16, head_dim 64 only):
//   scripts/bench_block_layer.py:make_run (S1), int8 output:
//     div       _attention_core's weights exps * (1 / denom), fp32 P.V, then
//               rint(att * out_mul) (the `full` arm: the requant after the core);
//     fold2     exp2((l - peak) * log2e), weights exps * (out_mul * rcp.approx(sum))
//               (`avfold2`);
//     sm2       q arrives scaled by D^-1/2 * log2e (folded into the QKV dense's
//               scale on the host): exp2(l - peak), weights exps * rcp.approx(sum),
//               then rint(att * out_mul); sm2div divides exactly (`sm2div`);
//     nomax     exp(l) with no max subtraction, exps / denom, rint(att * out_mul);
//     cast      the `full` core with its fp32 output truncated to int8 (`noquant`);
//   scripts/bench_attn_int8.py:_variant_kernel (S2), output in qkv's dtype:
//     head0     every head attends with head 0's q, k and v (`nopack`: the
//               per-head factor 1 + h * 1e-6 rounds to 1 in bf16);
//     bf16logits  logits rounded to bf16, exp in bf16, an fp32 sum, weights
//               exps * bf16(1 / denom) in bf16;
//     nosoftmax weights = bf16(logits), for timing only.
// All scale q in qkv's dtype before QK^T, keep logits and softmax in fp32,
// cast the weights to v's dtype before P.V, and skip keys that the causal mask
// (finfo.min) or the seq_valid key mask (-1e30) would zero: exp() of either
// is exactly 0, so skipping them gives the same sums.
//
// On the H100 this is bound by latency and shared-memory bandwidth, not by
// device memory: one head's K and V fit in shared memory (2 x 197 x 64 bf16 = 50
// KB at ViT-B/16), and a block reads them once for 64 query rows. Each warp
// takes one query row at a time: q sits in registers, lane j computes the
// logits of keys j, j + 32, ... against K stored transposed (conflict-free), then
// each lane accumulates D / 32 of the output columns over P.V. The products run
// on the CUDA cores; a tensor-core (mma) version is later work.
//
// Where K and V do not fit (fp32 at L = 577, ViT-L/14@336: 296 KB of the 227 KB),
// the v_global variant keeps only K^T in shared memory (148 KB) and reads V
// through L2: each lane reads its output columns of key j, 32 lanes on 32
// consecutive values. The wrapper picks it by shape (fitclip_attention_smem_bytes).
#include "common.cuh"

using namespace fitclip;

namespace {

constexpr int kWarps = 8;
constexpr int kQueryTile = 64;
constexpr float kLog2e = 1.4426950408889634f;
enum Mode : int {
  kQkv = 0, kInt8 = 1, kBlock = 2,
  kDiv = 3, kFold2 = 4, kSm2 = 5, kSm2Div = 6, kNoMax = 7, kCast = 8,
  kHead0 = 9, kBf16Logits = 10, kNoSoftmax = 11,
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

// Shared memory: K^T (D x lp), V (L x D) unless read through L2, per-warp row
// buffers (kWarps x lp fp32).
template <typename T>
size_t smem_bytes(int seq, int lp, int head_dim, bool v_global) {
  return align16(sizeof(T) * head_dim * lp) +
         (v_global ? 0 : align16(sizeof(T) * static_cast<size_t>(seq) * head_dim)) +
         sizeof(float) * kWarps * lp;
}

template <int kMode>
__host__ __device__ constexpr bool int8_out() {
  return kMode == kInt8 || kMode == kDiv || kMode == kFold2 || kMode == kSm2 || kMode == kSm2Div ||
         kMode == kNoMax || kMode == kCast;
}

template <typename T, int D, int kMode, bool kVGlobal>
__global__ void __launch_bounds__(kWarps * 32)
attention_kernel(const T* __restrict__ qkv, void* __restrict__ out, int seq, int lp, int heads,
                 float scale, int causal, int seq_valid, float out_mul) {
  constexpr int kCols = D / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  T* kt = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + align16(sizeof(T) * D * lp));
  float* rows = reinterpret_cast<float*>(
      smem + align16(sizeof(T) * D * lp) +
      (kVGlobal ? 0 : align16(sizeof(T) * static_cast<size_t>(seq) * D)));

  const int width = heads * D;
  const int q0 = blockIdx.x * kQueryTile, h = blockIdx.y, b = blockIdx.z;
  const int hl = kMode == kHead0 ? 0 : h;  // the head whose q, k and v are read
  const int q1 = min(q0 + kQueryTile, seq);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* base = qkv + static_cast<size_t>(b) * seq * 3 * width;
  const T* vg = base + 2 * width + hl * D;  // V of key j at vg[j * 3 * width]

  // The keys any row of this tile can see.
  const int keys = min(causal ? q1 : seq, seq_valid);
  for (int idx = tid; idx < keys * D; idx += kWarps * 32) {
    const int j = idx / D, d = idx % D;
    const T* src = base + static_cast<size_t>(j) * 3 * width + hl * D + d;
    kt[d * lp + j] = src[width];
    if (!kVGlobal) vs[j * D + d] = src[2 * width];
  }
  __syncthreads();

  const float scale_t = to_float(from_float<T>(scale));
  float* p = rows + warp * lp;
  for (int i = q0 + warp; i < q1; i += kWarps) {
    const T* qrow = base + static_cast<size_t>(i) * 3 * width + hl * D;
    float q[D];
#pragma unroll
    for (int d = 0; d < D; ++d) q[d] = to_float(from_float<T>(mul(to_float(qrow[d]), scale_t)));

    const int nk = min(causal ? i + 1 : seq, seq_valid);
    float peak = kMode == kNoMax ? 0.f : -INFINITY;
    for (int j = lane; j < nk; j += 32) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(q[d], to_float(kt[d * lp + j]), s);
      if (kMode == kBf16Logits) s = bf16_round(s);
      p[j] = s;
      if (kMode != kNoMax) peak = fmaxf(peak, s);
    }
    if (kMode == kNoSoftmax) {
      for (int j = lane; j < nk; j += 32) p[j] = to_float(from_float<T>(p[j]));
    } else {
      if (kMode != kNoMax) peak = warp_max(peak);
      float denom = 0.f;
      for (int j = lane; j < nk; j += 32) {
        float e;
        if (kMode == kFold2) {
          e = exp2f(mul(sub(p[j], peak), kLog2e));
        } else if (kMode == kSm2 || kMode == kSm2Div) {
          e = exp2f(sub(p[j], peak));
        } else if (kMode == kNoMax) {
          e = expf(p[j]);
        } else if (kMode == kBf16Logits) {
          e = bf16_round(expf(bf16_round(sub(p[j], peak))));
        } else {
          e = expf(sub(p[j], peak));
        }
        p[j] = e;
        denom += e;
      }
      denom = warp_sum(denom);
      // The multiplier of each weight, where the mode multiplies.
      float norm;
      if (kMode == kInt8) norm = div(out_mul, denom);
      else if (kMode == kFold2) norm = mul(out_mul, rcp_approx(denom));
      else if (kMode == kSm2) norm = rcp_approx(denom);
      else if (kMode == kBf16Logits) norm = bf16_round(div(1.f, denom));
      else norm = div(1.f, denom);  // kBlock, kDiv, kCast; unused by the dividing modes
      for (int j = lane; j < nk; j += 32) {
        float wgt;
        if (kMode == kQkv || kMode == kHead0 || kMode == kSm2Div || kMode == kNoMax) {
          wgt = div(p[j], denom);
        } else if (kMode == kBf16Logits) {
          wgt = bf16_round(mul(p[j], norm));
        } else {
          wgt = mul(p[j], norm);
        }
        p[j] = to_float(from_float<T>(wgt));
      }
    }
    __syncwarp();

    float o[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[c] = 0.f;
    for (int j = 0; j < nk; ++j) {
      const float wgt = p[j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float v = kVGlobal ? to_float(vg[static_cast<size_t>(j) * 3 * width + lane + 32 * c])
                                 : to_float(vs[j * D + lane + 32 * c]);
        o[c] = fmaf(wgt, v, o[c]);
      }
    }
    const size_t o_row = (static_cast<size_t>(b) * seq + i) * width + h * D + lane;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if constexpr (int8_out<kMode>()) {
        int8_t* dst = static_cast<int8_t*>(out);
        int8_t v;
        if (kMode == kInt8 || kMode == kFold2) v = quant_rint(o[c]);
        else if (kMode == kCast) v = trunc_int8(o[c]);
        else v = quant_rint(mul(o[c], out_mul));
        dst[o_row + 32 * c] = v;
      } else {
        static_cast<T*>(out)[o_row + 32 * c] = from_float<T>(o[c]);
      }
    }
    __syncwarp();  // the next row overwrites p
  }
}

template <typename T, int D, int kMode, bool kVGlobal>
int launch(const void* qkv, void* out, int batch, int seq, int heads, float scale, int causal,
           int seq_valid, float out_mul, cudaStream_t s) {
  const int lp = seq + (seq & 1);
  const size_t smem = smem_bytes<T>(seq, lp, D, kVGlobal);
  auto kernel = attention_kernel<T, D, kMode, kVGlobal>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((seq + kQueryTile - 1) / kQueryTile, heads, batch);
  kernel<<<grid, kWarps * 32, smem, s>>>(static_cast<const T*>(qkv), out, seq, lp, heads, scale,
                                          causal, seq_valid, out_mul);
  return static_cast<int>(cudaGetLastError());
}

// The shipped modes, for either head_dim and dtype; V in shared memory.
template <typename T, int D>
int dispatch_shipped(int mode, const void* qkv, void* out, int batch, int seq, int heads,
                     float scale, int causal, int seq_valid, float out_mul, cudaStream_t s) {
  switch (mode) {
    case kQkv: return launch<T, D, kQkv, false>(qkv, out, batch, seq, heads, scale, causal, seq_valid, out_mul, s);
    case kInt8: return launch<T, D, kInt8, false>(qkv, out, batch, seq, heads, scale, causal, seq_valid, out_mul, s);
    case kBlock: return launch<T, D, kBlock, false>(qkv, out, batch, seq, heads, scale, causal, seq_valid, 1.f, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The shipped modes with V read through L2 (fp32, head_dim 64: the shape that
// overflows shared memory at L = 577).
int dispatch_v_global(int mode, const void* qkv, void* out, int batch, int seq, int heads,
                      float scale, int causal, int seq_valid, float out_mul, cudaStream_t s) {
  switch (mode) {
    case kQkv: return launch<float, 64, kQkv, true>(qkv, out, batch, seq, heads, scale, causal, seq_valid, out_mul, s);
    case kInt8: return launch<float, 64, kInt8, true>(qkv, out, batch, seq, heads, scale, causal, seq_valid, out_mul, s);
    case kBlock: return launch<float, 64, kBlock, true>(qkv, out, batch, seq, heads, scale, causal, seq_valid, 1.f, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bench arms' modes: bf16, head_dim 64.
int dispatch_bench(int mode, const void* qkv, void* out, int batch, int seq, int heads,
                   float scale, int causal, int seq_valid, float out_mul, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
#define FITCLIP_BENCH_MODE(M) \
  case M: return launch<bf16, 64, M, false>(qkv, out, batch, seq, heads, scale, causal, seq_valid, out_mul, s);
  switch (mode) {
    FITCLIP_BENCH_MODE(kDiv)
    FITCLIP_BENCH_MODE(kFold2)
    FITCLIP_BENCH_MODE(kSm2)
    FITCLIP_BENCH_MODE(kSm2Div)
    FITCLIP_BENCH_MODE(kNoMax)
    FITCLIP_BENCH_MODE(kCast)
    FITCLIP_BENCH_MODE(kHead0)
    FITCLIP_BENCH_MODE(kBf16Logits)
    FITCLIP_BENCH_MODE(kNoSoftmax)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FITCLIP_BENCH_MODE
}

}  // namespace

extern "C" size_t fitclip_attention_smem_bytes(int dtype, int seq, int head_dim, int v_global) {
  const int lp = seq + (seq & 1);
  return dtype == kBFloat16 ? smem_bytes<__nv_bfloat16>(seq, lp, head_dim, v_global != 0)
                            : smem_bytes<float>(seq, lp, head_dim, v_global != 0);
}

// mode: see Mode. The int8-output modes write int8, the others qkv's dtype;
// out_mul is the requant multiplier of the int8 modes (unused by qkv and the S2
// modes). v_global: read V through L2 (fp32, head_dim 64, shipped modes only).
extern "C" int fitclip_attention(const void* qkv, int dtype, void* out, int mode, int batch,
                                 int seq, int heads, int head_dim, float scale, int causal,
                                 int seq_valid, float out_mul, int v_global, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode > kBlock) {
    if (dtype != kBFloat16 || head_dim != 64 || v_global) return static_cast<int>(cudaErrorInvalidValue);
    return dispatch_bench(mode, qkv, out, batch, seq, heads, scale, causal, seq_valid, out_mul, s);
  }
  if (v_global) {
    if (dtype != kFloat32 || head_dim != 64) return static_cast<int>(cudaErrorInvalidValue);
    return dispatch_v_global(mode, qkv, out, batch, seq, heads, scale, causal, seq_valid, out_mul, s);
  }
  if (dtype == kBFloat16 && head_dim == 64)
    return dispatch_shipped<__nv_bfloat16, 64>(mode, qkv, out, batch, seq, heads, scale, causal, seq_valid, out_mul, s);
  if (dtype == kBFloat16 && head_dim == 32)
    return dispatch_shipped<__nv_bfloat16, 32>(mode, qkv, out, batch, seq, heads, scale, causal, seq_valid, out_mul, s);
  if (dtype == kFloat32 && head_dim == 64)
    return dispatch_shipped<float, 64>(mode, qkv, out, batch, seq, heads, scale, causal, seq_valid, out_mul, s);
  if (dtype == kFloat32 && head_dim == 32)
    return dispatch_shipped<float, 32>(mode, qkv, out, batch, seq, heads, scale, causal, seq_valid, out_mul, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
