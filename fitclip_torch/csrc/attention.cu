// attention: multi-head self-attention over the unsplit (B, L, 3 * H * D) QKV
// projection output, head_dim D = 64, one block per (query tile, head, batch row).
//
// Replaces two TPU kernels' attention:
//   int8 mode  the per-head core of fitclip_tpu/ops/block.py:_layer_kernel
//              (_attention_core with out_mul): weights = exps * (out_mul / denom),
//              fp32 output rounded and clipped to int8, the out-projection's input;
//   qkv mode   fitclip_tpu/ops/attention.py:_packed_kernel (fused_attention_qkv,
//              forward): weights = exps / denom, output in qkv's dtype.
// Both scale q in qkv's dtype before QK^T, keep logits and softmax in fp32,
// cast the weights to v's dtype before P.V, and skip keys that the causal mask
// (finfo.min) or the seq_valid key mask (-1e30) would zero: exp() of either
// is exactly 0, so skipping them gives the same sums.
//
// On the H100 this is bound by latency and shared-memory bandwidth, not by
// device memory: at L <= 577 one head's K and V fit in shared memory (2 x 197 x 64
// bf16 = 50 KB at ViT-B/16), and a block reads them once for 64 query rows. Each
// warp takes one query row at a time: q sits in registers, lane j computes the
// logits of keys j, j + 32, ... against K stored transposed (conflict-free), then
// each lane accumulates two of the 64 output columns over P.V. The products run
// on the CUDA cores; a tensor-core (mma) version is later work.
#include "common.cuh"

using namespace fitclip;

namespace {

constexpr int kHeadDim = 64;
constexpr int kWarps = 8;
constexpr int kQueryTile = 64;

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

// Shared memory: K^T (kHeadDim x lp), V (L x kHeadDim), per-warp row buffers (kWarps x lp fp32).
template <typename T>
size_t smem_bytes(int seq, int lp) {
  return align16(sizeof(T) * kHeadDim * lp) + align16(sizeof(T) * static_cast<size_t>(seq) * kHeadDim) +
         sizeof(float) * kWarps * lp;
}

template <typename T, bool kInt8Out>
__global__ void __launch_bounds__(kWarps * 32)
attention_kernel(const T* __restrict__ qkv, void* __restrict__ out, int seq, int lp, int heads,
                 float scale, int causal, int seq_valid, float out_mul) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* kt = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + align16(sizeof(T) * kHeadDim * lp));
  float* rows = reinterpret_cast<float*>(smem + align16(sizeof(T) * kHeadDim * lp) +
                                         align16(sizeof(T) * static_cast<size_t>(seq) * kHeadDim));

  const int width = heads * kHeadDim;
  const int q0 = blockIdx.x * kQueryTile, h = blockIdx.y, b = blockIdx.z;
  const int q1 = min(q0 + kQueryTile, seq);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* base = qkv + static_cast<size_t>(b) * seq * 3 * width;

  // The keys any row of this tile can see.
  const int keys = min(causal ? q1 : seq, seq_valid);
  for (int idx = tid; idx < keys * kHeadDim; idx += kWarps * 32) {
    const int j = idx / kHeadDim, d = idx % kHeadDim;
    const T* src = base + static_cast<size_t>(j) * 3 * width + h * kHeadDim + d;
    kt[d * lp + j] = src[width];
    vs[j * kHeadDim + d] = src[2 * width];
  }
  __syncthreads();

  const float scale_t = to_float(from_float<T>(scale));
  float* p = rows + warp * lp;
  for (int i = q0 + warp; i < q1; i += kWarps) {
    const T* qrow = base + static_cast<size_t>(i) * 3 * width + h * kHeadDim;
    float q[kHeadDim];
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) q[d] = to_float(from_float<T>(mul(to_float(qrow[d]), scale_t)));

    const int nk = min(causal ? i + 1 : seq, seq_valid);
    float peak = -INFINITY;
    for (int j = lane; j < nk; j += 32) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) s = fmaf(q[d], to_float(kt[d * lp + j]), s);
      p[j] = s;
      peak = fmaxf(peak, s);
    }
    peak = warp_max(peak);
    float denom = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float e = expf(sub(p[j], peak));
      p[j] = e;
      denom += e;
    }
    denom = warp_sum(denom);
    const float norm = kInt8Out ? div(out_mul, denom) : 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float wgt = kInt8Out ? mul(p[j], norm) : div(p[j], denom);
      p[j] = to_float(from_float<T>(wgt));
    }
    __syncwarp();

    float o0 = 0.f, o1 = 0.f;
    for (int j = 0; j < nk; ++j) {
      const float wgt = p[j];
      o0 = fmaf(wgt, to_float(vs[j * kHeadDim + lane]), o0);
      o1 = fmaf(wgt, to_float(vs[j * kHeadDim + lane + 32]), o1);
    }
    const size_t o = (static_cast<size_t>(b) * seq + i) * width + h * kHeadDim + lane;
    if (kInt8Out) {
      int8_t* dst = static_cast<int8_t*>(out);
      dst[o] = quant_rint(o0);
      dst[o + 32] = quant_rint(o1);
    } else {
      T* dst = static_cast<T*>(out);
      dst[o] = from_float<T>(o0);
      dst[o + 32] = from_float<T>(o1);
    }
    __syncwarp();  // the next row overwrites p
  }
}

template <typename T, bool kInt8Out>
int launch(const void* qkv, void* out, int batch, int seq, int heads, float scale, int causal,
           int seq_valid, float out_mul, cudaStream_t s) {
  const int lp = seq + (seq & 1);
  const size_t smem = smem_bytes<T>(seq, lp);
  auto kernel = attention_kernel<T, kInt8Out>;
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

}  // namespace

extern "C" size_t fitclip_attention_smem_bytes(int dtype, int seq) {
  const int lp = seq + (seq & 1);
  return dtype == kBFloat16 ? smem_bytes<__nv_bfloat16>(seq, lp) : smem_bytes<float>(seq, lp);
}

// int8_out = 1: int8 mode (out_mul folded into the normalizer, int8 output);
// int8_out = 0: qkv mode (output in qkv's dtype, out_mul unused).
extern "C" int fitclip_attention(const void* qkv, int dtype, void* out, int int8_out, int batch,
                                 int seq, int heads, int head_dim, float scale, int causal,
                                 int seq_valid, float out_mul, void* stream) {
  if (head_dim != kHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == kBFloat16) {
    return int8_out ? launch<bf16, true>(qkv, out, batch, seq, heads, scale, causal, seq_valid, out_mul, s)
                    : launch<bf16, false>(qkv, out, batch, seq, heads, scale, causal, seq_valid, out_mul, s);
  }
  if (dtype == kFloat32) {
    return int8_out ? launch<float, true>(qkv, out, batch, seq, heads, scale, causal, seq_valid, out_mul, s)
                    : launch<float, false>(qkv, out, batch, seq, heads, scale, causal, seq_valid, out_mul, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
