// attention_bwd: the backward of multi-head self-attention over the unsplit
// (B, L, 3 * H * D) QKV projection output, head_dim D = 32 or 64.
//
// Replaces fitclip_tpu/ops/attention.py:_packed_bwd_kernel (K3b, reached from
// _bwd -> _backward_packed). Given qkv and the output's gradient g (B, L, H * D),
// it writes the packed dqkv (B, L, 3 * H * D) in qkv's dtype with the TPU
// kernel's casts: q is scaled in qkv's dtype; logits, softmax weights W32 and
// dW = g v^T are fp32; the weights cast to v's dtype feed dV = W^T g;
// dL = W32 * (dW - rowsum(dW * W32)) is cast to q's dtype; dQ = dL k * scale,
// dK = dL^T q_s, all three accumulated in fp32. Keys past the causal limit
// are skipped: their weight, and so their dL, is exactly 0 in the reference.
//
// The TPU kernel holds a block's whole (L, L) logits, weights, dW and dL in
// VMEM. An SM has 227 KB, and blocks run in parallel with no order, so the two
// reductions over L (rows for dQ, columns for dK and dV) are two kernels, the
// rows kernel storing each row's peak, denominator and inner = rowsum(dW * W32)
// for the columns kernel. Every output element is written by one thread with a
// fixed summation order and there are no atomics, so the result is
// deterministic run to run.
//
// Four bodies; the wrapper picks one from (dtype, L, head_dim)
// (fitclip_torch/ops/attention.py:backward_body) and the entry refuses any
// other (fitclip_attention_bwd_body is the same rule):
//   mma         bf16: the tensor-core kernels of attention_bwd_mma.cuh (every
//               product on mma.sync, the operands of a block in shared memory
//               once), for any L whose q_s, g and statistics fit a block (up
//               to 848 at head_dim 64).
//   mma_global  bf16 past that: the same kernels with K alone in the rows
//               kernel's shared memory and q_s alone in the columns kernel's,
//               V and g read from device memory through L2.
//   f32_32, f32_16  fp32, register-tiled on the CUDA cores (the tensor cores
//               would take fp32 as TF32; see attention_f32.cuh):
//               rows_f32_kernel with 32 query rows a block, or 16 where its two
//               row buffers of logits/W32 and dW/dL no longer fit (past L = 680
//               at head_dim 64, 776 at 32; 16 rows take up to 1448 and 1608),
//               then columns_f32_kernel, 64 keys a block whatever L
//               (flash-style: q_s, g and the statistics stream past the
//               block's K and V). Both recompute the logits and dW in the same
//               fmaf chains, so the columns kernel's W32 and dL are the rows
//               kernel's bits. The sums over keys and rows run in the order of
//               the CUDA-core kernels these replaced, so dqkv is their bits.
//               Per pair and head the split does 7 products of D (two
//               recomputed) for the 5 of the function: at most ~70% of the
//               FFMA rate reaches the 10 B H L^2 D bound.
#include "attention_bwd_mma.cuh"
#include "attention_f32.cuh"

using namespace fitclip;

namespace {

enum Body : int { kBodyMma = 0, kBodyMmaGlobal = 1, kBodyF32Rows32 = 2, kBodyF32Rows16 = 3 };

constexpr size_t kSmemLimit = 232448;  // shared memory a block can use on an H100

// --- the mma body (bf16) -----------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int D, int kSteps, bool kSweep, bool kG>
int launch_mma(const void* qkv, const void* grad, void* dqkv, float* stats, int batch, int seq, int heads,
               float scale, int causal, cudaStream_t s) {
  using attn::bf16;
  auto rows = attn::bwd::rows_mma_kernel<D, kSteps, kSweep, kG>;
  auto columns = attn::bwd::columns_mma_kernel<D, kG>;
  const size_t rows_smem = attn::bwd::rows_smem_bytes(seq, D, kG);
  const size_t columns_smem = attn::bwd::columns_smem_bytes(seq, D, kG);
  cudaError_t err = allow_smem(rows, rows_smem);
  if (err == cudaSuccess) err = allow_smem(columns, columns_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + attn::kBlockRows - 1) / attn::kBlockRows, heads, batch);
  const size_t plane = static_cast<size_t>(batch) * heads * seq;
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* g = static_cast<const bf16*>(grad);
  bf16* d = static_cast<bf16*>(dqkv);
  rows<<<grid, attn::kThreads, rows_smem, s>>>(q, g, d, stats, seq, heads, scale, causal, plane);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  columns<<<grid, attn::kThreads, columns_smem, s>>>(q, g, d, stats, seq, heads, scale, causal, plane);
  return static_cast<int>(cudaGetLastError());
}

// The rows kernel's register tier by length, as the forward's: logits resident
// up to 80 or 208 keys, the sweep past that (and in the global body, which
// only lengths past 848 take).
template <int D>
int launch_mma_body(int body, const void* qkv, const void* grad, void* dqkv, float* stats, int batch, int seq,
                    int heads, float scale, int causal, cudaStream_t s) {
  if (body == kBodyMmaGlobal)
    return launch_mma<D, attn::kSweepSteps, true, true>(qkv, grad, dqkv, stats, batch, seq, heads, scale, causal, s);
  if (seq <= 16 * attn::kSmallSteps)
    return launch_mma<D, attn::kSmallSteps, false, false>(qkv, grad, dqkv, stats, batch, seq, heads, scale, causal,
                                                          s);
  if (seq <= attn::kResidentKeys)
    return launch_mma<D, attn::kLargeSteps, false, false>(qkv, grad, dqkv, stats, batch, seq, heads, scale, causal,
                                                          s);
  return launch_mma<D, attn::kSweepSteps, true, false>(qkv, grad, dqkv, stats, batch, seq, heads, scale, causal, s);
}

// --- the fp32 tiers (CUDA cores, register-tiled: attention_f32.cuh) ---------------

namespace fa = fitclip::f32attn;

// Query rows per block of the rows kernel, by body code.
constexpr int f32_rows(int body) { return body == kBodyF32Rows32 ? 32 : 16; }

size_t f32_smem_bytes(int seq, int head_dim, int body) {
  const size_t rows = fa::rows_smem_bytes(seq, head_dim, f32_rows(body));
  const size_t columns = fa::columns_smem_bytes(head_dim);
  return rows > columns ? rows : columns;
}

template <int D, int R>
int launch_f32(const void* qkv, const void* grad, void* dqkv, float* stats, int batch, int seq, int heads,
               float scale, int causal, cudaStream_t s) {
  auto rows = fa::rows_f32_kernel<D, R / 16>;
  auto columns = fa::columns_f32_kernel<D>;
  const size_t rows_smem = fa::rows_smem_bytes(seq, D, R);
  const size_t columns_smem = fa::columns_smem_bytes(D);
  cudaError_t err = allow_smem(rows, rows_smem);
  if (err == cudaSuccess) err = allow_smem(columns, columns_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t plane = static_cast<size_t>(batch) * heads * seq;
  const float* q = static_cast<const float*>(qkv);
  const float* g = static_cast<const float*>(grad);
  float* d = static_cast<float*>(dqkv);
  rows<<<dim3((seq + R - 1) / R, heads, batch), fa::kThreads, rows_smem, s>>>(q, g, d, stats, seq, heads, scale,
                                                                              causal, plane);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  columns<<<dim3((seq + fa::kTile - 1) / fa::kTile, heads, batch), fa::kThreads, columns_smem, s>>>(
      q, g, d, stats, seq, heads, scale, causal, plane);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32_tier(int body, const void* qkv, const void* grad, void* dqkv, float* stats, int batch, int seq,
                    int heads, float scale, int causal, cudaStream_t s) {
  if (body == kBodyF32Rows32) return launch_f32<D, 32>(qkv, grad, dqkv, stats, batch, seq, heads, scale, causal, s);
  return launch_f32<D, 16>(qkv, grad, dqkv, stats, batch, seq, heads, scale, causal, s);
}

}  // namespace

// The body that takes (dtype, L, head_dim), or -1 where none does: the rule of
// fitclip_torch/ops/attention.py:backward_body.
extern "C" int fitclip_attention_bwd_body(int dtype, int seq, int head_dim) {
  if (seq < 1 || (head_dim != 32 && head_dim != 64)) return -1;
  if (dtype == kBFloat16) {
    if (attn::bwd::columns_smem_bytes(seq, head_dim, false) <= kSmemLimit) return kBodyMma;
    if (attn::bwd::columns_smem_bytes(seq, head_dim, true) <= kSmemLimit) return kBodyMmaGlobal;
  }
  if (dtype == kFloat32) {
    for (int body = kBodyF32Rows32; body <= kBodyF32Rows16; ++body)
      if (f32_smem_bytes(seq, head_dim, body) <= kSmemLimit) return body;
  }
  return -1;
}

// Shared memory per block of a body at (L, head_dim): the larger of its two kernels'.
extern "C" size_t fitclip_attention_bwd_smem_bytes(int seq, int head_dim, int body) {
  if (body == kBodyMma || body == kBodyMmaGlobal)
    return attn::bwd::columns_smem_bytes(seq, head_dim, body == kBodyMmaGlobal);
  return f32_smem_bytes(seq, head_dim, body);
}

// stats: scratch of 3 * batch * heads * seq fp32 (written by the rows kernel,
// read by the columns kernel). Two launches on one stream. body: the wrapper's
// choice, refused unless it is the rule's.
extern "C" int fitclip_attention_bwd(const void* qkv, const void* grad, int dtype, void* dqkv,
                                     void* stats, int batch, int seq, int heads, int head_dim,
                                     float scale, int causal, int body, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  if (body < 0 || body != fitclip_attention_bwd_body(dtype, seq, head_dim))
    return static_cast<int>(cudaErrorInvalidValue);
  if (body == kBodyMma || body == kBodyMmaGlobal) {
    if (head_dim == 64)
      return launch_mma_body<64>(body, qkv, grad, dqkv, st, batch, seq, heads, scale, causal, s);
    return launch_mma_body<32>(body, qkv, grad, dqkv, st, batch, seq, heads, scale, causal, s);
  }
  if (head_dim == 64) return launch_f32_tier<64>(body, qkv, grad, dqkv, st, batch, seq, heads, scale, causal, s);
  return launch_f32_tier<32>(body, qkv, grad, dqkv, st, batch, seq, heads, scale, causal, s);
}
