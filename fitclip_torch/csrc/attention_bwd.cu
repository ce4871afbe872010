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
//   f32         fp32 on the CUDA cores (the tensor cores would take fp32 as
//               TF32): rows_kernel and columns_kernel below. A warp takes one
//               query row (rows) or one key (columns) against the head's two
//               transposed operands in shared memory; the columns kernel
//               recomputes the column's logits, W32 and dW with the rows
//               kernel's arithmetic in the same order (bit for bit its values).
//               Per pair and head that is four 64-long dot products and three
//               64-long axpys, about 900 FLOP: bound by issue rate and
//               shared-memory bandwidth. The column reads (lane * pitch + j)
//               use an odd row pitch, so that the 32 lanes hit 32 banks.
//   f32_global  fp32 where the two transposed operands of one head exceed a
//               block's shared memory (L = 577, ViT-L/14@336: 2 x 148 KB): only
//               the first (K^T in the rows kernel, (q_s)^T in the columns
//               kernel) stays in shared memory, and the second (V, g) is read
//               from device memory through L2, with the same arithmetic in the
//               same order.
#include "attention_bwd_mma.cuh"

using namespace fitclip;

namespace {

enum Body : int { kBodyMma = 0, kBodyMmaGlobal = 1, kBodyF32 = 2, kBodyF32Global = 3 };

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

// --- the fp32 bodies (CUDA cores) ------------------------------------------------

constexpr int kWarps = 8;
constexpr int kTile = 64;

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

// Row pitch of the transposed operands: odd, so that lane * pitch spreads the
// 32 lanes over the 32 banks.
int row_pitch(int seq) { return seq | 1; }

// Shared memory of either kernel: two transposed operands (D x lp; one in the
// global variant), three per-row statistics (lp fp32 each) and two fp32 row
// buffers per warp.
size_t f32_smem_bytes(int seq, int head_dim, bool global) {
  const int lp = row_pitch(seq);
  return (global ? 1 : 2) * align16(sizeof(float) * head_dim * lp) + sizeof(float) * 3 * lp +
         sizeof(float) * 2 * kWarps * lp;
}

template <int D>
__device__ inline void load_scaled(const float* src, float scale, float* r) {
#pragma unroll
  for (int d = 0; d < D; ++d) r[d] = mul(src[d], scale);
}

template <int D>
__device__ inline void load_row(const float* src, float* r) {
#pragma unroll
  for (int d = 0; d < D; ++d) r[d] = src[d];
}

// stats: (3, B, H, L) fp32 -- peak, denominator, inner. G: V from device memory.
template <int D, bool G>
__global__ void __launch_bounds__(kWarps * 32)
rows_kernel(const float* __restrict__ qkv, const float* __restrict__ grad, float* __restrict__ dqkv,
            float* __restrict__ stats, int seq, int lp, int heads, float scale, int causal,
            size_t stat_plane) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* kt = reinterpret_cast<float*>(smem);
  float* vt = reinterpret_cast<float*>(smem + align16(sizeof(float) * D * lp));
  float* bufs = reinterpret_cast<float*>(smem + (G ? 1 : 2) * align16(sizeof(float) * D * lp) +
                                         sizeof(float) * 3 * lp);

  const int width = heads * D;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int q1 = min(q0 + kTile, seq);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* base = qkv + static_cast<size_t>(b) * seq * 3 * width;
  const float* gbase = grad + static_cast<size_t>(b) * seq * width;
  float* dbase = dqkv + static_cast<size_t>(b) * seq * 3 * width;
  float* st = stats + (static_cast<size_t>(b) * heads + h) * seq;

  // The keys any row of this tile can see.
  const int keys = causal ? q1 : seq;
  for (int idx = tid; idx < keys * D; idx += kWarps * 32) {
    const int j = idx / D, d = idx % D;
    const float* src = base + static_cast<size_t>(j) * 3 * width + h * D + d;
    kt[d * lp + j] = src[width];
    if (!G) vt[d * lp + j] = src[2 * width];
  }
  __syncthreads();

  float* p = bufs + warp * 2 * lp;  // exps, then W32
  float* e = p + lp;                // dW, then dL
  for (int i = q0 + warp; i < q1; i += kWarps) {
    const int nk = causal ? i + 1 : seq;
    float r[D];
    load_scaled<D>(base + static_cast<size_t>(i) * 3 * width + h * D, scale, r);
    float peak = -INFINITY;
    for (int j = lane; j < nk; j += 32) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(r[d], kt[d * lp + j], s);
      p[j] = s;
      peak = fmaxf(peak, s);
    }
    peak = warp_max(peak);
    float denom = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float ex = expf(sub(p[j], peak));
      p[j] = ex;
      denom += ex;
    }
    denom = warp_sum(denom);

    load_row<D>(gbase + static_cast<size_t>(i) * width + h * D, r);
    float inner = 0.f;
    for (int j = lane; j < nk; j += 32) {
      float dw = 0.f;
      const float* vrow = base + static_cast<size_t>(j) * 3 * width + 2 * width + h * D;
#pragma unroll
      for (int d = 0; d < D; ++d) dw = fmaf(r[d], G ? vrow[d] : vt[d * lp + j], dw);
      const float w = div(p[j], denom);
      p[j] = w;
      e[j] = dw;
      inner = fmaf(w, dw, inner);
    }
    inner = warp_sum(inner);
    for (int j = lane; j < nk; j += 32) e[j] = mul(p[j], sub(e[j], inner));
    __syncwarp();

    float a[D / 32];
#pragma unroll
    for (int c = 0; c < D / 32; ++c) a[c] = 0.f;
    for (int j = 0; j < nk; ++j) {
      const float dl = e[j];
#pragma unroll
      for (int c = 0; c < D / 32; ++c) a[c] = fmaf(dl, kt[(lane + 32 * c) * lp + j], a[c]);
    }
    float* drow = dbase + static_cast<size_t>(i) * 3 * width + h * D;
#pragma unroll
    for (int c = 0; c < D / 32; ++c) drow[lane + 32 * c] = mul(a[c], scale);
    if (lane == 0) {
      st[i] = peak;
      st[stat_plane + i] = denom;
      st[2 * stat_plane + i] = inner;
    }
    __syncwarp();  // the next row overwrites p and e
  }
}

// G: g from device memory.
template <int D, bool G>
__global__ void __launch_bounds__(kWarps * 32)
columns_kernel(const float* __restrict__ qkv, const float* __restrict__ grad, float* __restrict__ dqkv,
               const float* __restrict__ stats, int seq, int lp, int heads, float scale,
               int causal, size_t stat_plane) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qt = reinterpret_cast<float*>(smem);
  float* gt = reinterpret_cast<float*>(smem + align16(sizeof(float) * D * lp));
  float* st = reinterpret_cast<float*>(smem + (G ? 1 : 2) * align16(sizeof(float) * D * lp));
  float* bufs = st + 3 * lp;

  const int width = heads * D;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int k1 = min(k0 + kTile, seq);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* base = qkv + static_cast<size_t>(b) * seq * 3 * width;
  const float* gbase = grad + static_cast<size_t>(b) * seq * width;
  float* dbase = dqkv + static_cast<size_t>(b) * seq * 3 * width;
  const float* gst = stats + (static_cast<size_t>(b) * heads + h) * seq;

  // The query rows that see any key of this tile.
  const int r0 = causal ? k0 : 0;
  for (int idx = tid; idx < (seq - r0) * D; idx += kWarps * 32) {
    const int l = r0 + idx / D, d = idx % D;
    qt[d * lp + l] = mul(base[static_cast<size_t>(l) * 3 * width + h * D + d], scale);
    if (!G) gt[d * lp + l] = gbase[static_cast<size_t>(l) * width + h * D + d];
  }
  for (int l = r0 + tid; l < seq; l += kWarps * 32) {
    st[l] = gst[l];
    st[lp + l] = gst[stat_plane + l];
    st[2 * lp + l] = gst[2 * stat_plane + l];
  }
  __syncthreads();

  float* p = bufs + warp * 2 * lp;  // W32
  float* e = p + lp;                // dL
  for (int s = k0 + warp; s < k1; s += kWarps) {
    const int l0 = causal ? s : 0;
    const float* krow = base + static_cast<size_t>(s) * 3 * width + width + h * D;
    float r[D];
    load_row<D>(krow, r);
    for (int l = l0 + lane; l < seq; l += 32) {
      float x = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) x = fmaf(qt[d * lp + l], r[d], x);
      p[l] = div(expf(sub(x, st[l])), st[lp + l]);
    }
    load_row<D>(krow + width, r);  // v
    for (int l = l0 + lane; l < seq; l += 32) {
      float dw = 0.f;
      const float* grow = gbase + static_cast<size_t>(l) * width + h * D;
#pragma unroll
      for (int d = 0; d < D; ++d) dw = fmaf(G ? grow[d] : gt[d * lp + l], r[d], dw);
      e[l] = mul(p[l], sub(dw, st[2 * lp + l]));
    }
    __syncwarp();

    float v[D / 32], g[D / 32];
#pragma unroll
    for (int c = 0; c < D / 32; ++c) v[c] = g[c] = 0.f;
    for (int l = l0; l < seq; ++l) {
      const float wt = p[l], dl = e[l];
      const float* grow = gbase + static_cast<size_t>(l) * width + h * D;
#pragma unroll
      for (int c = 0; c < D / 32; ++c) {
        const int d = lane + 32 * c;
        v[c] = fmaf(wt, G ? grow[d] : gt[d * lp + l], v[c]);
        g[c] = fmaf(dl, qt[(lane + 32 * c) * lp + l], g[c]);
      }
    }
    float* drow = dbase + static_cast<size_t>(s) * 3 * width + h * D;
#pragma unroll
    for (int c = 0; c < D / 32; ++c) {
      drow[width + lane + 32 * c] = g[c];
      drow[2 * width + lane + 32 * c] = v[c];
    }
    __syncwarp();  // the next key overwrites p and e
  }
}

template <int D, bool G>
int launch_f32(const void* qkv, const void* grad, void* dqkv, float* stats, int batch, int seq, int heads,
               float scale, int causal, cudaStream_t s) {
  const int lp = row_pitch(seq);
  const size_t smem = f32_smem_bytes(seq, D, G);
  cudaError_t err = allow_smem(rows_kernel<D, G>, smem);
  if (err == cudaSuccess) err = allow_smem(columns_kernel<D, G>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + kTile - 1) / kTile, heads, batch);
  const size_t plane = static_cast<size_t>(batch) * heads * seq;
  const float* q = static_cast<const float*>(qkv);
  const float* g = static_cast<const float*>(grad);
  float* d = static_cast<float*>(dqkv);
  rows_kernel<D, G><<<grid, kWarps * 32, smem, s>>>(q, g, d, stats, seq, lp, heads, scale, causal, plane);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  columns_kernel<D, G><<<grid, kWarps * 32, smem, s>>>(q, g, d, stats, seq, lp, heads, scale, causal, plane);
  return static_cast<int>(cudaGetLastError());
}

template <bool G>
int launch_f32_head_dim(int head_dim, const void* qkv, const void* grad, void* dqkv, float* stats, int batch,
                        int seq, int heads, float scale, int causal, cudaStream_t s) {
  if (head_dim == 64) return launch_f32<64, G>(qkv, grad, dqkv, stats, batch, seq, heads, scale, causal, s);
  return launch_f32<32, G>(qkv, grad, dqkv, stats, batch, seq, heads, scale, causal, s);
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
    if (f32_smem_bytes(seq, head_dim, false) <= kSmemLimit) return kBodyF32;
    if (f32_smem_bytes(seq, head_dim, true) <= kSmemLimit) return kBodyF32Global;
  }
  return -1;
}

// Shared memory per block of a body at (L, head_dim): the larger of its two kernels'.
extern "C" size_t fitclip_attention_bwd_smem_bytes(int seq, int head_dim, int body) {
  if (body == kBodyMma || body == kBodyMmaGlobal)
    return attn::bwd::columns_smem_bytes(seq, head_dim, body == kBodyMmaGlobal);
  return f32_smem_bytes(seq, head_dim, body == kBodyF32Global);
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
  if (body == kBodyF32Global)
    return launch_f32_head_dim<true>(head_dim, qkv, grad, dqkv, st, batch, seq, heads, scale, causal, s);
  return launch_f32_head_dim<false>(head_dim, qkv, grad, dqkv, st, batch, seq, heads, scale, causal, s);
}
