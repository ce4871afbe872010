// attention_bwd: the backward of multi-head self-attention over the unsplit
// (B, L, 3 * H * D) QKV projection output, head_dim D = 64.
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
// reductions over L (rows for dQ, columns for dK and dV) are two kernels:
//   rows     one block per (query tile, head, batch row), K^T and V^T in
//            shared memory. A warp takes one query row: logits, peak and
//            denominator, W32, dW and inner = rowsum(dW * W32), then dL and the
//            row's dQ. It stores peak, denominator and inner per row.
//   columns  one block per (key tile, head, batch row), (q_s)^T and g^T in
//            shared memory. A warp takes one key: it recomputes the column's
//            logits, W32 and dW with the same arithmetic in the same order (so
//            bit for bit the rows kernel's values), then accumulates dK and dV.
// Every output element is written by one thread with a fixed summation order
// and there are no atomics, so the result is deterministic run to run.
//
// The products run on the CUDA cores: per (query, key) pair and head, four
// 64-long dot products and three 64-long axpys, about 900 FLOP, so the kernel is
// bound by issue rate and shared-memory bandwidth, not by device memory (it
// reads qkv and g once per tile and never writes the (L, L) intermediates). A
// tensor-core (mma / wgmma) version is later work. The column reads
// (lane * pitch + j) use a row pitch chosen so that the 32 lanes hit 32 banks.
#include "common.cuh"

using namespace fitclip;

namespace {

constexpr int kHeadDim = 64;
constexpr int kWarps = 8;
constexpr int kTile = 64;

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

// Row pitch of the transposed operands: odd in 4-byte words, so that lane * pitch
// spreads the 32 lanes over the 32 banks (fp32: odd; bf16: pitch / 2 odd).
int row_pitch(int dtype, int seq) {
  if (dtype == kBFloat16) {
    int lp = seq + (seq & 1);
    return (lp / 2) % 2 ? lp : lp + 2;
  }
  return seq | 1;
}

// Shared memory of either kernel: two transposed operands (kHeadDim x lp), three
// per-row statistics (lp fp32 each) and two fp32 row buffers per warp.
template <typename T>
size_t smem_bytes(int lp) {
  return 2 * align16(sizeof(T) * kHeadDim * lp) + sizeof(float) * 3 * lp +
         sizeof(float) * 2 * kWarps * lp;
}

template <typename T>
__device__ inline void load_scaled(const T* src, float scale_t, float* r) {
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) r[d] = to_float(from_float<T>(mul(to_float(src[d]), scale_t)));
}

template <typename T>
__device__ inline void load_row(const T* src, float* r) {
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) r[d] = to_float(src[d]);
}

// stats: (3, B, H, L) fp32 -- peak, denominator, inner.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
rows_kernel(const T* __restrict__ qkv, const T* __restrict__ grad, T* __restrict__ dqkv,
            float* __restrict__ stats, int seq, int lp, int heads, float scale, int causal,
            size_t stat_plane) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* kt = reinterpret_cast<T*>(smem);
  T* vt = reinterpret_cast<T*>(smem + align16(sizeof(T) * kHeadDim * lp));
  float* bufs = reinterpret_cast<float*>(smem + 2 * align16(sizeof(T) * kHeadDim * lp) +
                                         sizeof(float) * 3 * lp);

  const int width = heads * kHeadDim;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int q1 = min(q0 + kTile, seq);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* base = qkv + static_cast<size_t>(b) * seq * 3 * width;
  const T* gbase = grad + static_cast<size_t>(b) * seq * width;
  T* dbase = dqkv + static_cast<size_t>(b) * seq * 3 * width;
  float* st = stats + (static_cast<size_t>(b) * heads + h) * seq;

  // The keys any row of this tile can see.
  const int keys = causal ? q1 : seq;
  for (int idx = tid; idx < keys * kHeadDim; idx += kWarps * 32) {
    const int j = idx / kHeadDim, d = idx % kHeadDim;
    const T* src = base + static_cast<size_t>(j) * 3 * width + h * kHeadDim + d;
    kt[d * lp + j] = src[width];
    vt[d * lp + j] = src[2 * width];
  }
  __syncthreads();

  const float scale_t = to_float(from_float<T>(scale));
  float* p = bufs + warp * 2 * lp;  // exps, then W32
  float* e = p + lp;                // dW, then dL
  for (int i = q0 + warp; i < q1; i += kWarps) {
    const int nk = causal ? i + 1 : seq;
    float r[kHeadDim];
    load_scaled(base + static_cast<size_t>(i) * 3 * width + h * kHeadDim, scale_t, r);
    float peak = -INFINITY;
    for (int j = lane; j < nk; j += 32) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) s = fmaf(r[d], to_float(kt[d * lp + j]), s);
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

    load_row(gbase + static_cast<size_t>(i) * width + h * kHeadDim, r);
    float inner = 0.f;
    for (int j = lane; j < nk; j += 32) {
      float dw = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) dw = fmaf(r[d], to_float(vt[d * lp + j]), dw);
      const float w = div(p[j], denom);
      p[j] = w;
      e[j] = dw;
      inner = fmaf(w, dw, inner);
    }
    inner = warp_sum(inner);
    for (int j = lane; j < nk; j += 32) e[j] = to_float(from_float<T>(mul(p[j], sub(e[j], inner))));
    __syncwarp();

    float a0 = 0.f, a1 = 0.f;
    for (int j = 0; j < nk; ++j) {
      const float dl = e[j];
      a0 = fmaf(dl, to_float(kt[lane * lp + j]), a0);
      a1 = fmaf(dl, to_float(kt[(lane + 32) * lp + j]), a1);
    }
    T* drow = dbase + static_cast<size_t>(i) * 3 * width + h * kHeadDim;
    drow[lane] = from_float<T>(mul(a0, scale));
    drow[lane + 32] = from_float<T>(mul(a1, scale));
    if (lane == 0) {
      st[i] = peak;
      st[stat_plane + i] = denom;
      st[2 * stat_plane + i] = inner;
    }
    __syncwarp();  // the next row overwrites p and e
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
columns_kernel(const T* __restrict__ qkv, const T* __restrict__ grad, T* __restrict__ dqkv,
               const float* __restrict__ stats, int seq, int lp, int heads, float scale,
               int causal, size_t stat_plane) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* qt = reinterpret_cast<T*>(smem);
  T* gt = reinterpret_cast<T*>(smem + align16(sizeof(T) * kHeadDim * lp));
  float* st = reinterpret_cast<float*>(smem + 2 * align16(sizeof(T) * kHeadDim * lp));
  float* bufs = st + 3 * lp;

  const int width = heads * kHeadDim;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int k1 = min(k0 + kTile, seq);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* base = qkv + static_cast<size_t>(b) * seq * 3 * width;
  const T* gbase = grad + static_cast<size_t>(b) * seq * width;
  T* dbase = dqkv + static_cast<size_t>(b) * seq * 3 * width;
  const float* gst = stats + (static_cast<size_t>(b) * heads + h) * seq;

  // The query rows that see any key of this tile.
  const int r0 = causal ? k0 : 0;
  const float scale_t = to_float(from_float<T>(scale));
  for (int idx = tid; idx < (seq - r0) * kHeadDim; idx += kWarps * 32) {
    const int l = r0 + idx / kHeadDim, d = idx % kHeadDim;
    const T q = base[static_cast<size_t>(l) * 3 * width + h * kHeadDim + d];
    qt[d * lp + l] = from_float<T>(mul(to_float(q), scale_t));
    gt[d * lp + l] = gbase[static_cast<size_t>(l) * width + h * kHeadDim + d];
  }
  for (int l = r0 + tid; l < seq; l += kWarps * 32) {
    st[l] = gst[l];
    st[lp + l] = gst[stat_plane + l];
    st[2 * lp + l] = gst[2 * stat_plane + l];
  }
  __syncthreads();

  float* p = bufs + warp * 2 * lp;  // W32, then W in v's dtype
  float* e = p + lp;                // dL
  for (int s = k0 + warp; s < k1; s += kWarps) {
    const int l0 = causal ? s : 0;
    const T* krow = base + static_cast<size_t>(s) * 3 * width + width + h * kHeadDim;
    float r[kHeadDim];
    load_row(krow, r);
    for (int l = l0 + lane; l < seq; l += 32) {
      float x = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) x = fmaf(to_float(qt[d * lp + l]), r[d], x);
      p[l] = div(expf(sub(x, st[l])), st[lp + l]);
    }
    load_row(krow + width, r);  // v
    for (int l = l0 + lane; l < seq; l += 32) {
      float dw = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) dw = fmaf(to_float(gt[d * lp + l]), r[d], dw);
      const float w = p[l];
      e[l] = to_float(from_float<T>(mul(w, sub(dw, st[2 * lp + l]))));
      p[l] = to_float(from_float<T>(w));
    }
    __syncwarp();

    float v0 = 0.f, v1 = 0.f, g0 = 0.f, g1 = 0.f;
    for (int l = l0; l < seq; ++l) {
      const float wt = p[l], dl = e[l];
      v0 = fmaf(wt, to_float(gt[lane * lp + l]), v0);
      v1 = fmaf(wt, to_float(gt[(lane + 32) * lp + l]), v1);
      g0 = fmaf(dl, to_float(qt[lane * lp + l]), g0);
      g1 = fmaf(dl, to_float(qt[(lane + 32) * lp + l]), g1);
    }
    T* drow = dbase + static_cast<size_t>(s) * 3 * width + h * kHeadDim;
    drow[width + lane] = from_float<T>(g0);
    drow[width + lane + 32] = from_float<T>(g1);
    drow[2 * width + lane] = from_float<T>(v0);
    drow[2 * width + lane + 32] = from_float<T>(v1);
    __syncwarp();  // the next key overwrites p and e
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
int launch(const void* qkv, const void* grad, void* dqkv, float* stats, int dtype, int batch,
           int seq, int heads, float scale, int causal, cudaStream_t s) {
  const int lp = row_pitch(dtype, seq);
  const size_t smem = smem_bytes<T>(lp);
  cudaError_t err = allow_smem(rows_kernel<T>, smem);
  if (err == cudaSuccess) err = allow_smem(columns_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + kTile - 1) / kTile, heads, batch);
  const size_t plane = static_cast<size_t>(batch) * heads * seq;
  const T* q = static_cast<const T*>(qkv);
  const T* g = static_cast<const T*>(grad);
  T* d = static_cast<T*>(dqkv);
  rows_kernel<T><<<grid, kWarps * 32, smem, s>>>(q, g, d, stats, seq, lp, heads, scale, causal, plane);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  columns_kernel<T><<<grid, kWarps * 32, smem, s>>>(q, g, d, stats, seq, lp, heads, scale, causal,
                                                    plane);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" size_t fitclip_attention_bwd_smem_bytes(int dtype, int seq) {
  const int lp = row_pitch(dtype, seq);
  return dtype == kBFloat16 ? smem_bytes<__nv_bfloat16>(lp) : smem_bytes<float>(lp);
}

// stats: scratch of 3 * batch * heads * seq fp32 (written by the rows kernel,
// read by the columns kernel). Two launches on one stream.
extern "C" int fitclip_attention_bwd(const void* qkv, const void* grad, int dtype, void* dqkv,
                                     void* stats, int batch, int seq, int heads, int head_dim,
                                     float scale, int causal, void* stream) {
  if (head_dim != kHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(qkv, grad, dqkv, st, dtype, batch, seq, heads, scale, causal, s);
  if (dtype == kFloat32)
    return launch<float>(qkv, grad, dqkv, st, dtype, batch, seq, heads, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
