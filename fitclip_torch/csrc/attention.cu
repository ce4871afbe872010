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
// cast the weights to v's dtype before P.V, and leave out keys that the causal
// mask (finfo.min) or the seq_valid key mask (-1e30) would zero: exp() of
// either is exactly 0, so leaving them out gives the same sums.
//
// Four bodies; the wrapper picks one from (dtype, L, head_dim)
// (fitclip_torch/ops/attention.py:attention_body) and the entry refuses any
// other (fitclip_attention_body is the same rule):
//   mma        bf16, L <= 208: attention_mma_kernel, the tensor-core core of
//              attention_mma.cuh (K and V in shared memory once per block of 64
//              rows, QK^T and P.V on mma.sync, every logit of a warp's 16 rows
//              in its registers). Every mode runs here in bf16.
//   mma_sweep  bf16, L > 208 (ViT-L/14, ViT-L/14@336): the same core sweeping
//              the keys in tiles of 64, QK^T recomputed in each of its three
//              passes (max, sum, weights and P.V).
//   f32_64, f32_32  fp32, the shipped modes: attention_f32_kernel, register-tiled
//              on the CUDA cores (tensor cores would take fp32 as TF32; see
//              attention_f32.cuh). A block takes 64 query rows (f32_64), or 32
//              past the length where 64 rows of logits no longer fit beside
//              the Q tile and the K/V ring (L > 680 at head_dim 64, > 776 at
//              32; f32_32 takes up to 1448 and 1608). K tiles of 64 keys stream
//              by cp.async into a double buffer for QK^T (4 x 4 logits a thread
//              at 64 rows), the logits of every key the block sees land in a
//              row buffer, warps take whole rows for the exact softmax, and V
//              tiles stream through the same buffer for P.V, accumulated in
//              registers. Logits sum over d and P.V over keys in ascending
//              order, and the softmax sums as the CUDA-core body it replaced
//              did (lane-strided, then the warp's butterfly), so the outputs
//              are that body's bits. Under causal, whole 32-key column blocks
//              past a warp's last row are skipped. Its bound is the FFMA
//              rate (4 B H L^2 D operations against 67 TFLOP/s); its 4 x 4
//              tiles are held back by shared-memory bandwidth first.
#include "attention_f32.cuh"

using namespace fitclip;
using namespace fitclip::attn;

namespace {

enum Body : int { kBodyMma = 0, kBodyMmaSweep = 1, kBodyF32Rows64 = 2, kBodyF32Rows32 = 3 };

constexpr size_t kSmemLimit = 232448;  // shared memory a block can use on an H100

// --- the mma bodies (bf16) ---------------------------------------------------------

template <int D, int kMode, int kSteps, bool kSweep>
__global__ void __launch_bounds__(kThreads, min_blocks<kSteps, kSweep>())
attention_mma_kernel(const bf16* __restrict__ qkv, void* __restrict__ out, int seq, int heads, float scale,
                     int causal, int seq_valid, float out_mul) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + static_cast<size_t>(round16(seq)) * D;

  const int width = heads * D;
  const int q0 = blockIdx.x * kBlockRows, h = blockIdx.y, b = blockIdx.z;
  const int hl = kMode == kHead0 ? 0 : h;  // the head whose q, k and v are read
  const bf16* base = qkv + static_cast<size_t>(b) * seq * 3 * width + hl * D;
  auto row = [&](int j) { return base + static_cast<size_t>(j) * 3 * width; };

  // The keys any row of this tile can see.
  const int keys = min(seq, seq_valid);
  load_kv<D>(ks, vs, causal ? min(min(q0 + kBlockRows, seq), keys) : keys, width, row);

  const int i0 = q0 + (threadIdx.x >> 5) * 16;
  const int lo = i0 + ((threadIdx.x & 31) >> 2), hi = lo + 8;
  uint32_t qa[D / 16][4];
  const QRows qr{lo < seq ? row(lo) : nullptr, hi < seq ? row(hi) : nullptr, bf16_round(scale)};
  load_q<D>(qr.lo, qr.hi, qr.scale, qa);
  wait_k();
  float o[D / 8][4];
  attend<D, kMode, kSteps, kSweep>(ks, vs, qa, qr, i0, i0 < seq ? keys : 0, causal != 0, out_mul, o);
  const long long o_row = static_cast<long long>(b) * seq * width + h * D;
  store_rows<D, kMode>(out, lo < seq ? o_row + static_cast<long long>(lo) * width : -1,
                       hi < seq ? o_row + static_cast<long long>(hi) * width : -1, o, out_mul);
}

template <int D, int kMode, int kSteps, bool kSweep>
int launch_mma(const void* qkv, void* out, int batch, int seq, int heads, float scale, int causal, int seq_valid,
               float out_mul, cudaStream_t s) {
  const size_t smem = smem_bytes(seq, D);
  auto kernel = attention_mma_kernel<D, kMode, kSteps, kSweep>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((seq + kBlockRows - 1) / kBlockRows, heads, batch);
  kernel<<<grid, kThreads, smem, s>>>(static_cast<const bf16*>(qkv), out, seq, heads, scale, causal, seq_valid,
                                      out_mul);
  return static_cast<int>(cudaGetLastError());
}

// The register tier by length: the small one (the text towers' 77, ViT-B/32's
// 50) only for the shipped modes.
template <int D, int kMode, bool kSmallTier>
int launch_mma_body(int body, const void* qkv, void* out, int batch, int seq, int heads, float scale, int causal,
                    int seq_valid, float out_mul, cudaStream_t s) {
  if (body == kBodyMmaSweep)
    return launch_mma<D, kMode, kSweepSteps, true>(qkv, out, batch, seq, heads, scale, causal, seq_valid, out_mul, s);
  if constexpr (kSmallTier) {
    if (seq <= 16 * kSmallSteps)
      return launch_mma<D, kMode, kSmallSteps, false>(qkv, out, batch, seq, heads, scale, causal, seq_valid,
                                                      out_mul, s);
  }
  return launch_mma<D, kMode, kLargeSteps, false>(qkv, out, batch, seq, heads, scale, causal, seq_valid, out_mul, s);
}

template <int D>
int dispatch_mma(int mode, int body, const void* qkv, void* out, int batch, int seq, int heads, float scale,
                 int causal, int seq_valid, float out_mul, cudaStream_t s) {
#define FITCLIP_MMA_MODE(M, SMALL) \
  case M: return launch_mma_body<D, M, SMALL>(body, qkv, out, batch, seq, heads, scale, causal, seq_valid, out_mul, s);
  switch (mode) {
    FITCLIP_MMA_MODE(kQkv, true)
    FITCLIP_MMA_MODE(kInt8, true)
    case kBlock:
      return launch_mma_body<D, kBlock, true>(body, qkv, out, batch, seq, heads, scale, causal, seq_valid, 1.f, s);
    default: break;
  }
  if constexpr (D == 64) {  // the bench arms' modes: head_dim 64 only
    switch (mode) {
      FITCLIP_MMA_MODE(kDiv, false)
      FITCLIP_MMA_MODE(kFold2, false)
      FITCLIP_MMA_MODE(kSm2, false)
      FITCLIP_MMA_MODE(kSm2Div, false)
      FITCLIP_MMA_MODE(kNoMax, false)
      FITCLIP_MMA_MODE(kCast, false)
      FITCLIP_MMA_MODE(kHead0, false)
      FITCLIP_MMA_MODE(kBf16Logits, false)
      FITCLIP_MMA_MODE(kNoSoftmax, false)
      default: break;
    }
  }
#undef FITCLIP_MMA_MODE
  return static_cast<int>(cudaErrorInvalidValue);
}

// --- the fp32 tiers (CUDA cores, register-tiled: attention_f32.cuh) ---------------

namespace fa = fitclip::f32attn;

size_t f32_smem_bytes(int seq, int head_dim, int rows) { return fa::forward_smem_bytes(seq, head_dim, rows); }

template <int D, int R, int kMode>
int launch_f32(const void* qkv, void* out, int batch, int seq, int heads, float scale, int causal, int seq_valid,
               float out_mul, cudaStream_t s) {
  const size_t smem = f32_smem_bytes(seq, D, R);
  auto kernel = fa::attention_f32_kernel<D, R / 16, kMode>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((seq + R - 1) / R, heads, batch);
  kernel<<<grid, fa::kThreads, smem, s>>>(static_cast<const float*>(qkv), out, seq, heads, scale, causal,
                                          seq_valid, out_mul);
  return static_cast<int>(cudaGetLastError());
}

// The shipped modes at one head_dim and tier.
template <int D, int R>
int dispatch_f32(int mode, const void* qkv, void* out, int batch, int seq, int heads, float scale, int causal,
                 int seq_valid, float out_mul, cudaStream_t s) {
  switch (mode) {
    case kQkv: return launch_f32<D, R, kQkv>(qkv, out, batch, seq, heads, scale, causal, seq_valid, out_mul, s);
    case kInt8: return launch_f32<D, R, kInt8>(qkv, out, batch, seq, heads, scale, causal, seq_valid, out_mul, s);
    case kBlock: return launch_f32<D, R, kBlock>(qkv, out, batch, seq, heads, scale, causal, seq_valid, 1.f, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D>
int dispatch_f32_tier(int body, int mode, const void* qkv, void* out, int batch, int seq, int heads, float scale,
                      int causal, int seq_valid, float out_mul, cudaStream_t s) {
  if (body == kBodyF32Rows64)
    return dispatch_f32<D, 64>(mode, qkv, out, batch, seq, heads, scale, causal, seq_valid, out_mul, s);
  return dispatch_f32<D, 32>(mode, qkv, out, batch, seq, heads, scale, causal, seq_valid, out_mul, s);
}

}  // namespace

// The body that takes (dtype, L, head_dim), or -1 where none does: the rule of
// fitclip_torch/ops/attention.py:attention_body.
extern "C" int fitclip_attention_body(int dtype, int seq, int head_dim) {
  if (seq < 1 || (head_dim != 32 && head_dim != 64)) return -1;
  if (dtype == kBFloat16) {
    if (smem_bytes(seq, head_dim) > kSmemLimit) return -1;
    return seq <= kResidentKeys ? kBodyMma : kBodyMmaSweep;
  }
  if (dtype == kFloat32) {
    const int rows = fa::forward_rows(seq, head_dim);
    if (rows > 0) return rows == 64 ? kBodyF32Rows64 : kBodyF32Rows32;
  }
  return -1;
}

// mode: see attn::Mode. The int8-output modes write int8, the others qkv's
// dtype; out_mul is the requant multiplier of the int8 modes (unused by qkv
// and the S2 modes). body: the wrapper's choice, refused unless it is the rule's.
// The bench modes take bf16 at head_dim 64 only.
extern "C" int fitclip_attention(const void* qkv, int dtype, void* out, int mode, int batch, int seq, int heads,
                                 int head_dim, float scale, int causal, int seq_valid, float out_mul, int body,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body < 0 || body != fitclip_attention_body(dtype, seq, head_dim) || mode < kQkv || mode > kNoSoftmax)
    return static_cast<int>(cudaErrorInvalidValue);
  if (body == kBodyMma || body == kBodyMmaSweep) {
    if (dtype != kBFloat16) return static_cast<int>(cudaErrorInvalidValue);
    if (head_dim == 64)
      return dispatch_mma<64>(mode, body, qkv, out, batch, seq, heads, scale, causal, seq_valid, out_mul, s);
    return dispatch_mma<32>(mode, body, qkv, out, batch, seq, heads, scale, causal, seq_valid, out_mul, s);
  }
  // The fp32 tiers: fp32 and the shipped modes only; a bf16 call never reaches them.
  if (dtype != kFloat32 || mode > kBlock) return static_cast<int>(cudaErrorInvalidValue);
  if (head_dim == 64)
    return dispatch_f32_tier<64>(body, mode, qkv, out, batch, seq, heads, scale, causal, seq_valid, out_mul, s);
  return dispatch_f32_tier<32>(body, mode, qkv, out, batch, seq, heads, scale, causal, seq_valid, out_mul, s);
}
