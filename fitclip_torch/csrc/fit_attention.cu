// fit_attention: Frozen-in-Time's divided space-time attention with a global
// CLS key/value, head_dim D = 64, three kernels.
//
//   space  each frame group's P patch rows attend over [global row | the P
//          group rows]. Float mode replaces fitclip_tpu/ops/attention.py:
//          _packed_gkv_kernel (K5, fused_attention_qkv_gkv): q scaled in qkv's
//          dtype, fp32 logits and softmax, weights = exps / denom cast to v's
//          dtype, output in qkv's dtype. int8 mode replaces the space
//          attention of fitclip_tpu/ops/fit_block.py:_fit_layer_pad_kernel (K4,
//          the shipped spacepack + spacecat arm): weights = exps * (out_mul /
//          denom), the CLS weight cast to v's dtype with the others, output
//          rounded and clipped to int8.
//   time   each location p of frame f attends over [global row | location p
//          of every frame]. Float mode replaces attention.py:
//          _time_attention_kernel (K6, fused_time_attention); int8 mode the
//          time attention of K4 (timemxu). Both scale q in fp32 and keep the
//          weights in fp32: weights = exps * (out_mul / denom), with out_mul 1
//          in float mode (K6's 1 / denom).
//   cls    the CLS row's attention over all N rows of its clip, itself
//          included (K4's clspack global row), int8 mode only: q scaled in
//          qkv's dtype, weights exps * (out_mul / denom) cast to v's dtype.
//
// Rows are addressed by base pointers and strides, so K4's joint
// (B, 1 + F * P, 3W) qkv (the global row is row 0 of each clip, the groups
// follow it) and K5's (G, P, 3W) groups with a (G, 3W) gkv go through the
// same code: group g reads clip c = g / frames, frame f = g % frames.
//
// On the H100: space in bf16 (both modes) is space_mma_kernel, attention.cu's
// tensor-core core (attention_mma.cuh) with a loader of its own: key 0 from the
// global row, keys 1..P from the group rows; 64 query rows per block, the
// 1 + P keys' K and V read once per block, QK^T and P.V on mma.sync with the
// logits in registers (swept in tiles of 64 keys past 208 keys). fp32 (both
// modes) stays on the CUDA cores (tensor cores would take fp32 as TF32):
// space_f32_kernel runs attention_f32_kernel's register-tiled block body
// (attention_f32.cuh: forward_block) with the same key order, its 64-key K
// and V tiles streamed by cp.async, the first tile's key 0 the global row; the
// row tier (64 or 32 query rows a block) by the key count, as attention.cu
// picks it. Its bound is the FFMA rate; shared-memory loads hold it back first
// (see attention_f32.cuh). The sums run in the old CUDA-core body's order (one
// fmaf chain per logit over d and per output over keys, lane-strided softmax
// sums), so its outputs are that body's bits.
// time is bound by device memory: time_rows_kernel reads each qkv element
// once. A lane holds one 16-byte vector of a head (8 dims in bf16, 4 in fp32),
// a head is a group of 8 (16) lanes, and a warp covers 4 (2) heads of one
// (clip, location): every load and store is whole 32-byte sectors, and a
// lane's 2F + 3 loads are in flight together. Each logit is a partial dot
// over the lane's dims reduced by 3 (4) xor-shuffles within its group; K and
// V are held as loaded, in registers sized by a frame tier (4, 8, 16).
// cls (cls_rows_kernel) reads one head's K and V of a clip once per (clip,
// head) block in the time kernel's lane groups: 32 (16) keys an instruction
// round a block, 8 loads in flight a lane; the softmax stays exact over the
// logits held in shared memory.
#include <type_traits>

#include "attention_f32.cuh"

using namespace fitclip;

namespace {

constexpr int kHeadDim = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxFrames = 16;

// --- space --------------------------------------------------------------------

// bf16: the tensor-core core. The keys are [global row | the group's P rows].
template <bool kInt8Out, int kSteps, bool kSweep>
__global__ void __launch_bounds__(attn::kThreads, attn::min_blocks<kSteps, kSweep>())
space_mma_kernel(const __nv_bfloat16* __restrict__ qkv, int qkv_clip_stride, const __nv_bfloat16* __restrict__ gkv,
                 int gkv_stride, void* __restrict__ out, int out_clip_stride, int frames, int patches, int heads,
                 float scale, float out_mul) {
  using attn::bf16;
  constexpr int kMode = kInt8Out ? attn::kInt8 : attn::kQkv;
  extern __shared__ __align__(16) unsigned char smem[];
  const int keys = patches + 1;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + static_cast<size_t>(attn::round16(keys)) * kHeadDim;

  const int width = heads * kHeadDim;
  const int q0 = blockIdx.x * attn::kBlockRows, h = blockIdx.y, g = blockIdx.z;
  const int c = g / frames, f = g % frames;
  const bf16* group = qkv + static_cast<size_t>(c) * qkv_clip_stride + static_cast<size_t>(f) * patches * 3 * width +
                      h * kHeadDim;
  const bf16* global = gkv + static_cast<size_t>(c) * gkv_stride + h * kHeadDim;
  auto row = [&](int i) { return group + static_cast<size_t>(i) * 3 * width; };  // group row i

  // Key 0 is the global row, key j >= 1 is group row j - 1.
  attn::load_kv<kHeadDim>(ks, vs, keys, width, [&](int j) { return j == 0 ? global : row(j - 1); });

  const int i0 = q0 + (threadIdx.x >> 5) * 16;
  const int lo = i0 + ((threadIdx.x & 31) >> 2), hi = lo + 8;
  uint32_t qa[kHeadDim / 16][4];
  const attn::QRows qr{lo < patches ? row(lo) : nullptr, hi < patches ? row(hi) : nullptr, bf16_round(scale)};
  attn::load_q<kHeadDim>(qr.lo, qr.hi, qr.scale, qa);
  attn::wait_k();
  float o[kHeadDim / 8][4];
  attn::attend<kHeadDim, kMode, kSteps, kSweep>(ks, vs, qa, qr, i0, i0 < patches ? keys : 0, false, out_mul, o);
  const long long o_row = static_cast<long long>(c) * out_clip_stride +
                          static_cast<long long>(f) * patches * width + h * kHeadDim;
  attn::store_rows<kHeadDim, kMode>(out, lo < patches ? o_row + static_cast<long long>(lo) * width : -1,
                                    hi < patches ? o_row + static_cast<long long>(hi) * width : -1, o, out_mul);
}

template <bool kInt8Out, int kSteps, bool kSweep>
int launch_space_mma(const void* qkv, int qkv_clip_stride, const void* gkv, int gkv_stride, void* out,
                     int out_clip_stride, int groups, int frames, int patches, int heads, float scale, float out_mul,
                     cudaStream_t s) {
  const size_t smem = attn::smem_bytes(patches + 1, kHeadDim);
  auto kernel = space_mma_kernel<kInt8Out, kSteps, kSweep>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((patches + attn::kBlockRows - 1) / attn::kBlockRows, heads, groups);
  kernel<<<grid, attn::kThreads, smem, s>>>(static_cast<const __nv_bfloat16*>(qkv), qkv_clip_stride,
                                            static_cast<const __nv_bfloat16*>(gkv), gkv_stride, out, out_clip_stride,
                                            frames, patches, heads, scale, out_mul);
  return static_cast<int>(cudaGetLastError());
}

// The register tier by the number of keys, as attention.cu picks it.
template <bool kInt8Out>
int launch_space_bf16(const void* qkv, int qkv_clip_stride, const void* gkv, int gkv_stride, void* out,
                      int out_clip_stride, int groups, int frames, int patches, int heads, float scale, float out_mul,
                      cudaStream_t s) {
  const int keys = patches + 1;
#define FIT_SPACE_MMA(STEPS, SWEEP)                                                                              \
  launch_space_mma<kInt8Out, STEPS, SWEEP>(qkv, qkv_clip_stride, gkv, gkv_stride, out, out_clip_stride, groups, \
                                          frames, patches, heads, scale, out_mul, s)
  if (keys > attn::kResidentKeys) return FIT_SPACE_MMA(attn::kSweepSteps, true);
  if (keys <= 16 * attn::kSmallSteps) return FIT_SPACE_MMA(attn::kSmallSteps, false);
  return FIT_SPACE_MMA(attn::kLargeSteps, false);
#undef FIT_SPACE_MMA
}

// fp32: attention_f32_kernel's block body over [global row | the group's P rows].
namespace fa = fitclip::f32attn;

template <int TM, bool kInt8Out>
__global__ void __launch_bounds__(fa::kThreads, 2)
space_f32_kernel(const float* __restrict__ qkv, int qkv_clip_stride, const float* __restrict__ gkv, int gkv_stride,
                 void* __restrict__ out, int out_clip_stride, int frames, int patches, int heads, float scale,
                 float out_mul) {
  const int width = heads * kHeadDim;
  const size_t stride = 3 * static_cast<size_t>(width);
  const int h = blockIdx.y, g = blockIdx.z;
  const int c = g / frames, f = g % frames;
  const float* group = qkv + static_cast<size_t>(c) * qkv_clip_stride + static_cast<size_t>(f) * patches * stride +
                       h * kHeadDim;
  const float* global = gkv + static_cast<size_t>(c) * gkv_stride + h * kHeadDim;
  // Key 0 is the global row, key j >= 1 is group row j - 1.
  auto key = [=](int j) { return j == 0 ? global : group + (j - 1) * stride; };
  const fa::ForwardRows<decltype(key)> rows{
      group, key, stride, width, patches, patches + 1, false, patches + 1,
      static_cast<size_t>(c) * out_clip_stride + static_cast<size_t>(f) * patches * width + h * kHeadDim};
  fa::forward_block<kHeadDim, TM, kInt8Out ? attn::kInt8 : attn::kQkv>(rows, blockIdx.x * fa::block_rows(TM),
                                                                        scale, out_mul, out);
}

template <int R, bool kInt8Out>
int launch_space_f32_rows(const void* qkv, int qkv_clip_stride, const void* gkv, int gkv_stride, void* out,
                          int out_clip_stride, int groups, int frames, int patches, int heads, float scale,
                          float out_mul, cudaStream_t s) {
  const size_t smem = fa::forward_smem_bytes(patches + 1, kHeadDim, R);
  auto kernel = space_f32_kernel<R / 16, kInt8Out>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((patches + R - 1) / R, heads, groups);
  kernel<<<grid, fa::kThreads, smem, s>>>(static_cast<const float*>(qkv), qkv_clip_stride,
                                          static_cast<const float*>(gkv), gkv_stride, out, out_clip_stride, frames,
                                          patches, heads, scale, out_mul);
  return static_cast<int>(cudaGetLastError());
}

template <bool kInt8Out>
int launch_space_f32(const void* qkv, int qkv_clip_stride, const void* gkv, int gkv_stride, void* out,
                     int out_clip_stride, int groups, int frames, int patches, int heads, float scale, float out_mul,
                     cudaStream_t s) {
  // The tier by key count, attention.cu's rule (f32_64, f32_32).
  const int rows = fa::forward_rows(patches + 1, kHeadDim);
  if (rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto launch = rows == 64 ? launch_space_f32_rows<64, kInt8Out> : launch_space_f32_rows<32, kInt8Out>;
  return launch(qkv, qkv_clip_stride, gkv, gkv_stride, out, out_clip_stride, groups, frames, patches, heads, scale,
                out_mul, s);
}

// --- time ---------------------------------------------------------------------

// A lane's 16-byte vector as floats: 8 bf16 (element 2i in the low half of
// word i) or 4 fp32.
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x), x[1] = __uint_as_float(u.y), x[2] = __uint_as_float(u.z), x[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // round to nearest even, as from_float
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t pack_int8(float a, float b, float c, float d) {
  return static_cast<uint8_t>(quant_rint(a)) | static_cast<uint32_t>(static_cast<uint8_t>(quant_rint(b))) << 8 |
         static_cast<uint32_t>(static_cast<uint8_t>(quant_rint(c))) << 16 |
         static_cast<uint32_t>(static_cast<uint8_t>(quant_rint(d))) << 24;
}

// One lane's output vector: 16 bytes in bf16 or fp32, 8 (4) bytes in int8.
__device__ __forceinline__ void store_vec(__nv_bfloat16* dst, const float (&o)[8]) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]), pack_bf16(o[4], o[5]),
                                              pack_bf16(o[6], o[7]));
}

__device__ __forceinline__ void store_vec(float* dst, const float (&o)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ void store_vec(int8_t* dst, const float (&o)[8]) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_int8(o[0], o[1], o[2], o[3]), pack_int8(o[4], o[5], o[6], o[7]));
}

__device__ __forceinline__ void store_vec(int8_t* dst, const float (&o)[4]) {
  *reinterpret_cast<uint32_t*>(dst) = pack_int8(o[0], o[1], o[2], o[3]);
}

template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Location p of frame f over [global row | location p of frames 0 .. F - 1],
// for F <= kF (the register tier). Item (clip, location, head group) per warp,
// the head group fastest; lane group l of a warp is head 4 hg + l in bf16 (2
// hg + l in fp32), lane l % kLanes of a group dims kVec (l % kLanes) .. of it.
// Per query frame: the logits (the partial dot over the lane's dims, one fmaf
// chain from 0, then xor-shuffles 1, 2, 4 (, 8) within the group), the peak,
// exps, denom (global first, then frames in ascending order), norm = out_mul /
// denom, and o = (e_0 norm) v_global + (e_g norm) v_g over g ascending, each
// product and sum rounded on its own.
template <typename T, bool kInt8Out, int kF>
__global__ void __launch_bounds__(kThreads)
time_rows_kernel(const T* __restrict__ qkv, int qkv_clip_stride, const T* __restrict__ gkv, int gkv_stride,
                 void* __restrict__ out, int out_clip_stride, int clips, int frames, int patches, int heads,
                 float scale, float out_mul) {
  constexpr int kVec = 16 / sizeof(T), kLanes = kHeadDim / kVec, kHeadsPerWarp = 32 / kLanes;
  using OutT = typename std::conditional<kInt8Out, int8_t, T>::type;
  const int lane = threadIdx.x & 31;
  const int hgroups = (heads + kHeadsPerWarp - 1) / kHeadsPerWarp;
  const long long item = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (item >= static_cast<long long>(clips) * patches * hgroups) return;  // the whole warp
  const int hg = static_cast<int>(item % hgroups);
  const long long cl = item / hgroups;
  const int loc = static_cast<int>(cl % patches), c = static_cast<int>(cl / patches);
  const int h = hg * kHeadsPerWarp + lane / kLanes;
  const bool live = h < heads;  // a lane group past the last head loads head heads - 1 and stores nothing
  const int width = heads * kHeadDim;
  const int col = min(h, heads - 1) * kHeadDim + (lane % kLanes) * kVec;
  const size_t row_stride = static_cast<size_t>(patches) * 3 * width;  // one frame
  const T* base = qkv + static_cast<size_t>(c) * qkv_clip_stride + static_cast<size_t>(loc) * 3 * width + col;
  const T* global = gkv + static_cast<size_t>(c) * gkv_stride + col;

  // Every K and V vector of this location, and the first query's, in flight together.
  const uint4 gk = load_vec(global + width), gv = load_vec(global + 2 * width);
  uint4 k[kF], v[kF];
#pragma unroll
  for (int g = 0; g < kF; ++g) {
    if (g < frames) {
      k[g] = load_vec(base + g * row_stride + width);
      v[g] = load_vec(base + g * row_stride + 2 * width);
    }
  }
  uint4 q_next = load_vec(base);

  auto group_sum = [&](float s) {
#pragma unroll
    for (int offset = 1; offset < kLanes; offset <<= 1) s = add(s, __shfl_xor_sync(0xffffffffu, s, offset));
    return s;
  };
  auto dot = [&](const float (&q)[kVec], const uint4& u) {
    float x[kVec];
    unpack(u, x);
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < kVec; ++d) s = fmaf(q[d], x[d], s);
    return group_sum(s);
  };

#pragma unroll
  for (int f = 0; f < kF; ++f) {
    if (f < frames) {
      float q[kVec];
      unpack(q_next, q);
      if (f + 1 < frames) q_next = load_vec(base + (f + 1) * row_stride);  // the next query, during this one
#pragma unroll
      for (int d = 0; d < kVec; ++d) q[d] = mul(q[d], scale);
      // logit 0: the global key; logit g + 1: frame g at this location.
      float logit[kF + 1];
      logit[0] = dot(q, gk);
      float peak = logit[0];
#pragma unroll
      for (int g = 0; g < kF; ++g) {
        if (g < frames) {
          logit[g + 1] = dot(q, k[g]);
          peak = fmaxf(peak, logit[g + 1]);
        }
      }
      const float e0 = expf(sub(logit[0], peak));
      float denom = e0;
#pragma unroll
      for (int g = 0; g < kF; ++g) {
        if (g < frames) {
          logit[g + 1] = expf(sub(logit[g + 1], peak));
          denom = add(denom, logit[g + 1]);
        }
      }
      const float norm = div(out_mul, denom);
      float o[kVec], x[kVec];
      unpack(gv, x);
      const float w0 = mul(e0, norm);
#pragma unroll
      for (int d = 0; d < kVec; ++d) o[d] = mul(w0, x[d]);
#pragma unroll
      for (int g = 0; g < kF; ++g) {
        if (g < frames) {
          const float wgt = mul(logit[g + 1], norm);
          unpack(v[g], x);
#pragma unroll
          for (int d = 0; d < kVec; ++d) o[d] = add(o[d], mul(wgt, x[d]));
        }
      }
      if (live) {
        OutT* dst = static_cast<OutT*>(out) + static_cast<size_t>(c) * out_clip_stride +
                    (static_cast<size_t>(f) * patches + loc) * width + col;
        store_vec(dst, o);
      }
    }
  }
}

template <typename T, bool kInt8Out, int kF>
int launch_time_tier(const void* qkv, int qkv_clip_stride, const void* gkv, int gkv_stride, void* out,
                     int out_clip_stride, int clips, int frames, int patches, int heads, float scale, float out_mul,
                     cudaStream_t s) {
  constexpr int kHeadsPerWarp = 32 / (kHeadDim / (16 / sizeof(T)));
  const long long items = static_cast<long long>(clips) * patches * ((heads + kHeadsPerWarp - 1) / kHeadsPerWarp);
  const dim3 grid(static_cast<unsigned>((items + kWarps - 1) / kWarps));
  time_rows_kernel<T, kInt8Out, kF><<<grid, kThreads, 0, s>>>(static_cast<const T*>(qkv), qkv_clip_stride,
                                                              static_cast<const T*>(gkv), gkv_stride, out,
                                                              out_clip_stride, clips, frames, patches, heads, scale,
                                                              out_mul);
  return static_cast<int>(cudaGetLastError());
}

// The register tier by frame count.
template <typename T, bool kInt8Out>
int launch_time(const void* qkv, int qkv_clip_stride, const void* gkv, int gkv_stride, void* out,
                int out_clip_stride, int clips, int frames, int patches, int heads, float scale, float out_mul,
                cudaStream_t s) {
  auto launch = frames <= 4   ? launch_time_tier<T, kInt8Out, 4>
                : frames <= 8 ? launch_time_tier<T, kInt8Out, 8>
                              : launch_time_tier<T, kInt8Out, kMaxFrames>;
  return launch(qkv, qkv_clip_stride, gkv, gkv_stride, out, out_clip_stride, clips, frames, patches, heads, scale,
                out_mul, s);
}

// --- cls ----------------------------------------------------------------------

__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red may still be read by an earlier reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// Row 0 of a clip over all of its seq rows, one head: one block per (head,
// clip), time_rows_kernel's lane mapping. A lane holds one 16-byte vector of a
// key's head row (kVec dims: 8 bf16 or 4 fp32), a group of kLanes lanes one
// key, so a block reads kGroups keys an instruction round (32 in bf16, 16 in
// fp32); key j belongs to group j % kGroups and each lane keeps kUnroll loads
// in flight. Loops run over the warp's first key, so that every lane of a warp
// takes each shuffle. Shared memory: the seq logits (then weights), kWarps
// reduction slots, and kWarps x kHeadDim partial sums of P.V.
// 1. logits: the lane's partial dot over its dims (one fmaf chain from 0,
//    q = T(T(q) * T(scale))) reduced by xor-shuffles 1, 2, 4 (, 8) within the
//    group, written by the group's first lane;
// 2. the exact softmax over the shared logits: the peak, exps, denom (block
//    sums), weights T(exps * (out_mul / denom));
// 3. P.V: each group sums its keys' w_j v_j in fp32 (one fmaf chain a dim, keys
//    ascending), the groups of a warp then add by xor-shuffles kLanes, ..., 16,
//    the warps in order through shared memory; the first group of warp 0
//    rounds to int8 (quant_rint) and stores its kVec bytes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cls_rows_kernel(const T* __restrict__ qkv, int8_t* __restrict__ out, int out_clip_stride, int seq, int heads,
                float scale, float out_mul) {
  constexpr int kVec = 16 / sizeof(T), kLanes = kHeadDim / kVec, kGroupsPerWarp = 32 / kLanes;
  constexpr int kGroups = kWarps * kGroupsPerWarp, kUnroll = 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* weight = reinterpret_cast<float*>(smem);
  float* red = weight + seq;
  float* part = red + kWarps;
  const int h = blockIdx.x, c = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int dim0 = (lane % kLanes) * kVec, key0 = warp * kGroupsPerWarp, mine = lane / kLanes;
  const int width = heads * kHeadDim;
  const size_t row = 3 * static_cast<size_t>(width);
  const T* clip = qkv + static_cast<size_t>(c) * seq * row + h * kHeadDim + dim0;

  const float scale_t = to_float(from_float<T>(scale));
  float q[kVec];
  unpack(load_vec(clip), q);
#pragma unroll
  for (int d = 0; d < kVec; ++d) q[d] = to_float(from_float<T>(mul(q[d], scale_t)));

  for (int j0 = key0; j0 < seq; j0 += kGroups * kUnroll) {
    uint4 k[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + mine + u * kGroups;
      if (j < seq) k[u] = load_vec(clip + j * row + width);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + mine + u * kGroups;
      float s = 0.f;
      if (j < seq) {
        float x[kVec];
        unpack(k[u], x);
#pragma unroll
        for (int d = 0; d < kVec; ++d) s = fmaf(q[d], x[d], s);
      }
#pragma unroll
      for (int offset = 1; offset < kLanes; offset <<= 1) s = add(s, __shfl_xor_sync(0xffffffffu, s, offset));
      if (j < seq && dim0 == 0) weight[j] = s;
    }
  }
  __syncthreads();

  float peak = -INFINITY;
  for (int j = tid; j < seq; j += kThreads) peak = fmaxf(peak, weight[j]);
  peak = block_reduce(peak, red, true);
  float denom = 0.f;
  for (int j = tid; j < seq; j += kThreads) {
    const float e = expf(sub(weight[j], peak));
    weight[j] = e;
    denom += e;
  }
  denom = block_reduce(denom, red, false);
  const float norm = div(out_mul, denom);
  for (int j = tid; j < seq; j += kThreads) weight[j] = to_float(from_float<T>(mul(weight[j], norm)));
  __syncthreads();

  float acc[kVec];
#pragma unroll
  for (int d = 0; d < kVec; ++d) acc[d] = 0.f;
  for (int j0 = key0; j0 < seq; j0 += kGroups * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + mine + u * kGroups;
      if (j < seq) v[u] = load_vec(clip + j * row + 2 * width);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + mine + u * kGroups;
      if (j < seq) {
        float x[kVec];
        unpack(v[u], x);
        const float wj = weight[j];
#pragma unroll
        for (int d = 0; d < kVec; ++d) acc[d] = fmaf(wj, x[d], acc[d]);
      }
    }
  }
#pragma unroll
  for (int offset = kLanes; offset < 32; offset <<= 1) {
#pragma unroll
    for (int d = 0; d < kVec; ++d) acc[d] = add(acc[d], __shfl_xor_sync(0xffffffffu, acc[d], offset));
  }
  if (lane < kLanes) {
#pragma unroll
    for (int d = 0; d < kVec; ++d) part[warp * kHeadDim + dim0 + d] = acc[d];
  }
  __syncthreads();
  if (warp == 0 && lane < kLanes) {
#pragma unroll
    for (int d = 0; d < kVec; ++d) acc[d] = part[dim0 + d];
    for (int w = 1; w < kWarps; ++w) {
#pragma unroll
      for (int d = 0; d < kVec; ++d) acc[d] = add(acc[d], part[w * kHeadDim + dim0 + d]);
    }
    store_vec(out + static_cast<size_t>(c) * out_clip_stride + h * kHeadDim + dim0, acc);
  }
}

size_t cls_smem_bytes(int seq) { return sizeof(float) * (static_cast<size_t>(seq) + kWarps + kWarps * kHeadDim); }

template <typename T>
int launch_cls(const void* qkv, void* out, int out_clip_stride, int clips, int seq, int heads, float scale,
               float out_mul, cudaStream_t s) {
  const size_t smem = cls_smem_bytes(seq);
  auto kernel = cls_rows_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(heads, clips), kThreads, smem, s>>>(static_cast<const T*>(qkv), static_cast<int8_t*>(out),
                                                   out_clip_stride, seq, heads, scale, out_mul);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The space kernel's shared memory a block at P rows a group (fp32: at its tier).
extern "C" size_t fitclip_fit_space_smem_bytes(int dtype, int patches) {
  const int keys = patches + 1;
  if (dtype == kBFloat16) return attn::smem_bytes(keys, kHeadDim);
  // Past the 32-row tier: its bytes, which the wrapper refuses.
  const int rows = fa::forward_rows(keys, kHeadDim);
  return fa::forward_smem_bytes(keys, kHeadDim, rows > 0 ? rows : 32);
}

extern "C" size_t fitclip_fit_cls_smem_bytes(int seq) { return cls_smem_bytes(seq); }

// Strides are in elements. int8_out = 1: out is int8 and out_mul rides the
// normalizer; int8_out = 0: out is in qkv's dtype (out_mul must be 1 for time).
// Space routes by dtype: bf16 to the tensor-core kernel, fp32 to the CUDA cores;
// time takes 1 .. kMaxFrames frames and 16-byte aligned rows.
extern "C" int fitclip_fit_space_attention(const void* qkv, int qkv_clip_stride, const void* gkv, int gkv_stride,
                                           int dtype, void* out, int out_clip_stride, int int8_out, int groups,
                                           int frames, int patches, int heads, int head_dim, float scale,
                                           float out_mul, void* stream) {
  if (head_dim != kHeadDim || frames < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FIT_SPACE(FN, I8) \
  FN<I8>(qkv, qkv_clip_stride, gkv, gkv_stride, out, out_clip_stride, groups, frames, patches, heads, scale, out_mul, s)
  if (dtype == kBFloat16) return int8_out ? FIT_SPACE(launch_space_bf16, true) : FIT_SPACE(launch_space_bf16, false);
  if (dtype == kFloat32) return int8_out ? FIT_SPACE(launch_space_f32, true) : FIT_SPACE(launch_space_f32, false);
#undef FIT_SPACE
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int fitclip_fit_time_attention(const void* qkv, int qkv_clip_stride, const void* gkv, int gkv_stride,
                                          int dtype, void* out, int out_clip_stride, int int8_out, int clips,
                                          int frames, int patches, int heads, int head_dim, float scale,
                                          float out_mul, void* stream) {
  if (head_dim != kHeadDim || frames < 1 || frames > kMaxFrames) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte vectors: the pointers 16-byte aligned, the strides whole vectors.
  const int vec = dtype == kBFloat16 ? 8 : 4;
  if ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(gkv)) % 16 ||
      reinterpret_cast<uintptr_t>(out) % (int8_out ? vec : 16) || qkv_clip_stride % vec || gkv_stride % vec ||
      out_clip_stride % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
#define FIT_TIME(T, I8) \
  launch_time<T, I8>(qkv, qkv_clip_stride, gkv, gkv_stride, out, out_clip_stride, clips, frames, patches, heads, \
                     scale, out_mul, s)
  if (dtype == kBFloat16) return int8_out ? FIT_TIME(bf16, true) : FIT_TIME(bf16, false);
  if (dtype == kFloat32) return int8_out ? FIT_TIME(float, true) : FIT_TIME(float, false);
#undef FIT_TIME
  return static_cast<int>(cudaErrorInvalidValue);
}

// qkv (clips, seq, 3W); writes one int8 row per clip at out + c * out_clip_stride.
// 16-byte vectors: qkv 16-byte aligned, out and its stride whole int8 vectors
// (8 bytes from bf16, 4 from fp32).
extern "C" int fitclip_fit_cls_attention(const void* qkv, int dtype, void* out, int out_clip_stride, int clips,
                                         int seq, int heads, int head_dim, float scale, float out_mul,
                                         void* stream) {
  if (head_dim != kHeadDim || seq < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = dtype == kBFloat16 ? 8 : 4;
  if (reinterpret_cast<uintptr_t>(qkv) % 16 || reinterpret_cast<uintptr_t>(out) % vec || out_clip_stride % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return launch_cls<__nv_bfloat16>(qkv, out, out_clip_stride, clips, seq, heads, scale, out_mul, s);
  if (dtype == kFloat32) return launch_cls<float>(qkv, out, out_clip_stride, clips, seq, heads, scale, out_mul, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
