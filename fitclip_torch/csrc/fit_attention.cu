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
// On the H100: space is bound by latency and shared-memory bandwidth (one
// head's 1 + P keys and values, 2 x 197 x 64 bf16 = 50 KB, are read once for
// 64 query rows; the products run on the CUDA cores). time and cls are bound
// by device memory: time reads each qkv element about once (one warp per
// (clip, location, head), lane = two of the 64 dims, F + 1 = 5 keys), cls
// reads one head's K and V of a clip once per (clip, head) block.
#include "common.cuh"

using namespace fitclip;

namespace {

constexpr int kHeadDim = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQueryTile = 64;
constexpr int kMaxFrames = 16;

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

// --- space --------------------------------------------------------------------

// Shared memory: K^T (kHeadDim x lp), V (keys x kHeadDim), per-warp rows (kWarps x lp fp32).
template <typename T>
size_t space_smem_bytes(int keys, int lp) {
  return align16(sizeof(T) * kHeadDim * lp) + align16(sizeof(T) * static_cast<size_t>(keys) * kHeadDim) +
         sizeof(float) * kWarps * lp;
}

template <typename T, bool kInt8Out>
__global__ void __launch_bounds__(kThreads)
space_kernel(const T* __restrict__ qkv, int qkv_clip_stride, const T* __restrict__ gkv, int gkv_stride,
             void* __restrict__ out, int out_clip_stride, int frames, int patches, int lp, int heads,
             float scale, float out_mul) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int keys = patches + 1;
  T* kt = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + align16(sizeof(T) * kHeadDim * lp));
  float* rows = reinterpret_cast<float*>(smem + align16(sizeof(T) * kHeadDim * lp) +
                                         align16(sizeof(T) * static_cast<size_t>(keys) * kHeadDim));

  const int width = heads * kHeadDim;
  const int q0 = blockIdx.x * kQueryTile, h = blockIdx.y, g = blockIdx.z;
  const int q1 = min(q0 + kQueryTile, patches);
  const int c = g / frames, f = g % frames;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* group = qkv + static_cast<size_t>(c) * qkv_clip_stride + static_cast<size_t>(f) * patches * 3 * width;
  const T* global = gkv + static_cast<size_t>(c) * gkv_stride;

  // Key 0 is the global row, key j >= 1 is group row j - 1.
  for (int idx = tid; idx < keys * kHeadDim; idx += kThreads) {
    const int j = idx / kHeadDim, d = idx % kHeadDim;
    const T* src = (j == 0 ? global : group + static_cast<size_t>(j - 1) * 3 * width) + h * kHeadDim + d;
    kt[d * lp + j] = src[width];
    vs[j * kHeadDim + d] = src[2 * width];
  }
  __syncthreads();

  const float scale_t = to_float(from_float<T>(scale));
  float* p = rows + warp * lp;
  for (int i = q0 + warp; i < q1; i += kWarps) {
    const T* qrow = group + static_cast<size_t>(i) * 3 * width + h * kHeadDim;
    float q[kHeadDim];
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) q[d] = to_float(from_float<T>(mul(to_float(qrow[d]), scale_t)));

    float peak = -INFINITY;
    for (int j = lane; j < keys; j += 32) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) s = fmaf(q[d], to_float(kt[d * lp + j]), s);
      p[j] = s;
      peak = fmaxf(peak, s);
    }
    peak = warp_max(peak);
    float denom = 0.f;
    for (int j = lane; j < keys; j += 32) {
      const float e = expf(sub(p[j], peak));
      p[j] = e;
      denom += e;
    }
    denom = warp_sum(denom);
    const float norm = kInt8Out ? div(out_mul, denom) : 0.f;
    for (int j = lane; j < keys; j += 32) {
      const float wgt = kInt8Out ? mul(p[j], norm) : div(p[j], denom);
      p[j] = to_float(from_float<T>(wgt));
    }
    __syncwarp();

    float o0 = 0.f, o1 = 0.f;
    for (int j = 0; j < keys; ++j) {
      const float wgt = p[j];
      o0 = fmaf(wgt, to_float(vs[j * kHeadDim + lane]), o0);
      o1 = fmaf(wgt, to_float(vs[j * kHeadDim + lane + 32]), o1);
    }
    const size_t o = static_cast<size_t>(c) * out_clip_stride +
                     (static_cast<size_t>(f) * patches + i) * width + h * kHeadDim + lane;
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
int launch_space(const void* qkv, int qkv_clip_stride, const void* gkv, int gkv_stride, void* out,
                 int out_clip_stride, int groups, int frames, int patches, int heads, float scale,
                 float out_mul, cudaStream_t s) {
  const int keys = patches + 1;
  const int lp = keys + (keys & 1);
  const size_t smem = space_smem_bytes<T>(keys, lp);
  auto kernel = space_kernel<T, kInt8Out>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((patches + kQueryTile - 1) / kQueryTile, heads, groups);
  kernel<<<grid, kThreads, smem, s>>>(static_cast<const T*>(qkv), qkv_clip_stride, static_cast<const T*>(gkv),
                                      gkv_stride, out, out_clip_stride, frames, patches, lp, heads, scale,
                                      out_mul);
  return static_cast<int>(cudaGetLastError());
}

// --- time ---------------------------------------------------------------------

template <typename T, bool kInt8Out>
__global__ void __launch_bounds__(kThreads)
time_kernel(const T* __restrict__ qkv, int qkv_clip_stride, const T* __restrict__ gkv, int gkv_stride,
            void* __restrict__ out, int out_clip_stride, int clips, int frames, int patches, int heads,
            float scale, float out_mul) {
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);  // (clip, location, head), head fastest
  if (item >= clips * patches * heads) return;
  const int h = item % heads, loc = (item / heads) % patches, c = item / (heads * patches);
  const int width = heads * kHeadDim;
  const size_t row_stride = static_cast<size_t>(patches) * 3 * width;  // one frame
  const T* base = qkv + static_cast<size_t>(c) * qkv_clip_stride + static_cast<size_t>(loc) * 3 * width +
                  h * kHeadDim + lane;
  const T* global = gkv + static_cast<size_t>(c) * gkv_stride + h * kHeadDim + lane;

  const float gk0 = to_float(global[width]), gk1 = to_float(global[width + 32]);
  const float gv0 = to_float(global[2 * width]), gv1 = to_float(global[2 * width + 32]);
  float k0[kMaxFrames], k1[kMaxFrames], v0[kMaxFrames], v1[kMaxFrames];
#pragma unroll
  for (int g = 0; g < kMaxFrames; ++g) {
    if (g < frames) {
      const T* r = base + g * row_stride;
      k0[g] = to_float(r[width]);
      k1[g] = to_float(r[width + 32]);
      v0[g] = to_float(r[2 * width]);
      v1[g] = to_float(r[2 * width + 32]);
    }
  }

  for (int f = 0; f < frames; ++f) {
    const T* qrow = base + f * row_stride;
    const float q0 = mul(to_float(qrow[0]), scale), q1 = mul(to_float(qrow[32]), scale);
    // logit 0: the global key; logit g + 1: frame g at this location.
    float logit[kMaxFrames + 1];
    logit[0] = warp_sum(fmaf(q0, gk0, q1 * gk1));
    float peak = logit[0];
#pragma unroll
    for (int g = 0; g < kMaxFrames; ++g) {
      if (g < frames) {
        logit[g + 1] = warp_sum(fmaf(q0, k0[g], q1 * k1[g]));
        peak = fmaxf(peak, logit[g + 1]);
      }
    }
    float e[kMaxFrames + 1];
    e[0] = expf(sub(logit[0], peak));
    float denom = e[0];
#pragma unroll
    for (int g = 0; g < kMaxFrames; ++g) {
      if (g < frames) {
        e[g + 1] = expf(sub(logit[g + 1], peak));
        denom = add(denom, e[g + 1]);
      }
    }
    const float norm = div(out_mul, denom);
    float o0 = mul(mul(e[0], norm), gv0), o1 = mul(mul(e[0], norm), gv1);
#pragma unroll
    for (int g = 0; g < kMaxFrames; ++g) {
      if (g < frames) {
        const float wgt = mul(e[g + 1], norm);
        o0 = add(o0, mul(wgt, v0[g]));
        o1 = add(o1, mul(wgt, v1[g]));
      }
    }
    const size_t o = static_cast<size_t>(c) * out_clip_stride +
                     (static_cast<size_t>(f) * patches + loc) * width + h * kHeadDim + lane;
    if (kInt8Out) {
      int8_t* dst = static_cast<int8_t*>(out);
      dst[o] = quant_rint(o0);
      dst[o + 32] = quant_rint(o1);
    } else {
      T* dst = static_cast<T*>(out);
      dst[o] = from_float<T>(o0);
      dst[o + 32] = from_float<T>(o1);
    }
  }
}

template <typename T, bool kInt8Out>
int launch_time(const void* qkv, int qkv_clip_stride, const void* gkv, int gkv_stride, void* out,
                int out_clip_stride, int clips, int frames, int patches, int heads, float scale, float out_mul,
                cudaStream_t s) {
  const long long items = static_cast<long long>(clips) * patches * heads;
  const dim3 grid(static_cast<unsigned>((items + kWarps - 1) / kWarps));
  time_kernel<T, kInt8Out><<<grid, kThreads, 0, s>>>(static_cast<const T*>(qkv), qkv_clip_stride,
                                                     static_cast<const T*>(gkv), gkv_stride, out,
                                                     out_clip_stride, clips, frames, patches, heads, scale,
                                                     out_mul);
  return static_cast<int>(cudaGetLastError());
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

// Shared memory: one fp32 logit per key, then kWarps reduction slots and the
// (4 x kHeadDim) partial sums of P.V.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cls_kernel(const T* __restrict__ qkv, int8_t* __restrict__ out, int out_clip_stride, int seq, int heads,
           float scale, float out_mul) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* w = reinterpret_cast<float*>(smem);
  float* red = w + seq;
  float* part = red + kWarps;
  const int h = blockIdx.x, c = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int width = heads * kHeadDim;
  const T* clip = qkv + static_cast<size_t>(c) * seq * 3 * width + h * kHeadDim;

  const float scale_t = to_float(from_float<T>(scale));
  const float q0 = to_float(from_float<T>(mul(to_float(clip[lane]), scale_t)));
  const float q1 = to_float(from_float<T>(mul(to_float(clip[lane + 32]), scale_t)));
  for (int j = warp; j < seq; j += kWarps) {
    const T* k = clip + static_cast<size_t>(j) * 3 * width + width;
    const float s = warp_sum(fmaf(q0, to_float(k[lane]), q1 * to_float(k[lane + 32])));
    if (lane == 0) w[j] = s;
  }
  __syncthreads();

  float peak = -INFINITY;
  for (int j = tid; j < seq; j += kThreads) peak = fmaxf(peak, w[j]);
  peak = block_reduce(peak, red, true);
  float denom = 0.f;
  for (int j = tid; j < seq; j += kThreads) {
    const float e = expf(sub(w[j], peak));
    w[j] = e;
    denom += e;
  }
  denom = block_reduce(denom, red, false);
  const float norm = div(out_mul, denom);
  for (int j = tid; j < seq; j += kThreads) w[j] = to_float(from_float<T>(mul(w[j], norm)));
  __syncthreads();

  // P.V: thread t sums keys j = t / 64 (mod 4) for dim t % 64.
  const int d = tid % kHeadDim, quarter = tid / kHeadDim;
  float acc = 0.f;
  for (int j = quarter; j < seq; j += kThreads / kHeadDim) {
    acc = fmaf(w[j], to_float(clip[static_cast<size_t>(j) * 3 * width + 2 * width + d]), acc);
  }
  part[quarter * kHeadDim + d] = acc;
  __syncthreads();
  if (tid < kHeadDim) {
    const float o = part[d] + part[kHeadDim + d] + part[2 * kHeadDim + d] + part[3 * kHeadDim + d];
    out[static_cast<size_t>(c) * out_clip_stride + h * kHeadDim + d] = quant_rint(o);
  }
}

size_t cls_smem_bytes(int seq) { return sizeof(float) * (static_cast<size_t>(seq) + kWarps + 4 * kHeadDim); }

template <typename T>
int launch_cls(const void* qkv, void* out, int out_clip_stride, int clips, int seq, int heads, float scale,
               float out_mul, cudaStream_t s) {
  const size_t smem = cls_smem_bytes(seq);
  auto kernel = cls_kernel<T>;
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

extern "C" size_t fitclip_fit_space_smem_bytes(int dtype, int patches) {
  const int keys = patches + 1;
  const int lp = keys + (keys & 1);
  return dtype == kBFloat16 ? space_smem_bytes<__nv_bfloat16>(keys, lp) : space_smem_bytes<float>(keys, lp);
}

extern "C" size_t fitclip_fit_cls_smem_bytes(int seq) { return cls_smem_bytes(seq); }

// Strides are in elements. int8_out = 1: out is int8 and out_mul rides the
// normalizer; int8_out = 0: out is in qkv's dtype (out_mul must be 1 for time).
extern "C" int fitclip_fit_space_attention(const void* qkv, int qkv_clip_stride, const void* gkv, int gkv_stride,
                                           int dtype, void* out, int out_clip_stride, int int8_out, int groups,
                                           int frames, int patches, int heads, int head_dim, float scale,
                                           float out_mul, void* stream) {
  if (head_dim != kHeadDim || frames < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
#define FIT_SPACE(T, I8) \
  launch_space<T, I8>(qkv, qkv_clip_stride, gkv, gkv_stride, out, out_clip_stride, groups, frames, patches, heads, \
                      scale, out_mul, s)
  if (dtype == kBFloat16) return int8_out ? FIT_SPACE(bf16, true) : FIT_SPACE(bf16, false);
  if (dtype == kFloat32) return int8_out ? FIT_SPACE(float, true) : FIT_SPACE(float, false);
#undef FIT_SPACE
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int fitclip_fit_time_attention(const void* qkv, int qkv_clip_stride, const void* gkv, int gkv_stride,
                                          int dtype, void* out, int out_clip_stride, int int8_out, int clips,
                                          int frames, int patches, int heads, int head_dim, float scale,
                                          float out_mul, void* stream) {
  if (head_dim != kHeadDim || frames < 1 || frames > kMaxFrames) return static_cast<int>(cudaErrorInvalidValue);
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
extern "C" int fitclip_fit_cls_attention(const void* qkv, int dtype, void* out, int out_clip_stride, int clips,
                                         int seq, int heads, int head_dim, float scale, float out_mul,
                                         void* stream) {
  if (head_dim != kHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return launch_cls<__nv_bfloat16>(qkv, out, out_clip_stride, clips, seq, heads, scale, out_mul, s);
  if (dtype == kFloat32) return launch_cls<float>(qkv, out, out_clip_stride, clips, seq, heads, scale, out_mul, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
