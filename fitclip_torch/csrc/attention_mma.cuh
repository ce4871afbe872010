// attention_mma: the tensor-core attention core shared by attention.cu (every
// bf16 mode) and fit_attention.cu's space kernel (bf16, both modes).
//
// One block is four warps, 64 query rows of one (batch row or group, head).
// The block copies its head's K and V once into shared memory with 16-byte
// cp.async (V landing while QK^T runs; rows of D bf16, the 16-byte chunks XOR-swizzled by row so that
// ldmatrix's eight row reads hit eight distinct bank groups; the pad rows up
// to a multiple of 16 keys are zero-filled, since a weight of 0 times a NaN
// read from garbage is NaN inside the mma). Each warp owns 16 query rows:
//   QK^T  q is loaded from device memory, scaled in bf16 as every mode does,
//         and held as m16k16 A fragments; K is B, read with ldmatrix from the
//         [key][d] tile; mma.sync.m16n8k16 (bf16 x bf16 -> fp32) leaves every
//         logit of the warp's 16 rows in its accumulator registers (4 fp32 per
//         lane per 8 keys).
//   softmax  No online softmax: the exact row max, then exps, then the sum,
//         as the TPU kernels take them. A row's logits sit in the four lanes
//         of a quad, so max and sum are two __shfl_xor_sync steps. Masked keys
//         (causal, seq_valid, the pad) are left out of max and sum and get a
//         weight of 0; key tiles past a warp's last visible key are skipped.
//   P.V   each weight is rounded to bf16 (v's dtype) and packed straight into
//         the A fragments of the next product (the m16n8 C layout is the A
//         layout of m16k16), V is B through ldmatrix.trans, the output is
//         D / 8 n8 tiles of fp32 accumulators, and the caller's epilogue
//         rounds it (bf16) or requantizes it (int8).
// nosoftmax's weights are the logits themselves rounded to bf16, so a logit
// that the tensor cores sum within their error of a bf16 rounding boundary
// is summed again on the CUDA cores in the fp32 bodies' order (refine_logit),
// and every weight is the one that order gives.
// Up to kResidentKeys keys the logits stay in registers and QK^T runs once.
// Past that the sweep variant walks the keys in tiles of 64: pass 1 takes the
// row max, pass 2 the sum, pass 3 the weights and P.V, recomputing QK^T each
// time, so the function stays exact (the same bits in every pass).
//
// On the H100 this is bound by latency, not by bytes or products: each warp
// walks a dependent chain of loads, exps and mma steps, with 12 warps resident
// per SM at 197 keys (three blocks of 168 registers and 53 KB of K and V).
//
// Each mode's arithmetic (which exp, which normalizer, divide or multiply,
// the int8 requant) is in the rule functions below, shared with the fp32
// CUDA-core bodies of attention.cu.
#pragma once

#include "common.cuh"

namespace fitclip {
namespace attn {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

// The modes of attention.cu; fit_attention.cu's space kernel runs kQkv (float)
// and kInt8 (int8) rules.
enum Mode : int {
  kQkv = 0, kInt8 = 1, kBlock = 2,
  kDiv = 3, kFold2 = 4, kSm2 = 5, kSm2Div = 6, kNoMax = 7, kCast = 8,
  kHead0 = 9, kBf16Logits = 10, kNoSoftmax = 11,
};

template <int kMode>
__host__ __device__ constexpr bool int8_out() {
  return kMode == kInt8 || kMode == kDiv || kMode == kFold2 || kMode == kSm2 || kMode == kSm2Div ||
         kMode == kNoMax || kMode == kCast;
}

// --- the modes' rules ------------------------------------------------------------

// exp of one logit against its row's peak (the logit is bf16-rounded in kBf16Logits).
template <int kMode>
__device__ __forceinline__ float softmax_exp(float l, float peak) {
  if (kMode == kFold2) return exp2f(mul(sub(l, peak), kLog2e));
  if (kMode == kSm2 || kMode == kSm2Div) return exp2f(sub(l, peak));
  if (kMode == kNoMax) return expf(l);
  if (kMode == kBf16Logits) return bf16_round(expf(bf16_round(sub(l, peak))));
  return expf(sub(l, peak));
}

// The multiplier of each weight, where the mode multiplies.
template <int kMode>
__device__ __forceinline__ float softmax_norm(float denom, float out_mul) {
  if (kMode == kInt8) return div(out_mul, denom);
  if (kMode == kFold2) return mul(out_mul, rcp_approx(denom));
  if (kMode == kSm2) return rcp_approx(denom);
  if (kMode == kBf16Logits) return bf16_round(div(1.f, denom));
  return div(1.f, denom);  // kBlock, kDiv, kCast; unused by the dividing modes
}

template <int kMode>
__host__ __device__ constexpr bool divides() {
  return kMode == kQkv || kMode == kHead0 || kMode == kSm2Div || kMode == kNoMax;
}

template <int kMode>
__device__ __forceinline__ float softmax_weight(float e, float denom, float norm) {
  if (divides<kMode>()) return div(e, denom);
  if (kMode == kBf16Logits) return bf16_round(mul(e, norm));
  return mul(e, norm);
}

// The int8 output of the int8-output modes from the fp32 P.V.
template <int kMode>
__device__ __forceinline__ int8_t requant(float o, float out_mul) {
  if (kMode == kInt8 || kMode == kFold2) return quant_rint(o);
  if (kMode == kCast) return trunc_int8(o);
  return quant_rint(mul(o, out_mul));
}

// --- the tensor-core core ---------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockRows = kWarps * 16;  // query rows per block
constexpr int kSmallSteps = 5;           // register tiers: 16-key steps held as logits
constexpr int kLargeSteps = 13;
constexpr int kResidentKeys = 16 * kLargeSteps;  // 208: past it, the sweep
constexpr int kSweepSteps = 4;                   // 64 keys per sweep tile

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

// Blocks per SM the kernels are compiled for (__launch_bounds__): the large
// register tier keeps 104 logits a lane and fits 168 registers at three
// blocks without spills; the others fit four.
template <int kSteps, bool kSweep>
__host__ __device__ constexpr int min_blocks() { return kSweep || kSteps <= kSmallSteps ? 4 : 3; }

// Shared memory of one block: K and V, round16(keys) rows of head_dim bf16 each.
inline size_t smem_bytes(int keys, int head_dim) {
  return 2 * sizeof(bf16) * static_cast<size_t>(round16(keys)) * head_dim;
}

// Element offset of 16-byte chunk c of row j in a K or V tile.
template <int D>
__device__ __forceinline__ int tile_offset(int j, int c) {
  const int swizzle = D == 64 ? (j & 7) : ((j >> 1) & 3);
  return j * D + ((c ^ swizzle) << 3);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// e / d rounded to nearest from y = RN(1 / d), without a divide: q = RN(e y)
// is within about an ulp of e / d, r = e - q d is exact in one fma, and
// RN(q + r y) is RN(e / d) (Markstein's theorem; tests/test_torch_kernels.py
// checks it in exact arithmetic), while no step leaves the normal range. The
// core takes it only where every quotient of the warp's rows is at least
// 2^-99 and every sum within [2^-100, 2^100], else the IEEE divide.
__device__ __forceinline__ float div_by_reciprocal(float e, float d, float y) {
  const float q = mul(e, y);
  return __fmaf_rn(__fmaf_rn(-q, d, e), y, q);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Copy rows 0 .. loaded - 1 (row(j)) into a swizzled [row][d] tile and zero
// rows loaded .. round16(loaded) - 1; one cp.async group, left in flight.
template <int D, typename RowFn>
__device__ __forceinline__ void load_tile(bf16* dst, int loaded, RowFn row) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < round16(loaded) * kChunks; idx += kThreads) {
    const int j = idx / kChunks, c = idx % kChunks;
    const bool valid = j < loaded;
    cp_async16(dst + tile_offset<D>(j, c), row(valid ? j : 0) + c * 8, valid);
  }
  cp_async_commit();
}

// Copy keys 0 .. loaded-1 of one head into the K and V tiles and zero rows
// loaded .. round16(loaded)-1. row(j) points at key j's q slice of the head:
// its k slice is width elements on, its v slice 2 * width. K and V are two
// cp.async groups, left in flight: the caller loads its q rows meanwhile,
// then wait_k (K in place, the block synchronized) before QK^T; V lands while
// QK^T and the softmax run, and every warp of the block, rows or none, reaches
// the one wait_v inside attend before P.V.
template <int D, typename RowFn>
__device__ __forceinline__ void load_kv(bf16* ks, bf16* vs, int loaded, int width, RowFn row) {
  load_tile<D>(ks, loaded, [&](int j) { return row(j) + width; });
  load_tile<D>(vs, loaded, [&](int j) { return row(j) + 2 * width; });
}

__device__ __forceinline__ void wait_k() {
  cp_async_wait_one();
  __syncthreads();
}

__device__ __forceinline__ void wait_v() {
  cp_async_wait_all();
  __syncthreads();
}

// Two q values of a row, scaled in bf16 (scale already bf16-rounded), as
// one bf16x2 register; 0 for a row past the end (row == nullptr).
__device__ __forceinline__ uint32_t scaled_pair(const bf16* row, int col, float scale) {
  if (row == nullptr) return 0u;
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(row + col);
  return pack_bf16(mul(__low2float(v), scale), mul(__high2float(v), scale));
}

// The A fragments of the warp's 16 q rows (lo: row g, hi: row g + 8 of the warp).
template <int D>
__device__ __forceinline__ void load_q(const bf16* lo, const bf16* hi, float scale,
                                       uint32_t (&qa)[D / 16][4]) {
  const int c = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = scaled_pair(lo, kk * 16 + c, scale);
    qa[kk][1] = scaled_pair(hi, kk * 16 + c, scale);
    qa[kk][2] = scaled_pair(lo, kk * 16 + c + 8, scale);
    qa[kk][3] = scaled_pair(hi, kk * 16 + c + 8, scale);
  }
}

// The warp's q rows in device memory (row g, row g + 8 of the warp; nullptr
// past the end) and the bf16-rounded scale, for refine_logit.
struct QRows {
  const bf16* lo;
  const bf16* hi;
  float scale;
};

constexpr uint32_t kAbs = 0x7fff7fffu;  // clears the signs of a bf16x2

// Whether bf16(x) may differ from bf16 of the same sum taken in another
// order, where every partial sum is at most m = sum |q_d k_d| in size: x lies
// within m 2^-19 of a bf16 rounding boundary (the midpoint of x's bf16
// interval; the one below is at least 2^(e - 9) away for x in [2^e, 2^(e+1))).
// The fp32 order and the tensor cores' truncating one stay far closer than
// the worst case of 64 u m (u = 2^-24): tests/test_torch_kernels.py holds the
// margin on a model of the two.
__device__ __forceinline__ bool near_bf16_boundary(float x, float m) {
  const float tol = mul(m, 0x1p-19f);
  const float mid = __uint_as_float((__float_as_uint(x) & 0xffff0000u) | 0x8000u);
  const float binade = __uint_as_float(__float_as_uint(x) & 0x7f800000u);
  return fabsf(sub(x, mid)) <= tol || tol >= mul(binade, 0x1p-9f);
}

// One logit as attention.cu's fp32 CUDA-core body and the plain version sum
// it: q scaled in bf16, one fma per d from d = 0, against key j of the tile.
template <int D>
__device__ __forceinline__ float refine_logit(const bf16* q, float scale, const bf16* ks, int j) {
  float s = 0.f;
#pragma unroll 1
  for (int c = 0; c < D / 8; ++c) {
    const uint4 qv = *reinterpret_cast<const uint4*>(q + c * 8);
    const uint4 kv = *reinterpret_cast<const uint4*>(ks + tile_offset<D>(j, c));
    const bf16* qe = reinterpret_cast<const bf16*>(&qv);
    const bf16* ke = reinterpret_cast<const bf16*>(&kv);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      s = __fmaf_rn(bf16_round(mul(__bfloat162float(qe[e]), scale)), __bfloat162float(ke[e]), s);
  }
  return s;
}

// Refine the flagged logits of a tile (bit 4 nt + r of near: s[nt][r]). Each
// lane walks its own flags, so the warp takes as many steps as its busiest
// lane, and writes each value back by a select over the tile's registers.
template <int D, int kSteps>
__device__ __forceinline__ void refine_near(float (&s)[2 * kSteps][4], uint32_t (&near)[(8 * kSteps + 31) / 32],
                                            const bf16* ks, const QRows& qr, int key0) {
  const int lane = threadIdx.x & 31;
  for (;;) {
    int idx = -1;
#pragma unroll
    for (int w = 0; w < (8 * kSteps + 31) / 32; ++w)
      if (idx < 0 && near[w] != 0u) {
        idx = 32 * w + __ffs(near[w]) - 1;
        near[w] &= near[w] - 1u;
      }
    if (idx < 0) break;
    const int nt = idx >> 2, r = idx & 3;
    const float v = refine_logit<D>(r >> 1 ? qr.hi : qr.lo, qr.scale, ks, key0 + nt * 8 + (lane & 3) * 2 + (r & 1));
#pragma unroll
    for (int t = 0; t < 2 * kSteps; ++t)
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        if (4 * t + rr == idx) s[t][rr] = v;
  }
  __syncwarp();
}

// The logits of the warp's rows against keys key0 .. key0 + 16 kSteps - 1;
// n8 tiles at and past `used` keys are skipped (left 0: masked later).
// kNoSoftmax also takes sum |q_d k_d| of each logit on the tensor cores and
// refines the logits of keys below `used` near a bf16 boundary.
template <int D, int kMode, int kSteps>
__device__ __forceinline__ void tile_logits(const bf16* ks, const uint32_t (&qa)[D / 16][4], const QRows& qr,
                                            int key0, int used, float (&s)[2 * kSteps][4]) {
  const int lane = threadIdx.x & 31;
  uint32_t near[(8 * kSteps + 31) / 32] = {};  // kNoSoftmax: the logits to refine
#pragma unroll
  for (int nt = 0; nt < 2 * kSteps; ++nt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) s[nt][r] = 0.f;
    const int n0 = key0 + nt * 8;
    if (n0 < used) {
      float mag[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int half = 0; half < D / 32; ++half) {
        // matrices: d chunks 4 half .. 4 half + 3 of keys n0 .. n0 + 7; b[0..1]
        // is the B fragment of k-step 2 half, b[2..3] of 2 half + 1.
        uint32_t b[4];
        ldmatrix_x4(b, ks + tile_offset<D>(n0 + (lane & 7), half * 4 + (lane >> 3)));
        mma_bf16(s[nt], qa[2 * half], b);
        mma_bf16(s[nt], qa[2 * half + 1], b + 2);
        if constexpr (kMode == kNoSoftmax) {
          const uint32_t bm[4] = {b[0] & kAbs, b[1] & kAbs, b[2] & kAbs, b[3] & kAbs};
          const uint32_t q0[4] = {qa[2 * half][0] & kAbs, qa[2 * half][1] & kAbs, qa[2 * half][2] & kAbs,
                                  qa[2 * half][3] & kAbs};
          const uint32_t q1[4] = {qa[2 * half + 1][0] & kAbs, qa[2 * half + 1][1] & kAbs,
                                  qa[2 * half + 1][2] & kAbs, qa[2 * half + 1][3] & kAbs};
          mma_bf16(mag, q0, bm);
          mma_bf16(mag, q1, bm + 2);
        }
      }
      if constexpr (kMode == kNoSoftmax) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if ((r >> 1 ? qr.hi : qr.lo) != nullptr && n0 + (lane & 3) * 2 + (r & 1) < used &&
              near_bf16_boundary(s[nt][r], mag[r]))
            near[(4 * nt + r) / 32] |= 1u << ((4 * nt + r) % 32);
      }
      if (kMode == kBf16Logits) {
#pragma unroll
        for (int r = 0; r < 4; ++r) s[nt][r] = bf16_round(s[nt][r]);
      }
    }
  }
  if constexpr (kMode == kNoSoftmax) refine_near<D, kSteps>(s, near, ks, qr, key0);
}

// Accumulator r of n8 tile nt holds key key0 + 8 nt + 2 (lane % 4) + (r & 1)
// of row g + 8 (r >> 1); lim[h] is the number of keys that row sees.
template <int kSteps>
__device__ __forceinline__ void tile_max(const float (&s)[2 * kSteps][4], int key0,
                                         const int (&lim)[2], float (&peak)[2]) {
  const int j0 = key0 + (threadIdx.x & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < 2 * kSteps; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (j0 + nt * 8 + (r & 1) < lim[r >> 1]) peak[r >> 1] = fmaxf(peak[r >> 1], s[nt][r]);
}

// The exps of one tile (in place) and their sums; the dividing modes also
// track each row's smallest positive exp (minpos) for the reciprocal's range.
template <int kMode, int kSteps>
__device__ __forceinline__ void tile_exps(float (&s)[2 * kSteps][4], int key0, const int (&lim)[2],
                                          const float (&peak)[2], float (&denom)[2], float (&minpos)[2]) {
  const int j0 = key0 + (threadIdx.x & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < 2 * kSteps; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float e = j0 + nt * 8 + (r & 1) < lim[r >> 1] ? softmax_exp<kMode>(s[nt][r], peak[r >> 1]) : 0.f;
      s[nt][r] = e;
      denom[r >> 1] += e;
      if (divides<kMode>() && e > 0.f) minpos[r >> 1] = fminf(minpos[r >> 1], e);
    }
}

// The weights of one tile from its exps (its logits in kNoSoftmax), rounded
// to bf16, into the P.V product. kByReciprocal: the dividing modes divide
// through norm = RN(1 / denom) (div_by_reciprocal), else by the IEEE divide.
template <int D, int kMode, int kSteps, bool kByReciprocal>
__device__ __forceinline__ void tile_pv(const bf16* vs, const float (&s)[2 * kSteps][4], int key0, int used,
                                        const int (&lim)[2], const float (&denom)[2], const float (&norm)[2],
                                        float (&o)[D / 8][4]) {
  const int lane = threadIdx.x & 31;
  const int j0 = key0 + (lane & 3) * 2;
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    if (key0 + ks * 16 >= used) continue;
    float w[2][4];
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int nt = 2 * ks + half, row = r >> 1;
        const float v = s[nt][r];
        const float wgt = kMode == kNoSoftmax                 ? v
                          : divides<kMode>() && kByReciprocal ? div_by_reciprocal(v, denom[row], norm[row])
                                                              : softmax_weight<kMode>(v, denom[row], norm[row]);
        w[half][r] = j0 + nt * 8 + (r & 1) >= lim[row] ? 0.f : wgt;
      }
    // The C fragments of n8 tiles 2 ks and 2 ks + 1 are the A fragment of k-step ks.
    const uint32_t pa[4] = {pack_bf16(w[0][0], w[0][1]), pack_bf16(w[0][2], w[0][3]),
                            pack_bf16(w[1][0], w[1][1]), pack_bf16(w[1][2], w[1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      // matrices: keys 16 ks .. +7 and +8 .. +15 of d chunks 2 dp and 2 dp + 1,
      // transposed: b[0..1] is the B fragment of d tile 2 dp, b[2..3] of 2 dp + 1.
      uint32_t b[4];
      ldmatrix_x4_trans(b, vs + tile_offset<D>(key0 + ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                               dp * 2 + (lane >> 4)));
      mma_bf16(o[2 * dp], pa, b);
      mma_bf16(o[2 * dp + 1], pa, b + 2);
    }
  }
}

// P.V of one tile, the reciprocal's range decided once per warp (by_reciprocal
// is warp-uniform), so that the weights of the common case carry no branch.
template <int D, int kMode, int kSteps>
__device__ __forceinline__ void tile_weights_pv(bool by_reciprocal, const bf16* vs, const float (&s)[2 * kSteps][4],
                                                int key0, int used, const int (&lim)[2], const float (&denom)[2],
                                                const float (&norm)[2], float (&o)[D / 8][4]) {
  if (!divides<kMode>() || by_reciprocal)
    tile_pv<D, kMode, kSteps, true>(vs, s, key0, used, lim, denom, norm, o);
  else
    tile_pv<D, kMode, kSteps, false>(vs, s, key0, used, lim, denom, norm, o);
}

// The attention of the warp's 16 query rows i0 .. i0 + 15 over the K and V
// tiles: row i sees keys j < keys, and j <= i too under causal. o is the fp32
// P.V (row g: o[t][0..1], row g + 8: o[t][2..3], d = 8 t + 2 (lane % 4) + 0..1).
// Every warp of the block calls it, so that all reach the block's one wait_v
// at the same place: a warp with no rows (the last tile past the end) passes
// keys = 0, skips every key tile and leaves o at 0.
template <int D, int kMode, int kSteps, bool kSweep>
__device__ __forceinline__ void attend(const bf16* ks, const bf16* vs, const uint32_t (&qa)[D / 16][4],
                                       const QRows& qr, int i0, int keys, bool causal, float out_mul,
                                       float (&o)[D / 8][4]) {
  const int g = (threadIdx.x & 31) >> 2;
  const int lim[2] = {causal ? min(i0 + g + 1, keys) : keys, causal ? min(i0 + g + 9, keys) : keys};
  const int used = causal ? min(i0 + 16, keys) : keys;  // the keys any of the 16 rows sees
#pragma unroll
  for (int t = 0; t < D / 8; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[t][r] = 0.f;
  float peak[2] = {kMode == kNoMax ? 0.f : -INFINITY, kMode == kNoMax ? 0.f : -INFINITY};
  float denom[2] = {0.f, 0.f}, norm[2] = {0.f, 0.f}, minpos[2] = {INFINITY, INFINITY};
  bool by_reciprocal = true;
  float s[2 * kSteps][4];
  auto finish = [&]() {  // the row statistics, once every key has been seen
    bool ok = true;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      denom[h] = quad_sum(denom[h]);
      norm[h] = softmax_norm<kMode>(denom[h], out_mul);
      if (divides<kMode>()) {
        minpos[h] = fminf(minpos[h], __shfl_xor_sync(0xffffffffu, minpos[h], 1));
        minpos[h] = fminf(minpos[h], __shfl_xor_sync(0xffffffffu, minpos[h], 2));
        ok = ok && denom[h] >= 0x1p-100f && denom[h] <= 0x1p100f && mul(minpos[h], norm[h]) >= 0x1p-99f;
      }
    }
    if (divides<kMode>()) by_reciprocal = __all_sync(0xffffffffu, ok);
  };
  if constexpr (!kSweep) {
    tile_logits<D, kMode, kSteps>(ks, qa, qr, 0, used, s);
    if (kMode != kNoSoftmax) {
      if (kMode != kNoMax) {
        tile_max<kSteps>(s, 0, lim, peak);
        peak[0] = quad_max(peak[0]);
        peak[1] = quad_max(peak[1]);
      }
      tile_exps<kMode, kSteps>(s, 0, lim, peak, denom, minpos);
      finish();
    }
    wait_v();
    tile_weights_pv<D, kMode, kSteps>(by_reciprocal, vs, s, 0, used, lim, denom, norm, o);
  } else {
    constexpr int kTile = 16 * kSteps;
    if (kMode != kNoSoftmax) {
      if (kMode != kNoMax) {
        for (int key0 = 0; key0 < used; key0 += kTile) {
          tile_logits<D, kMode, kSteps>(ks, qa, qr, key0, used, s);
          tile_max<kSteps>(s, key0, lim, peak);
        }
        peak[0] = quad_max(peak[0]);
        peak[1] = quad_max(peak[1]);
      }
      for (int key0 = 0; key0 < used; key0 += kTile) {
        tile_logits<D, kMode, kSteps>(ks, qa, qr, key0, used, s);
        tile_exps<kMode, kSteps>(s, key0, lim, peak, denom, minpos);
      }
      finish();
    }
    wait_v();
    for (int key0 = 0; key0 < used; key0 += kTile) {
      tile_logits<D, kMode, kSteps>(ks, qa, qr, key0, used, s);
      if (kMode != kNoSoftmax) {
        float unused[2] = {0.f, 0.f}, unused_min[2] = {0.f, 0.f};
        tile_exps<kMode, kSteps>(s, key0, lim, peak, unused, unused_min);
      }
      tile_weights_pv<D, kMode, kSteps>(by_reciprocal, vs, s, key0, used, lim, denom, norm, o);
    }
  }
}

// Two adjacent outputs of one row: int8 (requantized) or bf16.
template <int kMode>
__device__ __forceinline__ void store_pair(void* out, size_t idx, float a, float b, float out_mul) {
  if constexpr (int8_out<kMode>()) {
    *reinterpret_cast<char2*>(static_cast<int8_t*>(out) + idx) =
        make_char2(requant<kMode>(a, out_mul), requant<kMode>(b, out_mul));
  } else {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + idx) = __floats2bfloat162_rn(a, b);
  }
}

// The warp's output rows: element offsets of row g's and row g + 8's head
// slice, or -1 for a row past the end.
template <int D, int kMode>
__device__ __forceinline__ void store_rows(void* out, long long lo, long long hi, const float (&o)[D / 8][4],
                                           float out_mul) {
  const int c = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {
    if (lo >= 0) store_pair<kMode>(out, static_cast<size_t>(lo) + t * 8 + c, o[t][0], o[t][1], out_mul);
    if (hi >= 0) store_pair<kMode>(out, static_cast<size_t>(hi) + t * 8 + c, o[t][2], o[t][3], out_mul);
  }
}

}  // namespace attn
}  // namespace fitclip
