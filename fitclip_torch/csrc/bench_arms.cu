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
//                  of each row's 3W values and writes W bytes. One warp per
//                  output row (one divide per row, none per element), the row
//                  read as 16-byte streaming loads (8 bf16 or 4 fp32 values, up
//                  to four a lane in flight) and written as 8- or 4-byte
//                  stores; a row whose source or destination is not aligned to
//                  the vector, and the last W mod 8 (4) columns, take scalar
//                  loads. The grid is one warp a row: 3,140 blocks of 8 warps
//                  for S3's 32 x 785 rows, 4 for `nocls`'s one row a clip.
//   attn_amax      per block of `block` frames, max(|x|) over every head's q, k
//                  and v (floored at 1e-6, NaN propagated): the dynamic
//                  per-block scales of the int8 arms of
//                  scripts/bench_attn_int8.py:_variant_kernel (S2, q_amax,
//                  k_amax, v_amax). Bound by memory: one streaming read of qkv
//                  with 16-byte loads, four rows in flight a thread, the max
//                  taken on the bf16 bit patterns two at a time (__vmaxu2), each
//                  frame block spread over enough CTAs to fill the SMs and
//                  combined with atomicMax.
//   attention_s8   S2's `i8qk` and `i8qkav` cores on the layout of the bf16
//                  tensor-core core (attention_mma.cuh): one block of four
//                  warps per (head, frame) walks the frame's query tiles of 64
//                  rows, each warp owning 16 rows of a tile, so that K and V
//                  are quantized once per (frame, head). V lands in bf16 by
//                  cp.async (attention_mma.cuh's tile) while K is quantized
//                  in registers from 16-byte loads, rint(x * (127 / amax))
//                  clipped to +-127, into int8 [key][64] rows with the
//                  16-byte chunks XOR-swizzled by row, the pad keys up to a
//                  multiple of 16 zero. q is quantized from 8-byte loads
//                  straight into the A fragments of mma.sync.m16n8k32.s8, and
//                  one ldmatrix.x4 of 8 keys gives both k-steps' B fragments.
//                  The int32 sums, times q_amax * k_amax * scale / 127^2, are
//                  the logits, held in the bf16 core's accumulator layout, so
//                  its row max, exps and sums (two quad shuffles) apply
//                  unchanged: up to 208 keys every logit stays in registers
//                  and QK^T runs once; past that the keys are swept in tiles
//                  of 64, QK^T recomputed in each of three passes (exact: int8
//                  products sum exactly in int32). i8qk: the bf16 core's kQkv
//                  weights div(e, denom) in bf16 and its P.V (ldmatrix.trans
//                  of the bf16 V tile, fp32 accumulation). i8qkav: V is
//                  quantized once from the bf16 tile into an int8 [d][position]
//                  tile whose positions permute each 32-key step as the QK^T
//                  accumulators hold the keys (2t, 2t + 1, 8 + 2t, 9 + 2t of
//                  each 16 on lane t; the contraction takes the keys in any
//                  order), so the weights rint(div(e, denom) * 127) pack into
//                  the A fragments of m16n8k32 as they lie, and an
//                  ldmatrix.x4 of the tile gives two d tiles' B fragments;
//                  out = acc * v_amax / 127^2. Output bf16. Like the bf16 core
//                  it is bound by the latency of each warp's chain of loads,
//                  exps and mma steps (three blocks an SM at 197 keys), not by
//                  its 31 G int8 products or its bytes per 512 frames.
#include <algorithm>

#include "attention_mma.cuh"

using namespace fitclip;
using namespace fitclip::attn;

namespace {

constexpr int kHeadDim = 64;
constexpr size_t kSmemLimit = 232448;  // shared memory a block can use on an H100

__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// Four int8 values packed into a 32-bit word, the first in the low byte.
__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) | (static_cast<uint32_t>(d) << 24);
}

// 32-bit word e of a 16-byte vector (e a constant once unrolled).
__device__ __forceinline__ uint32_t word(const uint4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// quant_rint(x * inv) of the two bf16 values of w and the two of w2, packed.
__device__ __forceinline__ uint32_t quant_bf16x4(uint32_t w, uint32_t w2, float inv) {
  return pack_s8(quant_rint(mul(bf16_lo(w), inv)), quant_rint(mul(bf16_hi(w), inv)),
                 quant_rint(mul(bf16_lo(w2), inv)), quant_rint(mul(bf16_hi(w2), inv)));
}

// --- slice_requant --------------------------------------------------------------

constexpr int kSliceWarps = 8;   // rows per block of 256 threads
constexpr int kSliceUnroll = 4;  // 16-byte vectors a lane has in flight

// The int8 values of one 16-byte vector: 8 bf16 -> 8 bytes, 4 fp32 -> 4 bytes.
__device__ __forceinline__ void store_quant(int8_t* dst, const uint4& v, float inv, __nv_bfloat16) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(quant_bf16x4(v.x, v.y, inv), quant_bf16x4(v.z, v.w, inv));
}

__device__ __forceinline__ void store_quant(int8_t* dst, const uint4& v, float inv, float) {
  *reinterpret_cast<uint32_t*>(dst) =
      pack_s8(quant_rint(mul(__uint_as_float(v.x), inv)), quant_rint(mul(__uint_as_float(v.y), inv)),
              quant_rint(mul(__uint_as_float(v.z), inv)), quant_rint(mul(__uint_as_float(v.w), inv)));
}

// Warp r of the grid takes output row r (clip r / rows, row row0 + r % rows).
template <typename T>
__global__ void __launch_bounds__(kSliceWarps * 32)
slice_requant_rows_kernel(const T* __restrict__ qkv, int8_t* __restrict__ out, int n, int row0, int rows,
                          int width, float inv, long long total) {
  constexpr int kVec = 16 / sizeof(T);  // values per 16-byte load
  const long long r = static_cast<long long>(blockIdx.x) * kSliceWarps + (threadIdx.x >> 5);
  if (r >= total) return;
  const int lane = threadIdx.x & 31;
  const long long clip = r / rows;
  const long long row = clip * n + row0 + (r - clip * rows);
  const T* src = qkv + row * 3 * width;
  int8_t* dst = out + row * width;
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(dst) & (kVec - 1)) == 0;
  const int vecs = aligned ? width / kVec : 0;
  const uint4* sv = reinterpret_cast<const uint4*>(src);
  for (int v0 = lane; v0 < vecs; v0 += 32 * kSliceUnroll) {
    uint4 x[kSliceUnroll];
#pragma unroll
    for (int u = 0; u < kSliceUnroll; ++u)
      if (v0 + 32 * u < vecs) x[u] = load_stream(sv + v0 + 32 * u);
#pragma unroll
    for (int u = 0; u < kSliceUnroll; ++u)
      if (v0 + 32 * u < vecs) store_quant(dst + (v0 + 32 * u) * kVec, x[u], inv, T());
  }
  for (int c = vecs * kVec + lane; c < width; c += 32) dst[c] = quant_rint(mul(to_float(src[c]), inv));
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

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Shared memory of one block: K int8, round16(seq) rows of 64 bytes; then V
// in bf16, round16(seq) x 64 (attention_mma.cuh's V tile: i8qk's P.V operand,
// i8qkav's staging); i8qkav then its int8 [d][position] tile, vpitch bytes a
// row (round32(seq) positions, + 16 so that ldmatrix's eight rows fall in
// distinct banks).
struct S8Smem {
  int vpitch;
  size_t v_off, vt_off, total;
};

__host__ __device__ inline S8Smem s8_smem(int seq, bool av8) {
  S8Smem s;
  s.vpitch = (seq + 31) / 32 * 32 + 16;
  s.v_off = static_cast<size_t>(round16(seq)) * kHeadDim;
  s.vt_off = s.v_off + sizeof(bf16) * static_cast<size_t>(round16(seq)) * kHeadDim;
  s.total = s.vt_off + (av8 ? static_cast<size_t>(kHeadDim) * s.vpitch : 0);
  return s;
}

// Byte offset of 8-byte half c8 & 1 of 16-byte chunk c8 >> 1 of key j in the K
// tile: the chunks swizzled as tile_offset<32> swizzles a 64-byte bf16 row.
__device__ __forceinline__ int k_offset(int j, int c8) {
  return j * kHeadDim + (((c8 >> 1) ^ ((j >> 1) & 3)) << 4) + ((c8 & 1) << 3);
}

// The key at position p of V's int8 tile: within each 32-key step, position
// 4 t + i of half h (16 positions) holds key 16 h + 8 (i >> 1) + 2 t + (i & 1),
// the keys lane t's accumulators hold in the step's four n8 tiles.
__host__ __device__ constexpr int position_key(int p) {
  return (p & ~31) + (p & 16) + ((p >> 1) & 1) * 8 + ((p >> 2) & 3) * 2 + (p & 1);
}

// K of keys 0 .. seq - 1 quantized into the int8 tile, keys seq ..
// round16(seq) - 1 zero, in rounds: each round a thread issues all its loads
// (up to kBatch items), then quantizes and stores them, so that a round costs
// one load latency; up to 208 keys one round of 13 takes the tile
// (round16(seq) / 16 items a thread). Item (j, c8): d 8 c8 .. 8 c8 + 7 of key
// j, eight lanes reading a key's 128 bytes -> 8 bytes of the [key][64] tile.
template <int kBatch, typename RowFn>
__device__ __forceinline__ void quantize_k(int8_t* ks, int seq, int width, float inv, RowFn row) {
  const int items = round16(seq) * 8;
  for (int i0 = threadIdx.x; i0 < items; i0 += kThreads * kBatch) {
    uint4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = i0 + u * kThreads, j = idx >> 3;
      v[u] = idx < items && j < seq ? *reinterpret_cast<const uint4*>(row(j) + width + (idx & 7) * 8)
                                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = i0 + u * kThreads;
      if (idx < items)
        *reinterpret_cast<uint2*>(ks + k_offset(idx >> 3, idx & 7)) =
            make_uint2(quant_bf16x4(v[u].x, v[u].y, inv), quant_bf16x4(v[u].z, v[u].w, inv));
    }
  }
}

// i8qkav's V quantized from the bf16 tile (vs, rows 0 .. round16(seq) - 1) into
// vt[d][position], positions of keys past seq zero. Item (c8, group): d 8 c8
// .. 8 c8 + 7 of the four keys of positions 4 group .. 4 group + 3 -> one
// 32-bit word per d; consecutive lanes take consecutive groups, so a warp's
// stores of one d are consecutive words.
__device__ __forceinline__ void quantize_vt(const bf16* vs, int8_t* vt, int vpitch, int seq, float inv) {
  const int groups = (seq + 31) / 32 * 8;
  for (int idx = threadIdx.x; idx < 8 * groups; idx += kThreads) {
    const int c8 = idx / groups, group = idx - c8 * groups;
    uint4 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = position_key(4 * group + i);
      v[i] = j < seq ? *reinterpret_cast<const uint4*>(vs + tile_offset<kHeadDim>(j, c8)) : make_uint4(0u, 0u, 0u, 0u);
    }
    int8_t* dst = vt + c8 * 8 * vpitch + 4 * group;
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // bf16 pair e of each key's vector: d = 8 c8 + 2 e, + 1
      const uint32_t w[4] = {word(v[0], e), word(v[1], e), word(v[2], e), word(v[3], e)};
      *reinterpret_cast<uint32_t*>(dst + 2 * e * vpitch) =
          pack_s8(quant_rint(mul(bf16_lo(w[0]), inv)), quant_rint(mul(bf16_lo(w[1]), inv)),
                  quant_rint(mul(bf16_lo(w[2]), inv)), quant_rint(mul(bf16_lo(w[3]), inv)));
      *reinterpret_cast<uint32_t*>(dst + (2 * e + 1) * vpitch) =
          pack_s8(quant_rint(mul(bf16_hi(w[0]), inv)), quant_rint(mul(bf16_hi(w[1]), inv)),
                  quant_rint(mul(bf16_hi(w[2]), inv)), quant_rint(mul(bf16_hi(w[3]), inv)));
    }
  }
}

// The raw q values of the warp's 16 rows for the m16k32 A fragments (lo: row
// g, hi: row g + 8; 0 past the end): k-step kk, register i holds d 32 kk +
// 16 (i >> 1) + 4 t .. + 3 of row lo (i even) or hi. Loaded before K's round
// so that both are in flight together; quantized after it (quantize_q).
__device__ __forceinline__ void load_q_raw(const bf16* lo, const bf16* hi, uint2 (&raw)[2][4]) {
  const int d = (threadIdx.x & 3) * 4;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bf16* row = i & 1 ? hi : lo;
      raw[kk][i] = row == nullptr ? make_uint2(0u, 0u)
                                  : *reinterpret_cast<const uint2*>(row + 32 * kk + 16 * (i >> 1) + d);
    }
}

__device__ __forceinline__ void quantize_q(const uint2 (&raw)[2][4], float inv, uint32_t (&qa)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) qa[kk][i] = quant_bf16x4(raw[kk][i].x, raw[kk][i].y, inv);
}

// The logits of the warp's rows against keys key0 .. key0 + 16 kSteps - 1 in
// the bf16 core's accumulator layout (tile_logits' producer in int8): per n8
// tile one ldmatrix.x4 (the 8 keys' four 16-byte chunks: both k-steps' B
// fragments) and two m16n8k32 steps, the int32 sum times logit_scale. Tiles
// at and past `used` keys are skipped (left 0: masked later).
template <int kSteps>
__device__ __forceinline__ void s8_logits(const int8_t* ks, const uint32_t (&qa)[2][4], int key0, int used,
                                          float logit_scale, float (&s)[2 * kSteps][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < 2 * kSteps; ++nt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) s[nt][r] = 0.f;
    const int n0 = key0 + nt * 8;
    if (n0 < used) {
      uint32_t b[4];
      ldmatrix_x4(b, reinterpret_cast<const bf16*>(ks) + tile_offset<32>(n0 + (lane & 7), lane >> 3));
      int c[4] = {0, 0, 0, 0};
      mma_s8(c, qa[0], b);
      mma_s8(c, qa[1], b + 2);
#pragma unroll
      for (int r = 0; r < 4; ++r) s[nt][r] = mul(__int2float_rn(c[r]), logit_scale);
    }
  }
}

// The A fragment of i8qkav's 32-key step st of a tile: the int8 weights
// rint(div(e, denom) * 127) of n8 tiles 4 st .. 4 st + 3 (0 past the tile or
// the row's keys), packed as they lie in the accumulators: positions 4 t ..
// 4 t + 3 of each half step are the lane's keys (position_key).
// kByReciprocal: the divide through norm, as tile_pv.
template <int kSteps, bool kByReciprocal>
__device__ __forceinline__ void s8_step_weights(const float (&s)[2 * kSteps][4], int st, int key0, const int (&lim)[2],
                                                const float (&denom)[2], const float (&norm)[2], uint32_t (&a)[4]) {
  const int j0 = key0 + (threadIdx.x & 3) * 2;
  int w[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int nt = 4 * st + q, row = r >> 1;
      w[q][r] = 0;
      if (nt < 2 * kSteps && j0 + nt * 8 + (r & 1) < lim[row]) {
        const float wq = kByReciprocal ? div_by_reciprocal(s[nt][r], denom[row], norm[row])
                                       : div(s[nt][r], denom[row]);
        w[q][r] = __float2int_rn(mul(wq, 127.f));
      }
    }
  a[0] = pack_s8(w[0][0], w[0][1], w[1][0], w[1][1]);  // row g, positions 4 t ..
  a[1] = pack_s8(w[0][2], w[0][3], w[1][2], w[1][3]);  // row g + 8
  a[2] = pack_s8(w[2][0], w[2][1], w[3][0], w[3][1]);  // row g, positions 16 + 4 t ..
  a[3] = pack_s8(w[2][2], w[2][3], w[3][2], w[3][3]);
}

// i8qkav's P.V of one tile: per 32-key step its A fragment (s8_step_weights)
// and, per pair of d tiles, one ldmatrix.x4 of the [d][position] tile (rows
// d, the step's two 16-byte chunks: both d tiles' B fragments) and two
// m16n8k32 steps.
template <int kSteps, bool kByReciprocal>
__device__ __forceinline__ void s8_tile_pv(const int8_t* vt, int vpitch, const float (&s)[2 * kSteps][4], int key0,
                                           int used, const int (&lim)[2], const float (&denom)[2],
                                           const float (&norm)[2], int (&acc)[kHeadDim / 8][4]) {
  const int lane = threadIdx.x & 31;
  const int8_t* base = vt + ((lane & 7) + ((lane >> 4) << 3)) * vpitch + ((lane >> 3) & 1) * 16 + key0;
#pragma unroll
  for (int st = 0; st < (2 * kSteps + 3) / 4; ++st) {
    if (key0 + st * 32 >= used) continue;
    uint32_t a[4];
    s8_step_weights<kSteps, kByReciprocal>(s, st, key0, lim, denom, norm, a);
#pragma unroll
    for (int dp = 0; dp < kHeadDim / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4(b, reinterpret_cast<const bf16*>(base + dp * 16 * vpitch + st * 32));
      mma_s8(acc[2 * dp], a, b);
      mma_s8(acc[2 * dp + 1], a, b + 2);
    }
  }
}

// The attention of the warp's 16 query rows over the K tile and V (i8qk: the
// bf16 tile vs; i8qkav: the int8 [d][position] tile vt), every key below
// `keys` visible: attention_mma.cuh's attend with s8_logits as the logits'
// producer, kQkv's softmax, and for i8qkav s8_tile_pv. o: the fp32 output
// (i8qkav: acc * out_scale). It has no barrier: K and V are in place.
template <bool kAV8, int kSteps, bool kSweep>
__device__ __forceinline__ void attend_s8(const int8_t* ks, const bf16* vs, const int8_t* vt, int vpitch,
                                          const uint32_t (&qa)[2][4], float logit_scale, int keys,
                                          float out_scale, float (&o)[kHeadDim / 8][4]) {
  const int lim[2] = {keys, keys};
  const int used = keys;
  int acc[kHeadDim / 8][4];
#pragma unroll
  for (int t = 0; t < kHeadDim / 8; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      o[t][r] = 0.f;
      acc[t][r] = 0;
    }
  float peak[2] = {-INFINITY, -INFINITY};
  float denom[2] = {0.f, 0.f}, norm[2] = {0.f, 0.f}, minpos[2] = {INFINITY, INFINITY};
  bool by_reciprocal = true;
  float s[2 * kSteps][4];
  auto finish = [&]() {  // the row statistics, once every key has been seen (attend's)
    bool ok = true;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      denom[h] = quad_sum(denom[h]);
      norm[h] = softmax_norm<kQkv>(denom[h], 1.f);
      minpos[h] = fminf(minpos[h], __shfl_xor_sync(0xffffffffu, minpos[h], 1));
      minpos[h] = fminf(minpos[h], __shfl_xor_sync(0xffffffffu, minpos[h], 2));
      ok = ok && denom[h] >= 0x1p-100f && denom[h] <= 0x1p100f && mul(minpos[h], norm[h]) >= 0x1p-99f;
    }
    by_reciprocal = __all_sync(0xffffffffu, ok);
  };
  auto pv = [&](int key0) {
    if constexpr (kAV8) {
      if (by_reciprocal)
        s8_tile_pv<kSteps, true>(vt, vpitch, s, key0, used, lim, denom, norm, acc);
      else
        s8_tile_pv<kSteps, false>(vt, vpitch, s, key0, used, lim, denom, norm, acc);
    } else {
      tile_weights_pv<kHeadDim, kQkv, kSteps>(by_reciprocal, vs, s, key0, used, lim, denom, norm, o);
    }
  };
  if constexpr (!kSweep) {
    s8_logits<kSteps>(ks, qa, 0, used, logit_scale, s);
    tile_max<kSteps>(s, 0, lim, peak);
    peak[0] = quad_max(peak[0]);
    peak[1] = quad_max(peak[1]);
    tile_exps<kQkv, kSteps>(s, 0, lim, peak, denom, minpos);
    finish();
    pv(0);
  } else {
    constexpr int kTile = 16 * kSteps;
    for (int key0 = 0; key0 < used; key0 += kTile) {
      s8_logits<kSteps>(ks, qa, key0, used, logit_scale, s);
      tile_max<kSteps>(s, key0, lim, peak);
    }
    peak[0] = quad_max(peak[0]);
    peak[1] = quad_max(peak[1]);
    for (int key0 = 0; key0 < used; key0 += kTile) {
      s8_logits<kSteps>(ks, qa, key0, used, logit_scale, s);
      tile_exps<kQkv, kSteps>(s, key0, lim, peak, denom, minpos);
    }
    finish();
    for (int key0 = 0; key0 < used; key0 += kTile) {
      s8_logits<kSteps>(ks, qa, key0, used, logit_scale, s);
      float unused[2] = {0.f, 0.f}, unused_min[2] = {0.f, 0.f};
      tile_exps<kQkv, kSteps>(s, key0, lim, peak, unused, unused_min);
      pv(key0);
    }
  }
  if constexpr (kAV8) {
#pragma unroll
    for (int t = 0; t < kHeadDim / 8; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[t][r] = mul(__int2float_rn(acc[t][r]), out_scale);
  }
}

// One block per (head, frame) walks the frame's query tiles of 64 rows, so
// that K and V are quantized once per (frame, head): V lands in bf16 by
// cp.async while K is quantized in registers (the first tile's q loads in
// flight beside K's), then i8qkav quantizes V into its [d][position] tile.
template <bool kAV8, int kSteps, bool kSweep>
__global__ void __launch_bounds__(kThreads, min_blocks<kSteps, kSweep>())
attention_s8_mma_kernel(const bf16* __restrict__ qkv, const float* __restrict__ scales, bf16* __restrict__ out,
                        int seq, int heads, int block, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const S8Smem lay = s8_smem(seq, kAV8);
  int8_t* ks = reinterpret_cast<int8_t*>(smem);
  bf16* vs = reinterpret_cast<bf16*>(smem + lay.v_off);
  int8_t* vt = reinterpret_cast<int8_t*>(smem + lay.vt_off);

  const int width = heads * kHeadDim;
  const int h = blockIdx.x, b = blockIdx.y;
  const bf16* base = qkv + static_cast<size_t>(b) * seq * 3 * width + h * kHeadDim;
  auto row = [&](int j) { return base + static_cast<size_t>(j) * 3 * width; };
  const float* sc = scales + (b / block) * 3;
  const float q_amax = sc[0], k_amax = sc[1], v_amax = sc[2];
  const float logit_scale = div(mul(mul(q_amax, k_amax), scale), 16129.f);
  const float inv_q = div(127.f, q_amax), out_scale = div(v_amax, 16129.f);

  load_tile<kHeadDim>(vs, seq, [&](int j) { return row(j) + 2 * width; });
  const int g = (threadIdx.x & 31) >> 2;
  uint2 q_raw[2][4];
  auto load_q = [&](int i0) {
    load_q_raw(i0 + g < seq ? row(i0 + g) : nullptr, i0 + g + 8 < seq ? row(i0 + g + 8) : nullptr, q_raw);
  };
  load_q((threadIdx.x >> 5) * 16);
  quantize_k<kSweep ? 8 : kLargeSteps>(ks, seq, width, div(127.f, k_amax), row);
  wait_v();
  if constexpr (kAV8) {
    quantize_vt(vs, vt, lay.vpitch, seq, div(127.f, v_amax));
    __syncthreads();
  }
  for (int q0 = 0; q0 < seq; q0 += kBlockRows) {  // no barrier in the loop
    const int i0 = q0 + (threadIdx.x >> 5) * 16;
    if (i0 >= seq) break;
    if (q0 > 0) load_q(i0);
    uint32_t qa[2][4];
    quantize_q(q_raw, inv_q, qa);
    float o[kHeadDim / 8][4];
    attend_s8<kAV8, kSteps, kSweep>(ks, vs, vt, lay.vpitch, qa, logit_scale, seq, out_scale, o);
    const int lo = i0 + g, hi = lo + 8;
    const long long o_row = static_cast<long long>(b) * seq * width + h * kHeadDim;
    store_rows<kHeadDim, kQkv>(out, lo < seq ? o_row + static_cast<long long>(lo) * width : -1,
                               hi < seq ? o_row + static_cast<long long>(hi) * width : -1, o, 0.f);
  }
}

template <bool kAV8, int kSteps, bool kSweep>
int launch_s8(const void* qkv, const void* scales, void* out, int frames, int seq, int heads, int block,
              float scale, cudaStream_t s) {
  const size_t smem = s8_smem(seq, kAV8).total;
  auto kernel = attention_s8_mma_kernel<kAV8, kSteps, kSweep>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(heads, frames), kThreads, smem, s>>>(static_cast<const bf16*>(qkv), static_cast<const float*>(scales),
                                                     static_cast<bf16*>(out), seq, heads, block, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool kAV8>
int dispatch_s8(const void* qkv, const void* scales, void* out, int frames, int seq, int heads, int block,
                float scale, cudaStream_t s) {
  if (seq <= kResidentKeys)
    return launch_s8<kAV8, kLargeSteps, false>(qkv, scales, out, frames, seq, heads, block, scale, s);
  return launch_s8<kAV8, kSweepSteps, true>(qkv, scales, out, frames, seq, heads, block, scale, s);
}

}  // namespace

// out (clips, n, W) int8, rows [row0, row0 + rows) of each clip, from qkv (clips, n, 3W).
extern "C" int fitclip_slice_requant(const void* qkv, int dtype, void* out, int clips, int n,
                                     int row0, int rows, int width, float inv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (clips < 1 || rows < 1 || width < 1 || row0 < 0 || row0 + rows > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = static_cast<long long>(clips) * rows;
  const unsigned grid = static_cast<unsigned>((total + kSliceWarps - 1) / kSliceWarps);
  int8_t* o = static_cast<int8_t*>(out);
  if (dtype == kBFloat16) {
    slice_requant_rows_kernel<__nv_bfloat16><<<grid, kSliceWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(qkv), o, n, row0, rows, width, inv, total);
  } else if (dtype == kFloat32) {
    slice_requant_rows_kernel<float><<<grid, kSliceWarps * 32, 0, s>>>(
        static_cast<const float*>(qkv), o, n, row0, rows, width, inv, total);
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
  return s8_smem(seq, av8 != 0).total;
}

// bf16 qkv (frames, seq, 3 * heads * 64), scales from fitclip_attn_amax -> bf16 out
// (frames, seq, heads * 64). av8: the i8qkav arm, else i8qk. Up to 208 keys
// the logits stay in registers, past that the sweep; a length whose tiles
// do not fit a block's shared memory is refused.
extern "C" int fitclip_attention_s8(const void* qkv, const void* scales, void* out, int frames,
                                    int seq, int heads, int block, float scale, int av8,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (frames < 1 || seq < 1 || heads < 1 || block < 1 || s8_smem(seq, av8 != 0).total > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (av8) return dispatch_s8<true>(qkv, scales, out, frames, seq, heads, block, scale, s);
  return dispatch_s8<false>(qkv, scales, out, frames, seq, heads, block, scale, s);
}
