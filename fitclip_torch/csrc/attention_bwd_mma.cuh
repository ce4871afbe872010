// attention_bwd_mma: the bf16 attention backward on the tensor cores, the two
// kernels of attention_bwd.cu's mma body.
//
// Replaces fitclip_tpu/ops/attention.py:_packed_bwd_kernel (K3b, reached from
// _bwd -> _backward_packed) for bf16, with its casts: q is scaled in bf16;
// logits, W32 = exps / denom and dW = g v^T are fp32; dV = bf16(W32)^T g;
// dL = bf16(W32 (dW - rowsum(dW W32))), 0 past the causal limit; dQ = (dL k)
// scale with scale in fp32, dK = dL^T q_s; every product is bf16 x bf16 -> fp32
// on mma.sync.m16n8k16, and dqkv is stored in bf16.
//
// What bounds it on an H100: by bytes (qkv and g read once, dqkv written
// once) it could take 0.081 ms at ViT-B/16's training shape (128 x 197 x
// 2304), by products 0.039 ms (10 B H L^2 D at 989 TFLOP/s). The CUDA-core
// kernels it replaces issued one scalar fma, one shared-memory read and one
// convert per product and took 5.7 ms there. Here every product is an mma, a
// block holds its operands in shared memory once, and each warp walks a
// dependent chain of loads, mma steps and exps: it is bound by latency, as the
// forward core (attention_mma.cuh) is, whose loader, fragments and softmax
// steps it reuses.
//
// A block is four warps and 64 rows of one (batch row, head). Blocks run in no
// order and nothing carries between them, so the two reductions over L are two
// kernels with no atomics, and the result is deterministic:
//   rows     64 query rows. K and V of the keys any row sees go to swizzled
//            shared memory once (load_kv; the pad keys up to a multiple of 16
//            are zero-filled). A warp holds its 16 rows' q_s and g as A
//            fragments. It takes the exact row peak and denominator as the
//            forward does (logits in registers up to kResidentKeys keys, a
//            sweep over tiles of 64 past that, QK^T recomputed each pass; no
//            online rescale), turns the exps into W32 in place, then
//              inner  = sum W32 dW, dW = g V^T recomputed tile by tile (V in
//                       K's place of QK^T) and never held;
//              dQ     dW once more, dL rounded to bf16 and masked, packed from
//                       the C fragments straight into A fragments (the m16n8 C
//                       layout is the m16k16 A layout, as in P.V), times K
//                       through ldmatrix.trans.
//            It writes dQ scale in bf16 and peak, denom and inner per row.
//   columns  64 keys. q_s (scaled in bf16, as the TPU kernel scales it) and g
//            of the query rows that see any of them (under causal, rows >= the
//            block's first key), zero-padded to a multiple of 16, go to
//            swizzled shared memory with those rows' statistics. A warp holds
//            its 16 keys' K and V as A fragments and streams over query tiles
//            of 16, skipping under causal the tiles wholly above its keys:
//              S^T = K q_s^T and dW^T = V g^T (q_s and g as B, ldmatrix);
//              W32^T = exp(S^T - peak_l) / denom_l, dL^T = bf16(W32^T (dW^T -
//              inner_l)), masked;
//              dV += bf16(W32)^T g and dK += dL^T q_s (g and q_s as B through
//              ldmatrix.trans).
//            There is no reduction over a row here, so it needs no sweep.
// Past 848 keys at head_dim 64 (1600 at 32) the operands overflow a block: the
// global variant (kG) keeps K alone in the rows kernel's shared memory and q_s
// alone in the columns kernel's, and reads the fragments of V and g from
// device memory through L2 (the same registers ldmatrix would give).
// S^T equals the rows kernel's S up to the tensor cores' summation order, so a
// recomputed weight may differ from the rows kernel's by an ulp: inside the
// float rule the kernel is held to. Every W32 is RN(e / denom): through the
// row's reciprocal with one Markstein correction (div_by_reciprocal) where the
// quotient is at least 2^-99 (denom lies in [1, L]: the peak's own exp is 1),
// else by the IEEE divide.
#pragma once

#include "attention_mma.cuh"

namespace fitclip {
namespace attn {
namespace bwd {

// Shared memory of the rows kernel: K and V, round16(seq) rows of head_dim bf16
// each (K alone where V is read from device memory, kG).
inline size_t rows_smem_bytes(int seq, int head_dim, bool global) {
  return (global ? 1 : 2) * sizeof(bf16) * static_cast<size_t>(round16(seq)) * head_dim;
}

// Shared memory of the columns kernel, the larger of the two: q_s and g (q_s
// alone, kG) and four fp32 statistics per row (peak, denom, its reciprocal,
// inner).
inline size_t columns_smem_bytes(int seq, int head_dim, bool global) {
  return rows_smem_bytes(seq, head_dim, global) + 4 * sizeof(float) * static_cast<size_t>(round16(seq));
}

// A [row][d] operand: a swizzled tile in shared memory, or (kG) rows in device
// memory, row j at p + j * pitch, and those at and past count read as 0.
struct Rows {
  const bf16* p;
  size_t pitch;
  int count;
};

// The B fragments of k-steps 2 half and 2 half + 1 of the n8 tile of rows n0 ..
// n0 + 7 (b[0..1], b[2..3]): ldmatrix from the tile, or the same registers from
// device memory (lane: row n0 + lane / 4, d = 32 half + 8 i + 2 (lane % 4) + 0..1).
template <int D, bool kG>
__device__ __forceinline__ void b_frags(const Rows& op, int n0, int half, uint32_t (&b)[4]) {
  const int lane = threadIdx.x & 31;
  if constexpr (kG) {
    const int j = n0 + (lane >> 2);
    const bf16* p = op.p + static_cast<size_t>(j) * op.pitch + half * 32 + (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = j < op.count ? *reinterpret_cast<const uint32_t*>(p + 8 * i) : 0u;
  } else {
    ldmatrix_x4(b, op.p + tile_offset<D>(n0 + (lane & 7), half * 4 + (lane >> 3)));
  }
}

// {rows[l][d], rows[l + 1][d]} as one bf16x2 (0 at and past count).
__device__ __forceinline__ uint32_t column_pair(const Rows& op, int l, int d) {
  const bf16 zero = __float2bfloat16(0.f);
  const __nv_bfloat162 v = __halves2bfloat162(l < op.count ? op.p[static_cast<size_t>(l) * op.pitch + d] : zero,
                                              l + 1 < op.count ? op.p[static_cast<size_t>(l + 1) * op.pitch + d] : zero);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The B fragments of d tiles 2 dp and 2 dp + 1 (b[0..1], b[2..3]) for the 16-row
// k-step from row l0: ldmatrix.trans from the tile, or the same registers from
// device memory (lane: rows l0 + 2 (lane % 4) + 0..1 and + 8, d = 8 t + lane / 4).
template <int D, bool kG>
__device__ __forceinline__ void b_frags_trans(const Rows& op, int l0, int dp, uint32_t (&b)[4]) {
  const int lane = threadIdx.x & 31;
  if constexpr (kG) {
    const int l = l0 + (lane & 3) * 2, d = dp * 16 + (lane >> 2);
    b[0] = column_pair(op, l, d);
    b[1] = column_pair(op, l + 8, d);
    b[2] = column_pair(op, l, d + 8);
    b[3] = column_pair(op, l + 8, d + 8);
  } else {
    ldmatrix_x4_trans(b, op.p + tile_offset<D>(l0 + (lane & 7) + ((lane >> 3) & 1) * 8, dp * 2 + (lane >> 4)));
  }
}

// Blocks per SM the rows kernel is compiled for: the resident 208-key tier
// holds 104 fp32 weights a lane and fits three, with a few hundred bytes of
// spills at head_dim 64 (ptxas.txt); the others four.
template <int kSteps, bool kSweep>
__host__ __device__ constexpr int rows_min_blocks() { return kSweep || kSteps <= kSmallSteps ? 4 : 3; }

// RN(e / denom) for denom in [1, L]: see the note above.
__device__ __forceinline__ float weight32(float e, float denom, float y) {
  return mul(e, y) >= 0x1p-99f ? div_by_reciprocal(e, denom, y) : div(e, denom);
}

// dW = g V^T of the n8 tile of keys n0 .. n0 + 7 (the fragment shape of QK^T).
template <int D, bool kG>
__device__ __forceinline__ void ntile_dw(const Rows& v, const uint32_t (&ga)[D / 16][4], int n0, float (&dw)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) dw[r] = 0.f;
#pragma unroll
  for (int half = 0; half < D / 32; ++half) {
    uint32_t b[4];
    b_frags<D, kG>(v, n0, half, b);
    mma_bf16(dw, ga[2 * half], b);
    mma_bf16(dw, ga[2 * half + 1], b + 2);
  }
}

// The exps of one tile (tile_exps) turned into W32 in place; 0 where masked.
template <int kSteps>
__device__ __forceinline__ void tile_w32(float (&s)[2 * kSteps][4], int key0, const int (&lim)[2],
                                         const float (&denom)[2], const float (&y)[2]) {
  const int j0 = key0 + (threadIdx.x & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < 2 * kSteps; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      s[nt][r] = j0 + nt * 8 + (r & 1) < lim[r >> 1] ? weight32(s[nt][r], denom[r >> 1], y[r >> 1]) : 0.f;
}

// inner += sum W32 dW over one tile (lane-partial: the caller sums the quad).
template <int D, int kSteps, bool kG>
__device__ __forceinline__ void tile_inner(const Rows& v, const uint32_t (&ga)[D / 16][4],
                                           const float (&w)[2 * kSteps][4], int key0, int used, float (&inner)[2]) {
#pragma unroll
  for (int nt = 0; nt < 2 * kSteps; ++nt) {
    if (key0 + nt * 8 >= used) continue;
    float dw[4];
    ntile_dw<D, kG>(v, ga, key0 + nt * 8, dw);
#pragma unroll
    for (int r = 0; r < 4; ++r) inner[r >> 1] = fmaf(w[nt][r], dw[r], inner[r >> 1]);
  }
}

// dQ += dL K over one tile: dW recomputed, dL = bf16(W32 (dW - inner)) masked,
// packed into the A fragment of each 16-key step, K as B through ldmatrix.trans.
template <int D, int kSteps, bool kG>
__device__ __forceinline__ void tile_dq(const bf16* ks, const Rows& v, const uint32_t (&ga)[D / 16][4],
                                        const float (&w)[2 * kSteps][4], int key0, int used, const int (&lim)[2],
                                        const float (&inner)[2], float (&dq)[D / 8][4]) {
  const int lane = threadIdx.x & 31;
  const int j0 = key0 + (lane & 3) * 2;
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    if (key0 + st * 16 >= used) continue;
    float dl[2][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int nt = 2 * st + half;
      float dw[4] = {0.f, 0.f, 0.f, 0.f};
      if (key0 + nt * 8 < used) ntile_dw<D, kG>(v, ga, key0 + nt * 8, dw);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        dl[half][r] = j0 + nt * 8 + (r & 1) < lim[r >> 1] ? mul(w[nt][r], sub(dw[r], inner[r >> 1])) : 0.f;
    }
    // pack_bf16 rounds to nearest: dL's cast to q's dtype.
    const uint32_t pa[4] = {pack_bf16(dl[0][0], dl[0][1]), pack_bf16(dl[0][2], dl[0][3]),
                            pack_bf16(dl[1][0], dl[1][1]), pack_bf16(dl[1][2], dl[1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, ks + tile_offset<D>(key0 + st * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                               dp * 2 + (lane >> 4)));
      mma_bf16(dq[2 * dp], pa, b);
      mma_bf16(dq[2 * dp + 1], pa, b + 2);
    }
  }
}

// stats: (3, B, H, L) fp32 -- peak, denominator, inner -- planes `plane` apart.
// kG: V read from device memory (K alone in shared memory).
template <int D, int kSteps, bool kSweep, bool kG>
__global__ void __launch_bounds__(kThreads, rows_min_blocks<kSteps, kSweep>())
rows_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ grad, bf16* __restrict__ dqkv,
                float* __restrict__ stats, int seq, int heads, float scale, int causal, size_t plane) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + static_cast<size_t>(round16(seq)) * D;

  const int width = heads * D;
  const int q0 = blockIdx.x * kBlockRows, h = blockIdx.y, b = blockIdx.z;
  const bf16* base = qkv + static_cast<size_t>(b) * seq * 3 * width + h * D;
  const bf16* gbase = grad + static_cast<size_t>(b) * seq * width + h * D;
  auto row = [&](int j) { return base + static_cast<size_t>(j) * 3 * width; };

  // The keys any row of this tile can see.
  const int keys = causal ? min(q0 + kBlockRows, seq) : seq;
  if constexpr (kG) {
    load_tile<D>(ks, keys, [&](int j) { return row(j) + width; });
  } else {
    load_kv<D>(ks, vs, keys, width, row);
  }
  const Rows v{kG ? base + 2 * width : vs, static_cast<size_t>(3) * width, keys};

  const int lane = threadIdx.x & 31, g = lane >> 2;
  const int i0 = q0 + (threadIdx.x >> 5) * 16;
  const int lo = i0 + g, hi = lo + 8;
  uint32_t qa[D / 16][4], ga[D / 16][4];
  const QRows qr{lo < seq ? row(lo) : nullptr, hi < seq ? row(hi) : nullptr, bf16_round(scale)};
  load_q<D>(qr.lo, qr.hi, qr.scale, qa);
  load_q<D>(lo < seq ? gbase + static_cast<size_t>(lo) * width : nullptr,  // g, scale 1
            hi < seq ? gbase + static_cast<size_t>(hi) * width : nullptr, 1.f, ga);
  if constexpr (kG) wait_v();  // one group: K
  else wait_k();

  // A warp past the last row takes no keys: it skips every tile.
  const int nk = i0 < seq ? keys : 0;
  const int lim[2] = {causal ? min(i0 + g + 1, nk) : nk, causal ? min(i0 + g + 9, nk) : nk};
  const int used = causal ? min(i0 + 16, nk) : nk;  // the keys any of the 16 rows sees
  constexpr int kTile = 16 * kSteps;

  float peak[2] = {-INFINITY, -INFINITY}, denom[2] = {0.f, 0.f}, minpos[2] = {INFINITY, INFINITY};
  float s[2 * kSteps][4];
  if constexpr (!kSweep) {
    tile_logits<D, kQkv, kSteps>(ks, qa, qr, 0, used, s);
    tile_max<kSteps>(s, 0, lim, peak);
  } else {
    for (int key0 = 0; key0 < used; key0 += kTile) {
      tile_logits<D, kQkv, kSteps>(ks, qa, qr, key0, used, s);
      tile_max<kSteps>(s, key0, lim, peak);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) peak[r] = quad_max(peak[r]);
  if constexpr (!kSweep) {
    tile_exps<kQkv, kSteps>(s, 0, lim, peak, denom, minpos);
  } else {
    for (int key0 = 0; key0 < used; key0 += kTile) {
      tile_logits<D, kQkv, kSteps>(ks, qa, qr, key0, used, s);
      tile_exps<kQkv, kSteps>(s, key0, lim, peak, denom, minpos);
    }
  }
  float y[2], inner[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    denom[r] = quad_sum(denom[r]);
    y[r] = div(1.f, denom[r]);
  }
  wait_v();  // V lands while the statistics run; every warp reaches this barrier
  // The exps of a tile again (sweep: from recomputed logits), then W32.
  auto weights = [&](int key0) {
    if constexpr (kSweep) {
      float unused[2] = {0.f, 0.f}, unused_min[2] = {0.f, 0.f};
      tile_logits<D, kQkv, kSteps>(ks, qa, qr, key0, used, s);
      tile_exps<kQkv, kSteps>(s, key0, lim, peak, unused, unused_min);
    }
    tile_w32<kSteps>(s, key0, lim, denom, y);
  };
  if constexpr (!kSweep) weights(0);
  for (int key0 = 0; key0 < used; key0 += kTile) {
    if constexpr (kSweep) weights(key0);
    tile_inner<D, kSteps, kG>(v, ga, s, key0, used, inner);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) inner[r] = quad_sum(inner[r]);

  float dq[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) dq[t][r] = 0.f;
  for (int key0 = 0; key0 < used; key0 += kTile) {
    if constexpr (kSweep) weights(key0);
    tile_dq<D, kSteps, kG>(ks, v, ga, s, key0, used, lim, inner, dq);
  }

#pragma unroll
  for (int t = 0; t < D / 8; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) dq[t][r] = mul(dq[t][r], scale);  // dQ's fp32 scale
  const long long q_row = static_cast<long long>(b) * seq * 3 * width + h * D;
  store_rows<D, kQkv>(dqkv, lo < seq ? q_row + static_cast<long long>(lo) * 3 * width : -1,
                      hi < seq ? q_row + static_cast<long long>(hi) * 3 * width : -1, dq, 0.f);
  if ((lane & 3) == 0) {
    float* st = stats + (static_cast<size_t>(b) * heads + h) * seq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r ? hi : lo;
      if (i < seq) {
        st[i] = peak[r];
        st[plane + i] = denom[r];
        st[2 * plane + i] = inner[r];
      }
    }
  }
}

// kG: g read from device memory (q_s alone in shared memory).
template <int D, bool kG>
__global__ void __launch_bounds__(kThreads, 3)
columns_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ grad, bf16* __restrict__ dqkv,
                   const float* __restrict__ stats, int seq, int heads, float scale, int causal, size_t plane) {
  constexpr int kChunks = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int width = heads * D;
  const int k0 = blockIdx.x * kBlockRows, h = blockIdx.y, b = blockIdx.z;
  // The query rows that see any key of this block: r0 .. seq - 1, stored from 0.
  const int r0 = causal ? k0 : 0;
  const int rows = seq - r0, filled = round16(rows);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* gs = qs + static_cast<size_t>(filled) * D;
  float* sp = reinterpret_cast<float*>(qs + static_cast<size_t>(kG ? 1 : 2) * filled * D);  // peak, denom, y, inner

  const bf16* base = qkv + static_cast<size_t>(b) * seq * 3 * width + h * D;
  const bf16* gbase = grad + static_cast<size_t>(b) * seq * width + h * D;
  auto row = [&](int j) { return base + static_cast<size_t>(j) * 3 * width; };
  const Rows q{qs, 0, rows}, gr{kG ? gbase + static_cast<size_t>(r0) * width : gs, static_cast<size_t>(width), rows};

  if constexpr (!kG) load_tile<D>(gs, rows, [&](int j) { return gbase + static_cast<size_t>(r0 + j) * width; });
  const float sc = bf16_round(scale);
  for (int idx = threadIdx.x; idx < filled * kChunks; idx += kThreads) {
    const int j = idx / kChunks, c = idx % kChunks;
    const bf16* q = j < rows ? row(r0 + j) : nullptr;
    const uint4 v = make_uint4(scaled_pair(q, c * 8, sc), scaled_pair(q, c * 8 + 2, sc), scaled_pair(q, c * 8 + 4, sc),
                               scaled_pair(q, c * 8 + 6, sc));
    *reinterpret_cast<uint4*>(qs + tile_offset<D>(j, c)) = v;
  }
  const float* gst = stats + (static_cast<size_t>(b) * heads + h) * seq + r0;
  for (int j = threadIdx.x; j < filled; j += kThreads) {
    const bool valid = j < rows;  // a pad row is masked; its statistics only stay finite
    const float denom = valid ? gst[plane + j] : 1.f;
    sp[j] = valid ? gst[j] : 0.f;
    sp[filled + j] = denom;
    sp[2 * filled + j] = div(1.f, denom);
    sp[3 * filled + j] = valid ? gst[2 * plane + j] : 0.f;
  }

  const int lane = threadIdx.x & 31, g = lane >> 2;
  const int s0 = k0 + (threadIdx.x >> 5) * 16;
  const int klo = s0 + g, khi = klo + 8;
  uint32_t ka[D / 16][4], va[D / 16][4];
  // K and V as A fragments (load_q at scale 1: the bf16 values as they are).
  load_q<D>(klo < seq ? row(klo) + width : nullptr, khi < seq ? row(khi) + width : nullptr, 1.f, ka);
  load_q<D>(klo < seq ? row(klo) + 2 * width : nullptr, khi < seq ? row(khi) + 2 * width : nullptr, 1.f, va);
  cp_async_wait_all();
  __syncthreads();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) dk[t][r] = dv[t][r] = 0.f;
  // Under causal the tiles above the warp's first key are skipped (rows r0 ..
  // s0 - 1 see none of its keys); a warp past the last key takes no tile.
  const int first = causal ? s0 - r0 : 0;
  const int last = s0 < seq ? filled : 0;
  for (int l0 = first; l0 < last; l0 += 16) {
    float st[2][4] = {}, dwt[2][4] = {};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int half = 0; half < D / 32; ++half) {
        uint32_t bq[4], bg[4];
        b_frags<D, false>(q, l0 + nt * 8, half, bq);
        b_frags<D, kG>(gr, l0 + nt * 8, half, bg);
        mma_bf16(st[nt], ka[2 * half], bq);
        mma_bf16(st[nt], ka[2 * half + 1], bq + 2);
        mma_bf16(dwt[nt], va[2 * half], bg);
        mma_bf16(dwt[nt], va[2 * half + 1], bg + 2);
      }
    // Accumulator r of n8 tile nt: key klo (r < 2) or khi, query row
    // l0 + 8 nt + 2 (lane % 4) + (r & 1) of the stored rows.
    float w[2][4], dl[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int l = l0 + nt * 8 + (lane & 3) * 2 + (r & 1);
        const int key = r >> 1 ? khi : klo;
        const bool seen = l < rows && key < seq && (!causal || r0 + l >= key);
        float wt = 0.f, d = 0.f;
        if (seen) {
          wt = weight32(expf(sub(st[nt][r], sp[l])), sp[filled + l], sp[2 * filled + l]);
          d = mul(wt, sub(dwt[nt][r], sp[3 * filled + l]));
        }
        w[nt][r] = wt;
        dl[nt][r] = d;
      }
    // The C fragments of the two n8 tiles are the A fragment of the 16-row step;
    // pack_bf16 rounds W32 to v's dtype and dL to q's.
    const uint32_t pw[4] = {pack_bf16(w[0][0], w[0][1]), pack_bf16(w[0][2], w[0][3]), pack_bf16(w[1][0], w[1][1]),
                            pack_bf16(w[1][2], w[1][3])};
    const uint32_t pl[4] = {pack_bf16(dl[0][0], dl[0][1]), pack_bf16(dl[0][2], dl[0][3]),
                            pack_bf16(dl[1][0], dl[1][1]), pack_bf16(dl[1][2], dl[1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bg[4], bq[4];
      b_frags_trans<D, kG>(gr, l0, dp, bg);
      b_frags_trans<D, false>(q, l0, dp, bq);
      mma_bf16(dv[2 * dp], pw, bg);
      mma_bf16(dv[2 * dp + 1], pw, bg + 2);
      mma_bf16(dk[2 * dp], pl, bq);
      mma_bf16(dk[2 * dp + 1], pl, bq + 2);
    }
  }

  const long long k_row = static_cast<long long>(b) * seq * 3 * width + width + h * D;
  const long long lo = klo < seq ? k_row + static_cast<long long>(klo) * 3 * width : -1;
  const long long hi = khi < seq ? k_row + static_cast<long long>(khi) * 3 * width : -1;
  store_rows<D, kQkv>(dqkv, lo, hi, dk, 0.f);
  store_rows<D, kQkv>(dqkv, lo < 0 ? -1 : lo + width, hi < 0 ? -1 : hi + width, dv, 0.f);
}

}  // namespace bwd
}  // namespace attn
}  // namespace fitclip
