// attention_f32: the register-tiled fp32 attention kernels -- attention.cu's
// fp32 forward (attention_f32_kernel; fit_attention.cu's space_f32_kernel runs
// the same block body, forward_block) and attention_bwd.cu's fp32 backward
// (rows_f32_kernel, columns_f32_kernel) -- and the pieces they share.
//
// fp32 stays on the CUDA cores: the tensor cores would take fp32 operands as
// TF32, which the fp32 contract rules out. So the design is that of a SIMT
// SGEMM. Operands stream through shared memory in tiles of 64 rows of D fp32
// ([row][d], pitch D + 4 floats) by 16-byte cp.async (double-buffered in the
// forward and rows kernels); each thread keeps a micro-tile of the product
// in registers and feeds it with 128-bit shared loads. A block is 8 warps,
// w = 2 wr + wc, lane = 8 ty + tx:
//   abt  C = A B^T over d (logits, dW): the thread's TM x 4 outputs are rows
//        wr * 4TM + ty + 4i of A and rows 32 wc + tx + 8k of B. A step of 4 d
//        loads TM float4 of A (4 rows a warp: each broadcast to the 8 lanes of
//        a quarter-warp) and 4 of B (8 consecutive rows a quarter-warp), then
//        runs 16 TM FFMAs; the pitch D + 4 puts consecutive rows on distinct
//        16-byte bank groups, so no load conflicts.
//   pb   C += P B over j (P.V, dQ, dK, dV): the thread's TM x D/16 outputs are
//        the same rows and columns (D/2) wc + (D/16) tx .. of B; a step of 4 j
//        loads TM float4 of the row buffer P and 4 rows of B.
// What bounds them on the H100 is shared memory, not the FFMA pipe: an SM
// delivers 128 bytes of shared loads to its registers a clock whether or not
// the lanes broadcast, and a thread of a TM x 4 tile loads 16 (TM + 4) bytes
// for 4 TM FMAs a step of d, so at TM = 4 the loads take twice the FFMA
// time (three times at TM = 2). Only larger register tiles (8 x 8) would
// balance them, and those need more shared memory and registers a block than
// the exact softmax's row buffers leave.
// Every sum runs in one fmaf chain in ascending order (d for abt, j for pb),
// so a logit or a dW is the same bits in every kernel that forms it.
// Row buffers (logits, weights, dW, dL) have a pitch of round4(cols) rounded up
// to 8 mod 32 floats: the stores of abt's tile (4 rows x 8 columns a warp)
// hit 32 distinct banks and pb's float4 loads of 4 rows distinct bank groups.
#pragma once

#include "attention_mma.cuh"

namespace fitclip {
namespace f32attn {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;   // keys (or query rows) per streamed tile
constexpr int kGroup = 4;   // rows a warp takes at once in a row pass

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// The pitch (floats) of a row buffer over `cols` columns.
__host__ __device__ constexpr int buffer_pitch(int cols) { return ((round4(cols) + 23) & ~31) + 8; }

// The pitch of an operand tile of head_dim D.
__host__ __device__ constexpr int tile_pitch(int d) { return d + 4; }

// Rows of A (query rows or keys) a block covers at TM rows a thread.
__host__ __device__ constexpr int block_rows(int tm) { return 2 * tm * kWarps; }

// A 4-byte global -> shared copy; valid = false zero-fills the destination.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr), "l"(src), "r"(bytes));
}

// Rows 0 .. kRows - 1 of an operand tile, row r at row(r) (a pointer to its
// first float); rows at and past `valid` are zero-filled (a NaN read from past
// the end would survive a weight of 0). Left in flight, uncommitted.
template <int D, int kRows, typename RowFn>
__device__ __forceinline__ void load_rows(float* tile, RowFn row, int valid) {
  constexpr int kChunks = D / 4;
  for (int idx = threadIdx.x; idx < kRows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const bool ok = r < valid;
    cp_async16(tile + r * tile_pitch(D) + 4 * c, row(ok ? r : 0) + 4 * c, ok);
  }
}

// load_rows of rows src + r * stride floats.
template <int D, int kRows>
__device__ __forceinline__ void load_tile(float* tile, const float* src, size_t stride, int valid) {
  load_rows<D, kRows>(tile, [=](int r) { return src + r * stride; }, valid);
}

// Scale the chunks of a tile that this thread copied with load_tile (after
// cp.async.wait_group: a thread sees its own copies), q_s = q * scale in fp32.
template <int D, int kRows>
__device__ __forceinline__ void scale_tile(float* tile, int valid, float scale) {
  constexpr int kChunks = D / 4;
  for (int idx = threadIdx.x; idx < valid * kChunks && idx < kRows * kChunks; idx += kThreads) {
    float4* p = reinterpret_cast<float4*>(tile + (idx / kChunks) * tile_pitch(D) + 4 * (idx % kChunks));
    const float4 v = *p;
    *p = make_float4(mul(v.x, scale), mul(v.y, scale), mul(v.z, scale), mul(v.w, scale));
  }
}

// The thread's place in the micro-tile layout.
struct Lane {
  int warp, lane, wr, wc, ty, tx;
  __device__ __forceinline__ Lane()
      : warp(threadIdx.x >> 5), lane(threadIdx.x & 31), wr(warp >> 1), wc(warp & 1), ty(lane >> 3),
        tx(lane & 7) {}
  // First A row of the warp and of the thread (then + 4 i), first B row of
  // the warp and of the thread (then + 8 k), first output column of pb.
  template <int TM> __device__ __forceinline__ int warp_row() const { return wr * 4 * TM; }
  template <int TM> __device__ __forceinline__ int row() const { return wr * 4 * TM + ty; }
  __device__ __forceinline__ int warp_col() const { return 32 * wc; }
  __device__ __forceinline__ int col() const { return 32 * wc + tx; }
  template <int D> __device__ __forceinline__ int out_col() const { return (D / 2) * wc + (D / 16) * tx; }
};

// acc[i][k] = sum over d ascending of A[row + 4i][d] * B[col + 8k][d], one
// fmaf chain from 0 (A and B tiles of pitch D + 4).
template <int D, int TM>
__device__ __forceinline__ void abt(const float* __restrict__ a, const float* __restrict__ b, const Lane& t,
                                    float (&acc)[TM][4]) {
  constexpr int P = tile_pitch(D);
  const float* ar = a + t.row<TM>() * P;
  const float* br = b + t.col() * P;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float4 x[TM], y[4];
#pragma unroll
    for (int i = 0; i < TM; ++i) x[i] = *reinterpret_cast<const float4*>(ar + 4 * i * P + d);
#pragma unroll
    for (int k = 0; k < 4; ++k) y[k] = *reinterpret_cast<const float4*>(br + 8 * k * P + d);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float s = acc[i][k];
        s = fmaf(x[i].x, y[k].x, s);
        s = fmaf(x[i].y, y[k].y, s);
        s = fmaf(x[i].z, y[k].z, s);
        acc[i][k] = fmaf(x[i].w, y[k].w, s);
      }
  }
}

// Store abt's tile at columns col0 + (col + 8k) of a row buffer (pitch
// `pitch`), the columns below `limit` only.
template <int TM>
__device__ __forceinline__ void store_tile(float* buf, int pitch, int col0, int limit, const Lane& t,
                                           const float (&acc)[TM][4]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = col0 + t.col() + 8 * k;
      if (j < limit) buf[(t.row<TM>() + 4 * i) * pitch + j] = acc[i][k];
    }
}

// acc[i][c] += sum over j in [j0, j1) ascending of P[row + 4i][j] *
// B[j][out_col + c], j0 and j1 multiples of 4 (P: a row buffer of pitch
// `pitch`, offset by the caller so that its column j pairs with B's row j).
template <int D, int TM>
__device__ __forceinline__ void pb(const float* __restrict__ p, int pitch, const float* __restrict__ b, int j0,
                                   int j1, const Lane& t, float (&acc)[TM][D / 16]) {
  constexpr int P = tile_pitch(D), CN = D / 16;
  const float* pr = p + t.row<TM>() * pitch;
  const float* bc = b + t.out_col<D>();
#pragma unroll 2
  for (int j = j0; j < j1; j += 4) {
    float4 x[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) x[i] = *reinterpret_cast<const float4*>(pr + 4 * i * pitch + j);
    float y[4][CN];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      if constexpr (CN == 4) {
        const float4 v = *reinterpret_cast<const float4*>(bc + (j + jj) * P);
        y[jj][0] = v.x, y[jj][1] = v.y, y[jj][2] = v.z, y[jj][3] = v.w;
      } else {
        const float2 v = *reinterpret_cast<const float2*>(bc + (j + jj) * P);
        y[jj][0] = v.x, y[jj][1] = v.y;
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        float s = acc[i][c];
        s = fmaf(x[i].x, y[0][c], s);
        s = fmaf(x[i].y, y[1][c], s);
        s = fmaf(x[i].z, y[2][c], s);
        acc[i][c] = fmaf(x[i].w, y[3][c], s);
      }
  }
}

// --- the forward (attention.cu, fit_attention.cu's fp32 space kernel) -------------

// Shared memory: the scaled Q tile (R rows), the K/V ring (two 64-key tiles)
// and the logits/weights row buffer (R x buffer_pitch(keys)).
inline size_t forward_smem_bytes(int keys, int head_dim, int rows) {
  const int pitch = tile_pitch(head_dim);
  return sizeof(float) *
         (static_cast<size_t>(rows) * pitch + 2 * kTile * pitch + static_cast<size_t>(rows) * buffer_pitch(keys));
}

constexpr size_t kSmemLimit = 232448;  // shared memory a block can use on an H100

// The forward's tier at `keys` keys: 64 query rows a block while their row
// buffer fits beside the Q tile and the K/V ring, else 32; 0 where neither fits.
inline int forward_rows(int keys, int head_dim) {
  if (forward_smem_bytes(keys, head_dim, 64) <= kSmemLimit) return 64;
  return forward_smem_bytes(keys, head_dim, 32) <= kSmemLimit ? 32 : 0;
}

// Where one block's operands live: query row i at q + i * stride, key j's
// qkv row (its q; K at + width, V at + 2 width) at key(j), output row i at
// out + o_base + i * width (elements of the mode's type). `rows` query rows
// see `keys` keys (under causal, row i sees keys 0..i: keys == rows).
template <typename KeyFn>
struct ForwardRows {
  const float* q;
  KeyFn key;
  size_t stride;
  int width, rows, keys;
  bool causal;
  int seq_valid;
  size_t o_base;
};

// One block: R = 16 TM query rows q0 .. q0 + R - 1 of one (batch row or
// group, head). K tiles stream through the ring for QK^T (the logits of every
// key the block's rows can see go to the row buffer), warps then take whole
// rows for the exact softmax (peak, exps, denominator, weights: the order of
// the CUDA-core body this replaced), and V tiles stream through the same ring
// for P.V, the output accumulating in registers and written once in the
// mode's type.
template <int D, int TM, int kMode, typename KeyFn>
__device__ __forceinline__ void forward_block(const ForwardRows<KeyFn>& a, int q0, float scale, float out_mul,
                                              void* __restrict__ out) {
  using namespace attn;
  constexpr int R = block_rows(TM), P = tile_pitch(D), CN = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ring = qs + R * P;
  float* sbuf = ring + 2 * kTile * P;
  const int lp = buffer_pitch(a.keys);

  const int q1 = min(q0 + R, a.rows);
  // The keys any row of this block can see, and the columns P.V reads.
  const int keys = min(a.causal ? q1 : a.keys, a.seq_valid);
  const int tiles = (keys + kTile - 1) / kTile, kcols = round4(keys);
  const Lane t;
  // The warp's rows, and the keys any of them can see (the tiles and columns
  // past those are skipped: their logits are masked, their weights 0).
  const int wrow = q0 + t.warp_row<TM>();
  const bool live = wrow < a.rows;
  const int wkeys = a.causal ? min(keys, wrow + 4 * TM) : keys, wcols = round4(wkeys);

  // Loads 0 .. tiles - 1 are K tiles, then V tiles; load n goes to ring slot n & 1.
  auto fetch = [&](int n) {
    if (n < 2 * tiles) {
      const int j0 = kTile * (n % tiles), off = n < tiles ? a.width : 2 * a.width;
      load_rows<D, kTile>(ring + (n & 1) * kTile * P, [&](int r) { return a.key(j0 + r) + off; }, keys - j0);
    }
    cp_async_commit();
  };
  load_tile<D, R>(qs, a.q + q0 * a.stride, a.stride, q1 - q0);
  fetch(0);

  float o[TM][CN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < CN; ++c) o[i][c] = 0.f;
  for (int n = 0; n < 2 * tiles; ++n) {
    fetch(n + 1);
    cp_async_wait_one();
    if (n == 0) scale_tile<D, R>(qs, q1 - q0, scale);
    __syncthreads();
    const float* tile = ring + (n & 1) * kTile * P;
    if (n < tiles) {
      const int j0 = kTile * n;
      if (live && j0 + t.warp_col() < wkeys) {
        float acc[TM][4];
        abt<D, TM>(qs, tile, t, acc);
        store_tile<TM>(sbuf, lp, j0, kcols, t, acc);
      }
      if (n == tiles - 1) {
        __syncthreads();
        // The exact softmax, a warp per row: the peak over the whole row, then
        // exps and their sum (lane-strided partial sums, then the warp's
        // butterfly), then the weights; 0 from the row's last key to kcols.
        // A warp takes kGroup of its rows at once, so that their loads,
        // exps and shuffle chains overlap.
        for (int r0 = t.warp; r0 < R; r0 += kGroup * kWarps) {
          float* p[kGroup];
          int nk[kGroup], most = 0;
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            const int r = r0 + g * kWarps, i = q0 + r;
            p[g] = sbuf + min(r, R - 1) * lp;
            nk[g] = r < R && i < a.rows ? min(a.causal ? i + 1 : a.keys, a.seq_valid) : 0;
            most = max(most, nk[g]);
          }
          float peak[kGroup], denom[kGroup];
#pragma unroll
          for (int g = 0; g < kGroup; ++g) peak[g] = -INFINITY, denom[g] = 0.f;
          for (int j = t.lane; j < most; j += 32)
#pragma unroll
            for (int g = 0; g < kGroup; ++g)
              if (j < nk[g]) peak[g] = fmaxf(peak[g], p[g][j]);
#pragma unroll
          for (int g = 0; g < kGroup; ++g) peak[g] = warp_max(peak[g]);
          for (int j = t.lane; j < most; j += 32)
#pragma unroll
            for (int g = 0; g < kGroup; ++g)
              if (j < nk[g]) {
                const float e = softmax_exp<kMode>(p[g][j], peak[g]);
                p[g][j] = e;
                denom[g] += e;
              }
          float norm[kGroup];
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            denom[g] = warp_sum(denom[g]);
            norm[g] = softmax_norm<kMode>(denom[g], out_mul);
          }
          for (int j = t.lane; j < kcols; j += 32)
#pragma unroll
            for (int g = 0; g < kGroup; ++g)
              if (nk[g] > 0) p[g][j] = j < nk[g] ? softmax_weight<kMode>(p[g][j], denom[g], norm[g]) : 0.f;
        }
      }
    } else {
      const int j0 = kTile * (n - tiles);
      if (live && j0 < wcols) pb<D, TM>(sbuf + j0, lp, tile, 0, min(kTile, wcols - j0), t, o);
    }
    __syncthreads();  // the next load overwrites this ring slot
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + t.row<TM>() + 4 * i;
    if (row >= a.rows) continue;
    const size_t o_row = a.o_base + static_cast<size_t>(row) * a.width + t.out_col<D>();
#pragma unroll
    for (int c = 0; c < CN; ++c) {
      if constexpr (int8_out<kMode>()) {
        static_cast<int8_t*>(out)[o_row + c] = requant<kMode>(o[i][c], out_mul);
      } else {
        static_cast<float*>(out)[o_row + c] = o[i][c];
      }
    }
  }
}

// attention.cu's fp32 forward: a block of R query rows of one (batch row,
// head) of the (B, L, 3W) qkv, every key of its own batch row.
template <int D, int TM, int kMode>
__global__ void __launch_bounds__(kThreads, 2)
attention_f32_kernel(const float* __restrict__ qkv, void* __restrict__ out, int seq, int heads, float scale,
                     int causal, int seq_valid, float out_mul) {
  const int width = heads * D;
  const size_t stride = 3 * static_cast<size_t>(width);
  const int h = blockIdx.y, b = blockIdx.z;
  const float* base = qkv + static_cast<size_t>(b) * seq * stride + h * D;
  auto key = [=](int j) { return base + j * stride; };
  const ForwardRows<decltype(key)> rows{base, key, stride, width, seq, seq, causal != 0, seq_valid,
                                        static_cast<size_t>(b) * seq * width + h * D};
  forward_block<D, TM, kMode>(rows, blockIdx.x * block_rows(TM), scale, out_mul, out);
}

// --- the backward (attention_bwd.cu) ---------------------------------------------

// The rows kernel's shared memory: q_s and g tiles (R rows), the K/V ring, and
// two row buffers (exps then W32; dW then dL) of R x buffer_pitch(L).
inline size_t rows_smem_bytes(int seq, int head_dim, int rows) {
  const size_t pitch = tile_pitch(head_dim);
  return sizeof(float) *
         (2 * rows * pitch + 2 * kTile * pitch + 2 * static_cast<size_t>(rows) * buffer_pitch(seq));
}

// The columns kernel's (no L in it): the block's K and V tiles, one stage of
// q_s, g and three statistics of 64 rows, the staged W and dL (64 x 64).
inline size_t columns_smem_bytes(int head_dim) {
  const size_t tile = kTile * tile_pitch(head_dim);
  return sizeof(float) * (4 * tile + 3 * kTile + 2 * kTile * buffer_pitch(kTile));
}

// dQ and the row statistics of R = 16 TM query rows of one (batch row, head).
// K tiles stream through the ring for the logits (row buffer e), warps take
// whole rows for the peak, exps and denominator; V tiles stream for dW = g V^T
// (row buffer w), warps take whole rows for W32 = exps / denom, inner =
// rowsum(dW W32) and dL = W32 (dW - inner) in place; K tiles stream again for
// dQ = dL K (registers), scaled once at the end. The sums over keys run as in
// the CUDA-core kernel this replaced (lane-strided, then the warp's butterfly).
// stats: (3, B, H, L) fp32 -- peak, denominator, inner.
template <int D, int TM>
__global__ void __launch_bounds__(kThreads)
rows_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ grad, float* __restrict__ dqkv,
                float* __restrict__ stats, int seq, int heads, float scale, int causal, size_t stat_plane) {
  constexpr int R = block_rows(TM), P = tile_pitch(D), CN = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* gs = qs + R * P;
  float* ring = gs + R * P;
  const int lp = buffer_pitch(seq);
  float* ebuf = ring + 2 * kTile * P;  // exps, then W32
  float* wbuf = ebuf + R * lp;         // dW, then dL

  const int width = heads * D;
  const size_t stride = 3 * static_cast<size_t>(width);
  const int q0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int q1 = min(q0 + R, seq);
  const float* base = qkv + static_cast<size_t>(b) * seq * stride + h * D;
  const float* gbase = grad + static_cast<size_t>(b) * seq * width + h * D;
  float* st = stats + (static_cast<size_t>(b) * heads + h) * seq;
  const int keys = causal ? q1 : seq;
  const int tiles = (keys + kTile - 1) / kTile, kcols = round4(keys);
  const Lane t;
  const int wrow = q0 + t.warp_row<TM>();
  const bool live = wrow < seq;
  const int wkeys = causal ? min(keys, wrow + 4 * TM) : keys, wcols = round4(wkeys);

  // Loads: K tiles, V tiles, K tiles again; load n goes to ring slot n & 1.
  auto fetch = [&](int n) {
    if (n < 3 * tiles) {
      const int j0 = kTile * (n % tiles);
      load_tile<D, kTile>(ring + (n & 1) * kTile * P, base + (n / tiles == 1 ? 2 : 1) * width + j0 * stride,
                          stride, keys - j0);
    }
    cp_async_commit();
  };
  load_tile<D, R>(qs, base + q0 * stride, stride, q1 - q0);
  load_tile<D, R>(gs, gbase + static_cast<size_t>(q0) * width, width, q1 - q0);
  fetch(0);

  float a[TM][CN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < CN; ++c) a[i][c] = 0.f;
  for (int n = 0; n < 3 * tiles; ++n) {
    fetch(n + 1);
    cp_async_wait_one();
    if (n == 0) scale_tile<D, R>(qs, q1 - q0, scale);
    __syncthreads();
    const float* tile = ring + (n & 1) * kTile * P;
    const int pass = n / tiles, j0 = kTile * (n % tiles);
    if (pass < 2) {
      if (live && j0 + t.warp_col() < wkeys) {
        float acc[TM][4];
        abt<D, TM>(pass == 0 ? qs : gs, tile, t, acc);
        store_tile<TM>(pass == 0 ? ebuf : wbuf, lp, j0, kcols, t, acc);
      }
      if (n % tiles == tiles - 1) {
        __syncthreads();
        // A warp per row, kGroup of its rows at once (as the forward's softmax).
        for (int r0 = t.warp; r0 < R; r0 += kGroup * kWarps) {
          float *e[kGroup], *w[kGroup];
          int nk[kGroup], most = 0;
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            const int r = min(r0 + g * kWarps, R - 1), i = q0 + r0 + g * kWarps;
            e[g] = ebuf + r * lp;
            w[g] = wbuf + r * lp;
            nk[g] = r0 + g * kWarps < R && i < seq ? (causal ? i + 1 : seq) : 0;
            most = max(most, nk[g]);
          }
          if (pass == 0) {
            // The peak, the exps and their sum; both kept in the statistics.
            float peak[kGroup], denom[kGroup];
#pragma unroll
            for (int g = 0; g < kGroup; ++g) peak[g] = -INFINITY, denom[g] = 0.f;
            for (int j = t.lane; j < most; j += 32)
#pragma unroll
              for (int g = 0; g < kGroup; ++g)
                if (j < nk[g]) peak[g] = fmaxf(peak[g], e[g][j]);
#pragma unroll
            for (int g = 0; g < kGroup; ++g) peak[g] = warp_max(peak[g]);
            for (int j = t.lane; j < most; j += 32)
#pragma unroll
              for (int g = 0; g < kGroup; ++g)
                if (j < nk[g]) {
                  const float ex = expf(sub(e[g][j], peak[g]));
                  e[g][j] = ex;
                  denom[g] += ex;
                }
#pragma unroll
            for (int g = 0; g < kGroup; ++g) {
              denom[g] = warp_sum(denom[g]);
              const int i = q0 + r0 + g * kWarps;
              if (t.lane == 0 && nk[g] > 0) st[i] = peak[g], st[stat_plane + i] = denom[g];
            }
          } else {
            // W32, inner and dL; 0 from the row's last key to kcols.
            float denom[kGroup], inner[kGroup];
#pragma unroll
            for (int g = 0; g < kGroup; ++g) {
              denom[g] = nk[g] > 0 ? st[stat_plane + q0 + r0 + g * kWarps] : 1.f;
              inner[g] = 0.f;
            }
            for (int j = t.lane; j < most; j += 32)
#pragma unroll
              for (int g = 0; g < kGroup; ++g)
                if (j < nk[g]) {
                  const float wt = div(e[g][j], denom[g]);
                  e[g][j] = wt;
                  inner[g] = fmaf(wt, w[g][j], inner[g]);
                }
#pragma unroll
            for (int g = 0; g < kGroup; ++g) inner[g] = warp_sum(inner[g]);
            for (int j = t.lane; j < kcols; j += 32)
#pragma unroll
              for (int g = 0; g < kGroup; ++g)
                if (nk[g] > 0) w[g][j] = j < nk[g] ? mul(e[g][j], sub(w[g][j], inner[g])) : 0.f;
#pragma unroll
            for (int g = 0; g < kGroup; ++g)
              if (t.lane == 0 && nk[g] > 0) st[2 * stat_plane + q0 + r0 + g * kWarps] = inner[g];
          }
        }
      }
    } else if (live && j0 < wcols) {
      pb<D, TM>(wbuf + j0, lp, tile, 0, min(kTile, wcols - j0), t, a);
    }
    __syncthreads();  // the next load overwrites this ring slot
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + t.row<TM>() + 4 * i;
    if (row >= seq) continue;
    float* drow = dqkv + (static_cast<size_t>(b) * seq + row) * stride + h * D + t.out_col<D>();
#pragma unroll
    for (int c = 0; c < CN; ++c) drow[c] = mul(a[i][c], scale);
  }
}

// dK and dV of 64 keys of one (batch row, head), flash-style: the keys' K and
// V tiles stay in shared memory while the q_s, g and statistics tiles of the
// query rows that see them (from the block's own diagonal under causal)
// stream past, one tile at a time (two blocks share an SM, so one's copies
// overlap the other's products). Per row tile: S^T = K q_s^T and dW^T = V g^T
// in registers (each logit and dW the rows kernel's bits: the same fmaf
// chains), W32 = exp(S - peak) / denom and dL = W32 (dW - inner) from the
// stored statistics (0 past the end and above the diagonal), staged in shared
// memory; then dV += W^T g and dK += dL^T q_s in registers, over rows in
// ascending order.
template <int D>
__global__ void __launch_bounds__(kThreads)
columns_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ grad, float* __restrict__ dqkv,
                   const float* __restrict__ stats, int seq, int heads, float scale, int causal,
                   size_t stat_plane) {
  constexpr int T = kTile, TM = T / 16, P = tile_pitch(D), CN = D / 16, WP = buffer_pitch(T);
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + T * P;
  float* qt = vs + T * P;
  float* gt = qt + T * P;
  float* stt = gt + T * P;  // peak, denominator, inner of the tile's rows
  float* wt = stt + 3 * T;  // W32, keys x rows
  float* et = wt + T * WP;  // dL

  const int width = heads * D;
  const size_t stride = 3 * static_cast<size_t>(width);
  const int k0 = blockIdx.x * T, h = blockIdx.y, b = blockIdx.z;
  const float* base = qkv + static_cast<size_t>(b) * seq * stride + h * D;
  const float* gbase = grad + static_cast<size_t>(b) * seq * width + h * D;
  const float* gst = stats + (static_cast<size_t>(b) * heads + h) * seq;
  const int r0 = causal ? k0 : 0;  // the first query row that sees a key of this block
  const Lane t;
  const int wkey = k0 + t.warp_row<TM>();  // the warp's first key
  const bool live = wkey < seq;

  load_tile<D, T>(ks, base + width + k0 * stride, stride, seq - k0);
  load_tile<D, T>(vs, base + 2 * width + k0 * stride, stride, seq - k0);
  float dk[TM][CN], dv[TM][CN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < CN; ++c) dk[i][c] = dv[i][c] = 0.f;
  for (int l0 = r0; l0 < seq; l0 += T) {
    const int rows = min(T, seq - l0);
    load_tile<D, T>(qt, base + l0 * stride, stride, rows);
    load_tile<D, T>(gt, gbase + static_cast<size_t>(l0) * width, width, rows);
    for (int idx = threadIdx.x; idx < 3 * T; idx += kThreads) {
      const int k = idx / T, l = l0 + idx % T;
      cp_async4(stt + idx, gst + k * stat_plane + (l < seq ? l : 0), l < seq);
    }
    cp_async_commit();
    cp_async_wait_all();
    scale_tile<D, T>(qt, rows, scale);
    __syncthreads();
    // The rows of this tile the warp's keys see: from its first key under
    // causal (earlier rows have W = dL = 0 for all of them), to the end.
    const int lstart = causal ? max(0, wkey - l0) : 0;
    const int lend = round4(rows);
    if (live && t.warp_col() < rows && t.warp_col() + 32 > lstart) {
      float x[TM][4], y[TM][4];
      abt<D, TM>(ks, qt, t, x);
      abt<D, TM>(vs, gt, t, y);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = t.col() + 8 * k, l = l0 + c;
        const float peak = stt[c], denom = stt[T + c], inner = stt[2 * T + c];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int s = k0 + t.row<TM>() + 4 * i;
          float wv = 0.f, dl = 0.f;
          if (l < seq && (!causal || l >= s)) {
            wv = div(expf(sub(x[i][k], peak)), denom);
            dl = mul(wv, sub(y[i][k], inner));
          }
          wt[(t.row<TM>() + 4 * i) * WP + c] = wv;
          et[(t.row<TM>() + 4 * i) * WP + c] = dl;
        }
      }
    }
    __syncthreads();
    if (live && lstart < lend) {
      pb<D, TM>(wt, WP, gt, lstart, lend, t, dv);
      pb<D, TM>(et, WP, qt, lstart, lend, t, dk);
    }
    __syncthreads();  // the next tile overwrites q_s, g, the statistics, W and dL
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int s = k0 + t.row<TM>() + 4 * i;
    if (s >= seq) continue;
    float* drow = dqkv + (static_cast<size_t>(b) * seq + s) * stride + h * D + t.out_col<D>();
#pragma unroll
    for (int c = 0; c < CN; ++c) {
      drow[width + c] = dk[i][c];
      drow[2 * width + c] = dv[i][c];
    }
  }
}

}  // namespace f32attn
}  // namespace fitclip
