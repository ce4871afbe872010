// s3dg_stem: the S3D-G space-to-depth stem of the fast eval forward, in one kernel.
//
// Replaces fitclip_tpu/ops/s3dg_stem.py:_stem_kernel_v3 (K7, via s3dg_stem_conv_v3 and the
// s2d_transpose producer). For bf16 video x (B, T, H, W, 3), T even and H, W multiples of 4:
//   s = space_to_depth(x)                       (B, T/2, H/2, W/2, 24), channels (t2, h2, w2, c)
//   y = ReLU(Conv3D(s, K) + bias)               K (2, 4, 4, 24, 64) with BN folded; taps t, t+1
//                                               and h-1..h+2, w-1..w+2, zero outside; fp32 sums
//   out = MaxPool 3x3 / 2 in (H, W), TF-'SAME'  pad (0, 1) with 0, exact after the ReLU
// -> (B, T/2, H/4, W/4, 64) bf16, NDHWC, rounded once (max commutes with the monotone
// rounding to bf16, so pooling the rounded conv outputs gives the same bits).
//
// Space-to-depth folds into the loads: conv position (t, h, w) reads raw frames 2t..2t+3,
// raw rows 2h-2..2h+5 and raw columns 2w-2..2w+5, so the product is an implicit GEMM of
// M = B * T/2 * H/2 * W/2 positions by K = 4 * 8 * 8 * 3 = 768 by N = 64, with k ordered
// (frame, row, column, channel): a k-run of 24 is one raw row's 8 pixels, contiguous in
// NDHWC memory. The weights come packed in that order (ops/s3dg_stem.py:pack_stem_weights).
//
// Bound on the H100: at the MIL-NCE shape (32 clips x 16 frames x 224^2) the product is
// 315.7 GFLOP, 0.319 ms at the bf16 tensor peak, against 0.077 ms for its 257 MB of
// input and output: bound by operations. The design, simple first:
// - one persistent CTA per SM (256 threads, ~215 KB of shared memory) walks over
//   (clip, output time, band of two pooled rows); the 64 x 768 folded weights (96 KB)
//   stay in shared memory for the CTA's whole life;
// - a band needs five conv rows (one halo row recomputed by the next band); their raw
//   input, 4 frames x 16 rows x the padded width, is copied to shared memory with
//   cp.async (rows outside the clip zero-filled, the pad columns zeroed once);
// - mma.sync m16n8k16 bf16 -> fp32, the A fragments read as 32-bit pairs straight from
//   the raw rows (a k-pair never straddles a 24-run), B from the weights;
// - two conv rows at a time go through bias + ReLU into a bf16 staging tile, and each
//   thread keeps a running 3x3 max of its pooled outputs in registers;
// - the pooled band is written NDHWC, 128 contiguous bytes per (row, column).
// The TPU kernel's lane rotates, selection matmuls and 126-lane limit are TPU layout and
// have no counterpart here. Not yet done: wgmma/TMA, and overlapping a band's input
// copy with the previous band's products.
#include "common.cuh"

using namespace fitclip;

namespace {

constexpr int kCout = 64;
constexpr int kK = 768;                    // 4 frames x 8 rows x 8 columns x 3 channels
constexpr int kWStride = kK + 8;           // bf16 per weight row in shared memory (388 words)
constexpr int kWWords = kWStride / 2;
constexpr int kThreads = 256;
constexpr int kPoolRows = 2;               // pooled rows per band
constexpr int kConvRows = 2 * kPoolRows + 1;
constexpr int kInRows = 2 * kConvRows + 6; // raw rows per frame: 2h-2 .. 2h+5 over the band
constexpr int kFrames = 4;
constexpr int kGroupRows = 2;              // conv rows per pass of the products
constexpr int kStageStride = 72;           // bf16 per staged position (36 words)
constexpr int kStageWords = kStageStride / 2;
constexpr int kMaxWidth = 240;             // bounded by the shared memory of one block
constexpr int kPoolRegs = 16;              // ceil(kPoolRows * (W/4) * 32 / kThreads) at W <= 240
constexpr int kSmemLimit = 232448;

// Raw row stride in shared memory, in bf16: raw column c sits at 8 + 3c, so the data starts
// 16-byte aligned, and columns -2, -1 and W .. W+3 are zero padding.
__host__ __device__ inline int in_row_stride(int width) { return ((8 + 3 * (width + 4)) + 7) / 8 * 8; }

inline size_t smem_bytes(int width) {
  const size_t weights = static_cast<size_t>(kCout) * kWStride * 2;
  const size_t bias = kCout * 4;
  const size_t input = static_cast<size_t>(kFrames) * kInRows * in_row_stride(width) * 2;
  const size_t stage = static_cast<size_t>(kGroupRows) * (width / 2) * kStageStride * 2;
  return weights + bias + input + stage;
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? kBytes : 0;  // 0 source bytes: the destination is zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(addr), "l"(src),
               "n"(kBytes), "r"(bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t bf16x2_max(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hmax2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t relu_bf16x2(float lo, float hi) {
  __nv_bfloat162 r = __floats2bfloat162_rn(fmaxf(lo, 0.f), fmaxf(hi, 0.f));
  return *reinterpret_cast<uint32_t*>(&r);
}

template <int kCopyBytes>
__global__ void __launch_bounds__(kThreads, 1)
s3dg_stem_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int batch,
                 int frames, int height, int width) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);
  float* bias_s = reinterpret_cast<float*>(smem + kCout * kWStride * 2);
  __nv_bfloat16* in_s = reinterpret_cast<__nv_bfloat16*>(smem + kCout * kWStride * 2 + kCout * 4);
  const int rs = in_row_stride(width);
  uint32_t* stage_w = reinterpret_cast<uint32_t*>(in_s + kFrames * kInRows * rs);
  const uint32_t* w_w = reinterpret_cast<const uint32_t*>(w_s);
  const uint32_t* in_w = reinterpret_cast<const uint32_t*>(in_s);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int ts = frames / 2, hs = height / 2, ws = width / 2, hp = height / 4, wp = width / 4;
  const int bands = (hp + kPoolRows - 1) / kPoolRows;
  const int units = batch * ts * bands;
  const int rs2 = rs / 2;

  // The weights (64 rows of 768, 96 chunks of 16 bytes each) and the bias, once.
  for (int c = tid; c < kCout * (kK / 8); c += kThreads) {
    const int n = c / (kK / 8), k = (c % (kK / 8)) * 8;
    cp_async<16>(w_s + n * kWStride + k, w + n * kK + k, true);
  }
  if (tid < kCout) bias_s[tid] = bias[tid];
  // Zero the pad columns of every raw row; the copies below never touch them.
  const int pad_hi = 8 + 3 * width;
  for (int i = tid; i < kFrames * kInRows * (rs - 3 * width); i += kThreads) {
    const int row = i / (rs - 3 * width), col = i % (rs - 3 * width);
    in_s[row * rs + (col < 8 ? col : pad_hi + col - 8)] = __float2bfloat16_rn(0.f);
  }

  const int row_chunks = width * 3 * 2 / kCopyBytes;
  const int pool_items = kPoolRows * wp * 32;  // (pooled row, pooled column, channel pair)

  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int band = unit % bands, bt = unit / bands;
    const int tt = bt % ts, bb = bt / ts;
    const int p0 = band * kPoolRows, h0 = 2 * p0;

    __syncthreads();  // the previous unit is done with in_s and the staging tile
    for (int i = tid; i < kFrames * kInRows * row_chunks; i += kThreads) {
      const int row = i / row_chunks, chunk = i % row_chunks;
      const int a = row / kInRows, rr = row % kInRows;
      const int f = 2 * tt + a, r = 2 * h0 - 2 + rr;
      const bool valid = f < frames && r >= 0 && r < height;
      const __nv_bfloat16* src =
          valid ? x + ((static_cast<size_t>(bb) * frames + f) * height + r) * width * 3 +
                      chunk * (kCopyBytes / 2)
                : x;
      cp_async<kCopyBytes>(in_s + row * rs + 8 + chunk * (kCopyBytes / 2), src, valid);
    }
    cp_async_wait_all();
    __syncthreads();

    uint32_t pooled[kPoolRegs];
#pragma unroll
    for (int s = 0; s < kPoolRegs; ++s) pooled[s] = 0u;  // +0.0 bf16 pairs: the pad value

    for (int j0 = 0; j0 < kConvRows; j0 += kGroupRows) {
      const int rows = min(kGroupRows, min(kConvRows - j0, hs - (h0 + j0)));  // rows >= hs are pad
      if (rows <= 0) break;
      const int m_total = rows * ws;
      const int mtiles = (m_total + 15) / 16;
      const bool active0 = warp < mtiles, active1 = warp + 8 < mtiles;
      if (active0) {
        // Word offset of each fragment row's (j, w) position: element 2j*rs + 6w + 2.
        int abase[2][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            int pos = (warp + 8 * mt) * 16 + g + 8 * h;
            if (pos >= m_total) pos = 0;  // a row past the end: computed, never stored
            const int j = j0 + pos / ws, wc = pos % ws;
            abase[mt][h] = j * rs + 3 * wc + 1;
          }
        float acc[2][8][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

        // K in 16 chunks of 48 = two 24-runs (raw rows r, r+1 of frame a), three k16 steps each.
        for (int c = 0; c < 16; ++c) {
          const uint32_t* ain = in_w + ((c >> 2) * kInRows + 2 * (c & 3)) * rs2;
          const uint32_t* bw = w_w + c * 24;
#pragma unroll
          for (int s = 0; s < 3; ++s) {
            const int lo = s == 0 ? t4 : s == 1 ? t4 + 8 : rs2 + 4 + t4;
            const int hi = s == 0 ? t4 + 4 : s == 1 ? rs2 + t4 : rs2 + 8 + t4;
            uint32_t bf[8][2];
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              const uint32_t* q = bw + (nt * 8 + g) * kWWords + s * 8 + t4;
              bf[nt][0] = q[0];
              bf[nt][1] = q[4];
            }
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              if (mt == 1 && !active1) continue;
              const uint32_t af[4] = {ain[abase[mt][0] + lo], ain[abase[mt][1] + lo],
                                      ain[abase[mt][0] + hi], ain[abase[mt][1] + hi]};
#pragma unroll
              for (int nt = 0; nt < 8; ++nt) mma_bf16(acc[mt][nt], af, bf[nt]);
            }
          }
        }

        // Bias + ReLU -> bf16 into the staging tile: position (j - j0) * ws + w, 36 words each.
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (mt == 1 && !active1) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int pos = (warp + 8 * mt) * 16 + g + 8 * h;
            if (pos >= m_total) continue;
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              const int col = nt * 8 + 2 * t4;
              stage_w[pos * kStageWords + nt * 4 + t4] =
                  relu_bf16x2(add(acc[mt][nt][2 * h], bias_s[col]),
                              add(acc[mt][nt][2 * h + 1], bias_s[col + 1]));
            }
          }
        }
      }
      __syncthreads();

      // Pool: conv row j feeds pooled row i when 2i <= j <= 2i + 2.
      for (int jl = 0; jl < rows; ++jl) {
        const int j = j0 + jl;
#pragma unroll
        for (int s = 0; s < kPoolRegs; ++s) {
          const int e = tid + s * kThreads;
          if (e >= pool_items) break;
          const int i = e / (wp * 32), q = (e / 32) % wp, cp = e % 32;
          if (j < 2 * i || j > 2 * i + 2) continue;
          const uint32_t* row = stage_w + (jl * ws + 2 * q) * kStageWords + cp;
          uint32_t v = bf16x2_max(row[0], row[kStageWords]);
          if (2 * q + 2 < ws) v = bf16x2_max(v, row[2 * kStageWords]);
          pooled[s] = bf16x2_max(pooled[s], v);
        }
      }
      __syncthreads();
    }

    uint32_t* out_w = reinterpret_cast<uint32_t*>(out);
#pragma unroll
    for (int s = 0; s < kPoolRegs; ++s) {
      const int e = tid + s * kThreads;
      if (e >= pool_items) break;
      const int i = e / (wp * 32), q = (e / 32) % wp, cp = e % 32;
      const int p = p0 + i;
      if (p < hp)
        out_w[((static_cast<size_t>(bb * ts + tt) * hp + p) * wp + q) * (kCout / 2) + cp] =
            pooled[s];
    }
  }
}

template <int kCopyBytes>
int launch(const void* x, const void* w, const void* bias, void* out, int batch, int frames,
           int height, int width, cudaStream_t stream) {
  const size_t smem = smem_bytes(width);
  cudaError_t err = cudaFuncSetAttribute(s3dg_stem_kernel<kCopyBytes>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int units = batch * (frames / 2) * ((height / 4 + kPoolRows - 1) / kPoolRows);
  const int grid = units < sms ? units : sms;
  s3dg_stem_kernel<kCopyBytes><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), batch, frames, height,
      width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory the stem kernel needs at a frame width (0 if the width is not taken).
extern "C" size_t fitclip_s3dg_stem_smem_bytes(int width) {
  return width > kMaxWidth || smem_bytes(width) > kSmemLimit ? 0 : smem_bytes(width);
}

// x (B, T, H, W, 3) bf16, w (64, 768) bf16 packed, bias (64,) fp32 -> out (B, T/2, H/4, W/4, 64)
// bf16. T even, H and W multiples of 4, W <= 240.
extern "C" int fitclip_s3dg_stem(const void* x, const void* w, const void* bias, void* out,
                                 int batch, int frames, int height, int width, void* stream) {
  if (batch <= 0 || frames <= 0 || frames % 2 || height <= 0 || height % 4 || width <= 0 ||
      width % 4 || fitclip_s3dg_stem_smem_bytes(width) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width % 8 == 0) return launch<16>(x, w, bias, out, batch, frames, height, width, s);
  return launch<8>(x, w, bias, out, batch, frames, height, width, s);
}
