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
// input and output: bound by operations. The design (s3dg_stem_wgmma_kernel):
// - products on wgmma.mma_async m64n64k16 bf16 -> fp32 with A from registers (the RS
//   form): N = 64 is every output channel, K = 768 is 48 k16 steps. A is the implicit
//   im2col, gathered from the raw rows in shared memory as 32-bit pairs (a k-pair never
//   straddles a 24-run); positions sit 12 bytes apart there, which no shared-memory
//   layout of wgmma takes. Fragment rows g and g + 8 read raw row pairs two rows
//   apart, so each pair's words feed two chunks and are loaded once. B, the 64 x 768 folded weights, is written once per block in
//   the K-major layout with the 128-byte swizzle (12 slices of 64 k) and read through a
//   matrix descriptor;
// - one persistent block per SM (4 warpgroups, 512 threads) takes a contiguous run of
//   pooled rows (the runs of all blocks balanced to a row), of one (clip, time) at a time.
//   A step is one pooled row i: conv rows 2i + 1 and 2i + 2, the 16 rows of a warp's
//   fragment being one conv column p at both conv rows (rows g and g + 8), so that the
//   vertical 3-max over conv rows 2i, 2i + 1, 2i + 2 is taken in registers, conv row
//   2i carried from the step before (the halo row is computed once, plus one prologue
//   step at the start of a run). Warpgroup wg holds conv columns 32 wg .. 32 wg + 31,
//   warp q of it columns 32 wg + 4 g + q: the gather's lanes then hit 32 distinct banks;
// - the raw rows live in a ring of 16 rows per frame: a step reads raw rows 4i .. 4i + 9
//   of the 4 frames, and its cp.async copies of the next step's 4 new rows a frame (rows
//   outside the clip zero-filled, the pad columns zeroed once) run during its products;
// - bias + ReLU in fp32, one rounding to bf16, the vertical max in registers, then the
//   horizontal 3/2 max through a double-buffered staging row (one barrier a step) and
//   the NDHWC store, 128 contiguous bytes per (row, column).
// The TPU kernel's lane rotates, selection matmuls and 126-lane limit are TPU layout and
// have no counterpart here.
#include "gemm_wgmma.cuh"

using namespace fitclip;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kCout = 64;
constexpr int kK = 768;                      // 4 frames x 8 rows x 8 columns x 3 channels
constexpr int kSliceBytes = kCout * 128;     // 64 k of every weight row: 128-byte swizzle rows
constexpr int kWeightBytes = kK / 64 * kSliceBytes;
constexpr int kWarpgroups = 4;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kTileColumns = 32;             // conv columns of a warpgroup: 8 a warp, 4 apart
constexpr int kMaxWidth = 240;               // bounded by the shared memory of one block
constexpr int kFrames = 4;
constexpr int kRing = 16;                    // raw rows a frame: a step reads 10, loads 4 ahead
constexpr int kStageWords = 33;              // bf16 pairs a staged column (32 + 1: no bank conflicts)
constexpr int kSmemLimit = 232448;

// Raw row stride in shared memory, in bf16: raw column c sits at 8 + 3c, so the data starts
// 16-byte aligned, and columns -2, -1 and W .. W+3 are zero padding.
__host__ __device__ inline int in_row_stride(int width) { return ((8 + 3 * (width + 4)) + 7) / 8 * 8; }

// 1 KB to align the weights (the 128-byte swizzle repeats every 1024 bytes), the
// weights, the bias, the ring and two staging rows.
inline size_t smem_bytes(int width) {
  return 1024 + kWeightBytes + kCout * 4 + static_cast<size_t>(kFrames) * kRing * in_row_stride(width) * 2 +
         2 * static_cast<size_t>(width / 2) * kStageWords * 4;
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? kBytes : 0;  // 0 source bytes: the destination is zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(addr), "l"(src), "n"(kBytes),
               "r"(bytes));
}

// d (+)= A B^T for one warpgroup: A 64 x 16 bf16 from registers (a warp's 16 rows in
// mma.sync's m16n8k16 A layout), B 64 x 16 through the descriptor, d 64 x 64 fp32.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Keeps the compiler from moving reads of the accumulators above the wait that completes them.
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t bf16x2_max(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hmax2(*reinterpret_cast<__nv_bfloat162*>(&a), *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t relu_bf16x2(float lo, float hi) {
  __nv_bfloat162 r = __floats2bfloat162_rn(fmaxf(lo, 0.f), fmaxf(hi, 0.f));
  return *reinterpret_cast<uint32_t*>(&r);
}

template <int kCopyBytes>
__global__ void __launch_bounds__(kThreads, 1)
s3dg_stem_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, const float* __restrict__ bias,
                       bf16* __restrict__ out, int batch, int frames, int height, int width) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (gemm::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* w_s = smem;
  float* bias_s = reinterpret_cast<float*>(smem + kWeightBytes);
  bf16* ring = reinterpret_cast<bf16*>(smem + kWeightBytes + kCout * 4);
  const int rs = in_row_stride(width), rs2 = rs / 2;
  uint32_t* stage_w = reinterpret_cast<uint32_t*>(ring + kFrames * kRing * rs);
  const uint32_t* ring_w = reinterpret_cast<const uint32_t*>(ring);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int ts = frames / 2, hs = height / 2, ws = width / 2, hp = height / 4, wp = width / 4;

  // The weights (64 rows of 96 chunks of 16 bytes), slice by slice of 64 k, chunk c of row
  // n at c ^ (n & 7) (the 128-byte swizzle), and the bias, once.
  for (int i = tid; i < kCout * (kK / 8); i += kThreads) {
    const int n = i / (kK / 8), chunk = i % (kK / 8);
    cp_async16(w_s + (chunk >> 3) * kSliceBytes + n * 128 + (((chunk & 7) ^ (n & 7)) << 4), w + n * kK + chunk * 8,
               true);
  }
  cp_async_commit();
  if (tid < kCout) bias_s[tid] = bias[tid];
  // Zero the pad columns of every ring row; the copies below never touch them.
  const int pad_hi = 8 + 3 * width;
  for (int i = tid; i < kFrames * kRing * (rs - 3 * width); i += kThreads) {
    const int row = i / (rs - 3 * width), col = i % (rs - 3 * width);
    ring[row * rs + (col < 8 ? col : pad_hi + col - 8)] = __float2bfloat16_rn(0.f);
  }
  cp_async_wait_all();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // wgmma reads the weights
  __syncthreads();
  const uint64_t desc0 = gemm::smem_desc(gemm::smem_u32(w_s));

  // This lane's conv column (rows g and g + 8 of its warp's 16) and its 24-run's first
  // word in a raw row, plus t; a column past the frame gathers the last one, unstored.
  const int p = wg * kTileColumns + 4 * g + (warp & 3);
  const bool live = p < ws;
  const bool tile_live = wg * kTileColumns < ws;  // uniform over the warpgroup
  const int col_word = 3 * min(p, ws - 1) + 1 + t;
  const int row_chunks = width * 6 / kCopyBytes;

  // Raw rows r0 .. r0 + count - 1 of the 4 frames of (clip bb, time tt) into their ring
  // slots (r mod 16), cp.async, zero outside the clip.
  auto load_rows = [&](int bb, int tt, int r0, int count) {
    for (int i = tid; i < kFrames * count * row_chunks; i += kThreads) {
      const int chunk = i % row_chunks, rr = i / row_chunks;
      const int a = rr / count, r = r0 + rr % count, f = 2 * tt + a;
      const bool valid = f < frames && r >= 0 && r < height;
      const bf16* src = valid ? x + ((static_cast<size_t>(bb) * frames + f) * height + r) * width * 3 +
                                    chunk * (kCopyBytes / 2)
                              : x;
      cp_async<kCopyBytes>(ring + (a * kRing + (r & (kRing - 1))) * rs + 8 + chunk * (kCopyBytes / 2), src, valid);
    }
    cp_async_commit();
  };

  const int units = batch * ts * hp;  // pooled rows
  const int first = static_cast<int>(static_cast<long long>(units) * blockIdx.x / gridDim.x);
  const int last = static_cast<int>(static_cast<long long>(units) * (blockIdx.x + 1) / gridDim.x);
  uint32_t carry[8] = {};  // conv row 2i's outputs at (p, channels 8j + 2t, + 1), bf16 pairs
  int parity = 0;
  for (int u = first; u < last;) {
    const int bt = u / hp, i0 = u % hp, i_end = min(hp, i0 + (last - u));
    const int tt = bt % ts, bb = bt / ts;
    // Prologue: the raw rows of step i0 - 1, whose second conv row (2 i0) is the carry.
    load_rows(bb, tt, 4 * i0 - 4, 10);
    cp_async_wait_all();
    __syncthreads();
    for (int s = i0 - 1; s < i_end; ++s) {
      if (s + 1 < i_end) load_rows(bb, tt, 4 * s + 10, 4);  // the next step's new rows
      float d[32];
      if (tile_live) {
        // Chunk c = 4a + rp: frame a, raw rows 2rp, 2rp + 1 of a conv row's 8 (k 48c ..
        // 48c + 47); conv row 2s + 1 (fragment row g) starts at raw row 4s, 2s + 2 (row
        // g + 8) at 4s + 2. Three k16 steps a chunk: k 0-15 | 16-23 + 24-31 | 32-47, the
        // lane's words of a row pair at {0, 4 | 8, rs2 | rs2 + 4, rs2 + 8}. Row pair r of
        // a frame (raw rows 4s + 2r, + 1) is row g's pair r and row g + 8's pair r - 1,
        // so each is read once: 5 pairs a frame, not 8.
        const int slot0 = (4 * s) & (kRing - 1);
#pragma unroll
        for (int a = 0; a < kFrames; ++a) {
          uint32_t pairs[5][6];
#pragma unroll
          for (int r = 0; r < 5; ++r) {
            // The group in flight completes before the next pair loads: two pairs live at
            // most, so 512 threads fit 128 registers with no spill (the other three
            // warpgroups keep the tensor cores busy meanwhile).
            if (a + r > 0) gemm::wgmma_wait<0>();
            const uint32_t* row = ring_w + (a * kRing + ((slot0 + 2 * r) & (kRing - 1))) * rs2 + col_word;
            pairs[r][0] = row[0], pairs[r][1] = row[4], pairs[r][2] = row[8];
            pairs[r][3] = row[rs2], pairs[r][4] = row[rs2 + 4], pairs[r][5] = row[rs2 + 8];
            if (r == 0) continue;
            const uint32_t(&lo)[6] = pairs[r - 1];
            const uint32_t(&hi)[6] = pairs[r];
            gemm::wgmma_fence();
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              const int kk = 3 * (4 * a + r - 1) + k;  // k16 step: weight slice kk / 4, 32 bytes in
              const uint32_t f[4] = {lo[2 * k], hi[2 * k], lo[2 * k + 1], hi[2 * k + 1]};
              wgmma_rs(d, f, desc0 + (((kk >> 2) * kSliceBytes + (kk & 3) * 32) >> 4), kk > 0);
            }
            gemm::wgmma_commit();
          }
        }
        gemm::wgmma_wait<0>();
        fence_operands(d);
        // Bias + ReLU -> bf16; the vertical max over conv rows 2s, 2s + 1, 2s + 2 (row hs
        // is the pool's zero pad); stage it for the horizontal max.
        const bool second = 2 * s + 2 < hs;
        uint32_t* stage = stage_w + parity * ws * kStageWords + p * kStageWords + t;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float b0 = bias_s[8 * j + 2 * t], b1 = bias_s[8 * j + 2 * t + 1];
          const uint32_t y1 = relu_bf16x2(add(d[4 * j], b0), add(d[4 * j + 1], b1));
          const uint32_t y2 = second ? relu_bf16x2(add(d[4 * j + 2], b0), add(d[4 * j + 3], b1)) : 0u;
          const uint32_t v = bf16x2_max(carry[j], bf16x2_max(y1, y2));
          carry[j] = y2;
          if (s >= i0 && live) stage[4 * j] = v;
        }
      }
      cp_async_wait_all();
      __syncthreads();  // the staged row is whole; the next step's rows have landed
      if (s >= i0) {
        // Horizontal: pooled column q over staged columns 2q, 2q + 1, 2q + 2 (ws: the pad).
        const uint32_t* stage = stage_w + parity * ws * kStageWords;
        uint32_t* out_w = reinterpret_cast<uint32_t*>(out) + (static_cast<size_t>(bt) * hp + s) * wp * (kCout / 2);
        for (int e = tid; e < wp * (kCout / 2); e += kThreads) {
          const int q = e >> 5, cw = e & 31;
          const uint32_t* src = stage + 2 * q * kStageWords + cw;
          uint32_t v = bf16x2_max(src[0], src[kStageWords]);
          if (2 * q + 2 < ws) v = bf16x2_max(v, src[2 * kStageWords]);
          out_w[e] = v;
        }
      }
      parity ^= 1;
    }
    u += i_end - i0;
  }
}

template <int kCopyBytes>
int launch(const void* x, const void* w, const void* bias, void* out, int batch, int frames, int height, int width,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(width);
  cudaError_t err = cudaFuncSetAttribute(s3dg_stem_wgmma_kernel<kCopyBytes>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int units = batch * (frames / 2) * (height / 4);
  const int grid = units < sms ? units : sms;
  s3dg_stem_wgmma_kernel<kCopyBytes><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<bf16*>(out), batch, frames, height, width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory the stem kernel needs at a frame width (0 if the width is not taken).
extern "C" size_t fitclip_s3dg_stem_smem_bytes(int width) {
  return width > kMaxWidth || smem_bytes(width) > kSmemLimit ? 0 : smem_bytes(width);
}

// x (B, T, H, W, 3) bf16, w (64, 768) bf16 packed, bias (64,) fp32 -> out (B, T/2, H/4, W/4, 64)
// bf16. T even, H and W multiples of 4, W <= 240; x, w and out 16-byte aligned.
extern "C" int fitclip_s3dg_stem(const void* x, const void* w, const void* bias, void* out, int batch, int frames,
                                 int height, int width, void* stream) {
  if (batch <= 0 || frames <= 0 || frames % 2 || height <= 0 || height % 4 || width <= 0 || width % 4 ||
      fitclip_s3dg_stem_smem_bytes(width) == 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(out)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width % 8 == 0) return launch<16>(x, w, bias, out, batch, frames, height, width, s);
  return launch<8>(x, w, bias, out, batch, frames, height, width, s);
}
