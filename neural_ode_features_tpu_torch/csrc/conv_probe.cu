// The 3x3 conv probe: y = conv3x3_same(x, w) alone (sm_90a), under five f32
// strategies and four bf16 twins, so that the conv stage of the fused
// kernels can be timed and redesigned in isolation.  One CTA per sample,
// but im2col_bf16, which tiles the rows of all samples.
//
// Replaces the TPU kernels of probes/conv_probe.py: pallas_conv_2d (kernels
// from make_roll_kernel) and pallas_conv (make_kernel, make_scratch_kernel).
// Wrapper and plain PyTorch version: kernels/conv3x3.py; entry point:
// probes/conv_probe.py in the package.
//
//   x (B, H, W, C) f32 NHWC, w (3, 3, C, C) f32 HWIO = (9, C, C) as (tap,
//   input channel, output channel), y (B, H, W, C) f32.  No bias and no time
//   map: the split ConcatConv adds those outside the contraction.
//
//   mma3    nodef::conv3x3_mma<3> of odefunc_common.cuh on a zero-bordered
//           copy of x in shared memory: the implicit GEMM over padded-pitch
//           positions on the tensor cores, mma.sync TF32 with 3xTF32 error
//           compensation (f32-grade).  This is the f32 conv stage of
//           odefunc.cu, rk_step.cu and odefunc_bwd.cu itself at C = 64 to
//           512 (multiples of 32) on 7x7 and 6x6 maps where wgmma_ok does
//           not hold, and of the backward's input-gradient convs at all of
//           them but its cluster pass (odefunc_bwd.cu), compiled for the
//           same width (wide_shape), so its time is
//           what those kernels pay per conv; at C % 64 == 32 it is the
//           check of the padded last block.
//   wgmma3  nodef::conv3x3_wgmma of odefunc_common.cuh, the same arithmetic
//           on wgmma.mma_async (A from registers, B split once per CTA
//           from a tile that cp.async.bulk brought in): the conv stage of
//           the f32 builds of odefunc.cu, rk_step.cu and odefunc_bwd.cu's
//           forward recompute wherever make_shape sets wg (wgmma_ok), under
//           their layout; it takes exactly those shapes.
//   mma1    mma3's kernel with the two tail products compiled out: plain
//           TF32, about three decimal digits.  A reading of what f32-grade
//           costs; nothing on a path uses it.
//   tap9    nodef::conv3x3 of odefunc_common.cuh (f32 FFMA): nine shifted
//           taps accumulated in registers, one output channel x up to 8
//           pixels per thread.  The fused kernels' stage at every other
//           shape, and the baseline of the race.  The counterpart of the TPU
//           strategies seq9, tree9, fori9 and roll9.
//   im2col  the CTA gathers the (H*W, 9C) patch matrix of its sample into
//           shared memory once (border entries zero) and computes one
//           (H*W, 9C) @ (9C, C) product from it, each thread a register tile
//           of 4 output channels x up to 4 pixels.  The counterpart of im2col,
//           im2colS and rollS.  The TPU kernels build the patch by rolls and
//           masks because Mosaic cannot reshape 4D tiles; here it is a gather.
//
// The bf16 twins ("bf16 multiplies, f32 accumulation", the TPU probe's
// *_bf16 strategies: both operands rounded to bf16, products and sums f32):
//
//   mma_bf16     nodef::conv3x3_mma<kPassBf16>: one mma.sync.m16n8k16 bf16
//                pass per 16 channels, operands packed to bf16 as the
//                fragments are built.  The conv stage of rk_step.cu's bf16
//                build, of odefunc.cu's where wgmma_ok does not hold and of
//                the bf16 backward's one-CTA pass's input gradients.
//   wgmma_bf16   nodef::conv3x3_wgmma<kBf16> on x rounded as it is copied
//                in: the conv stage of odefunc.cu's bf16 build where
//                wgmma_ok holds (7x7x64, 6x6x64); it takes exactly those
//                shapes.
//   tap9_bf16    tap9 on x rounded as it is copied in, the weights rounded
//                as they are read (nodef::conv3x3<true>): the bf16 builds'
//                stage at the other shapes.
//   im2col_bf16  one bf16 GEMM over the rows of every sample on
//                wgmma.mma_async with both operands from shared memory
//                (the note at im2col_wgmma_kernel); C a multiple of 4 to
//                128.
//
// Bound (H100 SXM: 67 TFLOP/s f32 outside the tensor cores, 495 TFLOP/s TF32
// on them, 3.35 TB/s): at B = 256, 7x7x64 the conv is 2*256*49*576*64 =
// 0.925 GFLOP, 13.8 us of FFMA or 1.9 us of TF32 products, against 6.6 MB
// moved, 2.0 us.  So tap9 and im2col are bound by operations (what decides
// them is FFMA per shared-memory load: tap9 does 32 per 4 scalar + 8 vector
// loads, im2col 64 per 8 vector loads), and on the tensor cores the conv is
// bound by bytes; mma3 itself forms three products over a 64-row tile (49
// real), 3.6 GFLOP, 7.3 us at the TF32 peak.
#include "odefunc_common.cuh"

namespace nodef {

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
tap9_kernel(const float* __restrict__ x, const float* __restrict__ w, Shape s,
            float* __restrict__ y) {
  extern __shared__ float4 smem_raw[];
  const Smem m = carve<false>(reinterpret_cast<float*>(smem_raw), s, nullptr);
  const int n = s.H * s.W * s.C;
  const float* xb = x + (size_t)blockIdx.x * n;
  float* yb = y + (size_t)blockIdx.x * n;

  zero_pad(m, s);
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += kThreads)
    m.spad[pad_index(s, e)] = kBf16 ? bf16_round(xb[e]) : xb[e];
  __syncthreads();
  conv3x3<kBf16>(m, s, w, [&](int p, int co, float acc) { yb[p * s.C + co] = acc; });
}

// kXg: the layout without sx (the state's global home, which this kernel
// does not use).
template <int PASSES, bool kWide, bool kXg>
__global__ void __launch_bounds__(kThreads, min_blocks(kWide))
mma_kernel(const float* __restrict__ x, const float* __restrict__ w, Shape s,
           float* __restrict__ y) {
  extern __shared__ float4 smem_raw[];
  const Smem m = carve<kXg>(reinterpret_cast<float*>(smem_raw), s, nullptr);
  const int n = s.H * s.W * s.C;
  const float* xb = x + (size_t)blockIdx.x * n;
  float* yb = y + (size_t)blockIdx.x * n;

  zero_pad(m, s);
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += kThreads) m.spad[pad_index(s, e)] = xb[e];
  __syncthreads();
  mma_stage<PASSES, false, kWide>(m, s, w, [&](int p, int co, float acc) { yb[p * s.C + co] = acc; });
}

// The wgmma3 stage (PREC = kF32) or the wgmma_bf16 stage (kBf16) alone,
// under the f32 or the bf16 kernels' layout (the narrow build: both run at
// C = 64 only).  kBf16 rounds x to bf16 as it is copied in, as the bf16
// build's gn_relu_to_pad rounds its output.
template <int PREC>
__global__ void __launch_bounds__(kThreads, min_blocks(false))
wgmma_kernel(const float* __restrict__ x, const float* __restrict__ w, Shape s,
             float* __restrict__ y) {
  extern __shared__ float4 smem_raw[];
  const Smem m = carve<false>(reinterpret_cast<float*>(smem_raw), s, nullptr);
  const int n = s.H * s.W * s.C;
  const float* xb = x + (size_t)blockIdx.x * n;
  float* yb = y + (size_t)blockIdx.x * n;

  zero_pad(m, s);
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += kThreads)
    m.spad[pad_index(s, e)] = PREC == kBf16 ? bf16_round(xb[e]) : xb[e];
  __syncthreads();
  conv3x3_wgmma<PREC>(m, s, w, [&](int p, int co, float acc) { yb[p * s.C + co] = acc; });
}

constexpr int kI2cThreads = 256;  // threads per CTA of the im2col kernel
constexpr int kI2cPix = 4;        // output pixels per thread (x 4 channels)
// Floats appended to each patch row: rows then start 4 banks apart, so the
// two pixel groups of a warp read their float4s without a bank conflict.
constexpr int kI2cPad = 4;

// Dynamic shared memory of the im2col kernel: the patch matrix and one conv
// tap's (C, C) weights, double-buffered.  kernels/conv3x3.py mirrors it.
inline size_t im2col_smem_bytes(int H, int W, int C) {
  return sizeof(float) * ((size_t)H * W * (9 * C + kI2cPad) + 2 * (size_t)C * C);
}

inline bool im2col_shape_ok(int H, int W, int C) {
  if (!layout_ok(ffma_shape(H, W, C, 1)) || kI2cThreads % (C / 4)) return false;
  const int npg = kI2cThreads / (C / 4);
  return (H * W + npg - 1) / npg <= kI2cPix && im2col_smem_bytes(H, W, C) <= kMaxSmem;
}

__device__ __forceinline__ void i2c_load_tap(float* dst, const float* __restrict__ src, int cc) {
  for (int i = threadIdx.x * 4; i < cc; i += kI2cThreads * 4) cp_async16(dst + i, src + i);
  cp_async_commit();
}

__global__ void __launch_bounds__(kI2cThreads, 1)
im2col_kernel(const float* __restrict__ x, const float* __restrict__ w, Shape s,
              float* __restrict__ y) {
  extern __shared__ float4 smem_raw[];
  const int tid = threadIdx.x, C = s.C, hw = s.H * s.W, cc = C * C;
  const int ld = 9 * C + kI2cPad;  // patch row stride, a multiple of 4 floats
  float* patch = reinterpret_cast<float*>(smem_raw);
  float* sw = patch + hw * ld;
  const float* xb = x + (size_t)blockIdx.x * hw * C;
  float* yb = y + (size_t)blockIdx.x * hw * C;

  i2c_load_tap(sw, w, cc);

  // patch[p, tap*C + ci] = x[y + ky - 1, x + kx - 1, ci], zero off the map.
  const int c4 = C / 4, nvec = hw * 9 * c4;
  for (int i = tid; i < nvec; i += kI2cThreads) {
    const int ci4 = i % c4, tap = (i / c4) % 9, p = i / (9 * c4);
    const int sy = p / s.W + tap / 3 - 1, sx = p % s.W + tap % 3 - 1;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (sy >= 0 && sy < s.H && sx >= 0 && sx < s.W)
      v = __ldg(reinterpret_cast<const float4*>(xb + (sy * s.W + sx) * C) + ci4);
    *reinterpret_cast<float4*>(patch + p * ld + tap * C + ci4 * 4) = v;
  }

  // Thread -> (4 output channels cg*4.., pixels pg, pg + npg, ...).
  const int cg = tid % c4, pg = tid / c4, npg = kI2cThreads / c4;
  const int np = (hw + npg - 1) / npg;  // pixel slots per thread (<= kI2cPix)
  float acc[kI2cPix][4];
  int row[kI2cPix];
#pragma unroll
  for (int k = 0; k < kI2cPix; ++k) {
    int p = pg + k * npg;
    if (p >= hw) p = 0;  // idle slot: computes pixel 0, result dropped
    row[k] = p * ld;
    acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;
  }

  for (int tap = 0; tap < 9; ++tap) {
    cp_async_wait_all();
    __syncthreads();  // tap's weights (and, first, the patch) visible; other buffer free
    if (tap < 8) i2c_load_tap(sw + ((tap + 1) & 1) * cc, w + (size_t)(tap + 1) * cc, cc);
    const float* wt = sw + (tap & 1) * cc + cg * 4;
    const float* in = patch + tap * C;
    for (int ci = 0; ci < C; ci += 4) {
      float4 w0 = *reinterpret_cast<const float4*>(wt + (ci + 0) * C);
      float4 w1 = *reinterpret_cast<const float4*>(wt + (ci + 1) * C);
      float4 w2 = *reinterpret_cast<const float4*>(wt + (ci + 2) * C);
      float4 w3 = *reinterpret_cast<const float4*>(wt + (ci + 3) * C);
#pragma unroll
      for (int k = 0; k < kI2cPix; ++k) {
        if (k < np) {
          const float4 a = *reinterpret_cast<const float4*>(in + row[k] + ci);
          acc[k][0] = fmaf(a.x, w0.x, acc[k][0]);
          acc[k][1] = fmaf(a.x, w0.y, acc[k][1]);
          acc[k][2] = fmaf(a.x, w0.z, acc[k][2]);
          acc[k][3] = fmaf(a.x, w0.w, acc[k][3]);
          acc[k][0] = fmaf(a.y, w1.x, acc[k][0]);
          acc[k][1] = fmaf(a.y, w1.y, acc[k][1]);
          acc[k][2] = fmaf(a.y, w1.z, acc[k][2]);
          acc[k][3] = fmaf(a.y, w1.w, acc[k][3]);
          acc[k][0] = fmaf(a.z, w2.x, acc[k][0]);
          acc[k][1] = fmaf(a.z, w2.y, acc[k][1]);
          acc[k][2] = fmaf(a.z, w2.z, acc[k][2]);
          acc[k][3] = fmaf(a.z, w2.w, acc[k][3]);
          acc[k][0] = fmaf(a.w, w3.x, acc[k][0]);
          acc[k][1] = fmaf(a.w, w3.y, acc[k][1]);
          acc[k][2] = fmaf(a.w, w3.z, acc[k][2]);
          acc[k][3] = fmaf(a.w, w3.w, acc[k][3]);
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kI2cPix; ++k) {
    const int p = pg + k * npg;
    if (k < np && p < hw)
      *reinterpret_cast<float4*>(yb + p * C + cg * 4) =
          make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
  }
}

// ---- im2col_bf16: the patch matrix on bf16 wgmma ---------------------------
//
// y = conv3x3_same(x, w) as one GEMM over the rows of all samples:
// patch (B*H*W, 9C) @ w (9C, C), both operands rounded to bf16 (to nearest
// even), f32 accumulation.  M runs over the flattened rows r = (b*H + y)*W
// + x, tiled in 64- or 128-row tiles that cross sample boundaries as the TPU
// kernel's tb samples do (a row's sums do not depend on its tile); K runs
// over (tap, input channel), tap-major, in stages of kI2wK = 64 (the last
// padded with zeros); N = C, padded to 64 * NB.
//
// A CTA is one producer warpgroup and MW consumer warpgroups, each
// consumer 64 rows.  Both operands of the products are K-major tiles in
// shared memory under the 128-byte swizzle (sw128_offset: a quarter-warp's
// eight 16-byte stores fall in eight distinct bank groups); per stage and
// 64-column block, wgmma.mma_async.m64n64k16 bf16 reads them through
// wgmma_desc_sw128, four k16 steps.
//   - The consumers first copy the CTA's window of x (the tile's rows and
//     W + 1 rows on either side: a contiguous range of x) into shared
//     memory as bf16 (cvt.rn.bf16x2), so that x is read from L2 once and
//     rounded once.  Then each builds its own 64 rows of each stage's
//     patch slice from the window (one 16-byte load a row and 8 k; zero
//     off the map, past the last row and past 9C) while its products of
//     the stage before run, and meets its own warpgroup (a named barrier)
//     before its products read them.
//   - The producer brings the stage's 64 rows of w (f32) in by cp.async,
//     i2w_depth stages ahead, into a staging ring whose 16-byte chunk (k,
//     q) lies at chunk q ^ (k / 8 % 8) of row k (the conversion reads
//     eight rows k 8 apart: eight bank groups), converts them to the
//     stage's (64 * NB, 64) bf16 slice and arrives on the stage's "full"
//     mbarrier (128 arrivals, each after a fence.proxy.async).  The
//     consumers wait on it, and after their products arrive on the
//     stage's "empty" mbarrier (one arrival per warp), which the producer
//     waits on before it writes the stage's weights again.
//   - The epilogue writes each consumer's f32 sums straight from its
//     registers, two floats a store.
//
// Accumulation order (PERF.md section 6 (1)): the tensor core's
// accumulation truncates, so per stage and k half (32 k) the two k16 steps
// form a chain from zero, added on the CUDA cores to that half's running
// f32 sum, stages in order; last, first half + second half.  At C = 64 a
// stage is a tap: the order of conv3x3_mma<kPassBf16> and of wgmma_bf16,
// and the card gives their bits.  One chain over K = 9C reads further from
// the f64 conv (probes/timing_aids.py --im2col, "chain").
// kernels/conv3x3.py im2col_wgmma_emulated follows the order.
//
// Bound at B = 256, 7x7x64 (H100 SXM, 3.35 TB/s, 989 TFLOP/s dense bf16):
// 6.6 MB moved, 2.0 us; 0.925 GFLOP, 0.94 us of bf16 products.  Each CTA
// reads the weights (147 KB of f32 at C = 64: 14 MB from L2 at B = 256 in
// 128-row tiles) and its window, and moves each stage through shared
// memory more than once (the patch built, then read by the tensor cores;
// the weights staged, converted, then read).
constexpr int kI2wK = 64;            // k of one stage: 128 bytes of bf16 per row
constexpr int kI2wStages = 4;        // stages in the ring
constexpr int kI2wMaxC = 128;        // the widest C (two 64-column blocks)
constexpr int kI2wMaxWindow = 65536; // bytes of the x window at most

// Stages of w in flight (the staging ring's depth): four at C <= 64, else
// two (the shared memory of the 64-row CTA of two column blocks).
__host__ __device__ constexpr int i2w_depth(int nb) { return nb == 1 ? 4 : 2; }
// 16-byte chunks of a staging row: C / 4, rounded up to a multiple of 8.
__host__ __device__ constexpr int i2w_chunks(int C) { return (C + 31) / 32 * 8; }
// Bytes of one stage (the (MW * 64, 64) patch slice and the (64 * NB, 64)
// weight slice), of the staging ring, of the x window (bf16, MW * 64 + 2W
// + 2 rows of C); dynamic shared memory: 1,024 bytes to align, the stages,
// the staging ring, the window and the 2 * kI2wStages mbarriers.
// kernels/conv3x3.py mirrors them.
__host__ __device__ constexpr int i2w_stage_bytes(int mw, int nb) {
  return (64 * mw + 64 * nb) * kI2wK * 2;
}
__host__ __device__ constexpr int i2w_staging_bytes(int nb, int C) {
  return i2w_depth(nb) * kI2wK * i2w_chunks(C) * 16;
}
__host__ __device__ constexpr int i2w_window_bytes(int mw, int W, int C) {
  return ((64 * mw + 2 * W + 2) * 2 * C + 15) / 16 * 16;
}
inline size_t i2w_smem_bytes(int mw, int nb, int W, int C) {
  return 1024 + (size_t)kI2wStages * i2w_stage_bytes(mw, nb) + i2w_staging_bytes(nb, C) +
         i2w_window_bytes(mw, W, C) + 16 * kI2wStages;
}

inline bool i2w_shape_ok(int B, int H, int W, int C) {
  return B >= 1 && H >= 1 && W >= 1 && C >= 4 && C <= kI2wMaxC && C % 4 == 0 &&
         i2w_window_bytes(1, W, C) <= kI2wMaxWindow && (long long)B * H * W * C < (1LL << 31);
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// 16 bytes from global src to shared dst, or 16 zero bytes where !valid.
__device__ __forceinline__ void cp_async16_at(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void sts128(uint32_t addr, uint32_t a, uint32_t b, uint32_t c,
                                       uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b), "r"(c),
               "r"(d)
               : "memory");
}
__device__ __forceinline__ void sts64(uint32_t addr, uint32_t a, uint32_t b) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(a), "r"(b) : "memory");
}
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
}
__device__ __forceinline__ float4 lds128f(uint32_t addr) {
  const uint4 v = lds128(addr);
  return make_float4(__uint_as_float(v.x), __uint_as_float(v.y), __uint_as_float(v.z),
                     __uint_as_float(v.w));
}




// The threads of the consumer warpgroups meet (named barrier 4).
__device__ __forceinline__ void consumers_sync(int mw) {
  asm volatile("bar.sync 4, %0;\n" ::"r"(128 * mw) : "memory");
}

template <int MW, int NB>
__global__ void __launch_bounds__(128 * (MW + 1), 1)
im2col_wgmma_kernel(const float* __restrict__ x, const float* __restrict__ w, int rows, int H,
                    int W, int C, float* __restrict__ y) {
  constexpr int kStage = i2w_stage_bytes(MW, NB);  // bytes
  constexpr int kD = i2w_depth(NB);
  extern __shared__ uint8_t i2w_raw[];
  const int QN = i2w_chunks(C), slot = kI2wK * QN * 16;  // the staging ring's rows, slot bytes
  const uint32_t base = (smem_addr(reinterpret_cast<float*>(i2w_raw)) + 1023u) & ~1023u;
  const uint32_t stg = base + kI2wStages * kStage;        // the staging ring (f32)
  const uint32_t win = stg + kD * slot;                   // the x window (bf16)
  const uint32_t bars = win + i2w_window_bytes(MW, W, C);  // full[s] +8s, empty[s] +8(S+s)
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, K = 9 * C;
  const int nk = (K + kI2wK - 1) / kI2wK, tile0 = blockIdx.x * 64 * MW;

  if (tid == 0) {
    for (int s = 0; s < kI2wStages; ++s) {
      mbar_init(bars + 8 * s, 128);
      mbar_init(bars + 8 * (kI2wStages + s), 4 * MW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // The producer.  Copies: chunk i = wt + 128 m of a stage, staging row
    // kl = i / QN, chunk q = i % QN: its place in a slot and its source
    // relative to the stage's first row of w, the same at every stage.
    // Conversion: thread wt, k chunk g (8 k: staging rows 8g .. 8g+7) of
    // output channels 4q .. 4q+3, q = wt / 8 + 16 jn.
    const int g = wt & 7, q0 = wt >> 3;
    constexpr int kCh = 8 * NB;  // chunks a thread a stage, at most
    const int nch = QN / 2;      // chunks a thread a stage
    uint32_t c_dst[kCh];
    int c_src[kCh], c_row[kCh];
#pragma unroll
    for (int m = 0; m < kCh; ++m) {
      const int i = wt + 128 * m, kl = i / QN, q = i - kl * QN;
      c_dst[m] = (kl * QN + (q ^ ((kl >> 3) & 7))) * 16;
      c_src[m] = kl * C + 4 * q;
      c_row[m] = 4 * q < C ? kl : K;  // K: never a row of w
    }
    auto copy = [&](int kc) {
      if (kc < nk) {
        const uint32_t dst = stg + (kc % kD) * slot;
        const int rows_left = K - kc * kI2wK;
        const float* wk = w + (size_t)kc * kI2wK * C;
#pragma unroll
        for (int m = 0; m < kCh; ++m) {
          if (m < nch) {
            const bool ok = c_row[m] < rows_left;
            cp_async16_at(dst + c_dst[m], ok ? wk + c_src[m] : w, ok);
          }
        }
      }
      cp_async_commit();  // one group a stage, empty past the last
    };
#pragma unroll
    for (int d = 0; d < kD - 1; ++d) copy(d);
    for (int kc = 0; kc < nk; ++kc) {  // the producer's stages
      const int s = kc % kI2wStages, use = kc / kI2wStages;
      const uint32_t b_s = base + s * kStage + 64 * MW * 128, src = stg + (kc % kD) * slot;
      copy(kc + kD - 1);
      cp_async_wait<kD - 1>();  // this thread's copies of stage kc have landed ...
      warpgroup_sync(0);        // ... and every producer thread's
      if (use > 0) mbar_wait(bars + 8 * (kI2wStages + s), (use - 1) & 1);
#pragma unroll
      for (int jn = 0; jn < NB; ++jn) {
        const int q = q0 + 16 * jn, n0 = 4 * q;
        float4 u[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          u[e] = n0 < C ? lds128f(src + ((8 * g + e) * QN + (q ^ g)) * 16)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        sts128(b_s + sw128_offset(n0, 8 * g), bf16x2(u[0].x, u[1].x), bf16x2(u[2].x, u[3].x),
               bf16x2(u[4].x, u[5].x), bf16x2(u[6].x, u[7].x));
        sts128(b_s + sw128_offset(n0 + 1, 8 * g), bf16x2(u[0].y, u[1].y),
               bf16x2(u[2].y, u[3].y), bf16x2(u[4].y, u[5].y), bf16x2(u[6].y, u[7].y));
        sts128(b_s + sw128_offset(n0 + 2, 8 * g), bf16x2(u[0].z, u[1].z),
               bf16x2(u[2].z, u[3].z), bf16x2(u[4].z, u[5].z), bf16x2(u[6].z, u[7].z));
        sts128(b_s + sw128_offset(n0 + 3, 8 * g), bf16x2(u[0].w, u[1].w),
               bf16x2(u[2].w, u[3].w), bf16x2(u[4].w, u[5].w), bf16x2(u[6].w, u[7].w));
      }
      fence_proxy_async();  // these stores, before the tensor cores read them
      mbar_arrive(bars + 8 * s);
      warpgroup_sync(0);  // every thread is done with the staging slot
    }
    return;
  }

  // A consumer: rows 64 * wc .. + 63 of the tile.  Thread wt builds k
  // chunk g (8 k) of its rows wt / 8 + 16 j; per k half of the stage and
  // column block a chain a0 (k 0..31) or a1 (k 32..63) is added to the
  // half's running sum run[0] or run[1].
  const int wc = wg - 1, lane = tid & 31, wi = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int ag = wt & 7, ar0 = 64 * wc + (wt >> 3);
  const bool c8 = C % 8 == 0;  // a chunk of 8 k lies in one tap
  // The window: rows tile0 - W - 1 .. tile0 + 64 MW + W of x (zero past
  // either end), four floats a thread at a time, coalesced, by the
  // consumers while the producer's first copies are in flight.
  {
    const int n = (64 * MW + 2 * W + 2) * C;
    const long long e0 = (long long)(tile0 - W - 1) * C, end = (long long)rows * C;
#pragma unroll 4
    for (int i = 4 * (tid - 128); i < n; i += 4 * 128 * MW) {
      const long long e = e0 + i;
      const float4 v = (e >= 0 && e < end) ? __ldg(reinterpret_cast<const float4*>(x + e))
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
      sts64(win + 2 * i, bf16x2(v.x, v.y), bf16x2(v.z, v.w));
    }
  }
  consumers_sync(MW);
  unsigned on[4];              // bit tap: the tap's input lies on the map
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = tile0 + ar0 + 16 * j;
    on[j] = 0;
    if (r < rows) {
      const int p = r % (H * W), yy = p / W, xx = p - yy * W;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int sy = yy + tap / 3 - 1, sx = xx + tap % 3 - 1;
        if (sy >= 0 && sy < H && sx >= 0 && sx < W) on[j] |= 1u << tap;
      }
    }
  }
  // The patch slice of stage kc, this warpgroup's rows: k = kc*64 + 8ag +
  // 4h, h = 0, 1 (4 k of one tap each, C % 4 == 0), from window row
  // (r - tile0) + W + 1 + the tap's shift.
  auto build_a = [&](int kc) {
    const uint32_t a_s = base + (kc % kI2wStages) * kStage;
    int off[2];
    unsigned bit[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = kc * kI2wK + 8 * ag + 4 * h;
      const int tap = k < K ? k / C : 0, ci = k - tap * C;
      bit[h] = k < K ? 1u << tap : 0u;
      off[h] = 2 * (((tap / 3 - 1) * W + tap % 3 + W) * C + ci);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t row = win + 2 * (ar0 + 16 * j) * C;
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (c8) {
        if (on[j] & bit[0]) q = lds128(row + off[0]);
      } else {
        const uint2 lo = (on[j] & bit[0]) ? lds64(row + off[0]) : make_uint2(0u, 0u);
        const uint2 hi = (on[j] & bit[1]) ? lds64(row + off[1]) : make_uint2(0u, 0u);
        q = make_uint4(lo.x, lo.y, hi.x, hi.y);
      }
      sts128(a_s + sw128_offset(ar0 + 16 * j, 8 * ag), q.x, q.y, q.z, q.w);
    }
    fence_proxy_async();  // these stores, before the tensor cores read them
  };

  float a0[32], a1[32], run[2][NB][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    a0[i] = a1[i] = 0.f;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) run[0][nb][i] = run[1][nb][i] = 0.f;
  }
  build_a(0);
  warpgroup_sync(wg);
  for (int kc = 0; kc < nk; ++kc) {  // the consumers' stages
    const int s = kc % kI2wStages;
    const uint32_t a_s = base + s * kStage, b_s = a_s + 64 * MW * 128;
    const uint64_t da = wgmma_desc_sw128(a_s + wc * 64 * 128);
    mbar_wait(bars + 8 * s, (kc / kI2wStages) & 1);  // the stage's weights
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const uint64_t db = wgmma_desc_sw128(b_s + nb * 64 * 128);
      wgmma_fence();
      wgmma_ss_bf16(a0, da, db, 0);
      wgmma_ss_bf16(a0, da + 2, db + 2, 1);
      wgmma_ss_bf16(a1, da + 4, db + 4, 0);
      wgmma_ss_bf16(a1, da + 6, db + 6, 1);
      wgmma_commit();
      // The next stage's patch slice while the last block's products run.
      if (nb == NB - 1 && kc + 1 < nk) build_a(kc + 1);
      wgmma_wait<0>();
      pin(a0);
      pin(a1);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        run[0][nb][i] += a0[i];
        run[1][nb][i] += a1[i];
      }
    }
    if (lane == 0) mbar_arrive(bars + 8 * (kI2wStages + s));
    warpgroup_sync(wg);  // the next slice is visible to the products
  }
  // The epilogue: rows 16 wi + g and + 8 of the warp, columns 8j + 2t and
  // + 1 of each block.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = tile0 + 64 * wc + 16 * wi + g + 8 * h;
    if (r >= rows) continue;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int co = 64 * nb + 8 * j + 2 * t, i = 4 * j + 2 * h;
        if (co < C)
          *reinterpret_cast<float2*>(y + (size_t)r * C + co) =
              make_float2(run[0][nb][i] + run[1][nb][i], run[0][nb][i + 1] + run[1][nb][i + 1]);
      }
  }
}

}  // namespace nodef

template <bool kBf16>
static int launch_tap9(const float* x, const float* w, float* y,
                       int B, int H, int W, int C, void* stream) {
  using namespace nodef;
  const Shape s = ffma_shape(H, W, C, 1);
  if (!layout_ok(s) || B < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = odefunc_smem_bytes(s);
  cudaError_t err = cudaFuncSetAttribute(
      tap9_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tap9_kernel<kBf16><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(x, w, s, y);
  return (int)cudaGetLastError();
}

static int launch_im2col(const float* x, const float* w, float* y,
                         int B, int H, int W, int C, void* stream) {
  using namespace nodef;
  if (!im2col_shape_ok(H, W, C) || B < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = im2col_smem_bytes(H, W, C);
  cudaError_t err = cudaFuncSetAttribute(
      im2col_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Shape s = ffma_shape(H, W, C, 1);
  im2col_kernel<<<B, kI2cThreads, smem, static_cast<cudaStream_t>(stream)>>>(x, w, s, y);
  return (int)cudaGetLastError();
}

template <int MW, int NB>
static int launch_i2w(const float* x, const float* w, float* y, int rows, int H, int W, int C,
                      cudaStream_t stream) {
  using namespace nodef;
  const auto kernel = im2col_wgmma_kernel<MW, NB>;
  const size_t smem = i2w_smem_bytes(MW, NB, W, C);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(rows + 64 * MW - 1) / (64 * MW), 128 * (MW + 1), smem, stream>>>(x, w, rows, H, W,
                                                                              C, y);
  return (int)cudaGetLastError();
}

extern "C" int conv_probe_tap9(const float* x, const float* w, float* y,
                               int B, int H, int W, int C, void* stream) {
  return launch_tap9<false>(x, w, y, B, H, W, C, stream);
}

extern "C" int conv_probe_tap9_bf16(const float* x, const float* w, float* y,
                                    int B, int H, int W, int C, void* stream) {
  return launch_tap9<true>(x, w, y, B, H, W, C, stream);
}

extern "C" int conv_probe_im2col(const float* x, const float* w, float* y,
                                 int B, int H, int W, int C, void* stream) {
  return launch_im2col(x, w, y, B, H, W, C, stream);
}

// tile_rows: 64, or 128 at C <= 64 where that tile's window fits; the
// caller's choice (kernels/conv3x3.py im2col_tile_rows).
extern "C" int conv_probe_im2col_bf16(const float* x, const float* w, float* y,
                                      int B, int H, int W, int C, void* stream,
                                      int tile_rows) {
  using namespace nodef;
  const bool tall = tile_rows == 128;
  if (!i2w_shape_ok(B, H, W, C) || (tile_rows != 64 && !tall) ||
      (tall && (C > 64 || i2w_window_bytes(2, W, C) > kI2wMaxWindow)))
    return (int)cudaErrorInvalidValue;
  const int rows = B * H * W;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C > 64) return launch_i2w<1, 2>(x, w, y, rows, H, W, C, st);
  return tall ? launch_i2w<2, 1>(x, w, y, rows, H, W, C, st)
              : launch_i2w<1, 1>(x, w, y, rows, H, W, C, st);
}

template <int PASSES>
static int launch_mma(const float* x, const float* w, float* y,
                      int B, int H, int W, int C, void* stream) {
  using namespace nodef;
  const Shape s = make_shape(H, W, C, 1, kBf16Conv);  // conv3x3_mma's layout
  if (!s.mma || !layout_ok(s) || B < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = odefunc_smem_bytes(s);
  const auto kernel = !wide_shape(s) ? mma_kernel<PASSES, false, false>
                      : s.xg        ? mma_kernel<PASSES, true, true>
                                    : mma_kernel<PASSES, true, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(x, w, s, y);
  return (int)cudaGetLastError();
}

extern "C" int conv_probe_mma3(const float* x, const float* w, float* y,
                               int B, int H, int W, int C, void* stream) {
  return launch_mma<3>(x, w, y, B, H, W, C, stream);
}

extern "C" int conv_probe_mma1(const float* x, const float* w, float* y,
                               int B, int H, int W, int C, void* stream) {
  return launch_mma<1>(x, w, y, B, H, W, C, stream);
}

extern "C" int conv_probe_mma_bf16(const float* x, const float* w, float* y,
                                   int B, int H, int W, int C, void* stream) {
  return launch_mma<nodef::kPassBf16>(x, w, y, B, H, W, C, stream);
}

template <int PREC>
static int launch_wgmma(const float* x, const float* w, float* y,
                        int B, int H, int W, int C, void* stream) {
  using namespace nodef;
  const Shape s = make_shape(H, W, C, 1, PREC);
  if (!s.wg || wide_shape(s) || !layout_ok(s) || B < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = odefunc_smem_bytes(s);
  cudaError_t err = cudaFuncSetAttribute(wgmma_kernel<PREC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  wgmma_kernel<PREC><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(x, w, s, y);
  return (int)cudaGetLastError();
}

extern "C" int conv_probe_wgmma3(const float* x, const float* w, float* y,
                                 int B, int H, int W, int C, void* stream) {
  return launch_wgmma<nodef::kF32>(x, w, y, B, H, W, C, stream);
}

extern "C" int conv_probe_wgmma_bf16(const float* x, const float* w, float* y,
                                     int B, int H, int W, int C, void* stream) {
  return launch_wgmma<nodef::kBf16>(x, w, y, B, H, W, C, stream);
}
