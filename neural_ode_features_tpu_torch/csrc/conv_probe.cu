// The 3x3 conv probe: y = conv3x3_same(x, w) alone, one CTA per sample
// (sm_90a), under five strategies, so that the conv stage of the fused
// kernels can be timed and redesigned in isolation.
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
//                build, of odefunc.cu's where wgmma_ok does not hold (there
//                it runs wgmma_bf16, which no strategy here races) and of
//                the bf16 backward's one-CTA pass's input gradients.
//   tap9_bf16    tap9 on x rounded as it is copied in, the weights rounded
//                as they are read (nodef::conv3x3<true>): the bf16 builds'
//                stage at the other shapes.
//   im2col_bf16  im2col, the patch rounded as it is gathered and the
//                weights as they are read.
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

// The wgmma3 stage alone, under the f32 kernels' layout (the narrow build:
// wgmma3 runs at C = 64 only).
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
  for (int e = threadIdx.x; e < n; e += kThreads) m.spad[pad_index(s, e)] = xb[e];
  __syncthreads();
  conv3x3_wgmma<kF32>(m, s, w, [&](int p, int co, float acc) { yb[p * s.C + co] = acc; });
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

__device__ __forceinline__ float4 bf16_round4(float4 v) {
  return make_float4(bf16_round(v.x), bf16_round(v.y), bf16_round(v.z), bf16_round(v.w));
}

__device__ __forceinline__ void i2c_load_tap(float* dst, const float* __restrict__ src, int cc) {
  for (int i = threadIdx.x * 4; i < cc; i += kI2cThreads * 4) cp_async16(dst + i, src + i);
  cp_async_commit();
}

template <bool kBf16>
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
    if (kBf16) v = bf16_round4(v);
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
      if (kBf16) {
        w0 = bf16_round4(w0);
        w1 = bf16_round4(w1);
        w2 = bf16_round4(w2);
        w3 = bf16_round4(w3);
      }
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

template <bool kBf16>
static int launch_im2col(const float* x, const float* w, float* y,
                         int B, int H, int W, int C, void* stream) {
  using namespace nodef;
  if (!im2col_shape_ok(H, W, C) || B < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = im2col_smem_bytes(H, W, C);
  cudaError_t err = cudaFuncSetAttribute(
      im2col_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Shape s = ffma_shape(H, W, C, 1);
  im2col_kernel<kBf16><<<B, kI2cThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w, s, y);
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
  return launch_im2col<false>(x, w, y, B, H, W, C, stream);
}

extern "C" int conv_probe_im2col_bf16(const float* x, const float* w, float* y,
                                      int B, int H, int W, int C, void* stream) {
  return launch_im2col<true>(x, w, y, B, H, W, C, stream);
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

extern "C" int conv_probe_wgmma3(const float* x, const float* w, float* y,
                                 int B, int H, int W, int C, void* stream) {
  using namespace nodef;
  const Shape s = make_shape(H, W, C, 1, kF32);
  if (!s.wg || wide_shape(s) || !layout_ok(s) || B < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = odefunc_smem_bytes(s);
  cudaError_t err =
      cudaFuncSetAttribute(wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  wgmma_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(x, w, s, y);
  return (int)cudaGetLastError();
}
