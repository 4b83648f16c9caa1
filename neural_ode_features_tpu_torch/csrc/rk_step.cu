// Fused dopri5 attempt: one whole embedded RK step per sample, one CTA per
// sample (sm_90a).
//
// Replaces the TPU kernels neural_ode_features_tpu/kernels/rk_step_pallas.py
// (_make_rows_step.fused_step -> _rk_step_kernel_rows, and the 4D-layout
// make_fused_dopri5_step.fused_step -> _rk_step_kernel: one function).
// Wrapper and plain PyTorch version: kernels/rk_step.py.
//
// Per sample: the six FSAL evaluations of f (odefunc_common.cuh) with their
// stage sums, y1 (5th order), err (b_err), y_mid (c_mid, for the quartic
// dense output) and the mixed-tolerance error ratio
//     sqrt(mean((err / (atol + rtol * max(|y0|, |y1|)))^2) + FLT_MIN).
// rtol and atol are (B,) arrays, one entry per sample, read once by the
// sample's CTA: rows of one launch may carry different tolerances (a
// tolerance grid stacked on the batch axis is one launch per attempt).
// The stage derivatives k2..k6 live in a global scratch tensor written and
// read back by the same thread (same element mapping), so they stay in L1/L2
// and shared memory holds only one eval's working set; k7 is f1.
//
// The twelve 3x3 convs of an attempt are the conv stage of
// odefunc_common.cuh: at C = 64 to 512 (multiples of 32) on 7x7 and 6x6
// maps TF32 products on the tensor cores with 3xTF32 error compensation
// (f32-grade, so the accept/reject decisions follow the f32 plain
// version's): wgmma.mma_async (wgmma3) where wgmma_ok holds, 7x7x64 and
// 6x6x64 among those shapes, else mma.sync; at other shapes f32 FFMA.
// kWide, kXg: the build (odefunc_common.cuh wide_shape).
// kPrec: rk_step_forward is the f32 kernel; rk_step_forward_bf16 is the
// fused step's conv_precision='bf16' (kBf16Conv): the twelve convs on the
// bf16 stage (bf16 operands, f32 accumulation: wgmma_bf16 where wgmma_ok
// holds, else mma.sync bf16; FFMA on rounded operands at other shapes),
// GroupNorm, bias, time map, stage sums and error ratio f32, as the TPU
// kernel's mxu_dtype=bf16.
// Where the stage input y_i does not fit in shared memory (fit_layout, the
// kXg build), the y1 output is its buffer until the last pass writes y1.
#include <float.h>

#include "odefunc_common.cuh"

namespace nodef {

constexpr int kStages = 7;

struct Tableau {  // f32 coefficients, zero where a term is skipped
  float a[kStages][kStages];
  float b[kStages], e[kStages], c[kStages], mid[kStages];
};

template <bool kWide, bool kXg, int kPrec>
__global__ void __launch_bounds__(kThreads, min_blocks(kWide))
rk_step_kernel(const float* __restrict__ t0, const float* __restrict__ dt,
               const float* __restrict__ y0, const float* __restrict__ f0,
               Odefunc p, Shape s, Tableau tab,
               const float* __restrict__ rtol_b,
               const float* __restrict__ atol_b,
               float* __restrict__ ks, float* __restrict__ y1,
               float* __restrict__ f1, float* __restrict__ ymid,
               float* __restrict__ ratio) {
  extern __shared__ float4 smem_raw[];
  __shared__ Tableau st;
  const int n = s.H * s.W * s.C, tid = threadIdx.x;
  const size_t off = (size_t)blockIdx.x * n, plane = (size_t)gridDim.x * n;
  const Smem m = carve<kXg>(reinterpret_cast<float*>(smem_raw), s, y1 + off);
  const float tb = t0[blockIdx.x], h = dt[blockIdx.x];
  const float rtol = rtol_b[blockIdx.x], atol = atol_b[blockIdx.x];
  const float* y0b = y0 + off;

  // k_j of this sample: k1 = f0, k2..k6 in scratch, k7 = f1.
  auto kp = [&](int j) -> float* {
    if (j == 0) return const_cast<float*>(f0) + off;
    if (j == kStages - 1) return f1 + off;
    return ks + (size_t)(j - 1) * plane + off;
  };

  if (tid == 0) st = tab;
  zero_pad(m, s);
  __syncthreads();

  for (int i = 1; i < kStages; ++i) {
    // y_i = y0 + dt * sum_j a[i][j] k_j, zero terms skipped, left to right.
    // The loads of k_1..k_i are started together, ahead of the sum, so that
    // their L2 latencies overlap.
    for (int e = tid; e < n; e += kThreads) {
      float kv[kStages - 1];
#pragma unroll
      for (int j = 0; j < kStages - 1; ++j) kv[j] = j < i ? kp(j)[e] : 0.f;
      const float yv = y0b[e];
      float acc = 0.f;
      bool any = false;
#pragma unroll
      for (int j = 0; j < kStages - 1; ++j) {
        const float a = j < i ? st.a[i][j] : 0.f;
        if (a != 0.f) {
          const float term = a * kv[j];
          acc = any ? acc + term : term;
          any = true;
        }
      }
      m.sx[e] = any ? yv + h * acc : yv;
    }
    __syncthreads();
    float* ki = kp(i);
    odefunc_eval<kWide, kPrec>(m, s, p, tb + st.c[i] * h, [&](int e, float v) { ki[e] = v; });
  }

  float r2 = 0.f;
  for (int e = tid; e < n; e += kThreads) {
    float kv[kStages];
#pragma unroll
    for (int j = 0; j < kStages; ++j) kv[j] = kp(j)[e];
    float sb = 0.f, se = 0.f, sm = 0.f;
    bool ab = false, ae = false, am = false;
#pragma unroll
    for (int j = 0; j < kStages; ++j) {
      const float k = kv[j];
      if (st.b[j] != 0.f) { const float v = st.b[j] * k; sb = ab ? sb + v : v; ab = true; }
      if (st.e[j] != 0.f) { const float v = st.e[j] * k; se = ae ? se + v : v; ae = true; }
      if (st.mid[j] != 0.f) { const float v = st.mid[j] * k; sm = am ? sm + v : v; am = true; }
    }
    const float yv = y0b[e];
    const float y1v = yv + h * sb;
    const float err = h * se;
    y1[off + e] = y1v;
    ymid[off + e] = yv + h * sm;
    const float r = err / (atol + rtol * fmaxf(fabsf(yv), fabsf(y1v)));
    r2 = fmaf(r, r, r2);
  }

  // Block sum of r2: warp shuffles, then one value per warp in sred.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) r2 += __shfl_xor_sync(0xffffffffu, r2, o);
  if ((tid & 31) == 0) m.sred[tid >> 5] = r2;
  __syncthreads();
  if (tid == 0) {
    float tot = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) tot += m.sred[w];
    ratio[blockIdx.x] = sqrtf(tot / (float)n + FLT_MIN);
  }
}

template <int kPrec>
int launch(const float* t0, const float* dt, const float* y0, const float* f0,
           const Odefunc& p, const float* tableau, const float* rtol, const float* atol,
           float* ks, float* y1, float* f1, float* ymid, float* ratio,
           int B, int H, int W, int C, int G, void* stream) {
  if (!shape_ok(H, W, C, G) || B < 1) return (int)cudaErrorInvalidValue;
  const Shape s = make_shape(H, W, C, G);
  const size_t smem = odefunc_smem_bytes(s);
  const auto kernel = !wide_shape(s) ? rk_step_kernel<false, false, kPrec>
                      : s.xg        ? rk_step_kernel<true, true, kPrec>
                                    : rk_step_kernel<true, false, kPrec>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Tableau tab;
  const float* q = tableau;
  for (int i = 0; i < kStages; ++i)
    for (int j = 0; j < kStages; ++j) tab.a[i][j] = *q++;
  for (int i = 0; i < kStages; ++i) tab.b[i] = *q++;
  for (int i = 0; i < kStages; ++i) tab.e[i] = *q++;
  for (int i = 0; i < kStages; ++i) tab.c[i] = *q++;
  for (int i = 0; i < kStages; ++i) tab.mid[i] = *q++;
  kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      t0, dt, y0, f0, p, s, tab, rtol, atol, ks, y1, f1, ymid, ratio);
  return (int)cudaGetLastError();
}

}  // namespace nodef

// tableau: host, a (7x7), b, b_err, c, c_mid (7 each), f32; rtol, atol:
// device, (B,) each.
#define NODEF_RK_STEP_ARGS                                                               \
  const float *t0, const float *dt, const float *y0, const float *f0, const float *n1s,  \
      const float *n1b, const float *w1, const float *b1, const float *m1,                \
      const float *n2s, const float *n2b, const float *w2, const float *b2,               \
      const float *m2, const float *n3s, const float *n3b, const float *tableau,          \
      const float *rtol, const float *atol, float *ks, float *y1, float *f1,              \
      float *ymid, float *ratio, int B, int H, int W, int C, int G, void *stream

extern "C" int rk_step_forward(NODEF_RK_STEP_ARGS) {
  const nodef::Odefunc p{n1s, n1b, w1, b1, m1, n2s, n2b, w2, b2, m2, n3s, n3b};
  return nodef::launch<nodef::kF32>(t0, dt, y0, f0, p, tableau, rtol, atol, ks, y1, f1,
                                    ymid, ratio, B, H, W, C, G, stream);
}

extern "C" int rk_step_forward_bf16(NODEF_RK_STEP_ARGS) {
  const nodef::Odefunc p{n1s, n1b, w1, b1, m1, n2s, n2b, w2, b2, m2, n3s, n3b};
  return nodef::launch<nodef::kBf16Conv>(t0, dt, y0, f0, p, tableau, rtol, atol, ks, y1,
                                         f1, ymid, ratio, B, H, W, C, G, stream);
}
