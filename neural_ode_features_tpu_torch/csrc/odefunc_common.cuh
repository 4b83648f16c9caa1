// One evaluation of the ODE-Net dynamics f(t, h) for ONE sample, by one CTA:
//
//     GN -> ReLU -> [conv3x3(h, W1) + b1 + t*M1] -> GN -> ReLU
//        -> [conv3x3(h, W2) + b2 + t*M2] -> GN
//
// Shared by csrc/odefunc.cu (one f per launch), csrc/rk_step.cu (six f
// per launch inside one dopri5 attempt) and csrc/odefunc_bwd.cu (the forward
// recompute, and the input-gradient convs through conv3x3).  ConcatConv uses the split form of
// ops/layers.py: the time channel contributes t*M, with the border-aware map
// M = conv(ones, W[:, :, :1, :]) precomputed in strict f32 by the wrapper,
// so the contraction here is a clean C -> C 3x3 conv.
//
// Layout: the state of one sample is NHWC-flat, element e = (y*W + x)*C + c,
// the same order as the port's public (B, H*W*C) solver state, so the
// kernels read and write the solver's tensors directly.
//
// Arithmetic: strict f32 on the CUDA cores (FFMA); no TF32, bf16 or tensor
// cores.  GroupNorm uses the centred variance, as the JAX package does.
//
// Work split inside the CTA (kThreads threads, C | kThreads):
//   * conv: thread -> (output channel co = tid % C, pixel group pg = tid / C);
//     a thread accumulates its channel at pixels pg, pg + NPG, ... (at most
//     kMaxPix of them) in registers.  Each conv tap's (C, C) weight slice is
//     staged into shared memory by cp.async, double-buffered across taps, so
//     every CTA reads each weight once per conv from L2.  Inputs are read
//     as float4 over 4 input channels; all lanes of a warp share the pixel,
//     so these are broadcasts.
//   * GroupNorm: per-(pixel group, channel) partial sums in shared memory,
//     then one thread per group.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace nodef {

constexpr int kThreads = 512;  // threads per CTA, one CTA per sample
constexpr int kMaxPix = 8;     // conv output pixels per thread
constexpr float kEps = 1e-5f;  // GroupNorm epsilon

// Parameters of the ODEfunc, device pointers, all f32 and contiguous.
struct Odefunc {
  const float* n1s; const float* n1b;
  const float* w1;  // (9, C, C): tap (ky*3 + kx), input channel, output channel
  const float* b1;  // (C,)
  const float* m1;  // (H*W, C) time map
  const float* n2s; const float* n2b;
  const float* w2; const float* b2; const float* m2;
  const float* n3s; const float* n3b;
};

struct Shape { int H, W, C, G; };

// Dynamic shared memory, in floats, in this order:
//   sx    [H*W*C]            pre-norm state of the sample
//   spad  [(H+2)*(W+2)*C]    relu(GN(.)) with a zero border: the conv input
//   sw    [2*C*C]            one conv tap's weights, double-buffered
//   sred  [kThreads]         per-(pixel group, channel) partial sums
//   smean [G], sinv [G]      group statistics
// kernels/odefunc.py (smem_bytes) mirrors this formula for the gate.
inline size_t odefunc_smem_bytes(int H, int W, int C, int G) {
  return sizeof(float) * ((size_t)H * W * C + (size_t)(H + 2) * (W + 2) * C +
                          2 * (size_t)C * C + kThreads + 2 * (size_t)G);
}

// The largest dynamic shared memory one CTA may use on sm_90 (227 KB), less
// 1 KB for the rk-step kernel's static tableau.
constexpr size_t kMaxSmem = 232448 - 1024;

// The shapes the kernels take; kernels/odefunc.py (supported) is the same
// gate in Python.
inline bool shape_ok(int H, int W, int C, int G) {
  if (H < 1 || W < 1 || C < 4 || G < 1 || C % 4 || kThreads % C || C % G) return false;
  const int npg = kThreads / C;
  return (H * W + npg - 1) / npg <= kMaxPix && odefunc_smem_bytes(H, W, C, G) <= kMaxSmem;
}

struct Smem { float* sx; float* spad; float* sw; float* sred; float* smean; float* sinv; };

__device__ __forceinline__ Smem carve(float* base, const Shape& s) {
  Smem m;
  m.sx = base;
  m.spad = m.sx + s.H * s.W * s.C;
  m.sw = m.spad + (s.H + 2) * (s.W + 2) * s.C;
  m.sred = m.sw + 2 * s.C * s.C;
  m.smean = m.sred + kThreads;
  m.sinv = m.smean + s.G;
  return m;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Zero the padded conv input once per launch; only its interior is written
// afterwards, so the border stays zero (SAME padding).
__device__ __forceinline__ void zero_pad(const Smem& m, const Shape& s) {
  const int n = (s.H + 2) * (s.W + 2) * s.C;
  for (int i = threadIdx.x; i < n; i += kThreads) m.spad[i] = 0.f;
}

// Group mean and 1/sqrt(var + eps) of x (H*W*C, NHWC) into mean/inv
// (centred variance).  Starts reading x (the caller has synchronised) and
// ends synchronised.
__device__ void gn_stats(const Smem& m, const Shape& s, const float* x,
                         float* mean, float* inv) {
  const int tid = threadIdx.x, C = s.C, c = tid % C, pg = tid / C;
  const int npg = kThreads / C, hw = s.H * s.W, gs = C / s.G;
  const float n = (float)(hw * gs);

  float acc = 0.f;
  for (int p = pg; p < hw; p += npg) acc += x[p * C + c];
  m.sred[tid] = acc;  // tid == pg * C + c
  __syncthreads();
  if (tid < s.G) {
    float tot = 0.f;
    for (int q = 0; q < npg; ++q)
      for (int j = 0; j < gs; ++j) tot += m.sred[q * C + tid * gs + j];
    mean[tid] = tot / n;
  }
  __syncthreads();

  const float mu = mean[c / gs];
  acc = 0.f;
  for (int p = pg; p < hw; p += npg) {
    const float d = x[p * C + c] - mu;
    acc = fmaf(d, d, acc);
  }
  m.sred[tid] = acc;
  __syncthreads();
  if (tid < s.G) {
    float tot = 0.f;
    for (int q = 0; q < npg; ++q)
      for (int j = 0; j < gs; ++j) tot += m.sred[q * C + tid * gs + j];
    inv[tid] = 1.0f / sqrtf(tot / n + kEps);
  }
  __syncthreads();
}

// Normalised value x-hat at element e of x, from gn_stats' mean/inv.
__device__ __forceinline__ float gn_hat(const Shape& s, const float* x,
                                        const float* mean, const float* inv, int e) {
  const int g = (e % s.C) / (s.C / s.G);
  return (x[e] - mean[g]) * inv[g];
}

// GroupNorm output at element e of sx (after gn_stats into smean/sinv).
__device__ __forceinline__ float gn_value(const Smem& m, const Shape& s,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ bias, int e) {
  const int c = e % s.C;
  return gn_hat(s, m.sx, m.smean, m.sinv, e) * scale[c] + bias[c];
}

// spad interior = relu(GN(x)) with x's statistics in mean/inv.  NaN passes
// through, as in torch.relu.
__device__ void gn_relu_to_pad(const Smem& m, const Shape& s, const float* x,
                               const float* mean, const float* inv,
                               const float* __restrict__ scale,
                               const float* __restrict__ bias) {
  const int n = s.H * s.W * s.C, Wp = s.W + 2;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int c = e % s.C, p = e / s.C, y = p / s.W, xx = p % s.W;
    const float v = gn_hat(s, x, mean, inv, e) * scale[c] + bias[c];
    m.spad[((y + 1) * Wp + xx + 1) * s.C + c] = v < 0.f ? 0.f : v;
  }
}

__device__ __forceinline__ void load_tap(float* dst, const float* __restrict__ src, int cc) {
  for (int i = threadIdx.x * 4; i < cc; i += kThreads * 4) cp_async16(dst + i, src + i);
  cp_async_commit();
}

// 3x3 SAME conv of spad with w (9, C, C); the sum at output pixel p and
// channel co is handed to epi(p, co, acc).  Caller synchronises before (spad
// written) and after (whatever epi wrote).
template <class Epi>
__device__ void conv3x3(const Smem& m, const Shape& s, const float* __restrict__ w,
                        Epi epi) {
  const int tid = threadIdx.x, C = s.C, co = tid % C, pg = tid / C;
  const int npg = kThreads / C, hw = s.H * s.W, Wp = s.W + 2, cc = C * C;
  const int np = (hw + npg - 1) / npg;  // pixel slots per thread (<= kMaxPix)

  float acc[kMaxPix];
  int base[kMaxPix];
#pragma unroll
  for (int k = 0; k < kMaxPix; ++k) {
    int p = pg + k * npg;
    if (p >= hw) p = 0;  // idle slot: computes pixel 0, result dropped
    base[k] = ((p / s.W) * Wp + p % s.W) * C;
    acc[k] = 0.f;
  }

  load_tap(m.sw, w, cc);
  for (int tap = 0; tap < 9; ++tap) {
    cp_async_wait_all();
    __syncthreads();  // tap's weights visible; previous tap's buffer free
    if (tap < 8) load_tap(m.sw + ((tap + 1) & 1) * cc, w + (size_t)(tap + 1) * cc, cc);
    const float* wt = m.sw + (tap & 1) * cc + co;
    const float* in = m.spad + ((tap / 3) * Wp + tap % 3) * C;
    for (int ci = 0; ci < C; ci += 4) {
      const float w0 = wt[(ci + 0) * C], w1 = wt[(ci + 1) * C];
      const float w2 = wt[(ci + 2) * C], w3 = wt[(ci + 3) * C];
#pragma unroll
      for (int k = 0; k < kMaxPix; ++k) {
        if (k < np) {
          const float4 v = *reinterpret_cast<const float4*>(in + base[k] + ci);
          acc[k] = fmaf(v.x, w0, acc[k]);
          acc[k] = fmaf(v.y, w1, acc[k]);
          acc[k] = fmaf(v.z, w2, acc[k]);
          acc[k] = fmaf(v.w, w3, acc[k]);
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kMaxPix; ++k) {
    const int p = pg + k * npg;
    if (k < np && p < hw) epi(p, co, acc[k]);
  }
}

// sx[p, co] = (conv3x3(spad, w) + bias[co]) + t * M[p, co].
__device__ __forceinline__ void conv3x3_to_sx(const Smem& m, const Shape& s,
                                              const float* __restrict__ w,
                                              const float* __restrict__ bias,
                                              const float* __restrict__ tmap, float t) {
  const int C = s.C;
  const float b = bias[threadIdx.x % C];
  conv3x3(m, s, w, [&](int p, int co, float acc) {
    m.sx[p * C + co] = (acc + b) + t * tmap[p * C + co];
  });
}

// f(t, sx) for one sample.  sx holds the input state and the caller has
// synchronised after writing it.  The result is handed to out(e, value) for
// e = threadIdx.x + j * kThreads, reading sx only at those e, so the caller
// may overwrite sx[e] at the same e without another barrier.
template <class Out>
__device__ void odefunc_eval(const Smem& m, const Shape& s, const Odefunc& p,
                             float t, Out out) {
  gn_stats(m, s, m.sx, m.smean, m.sinv);
  gn_relu_to_pad(m, s, m.sx, m.smean, m.sinv, p.n1s, p.n1b);
  __syncthreads();
  conv3x3_to_sx(m, s, p.w1, p.b1, p.m1, t);
  __syncthreads();
  gn_stats(m, s, m.sx, m.smean, m.sinv);
  gn_relu_to_pad(m, s, m.sx, m.smean, m.sinv, p.n2s, p.n2b);
  __syncthreads();
  conv3x3_to_sx(m, s, p.w2, p.b2, p.m2, t);
  __syncthreads();
  gn_stats(m, s, m.sx, m.smean, m.sinv);
  const int n = s.H * s.W * s.C;
  for (int e = threadIdx.x; e < n; e += kThreads) out(e, gn_value(m, s, p.n3s, p.n3b, e));
}

}  // namespace nodef

extern "C" const char* nodef_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
