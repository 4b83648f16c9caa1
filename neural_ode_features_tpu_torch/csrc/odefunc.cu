// Fused ODEfunc: f(t, h) for a batch, one CTA per sample (sm_90a).
//
// Replaces the TPU kernel neural_ode_features_tpu/kernels/odefunc_pallas.py
// (_odefunc_pallas -> _odefunc_kernel).  Wrapper and plain PyTorch version:
// kernels/odefunc.py.  The per-sample work is odefunc_eval in
// odefunc_common.cuh; at C = 64 to 512 (multiples of 32) on 7x7 and 6x6
// maps its two convs run on the tensor cores (3xTF32, f32-grade: wgmma3,
// Hopper's wgmma.mma_async, where wgmma_ok holds, 7x7x64 and 6x6x64 among
// those shapes; else mma.sync), at other shapes as f32 FFMA.  kWide, kXg:
// the build (odefunc_common.cuh wide_shape).  Where the state does not fit in shared memory beside the
// conv's working set (fit_layout: 7x7 from C = 320), the output tensor is
// the sample's state buffer: h is copied into it, f overwrites it.
//
// Two precisions (kPrec, odefunc_common.cuh): odefunc_forward is the f32
// kernel; odefunc_forward_bf16 computes compute_dtype='bfloat16' dynamics
// (kBf16: the plain bf16 path's roundings, both convs on the bf16 stage),
// from and to f32 tensors, with the same shapes, layouts and gate.
#include "odefunc_common.cuh"

namespace nodef {

template <bool kWide, bool kXg, int kPrec>
__global__ void __launch_bounds__(kThreads, min_blocks(kWide))
odefunc_kernel(const float* __restrict__ t, const float* __restrict__ h,
               Odefunc p, Shape s, float* __restrict__ out) {
  extern __shared__ float4 smem_raw[];
  const int n = s.H * s.W * s.C;
  const float* hb = h + (size_t)blockIdx.x * n;
  float* ob = out + (size_t)blockIdx.x * n;
  const Smem m = carve<kXg>(reinterpret_cast<float*>(smem_raw), s, ob);

  zero_pad(m, s);
  for (int e = threadIdx.x; e < n; e += kThreads)
    m.sx[e] = kPrec == kBf16 ? bf16_round(hb[e]) : hb[e];
  __syncthreads();
  odefunc_eval<kWide, kPrec>(m, s, p, t[blockIdx.x], [&](int e, float v) { ob[e] = v; });
}

template <int kPrec>
int launch(const float* t, const float* h, const Odefunc& p, float* out,
           int B, int H, int W, int C, int G, void* stream) {
  if (!shape_ok(H, W, C, G, kPrec == kF32) || B < 1) return (int)cudaErrorInvalidValue;
  const Shape s = make_shape(H, W, C, G, kPrec == kF32);
  const size_t smem = odefunc_smem_bytes(s);
  const auto kernel = !wide_shape(s) ? odefunc_kernel<false, false, kPrec>
                      : s.xg        ? odefunc_kernel<true, true, kPrec>
                                    : odefunc_kernel<true, false, kPrec>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(t, h, p, s, out);
  return (int)cudaGetLastError();
}

}  // namespace nodef

#define NODEF_ODEFUNC_ARGS                                                              \
  const float *t, const float *h, const float *n1s, const float *n1b, const float *w1,  \
      const float *b1, const float *m1, const float *n2s, const float *n2b,              \
      const float *w2, const float *b2, const float *m2, const float *n3s,               \
      const float *n3b, float *out, int B, int H, int W, int C, int G, void *stream

extern "C" int odefunc_forward(NODEF_ODEFUNC_ARGS) {
  const nodef::Odefunc p{n1s, n1b, w1, b1, m1, n2s, n2b, w2, b2, m2, n3s, n3b};
  return nodef::launch<nodef::kF32>(t, h, p, out, B, H, W, C, G, stream);
}

extern "C" int odefunc_forward_bf16(NODEF_ODEFUNC_ARGS) {
  const nodef::Odefunc p{n1s, n1b, w1, b1, m1, n2s, n2b, w2, b2, m2, n3s, n3b};
  return nodef::launch<nodef::kBf16>(t, h, p, out, B, H, W, C, G, stream);
}
