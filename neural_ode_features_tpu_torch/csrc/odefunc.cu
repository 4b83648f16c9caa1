// Fused ODEfunc: f(t, h) for a batch, one CTA per sample (sm_90a).
//
// Replaces the TPU kernel neural_ode_features_tpu/kernels/odefunc_pallas.py
// (_odefunc_pallas -> _odefunc_kernel).  Wrapper and plain PyTorch version:
// kernels/odefunc.py.  The per-sample work is odefunc_eval in
// odefunc_common.cuh.
#include "odefunc_common.cuh"

namespace nodef {

__global__ void __launch_bounds__(kThreads, 2)
odefunc_kernel(const float* __restrict__ t, const float* __restrict__ h,
               Odefunc p, Shape s, float* __restrict__ out) {
  extern __shared__ float4 smem_raw[];
  const Smem m = carve(reinterpret_cast<float*>(smem_raw), s);
  const int n = s.H * s.W * s.C;
  const float* hb = h + (size_t)blockIdx.x * n;
  float* ob = out + (size_t)blockIdx.x * n;

  zero_pad(m, s);
  for (int e = threadIdx.x; e < n; e += kThreads) m.sx[e] = hb[e];
  __syncthreads();
  odefunc_eval(m, s, p, t[blockIdx.x], [&](int e, float v) { ob[e] = v; });
}

}  // namespace nodef

extern "C" int odefunc_forward(
    const float* t, const float* h,
    const float* n1s, const float* n1b, const float* w1, const float* b1, const float* m1,
    const float* n2s, const float* n2b, const float* w2, const float* b2, const float* m2,
    const float* n3s, const float* n3b,
    float* out, int B, int H, int W, int C, int G, void* stream) {
  using namespace nodef;
  if (!shape_ok(H, W, C, G) || B < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = odefunc_smem_bytes(H, W, C, G);
  cudaError_t err = cudaFuncSetAttribute(
      odefunc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Odefunc p{n1s, n1b, w1, b1, m1, n2s, n2b, w2, b2, m2, n3s, n3b};
  const Shape s{H, W, C, G};
  odefunc_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(t, h, p, s, out);
  return (int)cudaGetLastError();
}
