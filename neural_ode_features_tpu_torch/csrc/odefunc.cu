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
// (kBf16: the plain bf16 path's roundings, both convs on the bf16 stage:
// wgmma_bf16, bf16 wgmma.mma_async, where wgmma_ok holds, else the bf16
// mma.sync pass), from and to f32 tensors, with the same shapes, layouts
// and gate.
//
// The rows build (rows_build_ok: the bf16 dynamics at the tensor-core
// shapes of C = 96 to 512, where one CTA per sample fills an SM and every
// CTA streams each conv's whole weights from L2): the same function as a
// fixed sequence of launches on the caller's stream, each conv one bf16
// GEMM over the rows of every sample (rows_conv.cuh):
//   rows_gn_relu_kernel   a slice of whole groups of a sample a CTA: h
//                         rounded, GN1 -> ReLU, the conv input as bf16 into
//                         scratch (exact: kBf16 rounded it);
//   rows_conv (w1)        its epilogue concat_out<kBf16>(acc, b1, t, M1)
//                         writes u1 (f32 holding bf16 values) into out;
//   rows_gn_relu_kernel   GN2 -> ReLU of u1 into the scratch;
//   rows_conv (w2)        u2 into out;
//   rows_gn_out_kernel    GN3 of u2, a slice a CTA: f, over out.
// The GroupNorms (rows_gn; it and the conv epilogue ConcatEpi live in
// rows_conv.cuh, which the bf16 backward's rows build shares) split a
// sample over rows_slices(G) CTAs, each holding the per-sample kernel's
// (pixel group, channel) slots for its channels, so that gn_stats' sums
// keep their order, and the convs sum in mma_bf16's order: the rows build
// gives the per-sample build's bits (odefunc_forward_bf16_cta, kept for
// measurement only).  A row's sums do not depend on its tile, so a row
// does not depend on its batch.  Scratch (the caller's, rows_scratch_bytes): the bf16 conv input
// and one conv's packed weights.
#include "odefunc_common.cuh"
#include "rows_conv.cuh"

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
  if (!shape_ok(H, W, C, G) || B < 1) return (int)cudaErrorInvalidValue;
  const Shape s = make_shape(H, W, C, G);
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

// relu(GN(x)) as bf16 bit patterns: the next conv's input (gn_relu_to_pad's
// values; NaN passes through).  A slice of whole groups a CTA (rows_conv.cuh
// rows_gn).
__global__ void rows_gn_relu_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                                    const float* __restrict__ bias, Shape s,
                                    uint16_t* __restrict__ xa) {
  const size_t n = (size_t)s.H * s.W * s.C;
  rows_gn(x, scale, bias, s, [&](int b, size_t e, float (&y)[4]) {
#pragma unroll
    for (int k = 0; k < 4; ++k) y[k] = y[k] < 0.f ? 0.f : y[k];
    *reinterpret_cast<uint2*>(xa + b * n + e) = bf16x4_bits(y);
  });
}

// GN3: f.  x may be out (rows_gn reads a slice whole before it writes it).
__global__ void rows_gn_out_kernel(const float* x, const float* __restrict__ scale,
                                   const float* __restrict__ bias, Shape s, float* out) {
  const size_t n = (size_t)s.H * s.W * s.C;
  rows_gn(x, scale, bias, s, [&](int b, size_t e, float (&y)[4]) {
    *reinterpret_cast<float4*>(out + b * n + e) = make_float4(y[0], y[1], y[2], y[3]);
  });
}

// The shapes of the rows build: the bf16 dynamics' tensor-core shapes past
// C = 64 (kernels/odefunc.py stage gives 'rows_bf16').
inline bool rows_build_ok(int H, int W, int C, int G) {
  return shape_ok(H, W, C, G) && wide_shape(make_shape(H, W, C, G));
}

int launch_rows(const float* t, const float* h, const Odefunc& p, float* out, int B, int H,
                int W, int C, int G, void* scratch, void* stream) {
  if (!scratch || !rows_ok(B, H, W, C)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Shape s = make_shape(H, W, C, G);
  const size_t gsm = rows_gn_smem_bytes(s);
  const int rows = B * H * W, sms = rows_sm_count();
  const int gb = B * rows_slices(G), gt = rows_slice_threads(G);  // a slice a CTA
  uint16_t* xa = static_cast<uint16_t*>(scratch);
  uint8_t* wp = static_cast<uint8_t*>(scratch) + rows_scratch_bytes(B, H, W, C, true) -
                rows_pack_bytes(true, C);
  const int tile = rows_tile_rows(rows, C, sms);
  cudaError_t err;
  err = cudaFuncSetAttribute(rows_gn_relu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)gsm);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rows_gn_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)gsm);
  if (err != cudaSuccess) return (int)err;
  const float* n_s[2] = {p.n1s, p.n2s};
  const float* n_b[2] = {p.n1b, p.n2b};
  const float* ws[2] = {p.w1, p.w2};
  const ConcatEpi epi[2] = {{p.b1, p.m1, t, out, H * W, C}, {p.b2, p.m2, t, out, H * W, C}};
  for (int k = 0; k < 2; ++k) {
    rows_gn_relu_kernel<<<gb, gt, gsm, st>>>(k ? out : h, n_s[k], n_b[k], s, xa);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int code = rows_conv<true>(xa, ws[k], wp, rows, H, W, C, tile, epi[k], st);
    if (code) return code;
  }
  rows_gn_out_kernel<<<gb, gt, gsm, st>>>(out, p.n3s, p.n3b, s, out);
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

// The bf16 dynamics: the rows build where rows_build_ok (scratch: at least
// rows_scratch_bytes with one tap a stage), else the per-sample kernel
// (scratch unused).
extern "C" int odefunc_forward_bf16(NODEF_ODEFUNC_ARGS, void* scratch) {
  const nodef::Odefunc p{n1s, n1b, w1, b1, m1, n2s, n2b, w2, b2, m2, n3s, n3b};
  if (nodef::rows_build_ok(H, W, C, G))
    return nodef::launch_rows(t, h, p, out, B, H, W, C, G, scratch, stream);
  return nodef::launch<nodef::kBf16>(t, h, p, out, B, H, W, C, G, stream);
}

// The per-sample bf16 kernel at every shape it takes, the rows build's
// shapes too: a reading for measurement (probes/timing_aids.py
// odefunc_cta_bf16), on no path.
extern "C" int odefunc_forward_bf16_cta(NODEF_ODEFUNC_ARGS) {
  const nodef::Odefunc p{n1s, n1b, w1, b1, m1, n2s, n2b, w2, b2, m2, n3s, n3b};
  return nodef::launch<nodef::kBf16>(t, h, p, out, B, H, W, C, G, stream);
}
