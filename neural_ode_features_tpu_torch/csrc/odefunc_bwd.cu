// Fused ODEfunc backward (the VJP of f): (dtheta, dt, dh) for a batch
// (sm_90a).
//
// Replaces the TPU kernel neural_ode_features_tpu/kernels/odefunc_bwd_rows.py
// (odefunc_bwd_rows -> _bwd_rows_kernel).  Wrapper and plain PyTorch
// version: kernels/odefunc_bwd.py.
//
// The TPU kernel sums the parameter gradients over the batch by
// read-modify-write into output blocks that every grid step revisits; that
// is race-free only because a TPU grid runs in order.  CTAs run
// concurrently, so the work is split into three launches, with no atomics
// and every sum in a fixed order (two launches on the same inputs give
// bit-identical dtheta):
//
//   1. bwd_sample_kernel, one CTA per sample (512 threads): recompute the
//      forward (odefunc_common.cuh helpers: split ConcatConv, centred-variance
//      GroupNorm) and write f = GN3(v) itself, so that an augmented
//      evaluation of the adjoint needs no launch of odefunc.cu; then GN3
//      backward, conv2 input gradient (a 3x3 conv of the cotangent with the
//      tap-flipped, transposed weights), ReLU2 + GN2 backward, conv1 input
//      gradient, ReLU1 + GN1 backward.  Its four convs are the conv stage of
//      odefunc_common.cuh: at C = 64 to 512 (multiples of 32) on 7x7 and 6x6
//      maps mma.sync TF32 products with 3xTF32 error compensation
//      (f32-grade);
//      the input-gradient convs read
//      w1, w2 themselves, taps reversed and transposed in the fragment loads
//      (conv3x3_mma<3, true>).  Other shapes run the f32 FFMA conv3x3, the
//      input gradients on the wrapper's w1bt, w2bt.  Writes dh, the
//      per-sample dt = sum(gv*M2) + sum(gu*M1), the per-sample partial sums
//      of the GroupNorm scales/biases, conv biases and time-column kernels
//      (dWt[k] = t * sum of gv over the pixels where tap k is inside the
//      map: the tap-validity contraction), and the activations r1, r2 and
//      cotangents gu, gv that the weight gradients need.  The conv1 output
//      u (GN2's input) stays in shared memory where it fits; on the wide
//      stage from 7x7x256 it does not (the forward's working set is 194 KB
//      of the 227 there), and u goes to a global scratch (B, H*W*C) beside
//      r1 and r2, written and read back by the same CTA; from 7x7x288 the
//      state x goes to the dh output, which is written last, at the same
//      elements (fit_layout).
//   2. bwd_weight_kernel: dW[conv][k] (C x C per tap) = sum over (b, p) of
//      r[b, p + off_k] (x) g[b, p]; one CTA per (conv, tap, row chunk, ci
//      tile, co tile), a TILE x TILE output tile (64, or 32 where C % 64 ==
//      32) with a 4x4 register tile per thread.  At C = 512 its scratch
//      wpart is 151 MB, whatever B.  On the wide build's shapes each
//      32-row step is summed from zero and added to the running sum
//      (TWO_LEVEL): one chain over a chunk's B*H*W/8 rows (784 at B = 128,
//      7x7) drifts by up to 8.6e-4 from the f64 sum at 7x7x512, whose 4.7M
//      entries have more of the tail than 7x7x64's; the narrow shapes keep
//      one chain (their sums' order, and their time, unchanged).
//   3. bwd_reduce_kernel: one thread per output sums the row chunks and the
//      per-sample partials, and writes dtheta in the raw layout: conv kernels
//      (3, 3, C+1, C) with the time channel first, and the eight (C,) vectors.
//
// Bound (H100 SXM, 700 W; 3.35 TB/s): two forward convs, two input-gradient
// convs and two weight-gradient contractions are six 3x3-conv equivalents,
// 6 * 2*49*9*64*64 = 21.7 MFLOP per sample, 2.77 GFLOP at B = 128.  On the
// CUDA cores (67 TFLOP/s f32) that is about 41 us; on the tensor cores
// (495 TFLOP/s TF32, the operations counted once) 5.6 us, against 1.9 us for
// the 6.4 MB of h, g, f, dh and the weights: bound by operations either way.
// The weight-gradient contraction (bwd_weight_kernel) is still f32 FFMA.
//
// Two precisions (kPrec, odefunc_common.cuh).  odefunc_backward is the f32
// kernel.  odefunc_backward_bf16 is the VJP of compute_dtype='bfloat16'
// dynamics, with the same arguments, shapes, layouts and gate; its TPU
// counterpart is jax.vjp of the JAX jnp bf16 dynamics (the TPU kernel above
// has no bf16 mode), and its plain version autograd through the port's
// plain bf16 f (kernels/odefunc_bwd.py).  It recomputes the forward at
// odefunc_forward_bf16's rounding points (its f is that kernel's bit for
// bit) and takes the plain bf16 VJP's: the cotangent rounded on entry; in
// each GroupNorm the products dy*scale (per element, scale rounded) and,
// for dscale, dy*bf16(x-hat), the statistics backward in f32, dx rounded;
// the ReLU masks from the bf16 GroupNorm outputs; each input-gradient conv
// on the bf16 conv stage (mma.sync.m16n8k16, f32 accumulation; at the FFMA
// shapes f32 FFMA on rounded weights) and its sum rounded once; the
// time-map products g*bf16(M) and g*t rounded per element, each conv's t
// gradient rounded and their sum rounded.  Every sum over the batch (the
// weight, scale and bias gradients) stays f32 per sample and in the
// reduction's fixed order and is rounded once, in bwd_reduce_kernel, as the
// plain path rounds each of those sums once; dtheta stays bit-identical
// from launch to launch.  r1, r2, gu, gv hold bf16 values, so the FFMA
// weight-gradient products are exact and that kernel is shared.  Bound
// at B = 128, 7x7x64: the 2.77 GFLOP at 989 TFLOP/s dense bf16 is 2.8 us,
// the 6.4 MB 1.9 us: bound by operations.
#include "odefunc_common.cuh"

namespace nodef {

constexpr int kParts = 26;       // per-sample partial rows, see bwd_sample_kernel
constexpr int kRowTile = 32;     // rows staged per step in the weight-gradient CTA
constexpr int kSplit = 8;        // row chunks per (conv, tap)

// The weight-gradient output tile (ci and co): 64, or 32 where C is 32.
inline int weight_tile(int C) { return C % 64 == 0 ? 64 : 32; }

// Shared memory of bwd_sample_kernel: the forward's layout (carve), then
//   su    [H*W*C]   conv1 output u (GN2's input), unless s.ug
//   st    [6*G]     mean/inv of GN1, GN2, GN3
//   chan  [4*C]     per-channel sums and group means
// (the second partial-sum buffer is the second half of the forward's sred).
// kernels/odefunc_bwd.py (bwd_smem_bytes, u_global) mirrors these formulas.
inline size_t bwd_smem_bytes(const Shape& s) {
  return odefunc_smem_bytes(s) +
         sizeof(float) * (6 * (size_t)s.G + 4 * (size_t)s.C +
                          (s.ug ? 0 : (size_t)s.H * s.W * s.C));
}

// The shape under the backward's layout: fit_layout with u.
inline Shape bwd_shape(int H, int W, int C, int G) {
  Shape s = make_shape(H, W, C, G);
  s.xg = 0;
  s.ring = kRing;
  fit_layout(s, true, bwd_smem_bytes);
  return s;
}

inline bool bwd_shape_ok(int H, int W, int C, int G) {
  const Shape s = bwd_shape(H, W, C, G);
  return layout_ok(s) && C >= 32 && C % weight_tile(C) == 0 && bwd_smem_bytes(s) <= kMaxSmem;
}

// Normalised value x-hat at element e (channel c) of x, from gn_stats'
// mean/inv.  kBf16: x rounded to bf16 as it is read (the state h; the
// other GroupNorm inputs hold bf16 values already).
template <bool WIDE, int PREC = kF32>
__device__ __forceinline__ float gn_hat(const Shape& s, const float* x, const float* mean,
                                        const float* inv, int e, int c) {
  const int g = group_of<WIDE>(s, c);
  return ((PREC == kBf16 ? bf16_round(x[e]) : x[e]) - mean[g]) * inv[g];
}

// Whether GroupNorm's output y = GN(x) (scale, bias) at element e is
// positive: the ReLU mask, from the statistics the forward used and at its
// precision.
template <bool WIDE, int PREC>
__device__ __forceinline__ bool gn_positive(const Shape& s, const float* x, const float* mean,
                                            const float* inv, const float* __restrict__ scale,
                                            const float* __restrict__ bias, int e, int c) {
  if constexpr (PREC == kBf16) {
    const int g = group_of<WIDE>(s, c);
    return gn_affine<kBf16>(bf16_round(x[e]), mean[g], inv[g], scale[c], bias[c]) > 0.f;
  } else {
    return gn_hat<WIDE>(s, x, mean, inv, e, c) * scale[c] + bias[c] > 0.f;
  }
}

// Per-channel sums of a(e, c) and b(e, c) over the sample's pixels into
// chan[c] and chan[C + c]: per (pixel group, channel) in registers, then
// over the pixel groups in order.  Caller synchronises before; ends
// synchronised.
template <bool WIDE, class A, class Bf>
__device__ __forceinline__ void channel_sums(const Smem& m, float* sred2, float* chan,
                                             const Shape& s, A af, Bf bf) {
  const int tid = threadIdx.x, C = s.C;
  int pg, c;
  thread_slot<WIDE>(s, pg, c);
  const int npg = s.npg, hw = s.H * s.W;
  float a1 = 0.f, a2 = 0.f;
  if (!WIDE || pg < npg)
    for (int p = pg; p < hw; p += npg) {
      const int e = p * C + c;
      a1 = af(e, c, a1);
      a2 = bf(e, c, a2);
    }
  m.sred[tid] = a1;
  sred2[tid] = a2;
  __syncthreads();
  if (tid < C) {
    float s1 = 0.f, s2 = 0.f;
    for (int q = 0; q < npg; ++q) {
      s1 += m.sred[q * C + tid];
      s2 += sred2[q * C + tid];
    }
    chan[tid] = s1;
    chan[C + tid] = s2;
  }
  __syncthreads();
}

// GroupNorm backward for one sample.  x: the GN input, mean/inv: its
// statistics, dyf(e, c): the cotangent of the GN output at element e of
// channel c.  Writes dscale = sum_p dy * x-hat and dbias = sum_p dy (per
// channel), then hands
// dx = inv * (dy*scale - mean_g(dy*scale) - x-hat * mean_g(dy*scale*x-hat))
// to out(w, dx) at the thread's elements w (Walk).  kBf16, the plain bf16
// path's backward (autograd through bf16 ops, the statistics in f32): dy
// holds bf16 values; dscale sums the bf16 products dy * bf16(x-hat);
// dy*scale is rounded per element (scale rounded), so the group means take
// a second pass of sums; dx is rounded.  Caller synchronises before; ends
// unsynchronised.  Thread -> (channel, pixel group) as in gn_stats.
template <bool WIDE, int PREC, class Dy, class Out>
__device__ void gn_backward(const Smem& m, float* sred2, float* chan, const Shape& s,
                            const float* x, const float* mean, const float* inv,
                            const float* __restrict__ scale, Dy dyf,
                            float* dscale, float* dbias, Out out) {
  constexpr bool kB = PREC == kBf16;
  const int tid = threadIdx.x, C = s.C, hw = s.H * s.W, gs = s.gs;
  auto xhat = [&](int e, int c) { return gn_hat<WIDE, PREC>(s, x, mean, inv, e, c); };
  // dy * scale at the precision of the build.
  auto dys = [&](int e, int c) {
    return kB ? bf16_round(dyf(e, c) * bf16_round(scale[c])) : dyf(e, c) * scale[c];
  };
  channel_sums<WIDE>(
      m, sred2, chan, s,
      [&](int e, int c, float a) {
        const float dy = dyf(e, c), xh = xhat(e, c);
        return kB ? a + bf16_round(dy * bf16_round(xh)) : fmaf(dy, xh, a);
      },
      [&](int e, int c, float a) { return a + dyf(e, c); });
  if (tid < C) {
    dscale[tid] = chan[tid];
    dbias[tid] = chan[C + tid];
  }
  if constexpr (kB) {  // chan = per-channel sums of dy*scale*x-hat, dy*scale
    __syncthreads();
    channel_sums<WIDE>(
        m, sred2, chan, s, [&](int e, int c, float a) { return fmaf(dys(e, c), xhat(e, c), a); },
        [&](int e, int c, float a) { return a + dys(e, c); });
  }
  if (tid < s.G) {
    const float n = (float)(hw * gs);
    float s1 = 0.f, s2 = 0.f;
    for (int j = 0; j < gs; ++j) {
      const int cc = tid * gs + j;
      if (kB) {
        s1 += chan[cc];
        s2 += chan[C + cc];
      } else {
        s1 = fmaf(scale[cc], chan[cc], s1);
        s2 = fmaf(scale[cc], chan[C + cc], s2);
      }
    }
    chan[2 * C + tid] = s2 / n;  // mean_g(dy * scale)
    chan[3 * C + tid] = s1 / n;  // mean_g(dy * scale * x-hat)
  }
  __syncthreads();
  const int n = hw * C;
  if (!WIDE || s.cdiv) {  // every element lies in the channel tid % C
    const int cc = tid & (C - 1), g = group_of<WIDE>(s, cc);
    const float ig = inv[g], m1 = chan[2 * C + g], m2 = chan[3 * C + g];
    for (Walk<true> w(s); w.e < n; w.next(s)) {
      const float dx = ig * (dys(w.e, cc) - m1 - xhat(w.e, cc) * m2);
      out(w, kB ? bf16_round(dx) : dx);
    }
  } else {
    for (Walk<false> w(s); w.e < n; w.next(s)) {
      const int cc = w.c(s), g = div_magic(cc, s.gmagic);
      const float dx = inv[g] * (dys(w.e, cc) - chan[2 * C + g] - xhat(w.e, cc) * chan[3 * C + g]);
      out(w, kB ? bf16_round(dx) : dx);
    }
  }
}

// Bias, time-column and t gradients of one ConcatConv from its output
// cotangent, which lies in the spad interior (caller synchronised):
// db[c] = sum_p g, dwt[k*C + c] = t * sum of g over the pixels where tap k
// reads inside the map (the tap-validity contraction), and the returned
// sum_p,c g * M (valid in thread 0).  kBf16 (g, t bf16 values): the plain
// bf16 path's products g * bf16(M) and g * t rounded per element, and the
// returned sum rounded.  Ends synchronised.
template <bool WIDE, int PREC = kF32>
__device__ float conv_param_grads(const Smem& m, float* sred2, float* chan, const Shape& s,
                                  const float* __restrict__ tmap, float t, float* db,
                                  float* dwt) {
  const int tid = threadIdx.x, C = s.C;
  int pg, c;
  thread_slot<WIDE>(s, pg, c);
  const int npg = s.npg, hw = s.H * s.W, Wp = s.W + 2;
  float a1 = 0.f, a2 = 0.f;
  if (!WIDE || pg < npg)
    for (int p = pg; p < hw; p += npg) {
      const float v = m.spad[pad_at(s, p, c)];
      a1 += v;
      a2 = PREC == kBf16 ? a2 + bf16_round(v * bf16_round(tmap[p * C + c]))
                         : fmaf(v, tmap[p * C + c], a2);
    }
  m.sred[tid] = a1;
  sred2[tid] = a2;
  for (int e = tid; e < 9 * C; e += kThreads) {
    const int k = WIDE ? div_magic(e, s.cmagic) : e >> s.lc, cc = e - k * C;
    const int ky = k / 3, kx = k % 3;
    const int y0 = max(0, 1 - ky), y1 = min(s.H, s.H + 1 - ky);
    const int x0 = max(0, 1 - kx), x1 = min(s.W, s.W + 1 - kx);
    float acc = 0.f;
    for (int y = y0; y < y1; ++y)
      for (int x = x0; x < x1; ++x) {
        const float v = m.spad[((y + 1) * Wp + x + 1) * s.P + cc];
        acc += PREC == kBf16 ? bf16_round(v * t) : v;
      }
    dwt[e] = PREC == kBf16 ? acc : t * acc;
  }
  __syncthreads();
  if (tid < C) {
    float s1 = 0.f, s2 = 0.f;
    for (int q = 0; q < npg; ++q) {
      s1 += m.sred[q * C + tid];
      s2 += sred2[q * C + tid];
    }
    db[tid] = s1;
    chan[tid] = s2;
  }
  __syncthreads();
  float dt = 0.f;
  if (tid == 0)
    for (int cc = 0; cc < C; ++cc) dt += chan[cc];
  __syncthreads();
  return PREC == kBf16 ? bf16_round(dt) : dt;
}

// Per-sample partial rows (kParts x C): 0 dn1s, 1 dn1b, 2 dn2s, 3 dn2b,
// 4 dn3s, 5 dn3b, 6 db1, 7 db2, 8..16 dwt1 (tap-major), 17..25 dwt2.
// kWide, kXg: the build (odefunc_common.cuh wide_shape); in the wide ones u
// lives in the global scratch ug where s.ug, and with kXg the state x in dh
// (dh is written last, by the thread that reads x at the same element).
// kPrec: kF32, or kBf16 for the VJP of the bf16 dynamics (the head of this
// file).
template <bool kWide, bool kXg, int kPrec>
__global__ void __launch_bounds__(kThreads, min_blocks(kWide))
bwd_sample_kernel(const float* __restrict__ t, const float* __restrict__ h,
                  const float* __restrict__ g, Odefunc p,
                  const float* __restrict__ w1bt, const float* __restrict__ w2bt, Shape s,
                  float* __restrict__ fout, float* __restrict__ dh,
                  float* __restrict__ dt, float* __restrict__ r1, float* __restrict__ r2,
                  float* __restrict__ gu, float* __restrict__ gv,
                  float* __restrict__ part, float* __restrict__ ug) {
  constexpr bool kB = kPrec == kBf16;
  extern __shared__ float4 smem_raw[];
  const int C = s.C, G = s.G, n = s.H * s.W * C, tid = threadIdx.x;
  const size_t off = (size_t)blockIdx.x * n;
  const Smem m = carve<kXg>(reinterpret_cast<float*>(smem_raw), s, dh + off);
  const bool ug_on = kWide && s.ug;
  float* su = ug_on ? ug + off : m.sinv + G;
  float* sred2 = m.sred + kThreads;
  float* st = ug_on ? m.sinv + G : su + n;
  float* chan = st + 6 * G;
  const float tb = kB ? bf16_round(t[blockIdx.x]) : t[blockIdx.x];
  const float* hb = h + off;
  const float* gb = g + off;
  float* pb = part + (size_t)blockIdx.x * kParts * C;
  float *mean1 = st, *inv1 = st + G, *mean2 = st + 2 * G, *inv2 = st + 3 * G;
  float *mean3 = st + 4 * G, *inv3 = st + 5 * G;

  // Forward recompute: r1 = relu(GN1(h)), u = conv1(r1), r2 = relu(GN2(u)),
  // v = conv2(r2) in sx, f = GN3(v); kBf16 at odefunc_eval's rounding
  // points, so that f is odefunc_forward_bf16's bit for bit.
  zero_pad(m, s);
  for (int e = tid; e < n; e += kThreads) m.sx[e] = kB ? bf16_round(hb[e]) : hb[e];
  __syncthreads();
  // The GN statistics go to st (gn_apply reads them there where C does not
  // divide kThreads), the relu(GN(.)) into the spad interior.
  auto relu_to_pad = [&](const auto& w, float v) {
    m.spad[pad_at(s, w.q(s), w.c(s))] = v < 0.f ? 0.f : v;
  };
  Stat stat = gn_stats<kWide>(m, s, m.sx, mean1, inv1);
  gn_apply<kWide, kPrec>(s, stat, mean1, inv1, p.n1s, p.n1b, m.sx, relu_to_pad);
  __syncthreads();
  each_element<kWide>(s, [&](const auto& w) { r1[off + w.e] = m.spad[pad_at(s, w.q(s), w.c(s))]; });
  conv_stage<kWide, kPrec>(m, s, p.w1, [&](int q, int co, float acc) {
    if constexpr (kB)
      su[q * C + co] = bf16_round(bf16_round(bf16_round(acc) + bf16_round(p.b1[co])) +
                                  bf16_round(tb * bf16_round(p.m1[q * C + co])));
    else
      su[q * C + co] = (acc + p.b1[co]) + tb * p.m1[q * C + co];
  });
  __syncthreads();
  stat = gn_stats<kWide>(m, s, su, mean2, inv2);
  gn_apply<kWide, kPrec>(s, stat, mean2, inv2, p.n2s, p.n2b, su, relu_to_pad);
  __syncthreads();
  each_element<kWide>(s, [&](const auto& w) { r2[off + w.e] = m.spad[pad_at(s, w.q(s), w.c(s))]; });
  conv3x3_to_sx<kWide, kPrec>(m, s, p.w2, p.b2, p.m2, tb);
  __syncthreads();
  stat = gn_stats<kWide>(m, s, m.sx, mean3, inv3);
  gn_apply<kWide, kPrec>(s, stat, mean3, inv3, p.n3s, p.n3b, m.sx,
                         [&](const auto& w, float v) { fout[off + w.e] = v; });
  __syncthreads();  // mean3, inv3 visible

  // An input-gradient conv's sum into sx: kBf16 rounds it (the bf16 conv's
  // one rounding) for the ReLU mask and the GroupNorm backward that read it.
  auto to_sx = [&](int q, int ci, float acc) { m.sx[q * C + ci] = kB ? bf16_round(acc) : acc; };

  // GN3: gv = dL/dv into gv and the spad interior (the border stays zero);
  // kBf16 takes the cotangent rounded, as the backward of f's cast to f32.
  gn_backward<kWide, kPrec>(m, sred2, chan, s, m.sx, mean3, inv3, p.n3s,
                            [&](int e, int) { return kB ? bf16_round(gb[e]) : gb[e]; },
                            pb + 4 * C, pb + 5 * C,
                            [&](const auto& w, float v) {
                              gv[off + w.e] = v;
                              m.spad[pad_at(s, w.q(s), w.c(s))] = v;
                            });
  __syncthreads();
  float dt_acc =
      conv_param_grads<kWide, kPrec>(m, sred2, chan, s, p.m2, tb, pb + 7 * C, pb + 17 * C);

  // conv2 input gradient: sx = conv3x3(pad(gv), w2bt).
  if (s.mma) mma_stage<kB ? kPassBf16 : 3, true, kWide>(m, s, p.w2, to_sx);
  else conv3x3<kB>(m, s, w2bt, to_sx);
  __syncthreads();

  // ReLU2 + GN2: gu = dL/du.
  gn_backward<kWide, kPrec>(m, sred2, chan, s, su, mean2, inv2, p.n2s,
                            [&](int e, int c) {
                              return gn_positive<kWide, kPrec>(s, su, mean2, inv2, p.n2s,
                                                               p.n2b, e, c)
                                         ? m.sx[e]
                                         : 0.f;
                            },
                            pb + 2 * C, pb + 3 * C,
                            [&](const auto& w, float v) {
                              gu[off + w.e] = v;
                              m.spad[pad_at(s, w.q(s), w.c(s))] = v;
                            });
  __syncthreads();
  const float dt1 =
      conv_param_grads<kWide, kPrec>(m, sred2, chan, s, p.m1, tb, pb + 6 * C, pb + 8 * C);
  dt_acc = kB ? bf16_round(dt_acc + dt1) : dt_acc + dt1;

  // conv1 input gradient: sx = conv3x3(pad(gu), w1bt).
  if (s.mma) mma_stage<kB ? kPassBf16 : 3, true, kWide>(m, s, p.w1, to_sx);
  else conv3x3<kB>(m, s, w1bt, to_sx);
  __syncthreads();

  // ReLU1 + GN1: dh.
  gn_backward<kWide, kPrec>(m, sred2, chan, s, hb, mean1, inv1, p.n1s,
                            [&](int e, int c) {
                              return gn_positive<kWide, kPrec>(s, hb, mean1, inv1, p.n1s,
                                                               p.n1b, e, c)
                                         ? m.sx[e]
                                         : 0.f;
                            },
                            pb, pb + C, [&](const auto& w, float v) { dh[off + w.e] = v; });
  if (tid == 0) dt[blockIdx.x] = dt_acc;
}

// wpart[split][conv][tap][ci][co] = sum over the split's rows (b, p) of
// r[b, p + off_tap, ci] * g[b, p, co] (zero where the tap leaves the map).
// (TILE / 4)^2 threads, each a 4x4 register tile of the TILE x TILE block.
// TWO_LEVEL: the rows in steps of kRowTile, each step's sum from zero.
template <int TILE, bool TWO_LEVEL>
__global__ void __launch_bounds__((TILE / 4) * (TILE / 4))
bwd_weight_kernel(const float* __restrict__ r1, const float* __restrict__ r2,
                  const float* __restrict__ gu, const float* __restrict__ gv, Shape s,
                  int B, float* __restrict__ wpart) {
  constexpr int kQ = TILE / 4, kRedThreads = kQ * kQ;
  __shared__ float4 sr[kRowTile][kQ];
  __shared__ float4 sg[kRowTile][kQ];
  const int conv = blockIdx.x / (9 * kSplit), tap = (blockIdx.x / kSplit) % 9;
  const int split = blockIdx.x % kSplit, C = s.C;
  const int ci0 = blockIdx.y * TILE, co0 = blockIdx.z * TILE;
  const float* r = conv == 0 ? r1 : r2;
  const float* g = conv == 0 ? gu : gv;
  const int hw = s.H * s.W, dy = tap / 3 - 1, dx = tap % 3 - 1;
  const long nrows = (long)B * hw;
  const long lo = nrows * split / kSplit, hi = nrows * (split + 1) / kSplit;
  const int tid = threadIdx.x, tci = tid / kQ, tco = tid % kQ;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long row0 = lo; row0 < hi; row0 += kRowTile) {
    for (int i = tid; i < kRowTile * kQ; i += kRedThreads) {
      const int rr = i / kQ, q = i % kQ;
      const long row = row0 + rr;
      float4 vr = make_float4(0.f, 0.f, 0.f, 0.f), vg = vr;
      if (row < hi) {
        const long b = row / hw;
        const int pix = (int)(row % hw), y = pix / s.W + dy, x = pix % s.W + dx;
        vg = *reinterpret_cast<const float4*>(g + row * C + co0 + 4 * q);
        if (y >= 0 && y < s.H && x >= 0 && x < s.W)
          vr = *reinterpret_cast<const float4*>(r + ((b * hw + y * s.W + x) * C) + ci0 + 4 * q);
      }
      sr[rr][q] = vr;
      sg[rr][q] = vg;
    }
    __syncthreads();
    auto rows = [&](float (&sum)[4][4]) {
#pragma unroll 4
      for (int rr = 0; rr < kRowTile; ++rr) {
        const float4 a = sr[rr][tci], b = sg[rr][tco];
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sum[i][j] = fmaf(av[i], bv[j], sum[i][j]);
      }
    };
    if (TWO_LEVEL) {
      float step[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) step[i][j] = 0.f;
      rows(step);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += step[i][j];
    } else {
      rows(acc);
    }
    __syncthreads();
  }

  float* out = wpart + (((size_t)split * 2 + conv) * 9 + tap) * C * C;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = ci0 + 4 * tci + i;
    *reinterpret_cast<float4*>(out + (size_t)ci * C + co0 + 4 * tco) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// dk1, dk2: (9, C+1, C) raw conv-kernel gradients (channel 0: time);
// dvec: (8, C) in the order of the partial rows 0..7.  kRound (the bf16
// build): each sum over the batch rounded once to bf16, as the plain bf16
// path's reductions over the batch round theirs, but the time channel's,
// which the plain path sums in f32 from per-pixel bf16 values.
template <bool kRound>
__global__ void bwd_reduce_kernel(const float* __restrict__ wpart,
                                  const float* __restrict__ part, Shape s, int B,
                                  float* __restrict__ dk1, float* __restrict__ dk2,
                                  float* __restrict__ dvec) {
  const int C = s.C, nk = 9 * (C + 1) * C;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.f;
  if (idx < 2 * nk) {
    const int conv = idx / nk, rem = idx % nk;
    const int tap = rem / ((C + 1) * C), row = (rem / C) % (C + 1), co = rem % C;
    if (row == 0) {
      for (int b = 0; b < B; ++b) acc += part[((size_t)b * kParts + 8 + 9 * conv + tap) * C + co];
    } else {
      for (int sp = 0; sp < kSplit; ++sp)
        acc += wpart[((((size_t)sp * 2 + conv) * 9 + tap) * C + row - 1) * C + co];
      if (kRound) acc = bf16_round(acc);
    }
    (conv == 0 ? dk1 : dk2)[rem] = acc;
  } else if (idx < 2 * nk + 8 * C) {
    const int j = idx - 2 * nk;
    for (int b = 0; b < B; ++b) acc += part[(size_t)b * kParts * C + j];
    dvec[j] = kRound ? bf16_round(acc) : acc;
  }
}

template <int kPrec>
int backward(const float* t, const float* h, const float* g, const Odefunc& p,
             const float* w1bt, const float* w2bt, float* f, float* dh, float* dt,
             float* r1, float* r2, float* gu, float* gv, float* part, float* wpart,
             float* ug, float* dk1, float* dk2, float* dvec, int B, int H, int W, int C,
             int G, void* stream) {
  if (!bwd_shape_ok(H, W, C, G) || B < 1) return (int)cudaErrorInvalidValue;
  const Shape s = bwd_shape(H, W, C, G);
  if (!s.mma && (w1bt == nullptr || w2bt == nullptr)) return (int)cudaErrorInvalidValue;
  if (s.ug && ug == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes(s);
  const auto sample = !wide_shape(s) ? bwd_sample_kernel<false, false, kPrec>
                      : s.xg        ? bwd_sample_kernel<true, true, kPrec>
                                    : bwd_sample_kernel<true, false, kPrec>;
  cudaError_t err =
      cudaFuncSetAttribute(sample, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sample<<<B, kThreads, smem, st>>>(t, h, g, p, w1bt, w2bt, s, f, dh, dt, r1, r2, gu, gv,
                                    part, s.ug ? ug : nullptr);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int tile = weight_tile(C);
  const dim3 wgrid(2 * 9 * kSplit, C / tile, C / tile);
  const bool two = wide_shape(s);
  if (tile == 64)
    (two ? bwd_weight_kernel<64, true> : bwd_weight_kernel<64, false>)
        <<<wgrid, 16 * 16, 0, st>>>(r1, r2, gu, gv, s, B, wpart);
  else
    (two ? bwd_weight_kernel<32, true> : bwd_weight_kernel<32, false>)
        <<<wgrid, 8 * 8, 0, st>>>(r1, r2, gu, gv, s, B, wpart);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int total = 2 * 9 * (C + 1) * C + 8 * C;
  bwd_reduce_kernel<kPrec == kBf16><<<(total + 255) / 256, 256, 0, st>>>(wpart, part, s, B,
                                                                        dk1, dk2, dvec);
  return (int)cudaGetLastError();
}

}  // namespace nodef

// Scratch, allocated by the wrapper: r1, r2, gu, gv (B, H*W*C) each, part
// (B, 26, C), wpart (8, 2, 9, C, C), and u (B, H*W*C) where bwd_shape's ug
// (else it may be null).  w1bt, w2bt (the tap-flipped, transposed
// kernels) are read only by the FFMA stage and may be null where make_shape
// picks the tensor-core stage.  odefunc_backward_bf16 takes the same
// arguments and shapes.
#define NODEF_BACKWARD_ARGS                                                                 \
  const float *t, const float *h, const float *g, const float *n1s, const float *n1b,       \
      const float *w1, const float *b1, const float *m1, const float *n2s, const float *n2b, \
      const float *w2, const float *b2, const float *m2, const float *n3s, const float *n3b, \
      const float *w1bt, const float *w2bt, float *f, float *dh, float *dt, float *r1,       \
      float *r2, float *gu, float *gv, float *part, float *wpart, float *ug, float *dk1,     \
      float *dk2, float *dvec, int B, int H, int W, int C, int G, void *stream

extern "C" int odefunc_backward(NODEF_BACKWARD_ARGS) {
  const nodef::Odefunc p{n1s, n1b, w1, b1, m1, n2s, n2b, w2, b2, m2, n3s, n3b};
  return nodef::backward<nodef::kF32>(t, h, g, p, w1bt, w2bt, f, dh, dt, r1, r2, gu, gv, part,
                                      wpart, ug, dk1, dk2, dvec, B, H, W, C, G, stream);
}

extern "C" int odefunc_backward_bf16(NODEF_BACKWARD_ARGS) {
  const nodef::Odefunc p{n1s, n1b, w1, b1, m1, n2s, n2b, w2, b2, m2, n3s, n3b};
  return nodef::backward<nodef::kBf16>(t, h, g, p, w1bt, w2bt, f, dh, dt, r1, r2, gu, gv, part,
                                       wpart, ug, dk1, dk2, dvec, B, H, W, C, G, stream);
}
