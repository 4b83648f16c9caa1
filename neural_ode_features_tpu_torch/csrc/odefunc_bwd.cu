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
//      maps TF32 products on the tensor cores with 3xTF32 error compensation
//      (f32-grade).  The forward recompute's two run the forward kernels'
//      own stage (wgmma3 where make_shape says so, so that f is
//      odefunc_forward's bit for bit); the input-gradient convs run
//      mma.sync at every such shape and read
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
//      r[b, p + off_k] (x) g[b, p], per (conv, tap) a GEMM with M = C_in,
//      N = C_out, K = the B*H*W rows, on the tensor cores (mma.sync
//      m16n8k8 TF32), as the TPU kernel runs it on its matrix unit (one
//      (9C x rows).(rows x C) product of its patch scratch).  The nine taps
//      of a conv read the same g rows and the same r rows shifted, so a CTA
//      stages each sample's r map once, with a zero border, and g's rows
//      once, and its warps take the taps: one row of three taps at
//      64 x 64 tiles (12 warps), all nine at 32 x 32 (C % 64 == 32; 9
//      warps), a 32 x 32 warp tile each, so no thread holds more than one
//      tap's accumulators.  Samples stream through two cp.async buffers,
//      the next sample's copy in flight while this one's products run (a
//      ring of three measured no faster, PERF.md).  The rows are cut into
//      ns chunks, the wrapper's choice (kernels/odefunc_bwd.py
//      weight_splits: 22 at B = 128, C = 64, 132 CTAs; 1 at C = 512, where
//      the tiles alone give 384), which also sizes the scratch wpart
//      (ns, 2, 9, C, C): 19 MB at C = 512 (151 MB with the FFMA kernel's
//      fixed 8).  f32: 3xTF32 products.  Each 32-row step of a
//      sample is summed from zero on the tensor core (whose accumulation
//      truncates), the steps of kGroupSamples samples in f32 in registers,
//      and those group sums in f32 in shared memory: a chunk of 128 samples
//      is then no chain of 256 adds (which took 7x7x512's dtheta error to
//      2.1x the FFMA kernel's; measured, PERF.md).  Every
//      shape the backward takes runs it (any H x W, C a multiple of 32 to
//      512): the tile, the taps per CTA and the staging follow from the
//      shape.
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
// By kernel (utils/flops.py bwd_kernel_work): the per-sample pass has four
// of the six convs (3.7 us of TF32, against 4.2 us of bytes), the weight
// gradients two (0.925 GFLOP, 1.9 us of TF32, against 2.0 us for reading
// r1, r2, gu, gv once and writing one (2, 9, C, C) result), the reduction
// only bytes (2.3 us): each bound by bytes.  The weight-gradient kernel
// runs at 13x its bound at 7x7x64 (PERF.md).  Its 22 chunks (6.5 MB, where
// the result is 0.3 MB) are this design's own traffic, another 1.9 us at
// HBM's rate; its bf16 build, a third of the products, takes 69% of its
// time, so the products do not bind it either: the likely limit is the
// fragments' shared-memory loads (one 8-byte load per two elements, each
// staged row read by every tap's warps).  The tap
// reuse keeps its staging to one copy of r and g per tap row (T = 64) or
// per conv (T = 32) and column tile.
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
// from launch to launch.  r1, r2, gu, gv hold bf16 values, which TF32 holds
// exactly, so the weight-gradient kernel's bf16 build (kExact) takes one
// TF32 pass of mma.sync per product, each product exact with f32
// accumulation (a bf16 m16n8k16 pass would form the same exact products but
// needs each register's two k rows packed from two loads: no fewer loads,
// more instructions).  Bound
// at B = 128, 7x7x64: the 2.77 GFLOP at 989 TFLOP/s dense bf16 is 2.8 us,
// the 6.4 MB 1.9 us: bound by operations.
#include "odefunc_common.cuh"

namespace nodef {

constexpr int kParts = 26;       // per-sample partial rows, see bwd_sample_kernel
constexpr int kStepRows = 32;    // weight-gradient rows summed from zero per step
constexpr int kGroupSamples = 8;  // samples whose steps are added up before the total
constexpr int kWeightPad = 8;    // floats added to a staged row of T channels

// The weight-gradient output tile (ci and co): 64, or 32 where C % 64 == 32;
// taps per CTA (T = 64: a row of three taps, 12 warps; T = 32: all nine, 9
// warps) and its warps.
inline int weight_tile(int C) { return C % 64 == 0 ? 64 : 32; }
__host__ __device__ constexpr int weight_taps_of(int T) { return T == 64 ? 3 : 9; }
__host__ __device__ constexpr int weight_warps(int T) {
  return weight_taps_of(T) * (T / 32) * (T / 32);
}

// Rows of g staged per sample: H*W, padded with zero rows to a multiple of 8.
__host__ __device__ inline int weight_rows(const Shape& s) { return (s.H * s.W + 7) & ~7; }

// Dynamic shared memory of bwd_weight_kernel: two buffers, each r's
// bordered map and g's rows, T + kWeightPad floats a row; then each
// thread's 32 group sums and the qrow table.
inline size_t weight_smem_bytes(const Shape& s) {
  const size_t rows = (size_t)(s.H + 2) * (s.W + 2) + weight_rows(s);
  const int t = weight_tile(s.C);
  return sizeof(float) * (2 * rows * (t + kWeightPad) + 32 * 32 * (size_t)weight_warps(t)) +
         sizeof(int) * weight_rows(s);
}

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

// The shape under the backward's layout: fit_layout with u.  f32: the
// kF32 build (its forward recompute runs wgmma3 where make_shape says so).
inline Shape bwd_shape(int H, int W, int C, int G, bool f32) {
  Shape s = make_shape(H, W, C, G, f32);
  s.xg = 0;
  s.ring = kRing;
  fit_layout(s, true, bwd_smem_bytes);
  return s;
}

inline bool bwd_shape_ok(int H, int W, int C, int G, bool f32) {
  const Shape s = bwd_shape(H, W, C, G, f32);
  return layout_ok(s) && C >= 32 && C % weight_tile(C) == 0 && bwd_smem_bytes(s) <= kMaxSmem &&
         weight_smem_bytes(s) <= kMaxSmem;
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

// wpart[split][conv][tap][ci][co] = sum over the split's samples b and
// pixels p of r[b, p + off_tap, ci] * g[b, p, co] (zero where the tap leaves
// the map): per (conv, tap) a GEMM with M = ci, N = co, K = rows (b, p), on
// the tensor cores (the head of this file).  One CTA per (conv, group of
// weight_taps_of(T) taps, split, ci tile, co tile) of T x T outputs per tap; warp
// w takes tap w / WPT and a 32 x 32 quarter (T = 64) or the whole (T = 32)
// of its tile: 2 m16 x 4 n8 mma tiles.  Per sample the CTA stages r's
// zero-bordered map ((H+2)*(W+2) rows of T channels) and g's H*W rows
// (padded with zero rows to a multiple of 8) into one of two buffers by
// cp.async, the next sample's copy in flight while this one's products
// run; a tap's A rows are the row qrow[k] + off_tap of the bordered map,
// qrow[k] = k + 2*(k / W) (0 for the zero rows beyond H*W).  Fragments: A
// row g / g + 8 of an m16 tile is ci 2g / 2g + 1 (one 8-byte load gives
// both), column n of the n8 tiles 2p and 2p + 1 is co 2n and 2n + 1 (one
// 8-byte load gives both); row pitch T + 8 floats, so that each load is
// free of bank conflicts where its four k rows are consecutive.  Each step
// of kStepRows rows of a sample is summed from zero on the tensor core and
// added to a running sum in f32 (registers), which every kGroupSamples
// samples is added to the thread's total in shared memory (tot): steps,
// samples and groups in order.
// kExact (the bf16 build): r and g hold bf16 values, which TF32 holds
// exactly, so one TF32 pass forms every product exactly; else 3xTF32
// (tail products first).
template <int T, bool kExact>
__global__ void __launch_bounds__(32 * weight_warps(T))
bwd_weight_kernel(const float* __restrict__ r1, const float* __restrict__ r2,
                  const float* __restrict__ gu, const float* __restrict__ gv, Shape s,
                  int B, int ns, float* __restrict__ wpart) {
  constexpr int NT = weight_taps_of(T), WPT = (T / 32) * (T / 32);
  constexpr int kThr = 32 * weight_warps(T), pitch = T + kWeightPad, kChunks = T / 4;
  extern __shared__ float4 wsmem[];
  const int C = s.C, H = s.H, W = s.W, hw = H * W, Wp = W + 2;
  const int nr = (H + 2) * Wp, nk = weight_rows(s);
  float* sbase = reinterpret_cast<float*>(wsmem);
  const int stage_floats = (nr + nk) * pitch;
  float* tot = sbase + 2 * stage_floats;  // [32][kThr]: each thread's group sums
  int* qrow = reinterpret_cast<int*>(tot + 32 * kThr);
  constexpr int ngrp = 9 / NT;
  const int conv = blockIdx.x / (ngrp * ns), grp = (blockIdx.x / ns) % ngrp;
  const int split = blockIdx.x % ns;
  const int ci0 = blockIdx.y * T, co0 = blockIdx.z * T;
  const float* r = conv == 0 ? r1 : r2;
  const float* g = conv == 0 ? gu : gv;
  const int b0 = (int)((long)B * split / ns), b1 = (int)((long)B * (split + 1) / ns);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int tap = grp * NT + warp / WPT, wt = warp % WPT;
  const int wci = (wt / (T / 32)) * 32, wco = (wt % (T / 32)) * 32;
  const int tapoff = (tap / 3) * Wp + tap % 3;

  for (int k = tid; k < nk; k += kThr) qrow[k] = k < hw ? k + 2 * div_magic(k, s.wmagic) : 0;
#pragma unroll
  for (int v = 0; v < 32; ++v) tot[v * kThr + tid] = 0.f;

  // Sample b's r map (bordered) and g rows into buffer buf, zero-filled
  // outside the map and beyond H*W.
  auto stage = [&](int b, int buf) {
    float* sr = sbase + buf * stage_floats;
    float* sg = sr + nr * pitch;
    const size_t row0 = (size_t)b * hw;
    for (int i = tid; i < nr * kChunks; i += kThr) {
      const int q = i / kChunks, c4 = (i % kChunks) * 4;
      const int py = div_magic(q, s.pmagic), y = py - 1, x = q - py * Wp - 1;
      const bool in = y >= 0 && y < H && x >= 0 && x < W;
      cp_async16_zfill(sr + q * pitch + c4,
                       in ? r + (row0 + y * W + x) * C + ci0 + c4 : r, in);
    }
    for (int i = tid; i < nk * kChunks; i += kThr) {
      const int k = i / kChunks, c4 = (i % kChunks) * 4;
      const bool in = k < hw;
      cp_async16_zfill(sg + k * pitch + c4, in ? g + (row0 + k) * C + co0 + c4 : g, in);
    }
    cp_async_commit();
  };

  float run[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) run[i][j][v] = 0.f;

  stage(b0, 0);
  for (int b = b0, buf = 0, in_group = 0; b < b1; ++b, buf ^= 1) {
    if (b + 1 < b1) {
      stage(b + 1, buf ^ 1);
      cp_async_wait_but_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // sample b visible (and qrow, the first time)
    const float* sr = sbase + buf * stage_floats;
    // Byte addresses of this thread's A element (ci wci + 2g, at the tap's
    // offset; add the row) and B element (k row tq, co wco + 2g).
    const uint32_t a_thread = smem_addr(sr + tapoff * pitch + wci + 2 * gq);
    const uint32_t b_thread = smem_addr(sr + (nr + tq) * pitch + wco + 2 * gq);
    for (int k0 = 0; k0 < nk; k0 += kStepRows) {
      float acc[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kStepRows; kk += 8) {
        const int k = k0 + kk;
        if (k >= nk) break;
        // B: k rows k + tq (register 0) and k + tq + 4 (register 1); the
        // n8 tiles 2p and 2p + 1 from one 8-byte load.
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 v = lds2(b_thread + 4u * ((k + 4 * h) * pitch + 16 * p));
            if (kExact) {
              bh[2 * p][h] = __float_as_uint(v.x);
              bh[2 * p + 1][h] = __float_as_uint(v.y);
            } else {
              tf32_split(v.x, bh[2 * p][h], bl[2 * p][h]);
              tf32_split(v.y, bh[2 * p + 1][h], bl[2 * p + 1][h]);
            }
          }
        const int qa = qrow[k + tq], qb = qrow[k + tq + 4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // A: rows g, g + 8 (ci 2g, 2g + 1) at k columns tq, tq + 4.
          const float2 u0 = lds2(a_thread + 4u * (qa * pitch + 16 * i));
          const float2 u1 = lds2(a_thread + 4u * (qb * pitch + 16 * i));
          const float av[4] = {u0.x, u0.y, u1.x, u1.y};
          uint32_t ah[4], al[4];
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            if (kExact) ah[v] = __float_as_uint(av[v]);
            else tf32_split(av[v], ah[v], al[v]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (!kExact) {
              mma_tf32(acc[i][j], al, bh[j]);
              mma_tf32(acc[i][j], ah, bl[j]);
            }
            mma_tf32(acc[i][j], ah, bh[j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) run[i][j][v] += acc[i][j][v];
    }
    // Every kGroupSamples samples (and at the split's end) the group's sum
    // goes to the thread's own slots of tot, and run starts again from zero.
    if (++in_group == kGroupSamples || b + 1 == b1) {
      in_group = 0;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            tot[((i * 4 + j) * 4 + v) * kThr + tid] += run[i][j][v];
            run[i][j][v] = 0.f;
          }
    }
    __syncthreads();  // every warp is done with buffer buf
  }

  // Accumulator (row g, columns 2t, 2t + 1) of n8 tile 2p + e is ci 2g, co
  // 16p + 4t + e and 16p + 4t + 2 + e; row g + 8 is ci 2g + 1.
  auto sum = [&](int i, int j, int v) { return tot[((i * 4 + j) * 4 + v) * kThr + tid]; };
  float* out = wpart + (((size_t)split * 2 + conv) * 9 + tap) * C * C;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int ci = ci0 + wci + 16 * i + 2 * gq + h, co = co0 + wco + 16 * p + 4 * tq;
        *reinterpret_cast<float4*>(out + (size_t)ci * C + co) =
            make_float4(sum(i, 2 * p, 2 * h), sum(i, 2 * p + 1, 2 * h),
                        sum(i, 2 * p, 2 * h + 1), sum(i, 2 * p + 1, 2 * h + 1));
      }
}

// dk1, dk2: (9, C+1, C) raw conv-kernel gradients (channel 0: time);
// dvec: (8, C) in the order of the partial rows 0..7.  kRound (the bf16
// build): each sum over the batch rounded once to bf16, as the plain bf16
// path's reductions over the batch round theirs, but the time channel's,
// which the plain path sums in f32 from per-pixel bf16 values.
template <bool kRound>
__global__ void bwd_reduce_kernel(const float* __restrict__ wpart,
                                  const float* __restrict__ part, Shape s, int B, int ns,
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
      for (int sp = 0; sp < ns; ++sp)
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
             int G, int ns, void* stream) {
  constexpr bool kF = kPrec == kF32;
  if (!bwd_shape_ok(H, W, C, G, kF) || B < 1 || ns < 1 || ns > B)
    return (int)cudaErrorInvalidValue;
  const Shape s = bwd_shape(H, W, C, G, kF);
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
  const auto weight = tile == 64 ? bwd_weight_kernel<64, kPrec == kBf16>
                                 : bwd_weight_kernel<32, kPrec == kBf16>;
  const size_t wsmem = weight_smem_bytes(s);
  if ((err = cudaFuncSetAttribute(weight, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)wsmem)) != cudaSuccess)
    return (int)err;
  const dim3 wgrid(2 * (9 / weight_taps_of(tile)) * ns, C / tile, C / tile);
  weight<<<wgrid, 32 * (tile == 64 ? weight_warps(64) : weight_warps(32)), wsmem, st>>>(
      r1, r2, gu, gv, s, B, ns, wpart);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int total = 2 * 9 * (C + 1) * C + 8 * C;
  bwd_reduce_kernel<kPrec == kBf16><<<(total + 255) / 256, 256, 0, st>>>(wpart, part, s, B, ns,
                                                                        dk1, dk2, dvec);
  return (int)cudaGetLastError();
}

}  // namespace nodef

// Scratch, allocated by the wrapper: r1, r2, gu, gv (B, H*W*C) each, part
// (B, 26, C), wpart (ns, 2, 9, C, C), and u (B, H*W*C) where bwd_shape's ug
// (else it may be null).  ns, the weight gradient's row chunks (1 to B),
// is the wrapper's choice (kernels/odefunc_bwd.py weight_splits), which
// sizes wpart by it.  w1bt, w2bt (the tap-flipped, transposed
// kernels) are read only by the FFMA stage and may be null where make_shape
// picks the tensor-core stage.  odefunc_backward_bf16 takes the same
// arguments and shapes.
#define NODEF_BACKWARD_ARGS                                                                 \
  const float *t, const float *h, const float *g, const float *n1s, const float *n1b,       \
      const float *w1, const float *b1, const float *m1, const float *n2s, const float *n2b, \
      const float *w2, const float *b2, const float *m2, const float *n3s, const float *n3b, \
      const float *w1bt, const float *w2bt, float *f, float *dh, float *dt, float *r1,       \
      float *r2, float *gu, float *gv, float *part, float *wpart, float *ug, float *dk1,     \
      float *dk2, float *dvec, int B, int H, int W, int C, int G, int ns, void *stream

extern "C" int odefunc_backward(NODEF_BACKWARD_ARGS) {
  const nodef::Odefunc p{n1s, n1b, w1, b1, m1, n2s, n2b, w2, b2, m2, n3s, n3b};
  return nodef::backward<nodef::kF32>(t, h, g, p, w1bt, w2bt, f, dh, dt, r1, r2, gu, gv, part,
                                      wpart, ug, dk1, dk2, dvec, B, H, W, C, G, ns,
                                      stream);
}

extern "C" int odefunc_backward_bf16(NODEF_BACKWARD_ARGS) {
  const nodef::Odefunc p{n1s, n1b, w1, b1, m1, n2s, n2b, w2, b2, m2, n3s, n3b};
  return nodef::backward<nodef::kBf16>(t, h, g, p, w1bt, w2bt, f, dh, dt, r1, r2, gu, gv, part,
                                       wpart, ug, dk1, dk2, dvec, B, H, W, C, G, ns,
                                       stream);
}
