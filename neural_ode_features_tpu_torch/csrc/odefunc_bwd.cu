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
//   1. bwd_sample_kernel, one CTA per sample (512 threads), or, at C = 64
//      with an even group count (pair_ok: 7x7x64, 6x6x64; both builds),
//      bwd_sample_kernel_cluster, two CTAs of 256 threads per sample with
//      the same sums in the same order (its note below): recompute the
//      forward (odefunc_common.cuh helpers: split ConcatConv, centred-variance
//      GroupNorm) and write f = GN3(v) itself, so that an augmented
//      evaluation of the adjoint needs no launch of odefunc.cu; then GN3
//      backward, conv2 input gradient (a 3x3 conv of the cotangent with the
//      tap-flipped, transposed weights), ReLU2 + GN2 backward, conv1 input
//      gradient, ReLU1 + GN1 backward.  Its four convs are the conv stage of
//      odefunc_common.cuh: at C = 64 to 512 (multiples of 32) on 7x7 and 6x6
//      maps TF32 products on the tensor cores with 3xTF32 error compensation
//      (f32-grade).  The forward recompute's two run the forward kernels'
//      own stage (wgmma3, wgmma_bf16 where make_shape says so, so that f is
//      the forward kernel's bit for bit); the input-gradient convs run
//      mma.sync at every such shape (the cluster pass: wgmma) and read
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
//      N = C_out, K = the B*H*W rows, on the tensor cores, as the TPU kernel
//      runs it on its matrix unit (one (9C x rows).(rows x C) product of its
//      patch scratch).  The nine taps of a conv read the same g rows and the
//      same r rows shifted, so a CTA stages each sample's r map once, with a
//      zero border, and g's rows once, and its warps take the taps.  Where
//      C % 64 == 0 (wgmma_weights) it runs on Hopper's warpgroup products:
//      chains of wgmma.mma_async.m64n64k8 TF32, A (r) from registers, B (g,
//      staged transposed: TF32 takes B K-major only) from shared memory,
//      three warpgroups a CTA, one tap each of a row of three, 64 x 64
//      tiles (its note below).  Elsewhere (C = 32, C % 64 == 32) it is
//      bwd_weight_kernel_mma (mma.sync m16n8k8 TF32): one row of three taps
//      at 64 x 64 tiles (12 warps) or all nine at 32 x 32 (9 warps), a
//      32 x 32 warp tile each; at C % 64 == 32 its 32 x 32 tiles waste
//      nothing and it was the faster (7x7x96: 0.071 ms f32, 0.042 bf16,
//      against 0.108 and 0.080 on wgmma).  Both kernels sum every output in
//      one order, so they give the same bits (a wgmma TF32 chain gives
//      mma.sync's, PERF.md).  Samples stream through two buffers, the next
//      sample's copy in flight while this one's products run.  The rows are
//      cut into ns chunks, the wrapper's choice (kernels/odefunc_bwd.py
//      weight_splits, over the mma.sync kernel's grid: 22 at B = 128,
//      C = 64, 132 CTAs; 1 at C = 512, where the tiles alone give 384),
//      which also sizes the scratch wpart (ns, 2, 9, C, C): 19 MB at
//      C = 512 (151 MB with the FFMA kernel's fixed 8).  f32: 3xTF32
//      products.  Each 32-row step of a sample is summed from zero on the
//      tensor core (whose accumulation truncates), the steps of
//      kGroupSamples samples in f32 in registers, and those group sums in
//      f32 in shared memory: a chunk of 128 samples is then no chain of 256
//      adds (which took 7x7x512's dtheta error to 2.1x the FFMA kernel's;
//      measured, PERF.md).  Every shape the backward takes runs one of the
//      two (any H x W, C a multiple of 32 to 512).
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
// runs at 10.6x its bound at 7x7x64 on wgmma (13x on mma.sync; PERF.md).
// Its 22 chunks (6.5 MB, where the result is 0.3 MB) are this design's own
// traffic, another 1.9 us at HBM's rate.  At 7x7x512 (bwd_weight_kernel,
// PERF.md) its staging alone, the products taken out, reads 0.54-0.56 ms:
// the 384 CTAs' 64-channel tiles read the residuals from L2 24 times over
// (1.2 GB); its loop without the copies 0.42 ms (bf16) and 0.71 (f32), the
// f32 build's three times the products adding less than the bf16 loop's
// own time: a sample's fixed part (barrier, fragment loads, the chains'
// latency), not the products, binds it.  The tap reuse keeps
// the staging to one copy of r and g per tap row (or, on mma.sync at
// T = 32, per conv) and tile.
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
// on the bf16 conv stage (mma.sync.m16n8k16, f32 accumulation; the cluster
// pass: wgmma_bf16; at the FFMA shapes f32 FFMA on rounded weights) and its
// sum rounded once; the
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
//
// The rows backward (rows_bwd_ok: the bf16 build at the tensor-core shapes
// of C = 96 to 512, 7x7 and 6x6 maps).  There one CTA per sample fills an
// SM and streams all four convs' whole weights from L2 into every sample's
// CTA, on the per-sample mma.sync stage.  In its place the per-sample pass
// is a fixed sequence of launches on the caller's stream (launch_rows_bwd),
// each conv one bf16 GEMM over the rows of every sample (rows_conv.cuh),
// the per-sample work between them in GroupNorm launches that split each
// sample over rows_slices(G) CTAs, a slice of whole groups each (the
// rows_conv.cuh note): a slice's CTA holds bwd_sample_kernel's (pixel
// group, channel) slots for its channels and adds in its order (gn_stats,
// channel_sums, gn_backward, conv_param_grads), each sample's slice staged
// into shared memory first:
//   rows_bwd_gn_relu_kernel  h rounded, GN1 -> ReLU: r1, the conv input as
//                            bf16, GN1's statistics (scratch);
//   rows_conv (w1)           u = concat_out<kBf16> (ConcatEpi) into ug
//                            (one epilogue type for the four convs,
//                            RowsBwdEpi);
//   rows_bwd_gn_relu_kernel  GN2 -> ReLU of u: r2, conv input, statistics;
//   rows_conv (w2)           v into dh (dh is written last);
//   rows_bwd_gv_kernel       GN3 of v: f; its backward under the rounded
//                            cotangent: gv (and as bf16 the next conv's
//                            input), conv2's parameter partials and the t
//                            gradient's per-channel sums (scratch);
//   rows_conv (w2, kTrans)   the conv2 input gradient, each sum rounded
//                            once (the pass's to_sx), into dh;
//   rows_bwd_gu_kernel       ReLU2 + GN2 backward: gu, conv1's partials and
//                            t sums; dt = conv2's t gradient, its sums
//                            added over the channels in order;
//   rows_conv (w1, kTrans)   the conv1 input gradient into dh;
//   rows_bwd_dh_kernel       ReLU1 + GN1 backward: dh (a slice staged whole
//                            before it is written over); dt = bf16(dt +
//                            conv1's t gradient);
// then bwd_weight_kernel and bwd_reduce_kernel as the other passes run
// them.  The convs sum in mma_bf16's order (the transposed packing reads
// tap 8 - k's tile transposed, as conv3x3_mma<kPassBf16, true> does), so
// every output is bwd_sample_kernel<..., kBf16>'s bit for bit; that pass
// stays readable as odefunc_backward_bf16_cta (measurement only).  No
// atomics: two launches give the same bits, and a row's sums do not depend
// on its tile or its batch.  Scratch (the wrapper's,
// rows_bwd_scratch_bytes): the bf16 conv input, one conv's packed weights,
// reused by the four convs in turn, GN1's and GN2's statistics and the two
// convs' per-channel t sums; u takes ug.  Bound at B = 128, 7x7x512
// (utils/flops.py bwd_kernel_bounds at 989 TFLOP/s dense bf16): the four
// convs are 4 * 2*49*9*512^2 * 128 = 59.2 GFLOP, 0.060 ms, against the
// 25.7 MB of h, g, f, dh, r1, r2, gu, gv and the weights, 0.008 ms: bound
// by operations; the GroupNorm launches alone by their 214 MB, 0.064 ms
// (rows_sample_bounds).
#include "odefunc_common.cuh"
#include "rows_conv.cuh"

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

// Dynamic shared memory of bwd_weight_kernel_mma: two buffers, each r's
// bordered map and g's rows, T + kWeightPad floats a row; then each
// thread's 32 group sums and the qrow table.
inline size_t mma_weight_smem_bytes(const Shape& s) {
  const size_t rows = (size_t)(s.H + 2) * (s.W + 2) + weight_rows(s);
  const int t = weight_tile(s.C);
  return sizeof(float) * (2 * rows * (t + kWeightPad) + 32 * 32 * (size_t)weight_warps(t)) +
         sizeof(int) * weight_rows(s);
}

// bwd_weight_kernel (wgmma): a CTA of three warpgroups, one tap each of a
// row of three, on a 64 x 64 (ci, co) tile; a staged r row is 64 +
// kWeightPad floats.  g's rows are staged transposed, one tile of TF32
// core matrices (8 co x 4 k, 128 bytes) a buffer (kExact) or a head and a
// tail tile (3xTF32): 8 groups of 8 co, each nk/4 core matrices along k
// and 16 bytes of padding (so that the transposing stores of a warp fall in
// 32 distinct banks), gt_offset.  A thread holds up to kWgGItems float4 of
// a later sample's g, which caps nk at kWgMaxRows (every map the forward
// takes at C >= 64 has H*W <= 64).
constexpr int kWgThreads = 384;
constexpr int kWgPitch = 64 + kWeightPad;
constexpr int kWgGItems = 3;
constexpr int kWgMaxRows = kWgGItems * kWgThreads / 16;
__host__ __device__ constexpr int gt_group_floats(int nk) { return 8 * nk + 4; }
__host__ __device__ constexpr int gt_tile_floats(int nk) { return 8 * gt_group_floats(nk); }
__host__ __device__ constexpr uint32_t gt_sbo_bytes(int nk) { return 4u * gt_group_floats(nk); }
// Float offset of (co n, row k) in a transposed g tile of nk rows.
__host__ __device__ constexpr int gt_offset(int n, int k, int nk) {
  return (n >> 3) * gt_group_floats(nk) + (k >> 2) * 32 + (n & 7) * 4 + (k & 3);
}

// Dynamic shared memory of bwd_weight_kernel: two buffers, each r's
// bordered map (kWgPitch floats a row) and the transposed g tile (two for
// 3xTF32); then each thread's 32 group sums and the qrow table.
inline size_t wgmma_weight_smem_bytes(const Shape& s, bool exact) {
  const size_t nr = (size_t)(s.H + 2) * (s.W + 2);
  const size_t gt = (exact ? 1 : 2) * (size_t)gt_tile_floats(weight_rows(s));
  return sizeof(float) * (2 * (nr * kWgPitch + gt) + 32 * (size_t)kWgThreads) +
         sizeof(int) * weight_rows(s);
}

// The shapes bwd_weight_kernel (wgmma) takes: C >= 64 (a 32-channel tail
// of C % 64 == 32 zero-filled in the last tile) with nk <= kWgMaxRows and
// its staging within shared memory, which is every map the forward takes
// at C >= 64.
inline bool wgmma_weights_ok(const Shape& s) {
  return s.C >= 64 && weight_rows(s) <= kWgMaxRows &&
         wgmma_weight_smem_bytes(s, false) <= kMaxSmem;
}
// The shapes whose weight gradients the path runs on it: C % 64 == 0.
// Where C % 64 == 32 the mma.sync kernel's 32 x 32 tiles of nine taps
// waste nothing and its CTAs are fewer: at 7x7x96 it read 0.071 ms (f32)
// and 0.042 (bf16) against bwd_weight_kernel's 0.108 and 0.080 (PERF.md),
// so those widths keep it, as C = 32 does.
inline bool wgmma_weights(const Shape& s) { return s.C % 64 == 0 && wgmma_weights_ok(s); }

// Which weight kernel launch_weights runs: the path's choice
// (wgmma_weights), the mma.sync kernel, or bwd_weight_kernel wherever it
// can run (the two last for measurement).
enum WeightKernel { kWeightsPath = 0, kWeightsMma = 1, kWeightsWgmma = 2 };

// Dynamic shared memory of the weight-gradient kernel that runs at this
// shape (its 3xTF32 build, the larger); kernels/odefunc_bwd.py
// weight_smem_bytes mirrors it.
inline size_t weight_smem_bytes(const Shape& s) {
  return wgmma_weights(s) ? wgmma_weight_smem_bytes(s, false) : mma_weight_smem_bytes(s);
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

// The shape under the backward's layout: fit_layout with u (its forward
// recompute runs wgmma_conv where make_shape says so).
inline Shape bwd_shape(int H, int W, int C, int G) {
  Shape s = make_shape(H, W, C, G);
  s.xg = 0;
  s.ring = kRing;
  fit_layout(s, true, bwd_smem_bytes);
  return s;
}

inline bool bwd_shape_ok(int H, int W, int C, int G) {
  const Shape s = bwd_shape(H, W, C, G);
  return layout_ok(s) && C >= 32 && C % weight_tile(C) == 0 && bwd_smem_bytes(s) <= kMaxSmem &&
         weight_smem_bytes(s) <= kMaxSmem;
}

// Normalised value x-hat of a GroupNorm input x from its group's mean and
// inv.  kBf16: x rounded to bf16 as it is read (the state h; the other
// GroupNorm inputs hold bf16 values already).  Both per-sample passes take
// it.
template <int PREC>
__device__ __forceinline__ float gn_hat_of(float x, float mean, float inv) {
  return ((PREC == kBf16 ? bf16_round(x) : x) - mean) * inv;
}

// Whether GroupNorm's output y = GN(x) (its channel's scale sc, bias bi) is
// positive: the ReLU mask, from the statistics the forward used and at its
// precision.  Both per-sample passes take it.
template <int PREC>
__device__ __forceinline__ bool gn_positive_of(float x, float mean, float inv, float sc,
                                               float bi) {
  if constexpr (PREC == kBf16)
    return gn_affine<kBf16>(bf16_round(x), mean, inv, sc, bi) > 0.f;
  else
    return gn_hat_of<kF32>(x, mean, inv) * sc + bi > 0.f;
}

// The plain bf16 VJP's per-element products, in both per-sample passes.
// dy * scale (kBf16: scale rounded, the product rounded).
template <int PREC>
__device__ __forceinline__ float gn_dys(float dy, float sc) {
  return PREC == kBf16 ? bf16_round(dy * bf16_round(sc)) : dy * sc;
}
// a + dy * x-hat, a term of dscale's sum (kBf16: dy * bf16(x-hat) rounded).
template <int PREC>
__device__ __forceinline__ float gn_dscale_add(float a, float dy, float xh) {
  return PREC == kBf16 ? a + bf16_round(dy * bf16_round(xh)) : fmaf(dy, xh, a);
}
// a + g * M, a term of the t gradient's sum (kBf16: g * bf16(M) rounded).
template <int PREC>
__device__ __forceinline__ float tmap_add(float a, float g, float tm) {
  return PREC == kBf16 ? a + bf16_round(g * bf16_round(tm)) : fmaf(g, tm, a);
}
// g's term of a time-column sum, and the sum's value at t: kBf16 sums the
// rounded products g * t, the f32 build multiplies the sum of g by t.
template <int PREC>
__device__ __forceinline__ float tcol_term(float g, float t) {
  return PREC == kBf16 ? bf16_round(g * t) : g;
}
template <int PREC>
__device__ __forceinline__ float tcol_value(float sum, float t) {
  return PREC == kBf16 ? sum : t * sum;
}

// gn_hat_of at element e (channel c) of x, from gn_stats' mean/inv.
template <bool WIDE, int PREC = kF32>
__device__ __forceinline__ float gn_hat(const Shape& s, const float* x, const float* mean,
                                        const float* inv, int e, int c) {
  const int g = group_of<WIDE>(s, c);
  return gn_hat_of<PREC>(x[e], mean[g], inv[g]);
}

// gn_positive_of at element e (channel c) of x.
template <bool WIDE, int PREC>
__device__ __forceinline__ bool gn_positive(const Shape& s, const float* x, const float* mean,
                                            const float* inv, const float* __restrict__ scale,
                                            const float* __restrict__ bias, int e, int c) {
  const int g = group_of<WIDE>(s, c);
  return gn_positive_of<PREC>(x[e], mean[g], inv[g], scale[c], bias[c]);
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
  auto dys = [&](int e, int c) { return gn_dys<PREC>(dyf(e, c), scale[c]); };
  channel_sums<WIDE>(
      m, sred2, chan, s,
      [&](int e, int c, float a) { return gn_dscale_add<PREC>(a, dyf(e, c), xhat(e, c)); },
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
      a2 = tmap_add<PREC>(a2, v, tmap[p * C + c]);
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
      for (int x = x0; x < x1; ++x)
        acc += tcol_term<PREC>(m.spad[((y + 1) * Wp + x + 1) * s.P + cc], t);
    dwt[e] = tcol_value<PREC>(acc, t);
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
    su[q * C + co] = concat_out<kPrec>(acc, p.b1[co], tb, p.m1[q * C + co]);
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

// ---- the per-sample pass at C = 64: a two-CTA cluster per sample --------
//
// bwd_sample_kernel_cluster<kPrec> computes what bwd_sample_kernel<false,
// false, kPrec> computes, with the same sums in the same order and, in the
// bf16 build, the same rounding points, as a cluster of two
// CTAs of 256 threads per sample (Hopper's thread-block clusters).  One CTA
// per sample put 128 CTAs of 512 threads on 132 SMs at the training batch,
// one an SM, so nothing filled the gaps of its serial chain (a tap's split
// and barriers, a GroupNorm reduction, a global write); two CTAs of half
// the size and half the shared memory give every SM two independent
// instruction streams, and a small batch (the event adjoint's 16) twice
// the SMs.
//
// Rank r (0 or 1) owns output channels 32r .. 32r+31.  At C = 64 with an
// even group count a GroupNorm group never has channels in both halves
// (pair_ok), so each CTA keeps its own half of the state x, of u, of the
// GroupNorm statistics and of the per-channel partial sums, and runs every
// sum of the one-CTA pass over its own channels in that pass's order: a
// thread is (channel 32r + tid % 32, pixel group tid / 32), the pass's 8
// pixel groups.  Only the convs read every channel: each CTA holds the
// whole zero-bordered conv input (spad, 64 channels), and wherever it writes
// relu(GN(.)) or a cotangent into its spad it writes the same value into its
// peer's through distributed shared memory (mapa, st.shared::cluster); the
// two meet at a cluster barrier before the conv, and again after it, before
// either writes the next conv input into the other's spad.  dt, a sum over
// all channels, is made by rank 0 from both halves' per-channel sums (rank 1
// stores its 32 into rank 0's dtp), channel by channel in order, as the one-CTA
// pass adds them: in both builds every output, dt included, is that pass's
// bit for bit.  No atomics: two launches give the same bits.
//
// The bf16 build (kBf16) takes its rounding points from the helpers the
// one-CTA pass calls (gn_affine, gn_hat_of, gn_positive_of, gn_dys,
// gn_dscale_add, tmap_add, tcol_term, concat_out; the head of this file
// lists the points): h, t and the cotangent rounded on
// entry, each input-gradient conv's sum rounded once, the GroupNorm
// backward's bf16 products and second sums, dx rounded, the time-map
// products and the t gradients rounded.
//
// The convs (pair_conv) are the forward's conv itself (odefunc_common.cuh
// wgmma_conv at two warpgroups: wgmma3 in kF32, wgmma_bf16 in kBf16) on a
// CTA's output half: its two warpgroups take the two k halves (32 input
// channels each) of a tap for the CTA's 32 output channels, one chain from
// zero per tap (three m64n32k8 TF32 products per k8 step, or two m64n32k16
// bf16), the taps added in f32 in order, the first k half + the second
// last: the mma.sync stage's order, so the recompute's two convs give the
// forward kernel's f.  The input gradient is the conv with tap 8 - k's (C, C) tile
// transposed: its B operand is row n = input channel, column k = output
// channel of w[8 - k], so a CTA's half is the tile's 32 contiguous rows
// 32r.., copied (8 KB) as the forward's tap k (16 KB, the CTA's half being
// columns) is, and the split reads it row-wise and writes the tensor cores'
// K-major order.  Each CTA brings in its own copy of each tap by
// cp.async.bulk onto its own "full" mbarrier: a copy multicast to the pair
// would halve the weights' L2 reads (the forward's whole tile reaches both
// CTAs), but needs the issuing CTA to wait on the peer's "empty" barrier
// (a remote arrive every tap), a coupling of the two CTAs' tap loops that
// this first design leaves out.
//
// Shared memory per CTA (pair_smem_bytes): 72,976 bytes at 7x7x64 and
// 69,072 at 6x6x64 (bf16: 60,688 and 56,784; the one-CTA pass's: 110,720
// and 103,488), so two CTAs and their reserved kilobyte fit an SM (three,
// by shared memory alone); the launch bounds (256 threads, 2 CTAs) give up
// to 128 registers a thread.  Bound as bwd_sample_kernel's (the head of
// this file: 4.2 us of bytes at B = 128, 7x7x64).

constexpr int kPairThreads = 256;                    // threads per CTA of the cluster
constexpr int kPairC = kMmaC / 2;                    // output channels a CTA owns
constexpr int kPairGroups = kPairThreads / kPairC;   // pixel groups, the one-CTA pass's 8

// The shapes whose per-sample pass runs as a cluster, in both builds: the
// wgmma_conv shapes (C = 64, among them 7x7x64 and 6x6x64) with an even
// number of GroupNorm groups, so that no group has channels in both
// halves.  kernels/odefunc_bwd.py (sample_pass) is the same gate in Python.
inline bool pair_ok(int H, int W, int C, int G) {
  return wgmma_ok(H, W, C) && G > 0 && C % G == 0 && G % 2 == 0;
}

// Floats of a cluster CTA's weight area in build prec: wgmma_conv<2>'s
// operand tiles (the TF32 heads and tails of its half of a tap, or its
// bf16 tile), the f32 tile as copied and its two mbarriers.
__host__ __device__ constexpr int pair_area_floats(int prec) {
  return wg_operand_floats(2, prec) + kTileF + 4;
}

// Dynamic shared memory of a CTA of the cluster pass, in floats:
//   head  [pair_area_floats(prec)]  the weight area (above)
//   spad  [R*P]        the conv input, all C channels, with a zero border
//   sx, su [H*W*kPairC each]  own channels of x (then v, then an input
//                      gradient) and of u
//   sred  [2*kPairThreads]  per-(pixel group, channel) partial sums
//   st    [3*G]        mean/inv of GN1, GN2, GN3 of its G/2 groups
//   chan  [4*kPairC]   per-channel sums and group means
//   dtp   [2*C]        rank 0: every channel's sum of g*M, conv2's then conv1's
// kernels/odefunc_bwd.py (cluster_smem_bytes) mirrors this formula.
inline size_t pair_smem_bytes(const Shape& s, int prec) {
  return sizeof(float) * ((size_t)pair_area_floats(prec) + (size_t)s.R * s.P +
                          2 * (size_t)s.H * s.W * kPairC + 2 * kPairThreads + 3 * (size_t)s.G +
                          4 * kPairC + 2 * (size_t)s.C);
}

// head: wgmma_conv<2>'s weight area.
struct PairSmem { float *head, *spad, *sx, *su, *sred, *st, *chan, *dtp; };

__device__ __forceinline__ PairSmem carve_pair(float* base, const Shape& s, int prec) {
  PairSmem m;
  m.head = base;
  m.spad = m.head + pair_area_floats(prec);
  m.sx = m.spad + s.R * s.P;
  m.su = m.sx + s.H * s.W * kPairC;
  m.sred = m.su + s.H * s.W * kPairC;
  m.st = m.sred + 2 * kPairThreads;
  m.chan = m.st + 3 * s.G;
  m.dtp = m.chan + 4 * kPairC;
  return m;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Every thread of both CTAs meets here; each CTA's shared-memory writes
// before it (its own and those into the peer's) are visible to both after
// it (arrive releases, wait acquires, at cluster scope).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}
// v stored at the shared-memory location of CTA `rank` that corresponds to
// this CTA's location p.
__device__ __forceinline__ void st_peer(const float* p, uint32_t rank, float v) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(a), "f"(v) : "memory");
}

// A CTA's own element el = q*kPairC + cl is pixel q, channel c0 + cl; a
// thread visits el = tid + j*kPairThreads, all in its channel cl = tid % 32.
// x_at: the element of x (channel c0's column, rows `pitch` floats apart).
__device__ __forceinline__ float x_at(const float* x, int pitch, int el) {
  return x[(el >> 5) * pitch + (el & (kPairC - 1))];
}

// gn_stats (narrow) over a CTA's own channels: the same sums in the same
// order (per (pixel group, channel), then over the pixel groups and the
// group's channels); writes its groups' mean/inv (local group index).
// Caller synchronises before; the caller synchronises before anyone reads
// mean/inv.
__device__ Stat pair_stats(const PairSmem& m, const Shape& s, const float* x, int pitch,
                           float* mean, float* inv) {
  const int tid = threadIdx.x, pg = tid >> 5, cl = tid & (kPairC - 1), hw = s.H * s.W;
  const int gs = 1 << s.lgs, grp = cl >> s.lgs, g0 = grp << s.lgs;
  const float n = (float)(hw * gs);
  float* red2 = m.sred + kPairThreads;
  float acc = 0.f;
  for (int p = pg; p < hw; p += kPairGroups) acc += x[p * pitch + cl];
  m.sred[tid] = acc;
  __syncthreads();
  float tot = 0.f;
  for (int q = 0; q < kPairGroups; ++q)
    for (int j = 0; j < gs; ++j) tot += m.sred[q * kPairC + g0 + j];
  Stat st;
  st.mean = tot / n;
  acc = 0.f;
  for (int p = pg; p < hw; p += kPairGroups) {
    const float d = x[p * pitch + cl] - st.mean;
    acc = fmaf(d, d, acc);
  }
  red2[tid] = acc;
  __syncthreads();
  tot = 0.f;
  for (int q = 0; q < kPairGroups; ++q)
    for (int j = 0; j < gs; ++j) tot += red2[q * kPairC + g0 + j];
  st.inv = 1.0f / sqrtf(tot / n + kEps);
  if (pg == 0 && cl == g0) {
    mean[grp] = st.mean;
    inv[grp] = st.inv;
  }
  return st;
}

// f(el, y) with y = GN(x) (scale, bias: the CTA's channels) at the thread's
// elements, from pair_stats' st, at precision PREC (gn_affine).
template <int PREC, class F>
__device__ __forceinline__ void pair_apply(const Shape& s, Stat st, const float* __restrict__ scale,
                                          const float* __restrict__ bias, const float* x,
                                          int pitch, F f) {
  const int n = s.H * s.W * kPairC, cl = threadIdx.x & (kPairC - 1);
  const float sc = scale[cl], bi = bias[cl];
  for (int el = threadIdx.x; el < n; el += kPairThreads)
    f(el, gn_affine<PREC>(x_at(x, pitch, el), st.mean, st.inv, sc, bi));
}

// gn_positive_of at the CTA's element el.
template <int PREC>
__device__ __forceinline__ bool pair_positive(const Shape& s, const float* x, int pitch,
                                              const float* mean, const float* inv,
                                              const float* __restrict__ scale,
                                              const float* __restrict__ bias, int el) {
  const int cl = el & (kPairC - 1), g = cl >> s.lgs;
  return gn_positive_of<PREC>(x_at(x, pitch, el), mean[g], inv[g], scale[cl], bias[cl]);
}

// gn_backward over the CTA's channels, in its order and at its precision:
// dscale, dbias (the CTA's columns of the partial rows), then dx to
// out(el, dx).  Caller synchronises before; ends unsynchronised.
template <int PREC, class Dy, class Out>
__device__ void pair_gn_backward(const PairSmem& m, const Shape& s, const float* x, int pitch,
                                 const float* mean, const float* inv,
                                 const float* __restrict__ scale, Dy dyf, float* dscale,
                                 float* dbias, Out out) {
  constexpr bool kB = PREC == kBf16;
  const int tid = threadIdx.x, cl = tid & (kPairC - 1), hw = s.H * s.W, n = hw * kPairC;
  const int gs = 1 << s.lgs, g = cl >> s.lgs;
  auto xhat = [&](int el) { return gn_hat_of<PREC>(x_at(x, pitch, el), mean[g], inv[g]); };
  auto dys = [&](int el) { return gn_dys<PREC>(dyf(el), scale[cl]); };
  // channel_sums over the CTA's channels: a1(el, acc) and a2(el, acc) per
  // thread, then over the pixel groups in order, into chan[cl] and
  // chan[kPairC + cl].  Ends synchronised.
  auto channel_sums = [&](auto a1f, auto a2f) {
    float a1 = 0.f, a2 = 0.f;
    for (int el = tid; el < n; el += kPairThreads) {
      a1 = a1f(el, a1);
      a2 = a2f(el, a2);
    }
    float* red2 = m.sred + kPairThreads;
    m.sred[tid] = a1;
    red2[tid] = a2;
    __syncthreads();
    if (tid < kPairC) {
      float s1 = 0.f, s2 = 0.f;
      for (int q = 0; q < kPairGroups; ++q) {
        s1 += m.sred[q * kPairC + tid];
        s2 += red2[q * kPairC + tid];
      }
      m.chan[tid] = s1;
      m.chan[kPairC + tid] = s2;
    }
    __syncthreads();
  };
  channel_sums([&](int el, float a) { return gn_dscale_add<PREC>(a, dyf(el), xhat(el)); },
               [&](int el, float a) { return a + dyf(el); });
  if (tid < kPairC) {
    dscale[tid] = m.chan[tid];
    dbias[tid] = m.chan[kPairC + tid];
  }
  if constexpr (kB)  // chan = per-channel sums of dy*scale*x-hat, dy*scale
    channel_sums([&](int el, float a) { return fmaf(dys(el), xhat(el), a); },
                 [&](int el, float a) { return a + dys(el); });
  if (tid < (s.G >> 1)) {  // the group means of this CTA's groups
    const float nn = (float)(hw * gs);
    float s1 = 0.f, s2 = 0.f;
    for (int j = 0; j < gs; ++j) {
      const int cc = tid * gs + j;
      if (kB) {
        s1 += m.chan[cc];
        s2 += m.chan[kPairC + cc];
      } else {
        s1 = fmaf(scale[cc], m.chan[cc], s1);
        s2 = fmaf(scale[cc], m.chan[kPairC + cc], s2);
      }
    }
    m.chan[2 * kPairC + tid] = s2 / nn;  // mean_g(dy * scale)
    m.chan[3 * kPairC + tid] = s1 / nn;  // mean_g(dy * scale * x-hat)
  }
  __syncthreads();
  const float ig = inv[g], m1 = m.chan[2 * kPairC + g], m2 = m.chan[3 * kPairC + g];
  for (int el = tid; el < n; el += kPairThreads) {
    const float dx = ig * (dys(el) - m1 - xhat(el) * m2);
    out(el, kB ? bf16_round(dx) : dx);
  }
}

// conv_param_grads over the CTA's channels, at its precision, from the
// cotangent in its spad (its own channels, written by this CTA; caller
// synchronised): db and dwt (the CTA's columns), and each channel's sum of
// g*M into rank 0's dtp at slot*C + channel.  Ends unsynchronised.
template <int PREC>
__device__ void pair_param_grads(const PairSmem& m, const Shape& s, const float* __restrict__ tmap,
                                 float t, float* db, float* dwt, uint32_t rank, int slot) {
  const int tid = threadIdx.x, pg = tid >> 5, cl = tid & (kPairC - 1), C = s.C;
  const int hw = s.H * s.W, Wp = s.W + 2, c0 = (int)rank * kPairC, c = c0 + cl;
  float a1 = 0.f, a2 = 0.f;
  for (int p = pg; p < hw; p += kPairGroups) {
    const float v = m.spad[pad_at(s, p, c)];
    a1 += v;
    a2 = tmap_add<PREC>(a2, v, tmap[p * C + c]);
  }
  float* red2 = m.sred + kPairThreads;
  m.sred[tid] = a1;
  red2[tid] = a2;
  for (int e = tid; e < 9 * kPairC; e += kPairThreads) {
    const int k = e >> 5, ce = e & (kPairC - 1);
    const int ky = k / 3, kx = k % 3;
    const int y0 = max(0, 1 - ky), y1 = min(s.H, s.H + 1 - ky);
    const int x0 = max(0, 1 - kx), x1 = min(s.W, s.W + 1 - kx);
    float acc = 0.f;
    for (int y = y0; y < y1; ++y)
      for (int x = x0; x < x1; ++x)
        acc += tcol_term<PREC>(m.spad[((y + 1) * Wp + x + 1) * s.P + c0 + ce], t);
    dwt[k * C + ce] = tcol_value<PREC>(acc, t);
  }
  __syncthreads();
  if (tid < kPairC) {
    float s1 = 0.f, s2 = 0.f;
    for (int q = 0; q < kPairGroups; ++q) {
      s1 += m.sred[q * kPairC + tid];
      s2 += red2[q * kPairC + tid];
    }
    db[tid] = s1;
    float* to = m.dtp + slot * C + c0 + tid;
    if (rank == 0) *to = s2;
    else st_peer(to, 0, s2);
  }
}

// 3x3 SAME conv of spad (all C = 64 channels) on wgmma for this CTA's 32
// output channels (wgmma_conv<2> at precision PREC), epi(p, cl, sum) once
// per output pixel p and own channel cl; the caller synchronises before and
// after.  BT: the input gradient, the conv with tap 8 - k's tile transposed.
template <bool BT, int PREC, class Epi>
__device__ __forceinline__ void pair_conv(const PairSmem& m, const Shape& s,
                                          const float* __restrict__ w, uint32_t rank, Epi epi) {
  wgmma_conv<2, BT, PREC>(m.spad, s, m.head, w, (int)rank * kPairC, epi);
}

// The per-sample pass as a cluster (the note above): block 2b + r is rank r
// of sample b.  Arguments and outputs as bwd_sample_kernel's (no global
// scratch: C = 64); kPrec: kF32 or kBf16.
template <int kPrec>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kPairThreads, 2)
bwd_sample_kernel_cluster(const float* __restrict__ t, const float* __restrict__ h,
                          const float* __restrict__ g, Odefunc p, Shape s,
                          float* __restrict__ fout, float* __restrict__ dh,
                          float* __restrict__ dt, float* __restrict__ r1,
                          float* __restrict__ r2, float* __restrict__ gu,
                          float* __restrict__ gv, float* __restrict__ part) {
  constexpr bool kB = kPrec == kBf16;
  extern __shared__ float4 smem_raw[];
  const PairSmem m = carve_pair(reinterpret_cast<float*>(smem_raw), s, kPrec);
  const int C = s.C, tid = threadIdx.x, hw = s.H * s.W, n = hw * kPairC, Gh = s.G >> 1;
  const uint32_t rank = cluster_rank(), peer = rank ^ 1;
  const int b = blockIdx.x >> 1, c0 = (int)rank * kPairC;
  const size_t off = (size_t)b * hw * C + c0;  // (pixel q, channel c0 + cl) at off + q*C + cl
  const float tb = kB ? bf16_round(t[b]) : t[b];
  const float* hb = h + off;
  float* pb = part + (size_t)b * kParts * C + c0;
  float *mean1 = m.st, *inv1 = m.st + Gh, *mean2 = m.st + 2 * Gh, *inv2 = m.st + 3 * Gh;
  float *mean3 = m.st + 4 * Gh, *inv3 = m.st + 5 * Gh;
  auto at = [&](int el) { return off + (size_t)(el >> 5) * C + (el & (kPairC - 1)); };
  // v into both CTAs' spads at the CTA's element el.
  auto to_pads = [&](int el, float v) {
    float* d = m.spad + pad_at(s, el >> 5, c0 + (el & (kPairC - 1)));
    *d = v;
    st_peer(d, peer, v);
  };

  // Forward recompute, as bwd_sample_kernel's: r1 = relu(GN1(h)), u =
  // conv1(r1), r2 = relu(GN2(u)), v = conv2(r2) in sx, f = GN3(v).
  for (int i = tid; i < s.R * s.P; i += kPairThreads) m.spad[i] = 0.f;
  for (int el = tid; el < n; el += kPairThreads)
    m.sx[el] = kB ? bf16_round(x_at(hb, C, el)) : x_at(hb, C, el);
  cluster_sync();  // both spads zeroed before either CTA writes into the other's
  Stat stat = pair_stats(m, s, m.sx, kPairC, mean1, inv1);
  pair_apply<kPrec>(s, stat, p.n1s + c0, p.n1b + c0, m.sx, kPairC, [&](int el, float v) {
    const float y = v < 0.f ? 0.f : v;
    to_pads(el, y);
    r1[at(el)] = y;
  });
  cluster_sync();  // both spads hold r1
  pair_conv<false, kPrec>(m, s, p.w1, rank, [&](int q, int cl, float acc) {
    const int co = c0 + cl;
    m.su[q * kPairC + cl] = concat_out<kPrec>(acc, p.b1[co], tb, p.m1[q * C + co]);
  });
  cluster_sync();  // u visible; the peer has read its spad
  stat = pair_stats(m, s, m.su, kPairC, mean2, inv2);
  pair_apply<kPrec>(s, stat, p.n2s + c0, p.n2b + c0, m.su, kPairC, [&](int el, float v) {
    const float y = v < 0.f ? 0.f : v;
    to_pads(el, y);
    r2[at(el)] = y;
  });
  cluster_sync();  // both spads hold r2
  pair_conv<false, kPrec>(m, s, p.w2, rank, [&](int q, int cl, float acc) {
    const int co = c0 + cl;
    m.sx[q * kPairC + cl] = concat_out<kPrec>(acc, p.b2[co], tb, p.m2[q * C + co]);
  });
  cluster_sync();  // v visible; the peer has read its spad
  stat = pair_stats(m, s, m.sx, kPairC, mean3, inv3);
  pair_apply<kPrec>(s, stat, p.n3s + c0, p.n3b + c0, m.sx, kPairC,
                    [&](int el, float v) { fout[at(el)] = v; });
  __syncthreads();  // mean3, inv3 visible

  // An input-gradient conv's sum into sx; kBf16 rounds it once.
  auto to_sx = [&](int q, int cl, float acc) {
    m.sx[q * kPairC + cl] = kB ? bf16_round(acc) : acc;
  };
  // GN3: gv into both spads; kBf16 takes the cotangent rounded.
  pair_gn_backward<kPrec>(m, s, m.sx, kPairC, mean3, inv3, p.n3s + c0,
                          [&](int el) { return kB ? bf16_round(g[at(el)]) : g[at(el)]; },
                          pb + 4 * C, pb + 5 * C,
                          [&](int el, float v) {
                            gv[at(el)] = v;
                            to_pads(el, v);
                          });
  __syncthreads();
  pair_param_grads<kPrec>(m, s, p.m2, tb, pb + 7 * C, pb + 17 * C, rank, 0);
  cluster_sync();  // both spads hold gv; rank 0 holds conv2's g*M sums
  pair_conv<true, kPrec>(m, s, p.w2, rank, to_sx);  // conv2 input gradient
  cluster_sync();  // sx visible; the peer has read its spad
  // ReLU2 + GN2: gu into both spads.
  pair_gn_backward<kPrec>(m, s, m.su, kPairC, mean2, inv2, p.n2s + c0,
                          [&](int el) {
                            return pair_positive<kPrec>(s, m.su, kPairC, mean2, inv2,
                                                        p.n2s + c0, p.n2b + c0, el)
                                       ? m.sx[el]
                                       : 0.f;
                          },
                          pb + 2 * C, pb + 3 * C,
                          [&](int el, float v) {
                            gu[at(el)] = v;
                            to_pads(el, v);
                          });
  __syncthreads();
  pair_param_grads<kPrec>(m, s, p.m1, tb, pb + 6 * C, pb + 8 * C, rank, 1);
  cluster_sync();  // both spads hold gu; rank 0 holds conv1's g*M sums
  pair_conv<true, kPrec>(m, s, p.w1, rank, to_sx);  // conv1 input gradient
  __syncthreads();
  // ReLU1 + GN1: dh.
  pair_gn_backward<kPrec>(m, s, hb, C, mean1, inv1, p.n1s + c0,
                          [&](int el) {
                            return pair_positive<kPrec>(s, hb, C, mean1, inv1, p.n1s + c0,
                                                        p.n1b + c0, el)
                                       ? m.sx[el]
                                       : 0.f;
                          },
                          pb, pb + C, [&](int el, float v) { dh[at(el)] = v; });
  if (rank == 0 && tid == 0) {  // dt: conv2's channels in order, plus conv1's
    float dv = 0.f, du = 0.f;
    for (int c = 0; c < C; ++c) dv += m.dtp[c];
    for (int c = 0; c < C; ++c) du += m.dtp[C + c];
    dt[b] = kB ? bf16_round(bf16_round(dv) + bf16_round(du)) : dv + du;
  }
}

// wpart[split][conv][tap][ci][co] = sum over the split's samples b and
// pixels p of r[b, p + off_tap, ci] * g[b, p, co] (zero where the tap leaves
// the map): per (conv, tap) a GEMM with M = ci, N = co, K = rows (b, p), on
// the tensor cores (the head of this file).  bwd_weight_kernel_mma is the
// mma.sync kernel: the weight gradients at C = 32, and at every shape
// through odefunc_backward*_mma_weights and odefunc_bwd_weight_grads
// (measurement only; bwd_weight_kernel gives its bits).  One CTA per (conv, group of
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
bwd_weight_kernel_mma(const float* __restrict__ r1, const float* __restrict__ r2,
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

// bwd_weight_kernel: the same wpart, bit for bit, on Hopper's asynchronous
// warpgroup products (the head of this file).  One CTA per (conv, row of
// three taps, split, 64-channel ci tile, 64-channel co tile), three
// warpgroups, warpgroup wg taking tap 3*row + wg: per 32-row step of a
// sample one chain of wgmma.mma_async.m64n64k8 TF32 (four k8, three past
// row 32 at 7x7) from zero, M = 64 ci, N = 64 co, K = the step's rows.
//   A (ci x rows) comes from registers: a tap's rows are the bordered map's
//   rows qrow[k] + off_tap, where no descriptor can start (a shifted pixel
//   row), so each thread loads its fragment as the mma.sync kernel does:
//   row g / g + 8 of warp w's 16 is ci 16w + 2g / 2g + 1 (one 8-byte load
//   gives both), k columns t and t + 4 (the fragment of mma.sync m16n8k8,
//   a0 and a2 at k = t and t + 4), so the k order within a k8 is the rows'
//   own, as in the mma.sync kernel.
//   B (rows x co) comes from shared memory through a descriptor, K-major,
//   which TF32 requires (its wgmma has no transpose): g's rows are staged
//   transposed (gt_offset), once per sample and shared by the three taps.
//   cp.async cannot transpose, so each thread loads up to kWgGItems float4
//   (4 co of one row) of a later sample into registers and stores them as
//   single floats (3xTF32: head and tail tiles, split as the mma.sync
//   kernel splits B) while this sample's chains run; rows past H*W and
//   channels past C are stored as zeros.  r's bordered map comes by
//   cp.async (zero-filled outside the map and past C) a sample ahead.  Two
//   buffers: a sample's r map and g tiles in one while the next's fill the
//   other.
// Order of sums: per k8, 3xTF32 a_lo*b_hi, a_hi*b_lo, a_hi*b_hi onto the
// chain (kExact: a_hi*b_hi alone), the chain added to run in f32, run to
// the thread's slots of tot every kGroupSamples samples and at the split's
// end: the mma.sync kernel's per output, whose bits this gives (a wgmma
// TF32 chain gives mma.sync's, PERF.md).  kExact issues a sample's two
// chains (rows 0-31 and 32-63) onto two accumulators before it waits for
// the first, so two chains a warpgroup are in flight; 3xTF32 issues one at
// a time (the second's split A fragments and accumulator would pass the
// 168 registers a thread of three warpgroups has).
template <bool kExact>
__global__ void __launch_bounds__(kWgThreads, 1)
bwd_weight_kernel(const float* __restrict__ r1, const float* __restrict__ r2,
                  const float* __restrict__ gu, const float* __restrict__ gv, Shape s, int B,
                  int ns, float* __restrict__ wpart) {
  constexpr int kTiles = kExact ? 1 : 2;  // g's transposed tiles: head (and tail)
  extern __shared__ float4 wsmem[];
  const int C = s.C, H = s.H, W = s.W, hw = H * W, Wp = W + 2;
  const int nr = (H + 2) * Wp, nk = weight_rows(s), gtf = gt_tile_floats(nk);
  const int stage_floats = nr * kWgPitch + kTiles * gtf;
  float* sbase = reinterpret_cast<float*>(wsmem);
  float* tot = sbase + 2 * stage_floats;  // [32][kWgThreads]: each thread's group sums
  int* qrow = reinterpret_cast<int*>(tot + 32 * kWgThreads);
  const int conv = blockIdx.x / (3 * ns), row3 = (blockIdx.x / ns) % 3;
  const int split = blockIdx.x % ns;
  const int ci0 = blockIdx.y * 64, co0 = blockIdx.z * 64;
  const float* r = conv == 0 ? r1 : r2;
  const float* g = conv == 0 ? gu : gv;
  const int b0 = (int)((long)B * split / ns), b1 = (int)((long)B * (split + 1) / ns);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3, wg = warp >> 2, wi = warp & 3;
  const int tap = 3 * row3 + wg, tapoff = (tap / 3) * Wp + tap % 3;

  for (int k = tid; k < nk; k += kWgThreads)
    qrow[k] = k < hw ? k + 2 * div_magic(k, s.wmagic) : 0;
#pragma unroll
  for (int v = 0; v < 32; ++v) tot[v * kWgThreads + tid] = 0.f;

  // Sample b's r map (bordered) into buffer buf, zero-filled outside the
  // map and past C.
  auto stage_r = [&](int b, int buf) {
    float* sr = sbase + buf * stage_floats;
    const size_t row0 = (size_t)b * hw;
    for (int i = tid; i < nr * 16; i += kWgThreads) {
      const int q = i >> 4, c4 = (i & 15) * 4;
      const int py = div_magic(q, s.pmagic), y = py - 1, x = q - py * Wp - 1;
      const bool in = y >= 0 && y < H && x >= 0 && x < W && ci0 + c4 < C;
      cp_async16_zfill(sr + q * kWgPitch + c4, in ? r + (row0 + y * W + x) * C + ci0 + c4 : r,
                       in);
    }
    cp_async_commit();
  };
  // Item i of a sample's g tile: row 4*(i / 64) + i % 4, co quad
  // 8*((i / 32) % 2) + (i % 32) / 4, so that a warp's stores of one of a
  // quad's four co fall in 32 distinct banks.
  float4 gnext[kWgGItems];
  auto load_g = [&](int b) {
    const size_t row0 = (size_t)b * hw;
#pragma unroll
    for (int j = 0; j < kWgGItems; ++j) {
      const int i = tid + j * kWgThreads;
      const int k = 4 * (i >> 6) + (i & 3), co = 4 * (8 * ((i >> 5) & 1) + ((i & 31) >> 2));
      gnext[j] = i < nk * 16 && k < hw && co0 + co < C
                     ? __ldg(reinterpret_cast<const float4*>(g + (row0 + k) * C + co0 + co))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store_g = [&](int buf) {
    float* head = sbase + buf * stage_floats + nr * kWgPitch;
#pragma unroll
    for (int j = 0; j < kWgGItems; ++j) {
      const int i = tid + j * kWgThreads;
      if (i >= nk * 16) break;
      const int k = 4 * (i >> 6) + (i & 3), co = 4 * (8 * ((i >> 5) & 1) + ((i & 31) >> 2));
      const float v[4] = {gnext[j].x, gnext[j].y, gnext[j].z, gnext[j].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int off = gt_offset(co + e, k, nk);
        if (kExact) {
          head[off] = v[e];
        } else {
          uint32_t hi, lo;
          tf32_split(v[e], hi, lo);
          head[off] = __uint_as_float(hi);
          head[gtf + off] = __uint_as_float(lo);
        }
      }
    }
  };
  // While this sample's chains run: sample b + 1's tiles, then the loads
  // of sample b + 2's.
  auto next_g = [&](int b, int buf) {
    if (b + 1 < b1) {
      store_g(buf ^ 1);
      if (b + 2 < b1) load_g(b + 2);
    }
  };
  // The A fragments of the step at row k0 (split for 3xTF32).
  auto load_a = [&](uint32_t a_thread, int k0, uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int k = k0 + 8 * ks;
      if (k >= nk) break;
      const int qa = qrow[k + tq], qb = qrow[k + tq + 4];
      const float2 u0 = lds2(a_thread + 4u * (qa * kWgPitch));
      const float2 u1 = lds2(a_thread + 4u * (qb * kWgPitch));
      const float av[4] = {u0.x, u0.y, u1.x, u1.y};
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        if (kExact) ah[ks][v] = __float_as_uint(av[v]);
        else tf32_split(av[v], ah[ks][v], al[ks][v]);
      }
    }
  };
  // The step's chain onto acc, from zero.
  auto chain = [&](float (&acc)[32], int k0, uint64_t d_hi, uint64_t d_lo,
                   const uint32_t (&ah)[4][4], const uint32_t (&al)[4][4]) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int k = k0 + 8 * ks;
      if (k >= nk) break;
      const uint64_t step = (uint64_t)(2 * k);  // k rows of 32 bytes, in 16-byte units
      if (!kExact) {
        wgmma_tf32_n64(acc, al[ks], d_hi + step, ks > 0);
        wgmma_tf32_n64(acc, ah[ks], d_lo + step, 1);
      }
      wgmma_tf32_n64(acc, ah[ks], d_hi + step, kExact ? ks > 0 : 1);
    }
    wgmma_commit();
  };

  float run[32];
#pragma unroll
  for (int v = 0; v < 32; ++v) run[v] = 0.f;

  stage_r(b0, 0);
  load_g(b0);
  store_g(0);
  if (b0 + 1 < b1) load_g(b0 + 1);
  const uint32_t sbo = gt_sbo_bytes(nk);
  for (int b = b0, buf = 0, in_group = 0; b < b1; ++b, buf ^= 1) {
    cp_async_wait_all();
    fence_proxy_async();  // this thread's g stores, before the products read them
    __syncthreads();      // sample b visible (and qrow, the first time)
    if (b + 1 < b1) stage_r(b + 1, buf ^ 1);
    const float* sr = sbase + buf * stage_floats;
    const float* head = sr + nr * kWgPitch;
    // This thread's A element (ci 16wi + 2g at the tap's offset; add the
    // row) and the descriptors of the head and tail tiles at row 0.
    const uint32_t a_thread = smem_addr(sr + tapoff * kWgPitch + 16 * wi + 2 * gq);
    const uint64_t d_hi = wgmma_desc(smem_addr(head), sbo);
    const uint64_t d_lo = wgmma_desc(smem_addr(head + (kExact ? 0 : gtf)), sbo);
    if constexpr (kExact) {
      // Two steps at a time: both chains in flight, added in order.
      for (int k0 = 0; k0 < nk; k0 += 2 * kStepRows) {
        const bool two = k0 + kStepRows < nk;
        uint32_t ah0[4][4], ah1[4][4];
        load_a(a_thread, k0, ah0, ah0);
        if (two) load_a(a_thread, k0 + kStepRows, ah1, ah1);
        float acc0[32], acc1[32];
        wgmma_fence();
        chain(acc0, k0, d_hi, d_lo, ah0, ah0);
        if (two) chain(acc1, k0 + kStepRows, d_hi, d_lo, ah1, ah1);
        if (k0 == 0) next_g(b, buf);
        if (two) wgmma_wait_but_one();
        else wgmma_wait_all();
        wgmma_pin(acc0);
#pragma unroll
        for (int v = 0; v < 32; ++v) run[v] += acc0[v];
        if (two) {
          wgmma_wait_all();
          wgmma_pin(acc1);
#pragma unroll
          for (int v = 0; v < 32; ++v) run[v] += acc1[v];
        }
      }
    } else {
      for (int k0 = 0; k0 < nk; k0 += kStepRows) {
        uint32_t ah[4][4], al[4][4];
        load_a(a_thread, k0, ah, al);
        float acc[32];
        wgmma_fence();
        chain(acc, k0, d_hi, d_lo, ah, al);
        if (k0 == 0) next_g(b, buf);
        wgmma_wait_all();
        wgmma_pin(acc);
#pragma unroll
        for (int v = 0; v < 32; ++v) run[v] += acc[v];
      }
    }
    // Every kGroupSamples samples (and at the split's end) the group's sum
    // goes to the thread's own slots of tot, and run starts again from zero.
    if (++in_group == kGroupSamples || b + 1 == b1) {
      in_group = 0;
#pragma unroll
      for (int v = 0; v < 32; ++v) {
        tot[v * kWgThreads + tid] += run[v];
        run[v] = 0.f;
      }
    }
  }

  // Accumulator 4j + 2h + e: ci 16wi + 2g + h, co 8j + 2t + e.
  float* out = wpart + (((size_t)split * 2 + conv) * 9 + tap) * C * C;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = ci0 + 16 * wi + 2 * gq + h, co = co0 + 8 * j + 2 * tq;
      if (ci < C && co < C)
        *reinterpret_cast<float2*>(out + (size_t)ci * C + co) =
            make_float2(tot[(4 * j + 2 * h) * kWgThreads + tid],
                        tot[(4 * j + 2 * h + 1) * kWgThreads + tid]);
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

// ---- the rows backward (the head of this file) ----------------------------

// The gate's clause on shared memory (kernels/odefunc_bwd.py mirrors it):
// a sample's bordered cotangent map, 2*kThreads partial sums, 2G statistics
// and 4C channel sums, within one CTA's shared memory, as the one-CTA
// per-sample launches that first ran the rows backward held them.  The
// sliced launches take far less (rows_bwd_slice_smem_bytes); the clause
// keeps the set of shapes the rows backward takes (a 1x62 map's stops at
// C = 192).
inline size_t rows_bwd_smem_bytes(int H, int W, int C, int G) {
  return sizeof(float) *
         ((size_t)(H + 2) * (W + 2) * C + 2 * kThreads + 2 * (size_t)G + 4 * (size_t)C);
}

// The shapes of the rows backward (kernels/odefunc_bwd.py sample_pass gives
// 'rows' for the bf16 build): the backward's gate at the bf16 dynamics'
// rows-build shapes (the tensor-core shapes past C = 64), where the
// bordered map fits.
inline bool rows_bwd_ok(int H, int W, int C, int G) {
  return bwd_shape_ok(H, W, C, G) && shape_ok(H, W, C, G) &&
         wide_shape(make_shape(H, W, C, G)) && rows_bwd_smem_bytes(H, W, C, G) <= kMaxSmem;
}

// Bytes of the rows backward's scratch (kernels/odefunc_bwd.py mirrors
// it): the rows conv's (the bf16 conv input, one conv's packed weights),
// then the statistics of GN1 and GN2, (B, 2, 2, G) floats, then the t
// gradient's per-channel sums of conv2 and conv1, (B, 2, C) floats.
inline size_t rows_bwd_scratch_bytes(int B, int H, int W, int C, int G) {
  return rows_scratch_bytes(B, H, W, C, true) + sizeof(float) * 4 * (size_t)B * G +
         sizeof(float) * 2 * (size_t)B * C;
}

// Dynamic shared memory of the sliced GroupNorm backwards (rows_bwd_gv,
// _gu, _dh; kernels/odefunc_bwd.py mirrors it): two staged slices (the
// GroupNorm input and the cotangent), 4 partial sums a thread, the groups'
// statistics and two group means, two channel sums, and a conv's C
// per-channel t sums (dt's gather).  The recompute's GroupNorms take
// rows_gn_smem_bytes.
inline size_t rows_bwd_slice_smem_bytes(int H, int W, int C, int G) {
  return sizeof(float) * (2 * (size_t)H * W * (C / rows_slices(G)) +
                          4 * (size_t)rows_slice_threads(G) + 4 * (size_t)(G / rows_slices(G)) +
                          2 * (size_t)(C / rows_slices(G)) + (size_t)C);
}

// A sliced GroupNorm backward's shared memory (rows_bwd_slice_smem_bytes'
// order): xs the GroupNorm input, dy its output's cotangent, red the
// partial sums, the statistics, the channel sums ch1, ch2 and the group
// means gm1 = mean_g(dy*scale), gm2 = mean_g(dy*scale*x-hat), and a
// conv's per-channel t sums dtc.
struct RowsBwdSmem {
  float* xs;
  float* dy;
  float* red;
  float* mean;
  float* inv;
  float* gm1;
  float* gm2;
  float* ch1;
  float* ch2;
  float* dtc;
};

__device__ __forceinline__ RowsBwdSmem rows_bwd_carve(const RowsSlice& sl) {
  extern __shared__ float4 smem_raw[];
  RowsBwdSmem m;
  m.xs = reinterpret_cast<float*>(smem_raw);
  m.dy = m.xs + sl.hw * sl.cs;
  m.red = m.dy + sl.hw * sl.cs;
  m.mean = m.red + 4 * blockDim.x;
  m.inv = m.mean + sl.ng;
  m.gm1 = m.inv + sl.ng;
  m.gm2 = m.gm1 + sl.ng;
  m.ch1 = m.gm2 + sl.ng;
  m.ch2 = m.ch1 + sl.cs;
  m.dtc = m.ch2 + sl.cs;
  return m;
}

// Stage x's and dy's slices (dy from dyg) and, where dtc is not null, a
// conv's C per-channel t sums (the sample's), and read GroupNorm k's
// statistics (0: GN1, 1: GN2) of the slice's groups from the recompute's
// scratch (k < 0: none).  Ends synchronised.
__device__ __forceinline__ void rows_bwd_stage(const RowsSlice& sl, const Shape& s,
                                               const RowsBwdSmem& m, const float* x,
                                               const float* dyg, const float* stats, int k,
                                               const float* dtc = nullptr) {
  slice_stage(sl, s, x, m.xs);
  slice_stage(sl, s, dyg, m.dy);
  if (dtc)
    for (int i = threadIdx.x; 4 * i < s.C; i += blockDim.x) cp_async16(m.dtc + 4 * i, dtc + 4 * i);
  cp_async_commit();
  if (k >= 0) {
    const float* src = stats + ((size_t)sl.b * 2 + k) * 2 * s.G + sl.g0;
    for (int g = threadIdx.x; g < sl.ng; g += blockDim.x) {
      m.mean[g] = src[g];
      m.inv[g] = src[s.G + g];
    }
  }
  cp_async_wait_all();
  __syncthreads();
}

// dy = the cotangent of relu(GN(x)) in place: the staged cotangent where
// GroupNorm's output is positive (gn_positive_of, the forward's
// statistics), else 0.  Ends synchronised.
__device__ __forceinline__ void rows_bwd_relu_mask(const RowsSlice& sl, const Shape& s,
                                                   const RowsBwdSmem& m,
                                                   const float* __restrict__ scale,
                                                   const float* __restrict__ bias) {
  const Col4 k = col4(sl, s, m.mean, m.inv, scale, bias);
  slice_each4(sl, s, [&](int i, size_t) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (!gn_positive_of<kBf16>(m.xs[i + j], k.mean[j], k.inv[j], k.sc[j], k.bi[j]))
        m.dy[i + j] = 0.f;
  });
  __syncthreads();
}

// gn_backward<kBf16> of the slice: x = xs (statistics mean, inv), its
// output's cotangent dyf(i) at staged offset i (bf16 values); dscale,
// dbias (the sample's part rows) get the slice's channels; dx (rounded),
// four channels at a time, goes to out(i, e, dx) at the staged offset i,
// element e.  The per-channel sums of both of gn_backward's passes (dscale
// and dbias; then dy*scale*x-hat and dy*scale, the bf16 backward's group
// means) run as four chains of one loop over the slot's pixels, each in
// channel_sums' order, then over the pixel groups.  Caller synchronises
// before; ends unsynchronised.
template <class Dy, class Out>
__device__ void slice_gn_backward(const RowsSlice& sl, const Shape& s, const RowsBwdSmem& m,
                                  const float* __restrict__ scale, float* dscale, float* dbias,
                                  Dy dyf, Out out) {
  const int tid = threadIdx.x, cs = sl.cs, nt = blockDim.x;
  float a1 = 0.f, a2 = 0.f, b1 = 0.f, b2 = 0.f;
  if (tid < sl.slots) {
    const int g = div_magic(sl.cl, s.gmagic);
    const float mu = m.mean[g], iv = m.inv[g], sc = scale[sl.c0 + sl.cl];
    for (int p = sl.pg; p < sl.hw; p += s.npg) {
      const int i = p * cs + sl.cl;
      const float dy = dyf(i), xh = gn_hat_of<kBf16>(m.xs[i], mu, iv);
      const float dys = gn_dys<kBf16>(dy, sc);
      a1 = gn_dscale_add<kBf16>(a1, dy, xh);
      a2 = a2 + dy;
      b1 = fmaf(dys, xh, b1);
      b2 = b2 + dys;
    }
  }
  m.red[tid] = a1;
  m.red[nt + tid] = a2;
  m.red[2 * nt + tid] = b1;
  m.red[3 * nt + tid] = b2;
  __syncthreads();
  if (tid < cs) {
    float s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f;
    for (int q = 0; q < s.npg; ++q) {
      s1 += m.red[q * cs + tid];
      s2 += m.red[nt + q * cs + tid];
      s3 += m.red[2 * nt + q * cs + tid];
      s4 += m.red[3 * nt + q * cs + tid];
    }
    dscale[sl.c0 + tid] = s1;
    dbias[sl.c0 + tid] = s2;
    m.ch1[tid] = s3;
    m.ch2[tid] = s4;
  }
  __syncthreads();
  if (tid < sl.ng) {
    const float n = (float)(sl.hw * s.gs);
    float s1 = 0.f, s2 = 0.f;
    for (int j = 0; j < s.gs; ++j) {
      s1 += m.ch1[tid * s.gs + j];
      s2 += m.ch2[tid * s.gs + j];
    }
    m.gm1[tid] = s2 / n;  // mean_g(dy * scale)
    m.gm2[tid] = s1 / n;  // mean_g(dy * scale * x-hat)
  }
  __syncthreads();
  const int cl = sl.col;
  float gm1[4], gm2[4];
  const Col4 k = col4(sl, s, m.mean, m.inv, scale);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int g = div_magic(cl + j, s.gmagic);
    gm1[j] = m.gm1[g];
    gm2[j] = m.gm2[g];
  }
  slice_each4(sl, s, [&](int i, size_t e) {
    float dx[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float d = k.inv[j] * (gn_dys<kBf16>(dyf(i + j), k.sc[j]) - gm1[j] -
                                  gn_hat_of<kBf16>(m.xs[i + j], k.mean[j], k.inv[j]) * gm2[j]);
      dx[j] = bf16_round(d);
    }
    out(i, e, dx);
  });
}

// tmap_add<kBf16>'s term of the t gradient, g * bf16(M) rounded, for the
// staged terms of slice_conv_param_grads.
__device__ __forceinline__ float tmap_term(float g, float tm) {
  return bf16_round(g * bf16_round(tm));
}

// conv_param_grads<kBf16> of the slice from its conv output's cotangent gv
// (staged, bf16 values) and its time-map terms tmap_term(gv, M) (staged,
// written by the GroupNorm backward's output pass): db and dwt (the
// sample's part rows: db[c], dwt[k*C + c]) and the t gradient's
// per-channel sums chan_t[c] (the sample's), which rows_bwd_dt adds over
// the channels.  The nine time columns of a channel are nine chains over
// the pixels in order, each adding the terms of the pixels where its tap
// reads inside the map.  Caller synchronises before.
__device__ void slice_conv_param_grads(const RowsSlice& sl, const Shape& s, float* red,
                                       const float* gv, const float* terms, float t,
                                       float* db, float* dwt, float* chan_t) {
  const int tid = threadIdx.x, cs = sl.cs, C = s.C;
  float a1 = 0.f, a2 = 0.f;
  if (tid < sl.slots)
    for (int p = sl.pg; p < sl.hw; p += s.npg) {
      const float v = gv[p * cs + sl.cl];
      a1 += v;
      a2 += terms[p * cs + sl.cl];  // tmap_add<kBf16>
    }
  red[tid] = a1;
  red[blockDim.x + tid] = a2;
  if (tid < cs) {
    float acc[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) acc[k] = 0.f;
    for (int y = 0; y < s.H; ++y)
      for (int x = 0; x < s.W; ++x) {
        const float v = tcol_term<kBf16>(gv[(y * s.W + x) * cs + tid], t);
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          const int ky = k / 3, kx = k % 3;
          if (y >= 1 - ky && y < s.H + 1 - ky && x >= 1 - kx && x < s.W + 1 - kx) acc[k] += v;
        }
      }
#pragma unroll
    for (int k = 0; k < 9; ++k) dwt[k * C + sl.c0 + tid] = tcol_value<kBf16>(acc[k], t);
  }
  __syncthreads();
  if (tid < cs) {
    float s1 = 0.f, s2 = 0.f;
    for (int q = 0; q < s.npg; ++q) {
      s1 += red[q * cs + tid];
      s2 += red[blockDim.x + q * cs + tid];
    }
    db[sl.c0 + tid] = s1;
    chan_t[sl.c0 + tid] = s2;
  }
}

// One conv's t gradient, conv_param_grads' (rounded) sum over the channels
// in order of its per-channel sums (staged in shared memory).
__device__ __forceinline__ float rows_bwd_dt(const float* chan_t, int C) {
  float dt = 0.f;
#pragma unroll 16
  for (int cc = 0; cc < C; ++cc) dt += chan_t[cc];
  return bf16_round(dt);
}

// The GroupNorm backward's output y (four channels, staged offset i) kept
// for the conv parameter gradients: into dy (the cotangent, read no more)
// and its time-map terms into xs (the GroupNorm input, read no more), from
// the time map at tm (four floats).
__device__ __forceinline__ void rows_bwd_out(const RowsBwdSmem& m, int i, const float (&y)[4],
                                             const float* __restrict__ tm) {
  const float4 t4 = *reinterpret_cast<const float4*>(tm);
  *reinterpret_cast<float4*>(m.dy + i) = make_float4(y[0], y[1], y[2], y[3]);
  *reinterpret_cast<float4*>(m.xs + i) = make_float4(
      tmap_term(y[0], t4.x), tmap_term(y[1], t4.y), tmap_term(y[2], t4.z), tmap_term(y[3], t4.w));
}

// The recompute's GroupNorm -> ReLU (rows_gn, the rows forward's, a slice
// of whole groups a CTA): r = relu(GN(x)) (f32 holding bf16 values, for
// the weight gradients), the conv input as bf16 into xa, GroupNorm k's
// statistics into stats.
__global__ void rows_bwd_gn_relu_kernel(const float* __restrict__ x,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ bias, Shape s,
                                        float* __restrict__ r, uint16_t* __restrict__ xa,
                                        float* __restrict__ stats, int k) {
  const size_t n = (size_t)s.H * s.W * s.C;
  rows_gn(
      x, scale, bias, s,
      [&](int b, size_t e, float (&y)[4]) {
#pragma unroll
        for (int j = 0; j < 4; ++j) y[j] = y[j] < 0.f ? 0.f : y[j];
        *reinterpret_cast<float4*>(r + b * n + e) = make_float4(y[0], y[1], y[2], y[3]);
        *reinterpret_cast<uint2*>(xa + b * n + e) = bf16x4_bits(y);
      },
      stats, k);
}

// GN3 of v (the conv2 output) for one slice: f; then the GN3 backward
// under the rounded cotangent: gv into gv and as bf16 into xa (the conv2
// input gradient's input), conv2's parameter partials, and the t
// gradient's per-channel sums into chan_t (B, 2, C) at conv 0.
__global__ void rows_bwd_gv_kernel(const float* __restrict__ t, const float* __restrict__ g,
                                   Odefunc p, Shape s, const float* __restrict__ v,
                                   float* __restrict__ fout, float* __restrict__ gv,
                                   uint16_t* __restrict__ xa, float* __restrict__ part,
                                   float* __restrict__ chan_t) {
  const RowsSlice sl = rows_slice(s, blockIdx.x);
  const RowsBwdSmem m = rows_bwd_carve(sl);
  const size_t off = (size_t)sl.b * sl.hw * s.C;
  float* pb = part + (size_t)sl.b * kParts * s.C;
  rows_bwd_stage(sl, s, m, v, g, nullptr, -1);
  slice_stats(sl, s, m.xs, m.red, m.mean, m.inv);
  const Col4 k = col4(sl, s, m.mean, m.inv, p.n3s, p.n3b);
  slice_gn_backward(
      sl, s, m, p.n3s, pb + 4 * s.C, pb + 5 * s.C, [&](int i) { return bf16_round(m.dy[i]); },
      [&](int i, size_t e, const float (&y)[4]) {
        float f4[4];  // f = GN3(v), before the time-map terms take v's place
#pragma unroll
        for (int j = 0; j < 4; ++j)
          f4[j] = gn_affine<kBf16>(m.xs[i + j], k.mean[j], k.inv[j], k.sc[j], k.bi[j]);
        *reinterpret_cast<float4*>(fout + off + e) = make_float4(f4[0], f4[1], f4[2], f4[3]);
        rows_bwd_out(m, i, y, p.m2 + e);
        *reinterpret_cast<float4*>(gv + off + e) = make_float4(y[0], y[1], y[2], y[3]);
        *reinterpret_cast<uint2*>(xa + off + e) = bf16x4_bits(y);
      });
  __syncthreads();
  slice_conv_param_grads(sl, s, m.red, m.dy, m.xs, bf16_round(t[sl.b]), pb + 7 * s.C,
                         pb + 17 * s.C, chan_t + (size_t)sl.b * 2 * s.C);
}

// ReLU2 + GN2 backward of one slice from the conv2 input gradient sx
// (rounded sums): gu into gu and as bf16 into xa, conv1's parameter
// partials and its t gradient's per-channel sums (chan_t, conv 1).  The
// first slice's thread 0 also sets dt to conv2's t gradient (rows_gv's
// sums, all channels).
__global__ void rows_bwd_gu_kernel(const float* __restrict__ t, Odefunc p, Shape s,
                                   const float* __restrict__ u, const float* __restrict__ sx,
                                   const float* __restrict__ stats, float* __restrict__ gu,
                                   uint16_t* __restrict__ xa, float* __restrict__ part,
                                   float* __restrict__ chan_t, float* __restrict__ dt) {
  const RowsSlice sl = rows_slice(s, blockIdx.x);
  const RowsBwdSmem m = rows_bwd_carve(sl);
  const size_t off = (size_t)sl.b * sl.hw * s.C;
  float* pb = part + (size_t)sl.b * kParts * s.C;
  float* cb = chan_t + (size_t)sl.b * 2 * s.C;
  const bool first = sl.c0 == 0;
  rows_bwd_stage(sl, s, m, u, sx, stats, 1, first ? cb : nullptr);
  rows_bwd_relu_mask(sl, s, m, p.n2s, p.n2b);
  slice_gn_backward(sl, s, m, p.n2s, pb + 2 * s.C, pb + 3 * s.C, [&](int i) { return m.dy[i]; },
                    [&](int i, size_t e, const float (&y)[4]) {
                      rows_bwd_out(m, i, y, p.m1 + e);
                      *reinterpret_cast<float4*>(gu + off + e) =
                          make_float4(y[0], y[1], y[2], y[3]);
                      *reinterpret_cast<uint2*>(xa + off + e) = bf16x4_bits(y);
                    });
  __syncthreads();
  slice_conv_param_grads(sl, s, m.red, m.dy, m.xs, bf16_round(t[sl.b]), pb + 6 * s.C,
                         pb + 8 * s.C, cb + s.C);
  if (first && threadIdx.x == 0) dt[sl.b] = rows_bwd_dt(m.dtc, s.C);
}

// ReLU1 + GN1 backward of one slice: dh, over the conv1 input gradient's
// rounded sums, which dh holds (the slice is staged whole before any of it
// is written, and no other CTA writes it).  The first slice's thread 0
// also adds conv1's t gradient to dt: dt = bf16(dt + bf16(its sum)).
__global__ void rows_bwd_dh_kernel(const float* __restrict__ h, Odefunc p, Shape s,
                                   const float* __restrict__ stats, float* __restrict__ part,
                                   const float* __restrict__ chan_t, float* __restrict__ dt,
                                   float* dh) {
  const RowsSlice sl = rows_slice(s, blockIdx.x);
  const RowsBwdSmem m = rows_bwd_carve(sl);
  float* db = dh + (size_t)sl.b * sl.hw * s.C;
  float* pb = part + (size_t)sl.b * kParts * s.C;
  const bool first = sl.c0 == 0;
  rows_bwd_stage(sl, s, m, h, dh, stats, 0,
                 first ? chan_t + ((size_t)sl.b * 2 + 1) * s.C : nullptr);
  rows_bwd_relu_mask(sl, s, m, p.n1s, p.n1b);
  slice_gn_backward(sl, s, m, p.n1s, pb, pb + s.C, [&](int i) { return m.dy[i]; },
                    [&](int, size_t e, const float (&y)[4]) {
    *reinterpret_cast<float4*>(db + e) = make_float4(y[0], y[1], y[2], y[3]);
  });
  if (first && threadIdx.x == 0) dt[sl.b] = bf16_round(dt[sl.b] + rows_bwd_dt(m.dtc, s.C));
}

// The four convs' epilogues as one type, so that one rows_conv_kernel build
// serves them (each build adds to the source's compile time): the
// recompute's concat_out<kBf16> (ConcatEpi) into u, or where bias is null an
// input gradient's sums, each rounded once (the bf16 conv's rounding,
// bwd_sample_kernel's to_sx), into u (rows, C).
struct RowsBwdEpi {
  ConcatEpi e;
  __device__ __forceinline__ void operator()(int r, int co, float v0, float v1) const {
    if (e.bias)
      e(r, co, v0, v1);
    else
      *reinterpret_cast<float2*>(e.u + (size_t)r * e.C + co) =
          make_float2(bf16_round(v0), bf16_round(v1));
  }
};

// The rows backward's per-sample pass (the head of this file) on stream st.
int launch_rows_bwd(const float* t, const float* h, const float* g, const Odefunc& p, float* f,
                    float* dh, float* dt, float* r1, float* r2, float* gu, float* gv,
                    float* part, float* ug, int B, int H, int W, int C, int G, void* scratch,
                    cudaStream_t st) {
  if (!scratch || !ug || !rows_ok(B, H, W, C)) return (int)cudaErrorInvalidValue;
  const Shape s = make_shape(H, W, C, G);
  const size_t gsm = rows_gn_smem_bytes(s), bsm = rows_bwd_slice_smem_bytes(H, W, C, G);
  const int rows = B * H * W, sms = rows_sm_count();
  const int gb = B * rows_slices(G), gt = rows_slice_threads(G);  // a slice a CTA
  uint8_t* base = static_cast<uint8_t*>(scratch);
  uint16_t* xa = reinterpret_cast<uint16_t*>(base);
  uint8_t* wp = base + rows_scratch_bytes(B, H, W, C, true) - rows_pack_bytes(true, C);
  float* stats = reinterpret_cast<float*>(base + rows_scratch_bytes(B, H, W, C, true));
  float* chan_t = stats + 4 * (size_t)B * G;
  const int tile = rows_tile_rows(rows, C, sms);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(rows_bwd_gn_relu_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)gsm)) ||
      (err = cudaFuncSetAttribute(rows_bwd_gv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bsm)) ||
      (err = cudaFuncSetAttribute(rows_bwd_gu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bsm)) ||
      (err = cudaFuncSetAttribute(rows_bwd_dh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bsm)))
    return (int)err;
  int code;
  const RowsBwdEpi rounded{{nullptr, nullptr, nullptr, dh, H * W, C}};
  // The forward recompute: r1, u (in ug), r2, v (in dh).
  rows_bwd_gn_relu_kernel<<<gb, gt, gsm, st>>>(h, p.n1s, p.n1b, s, r1, xa, stats, 0);
  if ((err = cudaGetLastError())) return (int)err;
  if ((code = rows_conv<true>(xa, p.w1, wp, rows, H, W, C, tile,
                              RowsBwdEpi{{p.b1, p.m1, t, ug, H * W, C}}, st)))
    return code;
  rows_bwd_gn_relu_kernel<<<gb, gt, gsm, st>>>(ug, p.n2s, p.n2b, s, r2, xa, stats, 1);
  if ((err = cudaGetLastError())) return (int)err;
  if ((code = rows_conv<true>(xa, p.w2, wp, rows, H, W, C, tile,
                              RowsBwdEpi{{p.b2, p.m2, t, dh, H * W, C}}, st)))
    return code;
  // f, gv; the conv2 input gradient; gu; the conv1 input gradient; dh.
  rows_bwd_gv_kernel<<<gb, gt, bsm, st>>>(t, g, p, s, dh, f, gv, xa, part, chan_t);
  if ((err = cudaGetLastError())) return (int)err;
  if ((code = rows_conv<true, true>(xa, p.w2, wp, rows, H, W, C, tile, rounded, st)))
    return code;
  rows_bwd_gu_kernel<<<gb, gt, bsm, st>>>(t, p, s, ug, dh, stats, gu, xa, part, chan_t, dt);
  if ((err = cudaGetLastError())) return (int)err;
  if ((code = rows_conv<true, true>(xa, p.w1, wp, rows, H, W, C, tile, rounded, st)))
    return code;
  rows_bwd_dh_kernel<<<gb, gt, bsm, st>>>(h, p, s, stats, part, chan_t, dt, dh);
  return (int)cudaGetLastError();
}

// The weight gradients into wpart (ns, 2, 9, C, C): bwd_weight_kernel
// or bwd_weight_kernel_mma, as `which` says (WeightKernel).
template <bool kExact>
cudaError_t launch_weights(const float* r1, const float* r2, const float* gu, const float* gv,
                           const Shape& s, int B, int ns, float* wpart, int which,
                           cudaStream_t st) {
  const int C = s.C;
  cudaError_t err;
  if (which == kWeightsWgmma && !wgmma_weights_ok(s)) return cudaErrorInvalidValue;
  if (which == kWeightsWgmma || (which == kWeightsPath && wgmma_weights(s))) {
    const auto weight = bwd_weight_kernel<kExact>;
    const size_t wsmem = wgmma_weight_smem_bytes(s, kExact);
    if ((err = cudaFuncSetAttribute(weight, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)wsmem)) != cudaSuccess)
      return err;
    const int tiles = (C + 63) / 64;
    weight<<<dim3(2 * 3 * ns, tiles, tiles), kWgThreads, wsmem, st>>>(r1, r2, gu, gv, s, B, ns,
                                                                      wpart);
    return cudaGetLastError();
  }
  const int tile = weight_tile(C);
  const auto weight = tile == 64 ? bwd_weight_kernel_mma<64, kExact>
                                 : bwd_weight_kernel_mma<32, kExact>;
  const size_t wsmem = mma_weight_smem_bytes(s);
  if ((err = cudaFuncSetAttribute(weight, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)wsmem)) != cudaSuccess)
    return err;
  const dim3 wgrid(2 * (9 / weight_taps_of(tile)) * ns, C / tile, C / tile);
  weight<<<wgrid, 32 * (tile == 64 ? weight_warps(64) : weight_warps(32)), wsmem, st>>>(
      r1, r2, gu, gv, s, B, ns, wpart);
  return cudaGetLastError();
}

// The per-sample pass (the cluster pass where pair_ok, the rows backward
// where rows, else bwd_sample_kernel), then the weight gradients
// (launch_weights; mma_weights: the mma.sync kernel at every shape) and the
// reduction over the batch, on the caller's stream.
template <int kPrec>
int backward(const float* t, const float* h, const float* g, const Odefunc& p,
             const float* w1bt, const float* w2bt, float* f, float* dh, float* dt,
             float* r1, float* r2, float* gu, float* gv, float* part, float* wpart,
             float* ug, float* dk1, float* dk2, float* dvec, int B, int H, int W, int C,
             int G, int ns, bool rows, void* scratch, void* stream, bool mma_weights = false) {
  if (!bwd_shape_ok(H, W, C, G) || B < 1 || ns < 1 || ns > B)
    return (int)cudaErrorInvalidValue;
  const Shape s = bwd_shape(H, W, C, G);
  if (!s.mma && (w1bt == nullptr || w2bt == nullptr)) return (int)cudaErrorInvalidValue;
  if (s.ug && ug == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (pair_ok(H, W, C, G)) {  // the cluster pass, two CTAs a sample
    const size_t smem = pair_smem_bytes(s, kPrec);
    const auto pass = bwd_sample_kernel_cluster<kPrec>;
    if ((err = cudaFuncSetAttribute(pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess)
      return (int)err;
    pass<<<2 * B, kPairThreads, smem, st>>>(t, h, g, p, s, f, dh, dt, r1, r2, gu, gv, part);
  } else if (rows) {  // the rows backward (bf16, rows_bwd_ok: never pair_ok's C = 64)
    const int code = launch_rows_bwd(t, h, g, p, f, dh, dt, r1, r2, gu, gv, part, ug, B, H, W,
                                     C, G, scratch, st);
    if (code) return code;
  } else {
    const size_t smem = bwd_smem_bytes(s);
    const auto sample = !wide_shape(s) ? bwd_sample_kernel<false, false, kPrec>
                        : s.xg        ? bwd_sample_kernel<true, true, kPrec>
                                      : bwd_sample_kernel<true, false, kPrec>;
    if ((err = cudaFuncSetAttribute(sample, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess)
      return (int)err;
    sample<<<B, kThreads, smem, st>>>(t, h, g, p, w1bt, w2bt, s, f, dh, dt, r1, r2, gu, gv,
                                      part, s.ug ? ug : nullptr);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = launch_weights<kPrec == kBf16>(r1, r2, gu, gv, s, B, ns, wpart,
                                            mma_weights ? kWeightsMma : kWeightsPath, st)))
    return (int)err;
  const int total = 2 * 9 * (C + 1) * C + 8 * C;
  bwd_reduce_kernel<kPrec == kBf16><<<(total + 255) / 256, 256, 0, st>>>(wpart, part, s, B, ns,
                                                                        dk1, dk2, dvec);
  return (int)cudaGetLastError();
}

}  // namespace nodef

// Scratch, allocated by the wrapper: r1, r2, gu, gv (B, H*W*C) each, part
// (B, 26, C), wpart (ns, 2, 9, C, C), and u (B, H*W*C) where bwd_shape's ug
// or the rows backward runs (else it may be null).  ns, the weight
// gradient's row chunks (1 to B),
// is the wrapper's choice (kernels/odefunc_bwd.py weight_splits), which
// sizes wpart by it.  w1bt, w2bt (the tap-flipped, transposed
// kernels) are read only by the FFMA stage and may be null where make_shape
// picks the tensor-core stage.  odefunc_backward_bf16 takes the same
// arguments and shapes, and last the rows backward's scratch (at least
// rows_bwd_scratch_bytes where rows_bwd_ok, else unused).
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
                                      wpart, ug, dk1, dk2, dvec, B, H, W, C, G, ns, false,
                                      nullptr, stream);
}

// The bf16 VJP: the rows backward where rows_bwd_ok, else the cluster or
// the one-CTA pass.
extern "C" int odefunc_backward_bf16(NODEF_BACKWARD_ARGS, void* scratch) {
  const nodef::Odefunc p{n1s, n1b, w1, b1, m1, n2s, n2b, w2, b2, m2, n3s, n3b};
  return nodef::backward<nodef::kBf16>(t, h, g, p, w1bt, w2bt, f, dh, dt, r1, r2, gu, gv, part,
                                       wpart, ug, dk1, dk2, dvec, B, H, W, C, G, ns,
                                       nodef::rows_bwd_ok(H, W, C, G), scratch, stream);
}

// The bf16 VJP on the per-sample passes at every shape they take, the rows
// backward's shapes too: a reading for measurement (probes/timing_aids.py
// odefunc_bwd_cta_bf16), on no path.
extern "C" int odefunc_backward_bf16_cta(NODEF_BACKWARD_ARGS) {
  const nodef::Odefunc p{n1s, n1b, w1, b1, m1, n2s, n2b, w2, b2, m2, n3s, n3b};
  return nodef::backward<nodef::kBf16>(t, h, g, p, w1bt, w2bt, f, dh, dt, r1, r2, gu, gv, part,
                                       wpart, ug, dk1, dk2, dvec, B, H, W, C, G, ns, false,
                                       nullptr, stream);
}

// Both builds with the weight gradients on the mma.sync kernel at every
// shape (bwd_weight_kernel_mma, what bwd_weight_kernel replaced where
// C % 64 == 0):
// readings for measurement (probes/timing_aids.py odefunc_bwd_mma_weights),
// on no path.
extern "C" int odefunc_backward_mma_weights(NODEF_BACKWARD_ARGS) {
  const nodef::Odefunc p{n1s, n1b, w1, b1, m1, n2s, n2b, w2, b2, m2, n3s, n3b};
  return nodef::backward<nodef::kF32>(t, h, g, p, w1bt, w2bt, f, dh, dt, r1, r2, gu, gv, part,
                                      wpart, ug, dk1, dk2, dvec, B, H, W, C, G, ns, false,
                                      nullptr, stream, true);
}
extern "C" int odefunc_backward_bf16_mma_weights(NODEF_BACKWARD_ARGS, void* scratch) {
  const nodef::Odefunc p{n1s, n1b, w1, b1, m1, n2s, n2b, w2, b2, m2, n3s, n3b};
  return nodef::backward<nodef::kBf16>(t, h, g, p, w1bt, w2bt, f, dh, dt, r1, r2, gu, gv, part,
                                       wpart, ug, dk1, dk2, dvec, B, H, W, C, G, ns,
                                       nodef::rows_bwd_ok(H, W, C, G), scratch, stream, true);
}

// The weight-gradient launch alone, on the residuals of a backward call
// (r1, r2, gu, gv, (B, H*W*C) each), into wpart (ns, 2, 9, C, C): exact
// (the bf16 build's one TF32 pass) or 3xTF32, on the kernel `which` names
// (nodef::WeightKernel: 0 the path's, 1 the mma.sync kernel, 2
// bwd_weight_kernel wherever it can run): the two kernels' bits and device
// time in turns (probes/timing_aids.py bwd_weight_partials), on no path.
extern "C" int odefunc_bwd_weight_grads(const float* r1, const float* r2, const float* gu,
                                        const float* gv, float* wpart, int B, int H, int W,
                                        int C, int G, int ns, int exact, int which,
                                        void* stream) {
  if (!nodef::bwd_shape_ok(H, W, C, G) || B < 1 || ns < 1 || ns > B || which < 0 || which > 2)
    return (int)cudaErrorInvalidValue;
  const nodef::Shape s = nodef::bwd_shape(H, W, C, G);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(exact ? nodef::launch_weights<true>(r1, r2, gu, gv, s, B, ns, wpart, which, st)
                     : nodef::launch_weights<false>(r1, r2, gu, gv, s, B, ns, wpart, which, st));
}
