// One evaluation of the ODE-Net dynamics f(t, h) for ONE sample, by one CTA:
//
//     GN -> ReLU -> [conv3x3(h, W1) + b1 + t*M1] -> GN -> ReLU
//        -> [conv3x3(h, W2) + b2 + t*M2] -> GN
//
// Shared by csrc/odefunc.cu (one f per launch), csrc/rk_step.cu (six f
// per launch inside one dopri5 attempt), csrc/odefunc_bwd.cu (the forward
// recompute and the input-gradient convs) and csrc/conv_probe.cu (the conv
// stages alone).  ConcatConv uses the split form of ops/layers.py: the time
// channel contributes t*M, with the border-aware map
// M = conv(ones, W[:, :, :1, :]) precomputed in strict f32 by the wrapper,
// so the contraction here is a clean C -> C 3x3 conv.
//
// Layout: the state of one sample is NHWC-flat, element e = (y*W + x)*C + c,
// the same order as the port's public (B, H*W*C) solver state, so the
// kernels read and write the solver's tensors directly.  Thread tid visits
// the elements e = tid + j*kThreads (coalesced); where C divides kThreads
// they all lie in the channel tid % C, elsewhere (C = 96, 160, ...) the
// channel steps along with j (Walk).
//
// The conv has three stages; which one a kernel runs is decided from the
// shape and the precision alone (make_shape, mirrored by kernels/odefunc.py
// `stage`):
//
//   * conv3x3_wgmma ("wgmma3"; the kF32 evaluations at the shapes of
//     wgmma_ok, among them 7x7x64 and 6x6x64): the arithmetic of
//     conv3x3_mma<3> below on Hopper's warpgroup products,
//     wgmma.mma_async.m64n32k8 TF32 with A from registers and B from shared
//     memory; see its note.  Its bf16 build ("wgmma_bf16"; the kBf16 and
//     kBf16Conv evaluations at the same shapes) is conv3x3_mma<kPassBf16>'s
//     arithmetic on wgmma.mma_async.m64n32k16 bf16.
//   * conv3x3_mma (C a multiple of 32 from 64 to 512 and H*(W+2) <= 64: 7x7
//     and 6x6 maps): an implicit GEMM on the tensor cores, mma.sync.m16n8k8
//     TF32 with f32 accumulation
//     and "3xTF32" error compensation.  Every f32 operand x is split in
//     registers into a TF32 head hi = rna(x) (round to nearest, ties away)
//     and a tail lo = x - hi, of which the tensor core reads the TF32 part;
//     each operand pair contributes a_lo*b_hi, a_hi*b_lo and then a_hi*b_hi
//     to the f32 accumulator, so a product carries an error near 2^-21
//     (f32-grade) in place of TF32's 2^-11.  M runs over the
//     padded-pitch positions q = y*(W+2) + x of one sample (the two border
//     columns of each row are computed and dropped), so the A rows of tap
//     (ky, kx) are the rows q + ky*(W+2) + kx of the zero-bordered spad:
//     one uniform row stride and no gather.  N = C in blocks of 64 output
//     channels, one after the other; K = 9*C as (tap, 64-channel input
//     block) tiles.  Where C is not a multiple of 64 the last block is
//     padded: spad's channels C..64*nblk-1 stay zero, the weight tiles'
//     rows and columns beyond C are zero-filled by cp.async, the k half of
//     a tile that lies wholly beyond C is skipped (it adds exact zeros) and
//     output channels >= C are dropped.  The 16 warps tile a 64x64 output
//     block as 2 (M) x 4 (N)
//     warps of 32x16, times 2 halves of every tile's input channels; the two
//     halves' partial sums are added through shared memory, first half +
//     second half.  Within a k8
//     step a thread's two k columns are (2t, 2t+1), not (t, t+4) (A and B
//     agree, and a sum over k has no order), which makes each A fragment row
//     one 8-byte load.  spad rows are 64*nblk + 8 floats apart and weight
//     rows 68 or 72, so that no fragment load has a bank conflict.  The f32
//     weights of a (64, 64) tile are staged by cp.async through a ring of
//     three buffers, two tiles ahead of the products (two buffers, one tile
//     ahead, where shared memory is short: fit_layout); they are never
//     split in global memory.
//   * conv3x3 (every other supported shape, and the probe's tap9 baseline):
//     strict f32 FFMA on the CUDA cores, thread -> (output channel
//     co = tid % C, pixel group pg = tid / C), at most kMaxPix pixels per
//     thread, each tap's (C, C) weights double-buffered by cp.async.
//
// Each stage has a bf16 build, "bf16 multiplies, f32 accumulation" (the TPU
// kernels' bf16 modes): conv3x3_mma<kPassBf16> packs both operands to bf16
// (round to nearest even) as it builds the fragments of one
// mma.sync.m16n8k16 bf16 pass, wgmma_conv<..., kBf16> converts each weight
// tile to bf16 once per CTA and packs A as conv3x3_mma<kPassBf16> does, and
// conv3x3<true> rounds the weights as it reads them and takes a conv input
// that its writer has rounded.  The tap sums and their order are those of
// the f32 builds.  Which build an evaluation runs is its precision (PREC
// below):
//   kF32       every f32 kernel: the conv stage above, the rest f32;
//   kBf16Conv  the fused step's conv_precision='bf16': the conv input is
//              rounded where it is written and the convs run the bf16
//              stage (wgmma_bf16 where wgmma_ok, as kBf16); GroupNorm,
//              bias, time map and stage sums stay f32;
//   kBf16      compute_dtype='bfloat16' dynamics, the port's plain bf16
//              path (kernels/odefunc.py odefunc_plain, precision 'bf16'):
//              h rounded on entry; each GroupNorm's normalised value, its
//              scale product and its bias sum rounded (statistics in f32);
//              the bf16 conv stage, then the conv output, its sum with the
//              bias, t*M (t and M rounded) and the last sum each rounded.
//              The conv output is rounded before the bias add, as a bf16
//              conv and a bias add round on the card (cuDNN) and in the JAX
//              jnp path; the CPU library folds the bias into the conv's one
//              rounding.  f leaves as f32 holding bf16 values.
//
// GroupNorm uses the centred variance, as the JAX package does: per-(pixel
// group, channel) partial sums in shared memory, then every thread adds up
// its own group's partials (in the order pixel group, then channel) and
// keeps the statistics of its channel's group in registers.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace nodef {

constexpr int kThreads = 512;  // threads per CTA, one CTA per sample
constexpr int kMaxC = 512;     // the widest C (the JAX kernels' gate too)
constexpr int kMaxPix = 8;     // FFMA conv: output pixels per thread
constexpr float kEps = 1e-5f;  // GroupNorm epsilon

constexpr int kMmaC = 64;      // channels of one block of the tensor-core stage
constexpr int kMmaStep = 32;   // its C granularity: one k half of a block
constexpr int kMmaM = 64;      // padded-pitch positions of its M tile
constexpr int kPadA = 8;       // floats added to spad's row pitch
constexpr int kPitchB = 68;    // weight row pitch, tap stored (ci, co)
constexpr int kPitchBT = 72;   // weight row pitch, tap stored (co, ci)
constexpr int kRing = 3;       // weight buffers in flight (2 where short)
constexpr int kWgN = 32;       // wgmma3: output channels of one warpgroup's product
constexpr int kTileF = kMmaC * kMmaC;  // floats of one (64, 64) weight tile
constexpr int kHalfTileF = kTileF / 2;  // floats of half a tile: 32 output channels
// wgmma3's weight area: the TF32 head and tail tiles in the order the
// tensor cores read, the f32 tile as copied, its two mbarriers (16 bytes).
constexpr int kWgFloats = 3 * kTileF + 4;

// The precision of one evaluation (see the head of this file), and the
// conv3x3_mma PASSES value of its one-pass bf16 build.
constexpr int kF32 = 0, kBf16Conv = 1, kBf16 = 2;
constexpr int kPassBf16 = 16;

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

// P: spad's row pitch in floats, R: its rows, mma: the conv stage (0 FFMA,
// 1 tensor cores), wg: the evaluation's convs run wgmma_conv (wgmma3 in
// kF32, wgmma_bf16 in kBf16), nblk: its
// 64-channel blocks (ceil(C / 64)).  npg = kThreads / C (floor) pixel
// groups of C threads each; gs = C / G channels per group; cdiv: C divides
// kThreads (a power of two, as is gs then), with lc = log2 C and
// lgs = log2 gs (the narrow build's shifts); dc = kThreads % C, the
// channel step of Walk.  ring: weight
// buffers of the tensor-core stage; xg (and, in the backward, ug): the
// state x (the conv1 output u) lives in per-sample global scratch in place
// of shared memory (fit_layout).  cmagic, gmagic, wmagic, pmagic, bmagic:
// ceil(2^32 / d) for d = C, gs, W, W+2 and nblk, which turn the divisions
// by them into a multiply (div_magic).
struct Shape {
  int H, W, C, G, P, R, mma, wg, nblk;
  int npg, gs, cdiv, dc, lc, lgs;
  int ring, xg, ug;
  unsigned cmagic, gmagic, wmagic, pmagic, bmagic;
};

inline int log2_floor(int v) {
  int l = 0;
  while ((2 << l) <= v) ++l;
  return l;
}

inline unsigned magic_of(int d) {  // d == 1 has no 32-bit magic: see div_magic
  return d > 1 ? (unsigned)(((1ull << 32) + d - 1) / d) : 0u;
}

// The shapes the tensor-core stage takes: C a multiple of 32 from 64 to 512
// (64-channel blocks, the last one padded where C % 64 == 32), and the map's
// padded-pitch positions within one 64-row tile.  kernels/odefunc.py
// (stage) is the same gate in Python.
inline bool mma_ok(int H, int W, int C) {
  return C >= kMmaC && C <= kMaxC && C % kMmaStep == 0 && H >= 1 && W >= 1 &&
         H * (W + 2) <= kMmaM;
}

// The shapes whose kF32 convs run wgmma3 in place of conv3x3_mma<3>, and
// whose kBf16 convs run wgmma_bf16 in place of conv3x3_mma<kPassBf16>: the
// tensor-core shapes of C = 64 (the main path's 7x7x64, the MNIST block's
// 6x6x64).  At C = 96 to 448 the chip read wgmma3 2.1 to 2.4 times slower
// than mma3 per conv (one CTA an SM there, so nothing overlaps its
// per-tile copy, split and barriers; PERF.md, PR 18), and from 480 its
// backward does not fit.  kernels/odefunc.py (stage, WGMMA_C) is the same
// gate.
inline bool wgmma_ok(int H, int W, int C) {
  return mma_ok(H, W, C) && C == kMmaC;
}

// spad of the tensor-core stage has slack rows at its end: the last M-tile
// rows read up to row kMmaM - 1 + 2*(W+2) + 2.
inline Shape ffma_shape(int H, int W, int C, int G) {
  const int c = C > 0 ? C : 1, gs = G > 0 && C >= G ? C / G : 1;
  return Shape{H, W, C, G, C, (H + 2) * (W + 2), 0, 0, 1,
               kThreads / c, gs, kThreads % c == 0, kThreads % c,
               log2_floor(c), log2_floor(gs), kRing, 0, 0,
               magic_of(c), magic_of(gs), magic_of(W), magic_of(W + 2), 0u};
}

// Floats of the weight buffers: the ring of the tensor-core stage (which
// also holds the 64x64 partial sums of the second k half), or the FFMA
// stage's double buffer.  Where wg, the area holds wgmma3's tiles too (the
// kernels that run wgmma3 run the ring's stage in their other convs: the
// backward's input gradients).
__host__ __device__ inline int weight_floats(const Shape& s) {
  if (!s.mma) return 2 * s.C * s.C;
  const int ring = s.ring * kMmaC * kPitchBT;
  return s.wg && kWgFloats > ring ? kWgFloats : ring;
}

// Dynamic shared memory, in floats, in this order:
//   sx    [H*W*C]       pre-norm state of the sample, unless xg
//   spad  [R*P]         relu(GN(.)) with a zero border: the conv input
//   sw    [weight_floats]
//   sred  [2*kThreads]  per-(pixel group, channel) partial sums, two buffers
//   smean [G], sinv [G] group statistics
// kernels/odefunc.py (layout) mirrors this formula for the gate.
inline size_t odefunc_smem_bytes(const Shape& s) {
  return sizeof(float) * ((s.xg ? 0 : (size_t)s.H * s.W * s.C) + (size_t)s.R * s.P +
                          (size_t)weight_floats(s) + 2 * kThreads + 2 * (size_t)s.G);
}

// The largest dynamic shared memory one CTA may use on sm_90 (227 KB), less
// 1 KB for the rk-step kernel's static tableau.
constexpr size_t kMaxSmem = 232448 - 1024;

// Every kernel is compiled three times, by its conv stage's width and where
// the state x lives (the template arguments kWide, kXg of each kernel; the
// launcher picks by wide_shape and s.xg):
//   narrow (the FFMA stage, or the tensor cores at C = 64):
//     __launch_bounds__(kThreads, 2), at most 64 registers a thread, the
//     tensor-core stage's block loops folded to one block and its ring to
//     three buffers at compile time, and C dividing kThreads;
//   wide (the tensor cores at C = 96 to 512, whose working set fills an
//     SM's shared memory alone): __launch_bounds__(kThreads, 1), up to 128;
//   wide with x in global scratch (fit_layout's xg): the same, with x's
//     loads and stores global ones.  x's home is known at compile time in
//     every build, so that the others address it in shared memory.
inline bool wide_shape(const Shape& s) { return s.mma && s.C > kMmaC; }
constexpr int min_blocks(bool wide) { return wide ? 1 : 2; }

// The layout of a wide shape whose working set bytes(s) does not fit: first
// u (the backward's conv1 output, where with_u), then x move to per-sample
// global scratch, then the weight ring drops to two buffers.  The values do
// not depend on the layout.  kernels/odefunc.py (layout) mirrors it.
template <class Bytes>
inline void fit_layout(Shape& s, bool with_u, Bytes bytes) {
  if (!wide_shape(s)) return;
  if (with_u && bytes(s) > kMaxSmem) s.ug = 1;
  if (bytes(s) > kMaxSmem) s.xg = 1;
  if (bytes(s) > kMaxSmem) s.ring = 2;
}

// Every precision runs wgmma_conv where wgmma_ok (conv_stage): wgmma3 in
// kF32, wgmma_bf16 in kBf16 and in kBf16Conv (the fused step's bf16 convs;
// mma.sync's bits, as in kBf16).
inline Shape make_shape(int H, int W, int C, int G) {
  Shape s = ffma_shape(H, W, C, G);
  if (mma_ok(H, W, C)) {
    s.nblk = (C + kMmaC - 1) / kMmaC;
    s.P = s.nblk * kMmaC + kPadA;
    s.R = kMmaM + 2 * (W + 2) + 2;
    s.mma = 1;
    s.wg = wgmma_ok(H, W, C);
    s.bmagic = magic_of(s.nblk);
  }
  fit_layout(s, false, odefunc_smem_bytes);
  return s;
}

// The shapes the kernels take; kernels/odefunc.py (refusal) is the same
// gate in Python.  layout_ok: a shape under a given layout (make_shape's, or
// ffma_shape's for the probe's FFMA baseline).
inline bool layout_ok(const Shape& s) {
  if (s.H < 1 || s.W < 1 || s.C < 4 || s.G < 1 || s.C % 4 || s.C % s.G || s.C > kMaxC)
    return false;
  if (!s.mma && !s.cdiv) return false;  // FFMA: thread -> (channel, pixel group)
  if (odefunc_smem_bytes(s) > kMaxSmem) return false;
  if (s.mma) return true;
  return (s.H * s.W + s.npg - 1) / s.npg <= kMaxPix;
}

inline bool shape_ok(int H, int W, int C, int G) {
  return layout_ok(make_shape(H, W, C, G));
}

struct Smem { float* sx; float* spad; float* sw; float* sred; float* smean; float* sinv; };

// XG: the sample's global scratch xg (H*W*C floats) stands in for sx
// (s.xg); written and read back by this CTA only.
template <bool XG>
__device__ __forceinline__ Smem carve(float* base, const Shape& s, float* xg) {
  Smem m;
  float* p = base;
  if (XG) {
    m.sx = xg;
  } else {
    m.sx = p;
    p += s.H * s.W * s.C;
  }
  m.spad = p;
  m.sw = m.spad + s.R * s.P;
  m.sred = m.sw + weight_floats(s);
  m.smean = m.sred + 2 * kThreads;
  m.sinv = m.smean + s.G;
  return m;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
// The same copy, or 16 zero bytes where !valid (a source size of 0 reads
// nothing).
__device__ __forceinline__ void cp_async16_zfill(float* smem, const float* gmem, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Zero the padded conv input once per launch; only its interior's channels
// < C are written afterwards, so the border, the padding channels of the
// tensor-core stage and the slack rows stay zero (SAME padding).
__device__ __forceinline__ void zero_pad(const Smem& m, const Shape& s) {
  const int n = s.R * s.P;
  for (int i = threadIdx.x; i < n; i += kThreads) m.spad[i] = 0.f;
}

// q / d for 0 <= q < 2^16, with magic = ceil(2^32 / d) (0 for d == 1).
__device__ __forceinline__ int div_magic(int q, unsigned magic) {
  return magic ? (int)__umulhi((unsigned)q, magic) : q;
}

// x rounded to bf16 (to nearest even), as a float.
__device__ __forceinline__ float bf16_round(float x) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(x), "f"(0.f));
  return __uint_as_float(r & 0xffff0000u);
}

// lo and hi rounded to bf16 and packed, lo in the low half (an mma
// fragment register).
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The elements e = tid + j*kThreads of one sample in order, with their
// pixel q(s) = e / C and channel c(s) = e % C.  CDIV: C divides kThreads
// (s.cdiv), a power of two: both by shifts of e, and c is the thread's
// channel.  Else they are stepped along with e, without a division.
template <bool CDIV>
struct Walk;

template <>
struct Walk<true> {
  int e;
  __device__ __forceinline__ explicit Walk(const Shape&) : e(threadIdx.x) {}
  __device__ __forceinline__ void next(const Shape&) { e += kThreads; }
  __device__ __forceinline__ int q(const Shape& s) const { return e >> s.lc; }
  __device__ __forceinline__ int c(const Shape& s) const { return e & (s.C - 1); }
};

template <>
struct Walk<false> {
  int e, q_, c_;
  __device__ __forceinline__ explicit Walk(const Shape& s)
      : e(threadIdx.x), q_(div_magic(threadIdx.x, s.cmagic)), c_(threadIdx.x - q_ * s.C) {}
  __device__ __forceinline__ void next(const Shape& s) {
    e += kThreads;
    q_ += s.npg;
    c_ += s.dc;
    if (c_ >= s.C) {
      c_ -= s.C;
      ++q_;
    }
  }
  __device__ __forceinline__ int q(const Shape&) const { return q_; }
  __device__ __forceinline__ int c(const Shape&) const { return c_; }
};

// The thread's pixel group pg = tid / C and channel c = tid % C, and the
// GroupNorm group of a channel: shifts in the narrow build, where C and gs
// are powers of two.
template <bool WIDE>
__device__ __forceinline__ void thread_slot(const Shape& s, int& pg, int& c) {
  const int tid = threadIdx.x;
  pg = WIDE ? div_magic(tid, s.cmagic) : tid >> s.lc;
  c = WIDE ? tid - pg * s.C : tid & (s.C - 1);
}
template <bool WIDE>
__device__ __forceinline__ int group_of(const Shape& s, int c) {
  return WIDE ? div_magic(c, s.gmagic) : c >> s.lgs;
}

// f(w) at every element w of the thread (Walk); the narrow build knows that
// C divides kThreads.
template <bool WIDE, class F>
__device__ __forceinline__ void each_element(const Shape& s, F f) {
  const int n = s.H * s.W * s.C;
  if (!WIDE || s.cdiv) {
    for (Walk<true> w(s); w.e < n; w.next(s)) f(w);
  } else {
    for (Walk<false> w(s); w.e < n; w.next(s)) f(w);
  }
}

// Index in spad of pixel q, channel c.
__device__ __forceinline__ int pad_at(const Shape& s, int q, int c) {
  const int y = div_magic(q, s.wmagic);
  return ((y + 1) * (s.W + 2) + q - y * s.W + 1) * s.P + c;
}

// Index in spad of the state element e = (y*W + x)*C + c.
__device__ __forceinline__ int pad_index(const Shape& s, int e) {
  const int q = div_magic(e, s.cmagic);
  return pad_at(s, q, e - q * s.C);
}

// Mean and 1/sqrt(var + eps) of one GroupNorm group.
struct Stat { float mean, inv; };

// Group statistics of x (H*W*C, NHWC), centred variance.  Thread tid stands
// for channel c = tid % C of pixel group tid / C; the npg*C threads of
// whole pixel groups add, the rest (C not dividing kThreads) add nothing.
// Returns the statistics of the group of the thread's channel (those of
// every element the thread visits where C divides kThreads), and writes all
// groups' to mean/inv.  Starts reading x (the caller has synchronised);
// where C does not divide kThreads it ends synchronised (mean/inv visible),
// else the caller synchronises before anyone reads mean/inv.  Sums: per
// (pixel group, channel) over its pixels, then over pixel groups and the
// group's channels, in that order.
template <bool WIDE>
__device__ Stat gn_stats(const Smem& m, const Shape& s, const float* x,
                         float* mean, float* inv) {
  const int tid = threadIdx.x, C = s.C;
  int pg, c;
  thread_slot<WIDE>(s, pg, c);
  const int npg = WIDE ? s.npg : kThreads >> s.lc, hw = s.H * s.W;
  const int gs = WIDE ? s.gs : 1 << s.lgs, grp = group_of<WIDE>(s, c);
  const int g0 = WIDE ? grp * gs : grp << s.lgs;
  const bool on = !WIDE || pg < npg;  // the narrow build: C divides kThreads
  const float n = (float)(hw * gs);
  float* red2 = m.sred + kThreads;

  float acc = 0.f;
  if (on)
    for (int p = pg; p < hw; p += npg) acc += x[p * C + c];
  m.sred[tid] = acc;  // tid == pg * C + c
  __syncthreads();
  float tot = 0.f;
  if (on)
    for (int q = 0; q < npg; ++q)
      for (int j = 0; j < gs; ++j) tot += m.sred[q * C + g0 + j];
  Stat st;
  st.mean = tot / n;

  acc = 0.f;
  if (on)
    for (int p = pg; p < hw; p += npg) {
      const float d = x[p * C + c] - st.mean;
      acc = fmaf(d, d, acc);
    }
  red2[tid] = acc;
  __syncthreads();
  tot = 0.f;
  if (on)
    for (int q = 0; q < npg; ++q)
      for (int j = 0; j < gs; ++j) tot += red2[q * C + g0 + j];
  st.inv = 1.0f / sqrtf(tot / n + kEps);
  if (pg == 0 && c == g0) {
    mean[grp] = st.mean;
    inv[grp] = st.inv;
  }
  if (WIDE && !s.cdiv) __syncthreads();
  return st;
}

// One GroupNorm output from x, its group's statistics and its channel's
// scale and bias; kBf16 rounds the normalised value, the scale product and
// the bias sum (scale and bias rounded too), as the plain bf16 path.
template <int PREC>
__device__ __forceinline__ float gn_affine(float x, float mean, float inv, float sc, float bi) {
  if constexpr (PREC == kBf16)
    return bf16_round(bf16_round(bf16_round((x - mean) * inv) * bf16_round(sc)) + bf16_round(bi));
  else
    return (x - mean) * inv * sc + bi;
}

// f(w, y) with y = GN(x) (scale, bias) at every element w of the thread,
// from gn_stats' st (C dividing kThreads) or mean/inv (elsewhere).
template <bool WIDE, int PREC = kF32, class F>
__device__ __forceinline__ void gn_apply(const Shape& s, Stat st, const float* mean,
                                         const float* inv, const float* __restrict__ scale,
                                         const float* __restrict__ bias, const float* x, F f) {
  const int n = s.H * s.W * s.C;
  if (!WIDE || s.cdiv) {  // every element lies in the channel tid % C
    const int c = threadIdx.x & (s.C - 1);
    const float sc = scale[c], bi = bias[c];
    for (Walk<true> w(s); w.e < n; w.next(s))
      f(w, gn_affine<PREC>(x[w.e], st.mean, st.inv, sc, bi));
  } else {
    for (Walk<false> w(s); w.e < n; w.next(s)) {
      const int c = w.c(s), g = div_magic(c, s.gmagic);
      f(w, gn_affine<PREC>(x[w.e], mean[g], inv[g], scale[c], bias[c]));
    }
  }
}

// spad interior = relu(GN(x)), from gn_stats' result.  NaN passes through,
// as in torch.relu.  kBf16Conv rounds it to bf16 here, once, for the bf16
// conv stage (kBf16's GroupNorm output is rounded already).
template <bool WIDE, int PREC = kF32>
__device__ void gn_relu_to_pad(const Smem& m, const Shape& s, const float* x, Stat st,
                               const float* __restrict__ scale,
                               const float* __restrict__ bias) {
  gn_apply<WIDE, PREC>(s, st, m.smean, m.sinv, scale, bias, x, [&](const auto& w, float v) {
    const float r = v < 0.f ? 0.f : v;
    m.spad[pad_at(s, w.q(s), w.c(s))] = PREC == kBf16Conv ? bf16_round(r) : r;
  });
}

// ---- FFMA stage -----------------------------------------------------------

__device__ __forceinline__ void load_tap(float* dst, const float* __restrict__ src, int cc) {
  for (int i = threadIdx.x * 4; i < cc; i += kThreads * 4) cp_async16(dst + i, src + i);
  cp_async_commit();
}

// 3x3 SAME conv of spad with w (9, C, C); the sum at output pixel p and
// channel co is handed to epi(p, co, acc).  Caller synchronises before (spad
// written) and after (whatever epi wrote).  BF16: the bf16 twin, each
// weight rounded to bf16 as it is read, spad rounded by its writer; the
// products of bf16 values are exact in f32, the sums as in the f32 build.
template <bool BF16 = false, class Epi>
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
    base[k] = ((p / s.W) * Wp + p % s.W) * s.P;
    acc[k] = 0.f;
  }

  load_tap(m.sw, w, cc);
  for (int tap = 0; tap < 9; ++tap) {
    cp_async_wait_all();
    __syncthreads();  // tap's weights visible; previous tap's buffer free
    if (tap < 8) load_tap(m.sw + ((tap + 1) & 1) * cc, w + (size_t)(tap + 1) * cc, cc);
    const float* wt = m.sw + (tap & 1) * cc + co;
    const float* in = m.spad + ((tap / 3) * Wp + tap % 3) * s.P;
    for (int ci = 0; ci < C; ci += 4) {
      float w0 = wt[(ci + 0) * C], w1 = wt[(ci + 1) * C];
      float w2 = wt[(ci + 2) * C], w3 = wt[(ci + 3) * C];
      if (BF16) {
        w0 = bf16_round(w0);
        w1 = bf16_round(w1);
        w2 = bf16_round(w2);
        w3 = bf16_round(w3);
      }
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

// ---- tensor-core stage ----------------------------------------------------

// TF32 head of x: round to nearest, ties away from zero, the low 13 mantissa
// bits zero.  The bits of cvt.rna.tf32.f32 for every finite x below the
// overflow threshold, in two integer operations (the conversion instruction
// runs at a fraction of their rate, and the split is what this stage
// spends most of its instructions on).  Inf becomes NaN: both poison a state.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo exactly in f32; the tensor core reads the TF32 part of lo (it
// ignores the low 13 mantissa bits), so the pair stands for x to within
// 2^-21 |x|.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a * b: the same product onto a zero accumulator.
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// d += a (16x16, row) * b (16x8, col), bf16 in (two k values per register,
// the lower k in the low half), f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a * b: the bf16 product onto a zero accumulator.
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

__device__ __forceinline__ uint32_t smem_addr(const float* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ float2 lds2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0,%1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

// Stage one (64, 64) f32 weight tile, rows `ld` floats apart in global
// memory, into a buffer with rows `pitch` floats apart.  PAD: only `rows`
// rows and `cols` columns lie inside the weights (C is not a multiple of
// 64); the rest is zero-filled, each 16-byte chunk wholly in or out.
template <bool PAD>
__device__ __forceinline__ void load_tile_mma(float* dst, const float* __restrict__ src,
                                              int ld, int pitch, int rows, int cols) {
  for (int i = threadIdx.x; i < kMmaC * kMmaC / 4; i += kThreads) {
    const int r = i >> 4, c4 = (i & 15) * 4;
    if (PAD) {
      const bool in = r < rows && c4 < cols;
      cp_async16_zfill(dst + r * pitch + c4, in ? src + r * ld + c4 : src, in);
    } else {
      cp_async16(dst + r * pitch + c4, src + r * ld + c4);
    }
  }
  cp_async_commit();
}

// 3x3 SAME conv of spad on the tensor cores (see the head of this file),
// with the contract of conv3x3: epi(p, co, sum) once per output pixel p and
// channel co < C; the caller synchronises before and after.  PASSES = 3:
// 3xTF32, f32-grade; PASSES = 1: the head product alone (plain TF32; a
// timing and accuracy reading of the probe, on no path); PASSES =
// kPassBf16: one m16n8k16 bf16 pass per 16 channels, both operands rounded
// to bf16 as their fragments are packed.  BT = false: w is
// (9, ci, co), tap order as stored.  BT = true: the taps are read in reverse
// order and each as (co, ci), i.e. the conv with the tap-flipped, transposed
// kernel (the input gradient of the conv with w): the buffer holds a tile
// as (n, k) rows, so a bf16 B register's two k values are one 8-byte load
// of a row where BT = false packs two rows.  WIDE = false: C = 64 is
// known.  GENERAL: the last block may be padded and the ring may hold two
// buffers (both read from s); else the blocks are whole and the ring holds
// kRing, known at compile time (mma_stage picks).
//
// Loops: over the nblk blocks of output channels nb; within one, over the
// 9*nblk tiles i = (tap, input block kb), tap-major, each tile's (64, 64)
// weights w[tap][kb block][nb block] (BT: w[8 - tap][nb block][kb block]).
// At C = 64 there is one block and the tiles are the nine taps.
//
// Order of the sums: the tensor core adds one tile's products (its half of
// the tile's 64 input channels, tail products first within a k8 step; two
// k16 steps in the bf16 pass) onto a zero accumulator; that tile sum is
// added to the running sum by an f32 add on the CUDA cores, tiles in order;
// last, first half + second half.
// The tensor core's own accumulation truncates, so a chain over all nine
// taps would carry a bias of a few 1e-6 of the sum; a chain of one tile (32
// channels, as at C = 64) does not, at any C.
template <int PASSES, bool BT, bool WIDE, bool GENERAL, class Epi>
__device__ void conv3x3_mma(const Smem& m, const Shape& s, const float* __restrict__ w,
                            Epi epi) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kg = warp >> 3, wm = (warp >> 2) & 1, wn = warp & 3;
  const int Wp = s.W + 2, P = s.P, C = WIDE ? s.C : kMmaC;
  const int nblk = WIDE ? s.nblk : 1, ntile = 9 * nblk, ring = GENERAL ? s.ring : kRing;
  const bool pad = GENERAL && C % kMmaC != 0;  // the last block is padded
  constexpr int pitch = BT ? kPitchBT : kPitchB, stage = kMmaC * kPitchBT;
  // Tile i of output block nb into ring buffer buf.
  auto load_tile = [&](int i, int nb, int buf) {
    const int tap = WIDE ? div_magic(i, s.bmagic) : i, kb = i - tap * nblk;
    const int rb = BT ? nb : kb, cb = BT ? kb : nb;
    const float* src = w + (size_t)(BT ? 8 - tap : tap) * C * C + (size_t)rb * kMmaC * C + cb * kMmaC;
    if (pad) load_tile_mma<true>(m.sw + buf * stage, src, C, pitch, C - rb * kMmaC, C - cb * kMmaC);
    else load_tile_mma<false>(m.sw + buf * stage, src, C, pitch, 0, 0);
  };
  // Byte addresses in shared memory of this thread's first A element (row g
  // of the warp's first m16 tile at tap (0, 0), k column 32*kg + 2t) and of
  // its first B element in buffer 0.
  const uint32_t a_thread = smem_addr(m.spad + (32 * wm + g) * P + 32 * kg + 2 * t);
  const uint32_t b_thread = smem_addr(
      BT ? m.sw + (16 * wn + g) * pitch + 32 * kg + 2 * t
         : m.sw + (32 * kg + 2 * t) * pitch + 16 * wn + g);

  for (int nb = 0; nb < nblk; ++nb) {
    float run[2][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) run[i][j][r] = 0.f;

    for (int i = 0; i < ring - 1; ++i) load_tile(i, nb, i);
    // wbuf: the ring buffer of the tile where the ring depth is read from s
    // (GENERAL); else tile % kRing.
    for (int tile = 0, wbuf = 0; tile < ntile;
         ++tile, wbuf = GENERAL && wbuf + 1 < ring ? wbuf + 1 : 0) {
      const int buf = GENERAL ? wbuf : tile % kRing;
      if (ring == 3 && tile + 1 < ntile) cp_async_wait_but_one(); else cp_async_wait_all();
      __syncthreads();  // the tile's weights visible; the buffer of tile - 1 is free
      if (tile + ring - 1 < ntile) load_tile(tile + ring - 1, nb, buf == 0 ? ring - 1 : buf - 1);
      const int tap = WIDE ? div_magic(tile, s.bmagic) : tile, kb = tile - tap * nblk;
      if (pad && kb * kMmaC + 32 * kg >= C) continue;  // a k half of zeros
      const uint32_t a_tap = a_thread + 4u * (((tap / 3) * Wp + tap % 3) * P + kb * kMmaC);
      const uint32_t b_tap = b_thread + 4u * (buf * stage);
      float acc[2][2][4];
      if constexpr (PASSES == kPassBf16) {
        // Two k16 steps over the warp's 32 input channels.  The thread's k
        // values are 2t, 2t + 1 (fragment register 0) and 2t + 8, 2t + 9
        // (register 1 of B, 2 of A), as the bf16 fragments lay them out: A
        // rows g and g + 8 by two 8-byte loads each, B column g from four
        // weight rows (BT: two 8-byte loads of weight row n = g).
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t b16[2][2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (BT) {
              const uint32_t bj = b_tap + 4u * ((8 * j) * pitch + 16 * ks);
              const float2 v0 = lds2(bj), v1 = lds2(bj + 4u * 8);
              b16[j][0] = bf16x2(v0.x, v0.y);
              b16[j][1] = bf16x2(v1.x, v1.y);
            } else {
              const uint32_t bj = b_tap + 4u * ((16 * ks) * pitch + 8 * j);
              b16[j][0] = bf16x2(lds(bj), lds(bj + 4u * pitch));
              b16[j][1] = bf16x2(lds(bj + 4u * (8 * pitch)), lds(bj + 4u * (9 * pitch)));
            }
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const uint32_t ai = a_tap + 4u * ((16 * i) * P + 16 * ks);
            const float2 r0 = lds2(ai), r1 = lds2(ai + 4u * (8 * P));
            const float2 r2 = lds2(ai + 4u * 8), r3 = lds2(ai + 4u * (8 * P + 8));
            const uint32_t a16[4] = {bf16x2(r0.x, r0.y), bf16x2(r1.x, r1.y),
                                     bf16x2(r2.x, r2.y), bf16x2(r3.x, r3.y)};
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              if (ks == 0) mma_bf16_zero(acc[i][j], a16, b16[j]);
              else mma_bf16(acc[i][j], a16, b16[j]);
            }
          }
        }
      }
      // The k8 steps of the TF32 passes (none in the bf16 pass).
      constexpr int kSteps = PASSES == kPassBf16 ? 0 : 4;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        uint32_t bhi[2][2], blo[2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float bv[2];
          if (BT) {
            const float2 v = lds2(b_tap + 4u * ((8 * j) * pitch + 8 * ks));
            bv[0] = v.x;
            bv[1] = v.y;
          } else {
            bv[0] = lds(b_tap + 4u * ((8 * ks) * pitch + 8 * j));
            bv[1] = lds(b_tap + 4u * ((8 * ks + 1) * pitch + 8 * j));
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (PASSES == 3) tf32_split(bv[r], bhi[j][r], blo[j][r]);
            else bhi[j][r] = tf32_rna(bv[r]);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // Rows g and g + 8 of the m16 tile, k columns 2t and 2t + 1.
          const float2 r0 = lds2(a_tap + 4u * ((16 * i) * P + 8 * ks));
          const float2 r1 = lds2(a_tap + 4u * ((16 * i + 8) * P + 8 * ks));
          const float av[4] = {r0.x, r1.x, r0.y, r1.y};
          uint32_t ahi[4], alo[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (PASSES == 3) tf32_split(av[r], ahi[r], alo[r]);
            else ahi[r] = tf32_rna(av[r]);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (PASSES == 3) {
              if (ks == 0) mma_tf32_zero(acc[i][j], alo, bhi[j]);
              else mma_tf32(acc[i][j], alo, bhi[j]);
              mma_tf32(acc[i][j], ahi, blo[j]);
              mma_tf32(acc[i][j], ahi, bhi[j]);
            } else {
              if (ks == 0) mma_tf32_zero(acc[i][j], ahi, bhi[j]);
              else mma_tf32(acc[i][j], ahi, bhi[j]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) run[i][j][r] += acc[i][j][r];
    }

    // Add the two k halves: the second half's warps park their sums in the
    // weight ring, in fragment order; the first half's add them and finish.
    __syncthreads();  // every warp is done with the ring
    float* red = m.sw + ((warp & 7) * 32 + lane);
    if (kg == 1) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) red[((i * 2 + j) * 4 + r) * 256] = run[i][j][r];
    }
    __syncthreads();
    if (kg == 0) {
      const int hq = s.H * Wp;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = 32 * wm + 16 * i + 8 * h + g, y = div_magic(q, s.pmagic), x = q - y * Wp;
          const bool real = q < hq && x < s.W;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int l = 0; l < 2; ++l) {
              const int r = 2 * h + l, co = nb * kMmaC + 16 * wn + 8 * j + 2 * t + l;
              const float v = run[i][j][r] + red[((i * 2 + j) * 4 + r) * 256];
              if (real && (!pad || co < C)) epi(y * s.W + x, co, v);
            }
        }
    }
    if (nb + 1 < nblk) __syncthreads();  // the ring, which holds red, is free again
  }
}

// ---- wgmma3: the f32 stage on warpgroup products --------------------------
//
// conv3x3_wgmma is conv3x3_mma<3> (the same M rows, tiles and 3xTF32
// arithmetic, the same order of sums) on sm_90a's asynchronous warpgroup
// products.  The four warpgroups of the CTA each own one quarter of a 64x64
// output block: warpgroup wg takes output channels 32*(wg & 1) .. +31
// (N = 32) and the k half wg >> 1 of every tap's 64 input channels, as
// conv3x3_mma's warps take theirs.  Per k8 step it issues
// wgmma.mma_async.m64n32k8.f32.tf32.tf32 three times, a_lo*b_hi, a_hi*b_lo,
// a_hi*b_hi, onto one accumulator, and waits for them; a tap's chain (4 k8
// steps, 12 products) starts from zero (scale-d = 0) and is added to the
// running sum by an f32 add on the CUDA cores, taps in order; last, first k
// half + second k half through shared memory.  A thread holds a 16-float
// accumulator and a 16-float running sum.
//
//   A (the conv input rows of a tap) comes from registers: a tap's rows
//   start at spad row ky*(W+2)+kx, where no shared-memory descriptor can
//   start, so each thread loads its fragment as conv3x3_mma does (rows g
//   and g+8 of its warp's 16, one 8-byte load each, physical input channels
//   2t and 2t+1) and splits it.  The register fragment of the instruction
//   is that of mma.sync m16n8k8 per warp (CUTLASS GMMA ALayout_64x8): a0,
//   a2 are k = t and t+4.  So the instruction's k order is the permutation
//   logical t <- physical 2t, logical t+4 <- physical 2t+1 of each group of
//   8 input channels, and B is laid out in that order.
//   B (the weights) comes from shared memory through a descriptor: K-major,
//   no swizzle, 8x4 core matrices of 128 bytes, the two k halves of a k8
//   step 128 bytes apart (LBO), 8-row groups of n 2048 bytes apart (SBO)
//   (wg_tile_offset).  Each tap's (64, 64) f32 tile reaches shared memory
//   once per CTA by the copy engine (one cp.async.bulk of 16 KB completing
//   on a "full" mbarrier).  Each warpgroup splits the
//   quarter of it that its products read into TF32 heads and tails in the
//   tensor cores' order (fence.proxy.async, then a barrier of its own 128
//   threads, before its products read them) and arrives on an "empty"
//   mbarrier; once all four have, one thread starts the next tap's copy.
//   So within the tap loop the warpgroups meet at no CTA-wide barrier: one
//   splits while another's products run.  The split lives in
//   shared memory and is redone from the f32 weights at every launch, so an
//   in-place weight update reaches the next launch and every graph replay;
//   nothing is cached.
//   A CTA of two warpgroups (wgmma_conv<2>, the backward's cluster pass)
//   runs the same chain for one output half, c0 .. c0+31, each warpgroup a
//   k half, and copies and splits only what that half reads.
//
// Bound: the same work as conv3x3_mma<3> (three products per pair over 64
// rows, of which 49 or 36 are real), 3.9 us of TF32 peak per conv per
// sample on one SM at 7x7x64; A's split twice per element (once per
// output-channel half) in place of four times, B's once per CTA in place
// of twice per warp pair.
//
// wgmma_bf16 (PREC = kBf16) is conv3x3_mma<kPassBf16> (one bf16 pass per 16
// input channels, operands rounded to nearest even) on the same warpgroups,
// copies and mbarriers.  Per tap and k half: wgmma.mma_async.m64n32k16 bf16
// from zero, then one accumulating (k16 steps 0 and 1), the chain added to
// the running sum in f32, taps in order, the k halves last: the mma.sync
// bf16 stage's order, two instructions where wgmma3 issues twelve.
//   A comes from registers, packed from spad as conv3x3_mma<kPassBf16>
//   packs it: the register fragment of the 16-bit m64nNk16 is mma.sync
//   m16n8k16's per warp (k 2t, 2t+1 in register 0, 2t+8, 2t+9 in register
//   2), so the k order is the physical one and needs no permutation.
//   B: each warpgroup converts its part of the f32 tile to bf16 (cvt.rn,
//   bf16x2's rounding) into one bf16 tile, K-major, no swizzle: core
//   matrices of 8 rows n x 16 bytes (8 k), the next 8 k 128 bytes on (LBO),
//   the next 8 n 1024 bytes on (SBO) (wg_bf16_offset).  One 16-byte store a
//   thread a tap: forward, 8 k of one n read down 8 rows of the (k, n) tile
//   (consecutive lanes on consecutive n, conflict-free); BT, 8 consecutive
//   k of row n of the copied rows, by wgmma3's rotated walk.  The 16-bit
//   types could take the forward's (k, n) tile MN-major through the
//   instruction's transpose flag with no gather; the K-major tile was taken
//   for both (BT's rows are K-major as copied): one descriptor layout, the
//   one wgmma3 proved on the chip, and the gather costs a thread 8 loads
//   from 8 rows, which neighbouring lanes read without a bank conflict.
// Bound: a third of wgmma3's tensor-core work at twice the rate; 0.63 us
// of bf16 peak per conv per sample at 7x7x64 on one SM.

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_inval(uint32_t bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on bar's transaction count.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const float* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
// This thread's generic-proxy shared-memory accesses, ordered before the
// async proxy's (the tensor cores' descriptor reads, the copy engine's
// writes).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// The 128 threads of warpgroup wg meet (named barrier 1 + wg; 0 is
// __syncthreads').
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Waits until at most one committed group of this warpgroup is pending.
__device__ __forceinline__ void wgmma_wait_but_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// Pins the accumulator's registers at this point of the program (no
// instruction that touches them moves across).
template <int N>
__device__ __forceinline__ void wgmma_pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a K-major, unswizzled B operand at shared byte address
// addr: LBO 128 bytes (the next core matrix along k: 4 TF32 or 8 bf16 k),
// SBO `sbo` bytes (the next 8 n: 2048 in a TF32 tile, 1024 in a bf16 one;
// in the weight gradients' transposed g tile of nk rows, odefunc_bwd.cu
// gt_offset, 32*nk + 16: gt_sbo_bytes).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d (+)= a (64x8 TF32, this warpgroup's registers) * b (8x32, descriptor);
// accumulate = 0 starts d from zero.  d[4j + r]: row 16*warp + g + 8*(r >> 1),
// column 8j + 2t + (r & 1).
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "{%16,%17,%18,%19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// The same product at N = 64 (the backward's weight gradients, odefunc_bwd.cu
// bwd_weight_kernel): d (+)= a (64x8 TF32) * b (8x64, a K-major descriptor
// of wgmma_desc's form, whose SBO the caller's tile sets); d[4j + r]: row
// 16*warp + g + 8*(r >> 1), column 8j + 2t + (r & 1), j = 0..7.
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (+)= a (64x16 bf16, this warpgroup's registers) * b (16x32, K-major
// descriptor); accumulate = 0 starts d from zero.  d as in wgmma_tf32.
__device__ __forceinline__ void wgmma_bf16(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "{%16,%17,%18,%19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// The byte offset, inside a head or tail tile, of output channel n and of
// the tile's input channel k: core matrix (n / 8, 2*(k / 8) + half) with
// half = k % 2 (physical 2t+1 is logical t+4), row n % 8, column (k % 8)/2.
__host__ __device__ constexpr int wg_tile_offset(int n, int k) {
  return (((n >> 3) * 16 + 2 * (k >> 3) + (k & 1)) * 8 + (n & 7)) * 16 + ((k & 7) >> 1) * 4;
}

// The byte offset, inside a bf16 tile of 64 k, of output channel n and
// input channel k: core matrix (n / 8, k / 8), row n % 8, column k % 8.
__host__ __device__ constexpr int wg_bf16_offset(int n, int k) {
  return (((n >> 3) * 8 + (k >> 3)) * 8 + (n & 7)) * 16 + (k & 7) * 2;
}

// Both operands from shared memory under the 128-byte swizzle (the probe's
// im2col_bf16, csrc/conv_probe.cu): a K-major tile of rows of 64 bf16 k
// (128 bytes each), 8-row atoms of 1,024 bytes on 1,024-byte boundaries, the
// 16-byte chunk c of row r stored at chunk c ^ (r % 8) of that row.
//
// The byte offset of row r (m of A, n of B), element k (0..63) in the tile.
__host__ __device__ constexpr int sw128_offset(int r, int k) {
  return r * 128 + (((k >> 3) ^ (r & 7)) << 4) + (k & 7) * 2;
}

// Descriptor of such a tile from shared byte address addr: SBO 1,024 bytes
// (the next 8 rows), LBO unused for a swizzled K-major operand (1), layout
// type 1 (128-byte swizzle).  A k16 step inside the 64 k adds its 32 bytes
// to addr; the hardware applies the swizzle to the address it forms, so
// the atoms must start on 1,024-byte boundaries.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (+)= a (64x16 bf16, descriptor) * b (16x64 bf16, descriptor), both
// K-major; accumulate = 0 starts d from zero.  d[4j + r]: row 16*warp + g +
// 8*(r >> 1), column 8j + 2t + (r & 1) of the warpgroup's 64x64 block.
__device__ __forceinline__ void wgmma_ss_bf16(float (&d)[32], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Floats of wgmma_conv<NWG, BT, PREC>'s operand tiles: the TF32 heads and
// tails (NWG/2 * kHalfTileF floats each), or the one bf16 tile (half as
// many bytes as a head tile).
__host__ __device__ constexpr int wg_operand_floats(int nwg, int prec) {
  return prec == kF32 ? nwg * kHalfTileF : nwg * kHalfTileF / 4;
}

// 3x3 SAME conv of spad on wgmma (the note above) at C = 64 (one block of
// output and input channels; wgmma_ok), with the contract of conv3x3:
// epi(p, co, sum) once per output pixel p and output channel co of the
// CTA's; the caller synchronises before and after.  NWG warpgroups: 4, the
// whole block (co = 0..63), or 2, the output channels c0 .. c0+31 alone
// (co = 0..31 counts from c0; a CTA of a cluster that splits the block),
// warpgroup wg taking the k half wg / (NWG/2).  Tile = tap: tap k's (64, 64)
// weights w[k], (ci, co), one contiguous copy; BT (NWG = 2 only): the input
// gradient, the conv with tap 8 - k's tile transposed, whose B operand is
// row n = input, column k = output channel of w[8 - k]: the CTA copies the
// tile's 32 contiguous rows c0.. (8 KB) and its split reads them row-wise.
// PREC: kF32 (wgmma3) or kBf16 (wgmma_bf16, the note above).  At `head`:
// the operand tiles (wg_operand_floats: kF32, the TF32 head tile and the
// tail tile, NWG/2 * kHalfTileF floats each, wg_tile_offset order; kBf16,
// the bf16 tile, wg_bf16_offset order), the f32 tile as copied (kTileF)
// and its two mbarriers.
template <int NWG, bool BT, int PREC, class Epi>
__device__ void wgmma_conv(const float* spad, const Shape& s, float* head,
                           const float* __restrict__ w, int c0, Epi epi) {
  static_assert(NWG == 4 || NWG == 2, "a CTA's warpgroups: the whole block or one output half");
  static_assert(!BT || NWG == 2, "the transposed split reads one output half's 32 rows");
  static_assert(PREC == kF32 || PREC == kBf16, "wgmma3 or wgmma_bf16");
  constexpr bool kB = PREC == kBf16;
  constexpr int kNH = NWG / 2;                   // output halves of the CTA
  constexpr int kTileN = kNH * kHalfTileF;       // floats of its head (tail) tile
  constexpr int kHalfThreads = 128 * kNH;        // threads of one k half
  constexpr uint32_t kBytes = 4u * (BT ? kHalfTileF : kTileF);  // one tap's copy
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wi = warp & 3;
  const int wg = warp >> 2, nh = wg % kNH, kh = wg / kNH, wt = tid & 127;
  const int Wp = s.W + 2, P = s.P;
  float* tail = head + kTileN;
  // the f32 tile as copied, 64 floats a row
  const float* raw = head + wg_operand_floats(NWG, PREC);
  // The f32 tile's "full" (copy landed) and "empty" (every warpgroup has
  // split its part) mbarriers.
  const uint32_t raw_s = smem_addr(raw), full = smem_addr(raw + kTileF), empty = full + 8;
  auto tile = [&](int tap) {
    return BT ? w + (size_t)(8 - tap) * kTileF + (size_t)c0 * kMmaC : w + (size_t)tap * kTileF;
  };

  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(empty, NWG);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();  // the caller's generic accesses to the tiles come first
    mbar_expect_tx(full, kBytes);
    bulk_copy(raw_s, tile(0), kBytes, full);
  }
  __syncthreads();

  // This thread's first A element (row g of its warp's 16 at tap (0, 0),
  // physical k column 32*kh + 2t) and the descriptor of its warpgroup's
  // part of the head (bf16) tile at k8 (k16) step 0.
  const uint32_t a_thread = smem_addr(spad + (16 * wi + g) * P + 32 * kh + 2 * t);
  const uint64_t b_head =
      kB ? wgmma_desc(smem_addr(head) + wg_bf16_offset(kWgN * nh, 32 * kh), 1024)
         : wgmma_desc(smem_addr(head) + wg_tile_offset(kWgN * nh, 32 * kh), 2048);
  constexpr uint64_t kTail = (4 * kTileN) >> 4, kStep = 256 >> 4;  // descriptor units

  float acc[16], run[16];  // each tap's chain starts from zero (scale-d = 0)
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = run[i] = 0.f;
  for (int tap = 0; tap < 9; ++tap) {
    mbar_wait(full, tap & 1);  // the f32 tile has landed
    // Each warpgroup splits (converts) the part of the tile its products
    // read (its last products, which read those slots, are done).
    if constexpr (BT) {
      // Item (row n, 8 consecutive k of the k half): two 16-byte loads of
      // the raw row; TF32, the even k into one core-matrix row, the odd
      // into the next; bf16, all eight into one.  A quarter-warp's 8 lanes
      // read 8 distinct 16-byte bank groups (rotated k octets, either half
      // first) and store 8 rows of distinct banks.
      const int l = wt & 7, o = ((wt >> 3) + l) & 3, sw = l >> 2;
      const int n = 8 * (wt >> 5) + l, k0 = 32 * kh + 8 * o;
      const float* row = raw + n * kMmaC + k0;
      const float4 u0 = *reinterpret_cast<const float4*>(row + 4 * sw);
      const float4 u1 = *reinterpret_cast<const float4*>(row + 4 * (sw ^ 1));
      const float4 lo4 = sw ? u1 : u0, hi4 = sw ? u0 : u1;
      if constexpr (kB) {
        *reinterpret_cast<uint4*>(reinterpret_cast<char*>(head) + wg_bf16_offset(n, k0)) =
            make_uint4(bf16x2(lo4.x, lo4.y), bf16x2(lo4.z, lo4.w), bf16x2(hi4.x, hi4.y),
                       bf16x2(hi4.z, hi4.w));
      } else {
        const float v[8] = {lo4.x, lo4.y, lo4.z, lo4.w, hi4.x, hi4.y, hi4.z, hi4.w};
#pragma unroll
        for (int odd = 0; odd < 2; ++odd) {
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) tf32_split(v[odd + 2 * e], hi[e], lo[e]);
          const int off = wg_tile_offset(n, k0 + odd) >> 2;
          *reinterpret_cast<uint4*>(head + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<uint4*>(tail + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
      }
    } else if constexpr (kB) {
      // Item wt: n = 32nh + wt % 32, the k octet wt / 32 of the k half,
      // eight rows of the (k, n) tile (neighbouring lanes on neighbouring n)
      // into one core-matrix row.
      const int n = 32 * nh + (wt & 31), k0 = 32 * kh + 8 * (wt >> 5);
      const float* col = raw + k0 * kMmaC + c0 + n;
      uint32_t b[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) b[e] = bf16x2(col[(2 * e) * kMmaC], col[(2 * e + 1) * kMmaC]);
      *reinterpret_cast<uint4*>(reinterpret_cast<char*>(head) + wg_bf16_offset(n, k0)) =
          make_uint4(b[0], b[1], b[2], b[3]);
    } else {
      // Item i = (n = 32nh + i % 32, 4 k of one core-matrix row), k = 32kh
      // + 8*(c / 2) + (c % 2) + 2e for chunk c = i / 32, e = 0..3.
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = wt + 128 * j, n = 32 * nh + (i & 31), c = i >> 5;
        const int k0 = 32 * kh + 8 * (c >> 1) + (c & 1);
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) tf32_split(raw[(k0 + 2 * e) * kMmaC + c0 + n], hi[e], lo[e]);
        const int off = wg_tile_offset(n, k0) >> 2;
        *reinterpret_cast<uint4*>(head + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(tail + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
    fence_proxy_async();
    warpgroup_sync(wg);  // its heads and tails are visible to its products
    if (wt == 0) mbar_arrive(empty);  // its reads of the f32 tile are done
    // The next tap's tile, once every warpgroup has split this one.
    if (tid == 0 && tap < 8) {
      mbar_wait(empty, tap & 1);
      mbar_expect_tx(full, kBytes);
      bulk_copy(raw_s, tile(tap + 1), kBytes, full);
    }

    const uint32_t a_tap = a_thread + 4u * (((tap / 3) * Wp + tap % 3) * P);
    if constexpr (kB) {
      // Both k16 steps' A fragments (rows g and g + 8, k 2t, 2t+1 and 2t+8,
      // 2t+9), then the chain: step 0 from zero, step 1 accumulating.
      uint32_t a16[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const uint32_t ak = a_tap + 4u * (16 * ks);
        const float2 r0 = lds2(ak), r1 = lds2(ak + 4u * (8 * P));
        const float2 r2 = lds2(ak + 4u * 8), r3 = lds2(ak + 4u * (8 * P + 8));
        a16[ks][0] = bf16x2(r0.x, r0.y);
        a16[ks][1] = bf16x2(r1.x, r1.y);
        a16[ks][2] = bf16x2(r2.x, r2.y);
        a16[ks][3] = bf16x2(r3.x, r3.y);
      }
      wgmma_fence();
      wgmma_bf16(acc, a16[0], b_head, 0);
      wgmma_bf16(acc, a16[1], b_head + kStep, 1);
      wgmma_commit();
      wgmma_wait_all();
      wgmma_pin(acc);
    }
    // One k8 step at a time: its A fragment split in registers, then its
    // three products, waited for before the registers are reused (two or
    // four steps a group spill the narrow build: slower on the chip).
#pragma unroll
    for (int ks = 0; ks < (kB ? 0 : 4); ++ks) {
      const float2 r0 = lds2(a_tap + 4u * (8 * ks));
      const float2 r1 = lds2(a_tap + 4u * (8 * P + 8 * ks));
      const float av[4] = {r0.x, r1.x, r0.y, r1.y};
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) tf32_split(av[r], ahi[r], alo[r]);
      const uint64_t bh = b_head + kStep * ks;
      wgmma_fence();
      wgmma_tf32(acc, alo, bh, ks > 0);
      wgmma_tf32(acc, ahi, bh + kTail, 1);
      wgmma_tf32(acc, ahi, bh, 1);
      wgmma_commit();
      wgmma_wait_all();
      wgmma_pin(acc);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) run[i] += acc[i];
  }

  // Add the two k halves: the second half's warpgroups park their sums in
  // the head tile's space, in accumulator order; the first half's add them
  // and finish.
  __syncthreads();  // every warpgroup is done with the head and tail tiles
  float* red = head + (tid & (kHalfThreads - 1));
  if (kh == 1) {
#pragma unroll
    for (int i = 0; i < 16; ++i) red[i * kHalfThreads] = run[i];
  }
  __syncthreads();  // also: every thread has passed its last wait
  if (tid == 0) {
    mbar_inval(full);
    mbar_inval(empty);
  }
  if (kh == 0) {
    const int hq = s.H * Wp;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 16 * wi + 8 * h + g, y = div_magic(q, s.pmagic), x = q - y * Wp;
      if (q >= hq || x >= s.W) continue;  // a border column or a slack row
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int l = 0; l < 2; ++l) {
          const int r = 4 * j + 2 * h + l;
          epi(y * s.W + x, kWgN * nh + 8 * j + 2 * t + l, run[r] + red[r * kHalfThreads]);
        }
    }
  }
}

// The stage wgmma3 (PREC = kF32) or wgmma_bf16 (kBf16) of a 512-thread CTA:
// the whole block, the weight area at m.sw.
template <int PREC, class Epi>
__device__ __forceinline__ void conv3x3_wgmma(const Smem& m, const Shape& s,
                                              const float* __restrict__ w, Epi epi) {
  wgmma_conv<4, false, PREC>(m.spad, s, m.sw, w, 0, epi);
}

// ---- both stages ----------------------------------------------------------

// The tensor-core stage at the shape's block padding and ring depth: the
// whole-block shapes with a ring of kRing (7x7: C = 64 to 448 in steps of
// 64) run a tile loop that reads neither from s, the others the GENERAL
// one.
template <int PASSES, bool BT, bool WIDE, class Epi>
__device__ __forceinline__ void mma_stage(const Smem& m, const Shape& s,
                                          const float* __restrict__ w, Epi epi) {
  if constexpr (WIDE) {
    if (s.C % kMmaC || s.ring != kRing) {
      conv3x3_mma<PASSES, BT, true, true>(m, s, w, epi);
      return;
    }
  }
  conv3x3_mma<PASSES, BT, WIDE, false>(m, s, w, epi);
}

// The conv stage of the shape: wgmma3 (kF32) or wgmma_bf16 (kBf16 and
// kBf16Conv, whose conv input spad its writer has rounded already, so that
// wgmma_bf16's rounding of it changes nothing) where make_shape says so
// (s.wg), else the tensor cores' mma.sync stage (3xTF32) where it says so,
// else FFMA; each in its bf16 build where PREC is not kF32.  WIDE:
// wide_shape(s).
template <bool WIDE, int PREC = kF32, class Epi>
__device__ __forceinline__ void conv_stage(const Smem& m, const Shape& s,
                                           const float* __restrict__ w, Epi epi) {
  if constexpr (!WIDE) {
    if (s.wg) {
      conv3x3_wgmma<PREC == kF32 ? kF32 : kBf16>(m, s, w, epi);
      return;
    }
  }
  if (s.mma) mma_stage<PREC == kF32 ? 3 : kPassBf16, false, WIDE>(m, s, w, epi);
  else conv3x3<PREC != kF32>(m, s, w, epi);
}

// The split ConcatConv's output (conv + bias) + t * M of one element from
// the conv's sum acc; kBf16 rounds the conv output, its sum with the bias,
// t * M and the last sum, with bias and M rounded (t is rounded by the
// caller).
template <int PREC>
__device__ __forceinline__ float concat_out(float acc, float bias, float t, float tm) {
  if constexpr (PREC == kBf16)
    return bf16_round(bf16_round(bf16_round(acc) + bf16_round(bias)) +
                      bf16_round(t * bf16_round(tm)));
  else
    return (acc + bias) + t * tm;
}

// sx[p, co] = concat_out(conv3x3(spad, w), bias[co], t, M[p, co]).
template <bool WIDE, int PREC = kF32>
__device__ __forceinline__ void conv3x3_to_sx(const Smem& m, const Shape& s,
                                              const float* __restrict__ w,
                                              const float* __restrict__ bias,
                                              const float* __restrict__ tmap, float t) {
  const int C = s.C;
  conv_stage<WIDE, PREC>(m, s, w, [&](int p, int co, float acc) {
    m.sx[p * C + co] = concat_out<PREC>(acc, bias[co], t, tmap[p * C + co]);
  });
}

// f(t, sx) for one sample at precision PREC.  sx holds the input state
// (kBf16: rounded to bf16) and the caller has synchronised after writing
// it.  The result is handed to out(e, value) for e = threadIdx.x + j *
// kThreads, reading sx only at those e, so the caller may overwrite sx[e]
// at the same e without another barrier.
template <bool WIDE, int PREC = kF32, class Out>
__device__ void odefunc_eval(const Smem& m, const Shape& s, const Odefunc& p,
                             float t, Out out) {
  if constexpr (PREC == kBf16) t = bf16_round(t);
  Stat st = gn_stats<WIDE>(m, s, m.sx, m.smean, m.sinv);
  gn_relu_to_pad<WIDE, PREC>(m, s, m.sx, st, p.n1s, p.n1b);
  __syncthreads();
  conv3x3_to_sx<WIDE, PREC>(m, s, p.w1, p.b1, p.m1, t);
  __syncthreads();
  st = gn_stats<WIDE>(m, s, m.sx, m.smean, m.sinv);
  gn_relu_to_pad<WIDE, PREC>(m, s, m.sx, st, p.n2s, p.n2b);
  __syncthreads();
  conv3x3_to_sx<WIDE, PREC>(m, s, p.w2, p.b2, p.m2, t);
  __syncthreads();
  st = gn_stats<WIDE>(m, s, m.sx, m.smean, m.sinv);
  gn_apply<WIDE, PREC>(s, st, m.smean, m.sinv, p.n3s, p.n3b, m.sx,
                       [&](const auto& w, float v) { out(w.e, v); });
}

}  // namespace nodef

extern "C" const char* nodef_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
