// The 3x3 SAME conv C -> C as one bf16 GEMM over the rows of every sample
// (sm_90a), at every width from C = 72 to 512 with C % 8 == 0: the conv
// stage of the bf16 ODEfunc at C = 96 to 512 (csrc/odefunc.cu, the
// 'rows_bf16' build) and of the probe's tap9_bf16 and im2col_bf16 there
// (csrc/conv_probe.cu; at C <= 64, and where C % 8 != 0, the probe keeps
// its window kernel, rows_wgmma_conv).  It replaces, on those paths, the
// per-sample mma.sync stage conv3x3_mma<kPassBf16>, which streams each
// conv's whole f32 weights from L2 into every sample's CTA.
//
//   xa  (rows, C) bf16 bit patterns, rows = B*H*W flattened as (b*H + y)*W
//       + x: the conv input, rounded by its writer;
//   wp  the weights rounded to bf16 once per call by rows_pack_kernel, in
//       the order the products read them (below);
//   epi(r, co, v0, v1): the sums of row r at output channels co, co + 1.
//
// M runs over the rows in tiles of 64 * MW (one consumer warpgroup per 64
// rows; tiles cross sample boundaries, and a row's sums do not depend on its
// tile), N over output channels in tiles of 64 * kRowsNB = 128 (grid
// dimension y; past C the packed weights are zero), K over (tap, input
// channel) in stages of kRowsK = 64.  What a stage is follows the probe's
// two strategies: kTap (tap9_bf16, the ODEfunc) input channels 64 (kc % S)
// .. + 63 of tap kc / S, S = ceil(C / 64) (zero past C); else (im2col_bf16)
// k = 64 kc .. 64 kc + 63 of K = 9C, where k = tap * C + ci (zero past 9C;
// at C % 64 != 0 a stage spans taps).
//
// Per stage both operands lie in shared memory as K-major tiles of 128-byte
// rows under the 128-byte swizzle (sw128_offset): the A slice (64 * MW
// rows) and the B slice (128 output channels), read by
// wgmma.mma_async.m64n128k16 bf16 through wgmma_desc_sw128.  A ring of
// rows_ring(MW) slots of kRowsPerSlot = 2 stages each (three slots for
// 128-row tiles, two for 64, which run two CTAs an SM), each slot one round
// of copies, waits and barriers:
//   - B: rows_pack_kernel has laid out every (N tile, stage) B slice in
//     global memory byte for byte as shared memory holds it (swizzle
//     included), so thread 0 brings a slot's slices in with one
//     cp.async.bulk (32 KB) onto the slot's "full" mbarrier; each warp
//     arrives on the slot's "empty" mbarrier after its products, which
//     thread 0 waits on before it refills the slot.  Each CTA reads a
//     stage's weights once from L2, already rounded and placed.
//   - A: each consumer warpgroup gathers its own 64 rows of each stage's
//     slice straight from xa by cp.async (16 bytes = 8 input channels of
//     one tap per copy, zero-filled off the map, past the last row and past
//     C or 9C); cp.async.wait_group, fence.proxy.async and a warpgroup
//     barrier before its products read the slice.  The window of x that
//     the C <= 128 kernel copies into shared memory does not fit at wide C
//     (80 KB per 64 rows at C = 512).
//
// Accumulation order (PERF.md section 6): per stage and k half (32 k), a
// chain of two k16 steps from zero, added on the CUDA cores to that half's
// running f32 sum, stages in order; last, the first half's sum plus the
// second's.  With kTap this is conv3x3_mma<kPassBf16>'s order (mma_bf16:
// per (tap, 64-channel input block) tile, tap-major, and k half), so the
// rows build gives the per-sample build's bits; a k half of zeros (past C)
// adds a zero chain where mma_bf16 skips it, which changes no sum.
// kernels/conv3x3.py rows_wgmma_emulated follows the order.
//
// Bound at B = 256, 7x7x512 (H100 SXM: 989 TFLOP/s dense bf16, 3.35 TB/s):
// 59.2 GFLOP, 0.060 ms of bf16 products, against 12.8 MB in, 25.7 MB out
// and 4.7 MB of weights, 0.013 ms: bound by operations.  The chain from
// zero and its f32 add per stage make each stage a round of waits (the
// copies, the products, the add) that the card runs about 1,600 cycles
// apart at 7x7x512 (PERF.md section 6): taking the products, the A gathers or
// the B copies out one at a time each saved a quarter or less; a TMA box
// for A, a producer warp (setmaxnreg: ptxas kept 168 registers, and the
// running sums spilled) and chains pipelined across stages were each
// slower; two stages a slot (one round of waits for both) gained 4%.
//
// The transposed build (kTrans, with kTap): the input gradient of the conv
// with w, the bf16 ODEfunc backward's two input-gradient convs at C = 96 to
// 512 (csrc/odefunc_bwd.cu, the rows backward).  Only the packing differs:
// stage (tap, 64-channel block) holds tap 8 - tap's (C, C) tile transposed
// (B row n = the forward's input channel, k = its output channel), so the
// products and their order are the forward build's, and
// conv3x3_mma<kPassBf16, true> (mma_bf16 with BT: tiles tap-major, tap 8 -
// tap transposed, per k half a chain from zero) is summed in the same order.
#pragma once

#include "odefunc_common.cuh"

namespace nodef {

constexpr int kRowsK = 64;       // k of one stage: 128 bytes of bf16 a row
constexpr int kRowsNB = 2;       // 64-column blocks of an N tile
constexpr int kRowsSlice = 64 * kRowsK * 2;  // bytes of a 64-row slice of a stage

// The shapes the rows kernel takes (kernels/conv3x3.py rows_ok mirrors it):
// 16-byte copies of 8 input channels, one tap each, from 16-byte aligned
// rows; 32-bit element offsets.
inline bool rows_ok(int B, int H, int W, int C) {
  return B >= 1 && H >= 1 && W >= 1 && C > kMmaC && C <= kMaxC && C % 8 == 0 &&
         (long long)B * H * W * C < (1LL << 31);
}

// Stages a tap (kTap), stages of K, N tiles.
__host__ __device__ constexpr int rows_stages(bool tap, int C) {
  return tap ? 9 * ((C + kRowsK - 1) / kRowsK) : (9 * C + kRowsK - 1) / kRowsK;
}
__host__ __device__ constexpr int rows_ntiles(int C) {
  return ((C + kRowsK - 1) / kRowsK + kRowsNB - 1) / kRowsNB;
}
// Bytes of the packed weights (every N tile's every stage's B slice) and of
// a CTA's dynamic shared memory (1,024 to align, the ring, 2 mbarriers a
// stage); kernels/conv3x3.py mirrors both.
inline size_t rows_pack_bytes(bool tap, int C) {
  return (size_t)rows_ntiles(C) * rows_stages(tap, C) * kRowsNB * kRowsSlice;
}
// Stages a ring slot holds (one round of waits and barriers takes this
// many), and slots in the ring of a CTA of mw consumer warpgroups: three at
// 128 rows (one CTA an SM), two at 64 (two CTAs an SM).
constexpr int kRowsPerSlot = 2;
__host__ __device__ constexpr int rows_ring(int mw) { return mw == 2 ? 3 : 2; }
// Bytes of a call's scratch (kernels/odefunc.py rows_scratch_bytes): the
// bf16 conv input of B*H*W rows, rounded up to 1 KB, then one conv's packed
// weights.
inline size_t rows_scratch_bytes(int B, int H, int W, int C, bool tap) {
  return ((size_t)B * H * W * C * 2 + 1023) / 1024 * 1024 + rows_pack_bytes(tap, C);
}
inline size_t rows_smem_bytes(int mw) {
  return 1024 + (size_t)rows_ring(mw) * (kRowsPerSlot * (mw + kRowsNB) * kRowsSlice + 16);
}

// The M tile (64 or 128 rows) for `rows` rows of C channels on a card of
// `sms` SMs, by the shape and B alone (kernels/conv3x3.py rows_tile_rows):
// 128 where the 128-row tiles give at least every other SM a CTA (at B =
// 256 on 7x7 maps from C = 96), else 64 (two CTAs an SM).
inline int rows_tile_rows(int rows, int C, int sms) {
  return 2LL * ((rows + 127) / 128) * rows_ntiles(C) >= sms ? 128 : 64;
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// 16 bytes from global src to shared dst, or 16 zero bytes where !valid.
__device__ __forceinline__ void cp_async16_at(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// d (+)= a (64x16 bf16, descriptor) * b (16x128 bf16, descriptor), both
// K-major under the 128-byte swizzle; accumulate = 0 starts d from zero.
// d[4j + r]: row 16*warp + g + 8*(r >> 1), column 8j + 2t + (r & 1), j < 16.
__device__ __forceinline__ void wgmma_ss_bf16_n128(float (&d)[64], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// wp[(nt * nk + kc) * slice + sw128_offset(n, k)] = bf16(w[row][128 nt + n])
// with row = tap * C + ci of stage kc's k (zero past C, 9C and the last
// column block): the B slices in shared memory's order, so that a CTA
// copies each as it is.  One 16-byte chunk (8 k of one n) a thread,
// neighbouring threads on neighbouring n (coalesced reads of w).  kTrans
// (with kTap): bf16(w[8 - tap][128 nt + n][ci]), tap 8 - tap's tile
// transposed (each thread's 8 k one 32-byte run of w).
template <bool kTap, bool kTrans = false>
__global__ void __launch_bounds__(256)
rows_pack_kernel(const float* __restrict__ w, int C, uint8_t* __restrict__ wp) {
  static_assert(kTap || !kTrans, "the transposed packing has one tap a stage");
  constexpr int kN = 64 * kRowsNB;
  const int S = (C + kRowsK - 1) / kRowsK, nk = rows_stages(kTap, C);
  const long long total = (long long)rows_ntiles(C) * nk * 8 * kN;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int n = (int)(i % kN), q = (int)(i / kN % 8);
    const long long st = i / (8 * kN);  // nt * nk + kc
    const int kc = (int)(st % nk), co = (int)(st / nk) * kN + n;
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pair[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kl = 8 * q + 2 * e + h;
        int row;
        bool ok;
        if (kTap) {
          const int ci = kc % S * kRowsK + kl;
          ok = ci < C, row = kc / S * C + ci;
        } else {
          row = kc * kRowsK + kl, ok = row < 9 * C;
        }
        if (kTrans) {
          const int tap = kc / S, ci = row - tap * C;
          pair[h] = ok && co < C ? w[((size_t)(8 - tap) * C + co) * C + ci] : 0.f;
        } else {
          pair[h] = ok && co < C ? w[(size_t)row * C + co] : 0.f;
        }
      }
      v[e] = bf16x2(pair[0], pair[1]);
    }
    *reinterpret_cast<uint4*>(wp + st * (kRowsNB * kRowsSlice) + sw128_offset(n, 8 * q)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// The conv (the note at the head of this file).  Grid (M tiles, N tiles),
// 128 * MW threads.
template <bool kTap, int MW, class Epi>
__global__ void __launch_bounds__(128 * MW, 1)
rows_conv_kernel(const uint16_t* __restrict__ xa, const uint8_t* __restrict__ wp, int rows,
                 int H, int W, int C, Epi epi) {
  // A slot: the A slices of its kU stages, then their B slices (contiguous
  // in the packing too, so that one copy brings them).
  constexpr int NB = kRowsNB, kU = kRowsPerSlot, kA = MW * kRowsSlice, kB = NB * kRowsSlice;
  constexpr int kSlot = kU * (kA + kB), kS = rows_ring(MW);
  extern __shared__ uint8_t rows_raw[];
  const uint32_t base = (smem_addr(reinterpret_cast<float*>(rows_raw)) + 1023u) & ~1023u;
  const uint32_t bars = base + kS * kSlot;  // full[s] +8s, empty[s] +8(kS+s)
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, lane = tid & 31;
  const int wi = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int S = (C + kRowsK - 1) / kRowsK, nk = rows_stages(kTap, C), nj = (nk + kU - 1) / kU;
  const int nt = blockIdx.y;
  const uint8_t* wtile = wp + (size_t)nt * nk * kB;  // a dead block's slice is zeros
  const int tile0 = blockIdx.x * 64 * MW;

  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kS + s), 4 * MW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_b = [&](int j) {  // thread 0: slot j's B slices
    const int s = j % kS, kc = kU * j;
    const uint32_t bytes = (nk - kc < kU ? nk - kc : kU) * kB;
    mbar_expect_tx(bars + 8 * s, bytes);
    bulk_copy(base + s * kSlot + kU * kA,
              reinterpret_cast<const float*>(wtile + (size_t)kc * kB), bytes, bars + 8 * s);
  };
  if (tid == 0)
    for (int j = 0; j < kS && j < nj; ++j) load_b(j);

  // This thread's copies: k chunk ag (8 channels) of rows ar + 16 j of its
  // warpgroup's 64; per row, which taps lie on the map.
  const int ag = wt & 7, ar = 64 * wg + (wt >> 3);
  unsigned on[4];
  int off[4];  // element offset of the row in xa
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = tile0 + ar + 16 * j;
    on[j] = 0;
    off[j] = 0;
    if (r < rows) {
      off[j] = r * C;
      const int p = r % (H * W), yy = p / W, xx = p - yy * W;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int sy = yy + tap / 3 - 1, sx = xx + tap % 3 - 1;
        if (sy >= 0 && sy < H && sx >= 0 && sx < W) on[j] |= 1u << tap;
      }
    }
  }
  auto load_a = [&](int jj) {  // slot jj's A rows of this warpgroup: one group
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int kc = kU * jj + u;
      if (kc < nk) {
        int tap, ci;
        bool live;
        if constexpr (kTap) {
          tap = kc / S, ci = kc % S * kRowsK + 8 * ag, live = ci < C;
        } else {
          const int k = kc * kRowsK + 8 * ag;
          live = k < 9 * C, tap = live ? k / C : 0, ci = k - tap * C;
        }
        const unsigned bit = live ? 1u << tap : 0u;
        const int shift = ((tap / 3 - 1) * W + tap % 3 - 1) * C + ci;
        const uint32_t a_s = base + (jj % kS) * kSlot + u * kA;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = on[j] & bit;
          cp_async16_at(a_s + sw128_offset(ar + 16 * j, 8 * ag), ok ? xa + off[j] + shift : xa,
                        ok);
        }
      }
    }
    cp_async_commit();  // one group a slot, empty past the last
  };
#pragma unroll
  for (int d = 0; d < kS - 1; ++d) load_a(d);

  // Per stage and k half a chain of two k16 steps from zero over all 128
  // columns (m64n128k16), waited for and added to that half's running sum.
  float acc[64], run[2][64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = run[0][i] = run[1][i] = 0.f;
  for (int j = 0; j < nj; ++j) {
    const int s = j % kS;
    cp_async_wait<kS - 2>();  // this thread's copies of slot j have landed ...
    fence_proxy_async();      // ... for the tensor cores to read ...
    warpgroup_sync(wg);       // ... and every thread's of the warpgroup
    // The warpgroup is past slot j - 1: it takes slot j + kS - 1's stages.
    load_a(j + kS - 1);
    if (tid == 0 && j > 0 && j - 1 + kS < nj) {
      mbar_wait(bars + 8 * (kS + (j - 1) % kS), ((j - 1) / kS) & 1);
      load_b(j - 1 + kS);
    }
    mbar_wait(bars + 8 * s, (j / kS) & 1);  // the slot's weights
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (kU * j + u < nk) {
        const uint32_t a_s = base + s * kSlot;
        const uint64_t da = wgmma_desc_sw128(a_s + u * kA + wg * kRowsSlice);
        const uint64_t db = wgmma_desc_sw128(a_s + kU * kA + u * kB);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          wgmma_fence();
          wgmma_ss_bf16_n128(acc, da + 4 * h, db + 4 * h, 0);
          wgmma_ss_bf16_n128(acc, da + 4 * h + 2, db + 4 * h + 2, 1);
          wgmma_commit();
          wgmma_wait<0>();
          pin(acc);
#pragma unroll
          for (int i = 0; i < 64; ++i) run[h][i] += acc[i];
        }
      }
    }
    if (lane == 0) mbar_arrive(bars + 8 * (kS + s));
  }
  // The epilogue: rows 16 wi + g and + 8 of the warp, columns 8j + 2t and
  // + 1 of the tile.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = tile0 + 64 * wg + 16 * wi + g + 8 * h;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int co = 128 * nt + 8 * j + 2 * t, i = 4 * j + 2 * h;
      if (co < C) epi(r, co, run[0][i] + run[1][i], run[0][i + 1] + run[1][i + 1]);
    }
  }
}

// One conv on the caller's stream: w (9, C, C) f32 packed into wp (at least
// rows_pack_bytes), then the products over xa (rows, C) bf16 into epi.
// tile_rows: 64 or 128 (rows_tile_rows).  kTrans: the conv with w's
// tap-flipped, transposed taps (the input gradient).  Returns a
// cudaError_t.
template <bool kTap, bool kTrans = false, class Epi>
inline int rows_conv(const uint16_t* xa, const float* w, uint8_t* wp, int rows, int H, int W,
                     int C, int tile_rows, Epi epi, cudaStream_t st) {
  const long long chunks = (long long)rows_ntiles(C) * rows_stages(kTap, C) * 8 * 64 * kRowsNB;
  rows_pack_kernel<kTap, kTrans><<<(int)((chunks + 255) / 256), 256, 0, st>>>(w, C, wp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool tall = tile_rows == 128;
  const auto kernel = tall ? rows_conv_kernel<kTap, 2, Epi> : rows_conv_kernel<kTap, 1, Epi>;
  const size_t smem = rows_smem_bytes(tall ? 2 : 1);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((rows + tile_rows - 1) / tile_rows, rows_ntiles(C));
  kernel<<<grid, tall ? 256 : 128, smem, st>>>(xa, wp, rows, H, W, C, epi);
  return (int)cudaGetLastError();
}

// The card's SM count (the tile rule's), read once.
inline int rows_sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// ---- the rows builds' per-sample GroupNorm and conv epilogue ------------
//
// Shared by the bf16 ODEfunc's rows build (csrc/odefunc.cu) and the bf16
// backward's rows build (csrc/odefunc_bwd.cu), one CTA of kThreads per
// sample under the per-sample kernels' Shape and thread map.

// The rows build's GroupNorm of one sample (CTA) from x (B, H*W*C) f32:
// x rounded to bf16 into shared memory (the bf16 dynamics' entry rounding
// of h; u1 and u2 hold bf16 values already), gn_stats, then gn_apply<kBf16>
// in the per-sample kernel's thread map, each value handed to out(e, v).
// stats: where not null, the groups' mean and inv are written to stats[g]
// and stats[G + g] at the end.
template <class Out>
__device__ __forceinline__ void rows_gn(const float* __restrict__ x,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ bias, const Shape& s, Out out,
                                        float* __restrict__ stats = nullptr) {
  extern __shared__ float4 smem_raw[];
  const int n = s.H * s.W * s.C;
  Smem m{};
  m.sx = reinterpret_cast<float*>(smem_raw);
  m.sred = m.sx + n;
  m.smean = m.sred + 2 * kThreads;
  m.sinv = m.smean + s.G;
  const float* xb = x + (size_t)blockIdx.x * n;
  for (int e = threadIdx.x; e < n; e += kThreads) m.sx[e] = bf16_round(xb[e]);
  __syncthreads();
  const Stat st = gn_stats<true>(m, s, m.sx, m.smean, m.sinv);
  gn_apply<true, kBf16>(s, st, m.smean, m.sinv, scale, bias, m.sx,
                        [&](const auto& w, float v) { out(w.e, v); });
  if (stats) {
    __syncthreads();  // gn_stats' mean/inv
    for (int g = threadIdx.x; g < s.G; g += kThreads) {
      stats[g] = m.smean[g];
      stats[s.G + g] = m.sinv[g];
    }
  }
}

inline size_t rows_gn_smem_bytes(const Shape& s) {
  return sizeof(float) * ((size_t)s.H * s.W * s.C + 2 * kThreads + 2 * (size_t)s.G);
}

// The conv's epilogue: u[r, co] = concat_out<kBf16>(acc, bias[co], t[b], M[p, co])
// for row r = b * hw + p, t rounded as odefunc_eval rounds it.
struct ConcatEpi {
  const float* bias;
  const float* tmap;
  const float* t;
  float* u;
  int hw, C;
  __device__ __forceinline__ void operator()(int r, int co, float v0, float v1) const {
    const int b = r / hw, p = r - b * hw;
    const float tb = bf16_round(t[b]);
    const float* m = tmap + (size_t)p * C + co;
    *reinterpret_cast<float2*>(u + (size_t)r * C + co) =
        make_float2(concat_out<kBf16>(v0, bias[co], tb, m[0]),
                    concat_out<kBf16>(v1, bias[co + 1], tb, m[1]));
  }
};

}  // namespace nodef
