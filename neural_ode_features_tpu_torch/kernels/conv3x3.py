"""The 3×3 conv probe kernels: ``y = conv3x3_same(x, w)`` alone, in one CUDA
launch, under five f32 strategies and four bf16 twins.

Replaces the TPU kernels of ``probes/conv_probe.py``: ``pallas_conv_2d``
(kernels from ``make_roll_kernel``) and ``pallas_conv`` (``make_kernel``,
``make_scratch_kernel``).  Source: ``csrc/conv_probe.cu``.

This is the split-ConcatConv contraction of the ODEfunc without bias and
time map: x (B, H, W, C) f32 NHWC, w (3, 3, C, C) f32 HWIO.  Strategies:

``'mma3'``    the shared device function ``conv3x3_mma`` of
              ``csrc/odefunc_common.cuh`` with a store epilogue: the conv
              stage of ``odefunc.cu``, ``rk_step.cu`` and ``odefunc_bwd.cu``
              itself at C = 64 to 512 (multiples of 32) on 7×7 and 6×6
              maps; at C % 64 == 32 it is the direct check of the padded
              last channel block.  An
              implicit GEMM on the tensor
              cores (``mma.sync.m16n8k8`` TF32, f32 accumulation) over the
              padded-pitch positions of one sample, with 3×TF32 error
              compensation: every f32 operand is split into a TF32 head and
              tail and each pair contributes ``a_lo·b_hi``, ``a_hi·b_lo`` and
              then ``a_hi·b_hi``.  f32-grade: an error near 2⁻²¹ per product.
``'wgmma3'``  the shared device function ``conv3x3_wgmma``: the same 3×TF32
              arithmetic on Hopper's ``wgmma.mma_async.m64n32k8`` TF32 (A
              from registers, B from shared memory: each tap's (64, 64) f32
              weight tile brought in once per CTA by ``cp.async.bulk``
              behind an mbarrier, each warpgroup splitting its quarter into
              TF32 heads and tails in the tensor cores' k order).  The conv
              stage of the f32 fused kernels (and of the backward's forward
              recompute) wherever ``kernels.odefunc.stage`` gives
              ``'wgmma3'``: C = 64 on 7×7, 6×6 and other maps with H·(W+2)
              ≤ 64; it takes exactly those shapes and gives ``mma3``'s
              bits.
``'mma1'``    ``mma3``'s kernel with the two tail products compiled out: plain
              TF32, about three decimal digits.  A reading of what f32-grade
              costs; nothing on a path uses it.
``'tap9'``    the f32 FFMA ``conv3x3`` of the same header: the fused kernels'
              stage at every other shape and the baseline of the race (the
              counterpart of the TPU ``seq9``/``tree9``/``fori9``/``roll9``).
``'im2col'``  the CTA gathers its sample's (H·W, 9C) patch matrix into shared
              memory once and computes one (H·W, 9C) @ (9C, C) product, each
              thread a 4-channel × 4-pixel register tile (the counterpart of
              ``im2col``/``im2colS``/``rollS``).

The bf16 twins, "bf16 multiplies, f32 accumulation" (the JAX probe's
``<strategy>_bf16``: both operands cast to bf16, products summed in f32),
whose plain version is ``conv3x3_plain(x, w, passes="bf16")``:

``'mma_bf16'``    the bf16 conv stage of ``conv3x3_mma``: one
                  ``mma.sync.m16n8k16`` bf16 pass per 16 channels, operands
                  rounded to nearest even as the fragments are packed.  The
                  conv stage of ``rk_step.cu``'s bf16 build and of
                  ``odefunc.cu``'s per-sample bf16 kernel where
                  ``kernels.odefunc.stage`` does not give ``'wgmma_bf16'``
                  (at C = 96–512 the paths run the rows build,
                  ``'rows_bf16'``, in its place), with ``mma3``'s gate.
``'wgmma_bf16'``  ``conv3x3_wgmma``'s bf16 build on x rounded as it is copied
                  in: the conv stage of the bf16 ``odefunc`` (and of the
                  bf16 backward's forward recompute) where ``stage`` gives
                  ``'wgmma_bf16'``, and only there.
``'tap9_bf16'``   nine per-tap bf16 products over the rows of every sample
                  (the TPU probe's ``seq9_bf16``, ``tree9_bf16``,
                  ``fori9_bf16``, ``roll9_bf16``): ``im2col_bf16``'s kernel
                  with one tap's 64 input channels as its stage (zero past
                  C), each stage summed as ``im2col_bf16`` sums one (a
                  tensor-core chain from zero per k half), the taps in f32
                  in order (:func:`tap9_wgmma_emulated`);
                  ``im2col_bf16``'s gate and tiles.  The fused bf16 builds'
                  FFMA stage, which the strategy was before, is read alone
                  by ``probes/timing_aids.py --tap9``.
``'im2col_bf16'`` one GEMM over the rows of every sample, as the TPU kernel's
                  ``(tb·H·W, 9C) @ (9C, C)`` dot: ``wgmma.mma_async``
                  m64n64k16 bf16 with both operands from shared memory
                  under the 128-byte swizzle (:func:`sw128_offset`), M tiled
                  in 64- or 128-row tiles across sample boundaries
                  (:func:`im2col_tile_rows`), K = 9C in stages of 64 that a
                  producer warpgroup builds (the patch, from the CTA's
                  window of x copied into shared memory as bf16 once; the
                  weights, converted) while the consumer warpgroups
                  multiply the stage before, through a ring of mbarriers.
                  It takes C a multiple of 4 up to 128, at maps whose
                  window fits (:func:`supported`).  ``tap9_bf16`` and
                  ``im2col_bf16`` are one template (``rows_wgmma_conv``) and
                  give the same bits where C is a multiple of 64.  From C =
                  72 to 512 where C % 8 == 0 (:func:`rows_wide`) both run
                  the rows kernel of ``csrc/rows_conv.cuh`` in its place,
                  the bf16 ``odefunc``'s conv stage there (``'rows_bf16'``):
                  x rounded into a bf16 scratch copy, the weights rounded
                  and laid out once per call, a second grid dimension over
                  128-channel N tiles, each stage's A slice gathered from
                  the bf16 copy by ``cp.async`` and its B slice brought in
                  by one ``cp.async.bulk`` (:func:`rows_wgmma_emulated`;
                  :func:`rows_tile_rows` picks the M tile).

Bound (H100 SXM: 67 TFLOP/s f32 outside the tensor cores, 495 TFLOP/s TF32
on them, 3.35 TB/s): at B = 256, 7×7×64 the conv is 0.925 GFLOP, 13.8 µs of
FFMA or 1.9 µs of TF32 products, against 6.6 MB moved, 2.0 µs.  So ``tap9``
and ``im2col`` are bound by operations, and with the tensor cores the conv
is bound by bytes.  ``mma3`` itself forms three products over a 64-row tile
(49 rows real): 3.6 GFLOP, 7.3 µs at the TF32 peak; ``mma_bf16`` one, 1.2
GFLOP, 1.2 µs at 989 TFLOP/s dense bf16, so it too is bound by bytes.
``wgmma3`` forms ``mma3``'s products; ``im2col_bf16`` and ``tap9_bf16``
0.925 GFLOP of bf16 products (no padded row at B = 256), 0.94 µs.

``conv3x3`` is the wrapper: a CPU tensor takes the plain PyTorch version
``conv3x3_plain``; a CUDA tensor launches the kernel or raises.
``conv3x3.launches`` counts launches.  No gradient: the TPU probe has none.

``tf32_split``, ``conv3x3_plain(passes=3 | 1)`` and ``conv3x3_padded_pitch``
emulate the tensor-core stage's arithmetic and its row mapping in plain
PyTorch; ``conv3x3_wgmma_emulated`` follows ``wgmma3`` step by step (its k
order, three products per k8 step, each tap's chain from zero, the fixed
order of the partial sums; ``transposed=True``, the backward's
input-gradient conv on that stage; ``precision='bf16'``, ``wgmma_bf16``:
two bf16 k16 steps a tap and k half), and
``wgmma_tile_offset``/``wgmma_pack`` (``wgmma_pack_rows``: the
input-gradient conv's half tile) and, for ``wgmma_bf16``,
``wgmma_bf16_offset``/``wgmma_pack_bf16``/``wgmma_pack_rows_bf16`` (its
conversion ``bf16_bits``) mirror where its weight tiles lie in shared
memory; ``im2col_patches``, ``im2col_wgmma_emulated`` and ``sw128_offset``
do the same for ``im2col_bf16``, ``tap9_wgmma_emulated`` for
``tap9_bf16``.  Tests and the probe's
error report use them; nothing on a path does. ``passes="bf16"`` is the bf16
twins' function itself (operands rounded, products exact, sums in ``x``'s
dtype).
"""

from __future__ import annotations

import ctypes
import itertools
import math

import torch
import torch.nn.functional as F

from . import _build
from .odefunc import (
    MAX_C,
    MAX_SMEM,
    MMA_M,
    ROWS_K,
    ROWS_NB,
    ROWS_SLICE,
    bf16_round,
    mma_ok,
    ptr,
    rows_ntiles,
    rows_pack_bytes,
    rows_scratch_bytes,
    stage,
    stream,
)
from .odefunc import supported as _fused_supported

__all__ = ["STRATEGIES", "BF16_STRATEGIES", "conv3x3", "conv3x3_plain",
           "conv3x3_padded_pitch", "conv3x3_wgmma_emulated", "wgmma_k_order",
           "wgmma_tile_offset", "wgmma_pack", "wgmma_pack_rows",
           "wgmma_rows_item", "wgmma_bf16_offset", "wgmma_pack_bf16",
           "wgmma_pack_rows_bf16", "bf16_bits", "tf32_split", "supported",
           "smem_bytes", "conv_flops", "conv_bytes", "sw128_offset",
           "im2col_patches", "im2col_wgmma_emulated", "tap9_wgmma_emulated",
           "im2col_tile_rows", "im2col_smem_bytes", "im2col_window_bytes",
           "ROWS_STRATEGIES", "rows_wide", "rows_tile_rows", "rows_smem_bytes",
           "rows_pack_bytes", "rows_scratch_bytes", "rows_wgmma_emulated"]

STRATEGIES = ("tap9", "im2col", "mma3", "mma1", "wgmma3")
# The bf16 twins; each has its f32 strategy's gate.
BF16_STRATEGIES = ("mma_bf16", "tap9_bf16", "im2col_bf16", "wgmma_bf16")
# The twin with its f32 strategy's gate.
_TWIN = {"mma_bf16": "mma3"}
# The strategies of one kernel over the rows of every sample
# (csrc/conv_probe.cu rows_wgmma_conv): one gate, a tile_rows argument.
ROWS_STRATEGIES = ("im2col_bf16", "tap9_bf16")

# Mirrors csrc/conv_probe.cu (kI2cThreads, kI2cPix, kI2cPad).
_I2C_THREADS = 256
_I2C_PIX = 4
_I2C_PAD = 4
# Mirrors csrc/conv_probe.cu (kI2wK, kI2wStages, kI2wMaxC, kI2wMaxWindow
# of im2col_bf16).
I2W_K = 64
I2W_STAGES = 4
I2W_MAX_C = 128
I2W_MAX_WINDOW = 65536
# Mirrors csrc/rows_conv.cuh (kRowsPerSlot: stages a ring slot holds;
# rows_ring: the slots of a 64- and a 128-row tile; kRowsK, kRowsNB,
# kRowsSlice live in kernels/odefunc.py, which sizes the bf16 odefunc's
# scratch).
ROWS_PER_SLOT = 2
ROWS_RING = {64: 2, 128: 3}


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split float32 ``x`` into a TF32 head and a TF32 tail, ``x ≈ hi + lo``
    to within 2⁻²¹ relative, as the tensor-core stage does: ``hi`` is ``x``
    rounded to 10 mantissa bits, to nearest with ties away from zero (as
    ``cvt.rna.tf32.f32``: add half a unit to the low 13 mantissa bits, then
    clear them), and ``lo`` is the TF32 part of ``x − hi``, its low 13
    mantissa bits cleared, which is what the tensor core reads of the f32
    difference that the kernel hands it."""
    if x.dtype != torch.float32:
        raise ValueError(f"tf32_split takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & -0x2000).view(torch.float32)
    return hi, lo


def _tap_product(a: torch.Tensor, b: torch.Tensor, passes) -> torch.Tensor:
    """One tap's (…, C) @ (C, C) product: plain (``passes=None``), or from
    TF32 heads and tails as the tensor-core stage forms it, the tail
    products first (3), or the head product alone (1), or of operands
    rounded to bf16 (``"bf16"``)."""
    if passes is None:
        return a @ b
    if passes == "bf16":
        return bf16_round(a) @ bf16_round(b)
    if passes not in (1, 3):
        raise ValueError(f"passes must be None, 1, 3 or 'bf16', got "
                         f"{passes!r}")
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    if passes == 1:
        return a_hi @ b_hi
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor,
                  passes: int | str | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernels: nine shifted slices of the
    zero-padded NHWC map, each times its (C, C) tap, summed in tap order
    (the kernels' arithmetic, step by step), in ``x``'s dtype.  ``passes=3``
    and ``passes=1`` (float32 only) form each tap's product from TF32 heads
    and tails as ``mma3`` and ``mma1`` do; they are an emulation for tests
    and error reports, used by nothing on a path.  ``passes="bf16"``: both
    operands rounded to bf16 and the products summed in ``x``'s dtype, the
    plain version of the bf16 strategies (the JAX probe's ``_bf16``
    arithmetic, bf16 operands with ``preferred_element_type=float32``)."""
    _, hh, ww, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = None
    for ky in range(3):
        for kx in range(3):
            term = _tap_product(xp[:, ky:ky + hh, kx:kx + ww, :], w[ky, kx],
                                passes)
            out = term if out is None else out + term
    return out


def conv3x3_padded_pitch(x: torch.Tensor, w: torch.Tensor,
                         passes: int | None = None) -> torch.Tensor:
    """The tensor-core stage's row mapping in plain PyTorch (a mirror of
    ``conv3x3_mma`` for the tests): the GEMM's M runs over the padded-pitch
    positions q = y·(W+2) + x of one sample, so the A rows of tap (ky, kx)
    are the rows q + ky·(W+2) + kx of the zero-bordered map flattened to
    ((H+2)·(W+2) + slack, C), one uniform shift and no gather; the two
    border columns of each row are computed and dropped."""
    b, hh, ww, c = x.shape
    wp = ww + 2
    m = -(-hh * wp // 16) * 16                       # whole 16-row tiles
    if m > MMA_M:
        raise ValueError(f"{hh}x{ww}: {hh * wp} padded-pitch positions do "
                         f"not fit the {MMA_M}-row tile")
    rows = m + 2 * wp + 2                            # slack for the last taps
    spad = x.new_zeros((b, rows, c))
    spad[:, :(hh + 2) * wp] = F.pad(x, (0, 0, 1, 1, 1, 1)).reshape(b, -1, c)
    out = None
    for tap in range(9):
        shift = (tap // 3) * wp + tap % 3
        term = _tap_product(spad[:, shift:shift + m], w[tap // 3, tap % 3],
                            passes)
        out = term if out is None else out + term
    q = torch.arange(hh * wp, device=x.device)
    return out[:, q[q % wp < ww]].reshape(b, hh, ww, c)


def wgmma_k_order() -> list[int]:
    """The physical input channel (within a group of 8) at each of the
    ``wgmma`` k8 step's logical k positions: the thread of lane t loads
    channels 2t and 2t+1 of a row as one 8-byte load and hands them to the
    instruction as its k = t and k = t + 4 (the register fragment of
    ``m64nNk8`` TF32), so logical k holds physical 2k for k < 4 and
    2(k − 4) + 1 above."""
    return [2 * k if k < 4 else 2 * (k - 4) + 1 for k in range(8)]


def wgmma_tile_offset(n: int, k: int) -> int:
    """Byte offset of output channel n, physical input channel k (each in
    0..63) in a split weight tile of ``wgmma3`` (csrc/odefunc_common.cuh
    ``wg_tile_offset``): K-major 8×4 core matrices of 128 bytes, the core
    matrix (n // 8, 2·(k // 8) + k % 2), row n % 8, column (k % 8) // 2."""
    return ((((n >> 3) * 16 + 2 * (k >> 3) + (k & 1)) * 8 + (n & 7)) * 16
            + ((k & 7) >> 1) * 4)


def wgmma_pack(tile: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One (64, 64) float32 weight tile (input channel k, output channel
    n) split as ``wgmma3`` splits it in shared memory: the TF32 heads and
    the f32 tails (``x − hi``, whose TF32 part the tensor cores read), each
    as 4096 floats in the tensor cores' order (:func:`wgmma_tile_offset`)."""
    if tile.shape != (64, 64) or tile.dtype != torch.float32:
        raise ValueError(f"expected a (64, 64) float32 tile, got "
                         f"{tuple(tile.shape)} {tile.dtype}")
    bits = tile.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    lo = tile - hi
    at = torch.tensor([[wgmma_tile_offset(int(nn), int(kk)) // 4
                        for nn in range(64)] for kk in range(64)])
    head, tail = torch.empty(4096), torch.empty(4096)
    head[at.reshape(-1)] = hi.reshape(-1)
    tail[at.reshape(-1)] = lo.reshape(-1)
    return head, tail


def wgmma_pack_rows(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The input-gradient conv's split of one CTA's half tile, as the
    cluster pass of ``csrc/odefunc_bwd.cu`` (``pair_conv<true>``) walks it:
    ``rows`` (32, 64) float32 are rows n (input channels 32r..) of tap
    8 − k's weights, columns k (output channels).  Each of the two
    warpgroups (k half kh) takes, per thread wt (0..127), row n = 8·(wt //
    32) + wt % 8 and the 8 consecutive k of octet o = (wt // 8 + wt % 8) %
    4 of its half, and writes the even k into one core-matrix row of the
    heads and tails and the odd k into the next (:func:`wgmma_tile_offset`
    with n < 32).  Returns the heads and the f32 tails, 2048 floats each."""
    if rows.shape != (32, 64) or rows.dtype != torch.float32:
        raise ValueError(f"expected (32, 64) float32 rows, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    bits = rows.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    lo = rows - hi
    head, tail = torch.full((2048,), float("nan")), torch.full((2048,), float("nan"))
    for kh in range(2):
        for wt in range(128):
            n, o = wgmma_rows_item(wt)
            k0 = 32 * kh + 8 * o
            for odd in range(2):
                at = wgmma_tile_offset(n, k0 + odd) // 4
                ks = [k0 + odd + 2 * e for e in range(4)]
                head[at:at + 4] = hi[n, ks]
                tail[at:at + 4] = lo[n, ks]
    return head, tail


def wgmma_rows_item(wt: int) -> tuple[int, int]:
    """Row n and k octet o of thread ``wt`` (0..127) of a warpgroup in
    :func:`wgmma_pack_rows`'s walk; its first 16-byte load is the octet's
    second half where ``wt % 8 >= 4``."""
    lane8 = wt & 7
    return 8 * (wt >> 5) + lane8, ((wt >> 3) + lane8) & 3


def bf16_bits(x: torch.Tensor) -> torch.Tensor:
    """The 16-bit patterns (as int32) of float32 ``x`` rounded to bf16 to
    nearest, ties to even, in integer arithmetic (``cvt.rn.bf16x2.f32``,
    csrc/odefunc_common.cuh ``bf16x2``, on finite values): add 0x7FFF and
    the lowest kept bit to the f32 bits, keep the high half."""
    if x.dtype != torch.float32:
        raise ValueError(f"bf16_bits takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).to(torch.int32) & 0xFFFF


def wgmma_bf16_offset(n: int, k: int) -> int:
    """Byte offset of output channel n, input channel k (each in 0..63) in
    the bf16 weight tile of ``wgmma_bf16`` (csrc/odefunc_common.cuh
    ``wg_bf16_offset``): K-major core matrices of 128 bytes, 8 rows n of
    16 bytes (8 k), the core matrix (n // 8, k // 8), row n % 8, column
    k % 8; so a descriptor's LBO (the next 8 k) is 128 bytes and its SBO
    (the next 8 n) 1,024."""
    return ((((n >> 3) * 8 + (k >> 3)) * 8 + (n & 7)) * 16 + (k & 7) * 2)


def wgmma_pack_bf16(tile: torch.Tensor) -> torch.Tensor:
    """One (64, 64) float32 weight tile (input channel k, output channel n)
    converted as ``wgmma_bf16`` converts it in shared memory: each of the
    four warpgroups (output half nh, k half kh) takes, per thread wt
    (0..127), n = 32·nh + wt % 32 and the k octet wt // 32 of its half, the
    eight values down the tile's column n, rounded (:func:`bf16_bits`) into
    one 16-byte core-matrix row.  Returns the 4,096 bf16 bit patterns (int32)
    in the tile's order (:func:`wgmma_bf16_offset`)."""
    if tile.shape != (64, 64) or tile.dtype != torch.float32:
        raise ValueError(f"expected a (64, 64) float32 tile, got "
                         f"{tuple(tile.shape)} {tile.dtype}")
    bits = bf16_bits(tile)
    out = torch.full((4096,), -1, dtype=torch.int32)
    for nh in range(2):
        for kh in range(2):
            for wt in range(128):
                n, k0 = 32 * nh + (wt & 31), 32 * kh + 8 * (wt >> 5)
                at = wgmma_bf16_offset(n, k0) // 2
                out[at:at + 8] = bits[k0:k0 + 8, n]
    return out


def wgmma_pack_rows_bf16(rows: torch.Tensor) -> torch.Tensor:
    """The input-gradient conv's conversion of one CTA's half tile in the
    bf16 cluster pass: ``rows`` (32, 64) float32 are rows n of tap 8 − k's
    weights, columns k; each warpgroup (k half kh) takes, per thread wt,
    the row and k octet of :func:`wgmma_rows_item` and writes the octet's
    eight values, rounded, into one core-matrix row.  Returns the 2,048
    bf16 bit patterns (int32) in :func:`wgmma_bf16_offset` order (n < 32)."""
    if rows.shape != (32, 64) or rows.dtype != torch.float32:
        raise ValueError(f"expected (32, 64) float32 rows, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    bits = bf16_bits(rows)
    out = torch.full((2048,), -1, dtype=torch.int32)
    for kh in range(2):
        for wt in range(128):
            n, o = wgmma_rows_item(wt)
            k0 = 32 * kh + 8 * o
            at = wgmma_bf16_offset(n, k0) // 2
            out[at:at + 8] = bits[n, k0:k0 + 8]
    return out


def conv3x3_wgmma_emulated(x: torch.Tensor, w: torch.Tensor,
                           transposed: bool = False,
                           precision: str = "f32") -> torch.Tensor:
    """``wgmma3``'s arithmetic in plain PyTorch, float32, at C = 64 (its
    only width; tests and the probe's error report, nothing on a path): the
    padded-pitch rows of :func:`conv3x3_padded_pitch`; per tap and k half
    (32 input channels), a chain of four k8 steps from zero, each step
    ``a_lo·b_hi``, ``a_hi·b_lo``, ``a_hi·b_hi`` (TF32 heads and tails,
    :func:`tf32_split`) added in that order, each product's eight terms in
    the instruction's k order (:func:`wgmma_k_order`, exact products summed
    in float32); each chain added to its half's running sum in float32,
    taps in order; last, first half + second half.  The tensor cores' own
    summation order and rounding inside a product are the card's; this
    follows every order the kernel fixes.  ``transposed``: the backward's
    input-gradient conv on the same stage (the cluster pass of
    ``csrc/odefunc_bwd.cu``), ``x`` the cotangent and tap k's B tile the
    transpose of tap 8 − k's (C, C) weights (row = output channel of the
    forward conv): the gradient of the conv with ``w`` with respect to its
    input.  ``precision='bf16'``: ``wgmma_bf16``'s arithmetic, both
    operands rounded to bf16 and per tap and k half a chain of two k16
    steps from zero, each step's sixteen exact products summed in float32
    in k order; the same order of sums after it.  ``'bf16_conv'``: the
    fused step's bf16 convs on that stage, whose input its writer has
    rounded already: the same arithmetic.  In bf16 it takes every
    tensor-core width (:func:`mma_ok`, C a multiple of 32 from 64 to 512):
    ``mma_bf16``'s order, the conv stage of the bf16 builds' one CTA per
    sample there (``conv3x3_mma<kPassBf16>``): per k half, tiles (tap,
    64-channel input block) tap-major, a k half wholly past C skipped."""
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError("conv3x3_wgmma_emulated takes float32")
    if precision not in ("f32", "bf16", "bf16_conv"):
        raise ValueError(f"precision must be 'f32', 'bf16' or 'bf16_conv', "
                         f"got {precision!r}")
    b, hh, ww, c = x.shape
    wp = ww + 2
    bf16 = precision != "f32"
    if hh * wp > MMA_M or not (c == 64 or bf16 and mma_ok((hh, ww), c)):
        raise ValueError(f"wgmma3 takes C = 64 (bf16: C a multiple of 32 "
                         f"from 64 to 512) and H·(W+2) <= {MMA_M}, got "
                         f"{hh}x{ww}x{c}")
    cpad = -(-c // 64) * 64
    spad = x.new_zeros((b, MMA_M + 2 * wp + 2, cpad))
    spad[:, :(hh + 2) * wp, :c] = F.pad(x, (0, 0, 1, 1, 1, 1)).reshape(
        b, -1, c)
    order = torch.arange(16) if bf16 else torch.tensor(wgmma_k_order())
    halves = []
    for kh in range(2):
        run = x.new_zeros((b, MMA_M, c))
        for tap, kb in itertools.product(range(9), range(cpad // 64)):
            if 64 * kb + 32 * kh >= c:  # a k half of zeros: skipped
                continue
            shift = (tap // 3) * wp + tap % 3
            tile = w.new_zeros((cpad, c))
            tile[:c] = (w[2 - tap // 3, 2 - tap % 3].T if transposed
                        else w[tap // 3, tap % 3])
            acc = None
            for ks in range(2 if bf16 else 4):
                idx = 64 * kb + 32 * kh + len(order) * ks + order
                a, bt = spad[:, shift:shift + MMA_M, idx], tile[idx].contiguous()
                if bf16:
                    pairs = ((bf16_round(a), bf16_round(bt)),)
                else:
                    a_hi, a_lo = tf32_split(a)
                    b_hi, b_lo = tf32_split(bt)
                    pairs = ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))
                for pa, pb in pairs:
                    terms = pa.unsqueeze(-1) * pb  # (b, M, k, C), exact
                    prod = terms[:, :, 0]
                    for kk in range(1, len(order)):
                        prod = prod + terms[:, :, kk]
                    acc = prod if acc is None else acc + prod
            run = run + acc
        halves.append(run)
    out = halves[0] + halves[1]
    q = torch.arange(hh * wp)
    return out[:, q[q % wp < ww]].reshape(b, hh, ww, c)


def sw128_offset(r: int, k: int) -> int:
    """Byte offset of row r (a patch row m of A, an output channel n of B)
    and element k (0..63) in a K-major bf16 tile of ``im2col_bf16`` under
    the 128-byte swizzle (csrc/odefunc_common.cuh ``sw128_offset``): rows
    of 128 bytes (64 k), the 16-byte chunk k // 8 of row r at chunk
    (k // 8) ^ (r % 8), element k % 8 of 2 bytes in it."""
    return r * 128 + (((k >> 3) ^ (r & 7)) << 4) + (k & 7) * 2


def im2col_patches(x: torch.Tensor) -> torch.Tensor:
    """The patch matrix of a 3×3 SAME conv: x (B, H, W, C) as (B·H·W, 9C),
    row r = (b·H + y)·W + x, column tap·C + ci (tap = 3·ky + kx), zero
    where the tap lies off the map."""
    b, hh, ww, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.cat([xp[:, ky:ky + hh, kx:kx + ww, :].reshape(-1, c)
                      for ky in range(3) for kx in range(3)], dim=1)


def im2col_window_bytes(tile_rows: int, w: int, c: int) -> int:
    """Bytes of ``im2col_bf16``'s window of x in shared memory (csrc/
    conv_probe.cu ``i2w_window_bytes``): the tile's rows and W + 1 rows on
    either side, C channels of bf16 each, rounded up to 16 bytes."""
    return -(-(tile_rows + 2 * w + 2) * 2 * c // 16) * 16


def im2col_tile_rows(rows: int, sms: int, c: int, w: int) -> int:
    """The M tile of ``im2col_bf16`` for ``rows`` = B·H·W rows of maps W
    wide with C channels on a card of ``sms`` SMs: 64 rows (one consumer
    warpgroup, a CTA an SM) where the 64-row tiles fit one wave of the
    card, C > 64 (a consumer's running sums of two 64-channel blocks take
    the registers of one warpgroup of two) or the 128-row tile's window of
    x does not fit; else 128 (two consumer warpgroups: half the CTAs, each
    converting the weights once for 128 rows)."""
    return (64 if -(-rows // 64) <= sms or c > 64
            or im2col_window_bytes(128, w, c) > I2W_MAX_WINDOW else 128)


def im2col_smem_bytes(tile_rows: int, c: int, w: int) -> int:
    """Dynamic shared memory per CTA of ``im2col_bf16`` (csrc/conv_probe.cu
    ``i2w_smem_bytes``): 1,024 bytes to align, the ring of stages, each the
    (tile_rows, 64) patch slice and the (64·⌈C/64⌉, 64) weight slice in
    bf16, the staging ring of the weights' f32 rows (four stages at C ≤
    64, else two; rows of C/4 16-byte chunks rounded up to a multiple of
    8), the window of x (:func:`im2col_window_bytes`) and two
    mbarriers a stage."""
    nb = -(-c // 64)
    depth = 4 if nb == 1 else 2
    return (1024 + I2W_STAGES * (tile_rows + 64 * nb) * I2W_K * 2
            + depth * I2W_K * -(-c // 32) * 8 * 16
            + im2col_window_bytes(tile_rows, w, c) + 16 * I2W_STAGES)


def rows_wide(c: int) -> bool:
    """Whether ``im2col_bf16`` and ``tap9_bf16`` run the rows kernel of
    ``csrc/rows_conv.cuh`` at width ``c`` (C > 64, C % 8 == 0, C ≤ 512;
    csrc/rows_conv.cuh ``rows_ok``) rather than the window kernel: 16-byte
    copies of 8 channels of one tap straight from a bf16 copy of x."""
    return 64 < c <= MAX_C and c % 8 == 0


def rows_smem_bytes(tile_rows: int) -> int:
    """Dynamic shared memory per CTA of the rows kernel (csrc/rows_conv.cuh
    ``rows_smem_bytes``): 1,024 bytes to align and ``ROWS_RING[tile_rows]``
    slots, each ``ROWS_PER_SLOT`` stages' (tile_rows, 64) A slices and
    (128, 64) B slices in bf16 and two mbarriers."""
    return (1024 + ROWS_RING[tile_rows]
            * (ROWS_PER_SLOT * (tile_rows // 64 + ROWS_NB) * ROWS_SLICE + 16))


def rows_tile_rows(rows: int, sms: int, c: int) -> int:
    """The rows kernel's M tile for ``rows`` = B·H·W rows of C channels on a
    card of ``sms`` SMs (csrc/rows_conv.cuh ``rows_tile_rows``): 128 rows
    (two consumer warpgroups sharing each B slice, three ring slots, one
    CTA an SM) where the 128-row tiles times the N tiles give at least
    every other SM a CTA, else 64 (two slots, two CTAs an SM)."""
    return 128 if 2 * -(-rows // 128) * rows_ntiles(c) >= sms else 64


def _stage_sums(a: torch.Tensor, bw: torch.Tensor) -> torch.Tensor:
    """The rows kernel's order of sums over ``a`` (R, K) @ ``bw`` (K, C),
    both rounded, K whole stages of 64: per stage and k half (k 0..31 and
    32..63 of the stage) a chain of two k16 steps from zero, each step's
    sixteen exact products summed in float32 in k order, added to that
    half's running sum in float32, stages in order; last, the first half's
    sum plus the second's."""
    runs = [a.new_zeros((a.shape[0], bw.shape[1])) for _ in range(2)]
    for k0 in range(0, a.shape[1], 32):
        chain = None
        for ks in (k0, k0 + 16):
            terms = a[:, ks:ks + 16, None] * bw[ks:ks + 16]  # exact in f32
            step = terms[:, 0]
            for kk_ in range(1, 16):
                step = step + terms[:, kk_]
            chain = step if chain is None else chain + step
        half = (k0 // 32) % 2
        runs[half] = runs[half] + chain
    return runs[0] + runs[1]


def im2col_wgmma_emulated(x: torch.Tensor, w: torch.Tensor,
                          tile_rows: int = 64) -> torch.Tensor:
    """``im2col_bf16``'s arithmetic in plain PyTorch, float32 (tests and the
    probe's error report, nothing on a path): the rows of every sample
    flattened (:func:`im2col_patches`) and padded with zero rows to whole
    ``tile_rows`` tiles, both operands rounded to bf16, K = 9C padded with
    zeros to whole stages of 64, summed in the kernel's order
    (:func:`_stage_sums`).  At C = 64 a stage is a tap: the order of
    ``mma_bf16`` and ``wgmma_bf16`` (:func:`conv3x3_wgmma_emulated`).  The
    tensor cores' own order and rounding inside a step are the card's;
    this follows every order the kernel fixes."""
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError("im2col_wgmma_emulated takes float32")
    b, hh, ww, c = x.shape
    rows, kk = b * hh * ww, 9 * c
    a = x.new_zeros((-(-rows // tile_rows) * tile_rows,
                     -(-kk // I2W_K) * I2W_K))
    a[:rows, :kk] = bf16_round(im2col_patches(x))
    bw = x.new_zeros((a.shape[1], c))
    bw[:kk] = bf16_round(w.reshape(kk, c))
    return _stage_sums(a, bw)[:rows].reshape(b, hh, ww, c)


def tap9_wgmma_emulated(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``tap9_bf16``'s arithmetic in plain PyTorch, float32 (tests and the
    probe's error report, nothing on a path): the patch matrix with each
    tap's C columns padded with zeros to 64·⌈C/64⌉ (a stage: 64 input
    channels of one tap), both operands rounded to bf16, summed in
    ``im2col_bf16``'s order of a stage (:func:`_stage_sums`: per k half a
    chain of two k16 steps from zero), taps in order (the TPU's
    ``seq9_bf16``: ``acc = acc + dot(patch, w_tap)``, each tap's dot split
    in k halves).  Where C is a multiple of 64 the stages are
    ``im2col_bf16``'s: :func:`im2col_wgmma_emulated` bit for bit.  The tile
    height changes no row's sums."""
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError("tap9_wgmma_emulated takes float32")
    b, hh, ww, c = x.shape
    cp = -(-c // I2W_K) * I2W_K
    patches = bf16_round(im2col_patches(x))
    a = x.new_zeros((patches.shape[0], 9 * cp))
    bw = x.new_zeros((9 * cp, c))
    wt = bf16_round(w.reshape(9, c, c))
    for tap in range(9):
        a[:, tap * cp:tap * cp + c] = patches[:, tap * c:(tap + 1) * c]
        bw[tap * cp:tap * cp + c] = wt[tap]
    return _stage_sums(a, bw).reshape(b, hh, ww, c)


def rows_wgmma_emulated(x: torch.Tensor, w: torch.Tensor, tap: bool = True,
                        tile_rows: int = 64,
                        tile_cols: int = 64 * ROWS_NB) -> torch.Tensor:
    """The rows kernel's arithmetic in plain PyTorch, float32, tile by tile
    (tests only, nothing on a path): the rows of every sample flattened
    (:func:`im2col_patches`) and cut into ``tile_rows`` M tiles, the output
    channels into ``tile_cols`` N tiles (each padded with zeros), both
    operands rounded to bf16, each tile summed on its own in the kernel's
    order (:func:`_stage_sums`) over its stages: ``tap`` (``tap9_bf16``,
    the bf16 ``odefunc``'s ``'rows_bf16'``) one tap's 64 input channels a
    stage, zero past C; else (``im2col_bf16``) 64 k of K = 9C.  The tiles
    change no row's and no column's sums: :func:`tap9_wgmma_emulated`'s
    bits, and at the tensor-core widths
    ``conv3x3_wgmma_emulated(precision='bf16')``'s (``mma_bf16``'s)."""
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError("rows_wgmma_emulated takes float32")
    b, hh, ww, c = x.shape
    rows = b * hh * ww
    patches = bf16_round(im2col_patches(x))
    wt = bf16_round(w.reshape(9, c, c))
    step = -(-c // ROWS_K) * ROWS_K if tap else c  # K columns a tap
    kk = -(-9 * step // ROWS_K) * ROWS_K             # whole stages
    a = x.new_zeros((-(-rows // tile_rows) * tile_rows, kk))
    bw = x.new_zeros((kk, -(-c // tile_cols) * tile_cols))
    for t in range(9):
        a[:rows, t * step:t * step + c] = patches[:, t * c:(t + 1) * c]
        bw[t * step:t * step + c, :c] = wt[t]
    out = x.new_empty((a.shape[0], bw.shape[1]))
    for m0 in range(0, a.shape[0], tile_rows):
        for n0 in range(0, bw.shape[1], tile_cols):
            out[m0:m0 + tile_rows, n0:n0 + tile_cols] = _stage_sums(
                a[m0:m0 + tile_rows], bw[:, n0:n0 + tile_cols])
    return out[:rows, :c].reshape(b, hh, ww, c)


def smem_bytes(hw: tuple[int, int], c: int) -> int:
    """Dynamic shared memory per CTA of the ``im2col`` kernel."""
    return 4 * (hw[0] * hw[1] * (9 * c + _I2C_PAD) + 2 * c * c)


def supported(hw: tuple[int, int], c: int, strategy: str = "tap9") -> bool:
    """The kernels' shape gate.  ``tap9``: the gate of the fused kernels'
    FFMA stage (``kernels.odefunc.supported`` with ``conv_stage='ffma'``).
    ``im2col`` also needs C/4 to divide its 256 threads, at most 4 pixels
    per thread, and the patch matrix within the 227 KB of shared memory.
    ``mma3`` and ``mma1``: the tensor-core stage's gate
    (``kernels.odefunc.mma_ok``: C a multiple of 32 from 64 to 512 and
    H·(W+2) ≤ 64) and its working set within shared memory
    (``kernels.odefunc.layout``).  ``wgmma3``: where the f32 kernels run it
    (``stage`` gives ``'wgmma3'``), under their layout; ``wgmma_bf16``
    where the bf16 kernels run theirs.  ``im2col_bf16`` and ``tap9_bf16`` (csrc/conv_probe.cu
    ``i2w_shape_ok``): C a multiple of 4 from 4 to 128 on maps up to a
    width whose window of x fits 64 KB (W ≤ 95 at C = 128, 223 at C = 64;
    the wrapper also needs B·H·W·C < 2³¹), every shape of ``tap9``'s gate
    among them; and, on the rows kernel of ``csrc/rows_conv.cuh``
    (:func:`rows_wide`), C a multiple of 8 from 72 to 512 on any map.
    7×7×64 and 6×6×64 pass all nine, 7×7×96 to 7×7×512 the tensor-core
    ones and these two.  ``mma_bf16`` has its f32 strategy's gate."""
    strategy = _TWIN.get(strategy, strategy)
    if strategy in ROWS_STRATEGIES:
        return hw[0] >= 1 and hw[1] >= 1 and (rows_wide(c) or (
            4 <= c <= I2W_MAX_C and c % 4 == 0
            and im2col_window_bytes(64, hw[1], c) <= I2W_MAX_WINDOW))
    if strategy in ("mma3", "mma1"):
        return mma_ok(hw, c) and _fused_supported(hw, c, 1, "mma3")
    if strategy in ("wgmma3", "wgmma_bf16"):
        precision = "f32" if strategy == "wgmma3" else "bf16"
        return (stage(hw, c, precision) == strategy
                and _fused_supported(hw, c, 1, strategy))
    if not _fused_supported(hw, c, 1, "ffma"):
        return False
    if strategy == "tap9":
        return True
    if _I2C_THREADS % (c // 4):
        return False
    npg = _I2C_THREADS // (c // 4)
    return (math.ceil(hw[0] * hw[1] / npg) <= _I2C_PIX
            and smem_bytes(hw, c) <= MAX_SMEM)


def conv_flops(b: int, hw: tuple[int, int], c: int) -> int:
    """Operations of one conv: a multiply and an add per (pixel, tap, input
    channel, output channel)."""
    return 2 * b * hw[0] * hw[1] * 9 * c * c


def conv_bytes(b: int, hw: tuple[int, int], c: int) -> int:
    """Bytes one conv must move: x read once, y written once, w read once."""
    return 4 * (2 * b * hw[0] * hw[1] * c + 9 * c * c)


def _lib() -> ctypes.CDLL:
    lib = _build.load("conv_probe")
    for strategy in STRATEGIES + BF16_STRATEGIES:
        fn = getattr(lib, f"conv_probe_{strategy}")
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                           + [ctypes.c_void_p]
                           + [ctypes.c_int] * (strategy in ROWS_STRATEGIES))
            fn.restype = ctypes.c_int
    fn = lib.conv_probe_rows_bf16
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def conv3x3(x: torch.Tensor, w: torch.Tensor, strategy: str = "tap9",
            tile_rows: int | None = None) -> torch.Tensor:
    """3×3 SAME conv C → C of ``x`` (B, H, W, C) float32 NHWC with ``w``
    (3, 3, C, C) HWIO, no bias.  A bf16 strategy rounds both operands to
    bf16 and sums the products in f32.  ``tile_rows`` (``im2col_bf16`` and
    ``tap9_bf16`` only, 64 or 128; 128 at C ≤ 64 where its window fits,
    or on the rows kernel): their M tile, in place of
    :func:`im2col_tile_rows`' or :func:`rows_tile_rows`' choice (the
    values do not depend on it)."""
    if strategy not in STRATEGIES + BF16_STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; available: "
                         f"{STRATEGIES + BF16_STRATEGIES}")
    if x.ndim != 4 or tuple(w.shape) != (3, 3, x.shape[-1], x.shape[-1]):
        raise ValueError(f"expected x (B, H, W, C) and w (3, 3, C, C), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    wide = rows_wide(x.shape[-1])
    if tile_rows is not None and (
            strategy not in ROWS_STRATEGIES or tile_rows not in (64, 128)
            or (tile_rows == 128 and not wide and (
                x.shape[-1] > 64 or im2col_window_bytes(
                    128, x.shape[2], x.shape[-1]) > I2W_MAX_WINDOW))):
        raise ValueError(f"tile_rows (64, or 128 at C <= 64 where its "
                         f"window fits and on the rows kernel) is "
                         f"{ROWS_STRATEGIES}' alone, got {tile_rows!r} for "
                         f"{strategy!r} at {tuple(x.shape)}")
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, "bf16" if strategy in BF16_STRATEGIES
                             else None)
    b, hh, ww, c = x.shape
    if (b < 1 or not supported((hh, ww), c, strategy)
            or b * hh * ww * c >= 2 ** 31):
        raise ValueError(
            f"the CUDA conv kernel {strategy!r} does not take B×H×W×C = "
            f"{b}×{hh}×{ww}×{c} (see kernels.conv3x3.supported)")
    for name, a in (("x", x), ("w", w)):
        if a.device != x.device or a.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 on {x.device}, got "
                             f"{a.dtype} on {a.device}")
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"{name}: expected a contiguous, 16-byte "
                             "aligned tensor")
    y = torch.empty_like(x)
    lib = _lib()
    entry = f"conv_probe_{strategy}"
    args = [ptr(x), ptr(w), ptr(y), b, hh, ww, c, stream()]
    if strategy in ROWS_STRATEGIES:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        if wide:
            tap = strategy == "tap9_bf16"
            scratch = torch.empty(rows_scratch_bytes(b, (hh, ww), c, tap),
                                  dtype=torch.uint8, device=x.device)
            entry = "conv_probe_rows_bf16"
            args += [tile_rows or rows_tile_rows(b * hh * ww, sms, c), tap,
                     ptr(scratch)]
        else:
            args.append(tile_rows or im2col_tile_rows(b * hh * ww, sms, c,
                                                      ww))
    code = getattr(lib, entry)(*args)
    _build.check(lib, code, entry)
    conv3x3.launches += 1
    return y


conv3x3.launches = 0
