"""The 3×3 conv probe kernels: ``y = conv3x3_same(x, w)`` alone, in one CUDA
launch, one CTA per sample, under four f32 strategies and three bf16 twins.

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
                  conv stage of the bf16 builds of ``odefunc.cu`` and
                  ``rk_step.cu``, with ``mma3``'s gate.
``'tap9_bf16'``   ``tap9`` on bf16-rounded operands (the bf16 builds' stage
                  at the FFMA shapes).
``'im2col_bf16'`` ``im2col`` on bf16-rounded operands.

Bound (H100 SXM: 67 TFLOP/s f32 outside the tensor cores, 495 TFLOP/s TF32
on them, 3.35 TB/s): at B = 256, 7×7×64 the conv is 0.925 GFLOP, 13.8 µs of
FFMA or 1.9 µs of TF32 products, against 6.6 MB moved, 2.0 µs.  So ``tap9``
and ``im2col`` are bound by operations, and with the tensor cores the conv
is bound by bytes.  ``mma3`` itself forms three products over a 64-row tile
(49 rows real): 3.6 GFLOP, 7.3 µs at the TF32 peak; ``mma_bf16`` one, 1.2
GFLOP, 1.2 µs at 989 TFLOP/s dense bf16, so it too is bound by bytes.
``wgmma3`` forms ``mma3``'s products.

``conv3x3`` is the wrapper: a CPU tensor takes the plain PyTorch version
``conv3x3_plain``; a CUDA tensor launches the kernel or raises.
``conv3x3.launches`` counts launches.  No gradient: the TPU probe has none.

``tf32_split``, ``conv3x3_plain(passes=3 | 1)`` and ``conv3x3_padded_pitch``
emulate the tensor-core stage's arithmetic and its row mapping in plain
PyTorch; ``conv3x3_wgmma_emulated`` follows ``wgmma3`` step by step (its k
order, three products per k8 step, each tap's chain from zero, the fixed
order of the partial sums), and ``wgmma_tile_offset``/``wgmma_pack`` mirror
where its split weight tiles lie in shared memory.  Tests and the probe's
error report use them; nothing on a path does. ``passes="bf16"`` is the bf16
twins' function itself (operands rounded, products exact, sums in ``x``'s
dtype).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build
from .odefunc import MAX_SMEM, MMA_M, bf16_round, ptr, stage, stream
from .odefunc import supported as _fused_supported

__all__ = ["STRATEGIES", "BF16_STRATEGIES", "conv3x3", "conv3x3_plain",
           "conv3x3_padded_pitch", "conv3x3_wgmma_emulated", "wgmma_k_order",
           "wgmma_tile_offset", "wgmma_pack", "tf32_split", "supported",
           "smem_bytes", "conv_flops", "conv_bytes"]

STRATEGIES = ("tap9", "im2col", "mma3", "mma1", "wgmma3")
# The bf16 twins; each has its f32 strategy's gate.
BF16_STRATEGIES = ("mma_bf16", "tap9_bf16", "im2col_bf16")
_TWIN = {"mma_bf16": "mma3", "tap9_bf16": "tap9", "im2col_bf16": "im2col"}

# Mirrors csrc/conv_probe.cu (kI2cThreads, kI2cPix, kI2cPad).
_I2C_THREADS = 256
_I2C_PIX = 4
_I2C_PAD = 4


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


def conv3x3_wgmma_emulated(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
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
    follows every order the kernel fixes."""
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError("conv3x3_wgmma_emulated takes float32")
    b, hh, ww, c = x.shape
    wp = ww + 2
    if c != 64 or hh * wp > MMA_M:
        raise ValueError(f"wgmma3 takes C = 64 and H·(W+2) <= {MMA_M}, got "
                         f"{hh}x{ww}x{c}")
    spad = x.new_zeros((b, MMA_M + 2 * wp + 2, c))
    spad[:, :(hh + 2) * wp] = F.pad(x, (0, 0, 1, 1, 1, 1)).reshape(b, -1, c)
    order = torch.tensor(wgmma_k_order())
    halves = []
    for kh in range(2):
        run = x.new_zeros((b, MMA_M, c))
        for tap in range(9):
            shift = (tap // 3) * wp + tap % 3
            acc = None
            for ks in range(4):
                idx = 32 * kh + 8 * ks + order
                a_hi, a_lo = tf32_split(spad[:, shift:shift + MMA_M, idx])
                b_hi, b_lo = tf32_split(w[tap // 3, tap % 3][idx])
                for pa, pb in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
                    terms = pa.unsqueeze(-1) * pb  # (b, M, 8, C), exact
                    prod = terms[:, :, 0]
                    for kk in range(1, 8):
                        prod = prod + terms[:, :, kk]
                    acc = prod if acc is None else acc + prod
            run = run + acc
        halves.append(run)
    out = halves[0] + halves[1]
    q = torch.arange(hh * wp)
    return out[:, q[q % wp < ww]].reshape(b, hh, ww, c)


def smem_bytes(hw: tuple[int, int], c: int) -> int:
    """Dynamic shared memory per CTA of the ``im2col`` kernel."""
    return 4 * (hw[0] * hw[1] * (9 * c + _I2C_PAD) + 2 * c * c)


def supported(hw: tuple[int, int], c: int, strategy: str = "tap9") -> bool:
    """The kernels' shape gate.  ``tap9``: the gate of the fused kernels'
    FFMA stage (``kernels.odefunc.supported`` with ``conv_stage='ffma'``).
    ``im2col`` also needs C/4 to divide its 256 threads, at most 4 pixels
    per thread, and the patch matrix within the 227 KB of shared memory.
    ``mma3`` and ``mma1``: the tensor-core stage's gate
    (``kernels.odefunc.stage`` of a bf16 build: C a multiple of 32 from 64
    to 512 and H·(W+2) ≤ 64) and its working set within shared memory
    (``kernels.odefunc.layout``).  ``wgmma3``: where the f32 kernels run it
    (``stage`` gives ``'wgmma3'``), under their layout.  7×7×64 and 6×6×64
    pass all five, 7×7×96 to 7×7×512 the tensor-core ones.  A bf16 twin has
    its f32 strategy's gate."""
    strategy = _TWIN.get(strategy, strategy)
    if strategy in ("mma3", "mma1"):
        return (stage(hw, c, "bf16") == "mma3"
                and _fused_supported(hw, c, 1, "mma3"))
    if strategy == "wgmma3":
        return (stage(hw, c) == "wgmma3"
                and _fused_supported(hw, c, 1, "wgmma3"))
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
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            strategy: str = "tap9") -> torch.Tensor:
    """3×3 SAME conv C → C of ``x`` (B, H, W, C) float32 NHWC with ``w``
    (3, 3, C, C) HWIO, no bias.  A bf16 strategy rounds both operands to
    bf16 and sums the products in f32."""
    if strategy not in STRATEGIES + BF16_STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; available: "
                         f"{STRATEGIES + BF16_STRATEGIES}")
    if x.ndim != 4 or tuple(w.shape) != (3, 3, x.shape[-1], x.shape[-1]):
        raise ValueError(f"expected x (B, H, W, C) and w (3, 3, C, C), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, "bf16" if strategy in BF16_STRATEGIES
                             else None)
    b, hh, ww, c = x.shape
    if b < 1 or not supported((hh, ww), c, strategy):
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
    fn = getattr(lib, f"conv_probe_{strategy}")
    code = fn(ptr(x), ptr(w), ptr(y), b, hh, ww, c, stream())
    _build.check(lib, code, f"conv_probe_{strategy}")
    conv3x3.launches += 1
    return y


conv3x3.launches = 0
