"""The 3×3 conv probe kernels: ``y = conv3x3_same(x, w)`` alone, in one CUDA
launch, one CTA per sample, under two strategies.

Replaces the TPU kernels of ``probes/conv_probe.py``: ``pallas_conv_2d``
(kernels from ``make_roll_kernel``) and ``pallas_conv`` (``make_kernel``,
``make_scratch_kernel``).  Source: ``csrc/conv_probe.cu``.

This is the split-ConcatConv contraction of the ODEfunc without bias and
time map: x (B, H, W, C) f32 NHWC, w (3, 3, C, C) f32 HWIO.  Strategies:

``'tap9'``    the shared device function ``conv3x3`` of
              ``csrc/odefunc_common.cuh`` with a store epilogue: the conv
              stage of ``odefunc.cu``, ``rk_step.cu`` and ``odefunc_bwd.cu``
              itself (the counterpart of the TPU ``seq9``/``tree9``/
              ``fori9``/``roll9``).
``'im2col'``  the CTA gathers its sample's (H·W, 9C) patch matrix into shared
              memory once and computes one (H·W, 9C) @ (9C, C) product, each
              thread a 4-channel × 4-pixel register tile (the counterpart of
              ``im2col``/``im2colS``/``rollS``).

Bound (H100 SXM: 67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s): at
B = 256, 7×7×64 the conv is 0.925 GFLOP, 13.8 µs of FFMA, against 6.6 MB
moved, 2.0 µs: bound by operations.  Both kernels are strict f32 FFMA on the
CUDA cores; a ``wgmma`` design and the ``*_bf16`` strategies are later work
(ROADMAP.md, Queue 2 item 5).

``conv3x3`` is the wrapper: a CPU tensor takes the plain PyTorch version
``conv3x3_plain``; a CUDA tensor launches the kernel or raises.
``conv3x3.launches`` counts launches.  No gradient: the TPU probe has none.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build
from .odefunc import MAX_SMEM, ptr, stream
from .odefunc import supported as _tap9_supported

__all__ = ["STRATEGIES", "conv3x3", "conv3x3_plain", "supported",
           "smem_bytes", "conv_flops", "conv_bytes"]

STRATEGIES = ("tap9", "im2col")

# Mirrors csrc/conv_probe.cu (kI2cThreads, kI2cPix, kI2cPad).
_I2C_THREADS = 256
_I2C_PIX = 4
_I2C_PAD = 4


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of both kernels: nine shifted slices of the
    zero-padded NHWC map, each times its (C, C) tap, summed in tap order
    (the kernels' arithmetic, step by step), in ``x``'s dtype."""
    _, hh, ww, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = None
    for ky in range(3):
        for kx in range(3):
            term = xp[:, ky:ky + hh, kx:kx + ww, :] @ w[ky, kx]
            out = term if out is None else out + term
    return out


def smem_bytes(hw: tuple[int, int], c: int) -> int:
    """Dynamic shared memory per CTA of the ``im2col`` kernel."""
    return 4 * (hw[0] * hw[1] * (9 * c + _I2C_PAD) + 2 * c * c)


def supported(hw: tuple[int, int], c: int, strategy: str = "tap9") -> bool:
    """The kernels' shape gate.  ``tap9``: the gate of the fused kernels
    (``kernels.odefunc.supported``).  ``im2col`` also needs C/4 to divide its
    256 threads, at most 4 pixels per thread, and the patch matrix within
    the 227 KB of shared memory.  7×7×64 and 6×6×64 pass both."""
    if not _tap9_supported(hw, c, 1):
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
    for fn in (lib.conv_probe_tap9, lib.conv_probe_im2col):
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            strategy: str = "tap9") -> torch.Tensor:
    """3×3 SAME conv C → C of ``x`` (B, H, W, C) float32 NHWC with ``w``
    (3, 3, C, C) HWIO, no bias."""
    if strategy.endswith("_bf16"):
        raise NotImplementedError(
            f"strategy {strategy!r}: the CUDA conv kernels compute in f32 "
            "only; bf16 multiplies wait for the tensor-core kernels "
            "(ROADMAP.md, Queue 2 item 5)")
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; available: "
                         f"{STRATEGIES}")
    if x.ndim != 4 or tuple(w.shape) != (3, 3, x.shape[-1], x.shape[-1]):
        raise ValueError(f"expected x (B, H, W, C) and w (3, 3, C, C), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.device.type == "cpu":
        return conv3x3_plain(x, w)
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
