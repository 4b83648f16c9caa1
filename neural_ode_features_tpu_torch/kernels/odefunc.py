"""Fused ODEfunc kernel: f(t, h) = GN→ReLU→ConcatConv3×3→GN→ReLU→
ConcatConv3×3→GN in one CUDA launch, one CTA per sample.

Replaces the TPU kernel ``neural_ode_features_tpu/kernels/odefunc_pallas.py``
(``_odefunc_pallas`` → ``_odefunc_kernel``).  Source: ``csrc/odefunc.cu``
with the per-sample code in ``csrc/odefunc_common.cuh``.

Bound (H100 SXM, 700 W power limit; 67 TFLOP/s f32 outside the tensor
cores, 3.35 TB/s): the two 3×3 convs are 2 · 2·H·W·9C·C FLOP per sample,
1.85 GFLOP at B = 256, 7×7×64, i.e. about 28 µs of FFMA; the bytes (state in
and out, 0.3 MB of weights) are 6.7 MB, about 2 µs.  So it is bound by
operations.  The design keeps the sample in shared memory for the whole
chain (state, padded conv input, GroupNorm scratch), streams each conv
tap's weights into shared memory once per CTA (cp.async, double-buffered)
and runs the convs as register-tiled FFMA.  Strict f32: no TF32, no tensor
cores; those are later work (ROADMAP.md).

``odefunc`` is the wrapper: a CPU tensor takes the plain PyTorch version
``odefunc_plain`` (which the tests hold against the JAX package); a CUDA
tensor launches the kernel or raises.  ``odefunc.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..ops.layers import conv2d, group_norm, time_map
from . import _build

__all__ = ["OdefuncWeights", "prepare", "supported", "smem_bytes",
           "odefunc", "odefunc_plain"]

# Mirrors csrc/odefunc_common.cuh (kThreads, kMaxPix, kMaxSmem).
THREADS = 512
MAX_PIX = 8
MAX_SMEM = 232448 - 1024


class OdefuncWeights(NamedTuple):
    """ODEfunc parameters laid out for the kernels, f32 and contiguous:
    conv kernels split into the state part ``w`` (3, 3, C, C) HWIO and the
    border-aware time maps ``m`` (H, W, C) of the split ConcatConv."""

    n1s: torch.Tensor
    n1b: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    m1: torch.Tensor
    n2s: torch.Tensor
    n2b: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    m2: torch.Tensor
    n3s: torch.Tensor
    n3b: torch.Tensor


def prepare(params, hw: tuple[int, int]) -> OdefuncWeights:
    """Lay out an ODEfunc param dict (``norm1/conv1/norm2/conv2/norm3``,
    conv kernels (3, 3, C+1, C)) for maps of spatial shape ``hw``.  The time
    maps are computed here once, in strict f32.  Weights already laid out
    are returned as they are."""
    if isinstance(params, OdefuncWeights):
        return params
    hh, ww = hw

    def f32(x):
        return x.float().contiguous()

    def conv(name):
        k = params[name]["kernel"].float()
        return (f32(k[:, :, 1:, :]), f32(params[name]["bias"]),
                f32(time_map(k, hh, ww)))

    w1, b1, m1 = conv("conv1")
    w2, b2, m2 = conv("conv2")
    return OdefuncWeights(
        f32(params["norm1"]["scale"]), f32(params["norm1"]["bias"]), w1, b1, m1,
        f32(params["norm2"]["scale"]), f32(params["norm2"]["bias"]), w2, b2, m2,
        f32(params["norm3"]["scale"]), f32(params["norm3"]["bias"]))


def smem_bytes(hw: tuple[int, int], c: int, groups: int) -> int:
    """Dynamic shared memory per CTA (csrc/odefunc_common.cuh)."""
    hh, ww = hw
    return 4 * (hh * ww * c + (hh + 2) * (ww + 2) * c + 2 * c * c + THREADS
                + 2 * groups)


def supported(hw: tuple[int, int], c: int, groups: int) -> bool:
    """The kernels' shape gate: C divisible by 4 and by ``groups``, C
    dividing the CTA's 512 threads, at most 8 conv pixels per thread, and the
    working set within the 227 KB of shared memory.  7×7×64 (CIFAR-10) and
    6×6×64 (MNIST) pass."""
    hh, ww = hw
    if hh < 1 or ww < 1 or c < 4 or c % 4 or THREADS % c or c % groups:
        return False
    return (math.ceil(hh * ww / (THREADS // c)) <= MAX_PIX
            and smem_bytes(hw, c, groups) <= MAX_SMEM)


def odefunc_plain(w: OdefuncWeights, t, h: torch.Tensor,
                  groups: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same function, with the
    same split ConcatConv (conv + b + t·M)."""
    t = torch.as_tensor(t, dtype=h.dtype, device=h.device).reshape(-1, 1, 1, 1)
    out = torch.relu(group_norm({"scale": w.n1s, "bias": w.n1b}, h,
                                groups=groups))
    out = conv2d({"kernel": w.w1, "bias": w.b1}, out, padding=1) + t * w.m1
    out = torch.relu(group_norm({"scale": w.n2s, "bias": w.n2b}, out,
                                groups=groups))
    out = conv2d({"kernel": w.w2, "bias": w.b2}, out, padding=1) + t * w.m2
    return group_norm({"scale": w.n3s, "bias": w.n3b}, out, groups=groups)


def ptr(x: torch.Tensor) -> ctypes.c_void_p:
    """A tensor's device address, for a C entry point."""
    return ctypes.c_void_p(x.data_ptr())


def check_cuda_inputs(w: OdefuncWeights, states: dict, hw, c: int,
                      groups: int) -> None:
    """Validate what a kernel launch receives (``states``: name → tensor of
    the per-sample data); raise on anything the kernel does not take — there
    is no fallback on the card."""
    if not supported(hw, c, groups):
        raise ValueError(
            f"the CUDA ODEfunc kernels do not take H×W×C = {hw[0]}×{hw[1]}×{c}"
            f" with groups={groups} (see kernels.odefunc.supported)")
    dev = next(iter(states.values())).device
    if dev.type != "cuda":
        raise ValueError(f"expected CUDA tensors, got {dev}")
    shapes = {"w1": (3, 3, c, c), "w2": (3, 3, c, c),
              "m1": (hw[0], hw[1], c), "m2": (hw[0], hw[1], c)}
    for name, x in [*w._asdict().items(), *states.items()]:
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 on {dev}, got "
                             f"{x.dtype} on {x.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: expected a contiguous, 16-byte "
                             "aligned tensor")
        want = shapes.get(name, (c,)) if name in w._fields else None
        if want is not None and tuple(x.shape) != want:
            raise ValueError(f"{name}: expected shape {want}, got "
                             f"{tuple(x.shape)}")


def weight_pointers(w: OdefuncWeights) -> list[ctypes.c_void_p]:
    return [ptr(x) for x in w]


def stream() -> ctypes.c_void_p:
    """PyTorch's current CUDA stream, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _lib() -> ctypes.CDLL:
    lib = _build.load("odefunc")
    fn = lib.odefunc_forward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def odefunc(params, t, h: torch.Tensor, *, groups: int = 32) -> torch.Tensor:
    """f(t, h) for ``h`` (B, H, W, C) float32 NHWC and ``t`` scalar or (B,).
    ``params``: an ODEfunc param dict or :class:`OdefuncWeights`."""
    b, hh, ww, c = h.shape
    w = prepare(params, (hh, ww))
    if h.device.type == "cpu":
        return odefunc_plain(w, t, h, groups)
    check_cuda_inputs(w, {"h": h}, (hh, ww), c, groups)
    t = torch.as_tensor(t, dtype=torch.float32, device=h.device)
    t = t.reshape(-1).expand(b).contiguous()
    out = torch.empty_like(h)
    lib = _lib()
    code = lib.odefunc_forward(
        ptr(t), ptr(h), *weight_pointers(w), ptr(out),
        b, hh, ww, c, groups, stream())
    _build.check(lib, code, "odefunc_forward")
    odefunc.launches += 1
    return out


odefunc.launches = 0
