"""Fused ODEfunc backward kernel: the VJP of f(t, h), giving (dθ, dt, dh).

Replaces the TPU kernel ``neural_ode_features_tpu/kernels/odefunc_bwd_rows.py``
(``odefunc_bwd_rows`` → ``_bwd_rows_kernel``).  Source:
``csrc/odefunc_bwd.cu`` (with the per-sample forward helpers of
``csrc/odefunc_common.cuh``).

The kernel recomputes the forward from ``(params, t, h)``, as the TPU kernel
does, so the residuals of the VJP are only those three; it also writes the
recomputed f(t, h) (``with_f=True``), so that an augmented evaluation of the
adjoint is this one call and no launch of the ODEfunc kernel.  The TPU kernel
summed the parameter gradients over the batch by read-modify-write into
revisited output blocks, race-free only because a TPU grid runs in order.
Here a per-sample pass (one CTA per sample) writes dh, dt and per-sample
partial sums, and two more launches reduce over the batch in a fixed order:
no atomics, and two calls on the same inputs give bit-identical dθ.

Bound (H100 SXM, 700 W power limit; 67 TFLOP/s f32 outside the tensor
cores, 495 TFLOP/s TF32 on them, 3.35 TB/s): six 3×3-conv equivalents
(forward recompute, input gradients, weight gradients), 21.7 MFLOP per
sample at 7×7×64, 2.77 GFLOP at B = 128: about 41 µs of FFMA, 5.6 µs of TF32
products; the bytes are about 6.4 MB, 1.9 µs.  So it is bound by operations.
The per-sample pass runs its four convs (two of the forward, two input
gradients) on the conv stage of ``kernels.odefunc.stage``: at C = 64 to 512
(multiples of 32) on 7×7 and 6×6 maps ``mma.sync`` TF32 with 3×TF32 error
compensation, f32-grade; the input-gradient convs read ``w1``, ``w2``
themselves, taps reversed and transposed in the fragment loads.  The conv1
output u stays in shared memory where it fits; from 7×7×256 it goes to a
global scratch beside r1 and r2 (:func:`u_global`), and from 7×7×288 the
state x to the dh output (``kernels.odefunc.layout``).  The weight-gradient
contraction is f32 FFMA in 64×64 tiles, 32×32 where C % 64 == 32
(ROADMAP.md, Queue 2); its scratch is (8, 2, 9, C, C), 151 MB at C = 512.

``precision='bf16'`` runs the kernel's bf16 build (``odefunc_backward_bf16``):
the VJP of the ``compute_dtype='bfloat16'`` dynamics (the ODEfunc kernel's
bf16 build, ``odefunc_plain(..., 'bf16')``), whose JAX counterpart is
``jax.vjp`` of the jnp bf16 dynamics (the TPU kernel computes in f32 only).
It recomputes the forward as that build does (its f is the bf16 forward's
bit for bit) and rounds where autograd through the plain bf16 f rounds: the
cotangent on entry; in each GroupNorm the per-element ``dy·scale`` and
``dy·bf16(x̂)``, its f32 statistics backward, dx on leaving; each
input-gradient conv's sum (bf16 operands on the tensor cores,
``mma.sync.m16n8k16`` with f32 accumulation, the taps reversed and
transposed in the fragment loads; f32 FFMA on rounded weights at the FFMA
shapes); the time-map products.  Each sum over the batch (weight, scale and
bias gradients) is kept in f32 per sample, reduced in the fixed order and
rounded once, as the plain path rounds it once; the time column, which the
plain path sums in f32 from per-pixel bf16 values, is not rounded.  f, dh,
dt and every leaf but the time column hold bf16 values.  Bound at B = 128,
7×7×64: 2.77 GFLOP at 989 TFLOP/s dense bf16, 2.8 µs, against 1.9 µs of
bytes: bound by operations (0.0414 ms on the CUDA cores in f32).

``odefunc_bwd`` is the wrapper: a CPU tensor takes the plain PyTorch version
``odefunc_bwd_plain`` (``torch.autograd.grad`` of ``odefunc_plain`` at the
same precision); a CUDA tensor launches the kernel or raises.
``odefunc_bwd.launches`` counts the f32 build's launches,
``odefunc_bwd.launches_bf16`` the bf16 build's.  Both return the parameter
gradients in the raw ODEfunc layout (conv kernels (3, 3, C+1, C), time
channel first): the time column is the tap-validity contraction of the time
map's cotangent (:func:`tap_contract`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .odefunc import (
    MAX_SMEM,
    OdefuncWeights,
    check_cuda_inputs,
    layout,
    odefunc_plain,
    prepare,
    ptr,
    refusal,
    stage,
    stream,
    weight_pointers,
)

__all__ = ["odefunc_bwd", "odefunc_bwd_plain", "bwd_supported",
           "bwd_refusal", "bwd_smem_bytes", "u_global", "tap_contract"]

# Mirror csrc/odefunc_bwd.cu (kParts, kSplit, weight_tile).
_PARTS = 26
_SPLIT = 8


def _weight_tile(c: int) -> int:
    return 64 if c % 64 == 0 else 32


def u_global(hw: tuple[int, int], c: int, groups: int) -> bool:
    """Whether the per-sample pass keeps the conv1 output u (H·W·C floats)
    in global scratch in place of shared memory (csrc/odefunc_bwd.cu
    ``bwd_shape``): on the wide tensor-core stage where u does not fit
    beside the forward's working set, on 7×7 maps from C = 256."""
    return layout(hw, c, groups, backward=True).u_global


def bwd_smem_bytes(hw: tuple[int, int], c: int, groups: int) -> int:
    """Dynamic shared memory per CTA of the per-sample pass
    (csrc/odefunc_bwd.cu ``bwd_smem_bytes``): the forward's, 6·G
    statistics, 4·C channel sums and, unless :func:`u_global`, u."""
    return layout(hw, c, groups, backward=True).smem


def bwd_refusal(hw: tuple[int, int], c: int, groups: int) -> str | None:
    """Why the backward kernel does not take this shape, or None: the
    forward kernels' gate under the backward's layout (``layout(...,
    backward=True)``), C at least 32 and a multiple of the weight-gradient
    tile (64, or 32 where C % 64 == 32).  On 7×7 and 6×6 maps with groups
    32 every multiple of 32 up to 512 passes."""
    why = refusal(hw, c, groups)
    if why is not None:
        return why
    if c < 32 or c % _weight_tile(c):
        return "C >= 32, a multiple of 32"
    if bwd_smem_bytes(hw, c, groups) > MAX_SMEM:
        return (f"the per-sample working set ({bwd_smem_bytes(hw, c, groups)}"
                f" B) exceeds the {MAX_SMEM} B of shared memory")
    return None


def bwd_supported(hw: tuple[int, int], c: int, groups: int) -> bool:
    """The backward kernel's shape gate: :func:`bwd_refusal` finds
    nothing."""
    return bwd_refusal(hw, c, groups) is None


def tap_contract(dm: torch.Tensor, kh: int = 3, kw: int = 3,
                 padding: int = 1) -> torch.Tensor:
    """Adjoint of ``ops.layers.time_map``: the time-column kernel gradient
    (kh, kw, 1, C) from the time map's cotangent ``dm`` (H, W, C).  Tap
    (ky, kx) sums ``dm`` over the pixels where it reads inside the map
    (``mask9ᵀ · dm``), in elementwise f32."""
    hh, ww, c = dm.shape
    ones = F.pad(torch.ones((hh, ww), dtype=dm.dtype, device=dm.device),
                 (padding, padding, padding, padding))
    taps = [(ones[ky:ky + hh, kx:kx + ww, None] * dm).sum(dim=(0, 1))
            for ky in range(kh) for kx in range(kw)]
    return torch.stack(taps).reshape(kh, kw, 1, c)


def _raw_grads(d: OdefuncWeights) -> dict:
    """Gradients of the kernel layout (:class:`OdefuncWeights`) in the raw
    ODEfunc layout: each conv kernel's time column from its map's cotangent."""

    def conv(dw, db, dm):
        return {"kernel": torch.cat([tap_contract(dm), dw], dim=2),
                "bias": db}

    return {
        "norm1": {"scale": d.n1s, "bias": d.n1b},
        "conv1": conv(d.w1, d.b1, d.m1),
        "norm2": {"scale": d.n2s, "bias": d.n2b},
        "conv2": conv(d.w2, d.b2, d.m2),
        "norm3": {"scale": d.n3s, "bias": d.n3b},
    }


def odefunc_bwd_plain(w: OdefuncWeights, t, h: torch.Tensor, g: torch.Tensor,
                      groups: int, with_f: bool = False,
                      precision: str = "f32"):
    """Plain PyTorch version of the kernel: ``torch.autograd.grad`` of
    ``odefunc_plain`` at ``(w, t, h)`` and ``precision`` ('f32' or 'bf16')
    against the cotangent ``g``.  Returns ``(dparams raw, dt (B,), dh)``,
    and f(t, h) as a fourth value where ``with_f``; ``dt`` is per sample
    even for a scalar ``t``, as the kernel's."""
    if precision not in _ENTRY:
        raise ValueError(f"precision must be one of {tuple(_ENTRY)}, got "
                         f"{precision!r}")
    b = h.shape[0]
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in w]
        tb = (torch.as_tensor(t, dtype=h.dtype, device=h.device).detach()
              .reshape(-1).expand(b).clone().requires_grad_())
        hh = h.detach().requires_grad_()
        out = odefunc_plain(OdefuncWeights(*leaves), tb, hh, groups,
                            precision)
        grads = torch.autograd.grad(out, [*leaves, tb, hh], g)
    res = (_raw_grads(OdefuncWeights(*grads[:-2])), grads[-2], grads[-1])
    return (*res, out.detach()) if with_f else res


# The C entry point of each build of the kernel (csrc/odefunc_bwd.cu).
_ENTRY = {"f32": "odefunc_backward", "bf16": "odefunc_backward_bf16"}


def _lib() -> ctypes.CDLL:
    lib = _build.load("odefunc_bwd")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * 30 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


def odefunc_bwd(params, t, h: torch.Tensor, g: torch.Tensor, *,
                groups: int = 32, with_f: bool = False,
                precision: str = "f32"):
    """VJP of f at ``(params, t, h)`` against ``g`` (B, H, W, C):
    ``(dparams, dt (B,), dh)`` with ``dparams`` in the raw ODEfunc layout,
    and the recomputed f(t, h) as a fourth value where ``with_f``.
    ``params``: an ODEfunc param dict or :class:`OdefuncWeights`; ``t``
    scalar or (B,).  ``precision``: 'f32', or 'bf16' for the VJP of the
    bf16 dynamics (the kernel's bf16 build on the card)."""
    b, hh, ww, c = h.shape
    w = prepare(params, (hh, ww))
    if h.device.type == "cpu":
        return odefunc_bwd_plain(w, t, h, g, groups, with_f, precision)
    if precision not in _ENTRY:
        raise ValueError(f"precision must be one of {tuple(_ENTRY)}, got "
                         f"{precision!r}")
    if tuple(g.shape) != tuple(h.shape):
        raise ValueError(f"cotangent {tuple(g.shape)} does not match the "
                         f"state {tuple(h.shape)}")
    why = bwd_refusal((hh, ww), c, groups)
    if why is not None:
        raise ValueError(
            f"the CUDA ODEfunc backward kernel does not take H×W×C = "
            f"{hh}×{ww}×{c} with groups={groups}: {why} "
            "(kernels.odefunc_bwd.bwd_refusal)")
    check_cuda_inputs(w, {"h": h, "g": g}, (hh, ww), c, groups)
    dev = h.device
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    t = t.reshape(-1).expand(b).contiguous()
    # The conv input gradient is a 3×3 conv of the cotangent with each tap's
    # (C, C) slice transposed and the taps in reverse order.  The
    # tensor-core stage reads w1, w2 that way itself; the FFMA stage takes
    # the rearranged copies.
    wbt = [] if stage((hh, ww), c) == "mma3" else [
        x.reshape(9, c, c).flip(0).transpose(1, 2).contiguous()
        for x in (w.w1, w.w2)]
    wbt_ptrs = [ptr(x) for x in wbt] or [None, None]
    n = hh * ww * c
    f = torch.empty_like(h)
    dh = torch.empty_like(h)
    # One allocation for the small outputs (dk, dvec, dt) and one for the
    # scratch (r1, r2, gu, gv, part, wpart and, where it does not fit in
    # shared memory, u): a step of the adjoint makes dozens of these calls,
    # and the host launches them.  Every piece is a multiple of four floats
    # long (C is), so each stays 16-byte aligned.
    nk = 9 * (c + 1) * c
    outs = torch.empty((2 * nk + 8 * c + b,), dtype=torch.float32, device=dev)
    dk = outs[:2 * nk].view(2, 3, 3, c + 1, c)
    dvec = outs[2 * nk:2 * nk + 8 * c].view(8, c)
    dt = outs[2 * nk + 8 * c:]
    sizes = [b * n] * 4 + [b * _PARTS * c, _SPLIT * 2 * 9 * c * c,
                           b * n if u_global((hh, ww), c, groups) else 0]
    scratch = torch.empty((sum(sizes),), dtype=torch.float32, device=dev)
    offsets = [4 * sum(sizes[:i]) for i in range(len(sizes))]
    at = lambda base, nbytes: ctypes.c_void_p(base.data_ptr() + nbytes)
    lib = _lib()
    entry = _ENTRY[precision]
    code = getattr(lib, entry)(
        ptr(t), ptr(h), ptr(g), *weight_pointers(w), *wbt_ptrs,
        ptr(f), ptr(dh), at(outs, 4 * (2 * nk + 8 * c)),
        *(at(scratch, o) for o in offsets),
        at(outs, 0), at(outs, 4 * nk), at(outs, 8 * nk),
        b, hh, ww, c, groups, stream())
    _build.check(lib, code, entry)
    if precision == "bf16":
        odefunc_bwd.launches_bf16 += 1
    else:
        odefunc_bwd.launches += 1
    dparams = {
        "norm1": {"scale": dvec[0], "bias": dvec[1]},
        "conv1": {"kernel": dk[0], "bias": dvec[6]},
        "norm2": {"scale": dvec[2], "bias": dvec[3]},
        "conv2": {"kernel": dk[1], "bias": dvec[7]},
        "norm3": {"scale": dvec[4], "bias": dvec[5]},
    }
    return (dparams, dt, dh, f) if with_f else (dparams, dt, dh)


odefunc_bwd.launches = odefunc_bwd.launches_bf16 = 0
