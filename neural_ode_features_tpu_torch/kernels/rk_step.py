"""Fused dopri5 step kernel: one whole step attempt per launch, one CTA per
sample.

Replaces the TPU kernels ``neural_ode_features_tpu/kernels/rk_step_pallas.py``
``_make_rows_step.fused_step`` → ``_rk_step_kernel_rows`` (``conv_strategy=
'rollS'``, the default) and ``make_fused_dopri5_step.fused_step`` →
``_rk_step_kernel`` (``'im2col'``, ``'tree9'``, ``'fori9'``).  Those
strategies were TPU layout workarounds for one function; on the card every
``conv_strategy`` value runs the same kernel, ``csrc/rk_step.cu``.

Per sample the kernel computes the six FSAL evaluations of f, the stage
sums, y1 (5th order), the embedded error, ``y_mid`` (the c_mid midpoint of
the quartic dense output) and the mixed-tolerance RMS error ratio.  One CTA
owns one sample, so the grid is exactly B (a ragged batch needs no tile
divisor) and no reduction crosses blocks.  The tolerances are per sample
too: ``rtol`` and ``atol`` reach the kernel as ``(B,)`` arrays, each CTA
reading its own entry once (a float is broadcast by the wrapper and gives
the bits a scalar argument gave), so rows of one launch may carry different
tolerances: a tolerance grid stacked on the batch axis is one launch per
attempt.

Bound (H100 SXM, 700 W power limit; 67 TFLOP/s f32 outside the tensor
cores, 495 TFLOP/s TF32 on them, 3.35 TB/s): 6 evaluations × 2 convs ×
2·49·576·64 FLOP per sample is 11.1 GFLOP per attempt at B = 256, 7×7×64:
about 166 µs of FFMA, 22 µs of TF32 products, against about 5 µs for its
16 MB of state in and out.  So it is bound by operations.  The design keeps
each evaluation's working set in shared memory (one CTA per sample), streams
the f32 conv weights tap by tap through shared memory, and keeps the stage
derivatives k2..k6 in an L2-resident scratch tensor read back by the thread
that wrote them.  Its twelve convs run on the conv stage of
``kernels.odefunc.stage``: at C = 64 to 512 (multiples of 32) on 7×7 and
6×6 maps on the tensor cores (``wgmma.mma_async`` TF32, ``'wgmma3'``, at
the widths of ``kernels.odefunc.WGMMA_C``, 64 among them; ``mma.sync`` TF32
at the others) with 3×TF32 error compensation, which is f32-grade (an
error near 2⁻²¹ per product), so that the accept/reject decisions follow
the f32 plain version's; at other shapes as f32 FFMA.

``conv_precision='bf16'`` (the TPU kernel's ``mxu_dtype=bfloat16``, its
default on TPU hardware; here an opt-in, never a default) runs a second
build (the operator ``nodef::dopri5_step_bf16``): the twelve convs on the
bf16 conv stage, both operands rounded to bf16 and the products summed in
f32 (``kernels.odefunc.stage(hw, c, 'bf16_conv')``: ``'wgmma_bf16'``,
``wgmma.mma_async`` bf16, at the widths of ``WGMMA_C``, the bf16
``odefunc``'s stage and bits; ``mma.sync.m16n8k16`` bf16 at the other
tensor-core shapes; f32 FFMA on rounded operands at the FFMA shapes),
GroupNorm, bias, time map, stage sums and error ratio in f32.
Bound at B = 256, 7×7×64: 11.1 GFLOP at 989 TFLOP/s dense bf16, about
11 µs.

``make_fused_dopri5_step`` builds the ``fused_step`` hook of
``solver.runge_kutta.adaptive_odeint``.  ``dopri5_step`` is the wrapper,
one call of the operator ``nodef::dopri5_step`` (``kernels/ops.py``): a CPU
tensor takes the plain PyTorch version ``dopri5_step_plain``; a CUDA tensor
launches the kernel (:func:`launch`) or raises.  ``dopri5_step.launches``
counts the f32 build's launches, ``dopri5_step.launches_bf16`` the bf16
build's.  The plain version runs the solver's own attempt
(``rk_attempt.py``) with ``tableau.DOPRI5``, two modules that import no
solver module: the operators load an exported program with the kernels
alone.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..rk_attempt import _rk_attempt, _rms, _tol_column
from ..tableau import DOPRI5
from . import _build
from .odefunc import (
    OdefuncWeights,
    check_cuda_inputs,
    odefunc_plain,
    prepare,
    ptr,
    stream,
    weight_pointers,
)

__all__ = ["make_fused_dopri5_step", "dopri5_step", "dopri5_step_plain",
           "launch", "fold", "CONV_STRATEGIES", "CONV_PRECISIONS"]

# The JAX package's conv strategies; all run the one CUDA kernel.
CONV_STRATEGIES = ("rollS", "roll9", "im2col", "tree9", "fori9")
# conv_precision: None and 'f32' are the f32 build, 'bf16' the bf16 one.
CONV_PRECISIONS = (None, "f32", "bf16")
# The C entry point of each build (csrc/rk_step.cu).
_ENTRY = {"f32": "rk_step_forward", "bf16": "rk_step_forward_bf16"}
_STAGES = 7


def _check_tableau(tableau) -> None:
    """Raise unless ``tableau`` is ``tableau.DOPRI5``, the only one the
    kernel and its operator compute with."""
    if tableau is not DOPRI5:
        raise ValueError("the fused step takes the dopri5 tableau "
                         "(tableau.DOPRI5)")


def _check_conv_precision(conv_precision) -> None:
    if conv_precision not in CONV_PRECISIONS:
        raise ValueError(f"conv_precision must be one of {CONV_PRECISIONS},"
                         f" got {conv_precision!r}")


def dopri5_step_plain(w: OdefuncWeights, tableau, t0, dt,
                      y0: torch.Tensor, f0: torch.Tensor, *, hw, groups: int,
                      rtol, atol, conv_precision: str | None = None):
    """Plain PyTorch version of the kernel: the solver's RK attempt with the
    plain ODEfunc, then the RMS ratio without a zero-scale guard (atol > 0).
    ``rtol``, ``atol``: floats or ``(B,)`` tensors, as the kernel's.
    ``conv_precision='bf16'``: each conv's operands rounded to bf16
    (``odefunc_plain(precision='bf16_conv')``), the rest as f32."""
    _check_conv_precision(conv_precision)
    b, n = y0.shape
    rtol = _tol_column(rtol, b, y0.dtype, y0.device)
    atol = _tol_column(atol, b, y0.dtype, y0.device)
    c = n // (hw[0] * hw[1])
    precision = "bf16_conv" if conv_precision == "bf16" else "f32"

    def func(t, y):
        return odefunc_plain(w, t, y.reshape(b, hw[0], hw[1], c),
                             groups, precision).reshape(b, n)

    y1, err, f1, _, y_mid = _rk_attempt(tableau, func, t0, dt, y0, f0)
    scale = atol + rtol * torch.maximum(y0.abs(), y1.abs())
    return y1, f1, y_mid, _rms(err / scale)


@functools.cache
def _coefficients() -> ctypes.Array:
    """dopri5's coefficients as the C entry point's host array (copied into
    the kernel's by-value ``Tableau`` argument at each launch)."""
    t = DOPRI5
    vals = np.concatenate([t.a.reshape(-1), t.b, t.b_err, t.c, t.c_mid])
    return (ctypes.c_float * vals.size)(*vals.astype(np.float32).tolist())


def _lib() -> ctypes.CDLL:
    lib = _build.load("rk_step")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * 24 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


def tolerance_rows(tol, like: torch.Tensor) -> torch.Tensor:
    """A float or ``(B,)`` tolerance as the kernel reads it: a contiguous
    ``(B,)`` tensor of ``like``'s dtype on its device (``like``: (B, N))."""
    col = _tol_column(tol, like.shape[0], like.dtype, like.device)
    if isinstance(col, float):
        return torch.full((like.shape[0],), col, dtype=like.dtype,
                          device=like.device)
    return col[:, 0].contiguous()


def launch(w: OdefuncWeights, t0, dt, y0: torch.Tensor, f0: torch.Tensor,
           rtol: torch.Tensor, atol: torch.Tensor, hw, groups: int,
           precision: str = "f32", ks: torch.Tensor | None = None):
    """One launch of the kernel on CUDA tensors (the CUDA side of the
    operators ``nodef::dopri5_step`` and, ``precision='bf16'`` (bf16
    convs), ``nodef::dopri5_step_bf16``, ``kernels/ops.py``): dopri5,
    ``rtol`` and ``atol`` as ``(B,)`` rows.  ``ks``: the scratch that
    takes the stage derivatives k2..k6, (5, B, H·W·C) float32, made here
    if None (a caller that passes one reads the stages back).  Checks what
    the kernel takes and raises on anything else; counts the launch in
    ``dopri5_step.launches`` (the f32 build) or
    ``dopri5_step.launches_bf16``."""
    b, n, c = fold(t0, dt, y0, f0, hw)
    hh, ww = hw
    if ks is None:
        ks = torch.empty((_STAGES - 2, b, n), dtype=y0.dtype,
                         device=y0.device)
    elif tuple(ks.shape) != (_STAGES - 2, b, n):
        raise ValueError(f"ks: expected shape {(_STAGES - 2, b, n)}, got "
                         f"{tuple(ks.shape)}")
    check_cuda_inputs(w, {"t0": t0, "dt": dt, "y0": y0, "f0": f0,
                          "rtol": rtol, "atol": atol, "ks": ks}, hw, c,
                      groups)
    y1, f1, y_mid = (torch.empty_like(y0) for _ in range(3))
    ratio = torch.empty((b,), dtype=y0.dtype, device=y0.device)
    # The tableau stays a host array: the C entry point copies it into the
    # kernel's by-value ``Tableau`` argument (csrc/rk_step.cu), so a CUDA
    # graph captures it with the launch and a replay reads no host memory.
    lib = _lib()
    entry = _ENTRY[precision]
    code = getattr(lib, entry)(
        ptr(t0), ptr(dt), ptr(y0), ptr(f0), *weight_pointers(w),
        ctypes.cast(_coefficients(), ctypes.c_void_p), ptr(rtol), ptr(atol),
        ptr(ks), ptr(y1), ptr(f1), ptr(y_mid), ptr(ratio),
        b, hh, ww, c, groups, stream())
    _build.check(lib, code, entry)
    if precision == "bf16":
        dopri5_step.launches_bf16 += 1
    else:
        dopri5_step.launches += 1
    return y1, f1, y_mid, ratio


def fold(t0, dt, y0: torch.Tensor, f0: torch.Tensor, hw) -> tuple:
    """``(B, N, C)`` of a step's states ``y0``, ``f0`` (B, H·W·C) at ``t0``,
    ``dt`` (B,); raises where they do not fold to (B, H, W, C).  The shape
    gate of the kernel's launch and of the operator's fake version."""
    b, n = y0.shape
    c = n // (hw[0] * hw[1])
    if c * hw[0] * hw[1] != n or tuple(f0.shape) != (b, n):
        raise ValueError(f"states {tuple(y0.shape)}, {tuple(f0.shape)} do "
                         f"not fold to (B, {hw[0]}, {hw[1]}, C)")
    if tuple(t0.shape) != (b,) or tuple(dt.shape) != (b,):
        raise ValueError("t0 and dt must have shape (B,)")
    return b, n, c


def _operator(conv_precision):
    _check_conv_precision(conv_precision)
    return (torch.ops.nodef.dopri5_step_bf16 if conv_precision == "bf16"
            else torch.ops.nodef.dopri5_step)


def dopri5_step(w: OdefuncWeights, tableau, t0, dt,
                y0: torch.Tensor, f0: torch.Tensor, *, hw, groups: int,
                rtol, atol, conv_precision: str | None = None):
    """One dopri5 attempt for flat NHWC states ``y0``, ``f0`` (B, H·W·C) at
    per-sample ``t0``, ``dt`` (B,).  ``tableau``: ``tableau.DOPRI5``.
    ``rtol``, ``atol``: floats or ``(B,)`` tensors, one tolerance per row.
    Returns ``(y1, f1, y_mid, ratio)``: one call of the operator
    ``nodef::dopri5_step`` (``conv_precision='bf16'``:
    ``nodef::dopri5_step_bf16``), the kernel on a CUDA tensor and
    :func:`dopri5_step_plain` on a CPU tensor."""
    _check_tableau(tableau)
    return _operator(conv_precision)(
        t0, dt, y0, f0, list(w), tolerance_rows(rtol, y0),
        tolerance_rows(atol, y0), hw[0], hw[1], groups)


dopri5_step.launches = dopri5_step.launches_bf16 = 0


def make_fused_dopri5_step(
    params, tableau, hw: tuple[int, int], *,
    groups: int = 32,
    rtol,
    atol,
    conv_strategy: str = "rollS",
    conv_precision: str | None = None,
):
    """Build the ``fused_step`` callable for ``adaptive_odeint``:
    ``fused_step(t0 (B,), dt (B,), y0 (B,N), f0 (B,N)) -> (y1, f1, y_mid,
    ratio)``, with the JAX signature and return contract.

    ``params``: the ODEfunc param dict (conv kernels (3, 3, C+1, C)) on the
    solve's device.  ``rtol``, ``atol``: floats, or ``(B,)`` tensors with
    one tolerance per row of the states the step will see; ``atol > 0`` is
    required of every row.  ``conv_strategy``: any JAX value; all run one
    kernel.
    ``conv_precision``: None or ``'f32'``: f32-grade, on the tensor cores
    with 3×TF32 error compensation where the shape allows, else f32 FFMA;
    ``'bf16'``: the bf16 build (bf16 conv operands, f32 accumulation), as
    the JAX ``conv_precision='bf16'``.  None is f32 on every device: unlike
    the JAX ``make_fused_dopri5_step``'s ``None`` on TPU hardware, bf16 is
    never a default."""
    positive = (bool((atol > 0.0).all()) if isinstance(atol, torch.Tensor)
                else atol > 0.0)
    if not positive:
        raise ValueError("fused RK step requires atol > 0 (the error norm "
                         "has no 0/0 guard)")
    if conv_strategy not in CONV_STRATEGIES:
        raise ValueError(f"unknown conv strategy {conv_strategy!r}")
    op = _operator(conv_precision)
    _check_tableau(tableau)
    w = list(prepare(params, hw))
    # The tolerances as (B,) tensors, made at the first attempt: that one
    # runs eagerly on every route, so a captured attempt (the CUDA graph of
    # solver/attempt_graph.py) finds them made.  Under tracing (the
    # while_loop body of torch.export) the body may change nothing outside
    # itself, so they are made in the traced attempt.  The step calls the
    # operator itself: the wrapper's checks and conversions are done here
    # once.
    rows = []

    def fused_step(t0, dt, y0, f0):
        if torch.compiler.is_compiling():
            tols = (tolerance_rows(rtol, y0), tolerance_rows(atol, y0))
        else:
            if not rows:
                rows.extend((tolerance_rows(rtol, y0),
                             tolerance_rows(atol, y0)))
            tols = rows
        return op(t0, dt, y0, f0, w, *tols, hw[0], hw[1], groups)

    return fused_step
