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
divisor) and no reduction crosses blocks.

Bound (H100 SXM, 700 W power limit; 67 TFLOP/s f32 outside the tensor
cores, 3.35 TB/s): 6 evaluations × 2 convs × 2·49·576·64 FLOP per sample is
11.1 GFLOP per attempt at B = 256, 7×7×64, about 166 µs of FFMA, against
about 5 µs for its 16 MB of state in and out.  So it is bound by operations.
The design keeps each evaluation's working set in shared memory (one CTA per
sample), streams conv weights tap by tap through shared memory, keeps the
stage derivatives k2..k6 in an L2-resident scratch tensor read back by the
thread that wrote them, and computes in strict f32 FFMA so that the
accept/reject decisions follow the plain version's.  Tensor cores (TF32 or
bf16 ``wgmma``) are later work (ROADMAP.md).

``make_fused_dopri5_step`` builds the ``fused_step`` hook of
``solver.runge_kutta.adaptive_odeint``.  ``dopri5_step`` is the wrapper: a
CPU tensor takes the plain PyTorch version ``dopri5_step_plain``; a CUDA
tensor launches the kernel or raises.  ``dopri5_step.launches`` counts
launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..solver.runge_kutta import _rk_attempt, _rms
from ..solver.tableau import ButcherTableau
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
           "CONV_STRATEGIES"]

# The JAX package's conv strategies; all run the one CUDA kernel.
CONV_STRATEGIES = ("rollS", "roll9", "im2col", "tree9", "fori9")
_STAGES = 7


def dopri5_step_plain(w: OdefuncWeights, tableau: ButcherTableau, t0, dt,
                      y0: torch.Tensor, f0: torch.Tensor, *, hw, groups: int,
                      rtol: float, atol: float):
    """Plain PyTorch version of the kernel: ``_rk_attempt`` with the plain
    ODEfunc, then the RMS ratio without a zero-scale guard (atol > 0)."""
    b, n = y0.shape
    c = n // (hw[0] * hw[1])

    def func(t, y):
        return odefunc_plain(w, t, y.reshape(b, hw[0], hw[1], c),
                             groups).reshape(b, n)

    y1, err, f1, _, y_mid = _rk_attempt(tableau, func, t0, dt, y0, f0)
    scale = atol + rtol * torch.maximum(y0.abs(), y1.abs())
    return y1, f1, y_mid, _rms(err / scale)


def _coefficients(tableau: ButcherTableau) -> ctypes.Array:
    vals = np.concatenate([np.asarray(tableau.a).reshape(-1), tableau.b,
                           tableau.b_err, tableau.c, tableau.c_mid])
    return (ctypes.c_float * vals.size)(*vals.astype(np.float32).tolist())


def _lib() -> ctypes.CDLL:
    lib = _build.load("rk_step")
    fn = lib.rk_step_forward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_float] * 2
                       + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def dopri5_step(w: OdefuncWeights, tableau: ButcherTableau, t0, dt,
                y0: torch.Tensor, f0: torch.Tensor, *, hw, groups: int,
                rtol: float, atol: float):
    """One dopri5 attempt for flat NHWC states ``y0``, ``f0`` (B, H·W·C) at
    per-sample ``t0``, ``dt`` (B,).  Returns ``(y1, f1, y_mid, ratio)``."""
    if y0.device.type == "cpu":
        return dopri5_step_plain(w, tableau, t0, dt, y0, f0, hw=hw,
                                 groups=groups, rtol=rtol, atol=atol)
    b, n = y0.shape
    hh, ww = hw
    c = n // (hh * ww)
    if c * hh * ww != n or tuple(f0.shape) != (b, n):
        raise ValueError(f"states {tuple(y0.shape)}, {tuple(f0.shape)} do "
                         f"not fold to (B, {hh}, {ww}, C)")
    if tuple(t0.shape) != (b,) or tuple(dt.shape) != (b,):
        raise ValueError("t0 and dt must have shape (B,)")
    check_cuda_inputs(w, {"t0": t0, "dt": dt, "y0": y0, "f0": f0}, hw, c,
                      groups)
    ks = torch.empty((_STAGES - 2, b, n), dtype=y0.dtype, device=y0.device)
    y1, f1, y_mid = (torch.empty_like(y0) for _ in range(3))
    ratio = torch.empty((b,), dtype=y0.dtype, device=y0.device)
    coeffs = _coefficients(tableau)  # host array, read by the C entry point
    lib = _lib()
    code = lib.rk_step_forward(
        ptr(t0), ptr(dt), ptr(y0), ptr(f0), *weight_pointers(w),
        ctypes.cast(coeffs, ctypes.c_void_p), float(rtol), float(atol),
        ptr(ks), ptr(y1), ptr(f1), ptr(y_mid), ptr(ratio),
        b, hh, ww, c, groups, stream())
    _build.check(lib, code, "rk_step_forward")
    dopri5_step.launches += 1
    return y1, f1, y_mid, ratio


dopri5_step.launches = 0


def make_fused_dopri5_step(
    params, tableau: ButcherTableau, hw: tuple[int, int], *,
    groups: int = 32,
    rtol: float,
    atol: float,
    conv_strategy: str = "rollS",
    conv_precision: str | None = None,
):
    """Build the ``fused_step`` callable for ``adaptive_odeint``:
    ``fused_step(t0 (B,), dt (B,), y0 (B,N), f0 (B,N)) -> (y1, f1, y_mid,
    ratio)``, with the JAX signature and return contract.

    ``params``: the ODEfunc param dict (conv kernels (3, 3, C+1, C)) on the
    solve's device.  ``conv_strategy``: any JAX value; all run one kernel.
    ``conv_precision``: None or ``'f32'`` (the kernel's only precision;
    ``'bf16'`` tensor-core convs are later work)."""
    if atol <= 0.0:
        raise ValueError("fused RK step requires atol > 0 (the error norm "
                         "has no 0/0 guard)")
    if conv_strategy not in CONV_STRATEGIES:
        raise ValueError(f"unknown conv strategy {conv_strategy!r}")
    if conv_precision not in (None, "f32"):
        raise NotImplementedError(
            f"conv_precision={conv_precision!r}: the CUDA kernel computes in "
            "f32 only (ROADMAP.md: tensor-core convs)")
    if (tableau.c_mid is None or not tableau.fsal
            or tableau.stages != _STAGES):
        raise ValueError("the fused step takes a 7-stage FSAL tableau with "
                         "c_mid (dopri5)")
    w = prepare(params, hw)

    def fused_step(t0, dt, y0, f0):
        return dopri5_step(w, tableau, t0, dt, y0, f0, hw=hw, groups=groups,
                           rtol=rtol, atol=atol)

    return fused_step
