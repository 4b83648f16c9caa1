"""The kernels of the exported path as ``torch.library`` operators.

    torch.ops.nodef.odefunc(t, h, w, groups) -> f
    torch.ops.nodef.dopri5_step(t0, dt, y0, f0, w, rtol, atol, height,
                                width, groups) -> (y1, f1, y_mid, ratio)

and their bf16 builds under the same schemas, ``nodef::odefunc_bf16`` (the
``compute_dtype='bfloat16'`` dynamics) and ``nodef::dopri5_step_bf16``
(``conv_precision='bf16'``); the f32 schemas are those of the programs
``export_model export`` has written.

``w`` is the twelve tensors of ``kernels.odefunc.OdefuncWeights`` (the
ODEfunc weights laid out for the kernels), ``t`` and the tolerances ``(B,)``
rows.  Each operator has three implementations: CUDA, the kernel's launch
(``kernels.odefunc.launch``, ``kernels.rk_step.launch``), which checks its
inputs and raises on anything the kernel does not take, and counts the
launch; CPU, the plain PyTorch version (``odefunc_plain``,
``dopri5_step_plain``); and a fake one for tracing, which runs the launch's
gate from shapes alone (``kernels.odefunc.check_device``,
``kernels.rk_step.fold``) for a tensor off the CPU, so that an export for
the card refuses what its launch would refuse.  The wrappers check nothing
of their own: each call is checked once, where it runs.  The
dopri5 coefficients are a host constant inside the CUDA launch, as the C
entry point takes them by value.

The wrappers ``kernels.odefunc.odefunc`` and ``kernels.rk_step.dopri5_step``
call these operators, so eager solves and ``torch.export`` take the one
route; ``torch.export`` records the operators by name, and a program saved
by ``export_model export`` loads with this module imported and no model,
solver or training module.  They are registered through
``torch.library.Library`` ``define``/``impl``: a Python kernel behind the
dispatcher, with no per-call wrapping of its own.  No autograd formula is
registered: ``kernels.odefunc._OdefuncVJP`` is the autograd wrapper of the
ODEfunc kernel, and the fused step runs on inference paths only.
"""

from __future__ import annotations

import torch

from ..tableau import DOPRI5
from . import odefunc as _odefunc
from . import rk_step as _rk_step

__all__ = ["LIB"]

LIB = torch.library.Library("nodef", "DEF")
_ODEFUNC = "(Tensor t, Tensor h, Tensor[] w, int groups) -> Tensor"
_STEP = ("(Tensor t0, Tensor dt, Tensor y0, Tensor f0, Tensor[] w, "
         "Tensor rtol, Tensor atol, int height, int width, int groups) -> "
         "(Tensor, Tensor, Tensor, Tensor)")
for _suffix in ("", "_bf16"):
    LIB.define(f"odefunc{_suffix}{_ODEFUNC}")
    LIB.define(f"dopri5_step{_suffix}{_STEP}")


def _odefunc_cpu(precision):
    def impl(t, h, w, groups):
        return _odefunc.odefunc_plain(_odefunc.OdefuncWeights(*w), t, h,
                                      groups, precision)
    return impl


def _odefunc_cuda(precision):
    def impl(t, h, w, groups):
        return _odefunc.launch(_odefunc.OdefuncWeights(*w), t, h, groups,
                               precision)
    return impl


def _gate(hw, c, groups, device):
    """The kernels' shape and device gate, for a tensor off the CPU."""
    if device.type != "cpu":
        _odefunc.check_device(hw, c, groups, device)


def _odefunc_fake(t, h, w, groups):
    _gate(tuple(h.shape[1:3]), h.shape[3], groups, h.device)
    return torch.empty_like(h)


def _step_cpu(conv_precision):
    def impl(t0, dt, y0, f0, w, rtol, atol, height, width, groups):
        return _rk_step.dopri5_step_plain(
            _odefunc.OdefuncWeights(*w), DOPRI5, t0, dt, y0, f0,
            hw=(height, width), groups=groups, rtol=rtol, atol=atol,
            conv_precision=conv_precision)
    return impl


def _step_cuda(precision):
    def impl(t0, dt, y0, f0, w, rtol, atol, height, width, groups):
        return _rk_step.launch(_odefunc.OdefuncWeights(*w), t0, dt, y0, f0,
                               rtol, atol, (height, width), groups, precision)
    return impl


def _step_fake(t0, dt, y0, f0, w, rtol, atol, height, width, groups):
    _, _, c = _rk_step.fold(t0, dt, y0, f0, (height, width))
    _gate((height, width), c, groups, y0.device)
    return (torch.empty_like(y0), torch.empty_like(y0), torch.empty_like(y0),
            y0.new_empty((y0.shape[0],)))


for _name, _cpu, _cuda, _fake in (
        ("odefunc", _odefunc_cpu("f32"), _odefunc_cuda("f32"), _odefunc_fake),
        ("dopri5_step", _step_cpu(None), _step_cuda("f32"), _step_fake),
        ("odefunc_bf16", _odefunc_cpu("bf16"), _odefunc_cuda("bf16"),
         _odefunc_fake),
        ("dopri5_step_bf16", _step_cpu("bf16"), _step_cuda("bf16"),
         _step_fake)):
    LIB.impl(_name, _cpu, "CPU")
    LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"nodef::{_name}", _fake, lib=LIB)
