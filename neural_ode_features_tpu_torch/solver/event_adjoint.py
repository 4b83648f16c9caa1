"""Differentiable event-terminated integration by the implicit function
theorem (port of ``neural_ode_features_tpu/solver/event_adjoint.py``).

The hitting time t* is defined by g(t*, y(t*)) = 0 along y' = f(θ, t, y),
y(t0) = y0.  For ξ ∈ {θ, y0}::

    dt*/dξ = −(∂g/∂t + ∂g/∂y·f)⁻¹ · ∂g/∂y · ∂y(t*)/∂ξ
    dy*/dξ = ∂y(t*)/∂ξ + f(t*, y*) · dt*/dξ

Both come by composition, as in JAX:

  1. locate t* with :func:`~.event.odeint_event` under ``torch.no_grad()``
     on detached inputs;
  2. solve again, differentiably, to the located end with
     :func:`~.adjoint.odeint_adjoint` on s ∈ [0, 1]: z(s) = y(t0 + s·(t*−t0))
     solves z' = (t*−t0)·f(t0 + s·(t*−t0), z), one batched solve for rows
     with different hitting times (the factor is per row);
  3. one Newton step, differentiable only through y_T, with the
     denominator ∂g/∂t + ∂g/∂y·f (one forward-mode JVP of ``event_fn``) and
     f frozen::

         t* = t_loc − g(t_loc, y_T) / denom,   y* = y_T + f · (t* − t_loc)

     At the primal the correction is about 0; its chain rule is the IFT.

Rows where no event fires return ``t_event = t_max`` with zero event-time
gradient, and ``y_event = y(t_max)`` with its trajectory gradient.  A
grazing event (denom → 0) has unbounded sensitivity.  ``stats`` are the
locate solve's; ``success`` also needs the re-solve.

``vjp(params, t, y, a) -> (f, dparams, dt, dy)`` (a tensor state only)
replaces autograd through ``func`` in the re-solve's backward, as in
:func:`~.adjoint.odeint_adjoint`: the ODE-Net passes its kernel pair
(``models.odenet.block_dynamics``), and this module scales it by the same
per-row factor as the dynamics.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.autograd.forward_ad as fwAD
from torch.utils import _pytree as pytree

from .adjoint import odeint_adjoint
from .event import EventSolution, odeint_event
from .ravel import ravel_batched, ravel_full

__all__ = ["odeint_event_adjoint"]


def _bcast_row(vec: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A 0-d or (B,) row factor broadcast against a leaf of any rank."""
    if vec.ndim == 0:
        return vec
    return vec.reshape(vec.shape + (1,) * (leaf.ndim - 1))


def _event_jvp(event_fn, t, y, tangent_y) -> torch.Tensor:
    """d/dε g(t + ε, y + ε·tangent_y) at ε = 0, by forward-mode AD."""
    with fwAD.dual_level():
        t_d = fwAD.make_dual(t, torch.ones_like(t))
        y_d = pytree.tree_map(fwAD.make_dual, y, tangent_y)
        g = torch.as_tensor(event_fn(t_d, y_d))
        tangent = fwAD.unpack_dual(g).tangent
    return torch.zeros_like(g) if tangent is None else tangent.detach()


def odeint_event_adjoint(
    func: Callable[[Any, Any, Any], Any],
    params: Any,
    y0: Any,
    t0: float,
    event_fn: Callable[[Any, Any], Any],
    *,
    t_max: float,
    rtol: float = 1e-7,
    atol: float = 1e-9,
    method: str = "dopri5",
    error_control: str = "global",
    max_steps: int = 256,
    first_step: float | None = None,
    controller: str = "i",
    refine_iters: int = 30,
    direction: int = 0,
    interior_probes: int = 0,
    adjoint_rtol: float | None = None,
    adjoint_atol: float | None = None,
    adjoint_max_steps: int | None = None,
    adjoint_seminorm: bool = False,
    adjoint_mode: str = "reintegrate",
    vjp: Callable | None = None,
) -> EventSolution:
    """Like :func:`~.event.odeint_event`, differentiable in ``params`` (a
    tree of tensors) and ``y0`` (a tensor or a tree of tensors), event time
    included.  ``func(params, t, y)`` takes the parameters explicitly (the
    :func:`~.adjoint.odeint_adjoint` signature); ``event_fn(t, y)`` is the
    forward-only one's.  The location knobs go to the locate solve, the
    ``adjoint_*`` knobs to the re-solve's backward; ``vjp``: see the module
    docstring.  ``t_event`` and ``y_event`` carry gradients, ``fired`` and
    ``stats`` do not."""
    per_sample = error_control == "per_sample"
    is_tensor = isinstance(y0, torch.Tensor)
    if vjp is not None and not is_tensor:
        raise ValueError("vjp= takes a tensor state y0")

    # 1. Locate t* (no graph).
    with torch.no_grad():
        params_c = pytree.tree_map(torch.Tensor.detach, params)
        y0_c = pytree.tree_map(torch.Tensor.detach, y0)
        sol = odeint_event(
            lambda t, y: func(params_c, t, y), y0_c, t0, event_fn,
            t_max=t_max, rtol=rtol, atol=atol, method=method,
            error_control=error_control, max_steps=max_steps,
            first_step=first_step, controller=controller,
            refine_iters=refine_iters, direction=direction,
            interior_probes=interior_probes)
    t_loc = sol.t_event.detach()  # 0-d ('global') or (B,) ('per_sample')
    fired = sol.fired

    # 2. The differentiable solve to the located end, on s ∈ [0, 1], with
    # the per-row duration a constant (the end's motion comes from step 3).
    dur = t_loc - float(t0)
    if is_tensor:
        state0, unravel, flatten = y0, (lambda z: z), (lambda z: z)
    else:
        state0, unravel, flatten = (ravel_batched if per_sample
                                    else ravel_full)(y0)

    def scale(z):  # a state-shaped tensor times the per-row duration
        return _bcast_row(dur, z) * z

    def func_s(p, s, z):
        return scale(flatten(func(p, float(t0) + s * dur, unravel(z))))

    vjp_s = None
    if vjp is not None:
        def vjp_s(p, s, z, a):
            # a·(dur·f) = (dur·a)·f per row; d/ds = dur·d/dt.
            f, dp, dt, dz = vjp(p, float(t0) + s * dur, z, scale(a))
            return scale(f), dp, dt * dur, dz

    zs, fix_stats = odeint_adjoint(
        func_s, params, state0,
        torch.tensor([0.0, 1.0], dtype=t_loc.dtype, device=t_loc.device),
        rtol=rtol, atol=atol, method=method, error_control=error_control,
        # One interval over the whole located span: at least odeint's
        # default budget (max_steps bounds the location's work only).
        max_steps=max(max_steps, 2**14), controller=controller,
        adjoint_rtol=adjoint_rtol, adjoint_atol=adjoint_atol,
        adjoint_max_steps=adjoint_max_steps,
        adjoint_seminorm=adjoint_seminorm, adjoint_mode=adjoint_mode,
        vjp=vjp_s)
    y_T = unravel(zs[-1])  # differentiable y(t_loc)

    # 3. One Newton step, differentiable only through y_T.
    with torch.no_grad():
        y_T_c = pytree.tree_map(torch.Tensor.detach, y_T)
        f_T = func(params_c, t_loc, y_T_c)  # the frozen end velocity
    denom = _event_jvp(event_fn, t_loc, y_T_c, f_T)
    # Rows where no event fired: the branch is discarded, but 0·NaN would
    # still poison the backward.  Fired rows keep the true denominator.
    denom_safe = torch.where(fired & (denom != 0.0), denom,
                             torch.ones_like(denom))
    g_T = torch.as_tensor(event_fn(t_loc, y_T))
    newton = fired.to(g_T.dtype) * g_T / denom_safe
    t_star = t_loc - newton
    y_star = pytree.tree_map(lambda yt, ft: yt - _bcast_row(newton, yt) * ft,
                             y_T, f_T)
    stats = sol.stats._replace(
        success=sol.stats.success & fix_stats.success.all())
    return EventSolution(t_event=t_star, y_event=y_star, fired=fired,
                         stats=stats)
