"""Adjoint-method gradients through ``odeint`` (port of
``neural_ode_features_tpu/solver/adjoint.py``).

``odeint_adjoint`` is a ``torch.autograd.Function``:

  * forward: the port's :func:`~.odeint.odeint` under ``torch.no_grad()``
    (no fused step, as in JAX), keeping only ``(params, ts, ys)``;
  * backward: the interval loop of the JAX ``_bwd``.  For i = T-1 … 1 it
    adds the cotangent g_i to a_y, takes the observation-time gradient
    dL/dt_i = g_i · f(t_i, y_i), and integrates the augmented state
    ``(y, a_y, a_θ, a_t)`` from t_i back to t_{i-1} with batch-global error
    control, restarting y from the stored observation.  The vector–Jacobian
    products a_y·∂f/∂{θ,t,y} come from ``vjp`` (default: ``torch.autograd``
    through ``func``; the ODE-Net passes its fused kernel pair).
  * ``adjoint_seminorm=True`` (Kidger et al. 2020): the backward solve's
    accept/reject norm covers only (y, a_y); the a_θ and a_t columns are
    pure integrals that cannot feed back into the dynamics, so leaving them
    out cuts backward NFE with no first-order effect on the gradients.
  * ``adjoint_mode='interpolated'`` (Daulbaev et al. 2020): the forward is a
    dense solve (:func:`~.dense.odeint_dense`) whose accepted steps'
    polynomials are kept, and the backward reads y(t) from them instead of
    integrating it again: the augmented state shrinks to (a_y, a_θ, a_t)
    and y never drifts.  The kept coefficients cost O(accepted steps ·
    (order+1) · B · N) memory, freed with the autograd graph.

The backward dynamics evaluations are counted as the JAX ``nfe_b_sum`` (the
augmented solves' NFE plus one f per observation interval, T-1) and written
into the returned stats' ``nfe_b`` tensor during ``.backward()``.  A failed
backward solve, or a dense forward that ran out of ``dense_max_steps``,
poisons the gradients with NaN.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

from ..tableau import ADAPTIVE_TABLEAUS
from .dense import DenseSolution, odeint_dense
from .fixed_grid import FIXED_GRID_METHODS
from .odeint import odeint
from .ravel import ravel_batched, ravel_full

__all__ = ["odeint_adjoint", "AdjointStats", "check_adjoint_options"]

_MODES = ("reintegrate", "interpolated")


class AdjointStats(NamedTuple):
    """The forward solve's per-sample accounting, plus ``nfe_b``: a 0-d
    int64 tensor on the solve's device that ``.backward()`` fills with the
    total backward dynamics evaluations (0 until then)."""

    nfe: torch.Tensor
    naccept: torch.Tensor
    nreject: torch.Tensor
    success: torch.Tensor
    nfe_b: torch.Tensor


def check_adjoint_options(adjoint_seminorm: bool, adjoint_mode: str,
                          method: str = "dopri5") -> None:
    """Raise for a combination of adjoint options that cannot run, where
    the caller passed it."""
    if adjoint_mode not in _MODES:
        raise ValueError(f"unknown adjoint_mode {adjoint_mode!r}; {_MODES}")
    if adjoint_seminorm and method in FIXED_GRID_METHODS:
        raise ValueError(
            "adjoint_seminorm controls the backward solve's adaptive error "
            f"norm; method={method!r} is fixed-grid and has no error "
            "control to restrict")
    if adjoint_mode == "interpolated" and method not in ADAPTIVE_TABLEAUS:
        raise ValueError(
            "adjoint_mode='interpolated' needs the forward's dense solution "
            "(odeint_dense), which supports adaptive RK methods only, not "
            f"{method!r}")


def _autograd_vjp(func):
    """``vjp(params, t, y, a) -> (f, dparams, dt, dy)`` by
    ``torch.autograd.grad`` through ``func``."""

    def vjp(params, t, y, a):
        leaves, spec = pytree.tree_flatten(params)
        with torch.enable_grad():
            ps = [p.detach().requires_grad_() for p in leaves]
            tt = t.detach().requires_grad_()
            yy = y.detach().requires_grad_()
            f = func(pytree.tree_unflatten(ps, spec), tt, yy)
            grads = torch.autograd.grad(f, [*ps, tt, yy], a,
                                        allow_unused=True)
        grads = [torch.zeros_like(x) if gr is None else gr
                 for gr, x in zip(grads, [*ps, tt, yy])]
        return (f.detach(), pytree.tree_unflatten(grads[:-2], spec),
                grads[-2], grads[-1])

    return vjp


@dataclasses.dataclass
class _Spec:
    func: Callable
    vjp: Callable
    treedef: Any
    paths: list
    fwd_kw: dict
    bwd_kw: dict
    per_sample: bool
    nfe_b: torch.Tensor
    seminorm: bool = False
    interpolated: bool = False
    dense_max_steps: int = 256


def _leaves_like(tree, paths) -> list[torch.Tensor]:
    """The leaves of ``tree`` at ``paths`` (so that a gradient tree whose
    dicts list their keys in another order still lines up)."""
    found = dict(pytree.tree_flatten_with_path(tree)[0])
    return [found[p] for p in paths]


class _Adjoint(torch.autograd.Function):

    @staticmethod
    def forward(ctx, spec: _Spec, y0, ts, *leaves):
        params = pytree.tree_unflatten(list(leaves), spec.treedef)
        ctx.spec = spec
        ctx.dense = spec.interpolated and ts.shape[0] >= 2
        if ctx.dense:
            # Dense forward: the same solver and tolerances, keeping every
            # accepted step's interpolation record for the backward.
            kw = {k: v for k, v in spec.fwd_kw.items()
                  if k not in ("max_steps", "unroll")}
            y_at, stats = odeint_dense(
                lambda t, y: spec.func(params, t, y), y0, float(ts[0]),
                float(ts[-1]), max_steps=spec.dense_max_steps, **kw)
            ys = y_at(ts)
            sol = y_at.__wrapped_sol__
            # Keep the written slots only (the buffer holds up to twice the
            # attempts).
            keep = max(int(stats.naccept.max()), 1)
            ctx.sol_meta = (sol.direction, sol.t_span)
            ctx.save_for_backward(
                ts, ys, stats.success.all(), sol.t0s[:keep].clone(),
                sol.dts[:keep].clone(), sol.coeffs[:keep].clone(),
                sol.naccept, *leaves)
        else:
            ys, stats = odeint(lambda t, y: spec.func(params, t, y), y0, ts,
                               **spec.fwd_kw)
            ctx.save_for_backward(ts, ys, *leaves)
        ctx.mark_non_differentiable(*stats)
        return (ys, *stats)

    @staticmethod
    def backward(ctx, g_ys, *_):
        spec = ctx.spec
        fwd_ok = sol = None
        if ctx.dense:
            ts, ys, fwd_ok, t0s, dts, coeffs, naccept, *leaves = (
                ctx.saved_tensors)
            sol = DenseSolution(t0s, dts, coeffs, naccept, *ctx.sol_meta)
            _, unravel_y, _ = (ravel_batched if spec.per_sample
                               else ravel_full)(ys[0])
        else:
            ts, ys, *leaves = ctx.saved_tensors
        params = pytree.tree_unflatten(leaves, spec.treedef)
        n_times, batch, dev = ts.shape[0], ys.shape[1], ys.device
        bwd_kw = dict(spec.bwd_kw)
        if spec.seminorm:
            # 0/1 over the augmented state; a scalar stands for its subtree.
            mask = {"a_y": 1.0, "a_p": 0.0, "a_t": 0.0}
            if not ctx.dense:
                mask["y"] = 1.0
            bwd_kw["error_mask"] = mask
        if bwd_kw.get("batch_sum") is not None:
            # Across ranks, a_θ and a_t are each rank's partial sums of one
            # value (the dynamics never read them, so the parts integrate
            # apart and add up); y and a_y are this rank's rows.
            shared = {"a_y": 0.0, "a_p": 1.0, "a_t": 1.0}
            if not ctx.dense:
                shared["y"] = 0.0
            bwd_kw["shared_mask"] = shared

        def t_arg(t):
            # The forward's time-argument contract holds in the backward
            # too: with per-sample control func always sees t of shape (B,).
            return t.expand(batch) if spec.per_sample else t

        def aug_dynamics(t, aug):
            # Interpolated: y(t) comes from the forward's dense solution and
            # is not part of the state.
            y = (unravel_y(sol.evaluate_flat(t))[0] if ctx.dense
                 else aug["y"])
            f, v_p, v_t, v_y = spec.vjp(params, t_arg(t), y, aug["a_y"])
            out = {"a_y": -v_y,
                   "a_p": [-v for v in _leaves_like(v_p, spec.paths)],
                   "a_t": -v_t.reshape(-1).sum()}
            if not ctx.dense:
                out["y"] = f
            return out

        a_y = torch.zeros_like(ys[0])
        a_p = [torch.zeros_like(p) for p in leaves]
        a_t = torch.zeros((), dtype=ts.dtype, device=dev)
        grad_ts = torch.zeros_like(ts)
        nfe_b = torch.zeros((), dtype=torch.int64, device=dev)
        ok = torch.ones((), dtype=torch.bool, device=dev)
        for i in range(n_times - 1, 0, -1):
            a_y = a_y + g_ys[i]
            # dL/dt_i from shifting the i-th observation time: an explicit
            # f32 multiply-and-sum (no matmul, so TF32 cannot touch it).
            f_i = spec.func(params, t_arg(ts[i]), ys[i])
            g_t_i = (g_ys[i] * f_i).sum().to(ts.dtype)
            grad_ts[i] = g_t_i
            a_t = a_t - g_t_i
            aug0 = {"a_y": a_y, "a_p": a_p, "a_t": a_t}
            if not ctx.dense:
                aug0["y"] = ys[i]
            traj, st = odeint(aug_dynamics, aug0,
                              torch.stack([ts[i], ts[i - 1]]), **bwd_kw)
            a_y, a_t = traj["a_y"][-1], traj["a_t"][-1]
            a_p = [x[-1] for x in traj["a_p"]]
            nfe_b = nfe_b + st.nfe[0]
            ok = ok & st.success[0]
        a_y = a_y + g_ys[0]
        grad_ts[0] = a_t
        spec.nfe_b.copy_(nfe_b + (n_times - 1))
        if fwd_ok is not None:  # a truncated dense forward poisons too
            ok = ok & fwd_ok

        # A failed backward solve must not pass for zero gradients.
        def poison(g):
            return torch.where(ok, g, torch.full_like(g, float("nan")))

        return (None, poison(a_y), poison(grad_ts),
                *(poison(g) for g in a_p))


def odeint_adjoint(
    func: Callable[[Any, Any, Any], torch.Tensor],
    params: Any,
    y0: torch.Tensor,
    ts,
    *,
    rtol: float = 1e-7,
    atol: float = 1e-9,
    method: str = "dopri5",
    error_control: str = "global",
    max_steps: int = 2**14,
    unroll: str = "while",
    controller: str = "i",
    adjoint_rtol: float | None = None,
    adjoint_atol: float | None = None,
    adjoint_max_steps: int | None = None,
    adjoint_seminorm: bool = False,
    adjoint_mode: str = "reintegrate",
    dense_max_steps: int = 256,
    steps_per_interval: int = 1,
    vjp: Callable | None = None,
    batch_sum: Callable | None = None,
) -> tuple[torch.Tensor, AdjointStats]:
    """Like :func:`~.odeint.odeint`, differentiable in ``params`` (a tree of
    tensors), ``y0`` (a tensor) and ``ts`` through the augmented reverse-time
    adjoint ODE.

    ``func(params, t, y)`` must be a pure function of its explicit
    arguments.  ``adjoint_{rtol,atol,max_steps}`` override the backward
    solve's settings (default: the forward's).  ``controller`` and
    ``unroll`` (see :func:`~.odeint.odeint`; not the interpolated forward,
    a host loop) apply to both solves: with ``'while'`` on one card each
    takes the graph route, since neither records autograd.  ``adjoint_seminorm`` and ``adjoint_mode``: see the module
    docstring; ``dense_max_steps`` bounds the interpolated forward's
    attempts (its coefficient buffer grows with the attempts made).  With
    ``error_control='per_sample'`` ``func`` receives t of shape (B,) in the
    forward and the backward.  ``vjp(params, t, y, a) ->
    (f, dparams, dt, dy)`` replaces autograd through ``func`` in the
    augmented dynamics (``dt`` in ``t``'s shape, ``dparams`` a tree like
    ``params``).

    ``batch_sum`` (data parallelism, one rank per device): ``y0`` holds this
    rank's rows of a batch whose other rows other ranks hold, and
    ``batch_sum(t)`` sums ``t`` over those ranks.  The backward solve's
    batch-global norm (and a ``'global'`` forward's) then spans the whole
    batch, so every rank takes the one-device solve's steps and ``nfe_b``;
    each rank integrates its own partial a_θ and a_t with those steps, and
    the caller sums the parameter gradients once at the end.  A per-sample
    forward has no collective: its rows are independent.

    Returns ``(ys, AdjointStats)``; ``stats.nfe_b`` is filled in by
    ``.backward()``."""
    check_adjoint_options(adjoint_seminorm, adjoint_mode, method)
    if not isinstance(y0, torch.Tensor):
        raise TypeError("odeint_adjoint takes a tensor state y0")
    ts = torch.as_tensor(ts, device=y0.device)
    with_paths, treedef = pytree.tree_flatten_with_path(params)
    paths = [p for p, _ in with_paths]
    leaves = [x for _, x in with_paths]
    fwd_kw = dict(rtol=rtol, atol=atol, method=method,
                  error_control=error_control, max_steps=max_steps,
                  unroll=unroll, controller=controller, batch_sum=batch_sum)
    if adjoint_mode != "interpolated":
        fwd_kw["steps_per_interval"] = steps_per_interval
    # The augmented state couples every sample through the shared a_θ, so
    # the backward solve always uses batch-global error control.
    bwd_kw = dict(
        rtol=rtol if adjoint_rtol is None else adjoint_rtol,
        atol=atol if adjoint_atol is None else adjoint_atol,
        method=method, error_control="global",
        max_steps=max_steps if adjoint_max_steps is None
        else adjoint_max_steps, unroll=unroll,
        controller=controller, steps_per_interval=steps_per_interval,
        batch_sum=batch_sum)
    nfe_b = torch.zeros((), dtype=torch.int64, device=y0.device)
    spec = _Spec(func=func, vjp=vjp or _autograd_vjp(func), treedef=treedef,
                 paths=paths, fwd_kw=fwd_kw, bwd_kw=bwd_kw,
                 per_sample=error_control == "per_sample", nfe_b=nfe_b,
                 seminorm=adjoint_seminorm,
                 interpolated=adjoint_mode == "interpolated",
                 dense_max_steps=dense_max_steps)
    ys, *stats = _Adjoint.apply(spec, y0, ts, *leaves)
    return ys, AdjointStats(*stats, nfe_b=nfe_b)
