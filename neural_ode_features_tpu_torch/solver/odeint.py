"""``odeint`` — the front door to ODE integration (port of
``neural_ode_features_tpu/solver/odeint.py``).

Covers every method of the JAX front door: the adaptive tableau methods and
the adaptive Adams solver (``adams.py``), with both error-control modes, and
the fixed-grid methods (``fixed_grid.py``):

  * ``'per_sample'``: every batch row gets its own adaptive step sequence
    and NFE count (state leaves need a common leading batch axis);
  * ``'global'``: one error norm over the whole flattened state (reference
    semantics, any state shape).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..tableau import ADAPTIVE_TABLEAUS
from .adams import adams_odeint
from .fixed_grid import FIXED_GRID_METHODS, fixed_grid_odeint
from .ravel import ravel_batched, ravel_full
from .runge_kutta import SolveStats, adaptive_odeint

__all__ = ["odeint", "SOLVERS", "SolveStats"]

SOLVERS: tuple[str, ...] = (tuple(ADAPTIVE_TABLEAUS) + ("adams",)
                            + FIXED_GRID_METHODS)


def _mask_like(y0: Any, mask: Any, dtype: torch.dtype) -> Any:
    """``mask`` (a tree like ``y0``; a scalar stands for a whole subtree)
    broadcast to ``y0``'s leaves."""
    if isinstance(y0, torch.Tensor):
        return torch.as_tensor(mask, dtype=dtype, device=y0.device).expand(
            y0.shape)
    if isinstance(y0, dict):
        return {k: _mask_like(v, mask[k] if isinstance(mask, dict) else mask,
                              dtype) for k, v in y0.items()}
    return type(y0)(
        _mask_like(v, mask[i] if isinstance(mask, (list, tuple)) else mask,
                   dtype) for i, v in enumerate(y0))


def odeint(
    func: Callable[[Any, Any], Any],
    y0: Any,
    ts,
    *,
    rtol: float = 1e-7,
    atol: float = 1e-9,
    method: str = "dopri5",
    error_control: str = "global",
    max_steps: int = 2**14,
    first_step: float | None = None,
    unroll: str = "while",
    steps_per_interval: int = 1,
    error_mask: Any = None,
    max_order: int = 8,
    fused_step: Callable | None = None,
    controller: str = "i",
    batch_sum: Callable | None = None,
    shared_mask: Any = None,
    graph_key=None,
) -> tuple[Any, SolveStats]:
    """Solve ``dy/dt = func(t, y)`` from ``y0`` over times ``ts``.

    With ``error_control='global'`` ``func`` receives a scalar ``t`` and the
    state unchanged; with ``'per_sample'`` it receives ``t`` of shape
    ``(B,)``.  ``rtol``/``atol``: floats, or with ``'per_sample'`` control
    ``(B,)`` tensors, one tolerance per row.  ``unroll`` (the adaptive
    methods; the fixed-grid ones ignore it, as in JAX): ``'while'`` (early
    exit; on the card a replayed CUDA graph where autograd records
    nothing), ``'scan'`` (exactly ``max_steps`` attempts,
    reverse-differentiable: keep ``max_steps`` small) or ``'scan_remat'``
    (the same, each attempt recomputed in the backward); see
    ``runge_kutta``.  ``steps_per_interval``:
    substeps per ``ts`` interval (fixed-grid methods).  ``error_mask``: a
    state-like tree of 0/1 leaves (scalars broadcast) restricting the
    adaptive error norm to the selected entries (seminorm control).
    ``max_order``: the order ceiling of ``method='adams'`` (2..12); other
    methods ignore it.  ``fused_step`` (adaptive tableaus only) operates on
    the flat ``(B, N)`` state; see ``runge_kutta.adaptive_odeint``.

    ``batch_sum`` (data parallelism): with ``'global'`` control the state
    holds this rank's rows of a batch whose other rows other ranks hold;
    ``batch_sum(t)`` returns ``t`` summed over those ranks, and the error
    norms then span the whole batch (``runge_kutta.RankNorm``), so that
    every rank takes the one-device solve's steps.  ``shared_mask``: a
    state-like tree of 0/1 leaves (scalars broadcast) marking the
    components that are one value for the whole batch, each rank holding a
    partial sum of it.  Per-sample control ignores both: its rows are
    independent.  ``graph_key`` (adaptive tableaus): ``func``'s weights
    stay fixed across solves, named by this hashable tuple; a ``'while'``
    solve on the card then replays a cached CUDA graph
    (``runge_kutta.adaptive_odeint``).

    Returns ``(ys, stats)``: ``ys`` like ``y0`` with a leading time axis,
    ``stats`` per-sample (``(B,)`` for per-sample control, ``(1,)`` for
    global).
    """
    if method not in SOLVERS:
        raise ValueError(f"unknown method {method!r}; available: {SOLVERS}")
    if error_control not in ("global", "per_sample"):
        raise ValueError(f"unknown error_control {error_control!r}")

    ts = torch.as_tensor(ts)
    if ts.ndim != 1:
        raise ValueError(f"ts must be 1-D, got shape {tuple(ts.shape)}")
    # Under tracing ``ts`` has no values to check on the host.
    if ts.shape[0] > 1 and not torch.compiler.is_compiling():
        diffs = torch.diff(ts.detach().cpu().double())
        if not (bool((diffs > 0).all()) or bool((diffs < 0).all())):
            raise ValueError("ts must be strictly monotonic (either direction)")
        if method == "fixed_adams" and not torch.allclose(
                diffs, diffs[0].expand_as(diffs), rtol=1e-6, atol=0.0):
            raise ValueError(
                "fixed_adams assumes a uniformly spaced ts grid; use "
                "steps_per_interval on a uniform grid")
    if error_mask is not None and method in FIXED_GRID_METHODS:
        raise ValueError(
            "error_mask (seminorm control) only applies to adaptive methods;"
            f" {method!r} is fixed-grid")
    if controller != "i" and method not in ADAPTIVE_TABLEAUS:
        raise ValueError(
            f"controller={controller!r} only applies to adaptive tableau "
            f"methods ({tuple(ADAPTIVE_TABLEAUS)}), not {method!r}")

    if error_control == "per_sample":
        flat0, unravel, flatten = ravel_batched(y0)

        def flat_func(t, y_flat):
            return flatten(func(t, unravel(y_flat)))
    else:
        flat0, unravel, flatten = ravel_full(y0)

        def flat_func(t, y_flat):
            return flatten(func(t[0], unravel(y_flat)))

    flat_mask = None
    if error_mask is not None:
        flat_mask = flatten(_mask_like(y0, error_mask, flat0.dtype))
        # An all-zero mask row would switch error control off (every step
        # accepted, dt growing without bound) and still report success.
        if not bool(flat_mask.any(dim=-1).all()):
            raise ValueError(
                "error_mask masks out every state component of at least one "
                "sample: that disables error control; keep at least one "
                "component unmasked per sample")

    if error_control == "per_sample":
        batch_sum = None
    shared = None
    if batch_sum is not None and shared_mask is not None:
        shared = flatten(_mask_like(y0, shared_mask, flat0.dtype)) > 0
    rank_kw = ({} if batch_sum is None
               else dict(batch_sum=batch_sum, shared=shared))

    if ts.shape[0] == 1:
        batch, dev = flat0.shape[0], flat0.device
        zeros = torch.zeros((batch,), dtype=torch.int32, device=dev)
        stats = SolveStats(nfe=zeros, naccept=zeros, nreject=zeros,
                           success=torch.ones((batch,), dtype=torch.bool,
                                              device=dev))
        return unravel(flat0[None]), stats

    if method in ADAPTIVE_TABLEAUS:
        ys, stats = adaptive_odeint(
            flat_func, flat0, ts, rtol, atol, ADAPTIVE_TABLEAUS[method],
            max_steps=max_steps, first_step=first_step, unroll=unroll,
            error_mask=flat_mask, fused_step=fused_step,
            controller=controller, graph_key=graph_key, **rank_kw)
    elif fused_step is not None:
        raise ValueError("fused_step only applies to adaptive tableau "
                         f"methods, not {method!r}")
    elif method == "adams":
        ys, stats = adams_odeint(flat_func, flat0, ts, rtol, atol,
                                 max_steps=max_steps, first_step=first_step,
                                 unroll=unroll, error_mask=flat_mask,
                                 max_order=max_order,
                                 **rank_kw)
    else:
        ys, stats = fixed_grid_odeint(flat_func, flat0, ts, method,
                                      steps_per_interval=steps_per_interval)
    return unravel(ys), stats
