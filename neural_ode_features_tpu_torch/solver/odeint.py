"""``odeint`` — the front door to ODE integration (port of
``neural_ode_features_tpu/solver/odeint.py``).

Covers the adaptive tableau methods with both error-control modes:

  * ``'per_sample'``: every batch row gets its own adaptive step sequence
    and NFE count (state leaves need a common leading batch axis);
  * ``'global'``: one error norm over the whole flattened state (reference
    semantics, any state shape).

``adams`` and the fixed-grid methods are not ported yet (ROADMAP.md,
Queue 1 item 7, and item 4 for ``fixed_grid``).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .ravel import ravel_batched, ravel_full
from .runge_kutta import SolveStats, adaptive_odeint
from .tableau import ADAPTIVE_TABLEAUS

__all__ = ["odeint", "SOLVERS", "SolveStats"]

# Methods the JAX front door accepts; only the adaptive tableaus run here.
_NOT_PORTED = ("adams", "euler", "midpoint", "heun2", "rk4", "fixed_adams")
SOLVERS: tuple[str, ...] = tuple(ADAPTIVE_TABLEAUS) + _NOT_PORTED


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
    fused_step: Callable | None = None,
    controller: str = "i",
) -> tuple[Any, SolveStats]:
    """Solve ``dy/dt = func(t, y)`` from ``y0`` over times ``ts``.

    With ``error_control='global'`` ``func`` receives a scalar ``t`` and the
    state unchanged; with ``'per_sample'`` it receives ``t`` of shape
    ``(B,)``.  ``fused_step`` (adaptive tableaus only) operates on the flat
    ``(B, N)`` state; see ``runge_kutta.adaptive_odeint``.

    Returns ``(ys, stats)``: ``ys`` like ``y0`` with a leading time axis,
    ``stats`` per-sample (``(B,)`` for per-sample control, ``(1,)`` for
    global).
    """
    if method not in SOLVERS:
        raise ValueError(f"unknown method {method!r}; available: {SOLVERS}")
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"method {method!r} is not ported yet (ROADMAP.md, Queue 1)")
    if error_control not in ("global", "per_sample"):
        raise ValueError(f"unknown error_control {error_control!r}")

    ts = torch.as_tensor(ts)
    if ts.ndim != 1:
        raise ValueError(f"ts must be 1-D, got shape {tuple(ts.shape)}")
    if ts.shape[0] > 1:
        diffs = torch.diff(ts.detach().cpu().double())
        if not (bool((diffs > 0).all()) or bool((diffs < 0).all())):
            raise ValueError("ts must be strictly monotonic (either direction)")

    if error_control == "per_sample":
        flat0, unravel, flatten = ravel_batched(y0)

        def flat_func(t, y_flat):
            return flatten(func(t, unravel(y_flat)))
    else:
        flat0, unravel, flatten = ravel_full(y0)

        def flat_func(t, y_flat):
            return flatten(func(t[0], unravel(y_flat)))

    if ts.shape[0] == 1:
        batch, dev = flat0.shape[0], flat0.device
        zeros = torch.zeros((batch,), dtype=torch.int32, device=dev)
        stats = SolveStats(nfe=zeros, naccept=zeros, nreject=zeros,
                           success=torch.ones((batch,), dtype=torch.bool,
                                              device=dev))
        return unravel(flat0[None]), stats

    ys, stats = adaptive_odeint(
        flat_func, flat0, ts, rtol, atol, ADAPTIVE_TABLEAUS[method],
        max_steps=max_steps, first_step=first_step, fused_step=fused_step,
        controller=controller,
    )
    return unravel(ys), stats
