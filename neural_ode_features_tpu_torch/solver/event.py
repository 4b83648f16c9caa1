"""Event-terminated integration: solve until ``event_fn(t, y)`` crosses zero
(port of ``neural_ode_features_tpu/solver/event.py``).

The solve is the adaptive RK loop of ``runge_kutta.py`` with an event test
on every accepted step: ``event_fn``'s sign is sampled at the step's
(span-clipped) end and at ``interior_probes`` evenly spaced points of the
step's own dense-output interpolant (the quartic or cubic fit that
``odeint_dense`` stores); the first probe interval whose signs differ in the
requested ``direction`` brackets the root, which ``refine_iters`` bisection
iterations on that interpolant refine.  Location costs no dynamics
evaluation, only Horner passes and ``event_fn`` calls.  With
``error_control='per_sample'`` every batch row integrates until its own
event fires.

Detection model and its limits (those of scipy's ``solve_ivp`` events and
torchdiffeq's ``odeint_event``): an even number of crossings between two
probe points is invisible, and step size follows the state tolerance, not
``event_fn``; raise ``interior_probes`` or tighten the tolerance to catch a
brief dip through zero.  The located root's resolution is the probe
interval times ``2**-refine_iters``.

Loop design.  The JAX solve is one ``lax.while_loop`` that gates the
bisection on ``lax.cond(any(bracket))``.  Here the attempts run on the host
with one device→host sync per attempt, and the bracket flag is read in that
same sync one attempt late: the attempt that brackets a root keeps its
bisection inputs, and the next sync (or the one after the loop) says whether
to run it.  A bracketed row is done at once, so nothing in between reads its
``(t_event, y_event)``.

Forward only: for gradients, event time included, use
:func:`~.event_adjoint.odeint_event_adjoint`.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..rk_attempt import _rk_attempt, tableau_scalars
from ..tableau import ADAPTIVE_TABLEAUS, CUBIC_FIT, QUARTIC_FIT
from .ravel import ravel_batched, ravel_full
from .runge_kutta import (
    SolveStats,
    _error_ratio,
    _optimal_dt,
    _optimal_dt_pi,
    _select_initial_step,
)

__all__ = ["odeint_event", "EventSolution"]


class EventSolution(NamedTuple):
    """Result of an event-terminated solve.

    ``error_control='global'``: ``t_event``/``fired`` are 0-d and
    ``y_event`` has the input state's structure; ``'per_sample'``: they are
    ``(B,)`` and ``y_event`` keeps the batch axis.  Per row:

    * ``fired`` → ``(t_event, y_event)`` is the located crossing;
    * not ``fired``, ``stats.success`` → no event in the span, ``t_event ==
      t_max`` and ``y_event`` the state there;
    * not ``stats.success`` (``max_steps`` ran out) → the solver's running
      position, a consistent pair but not ``t_max``.
    """

    t_event: torch.Tensor
    y_event: Any
    fired: torch.Tensor
    stats: SolveStats


def odeint_event(
    func: Callable[[Any, Any], Any],
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
) -> EventSolution:
    """Integrate from ``t0`` until ``event_fn(t, y)`` crosses zero, or until
    ``t_max`` (either time direction), whichever comes first.

    ``event_fn(t, y)`` returns a scalar (``'global'``) or a ``(B,)`` vector
    (``'per_sample'``, one event per row; ``t`` is then ``(B,)``).  Edges:
    ``event_fn(t0, y0) == 0`` fires at ``t0`` whatever ``direction``; a
    non-finite ``event_fn`` value never counts as a crossing; a degenerate
    span (``t_max == t0``) returns at once with ``fired = (event_fn(t0, y0)
    == 0)``.  ``direction``: ``0`` any crossing, ``+1`` rising only, ``-1``
    falling only.  ``interior_probes``: extra interpolant probes per accepted
    step.  Returns an :class:`EventSolution`."""
    if method not in ADAPTIVE_TABLEAUS:
        raise ValueError(
            f"odeint_event supports adaptive RK methods, got {method!r}")
    if direction not in (-1, 0, 1):
        raise ValueError(f"direction must be -1, 0 or +1, got {direction!r}")
    if interior_probes < 0:
        raise ValueError(
            f"interior_probes must be >= 0, got {interior_probes!r}")
    if controller not in ("i", "pi"):
        raise ValueError(f"unknown controller {controller!r}; 'i' | 'pi'")
    tableau = ADAPTIVE_TABLEAUS[method]
    if error_control == "per_sample":
        flat0, unravel, flatten = ravel_batched(y0)
    elif error_control == "global":
        flat0, unravel, flatten = ravel_full(y0)
    else:
        raise ValueError(f"unknown error_control {error_control!r}")
    per_sample = error_control == "per_sample"
    dtype, dev = flat0.dtype, flat0.device
    batch, n = flat0.shape

    def flat_func(t, y_flat):
        return flatten(func(t if per_sample else t[0], unravel(y_flat)))

    def flat_event(t, y_flat):
        g = torch.as_tensor(event_fn(t if per_sample else t[0],
                                     unravel(y_flat)))
        if tuple(g.shape) not in ((), (batch,)):
            raise ValueError(
                "event_fn must return a scalar ('global') or a (B,) vector "
                f"('per_sample'); got shape {tuple(g.shape)} for "
                f"error_control={error_control!r}")
        return g.to(device=dev, dtype=dtype).expand(batch)

    span_end = torch.tensor(float(t_max), dtype=dtype, device=dev)
    span_dir = torch.sign(span_end - float(t0))
    fit = (QUARTIC_FIT if tableau.c_mid is not None else CUBIC_FIT).tolist()
    scalars = tableau_scalars(tableau, dtype, dev)
    n_coef = len(fit)

    t = torch.full((batch,), float(t0), dtype=dtype, device=dev)
    y = flat0
    f = flat_func(t, y)
    g = flat_event(t, y)
    nfe = torch.ones((batch,), dtype=torch.int32, device=dev)
    if first_step is None:
        dt = _select_initial_step(flat_func, t, y, f, span_dir, rtol, atol,
                                  tableau.order - 1)
        nfe = nfe + 1
    else:
        dt = torch.full((batch,), float(first_step), dtype=dtype,
                        device=dev) * span_dir

    # Defined edges: g(t0) = 0 fires at t0; a degenerate span completes
    # every row up front instead of bracketing a NaN.
    fired = g == 0.0
    done = fired | (span_dir == 0.0)
    # The running position doubles as the reported pair when max_steps
    # runs out.
    t_ev, y_ev = t, y
    naccept = torch.zeros_like(nfe)
    nreject = torch.zeros_like(nfe)
    rprev = torch.ones((batch,), dtype=dtype, device=dev)
    pending = None  # the last attempt's bisection inputs

    def poly_at(coef, x):
        # coef: D+1 (B, N) monomial coefficients on [0, 1]; x (B,) → (B, N)
        val = coef[-1]
        for c in reversed(coef[:-1]):
            val = torch.addcmul(c, val, x[:, None])
        return val

    def matches_direction(s_prev, s_next):
        # "g >= 0" at consecutive probe points.
        if direction == 1:
            return ~s_prev & s_next
        if direction == -1:
            return s_prev & ~s_next
        return s_prev != s_next

    def refine(t_ev, y_ev, bracket, lo, hi, g_lo, t0_, dt, coef):
        """Bisection on the step's interpolant (no dynamics evaluations);
        the sign invariant holds on the bracketed rows, whose (t_ev, y_ev)
        it writes."""
        for _ in range(refine_iters):
            mid = 0.5 * (lo + hi)
            g_mid = flat_event(t0_ + mid * dt, poly_at(coef, mid))
            cross = (g_mid >= 0.0) != (g_lo >= 0.0)
            lo, hi, g_lo = (torch.where(cross, lo, mid),
                            torch.where(cross, mid, hi),
                            torch.where(cross, g_lo, g_mid))
        x_star = 0.5 * (lo + hi)
        return (torch.where(bracket, t0_ + x_star * dt, t_ev),
                torch.where(bracket[:, None], poly_at(coef, x_star), y_ev))

    for _ in range(max_steps):
        # The one host sync per attempt: all rows done, and did the last
        # attempt bracket a root?
        if pending is None:
            finished = bool(done.all())
        else:
            finished, found = torch.stack(
                [done.all(), pending[0].any()]).tolist()
            if found:
                t_ev, y_ev = refine(t_ev, y_ev, *pending)
            pending = None
        if finished:
            break
        active = ~done
        y1, err, f1, new_evals, y_mid = _rk_attempt(tableau, flat_func, t,
                                                   dt, y, f, scalars)
        ratio = _error_ratio(err, y, y1, rtol, atol)
        accept = (ratio <= 1.0) & active
        t1 = t + dt

        # This step's interpolant: coef[c] = Σ_d fit[c][d]·data[d],
        # elementwise (no matmul, so no TF32 on the card).
        dt_col = dt[:, None]
        data = ((y, y1, y_mid, dt_col * f, dt_col * f1) if y_mid is not None
                else (y, y1, dt_col * f, dt_col * f1))
        coef = [sum(fit[c][d] * data[d] for d in range(n_coef)
                    if fit[c][d] != 0.0) for c in range(n_coef)]

        # Probe [0, x_hi]: the step clipped to the span.
        x_end = (span_end - t) / dt
        x_hi = torch.clamp(x_end, 0.0, 1.0)
        n_probe = interior_probes + 1
        xs, gs = [torch.zeros_like(x_hi)], [g]
        for j in range(1, n_probe + 1):
            x_j = x_hi * (j / n_probe)
            xs.append(x_j)
            gs.append(flat_event(t + x_j * dt, poly_at(coef, x_j)))
        y_hi = poly_at(coef, x_hi)
        t_hi = t + x_hi * dt
        g_hi = gs[-1]

        # The first probe interval with a matching, finite sign change
        # brackets the root (NaN is never a crossing).
        xs_ext, gs_ext = torch.stack(xs), torch.stack(gs)  # (K+1, B)
        s_ext = gs_ext >= 0.0
        finite = torch.isfinite(gs_ext)
        flips = (matches_direction(s_ext[:-1], s_ext[1:]) & finite[:-1]
                 & finite[1:] & accept[None, :])  # (K, B)
        bracket = flips.any(dim=0)
        seg = flips.to(torch.int8).argmax(dim=0)[None, :]  # first flip
        pending = (bracket, xs_ext.gather(0, seg)[0],
                   xs_ext.gather(0, seg + 1)[0], gs_ext.gather(0, seg)[0],
                   t, dt, coef)

        # No crossing and the step covered the rest of the span: finish at
        # t_max with the interpolated state.
        exhausted = accept & ~bracket & (x_end <= 1.0)
        # Bracketed rows keep their pair until the bisection writes it.
        t_ev = torch.where(exhausted, t_hi, torch.where(
            accept & ~bracket, t1, t_ev))
        y_ev = torch.where(exhausted[:, None], y_hi, torch.where(
            (accept & ~bracket)[:, None], y1, y_ev))
        fired = fired | bracket

        if controller == "pi":
            proposed = _optimal_dt_pi(dt, ratio, rprev, accept,
                                      tableau.order, 0.9, 10.0, 0.2)
            rprev = torch.where(accept & active,
                                torch.clamp(ratio, min=1e-4), rprev)
        else:
            proposed = _optimal_dt(dt, ratio, accept, tableau.order, 0.9,
                                   10.0, 0.2)
        acc_col = accept[:, None]
        t = torch.where(accept, t1, t)
        dt = torch.where(active, proposed, dt)
        y = torch.where(acc_col, y1, y)
        f = torch.where(acc_col, f1, f)
        g = torch.where(accept, g_hi, g)
        nfe = nfe + active.to(torch.int32) * new_evals
        naccept = naccept + accept.to(torch.int32)
        nreject = nreject + (active & ~accept).to(torch.int32)
        done = done | bracket | exhausted

    if pending is not None and bool(pending[0].any()):  # max_steps ran out
        t_ev, y_ev = refine(t_ev, y_ev, *pending)
    stats = SolveStats(nfe=nfe, naccept=naccept, nreject=nreject,
                       success=done)
    y_tree = unravel(y_ev)
    if per_sample:
        return EventSolution(t_event=t_ev, y_event=y_tree, fired=fired,
                             stats=stats)
    return EventSolution(t_event=t_ev[0], y_event=y_tree, fired=fired[0],
                         stats=stats)
