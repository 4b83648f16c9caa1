"""Continuous-solution API: solve once, evaluate y(t) anywhere afterwards
(port of ``neural_ode_features_tpu/solver/dense.py``).

``odeint`` needs the t-grid up front.  :func:`odeint_dense` returns a
:class:`DenseSolution`, the interpolation coefficients of every accepted
step, which can be evaluated at any t ∈ [t0, t1] later without re-solving:
a per-sample segment lookup and a Horner pass, both elementwise f32 (no
matmul, so no TF32 on the card).

The solve is a host loop over attempts, as ``adaptive_odeint``: one
``done.all()`` sync per attempt.  The coefficient buffer is written in place
at each sample's own slot under the accepted mask.  It starts at
``_FIRST_SLOTS`` step slots and doubles when the attempts reach its end, up
to ``max_steps``, so its size follows the attempts made and not the bound.

Memory: O(attempts · (order+1) · B · N) for the coefficient buffer, at most
twice the attempts made (and at most ``max_steps`` slots).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..rk_attempt import _rk_attempt, tableau_scalars
from ..tableau import ADAPTIVE_TABLEAUS, CUBIC_FIT, QUARTIC_FIT
from .ravel import ravel_batched, ravel_full
from .runge_kutta import (
    RankNorm,
    SolveStats,
    _error_ratio,
    _optimal_dt,
    _optimal_dt_pi,
    _select_initial_step,
)

__all__ = ["odeint_dense", "DenseSolution"]

_FIRST_SLOTS = 8  # the coefficient buffer's first size, in step slots


class DenseSolution(NamedTuple):
    """Piecewise-polynomial continuous solution.  Fields are per accepted
    step s and sample b."""

    # S: the buffer's step slots, at least max(naccept).
    t0s: torch.Tensor  # (S, B) step start times (monotonic in direction)
    dts: torch.Tensor  # (S, B) signed step sizes
    coeffs: torch.Tensor  # (S, D+1, B, N) monomial coefficients on x∈[0,1]
    naccept: torch.Tensor  # (B,) valid step count per sample
    direction: torch.Tensor  # () sign of integration
    t_span: torch.Tensor  # (2,) [t0, t1]

    def evaluate_flat(self, t) -> torch.Tensor:
        """y(t) as the flat (B, N) matrix; ``t``: scalar or (T,) → (T, B, N).

        Queries outside [t0, t1] are clamped to the span endpoints (the last
        accepted step generally overshoots t1, so the clamp must happen in
        t-space, not on the within-step coordinate)."""
        dev, dtype = self.t0s.device, self.t0s.dtype
        t_arr = torch.atleast_1d(torch.as_tensor(t).to(device=dev,
                                                       dtype=dtype))  # (T,)
        d = self.direction
        t_arr = d * torch.clamp(d * t_arr, d * self.t_span[0],
                                d * self.t_span[1])
        n_steps, batch = self.t0s.shape
        # Segment lookup per sample: last step with direction*(t - t0s) >= 0,
        # clipped to the valid range [0, naccept-1].  Unwritten slots hold 0:
        # force them beyond any query.
        s_idx = torch.arange(n_steps, device=dev)
        key = torch.where(s_idx[:, None] < self.naccept[None, :],
                          d * self.t0s, torch.full_like(self.t0s,
                                                        float("inf")))
        q = (d * t_arr)[None, :].expand(batch, -1).contiguous()  # (B, T)
        k = torch.searchsorted(key.T.contiguous(), q, right=True) - 1
        hi = torch.clamp(self.naccept.long() - 1, min=0)[:, None]
        k = torch.minimum(torch.clamp(k, min=0), hi)  # (B, T)
        t0 = self.t0s.T.gather(1, k)
        dt = self.dts.T.gather(1, k)
        x = torch.clamp((t_arr[None, :] - t0) / dt, 0.0, 1.0)  # (B, T)
        bidx = torch.arange(batch, device=dev)[:, None]
        c = self.coeffs[k, :, bidx, :]  # (B, T, D+1, N)
        val = c[:, :, -1, :]
        for i in range(c.shape[2] - 2, -1, -1):
            val = val * x[:, :, None] + c[:, :, i, :]
        return val.transpose(0, 1)  # (T, B, N)


def odeint_dense(
    func: Callable[[Any, Any], Any],
    y0: Any,
    t0: float,
    t1: float,
    *,
    rtol: float = 1e-7,
    atol: float = 1e-9,
    method: str = "dopri5",
    error_control: str = "global",
    max_steps: int = 256,
    first_step: float | None = None,
    controller: str = "i",
    batch_sum: Callable | None = None,
) -> tuple[Callable[[Any], Any], SolveStats]:
    """Solve over [t0, t1] once; return ``(y_at, stats)`` where ``y_at(t)``
    evaluates the continuous solution at any scalar-or-vector ``t`` in the
    span (clamped at the ends), returning the state with a leading time axis
    for vector ``t``.  ``y_at.__wrapped_sol__`` is the raw
    :class:`DenseSolution`.

    ``max_steps`` bounds the solve's attempts; the coefficient buffer grows
    with the attempts made (see the module docstring).  ``batch_sum``: with
    global control, the norm spans the rows other ranks hold
    (``runge_kutta.RankNorm``); per-sample control ignores it.
    """
    if method not in ADAPTIVE_TABLEAUS:
        raise ValueError(
            f"odeint_dense supports adaptive RK methods, got {method!r}")
    if controller not in ("i", "pi"):
        raise ValueError(f"unknown controller {controller!r}; 'i' | 'pi'")
    tableau = ADAPTIVE_TABLEAUS[method]
    if error_control == "per_sample":
        flat0, unravel, flatten = ravel_batched(y0)

        def flat_func(t, y_flat):
            return flatten(func(t, unravel(y_flat)))
    elif error_control == "global":
        flat0, unravel, flatten = ravel_full(y0)

        def flat_func(t, y_flat):
            return flatten(func(t[0], unravel(y_flat)))
    else:
        raise ValueError(f"unknown error_control {error_control!r}")

    dtype, dev = flat0.dtype, flat0.device
    batch, n = flat0.shape
    norm = (RankNorm(batch_sum, None, None, n, dev)
            if batch_sum is not None and error_control == "global" else None)
    span = torch.tensor([t0, t1], dtype=dtype, device=dev)
    direction = torch.sign(span[1] - span[0])

    quartic = tableau.c_mid is not None
    scalars = tableau_scalars(tableau, dtype, dev)
    fit = (QUARTIC_FIT if quartic else CUBIC_FIT).tolist()
    n_coef = len(fit)

    t = torch.full((batch,), float(span[0]), dtype=dtype, device=dev)
    f = flat_func(t, flat0)
    nfe = torch.ones((batch,), dtype=torch.int32, device=dev)
    if first_step is None:
        dt = _select_initial_step(flat_func, t, flat0, f, direction, rtol,
                                  atol, tableau.order - 1, norm)
        nfe = nfe + 1
    else:
        dt = torch.full((batch,), float(first_step), dtype=dtype,
                        device=dev) * direction

    y = flat0
    slots = min(max_steps, _FIRST_SLOTS)
    t0s = torch.zeros((slots, batch), dtype=dtype, device=dev)
    dts = torch.ones((slots, batch), dtype=dtype, device=dev)
    coeffs = torch.zeros((slots, n_coef, batch, n), dtype=dtype, device=dev)
    naccept = torch.zeros((batch,), dtype=torch.int32, device=dev)
    nreject = torch.zeros_like(naccept)
    done = torch.zeros((batch,), dtype=torch.bool, device=dev)
    rprev = torch.ones((batch,), dtype=dtype, device=dev)
    bidx = torch.arange(batch, device=dev)

    for attempt in range(max_steps):
        if bool(done.all()):  # the one host sync per attempt
            break
        if attempt == slots:
            # A sample has accepted at most ``attempt`` steps, so its next
            # slot is ``attempt`` at most: double the buffer.
            grown = min(max_steps, 2 * slots)
            t0s = torch.cat([t0s, t0s.new_zeros((grown - slots, batch))])
            dts = torch.cat([dts, dts.new_ones((grown - slots, batch))])
            coeffs = torch.cat([coeffs, coeffs.new_zeros(
                (grown - slots, n_coef, batch, n))])
            slots = grown
        active = ~done
        y1, err, f1, new_evals, y_mid = _rk_attempt(tableau, flat_func, t, dt,
                                                   y, f, scalars)
        dt_col = dt[:, None]
        data = ((y, y1, y_mid, dt_col * f, dt_col * f1) if quartic
                else (y, y1, dt_col * f, dt_col * f1))
        ratio = (_error_ratio(err, y, y1, rtol, atol) if norm is None
                 else norm.error_ratio(err, y, y1, rtol, atol))
        accept = (ratio <= 1.0) & active
        t1_ = t + dt

        # Monomial coefficients coef[c] = Σ_d fit[c][d] · data[d]: elementwise
        # f32 products, zero entries skipped (no matmul, so no TF32).
        coef = torch.stack([
            sum(fit[c][d] * data[d] for d in range(n_coef)
                if fit[c][d] != 0.0)
            for c in range(n_coef)])  # (D+1, B, N)

        # This step's record goes to row naccept[b] of sample b, in place,
        # where the step was accepted.
        slot = naccept.long()
        t0s[slot, bidx] = torch.where(accept, t, t0s[slot, bidx])
        dts[slot, bidx] = torch.where(accept, dt, dts[slot, bidx])
        coeffs[slot, :, bidx, :] = torch.where(
            accept[:, None, None], coef.transpose(0, 1),
            coeffs[slot, :, bidx, :])

        if controller == "pi":
            proposed = _optimal_dt_pi(dt, ratio, rprev, accept,
                                      tableau.order, 0.9, 10.0, 0.2)
            rprev = torch.where(accept & active,
                                torch.clamp(ratio, min=1e-4), rprev)
        else:
            proposed = _optimal_dt(dt, ratio, accept, tableau.order,
                                   0.9, 10.0, 0.2)
        reached = accept & (direction * (t1_ - span[1]) >= 0.0)
        acc_col = accept[:, None]

        t = torch.where(accept, t1_, t)
        dt = torch.where(active, proposed, dt)
        y = torch.where(acc_col, y1, y)
        f = torch.where(acc_col, f1, f)
        nfe = nfe + active.to(torch.int32) * new_evals
        naccept = naccept + accept.to(torch.int32)
        nreject = nreject + (active & ~accept).to(torch.int32)
        done = done | reached

    sol = DenseSolution(t0s=t0s, dts=dts, coeffs=coeffs, naccept=naccept,
                        direction=direction, t_span=span)
    stats = SolveStats(nfe=nfe, naccept=naccept, nreject=nreject,
                       success=done)

    def y_at(t):
        flat = sol.evaluate_flat(t)
        if torch.as_tensor(t).ndim == 0:
            return unravel(flat[0])
        return unravel(flat)

    y_at.__wrapped_sol__ = sol
    return y_at, stats
