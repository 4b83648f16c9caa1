"""Adaptive explicit Runge–Kutta integration with per-sample error control
(port of ``neural_ode_features_tpu/solver/runge_kutta.py``).

Loop design.  The JAX solve is one ``lax.while_loop`` resident on the
device.  Here the loop over step attempts runs on the host: each attempt
launches the stage work (or one fused-step kernel) and then reads
``done.all()``, which costs one device→host sync per attempt (about five
per solve at tol 1e-3).  The stopping rule is the JAX cond exactly: stop
when every sample is done or after ``max_steps`` attempts.  Capturing the
attempt loop in a CUDA graph is later work (ROADMAP.md).

The per-sample carry ``(t, dt, done)`` and the masked state update are the
JAX ones: finished samples are frozen with ``torch.where`` while stragglers
keep stepping.  The dense-output write, gated by ``lax.cond`` in JAX, is an
unconditional masked ``torch.where`` here: same values, no extra sync.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .tableau import CUBIC_FIT, QUARTIC_FIT, ButcherTableau

__all__ = ["SolveStats", "adaptive_odeint"]


class SolveStats(NamedTuple):
    """Per-sample solver accounting."""

    nfe: torch.Tensor  # (B,) int32 — dynamics evaluations per sample
    naccept: torch.Tensor  # (B,) int32 — accepted steps
    nreject: torch.Tensor  # (B,) int32 — rejected steps
    success: torch.Tensor  # (B,) bool — reached ts[-1] within max_steps


def _tiny(dtype: torch.dtype) -> float:
    return torch.finfo(dtype).tiny


def _rms(x: torch.Tensor) -> torch.Tensor:
    """Root-mean-square over the state axis: (B, N) → (B,); the ``tiny``
    inside the sqrt matches the JAX solver (value-neutral)."""
    return torch.sqrt(torch.mean(x * x, dim=-1) + _tiny(x.dtype))


def _error_ratio(err, y0, y1, rtol, atol):
    """Mixed-tolerance error norm: RMS of err scaled by
    ``atol + rtol * max(|y0|, |y1|)``, one ratio per sample row."""
    scale = atol + rtol * torch.maximum(y0.abs(), y1.abs())
    # atol=0 with exactly-zero state entries gives scale=0: err 0 there means
    # a perfectly-resolved component (ratio 0), not 0/0 = NaN → reject-forever.
    pos = scale > 0.0
    r = torch.where(
        pos,
        err / torch.where(pos, scale, torch.ones_like(scale)),
        torch.where(err == 0.0, torch.zeros_like(err),
                    torch.full_like(err, float("inf"))),
    )
    ratio = _rms(r)
    return torch.where(torch.isfinite(ratio), ratio,
                       torch.full_like(ratio, float("inf")))


def _optimal_dt(dt, ratio, accept, order, safety, ifactor, dfactor):
    """I (integral) controller: grow only on accept (≤ ``ifactor``), shrink
    only on reject (≥ ``dfactor``)."""
    ratio = torch.clamp(ratio, min=_tiny(dt.dtype))
    factor = safety * ratio ** (-1.0 / order)
    factor = torch.where(accept, torch.clamp(factor, 1.0, ifactor),
                         torch.clamp(factor, dfactor, 1.0))
    return dt * factor


# PI exponent pair (see the JAX module for how they were chosen).
_PI_BETA1 = 1.0
_PI_BETA2 = 0.1


def _optimal_dt_pi(dt, ratio, rprev, accept, order, safety, ifactor,
                   dfactor):
    """PI controller: ``safety · ratio^(-β1/k) · rprev^(+β2/k)`` on accept,
    the pure-I shrink on reject."""
    ratio = torch.clamp(ratio, min=_tiny(dt.dtype))
    k = float(order)
    fac_pi = safety * ratio ** (-_PI_BETA1 / k) * rprev ** (_PI_BETA2 / k)
    fac_i = safety * ratio ** (-1.0 / k)
    factor = torch.where(accept, torch.clamp(fac_pi, dfactor, ifactor),
                         torch.clamp(fac_i, dfactor, 1.0))
    return dt * factor


def _select_initial_step(func, t0, y0, f0, direction, rtol, atol, order):
    """Hairer, Nørsett & Wanner II.4 automatic initial step, per sample.
    Costs one extra dynamics evaluation."""
    scale = atol + rtol * y0.abs()
    d0 = _rms(y0 / scale)
    d1 = _rms(f0 / scale)
    small = (d0 < 1e-5) | (d1 < 1e-5)
    h0 = torch.where(small, torch.full_like(d0, 1e-6),
                     0.01 * d0 / torch.clamp(d1, min=1e-30))

    y1 = y0 + (h0 * direction)[:, None] * f0
    f1 = func(t0 + h0 * direction, y1)
    d2 = _rms((f1 - f0) / scale) / h0

    d_max = torch.maximum(d1, d2)
    h1 = torch.where(
        d_max <= 1e-15,
        torch.clamp(h0 * 1e-3, min=1e-6),
        (0.01 / d_max) ** (1.0 / (order + 1)),
    )
    return torch.minimum(100.0 * h0, h1) * direction


def _dense_write(fit, parts, ts, t0, t1, dt, direction, accept, out):
    """Fit the dense-output polynomial on this attempt and write every
    requested output time an *accepted* step covers (coverage tested in
    t-space, coordinate clamped to [0, 1], as in JAX).

    ``fit``: (D+1, D+1) collocation matrix; ``parts``: the D+1 (B, N) data
    components (y0, y1[, y_mid], dt·f0, dt·f1); ``out``: (T-1, B, N) for
    ``ts[1:]``.  The polynomial weights are per-sample scalars
    ``g_d(x) = Σ_c fit[c, d] x^c`` computed with elementwise f32 products
    (no matmul, so no TF32 on the card)."""
    ts_tail = ts[1:]
    covered = (
        accept[None, :]
        & (direction * (ts_tail[:, None] - t0[None, :]) > 0.0)
        & (direction * (ts_tail[:, None] - t1[None, :]) <= 0.0)
    )
    x = torch.clamp((ts_tail[:, None] - t0[None, :]) / dt[None, :], 0.0, 1.0)
    d1 = fit.shape[0]
    xp = torch.stack([x ** c for c in range(d1)])  # (D+1, T-1, B)
    g = (fit[:, :, None, None] * xp[:, None]).sum(dim=0)  # (D+1, T-1, B)
    vals = sum(g[d][:, :, None] * parts[d][None] for d in range(d1))
    return torch.where(covered[:, :, None], vals, out)


def _rk_attempt(tableau: ButcherTableau, func, t0, dt, y0, f0):
    """One embedded-RK step attempt.  Returns ``(y1, err, f1, new_evals,
    y_mid)``; ``y_mid`` is None for tableaus without ``c_mid``.  Terms with
    a zero coefficient are skipped and the rest summed left to right, as in
    JAX, so both packages round alike."""
    dtype = y0.dtype
    dt_col = dt[:, None]
    tab_a = np.asarray(tableau.a)

    def combo(coeffs, ks):
        acc = None
        for coef, k in zip(coeffs, ks):
            if float(coef) == 0.0:
                continue
            term = torch.tensor(float(coef), dtype=dtype, device=y0.device) * k
            acc = term if acc is None else acc + term
        return acc

    ks = [f0]
    for i in range(1, tableau.stages):
        acc = combo(tab_a[i, :i], ks)
        yi = y0 if acc is None else y0 + dt_col * acc
        ci = torch.tensor(float(tableau.c[i]), dtype=dtype, device=y0.device)
        ks.append(func(t0 + ci * dt, yi))

    y1 = y0 + dt_col * combo(tableau.b, ks)
    err = dt_col * combo(tableau.b_err, ks)
    if not tableau.fsal:  # pragma: no cover - all shipped tableaus are FSAL
        raise NotImplementedError("non-FSAL tableaus")
    y_mid = (None if tableau.c_mid is None
             else y0 + dt_col * combo(tableau.c_mid, ks))
    return y1, err, ks[-1], tableau.stages - 1, y_mid


def adaptive_odeint(
    func: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    y0: torch.Tensor,
    ts: torch.Tensor,
    rtol: float,
    atol: float,
    tableau: ButcherTableau,
    *,
    max_steps: int = 2**14,
    first_step: float | None = None,
    safety: float = 0.9,
    ifactor: float = 10.0,
    dfactor: float = 0.2,
    fused_step: Callable | None = None,
    controller: str = "i",
) -> tuple[torch.Tensor, SolveStats]:
    """Integrate ``dy/dt = func(t, y)`` over the monotonic grid ``ts``.

    Args:
      func: ``(t (B,), y (B, N)) -> (B, N)``.
      y0: (B, N) initial state, floating point.
      ts: (T,) strictly monotonic output times, T >= 2.
      rtol/atol: mixed tolerances for the per-sample error norm.
      tableau: embedded RK tableau (dopri5/bosh3/fehlberg2/tsit5).
      max_steps: bound on loop iterations (accept + reject attempts).
      first_step: optional fixed initial step (unsigned); default Hairer.
      fused_step: optional ``(t0 (B,), dt (B,), y0 (B,N), f0 (B,N)) ->
        (y1, f1, y_mid, ratio)`` replacing ``_rk_attempt`` + the error norm
        (``kernels/rk_step.py``).  Requires a quartic-dense FSAL tableau.
      controller: ``'i'`` (default, reference parity) or ``'pi'``.

    Returns:
      ys: (T, B, N) solution at ``ts`` (ys[0] ≡ y0).
      stats: per-sample :class:`SolveStats`.
    """
    if fused_step is not None and (tableau.c_mid is None or not tableau.fsal):
        raise ValueError("fused_step requires a quartic-dense FSAL tableau")
    if controller not in ("i", "pi"):
        raise ValueError(f"unknown controller {controller!r}; 'i' | 'pi'")
    dtype, dev = y0.dtype, y0.device
    batch, n = y0.shape
    ts = ts.to(device=dev, dtype=dtype)

    quartic = tableau.c_mid is not None
    fit = torch.tensor(QUARTIC_FIT if quartic else CUBIC_FIT, dtype=dtype,
                       device=dev)
    direction = torch.sign(ts[-1] - ts[0])
    t_final = ts[-1]

    t = torch.full((batch,), float(ts[0]), dtype=dtype, device=dev)
    f = func(t, y0)
    nfe = torch.ones((batch,), dtype=torch.int32, device=dev)
    if first_step is None:
        dt = _select_initial_step(func, t, y0, f, direction, rtol, atol,
                                  tableau.order - 1)
        nfe = nfe + 1
    else:
        dt = torch.full((batch,), float(first_step), dtype=dtype,
                        device=dev) * direction

    y = y0
    out = torch.zeros((ts.shape[0] - 1, batch, n), dtype=dtype, device=dev)
    naccept = torch.zeros((batch,), dtype=torch.int32, device=dev)
    nreject = torch.zeros_like(naccept)
    done = torch.zeros((batch,), dtype=torch.bool, device=dev)
    rprev = torch.ones((batch,), dtype=dtype, device=dev)
    inf = torch.full((batch,), float("inf"), dtype=dtype, device=dev)

    for _ in range(max_steps):
        if bool(done.all()):  # the one host sync per attempt
            break
        active = ~done
        if fused_step is not None:
            y1, f1, y_mid, ratio = fused_step(t, dt, y, f)
            new_evals = tableau.stages - 1
            ratio = torch.where(torch.isfinite(ratio), ratio, inf)
        else:
            y1, err, f1, new_evals, y_mid = _rk_attempt(tableau, func, t, dt,
                                                       y, f)
            ratio = _error_ratio(err, y, y1, rtol, atol)
        accept = (ratio <= 1.0) & active
        t1 = t + dt

        dt_col = dt[:, None]
        parts = ((y, y1, y_mid, dt_col * f, dt_col * f1) if quartic
                 else (y, y1, dt_col * f, dt_col * f1))
        out = _dense_write(fit, parts, ts, t, t1, dt, direction, accept, out)

        if controller == "pi":
            proposed = _optimal_dt_pi(dt, ratio, rprev, accept,
                                      tableau.order, safety, ifactor, dfactor)
            rprev = torch.where(accept & active,
                                torch.clamp(ratio, min=1e-4), rprev)
        else:
            proposed = _optimal_dt(dt, ratio, accept, tableau.order, safety,
                                   ifactor, dfactor)
        reached = accept & (direction * (t1 - t_final) >= 0.0)
        acc_col = accept[:, None]

        t = torch.where(accept, t1, t)
        dt = torch.where(active, proposed, dt)
        y = torch.where(acc_col, y1, y)
        f = torch.where(acc_col, f1, f)
        nfe = nfe + active.to(torch.int32) * new_evals
        naccept = naccept + accept.to(torch.int32)
        nreject = nreject + (active & ~accept).to(torch.int32)
        done = done | reached

    stats = SolveStats(nfe=nfe, naccept=naccept, nreject=nreject,
                       success=done)
    return torch.cat([y0[None], out], dim=0), stats
