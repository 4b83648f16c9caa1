"""Fixed-grid ODE steppers (port of
``neural_ode_features_tpu/solver/fixed_grid.py``): ``euler``, ``midpoint``,
``heun2``, ``rk4`` and the ``fixed_adams`` predictor–corrector.

The JAX loops are ``lax.scan``s; here they are Python loops over the grid,
and every operation is a differentiable tensor operation, so plain autograd
through a solve is the direct-backprop oracle the adjoint's gradient tests
compare against.  The trip count is fixed by ``ts`` and
``steps_per_interval``: no host sync happens inside a solve.

Each interval ``[ts[i], ts[i+1]]`` is subdivided into ``steps_per_interval``
equal substeps (default 1).
"""

from __future__ import annotations

from typing import Callable

import torch

from .runge_kutta import SolveStats

__all__ = ["fixed_grid_odeint", "FIXED_GRID_METHODS"]


def _euler_step(func, t0, dt, y0):
    return y0 + dt[:, None] * func(t0, y0), 1


def _midpoint_step(func, t0, dt, y0):
    half = 0.5 * dt
    k1 = func(t0, y0)
    k2 = func(t0 + half, y0 + half[:, None] * k1)
    return y0 + dt[:, None] * k2, 2


def _heun2_step(func, t0, dt, y0):
    k1 = func(t0, y0)
    k2 = func(t0 + dt, y0 + dt[:, None] * k1)
    return y0 + dt[:, None] * 0.5 * (k1 + k2), 2


def _rk4_step(func, t0, dt, y0):
    dt_c = dt[:, None]
    half = 0.5 * dt
    k1 = func(t0, y0)
    k2 = func(t0 + half, y0 + half[:, None] * k1)
    k3 = func(t0 + half, y0 + half[:, None] * k2)
    k4 = func(t0 + dt, y0 + dt_c * k3)
    return y0 + dt_c / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4), 4


_STEPPERS: dict[str, Callable] = {
    "euler": _euler_step,
    "midpoint": _midpoint_step,
    "heun2": _heun2_step,
    "rk4": _rk4_step,
}

# Adams–Bashforth-4 predictor / Adams–Moulton-3 corrector coefficients
# (uniform grid).
_AB4 = (55.0 / 24.0, -59.0 / 24.0, 37.0 / 24.0, -9.0 / 24.0)
_AM3 = (9.0 / 24.0, 19.0 / 24.0, -5.0 / 24.0, 1.0 / 24.0)


def _stats(batch: int, nfe: int, n_steps: int, dev) -> SolveStats:
    return SolveStats(
        nfe=torch.full((batch,), nfe, dtype=torch.int32, device=dev),
        naccept=torch.full((batch,), n_steps, dtype=torch.int32, device=dev),
        nreject=torch.zeros((batch,), dtype=torch.int32, device=dev),
        success=torch.ones((batch,), dtype=torch.bool, device=dev))


def _fixed_adams_odeint(func, y0, ts, steps_per_interval):
    """4th-order Adams–Bashforth–Moulton predictor–corrector (PECE) on the
    uniformly subdivided grid, RK4-bootstrapped for the first three steps.
    Assumes ``ts`` is uniformly spaced (``odeint`` checks)."""
    batch, n_out = y0.shape[0], ts.shape[0]
    dtype, dev = y0.dtype, y0.device
    spi = steps_per_interval

    # The full substep grid: ((n_out-1)*spi + 1,) times.
    frac = torch.arange(spi, dtype=dtype, device=dev) / spi
    grid = (ts[:-1, None] + (ts[1:] - ts[:-1])[:, None] * frac[None, :]
            ).reshape(-1)
    grid = torch.cat([grid, ts[-1:]])
    n_steps = grid.shape[0] - 1
    hb = (grid[1] - grid[0]).expand(batch)

    def at(i):
        return grid[i].expand(batch)

    # Bootstrap: 3 RK4 steps fill the f-history.
    ys = [y0]
    fs = [func(at(0), y0)]
    nfe = 1
    y = y0
    for i in range(min(3, n_steps)):
        y, ev = _rk4_step(func, at(i), hb, y)
        nfe += ev + 1
        ys.append(y)
        fs.append(func(at(i + 1), y))

    if n_steps > 3:
        h_c = hb[:, None]
        f0, f1, f2, f3 = fs  # f3 newest
        for i in range(4, n_steps + 1):
            y_pred = y + h_c * (
                _AB4[0] * f3 + _AB4[1] * f2 + _AB4[2] * f1 + _AB4[3] * f0)
            f_pred = func(at(i), y_pred)
            y = y + h_c * (
                _AM3[0] * f_pred + _AM3[1] * f3 + _AM3[2] * f2 + _AM3[3] * f1)
            f0, f1, f2, f3 = f1, f2, f3, func(at(i), y)
            ys.append(y)
        nfe += 2 * (n_steps - 3)

    # The requested output times out of the substep grid.
    idx = [i * spi for i in range(n_out)]
    idx[-1] = len(ys) - 1
    return (torch.stack([ys[i] for i in idx]),
            _stats(batch, nfe, n_steps, dev))


def fixed_grid_odeint(
    func: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    y0: torch.Tensor,
    ts: torch.Tensor,
    method: str,
    *,
    steps_per_interval: int = 1,
) -> tuple[torch.Tensor, SolveStats]:
    """Integrate on the grid ``ts`` with a fixed-step method.

    Args and returns as :func:`..runge_kutta.adaptive_odeint` (flat
    ``(B, N)`` state), minus tolerances."""
    ts = ts.to(device=y0.device, dtype=y0.dtype)
    if method == "fixed_adams":
        return _fixed_adams_odeint(func, y0, ts, steps_per_interval)
    step = _STEPPERS[method]
    batch = y0.shape[0]
    evals = 0
    y = y0
    out = [y0]
    for i in range(ts.shape[0] - 1):
        t_a = ts[i].expand(batch)
        hb = ((ts[i + 1] - ts[i]) / steps_per_interval).expand(batch)
        for k in range(steps_per_interval):
            y, evals = step(func, t_a + float(k) * hb, hb, y)
        out.append(y)
    n_steps = (ts.shape[0] - 1) * steps_per_interval
    return torch.stack(out), _stats(batch, evals * n_steps, n_steps,
                                    y0.device)


FIXED_GRID_METHODS = tuple(_STEPPERS) + ("fixed_adams",)
