"""One attempt of an embedded explicit Runge–Kutta step, and the error norm's
pieces that the fused step's plain version shares with the solver.

The solver (``solver/runge_kutta.py``, its dense, event and Adams relatives)
and the fused dopri5 step (``kernels/rk_step.py``, the CPU side of the
operator ``nodef::dopri5_step``) both run :func:`_rk_attempt`, so the plain
step gives the bits of the solver's own attempt.  The module imports only
numpy, torch and ``tableau.py``: an exported program loads with the kernels'
operators and no solver module (``export_model run``).
"""

from __future__ import annotations

import numpy as np
import torch

from .tableau import ButcherTableau

__all__ = ["tableau_scalars", "tableau_floats"]


def _tiny(dtype: torch.dtype) -> float:
    return torch.finfo(dtype).tiny


def _rms(x: torch.Tensor) -> torch.Tensor:
    """Root-mean-square over the state axis: (B, N) → (B,); the ``tiny``
    inside the sqrt matches the JAX solver (value-neutral)."""
    return torch.sqrt(torch.mean(x * x, dim=-1) + _tiny(x.dtype))


def _tol_column(tol, batch: int, dtype, device):
    """A tolerance as the solver uses it: a float as it is; a tensor (one
    tolerance per row, ``(B,)``) as a ``(B, 1)`` column in the state's dtype
    that broadcasts against ``(B, N)``."""
    if not isinstance(tol, torch.Tensor):
        return float(tol)
    if tol.ndim == 0:
        tol = tol.expand(batch)
    if tuple(tol.shape) != (batch,):
        raise ValueError(f"a per-row tolerance must have shape ({batch},), "
                         f"got {tuple(tol.shape)}")
    return tol.to(device=device, dtype=dtype)[:, None]


def tableau_scalars(tableau: ButcherTableau, dtype,
                    device) -> dict[float, torch.Tensor]:
    """Every coefficient of ``tableau`` as a 0-d tensor on ``device``, keyed
    by its value: made once per solve (one copy to the device), so that an
    attempt copies nothing from the host and can be captured."""
    vals = sorted({float(v) for v in np.concatenate(
        [np.asarray(tableau.a).reshape(-1), tableau.b, tableau.b_err,
         tableau.c, [] if tableau.c_mid is None else tableau.c_mid])})
    dev_vals = torch.tensor(vals, dtype=dtype, device=device)
    if torch.compiler.is_compiling():  # a traced loop's inputs: no views
        return {v: dev_vals[i].clone() for i, v in enumerate(vals)}
    return {v: dev_vals[i] for i, v in enumerate(vals)}


def tableau_floats(tableau: ButcherTableau) -> tuple:
    """``(a rows, b, b_err, c, c_mid)`` of ``tableau`` as tuples of Python
    floats (row i of ``a`` up to the diagonal; ``c_mid`` None where absent):
    what an attempt reads, made before a traced loop, whose body may not
    compute with numpy."""
    a = np.asarray(tableau.a)
    row = lambda v: tuple(float(x) for x in v)  # noqa: E731
    return (tuple(row(a[i, :i]) for i in range(tableau.stages)),
            row(tableau.b), row(tableau.b_err), row(tableau.c),
            None if tableau.c_mid is None else row(tableau.c_mid))


def _rk_attempt(tableau: ButcherTableau, func, t0, dt, y0, f0,
                scalars: dict | None = None, floats: tuple | None = None):
    """One embedded-RK step attempt.  Returns ``(y1, err, f1, new_evals,
    y_mid)``; ``y_mid`` is None for tableaus without ``c_mid``.  Terms with
    a zero coefficient are skipped and the rest summed left to right, as in
    JAX, so both packages round alike.  ``scalars``: the tableau on the
    device (:func:`tableau_scalars`), ``floats``: its
    :func:`tableau_floats`; each made here if None."""
    if scalars is None:
        scalars = tableau_scalars(tableau, y0.dtype, y0.device)
    tab_a, tab_b, tab_e, tab_c, tab_mid = floats or tableau_floats(tableau)
    dt_col = dt[:, None]

    def combo(coeffs, ks):
        acc = None
        for coef, k in zip(coeffs, ks):
            if coef == 0.0:
                continue
            term = scalars[coef] * k
            acc = term if acc is None else acc + term
        return acc

    ks = [f0]
    for i in range(1, tableau.stages):
        acc = combo(tab_a[i], ks)
        yi = y0 if acc is None else y0 + dt_col * acc
        ks.append(func(t0 + scalars[tab_c[i]] * dt, yi))

    y1 = y0 + dt_col * combo(tab_b, ks)
    err = dt_col * combo(tab_e, ks)
    if not tableau.fsal:  # pragma: no cover - all shipped tableaus are FSAL
        raise NotImplementedError("non-FSAL tableaus")
    y_mid = None if tab_mid is None else y0 + dt_col * combo(tab_mid, ks)
    return y1, err, ks[-1], tableau.stages - 1, y_mid
