"""Adaptive-step, adaptive-order Adams–Bashforth–Moulton (PECE) multistep
solver (port of ``neural_ode_features_tpu/solver/adams.py``).

The method is the JAX one, operation for operation:

  * predictor (AB) and corrector (AM) with variable coefficients computed at
    run time from the real, non-uniform history node positions: the weights
    are the exact integrals of the Lagrange basis over the step, solved by
    the Björck–Pereyra recurrences (``_bp_dual``), which stay f32-stable at
    order 8 to 12 where a generic LU solve of the Vandermonde system does not;
  * the order ramps from 1 up to ``max_order`` (default 8, cap 12) and is
    chosen per sample after every attempt from the Milne error ratios at
    orders k−1, k and k+1; on a rejection it may only step down;
  * two dynamics evaluations per attempt (predict, correct), the
    predictor–corrector difference as the error estimate, per-sample step
    control and NFE accounting as the RK path;
  * order-matched dense output: an output time inside an accepted step is
    evaluated with the corrector's own Lagrange interpolant.

Loop design.  One attempt is ``attempt(carry) -> (carry, dense-write
inputs)`` and makes no host read.  ``unroll='while'`` (default) runs it in a
host loop with one device→host sync per attempt.  The JAX body gates its
dense write on ``lax.cond(any(covered))``; here that flag is read in the same
sync as ``done.all()``, one attempt late: an attempt keeps what its dense
write needs, and the next attempt's sync (or the one after the loop) says
whether to write it.  Each output time is covered by one accepted step per
sample, so the values are the JAX ones.  ``'scan'`` and ``'scan_remat'``
(JAX's) run exactly ``max_steps`` attempts with no host read, each writing
its dense output under ``torch.where``; ``'scan_remat'`` recomputes each
attempt in the backward (``torch.utils.checkpoint``).  The same values:
a done row no longer changes.  History columns not yet filled get distinct
dummy node positions, so that no Vandermonde system is singular and no NaN
reaches a scan-mode gradient (JAX ``tests/test_adams.py``).

The weight recurrences, the predictor/corrector combines and the dense-output
contraction are solver-side contractions, all elementwise (no matmul, so
TF32 cannot touch them on the card).  The combines and ``y + dt·Σ`` are
chains of fused multiply-adds in node order (``addcmul``), which is how
XLA's CPU dot evaluates the JAX einsum, so that the two packages round
alike: in the first steps of the order ramp the predictor and the corrector
differ by about 1e-12 of the state, and the Milne ratios that choose the
order are rounding.  The history of f is a list of ``max_order`` (B, N)
tensors, shifted by masked selects.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..rk_attempt import _tol_column
from .runge_kutta import (
    RankNorm,
    SolveStats,
    _error_ratio,
    _optimal_dt,
    _select_initial_step,
    check_unroll,
)

__all__ = ["adams_odeint"]

_MAX_ORDER_CAP = 12  # the reference's VCABM ceiling


def _bp_dual(xs: list, bs: list) -> list:
    """Solve the dual Vandermonde system Σ_i w_i x_i^j = b_j, j = 0..k-1, by
    the Björck–Pereyra recurrences (Golub & Van Loan alg. 4.6.2).

    ``xs``: k node columns (B,); ``bs``: k moment columns, (B,) or (B, T).
    Returns the k weight columns, shaped like ``bs``.  The JAX loops, in the
    same order."""
    k = len(xs)
    bs = list(bs)
    trailing = bs[0].ndim == 2

    def col(v):  # an x column against b's trailing axis
        return v[:, None] if trailing else v

    for m in range(k - 1):
        for j in range(k - 1, m, -1):
            bs[j] = bs[j] - col(xs[m]) * bs[j - 1]
    for m in range(k - 2, -1, -1):
        for j in range(m + 1, k):
            bs[j] = bs[j] / col(xs[j] - xs[j - m - 1])
        for j in range(m, k - 1):
            bs[j] = bs[j] - bs[j + 1]
    return bs


def _integration_weights(s: torch.Tensor, k: int) -> list:
    """Exact ∫₀¹ of the Lagrange interpolant through the nodes at normalised
    positions ``s[:, :k]`` (moments 1/(j+1)): k weight columns (B,)."""
    if k == 1:
        return [torch.ones_like(s[:, 0])]
    xs = [s[:, j] for j in range(k)]
    bs = [torch.full_like(xs[0], 1.0 / (j + 1)) for j in range(k)]
    return _bp_dual(xs, bs)


def _partial_integration_weights(s: torch.Tensor, k: int,
                                 x: torch.Tensor) -> list:
    """∫₀ˣ of the Lagrange interpolant for several upper limits at once
    (moments x^{j+1}/(j+1)): ``x`` (T, B) → k weight columns (B, T)."""
    x_t = x.T  # (B, T)
    xs = [s[:, j] for j in range(k)]
    bs = [x_t ** (j + 1) / (j + 1) for j in range(k)]
    return _bp_dual(xs, bs)


def _combine(weights: list, fs: list) -> torch.Tensor:
    """Σ_i w_i f_i over the nodes of ``weights``: k columns (B,) against
    the (B, N) history, elementwise, as a chain of fused multiply-adds in
    node order (``addcmul``), which is how XLA evaluates the JAX einsum."""
    acc = weights[0][:, None] * fs[0]
    for w, f in zip(weights[1:], fs[1:]):
        acc = torch.addcmul(acc, w[:, None], f)
    return acc


def adams_odeint(
    func: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    y0: torch.Tensor,
    ts: torch.Tensor,
    rtol,
    atol,
    *,
    max_steps: int = 2**14,
    first_step: float | None = None,
    safety: float = 0.9,
    ifactor: float = 2.0,  # conservative growth for multistep stability
    dfactor: float = 0.2,
    unroll: str = "while",
    error_mask: torch.Tensor | None = None,
    max_order: int = 8,
    batch_sum: Callable | None = None,
    shared: torch.Tensor | None = None,
) -> tuple[torch.Tensor, SolveStats]:
    """Adaptive ABM solve of ``dy/dt = func(t, y)`` over the monotonic grid
    ``ts``; the contract of :func:`.runge_kutta.adaptive_odeint` (``rtol``,
    ``atol``: floats or ``(B,)`` tensors; ``error_mask``: seminorm control;
    ``batch_sum``, ``shared``: the norm spans ranks, :class:`RankNorm`;
    ``unroll``: ``'while'``, a host loop here, or ``'scan'``/
    ``'scan_remat'``).  ``max_order`` caps the order ramp (2..12).  Returns
    ``((T, B, N), SolveStats)``."""
    if not 2 <= max_order <= _MAX_ORDER_CAP:
        raise ValueError(
            f"max_order must be in [2, {_MAX_ORDER_CAP}], got {max_order}")
    check_unroll(unroll)
    kk = max_order
    dtype, dev = y0.dtype, y0.device
    batch, n = y0.shape
    ts = ts.to(device=dev, dtype=dtype)
    rtol = _tol_column(rtol, batch, dtype, dev)
    atol = _tol_column(atol, batch, dtype, dev)
    mask = None
    if error_mask is not None:
        mask = torch.as_tensor(error_mask, device=dev).expand(batch, n) > 0
    norm = (None if batch_sum is None
            else RankNorm(batch_sum, shared, mask, n, dev))
    direction = torch.sign(ts[-1] - ts[0])
    t_final = ts[-1]
    ts_tail = ts[1:]

    t = ts[0].expand(batch).contiguous()  # no read on the host
    f0 = func(t, y0)
    nfe = torch.ones((batch,), dtype=torch.int32, device=dev)
    if first_step is None:
        # The ramp starts at order 1: size the Hairer step for that, not for
        # the steady-state order (no start-up rejections).
        dt = _select_initial_step(func, t, y0, f0, direction, rtol, atol, 1,
                                  norm)
        nfe = nfe + 1
    else:
        dt = torch.full((batch,), float(first_step), dtype=dtype,
                        device=dev) * direction

    col = torch.arange(kk, device=dev)[None, :]
    m_idx = torch.arange(1, kk + 1, device=dev)[:, None]
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    ones = torch.ones((batch, 1), dtype=dtype, device=dev)

    def dense_write(out, y, t, dt, s_corr, f_nodes, k_corr, covered):
        """The order-matched Lagrange dense output on [t, t + dt], written
        where ``covered``: y + dt·Σ_i w_i(x) f_i over the corrector's nodes
        at each sample's corrector order."""
        x = torch.clamp((ts_tail[:, None] - t[None, :]) / dt[None, :], 0.0,
                        1.0)  # (T-1, B)
        y_int = None
        for k in range(2, kk + 1):
            w_x = _partial_integration_weights(s_corr, k, x)  # k × (B, T-1)
            acc = w_x[0].T[:, :, None] * f_nodes[0][None]
            for w, f in zip(w_x[1:k], f_nodes[1:k]):
                acc = torch.addcmul(acc, w.T[:, :, None], f[None])
            cand = torch.addcmul(y[None], dt[None, :, None], acc)
            y_int = cand if y_int is None else torch.where(
                (k_corr >= k)[None, :, None], cand, y_int)
        return torch.where(covered[:, :, None], y_int, out)

    def attempt(c):
        """One attempt from the carry ``c`` = ``(t, dt, y, hist_t, nhist,
        order, nfe, naccept, nreject, done, *hist_f)`` (history newest
        first): the next carry and this attempt's dense-write inputs."""
        (t, dt, y, hist_t, nhist, order, nfe, naccept, nreject, done,
         *hist_f) = c
        active = ~done
        dt_col = dt[:, None]
        t1 = t + dt

        # Normalised history positions s_i = (hist_t_i - t) / dt (<= 0); a
        # column without history gets a distinct dummy position, so that no
        # Vandermonde system is singular (its weights are never selected).
        s_raw = (hist_t - t[:, None]) / dt_col
        s_hist = torch.where(col < nhist[:, None], s_raw,
                             -(col.to(dtype) + 1.0))

        # Predict: AB-k at each sample's working order (<= its history).
        k_pred = torch.minimum(order, torch.clamp(nhist, max=kk))
        pred = [None] * (kk + 1)
        for k in range(1, kk + 1):
            w = _integration_weights(s_hist, k)
            pred[k] = torch.addcmul(y, dt_col, _combine(w, hist_f[:k]))
        y_pred = pred[1]
        for k in range(2, kk + 1):
            y_pred = torch.where((k_pred >= k)[:, None], pred[k], y_pred)

        f_pred = func(t1, y_pred)

        # Correct: AM over {t1} and the k-1 newest history nodes.
        s_corr = torch.cat([ones, s_hist[:, :kk - 1]], dim=1)
        f_nodes = [f_pred] + hist_f[:kk - 1]
        k_corr = torch.clamp(k_pred + 1, max=kk)
        corr = [None] * (kk + 1)
        for k in range(2, kk + 1):
            w = _integration_weights(s_corr, k)
            corr[k] = torch.addcmul(y, dt_col, _combine(w, f_nodes[:k]))
        y_corr = corr[2]
        for k in range(3, kk + 1):
            y_corr = torch.where((k_corr >= k)[:, None], corr[k], y_corr)

        f_new = func(t1, y_corr)

        # Milne error ratios at every order (the per-order predictors and
        # correctors are there already): ratio_all[m-1] at predictor order m.
        errs = [corr[min(m + 1, kk)] - pred[m] for m in range(1, kk + 1)]
        ratio_all = (torch.stack([_error_ratio(e, y, y_corr, rtol, atol, mask)
                                  for e in errs]) if norm is None
                     else norm.error_ratio(torch.stack(errs), y, y_corr,
                                           rtol, atol))  # (K, B)
        max_valid = torch.clamp(nhist, max=kk)  # orders with real history
        ratio_all = torch.where(m_idx <= max_valid[None, :], ratio_all, inf)

        def take_order(o):  # the ratio at per-sample order o: (B,)
            return ratio_all.gather(0, (o - 1).long()[None, :])[0]

        ratio = take_order(k_pred)
        accept = (ratio <= 1.0) & active

        # Order update: toward whichever of {k-1, k, k+1} has the smallest
        # Milne ratio; on a rejection only down.
        k_lo = torch.clamp(k_pred - 1, min=1)
        k_hi = torch.clamp(k_pred + 1, max=kk)
        r_lo, r_cur, r_hi = take_order(k_lo), ratio, take_order(k_hi)
        best = torch.where((r_hi < r_cur) & (r_hi <= r_lo), k_hi,
                           torch.where(r_lo < r_cur, k_lo, k_pred))
        new_order = torch.where(accept, best, torch.minimum(best, order))

        # The controller's exponent: the predictor's local error order, k+1.
        order_f = (k_pred + 1).to(dtype)
        new_dt = torch.where(
            active, _optimal_dt(dt, ratio, accept, order_f, safety, ifactor,
                                dfactor), dt)

        covered = (accept[None, :]
                   & (direction * (ts_tail[:, None] - t[None, :]) > 0.0)
                   & (direction * (ts_tail[:, None] - t1[None, :]) <= 0.0))
        pending = (y, t, dt, s_corr, f_nodes, k_corr, covered)

        # Masked history shift on accept.
        acc_col = accept[:, None]
        hist_t = torch.where(
            acc_col, torch.cat([t1[:, None], hist_t[:, :kk - 1]], dim=1),
            hist_t)
        hist_f = [torch.where(acc_col, new, old) for new, old in
                  zip([f_new] + hist_f[:kk - 1], hist_f)]
        reached = accept & (direction * (t1 - t_final) >= 0.0)

        carry = (torch.where(accept, t1, t), new_dt,
                 torch.where(acc_col, y_corr, y), hist_t,
                 torch.where(accept, torch.clamp(nhist + 1, max=kk), nhist),
                 new_order, nfe + 2 * active.to(torch.int32),
                 naccept + accept.to(torch.int32),
                 nreject + (active & ~accept).to(torch.int32),
                 done | reached, *hist_f)
        return carry, pending

    nhist = torch.ones((batch,), dtype=torch.int32, device=dev)
    carry = (t, dt, y0, t[:, None].expand(batch, kk).clone(), nhist,
             torch.ones_like(nhist), nfe, torch.zeros_like(nhist),
             torch.zeros_like(nhist),
             torch.zeros((batch,), dtype=torch.bool, device=dev),
             *([f0] * kk))
    out = torch.zeros((ts.shape[0] - 1, batch, n), dtype=dtype, device=dev)

    if unroll == "while":
        pending = None  # the last attempt's dense-write inputs
        for _ in range(max_steps):
            # The one host sync per attempt: are all samples done, and did
            # the last attempt cover an output time?
            if pending is None:
                finished = bool(carry[9].all())
            else:
                finished, write = torch.stack(
                    [carry[9].all(), pending[-1].any()]).tolist()
                if write:
                    out = dense_write(out, *pending)
                pending = None
            if finished:
                break
            carry, pending = attempt(carry)
        if pending is not None and bool(pending[-1].any()):  # max_steps ran out
            out = dense_write(out, *pending)
    else:
        def scan_step(out, *c):
            c, pending = attempt(c)
            return (dense_write(out, *pending), *c)

        state = (out, *carry)
        for _ in range(max_steps):
            state = (scan_step(*state) if unroll == "scan"
                     else checkpoint(scan_step, *state, use_reentrant=False))
        out, *carry = state
    nfe, naccept, nreject, done = carry[6:10]
    stats = SolveStats(nfe=nfe, naccept=naccept, nreject=nreject,
                       success=done)
    return torch.cat([y0[None], out], dim=0), stats
