"""Adaptive explicit Runge–Kutta integration with per-sample error control
(port of ``neural_ode_features_tpu/solver/runge_kutta.py``).

Loop design, as in JAX: one attempt is ``body(carry) -> carry`` over a
:class:`_Carry` (t, dt, y, f, the dense output, the counters, done and the
PI controller's last ratio), and makes no host read.  ``unroll`` picks the
loop around it:

  * ``'while'`` (default): stop when every sample is done or after
    ``max_steps`` attempts (the JAX cond).  On a CPU tensor, and wherever
    autograd records the attempts or the norm spans ranks (``batch_sum``),
    this is a host loop that reads ``done.all()`` once per attempt.  On a
    CUDA tensor otherwise, the first attempt runs eagerly and the rest
    replay it as one captured CUDA graph (``attempt_graph.py``): one launch
    and one read of ``done.all()`` per attempt in place of some fifty
    launches; a caller with fixed weights (``graph_key``) captures once per
    shape and replays every attempt of its later solves.  The routes give
    bit-identical results.  Under ``torch.export`` (or ``torch.compile``)
    the loop is PyTorch's ``while_loop``.
  * ``'scan'``: exactly ``max_steps`` attempts, no host read.  A done row
    no longer changes, so values and stats equal ``'while'``'s; the loop is
    reverse-differentiable.
  * ``'scan_remat'``: ``'scan'`` with each attempt under
    ``torch.utils.checkpoint`` (JAX ``jax.checkpoint``): the backward keeps
    the carry per attempt and recomputes the rest.

Finished samples are frozen with ``torch.where`` while stragglers keep
stepping, as in JAX.  The dense-output write, gated by ``lax.cond`` in JAX,
is an unconditional masked ``torch.where`` here: same values, no sync.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..rk_attempt import (
    _rk_attempt,
    _rms,
    _tiny,
    _tol_column,
    tableau_floats,
    tableau_scalars,
)
from ..tableau import CUBIC_FIT, QUARTIC_FIT, ButcherTableau

__all__ = ["SolveStats", "adaptive_odeint", "RankNorm"]

_UNROLLS = ("while", "scan", "scan_remat")


class SolveStats(NamedTuple):
    """Per-sample solver accounting."""

    nfe: torch.Tensor  # (B,) int32 — dynamics evaluations per sample
    naccept: torch.Tensor  # (B,) int32 — accepted steps
    nreject: torch.Tensor  # (B,) int32 — rejected steps
    success: torch.Tensor  # (B,) bool — reached ts[-1] within max_steps


class _Carry(NamedTuple):
    """What one attempt hands the next (JAX ``_Carry`` without ``iters``:
    the loops count attempts themselves)."""

    t: torch.Tensor  # (B,) current time
    dt: torch.Tensor  # (B,) signed proposed step
    y: torch.Tensor  # (B, N) current state
    f: torch.Tensor  # (B, N) dynamics at (t, y)  [FSAL]
    out: torch.Tensor  # (T-1, B, N) dense output at ts[1:] written so far
    nfe: torch.Tensor  # (B,) int32
    naccept: torch.Tensor  # (B,) int32
    nreject: torch.Tensor  # (B,) int32
    done: torch.Tensor  # (B,) bool
    rprev: torch.Tensor  # (B,) last accepted error ratio (PI controller)


def check_unroll(unroll: str) -> None:
    """Raise JAX's error for an unknown ``unroll`` mode."""
    if unroll not in _UNROLLS:
        raise ValueError(f"unknown unroll mode {unroll!r}")


def _host_loop(body, carry, max_steps: int):
    """The ``'while'`` loop on the host: one read of ``done.all()`` per
    attempt (the CPU's loop; on the card the loop that autograd can record,
    and the reference the graph route is held to)."""
    for _ in range(max_steps):
        if bool(carry.done.all()):
            break
        carry = body(carry)
    return carry


def _recording(carry) -> bool:
    """Whether autograd records an attempt on ``carry``."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in carry)


def _traced_loop(body, carry, max_steps: int):
    """``'while'`` under ``torch.compile`` or ``torch.export``: PyTorch's
    ``while_loop`` over the carry flattened to a tuple and an int32 attempt
    counter, with the JAX cond, ``(attempt < max_steps) & ~done.all()``; the
    body is functional (``inplace=False``) and reads nothing on the host."""
    from torch._higher_order_ops import while_loop

    done = _Carry._fields.index("done")

    def cond(attempt, *c):
        return (attempt < max_steps) & ~c[done].all()

    def step(attempt, *c):
        new = body(_Carry(*c))  # a field passed through is copied: no alias
        return (attempt + 1, *(n.clone() if n is o else n
                               for n, o in zip(new, c)))

    attempt = torch.zeros((), dtype=torch.int32, device=carry.done.device)
    return _Carry(*while_loop(cond, step, (attempt, *carry))[1:])


def _while_loop(body, carry, max_steps: int, capturable: bool, key=None):
    """``'while'``.  Under tracing, :func:`_traced_loop`.  Where
    ``capturable`` (a CUDA state, no cross-rank norm) and autograd records
    no attempt, the CUDA-graph route: with a cache ``key`` (from
    ``attempt_graph.cache_key``: fixed weights) every attempt of a solve the
    thread has seen replays its cached graph, and a new key runs its first
    attempt eagerly (the warm-up) and captures the next into the cache;
    without one, the first attempt runs eagerly and the others replay a
    graph captured for this solve alone.  Else the host loop."""
    if torch.compiler.is_compiling():
        return _traced_loop(body, carry, max_steps)
    if max_steps < 1 or bool(carry.done.all()):
        return carry
    from . import attempt_graph

    cache = capturable and key is not None and not _recording(carry)
    if cache:
        final = attempt_graph.replay_cached(carry, max_steps, key[0])
        if final is not None:
            return final
    carry = body(carry)
    if capturable and not _recording(carry):
        inplace = functools.partial(body, inplace=True)
        if cache:
            return attempt_graph.capture_cached(inplace, carry, max_steps - 1,
                                                *key)
        return attempt_graph.replay_attempts(inplace, carry, max_steps - 1)
    return _host_loop(body, carry, max_steps - 1)


def _scan_loop(body, carry, max_steps: int, remat: bool):
    """``'scan'``/``'scan_remat'``: exactly ``max_steps`` attempts."""
    def remat_body(c):
        return type(c)(*checkpoint(lambda *xs: tuple(body(type(c)(*xs))), *c,
                                   use_reentrant=False))

    step = remat_body if remat else body
    for _ in range(max_steps):
        carry = step(carry)
    return carry


def _by_value(x):
    """A tolerance (a float or a column) or ``ts`` as a hashable value."""
    if isinstance(x, torch.Tensor):
        return (x.dtype, tuple(x.shape), tuple(x.reshape(-1).tolist()))
    return x


def _scaled_error(err, y0, y1, rtol, atol):
    """err / (atol + rtol · max(|y0|, |y1|)), componentwise."""
    scale = atol + rtol * torch.maximum(y0.abs(), y1.abs())
    # atol=0 with exactly-zero state entries gives scale=0: err 0 there means
    # a perfectly-resolved component (ratio 0), not 0/0 = NaN → reject-forever.
    pos = scale > 0.0
    return torch.where(
        pos,
        err / torch.where(pos, scale, torch.ones_like(scale)),
        torch.where(err == 0.0, torch.zeros_like(err),
                    torch.full_like(err, float("inf"))),
    )


def _finite_or_inf(ratio):
    return torch.where(torch.isfinite(ratio), ratio,
                       torch.full_like(ratio, float("inf")))


def _error_ratio(err, y0, y1, rtol, atol, mask=None):
    """Mixed-tolerance error norm: RMS of err scaled by
    ``atol + rtol * max(|y0|, |y1|)``, one ratio per sample row.  ``rtol``,
    ``atol``: floats or ``(B, 1)`` columns.

    ``mask`` ((B, N) bool) restricts the norm to a subset of state columns,
    the seminorm of Kidger et al. 2020: the mean runs over the unmasked
    count."""
    r = _scaled_error(err, y0, y1, rtol, atol)
    if mask is None:
        ratio = _rms(r)
    else:
        denom = torch.clamp(mask.sum(dim=-1), min=1).to(r.dtype)
        # Select, don't multiply: an excluded entry may hold inf (atol = 0
        # at a zero-scale component) and inf · 0 would poison the sum.
        r_sq = torch.where(mask, r * r, torch.zeros_like(r))
        ratio = torch.sqrt(r_sq.sum(dim=-1) / denom + _tiny(r.dtype))
    return _finite_or_inf(ratio)


class RankNorm:
    """The batch-global error norm of a solve whose state holds this rank's
    rows of a batch that other ranks hold the rest of (data parallelism with
    ``error_control='global'``): the norm the one-device solve of the whole
    batch takes, so that every rank takes the same steps.

    ``batch_sum(t)``: ``t`` summed over those ranks, the same on every rank.
    ``shared``: ``(1, N)`` bool, the components that are one value for the
    whole batch, each rank holding a partial sum of it (the adjoint's a_θ
    and a_t); None for none.  ``mask``: the solve's seminorm mask or None.

    Row components enter as their squared terms, summed across the ranks;
    shared components are summed *before* squaring: y0, y1 and err there are
    all-reduced, then scaled and squared.  The denominator is the global
    component count.  One ``batch_sum`` per attempt (y0, y1, err of the
    shared components and the row terms in one buffer; only the row terms
    where the mask leaves the shared ones out), one per solve for the
    counts, two for the initial step."""

    def __init__(self, batch_sum, shared, mask, n: int, device):
        self.sum = batch_sum
        sh = (torch.zeros(n, dtype=torch.bool, device=device)
              if shared is None else shared.reshape(-1).to(device))
        self.sh = torch.nonzero(sh).reshape(-1)
        self.row = torch.nonzero(~sh).reshape(-1)
        self.n_sh = int(self.sh.numel())
        self.mask_sh = self.mask_row = None
        n_sh_in, n_row_in = self.n_sh, float(self.row.numel())
        if mask is not None:
            m = mask.reshape(-1)
            self.mask_sh, self.mask_row = m[self.sh], m[self.row]
            n_sh_in = int(self.mask_sh.sum())
            n_row_in = float(self.mask_row.sum())
        # Shared components the mask leaves out need not be summed per
        # attempt (the seminorm's a_θ, a_t): only the row terms are.
        self.shared_in_norm = n_sh_in > 0
        counts = self.sum(torch.tensor([float(self.row.numel()), n_row_in],
                                       dtype=torch.float64, device=device))
        self.count_all = counts[0] + self.n_sh
        self.count = torch.clamp(counts[1] + n_sh_in, min=1)

    def _sq(self, r, mask):
        sq = r * r
        return sq if mask is None else torch.where(mask, sq,
                                                   torch.zeros_like(sq))

    def error_ratio(self, err, y0, y1, rtol, atol):
        """:func:`_error_ratio` over the whole batch; ``err`` may carry
        leading axes (``(..., 1, N)``, one ratio each)."""
        row, sh = self.row, self.sh
        r_row = _scaled_error(err[..., row], y0[..., row], y1[..., row],
                              rtol, atol)
        sq = self._sq(r_row, self.mask_row).sum(dim=-1)
        if self.shared_in_norm:
            e_sh = err[..., sh]
            buf = self.sum(torch.cat([y0[..., sh].reshape(-1),
                                      y1[..., sh].reshape(-1),
                                      e_sh.reshape(-1), sq.reshape(-1)]))
            y0s, y1s, es, sq_g = torch.split(
                buf, [self.n_sh, self.n_sh, e_sh.numel(), sq.numel()])
            r_sh = _scaled_error(es.reshape(e_sh.shape),
                                 y0s.reshape(1, -1), y1s.reshape(1, -1),
                                 rtol, atol)
            total = (sq_g.reshape(sq.shape)
                     + self._sq(r_sh, self.mask_sh).sum(dim=-1))
        else:
            total = self.sum(sq)
        ratio = torch.sqrt(total / self.count.to(total.dtype)
                           + _tiny(total.dtype))
        return _finite_or_inf(ratio)

    def initial_norms(self, y0, f0, scale, rtol, atol):
        """``d0``, ``d1`` of :func:`_select_initial_step` over the whole
        batch (every component, as there)."""
        row, sh = self.row, self.sh
        s_row = scale[..., row]
        a, b = y0[..., row] / s_row, f0[..., row] / s_row
        sums = torch.stack([(a * a).sum(dim=-1), (b * b).sum(dim=-1)])
        if self.n_sh:
            buf = self.sum(torch.cat([y0[..., sh].reshape(-1),
                                      f0[..., sh].reshape(-1),
                                      sums.reshape(-1)]))
            y0s, f0s, sums_g = torch.split(
                buf, [self.n_sh, self.n_sh, sums.numel()])
            scale_s = atol + rtol * y0s.abs()
            a, b = y0s / scale_s, f0s / scale_s
            sums = sums_g.reshape(sums.shape) + torch.stack(
                [(a * a).sum(), (b * b).sum()]).reshape(2, 1)
            self._first = (f0s, scale_s)
        else:
            sums = self.sum(sums)
        d = torch.sqrt(sums / self.count_all.to(sums.dtype)
                       + _tiny(sums.dtype))
        return d[0], d[1]

    def initial_diff_norm(self, f1, f0, scale):
        """RMS of (f1 − f0) / scale over the whole batch (``d2``'s
        numerator), after :meth:`initial_norms`."""
        row, sh = self.row, self.sh
        c = (f1[..., row] - f0[..., row]) / scale[..., row]
        s = (c * c).sum(dim=-1)
        if self.n_sh:
            f0s, scale_s = self._first
            buf = self.sum(torch.cat([f1[..., sh].reshape(-1), s]))
            c = (buf[:self.n_sh] - f0s) / scale_s
            s = buf[self.n_sh:] + (c * c).sum()
        else:
            s = self.sum(s)
        return torch.sqrt(s / self.count_all.to(s.dtype) + _tiny(s.dtype))


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


def _select_initial_step(func, t0, y0, f0, direction, rtol, atol, order,
                         norm: RankNorm | None = None):
    """Hairer, Nørsett & Wanner II.4 automatic initial step, per sample.
    Costs one extra dynamics evaluation.  ``norm``: the norms span the
    batch across ranks (:class:`RankNorm`)."""
    scale = atol + rtol * y0.abs()
    if norm is None:
        d0 = _rms(y0 / scale)
        d1 = _rms(f0 / scale)
    else:
        d0, d1 = norm.initial_norms(y0, f0, scale, rtol, atol)
    small = (d0 < 1e-5) | (d1 < 1e-5)
    h0 = torch.where(small, torch.full_like(d0, 1e-6),
                     0.01 * d0 / torch.clamp(d1, min=1e-30))

    y1 = y0 + (h0 * direction)[:, None] * f0
    f1 = func(t0 + h0 * direction, y1)
    d2 = (_rms((f1 - f0) / scale) if norm is None
          else norm.initial_diff_norm(f1, f0, scale)) / h0

    d_max = torch.maximum(d1, d2)
    h1 = torch.where(
        d_max <= 1e-15,
        torch.clamp(h0 * 1e-3, min=1e-6),
        (0.01 / d_max) ** (1.0 / (order + 1)),
    )
    return torch.minimum(100.0 * h0, h1) * direction


def _dense_write(fit, parts, ts, t0, t1, dt, direction, accept, out,
                 inplace: bool = False):
    """Fit the dense-output polynomial on this attempt and write every
    requested output time an *accepted* step covers (coverage tested in
    t-space, coordinate clamped to [0, 1], as in JAX).

    ``fit``: (D+1, D+1) collocation matrix; ``parts``: the D+1 (B, N) data
    components (y0, y1[, y_mid], dt·f0, dt·f1); ``out``: (T-1, B, N) for
    ``ts[1:]``, written in place where ``inplace`` (the graph route, where
    ``out`` is its own buffer), else a new tensor.  The polynomial weights
    are per-sample scalars ``g_d(x) = Σ_c fit[c, d] x^c`` computed with
    elementwise f32 products (no matmul, so no TF32 on the card)."""
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
    if inplace:
        return torch.where(covered[:, :, None], vals, out, out=out)
    return torch.where(covered[:, :, None], vals, out)


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
    unroll: str = "while",
    error_mask: torch.Tensor | None = None,
    fused_step: Callable | None = None,
    controller: str = "i",
    batch_sum: Callable | None = None,
    shared: torch.Tensor | None = None,
    graph_key=None,
) -> tuple[torch.Tensor, SolveStats]:
    """Integrate ``dy/dt = func(t, y)`` over the monotonic grid ``ts``.

    Args:
      func: ``(t (B,), y (B, N)) -> (B, N)``.
      y0: (B, N) initial state, floating point.
      ts: (T,) strictly monotonic output times, T >= 2.
      rtol/atol: mixed tolerances for the per-sample error norm: floats,
        or ``(B,)`` tensors with one tolerance per row.
      tableau: embedded RK tableau (dopri5/bosh3/fehlberg2/tsit5).
      max_steps: bound on loop iterations (accept + reject attempts).
      first_step: optional fixed initial step (unsigned); default Hairer.
      unroll: ``'while'`` (early exit; on the card a replayed CUDA graph
        where nothing records autograd), ``'scan'`` (exactly ``max_steps``
        attempts, reverse-differentiable) or ``'scan_remat'`` (the same,
        each attempt recomputed in the backward); see the module docstring.
      error_mask: optional 0/1 tensor broadcastable to (B, N): error control
        restricted to these state columns (seminorm; see ``_error_ratio``).
        Turned into a bool tensor once per solve, not per attempt.
      fused_step: optional ``(t0 (B,), dt (B,), y0 (B,N), f0 (B,N)) ->
        (y1, f1, y_mid, ratio)`` replacing ``_rk_attempt`` + the error norm
        (``kernels/rk_step.py``).  Requires a quartic-dense FSAL tableau
        and no ``error_mask``; the caller builds it for the same tolerances.
      controller: ``'i'`` (default, reference parity) or ``'pi'``.
      batch_sum: the state is one row (global control) of a batch whose
        other rows other ranks hold: the error norms span them all
        (:class:`RankNorm`; ``shared``, ``(1, N)`` bool, marks the
        components each rank holds a partial sum of).  Not with
        ``fused_step``.
      graph_key: the dynamics' weights stay as they are across solves:
        a hashable tuple that names ``func`` and ``fused_step`` (tensors in
        it are taken by address and version counter).  On the card a
        ``'while'`` solve then replays one cached CUDA graph per shape,
        tolerance and ``ts`` (``attempt_graph.py``); None captures per
        solve.  Ignored with ``error_mask`` or ``batch_sum``.

    Returns:
      ys: (T, B, N) solution at ``ts`` (ys[0] ≡ y0).
      stats: per-sample :class:`SolveStats`.
    """
    if fused_step is not None and (error_mask is not None
                                   or batch_sum is not None
                                   or tableau.c_mid is None
                                   or not tableau.fsal):
        raise ValueError("fused_step requires a quartic-dense FSAL tableau, "
                         "no error_mask and no batch_sum")
    if controller not in ("i", "pi"):
        raise ValueError(f"unknown controller {controller!r}; 'i' | 'pi'")
    check_unroll(unroll)
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

    quartic = tableau.c_mid is not None
    fit = torch.tensor(QUARTIC_FIT if quartic else CUBIC_FIT, dtype=dtype,
                       device=dev)
    scalars = (None if fused_step is not None
               else tableau_scalars(tableau, dtype, dev))
    floats = tableau_floats(tableau)
    direction = torch.sign(ts[-1] - ts[0])
    t_final = ts[-1].clone()  # not a view of ts: a traced loop's inputs
    inf = torch.full((batch,), float("inf"), dtype=dtype, device=dev)

    # ts[0] as a (B,) column without a read on the host (ts is in dtype, so
    # the bits are those of a fill with float(ts[0])).
    t = ts[0].expand(batch).contiguous()
    f = func(t, y0)
    nfe = torch.ones((batch,), dtype=torch.int32, device=dev)
    if first_step is None:
        dt = _select_initial_step(func, t, y0, f, direction, rtol, atol,
                                  tableau.order - 1, norm)
        nfe = nfe + 1
    else:
        dt = torch.full((batch,), float(first_step), dtype=dtype,
                        device=dev) * direction

    naccept = torch.zeros((batch,), dtype=torch.int32, device=dev)
    carry0 = _Carry(
        t=t, dt=dt, y=y0, f=f,
        out=torch.zeros((ts.shape[0] - 1, batch, n), dtype=dtype, device=dev),
        nfe=nfe, naccept=naccept, nreject=torch.zeros_like(naccept),
        done=torch.zeros((batch,), dtype=torch.bool, device=dev),
        rprev=torch.ones((batch,), dtype=dtype, device=dev))

    def body(c: _Carry, inplace: bool = False) -> _Carry:
        """One attempt; no host read.  ``inplace``: write the dense output
        into ``c.out`` (the graph route's own buffer)."""
        active = ~c.done
        if fused_step is not None:
            y1, f1, y_mid, ratio = fused_step(c.t, c.dt, c.y, c.f)
            new_evals = tableau.stages - 1
            ratio = torch.where(torch.isfinite(ratio), ratio, inf)
        else:
            y1, err, f1, new_evals, y_mid = _rk_attempt(
                tableau, func, c.t, c.dt, c.y, c.f, scalars, floats)
            ratio = (_error_ratio(err, c.y, y1, rtol, atol, mask)
                     if norm is None
                     else norm.error_ratio(err, c.y, y1, rtol, atol))
        accept = (ratio <= 1.0) & active
        t1 = c.t + c.dt

        dt_col = c.dt[:, None]
        parts = ((c.y, y1, y_mid, dt_col * c.f, dt_col * f1) if quartic
                 else (c.y, y1, dt_col * c.f, dt_col * f1))
        out = _dense_write(fit, parts, ts, c.t, t1, c.dt, direction, accept,
                           c.out, inplace)

        rprev = c.rprev
        if controller == "pi":
            proposed = _optimal_dt_pi(c.dt, ratio, c.rprev, accept,
                                      tableau.order, safety, ifactor, dfactor)
            rprev = torch.where(accept & active,
                                torch.clamp(ratio, min=1e-4), c.rprev)
        else:
            proposed = _optimal_dt(c.dt, ratio, accept, tableau.order, safety,
                                   ifactor, dfactor)
        reached = accept & (direction * (t1 - t_final) >= 0.0)
        acc_col = accept[:, None]
        return _Carry(
            t=torch.where(accept, t1, c.t),
            dt=torch.where(active, proposed, c.dt),
            y=torch.where(acc_col, y1, c.y),
            f=torch.where(acc_col, f1, c.f),
            out=out,
            nfe=c.nfe + active.to(torch.int32) * new_evals,
            naccept=c.naccept + accept.to(torch.int32),
            nreject=c.nreject + (active & ~accept).to(torch.int32),
            done=c.done | reached,
            rprev=rprev)

    if unroll == "while":
        key = None
        if (graph_key is not None and dev.type == "cuda" and mask is None
                and norm is None and not torch.compiler.is_compiling()):
            from .attempt_graph import cache_key
            key = cache_key((
                graph_key, tableau.name, controller, safety, ifactor,
                dfactor, fused_step is not None, tuple(y0.shape), dtype,
                _by_value(rtol), _by_value(atol), _by_value(ts)))
        final = _while_loop(body, carry0, max_steps,
                            dev.type == "cuda" and norm is None, key)
    else:
        final = _scan_loop(body, carry0, max_steps, unroll == "scan_remat")
    stats = SolveStats(nfe=final.nfe, naccept=final.naccept,
                       nreject=final.nreject, success=final.done)
    return torch.cat([y0[None], final.out], dim=0), stats
