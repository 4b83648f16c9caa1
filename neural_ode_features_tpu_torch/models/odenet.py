"""ODE-Net: stem → continuous ODE block → head (port of
``neural_ode_features_tpu/models/odenet.py``: inference, the adjoint
training path, and the trajectory at any output times from one solve).

On a CUDA tensor the dynamics always run the fused ODEfunc kernel and, when
the configuration is eligible, every dopri5 attempt of an inference solve
runs the fused step kernel; the adjoint path's augmented dynamics run the
ODEfunc kernel pair (forward and fused backward), at every hidden width the
JAX kernels take on 7×7 (CIFAR-10) and 6×6 (MNIST) maps: the multiples of
32 up to 512.  A shape the kernels do not take raises on the card before
any launch, naming the gate (``kernels.odefunc.check_cuda_inputs``).  Every
solver (``cfg.method``: the
adaptive RK methods, ``adams``, the fixed-grid ones) runs on that dynamics.
On a CPU tensor every kernel runs its plain PyTorch version.  The JAX opt-ins
``cfg.use_pallas``/``cfg.use_fused_rk`` are not read.

``cfg.compute_dtype='bfloat16'`` runs the JAX jnp path's bf16 dynamics
with the solver state in float32, for inference and training alike.  On
the card one launch of the ODEfunc kernel's bf16 build per evaluation and
no fused step, as JAX's ``fused_rk_eligible`` rules; the adjoint's
augmented dynamics take the backward kernel's bf16 build (the VJP of those
dynamics, JAX's ``jax.vjp`` of its jnp dynamics).  On the CPU the same
functions run their plain bf16 versions.
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_leaves

from .._device import resolve_device, tree_to
from ..kernels.odefunc import aligned, odefunc, odefunc_vjp, prepare
from ..kernels.rk_step import make_fused_dopri5_step
from ..ops.layers import concat_conv2d, group_norm, init_conv, init_group_norm
from ..solver import (
    ADAPTIVE_TABLEAUS,
    AdjointStats,
    SolveStats,
    check_adjoint_options,
    odeint,
    odeint_adjoint,
)
from .common import ModelConfig, head_apply, init_head, init_stem, stem_apply

__all__ = ["init_odefunc", "init_odenet", "odefunc_apply", "block_dynamics",
           "fused_rk_eligible", "odenet_solve", "odenet_logits",
           "odenet_trajectory"]

# The JAX bound on the interpolated adjoint's dense forward.
DENSE_MAX_STEPS = 256


def init_odefunc(gen: torch.Generator, cfg: ModelConfig):
    """GN → ReLU → ConcatConv(h+1→h, 3×3) → GN → ReLU → ConcatConv → GN."""
    h = cfg.hidden
    return {
        "norm1": init_group_norm(h),
        "conv1": init_conv(gen, 3, 3, h + 1, h),
        "norm2": init_group_norm(h),
        "conv2": init_conv(gen, 3, 3, h + 1, h),
        "norm3": init_group_norm(h),
    }


def init_odenet(seed: int, cfg: ModelConfig, *, device="cuda"):
    """Random weights from ``seed`` (U(±1/√fan_in), as the JAX package),
    drawn on the CPU from one ``torch.Generator`` and moved to ``device``.
    The same seed gives the same weights on every device (not the JAX
    package's numbers: use ``utils.checkpoint.from_jax_params`` for those)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = {
        "stem": init_stem(gen, cfg),
        "odefunc": init_odefunc(gen, cfg),
        "head": init_head(gen, cfg),
    }
    return tree_to(params, dev)


def odefunc_apply(params, t, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The dynamics f(t, h); ``t`` scalar or (B,).  CUDA: the fused kernel,
    its bf16 build for ``cfg.compute_dtype='bfloat16'`` (raises for a shape
    outside its gate).  CPU: the plain path in ``cfg.compute_dtype``, as the
    JAX jnp path; the state and f stay f32."""
    if h.is_cuda:
        return odefunc(params, t, h, groups=cfg.groups,
                       compute_dtype=cfg.cdtype)
    g = cfg.groups
    out = h.to(cfg.cdtype)
    out = torch.relu(group_norm(params["norm1"], out, groups=g))
    out = concat_conv2d(params["conv1"], t, out, padding=1)
    out = torch.relu(group_norm(params["norm2"], out, groups=g))
    out = concat_conv2d(params["conv2"], t, out, padding=1)
    out = group_norm(params["norm3"], out, groups=g)
    return out.float()


def block_dynamics(params, h0: torch.Tensor, cfg: ModelConfig):
    """The ODE block as explicit-parameter dynamics for
    ``solver.odeint_adjoint`` and ``solver.odeint_event_adjoint``:
    ``(dyn(p, t, y), vjp(p, t, y, a))`` in ``cfg.compute_dtype``.
    ``params``: the ODEfunc param dict, laid out for the kernels once here,
    so ``dyn`` and ``vjp`` close over that layout (pass the same dict as the
    solver's ``params``).  One ``odefunc`` launch per evaluation and one
    ``odefunc_bwd`` launch per VJP, which writes f itself, each in the
    build of ``cfg.compute_dtype`` (on the CPU, the wrappers' plain
    versions at that precision).  The states handed to the kernels may be
    views into a flat solver state, hence ``aligned``."""
    g, dtype = cfg.groups, cfg.cdtype
    with torch.no_grad():
        w = prepare(params, tuple(h0.shape[1:3]))

    def dyn(p, t, y):
        return odefunc(w, t, aligned(y), groups=g, compute_dtype=dtype)

    def vjp(p, t, y, a):
        return odefunc_vjp(w, t, aligned(y), aligned(a), groups=g,
                           compute_dtype=dtype)
    return dyn, vjp


def fused_rk_eligible(cfg: ModelConfig, h0_shape, h0_dtype) -> bool:
    """True iff :func:`odenet_solve` installs the fused dopri5 step: dopri5,
    per-sample error control, f32 compute and state, NHWC maps.  The
    kernel's shape gate is checked by its wrapper, which raises on the card
    rather than falling back."""
    return (cfg.method == "dopri5" and cfg.error_control == "per_sample"
            and cfg.compute_dtype == "float32"
            and h0_dtype == torch.float32 and len(h0_shape) == 4)


def odenet_solve(params, h0: torch.Tensor, ts: torch.Tensor,
                 cfg: ModelConfig, *, tol=None, batch_sum=None):
    """Run the ODE block over ``ts`` from the stem's output ``h0`` (the JAX
    module's ``_solve``, inference path); returns ((T, B, H, W, C), stats).

    ``tol`` overrides ``cfg.tol`` for this call: a float, or a ``(B,)``
    tensor with one tolerance per row (per-sample error control), which is
    how a tolerance grid is stacked on the batch axis and solved at once
    (``sweep --fused``).  The fused step takes the same per-row tolerance.
    ``batch_sum``: ``h0`` is this rank's rows of a batch spread over ranks
    (``solver.odeint``; only global control reads it)."""
    tol = cfg.tol if tol is None else tol
    if isinstance(tol, torch.Tensor):
        if cfg.error_control != "per_sample":
            raise ValueError("a per-row tolerance needs "
                             "error_control='per_sample'")
        tol = tol.to(device=h0.device, dtype=h0.dtype)
    hw = tuple(h0.shape[1:3])
    # On the card, lay the ODEfunc weights out for the kernels once per
    # solve (split kernels, time maps); the CPU path mirrors the JAX jnp path.
    func_params = (prepare(params["odefunc"], hw) if h0.is_cuda
                   else params["odefunc"])

    def dyn(t, y):
        return odefunc_apply(func_params, t, y, cfg)

    fused_step = None
    if fused_rk_eligible(cfg, h0.shape, h0.dtype):
        fused_step = make_fused_dopri5_step(
            func_params, ADAPTIVE_TABLEAUS["dopri5"], hw,
            groups=cfg.groups, rtol=tol, atol=tol)
    # The weights stay as they are for the solve: on the card its attempt
    # graph is cached by them (address and version), the configuration (so
    # a bf16 and an f32 solve of one model are two entries) and the map
    # shape, unless autograd records through them.
    leaves = tree_leaves(params["odefunc"])
    graph_key = None
    if h0.is_cuda and not (torch.is_grad_enabled()
                           and any(p.requires_grad for p in leaves)):
        graph_key = ("odenet_solve", cfg, hw, tuple(leaves))
    return odeint(dyn, h0, ts, rtol=tol, atol=tol, method=cfg.method,
                  error_control=cfg.error_control, max_steps=cfg.max_steps,
                  fused_step=fused_step, controller=cfg.controller,
                  batch_sum=batch_sum, graph_key=graph_key)


def _solve_adjoint(params, h0: torch.Tensor, ts: torch.Tensor,
                   cfg: ModelConfig, tol: float, batch_sum=None):
    """The ODE block under ``odeint_adjoint`` (JAX ``_solve(adjoint=True)``)
    at ``tol``: differentiable in ``params["odefunc"]`` and ``h0``.  The
    forward takes no fused step, as in JAX, so it evaluates f once per stage
    (dopri5) or twice per attempt (adams); the augmented dynamics take f and
    its VJP from :func:`block_dynamics`.  The interpolated adjoint's dense
    forward has the JAX bound, ``min(cfg.max_steps, 256)`` attempts.
    bf16 dynamics take the bf16 builds (on the CPU, autograd through the
    plain bf16 f, as JAX's ``jax.vjp`` of its jnp dynamics)."""
    dyn, vjp = block_dynamics(params["odefunc"], h0, cfg)
    return odeint_adjoint(
        dyn, params["odefunc"], h0, ts, rtol=tol, atol=tol,
        method=cfg.method, error_control=cfg.error_control,
        max_steps=cfg.max_steps, controller=cfg.controller,
        adjoint_seminorm=cfg.adjoint_seminorm, adjoint_mode=cfg.adjoint_mode,
        dense_max_steps=min(cfg.max_steps, DENSE_MAX_STEPS), vjp=vjp,
        batch_sum=batch_sum)


def odenet_logits(params, x: torch.Tensor, cfg: ModelConfig, *,
                  adjoint: bool | None = None, tol=None, batch_sum=None
                  ) -> tuple[torch.Tensor, SolveStats | AdjointStats]:
    """Classification forward: solve h over [0, 1], head on h(1).  ``x``:
    (B, H, W, C_in) NHWC.  ``adjoint`` overrides ``cfg.adjoint``: the
    adjoint path (training) returns :class:`AdjointStats`, whose ``nfe_b``
    ``.backward()`` fills in.  ``tol`` overrides ``cfg.tol``: on the
    inference path a float or a ``(B,)`` tensor (see :func:`odenet_solve`),
    on the adjoint path one float, as the JAX ``_solve``.  ``batch_sum``:
    ``x`` is this rank's rows of a batch spread over ranks, and every
    batch-global error norm spans them all (``solver.odeint_adjoint``)."""
    adjoint = cfg.adjoint if adjoint is None else adjoint
    if adjoint:
        check_adjoint_options(cfg.adjoint_seminorm, cfg.adjoint_mode,
                              cfg.method)
        if isinstance(tol, torch.Tensor) and tol.ndim:
            raise ValueError("a per-row tolerance applies to the inference "
                             "path; the adjoint path takes one float tol")
    h0 = stem_apply(params["stem"], x, cfg)
    ts = torch.tensor([0.0, 1.0], dtype=h0.dtype, device=h0.device)
    if adjoint:
        traj, stats = _solve_adjoint(params, h0, ts, cfg,
                                     float(cfg.tol if tol is None else tol),
                                     batch_sum)
    else:
        traj, stats = odenet_solve(params, h0, ts, cfg, tol=tol,
                                   batch_sum=batch_sum)
    return head_apply(params["head"], traj[-1], cfg), stats


def odenet_trajectory(params, x: torch.Tensor, ts,
                      cfg: ModelConfig) -> tuple[torch.Tensor, SolveStats]:
    """Feature-extraction forward: the state trajectory h(t) at every
    requested t from ONE solve (dense output).  On the card every dopri5
    attempt is one fused-step launch, whose ``y_mid`` feeds the quartic fit
    of the dense write; ``adams`` writes its order-matched interpolant.

    Returns ((T, B, H, W, C) states, stats); pool with
    :func:`..models.common.pool_features` for (T, B, C) features."""
    h0 = stem_apply(params["stem"], x, cfg)
    ts = torch.as_tensor(ts).to(device=h0.device, dtype=h0.dtype)
    return odenet_solve(params, h0, ts, cfg)
