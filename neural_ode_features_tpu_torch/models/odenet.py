"""ODE-Net: stem → continuous ODE block → head (port of
``neural_ode_features_tpu/models/odenet.py``, inference path).

On a CUDA tensor the dynamics always run the fused ODEfunc kernel and, when
the configuration is eligible, every dopri5 attempt runs the fused step
kernel; on a CPU tensor both run their plain PyTorch versions.  The JAX
opt-ins ``cfg.use_pallas``/``cfg.use_fused_rk`` are not read.
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from ..kernels.odefunc import odefunc, prepare
from ..kernels.rk_step import make_fused_dopri5_step
from ..ops.layers import concat_conv2d, group_norm, init_conv, init_group_norm
from ..solver import ADAPTIVE_TABLEAUS, SolveStats, odeint
from .common import ModelConfig, head_apply, init_head, init_stem, stem_apply

__all__ = ["init_odefunc", "init_odenet", "odefunc_apply",
           "fused_rk_eligible", "odenet_logits"]


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
    return _to(params, dev)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def odefunc_apply(params, t, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The dynamics f(t, h); ``t`` scalar or (B,).  CUDA: the fused kernel
    (f32 only; raises for bf16 compute or a shape outside its gate).  CPU:
    the plain path in ``cfg.compute_dtype``, as the JAX jnp path."""
    if h.is_cuda:
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                "the CUDA ODEfunc kernel computes in float32 only")
        return odefunc(params, t, h, groups=cfg.groups)
    g = cfg.groups
    out = h.to(cfg.cdtype)
    out = torch.relu(group_norm(params["norm1"], out, groups=g))
    out = concat_conv2d(params["conv1"], t, out, padding=1)
    out = torch.relu(group_norm(params["norm2"], out, groups=g))
    out = concat_conv2d(params["conv2"], t, out, padding=1)
    out = group_norm(params["norm3"], out, groups=g)
    return out.float()


def fused_rk_eligible(cfg: ModelConfig, h0_shape, h0_dtype) -> bool:
    """True iff :func:`_solve` installs the fused dopri5 step: dopri5,
    per-sample error control, f32 compute and state, NHWC maps.  The
    kernel's shape gate is checked by its wrapper, which raises on the card
    rather than falling back."""
    return (cfg.method == "dopri5" and cfg.error_control == "per_sample"
            and cfg.compute_dtype == "float32"
            and h0_dtype == torch.float32 and len(h0_shape) == 4)


def _solve(params, h0: torch.Tensor, ts: torch.Tensor, cfg: ModelConfig):
    """Run the ODE block over ``ts``; returns ((T, B, H, W, C), stats)."""
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
            groups=cfg.groups, rtol=cfg.tol, atol=cfg.tol)
    return odeint(dyn, h0, ts, rtol=cfg.tol, atol=cfg.tol, method=cfg.method,
                  error_control=cfg.error_control, max_steps=cfg.max_steps,
                  fused_step=fused_step, controller=cfg.controller)


def odenet_logits(params, x: torch.Tensor, cfg: ModelConfig, *,
                  adjoint: bool | None = None
                  ) -> tuple[torch.Tensor, SolveStats]:
    """Classification forward: solve h over [0, 1], head on h(1).  ``x``:
    (B, H, W, C_in) NHWC.  The adjoint (training) path is not ported yet."""
    adjoint = cfg.adjoint if adjoint is None else adjoint
    if adjoint:
        raise NotImplementedError(
            "the adjoint path is not ported yet (ROADMAP.md, Queue 1 item 4)")
    h0 = stem_apply(params["stem"], x, cfg)
    ts = torch.tensor([0.0, 1.0], dtype=h0.dtype, device=h0.device)
    traj, stats = _solve(params, h0, ts, cfg)
    return head_apply(params["head"], traj[-1], cfg), stats
