"""Object-style convenience API: ``ODENet`` / ``ResNet`` / ``ODEBlock`` (port
of ``neural_ode_features_tpu/models/api.py``).

Thin immutable wrappers over the functional core: an instance pairs
``(params, config)``.  ``create`` draws the weights from an integer seed
through the port's explicit ``torch.Generator`` (where the JAX classes take
a PRNG key) and places them on ``device``, the card by default.  For
gradients through an ODE solve, construct the config with ``adjoint=True``.
"""

from __future__ import annotations

import torch

from ..solver import AdjointStats, SolveStats
from .common import ModelConfig, pool_features
from .odenet import (
    _solve_adjoint,
    init_odenet,
    odenet_logits,
    odenet_solve,
    odenet_trajectory,
)
from .resnet import init_resnet, resnet_block_states, resnet_logits

__all__ = ["ODENet", "ResNet", "ODEBlock"]


class ODENet:
    """stem → ODE block → head classifier with continuous feature taps."""

    def __init__(self, params, config: ModelConfig):
        self.params = params
        self.config = config

    @classmethod
    def create(cls, seed: int, config: ModelConfig | None = None, *,
               device="cuda", **cfg_kw):
        config = config or ModelConfig(**cfg_kw)
        return cls(init_odenet(seed, config, device=device), config)

    def __call__(self, x: torch.Tensor
                 ) -> tuple[torch.Tensor, SolveStats | AdjointStats]:
        """Classification logits + per-sample solve stats."""
        return odenet_logits(self.params, x, self.config)

    def trajectory(self, x: torch.Tensor, ts
                   ) -> tuple[torch.Tensor, SolveStats]:
        """States h(t) at every requested t from one solve: (T, B, H, W, C)."""
        return odenet_trajectory(self.params, x, ts, self.config)

    def features(self, x: torch.Tensor, ts) -> tuple[torch.Tensor, SolveStats]:
        """Pooled per-t feature vectors: (T, B, C)."""
        traj, stats = self.trajectory(x, ts)
        return pool_features(traj), stats


class ODEBlock:
    """The continuous feature core alone: h0 ↦ h(t).  Operates on pre-stem
    feature maps."""

    def __init__(self, odefunc_params, config: ModelConfig):
        self.params = odefunc_params
        self.config = config

    def __call__(self, h0: torch.Tensor, ts=None):
        """``ts=None`` (the default [0, 1] span) returns the final state
        h(1); an explicit ``ts``, of any length, including 2, always returns
        the full (T, B, H, W, C) trajectory.  Honours ``config.adjoint``."""
        cfg = self.config
        final_only = ts is None
        ts = torch.as_tensor([0.0, 1.0] if final_only else ts).to(
            device=h0.device, dtype=h0.dtype)
        solve = _solve_adjoint if cfg.adjoint else odenet_solve
        traj, stats = solve({"odefunc": self.params}, h0, ts, cfg)
        return (traj[-1] if final_only else traj), stats


class ResNet:
    """Discrete 6-block baseline with per-block feature taps."""

    def __init__(self, params, config: ModelConfig):
        self.params = params
        self.config = config

    @classmethod
    def create(cls, seed: int, config: ModelConfig | None = None, *,
               device="cuda", **cfg_kw):
        config = config or ModelConfig(**cfg_kw)
        return cls(init_resnet(seed, config, device=device), config)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return resnet_logits(self.params, x, self.config)

    def block_states(self, x: torch.Tensor) -> torch.Tensor:
        return resnet_block_states(self.params, x, self.config)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        return pool_features(self.block_states(x))
