"""Shared model components: config, downsampling stem, classification head
(port of ``neural_ode_features_tpu/models/common.py``)."""

from __future__ import annotations

import dataclasses

import torch

from ..ops.layers import (
    conv2d,
    global_avg_pool,
    group_norm,
    init_conv,
    init_group_norm,
    init_linear,
    linear,
)

__all__ = ["ModelConfig", "init_stem", "stem_apply", "init_head",
           "head_apply", "pool_features"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture + solver configuration.  Every field of the JAX
    ``ModelConfig`` is kept, under the same name, so that a ``params.json``
    written by the JAX package loads here."""

    in_channels: int = 1  # 1 = MNIST, 3 = CIFAR-10
    num_classes: int = 10
    hidden: int = 64
    groups: int = 32
    downsampling: str = "conv"  # 'conv' (Chen et al. default) | 'res'
    # solver settings (ODENet only)
    tol: float = 1e-3  # reference --tol: used for both rtol and atol
    method: str = "dopri5"
    error_control: str = "per_sample"
    controller: str = "i"  # 'i' (reference parity) | 'pi' (fewer rejections)
    adjoint: bool = False
    adjoint_seminorm: bool = False
    adjoint_mode: str = "reintegrate"
    max_steps: int = 4096
    # number of residual blocks (ResNet only)
    num_blocks: int = 6
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16' dynamics compute
    # TPU opt-ins of the JAX package (Pallas ODEfunc / fused RK-step
    # kernels).  The port does NOT read them: on a CUDA tensor it always
    # runs its own kernels, on a CPU tensor their plain PyTorch versions.
    use_pallas: bool = False
    use_fused_rk: bool = False

    @property
    def cdtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.compute_dtype == "bfloat16"
                else torch.float32)


def _res_not_ported():
    raise NotImplementedError(
        "downsampling='res' is not ported yet (ROADMAP.md, Queue 1 item 1)")


def init_stem(gen: torch.Generator, cfg: ModelConfig):
    """Downsampling stem, 28×28 → 6×6 (MNIST) / 32×32 → 7×7 (CIFAR):
    conv(in→h, 3×3, VALID) then 2 × [GN, ReLU, conv(h→h, 4×4, s2, p1)]."""
    h = cfg.hidden
    if cfg.downsampling == "conv":
        return {
            "conv0": init_conv(gen, 3, 3, cfg.in_channels, h),
            "norm1": init_group_norm(h),
            "conv1": init_conv(gen, 4, 4, h, h),
            "norm2": init_group_norm(h),
            "conv2": init_conv(gen, 4, 4, h, h),
        }
    if cfg.downsampling == "res":
        _res_not_ported()
    raise ValueError(f"unknown downsampling {cfg.downsampling!r}")


def stem_apply(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.downsampling == "res":
        _res_not_ported()
    g = cfg.groups
    x = conv2d(params["conv0"], x, padding="VALID")
    x = torch.relu(group_norm(params["norm1"], x, groups=g))
    x = conv2d(params["conv1"], x, stride=2, padding=1)
    x = torch.relu(group_norm(params["norm2"], x, groups=g))
    x = conv2d(params["conv2"], x, stride=2, padding=1)
    return x


def init_head(gen: torch.Generator, cfg: ModelConfig):
    return {
        "norm": init_group_norm(cfg.hidden),
        "fc": init_linear(gen, cfg.hidden, cfg.num_classes),
    }


def head_apply(params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """GN → ReLU → GAP → Linear."""
    h = torch.relu(group_norm(params["norm"], h, groups=cfg.groups))
    return linear(params["fc"], global_avg_pool(h))


def pool_features(h: torch.Tensor) -> torch.Tensor:
    """The extraction pooling: GAP of a (…, H, W, C) state → (…, C)."""
    return h.mean(dim=(-3, -2))
