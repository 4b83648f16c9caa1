"""Image normalisation (port of ``neural_ode_features_tpu/ops/preprocess.py``;
``augment`` belongs to training and is ported with it)."""

from __future__ import annotations

import torch

__all__ = ["normalize", "NORM_STATS"]

# Channel statistics. MNIST follows the reference's ToTensor-only convention
# (identity normalisation); CIFAR-10 uses the standard channel stats.
NORM_STATS = {
    "mnist": ((0.0,), (1.0,)),
    "cifar10": ((0.4914, 0.4822, 0.4465), (0.2470, 0.2435, 0.2616)),
}
NORM_STATS["synthetic-mnist"] = NORM_STATS["mnist"]
NORM_STATS["synthetic-cifar10"] = NORM_STATS["cifar10"]


def normalize(x: torch.Tensor, dataset: str,
              dtype=torch.float32) -> torch.Tensor:
    """uint8 NHWC → normalised float NHWC."""
    mean, std = NORM_STATS[dataset]
    x = x.to(dtype) / 255.0
    mean = torch.tensor(mean, dtype=dtype, device=x.device)
    std = torch.tensor(std, dtype=dtype, device=x.device)
    return (x - mean) / std
