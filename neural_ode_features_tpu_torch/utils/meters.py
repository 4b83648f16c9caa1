"""Training meters (port of ``neural_ode_features_tpu/utils/meters.py``)."""

from __future__ import annotations

__all__ = ["RunningAverageMeter", "AverageMeter", "count_parameters"]


def count_parameters(params) -> int:
    """Total scalar parameter count of a tree of tensors."""
    from torch.utils import _pytree as pytree

    return sum(leaf.numel() for leaf in pytree.tree_leaves(params))


class RunningAverageMeter:
    """Exponential moving average; the reference's loss/NFE meter."""

    def __init__(self, momentum: float = 0.97):
        self.momentum = momentum
        self.val = None
        self.avg = 0.0

    def reset(self):
        self.val = None
        self.avg = 0.0

    def update(self, val: float):
        if self.val is None:
            self.avg = float(val)
        else:
            self.avg = self.avg * self.momentum + float(val) * (1.0 - self.momentum)
        self.val = float(val)


class AverageMeter:
    """Plain arithmetic mean over an epoch."""

    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)
