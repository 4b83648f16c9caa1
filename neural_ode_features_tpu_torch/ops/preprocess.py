"""Image normalisation and augmentation (port of
``neural_ode_features_tpu/ops/preprocess.py``).

The random draws of ``augment`` come from an explicit ``torch.Generator``
(on the CPU, then moved to the images' device); ``crop_and_flip`` takes the
draws as tensors, so a test can feed it the draws the JAX package makes."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["normalize", "normalized_black", "augment", "augment_draws",
           "crop_and_flip", "NORM_STATS"]

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


def normalized_black(dataset: str, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """Per-channel value a black (0) pixel takes after :func:`normalize`:
    the pad fill for augmenting in normalised space."""
    mean, std = NORM_STATS[dataset]
    return ((0.0 - torch.tensor(mean, dtype=dtype, device=device))
            / torch.tensor(std, dtype=dtype, device=device))


def crop_and_flip(x: torch.Tensor, offsets: torch.Tensor,
                  flips: torch.Tensor | None, *, pad: int = 4,
                  fill=0.0) -> torch.Tensor:
    """Pad ``x`` (B, H, W, C) by ``pad`` with ``fill``, crop (H, W) at the
    per-sample ``offsets`` (B, 2) (row, column), and mirror the samples
    where ``flips`` (B,) is true.  The padding is the JAX package's exact
    arithmetic: zero-pad ``x - fill``, then add ``fill`` back."""
    b, h, w, _ = x.shape
    fill = torch.as_tensor(fill, dtype=x.dtype, device=x.device)
    padded = F.pad(x - fill, (0, 0, pad, pad, pad, pad)) + fill
    offsets = offsets.to(device=x.device, dtype=torch.long)
    rows = offsets[:, 0, None] + torch.arange(h, device=x.device)
    cols = offsets[:, 1, None] + torch.arange(w, device=x.device)
    out = padded[torch.arange(b, device=x.device)[:, None, None],
                 rows[:, :, None], cols[:, None, :]]
    if flips is not None:
        flips = flips.to(device=x.device, dtype=torch.bool)
        out = torch.where(flips[:, None, None, None], out.flip(2), out)
    return out


def augment_draws(batch: int, generator: torch.Generator, *, pad: int = 4,
                  flip: bool = True):
    """The draws of :func:`augment` for ``batch`` samples: ``(offsets (B, 2),
    flips (B,) or None)``, offsets uniform on [0, 2·pad], flips
    Bernoulli(0.5), from ``generator`` (a CPU generator).  A rank that holds
    some rows of a batch draws the whole batch's and keeps its rows."""
    offsets = torch.randint(0, 2 * pad + 1, (batch, 2), generator=generator)
    flips = torch.rand((batch,), generator=generator) < 0.5 if flip else None
    return offsets, flips


def augment(x: torch.Tensor, generator: torch.Generator, *, pad: int = 4,
            flip: bool = True, fill=0.0) -> torch.Tensor:
    """Random pad-crop (+ horizontal flip) of float NHWC ``x`` (normalise
    first; pass ``fill=normalized_black(dataset)``), with the draws of
    :func:`augment_draws`."""
    offsets, flips = augment_draws(x.shape[0], generator, pad=pad, flip=flip)
    return crop_and_flip(x, offsets, flips, pad=pad, fill=fill)
