"""The port's entry points.

``entry``: the counterpart of ``__graft_entry__.entry()``, CIFAR-10 ODE-Net
inference with per-sample adaptive dopri5 at rtol = atol = 1e-3.  The
configuration is the JAX entry's with the JAX kernel opt-ins switched on
(``use_pallas=use_fused_rk=True``), i.e. the configuration whose path the
TPU kernels carried; the port runs its CUDA kernels on the card regardless.

``train_entry``: the adjoint training step at the JAX ``TrainConfig``
defaults on ``synthetic-cifar10``.

``extract_entry``: continuous feature extraction, the ``entry`` model's
pooled states at T output times from one solve per batch of uint8 images.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ._device import strict_f32
from .data import dataset_spec, load_dataset
from .extract import time_grid
from .models import (
    ModelConfig,
    init_odenet,
    odenet_logits,
    odenet_trajectory,
    pool_features,
)
from .ops.preprocess import normalize
from .training import TrainConfig, Trainer

__all__ = ["entry", "ENTRY_CONFIG", "train_entry", "TRAIN_CONFIG",
           "extract_entry"]

ENTRY_CONFIG = ModelConfig(in_channels=3, tol=1e-3, error_control="per_sample",
                           use_pallas=True, use_fused_rk=True)


# The JAX TrainConfig defaults (hidden 64, groups 32, B = 128, tol 1e-3,
# dopri5 with per-sample forward error control, reintegrating adjoint
# without seminorm, SGD lr 0.1 momentum 0.9, augment on) on the in-repo
# CIFAR-10 twin.
TRAIN_CONFIG = TrainConfig(dataset="synthetic-cifar10")


def train_entry(device="cuda", batch: int = 128):
    """Return ``(trainer, (images_u8, labels))``: a :class:`Trainer` at
    :data:`TRAIN_CONFIG` with ``batch_size=batch`` (random weights from
    ``cfg.seed``; the learning-rate boundaries of the full 50,000-image
    epoch) and one fixed ``synthetic-cifar10`` batch, (batch, 32, 32, 3)
    uint8 and (batch,) int64.  ``trainer.train_batch(images_u8, labels)``
    takes one step.  Sets strict f32 on the card, as :func:`entry`."""
    dev = strict_f32(device)
    cfg = dataclasses.replace(TRAIN_CONFIG, batch_size=batch)
    images, labels = load_dataset(cfg.dataset, "train", limit=batch)
    steps = dataset_spec(cfg.dataset)["n_train"] // batch
    trainer = Trainer(cfg, steps_per_epoch=steps, device=dev)
    return trainer, (images, labels.astype(np.int64))


def entry(device="cuda", batch: int = 16):
    """Return ``(fwd, (params, x))``: ``fwd(params, x) -> (logits, nfe)``
    on random weights (seed 7) and a (batch, 32, 32, 3) f32 NHWC input
    drawn with numpy from seed 0.  Sets strict f32 on the card (no TF32 in
    cuDNN convs or cuBLAS matmuls)."""
    dev = strict_f32(device)
    cfg = ENTRY_CONFIG
    params = init_odenet(7, cfg, device=dev)
    x = torch.from_numpy(
        np.random.default_rng(0).normal(size=(batch, 32, 32, 3))
        .astype(np.float32)).to(dev)

    def fwd(params, x):
        logits, stats = odenet_logits(params, x, cfg)
        return logits, stats.nfe

    return fwd, (params, x)


def extract_entry(device="cuda", batch: int = 256, timestamps: int = 11):
    """Return ``(fwd, params, x)``: ``fwd(params, x_u8) -> ((T, B, C)
    features, stats)`` runs one extraction batch, the :func:`entry` model and
    weights (seed 7) solved once over ``linspace(0, 1, timestamps)`` with the
    states pooled per t; ``x`` is the first ``batch`` images of the
    ``synthetic-cifar10`` test split, (batch, 32, 32, 3) uint8 on ``device``.
    Sets strict f32 on the card, as :func:`entry`."""
    dev = strict_f32(device)
    cfg = ENTRY_CONFIG
    dataset = "synthetic-cifar10"
    params = init_odenet(7, cfg, device=dev)
    x = torch.from_numpy(load_dataset(dataset, "test", limit=batch)[0]).to(dev)
    ts = time_grid(timestamps, dev)

    @torch.no_grad()
    def fwd(params, x_u8):
        traj, stats = odenet_trajectory(params, normalize(x_u8, dataset), ts,
                                        cfg)
        return pool_features(traj), stats

    return fwd, params, x
