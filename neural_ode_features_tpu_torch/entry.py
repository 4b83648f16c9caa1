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

``dryrun_multichip``: the counterpart of ``__graft_entry__.dryrun_multichip``,
one training step across n ranks (data parallel, or FSDP on an (n/2, 2)
mesh for even n ≥ 4), then a population of n seeds sharded over the ranks
whose member 0 must equal a solo seed-0 epoch.
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
           "extract_entry", "dryrun_multichip"]

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


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One full training step (normalize → augment → adjoint solve → grad →
    SGD) on ``n_devices`` ranks, each its own process (``parallel.launch``):
    NCCL over the first n cards with ``device="cuda"`` (more ranks than
    cards raises, naming both counts), gloo processes with
    ``device="cpu"``.  For even n ≥ 4 the mesh is ``(data, model)`` =
    (n/2, 2) and every parameter and optimizer-state leaf is sharded over
    ``model``; otherwise pure data parallelism.  Then, for n > 1, one epoch
    of a population of n seeds sharded over the ranks (the same launch),
    whose member 0 must reproduce a solo seed-0 epoch on one device (rtol
    1e-4, atol 1e-5).  Prints the JAX function's two lines and returns
    what they report."""
    from .parallel import launch, rank_devices
    from .parallel.tasks import in_turn, population_epoch, train_steps

    kind = torch.device(device).type
    devices = rank_devices(n_devices, kind)
    model_shards = 2 if (n_devices >= 4 and n_devices % 2 == 0) else 1
    cfg = TrainConfig(dataset="synthetic-cifar10", model="odenet", tol=1e-2,
                      adjoint=True, error_control="per_sample",
                      batch_size=2 * n_devices, num_devices=n_devices,
                      model_shards=model_shards, augment=True)
    images, labels = load_dataset("synthetic-cifar10", "train",
                                  limit=2 * n_devices)
    jobs = [(train_steps, (cfg, [(images, labels)]),
             {"device": kind, "steps_per_epoch": 1})]
    pop_cfg = dataclasses.replace(cfg, batch_size=4, model_shards=1)
    pimages, plabels = load_dataset("synthetic-cifar10", "train",
                                    limit=pop_cfg.batch_size)
    if n_devices > 1:
        jobs.append((population_epoch, (pop_cfg, list(range(n_devices)),
                                        pimages, plabels), {"device": kind}))
    step, *pop = launch(in_turn, n_devices, jobs, devices=devices)[0]
    if model_shards > 1 and all(local == whole
                                for local, whole in step["shapes"]):
        raise RuntimeError("expected FSDP-sharded parameter leaves")
    loss, nfe = step["metrics"][0]["loss"], step["metrics"][0]["nfe"]
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    print(f"dryrun_multichip({n_devices}): loss={loss:.4f} nfe={nfe:.1f} "
          f"mesh={step['mesh']}")
    out = {"loss": loss, "nfe": nfe, "mesh": step["mesh"], "step": step}
    if pop:
        pop = pop[0]
        ploss = np.asarray(pop["metrics"]["loss"], np.float64)
        pnfe = float(np.mean(pop["metrics"]["nfe"]))
        if ploss.shape[0] != n_devices or not np.isfinite(ploss).all():
            raise RuntimeError(f"population losses {ploss}")
        if len(pop["owned"]) == n_devices:
            raise RuntimeError("expected the seed axis sharded over 'data'")
        solo = Trainer(dataclasses.replace(pop_cfg, seed=0, num_devices=1),
                       steps_per_epoch=1, device=strict_f32(devices[0]))
        sloss = np.asarray(solo.train_epoch(pimages, plabels, 0)["loss"],
                           np.float64)
        np.testing.assert_allclose(ploss[0], sloss, rtol=1e-4, atol=1e-5)
        print(f"dryrun_multichip({n_devices}) population(K={n_devices}): "
              f"loss_mean={float(ploss.mean()):.4f} nfe={pnfe:.1f} "
              f"(seed axis sharded over 'data'; member 0 == solo seed-0 "
              f"to 1e-4: {float(ploss[0][0]):.6f} vs {float(sloss[0]):.6f})")
        out.update(population=pop, solo_loss=sloss)
    return out
