"""Example: continuous features, the port's signature capability
(counterpart of the JAX package's ``examples/continuous_features.py``).

    python -m neural_ode_features_tpu_torch.examples.continuous_features [--cpu]

1. Train a small ODE-Net on the ``synthetic-mnist`` twin (the real MNIST
   code path): 1,024 images, B = 64, tol 1e-2, no augmentation, 2 epochs
   of 16 adjoint steps (``Trainer.train_epoch``).
2. Extract the features of 512 test images at 9 times t ∈ [0, 1] from ONE
   solve (``ODENet.features``) and print the retrieval mAP at each t.

On the card every step of 1 runs the ODEfunc kernel pair (``odefunc`` and
``odefunc_bwd``), and the solve of 2 runs ``odefunc`` twice and the fused
step ``rk_step`` once per attempt, at full width (6×6×64).  Runs on the
card unless ``--cpu`` is given; no card is an error.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .._device import strict_f32
from ..data import load_dataset
from ..evaluation import retrieval_map
from ..extract import time_grid
from ..models import ODENet
from ..ops.preprocess import normalize
from ..training import TrainConfig, Trainer

DATASET = "synthetic-mnist"
TIMES = 9


def run(n_train: int = 1024, n_test: int = 512, batch_size: int = 64,
        steps_per_epoch: int = 16, epochs: int = 2, *, device="cuda",
        params=None, log=print) -> dict:
    """Steps 1 and 2 at these sizes (the defaults are the example's);
    ``params``: start from these weights (default: the trainer's seed 0).
    Returns ``trainer``, ``ts``, ``features`` ((9, n_test, C)),
    ``stats`` (the features solve's) and ``maps`` (one mAP per t)."""
    dev = strict_f32(device)
    x_train, y_train = load_dataset(DATASET, "train", limit=n_train)
    cfg = TrainConfig(dataset=DATASET, tol=1e-2, batch_size=batch_size,
                      augment=False, epochs=epochs, lr=0.1)
    trainer = Trainer(cfg, steps_per_epoch=steps_per_epoch, device=dev,
                      params=params)
    for epoch in range(epochs):
        m = trainer.train_epoch(x_train, y_train, epoch)
        log(f"epoch {epoch}: loss {float(m['loss'][-1]):.3f} "
            f"nfe {float(m['nfe'][-1]):.1f}")

    net = ODENet(trainer.full_params(), trainer.model_cfg)
    x_test, y_test = load_dataset(DATASET, "test", limit=n_test)
    ts = time_grid(TIMES, dev)
    with torch.no_grad():
        feats, stats = net.features(
            normalize(torch.from_numpy(x_test).to(dev), DATASET), ts)
    log(f"\nfeatures {tuple(feats.shape)} from one solve "
        f"(mean NFE {float(stats.nfe.float().mean()):.1f})\n")
    maps = []
    for i, t in enumerate(ts.cpu().numpy()):
        maps.append(retrieval_map(feats[i], y_test, device=dev))
        log(f"t={t:.3f}  retrieval mAP={maps[-1]:.4f}")
    return {"trainer": trainer, "ts": ts, "features": feats, "stats": stats,
            "maps": np.asarray(maps)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    return run(device="cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    main()
