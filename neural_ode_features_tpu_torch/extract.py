"""Extract continuous features at a sweep of integration times t ∈ [0, 1]
(port of the JAX CLI ``extract.py``).

    python -m neural_ode_features_tpu_torch.extract --run <run dir or ckpt_*.pt>

Load a trained checkpoint, run every image through the ODE block with
``t = linspace(0, 1, N)`` (ONE solve per batch: dense output yields all N
states), global-average-pool each state into a feature vector, and write the
per-t feature matrices to one file in the run directory (layout:
``features_io.py``).  ResNet checkpoints tap the discrete block boundaries
instead (block k ↦ t = k/num_blocks).

Runs on the card unless ``--cpu`` is given.  The flags are the JAX CLI's.
The one difference is the default output, ``features_<split>.npz`` where
the JAX CLI writes ``.h5``: HDF5 needs ``h5py``; name an ``.h5`` with
``--output`` to write one.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import numpy as np
import torch

from ._device import strict_f32, tree_to
from .data import Batches, load_dataset
from .features_io import save_features
from .models import (
    ModelConfig,
    odenet_logits,
    odenet_trajectory,
    pool_features,
    resnet_block_states,
)
from .ops.preprocess import normalize
from .utils.checkpoint import load_checkpoint, resolve_checkpoint

__all__ = ["parse_args", "main", "extract_features", "time_grid"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--run", required=True,
                   help="run directory or checkpoint path")
    p.add_argument("--ckpt", default="ckpt_best.pt",
                   help="checkpoint file name inside --run")
    p.add_argument("--timestamps", type=int, default=11,
                   help="number of t values in linspace(0, 1, N)")
    p.add_argument("--split", default="test", choices=["train", "test"])
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--output", default=None,
                   help="output path, .npz or .h5 (default: "
                        "features_<split>.npz in the run directory)")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--nfe-sort", action="store_true",
                   help="order samples by a cheap 10x-loose-tolerance NFE "
                        "pre-pass so each batch is NFE-homogeneous (the "
                        "per-sample solve runs until its slowest sample "
                        "finishes; mixed batches pay the max). Only helps "
                        "when per-sample NFE actually varies; the output "
                        "keeps the dataset's order")
    p.add_argument("--fused", action="store_true",
                   help="accepted for the JAX CLI's sake and gives the same "
                        "file: there it folds all batches into one device "
                        "dispatch to save a per-dispatch cost that eager "
                        "PyTorch on a local card does not have, so the "
                        "per-batch loop runs here")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain PyTorch path on the CPU")
    return p.parse_args(argv)


def time_grid(n: int, device) -> torch.Tensor:
    """``linspace(0, 1, n)`` in float64, rounded once to f32: the f32 values
    nearest to k/(n-1) (an f32 linspace is an ulp off at some n)."""
    return torch.from_numpy(np.linspace(0.0, 1.0, n).astype(np.float32)
                            ).to(device)


def _valid_nfe(nfe: torch.Tensor, valid: np.ndarray) -> np.ndarray:
    """Per-valid-sample NFE: global error control yields a (1,) NFE per
    batch; broadcast it to the batch before masking off padded rows."""
    nfe = nfe.cpu().numpy()
    if nfe.shape[0] != valid.shape[0]:
        nfe = np.broadcast_to(nfe, valid.shape)
    return nfe[valid]


@torch.no_grad()
def extract_features(params, cfg: ModelConfig, images: np.ndarray,
                     labels: np.ndarray, *, dataset: str,
                     timestamps: int = 11, batch_size: int = 256,
                     nfe_sort: bool = False, device="cuda") -> dict:
    """Features of ``images`` (N, H, W, C) uint8 at every t, in the order
    given: ``{"t" (T,) f32, "features" (T, N, C) f32, "labels" (N,) i32,
    "nfe" (N,) i32}`` as numpy arrays.

    ``params`` with a ``blocks`` list are a ResNet's (T = num_blocks + 1,
    NFE 0); otherwise an ODE-Net's, solved once per batch over
    ``linspace(0, 1, timestamps)``.  Batches are padded to ``batch_size``
    with zero images whose rows are dropped; per-sample error control makes
    the valid rows independent of the padding.  Images go to the device one
    batch at a time and are normalised there; the features come back once
    per batch.  ``nfe_sort``: see ``--nfe-sort``."""
    dev = strict_f32(device)
    params = tree_to(params, dev)
    odenet = "blocks" not in params

    def to_device(img_u8):
        return normalize(torch.from_numpy(img_u8).to(dev), dataset)

    order = None
    if nfe_sort and odenet:
        # Cheap pre-pass: per-sample NFE at a loose tolerance strongly
        # predicts the NFE ordering at the target tolerance.
        cfg_loose = dataclasses.replace(cfg, tol=min(cfg.tol * 10, 1e-1),
                                        adjoint=False)
        probe_b = Batches(images, labels, batch_size, shuffle=False,
                          drop_remainder=False)
        nfe_pred = np.concatenate([
            _valid_nfe(odenet_logits(params, to_device(img), cfg_loose)[1].nfe,
                       valid)
            for img, _, valid in probe_b.padded_batches()])
        order = np.argsort(nfe_pred, kind="stable")
        images, labels = images[order], labels[order]
        print(f"nfe-sort: predicted NFE spread "
              f"{nfe_pred.min()}..{nfe_pred.max()}")

    if odenet:
        ts = time_grid(timestamps, dev)

        def extract_batch(x):
            traj, stats = odenet_trajectory(params, x, ts, cfg)
            return pool_features(traj), stats.nfe
    else:
        ts = time_grid(cfg.num_blocks + 1, dev)

        def extract_batch(x):
            feats = pool_features(resnet_block_states(params, x, cfg))
            return feats, torch.zeros((x.shape[0],), dtype=torch.int32)

    batches = Batches(images, labels, batch_size, shuffle=False,
                      drop_remainder=False)
    feats_parts, nfe_parts, label_parts = [], [], []
    for img, lab, valid in batches.padded_batches():
        f, nfe = extract_batch(to_device(img))
        feats_parts.append(f.float().cpu().numpy()[:, valid])
        nfe_parts.append(_valid_nfe(nfe, valid).astype(np.int32))
        label_parts.append(lab[valid])

    features = np.concatenate(feats_parts, axis=1)  # (T, N, C)
    nfe = np.concatenate(nfe_parts)
    labels_out = np.concatenate(label_parts).astype(np.int32)
    if order is not None:  # restore the dataset's original sample order
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        features, nfe, labels_out = features[:, inv], nfe[inv], labels_out[inv]
    return {"t": ts.cpu().numpy(), "features": features,
            "labels": labels_out, "nfe": nfe}


def main(argv=None) -> Path:
    args = parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    ckpt_path = resolve_checkpoint(args.run, name=args.ckpt)
    run_dir = ckpt_path.parent
    params, cfg, extra = load_checkpoint(ckpt_path, device=device)
    model = extra.get("model", "odenet")
    dataset = extra.get("train", {}).get("dataset") or (
        "mnist" if cfg.in_channels == 1 else "cifar10")
    print(f"checkpoint: {ckpt_path} (model={model}, dataset={dataset}, "
          f"tol={cfg.tol})")

    images, labels = load_dataset(dataset, args.split, args.data_dir,
                                  limit=args.limit)
    out = extract_features(params, cfg, images, labels, dataset=dataset,
                           timestamps=args.timestamps,
                           batch_size=args.batch_size,
                           nfe_sort=args.nfe_sort, device=device)
    out_path = Path(args.output) if args.output else (
        run_dir / f"features_{args.split}.npz")
    save_features(out_path, **out, dataset=dataset, model=model, tol=cfg.tol)
    print(f"wrote {out_path}: features {out['features'].shape}, "
          f"mean NFE {out['nfe'].mean():.1f}")
    return out_path


if __name__ == "__main__":
    main()
