"""Evaluate a trained checkpoint's test top-1 under solver overrides (port of
the JAX tool ``tools/eval_ckpt.py``, the solver-fidelity → accuracy
ladder's measurement).

    python -m neural_ode_features_tpu_torch.eval_ckpt --run <run dir> \\
        --dataset mnist --data-dir <dir with the raw files>

Prints ONE JSON line, the JAX tool's:
``{"top1", "mean_nfe", "solver", "tol", "steps", "n"}``.  Fixed-grid rungs
(``--solver euler --steps N``) integrate over a uniform (N+1)-point grid;
adaptive rungs use ``--tol`` with per-sample error control.  The split is
cut to whole batches (``--batch-size`` clamped to the split first), as the
JAX tool does.

``--run`` is a run directory of either package (the port's ``ckpt_best.pt``,
else the JAX ``ckpt_best.msgpack``; each falls back to its ``ckpt_last``)
or a checkpoint file: the port's ``.pt``, a JAX ``.msgpack`` or the JAX
converter's torch pickle.  A ResNet checkpoint is evaluated through its
blocks (NFE 0).  Runs on the card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from ._device import strict_f32
from .data import load_dataset
from .extract import time_grid
from .models import head_apply, odenet_trajectory, resnet_logits
from .ops.preprocess import normalize
from .utils.checkpoint import load_checkpoint, resolve_checkpoint

__all__ = ["parse_args", "main"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--run", required=True,
                   help="run directory or checkpoint path")
    p.add_argument("--dataset", default="synthetic-cifar10")
    p.add_argument("--solver", default="dopri5")
    p.add_argument("--tol", type=float, default=1e-3)
    p.add_argument("--steps", type=int, default=None,
                   help="fixed-grid methods: number of uniform steps")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run the plain PyTorch path on the CPU")
    return p.parse_args(argv)


@torch.no_grad()
def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = strict_f32("cpu" if args.cpu else "cuda")
    params, cfg0, _ = load_checkpoint(resolve_checkpoint(args.run),
                                      device=dev)
    cfg = dataclasses.replace(cfg0, method=args.solver, tol=args.tol,
                              adjoint=False, error_control="per_sample")

    x, y = load_dataset(args.dataset, "test", args.data_dir, limit=args.limit)
    ts = time_grid(2 if args.steps is None else args.steps + 1, dev)
    # Clamp to the split so that a --limit below --batch-size still
    # evaluates something; then whole batches only.
    batch = min(args.batch_size, len(x))
    n = (len(x) // batch) * batch

    correct = nfe_sum = 0.0
    for lo in range(0, n, batch):
        xb = normalize(torch.from_numpy(x[lo:lo + batch]).to(dev),
                       args.dataset)
        yb = torch.from_numpy(y[lo:lo + batch].astype(np.int64)).to(dev)
        if "blocks" in params:
            logits, nfe = resnet_logits(params, xb, cfg), torch.zeros(1)
        else:
            traj, stats = odenet_trajectory(params, xb, ts, cfg)
            logits = head_apply(params["head"], traj[-1], cfg)
            nfe = stats.nfe.float()
        correct += float((logits.argmax(dim=-1) == yb).sum())
        nfe_sum += float(nfe.sum())

    result = {
        "top1": round(correct / n, 5),
        "mean_nfe": round(nfe_sum / n, 2),
        "solver": args.solver,
        "tol": args.tol if args.steps is None else None,
        "steps": args.steps,
        "n": n,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
