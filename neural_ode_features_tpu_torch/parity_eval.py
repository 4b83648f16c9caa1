"""Accuracy-parity protocol: one checkpoint, one test split, two execution
paths (port of the JAX tool ``tools/parity_eval.py``).

    python -m neural_ode_features_tpu_torch.parity_eval --run <run dir> \\
        [--limit 2000] [--tol 1e-3] [--device cuda]

The JAX tool holds the JAX package against a torch oracle on the CPU.  Here
the oracle is the port's own plain path on the CPU (the plain PyTorch
versions of the kernels; the JAX stack is not imported): the same weights
evaluate the same split through the kernels on ``--device`` and through the
plain path on the CPU, both with the checkpoint's config at ``--tol`` and
per-sample error control.  Prints ONE JSON line with both top-1s, their
difference, the top-1 agreement and the largest logit difference; exits 1
if |top1_kernels - top1_plain| > 0.2% (the JAX tool's parity clause).

``--run`` is a run directory of either package or a checkpoint file (as
``eval_ckpt``); ``--ckpt`` names the file inside a run directory (the
port's ``ckpt_best.pt``; a JAX run directory falls back to its
``ckpt_best.msgpack``).  ``--cpu`` is ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from ._device import strict_f32
from .data import load_dataset
from .models import odenet_logits, resnet_logits
from .ops.preprocess import normalize
from .utils.checkpoint import load_checkpoint, resolve_checkpoint

__all__ = ["parse_args", "main", "logits_over"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--run", required=True,
                   help="run directory (from train) or checkpoint path")
    p.add_argument("--ckpt", default="ckpt_best.pt")
    p.add_argument("--tol", type=float, default=1e-3)
    p.add_argument("--limit", type=int, default=2000,
                   help="test images to evaluate (the plain path on the "
                        "CPU takes seconds per batch)")
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="where the kernel side runs (the plain side runs on "
                        "the CPU)")
    p.add_argument("--cpu", action="store_true", help="--device cpu")
    return p.parse_args(argv)


@torch.no_grad()
def logits_over(params, images_u8: np.ndarray, dataset: str, cfg,
                batch_size: int, device) -> np.ndarray:
    """Logits of ``images_u8`` (N, H, W, C) uint8 in batches, on the
    device ``params`` live on."""
    out = []
    for lo in range(0, len(images_u8), batch_size):
        x = normalize(torch.from_numpy(images_u8[lo:lo + batch_size])
                      .to(device), dataset)
        if "blocks" in params:
            logits = resnet_logits(params, x, cfg)
        else:
            logits, _ = odenet_logits(params, x, cfg)
        out.append(logits.float().cpu().numpy())
    return np.concatenate(out)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = strict_f32("cpu" if args.cpu else args.device)
    cpu = strict_f32("cpu")
    ckpt_path = resolve_checkpoint(args.run, name=args.ckpt)
    params, cfg0, extra = load_checkpoint(ckpt_path, device=dev)
    params_cpu, _, _ = load_checkpoint(ckpt_path, device=cpu)
    dataset = extra.get("train", {}).get("dataset") or (
        "mnist" if cfg0.in_channels == 1 else "cifar10")
    cfg = dataclasses.replace(cfg0, tol=args.tol, adjoint=False,
                              error_control="per_sample")
    print(f"checkpoint: {ckpt_path} (dataset={dataset}, tol={args.tol}, "
          f"n={args.limit}, device={dev})", file=sys.stderr)

    images, labels = load_dataset(dataset, "test", args.data_dir,
                                  limit=args.limit)
    n = len(images)
    logits_k = logits_over(params, images, dataset, cfg, args.batch_size, dev)
    logits_p = logits_over(params_cpu, images, dataset, cfg, args.batch_size,
                           cpu)
    preds_k, preds_p = logits_k.argmax(-1), logits_p.argmax(-1)
    top1_k = float((preds_k == labels[:n]).mean())
    top1_p = float((preds_p == labels[:n]).mean())
    diff = abs(top1_k - top1_p)
    max_abs = float(np.max(np.abs(logits_k - logits_p)))
    result = {
        "metric": "top1_parity_kernels_vs_plain_cpu",
        "dataset": dataset,
        "tol": args.tol,
        "n": int(n),
        "device": str(dev),
        "top1_kernels": round(top1_k, 6),
        "top1_plain": round(top1_p, 6),
        "abs_diff": round(diff, 6),
        "within_0.2pct": bool(diff <= 0.002),
        "pred_agreement": round(float((preds_k == preds_p).mean()), 6),
        "max_abs_logit_diff": max_abs,
        "max_rel_logit_diff": max_abs / max(float(np.max(np.abs(logits_p))),
                                            1e-12),
    }
    print(json.dumps(result))
    return 0 if diff <= 0.002 else 1


if __name__ == "__main__":
    sys.exit(main())
