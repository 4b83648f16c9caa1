"""Tolerance sweep: batched inference with per-sample adaptive steps across
an rtol/atol grid (port of the JAX CLI ``sweep.py``).

    python -m neural_ode_features_tpu_torch.sweep --tols 1e-1,1e-2,1e-3,1e-4
    python -m neural_ode_features_tpu_torch.sweep --run runs/<dir> --limit 2048
    python -m neural_ode_features_tpu_torch.sweep --fused --run runs/<dir>

For each tolerance: throughput (img/s), per-sample NFE statistics and, when
a checkpoint and a dataset are given, top-1 accuracy: the accuracy-vs-cost
curve.  Writes a CSV with the JAX CLI's columns and prints one row per
tolerance.  Without ``--run`` the model is random (seed 7) and only speed
and NFE are reported.

``--fused`` runs the whole grid in one solve per batch.  In JAX the
tolerance is a traced scalar vmapped over the grid; here the per-sample
controller already gives every row its own ``(t, dt, done)``, so the grid is
stacked on the batch axis: T copies of a batch's stem output as T·B rows,
row i·B + j carrying tolerance i (``models.odenet_solve(tol=(T·B,))``), one
fused-step launch per attempt for all tolerances.  One CTA per sample makes
a row independent of its neighbours, so ``top1`` and the NFE columns equal
the per-tolerance loop's; rows carry the shared ``sweep_s`` in place of
``ips``.

Runs on the card unless ``--cpu`` is given.  Timed regions end in
``torch.cuda.synchronize()``; the warm-up is outside them.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import time

import numpy as np
import torch

from ._device import strict_f32
from .data import load_dataset
from .models import (
    ModelConfig,
    head_apply,
    init_odenet,
    odenet_logits,
    odenet_solve,
    stem_apply,
)
from .ops.preprocess import normalize
from .utils.checkpoint import load_checkpoint, resolve_checkpoint

__all__ = ["parse_args", "main", "stacked_logits"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tols", default="1e-1,1e-2,1e-3,1e-4")
    p.add_argument("--run", default=None,
                   help="run dir / checkpoint: sweep a trained model and "
                        "report accuracy (default: random init, speed only)")
    p.add_argument("--dataset", default=None)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--limit", type=int, default=1024)
    p.add_argument("--method", default=None,
                   help="override the solver (default: checkpoint's)")
    p.add_argument("--error-control", default="per_sample",
                   choices=["per_sample", "global"])
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 dynamics compute (solver control stays "
                        "f32): on the card the ODEfunc kernel's bf16 build, "
                        "one launch per evaluation and no fused step")
    p.add_argument("--pallas", action="store_true",
                   help="accepted for the JAX CLI's sake and changes "
                        "nothing: on the card the fused ODEfunc kernel "
                        "always runs, and the fused step kernel whenever "
                        "models.fused_rk_eligible says so")
    p.add_argument("--fused", action="store_true",
                   help="run the whole tolerance grid in one solve per "
                        "batch: the grid stacked on the batch axis, each row "
                        "with its own tolerance (needs --error-control "
                        "per_sample). Rows report sweep_s (shared wall "
                        "clock) in place of per-tolerance ips; NFE is the "
                        "per-tolerance cost")
    p.add_argument("--output", default="tolerance_sweep.csv")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain PyTorch path on the CPU")
    return p.parse_args(argv)


def stacked_logits(params, h0_stack: torch.Tensor, cfg: ModelConfig,
                   tol_rows: torch.Tensor, n_tols: int):
    """One solve for ``n_tols`` tolerances: ``h0_stack`` holds ``n_tols``
    blocks of B stem outputs, ``tol_rows`` (n_tols·B,) each row's
    tolerance.  The head runs block by block, at the per-tolerance loop's
    shapes, so that its bits are the loop's.  Returns ``((n_tols, B, K)
    logits, (n_tols, B) NFE)``."""
    ts = torch.tensor([0.0, 1.0], dtype=h0_stack.dtype,
                      device=h0_stack.device)
    traj, stats = odenet_solve(params, h0_stack, ts, cfg, tol=tol_rows)
    logits = torch.stack([head_apply(params["head"], h, cfg)
                          for h in traj[-1].chunk(n_tols)])
    return logits, stats.nfe.reshape(n_tols, -1)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _noise(batch: int, channels: int, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(0).normal(
        size=(batch, 32, 32, channels)).astype(np.float32)).to(dev)


def _batches(images, labels, batch_size: int, dataset: str, dev):
    for lo in range(0, len(images), batch_size):
        x = normalize(torch.from_numpy(images[lo:lo + batch_size]).to(dev),
                      dataset)
        yield x, torch.from_numpy(
            labels[lo:lo + batch_size].astype(np.int64)).to(dev)


@torch.no_grad()
def _loop_sweep(args, params, cfg0, tols, dataset, images, labels, dev):
    rows = []
    for tol in tols:
        cfg = dataclasses.replace(cfg0, tol=tol)
        if images is not None:
            x0, _ = next(_batches(images, labels, args.batch_size, dataset,
                                  dev))
            odenet_logits(params, x0, cfg)  # warm-up, outside the timed region
            _sync(dev)
            correct = torch.zeros((), device=dev)
            nfes = []
            t0 = time.perf_counter()
            for x, lab in _batches(images, labels, args.batch_size, dataset,
                                   dev):
                logits, stats = odenet_logits(params, x, cfg)
                correct += (logits.argmax(-1) == lab).sum()
                nfes.append(stats.nfe)
            _sync(dev)
            dt = time.perf_counter() - t0
            nfes = torch.cat(nfes).cpu().numpy()
            row = {
                "tol": tol,
                "top1": round(float(correct) / len(images), 4),
                "ips": round(len(images) / dt, 1),
                "nfe_mean": round(float(nfes.mean()), 1),
                "nfe_min": int(nfes.min()),
                "nfe_max": int(nfes.max()),
            }
        else:
            xx = _noise(args.batch_size, cfg.in_channels, dev)
            odenet_logits(params, xx, cfg)  # warm-up
            _sync(dev)
            x_i, nfe_acc = xx, torch.zeros((), device=dev)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                logits, stats = odenet_logits(params, x_i, cfg)
                x_i = xx + logits.mean() * 1e-6
                nfe_acc += stats.nfe.float().mean()
            _sync(dev)
            dt = time.perf_counter() - t0
            row = {
                "tol": tol,
                "ips": round(args.batch_size * args.iters / dt, 1),
                "nfe_mean": round(float(nfe_acc) / args.iters, 1),
            }
        rows.append(row)
        print(" | ".join(f"{k}={v}" for k, v in row.items()), flush=True)
    return rows


@torch.no_grad()
def _fused_sweep(args, params, cfg, tols, dataset, images, labels, dev):
    """``--fused``: the grid stacked on the batch axis, one solve per batch
    (see the module docstring)."""
    if cfg.error_control != "per_sample":
        raise SystemExit("--fused stacks the tolerance grid on the batch "
                         "axis, one tolerance per row: it needs "
                         "--error-control per_sample")
    n_tols, bs = len(tols), args.batch_size
    tol_rows = torch.tensor(tols, dtype=torch.float32,
                            device=dev).repeat_interleave(bs)

    if images is not None:
        def stacked(x):
            h0 = stem_apply(params["stem"], x, cfg)
            return stacked_logits(params, h0.repeat(n_tols, 1, 1, 1), cfg,
                                  tol_rows, n_tols)

        stacked(next(_batches(images, labels, bs, dataset, dev))[0])
        _sync(dev)  # warm-up, outside the timed region
        correct = torch.zeros((n_tols,), device=dev)
        nfes = []
        t0 = time.perf_counter()
        for x, lab in _batches(images, labels, bs, dataset, dev):
            logits, nfe = stacked(x)
            correct += (logits.argmax(-1) == lab[None]).sum(dim=1)
            nfes.append(nfe)
        _sync(dev)
        dt = time.perf_counter() - t0
        nfes = torch.cat(nfes, dim=1).cpu().numpy()
        correct = correct.cpu().numpy()
        rows = [{
            "tol": tols[i],
            "top1": round(float(correct[i]) / len(images), 4),
            "nfe_mean": round(float(nfes[i].mean()), 1),
            "nfe_min": int(nfes[i].min()),
            "nfe_max": int(nfes[i].max()),
            "sweep_s": round(dt, 3),
        } for i in range(n_tols)]
    else:
        xx = _noise(bs, cfg.in_channels, dev)

        def stacked(x_stack):
            return stacked_logits(
                params, stem_apply(params["stem"], x_stack, cfg), cfg,
                tol_rows, n_tols)

        stacked(xx.repeat(n_tols, 1, 1, 1))
        _sync(dev)  # warm-up
        x_stack = xx.repeat(n_tols, 1, 1, 1)
        nfe_acc = torch.zeros((n_tols,), device=dev)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            logits, nfe = stacked(x_stack)
            live = logits.mean(dim=(1, 2)) * 1e-6  # one carry per tolerance
            x_stack = (xx[None] + live[:, None, None, None, None]).reshape(
                x_stack.shape)
            nfe_acc += nfe.float().mean(dim=1)
        _sync(dev)
        dt = time.perf_counter() - t0
        nfe_means = (nfe_acc / args.iters).cpu().numpy()
        rows = [{
            "tol": tols[i],
            "nfe_mean": round(float(nfe_means[i]), 1),
            "sweep_s": round(dt, 3),
        } for i in range(n_tols)]

    for row in rows:
        print(" | ".join(f"{k}={v}" for k, v in row.items()), flush=True)
    return rows


def main(argv=None):
    args = parse_args(argv)
    dev = strict_f32("cpu" if args.cpu else "cuda")

    if args.run:
        params, cfg0, extra = load_checkpoint(resolve_checkpoint(args.run),
                                              device=dev)
        if "odefunc" not in params:
            raise SystemExit(f"{args.run}: a tolerance sweep needs an "
                             "ODE-Net checkpoint")
        dataset = args.dataset or extra.get("train", {}).get("dataset")
    else:
        cfg0 = ModelConfig(in_channels=3)
        params = init_odenet(7, cfg0, device=dev)
        dataset = args.dataset

    images = labels = None
    if dataset:
        images, labels = load_dataset(dataset, "test", limit=args.limit)
        args.batch_size = min(args.batch_size, len(images))
        n = (len(images) // args.batch_size) * args.batch_size
        images, labels = images[:n], labels[:n]
        if not args.run and images.shape[-1] != cfg0.in_channels:
            # Random-init sweep on a 1-channel dataset: rebuild the model
            # at the dataset's channel count.
            cfg0 = ModelConfig(in_channels=images.shape[-1])
            params = init_odenet(7, cfg0, device=dev)

    tols = [float(s) for s in args.tols.split(",")]
    # An inference sweep: never through the adjoint path.
    cfg = dataclasses.replace(
        cfg0, method=args.method or cfg0.method,
        error_control=args.error_control,
        compute_dtype="bfloat16" if args.bf16 else cfg0.compute_dtype,
        adjoint=False)
    sweep = _fused_sweep if args.fused else _loop_sweep
    rows = sweep(args, params, cfg, tols, dataset, images, labels, dev)

    with open(args.output, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {args.output}")
    return rows


if __name__ == "__main__":
    main()
