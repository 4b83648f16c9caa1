"""Export a trained run as a serving artifact for the port's host (the port's
counterpart of the JAX tool ``tools/export_model.py``).

    python -m neural_ode_features_tpu_torch.export_model export-compiled \\
        --run <run dir> --batch 256 [--chain K] [--out DIR] [--cpu]

``export-compiled`` writes the JAX tool's ``.npexec`` directory layout,
which ``python -m neural_ode_features_tpu_torch.serve <dir>`` serves:

  weights.pt            the model's weights, the port's state dict (in place
                        of the JAX tool's ``executable.bin``: the port's
                        host runs the model code, see ``serve.py``)
  sample_input.npy      a deterministic input, numpy seed 0 (f32, C order)
  expected_logits.npy   the live model's logits on it, computed where the
                        export ran (on the card: through the kernels)
  meta.json             the JAX tool's keys (``inputs``, ``outputs``,
                        ``chain``, ``model``, ``rowwise``, ``sha256`` and
                        ``bytes`` of ``weights.pt``, ``config``) with
                        ``format``, ``platform`` and versions

``rowwise`` is the JAX tool's row-independence probe: the model is run
again with the other rows replaced by noise (seeds 1 and 2), and the kept
rows' logits must come out bit-identical.  Only then does the host take
ragged requests and coalesce them.  Per-sample error control passes it (on
the card each sample is one CTA of every kernel); ``error_control='global'``
does not (the step sequence is a reduction over the batch).

``export``, ``run`` and ``export-mock`` have no counterpart yet (ROADMAP.md,
Queue 1 item 9): the adaptive solve's exit depends on the data and the
kernels are not registered as ``torch.library`` operators, so
``torch.export`` cannot capture the path.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import io
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ._device import strict_f32
from .models import (
    ModelConfig,
    init_odenet,
    init_resnet,
    odenet_logits,
    resnet_logits,
)
from .utils.checkpoint import (
    from_torch_state_dict,
    load_checkpoint,
    resolve_checkpoint,
    to_torch_state_dict,
)

__all__ = ["FORMAT", "WEIGHTS", "input_shape", "logits_fn", "load_artifact",
           "do_export_compiled", "main"]

FORMAT = "torch-state-dict"
WEIGHTS = "weights.pt"


def input_shape(cfg: ModelConfig, batch: int, chain: int = 1) -> tuple:
    """The artifact's input: (B, 28|32, 28|32, C_in), NHWC f32, with a
    leading chain axis K when ``chain > 1``."""
    side = 32 if cfg.in_channels == 3 else 28
    shape = (batch, side, side, cfg.in_channels)
    return (chain,) + shape if chain > 1 else shape


def logits_fn(params, cfg: ModelConfig, model: str, chain: int = 1):
    """``fn(x) -> logits`` on tensors, the JAX tool's ``_logits_fn``: the
    ODE-Net's inference path (``adjoint=False``) or the ResNet; with
    ``chain > 1`` one call solves the K batches of a (K, B, ...) input in
    turn."""
    if model == "resnet":
        def inner(x):
            return resnet_logits(params, x, cfg)
    else:
        def inner(x):
            return odenet_logits(params, x, cfg, adjoint=False)[0]

    @torch.no_grad()
    def fn(x):
        if chain > 1:
            return torch.stack([inner(xi) for xi in x])
        return inner(x)
    return fn


def _run(fn, x: np.ndarray, dev: torch.device) -> np.ndarray:
    return np.ascontiguousarray(
        fn(torch.from_numpy(x).to(dev)).cpu().numpy())


def rowwise_probe(fn, x: np.ndarray, logits: np.ndarray,
                  dev: torch.device) -> bool:
    """The JAX tool's probe: rerun with the OTHER rows replaced by noise and
    require the kept rows' outputs bit-identical (seeds 1 and 2)."""
    if not (x.ndim >= 1 and logits.ndim >= 1 and x.shape[0] == logits.shape[0]
            and x.shape[0] >= 2):
        return False
    for probe_seed in (1, 2):
        prng = np.random.default_rng(probe_seed)
        keep = prng.random(x.shape[0]) < 0.5
        if not keep.any() or keep.all():
            keep[0] = True
            keep[-1] = False
        x2 = prng.normal(size=x.shape).astype(np.float32)
        x2[keep] = x[keep]
        if not np.array_equal(_run(fn, x2, dev)[keep], logits[keep]):
            return False
    return True


def do_export_compiled(args) -> Path:
    dev = strict_f32("cpu" if args.cpu else "cuda")
    run = Path(args.run)
    params, cfg, extra = load_checkpoint(resolve_checkpoint(run, args.ckpt),
                                         device=dev)
    model = extra.get("model", "odenet")
    shape = input_shape(cfg, args.batch, args.chain)
    fn = logits_fn(params, cfg, model, args.chain)

    t0 = time.perf_counter()
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    logits = _run(fn, x, dev)
    rowwise = rowwise_probe(fn, x, logits, dev)
    print(f"rowwise probe: {'independent' if rowwise else 'COUPLED'} "
          f"(continuous batching {'enabled' if rowwise else 'disabled'}); "
          f"{time.perf_counter() - t0:.1f} s on {dev.type}",
          file=sys.stderr, flush=True)

    suffix = f"_c{args.chain}" if args.chain > 1 else ""
    base = run if run.is_dir() else run.parent
    out = Path(args.out or (base / f"serve_b{args.batch}{suffix}.npexec"))
    out.mkdir(parents=True, exist_ok=True)
    torch.save(to_torch_state_dict(params), out / WEIGHTS)
    blob = (out / WEIGHTS).read_bytes()
    np.save(out / "sample_input.npy", x)
    np.save(out / "expected_logits.npy", logits)
    meta = {
        "format": FORMAT,
        "platform": dev.type,
        "device_name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu"),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "weights": WEIGHTS,
        "inputs": [{"shape": list(shape), "dtype": "float32"}],
        "chain": args.chain,
        "outputs": [{"shape": list(logits.shape), "dtype": "float32"}],
        "model": model,
        "rowwise": rowwise,
        "sha256": hashlib.sha256(blob).hexdigest(),
        "bytes": len(blob),
        "config": dataclasses.asdict(cfg),
    }
    (out / "meta.json").write_text(json.dumps(meta, indent=2))
    print(f"serving artifact: {out}")
    print(json.dumps({"artifact": str(out), "bytes": len(blob),
                      "sha256": meta["sha256"], "rowwise": rowwise}))
    return out


def load_artifact(art: Path, meta: dict, device: torch.device):
    """``(params, cfg, model)`` from an ``export-compiled`` directory whose
    ``meta.json`` is ``meta``; the weights' sha256 must match it."""
    blob = (art / meta.get("weights", WEIGHTS)).read_bytes()
    if hashlib.sha256(blob).hexdigest() != meta["sha256"]:
        raise ValueError(f"{art}: {WEIGHTS} does not match meta.json sha256")
    cfg = ModelConfig(**meta["config"])
    model = meta.get("model", "odenet")
    init = init_resnet if model == "resnet" else init_odenet
    state = torch.load(io.BytesIO(blob), map_location="cpu", weights_only=True)
    params = from_torch_state_dict(init(0, cfg, device=device), state)
    return params, cfg, model


def _not_ported(mode: str):
    def stop(args):
        raise SystemExit(
            f"export_model {mode} is not ported yet (ROADMAP.md, Queue 1 "
            "item 9): the adaptive solve's exit depends on the data and the "
            "kernels are not torch.library operators, so torch.export "
            "cannot capture the path; use export-compiled and the port's "
            "serving host")
    return stop


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="mode", required=True)
    pc = sub.add_parser("export-compiled",
                        help="write a .npexec artifact for the port's host")
    pc.add_argument("--run", required=True,
                    help="run directory (either package's) or checkpoint")
    pc.add_argument("--ckpt", default="ckpt_best.pt",
                    help="file inside --run (a JAX run directory falls back "
                         "to its ckpt_best.msgpack)")
    pc.add_argument("--batch", type=int, default=256)
    pc.add_argument("--chain", type=int, default=1,
                    help="batches per request: a (K, B, ...) input solved "
                         "batch by batch")
    pc.add_argument("--out", default=None)
    pc.add_argument("--cpu", action="store_true",
                    help="export on the CPU through the plain path")
    pc.set_defaults(fn=do_export_compiled)
    for mode in ("export", "run", "export-mock"):
        sub.add_parser(mode, help="not ported (ROADMAP.md, Queue 1 item "
                                  "9)").set_defaults(fn=_not_ported(mode))
    args, rest = p.parse_known_args(argv)
    if rest and args.mode == "export-compiled":
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    return args.fn(args)


if __name__ == "__main__":
    main()
