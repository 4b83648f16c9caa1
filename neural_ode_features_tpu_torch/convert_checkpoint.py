"""Convert checkpoints between the port's ``.pt`` format and the
torch-convention pickle of the JAX package's converter (port of the JAX
tool ``tools/convert_checkpoint.py``).

    # a port .pt or a JAX .msgpack -> the converter's torch pickle
    python -m neural_ode_features_tpu_torch.convert_checkpoint to-torch \\
        runs/<run>/ckpt_best.pt out.pt

    # the pickle (or a bare state dict) -> a port .pt with its .json sidecar
    python -m neural_ode_features_tpu_torch.convert_checkpoint from-torch \\
        out.pt ckpt.pt [--config runs/<run>/ckpt_best.pt.json]

``to-torch`` writes what the JAX tool writes, ``{"state_dict", "config",
"extra"}`` with the same names and layouts (``utils/checkpoint.py``
``to_torch_state_dict``), so the JAX tool's ``from-torch`` turns it into a
``.msgpack``.  ``from-torch`` takes the architecture from ``--config`` (a
checkpoint's ``.json`` sidecar) or from the pickle and writes the port's
checkpoint.  Writing ``.msgpack`` is the JAX tool's job: its byte format is
flax's serializer, which the port does not carry.  Runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import torch

from .models.common import ModelConfig
from .utils.checkpoint import (
    from_torch_state_dict,
    load_checkpoint,
    save_checkpoint,
    to_torch_state_dict,
)

__all__ = ["parse_args", "main", "to_torch", "from_torch"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", choices=["to-torch", "from-torch"])
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--config", default=None,
                   help="(from-torch) checkpoint .json with the model config")
    return p.parse_args(argv)


def _refuse_msgpack(dst: Path) -> None:
    if dst.suffix == ".msgpack":
        raise SystemExit(
            f"{dst}: the port does not write .msgpack (flax's serializer is "
            "not part of it); write a .pt here, or run the JAX tool "
            "tools/convert_checkpoint.py from-torch on a to-torch pickle")


def to_torch(src, dst) -> int:
    """``src`` (a port ``.pt``, a JAX ``.msgpack`` or a converter pickle)
    as the JAX converter's pickle at ``dst``; returns the tensor count."""
    _refuse_msgpack(Path(dst))
    params, cfg, extra = load_checkpoint(src, device="cpu")
    sd = to_torch_state_dict(params)
    torch.save({"state_dict": sd, "config": dataclasses.asdict(cfg),
                "extra": extra}, dst)
    return len(sd)


def from_torch(src, dst, config=None) -> None:
    """The pickle (or bare state dict) at ``src`` as a port checkpoint
    ``dst`` + ``dst.json``; the architecture from the ``config`` sidecar
    or from the pickle."""
    dst = Path(dst)
    _refuse_msgpack(dst)
    blob = torch.load(src, map_location="cpu", weights_only=True)
    sd = blob["state_dict"] if "state_dict" in blob else blob
    if config:
        meta = json.loads(Path(config).read_text())
    elif "config" in blob:
        meta = blob
    else:
        raise SystemExit("need --config to rebuild the architecture")
    cfg = ModelConfig(**meta["config"])
    extra = meta.get("extra", {})
    from .models import init_odenet, init_resnet

    init_fn = init_resnet if extra.get("model", "odenet") == "resnet" \
        else init_odenet
    params = from_torch_state_dict(init_fn(0, cfg, device="cpu"), sd)
    save_checkpoint(dst, params, cfg, extra=extra)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.mode == "to-torch":
        n = to_torch(args.src, args.dst)
        print(f"wrote torch checkpoint {args.dst} ({n} tensors)")
    else:
        from_torch(args.src, args.dst, args.config)
        print(f"wrote {args.dst}")


if __name__ == "__main__":
    main()
