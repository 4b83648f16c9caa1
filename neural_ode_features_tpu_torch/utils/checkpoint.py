"""Checkpoints and weights across the two packages: the port's ``.pt``
checkpoint files, the JAX package's ``.msgpack`` checkpoints and the torch
pickle of its converter, JAX param dicts → port params, and the
torch-convention state dict in both naming styles.

The port's native checkpoint is ``<path>`` (``ckpt_*.pt``), a ``torch.save``
of the ``'internal'``-style state dict (a flat ``dict[str, Tensor]``: OIHW
convs, (out, in) linears, dotted names), beside the same ``<path>.json``
sidecar (``config``, ``extra``) as the JAX writer.  That state dict is the
JAX package's own documented torch surface, so its ``from_torch_state_dict``
reads a ``.pt`` back, and a ``.pt`` written from its ``to_torch_state_dict``
loads here.

The port's own copy of the name and layout map of the JAX package's
``utils/checkpoint.py`` (HWIO → OIHW convs, (in, out) → (out, in) linears,
GroupNorm ``scale`` → ``weight``); a test holds it key for key and array for
array against the JAX converter.  Styles:

``'internal'`` (default): dotted module paths — ``stem.conv0.weight``,
``odefunc.conv1.weight``, ``head.fc.weight`` …

``'reference'``: the reference repo's presumed ``nn.Sequential`` names::

  stem.conv0           downsampling_layers.0
  stem.norm1           downsampling_layers.1
  stem.conv1           downsampling_layers.3
  stem.norm2           downsampling_layers.4
  stem.conv2           downsampling_layers.6
  odefunc.normK        feature_layers.0.odefunc.normK
  odefunc.convK        feature_layers.0.odefunc.convK._layer
  head.norm            fc_layers.0
  head.fc              fc_layers.4
  blocks.K.*           feature_layers.K.*            (ResNet)

:func:`load_checkpoint` also reads what the JAX package writes:

* ``<path>.msgpack`` beside ``<path>.msgpack.json`` (``config``,
  ``extra.model``: ``odenet`` or ``resnet``), flax's ``to_bytes`` of the
  param tree, decoded by :mod:`.flax_msgpack` (no flax, no ``msgpack``);
* the pickle of ``tools/convert_checkpoint.py to-torch``,
  ``{"state_dict", "config", "extra"}``, its state dict in either naming
  style.

Writing ``.msgpack`` is not ported: the port writes ``.pt``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from .._device import resolve_device
from ..models.common import ModelConfig
from .flax_msgpack import unpackb

__all__ = ["save_checkpoint", "load_checkpoint", "resolve_checkpoint",
           "from_jax_params", "to_torch_state_dict", "from_torch_state_dict"]


def _sidecar(path: Path) -> Path:
    return path.with_suffix(path.suffix + ".json")


def resolve_checkpoint(path: str | Path, name: str = "ckpt_best.pt") -> Path:
    """Resolve a CLI ``--run`` argument to a checkpoint file: a checkpoint
    file is returned as it is.  Inside a run directory: the port's ``name``,
    else ``ckpt_last.pt`` (a run interrupted before its first eval never
    wrote a "best"); in a JAX run directory, which has neither,
    ``ckpt_best.msgpack``, else ``ckpt_last.msgpack`` (the JAX package's
    own policy).  With none of them, the ``ckpt_last.pt`` that is
    missing."""
    p = Path(path)
    if p.is_dir():
        for cand in (name, "ckpt_last.pt", "ckpt_best.msgpack",
                     "ckpt_last.msgpack"):
            if (p / cand).exists():
                return p / cand
        return p / "ckpt_last.pt"
    return p


def save_checkpoint(path: str | Path, params: Any, cfg: ModelConfig,
                    extra: dict | None = None) -> None:
    """Write ``<path>`` (the 'internal' state dict of ``params``) and
    ``<path>.json`` (config + extra)."""
    path = Path(path)
    if path.suffix == ".msgpack":
        raise NotImplementedError(
            f"{path}: writing a JAX .msgpack checkpoint is not ported; the "
            "port writes .pt checkpoints (and reads .msgpack)")
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(to_torch_state_dict(params), path)
    meta = {"config": dataclasses.asdict(cfg), "extra": extra or {}}
    _sidecar(path).write_text(json.dumps(meta, indent=2))


def load_checkpoint(path: str | Path, init_fn=None, *,
                    device="cuda") -> tuple[Any, ModelConfig, dict]:
    """Read ``(params, cfg, extra)``, the params on ``device``, from the
    port's ``.pt`` + ``.json``, a JAX ``.msgpack`` + ``.json`` or the JAX
    converter's ``to-torch`` pickle (config and extra inside it).
    ``init_fn(seed, cfg, device=...) -> template`` defaults to the
    initialiser of the persisted ``extra['model']`` family.  The ``config``
    may be the JAX package's: the two dataclasses share every field, and
    the port does not read the TPU opt-ins."""
    dev = resolve_device(device)
    path = Path(path)
    if path.suffix == ".msgpack":
        state = unpackb(path.read_bytes())
        meta = json.loads(_sidecar(path).read_text())
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
        if "state_dict" in state:  # tools/convert_checkpoint.py to-torch
            meta, state = state, state["state_dict"]
        else:
            meta = json.loads(_sidecar(path).read_text())
    cfg = ModelConfig(**meta["config"])
    extra = meta.get("extra", {})
    if init_fn is None:
        from ..models import init_odenet, init_resnet

        init_fn = (init_resnet if extra.get("model", "odenet") == "resnet"
                   else init_odenet)
    template = init_fn(0, cfg, device=dev)
    if path.suffix == ".msgpack":
        params = from_jax_params(_from_state_dict(template, state),
                                 device=dev)
    else:
        params = from_torch_state_dict(template, state)
    return params, cfg, extra


def _from_state_dict(template: Any, state: Any, name: str = "") -> Any:
    """A flax state dict (nested dicts, a list's items under ``'0'``,
    ``'1'``, …) as a tree of the template's structure, each array checked
    against the template leaf's shape.  Keys must match exactly."""
    if isinstance(template, (dict, list, tuple)):
        keys = (list(template) if isinstance(template, dict)
                else [str(i) for i in range(len(template))])
        if not isinstance(state, dict) or set(state) != set(keys):
            got = sorted(state) if isinstance(state, dict) else type(state)
            raise ValueError(f"checkpoint tree at {name or '/'}: keys {got}, "
                             f"expected {sorted(keys)}")
        items = (template.items() if isinstance(template, dict)
                 else zip(keys, template))
        out = {k: _from_state_dict(v, state[k], f"{name}/{k}")
               for k, v in items}
        return out if isinstance(template, dict) else type(template)(
            out[k] for k in keys)
    if not isinstance(state, np.ndarray) or state.shape != tuple(
            template.shape):
        got = state.shape if isinstance(state, np.ndarray) else type(state)
        raise ValueError(f"checkpoint leaf {name}: {got}, expected an array "
                         f"of shape {tuple(template.shape)}")
    return state


def from_jax_params(params: Any, *, device="cuda") -> Any:
    """A JAX-package param dict (numpy or array-like leaves, same nesting
    and HWIO layout) as port params: f32-preserving torch tensors on
    ``device``.  The two packages share the public layout, so only the
    array type changes."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return torch.from_numpy(np.array(node, copy=True)).to(dev)

    return conv(params)


def _flatten(params: Any, prefix="") -> dict[str, torch.Tensor]:
    out = {}
    if isinstance(params, dict):
        for k, v in params.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = params
    return out


# internal dotted prefix → reference-style prefix ('reference' naming style).
_REFERENCE_PREFIX = {
    "stem.conv0": "downsampling_layers.0",
    "stem.norm1": "downsampling_layers.1",
    "stem.conv1": "downsampling_layers.3",
    "stem.norm2": "downsampling_layers.4",
    "stem.conv2": "downsampling_layers.6",
    "odefunc.norm1": "feature_layers.0.odefunc.norm1",
    "odefunc.conv1": "feature_layers.0.odefunc.conv1._layer",
    "odefunc.norm2": "feature_layers.0.odefunc.norm2",
    "odefunc.conv2": "feature_layers.0.odefunc.conv2._layer",
    "odefunc.norm3": "feature_layers.0.odefunc.norm3",
    "head.norm": "fc_layers.0",
    "head.fc": "fc_layers.4",
}


def _style_prefix(prefix: str, style: str) -> str:
    if style == "internal":
        return prefix
    if prefix in _REFERENCE_PREFIX:
        return _REFERENCE_PREFIX[prefix]
    if prefix.startswith("blocks."):  # ResNet blocks.K.sub → feature_layers.K.sub
        return "feature_layers." + prefix[len("blocks."):]
    return prefix


def _to_torch_name_and_layout(name: str, arr: torch.Tensor):
    """'stem/conv0/kernel' → ('stem.conv0.weight', OIHW tensor); linear
    (in, out) → (out, in); GroupNorm 'scale' → 'weight'."""
    parts = name.split("/")
    leaf = parts[-1]
    tname = ".".join(parts[:-1])
    if leaf == "kernel":
        if arr.ndim == 4:  # HWIO → OIHW
            return f"{tname}.weight", arr.permute(3, 2, 0, 1)
        return f"{tname}.weight", arr.T  # linear (in, out) → (out, in)
    if leaf == "scale":
        return f"{tname}.weight", arr
    return f"{tname}.{leaf}", arr


def to_torch_state_dict(params: Any,
                        style: str = "internal") -> dict[str, torch.Tensor]:
    """Port params as a torch-convention state dict of contiguous CPU
    tensors.  ``style``: 'internal' or 'reference'."""
    if style not in ("internal", "reference"):
        raise ValueError(f"unknown style {style!r}")
    out = {}
    for name, arr in _flatten(params).items():
        tname, tarr = _to_torch_name_and_layout(name, arr.detach().cpu())
        prefix, leaf = tname.rsplit(".", 1)
        out[f"{_style_prefix(prefix, style)}.{leaf}"] = tarr.contiguous()
    return out


def from_torch_state_dict(template: Any, state: dict) -> Any:
    """Inverse of :func:`to_torch_state_dict`: fill a port params template
    from a torch-convention dict (tensors or numpy arrays, either naming
    style).  Values take the template leaves' dtype, shape and device."""

    def _get(name, like):
        parts = name.split("/")
        leaf = parts[-1]
        tname = ".".join(parts[:-1])
        tleaf = "weight" if leaf in ("kernel", "scale") else leaf
        key = f"{tname}.{tleaf}"
        if key not in state:  # accept reference-style names transparently
            key = f"{_style_prefix(tname, 'reference')}.{tleaf}"
        val = state[key]
        arr = (val.detach().cpu() if isinstance(val, torch.Tensor)
               else torch.from_numpy(np.array(val, copy=True)))
        if leaf == "kernel":
            arr = arr.permute(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        return arr.to(dtype=like.dtype, device=like.device).reshape(
            like.shape).contiguous()

    filled = {n: _get(n, a) for n, a in _flatten(template).items()}

    def _rebuild(node, prefix=""):
        if isinstance(node, dict):
            return {k: _rebuild(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            t = [_rebuild(v, f"{prefix}{i}/") for i, v in enumerate(node)]
            return type(node)(t) if isinstance(node, tuple) else t
        return filled[prefix[:-1]]

    return _rebuild(template)
