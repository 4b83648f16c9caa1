"""Weights across the two packages: JAX param dicts → port params, and the
torch-convention state dict in both naming styles.

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

The msgpack checkpoint read and write are not ported yet (ROADMAP.md,
Queue 1 item 5).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["from_jax_params", "to_torch_state_dict", "from_torch_state_dict"]


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
