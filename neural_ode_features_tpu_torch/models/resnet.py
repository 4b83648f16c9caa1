"""ResNet baseline: stem → K discrete residual blocks → head (port of
``neural_ode_features_tpu/models/resnet.py``).

Per-block feature taps play the role of the ODE-Net's continuous t grid:
block k ↦ t = k / num_blocks.  The convs go through cuDNN (``ops/layers.py``
``conv2d``); the entry points turn TF32 off.
"""

from __future__ import annotations

import torch

from .._device import resolve_device, tree_to
from ..ops.layers import conv2d, group_norm, init_conv, init_group_norm
from .common import ModelConfig, head_apply, init_head, init_stem, stem_apply

__all__ = ["init_resnet", "resnet_logits", "resnet_block_states"]


def _init_block(gen: torch.Generator, h: int):
    return {
        "norm1": init_group_norm(h),
        "conv1": init_conv(gen, 3, 3, h, h),
        "norm2": init_group_norm(h),
        "conv2": init_conv(gen, 3, 3, h, h),
    }


def _block_apply(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    g = cfg.groups
    out = torch.relu(group_norm(params["norm1"], x, groups=g))
    out = conv2d(params["conv1"], out, padding=1)
    out = torch.relu(group_norm(params["norm2"], out, groups=g))
    out = conv2d(params["conv2"], out, padding=1)
    return x + out


def init_resnet(seed: int, cfg: ModelConfig, *, device="cuda"):
    """Random weights from ``seed``, drawn on the CPU from one
    ``torch.Generator`` and moved to ``device`` (as ``init_odenet``)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = {
        "stem": init_stem(gen, cfg),
        "blocks": [_init_block(gen, cfg.hidden)
                   for _ in range(cfg.num_blocks)],
        "head": init_head(gen, cfg),
    }
    return tree_to(params, dev)


def resnet_block_states(params, x: torch.Tensor,
                        cfg: ModelConfig) -> torch.Tensor:
    """All intermediate states: (num_blocks+1, B, H, W, C), the discrete
    analogue of the ODE trajectory (tap k ≙ t = k/num_blocks), used by the
    extraction pipeline."""
    h = stem_apply(params["stem"], x, cfg)
    states = [h]
    for bp in params["blocks"]:
        h = _block_apply(bp, h, cfg)
        states.append(h)
    return torch.stack(states)


def resnet_logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = stem_apply(params["stem"], x, cfg)
    for bp in params["blocks"]:
        h = _block_apply(bp, h, cfg)
    return head_apply(params["head"], h, cfg)
