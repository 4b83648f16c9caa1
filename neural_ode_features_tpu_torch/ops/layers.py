"""Functional NN layers on explicit parameter dicts (port of
``neural_ode_features_tpu/ops/layers.py``).

Public layout is the JAX package's: NHWC activations, HWIO conv kernels,
(in, out) linear kernels, GroupNorm ``scale``/``bias``.  Inside, convs run
through ``F.conv2d`` on NCHW/OIHW views.  Parameters are plain nested dicts
of tensors so that the same dict feeds the plain path, the CUDA kernels and
the checkpoint name map.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

__all__ = [
    "init_conv",
    "conv2d",
    "init_group_norm",
    "group_norm",
    "init_linear",
    "linear",
    "global_avg_pool",
    "concat_conv2d",
    "concat_time_channel",
    "time_map",
]

Params = dict[str, Any]


def _torch_uniform(gen: torch.Generator, shape, fan_in: int,
                   dtype=torch.float32) -> torch.Tensor:
    """U(±1/√fan_in) — torch's kaiming-uniform(a=√5) default for conv and
    linear weight *and* bias (JAX ``ops/layers.py:46``), drawn on the CPU
    from ``gen`` so that a seed gives the same weights on every device."""
    bound = 1.0 / math.sqrt(fan_in)
    u = torch.rand(shape, generator=gen, dtype=dtype)
    return u * (2.0 * bound) - bound


def init_conv(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int,
              *, bias: bool = True, dtype=torch.float32) -> Params:
    """Conv kernel in HWIO layout; torch-default kaiming-uniform(a=√5)."""
    fan_in = kh * kw * cin
    p = {"kernel": _torch_uniform(gen, (kh, kw, cin, cout), fan_in, dtype)}
    if bias:
        p["bias"] = _torch_uniform(gen, (cout,), fan_in, dtype)
    return p


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv2d(params: Params, x: torch.Tensor, *, stride: int = 1,
           padding="SAME") -> torch.Tensor:
    """NHWC conv with an HWIO kernel.  ``padding``: 'SAME' | 'VALID' | int
    (symmetric).  'SAME' supports stride 1 and odd kernels (all uses)."""
    kernel = params["kernel"].to(x.dtype)
    kh, kw = kernel.shape[:2]
    if padding == "SAME":
        if stride != 1 or kh % 2 == 0 or kw % 2 == 0:
            raise NotImplementedError("'SAME' padding: stride 1, odd kernels")
        pad = (kh // 2, kw // 2)
    elif padding == "VALID":
        pad = (0, 0)
    else:
        pad = (int(padding), int(padding))
    bias = params.get("bias")
    out = F.conv2d(_nchw(x), kernel.permute(3, 2, 0, 1),
                   None if bias is None else bias.to(x.dtype),
                   stride=stride, padding=pad)
    return _nhwc(out)


def init_group_norm(c: int, *, dtype=torch.float32) -> Params:
    return {"scale": torch.ones((c,), dtype=dtype),
            "bias": torch.zeros((c,), dtype=dtype)}


def group_norm(params: Params, x: torch.Tensor, *, groups: int = 32,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over NHWC within (H, W, C/G) per group; statistics in f32
    with the centred variance (mean of squared deviations)."""
    b, h, w, c = x.shape
    g = min(groups, c)
    xg = x.reshape(b, h, w, g, c // g).float()
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)
    d = xg - mean
    var = (d * d).mean(dim=(1, 2, 4), keepdim=True)
    out = (d * torch.rsqrt(var + eps)).reshape(b, h, w, c).to(x.dtype)
    return out * params["scale"].to(x.dtype) + params["bias"].to(x.dtype)


def init_linear(gen: torch.Generator, din: int, dout: int, *,
                dtype=torch.float32) -> Params:
    return {
        "kernel": _torch_uniform(gen, (din, dout), din, dtype),
        "bias": _torch_uniform(gen, (dout,), din, dtype),
    }


def linear(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["kernel"].to(x.dtype) + params["bias"].to(x.dtype)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d(1) + flatten: NHWC → (N, C)."""
    return x.mean(dim=(1, 2))


def time_map(kernel: torch.Tensor, hh: int, ww: int,
             padding: int = 1) -> torch.Tensor:
    """Border-aware time map ``M = conv(ones (H, W), kernel[:, :, :1, :])``
    of the split ConcatConv, as an (H, W, C) tensor.

    Written as a sum of shifted taps (elementwise f32 only), so no TF32 or
    reduced-precision conv path can touch it on the card."""
    kh, kw = kernel.shape[:2]
    w_t = kernel[:, :, 0, :].float()  # (kh, kw, C)
    ones = torch.ones((hh, ww), dtype=torch.float32, device=kernel.device)
    ones = F.pad(ones, (padding, padding, padding, padding))
    m = None
    for ky in range(kh):
        for kx in range(kw):
            term = ones[ky:ky + hh, kx:kx + ww, None] * w_t[ky, kx]
            m = term if m is None else m + term
    return m


def concat_conv2d(params: Params, t, x: torch.Tensor, *,
                  padding: int = 1) -> torch.Tensor:
    """ConcatConv2d via the *split* lowering (JAX ``ops/layers.py:161``):

        conv(concat(t·1, x), W) = conv(x, W[:,:,1:,:]) + t · M,
        M = conv(ones_map, W[:,:,:1,:])   (border-aware tap sums)

    exact up to f32 reassociation (~1e-4).  ``t``: scalar or (B,)."""
    kernel = params["kernel"]
    out = conv2d({"kernel": kernel[:, :, 1:, :], "bias": params["bias"]},
                 x, padding=padding)
    _, h, w, _ = x.shape
    m = time_map(kernel, h, w, padding).to(x.dtype)
    t = torch.as_tensor(t, dtype=x.dtype, device=x.device).reshape(-1, 1, 1, 1)
    return out + t * m


def concat_time_channel(t, x: torch.Tensor) -> torch.Tensor:
    """Broadcast scalar-or-per-sample ``t`` to a leading NHWC channel: the
    reference's ``ConcatConv2d`` input (``concat_conv2d`` computes the same
    conv without building it).  ``t``: shape ``()`` or ``(B,)``."""
    b, h, w, _ = x.shape
    t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
    t = t.reshape(-1, 1, 1, 1).expand(b, h, w, 1)
    return torch.cat([t, x], dim=-1)
