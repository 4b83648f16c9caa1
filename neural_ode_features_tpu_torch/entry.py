"""The port's counterpart of ``__graft_entry__.entry()``: CIFAR-10 ODE-Net
inference with per-sample adaptive dopri5 at rtol = atol = 1e-3.

The configuration is the JAX entry's with the JAX kernel opt-ins switched
on (``use_pallas=use_fused_rk=True``), i.e. the configuration whose path the
TPU kernels carried; the port runs its CUDA kernels on the card regardless.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .models import ModelConfig, init_odenet, odenet_logits

__all__ = ["entry", "ENTRY_CONFIG"]

ENTRY_CONFIG = ModelConfig(in_channels=3, tol=1e-3, error_control="per_sample",
                           use_pallas=True, use_fused_rk=True)


def entry(device="cuda", batch: int = 16):
    """Return ``(fwd, (params, x))``: ``fwd(params, x) -> (logits, nfe)``
    on random weights (seed 7) and a (batch, 32, 32, 3) f32 NHWC input
    drawn with numpy from seed 0.

    Sets strict f32 on the card (no TF32 in cuDNN convs or cuBLAS matmuls):
    TF32 is the H100 twin of the TPU's bf16 default, which the JAX package
    had to pin away from its solver-side contractions."""
    dev = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ENTRY_CONFIG
    params = init_odenet(7, cfg, device=dev)
    x = torch.from_numpy(
        np.random.default_rng(0).normal(size=(batch, 32, 32, 3))
        .astype(np.float32)).to(dev)

    def fwd(params, x):
        logits, stats = odenet_logits(params, x, cfg)
        return logits, stats.nfe

    return fwd, (params, x)
