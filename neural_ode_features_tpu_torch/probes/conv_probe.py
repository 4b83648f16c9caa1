"""Race the 3×3-conv strategies of ``kernels/conv3x3.py`` on the card, in
isolation, against the library conv and the operations bound.

    python -m neural_ode_features_tpu_torch.probes.conv_probe [tap9] [im2col] [--batch 256]

The port of ``probes/conv_probe.py``.  The three fused kernels
(``odefunc.cu``, ``rk_step.cu``, ``odefunc_bwd.cu``) spend their time in one
shared device function, the 3×3 conv; this probe times that conv alone
(``tap9``) and candidate replacements (``im2col``) before a fused kernel is
touched.  Inputs as in the JAX probe: x (B, 7, 7, 64) and w (3, 3, 64, 64)
from numpy seed 0, scaled by 0.1 and 0.05.

Each strategy is checked against the plain version ``conv3x3_plain`` and
against ``F.conv2d`` (TF32 off), then timed.  Timing: CUDA events around a
few hundred back-to-back launches, median over blocks.  The JAX probe chains
its calls in a ``lax.scan`` and takes the slope between a long and a short
chain to cancel the cost of a dispatch; CUDA events record on the device's
own timeline, so back-to-back launches between two events do that job here.
``F.conv2d`` is timed as the library reference in place of the JAX probe's
``xla_conv``.  The JAX probe's ``dotonly``, ``norollS`` and ``nomaskS`` are
wrong-valued timing aids for its patch building; in their place the
operations bound (67 TFLOP/s f32 outside the tensor cores) is printed.

Prints µs per conv, the bound, and the ratio to each; writes no file.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch
import torch.nn.functional as F

from .._device import strict_f32
from ..kernels.conv3x3 import (
    STRATEGIES,
    conv3x3,
    conv3x3_plain,
    conv_bytes,
    conv_flops,
)

__all__ = ["main", "probe_inputs", "library_conv", "time_us", "bound_us"]

H, W, C = 7, 7, 64
PEAK_F32_FLOPS = 67e12   # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
CHECK_TOL = dict(rtol=1e-4, atol=1e-5)  # f32 sums of 576 products, reordered


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("strategies", nargs="*", default=list(STRATEGIES),
                   help=f"strategies to race (default: {' '.join(STRATEGIES)})")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--cpu", action="store_true",
                   help="run the plain version on the CPU (checks only the "
                        "control flow; its times are not the card's)")
    return p.parse_args(argv)


def probe_inputs(batch: int, device, hw=(H, W), c: int = C):
    """x (batch, H, W, C) and w (3, 3, C, C), numpy seed 0, scales 0.1 and
    0.05, as the JAX probe draws them."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(batch, *hw, c)).astype(np.float32) * 0.1
    w = rng.normal(size=(3, 3, c, c)).astype(np.float32) * 0.05
    return (torch.from_numpy(x).to(device), torch.from_numpy(w).to(device))


def library_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same conv through one library call (cuDNN on the card), NHWC in
    and out.  The yardstick; the port itself never calls it for this."""
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                    padding=1).permute(0, 2, 3, 1)


def time_us(fn, device: torch.device, reps: int = 200,
            blocks: int = 5) -> float:
    """µs per call on ``device``: the median over ``blocks`` of the mean of
    ``reps`` back-to-back calls between two CUDA events (on the CPU: the
    host clock around ``reps`` calls)."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e6 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    means = []
    for _ in range(blocks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(1e3 * start.elapsed_time(end) / reps)
    return statistics.median(means)


def bound_us(batch: int, hw=(H, W), c: int = C) -> tuple[float, str]:
    """The least time the card could take for one conv, and what binds it."""
    by_ops = conv_flops(batch, hw, c) / PEAK_F32_FLOPS
    by_bytes = conv_bytes(batch, hw, c) / PEAK_BYTES
    return 1e6 * max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                         else "bytes")


def main(argv=None) -> dict:
    """Run the probe; returns ``{"bound_us", "bound_by", "library_us",
    "<strategy>": {"us", "err_plain", "err_library"}}``."""
    args = parse_args(argv)
    dev = strict_f32("cpu" if args.cpu else "cuda")
    x, w = probe_inputs(args.batch, dev)
    where = (torch.cuda.get_device_name(0) if dev.type == "cuda"
             else "cpu (plain version; not the card's times)")
    b_us, b_by = bound_us(args.batch)
    print(f"=== conv probe: B={args.batch} {H}x{W}x{C} on {where} ===")
    print(f"bound: {b_us:8.1f} us/conv by {b_by}")
    plain = conv3x3_plain(x, w)
    lib = library_conv(x, w)
    lib_us = time_us(lambda: library_conv(x, w), dev)
    print(f"F.conv2d (library reference): {lib_us:8.1f} us/conv  "
          f"({lib_us / b_us:.2f}x bound); max|diff vs plain| = "
          f"{float((lib - plain).abs().max()):.2e}")
    out = {"bound_us": b_us, "bound_by": b_by, "library_us": lib_us}
    for strategy in args.strategies:
        got = conv3x3(x, w, strategy)
        err_p = float((got - plain).abs().max())
        err_l = float((got - lib).abs().max())
        for name, ref in (("plain", plain), ("F.conv2d", lib)):
            if not torch.allclose(got, ref, **CHECK_TOL):
                raise SystemExit(f"{strategy}: differs from {name}: max abs "
                                 f"err {float((got - ref).abs().max()):.3e}")
        us = time_us(lambda s=strategy: conv3x3(x, w, s), dev)
        print(f"{strategy:>8}: {us:8.1f} us/conv  ({us / b_us:.2f}x bound, "
              f"{us / lib_us:.2f}x F.conv2d); max|diff| vs plain {err_p:.2e}, "
              f"vs F.conv2d {err_l:.2e}")
        out[strategy] = {"us": us, "err_plain": err_p, "err_library": err_l}
    return out


if __name__ == "__main__":
    main()
