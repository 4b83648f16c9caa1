"""Race the 3×3-conv strategies of ``kernels/conv3x3.py`` on the card, in
isolation, against the library conv and the operations bound.

    python -m neural_ode_features_tpu_torch.probes.conv_probe [mma3] [mma1] [wgmma3] [tap9] [im2col] [mma_bf16] [tap9_bf16] [im2col_bf16] [wgmma_bf16] [--batch 256,128]

The port of ``probes/conv_probe.py``.  The three fused kernels
(``odefunc.cu``, ``rk_step.cu``, ``odefunc_bwd.cu``) spend their time in one
shared device function, the 3×3 conv; this probe times that conv alone:
``wgmma3``, the f32 fused kernels' conv stage at 7×7×64 and 6×6×64 (3×TF32
on ``wgmma.mma_async``), ``mma3``, the tensor-core stage (3×TF32 on
``mma.sync``) that they run at their other tensor-core shapes and that the
backward's input-gradient convs run outside its f32 cluster pass, ``mma1``,
``mma3`` with the error
compensation compiled out (a reading only), and the f32 FFMA kernels ``tap9`` (the stage at other
shapes) and ``im2col``, before a fused kernel is touched; and their bf16
twins (the JAX probe's ``*_bf16``: operands rounded to bf16, products
summed in f32) ``mma_bf16`` (the bf16 conv stage at C = 96 to 512),
``wgmma_bf16`` (the bf16 ``odefunc``'s and the fused step's at 7×7×64 and
6×6×64), ``tap9_bf16`` (nine per-tap bf16 ``wgmma`` products) and
``im2col_bf16`` (one bf16 ``wgmma`` GEMM), both over the rows of every
sample.  Inputs as in the JAX probe: x (B, 7, 7, 64) and w
(3, 3, 64, 64) from numpy seed 0, scaled by 0.1 and 0.05.

Each strategy is checked against its plain version (``conv3x3_plain``; for
a bf16 twin ``passes="bf16"``) and against ``F.conv2d`` (TF32 off; for a
bf16 twin ``F.conv2d`` on bf16 tensors, whose output is rounded to bf16),
its error against the plain f32 version in
float64 is printed beside that of the plain emulation of its arithmetic
(``conv3x3_plain(passes=3 | 1)``, ``conv3x3_wgmma_emulated``,
``im2col_wgmma_emulated``, ``tap9_wgmma_emulated``; a bf16 twin's also
against the f64 conv of the
rounded operands, whose products are exact, so that only its order of
sums is left), and it is timed at every ``--batch`` in
turns (all strategies at the first batch, then at the second).  Two times
per strategy: the device time of its kernel by name under
``torch.profiler`` (``dev``), and CUDA events around a few hundred
back-to-back calls of the wrapper (``call``), which cannot go below what
the host needs for a launch (about 30 µs), so kernels faster than that
are told apart by ``dev`` alone.  The JAX probe chains its calls in a
``lax.scan`` and takes the slope between a long and a short chain to cancel
the cost of a dispatch; the device's own timeline does that job here.
``F.conv2d`` is timed as the library reference in place of the JAX probe's
``xla_conv``, in f32 and on bf16 tensors (the bf16 twins' yardstick): its
call as above, and its device time, CUDA events around calls queued behind
a spin kernel (:func:`queued_us`), so that a kernel is read device time
against device time.  Where both run, ``wgmma3``'s error against the f64
conv must be at most ``WGMMA_BAR`` (1.5) times ``mma3``'s in the same run,
and ``im2col_bf16``'s, ``tap9_bf16``'s and ``wgmma_bf16``'s (against the
f64 conv of the rounded operands) at most that times ``mma_bf16``'s, or the
probe exits.
The JAX probe's ``dotonly``, ``norollS`` and ``nomaskS`` are
wrong-valued timing aids for its patch building; in their place two bounds
are printed: operations at 67 TFLOP/s (f32 outside the tensor cores), and
the card's least time with the tensor cores, the larger of operations at
495 TFLOP/s (TF32) and bytes at 3.35 TB/s.

Prints µs per conv, the bounds, and the ratio to each; writes no file.
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
    BF16_STRATEGIES,
    STRATEGIES,
    conv3x3,
    conv3x3_plain,
    conv3x3_wgmma_emulated,
    conv_bytes,
    conv_flops,
    im2col_wgmma_emulated,
    tap9_wgmma_emulated,
)
from ..kernels.odefunc import bf16_round
from ..utils.flops import (
    H100_F32_FLOPS,
    H100_HBM_BYTES_PER_S,
    H100_TF32_FLOPS,
)

__all__ = ["main", "probe_inputs", "library_conv", "time_us", "device_us",
           "queued_us", "bound_us", "tensor_bound_us", "KERNEL_NAMES",
           "WGMMA_BAR"]

H, W, C = 7, 7, 64
CHECK_TOL = dict(rtol=1e-4, atol=1e-5)  # f32 sums of 576 products, reordered
# mma1 alone: plain TF32 keeps 11 bits per operand, about 1e-3 relative per
# product; over sums of 576 products of mixed sign 2e-3 relative, 2e-4 absolute.
TF32_TOL = dict(rtol=2e-3, atol=2e-4)
# A bf16 twin against F.conv2d on bf16 tensors: the library rounds its
# output to bf16 (2^-9 relative); both round the operands alike.
BF16_LIB_TOL = dict(rtol=8e-3, atol=1e-3)
# wgmma3 forms mma3's products on other hardware: its error against the f64
# conv may be at most this multiple of mma3's on the same inputs; so may
# im2col_bf16's, tap9_bf16's and wgmma_bf16's against the f64 conv of the
# rounded operands be of mma_bf16's.
WGMMA_BAR = 1.5
# Each strategy held to that bar, and the strategy it is held beside.
BARRED = {"wgmma3": "mma3", "im2col_bf16": "mma_bf16", "tap9_bf16": "mma_bf16",
          "wgmma_bf16": "mma_bf16"}
# A substring of each strategy's kernel name in a profile.
KERNEL_NAMES = {"tap9": "tap9_kernel<false>", "im2col": "im2col_kernel(",
                "mma3": "mma_kernel<3,", "mma1": "mma_kernel<1,",
                "wgmma3": "wgmma_kernel<0>",
                "mma_bf16": "mma_kernel<16,", "tap9_bf16": "tap9_wgmma_kernel<",
                "im2col_bf16": "im2col_wgmma_kernel<",
                "wgmma_bf16": "wgmma_kernel<2>"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("strategies", nargs="*",
                   default=list(STRATEGIES + BF16_STRATEGIES),
                   help="strategies to race (default: "
                        f"{' '.join(STRATEGIES + BF16_STRATEGIES)})")
    p.add_argument("--batch", default=[256, 128],
                   type=lambda v: [int(b) for b in v.split(",")],
                   help="batch sizes to race at, in turns, separated by "
                        "commas (default: 256,128: the inference and the "
                        "training batch)")
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
    and out, in ``x``'s dtype (bf16 tensors: the bf16 twins' yardstick).
    The port itself never calls it for this."""
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


def device_us(fn, names, reps: int = 100) -> dict:
    """Mean µs of device time per launch of each CUDA kernel whose name
    contains one of ``names`` (each is launched once per call of ``fn``),
    from ``torch.profiler`` over ``reps`` warm calls.  The mean is over the
    launches the profiler recorded: on the card it drops some launches, and
    now and then all of a short window's (a 0.05 ms kernel called five
    times read 0), so the window starts with a pause, the sum is divided
    by the recorded count, not by ``reps``, and a window that recorded no
    launch of a name is run again, up to three times, before this
    raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [ev for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA]
        hits = {name: [ev for ev in kernels if name in ev.key]
                for name in names}
        counts = {name: sum(ev.count for ev in evs)
                  for name, evs in hits.items()}
        if all(counts.values()):
            return {name: sum(ev.self_device_time_total for ev in evs)
                    / counts[name] for name, evs in hits.items()}
    missing = [name for name, n in counts.items() if not n]
    raise RuntimeError(f"no launch of {missing} in three profiles")


def queued_us(fn, reps: int = 50) -> float:
    """Device µs per call of ``fn``: ``reps`` calls enqueued behind a spin
    kernel, so that the card runs them back to back and the host's cost of
    each call is hidden, timed by CUDA events around them; the spin is
    lengthened until it outlasts the enqueueing.  Reads every kernel a call
    launches, so it times a library call whole."""
    fn()
    torch.cuda.synchronize()
    for spin in (10_000_000 << k for k in range(6)):  # from about 5 ms
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(spin)
        ev[1].record()
        t_host = time.perf_counter()
        for _ in range(reps):
            fn()
        t_host = 1e3 * (time.perf_counter() - t_host)
        ev[2].record()
        torch.cuda.synchronize()
        if ev[0].elapsed_time(ev[1]) > t_host:
            return 1e3 * ev[1].elapsed_time(ev[2]) / reps
    raise RuntimeError("the calls' enqueueing outlasted every spin: does "
                       "the call wait for the card?")


def _bound(flops: float, nbytes: float, peak_flops: float):
    by_ops, by_bytes = flops / peak_flops, nbytes / H100_HBM_BYTES_PER_S
    return 1e6 * max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                         else "bytes")


def bound_us(batch: int, hw=(H, W), c: int = C) -> tuple[float, str]:
    """The least time the card could take for one conv on the CUDA cores
    (f32 FFMA), and what binds it."""
    return _bound(conv_flops(batch, hw, c), conv_bytes(batch, hw, c),
                  H100_F32_FLOPS)


def tensor_bound_us(batch: int, hw=(H, W), c: int = C) -> tuple[float, str]:
    """The least time the card could take for one conv with the tensor
    cores (the operations counted once, at the TF32 rate), and what binds
    it."""
    return _bound(conv_flops(batch, hw, c), conv_bytes(batch, hw, c),
                  H100_TF32_FLOPS)


def _us(v) -> str:
    return "not measured" if v is None else f"{v:8.1f} us/conv"


def main(argv=None) -> dict:
    """Run the probe; returns, for the first batch size, ``{"bound_us",
    "bound_by", "tensor_bound_us", "tensor_bound_by", "library_us",
    "library_bf16_us", "library_device_us", "library_bf16_device_us",
    "<strategy>": {"us", "device_us", "err_plain", "err_library",
    "err_f64"}}`` (the device times are None on the CPU; a bf16 twin's
    errors are against its own plain version and the bf16 library conv,
    and it adds ``err_f64_bf16``, against the f64 conv of the rounded
    operands), and the same dict per batch size under ``"batches"``."""
    args = parse_args(argv)
    dev = strict_f32("cpu" if args.cpu else "cuda")
    on_card = dev.type == "cuda"
    where = (torch.cuda.get_device_name(0) if on_card
             else "cpu (plain version; not the card's times)")
    results = {}
    for batch in args.batch:
        x, w = probe_inputs(batch, dev)
        b_us, b_by = bound_us(batch)
        tb_us, tb_by = tensor_bound_us(batch)
        print(f"=== conv probe: B={batch} {H}x{W}x{C} on {where} ===")
        print(f"bound: {b_us:8.1f} us/conv by {b_by} (f32 FFMA); "
              f"{tb_us:.1f} us/conv by {tb_by} (tensor cores, TF32)")
        plain = conv3x3_plain(x, w)
        plain64 = conv3x3_plain(x.double(), w.double())
        lib = library_conv(x, w)
        lib_us = time_us(lambda: library_conv(x, w), dev)
        x16, w16 = x.bfloat16(), w.bfloat16()
        lib16 = library_conv(x16, w16).float()
        lib16_us = time_us(lambda: library_conv(x16, w16), dev)
        plain16 = conv3x3_plain(x, w, passes="bf16")
        plain64_16 = conv3x3_plain(bf16_round(x).double(),
                                   bf16_round(w).double())
        lib_dev = lib16_dev = None
        if on_card:
            lib_dev = queued_us(lambda: library_conv(x, w))
            lib16_dev = queued_us(lambda: library_conv(x16, w16))
        print(f"F.conv2d (library reference): call {lib_us:8.1f} us/conv  "
              f"({lib_us / b_us:.2f}x bound), device "
              f"{_us(lib_dev)}; max|diff vs plain| = "
              f"{float((lib - plain).abs().max()):.2e}; on bf16 tensors "
              f"call {lib16_us:8.1f} us/conv, device {_us(lib16_dev)}, "
              f"max|diff vs the bf16 plain version| = "
              f"{float((lib16 - plain16).abs().max()):.2e}")
        emulated = {"mma3": conv3x3_plain(x, w, passes=3),
                    "mma1": conv3x3_plain(x, w, passes=1),
                    "wgmma3": conv3x3_wgmma_emulated(x, w),
                    **dict.fromkeys(BF16_STRATEGIES, plain16),
                    "wgmma_bf16": conv3x3_wgmma_emulated(x, w,
                                                         precision="bf16"),
                    "im2col_bf16": im2col_wgmma_emulated(x, w),
                    "tap9_bf16": tap9_wgmma_emulated(x, w)}
        out = {"bound_us": b_us, "bound_by": b_by, "tensor_bound_us": tb_us,
               "tensor_bound_by": tb_by, "library_us": lib_us,
               "library_bf16_us": lib16_us, "library_device_us": lib_dev,
               "library_bf16_device_us": lib16_dev}
        for strategy in args.strategies:
            got = conv3x3(x, w, strategy)
            bf16 = strategy in BF16_STRATEGIES
            tol = TF32_TOL if strategy == "mma1" else CHECK_TOL
            ref_p, ref_l = (plain16, lib16) if bf16 else (plain, lib)
            err_p = float((got - ref_p).abs().max())
            err_l = float((got - ref_l).abs().max())
            err_64 = float((got.double() - plain64).abs().max())
            exact = plain64_16 if bf16 else plain64
            for name, ref, tol_ in (
                    ("plain", ref_p, tol),
                    ("F.conv2d", ref_l, BF16_LIB_TOL if bf16 else tol)):
                if not torch.allclose(got, ref, **tol_):
                    raise SystemExit(
                        f"{strategy}: differs from {name}: max abs err "
                        f"{float((got - ref).abs().max()):.3e}")
            us = time_us(lambda s=strategy: conv3x3(x, w, s), dev)
            line = f"{strategy:>8}: "
            d_us = None
            if on_card:
                name = KERNEL_NAMES[strategy]
                d_us = device_us(lambda s=strategy: conv3x3(x, w, s),
                                 (name,))[name]
                if d_us <= 0.0:
                    raise SystemExit(f"{strategy}: no device time under "
                                     f"{KERNEL_NAMES[strategy]!r} in the profile")
                lib_d = lib16_dev if bf16 else lib_dev
                line += (f"dev {d_us:7.1f} us/conv ({d_us / b_us:.2f}x the f32 "
                         f"bound, {d_us / tb_us:.2f}x the tensor-core bound, "
                         f"{d_us / lib_d:.2f}x F.conv2d"
                         f"{' bf16' if bf16 else ''}'s device time), ")
            line += (f"call {us:7.1f} us ({us / lib_us:.2f}x F.conv2d); "
                     f"max|diff| vs {'bf16 ' if bf16 else ''}plain "
                     f"{err_p:.2e}, vs F.conv2d{' bf16' if bf16 else ''} "
                     f"{err_l:.2e}, vs the f64 plain version {err_64:.2e}")
            out[strategy] = {"us": us, "device_us": d_us, "err_plain": err_p,
                             "err_library": err_l, "err_f64": err_64}
            if bf16:
                out[strategy]["err_f64_bf16"] = float(
                    (got.double() - exact).abs().max())
                line += (f", vs the f64 conv of the rounded operands "
                         f"{out[strategy]['err_f64_bf16']:.2e}")
            if strategy in emulated:
                emu = float((emulated[strategy].double() - exact).abs().max())
                line += f" (its plain emulation's: {emu:.2e})"
            print(line)
        for strategy, beside in BARRED.items():
            if strategy not in out or beside not in out:
                continue
            key = "err_f64_bf16" if strategy in BF16_STRATEGIES else "err_f64"
            e_s, e_b = out[strategy][key], out[beside][key]
            print(f"  {strategy} vs the f64 conv {e_s:.2e} beside {beside}'s "
                  f"{e_b:.2e} ({e_s / e_b:.2f}x; bar {WGMMA_BAR}x)")
            if e_s > WGMMA_BAR * e_b:
                raise SystemExit(f"{strategy}: error {e_s:.3e} against the "
                                 f"f64 conv exceeds {WGMMA_BAR} x {beside}'s "
                                 f"{e_b:.3e}")
        results[batch] = out
    first = dict(results[args.batch[0]])
    first["batches"] = results
    return first


if __name__ == "__main__":
    main()
