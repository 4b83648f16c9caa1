"""Device time of the three fused kernels at given shapes, in a form that
measures another checkout of the port with the same method, for comparing
two versions on one card (parent, change, change, parent).

    python -m neural_ode_features_tpu_torch.probes.kernel_times \\
        [--shapes 7x7x64,6x6x64,7x7x128] [--reps 100]
    # the same measurement of the checkout at <dir>:
    PYTHONPATH=<dir> python neural_ode_features_tpu_torch/probes/kernel_times.py

The kernels are imported by their absolute names, so the second form times
the package found on ``PYTHONPATH`` (built from its own ``csrc/``).  Per
shape H×W×C (groups 32; the :func:`entry` model's ODEfunc at that width,
seed 7): ``odefunc`` and ``rk_step`` (tol 1e-3) at B = 256, the backward at
B = 128, each its device ms per launch under ``torch.profiler`` (the mean
over the launches recorded in ``--reps`` calls; the backward, its three
kernels summed, and apart, ``odefunc_bwd_split_ms``, beside each kernel's
bound, ``odefunc_bwd_bound_ms``: the larger of its operations at the TF32
tensor-core peak and its bytes at HBM's rate, ``utils/flops.py``
``bwd_kernel_bounds``, where the package has it).  ``--bwd-only`` times the
backward alone.  ``--bwd-batch 128,256,16`` times the backward at each
batch (``odefunc_bwd_b<B>_split_ms`` beside the B = 128 keys; the rows
beyond 128 from a second numpy seed, at most 256).  Prints the card's name and power limit, then one JSON line
per shape.  Needs a CUDA card and ``nvcc``.

``--solves N`` adds one JSON line of host-side times of the same package:
the ``entry`` model's solve at B = 256 (``odenet_logits``, the median of N)
on the private host loop and on the package's own route for a ``'while'``
solve, one step of ``train_entry``'s trainer at B = 128 (the median of N;
27 or so ``odefunc`` calls on the host loop, its weights changing every
step), and the host µs of one call of the ``odefunc`` and ``rk_step``
wrappers (200 calls queued with no sync, then one sync: the host's cost of
a call, the operator's dispatch included where the package has one).
``--shapes ''`` skips the kernels.  Where the package has the bf16
backward, the host µs of one call of it at 7×7×96, B = 128
(``odefunc_bwd_bf16_call_host_us``: 50 calls queued, then one sync; the
rows backward's fifteen launches a call, or the one-CTA build's three).

``--bf16`` adds, per shape, the bf16 builds (``odefunc`` with
``compute_dtype=bfloat16``, ``rk_step`` with ``conv_precision='bf16'``, the
backward with ``precision='bf16'`` at B = 128, device ms as above; where
the package runs the bf16 ``odefunc`` as the rows build, its seven
launches and the per-sample kernel it replaced in turns, per-sample,
rows, rows, per-sample, ``odefunc_bf16_turns_ms``, device ms by CUDA
events behind a spin kernel, ``odefunc_bf16_ms`` and
``odefunc_bf16_cta_ms`` their means; the
backward's three kernels apart, beside the f32 build's, and at each
``--bwd-batch``, ``odefunc_bwd_bf16_b<B>_split_ms``) and the library
yardstick of their convs, ``F.conv2d`` on bf16 tensors at that shape (one
conv, B = 256).  It needs a package that has the bf16 builds.  Each row
names the per-sample pass each build runs (``bwd_pass``, ``bwd_bf16_pass``:
``kernels.odefunc_bwd.sample_pass``, where the package has it).  Where the
bf16 backward's pass is the rows backward (``'rows'``), its split is per
call by part (``rows_conv``, ``rows_pack``, ``rows_per_sample``: its four
convs, four packings and five per-sample launches, and their sum
``rows_pass``; ``bwd_weight_kernel``; ``bwd_reduce_kernel``), and the call
and the
one-CTA pass it replaced (``probes/timing_aids.py`` ``odefunc_bwd_cta_bf16``,
split by kernel in ``odefunc_bwd_bf16_cta_split_ms``) are timed in turns,
one-CTA, rows, rows, one-CTA, ``odefunc_bwd_bf16_turns_ms`` (device ms by
CUDA events behind a spin kernel).  Beside each rows build, the per-sample GroupNorm
launches' device ms a call (each kernel's mean per launch under
``torch.profiler`` times its launches: the forward's three at B = 256,
``rows_gn_fwd_ms``, the backward's five at B = 128, ``rows_gn_bwd_ms``)
and their bytes bound (``rows_gn_fwd_bound_ms``, ``rows_gn_bwd_bound_ms``:
``utils/flops.py`` ``rows_sample_bounds``).
``--bwd-only`` with ``--bf16`` also
times the library yardstick of the backward, ``torch.autograd.grad``
through ``F.group_norm`` + ``F.conv2d`` on f32 (TF32 off) and on bf16
tensors at B = 128 (``bwd_library_ms``, ``bwd_library_bf16_ms``, the same
clock).

``--bwd-only`` also times the weight-gradient launch alone in turns, the
``mma.sync`` kernel beside ``bwd_weight_kernel`` on ``wgmma`` (C ≥ 64; the
path runs it where C % 64 == 0, ``weight_kernel``): ``weight_turns_ms``
(``mma.sync``, ``wgmma``, ``wgmma``, ``mma.sync``), ``weight_mma_ms``,
``weight_ms`` (``wgmma``) and ``weight_bound_ms``, with ``--bf16``
the same for the bf16 build (``weight_bf16_*``), where the package has
that reading (``timing_aids.bwd_weight_partials``).

``--digest`` prints, per shape, the sha256 of each f32 kernel's outputs on
the seeded inputs (``odefunc``; ``rk_step``'s four outputs; the backward's
conv-kernel gradients, ``odefunc_bwd_weights``, and the rest of its
outputs, ``odefunc_bwd_rest``: f, dh, dt, the eight (C,) vectors and the
conv kernels' time channel; the residuals of its forward recompute,
``odefunc_bwd_r``: r1 and r2; the conv probe's strategies, its bf16 twins
too, where the shape takes them) and, where the package has the bf16
builds, of theirs
(``odefunc_bf16``, ``rk_step_bf16`` at ``conv_precision='bf16'``,
``odefunc_bwd_bf16``: every output; and apart, as the f32 build's,
``odefunc_bwd_bf16_weights``, ``odefunc_bwd_bf16_rest`` without f,
``odefunc_bwd_bf16_f`` and ``odefunc_bwd_bf16_r``; at the rows build's
shapes ``odefunc_bf16_cta``, the per-sample kernel's f, which the rows
build's must equal, and where the package has the rows backward
``odefunc_bwd_bf16_cta``, every output of the one-CTA pass, which the rows
backward's ``odefunc_bwd_bf16`` must equal; where the package has the
reading, ``odefunc_bwd_weights_mma`` and ``odefunc_bwd_bf16_weights_mma``,
the weight gradients on the ``mma.sync`` kernel, which ``bwd_weight_kernel``'s
must equal), so that two checkouts' kernels
can be held bit for bit (run once with each package on ``PYTHONPATH``, in
one call).

``--errors`` prints, per shape, the backward's dθ max abs error against its
plain version in float64 at B = 128, 64 and 5 (the seeded inputs' first
rows), beside the f32 plain version's (cuDNN, TF32 off), for both builds'
weight gradients where ``--bf16`` is given too (the bf16 build's distances
from the plain bf16 VJP, ``probes/bf16_distances.py``), so that two
checkouts' accuracy can be read on the same inputs.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from neural_ode_features_tpu_torch.kernels.odefunc import odefunc, prepare
from neural_ode_features_tpu_torch.kernels.odefunc_bwd import odefunc_bwd
from neural_ode_features_tpu_torch.kernels.rk_step import dopri5_step
from neural_ode_features_tpu_torch.models import ModelConfig, init_odenet
from neural_ode_features_tpu_torch.solver import DOPRI5

B, B_BWD, G = 256, 128, 32
BWD_KERNELS = ("bwd_sample_kernel", "bwd_weight_kernel", "bwd_reduce_kernel")
# The rows backward's parts, each the kernels whose names hold one of its
# fragments: the per-sample pass (its four convs, four weight packings and
# five per-sample launches; ``rows_pass`` in a row is their sum), then the
# weight gradients and the reduction.
ROWS_PASS_PARTS = {"rows_conv": ("rows_conv_kernel",),
                   "rows_pack": ("rows_pack_kernel",),
                   "rows_per_sample": ("rows_bwd_",)}
# The rows builds' per-sample GroupNorm launches and their count a call:
# the forward's three, the backward's five.
ROWS_GN_FWD = {"rows_gn_relu_kernel": 2, "rows_gn_out_kernel": 1}
ROWS_GN_BWD = {"rows_bwd_gn_relu_kernel": 2, "rows_bwd_gv_kernel": 1,
               "rows_bwd_gu_kernel": 1, "rows_bwd_dh_kernel": 1}
ROWS_BWD_PARTS = {**ROWS_PASS_PARTS,
                  "bwd_weight_kernel": ("bwd_weight_kernel",),
                  "bwd_reduce_kernel": ("bwd_reduce_kernel",)}


def device_ms(fn, names, reps: int) -> float:
    """Device ms per call: for each of ``names`` the mean over the recorded
    launches of the kernel so named (one per call), summed."""
    return sum(device_split(fn, names, reps).values())


def device_split(fn, names, reps: int) -> dict:
    """Device ms per call of each kernel named in ``names``: the mean over
    its recorded launches (one per call).  The window starts with a pause:
    the profiler can miss the first milliseconds."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for name in names:
        hits = [ev for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA and name in ev.key]
        count = sum(ev.count for ev in hits)
        if not count:
            raise RuntimeError(f"no launch of {name!r} in the profile")
        split[name] = sum(ev.self_device_time_total for ev in hits) / count / 1e3
    return split


def device_parts(fn, parts: dict, reps: int) -> dict:
    """Device ms per call of each part of ``parts`` (name -> fragments of
    kernel names): the recorded time of every kernel whose name holds one
    of the part's fragments, over ``reps`` calls (a part may launch several
    kernels a call); with :data:`ROWS_PASS_PARTS`' parts, their sum as
    ``rows_pass``."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name, frags in parts.items():
        hits = [ev for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA
                and any(f in ev.key for f in frags)]
        if not hits:
            raise RuntimeError(f"no launch of {name!r} in the profile")
        out[name] = sum(ev.self_device_time_total for ev in hits) / reps / 1e3
    if set(ROWS_PASS_PARTS) <= set(out):
        out["rows_pass"] = sum(out[k] for k in ROWS_PASS_PARTS)
    return out


def rows_gn_ms(fn, launches: dict, reps: int) -> float:
    """Device ms per call of the rows builds' per-sample GroupNorm
    launches: each kernel's mean per recorded launch under
    ``torch.profiler`` (``conv_probe.device_us``) times its launches a
    call, summed."""
    from neural_ode_features_tpu_torch.probes.conv_probe import device_us

    us = device_us(fn, tuple(launches), reps)
    return sum(us[k] * n for k, n in launches.items()) / 1e3


def rows_gn_bound(hh: int, ww: int, c: int, b: int, key: str):
    """The per-sample launches' bytes bound (``utils/flops.py``
    ``rows_sample_bounds``, ``key`` 'fwd' or 'bwd')."""
    from neural_ode_features_tpu_torch.utils.flops import rows_sample_bounds

    return rows_sample_bounds((hh, ww), c, b, G)[key]["bound_ms"]


def _rows_bwd(hh: int, ww: int, c: int) -> bool:
    """Whether the package runs the bf16 backward at this shape as the rows
    backward (``sample_pass`` gives ``'rows'``)."""
    from neural_ode_features_tpu_torch.kernels import odefunc_bwd as mod

    return (hasattr(mod, "sample_pass")
            and mod.sample_pass((hh, ww), c, G, "bf16") == "rows")


def _library_bwd_ms(w_raw, hb, tb, g, reps: int) -> dict:
    """Device ms of the backward's library yardstick on f32 and on bf16
    tensors (the module docstring); {} where the package lacks it (a
    checkout from before it: the yardstick does not depend on the
    package)."""
    from neural_ode_features_tpu_torch.probes import conv_probe

    if not hasattr(conv_probe, "library_bwd"):
        return {}
    library_bwd, queued_us = conv_probe.library_bwd, conv_probe.queued_us
    out = {}
    for key, dtype in (("bwd_library_ms", torch.float32),
                       ("bwd_library_bf16_ms", torch.bfloat16)):
        raw = {k: {kk: v.to(dtype) for kk, v in d.items()}
               for k, d in w_raw.items()}
        args = (hb.to(dtype), tb.to(dtype), raw, g.to(dtype))
        out[key] = queued_us(lambda: library_bwd(*args, G),
                             min(reps, 10)) / 1e3
    return out


def _inputs(hh: int, ww: int, c: int):
    dev = torch.device("cuda")
    cfg = ModelConfig(in_channels=3, hidden=c, groups=G)
    rng = np.random.default_rng(1)

    def arr(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    h = arr(rng.normal(size=(B, hh, ww, c)) * 0.3)
    t0, dt = arr(rng.uniform(0, 0.5, B)), arr(rng.uniform(0.05, 0.2, B))
    raw = init_odenet(7, cfg, device=dev)["odefunc"]
    w = prepare(raw, (hh, ww))
    y0, f0 = h.reshape(B, -1), odefunc(w, t0, h, groups=G).reshape(B, -1)
    g = arr(rng.normal(size=(B_BWD, hh, ww, c)))
    hb, tb = h[:B_BWD].contiguous(), t0[:B_BWD].contiguous()
    kw = dict(hw=(hh, ww), groups=G, rtol=1e-3, atol=1e-3)
    return w, h, t0, dt, y0, f0, g, hb, tb, kw, raw


def bwd_bounds(hh: int, ww: int, c: int, bf16: bool = False):
    """Each backward kernel's bound in ms at B = 128 (the module
    docstring), or None where the package lacks ``bwd_kernel_bounds`` (a
    checkout from before it)."""
    from neural_ode_features_tpu_torch.utils import flops

    if not hasattr(flops, "bwd_kernel_bounds"):
        return None
    from neural_ode_features_tpu_torch.kernels.odefunc_bwd import (
        weight_splits,
    )

    peak = flops.H100_BF16_FLOPS if bf16 else flops.H100_TF32_FLOPS
    return {k: v["bound_ms"] for k, v in flops.bwd_kernel_bounds(
        (hh, ww), c, B_BWD, weight_splits(B_BWD, c), peak).items()}


def _bwd_rows(nb: int, h, t0, g):
    """The backward's (t, h, g) at batch ``nb`` <= 256: the seeded inputs'
    first rows, the cotangent's rows beyond B_BWD from numpy seed 2."""
    if nb > B:
        raise ValueError(f"--bwd-batch takes batches up to {B}, got {nb}")
    if nb > B_BWD:
        extra = np.random.default_rng(2).normal(
            size=(nb - B_BWD, *g.shape[1:])).astype(np.float32)
        g = torch.cat([g, torch.from_numpy(extra).to(g.device)])
    return (t0[:nb].contiguous(), h[:nb].contiguous(), g[:nb].contiguous())


def _passes(hh: int, ww: int, c: int, bf16: bool) -> dict:
    """The per-sample pass of each build timed (``sample_pass``), or {}
    where the package has no such gate."""
    from neural_ode_features_tpu_torch.kernels import odefunc_bwd as mod

    if not hasattr(mod, "sample_pass"):
        return {}
    out = {"bwd_pass": mod.sample_pass((hh, ww), c, G)}
    if bf16:
        out["bwd_bf16_pass"] = mod.sample_pass((hh, ww), c, G, "bf16")
    return out


def weight_turns(w, tb, hb, g, bf16: bool, reps: int) -> dict:
    """The weight-gradient launch alone at B = 128, in turns on the
    residuals of one backward call: the ``mma.sync`` kernel,
    ``bwd_weight_kernel`` (``wgmma``, where C ≥ 64), ``wgmma``,
    ``mma.sync`` (``timing_aids.bwd_weight_partials``;
    device ms by CUDA events behind a spin kernel), f32 and, with ``bf16``,
    the bf16 build; the path's kernel (``weight_kernel``) and each build's
    weight bound beside them.  {} where the package lacks the reading (a
    checkout from before it: its ``bwd_weight_kernel`` is the ``mma.sync``
    kernel, read in ``odefunc_bwd_split_ms``)."""
    from neural_ode_features_tpu_torch.probes import timing_aids

    if not hasattr(timing_aids, "bwd_weight_partials"):
        return {}
    from neural_ode_features_tpu_torch.kernels.odefunc_bwd import (
        weight_kernel,
        wgmma_weights_ok,
    )
    from neural_ode_features_tpu_torch.probes.conv_probe import queued_us

    hh, ww, c = hb.shape[1:]
    out = {"weight_kernel": weight_kernel((hh, ww), c)}
    # bwd_weight_kernel takes C >= 64 (at C % 64 == 32 the path keeps the
    # mma.sync kernel, and the turns show why); at C = 32 mma.sync alone.
    wg = "wgmma" if wgmma_weights_ok((hh, ww), c) else "mma"
    for prec in ("f32", "bf16") if bf16 else ("f32",):
        res = {}
        odefunc_bwd(w, tb, hb, g, groups=G, precision=prec, residuals=res)
        part = timing_aids.bwd_weight_partials(res, prec, wg)

        def run(kernel, prec=prec, res=res, part=part):
            return timing_aids.bwd_weight_partials(res, prec, kernel,
                                                   out=part)

        turns = [queued_us(lambda k=k: run(k), reps) / 1e3
                 for k in ("mma", wg, wg, "mma")]
        key = "weight_bf16" if prec == "bf16" else "weight"
        bounds = bwd_bounds(hh, ww, c, prec == "bf16")
        out.update({f"{key}_turns_ms": turns,
                    f"{key}_mma_ms": (turns[0] + turns[3]) / 2,
                    f"{key}_ms": (turns[1] + turns[2]) / 2,
                    f"{key}_bound_ms": bounds and bounds["bwd_weight_kernel"]})
    return out


def measure(hh: int, ww: int, c: int, reps: int, bf16: bool = False,
            bwd_only: bool = False, bwd_batches=()) -> dict:
    w, h, t0, dt, y0, f0, g, hb, tb, kw, raw = _inputs(hh, ww, c)
    row = {"shape": f"{hh}x{ww}x{c}"}
    row.update(_passes(hh, ww, c, bf16))
    for nb in bwd_batches:
        if nb != B_BWD:
            args = _bwd_rows(nb, h, t0, g)
            row[f"odefunc_bwd_b{nb}_split_ms"] = device_split(
                lambda: odefunc_bwd(w, *args, groups=G), BWD_KERNELS, reps)
            if bf16:
                fn16 = lambda: odefunc_bwd(w, *args, groups=G,  # noqa: E731
                                           precision="bf16")
                row[f"odefunc_bwd_bf16_b{nb}_split_ms"] = (
                    device_parts(fn16, ROWS_BWD_PARTS, reps)
                    if _rows_bwd(hh, ww, c)
                    else device_split(fn16, BWD_KERNELS, reps))
    if not bwd_only:
        row["odefunc_ms"] = device_ms(lambda: odefunc(w, t0, h, groups=G),
                                      ("odefunc_kernel",), reps)
        row["rk_step_ms"] = device_ms(
            lambda: dopri5_step(w, DOPRI5, t0, dt, y0, f0, **kw),
            ("rk_step_kernel",), reps)
    row["odefunc_bwd_split_ms"] = device_split(
        lambda: odefunc_bwd(w, tb, hb, g, groups=G), BWD_KERNELS, reps)
    row["odefunc_bwd_ms"] = sum(row["odefunc_bwd_split_ms"].values())
    row["odefunc_bwd_bound_ms"] = bwd_bounds(hh, ww, c)
    if bf16 and not bwd_only:
        import torch.nn.functional as F

        xn = h.permute(0, 3, 1, 2).bfloat16()
        wn = w.w1.permute(3, 2, 0, 1).bfloat16()

        def f16():
            return odefunc(w, t0, h, groups=G, compute_dtype=torch.bfloat16)

        rows_build = _rows_build(hh, ww, c)
        if rows_build:
            # The rows build (seven launches a call) and the per-sample
            # kernel it replaced, in turns: device ms by CUDA events behind
            # a spin kernel.
            from neural_ode_features_tpu_torch.probes.conv_probe import (
                queued_us,
            )
            from neural_ode_features_tpu_torch.probes.timing_aids import (
                odefunc_cta_bf16,
            )

            def cta():
                return odefunc_cta_bf16(w, t0, h, G)

            turns = [queued_us(fn, reps) / 1e3 for fn in (cta, f16, f16, cta)]
            row.update({"odefunc_bf16_turns_ms": turns,
                        "odefunc_bf16_cta_ms": (turns[0] + turns[3]) / 2,
                        "rows_gn_fwd_ms": rows_gn_ms(f16, ROWS_GN_FWD, reps),
                        "rows_gn_fwd_bound_ms": rows_gn_bound(hh, ww, c, B,
                                                              "fwd")})
        row.update({
            "odefunc_bf16_ms": ((row["odefunc_bf16_turns_ms"][1]
                                 + row["odefunc_bf16_turns_ms"][2]) / 2
                                if rows_build else device_ms(
                                    f16, ("odefunc_kernel",), reps)),
            "rk_step_bf16_ms": device_ms(
                lambda: dopri5_step(w, DOPRI5, t0, dt, y0, f0,
                                    conv_precision="bf16", **kw),
                ("rk_step_kernel",), reps),
            "conv_library_bf16_ms": _event_ms(
                lambda: F.conv2d(xn, wn, padding=1), reps),
        })
    if bf16:
        def bwd16():
            return odefunc_bwd(w, tb, hb, g, groups=G, precision="bf16")

        if _rows_bwd(hh, ww, c):
            # The rows backward (fifteen launches a call) and the one-CTA
            # pass it replaced: each split, then the calls in turns.
            from neural_ode_features_tpu_torch.probes.conv_probe import (
                queued_us,
            )
            from neural_ode_features_tpu_torch.probes.timing_aids import (
                odefunc_bwd_cta_bf16,
            )

            def cta():
                return odefunc_bwd_cta_bf16(w, tb, hb, g, G)

            row["odefunc_bwd_bf16_split_ms"] = device_parts(
                bwd16, ROWS_BWD_PARTS, reps)
            row["odefunc_bwd_bf16_cta_split_ms"] = device_split(
                cta, BWD_KERNELS, reps)
            turns = [queued_us(fn, reps) / 1e3
                     for fn in (cta, bwd16, bwd16, cta)]
            row.update({"odefunc_bwd_bf16_turns_ms": turns,
                        "odefunc_bwd_bf16_cta_ms": (turns[0] + turns[3]) / 2,
                        "odefunc_bwd_bf16_rows_ms": (turns[1] + turns[2]) / 2,
                        "rows_gn_bwd_ms": rows_gn_ms(bwd16, ROWS_GN_BWD, reps),
                        "rows_gn_bwd_bound_ms": rows_gn_bound(
                            hh, ww, c, B_BWD, "bwd")})
        else:
            row["odefunc_bwd_bf16_split_ms"] = device_split(
                bwd16, BWD_KERNELS, reps)
        row["odefunc_bwd_bf16_ms"] = sum(
            v for k, v in row["odefunc_bwd_bf16_split_ms"].items()
            if k != "rows_pass")
        row["odefunc_bwd_bf16_bound_ms"] = bwd_bounds(hh, ww, c, True)
        if bwd_only:
            row.update(_library_bwd_ms(raw, hb, tb, g, reps))
    if bwd_only:
        row.update(weight_turns(w, tb, hb, g, bf16, reps))
    return row


def bwd_errors(hh: int, ww: int, c: int, bf16: bool = False) -> dict:
    """The backward's dθ max abs error against the float64 plain version at
    B = 128, 64, 5, beside the f32 plain version's; with ``bf16`` the bf16
    build's readings against the plain bf16 VJP (the module docstring)."""
    from neural_ode_features_tpu_torch.kernels.odefunc_bwd import (
        odefunc_bwd_plain,
    )

    w, _, _, _, _, _, g, hb, tb, _, _ = _inputs(hh, ww, c)
    w64 = type(w)(*(x.double() for x in w))

    def flat(dp):
        return torch.cat([dp[a][b].reshape(-1) for a in sorted(dp)
                          for b in sorted(dp[a])]).double()

    row = {"shape": f"{hh}x{ww}x{c}"}
    for nb in (B_BWD, B_BWD // 2, 5):
        args = (tb[:nb].contiguous(), hb[:nb].contiguous(),
                g[:nb].contiguous())
        ref = flat(odefunc_bwd_plain(w64, *(a.double() for a in args),
                                     G)[0])
        row[f"dtheta_err_b{nb}"] = float(
            (flat(odefunc_bwd(w, *args, groups=G)[0]) - ref).abs().max())
        row[f"plain_f32_err_b{nb}"] = float(
            (flat(odefunc_bwd_plain(w, *args, G)[0]) - ref).abs().max())
    if bf16:
        from neural_ode_features_tpu_torch.probes import bf16_distances

        readings = bf16_distances.bwd_readings(w, tb, hb, g, G)
        row["bf16"] = readings
        row["bf16_fails"] = bf16_distances.check(readings)
    return row


def _event_ms(fn, reps: int) -> float:
    """ms per call of a library call (whatever its kernels are named), by
    CUDA events around ``reps`` back-to-back calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _rows_build(hh: int, ww: int, c: int) -> bool:
    """Whether the package runs the bf16 ``odefunc`` at this shape as the
    rows build (``kernels.odefunc.stage`` gives ``'rows_bf16'``)."""
    from neural_ode_features_tpu_torch.kernels.odefunc import stage

    return stage((hh, ww), c, "bf16") == "rows_bf16"


def digest(hh: int, ww: int, c: int) -> dict:
    """sha256 of each f32 kernel's outputs on the seeded inputs."""
    from neural_ode_features_tpu_torch.kernels.conv3x3 import (
        BF16_STRATEGIES,
        STRATEGIES,
        conv3x3,
        supported,
    )
    from neural_ode_features_tpu_torch.probes.conv_probe import probe_inputs

    w, h, t0, dt, y0, f0, g, hb, tb, kw, _ = _inputs(hh, ww, c)

    def sha(*tensors):
        out = hashlib.sha256()
        for x in tensors:
            out.update(x.detach().contiguous().cpu().numpy().tobytes())
        return out.hexdigest()[:16]

    res = {}
    dp, dtk, dh, fb = odefunc_bwd(w, tb, hb, g, groups=G, with_f=True,
                                  residuals=res)
    kernels = [dp[a]["kernel"] for a in ("conv1", "conv2")]
    row = {"shape": f"{hh}x{ww}x{c}",
           "odefunc": sha(odefunc(w, t0, h, groups=G)),
           "rk_step": sha(*dopri5_step(w, DOPRI5, t0, dt, y0, f0, **kw)),
           "odefunc_bwd_weights": sha(*(k[:, :, 1:] for k in kernels)),
           "odefunc_bwd_rest": sha(
               *(dp[a][b] for a in sorted(dp) for b in sorted(dp[a])
                 if b != "kernel"), *(k[:, :, :1] for k in kernels),
               dtk, dh, fb),
           "odefunc_bwd_r": sha(res["r1"], res["r2"])}
    if hasattr(dopri5_step, "launches_bf16"):
        res16 = {}
        b16 = odefunc_bwd(w, tb, hb, g, groups=G, with_f=True,
                          precision="bf16", residuals=res16)
        kernels16 = [b16[0][a]["kernel"] for a in ("conv1", "conv2")]
        row.update({
            "odefunc_bwd_bf16_weights": sha(
                *(k[:, :, 1:] for k in kernels16)),
            "odefunc_bwd_bf16_rest": sha(
                *(b16[0][a][b] for a in sorted(b16[0])
                  for b in sorted(b16[0][a]) if b != "kernel"),
                *(k[:, :, :1] for k in kernels16), *b16[1:3]),
            "odefunc_bwd_bf16_f": sha(b16[3]),
            "odefunc_bwd_bf16_r": sha(*(res16[k] for k in sorted(res16)))})
        row.update({
            "odefunc_bf16": sha(odefunc(w, t0, h, groups=G,
                                        compute_dtype=torch.bfloat16)),
            "rk_step_bf16": sha(*dopri5_step(w, DOPRI5, t0, dt, y0, f0,
                                             conv_precision="bf16", **kw)),
            "odefunc_bwd_bf16": sha(
                *(b16[0][a][b] for a in sorted(b16[0])
                  for b in sorted(b16[0][a])), *b16[1:])})
        if _rows_build(hh, ww, c):
            from neural_ode_features_tpu_torch.probes.timing_aids import (
                odefunc_cta_bf16,
            )

            row["odefunc_bf16_cta"] = sha(odefunc_cta_bf16(w, t0, h, G))
        if _rows_bwd(hh, ww, c):
            from neural_ode_features_tpu_torch.probes.timing_aids import (
                odefunc_bwd_cta_bf16,
            )

            cta = odefunc_bwd_cta_bf16(w, tb, hb, g, G, with_f=True)
            row["odefunc_bwd_bf16_cta"] = sha(
                *(cta[0][a][b] for a in sorted(cta[0])
                  for b in sorted(cta[0][a])), *cta[1:])
    from neural_ode_features_tpu_torch.probes import timing_aids

    if hasattr(timing_aids, "odefunc_bwd_mma_weights"):
        # The weight gradients on the mma.sync kernel, which the path's
        # must equal.
        for key, prec in (("odefunc_bwd_weights_mma", "f32"),
                          ("odefunc_bwd_bf16_weights_mma", "bf16")):
            dm = timing_aids.odefunc_bwd_mma_weights(w, tb, hb, g, G, prec)[0]
            row[key] = sha(*(dm[a]["kernel"][:, :, 1:]
                             for a in ("conv1", "conv2")))
    x, wc = probe_inputs(B, "cuda", (hh, ww), c)
    for strategy in STRATEGIES + BF16_STRATEGIES:
        if supported((hh, ww), c, strategy):
            row[f"conv_{strategy}"] = sha(conv3x3(x, wc, strategy))
    return row


def solve_times(n: int) -> dict:
    """Host-side times of this package's inference solve and wrapper calls
    (see the module docstring)."""
    import statistics

    from neural_ode_features_tpu_torch.entry import (
        ENTRY_CONFIG,
        entry,
        train_entry,
    )
    from neural_ode_features_tpu_torch.models import odenet_logits
    from neural_ode_features_tpu_torch.solver import runge_kutta

    _, (params, x) = entry(device="cuda", batch=B)
    own = runge_kutta._while_loop

    def host(body, carry, steps, *args, **kwargs):
        return runge_kutta._host_loop(body, carry, steps)

    def clock(fn):
        torch.cuda.synchronize()
        t_s = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t_s)

    out = {}
    with torch.no_grad():
        for route, loop in (("host_loop", host), ("own_route", own)):
            runge_kutta._while_loop = loop
            try:
                clock(lambda: odenet_logits(params, x, ENTRY_CONFIG))
                out[f"solve_{route}_ms"] = statistics.median(
                    clock(lambda: odenet_logits(params, x, ENTRY_CONFIG))
                    for _ in range(n))
            finally:
                runge_kutta._while_loop = own
    trainer, (images, labels) = train_entry(device="cuda", batch=B_BWD)
    clock(lambda: trainer.train_batch(images, labels))
    out["train_step_ms"] = statistics.median(
        clock(lambda: trainer.train_batch(images, labels)) for _ in range(n))
    w = prepare(params["odefunc"], (7, 7))
    rng = np.random.default_rng(1)
    h = torch.from_numpy((rng.normal(size=(B, 7, 7, 64)) * 0.3)
                         .astype(np.float32)).cuda()
    t0 = torch.full((B,), 0.25, device="cuda")
    dt = torch.full((B,), 0.1, device="cuda")
    y0 = h.reshape(B, -1)
    f0 = odefunc(w, t0, h, groups=G).reshape(B, -1)
    kw = dict(hw=(7, 7), groups=G, rtol=1e-3, atol=1e-3)
    for name, fn in (("odefunc", lambda: odefunc(w, t0, h, groups=G)),
                     ("rk_step", lambda: dopri5_step(w, DOPRI5, t0, dt, y0,
                                                     f0, **kw))):
        fn()
        torch.cuda.synchronize()
        t_s = time.perf_counter()
        for _ in range(200):
            fn()
        host_us = 1e6 * (time.perf_counter() - t_s) / 200
        torch.cuda.synchronize()
        out[f"{name}_call_host_us"] = host_us
    if hasattr(odefunc_bwd, "launches_bf16"):
        w96, _, _, _, _, _, g96, hb96, tb96, _, _ = _inputs(7, 7, 96)
        bwd16 = lambda: odefunc_bwd(w96, tb96, hb96, g96, groups=G,  # noqa: E731
                                    precision="bf16")
        bwd16()
        torch.cuda.synchronize()
        t_s = time.perf_counter()
        for _ in range(50):
            bwd16()
        out["odefunc_bwd_bf16_call_host_us"] = (
            1e6 * (time.perf_counter() - t_s) / 50)
        torch.cuda.synchronize()
    return out


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--shapes", default="7x7x64,6x6x64",
                   help="comma-separated HxWxC")
    p.add_argument("--reps", type=int, default=100)
    p.add_argument("--solves", type=int, default=0,
                   help="also time N inference solves and the wrappers' "
                        "host cost per call")
    p.add_argument("--bf16", action="store_true",
                   help="also time the bf16 builds and F.conv2d in bf16")
    p.add_argument("--digest", action="store_true",
                   help="print the sha256 of the f32 kernels' outputs per "
                        "shape, in place of their times")
    p.add_argument("--bwd-only", action="store_true",
                   help="time the backward alone (with --bf16, both builds)")
    p.add_argument("--bwd-batch", default="",
                   help="comma-separated batches (<= 256) at which to time "
                        "the backward beside B = 128")
    p.add_argument("--errors", action="store_true",
                   help="print the backward's dθ errors against float64 "
                        "per shape, in place of times")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"=== kernel_times on {smi} ===")
    rows = []
    for shape in filter(None, args.shapes.split(",")):
        hh, ww, c = (int(v) for v in shape.split("x"))
        if args.digest:
            rows.append(digest(hh, ww, c))
        elif args.errors:
            rows.append(bwd_errors(hh, ww, c, args.bf16))
        else:
            rows.append(measure(
                hh, ww, c, args.reps, args.bf16, args.bwd_only,
                [int(v) for v in filter(None, args.bwd_batch.split(","))]))
        print(json.dumps(rows[-1]))
    if args.solves:
        import neural_ode_features_tpu_torch as pkg

        rows.append({"package": pkg.__file__, **solve_times(args.solves)})
        print(json.dumps(rows[-1]))
    return rows


if __name__ == "__main__":
    main()
