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
``--shapes ''`` skips the kernels.

``--bf16`` adds, per shape, the bf16 builds (``odefunc`` with
``compute_dtype=bfloat16``, ``rk_step`` with ``conv_precision='bf16'``, the
backward with ``precision='bf16'`` at B = 128, device ms as above; the
backward's three kernels apart, beside the f32 build's, and at each
``--bwd-batch``, ``odefunc_bwd_bf16_b<B>_split_ms``) and the library
yardstick of their convs, ``F.conv2d`` on bf16 tensors at that shape (one
conv, B = 256).  It needs a package that has the bf16 builds.  Each row
names the per-sample pass each build runs (``bwd_pass``, ``bwd_bf16_pass``:
``kernels.odefunc_bwd.sample_pass``, where the package has it).

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
``odefunc_bwd_bf16_f`` and ``odefunc_bwd_bf16_r``), so that two
checkouts' kernels can be held bit for bit (run once with each package on
``PYTHONPATH``, in one call).

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


def _inputs(hh: int, ww: int, c: int):
    dev = torch.device("cuda")
    cfg = ModelConfig(in_channels=3, hidden=c, groups=G)
    rng = np.random.default_rng(1)

    def arr(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    h = arr(rng.normal(size=(B, hh, ww, c)) * 0.3)
    t0, dt = arr(rng.uniform(0, 0.5, B)), arr(rng.uniform(0.05, 0.2, B))
    w = prepare(init_odenet(7, cfg, device=dev)["odefunc"], (hh, ww))
    y0, f0 = h.reshape(B, -1), odefunc(w, t0, h, groups=G).reshape(B, -1)
    g = arr(rng.normal(size=(B_BWD, hh, ww, c)))
    hb, tb = h[:B_BWD].contiguous(), t0[:B_BWD].contiguous()
    kw = dict(hw=(hh, ww), groups=G, rtol=1e-3, atol=1e-3)
    return w, h, t0, dt, y0, f0, g, hb, tb, kw


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


def measure(hh: int, ww: int, c: int, reps: int, bf16: bool = False,
            bwd_only: bool = False, bwd_batches=()) -> dict:
    w, h, t0, dt, y0, f0, g, hb, tb, kw = _inputs(hh, ww, c)
    row = {"shape": f"{hh}x{ww}x{c}"}
    row.update(_passes(hh, ww, c, bf16))
    for nb in bwd_batches:
        if nb != B_BWD:
            args = _bwd_rows(nb, h, t0, g)
            row[f"odefunc_bwd_b{nb}_split_ms"] = device_split(
                lambda: odefunc_bwd(w, *args, groups=G), BWD_KERNELS, reps)
            if bf16:
                row[f"odefunc_bwd_bf16_b{nb}_split_ms"] = device_split(
                    lambda: odefunc_bwd(w, *args, groups=G,
                                        precision="bf16"), BWD_KERNELS, reps)
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
        row.update({
            "odefunc_bf16_ms": device_ms(
                lambda: odefunc(w, t0, h, groups=G,
                                compute_dtype=torch.bfloat16),
                ("odefunc_kernel",), reps),
            "rk_step_bf16_ms": device_ms(
                lambda: dopri5_step(w, DOPRI5, t0, dt, y0, f0,
                                    conv_precision="bf16", **kw),
                ("rk_step_kernel",), reps),
            "conv_library_bf16_ms": _event_ms(
                lambda: F.conv2d(xn, wn, padding=1), reps),
        })
    if bf16:
        row["odefunc_bwd_bf16_split_ms"] = device_split(
            lambda: odefunc_bwd(w, tb, hb, g, groups=G, precision="bf16"),
            BWD_KERNELS, reps)
        row["odefunc_bwd_bf16_ms"] = sum(
            row["odefunc_bwd_bf16_split_ms"].values())
        row["odefunc_bwd_bf16_bound_ms"] = bwd_bounds(hh, ww, c, True)
    return row


def bwd_errors(hh: int, ww: int, c: int, bf16: bool = False) -> dict:
    """The backward's dθ max abs error against the float64 plain version at
    B = 128, 64, 5, beside the f32 plain version's; with ``bf16`` the bf16
    build's readings against the plain bf16 VJP (the module docstring)."""
    from neural_ode_features_tpu_torch.kernels.odefunc_bwd import (
        odefunc_bwd_plain,
    )

    w, _, _, _, _, _, g, hb, tb, _ = _inputs(hh, ww, c)
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


def digest(hh: int, ww: int, c: int) -> dict:
    """sha256 of each f32 kernel's outputs on the seeded inputs."""
    from neural_ode_features_tpu_torch.kernels.conv3x3 import (
        BF16_STRATEGIES,
        STRATEGIES,
        conv3x3,
        supported,
    )
    from neural_ode_features_tpu_torch.probes.conv_probe import probe_inputs

    w, h, t0, dt, y0, f0, g, hb, tb, kw = _inputs(hh, ww, c)

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
