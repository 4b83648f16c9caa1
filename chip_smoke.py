#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failed check exits nonzero and prints no result):

1. Build the CUDA kernels from ``neural_ode_features_tpu_torch/csrc``.
2. Hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (B = 256, 7×7×64), and the fused step also at a ragged
   B = 5.
3. Run the main path, ``entry(device="cuda", batch=256)`` (CIFAR-10 ODE-Net,
   per-sample dopri5 at tol 1e-3, full width, random weights), with the
   launch counters set to 0 just before: the ODEfunc kernel must launch
   twice (f0 and the initial-step probe), the fused step once per attempt.
   TF32 must be off.  The plain path (no kernels) runs on the same card and
   inputs; per-sample NFE and logits must agree.
4. Time each kernel, its plain version and the library yardstick (one f
   through cuDNN: ``F.group_norm``/``F.conv2d`` on NCHW with the t channel
   concatenated), and the whole solve in img/s.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

B, HH, WW, C, G = 256, 7, 7, 64, 32
TOL = 1e-3
STATE_TOL = dict(rtol=2e-4, atol=2e-5)   # kernel vs plain: f32 reassociation
RATIO_TOL = dict(rtol=2e-3, atol=1e-6)   # error ratio: a sum of squares
PEAK_F32_FLOPS = 67e12                   # H100 SXM, non-tensor f32
PEAK_BYTES = 3.35e12                     # H100 SXM HBM3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def close(name, got, want, rtol, atol):
    """Assert allclose; return the max absolute error."""
    import torch

    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        fail(f"{name}: kernel vs plain max abs err {err:.3e} "
             f"(rtol {rtol}, atol {atol})")
    return err


def time_ms(fn, reps: int = 10, blocks: int = 5) -> float:
    """Median over ``blocks`` of the mean time of ``reps`` back-to-back
    calls, from CUDA events, after a warm-up."""
    import torch

    fn()
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
        means.append(start.elapsed_time(end) / reps)
    return statistics.median(means)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from neural_ode_features_tpu_torch.entry import ENTRY_CONFIG, entry
    from neural_ode_features_tpu_torch.kernels import _build
    from neural_ode_features_tpu_torch.kernels.odefunc import (
        odefunc,
        odefunc_plain,
        prepare,
    )
    from neural_ode_features_tpu_torch.kernels.rk_step import (
        dopri5_step,
        dopri5_step_plain,
    )
    from neural_ode_features_tpu_torch.models import head_apply, stem_apply
    from neural_ode_features_tpu_torch.solver import DOPRI5, odeint

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"card: {torch.cuda.get_device_name(0)}")

    # 1. Build.
    t_build = time.perf_counter()
    logs = _build.build_all()
    print(f"[build] {len(logs)} kernel(s) built in "
          f"{time.perf_counter() - t_build:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # 2. Kernel checks at the main path's shapes.
    fwd, (params, x) = entry(device="cuda", batch=B)
    w = prepare(params["odefunc"], (HH, WW))
    rng = np.random.default_rng(1)
    h = torch.from_numpy((rng.normal(size=(B, HH, WW, C)) * 0.3)
                         .astype(np.float32)).to(dev)
    t = torch.from_numpy(rng.uniform(0, 1, B).astype(np.float32)).to(dev)
    err_k1 = close("odefunc", odefunc(w, t, h, groups=G),
                   odefunc_plain(w, t, h, G), **STATE_TOL)

    t0 = torch.from_numpy(rng.uniform(0, 0.5, B).astype(np.float32)).to(dev)
    dt = torch.from_numpy(rng.uniform(0.05, 0.2, B).astype(np.float32)).to(dev)
    y0 = h.reshape(B, -1)
    f0 = odefunc_plain(w, t0, h, G).reshape(B, -1)
    step_kw = dict(hw=(HH, WW), groups=G, rtol=TOL, atol=TOL)
    err_k2 = 0.0
    for nb in (B, 5):  # 5: a ragged batch
        got = dopri5_step(w, DOPRI5, t0[:nb], dt[:nb], y0[:nb].contiguous(),
                          f0[:nb].contiguous(), **step_kw)
        want = dopri5_step_plain(w, DOPRI5, t0[:nb], dt[:nb], y0[:nb],
                                 f0[:nb], **step_kw)
        for name, g, r in zip(("y1", "f1", "y_mid"), got[:3], want[:3]):
            err_k2 = max(err_k2, close(f"rk_step {name} B={nb}", g, r,
                                       **STATE_TOL))
        close(f"rk_step ratio B={nb}", got[3], want[3], **RATIO_TOL)
    torch.cuda.synchronize()
    print(f"[check] odefunc max abs err {err_k1:.3e}; rk_step max abs err "
          f"{err_k2:.3e} (B={B} and B=5)")

    # 3. Main path, counters from 0.
    odefunc.launches = 0
    dopri5_step.launches = 0
    torch.cuda.synchronize()
    t_main = time.perf_counter()
    logits, nfe = fwd(params, x)
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t_main
    launches = {"odefunc": odefunc.launches, "rk_step": dopri5_step.launches}
    attempts = int(((nfe - 2) // 6).max())
    print(f"[main] B={B}: {t_main:.3f} s (first call), launches {launches}, "
          f"attempts {attempts}, NFE mean {float(nfe.float().mean()):.2f} "
          f"min {int(nfe.min())} max {int(nfe.max())}")
    if launches["odefunc"] != 2:
        fail(f"odefunc kernel launched {launches['odefunc']} times, not 2")
    if launches["rk_step"] != attempts or attempts < 1:
        fail(f"rk_step kernel launched {launches['rk_step']} times for "
             f"{attempts} attempts")
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on")
    if tuple(logits.shape) != (B, 10) or not bool(torch.isfinite(logits).all()):
        fail(f"logits {tuple(logits.shape)} not finite (B, 10)")

    cfg = ENTRY_CONFIG
    ts = torch.tensor([0.0, 1.0], device=dev)

    def plain_forward():
        h0 = stem_apply(params["stem"], x, cfg)
        traj, stats = odeint(
            lambda tt, y: odefunc_plain(w, tt, y, G), h0, ts, rtol=TOL,
            atol=TOL, method="dopri5", error_control="per_sample",
            max_steps=cfg.max_steps)
        return head_apply(params["head"], traj[-1], cfg), stats.nfe

    logits_p, nfe_p = plain_forward()
    same = nfe == nfe_p
    share = float(same.float().mean())
    mean_k, mean_p = float(nfe.float().mean()), float(nfe_p.float().mean())
    print(f"[main] plain path: NFE equal on {share:.4f} of samples, mean "
          f"{mean_k:.3f} (kernels) vs {mean_p:.3f} (plain)")
    if share < 0.99 or abs(mean_k - mean_p) > 0.01 * mean_p:
        fail("per-sample NFE differs from the plain path")
    logit_err = float((logits[same] - logits_p[same]).abs().max())
    if not torch.allclose(logits[same], logits_p[same], rtol=1e-3, atol=1e-3):
        fail(f"logits differ from the plain path: max abs err {logit_err:.3e}")
    print(f"[main] logits vs plain path: max abs err {logit_err:.3e}")

    # 4. Times.
    wt = params["odefunc"]

    def library_f():
        xn = h.permute(0, 3, 1, 2)
        tmap = t.view(-1, 1, 1, 1).expand(-1, 1, HH, WW)
        out = F.relu(F.group_norm(xn, G, wt["norm1"]["scale"],
                                  wt["norm1"]["bias"], 1e-5))
        out = F.conv2d(torch.cat([tmap, out], 1),
                       wt["conv1"]["kernel"].permute(3, 2, 0, 1),
                       wt["conv1"]["bias"], padding=1)
        out = F.relu(F.group_norm(out, G, wt["norm2"]["scale"],
                                  wt["norm2"]["bias"], 1e-5))
        out = F.conv2d(torch.cat([tmap, out], 1),
                       wt["conv2"]["kernel"].permute(3, 2, 0, 1),
                       wt["conv2"]["bias"], padding=1)
        return F.group_norm(out, G, wt["norm3"]["scale"], wt["norm3"]["bias"],
                            1e-5).permute(0, 2, 3, 1)

    lib_err = float((library_f() - odefunc_plain(w, t, h, G)).abs().max())
    print(f"[time] library f vs plain f: max abs err {lib_err:.3e}")
    ms = {
        "odefunc": time_ms(lambda: odefunc(w, t, h, groups=G)),
        "odefunc_plain": time_ms(lambda: odefunc_plain(w, t, h, G)),
        "odefunc_library": time_ms(library_f),
        "rk_step": time_ms(lambda: dopri5_step(w, DOPRI5, t0, dt, y0, f0,
                                               **step_kw)),
        "rk_step_plain": time_ms(lambda: dopri5_step_plain(
            w, DOPRI5, t0, dt, y0, f0, **step_kw)),
    }
    solve_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t_s = time.perf_counter()
        fwd(params, x)
        torch.cuda.synchronize()
        solve_s.append(time.perf_counter() - t_s)
    plain_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t_s = time.perf_counter()
        plain_forward()
        torch.cuda.synchronize()
        plain_s.append(time.perf_counter() - t_s)
    print(f"[time] whole solve B={B}: {B / statistics.median(solve_s):.1f} "
          f"img/s with the kernels (median of {solve_s}), "
          f"{B / statistics.median(plain_s):.1f} img/s plain "
          f"(median of {plain_s})")

    n = HH * WW * C
    conv_flops = 2 * 2 * HH * WW * 9 * C * C * B      # two 3×3 convs, per f
    weight_bytes = 4 * (2 * 9 * C * C + 2 * n + 8 * C)

    def bound(flops, nbytes):
        by_ops, by_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
        return 1e3 * max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                             else "bytes")

    b1, by1 = bound(conv_flops, 4 * (2 * B * n + B) + weight_bytes)
    b2, by2 = bound(6 * conv_flops, 4 * (5 * B * n + 3 * B) + weight_bytes)
    kernels = [
        {"name": "odefunc", "route": "cuda",
         "source": "neural_ode_features_tpu_torch/csrc/odefunc.cu",
         "replaces": "neural_ode_features_tpu/kernels/odefunc_pallas.py:219",
         "launches": launches["odefunc"], "max_abs_err": err_k1,
         "ms": ms["odefunc"], "plain_ms": ms["odefunc_plain"],
         "bound_ms": b1, "bound_by": by1,
         "library_ms": ms["odefunc_library"]},
        {"name": "rk_step", "route": "cuda",
         "source": "neural_ode_features_tpu_torch/csrc/rk_step.cu",
         "replaces": "neural_ode_features_tpu/kernels/rk_step_pallas.py:586",
         "launches": launches["rk_step"], "max_abs_err": err_k2,
         "ms": ms["rk_step"], "plain_ms": ms["rk_step_plain"],
         "bound_ms": b2, "bound_by": by2, "library_ms": None},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
