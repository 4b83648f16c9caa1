#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failed check exits nonzero and prints no result):

1. Build the CUDA kernels from ``neural_ode_features_tpu_torch/csrc``, one
   ``nvcc`` per source, all at once.
2. Hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes (B = 256 for inference, B = 128 for training,
   7×7×64), the fused step and the backward kernel also at a ragged B = 5.
   The backward kernel is held against its plain version in float64 (the
   f32 plain version's cuDNN weight gradients are less exact than the
   kernel), its f output against the ODEfunc kernel's; two backward
   launches must give bit-identical dθ.  The backward call's device time is
   split by kernel name.  The four conv probe kernels (``tap9``, ``im2col``
   and the tensor-core ``mma3``, ``mma1``) are held against
   ``conv3x3_plain`` at B = 256, a ragged B = 5 and a 6×6 map, in f32 and in
   float64 (``mma1``, plain TF32, at its own looser tolerance), and
   ``mma3``'s error against the f64 plain version is printed beside
   ``tap9``'s.  Then the probe's own path, ``probes.conv_probe.main``, the
   four-strategy race at B = 256 and B = 128, with the conv counter set to
   0 just before.
3. The inference path, ``entry(device="cuda", batch=256)`` (CIFAR-10
   ODE-Net, per-sample dopri5 at tol 1e-3, full width, random weights),
   with the launch counters set to 0 just before: the ODEfunc kernel must
   launch twice (f0 and the initial-step probe), the fused step once per
   attempt.  TF32 must be off.  The plain path (no kernels) runs on the
   same card and inputs; per-sample NFE and logits must agree.
4. Training-path parity: the adjoint loss and parameter gradients through
   the kernels against the plain path (``odefunc_plain`` under autograd) on
   the card, B = 16, tol 1e-5, global control, augment off.
5. The training path, ``train_entry(device="cuda", batch=128)`` (the JAX
   ``TrainConfig`` defaults on ``synthetic-cifar10``, augment on): 5
   ``train_batch`` steps, the counters set to 0 before each.  Per step the
   ODEfunc kernel must launch 2 + 6·(forward attempts) + 1 times (the last
   for the observation-time gradient), the backward kernel nfe_b − 1 times
   (one call per augmented evaluation: it writes f itself), the fused step
   never; loss and every gradient finite.
6. The extraction path: the trained parameters → ``save_checkpoint`` →
   ``load_checkpoint`` → ``extract_features`` over the whole
   ``synthetic-cifar10`` test split (10,000 images, B = 256, T = 11) with
   the counters set to 0 just before: two ODEfunc launches per batch, one
   fused step per attempt, the backward kernel never.  The features' ends
   against the pooled stem output and the pooled state of the T = 2 solve,
   the first batch against the plain path, the ragged last batch against
   the same images in a full batch, ``nfe_sort`` against the unsorted run,
   ``odeint_dense`` at a small step budget against the trajectory; then
   ``save_features`` (.npz) → ``evaluate_features`` per t on the card.
7. Time each kernel, its plain version and the library yardstick (one f
   through cuDNN: ``F.group_norm``/``F.conv2d`` on NCHW with the t channel
   concatenated; for the backward, ``torch.autograd.grad`` through it; for
   the conv probe, ``F.conv2d``), the whole inference solve in img/s, the
   train step in img/s split into the forward and the backward solve, and
   one extraction batch through ``extract_entry`` at T = 11 beside T = 2;
   one train step and one extraction batch under ``torch.profiler``.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line
(per kernel: the conv stage it ran; ``ms``, the device time of its kernels
by name under ``torch.profiler``; ``call_ms``, CUDA events around
back-to-back calls of its wrapper, which the host's cost of a launch bounds
from below; ``bound_ms`` with the tensor cores and ``ffma_bound_ms`` on the
CUDA cores), and last ``{"ok": true, "device": {...}}``.  Imports nothing of
JAX.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

B, HH, WW, C, G = 256, 7, 7, 64, 32
B_TRAIN = 128                            # the JAX TrainConfig batch size
TOL = 1e-3
STATE_TOL = dict(rtol=2e-4, atol=2e-5)   # kernel vs plain: f32 reassociation
RATIO_TOL = dict(rtol=2e-3, atol=1e-6)   # error ratio: a sum of squares
DP_TOL = dict(rtol=3e-4, atol=3e-4)      # dθ: sums over B·H·W products
CONV_TOL = dict(rtol=1e-4, atol=1e-5)    # one conv: sums of 576 products
TF32_TOL = dict(rtol=2e-3, atol=2e-4)    # mma1 alone: plain TF32, 11-bit operands
T_OUT = 11                               # extract's default --timestamps
PEAK_F32_FLOPS = 67e12                   # H100 SXM, non-tensor f32
PEAK_TF32_FLOPS = 495e12                 # H100 SXM, TF32 tensor cores, dense
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


def leaves(tree) -> list:
    """A param tree's leaves in a fixed (sorted-key) order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def flat(tree):
    """A param tree's leaves, concatenated."""
    import torch

    return torch.cat([x.reshape(-1) for x in leaves(tree)])


def gradient_bar(name, got, want):
    """tests/test_pallas.py:142-145: rel-L2 < 1e-2 and cosine > 0.9999."""
    got, want = got.double(), want.double()
    rel = float((got - want).norm() / want.norm())
    cos = float(got @ want / (got.norm() * want.norm()))
    if not (rel < 1e-2 and cos > 0.9999):
        fail(f"{name}: rel-L2 {rel:.3e}, cosine {cos:.7f}")
    return rel, cos


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from neural_ode_features_tpu_torch.data import load_dataset
    from neural_ode_features_tpu_torch.entry import (
        ENTRY_CONFIG,
        entry,
        extract_entry,
        train_entry,
    )
    from neural_ode_features_tpu_torch.evaluation import evaluate_features
    from neural_ode_features_tpu_torch.extract import extract_features
    from neural_ode_features_tpu_torch.features_io import (
        load_features,
        save_features,
    )
    from neural_ode_features_tpu_torch.kernels import _build
    from neural_ode_features_tpu_torch.kernels.conv3x3 import (
        STRATEGIES,
        conv3x3,
        conv3x3_plain,
        conv_bytes,
        conv_flops,
    )
    from neural_ode_features_tpu_torch.kernels.odefunc import (
        odefunc,
        odefunc_plain,
        odefunc_vjp,
        prepare,
        stage,
    )
    from neural_ode_features_tpu_torch.kernels.odefunc_bwd import (
        odefunc_bwd,
        odefunc_bwd_plain,
    )
    from neural_ode_features_tpu_torch.kernels.rk_step import (
        dopri5_step,
        dopri5_step_plain,
    )
    from neural_ode_features_tpu_torch.models import (
        head_apply,
        odenet_logits,
        odenet_trajectory,
        pool_features,
        stem_apply,
    )
    from neural_ode_features_tpu_torch.ops import normalize
    from neural_ode_features_tpu_torch.probes import conv_probe
    from neural_ode_features_tpu_torch.solver import (
        DOPRI5,
        odeint,
        odeint_adjoint,
        odeint_dense,
    )
    from neural_ode_features_tpu_torch.utils import (
        load_checkpoint,
        save_checkpoint,
    )

    def device_ms_by_kernel(fn, keys, reps: int = 20) -> dict:
        """Mean device ms per call of ``fn`` in the kernels named by each
        of ``keys`` (``torch.profiler`` over ``reps`` warm calls)."""
        return {k: v / 1e3
                for k, v in conv_probe.device_us(fn, keys, reps).items()}

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

    # The backward kernel against its plain version evaluated in float64 on
    # the same (upcast) inputs: in f32 the plain version's cuDNN
    # weight-gradient convs are themselves up to ~1e-2 off at B = 128, an
    # order of magnitude further from the f64 result than the kernel.
    hb = h[:B_TRAIN].contiguous()
    tb = t[:B_TRAIN].contiguous()
    gb = torch.from_numpy((rng.normal(size=hb.shape)).astype(np.float32)).to(dev)
    w64 = type(w)(*(x.double() for x in w))
    err_k4 = 0.0
    for nb in (B_TRAIN, 5):  # 5: a ragged batch
        args = (tb[:nb].contiguous(), hb[:nb].contiguous(),
                gb[:nb].contiguous())
        dp, dtk, dh, f_b = odefunc_bwd(w, *args, groups=G, with_f=True)
        dp2 = odefunc_bwd(w, *args, groups=G)[0]
        if not torch.equal(f_b, odefunc(w, args[0], args[1], groups=G)):
            fail(f"odefunc_bwd f B={nb}: differs from the ODEfunc kernel's")
        dp_p, dt_p, dh_p = odefunc_bwd_plain(w64, *(a.double() for a in args),
                                             G)
        dp_32 = odefunc_bwd_plain(w, *args, G)[0]
        err_k4 = max(err_k4, close(f"odefunc_bwd dh B={nb}", dh.double(),
                                   dh_p, **STATE_TOL))
        close(f"odefunc_bwd dt B={nb}", dtk.double(), dt_p, **STATE_TOL)
        err_dp = close(f"odefunc_bwd dθ B={nb}", flat(dp).double(),
                       flat(dp_p), **DP_TOL)
        err_32 = float((flat(dp_32).double() - flat(dp_p)).abs().max())
        if not torch.equal(flat(dp), flat(dp2)):
            fail(f"odefunc_bwd dθ B={nb}: two launches differ")
        print(f"[check] odefunc_bwd B={nb} vs the f64 plain version: dθ max "
              f"abs err {err_dp:.3e} (the f32 plain version's: {err_32:.3e})")
    torch.cuda.synchronize()
    print(f"[check] odefunc_bwd dh max abs err {err_k4:.3e}; dt and dθ "
          f"within tolerance; f bit-identical to the ODEfunc kernel's; dθ "
          f"bit-identical across two launches (B={B_TRAIN} and B=5)")

    # One augmented evaluation of the adjoint is one backward call.
    odefunc.launches = odefunc_bwd.launches = 0
    f_v = odefunc_vjp(w, tb, hb, gb, groups=G)[0]
    if (odefunc.launches, odefunc_bwd.launches) != (0, 1):
        fail(f"odefunc_vjp launched odefunc {odefunc.launches} and "
             f"odefunc_bwd {odefunc_bwd.launches} times, not 0 and 1")
    close("odefunc_vjp f", f_v, odefunc_plain(w, tb, hb, G), **STATE_TOL)

    # Where the backward call's time goes, by kernel (device time).
    bwd_keys = ("bwd_sample_kernel", "bwd_weight_kernel", "bwd_reduce_kernel")
    bwd_split = device_ms_by_kernel(
        lambda: odefunc_bwd(w, tb, hb, gb, groups=G), bwd_keys)
    bwd_dev = sum(bwd_split.values())
    print(f"[split] odefunc_bwd B={B_TRAIN}: device ms by kernel "
          + ", ".join(f"{k} {v:.4f} ({100 * v / bwd_dev:.0f}%)"
                      for k, v in bwd_split.items())
          + f"; sum {bwd_dev:.4f}")

    # The conv probe kernels against the plain version, in f32 and in
    # float64 on the same inputs (upcast).
    err_k5 = 0.0
    for nb, hw in ((B, (HH, WW)), (5, (HH, WW)), (B, (6, 6))):
        xc, wc = conv_probe.probe_inputs(nb, dev, hw)
        plain = conv3x3_plain(xc, wc)
        plain64 = conv3x3_plain(xc.double(), wc.double())
        errs64 = {}
        for strategy in STRATEGIES:
            tol = TF32_TOL if strategy == "mma1" else CONV_TOL
            got = conv3x3(xc, wc, strategy)
            tag = f"conv_probe {strategy} B={nb} {hw[0]}x{hw[1]}"
            err = close(tag, got, plain, **tol)
            errs64[strategy] = close(f"{tag} (f64 plain)", got.double(),
                                     plain64, **tol)
            if strategy != "mma1":
                err_k5 = max(err_k5, err)
            print(f"[check] {tag}: max abs err {err:.3e} vs plain, "
                  f"{errs64[strategy]:.3e} vs the f64 plain version (the f32 "
                  f"plain version's: "
                  f"{float((plain.double() - plain64).abs().max()):.3e})")
        print(f"[check] conv B={nb} {hw[0]}x{hw[1]} vs the f64 plain version: "
              f"mma3 {errs64['mma3']:.3e} beside tap9 {errs64['tap9']:.3e} "
              f"(both within rtol {CONV_TOL['rtol']}, atol "
              f"{CONV_TOL['atol']}); mma1 {errs64['mma1']:.3e} (plain TF32, "
              f"rtol {TF32_TOL['rtol']}, atol {TF32_TOL['atol']})")
    torch.cuda.synchronize()

    # The probe's own path, the four-strategy race at B = 256 and B = 128,
    # counter from 0.
    conv3x3.launches = 0
    probe = conv_probe.main(["--batch", f"{B},{B_TRAIN}"])
    probe_launches = conv3x3.launches
    print(f"[probe] conv3x3 launches {probe_launches}")
    if probe_launches < 2 * 2 * len(STRATEGIES):
        fail(f"the probe launched the conv kernels {probe_launches} times")
    for nb, res in probe["batches"].items():
        if not (res["mma3"]["device_us"] < res["tap9"]["device_us"]
                and res["mma3"]["device_us"] < res["library_us"]):
            fail(f"the probe at B={nb}: mma3 {res['mma3']['device_us']:.1f} us "
                 f"is not below tap9 {res['tap9']['device_us']:.1f} us and "
                 f"F.conv2d {res['library_us']:.1f} us")

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

    # 4. Training-path parity: kernels against the plain path on the card.
    trainer, (images, labels) = train_entry(device="cuda", batch=B_TRAIN)
    tp = trainer.params
    mcfg = dataclasses.replace(trainer.model_cfg, tol=1e-5,
                               error_control="global", max_steps=512)
    xs = normalize(torch.from_numpy(images[:16]).to(dev), trainer.cfg.dataset)
    ys = torch.from_numpy(labels[:16]).to(dev)
    def adjoint_grads(logits):
        loss = F.cross_entropy(logits, ys)
        grads = torch.autograd.grad(loss, leaves(tp))
        return float(loss.detach()), torch.cat([g.reshape(-1) for g in grads])

    loss_k, grads_k = adjoint_grads(odenet_logits(tp, xs, mcfg,
                                                  adjoint=True)[0])
    h0 = stem_apply(tp["stem"], xs, mcfg)
    traj, _ = odeint_adjoint(
        lambda p, tt, y: odefunc_plain(prepare(p, (HH, WW)), tt, y, G),
        tp["odefunc"], h0, torch.tensor([0.0, 1.0], device=dev),
        rtol=mcfg.tol, atol=mcfg.tol, error_control="global",
        max_steps=mcfg.max_steps)
    loss_p, grads_p = adjoint_grads(head_apply(tp["head"], traj[-1], mcfg))
    if not np.isclose(loss_k, loss_p, rtol=1e-5, atol=0):
        fail(f"adjoint loss {loss_k} (kernels) vs {loss_p} (plain)")
    rel, cos = gradient_bar("adjoint gradients vs plain", grads_k, grads_p)
    print(f"[train] parity B=16 tol 1e-5 global: loss {loss_k:.7f} vs "
          f"{loss_p:.7f} plain; gradients rel-L2 {rel:.3e}, cosine {cos:.8f}")

    # 5. The training path at full width, counters from 0 before each step.
    train_launches, nfe_f, nfe_b = [], [], []
    for step in range(5):
        odefunc.launches = odefunc_bwd.launches = dopri5_step.launches = 0
        torch.cuda.synchronize()
        t_s = time.perf_counter()
        m = trainer.train_batch(images, labels)
        torch.cuda.synchronize()
        t_s = time.perf_counter() - t_s
        got = {"odefunc": odefunc.launches, "odefunc_bwd": odefunc_bwd.launches,
               "rk_step": dopri5_step.launches}
        attempts = int(((trainer.last_stats.nfe - 2) // 6).max())
        nb_ = int(m["nfe_b"])
        print(f"[train] step {step}: {t_s:.3f} s, loss {m['loss']:.5f}, "
              f"NFE-f mean {m['nfe']:.2f}, NFE-b {nb_}, attempts {attempts}, "
              f"launches {got}")
        want = {"odefunc": 2 + 6 * attempts + 1, "odefunc_bwd": nb_ - 1,
                "rk_step": 0}
        if got != want or nb_ < 2:
            fail(f"train step {step}: launches {got}, expected {want}")
        if not np.isfinite(m["loss"]):
            fail(f"train step {step}: loss {m['loss']}")
        if not all(bool(torch.isfinite(p.grad).all())
                   for p in trainer._leaves):
            fail(f"train step {step}: a gradient is not finite")
        if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
            fail("TF32 is on")
        train_launches.append(got)
        nfe_f.append(m["nfe"])
        nfe_b.append(nb_)

    # 6. The extraction path on the trained parameters, counters from 0.
    dataset = trainer.cfg.dataset
    ecfg = trainer.model_cfg
    t_s = time.perf_counter()
    test_images, test_labels = load_dataset(dataset, "test")
    print(f"[extract] {dataset} test split: {len(test_images)} images "
          f"generated in {time.perf_counter() - t_s:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "ckpt_best.pt"
        save_checkpoint(ckpt, trainer.params, ecfg,
                        {"model": "odenet", "train": {"dataset": dataset}})
        eparams, ecfg_l, extra = load_checkpoint(ckpt)
    if ecfg_l != ecfg or extra["train"]["dataset"] != dataset:
        fail("the checkpoint's sidecar did not round-trip")
    for a, b_ in zip(leaves(eparams), leaves(trainer.params)):
        if a.device.type != "cuda" or not torch.equal(a, b_.detach()):
            fail("the checkpoint's parameters did not round-trip")
    ekw = dict(dataset=dataset, timestamps=T_OUT, batch_size=B)

    def counted(fn):
        odefunc.launches = odefunc_bwd.launches = dopri5_step.launches = 0
        torch.cuda.synchronize()
        t_s = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t_s, {
            "odefunc": odefunc.launches, "odefunc_bwd": odefunc_bwd.launches,
            "rk_step": dopri5_step.launches}

    def batch_attempts(nfe):
        return int(((nfe - 2) // 6).max())

    # One full batch: the counters exactly.
    first, _, got = counted(lambda: extract_features(
        eparams, ecfg, test_images[:B], test_labels[:B], **ekw))
    want = {"odefunc": 2, "odefunc_bwd": 0,
            "rk_step": batch_attempts(first["nfe"])}
    print(f"[extract] first batch B={B} T={T_OUT}: launches {got}")
    if got != want or want["rk_step"] < 1:
        fail(f"extraction batch: launches {got}, expected {want}")

    # The whole split.
    feats, t_all, got = counted(lambda: extract_features(
        eparams, ecfg, test_images, test_labels, **ekw))
    n_img = len(test_images)
    n_batches = -(-n_img // B)
    n_full = n_img // B
    full_attempts = sum(batch_attempts(feats["nfe"][i * B:(i + 1) * B])
                        for i in range(n_full))
    last_attempts = got["rk_step"] - full_attempts
    print(f"[extract] {n_img} images, {n_batches} batches of {B} (last: "
          f"{n_img - n_full * B} valid), T={T_OUT}: {t_all:.2f} s, "
          f"{n_img / t_all:.1f} img/s with loading and copies; launches "
          f"{got}; NFE mean {feats['nfe'].mean():.2f} min "
          f"{feats['nfe'].min()} max {feats['nfe'].max()}")
    if got["odefunc"] != 2 * n_batches or got["odefunc_bwd"] != 0:
        fail(f"extraction: launches {got} over {n_batches} batches")
    if n_full < n_batches and last_attempts < batch_attempts(
            feats["nfe"][n_full * B:]):
        fail(f"extraction: {got['rk_step']} fused steps, of which "
             f"{full_attempts} in the full batches")
    if n_full == n_batches and last_attempts != 0:
        fail(f"extraction: {got['rk_step']} fused steps for "
             f"{full_attempts} attempts")
    if (feats["features"].shape != (T_OUT, n_img, C)
            or not np.isfinite(feats["features"]).all()
            or not np.array_equal(feats["labels"], test_labels)
            or not np.array_equal(feats["features"][:, :B],
                                  first["features"])):
        fail("extraction: features are not finite (T, N, C) in dataset order")
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on")

    # The ends of the trajectory, and the plain path, on the first batch.
    with torch.no_grad():
        x0 = normalize(torch.from_numpy(test_images[:B]).to(dev), dataset)
        h0 = stem_apply(eparams["stem"], x0, ecfg)
        ends, _ = odenet_trajectory(eparams, x0, [0.0, 1.0], ecfg)
        we = prepare(eparams["odefunc"], (HH, WW))
        traj_p, stats_p = odeint(
            lambda tt, y: odefunc_plain(we, tt, y, G), h0,
            torch.from_numpy(feats["t"]).to(dev), rtol=ecfg.tol,
            atol=ecfg.tol, method="dopri5", error_control="per_sample",
            max_steps=ecfg.max_steps)
        feats_p = pool_features(traj_p).cpu().numpy()
    fb = feats["features"][:, :B]
    err_0 = float(np.abs(fb[0] - pool_features(h0).cpu().numpy()).max())
    err_1 = float(np.abs(fb[-1] - pool_features(ends[-1]).cpu().numpy()).max())
    same = feats["nfe"][:B] == stats_p.nfe.cpu().numpy()
    err_p = float(np.abs(fb[:, same] - feats_p[:, same]).max())
    print(f"[extract] features[0] vs pooled stem output: max abs err "
          f"{err_0:.3e}; features[-1] vs the pooled T=2 state: {err_1:.3e}; "
          f"vs the plain path: NFE equal on {same.mean():.4f} of samples, "
          f"features max abs err {err_p:.3e}")
    if err_0 > 1e-5 or err_1 > 1e-5:
        fail("extraction: the trajectory's ends are off")
    if same.mean() < 0.99 or not np.allclose(fb[:, same], feats_p[:, same],
                                             rtol=1e-3, atol=1e-3):
        fail("extraction: features differ from the plain path")

    # The ragged last batch against the same images inside a full batch.
    tail = n_img - n_full * B
    if tail:
        full = extract_features(eparams, ecfg, test_images[-B:],
                                test_labels[-B:], **ekw)
        err_t = float(np.abs(full["features"][:, -tail:]
                             - feats["features"][:, -tail:]).max())
        print(f"[extract] last batch ({tail} valid of {B}) vs the same "
              f"images in a full batch: max abs err {err_t:.3e}")
        if err_t > 1e-6 or not np.array_equal(full["nfe"][-tail:],
                                              feats["nfe"][-tail:]):
            fail("extraction: a padded batch changes its valid rows")

    # nfe_sort gives the same file in the dataset's order.
    sorted_, t_sort, _ = counted(lambda: extract_features(
        eparams, ecfg, test_images, test_labels, nfe_sort=True, **ekw))
    err_s = float(np.abs(sorted_["features"] - feats["features"]).max())
    print(f"[extract] nfe_sort: {t_sort:.2f} s, max abs err {err_s:.3e} "
          f"against the unsorted run")
    if (err_s > 1e-6 or not np.array_equal(sorted_["nfe"], feats["nfe"])
            or not np.array_equal(sorted_["labels"], feats["labels"])):
        fail("extraction: nfe_sort changes the file")

    # The solve-once, query-any-t API on the card at a small step budget
    # (the coefficient buffer is 16 MB per step slot at B = 256): the
    # ODEfunc kernel per stage, no fused step; y(t) against the trajectory.
    with torch.no_grad():
        odefunc.launches = dopri5_step.launches = 0
        y_at, dstats = odeint_dense(
            lambda tt, y: odefunc(we, tt, y, groups=G), h0, 0.0, 1.0,
            rtol=ecfg.tol, atol=ecfg.tol, error_control="per_sample",
            max_steps=16)
        feats_d = pool_features(
            y_at(torch.from_numpy(feats["t"]).to(dev))).cpu().numpy()
    sol = y_at.__wrapped_sol__
    err_d = float(np.abs(feats_d - fb).max())
    print(f"[dense] odeint_dense B={B} max_steps=16: coefficient buffer "
          f"{sol.coeffs.numel() * 4 / 1e6:.0f} MB, accepted steps "
          f"{int(dstats.naccept.min())}..{int(dstats.naccept.max())}, "
          f"launches odefunc {odefunc.launches} rk_step "
          f"{dopri5_step.launches}; features at {T_OUT} times vs the "
          f"trajectory: max abs err {err_d:.3e}")
    if (not bool(dstats.success.all()) or dopri5_step.launches != 0
            or odefunc.launches != 2 + 6 * int((dstats.naccept
                                                + dstats.nreject).max())
            or not np.allclose(feats_d, fb, rtol=1e-3, atol=1e-3)):
        fail("odeint_dense on the card disagrees with the trajectory")

    # The feature file, and the metrics per t on the card.
    with tempfile.TemporaryDirectory() as tmp:
        path = save_features(Path(tmp) / "features_test.npz", **feats,
                             dataset=dataset, model="odenet", tol=ecfg.tol)
        size = path.stat().st_size
        loaded = load_features(path)
    if (not np.array_equal(loaded["features"], feats["features"])
            or loaded["attrs"]["dataset"] != dataset):
        fail("the feature file did not round-trip")
    t_s = time.perf_counter()
    for i, t_i in enumerate(loaded["t"]):
        m = evaluate_features(None, None, loaded["features"][i],
                              loaded["labels"])
        print(f"[extract] t={float(t_i):.1f} | " + " | ".join(
            f"{k}={v:.4f}" for k, v in m.items()))
        if set(m) != {"linear_acc", "knn_acc", "retrieval_map"} or not all(
                0.0 <= v <= 1.0 for v in m.values()):
            fail(f"evaluate_features at t={t_i}: {m}")
    print(f"[extract] feature file {size / 1e6:.1f} MB; metrics at "
          f"{len(loaded['t'])} times over {n_img} samples in "
          f"{time.perf_counter() - t_s:.1f} s")

    # 7. Times.
    wt = params["odefunc"]

    def library_f(h=h, t=t, wt=wt):
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

    # The backward yardstick: autograd through the cuDNN f, w.r.t. the raw
    # weights, t and h (its forward included, as the kernel recomputes it).
    wlib = {k: {kk: v.detach().requires_grad_() for kk, v in d.items()}
            for k, d in wt.items()}
    hlib = hb.detach().requires_grad_()
    tlib = tb.detach().requires_grad_()
    lib_leaves = [hlib, tlib] + leaves(wlib)

    def library_bwd():
        return torch.autograd.grad(library_f(hlib, tlib, wlib), lib_leaves, gb)

    lib_dh = library_bwd()[0]
    print(f"[time] library f backward vs plain backward: dh max abs err "
          f"{float((lib_dh - odefunc_bwd_plain(w, tb, hb, gb, G)[2]).abs().max()):.3e}")
    ms = {
        "odefunc": time_ms(lambda: odefunc(w, t, h, groups=G)),
        "odefunc_plain": time_ms(lambda: odefunc_plain(w, t, h, G)),
        "odefunc_library": time_ms(library_f),
        "rk_step": time_ms(lambda: dopri5_step(w, DOPRI5, t0, dt, y0, f0,
                                               **step_kw)),
        "rk_step_plain": time_ms(lambda: dopri5_step_plain(
            w, DOPRI5, t0, dt, y0, f0, **step_kw)),
        "odefunc_bwd": time_ms(lambda: odefunc_bwd(w, tb, hb, gb, groups=G)),
        "odefunc_bwd_plain": time_ms(lambda: odefunc_bwd_plain(w, tb, hb,
                                                               gb, G)),
        "odefunc_bwd_library": time_ms(library_bwd),
    }
    # Device time of each kernel by name (the events above time the
    # wrapper's calls, which cannot go below the host's cost of a launch).
    dev_ms = {
        "odefunc": device_ms_by_kernel(
            lambda: odefunc(w, t, h, groups=G), ("odefunc_kernel",)),
        "rk_step": device_ms_by_kernel(
            lambda: dopri5_step(w, DOPRI5, t0, dt, y0, f0, **step_kw),
            ("rk_step_kernel",)),
        "odefunc_bwd": device_ms_by_kernel(
            lambda: odefunc_bwd(w, tb, hb, gb, groups=G), bwd_keys),
    }
    dev_ms = {k: sum(v.values()) for k, v in dev_ms.items()}
    print("[time] kernels, ms: " + ", ".join(
        f"{k} device {dev_ms[k]:.4f} (call {ms[k]:.4f})" for k in dev_ms))
    xc, wc = conv_probe.probe_inputs(B, dev)
    conv_dev_ms = {}
    for strategy in STRATEGIES:
        ms[f"conv_{strategy}"] = time_ms(
            lambda s_=strategy: conv3x3(xc, wc, s_), reps=100)
        name = conv_probe.KERNEL_NAMES[strategy]
        conv_dev_ms[strategy] = device_ms_by_kernel(
            lambda s_=strategy: conv3x3(xc, wc, s_), (name,), reps=100)[name]
    ms["conv_plain"] = time_ms(lambda: conv3x3_plain(xc, wc), reps=100)
    ms["conv_library"] = time_ms(lambda: conv_probe.library_conv(xc, wc),
                                 reps=100)
    print("[time] one 3x3 conv B=%d, calls: " % B + ", ".join(
        f"{k[5:]} {1e3 * ms[k]:.1f} us" for k in ms if k.startswith("conv_"))
        + "; device: " + ", ".join(
            f"{k} {1e3 * v:.1f} us" for k, v in conv_dev_ms.items())
        + " (the probe's own device readings: " + ", ".join(
            f"{k} {probe[k]['device_us']:.1f}" for k in STRATEGIES)
        + f", F.conv2d {probe['library_us']:.1f} us)")

    # One extraction batch through extract_entry, warm: T = 11 beside T = 2
    # in turns (the same solve; the difference is the dense write and the
    # pooling).
    handles = {n_t: extract_entry(device="cuda", batch=B, timestamps=n_t)
               for n_t in (T_OUT, 2)}
    extract_s = {n_t: [] for n_t in handles}
    for rep in range(6):  # the first turn warms up and is dropped
        for n_t, (efwd, ep, ex) in handles.items():
            torch.cuda.synchronize()
            t_s = time.perf_counter()
            efeats, estats = efwd(ep, ex)
            torch.cuda.synchronize()
            if rep:
                extract_s[n_t].append(time.perf_counter() - t_s)
            if tuple(efeats.shape) != (n_t, B, C):
                fail(f"extract_entry: features {tuple(efeats.shape)}")
    med_e = {k: statistics.median(v) for k, v in extract_s.items()}
    print(f"[time] extraction batch B={B}: T={T_OUT} "
          f"{B / med_e[T_OUT]:.1f} img/s ({1e3 * med_e[T_OUT]:.2f} ms, "
          f"median of {extract_s[T_OUT]}); T=2 {B / med_e[2]:.1f} img/s "
          f"({1e3 * med_e[2]:.2f} ms, median of {extract_s[2]}); attempts "
          f"{int(((estats.nfe - 2) // 6).max())}")
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

    # The train step, warm: whole steps, then the forward and the backward
    # solve apart (the same work as train_batch, without the update).
    step_s, fwd_s, bwd_s = [], [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t_s = time.perf_counter()
        trainer.train_batch(images, labels)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t_s)
    for _ in range(5):
        x_t = trainer._preprocess(images, train=True)
        y_t = trainer._labels(labels)
        torch.cuda.synchronize()
        t_s = time.perf_counter()
        loss, _, _, _ = trainer._loss_and_logits(trainer.params, x_t, y_t)
        torch.cuda.synchronize()
        t_m = time.perf_counter()
        torch.autograd.grad(loss, trainer._leaves)
        torch.cuda.synchronize()
        fwd_s.append(t_m - t_s)
        bwd_s.append(time.perf_counter() - t_m)
    # Where the time goes: one warm train step and one warm extraction batch
    # under torch.profiler, device time by kernel (the profiler's own cost
    # is in the wall time).
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_profile(label, fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t_s = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t_s
        groups = {"odefunc": "odefunc_kernel", "odefunc_bwd": "bwd_",
                  "rk_step": "rk_step_kernel"}
        dev_ms = dict.fromkeys([*groups, "other"], 0.0)
        others = []
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:  # a host op: its kernels
                continue                           # are entries of their own
            ms_ = ev.self_device_time_total / 1e3
            name = next((g for g, key in groups.items() if key in ev.key),
                        "other")
            dev_ms[name] += ms_
            if name == "other" and ms_ > 0:
                others.append((ms_, ev.count, ev.key[:60]))
        busy = sum(dev_ms.values())
        print(f"[profile] {label} under torch.profiler: wall "
              f"{1e3 * prof_wall:.2f} ms, device busy {busy:.2f} ms "
              f"({100 * busy / (1e3 * prof_wall):.1f}%), idle "
              f"{100 * (1 - busy / (1e3 * prof_wall)):.1f}%; device ms by "
              f"kernel "
              f"{json.dumps({k: round(v, 3) for k, v in dev_ms.items()})}")
        for ms_, count, key in sorted(others, reverse=True)[:8]:
            print(f"[profile]   other: {ms_:.3f} ms in {count} calls: {key}")

    device_profile(f"one train step B={B_TRAIN}",
                   lambda: trainer.train_batch(images, labels))
    device_profile(f"one extraction batch B={B} T={T_OUT}",
                   lambda: handles[T_OUT][0](*handles[T_OUT][1:]))

    med = statistics.median
    print(f"[time] train step B={B_TRAIN}: {B_TRAIN / med(step_s):.1f} img/s "
          f"(median of {step_s}); forward solve {1e3 * med(fwd_s):.2f} ms "
          f"(median of {fwd_s}), backward solve {1e3 * med(bwd_s):.2f} ms "
          f"(median of {bwd_s}); over the 5 checked steps NFE-f mean "
          f"{statistics.mean(nfe_f):.2f}, NFE-b mean {statistics.mean(nfe_b):.1f}")

    n = HH * WW * C
    f_flops = 2 * 2 * HH * WW * 9 * C * C * B         # two 3×3 convs, per f
    weight_bytes = 4 * (2 * 9 * C * C + 2 * n + 8 * C)
    # Backward: six 3×3-conv equivalents per sample (forward recompute,
    # input gradients, weight gradients); reads h, g, t, the laid-out
    # weights, writes dh, dt and the raw dθ once each.
    # ... and f once more: the recomputed forward that the kernel writes.
    bwd_flops = 6 * 2 * HH * WW * 9 * C * C * B_TRAIN
    bwd_bytes = (4 * (4 * B_TRAIN * n + 2 * B_TRAIN) + weight_bytes
                 + 4 * (2 * 9 * (C + 1) * C + 8 * C))

    def bounds(flops, nbytes):
        """The card's least time with the tensor cores (the operations
        counted once, at the TF32 rate) and on the CUDA cores (f32 FFMA),
        each the larger of its operations time and the bytes time."""
        out = {}
        for key, peak in (("", PEAK_TF32_FLOPS), ("ffma_", PEAK_F32_FLOPS)):
            by_ops, by_bytes = flops / peak, nbytes / PEAK_BYTES
            out[key + "bound_ms"] = 1e3 * max(by_ops, by_bytes)
            out[key + "bound_by"] = ("operations" if by_ops >= by_bytes
                                     else "bytes")
        return out

    fused_stage = stage((HH, WW), C)
    kernels = [
        {"name": "odefunc", "route": "cuda",
         "source": "neural_ode_features_tpu_torch/csrc/odefunc.cu",
         "replaces": "neural_ode_features_tpu/kernels/odefunc_pallas.py:219",
         "launches": launches["odefunc"], "max_abs_err": err_k1,
         "ms": dev_ms["odefunc"], "plain_ms": ms["odefunc_plain"],
         **bounds(f_flops, 4 * (2 * B * n + B) + weight_bytes),
         "library_ms": ms["odefunc_library"], "stage": fused_stage,
         "call_ms": ms["odefunc"]},
        {"name": "rk_step", "route": "cuda",
         "source": "neural_ode_features_tpu_torch/csrc/rk_step.cu",
         "replaces": "neural_ode_features_tpu/kernels/rk_step_pallas.py:586",
         "launches": launches["rk_step"], "max_abs_err": err_k2,
         "ms": dev_ms["rk_step"], "plain_ms": ms["rk_step_plain"],
         **bounds(6 * f_flops, 4 * (5 * B * n + 3 * B) + weight_bytes),
         "library_ms": None, "stage": fused_stage,
         "call_ms": ms["rk_step"]},
        {"name": "odefunc_bwd", "route": "cuda",
         "source": "neural_ode_features_tpu_torch/csrc/odefunc_bwd.cu",
         "replaces": "neural_ode_features_tpu/kernels/odefunc_bwd_rows.py:305",
         "launches": train_launches[-1]["odefunc_bwd"], "max_abs_err": err_k4,
         "ms": dev_ms["odefunc_bwd"], "plain_ms": ms["odefunc_bwd_plain"],
         **bounds(bwd_flops, bwd_bytes),
         "library_ms": ms["odefunc_bwd_library"], "stage": fused_stage,
         "call_ms": ms["odefunc_bwd"], "ms_by_kernel": bwd_split},
        {"name": "conv_probe", "route": "cuda",
         "source": "neural_ode_features_tpu_torch/csrc/conv_probe.cu",
         "replaces": "probes/conv_probe.py:254",
         "launches": probe_launches, "max_abs_err": err_k5,
         "ms": conv_dev_ms["mma3"], "plain_ms": ms["conv_plain"],
         **bounds(conv_flops(B, (HH, WW), C), conv_bytes(B, (HH, WW), C)),
         "library_ms": ms["conv_library"], "stage": "mma3",
         "call_ms": ms["conv_mma3"], "strategy_ms": conv_dev_ms,
         "strategy_call_ms": {s_: ms[f"conv_{s_}"] for s_ in STRATEGIES}},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
