"""Straggler bench: what a batch's slowest samples cost per-sample adaptive
stepping, and what NFE-bucketed batching wins back (port of the JAX tool
``tools/straggler_bench.py``).

    python -m neural_ode_features_tpu_torch.straggler_bench [--pool 4096] \\
        [--batch-size 256] [--dim 64] [--lambda-max 200] [--tol 1e-6] \\
        [--reps 3] [--controller i|pi] [--cpu]

Per-sample adaptive stepping runs each batch until its slowest sample is
done, so a batch that mixes easy and stiff samples pays about its largest
NFE on every row.  NFE-bucketed batching (``extract --nfe-sort``) reorders
the pool by a cheap loose-tolerance NFE probe so that each batch holds
samples of like NFE.  The ODE-Net cannot show this (its GroupNorm-normalised
dynamics give an NFE that hardly depends on the input), so the pool here is
scalar linear ODEs y' = -λ·y per row of ``--dim`` components, λ log-spaced
over [1, ``--lambda-max``], drawn from ``np.random.default_rng(0)`` as the
JAX tool draws them, each batch solved over [0, 1] at rtol = atol =
``--tol`` with ``max_steps`` 4096.

Three modes over the same pool: per-sample control on a shuffled order,
per-sample control on the order sorted by the NFE of a probe at 10× the
tolerance, and batch-global control on the shuffled order (the reference's
execution model: one step sequence per batch from the batch-RMS error
norm).  Prints one JSON line with the JAX tool's keys: the three host
clocks (best of ``--reps`` after a warm-up run) and the probe's; the lane
work, the sum over batches of batch size × largest NFE (what the device
runs) beside the sum of per-sample NFE (the useful work); and each mode's
worst per-sample error in tolerance units, |y_num − y_exact| / (atol +
rtol·|y_exact|) against the closed form y(1) = y0·exp(−λ), since the modes
do not buy the same accuracy.  Beside the host clocks, the device's clock
over the same span (CUDA events, best of ``--reps``; ``None`` on the CPU):
``device_time_shuffled_ms``, ``device_time_nfe_sorted_ms``,
``device_time_global_shuffled_ms`` and ``device_probe_ms``.

The JAX tool runs the pool as one compiled scan over the batches.  Here a
Python loop runs the batches through ``solver.odeint`` (the port's host
loop, one device→host sync per attempt), which is how the port executes
every solve.  No hand-written kernel is on this path: the dynamics are one
elementwise product.  Runs on the card unless ``--cpu`` is given; no card is
an error.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ._device import strict_f32
from .solver import odeint

__all__ = ["parse_args", "make_pool", "solve_pool", "run_bench", "main"]

MAX_STEPS = 4096


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pool", type=int, default=4096)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--dim", type=int, default=64,
                   help="state dimension per sample")
    p.add_argument("--lambda-max", type=float, default=200.0)
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--controller", choices=("i", "pi"), default="i",
                   help="step-size controller for every solve")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    return p.parse_args(argv)


def make_pool(pool: int, batch_size: int, dim: int, lambda_max: float):
    """The JAX tool's pool: ``(lam (pool,), y0 (pool, dim), rng)``, numpy
    f32, ``pool`` cut to whole batches; ``rng`` is left where the JAX tool
    next draws the shuffled order from it."""
    pool = (pool // batch_size) * batch_size
    rng = np.random.default_rng(0)
    lam = np.exp(rng.uniform(0.0, np.log(lambda_max), size=pool)).astype(
        np.float32)
    y0 = rng.normal(size=(pool, dim)).astype(np.float32)
    return lam, y0, rng


def solve_pool(lam: torch.Tensor, y0: torch.Tensor, order: np.ndarray,
               batch_size: int, *, tol: float, error_control: str,
               controller: str):
    """Solve the pool in batches of ``batch_size`` rows taken in ``order``:
    returns ``(nfe (pool,), largest NFE per batch (n_batches,), worst error
    in tolerance units)``, the first two as numpy int arrays."""
    ts = torch.tensor([0.0, 1.0], dtype=y0.dtype, device=y0.device)
    idx = torch.as_tensor(np.asarray(order).reshape(-1, batch_size),
                          device=y0.device)
    nfes, worst = [], []
    for sel in idx:
        lam_b = lam[sel][:, None]
        y0_b = y0[sel]

        def f(t, y):
            return -lam_b * y

        ys, stats = odeint(f, y0_b, ts, rtol=tol, atol=tol,
                           error_control=error_control,
                           controller=controller, max_steps=MAX_STEPS)
        exact = y0_b * torch.exp(-lam_b)
        err = (ys[-1] - exact).abs() / (tol + tol * exact.abs())
        worst.append(err.amax())
        nfes.append(stats.nfe.expand(y0_b.shape[0]))
    nfe = torch.stack(nfes).cpu().numpy()
    return (nfe.reshape(-1), nfe.max(axis=1),
            float(torch.stack(worst).max()))


def _timed(fn, dev: torch.device):
    """``(fn(), host seconds, device ms or None)``: the host clock around
    ``fn`` and a synchronize, and CUDA events on the current stream."""
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        end.record()
        torch.cuda.synchronize(dev)
    host = time.perf_counter() - t0
    return out, host, start.elapsed_time(end) if cuda else None


def run_bench(pool=4096, batch_size=256, dim=64, lambda_max=200.0,
              tol=1e-6, reps=3, controller="i", *, device="cuda") -> dict:
    """The JAX tool's ``run_bench`` on ``device``; returns its dict plus
    the device clocks and ``backend`` (the JAX CLI adds that in ``main``)."""
    dev = strict_f32(device)
    lam_np, y0_np, rng = make_pool(pool, batch_size, dim, lambda_max)
    pool = len(lam_np)
    lam = torch.from_numpy(lam_np).to(dev)
    y0 = torch.from_numpy(y0_np).to(dev)

    def measure(order, error_control="per_sample"):
        def run():
            return solve_pool(lam, y0, order, batch_size, tol=tol,
                              error_control=error_control,
                              controller=controller)
        run()  # warm-up
        host, devs = float("inf"), []
        for _ in range(reps):
            out, t_h, t_d = _timed(run, dev)
            host = min(host, t_h)
            devs.append(t_d)
        nfe, max_nfe, err = out
        executed = int(np.sum(max_nfe.astype(np.int64)) * batch_size)
        return host, (None if devs[0] is None else min(devs)), nfe, \
            executed, err

    shuffled = rng.permutation(pool)
    t_shuf, d_shuf, nfe_s, lane_shuf, err_shuf = measure(shuffled)
    # The reference's execution model on the same shuffled pool.
    t_glob, d_glob, _, lane_glob, err_glob = measure(shuffled, "global")

    # The mechanism: the NFE of a probe at 10× the tolerance, argsort,
    # rebatch (extract --nfe-sort).
    def probe():
        return solve_pool(lam, y0, np.arange(pool), batch_size,
                          tol=tol * 10, error_control="per_sample",
                          controller=controller)[0]
    probe()  # warm-up
    nfe_probe, probe_dt, d_probe = _timed(probe, dev)
    order = np.argsort(nfe_probe, kind="stable")
    t_sort, d_sort, _, lane_sort, err_sort = measure(order)

    useful = int(np.sum(np.asarray(nfe_s, np.int64)))

    def ms(x):
        return None if x is None else round(x, 4)

    return {
        "metric": "straggler_bench_mixed_stiffness",
        "pool": pool,
        "batch_size": batch_size,
        "dim": dim,
        "tol": tol,
        "controller": controller,
        "nfe_spread": [int(nfe_s.min()), int(nfe_s.max())],
        "time_shuffled_s": round(t_shuf, 4),
        "time_nfe_sorted_s": round(t_sort, 4),
        "time_global_shuffled_s": round(t_glob, 4),
        "probe_s": round(probe_dt, 4),
        "speedup": round(t_shuf / t_sort, 3),
        "speedup_with_probe": round(t_shuf / (t_sort + probe_dt), 3),
        "speedup_vs_global": round(t_glob / (t_sort + probe_dt), 3),
        "err_units_shuffled": round(err_shuf, 2),
        "err_units_sorted": round(err_sort, 2),
        "err_units_global": round(err_glob, 2),
        "lane_work_shuffled": lane_shuf,
        "lane_work_sorted": lane_sort,
        "lane_work_global": lane_glob,
        "lane_work_useful": useful,
        "lane_work_reduction": round(lane_shuf / max(lane_sort, 1), 3),
        "device_time_shuffled_ms": ms(d_shuf),
        "device_time_nfe_sorted_ms": ms(d_sort),
        "device_time_global_shuffled_ms": ms(d_glob),
        "device_probe_ms": ms(d_probe),
        "backend": dev.type,
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    result = run_bench(pool=args.pool, batch_size=args.batch_size,
                       dim=args.dim, lambda_max=args.lambda_max,
                       tol=args.tol, reps=args.reps,
                       controller=args.controller,
                       device="cpu" if args.cpu else "cuda")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
