"""The train step across ranks: its time at 1..N ranks, its numbers against
one rank, and the collectives it adds.

    python -m neural_ode_features_tpu_torch.probes.parallel_probe \\
        [--ranks 1,2,4] [--batch 128] [--steps 6] [--cpu]

At the JAX ``TrainConfig`` defaults on ``synthetic-cifar10`` (hidden 64,
tol 1e-3 per sample, augment on), for each rank count n of ``--ranks``
(``parallel.launch``: one rank per card with NCCL, or gloo processes with
``--cpu``), one launch runs, in turn:

* ``dp``: data parallel at the global batch ``--batch`` (strong scaling);
* ``dp_weak``: data parallel at ``--batch`` rows per rank;
* ``fsdp``: a (n/2, 2) mesh at the global batch (even n only);
* ``allreduce``: the sums the step adds, alone: the per-attempt norm buffer
  of the backward solve and the gradient, each summed over the n ranks 50
  times back to back (µs per sum: the host clock around them and a
  synchronise).

Each configuration runs ``--steps`` steps on the same batches at every n;
the step time is the median over the steps after the first two (host
clock around a synchronise), with img/s.  The first two steps' metrics
are held against the n = 1 run's at the JAX bars (step-1 loss rtol 1e-6
and NFE equal; step-2 loss rtol 3e-4, NFE equal, nfe_b within 1) and
printed as ``bars``.  Prints the card's name and power limit, then one
JSON line per configuration.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.distributed as dist

from neural_ode_features_tpu_torch.data import load_dataset
from neural_ode_features_tpu_torch.entry import TRAIN_CONFIG
from neural_ode_features_tpu_torch.models import init_odenet
from neural_ode_features_tpu_torch.parallel import (
    all_reduce_sum,
    launch,
    rank_devices,
)
from neural_ode_features_tpu_torch.parallel.tasks import train_steps
from neural_ode_features_tpu_torch.utils import count_parameters


def sum_us(n_floats: int, device: str, reps: int = 50) -> float:
    """µs per sum of ``n_floats`` f32 values over every rank."""
    dev = torch.device(device)
    t = torch.ones(n_floats, device=dev)
    all_reduce_sum(t, None)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        all_reduce_sum(t, None)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / reps


def _rank(jobs, sums, device):
    out = {name: train_steps(cfg, batches, device=device)
           for name, cfg, batches in jobs}
    dist.barrier()
    out["allreduce"] = {name: sum_us(n, device) for name, n in sums.items()}
    return out


def _bars(got, want) -> bool:
    return (abs(got[0]["loss"] - want[0]["loss"])
            <= 1e-6 * abs(want[0]["loss"])
            and got[0]["nfe"] == want[0]["nfe"]
            and abs(got[1]["loss"] - want[1]["loss"])
            <= 3e-4 * abs(want[1]["loss"])
            and got[1]["nfe"] == want[1]["nfe"]
            and abs(got[1]["nfe_b"] - want[1]["nfe_b"]) <= 1.0)


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", default="1,2,4")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--cpu", action="store_true",
                   help="gloo ranks on the CPU (control flow only: no "
                        "device time)")
    args = p.parse_args(argv)
    kind = "cpu" if args.cpu else "cuda"
    counts = [int(n) for n in args.ranks.split(",")]
    card = ("cpu" if args.cpu else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    print(f"card: {card}")
    cfg = TRAIN_CONFIG
    b = args.batch
    x, y = load_dataset(cfg.dataset, "train", limit=b * max(counts))
    y = y.astype(np.int64)
    params = init_odenet(cfg.seed, cfg.model_config(), device="cpu")
    n_odefunc, n_all = (count_parameters(params["odefunc"]),
                        count_parameters(params))
    sums = {"norm_per_attempt": 3 * (n_odefunc + 1) + 1,
            "gradient_per_step": n_all + 3}

    def batches(rows):
        return [(x[:rows], y[:rows])] * args.steps

    rows, base = [], {}
    for n in counts:
        jobs = [("dp", dataclasses.replace(cfg, batch_size=b,
                                           num_devices=n), batches(b)),
                ("dp_weak", dataclasses.replace(cfg, batch_size=b * n,
                                                num_devices=n),
                 batches(b * n))]
        if n % 2 == 0:
            jobs.append(("fsdp", dataclasses.replace(
                cfg, batch_size=b, num_devices=n, model_shards=2),
                batches(b)))
        res = launch(_rank, n, jobs, sums if n > 1 else {}, kind,
                     devices=rank_devices(n, kind), timeout=600)[0]
        for name, _, bt in jobs:
            r = res[name]
            step_s = r["step_s"][2:] or r["step_s"]
            med = statistics.median(step_s)
            row = {"config": name, "ranks": n, "global_batch": len(bt[0][1]),
                   "step_ms": 1e3 * med, "img_s": len(bt[0][1]) / med,
                   "steps_ms": [1e3 * s for s in r["step_s"]],
                   "nfe": r["metrics"][0]["nfe"],
                   "nfe_b": r["metrics"][0]["nfe_b"],
                   "launches_rank0": r["launches"][0], "card": card}
            key = (name.replace("fsdp", "dp"), len(bt[0][1]))
            if n == 1:
                base[key] = r["metrics"]
            elif key in base:
                row["bars"] = _bars(r["metrics"], base[key])
            rows.append(row)
            print(json.dumps(row), flush=True)
        if n > 1:
            row = {"config": "allreduce", "ranks": n,
                   "floats": sums, "us": res["allreduce"], "card": card}
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
