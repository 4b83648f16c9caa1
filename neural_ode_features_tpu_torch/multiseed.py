"""Multi-seed accuracy campaign with the port (counterpart of the JAX tool
``tools/multiseed.py``): every learning-dependent claim at several seeds,
reported as mean ± std.

    python -m neural_ode_features_tpu_torch.multiseed [--phase all]
        [--seeds 0,1,2] [--population] [--num-devices N] [--cpu]
    python -m neural_ode_features_tpu_torch.multiseed --summarize

Campaign (on the synthetic twins; the cells and record keys are the JAX
tool's):
  flagship   synthetic-cifar10, 24 epochs, adjoint dopri5 tol 1e-3
  adjsweep   synthetic-mnist 16,384 images, 8 epochs: reintegrate /
             interpolated / seminorm / direct-backprop
  ladder     each flagship checkpoint evaluated at the solver-fidelity
             rungs (euler 1/4 steps, dopri5 tol 1e-1..1e-4)

Each cell runs the port's ``train`` (``python -m
neural_ode_features_tpu_torch.train``) or ``eval_ckpt`` in a subprocess and
appends one JSON line per completed cell to ``--out`` (default
``<runs-dir>/multiseed.jsonl``; append-only, resumable: cells already there
are skipped).  ``--population`` trains every missing seed of a cell in one
``train --seeds`` run; ``--num-devices`` and ``--cpu`` are passed to
``train`` (and ``--cpu`` to ``eval_ckpt``).  ``--summarize`` prints the
table.
"""

from __future__ import annotations

import argparse
import collections
import csv
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

__all__ = ["main", "summarize"]

FLAGSHIP_ARGS = ["--dataset", "synthetic-cifar10", "--epochs", "24",
                 "--lr-decay-epochs", "12,18,22", "--tol", "1e-3"]
ADJSWEEP_BASE = ["--dataset", "synthetic-mnist", "--epochs", "8",
                 "--limit", "16384", "--lr-decay-epochs", "5,7",
                 "--tol", "1e-3"]
ADJSWEEP_MODES = {
    "reintegrate": [],
    "interpolated": ["--adjoint-mode", "interpolated"],
    "seminorm": ["--adjoint-seminorm"],
    "backprop": ["--no-adjoint"],
}
LADDER = [
    ("euler1", ["--solver", "euler", "--steps", "1"]),
    ("euler4", ["--solver", "euler", "--steps", "4"]),
    ("dopri5-1e-1", ["--solver", "dopri5", "--tol", "1e-1"]),
    ("dopri5-1e-2", ["--solver", "dopri5", "--tol", "1e-2"]),
    ("dopri5-1e-3", ["--solver", "dopri5", "--tol", "1e-3"]),
    ("dopri5-1e-4", ["--solver", "dopri5", "--tol", "1e-4"]),
]


def _records(out: Path) -> list[dict]:
    if not out.exists():
        return []
    recs = []
    for line in out.read_text().splitlines():
        try:
            recs.append(json.loads(line))
        except json.JSONDecodeError:
            pass
    return recs


def _done(out: Path) -> set[str]:
    return {r["key"] for r in _records(out) if "key" in r}


def _emit(out: Path, rec: dict) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(f"[multiseed] {rec['key']}: {rec}", flush=True)


def _best_top1(run_dir: Path) -> float:
    with open(run_dir / "log.csv") as f:
        rows = list(csv.DictReader(f))
    return max(float(r["test_acc"]) for r in rows if r.get("test_acc"))


def _run(module: str, argv: list[str], timeout: float) -> str:
    cmd = [sys.executable, "-m", f"neural_ode_features_tpu_torch.{module}",
           *argv]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, start_new_session=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{module} failed rc={proc.returncode}:\n"
                           f"{proc.stdout[-1000:]}\n{proc.stderr[-1000:]}")
    return proc.stdout


class Campaign:
    """The cells of one campaign: where records go and how ``train`` runs."""

    def __init__(self, out: Path, runs_dir: Path, train_flags: list[str],
                 cpu: bool):
        self.out, self.runs_dir = out, runs_dir
        self.train_flags, self.cpu = train_flags, cpu

    def train(self, argv: list[str]) -> Path:
        """One solo ``train``; returns the run directory from its banner."""
        stdout = _run("train", [*argv, *self.train_flags, "--runs-dir",
                                str(self.runs_dir)], 5400)
        for line in stdout.splitlines():
            if line.startswith("run dir:"):
                return Path(line.split("run dir:", 1)[1].strip())
        raise RuntimeError(f"no run dir in train's output:\n{stdout[-2000:]}")

    def train_population(self, argv: list[str],
                         seeds: list[int]) -> dict[int, Path]:
        """One ``train --seeds`` run for every seed; ``{seed: run_dir}``
        from the per-seed banners."""
        stdout = _run("train", [*argv, *self.train_flags, "--seeds",
                                ",".join(map(str, seeds)), "--runs-dir",
                                str(self.runs_dir)],
                      5400 * max(1, len(seeds)))
        dirs = {}
        for line in stdout.splitlines():
            if line.startswith("run dir (seed "):
                head, path = line.split("):", 1)
                dirs[int(head.removeprefix("run dir (seed "))] = Path(
                    path.strip())
        missing = [s for s in seeds if s not in dirs]
        if missing:
            raise RuntimeError(f"population run dirs missing for seeds "
                               f"{missing}:\n{stdout[-2000:]}")
        return dirs

    def cell(self, key: str, run_dir: Path, population: bool) -> None:
        rec = {"key": key, "top1": _best_top1(run_dir),
               "run_dir": str(run_dir)}
        if population:
            rec["population"] = True
        _emit(self.out, rec)

    def ladder(self, seed: int, run_dir: str) -> None:
        for rung, extra in LADDER:
            key = f"ladder-{rung}-seed{seed}"
            if key in _done(self.out):
                continue
            stdout = _run("eval_ckpt", ["--run", run_dir, "--dataset",
                                        "synthetic-cifar10", *extra,
                                        *(["--cpu"] if self.cpu else [])],
                          2400)
            line = [ln for ln in stdout.splitlines()
                    if ln.strip().startswith("{")][-1]
            _emit(self.out, {"key": key, **json.loads(line)})


def summarize(out: Path) -> None:
    """Mean ± std of top-1 per cell over its seeds (the last record of a
    key wins: a repeated cell counts once)."""
    if not out.exists():
        print(f"no {out} yet")
        return
    by_key = {r["key"]: r["top1"] for r in _records(out)
              if "key" in r and "top1" in r}
    groups = collections.defaultdict(list)
    for key, top1 in by_key.items():
        groups[key.rsplit("-seed", 1)[0]].append(top1)
    print(f"{'cell':34s} {'n':>2s} {'mean':>7s} {'std':>7s}  values")
    for base in sorted(groups):
        v = np.asarray(groups[base], float)
        std = v.std(ddof=1) if len(v) > 1 else 0.0
        print(f"{base:34s} {len(v):2d} {v.mean():7.4f} {std:7.4f}  "
              + " ".join(f"{x:.4f}" for x in v))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--phase", default="all",
                   choices=["flagship", "adjsweep", "ladder", "all"])
    p.add_argument("--seeds", default="0,1,2")
    p.add_argument("--summarize", action="store_true")
    p.add_argument("--population", action="store_true",
                   help="train every missing seed of a cell in one "
                        "train --seeds run instead of one run per seed")
    p.add_argument("--runs-dir", default="runs")
    p.add_argument("--out", default=None,
                   help="the JSONL records (default <runs-dir>/"
                        "multiseed.jsonl)")
    p.add_argument("--num-devices", type=int, default=None,
                   help="passed to train")
    p.add_argument("--cpu", action="store_true",
                   help="passed to train and eval_ckpt")
    args = p.parse_args(argv)
    runs_dir = Path(args.runs_dir)
    out = Path(args.out) if args.out else runs_dir / "multiseed.jsonl"
    if args.summarize:
        summarize(out)
        return
    flags = ((["--cpu"] if args.cpu else [])
             + ([] if args.num_devices is None
                else ["--num-devices", str(args.num_devices)]))
    camp = Campaign(out, runs_dir, flags, args.cpu)
    seeds = [int(s) for s in args.seeds.split(",")]
    phases = {"flagship": args.phase in ("flagship", "all", "ladder"),
              "adjsweep": args.phase in ("adjsweep", "all"),
              "ladder": args.phase in ("ladder", "all")}
    flagship_dirs = {int(r["key"].rsplit("seed", 1)[1]): r["run_dir"]
                     for r in _records(out)
                     if r.get("key", "").startswith("flagship-seed")}

    cells = []  # (key prefix, train argv)
    if phases["flagship"]:
        cells.append(("flagship", FLAGSHIP_ARGS))
    if phases["adjsweep"]:
        cells += [(f"adjsweep-{mode}", [*ADJSWEEP_BASE, *extra])
                  for mode, extra in ADJSWEEP_MODES.items()]
    for prefix, train_argv in cells:
        todo = [s for s in seeds if f"{prefix}-seed{s}" not in _done(out)]
        if not todo:
            continue
        if args.population:
            dirs = camp.train_population(train_argv, todo)
        else:
            dirs = {s: camp.train([*train_argv, "--seed", str(s)])
                    for s in todo}
        for s, run_dir in dirs.items():
            camp.cell(f"{prefix}-seed{s}", run_dir, args.population)
            if prefix == "flagship":
                flagship_dirs[s] = str(run_dir)
    if phases["ladder"]:
        for s in seeds:
            if s in flagship_dirs:
                camp.ladder(s, flagship_dirs[s])


if __name__ == "__main__":
    main()
