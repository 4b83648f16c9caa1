"""The reference training protocol in one command, ending in the accuracy
verdict (port of the JAX tool ``tools/reference_protocol.py``).

    python -m neural_ode_features_tpu_torch.reference_protocol \\
        --dataset mnist|cifar10|both [--data-dir ./data] [--epochs 160] \\
        [--limit N] [--fabricate] [--smoke] [--cpu]

Once the real MNIST or CIFAR-10 files are under ``--data-dir`` (they are not
in the repository and must be placed by hand), the pipeline per dataset, at
the reference hyperparameters (SGD 0.1, batch 128, 160 epochs, decay at
60/100/140, tol 1e-3, the adjoint: the port's ``train`` defaults), is:

1. detect the files (``data.load_dataset`` raises with placement
   instructions when they are absent);
2. ``python -m neural_ode_features_tpu_torch.train`` (resumable: a rerun
   continues the same run directory);
3. ``python -m neural_ode_features_tpu_torch.eval_ckpt`` at dopri5, tol
   1e-3: the final test top-1;
4. ``python -m neural_ode_features_tpu_torch.parity_eval``: the same
   weights through the kernels on the card against the plain path on the
   CPU (the port's half of the ±0.2% clause).  Its failure is recorded in
   the verdict and does not stop the protocol;
5. the verdict, the JAX tool's keys, printed as one JSON line and written
   to ``<runs root>/<dataset>_verdict.json``: MNIST's target is top-1 ≥
   0.993; CIFAR-10 has the ±0.2% parity clause only.

The runs and verdicts go under ``runs_protocol_torch/`` in the repository
(``run_protocol(..., runs_root=)`` elsewhere), never into the JAX tool's
``runs_protocol/``.  ``--fabricate`` first writes real-format files (IDX,
CIFAR-10 pickle batches) from the synthetic twins into ``--data-dir``,
byte for byte what the JAX tool writes, so that the whole pipeline runs
without real data; the verdict then says ``"data": "fabricated"`` and no
accuracy target applies.  ``--smoke`` shrinks the run to 2 epochs and 2,048
images on the CPU.  Every step runs on the card unless ``--cpu`` is given;
no card is an error.
"""

from __future__ import annotations

import argparse
import gzip
import json
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from ._device import resolve_device
from .data import load_dataset

__all__ = ["TARGETS", "DEFAULT_RUNS", "fabricate", "run_protocol", "main"]

ROOT = Path(__file__).resolve().parent.parent
DEFAULT_RUNS = ROOT / "runs_protocol_torch"
PACKAGE = __package__

TARGETS = {"mnist": 0.993, "cifar10": None}  # cifar10: the ±0.2% clause


# -- real-format files from the synthetic twins -------------------------

def _write_idx_images(path: Path, arr) -> None:
    with open(path, "wb") as f:
        f.write((2051).to_bytes(4, "big"))
        for d in arr.shape:
            f.write(int(d).to_bytes(4, "big"))
        f.write(np.ascontiguousarray(arr, np.uint8).tobytes())


def _write_idx_labels(path: Path, arr, gz: bool = False) -> None:
    raw = ((2049).to_bytes(4, "big") + int(arr.shape[0]).to_bytes(4, "big")
           + np.ascontiguousarray(arr, np.uint8).tobytes())
    if gz:
        with gzip.open(path, "wb") as f:
            f.write(raw)
    else:
        path.write_bytes(raw)


def _cifar_batch(x, y) -> dict:
    return {b"data": np.ascontiguousarray(
                x.transpose(0, 3, 1, 2).reshape(len(x), -1), np.uint8),
            b"labels": [int(v) for v in y]}


def fabricate(dataset: str, data_dir: Path, limit: int | None) -> None:
    """Write real-format files from the synthetic twins under
    ``data_dir``: MNIST's four IDX files, or CIFAR-10's five training
    pickles and its test pickle."""
    if dataset == "mnist":
        root = data_dir / "mnist"
        root.mkdir(parents=True, exist_ok=True)
        for split, prefix in (("train", "train"), ("test", "t10k")):
            x, y = load_dataset("synthetic-mnist", split, limit=limit)
            _write_idx_images(root / f"{prefix}-images-idx3-ubyte",
                              x[..., 0])
            _write_idx_labels(root / f"{prefix}-labels-idx1-ubyte", y)
    else:
        root = data_dir / "cifar-10-batches-py"
        root.mkdir(parents=True, exist_ok=True)
        x, y = load_dataset("synthetic-cifar10", "train", limit=limit)
        n = len(x) // 5
        for i in range(5):
            with open(root / f"data_batch_{i + 1}", "wb") as f:
                pickle.dump(_cifar_batch(x[i * n:(i + 1) * n],
                                         y[i * n:(i + 1) * n]), f)
        xt, yt = load_dataset("synthetic-cifar10", "test", limit=limit)
        with open(root / "test_batch", "wb") as f:
            pickle.dump(_cifar_batch(xt, yt), f)
    print(f"[protocol] fabricated real-format {dataset} under {root}",
          flush=True)


# -- the pipeline ---------------------------------------------------------

def _sub(cmd: list[str], timeout: int) -> subprocess.CompletedProcess:
    print(f"[protocol] $ {' '.join(cmd)}", flush=True)
    proc = subprocess.run(cmd, cwd=str(ROOT), capture_output=True, text=True,
                          timeout=timeout, start_new_session=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"step failed rc={proc.returncode}:\n{proc.stdout[-1500:]}\n"
            f"{proc.stderr[-1500:]}")
    return proc


def _last_json(stdout: str) -> dict:
    for line in reversed(stdout.splitlines()):
        if line.strip().startswith("{"):
            return json.loads(line)
    raise RuntimeError(f"no JSON line in output:\n{stdout[-800:]}")


def _tool(name: str) -> list[str]:
    return [sys.executable, "-m", f"{PACKAGE}.{name}"]


def run_protocol(dataset: str, data_dir: Path, *, epochs: int,
                 limit: int | None, cpu: bool, fabricated: bool,
                 runs_root: Path = DEFAULT_RUNS) -> dict:
    """Steps 1–5 for one dataset; returns the verdict (also written to
    ``runs_root/<dataset>_verdict.json``)."""
    t_start = time.time()
    runs_root = Path(runs_root)

    # 1. The loaders raise with placement instructions if the files are
    # absent.
    load_dataset(dataset, "test", str(data_dir), limit=8)

    # 2. Train at the reference hyperparameters, the decay epochs scaled
    # when the epoch count is overridden.
    decay = ("60,100,140" if epochs == 160 else
             ",".join(str(max(1, int(epochs * f))) for f in (.375, .625, .875)))
    train_cmd = [*_tool("train"), "--dataset", dataset, "--epochs",
                 str(epochs), "--lr-decay-epochs", decay, "--tol", "1e-3",
                 "--data-dir", str(data_dir), "--runs-dir", str(runs_root)]
    if limit:
        train_cmd += ["--limit", str(limit)]
    if cpu:
        train_cmd += ["--cpu"]
    proc = _sub(train_cmd, timeout=3600 * 4)
    run_dir = None
    for line in proc.stdout.splitlines():
        if "run dir:" in line:
            run_dir = line.split("run dir:", 1)[1].strip()
    if not run_dir:
        raise RuntimeError(f"train printed no run dir:\n{proc.stdout[-800:]}")

    # 3. The final accuracy at the reference evaluation setting.
    eval_cmd = [*_tool("eval_ckpt"), "--run", run_dir, "--dataset", dataset,
                "--data-dir", str(data_dir), "--solver", "dopri5", "--tol",
                "1e-3"]
    if limit:
        eval_cmd += ["--limit", str(limit)]
    if cpu:
        eval_cmd += ["--cpu"]
    top1 = _last_json(_sub(eval_cmd, timeout=3600).stdout)["top1"]

    # 4. The kernels against the plain path on the same weights.
    parity_cmd = [*_tool("parity_eval"), "--run", run_dir, "--limit",
                  str(min(limit or 2000, 2000)), "--data-dir", str(data_dir)]
    if cpu:
        parity_cmd += ["--cpu"]
    try:
        parity = _last_json(_sub(parity_cmd, timeout=3600).stdout)
    except Exception as e:  # informative, not gating
        parity = {"error": str(e)[:300]}

    target = TARGETS[dataset]
    verdict = {
        "dataset": dataset,
        "data": "fabricated" if fabricated else "real",
        "top1": top1,
        "target": target,
        "meets_target": (None if (target is None or fabricated)
                         else top1 >= target),
        "parity": parity,
        "parity_within_0.2pct": (
            abs(parity["top1_kernels"] - parity["top1_plain"]) <= 0.002
            if "top1_kernels" in parity else None),
        "epochs": epochs,
        "run_dir": run_dir,
        "wall_s": round(time.time() - t_start, 1),
    }
    runs_root.mkdir(parents=True, exist_ok=True)
    (runs_root / f"{dataset}_verdict.json").write_text(
        json.dumps(verdict, indent=2))
    print(json.dumps(verdict), flush=True)
    return verdict


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", default="mnist",
                   choices=["mnist", "cifar10", "both"])
    p.add_argument("--data-dir", default=str(ROOT / "data"))
    p.add_argument("--epochs", type=int, default=160)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--fabricate", action="store_true",
                   help="write real-format files from the synthetic twins "
                        "first (the verdict says data: fabricated)")
    p.add_argument("--smoke", action="store_true",
                   help="tiny run: 2 epochs, 2048 images, CPU")
    p.add_argument("--cpu", action="store_true",
                   help="every step on the CPU (default: the card)")
    return p.parse_args(argv)


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    if args.smoke:
        args.epochs = min(args.epochs, 2)
        args.limit = args.limit or 2048
        args.cpu = True
    resolve_device("cpu" if args.cpu else "cuda")  # no card is an error
    datasets = (["mnist", "cifar10"] if args.dataset == "both"
                else [args.dataset])
    data_dir = Path(args.data_dir)
    verdicts = []
    for ds in datasets:
        if args.fabricate:
            fabricate(ds, data_dir, args.limit)
        verdicts.append(run_protocol(ds, data_dir, epochs=args.epochs,
                                     limit=args.limit, cpu=args.cpu,
                                     fabricated=args.fabricate))
    return verdicts


if __name__ == "__main__":
    main()
