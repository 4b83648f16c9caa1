"""Example: train → export → serve, the port's deployment loop (the
counterpart of the JAX package's ``examples/deploy_artifact.py``).

Trains a tiny MNIST ODE-Net for a few adjoint SGD steps, writes its run
directory, exports it with ``export_model export-compiled`` (weights,
sample input, expected logits, ``meta.json``), serves the artifact from a
separate process (``python -m neural_ode_features_tpu_torch.serve
--listen``) and checks that the served answers equal the live model's, bit
for bit, for a full batch and for ragged requests.

On the card by default; ``--cpu`` runs it all on the plain path:

    python -m neural_ode_features_tpu_torch.examples.deploy_artifact --cpu
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from neural_ode_features_tpu_torch import export_model
from neural_ode_features_tpu_torch._device import strict_f32
from neural_ode_features_tpu_torch.models import (
    ModelConfig,
    init_odenet,
    odenet_logits,
)
from neural_ode_features_tpu_torch.serving import SocketClient
from neural_ode_features_tpu_torch.utils import save_checkpoint

PKG_PARENT = Path(__file__).resolve().parents[2]
B = 16


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cpu", action="store_true",
                   help="train, export and serve on the CPU (plain path)")
    args = p.parse_args(argv)
    dev = strict_f32("cpu" if args.cpu else "cuda")

    # -- "training" (a few steps is plenty for the demo) --------------------
    cfg = ModelConfig(in_channels=1, tol=1e-2, error_control="per_sample")
    params = pytree.tree_map(lambda a: a.requires_grad_(),
                             init_odenet(0, cfg, device=dev))
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(B, 28, 28, 1))
                         .astype(np.float32)).to(dev)
    y = torch.arange(B, device=dev) % 10

    def loss_fn():
        # adjoint=True: training always rides the adjoint's backward solve.
        logits, _ = odenet_logits(params, x, cfg, adjoint=True)
        return F.cross_entropy(logits, y)

    for _ in range(3):
        grads = torch.autograd.grad(loss_fn(), pytree.tree_leaves(params))
        with torch.no_grad():
            for a, g in zip(pytree.tree_leaves(params), grads):
                a -= 0.05 * g
    print(f"trained 3 steps; loss {float(loss_fn().detach()):.4f}")
    params = pytree.tree_map(lambda a: a.detach(), params)

    with tempfile.TemporaryDirectory(prefix="deploy_") as tmp:
        tmp = Path(tmp)
        save_checkpoint(tmp / "run" / "ckpt_best.pt", params, cfg,
                        {"model": "odenet"})

        # -- export: weights + sample + expected logits + meta --------------
        art = export_model.main(
            ["export-compiled", "--run", str(tmp / "run"), "--batch", str(B),
             "--out", str(tmp / "model.npexec"),
             *(["--cpu"] if args.cpu else [])])

        # -- the serving process: the artifact, in another process ----------
        sock = str(tmp / "serve.sock")
        server = subprocess.Popen(
            [sys.executable, "-m", "neural_ode_features_tpu_torch.serve",
             str(art), "--listen", sock, *(["--cpu"] if args.cpu else [])],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            bufsize=1, cwd=PKG_PARENT)
        try:
            ready = server.stdout.readline().strip()
            if not ready.startswith("READY "):
                raise SystemExit(f"the host did not start: {ready!r}")
            batch = np.asarray(x.cpu())  # pretend this arrived over the wire
            live = export_model.logits_fn(params, cfg, "odenet")(x).cpu()
            with SocketClient(sock) as client:
                served = client.infer(batch)
                ragged = np.concatenate(client.infer_burst(
                    [batch[:5], batch[5:6], batch[6:]]))
                client.close(shutdown_server=True)
            rc = server.wait(timeout=60)
        finally:
            if server.poll() is None:
                server.kill()
                server.wait(timeout=30)
    live = live.numpy()
    diff = float(np.abs(served - live).max())
    print(f"served logits {served.shape}; max|served - live| = {diff:.2e}; "
          f"ragged requests equal to the full batch: "
          f"{bool(np.array_equal(ragged, served))}; host exit {rc}")
    if diff != 0.0 or not np.array_equal(ragged, served) or rc != 0:
        raise SystemExit("the served model differs from the live model")
    print("OK: the artifact serves the trained model")


if __name__ == "__main__":
    main()
