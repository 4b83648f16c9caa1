"""Example: the serving loop, end to end — the port's host on a socket,
driven through the port's client library (the counterpart of the JAX
package's ``examples/native_serving.py``).

Spawns ``python -m neural_ode_features_tpu_torch.serve <artifact> --listen``
and drives it through :class:`neural_ode_features_tpu_torch.serving.SocketClient`:
one round trip, then a pipelined stream in which the host stages request
*i+1* while request *i* solves, then a ragged burst that the host coalesces.

Without ``--artifact`` it exports a randomly initialised MNIST ODE-Net
(hidden 64, per-sample dopri5 at tol 1e-2) at B = 8 first.  On the card by
default; ``--cpu`` serves the plain path on the CPU:

    python -m neural_ode_features_tpu_torch.examples.native_serving --cpu
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from neural_ode_features_tpu_torch import export_model
from neural_ode_features_tpu_torch.serving import SocketClient

PKG_PARENT = Path(__file__).resolve().parents[2]


def random_artifact(workdir: Path, cpu: bool) -> Path:
    """A random-weight ODE-Net's run directory, exported at B = 8."""
    from neural_ode_features_tpu_torch.models import ModelConfig, init_odenet
    from neural_ode_features_tpu_torch.utils import save_checkpoint

    cfg = ModelConfig(in_channels=1, tol=1e-2, error_control="per_sample")
    params = init_odenet(0, cfg, device="cpu")
    save_checkpoint(workdir / "run" / "ckpt_best.pt", params, cfg,
                    {"model": "odenet"})
    return export_model.main(
        ["export-compiled", "--run", str(workdir / "run"), "--batch", "8",
         "--out", str(workdir / "model.npexec"), *(["--cpu"] if cpu else [])])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--artifact", default=None,
                   help="an export-compiled directory (default: export a "
                        "random model first)")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--cpu", action="store_true",
                   help="serve on the CPU through the plain path")
    args = p.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="serve_") as tmp:
        tmp = Path(tmp)
        artifact = (Path(args.artifact) if args.artifact
                    else random_artifact(tmp, args.cpu))
        sock = str(tmp / "serve.sock")
        cmd = [sys.executable, "-m", "neural_ode_features_tpu_torch.serve",
               str(artifact), "--listen", sock,
               *(["--cpu"] if args.cpu else [])]
        server = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.DEVNULL, text=True,
                                  bufsize=1, cwd=PKG_PARENT)
        try:
            ready = server.stdout.readline().strip()
            if not ready.startswith("READY "):
                raise SystemExit(f"the host did not start: {ready!r}")
            print(f"server: {ready}")

            with SocketClient(sock) as client:
                print(f"hello: input {client.in_shape} -> output "
                      f"{client.out_shape}, ragged rows <= {client.rows}")
                rng = np.random.default_rng(0)
                x = rng.normal(size=client.in_shape).astype(np.float32)

                t0 = time.perf_counter()
                y = client.infer(x)
                print(f"one round trip: "
                      f"{1e3 * (time.perf_counter() - t0):.1f} ms, output "
                      f"mean {float(y.mean()):+.4f}")

                xs = [rng.normal(size=client.in_shape).astype(np.float32)
                      for _ in range(args.requests)]
                t0 = time.perf_counter()
                ys = list(client.infer_stream(xs))
                wall = time.perf_counter() - t0
                print(f"pipelined stream: {len(ys)} requests in {wall:.3f} s "
                      f"({wall / len(ys) * 1e3:.1f} ms/request)")

                if client.rows:
                    # A row's answer does not depend on its batch-mates.
                    parts = [x[i:i + 1] for i in range(len(x))]
                    got = np.concatenate(client.infer_burst(parts))
                    print(f"ragged burst of {len(parts)} one-row requests: "
                          f"equal to the full batch: "
                          f"{bool(np.array_equal(got, y))}")

            # A fresh connection still works; then ask the server to exit.
            SocketClient(sock).close(shutdown_server=True)
            rc = server.wait(timeout=60)
            print(f"server shut down (exit {rc})")
            if rc != 0:
                raise SystemExit(rc)
        finally:
            if server.poll() is None:
                server.kill()
                server.wait(timeout=30)


if __name__ == "__main__":
    main()
