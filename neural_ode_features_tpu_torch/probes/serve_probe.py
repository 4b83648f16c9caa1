"""Timing the serving host from a client: its totals read between phases,
sequential and streamed requests in alternating turns, and a sweep of the
host interpreter's switch interval (how often its I/O and compute threads
trade the interpreter lock).

    python -m neural_ode_features_tpu_torch.probes.serve_probe
        [--intervals 0.005,0.001,0.0002] [--rounds 1] [--batch 256] [--cpu]

The sweep exports the ``entry()`` model (seed 7) at ``--batch`` rows and,
for each interval, spawns the port's host (``serve.py --listen``) with
``sys.setswitchinterval`` set to it, then times ``turns()`` and a burst of
64 ragged requests of 1..32 rows.  One JSON line per interval, after the
card's name and power limit.  ``chip_smoke.py`` uses the helpers for its
``[serve]`` phase at the default interval.
"""

from __future__ import annotations

import argparse
import json
import os
import select
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
STATS_TAG = "listen: stats "


def spawn_host(art, addr: str, *args: str, err_file,
               switch_interval: float | None = None) -> subprocess.Popen:
    """The port's host on ``art`` listening at ``addr``; stdout a binary
    pipe, stderr to ``err_file``.  With ``switch_interval`` the host's
    interpreter trades its lock between threads that often (seconds)."""
    module = ["-m", "neural_ode_features_tpu_torch.serve"]
    if switch_interval is not None:
        module = ["-c", "import runpy, sys; sys.setswitchinterval("
                  f"{switch_interval!r}); sys.argv[0] = 'serve'; runpy."
                  "run_module('neural_ode_features_tpu_torch.serve', "
                  "run_name='__main__')"]
    return subprocess.Popen(
        [sys.executable, *module, str(art), *args, "--listen", addr],
        stdout=subprocess.PIPE, stderr=err_file, bufsize=0, cwd=ROOT)


def readline_within(proc: subprocess.Popen, seconds: float) -> str:
    """One line of a child's binary stdout pipe; kills the child and raises
    ``TimeoutError`` after ``seconds``."""
    fd, line = proc.stdout.fileno(), bytearray()
    end = time.perf_counter() + seconds
    while not line.endswith(b"\n"):
        if not select.select([fd], [], [],
                             max(0.0, end - time.perf_counter()))[0]:
            proc.kill()
            raise TimeoutError(f"no line from the serving host in {seconds} s")
        ch = os.read(fd, 1)
        if not ch:
            break
        line += ch
    return line.decode().strip()


def short_addr(tmp: Path, name: str = "s.sock") -> str:
    """A unix socket path under ``tmp``, or a free TCP port on 127.0.0.1
    where that path would pass AF_UNIX's 107 bytes."""
    import socket

    path = str(tmp / name)
    if len(path.encode()) <= 100:
        return path
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return f"tcp:127.0.0.1:{probe.getsockname()[1]}"


def host_stats(proc: subprocess.Popen, err_path, timeout: float = 30.0):
    """The host's totals now: ``SIGUSR1``, then its next ``listen: stats``
    line on stderr (``err_path``)."""
    def lines():  # complete lines only
        text = Path(err_path).read_text(errors="replace")
        return [ln for ln in text[:text.rfind("\n") + 1].splitlines()
                if STATS_TAG in ln]

    n = len(lines())
    proc.send_signal(signal.SIGUSR1)
    end = time.perf_counter() + timeout
    while len(got := lines()) <= n:
        if time.perf_counter() > end or proc.poll() is not None:
            raise TimeoutError(
                f"the host printed no stats line in {timeout} s (host "
                + ("running" if proc.returncode is None
                   else f"exited {proc.returncode}") + ")")
        time.sleep(0.002)
    return json.loads(got[n].split(STATS_TAG, 1)[1])


def delta(a: dict, b: dict) -> dict:
    """Totals ``b`` less totals ``a``."""
    out = {k: b[k] - a[k] for k in ("flights", "requests", "rows",
                                    "solve_ms")}
    out["attempts"] = {k: v - a["attempts"].get(k, 0)
                       for k, v in b["attempts"].items()
                       if v != a["attempts"].get(k, 0)}
    out["launches"] = {k: v - a["launches"][k]
                       for k, v in b["launches"].items()}
    return out


def turns(client, X: np.ndarray, Y: np.ndarray, snap, *, rounds: int = 2,
          n_seq: int = 64, n_stream: int = 100) -> dict:
    """Full batches, sequential (one request at a time) and streamed
    (``infer_stream``, two in flight), in turns of ``n_seq`` and
    ``n_stream`` requests in the order seq, stream, stream, seq, repeated
    ``rounds`` times, so that a drift of the machine falls on both alike.
    Each request is a permutation of ``X`` (eight, cycled); ``Y`` is the
    host's answer to ``X``, and every answer must be its rows permuted.
    ``snap()`` reads the host's totals before and after each turn.

    Returns every sequential request's latency (s), and per turn its kind,
    img/s, dispatches, attempts and the compute thread's mean solve ms per
    dispatch; ``equal`` is whether every answer was right."""
    B = len(X)
    perms = [np.random.default_rng(40 + i).permutation(B) for i in range(8)]
    reqs = [X[p] for p in perms]
    lat, out, equal = [], [], True
    for kind in ("seq", "stream", "stream", "seq") * rounds:
        n = n_seq if kind == "seq" else n_stream
        batch = [reqs[i % 8] for i in range(n)]
        s0, t0 = snap(), time.perf_counter()
        if kind == "seq":
            ys = []
            for x in batch:
                t_r = time.perf_counter()
                ys.append(client.infer(x))
                lat.append(time.perf_counter() - t_r)
        else:
            ys = list(client.infer_stream(batch))
        secs = time.perf_counter() - t0
        d = delta(s0, snap())
        equal = equal and len(ys) == n and all(
            np.array_equal(y, Y[perms[i % 8]]) for i, y in enumerate(ys))
        out.append({"kind": kind, "requests": n, "img_s": B * n / secs,
                    "dispatches": d["flights"], "attempts": d["attempts"],
                    "solve_ms": d["solve_ms"] / max(d["flights"], 1)})
    return {"seq_latency_s": lat, "turns": out, "equal": equal}


def summary(res: dict) -> dict:
    """p50/p99 of the sequential latencies (with their count), each kind's
    img/s per turn, and whether every stream turn beat every sequential
    one (else the overlap is not resolved by these turns)."""
    lat = np.asarray(res["seq_latency_s"]) * 1e3
    by = {k: [t["img_s"] for t in res["turns"] if t["kind"] == k]
          for k in ("seq", "stream")}
    solve = {k: [t["solve_ms"] for t in res["turns"] if t["kind"] == k]
             for k in ("seq", "stream")}
    return {"requests": len(lat), "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "max_ms": float(lat.max()), "seq_img_s": by["seq"],
            "stream_img_s": by["stream"], "solve_ms_seq": solve["seq"],
            "solve_ms_stream": solve["stream"],
            "stream_above_seq_every_turn": min(by["stream"]) > max(by["seq"])}


def ragged_burst(X: np.ndarray, n: int = 64, seed: int = 3):
    """``n`` ragged requests of 1..32 rows of ``X``: (offsets, sizes, reqs)."""
    B = len(X)
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, min(32, B) + 1, size=n)
    offs = [int(rng.integers(0, B - r + 1)) for r in sizes]
    return offs, sizes, [X[o:o + r] for o, r in zip(offs, sizes)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m neural_ode_features_tpu_torch.probes.serve_probe",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--intervals", default="0.005,0.001,0.0002",
                   help="switch intervals to sweep, seconds (0.005 is "
                        "Python's default)")
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    import torch

    from neural_ode_features_tpu_torch import export_model
    from neural_ode_features_tpu_torch.entry import ENTRY_CONFIG
    from neural_ode_features_tpu_torch.models import init_odenet
    from neural_ode_features_tpu_torch.serving import SocketClient
    from neural_ode_features_tpu_torch.utils import save_checkpoint

    if not args.cpu:
        if not torch.cuda.is_available():
            print("serve_probe: CUDA is not available (--cpu)",
                  file=sys.stderr)
            return 1
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    cpu = ["--cpu"] if args.cpu else []
    with tempfile.TemporaryDirectory(prefix="srv") as tmp:
        tmp = Path(tmp)
        save_checkpoint(tmp / "run" / "ckpt_best.pt",
                        init_odenet(7, ENTRY_CONFIG, device="cpu"),
                        ENTRY_CONFIG,
                        {"model": "odenet"})
        art = export_model.main(["export-compiled", "--run", str(tmp / "run"),
                                 "--batch", str(args.batch), "--out",
                                 str(tmp / "a.npexec"), *cpu])
        X = np.load(art / "sample_input.npy")
        offs, sizes, reqs = ragged_burst(X)
        for si in (float(v) for v in args.intervals.split(",")):
            addr, err_path = short_addr(tmp), tmp / f"host{si}.err"
            with open(err_path, "wb") as err_f:
                host = spawn_host(art, addr, *cpu, err_file=err_f,
                                  switch_interval=si)
                try:
                    ready = readline_within(host, 300)
                    if ready != f"READY {addr}":
                        raise RuntimeError(f"host: {ready!r}")
                    client = SocketClient(addr)
                    t_r = time.perf_counter()
                    Y = client.infer(X)
                    first_ms = 1e3 * (time.perf_counter() - t_r)
                    res = turns(client, X, Y,
                                lambda: host_stats(host, err_path),
                                rounds=args.rounds)
                    s0, t_r = host_stats(host, err_path), time.perf_counter()
                    burst = client.infer_burst(reqs)
                    t_burst = time.perf_counter() - t_r
                    d = delta(s0, host_stats(host, err_path))
                    client.close(shutdown_server=True)
                    rc = host.wait(timeout=120)
                finally:
                    if host.poll() is None:
                        host.kill()
                        host.wait(timeout=30)
            ok = rc == 0 and res["equal"] and all(
                np.array_equal(y, Y[o:o + r])
                for y, o, r in zip(burst, offs, sizes))
            print(json.dumps({
                "switch_interval": si, "ok": ok, "first_ms": first_ms,
                **summary(res), "turns": res["turns"],
                "burst_img_s": int(sizes.sum()) / t_burst,
                "burst_rows": int(sizes.sum()),
                "burst_dispatches": d["flights"]}), flush=True)
            if not ok:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
