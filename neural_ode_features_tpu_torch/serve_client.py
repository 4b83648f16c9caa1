"""Client for the serving hosts (the port's counterpart of the JAX tool
``tools/serve_client.py``, with its flags and output lines).

Spawns a serving host on an ``export-compiled`` artifact, by default the
port's (``python -m neural_ode_features_tpu_torch.serve``; ``--binary``
names another executable that takes the same arguments, such as
``native/pjrt_serve``), streams batches to it and collects logits:

    python -m neural_ode_features_tpu_torch.serve_client \
        --artifact <dir>.npexec --requests 4 [--cpu]

Two transports:

  --transport files (default): one line per request — "<in.npy> <out.npy>"
      -> "OK <out.npy> <seconds>" | "ERR <msg>".
  --transport socket: raw f32 tensor bytes over an AF_UNIX stream or TCP
      (the host's --listen), through :class:`.serving.SocketClient`.
      Frames: hello (u32 len + JSON shapes) once per connection; request
      u32 len + payload; response u8 status + u32 len + payload.  Depth-2
      pipelined by the host like the stdin loop.

Request 0 replays the artifact's sample input, whose answer must equal
``expected_logits.npy`` bit for bit (so export and serve on one platform).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from .serving import ServeError, SocketClient

# The directory that holds the package: the spawned host imports it.
PKG_PARENT = Path(__file__).resolve().parent.parent


def host_command(args) -> list[str]:
    """The host's command line up to its artifact argument."""
    cmd = ([args.binary] if args.binary else
           [sys.executable, "-m", "neural_ode_features_tpu_torch.serve"])
    return cmd


def host_flags(args) -> list[str]:
    flags = ["--deadline", str(args.startup_timeout)]
    if args.plugin:
        flags += ["--plugin", args.plugin]
    if args.cpu:
        flags += ["--cpu"]
    return flags


def host_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(PKG_PARENT), env.get("PYTHONPATH")) if p)
    return env


def run_socket(args, sample, expected):
    """Drive the server's --listen socket transport (unix or tcp) through
    the library client (:class:`.serving.SocketClient`)."""
    sock_path = args.listen_addr
    if sock_path is None:
        sock_dir = tempfile.mkdtemp(prefix="pjrt_serve_sock_")
        sock_path = f"{sock_dir}/serve.sock"
    cmd = [*host_command(args), args.artifact, "--listen", sock_path,
           *host_flags(args)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, bufsize=1,
                            env=host_env())
    client = None
    try:
        t0 = time.perf_counter()
        ready = proc.stdout.readline().strip()
        if not ready.startswith("READY "):
            print(f"server failed to start: {ready!r}", file=sys.stderr)
            return 1
        print(f"server READY in {time.perf_counter()-t0:.1f}s "
              f"(includes warmup execute)")

        client = SocketClient(sock_path)
        assert client.in_bytes == sample.nbytes, (client.in_bytes,
                                                  sample.nbytes)
        print(f"hello: in {list(client.in_shape)} -> out "
              f"{list(client.out_shape)} ({client.in_bytes} B in, "
              f"{client.hello['out_bytes']} B out"
              + (f", ragged rows<={client.rows}" if client.rows else "")
              + ")")

        if args.rows:
            if not client.rows:
                # The server advertises ragged rows only when the artifact's
                # meta records rowwise=true (the exporter's measured
                # row-independence flag). A batch-coupled artifact (e.g.
                # error_control='global') would return wrong numerics for coalesced rows, so
                # fail early with the cause instead of a parity mismatch.
                print(f"--rows {args.rows}: this artifact does not support "
                      "ragged requests (meta.json rowwise != true — the "
                      "model is not row-independent, or it predates the "
                      "rowwise probe); re-export with export_model "
                      "export-compiled under per-sample error control.",
                      file=sys.stderr)
                return 1
            if args.rows > client.rows:
                print(f"--rows {args.rows}: server allows 1.."
                      f"{client.rows}", file=sys.stderr)
                return 1
            # Ragged requests: R rows each.  Per-sample models compute row
            # r from input row r only, so request 0 (= the sample's first
            # R rows) must reproduce the first R expected rows even when
            # the server coalesces it with other requests and pads.
            req_shape = (args.rows,) + tuple(sample.shape[1:])
            expected = expected[:args.rows]
            sample = sample[:args.rows]
        else:
            req_shape = sample.shape

        rng = np.random.default_rng(args.seed)
        n_img = int(np.prod(req_shape[:-3]))
        reqs = [sample if i == 0 else
                rng.normal(size=req_shape).astype(np.float32)
                for i in range(args.requests)]

        def check(i, y):
            if i == 0:
                d = float(np.abs(y - expected).max())
                print(f"request 0 parity vs expected_logits: "
                      f"max|diff|={d:.3e}")
                if d != 0.0:
                    print("PARITY MISMATCH", file=sys.stderr)
                    raise SystemExit(1)
            return y

        if args.clients > 1:
            # Concurrent clients: N independent connections stream their
            # own workloads simultaneously; the server multiplexes all of
            # them into its single device pipeline (poll() loop).  Each
            # client's first request is the artifact sample, so parity is
            # checked on EVERY connection's response routing.
            import threading

            barrier = threading.Barrier(args.clients)
            errs: list[str] = []
            walls = [0.0] * args.clients

            def one_client(ci):
                crng = np.random.default_rng(args.seed + 1000 + ci)
                creqs = [sample if i == 0 else crng.normal(
                    size=sample.shape).astype(np.float32)
                    for i in range(args.requests)]
                try:
                    c = SocketClient(sock_path)
                    barrier.wait(timeout=60)
                    t = time.perf_counter()
                    for i, y in enumerate(c.infer_stream(creqs)):
                        if i == 0 and np.abs(y - expected).max() != 0.0:
                            raise ServeError(
                                f"client {ci}: request-0 parity mismatch")
                    walls[ci] = time.perf_counter() - t
                    c.close()
                except Exception as e:  # surfaced after join
                    errs.append(f"client {ci}: {e}")

            threads = [threading.Thread(target=one_client, args=(ci,))
                       for ci in range(args.clients)]
            t = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            wall = time.perf_counter() - t
            if errs:
                print("\n".join(errs), file=sys.stderr)
                return 1
            total = n_img * args.requests * args.clients
            print(f"concurrent(socket): {args.clients} clients x "
                  f"{args.requests} requests in {wall:.3f}s -> "
                  f"{total / wall:,.0f} img/s aggregate, per-client walls "
                  f"{[f'{w:.2f}s' for w in walls]} (parity checked on "
                  f"every connection)")
            return 0

        if args.burst:
            # Single-stream continuous batching: fire ALL requests, drain
            # responses concurrently — the server's batch assembler packs
            # THIS connection's queued ragged requests into shared padded
            # dispatches (infer_stream's depth-2 window never queues more
            # than one).
            t = time.perf_counter()
            try:
                outs = client.infer_burst(reqs)
            except ServeError as e:
                print(f"server error: {e}", file=sys.stderr)
                return 1
            wall = time.perf_counter() - t
            for i, y in enumerate(outs):
                check(i, y)
            total = n_img * args.requests
            print(f"burst(socket): {args.requests} requests in "
                  f"{wall:.3f}s -> {wall / args.requests * 1e3:.0f} "
                  f"ms/request, {total / wall:,.0f} img/s aggregate "
                  f"(single connection, queue-drain coalescing)")
            return 0

        if args.pipeline:
            t = time.perf_counter()
            try:
                for i, y in enumerate(client.infer_stream(reqs)):
                    check(i, y)
            except ServeError as e:
                print(f"server error: {e}", file=sys.stderr)
                return 1
            wall = time.perf_counter() - t
            total = n_img * args.requests
            print(f"pipelined(socket): {args.requests} requests in "
                  f"{wall:.3f}s -> {wall / args.requests * 1e3:.0f} "
                  f"ms/request, {total / wall:,.0f} img/s aggregate "
                  f"(zero file IO)")
            return 0

        lat = []
        for i in range(args.requests):
            t = time.perf_counter()
            try:
                y = client.infer(reqs[i])
            except ServeError as e:
                print(f"request {i}: ERR {e}", file=sys.stderr)
                return 1
            lat.append(time.perf_counter() - t)
            check(i, y)
            print(f"request {i}: OK ({lat[-1]*1e3:.1f} ms round trip, "
                  f"logits {y.shape})")
        med = sorted(lat)[len(lat) // 2]
        print(f"median client-side round trip: {med*1e3:.1f} ms "
              f"({n_img/med:,.0f} img/s, zero file IO)")
        return 0
    finally:
        try:
            if client is not None:
                client.close(shutdown_server=True)
            proc.wait(timeout=30)
        except Exception:
            proc.kill()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--artifact", required=True, help=".npexec artifact dir")
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--pipeline", action="store_true",
                   help="stream every request before reading answers: the "
                        "server overlaps request i's execute/fetch with "
                        "i+1's file read + upload (depth-2 pipelining); "
                        "measures aggregate throughput instead of "
                        "per-request latency")
    p.add_argument("--burst", action="store_true",
                   help="socket transport only: send ALL requests up front "
                        "on one connection (select-interleaved, "
                        "deadlock-free) so the server coalesces this "
                        "single stream's ragged requests into shared "
                        "device batches — the single-client face of "
                        "continuous batching")
    p.add_argument("--binary", default=None,
                   help="the host's executable (default: the port's host, "
                        "python -m neural_ode_features_tpu_torch.serve)")
    p.add_argument("--plugin", default=None,
                   help="passed to the host as --plugin (the C++ host's "
                        "PJRT plugin; the port's host takes none)")
    p.add_argument("--cpu", action="store_true",
                   help="passed to the host: serve on the CPU through the "
                        "plain path")
    p.add_argument("--transport", choices=["files", "socket"],
                   default="files")
    p.add_argument("--clients", type=int, default=1,
                   help="socket transport only: N concurrent connections, "
                        "each streaming --requests requests; measures the "
                        "server's multi-client aggregate throughput")
    p.add_argument("--rows", type=int, default=0,
                   help="socket transport only: send ragged requests of R "
                        "rows (1..B) instead of full batches; the server "
                        "coalesces queued ragged requests from all "
                        "connections into shared device batches "
                        "(continuous batching)")
    p.add_argument("--listen-addr", default=None,
                   help="socket transport address: a unix path (default: "
                        "auto tmpdir) or tcp:HOST:PORT for network "
                        "serving")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--startup-timeout", type=float, default=900.0,
                   help="the host's --deadline: seconds its startup may "
                        "take (the first use of a kernel builds it)")
    args = p.parse_args(argv)
    if args.clients > 1 and args.transport != "socket":
        p.error("--clients requires --transport socket")
    if args.rows and args.transport != "socket":
        p.error("--rows requires --transport socket")
    if args.burst and args.transport != "socket":
        p.error("--burst requires --transport socket")
    if args.burst and args.clients > 1:
        p.error("--burst is the single-connection mode; use --clients for "
                "concurrent streams")

    art = Path(args.artifact)
    sample = np.load(art / "sample_input.npy")
    expected = np.load(art / "expected_logits.npy")

    if args.transport == "socket":
        return run_socket(args, sample, expected)

    cmd = [*host_command(args), str(art), "--serve", *host_flags(args)]
    proc = subprocess.Popen(
        cmd,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, bufsize=1,
        env=host_env(),
    )
    try:
        t0 = time.perf_counter()
        ready = proc.stdout.readline().strip()
        if ready != "READY":
            print(f"server failed to start: {ready!r}", file=sys.stderr)
            return 1
        print(f"server READY in {time.perf_counter()-t0:.1f}s "
              f"(includes warmup execute)")

        rng = np.random.default_rng(args.seed)
        n_img = int(np.prod(sample.shape[:-3]))
        with tempfile.TemporaryDirectory() as td:
            if args.pipeline:
                # Stream every request line up front (lines are ~60 bytes —
                # far under the pipe buffer), then collect the in-order
                # answers; the server keeps one request computing while it
                # stages the next.
                paths = []
                for i in range(args.requests):
                    x = sample if i == 0 else rng.normal(
                        size=sample.shape).astype(np.float32)
                    in_p, out_p = f"{td}/in_{i}.npy", f"{td}/out_{i}.npy"
                    np.save(in_p, x)
                    paths.append((in_p, out_p))
                t = time.perf_counter()
                for in_p, out_p in paths:
                    proc.stdin.write(f"{in_p} {out_p}\n")
                proc.stdin.flush()
                for i in range(args.requests):
                    resp = proc.stdout.readline().strip()
                    if not resp.startswith("OK "):
                        print(f"request {i}: {resp}", file=sys.stderr)
                        return 1
                wall = time.perf_counter() - t
                d = float(np.abs(np.load(paths[0][1]) - expected).max())
                print(f"request 0 parity vs expected_logits: "
                      f"max|diff|={d:.3e}")
                if d != 0.0:
                    print("PARITY MISMATCH", file=sys.stderr)
                    return 1
                total = n_img * args.requests
                print(f"pipelined: {args.requests} requests in {wall:.3f}s "
                      f"-> {wall / args.requests * 1e3:.0f} ms/request, "
                      f"{total / wall:,.0f} img/s aggregate (incl. file IO)")
                return 0
            lat = []
            for i in range(args.requests):
                # Request 0 replays the artifact's sample input so the
                # answer is checkable bit-for-bit; the rest are fresh.
                x = sample if i == 0 else rng.normal(
                    size=sample.shape).astype(np.float32)
                in_p, out_p = f"{td}/in_{i}.npy", f"{td}/out_{i}.npy"
                np.save(in_p, x)
                t = time.perf_counter()
                proc.stdin.write(f"{in_p} {out_p}\n")
                resp = proc.stdout.readline().strip()
                lat.append(time.perf_counter() - t)
                if not resp.startswith("OK "):
                    print(f"request {i}: {resp}", file=sys.stderr)
                    return 1
                y = np.load(out_p)
                if i == 0:
                    d = float(np.abs(y - expected).max())
                    print(f"request 0 parity vs expected_logits: "
                          f"max|diff|={d:.3e}")
                    if d != 0.0:
                        print("PARITY MISMATCH", file=sys.stderr)
                        return 1
                print(f"request {i}: {resp}  (client round trip "
                      f"{lat[-1]*1e3:.0f} ms, logits {y.shape})")
            med = sorted(lat)[len(lat) // 2]
            print(f"median client-side round trip: {med*1e3:.0f} ms "
                  f"({n_img/med:,.0f} img/s incl. file IO)")
    finally:
        try:
            proc.stdin.write("quit\n")
            proc.stdin.close()
            proc.wait(timeout=30)
        except Exception:
            proc.kill()
    return 0


if __name__ == "__main__":
    sys.exit(main())
