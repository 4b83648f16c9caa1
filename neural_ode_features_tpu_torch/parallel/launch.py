"""Start one process per device and run a function on every rank.

JAX drives N devices from one process; PyTorch's idiom is one process per
device.  :func:`launch` is how the port gets its N devices:

* the ranks are started with the ``spawn`` method (CUDA cannot be forked)
  and rendezvous through a ``FileStore`` in a fresh temporary directory, so
  two launches at once (parallel test workers) never share a port;
* rank r binds ``devices[r]``.  Ranks on distinct cards use NCCL; ranks on
  the CPU use gloo.  ``devices`` may name one card for several ranks (the
  counterpart of JAX's virtual devices, for a machine with fewer cards than
  ranks); that is the only way two ranks share a card, and the group's
  backend is then gloo, since NCCL refuses two ranks on one device.  Every
  rank prints the backend and device it runs on; nothing switches backend
  or device behind the caller's back;
* the CUDA kernels are built once in the parent before the ranks start
  (``kernels._build.build_all``), not N times at once;
* each rank runs the parent's intra-op thread count, so that a CPU rank
  computes what the parent would, bit for bit;
* every rank is joined with a timeout, and the process group has the same
  timeout, so a rank that waits for a lost peer fails instead of hanging.

The function and its arguments are pickled (a function by its import path),
and :func:`launch` returns each rank's return value, in rank order.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["launch", "rank_devices", "backend_for"]

_COLLECTIVE_S = 1800.0  # a collective's limit when the launch has none


def rank_devices(n: int, device="cuda") -> list[str]:
    """One device per rank: ``cuda:0 .. cuda:n-1``, or ``cpu`` n times.
    Raises when ``n`` ranks need more cards than are visible, naming both
    counts."""
    kind = torch.device(device).type
    if kind == "cpu":
        return ["cpu"] * n
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > have:
        raise ValueError(f"{n} ranks need {n} CUDA devices, {have} visible "
                         "(one rank per card)")
    return [f"cuda:{i}" for i in range(n)]


def backend_for(devices: list[str]) -> str:
    """``nccl`` for ranks on distinct cards, ``gloo`` for the CPU or for
    ranks that share a card."""
    devs = [torch.device(d) for d in devices]
    if any(d.type == "cuda" for d in devs) and any(d.type != "cuda"
                                                   for d in devs):
        raise ValueError(f"mixed CPU and CUDA ranks: {devices}")
    if devs[0].type == "cpu":
        return "gloo"
    return "nccl" if len({d.index for d in devs}) == len(devs) else "gloo"


def _rank_main(rank, world, devices, backend, store, threads, timeout, fn,
               args, kwargs, results):
    try:
        dev = torch.device(devices[rank])
        torch.set_num_threads(threads)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        print(f"rank {rank}/{world}: backend {backend} on {dev}"
              + (" (a card shared by several ranks)"
                 if backend == "gloo" and dev.type == "cuda" else ""),
              flush=True)
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout),
            device_id=dev if backend == "nccl" else None)
        try:
            out = fn(*args, **kwargs)
        finally:
            dist.destroy_process_group()
        # By value: the queue's own pickler would pass tensors through
        # shared memory that dies with this process.
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn, world: int, *args, devices: list[str] | None = None,
           timeout: float | None = 600.0, **kwargs) -> list:
    """Run ``fn(*args, **kwargs)`` on ``world`` ranks and return their
    results in rank order.

    ``devices``: one device per rank (default: ``cuda:0 .. cuda:world-1``).
    ``timeout``: seconds for the whole launch and for any one collective;
    ``None`` for no limit on the launch (a training run) and 30 minutes on
    a collective.  A rank that raises, dies or overruns ends every rank,
    and the parent raises with that rank's traceback."""
    devices = list(devices) if devices is not None else rank_devices(world)
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    backend = backend_for(devices)
    if backend == "nccl" or any(d.startswith("cuda") for d in devices):
        from ..kernels import _build

        _build.build_all()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="nodef-launch-")
    procs = [ctx.Process(
        target=_rank_main,
        args=(r, world, devices, backend, os.path.join(tmp, "store"),
              torch.get_num_threads(),
              _COLLECTIVE_S if timeout is None else timeout, fn, args,
              kwargs, results),
        daemon=True) for r in range(world)]
    try:
        for p in procs:
            p.start()
        out, failure = {}, None
        deadline = time.monotonic() + (float("inf") if timeout is None
                                       else timeout)
        # Drain the queue before joining: a rank blocks on exit until what it
        # put there has been read.
        while len(out) < world and failure is None:
            left = deadline - time.monotonic()
            try:
                rank, ok, val = results.get(timeout=max(min(left, 1.0),
                                                        0.01))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in out]
                if dead:
                    # Give a dying rank's report a moment to arrive.
                    try:
                        rank, ok, val = results.get(timeout=5.0)
                    except queue.Empty:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} and no result")
                        break
                elif left <= 0:
                    failure = f"the launch overran its {timeout:.0f} s limit"
                    break
                else:
                    continue
            if ok:
                out[rank] = pickle.loads(val)
            else:
                failure = f"rank {rank} failed:\n{val}"
        if failure is None:
            for p in procs:
                p.join(timeout=min(max(deadline - time.monotonic(), 10.0),
                                   60.0))
            stuck = [r for r, p in enumerate(procs) if p.is_alive()]
            if stuck:
                failure = f"ranks {stuck} did not exit"
        if failure is not None:
            raise RuntimeError(f"launch of {world} {backend} ranks: "
                               f"{failure}")
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10.0)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
