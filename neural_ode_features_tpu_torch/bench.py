"""Headline benchmark: CIFAR-10 ODE-Net inference throughput at rtol=1e-3 on
the card (port of the JAX package's top-level ``bench.py``).

    python -m neural_ode_features_tpu_torch.bench [--batch-size 256] \\
        [--iters 32] [--repeats 6] [--tol 1e-3] [--bf16] [--run <dir>] \\
        [--pool N [--nfe-sort]] [--cpu-batches 6] [--cpu]

Prints ONE JSON line, the JAX bench's record:
    {"metric": ..., "value": N, "unit": "img/s/chip", "vs_baseline": R, ...}

``value`` is images/sec on the card (per-sample adaptive dopri5 through
``models.odenet_logits``: on the card the fused ODEfunc and dopri5-step
kernels, every attempt of a solve a replay of the graph cache), the MEDIAN
of ``--repeats`` repetitions, with ``value_best`` and ``value_band`` [min,
max]; ``mean_nfe``, ``tflops`` and ``mfu`` (useful FLOPs at the measured
mean NFE, ``utils/flops.py``, over the card's bf16 dense peak; null on the
CPU); ``vs_baseline``, the ratio against the CPU torchdiffeq-style
reference execution model measured live with the port's torch oracle
(``oracle/torch_ref.py``: host-loop dopri5, batch-global control) on the
same weights.  The other keys: ``value_best``, ``value_band``, ``repeats``,
``batch_size``, ``backend`` ("cuda" or "cpu"), ``compute_dtype``,
``pallas`` (the hand-written ODEfunc kernel ran: on the card), ``fused_rk``
(``models.fused_rk_eligible`` on the stem's output shape), ``method``,
``controller``, ``cpu_ips`` (the best oracle batch), ``cpu_ips_median``,
``cpu_ips_spread``, ``host_load_1min``, with ``--pool`` ``pool``,
``pool_ips_unsorted`` and with ``--nfe-sort`` ``pool_ips_sorted``,
``pool_ips_sorted_with_probe``, ``probe_s``, ``probe_nfe_spread``; and,
saying which card ran it, ``device_kind`` and ``power_limit_w`` (from
``nvidia-smi``; null without it), and ``value_cuda_events``, the median
img/s of the same repetitions by CUDA events around the same work (null on
the CPU), a cross-check that the host clock saw all of it.  ``mfu`` has 6
decimals, not the JAX record's 4: on the card it is below 1%.

Timing.  The host clock is taken around work that ends in
``torch.cuda.synchronize()``, minus a measured empty synchronize (the
counterpart of the JAX bench's null dispatch).  ``--iters`` solves are
chained as the JAX bench chains them: the next input is ``x +
mean(logits)·1e-6``, and NFE is summed on the device.  One untimed run of
the whole loop first holds the kernels' build (``kernels/_build.py``) and
the graph cache's first capture; every timed solve must then replay the
cache (``solver.attempt_graph.cache_info``), else the run fails.  On the
card a stderr line gives the kernels' launches over the process's solves
and the attempts those solves took, each solve's the most of any row's
accepted and rejected steps (``launches in N solves, A attempts: {...}``).

Capture hardening, as the JAX bench's:

* **Supervisor + retry.** By default ``main()`` runs the measurement in a
  child process (``BENCH_INNER=1``).  If the child stalls past its budget,
  or returns no or a partial record, it is killed and retried ONCE; if
  that fails too, the supervisor emits the best partial JSON recorded so
  far with ``"incomplete": true``.  Invalid FLAGS (``--hidden`` not a
  positive multiple of 32) exit 2 with argparse's usage message and no
  JSON, before any attempt starts.
* **Deadline.** ``BENCH_DEADLINE_S`` (default 480 s) bounds the whole run;
  the child also runs a watchdog thread that prints the partial JSON
  (``incomplete``, its ``stage``) and exits just before its own budget.
  ``BENCH_NO_SUPERVISOR=1`` runs the measurement in this process.
* **Timestamped stderr progress** at every stage.
* **Errors are not swallowed.** Without ``--cpu`` the run is on the card
  or it fails (no CPU fallback).  A failure prints a record with
  ``incomplete``, ``error`` and no ``value``, and is not retried (the same
  flags fail the same way).  Exit codes: 0 for a complete record, 1 for an
  error, 3 for a partial one (deadline), 2 for bad flags.
* **Hardened CPU denominator.**  The oracle runs before the first CUDA
  work, with torch pinned to one intra-op thread (the pin is undone before
  the card's timing, whose host loop it would slow); ``cpu_ips`` is the best
  per-batch throughput, the median, spread and 1-min load average are
  recorded, and a spread over 4× withholds ``vs_baseline`` with a
  ``baseline_note``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

import numpy as np

__all__ = ["parse_args", "main", "inner_main", "supervise", "exit_code"]

_T0 = time.monotonic()
_ROOT = Path(__file__).resolve().parent.parent


def log(msg: str) -> None:
    """Timestamped progress line on stderr (flushed immediately)."""
    print(f"[bench +{time.monotonic() - _T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--iters", type=int, default=32)
    p.add_argument("--repeats", type=int, default=6,
                   help="timing repetitions; value=median, plus "
                        "value_best / value_band over the repetitions")
    p.add_argument("--warmup", type=int, default=None,
                   help="deprecated alias for --repeats")
    p.add_argument("--tol", type=float, default=1e-3)
    p.add_argument("--method", default="dopri5",
                   help="adaptive solver (dopri5/tsit5/bosh3/adams/...)")
    p.add_argument("--run", default=None,
                   help="benchmark a trained checkpoint (run dir or .msgpack)"
                        " instead of the deterministic random init")
    p.add_argument("--hidden", type=int, default=64,
                   help="ODEfunc channel width (untrained protocol only; "
                        "the CPU oracle is built at the same width). The "
                        "reference model is 64")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 dynamics (default f32 for NFE parity): on "
                        "the card the ODEfunc kernel's bf16 build, one "
                        "launch per evaluation and no fused step")
    p.add_argument("--controller", default="i", choices=["i", "pi"],
                   help="step-size controller: 'i' (reference NFE parity, "
                        "default) or 'pi' (proportional-integral — fewer "
                        "rejections; fewer NFE on stiff dynamics)")
    p.add_argument("--pallas", action="store_true",
                   help="accepted for the JAX CLI's sake and changes "
                        "nothing: on the card the fused ODEfunc kernel "
                        "always runs, and the fused step kernel whenever "
                        "models.fused_rk_eligible says so")
    p.add_argument("--fused-rk", action="store_true",
                   help="accepted for the JAX CLI's sake and changes "
                        "nothing: on the card the fused ODEfunc kernel "
                        "always runs, and the fused step kernel whenever "
                        "models.fused_rk_eligible says so")
    p.add_argument("--pool", type=int, default=0,
                   help="stream a pool of POOL DISTINCT images through "
                        "batch-size batches (rounded up to a multiple) "
                        "instead of repeating one batch — real per-sample "
                        "NFE heterogeneity with --run (trained weights). "
                        "0 = the single-batch protocol")
    p.add_argument("--nfe-sort", action="store_true",
                   help="with --pool: NFE-bucketed batching — probe "
                        "per-sample NFE at 10x-loose tolerance, sort the "
                        "pool stably by it, stream NFE-homogeneous batches "
                        "(the per-sample solve pays each batch's max NFE; "
                        "mixed batches waste lanes). Probe cost is "
                        "included in the reported throughput")
    p.add_argument("--cpu-batches", type=int, default=6,
                   help="oracle batches for the vs_baseline denominator; "
                        "the BEST per-batch throughput is used as the "
                        "capacity estimate (median+spread also reported)")
    p.add_argument("--cpu-batch-size", type=int, default=32)
    p.add_argument("--skip-baseline", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain PyTorch path on the CPU")
    args = p.parse_args(argv)
    if args.warmup is not None:
        args.repeats = args.warmup  # alias: honor the requested count
    if args.hidden % 32 != 0 or args.hidden <= 0:
        p.error(f"--hidden {args.hidden}: must be a positive multiple of 32"
                " (GroupNorm groups=32 in the reference architecture)")
    return args


def exit_code(record: dict) -> int:
    """0 for a complete record, 1 for an error record, 3 for a partial one
    (a deadline or a stall)."""
    if not record.get("incomplete"):
        return 0
    return 1 if "error" in record else 3


# ---------------------------------------------------------------------------
# Partial-result plumbing: the inner process keeps PARTIAL up to date after
# every milestone and mirrors it to BENCH_PARTIAL_PATH so the supervisor can
# salvage a killed run.
# ---------------------------------------------------------------------------

PARTIAL: dict = {
    "metric": "images_per_sec_per_chip_cifar10_odenet_inference_rtol1e-3",
    "value": None,
    "unit": "img/s/chip",
    "vs_baseline": None,
    "incomplete": True,
    "stage": "start",
}
_PARTIAL_LOCK = threading.Lock()


def milestone(stage: str, **updates) -> None:
    with _PARTIAL_LOCK:
        PARTIAL["stage"] = stage
        PARTIAL.update(updates)
        snapshot = dict(PARTIAL)
    log(f"milestone: {stage}")
    path = os.environ.get("BENCH_PARTIAL_PATH")
    if path:
        try:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(snapshot, f)
            os.replace(tmp, path)
        except OSError as e:  # never let bookkeeping kill the bench
            log(f"partial-file write failed: {e}")


def _start_watchdog(deadline_s: float) -> None:
    """Daemon thread: if the measurement outlives its budget (a hang no
    in-process mechanism can interrupt), print the current partial JSON and
    hard-exit so *something* parseable always reaches stdout."""

    def fire():
        time.sleep(deadline_s)
        with _PARTIAL_LOCK:
            snapshot = dict(PARTIAL)
        snapshot["incomplete"] = True
        snapshot["watchdog_fired_after_s"] = round(deadline_s, 1)
        log(f"WATCHDOG: deadline {deadline_s:.0f}s hit at stage "
            f"'{snapshot.get('stage')}' — emitting partial JSON")
        print(json.dumps(snapshot), flush=True)
        os._exit(3)

    threading.Thread(target=fire, daemon=True).start()


# ---------------------------------------------------------------------------
# Supervisor: run the measurement in a child, retry once on stall, always
# print a JSON line.
# ---------------------------------------------------------------------------

_STAGE_RANK = {"start": 0, "import-torch": 1, "baseline-start": 2,
               "baseline-done": 3, "model-ready": 4, "null-dispatch": 5,
               "compiled": 6, "first-timing": 7, "timed": 8, "done": 9}


def _last_json(text: str):
    for line in reversed((text or "").splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    return None


def supervise(argv) -> dict:
    # Validate flags HERE, before spawning anything: a usage error must exit
    # loudly with argparse's message, not surface as a salvaged partial JSON
    # from a dead child.
    parse_args(argv)
    deadline = float(os.environ.get("BENCH_DEADLINE_S", "480"))
    partial_path = os.path.join(tempfile.gettempdir(),
                                f"bench_partial_{os.getpid()}.json")
    child_argv = list(argv) if argv is not None else sys.argv[1:]

    # The child runs in its own session, so an external SIGTERM/SIGINT to
    # this supervisor must not orphan it on the card.
    import signal

    live_child: list = []

    def _reap(signum, frame):
        for c in live_child:
            try:
                c.kill()
            except OSError:
                pass
        os._exit(128 + signum)

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _reap)

    def remaining():
        return deadline - (time.monotonic() - _T0)

    pythonpath = os.pathsep.join(
        p for p in (str(_ROOT), os.environ.get("PYTHONPATH")) if p)
    best_partial = None
    try:
        for attempt in (1, 2):
            budget = remaining() - 8  # leave room to salvage + print
            if budget < 12:
                log(f"attempt {attempt}: only {budget:.0f}s left — skipping")
                break
            if attempt == 1 and budget > 150:
                # Keep a real slice of the deadline for the retry.
                budget = max(budget * 0.62, budget - 170)
            env = dict(os.environ,
                       BENCH_INNER="1",
                       BENCH_PARTIAL_PATH=partial_path,
                       BENCH_CHILD_DEADLINE_S=str(max(budget - 6, 8)),
                       PYTHONPATH=pythonpath)
            log(f"attempt {attempt}: budget {budget:.0f}s "
                f"(deadline {deadline:.0f}s)")
            child = subprocess.Popen(
                [sys.executable, "-m", f"{__package__}.bench", *child_argv],
                stdout=subprocess.PIPE, stderr=sys.stderr, env=env,
                text=True, start_new_session=True,
            )
            live_child[:] = [child]
            try:
                out, _ = child.communicate(timeout=budget)
            except subprocess.TimeoutExpired:
                child.kill()
                child.communicate()
                log(f"attempt {attempt}: child stalled past {budget:.0f}s "
                    "budget — killed; "
                    + ("retrying once" if attempt == 1 else "giving up"))
                continue
            except BaseException:
                child.kill()  # never leave a detached child holding the card
                child.communicate()
                raise
            parsed = _last_json(out)
            if parsed is not None and (not parsed.get("incomplete")
                                       or "error" in parsed):
                # A complete record, or an error: the same flags would fail
                # the same way, so it is not retried.
                print(json.dumps(parsed), flush=True)
                return parsed
            if parsed is not None:
                # The child's own watchdog fired: keep the partial as a
                # fallback but retry for a complete result.
                best_partial = parsed
                log(f"attempt {attempt}: child returned INCOMPLETE JSON at "
                    f"stage '{parsed.get('stage')}'"
                    + (" — retrying once" if attempt == 1 else ""))
            else:
                log(f"attempt {attempt}: child exited rc={child.returncode} "
                    "with no JSON line"
                    + (" — retrying once" if attempt == 1 else ""))

        # Salvage: the FURTHEST-stage partial any attempt recorded (stdout
        # partial from attempt 1 vs the mirrored partial file, which the
        # later attempt overwrites), else the skeleton.  A measured value
        # always beats a value-less record; between two measured records
        # the later milestone wins.
        def _score(rec):
            if rec is None:
                return (-1, -1)
            return (1 if rec.get("value") is not None else 0,
                    _STAGE_RANK.get(rec.get("stage"), 0))

        file_partial = None
        try:
            with open(partial_path) as f:
                file_partial = json.load(f)
        except (OSError, json.JSONDecodeError):
            pass
        result = max((dict(PARTIAL), file_partial, best_partial), key=_score)
        result["incomplete"] = True
        result.setdefault("stage", "no-attempt")
        log(f"emitting salvaged partial JSON (stage={result.get('stage')})")
        print(json.dumps(result), flush=True)
        return result
    finally:
        for path in (partial_path, partial_path + ".tmp"):
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass


# ---------------------------------------------------------------------------
# The measurement itself (runs in the child / BENCH_INNER process).
# ---------------------------------------------------------------------------

def _power_limit_w(device_kind: str):
    """The card's power limit in watts from ``nvidia-smi`` (the line whose
    name is ``device_kind``), or None where ``nvidia-smi`` is missing or
    names no such card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    for line in out.splitlines():
        name, _, limit = line.rpartition(",")
        if name.strip() == device_kind:
            try:
                return float(limit.strip().split()[0])
            except (ValueError, IndexError):
                return None
    return None


def _cpu_baseline(args, cfg, params, x_np):
    """The oracle's throughput on the CPU: ``(cpu_ips, median, [min, max],
    note)``, torch pinned to one intra-op thread for the measurement only
    (the host-loop oracle runs no inter-op work)."""
    import torch

    from .oracle.torch_ref import build_torch_odenet, load_params_into_torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tm = build_torch_odenet(in_channels=cfg.in_channels,
                                hidden=cfg.hidden, groups=cfg.groups,
                                num_classes=cfg.num_classes)
        load_params_into_torch(tm, params)
        tm.eval()
        xc = torch.from_numpy(
            x_np[: args.cpu_batch_size].transpose(0, 3, 1, 2))
        # BEST per-batch throughput = capacity estimate: the fastest batch
        # is the least contaminated by host load, and the largest
        # denominator is the conservative choice for vs_baseline.
        batch_dts = []
        with torch.no_grad():
            tm(xc, rtol=args.tol, atol=args.tol)  # warmup
            for _ in range(args.cpu_batches):
                t0 = time.perf_counter()
                tm(xc, rtol=args.tol, atol=args.tol)
                batch_dts.append(time.perf_counter() - t0)
    finally:
        torch.set_num_threads(threads)
    per_batch = xc.shape[0] / np.asarray(batch_dts)
    spread = [float(per_batch.min()), float(per_batch.max())]
    note = None
    if spread[1] / max(spread[0], 1e-9) > 4.0:
        note = ("degenerate spread "
                f"{[round(v, 1) for v in spread]} img/s "
                "(host under load) — vs_baseline withheld")
        log(f"baseline: {note}")
    return float(per_batch.max()), float(np.median(per_batch)), spread, note


def _measure(args, load1) -> dict:
    import dataclasses

    import torch

    from ._device import strict_f32, tree_to
    from .models import (
        ModelConfig,
        fused_rk_eligible,
        init_odenet,
        odenet_logits,
        stem_apply,
    )
    from .solver import ADAPTIVE_TABLEAUS
    from .utils import (
        load_checkpoint,
        odenet_flops_per_image,
        peak_flops_per_chip,
        resolve_checkpoint,
    )

    # No card and no --cpu raises here, before anything is measured.
    dev = strict_f32("cpu" if args.cpu else "cuda")
    cuda = dev.type == "cuda"

    # Parameters are built on the CPU, so that the oracle's baseline below
    # runs before the first CUDA work.
    if args.run:
        params, cfg0, _ = load_checkpoint(resolve_checkpoint(args.run),
                                          device="cpu")
        cfg = dataclasses.replace(
            cfg0,
            tol=args.tol,
            method=args.method,
            controller=args.controller,
            error_control="per_sample",
            adjoint=False,
            compute_dtype="bfloat16" if args.bf16 else cfg0.compute_dtype,
            use_pallas=args.pallas,
            use_fused_rk=args.fused_rk,
        )
    else:
        cfg = ModelConfig(
            in_channels=3,
            hidden=args.hidden,
            tol=args.tol,
            method=args.method,
            controller=args.controller,
            error_control="per_sample",
            compute_dtype="bfloat16" if args.bf16 else "float32",
            use_pallas=args.pallas,
            use_fused_rk=args.fused_rk,
        )
        params = init_odenet(7, cfg, device="cpu")

    rng = np.random.default_rng(0)
    side = 28 if cfg.in_channels == 1 else 32
    x_np = rng.normal(
        size=(args.batch_size, side, side, cfg.in_channels)
    ).astype(np.float32)

    # What runs, not what the flags asked for: the ODE state's shape comes
    # from the real stem (a 'res' stem gives other maps than a 'conv' one).
    with torch.no_grad():
        h1 = stem_apply(params["stem"], torch.from_numpy(x_np[:1]), cfg)
    hidden_shape = (args.batch_size, *h1.shape[1:])
    fused_rk_active = fused_rk_eligible(cfg, hidden_shape, torch.float32)
    if args.fused_rk and not fused_rk_active:
        log("NOTE: --fused-rk requested but the fused step does not run "
            "for this config (method/dtype/shape: models.fused_rk_eligible)")
    # On the card every evaluation is the hand-written ODEfunc kernel (its
    # bf16 build for --bf16); a shape outside its gate raises.
    pallas_active = cuda
    if args.pallas and not pallas_active:
        log("NOTE: --pallas requested but the CPU runs the plain PyTorch "
            "version of the ODEfunc kernel")

    # --- CPU-oracle denominator FIRST (before the first CUDA work) --------
    vs_baseline = None
    baseline_note = None
    cpu_ips = cpu_ips_median = cpu_ips_spread = None
    if not args.skip_baseline:
        # Stage marker BEFORE the host-loop oracle: a watchdog JSON stuck
        # at 'baseline-start' means a starved host, not a hung card.
        milestone("baseline-start")
        try:
            cpu_ips, cpu_ips_median, cpu_ips_spread, baseline_note = (
                _cpu_baseline(args, cfg, params, x_np))
            milestone("baseline-done",
                      cpu_ips=round(cpu_ips, 2),
                      cpu_ips_median=round(cpu_ips_median, 2),
                      cpu_ips_spread=[round(v, 2) for v in cpu_ips_spread])
        except (RuntimeError, ValueError) as e:  # an oracle failure
            baseline_note = f"baseline measurement failed: {e}"
            log(baseline_note)

    params = tree_to(params, dev)  # first CUDA work; once, not per rep
    x = torch.from_numpy(x_np).to(dev)
    device_kind = torch.cuda.get_device_name(dev) if cuda else "cpu"

    shape_name = "mnist" if cfg.in_channels == 1 else "cifar10"
    suffix = "" if cfg.hidden == 64 else f"_hidden{cfg.hidden}"
    if args.pool:
        n_batches = -(-args.pool // args.batch_size)
        suffix += f"_pool{n_batches * args.batch_size}" + (
            "_nfesort" if args.nfe_sort else ""
        )
    metric = (f"images_per_sec_per_chip_{shape_name}"
              f"_odenet_inference_rtol1e-3{suffix}")
    milestone(
        "model-ready",
        metric=metric,
        batch_size=args.batch_size,
        backend=dev.type,
        compute_dtype=cfg.compute_dtype,
        pallas=pallas_active,
        fused_rk=fused_rk_active,
        method=args.method,
        device_kind=device_kind,
    )

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    # The counterpart of the JAX bench's null dispatch: an empty
    # synchronize, taken off every timed region.
    sync()
    empties = []
    for _ in range(5):
        t0 = time.perf_counter()
        sync()
        empties.append(time.perf_counter() - t0)
    overhead = float(np.median(empties))
    milestone("null-dispatch", dispatch_overhead_s=overhead)

    def timed(fn):
        """``(fn(), host s, CUDA-event s or None)``: the host clock around
        ``fn`` and a synchronize, minus the empty synchronize; the events
        around the same work on the card's stream."""
        ev = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
              if cuda else None)
        t0 = time.perf_counter()
        if ev:
            ev[0].record()
        out = fn()
        if ev:
            ev[1].record()
        sync()
        dt = max(time.perf_counter() - t0 - overhead, 1e-9)
        return out, dt, (ev[0].elapsed_time(ev[1]) / 1e3 if ev else None)

    # Every timed solve must replay the graph cache (an RK solve on the
    # card); the warm-up took its captures.
    cached_route = cuda and cfg.method in ADAPTIVE_TABLEAUS

    def cache_state():
        """``(entries, solves replayed)`` of this thread's graph cache on
        the card; None off the cached route."""
        if not cached_route:
            return None
        from .solver import attempt_graph

        info = attempt_graph.cache_info(dev)
        return len(info), sum(e["replayed_solves"] for e in info)

    def check_cache(before, solves, what):
        if before is None:
            return
        entries, replays = cache_state()
        if entries != before[0] or replays - before[1] != solves:
            raise RuntimeError(
                f"{what}: {replays - before[1]} of {solves} solves replayed "
                f"the graph cache, entries {before[0]} -> {entries}: the "
                "timed solves must not capture")

    n_solves = 0
    solve_stats = []  # each solve's stats (the graph cache hands out clones)

    def solve(xb, c=cfg):
        nonlocal n_solves
        n_solves += 1
        logits, stats = odenet_logits(params, xb, c)
        if cuda:
            solve_stats.append(stats)
        return logits, stats

    reps = max(args.repeats, 2)
    pool_extra = {}
    rep_dts: list[float] = []
    rep_ev: list = []
    n_images = args.batch_size * args.iters
    with torch.no_grad():
        if args.pool:
            # Stream DISTINCT images so per-sample NFE varies: each batch
            # gathered on the card from the pool by a row of an index
            # matrix; --nfe-sort reorders that matrix by a loose-tolerance
            # NFE probe so every batch is NFE-homogeneous.
            n_batches = -(-args.pool // args.batch_size)
            pool_n = n_images = n_batches * args.batch_size
            x_pool = torch.from_numpy(
                rng.normal(size=(pool_n, side, side, cfg.in_channels))
                .astype(np.float32)).to(dev)

            def pool_loop(idx):
                # The NFE sum and the liveness term are separate sums, so
                # the liveness term cannot skew the reported mean NFE.
                nfe_acc = torch.zeros((), device=dev)
                live_acc = torch.zeros((), device=dev)
                for sel in idx:
                    logits, stats = solve(x_pool[sel])
                    nfe_acc += stats.nfe.float().mean()
                    live_acc += logits.mean()
                return float(nfe_acc / idx.shape[0] + live_acc * 1e-20)

            idx0 = torch.arange(pool_n, device=dev).reshape(
                n_batches, args.batch_size)

            def time_pass(idx, extra=(0.0, 0.0)):
                # extra: the probe's (host, event) time, paid before a
                # sorted pass: the value-bearing milestone includes it.
                dts, evs, nfe = [], [], 0.0
                before = cache_state()
                for i in range(reps):
                    nfe, dt, ev = timed(lambda: pool_loop(idx))
                    dts.append(dt)
                    evs.append(ev)
                    if i == 0:
                        milestone("first-timing",
                                  value=round(pool_n / (dt + extra[0]), 2),
                                  mean_nfe=round(nfe, 1))
                check_cache(before, reps * n_batches, "pool pass")
                return dts, evs, nfe

            pool_loop(idx0)  # build + capture
            milestone("compiled")
            dts_unsorted, evs, mean_nfe = time_pass(idx0)
            pool_extra = {
                "pool": pool_n,
                "pool_ips_unsorted": round(pool_n / min(dts_unsorted), 2),
            }
            rep_dts, rep_ev = dts_unsorted, evs

            if args.nfe_sort:
                cfg_loose = dataclasses.replace(
                    cfg, tol=min(args.tol * 10, 1e-1))

                def probe_loop():
                    return torch.cat([
                        solve(x_pool[sel], cfg_loose)[1].nfe
                        for sel in idx0]).cpu().numpy()

                probe_loop()  # capture at the loose tolerance
                before = cache_state()
                # best-of-2: match the solve passes' protocol
                probes = [timed(probe_loop) for _ in range(2)]
                check_cache(before, 2 * n_batches, "NFE probe")
                nfe_probe, probe_dt, probe_ev = min(probes,
                                                    key=lambda r: r[1])
                order = np.argsort(nfe_probe, kind="stable")
                idx_sorted = torch.from_numpy(order).to(dev).reshape(
                    n_batches, args.batch_size)
                dts_sorted, evs, mean_nfe = time_pass(
                    idx_sorted, (probe_dt, probe_ev))
                dt_sorted = min(dts_sorted)
                # The probe is real work: the headline sorted throughput
                # includes it, amortised over one pool pass.
                rep_dts = [d + probe_dt for d in dts_sorted]
                rep_ev = [e + probe_ev if cuda else None for e in evs]
                pool_extra.update(
                    pool_ips_sorted=round(pool_n / dt_sorted, 2),
                    pool_ips_sorted_with_probe=round(
                        pool_n / (dt_sorted + probe_dt), 2),
                    probe_s=round(probe_dt, 3),
                    probe_nfe_spread=[int(nfe_probe.min()),
                                      int(nfe_probe.max())],
                )
        else:
            def bench_loop():
                x_i, nfe_acc = x, torch.zeros((), device=dev)
                for _ in range(args.iters):
                    logits, stats = solve(x_i)
                    x_i = x + logits.mean() * 1e-6
                    nfe_acc = nfe_acc + stats.nfe.float().mean()
                float(x_i.mean())
                return float(nfe_acc) / args.iters

            bench_loop()  # build + capture
            milestone("compiled")
            before = cache_state()
            for i in range(reps):
                mean_nfe, dt, ev = timed(bench_loop)
                rep_dts.append(dt)
                rep_ev.append(ev)
                if i == 0:  # a usable value exists from here on
                    milestone("first-timing",
                              value=round(n_images / dt, 2),
                              mean_nfe=round(mean_nfe, 1))
            check_cache(before, reps * args.iters, "timed solves")

    if cuda:
        # What the solves launched (this process's counters, from 0): a
        # reader can hold them to the launch rules of PERF.md §2.
        from .kernels.odefunc import odefunc
        from .kernels.odefunc_bwd import odefunc_bwd
        from .kernels.rk_step import dopri5_step

        counts = {"odefunc": odefunc.launches,
                  "odefunc_bf16": odefunc.launches_bf16,
                  "rk_step": dopri5_step.launches,
                  "rk_step_bf16": dopri5_step.launches_bf16,
                  "odefunc_bwd": odefunc_bwd.launches,
                  "odefunc_bwd_bf16": odefunc_bwd.launches_bf16}
        attempts = sum(int((st.naccept + st.nreject).max())
                       for st in solve_stats)
        log(f"launches in {n_solves} solves, {attempts} attempts: "
            f"{json.dumps(counts)}")

    rep_arr = n_images / np.asarray(rep_dts)
    # Headline = MEDIAN of repeats; best-of in value_best/value_band.
    ips = float(np.median(rep_arr))
    ips_best = float(rep_arr.max())
    ips_events = (float(np.median(n_images / np.asarray(rep_ev)))
                  if cuda else None)
    milestone("timed",
              value=round(ips, 2),
              value_best=round(ips_best, 2),
              value_band=[round(float(rep_arr.min()), 2),
                          round(float(rep_arr.max()), 2)],
              repeats=len(rep_dts),
              mean_nfe=round(mean_nfe, 1))

    if cpu_ips and baseline_note is None:
        vs_baseline = ips / cpu_ips

    # Model-FLOPs utilisation: useful FLOPs at the measured mean NFE over
    # the card's bf16 dense peak (utils/flops.py says why bf16's).
    flops = odenet_flops_per_image(cfg, side, mean_nfe)
    achieved = flops["total"] * ips  # FLOP/s (one card)
    peak = peak_flops_per_chip(device_kind)
    mfu = (achieved / peak) if peak else None

    try:
        load1_end = round(os.getloadavg()[0], 2)
    except OSError:
        load1_end = None

    result = {
        "metric": metric,
        "value": round(ips, 2),
        "unit": "img/s/chip",
        "vs_baseline": round(vs_baseline, 2) if vs_baseline else None,
        "value_best": round(ips_best, 2),
        "value_band": [round(float(rep_arr.min()), 2),
                       round(float(rep_arr.max()), 2)],
        "repeats": len(rep_dts),
        "mean_nfe": round(mean_nfe, 1),
        "batch_size": args.batch_size,
        "backend": dev.type,
        "compute_dtype": cfg.compute_dtype,
        "pallas": pallas_active,
        "fused_rk": fused_rk_active,
        "method": args.method,
        "controller": args.controller,
        "tflops": round(achieved / 1e12, 3),
        "mfu": round(mfu, 6) if mfu is not None else None,
        "cpu_ips": round(cpu_ips, 2) if cpu_ips else None,
        "cpu_ips_median": (round(cpu_ips_median, 2)
                           if cpu_ips_median else None),
        "cpu_ips_spread": (
            [round(v, 2) for v in cpu_ips_spread] if cpu_ips_spread else None
        ),
        "host_load_1min": [load1, load1_end],
        "device_kind": device_kind,
        "power_limit_w": _power_limit_w(device_kind) if cuda else None,
        "value_cuda_events": (round(ips_events, 2) if ips_events is not None
                              else None),
        **pool_extra,
    }
    if baseline_note:
        result["baseline_note"] = baseline_note
    return result


def inner_main(argv=None) -> dict:
    args = parse_args(argv)
    child_deadline = os.environ.get("BENCH_CHILD_DEADLINE_S")
    if child_deadline:
        _start_watchdog(float(child_deadline))

    try:
        load1 = round(os.getloadavg()[0], 2)
    except OSError:
        load1 = None
    milestone("import-torch", host_load_1min=load1)
    try:
        result = _measure(args, load1)
    except Exception as e:  # the run's boundary: report, never swallow
        traceback.print_exc(file=sys.stderr)
        with _PARTIAL_LOCK:
            record = dict(PARTIAL, incomplete=True, value=None,
                          error=f"{type(e).__name__}: {e}")
        log(f"FAILED at stage '{record.get('stage')}': {record['error']}")
        print(json.dumps(record), flush=True)
        return record
    milestone("done", **result)
    with _PARTIAL_LOCK:
        PARTIAL.pop("incomplete", None)
        PARTIAL.pop("stage", None)
    print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> dict:
    if (os.environ.get("BENCH_INNER") == "1"
            or os.environ.get("BENCH_NO_SUPERVISOR") == "1"):
        return inner_main(argv)
    return supervise(argv)


if __name__ == "__main__":
    sys.exit(exit_code(main()))
