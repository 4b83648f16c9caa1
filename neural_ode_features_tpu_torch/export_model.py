"""Export a trained run for deployment (the port's counterpart of the JAX
tool ``tools/export_model.py``, with its modes, flags and defaults).

    python -m neural_ode_features_tpu_torch.export_model export \\
        --run <run dir> [--ckpt F] [--batch 256] [--out F] [--cpu]
    python -m neural_ode_features_tpu_torch.export_model run \\
        --artifact <F.nodeexport> [--run <run dir> [--ckpt F]] [--reps 3]
        [--cpu]
    python -m neural_ode_features_tpu_torch.export_model export-mock \\
        --out DIR [--in-shape 4,3,5] [--out-shape 4,10] [--scale 2]
        [--shift 1] [--layout reversed|rowmajor]
    python -m neural_ode_features_tpu_torch.export_model export-compiled \\
        --run <run dir> --batch 256 [--chain K] [--out DIR] [--cpu]

``export`` writes ``logits(x)`` at a fixed batch shape as a program that
runs with no model code: ``torch.export`` of the model (its weights are the
program's buffers), saved with ``torch.export.save`` to
``<run>/model_b{B}.nodeexport``, with the JAX tool's sidecar
``<artifact>.json`` (``input_shape``, ``input_dtype``, ``model``,
``platforms``, ``sha256``, ``bytes``, ``config``).  The program is traced
on the device it is exported on: on the card it calls the kernels as the
operators of ``kernels/ops.py`` (``nodef::odefunc``, ``nodef::dopri5_step``)
and the adaptive solve's attempt loop is PyTorch's ``while_loop``
(``solver.runge_kutta``), so ``platforms`` is ``["cuda"]``; with ``--cpu``
it is ``["cpu"]`` and the operators run their plain versions.

``run`` loads an artifact with ``torch.export.load`` and only
``kernels/ops.py`` imported (no model, solver or training module), runs it
on the JAX tool's input (numpy seed 0) and prints its throughput; with
``--run`` it also loads the live model and prints the parity line, failing
unless the argmax agreement is 1.0.  An artifact made for another device
than the current one raises, naming both.

``export-mock`` fabricates the JAX tool's ``.npexec`` for the native host's
mock plugin (``format: mock-pjrt-descriptor``), byte for byte; the port's
host (``serve.py``) serves it too.

``export-compiled`` writes the JAX tool's ``.npexec`` directory layout,
which ``python -m neural_ode_features_tpu_torch.serve <dir>`` serves:

  weights.pt            the model's weights, the port's state dict (in place
                        of the JAX tool's ``executable.bin``: the port's
                        host runs the model code, see ``serve.py``)
  sample_input.npy      a deterministic input, numpy seed 0 (f32, C order)
  expected_logits.npy   the live model's logits on it, computed where the
                        export ran (on the card: through the kernels)
  meta.json             the JAX tool's keys (``inputs``, ``outputs``,
                        ``chain``, ``model``, ``rowwise``, ``sha256`` and
                        ``bytes`` of ``weights.pt``, ``config``) with
                        ``format``, ``platform`` and versions

``rowwise`` is the JAX tool's row-independence probe: the model is run
again with the other rows replaced by noise (seeds 1 and 2), and the kept
rows' logits must come out bit-identical.  Only then does the host take
ragged requests and coalesce them.  Per-sample error control passes it (on
the card each sample is one CTA of every kernel); ``error_control='global'``
does not (the step sequence is a reduction over the batch).

Every mode but ``export-mock`` runs on the card and raises without one;
``--cpu`` runs on the CPU.  A bf16 run (``compute_dtype='bfloat16'``)
exports and serves as an f32 one does: its program holds
``nodef::odefunc_bf16`` inside the attempt loop and no fused step, and on
the card a call launches the ODEfunc kernel's bf16 build 2 + 6·attempts
times.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import io
import json
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from ._device import strict_f32

__all__ = ["FORMAT", "WEIGHTS", "PROGRAM_SUFFIX", "input_shape", "logits_fn",
           "LogitsProgram", "load_artifact", "load_program", "mock_expected",
           "write_mock_artifact", "do_export", "do_run", "do_export_mock",
           "do_export_compiled", "main"]

FORMAT = "torch-state-dict"
WEIGHTS = "weights.pt"
PROGRAM_SUFFIX = ".nodeexport"


def input_shape(cfg, batch: int, chain: int = 1) -> tuple:
    """The artifact's input: (B, 28|32, 28|32, C_in), NHWC f32, with a
    leading chain axis K when ``chain > 1``."""
    side = 32 if cfg.in_channels == 3 else 28
    shape = (batch, side, side, cfg.in_channels)
    return (chain,) + shape if chain > 1 else shape


def _model_logits(params, cfg, model: str):
    """``fn(x) -> logits``, the JAX tool's ``_logits_fn``: the ODE-Net's
    inference path (``adjoint=False``) or the ResNet."""
    from .models import odenet_logits, resnet_logits

    if model == "resnet":
        def inner(x):
            return resnet_logits(params, x, cfg)
    else:
        def inner(x):
            return odenet_logits(params, x, cfg, adjoint=False)[0]
    return inner


def logits_fn(params, cfg, model: str, chain: int = 1):
    """``fn(x) -> logits`` on tensors (:func:`_model_logits`) without
    autograd; with ``chain > 1`` one call solves the K batches of a
    (K, B, ...) input in turn."""
    inner = _model_logits(params, cfg, model)

    @torch.no_grad()
    def fn(x):
        if chain > 1:
            return torch.stack([inner(xi) for xi in x])
        return inner(x)
    return fn


def _run(fn, x: np.ndarray, dev: torch.device) -> np.ndarray:
    return np.ascontiguousarray(
        fn(torch.from_numpy(x).to(dev)).cpu().numpy())


def rowwise_probe(fn, x: np.ndarray, logits: np.ndarray,
                  dev: torch.device) -> bool:
    """The JAX tool's probe: rerun with the OTHER rows replaced by noise and
    require the kept rows' outputs bit-identical (seeds 1 and 2)."""
    if not (x.ndim >= 1 and logits.ndim >= 1 and x.shape[0] == logits.shape[0]
            and x.shape[0] >= 2):
        return False
    for probe_seed in (1, 2):
        prng = np.random.default_rng(probe_seed)
        keep = prng.random(x.shape[0]) < 0.5
        if not keep.any() or keep.all():
            keep[0] = True
            keep[-1] = False
        x2 = prng.normal(size=x.shape).astype(np.float32)
        x2[keep] = x[keep]
        if not np.array_equal(_run(fn, x2, dev)[keep], logits[keep]):
            return False
    return True


def do_export_compiled(args) -> Path:
    from .utils.checkpoint import (
        load_checkpoint,
        resolve_checkpoint,
        to_torch_state_dict,
    )

    dev = strict_f32("cpu" if args.cpu else "cuda")
    run = Path(args.run)
    params, cfg, extra = load_checkpoint(resolve_checkpoint(run, args.ckpt),
                                         device=dev)
    model = extra.get("model", "odenet")
    shape = input_shape(cfg, args.batch, args.chain)
    fn = logits_fn(params, cfg, model, args.chain)

    t0 = time.perf_counter()
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    logits = _run(fn, x, dev)
    rowwise = rowwise_probe(fn, x, logits, dev)
    print(f"rowwise probe: {'independent' if rowwise else 'COUPLED'} "
          f"(continuous batching {'enabled' if rowwise else 'disabled'}); "
          f"{time.perf_counter() - t0:.1f} s on {dev.type}",
          file=sys.stderr, flush=True)

    suffix = f"_c{args.chain}" if args.chain > 1 else ""
    base = run if run.is_dir() else run.parent
    out = Path(args.out or (base / f"serve_b{args.batch}{suffix}.npexec"))
    out.mkdir(parents=True, exist_ok=True)
    torch.save(to_torch_state_dict(params), out / WEIGHTS)
    blob = (out / WEIGHTS).read_bytes()
    np.save(out / "sample_input.npy", x)
    np.save(out / "expected_logits.npy", logits)
    meta = {
        "format": FORMAT,
        "platform": dev.type,
        "device_name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu"),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "weights": WEIGHTS,
        "inputs": [{"shape": list(shape), "dtype": "float32"}],
        "chain": args.chain,
        "outputs": [{"shape": list(logits.shape), "dtype": "float32"}],
        "model": model,
        "rowwise": rowwise,
        "sha256": hashlib.sha256(blob).hexdigest(),
        "bytes": len(blob),
        "config": dataclasses.asdict(cfg),
    }
    (out / "meta.json").write_text(json.dumps(meta, indent=2))
    print(f"serving artifact: {out}")
    print(json.dumps({"artifact": str(out), "bytes": len(blob),
                      "sha256": meta["sha256"], "rowwise": rowwise}))
    return out


def load_artifact(art: Path, meta: dict, device: torch.device):
    """``(params, cfg, model)`` from an ``export-compiled`` directory whose
    ``meta.json`` is ``meta``; the weights' sha256 must match it."""
    from .models import ModelConfig, init_odenet, init_resnet
    from .utils.checkpoint import from_torch_state_dict

    blob = (art / meta.get("weights", WEIGHTS)).read_bytes()
    if hashlib.sha256(blob).hexdigest() != meta["sha256"]:
        raise ValueError(f"{art}: {WEIGHTS} does not match meta.json sha256")
    cfg = ModelConfig(**meta["config"])
    model = meta.get("model", "odenet")
    init = init_resnet if model == "resnet" else init_odenet
    state = torch.load(io.BytesIO(blob), map_location="cpu", weights_only=True)
    params = from_torch_state_dict(init(0, cfg, device=device), state)
    return params, cfg, model


# -- export / run: the code-free program --------------------------------

def _buffer_name(path) -> str:
    """A weight's name as a buffer: its tree path, ``odefunc.conv1.kernel``
    as ``odefunc__conv1__kernel``."""
    return "__".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)


class LogitsProgram(torch.nn.Module):
    """``logits(x)`` of a model as a module whose buffers are its weights:
    what ``torch.export`` traces and saves (the weights travel inside the
    artifact)."""

    def __init__(self, params, cfg, model: str):
        super().__init__()
        from torch.utils._pytree import tree_flatten_with_path

        leaves, self._spec = tree_flatten_with_path(params)
        self._names = [_buffer_name(path) for path, _ in leaves]
        for name, (_, leaf) in zip(self._names, leaves):
            self.register_buffer(name, leaf)
        self._cfg, self._model = cfg, model

    def forward(self, x):
        from torch.utils._pytree import tree_unflatten

        params = tree_unflatten([getattr(self, n) for n in self._names],
                                self._spec)
        return _model_logits(params, self._cfg, self._model)(x)


def do_export(args) -> Path:
    from .utils.checkpoint import load_checkpoint, resolve_checkpoint

    dev = strict_f32("cpu" if args.cpu else "cuda")
    run = Path(args.run)
    params, cfg, extra = load_checkpoint(resolve_checkpoint(run, args.ckpt),
                                         device=dev)
    model = extra.get("model", "odenet")
    shape = input_shape(cfg, args.batch)
    t0 = time.perf_counter()
    with torch.no_grad():
        program = torch.export.export(
            LogitsProgram(params, cfg, model),
            (torch.zeros(shape, dtype=torch.float32, device=dev),),
            strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    base = run if run.is_dir() else run.parent
    out = Path(args.out or (base / f"model_b{args.batch}{PROGRAM_SUFFIX}"))
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_bytes(blob)
    meta = {
        "input_shape": list(shape),
        "input_dtype": "float32",
        "model": model,
        "platforms": [dev.type],
        "sha256": hashlib.sha256(blob).hexdigest(),
        "bytes": len(blob),
        "config": dataclasses.asdict(cfg),
        "format": "torch-export",
        "torch_version": torch.__version__,
    }
    out.with_suffix(out.suffix + ".json").write_text(json.dumps(meta, indent=2))
    print(f"exported {out} ({len(blob) / 1e6:.2f} MB, "
          f"platforms={meta['platforms']}; traced in "
          f"{time.perf_counter() - t0:.1f} s)")
    print(json.dumps({"artifact": str(out),
                      **{k: meta[k] for k in ("bytes", "sha256")}}))
    return out


def load_program(artifact, dev: torch.device):
    """``(module, meta)``: a ``.nodeexport`` loaded with the kernels'
    operators alone (``kernels/ops.py``), checked against its sidecar
    (sha256) and against ``dev`` (its ``platforms``)."""
    from .kernels import ops  # noqa: F401  (registers torch.ops.nodef)

    artifact = Path(artifact)
    blob = artifact.read_bytes()
    meta = json.loads(Path(str(artifact) + ".json").read_text())
    if hashlib.sha256(blob).hexdigest() != meta["sha256"]:
        raise ValueError(f"{artifact} does not match its sidecar's sha256")
    if dev.type not in meta["platforms"]:
        raise RuntimeError(
            f"{artifact} was exported for {meta['platforms']}, and this run "
            f"is on {dev.type} (export it there, or pass --cpu for a CPU "
            "artifact)")
    with warnings.catch_warnings():  # the loader views the bytes read
        warnings.filterwarnings("ignore", message="The given buffer is not "
                                "writable")
        program = torch.export.load(io.BytesIO(blob))
    return program.module(), meta


def do_run(args) -> dict:
    dev = strict_f32("cpu" if args.cpu else "cuda")
    module, meta = load_program(args.artifact, dev)
    shape = tuple(meta["input_shape"])
    x = torch.from_numpy(np.random.default_rng(0).normal(size=shape)
                         .astype(np.float32)).to(dev)

    def call():
        with torch.no_grad():
            out = module(x)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    logits = call()  # the first call: the kernels' build and warm-up
    t0 = time.perf_counter()
    for _ in range(args.reps):
        logits = call()
    dt = (time.perf_counter() - t0) / max(args.reps, 1)
    print(f"artifact runs: out shape {tuple(logits.shape)}, "
          f"{shape[0] / dt:,.0f} img/s ({dt * 1e3:.1f} ms/batch, "
          f"backend={dev.type})")
    res = {"out_shape": tuple(logits.shape), "ms": dt * 1e3,
           "logits": logits.cpu().numpy()}
    if args.run:  # parity against the live model
        from .utils.checkpoint import load_checkpoint, resolve_checkpoint

        params, cfg, extra = load_checkpoint(
            resolve_checkpoint(Path(args.run), args.ckpt), device=dev)
        ref = logits_fn(params, cfg, extra.get("model", "odenet"))(x)
        diff = float((ref - logits).abs().max())
        agree = float((ref.argmax(-1) == logits.argmax(-1)).float().mean())
        print(f"parity vs live model: max|diff|={diff:.2e}, "
              f"argmax agreement={agree:.4f}")
        res.update(max_diff=diff, agreement=agree)
        if agree != 1.0:
            raise SystemExit("exported artifact diverges from the live model")
    return res


# -- export-mock: the native host's mock plugin ---------------------------

def mock_expected(x, out_shape, scale, shift, mode="flat") -> torch.Tensor:
    """The mock plugin's compute (``native/mock_pjrt_plugin.cc``), as the
    JAX tool's ``mock_expected``, in float32 on ``x``'s device (an array or
    a tensor): what ``serve`` answers a mock artifact with, and the
    ``expected_logits.npy`` of :func:`write_mock_artifact`.

    ``mode="flat"``: ``out[j] = scale * in.ravel()[j % in.size] + shift``.
    ``mode="rowwise"``: ``out[r, c] = scale * in[r % R, c % irow] + shift``
    (output row r reads only input row r)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    n_out = int(np.prod(out_shape))
    if mode == "rowwise":
        rows = x.reshape(x.shape[0], -1)
        r = torch.arange(out_shape[0], device=x.device) % rows.shape[0]
        c = (torch.arange(n_out // out_shape[0], device=x.device)
             % rows.shape[1])
        picked = rows[r[:, None], c[None, :]]
    else:
        flat = x.reshape(-1)
        picked = flat[torch.arange(n_out, device=x.device) % flat.numel()]
    return (scale * picked + shift).reshape(tuple(out_shape))


def write_mock_artifact(out_dir, in_shape=(4, 3, 5), out_shape=(4, 10),
                        scale=2.0, shift=1.0, layout="reversed", seed=0,
                        mode="flat"):
    """Fabricate the JAX tool's ``.npexec`` for the mock plugin, byte for
    byte: a ``MOCKEXEC1`` descriptor as ``executable.bin``, a sample input
    (numpy ``seed``), its :func:`mock_expected` logits and ``meta.json``
    (``rowwise`` only for the rowwise compute with aligned leading dims)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    desc = (
        "MOCKEXEC1\n"
        f"out_shape={','.join(str(d) for d in out_shape)}\n"
        f"scale={scale}\n"
        f"shift={shift}\n"
        f"layout={layout}\n"
    )
    if mode != "flat":
        desc += f"mode={mode}\n"
    (out / "executable.bin").write_text(desc)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=in_shape).astype(np.float32)
    y = mock_expected(torch.from_numpy(x), out_shape, scale, shift,
                      mode).numpy()
    np.save(out / "sample_input.npy", np.ascontiguousarray(x))
    np.save(out / "expected_logits.npy", y)
    meta = {
        "format": "mock-pjrt-descriptor",
        "platform": "mock",
        "inputs": [{"shape": list(in_shape), "dtype": "float32"}],
        "outputs": [{"shape": list(out_shape), "dtype": "float32"}],
        "chain": 1,
        "scale": scale,
        "shift": shift,
        "layout": layout,
        "mode": mode,
        "rowwise": bool(mode == "rowwise" and len(in_shape) >= 1
                        and len(out_shape) >= 1
                        and in_shape[0] == out_shape[0]),
    }
    (out / "meta.json").write_text(json.dumps(meta, indent=2))
    return out


def do_export_mock(args) -> Path:
    out = write_mock_artifact(
        args.out, in_shape=tuple(int(d) for d in args.in_shape.split(",")),
        out_shape=tuple(int(d) for d in args.out_shape.split(",")),
        scale=args.scale, shift=args.shift, layout=args.layout)
    print(f"mock artifact: {out}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="mode", required=True)
    pe = sub.add_parser("export", help="write <run>/model_b{B}.nodeexport "
                                       "(torch.export) and its sidecar")
    pe.add_argument("--run", required=True, help="run dir with checkpoints")
    pe.add_argument("--ckpt", default="ckpt_best.pt",
                    help="file inside --run (a JAX run directory falls back "
                         "to its ckpt_best.msgpack)")
    pe.add_argument("--batch", type=int, default=256)
    pe.add_argument("--out", default=None)
    pe.add_argument("--cpu", action="store_true",
                    help="export on the CPU (the artifact then runs on the "
                         "CPU only)")
    pe.set_defaults(fn=do_export)
    pc = sub.add_parser("export-compiled",
                        help="write a .npexec artifact for the port's host")
    pc.add_argument("--run", required=True,
                    help="run directory (either package's) or checkpoint")
    pc.add_argument("--ckpt", default="ckpt_best.pt",
                    help="file inside --run (a JAX run directory falls back "
                         "to its ckpt_best.msgpack)")
    pc.add_argument("--batch", type=int, default=256)
    pc.add_argument("--chain", type=int, default=1,
                    help="batches per request: a (K, B, ...) input solved "
                         "batch by batch")
    pc.add_argument("--out", default=None)
    pc.add_argument("--cpu", action="store_true",
                    help="export on the CPU through the plain path")
    pc.set_defaults(fn=do_export_compiled)
    pm = sub.add_parser("export-mock",
                        help="fabricate a .npexec for the mock PJRT plugin "
                             "(hermetic host testing)")
    pm.add_argument("--out", required=True)
    pm.add_argument("--in-shape", default="4,3,5")
    pm.add_argument("--out-shape", default="4,10")
    pm.add_argument("--scale", type=float, default=2.0)
    pm.add_argument("--shift", type=float, default=1.0)
    pm.add_argument("--layout", default="reversed",
                    choices=["reversed", "rowmajor"])
    pm.set_defaults(fn=do_export_mock, cpu=True)
    pr = sub.add_parser("run", help="run a .nodeexport with no model code, "
                                    "optionally against the live model")
    pr.add_argument("--artifact", required=True)
    pr.add_argument("--run", default=None,
                    help="optional run dir for a live-model parity check")
    pr.add_argument("--ckpt", default="ckpt_best.pt")
    pr.add_argument("--reps", type=int, default=3)
    pr.add_argument("--cpu", action="store_true")
    pr.set_defaults(fn=do_run)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
