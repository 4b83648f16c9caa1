"""Where the tensor-core conv stage's time goes: rebuild the conv probe and
the fused dopri5 step with parts of ``csrc/odefunc_common.cuh`` edited out or
swapped, and time them on the card beside the shipped kernels.

    python -m neural_ode_features_tpu_torch.probes.timing_aids [--batch 256]

The counterpart of the JAX probe's ``dotonly``, ``norollS`` and ``nomaskS``:
most variants compute WRONG values on purpose, so that what is missing from
their time is what the missing part costs.  Each variant is a list of
``(old, new)`` text substitutions on a copy of ``csrc/`` in a temporary
directory (``VARIANTS``; a substitution whose ``old`` is not found exactly
once raises, and a CPU test holds the patterns against the sources), built
with the flags of ``kernels/_build.py`` and loaded with ``ctypes`` in place
of the shipped library for the duration of its measurement.

Conv probe (``mma3``, device µs per conv by kernel name):

``shipped``      the stage as it is.
``cvt``          head and tail rounded by ``cvt.rna.tf32.f32`` (right
                 values): what the integer rounding and the unrounded tail
                 save.
``cvt_head``     head by ``cvt.rna``, tail unrounded (right values).
``chain``        one tensor-core accumulator over all nine taps, no f32 adds
                 between taps (right values, less exact: its error against
                 the f64 conv is printed for every variant).
``no_reload``    only the first two taps' weights are ever staged.
``no_barrier``   ``no_reload`` without the per-tap barrier.
``no_products``  weights and barriers, but no fragment loads, splits or
                 products.
``empty``        no tap loop at all: zero pad, copy-in, the two-half
                 reduction and the store.

Fused step (``rk_step_kernel``, device ms per launch):

``shipped``, ``no_conv`` (no tap loops in its twelve convs) and
``no_conv_no_gn`` (also no GroupNorm statistics).

Prints the card's name and power limit and one line per variant; writes no
file.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from .._device import strict_f32
from ..kernels import _build
from ..kernels import rk_step as rk_step_mod
from ..kernels.conv3x3 import conv3x3, conv3x3_plain
from ..kernels.odefunc import odefunc_plain, prepare
from ..solver import DOPRI5
from .conv_probe import KERNEL_NAMES, device_us, probe_inputs

__all__ = ["VARIANTS", "RK_VARIANTS", "patched_sources", "main"]

HEADER = "odefunc_common.cuh"

_PRELOAD = "    for (int i = 0; i < ring - 1; ++i) load_tile(i, nb, i);\n"
_WAIT = ("      if (ring == 3 && tile + 1 < ntile) cp_async_wait_but_one();"
         " else cp_async_wait_all();\n"
         "      __syncthreads();  // the tile's weights visible; the buffer of"
         " tile - 1 is free\n")
_TAP_LOOP = ("    for (int tile = 0, wbuf = 0; tile < ntile;\n"
             "         ++tile, wbuf = GENERAL && wbuf + 1 < ring ? wbuf + 1 : 0) {\n"
             "      const int buf = GENERAL ? wbuf : tile % kRing;\n" + _WAIT)
_RELOAD = ("      if (tile + ring - 1 < ntile) load_tile(tile + ring - 1, nb,"
           " buf == 0 ? ring - 1 : buf - 1);\n")
_B_TAP = "      const uint32_t b_tap = b_thread + 4u * (buf * stage);\n"
_RNA = "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
_CVT = ('  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));\n'
        "  return r;\n")
_TAIL = "  lo = __float_as_uint(x - __uint_as_float(hi));\n"
_NO_RELOAD = [(_RELOAD, ""),
              (_B_TAP, _B_TAP.replace("buf * stage", "(tile & 1) * stage"))]

# name -> substitutions on csrc/odefunc_common.cuh.
VARIANTS = {
    "shipped": [],
    "cvt": [(_RNA, _CVT),
            (_TAIL, "  lo = tf32_rna(x - __uint_as_float(hi));\n")],
    "cvt_head": [(_RNA, _CVT)],
    "chain": [
        ("              if (ks == 0) mma_tf32_zero(acc[i][j], alo, bhi[j]);\n"
         "              else mma_tf32(acc[i][j], alo, bhi[j]);\n"
         "              mma_tf32(acc[i][j], ahi, blo[j]);\n"
         "              mma_tf32(acc[i][j], ahi, bhi[j]);\n",
         "              mma_tf32(run[i][j], alo, bhi[j]);\n"
         "              mma_tf32(run[i][j], ahi, blo[j]);\n"
         "              mma_tf32(run[i][j], ahi, bhi[j]);\n"),
        ("          for (int r = 0; r < 4; ++r) run[i][j][r] += acc[i][j][r];\n",
         "          for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;\n"),
    ],
    "no_reload": _NO_RELOAD,
    "no_barrier": _NO_RELOAD + [
        (_WAIT,
         "      if (tile == 0) { cp_async_wait_all(); __syncthreads(); }\n")],
    "no_products": [(_B_TAP, _B_TAP + "      if (tile >= 0) continue;\n")],
    "empty": [(_PRELOAD, ""),
              (_TAP_LOOP, _TAP_LOOP.replace("tile < ntile", "tile < 0"))],
}

_GN_FIRST_PASS = ("  float acc = 0.f;\n"
                  "  if (on)\n"
                  "    for (int p = pg; p < hw; p += npg) acc += x[p * C + c];\n")
RK_VARIANTS = {
    "shipped": [],
    "no_conv": VARIANTS["empty"],
    "no_conv_no_gn": VARIANTS["empty"] + [
        (_GN_FIRST_PASS,
         "  float acc = 0.f;\n"
         "  if (hw > 0) { Stat none; none.mean = x[tid] * 0.f; none.inv = 1.f;"
         " return none; }\n")],
}


def patched_sources(edits, dest: Path, csrc: Path = _build.CSRC) -> Path:
    """Copy ``csrc`` to ``dest`` and apply ``edits`` to the shared header;
    each ``old`` must occur exactly once."""
    shutil.copytree(csrc, dest)
    text = (dest / HEADER).read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"timing aid: expected exactly one occurrence "
                             f"of {old!r} in {HEADER}")
        text = text.replace(old, new)
    (dest / HEADER).write_text(text)
    return dest


def _build_variant(edits, source: str, tmp: Path, tag: str) -> ctypes.CDLL:
    src = patched_sources(edits, tmp / tag)
    lib = src / f"lib{source}.so"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build._nvcc(), *flags, "-o", str(lib),
                    str(src / f"{source}.cu")], check=True)
    cdll = ctypes.CDLL(str(lib))
    cdll.nodef_error_string.argtypes = [ctypes.c_int]
    cdll.nodef_error_string.restype = ctypes.c_char_p
    return cdll


def _with_library(source: str, lib, fn):
    """Run ``fn`` with ``lib`` loaded in place of the shipped ``source``."""
    shipped = _build.load(source)
    _build._loaded[source] = lib or shipped
    try:
        return fn()
    finally:
        _build._loaded[source] = shipped


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=256)
    args = p.parse_args(argv)
    dev = strict_f32("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"=== timing aids: B={args.batch} 7x7x64 on {smi} ===")
    out = {"conv_us": {}, "conv_err_f64": {}, "rk_step_ms": {}}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        x, w = probe_inputs(args.batch, dev)
        exact = conv3x3_plain(x.double(), w.double())
        name = KERNEL_NAMES["mma3"]
        for tag, edits in VARIANTS.items():
            lib = (_build_variant(edits, "conv_probe", tmp, f"conv_{tag}")
                   if edits else None)

            def run():
                err = float((conv3x3(x, w, "mma3").double() - exact)
                            .abs().max())
                return err, device_us(lambda: conv3x3(x, w, "mma3"),
                                      (name,))[name]

            err, us = _with_library("conv_probe", lib, run)
            out["conv_us"][tag], out["conv_err_f64"][tag] = us, err
            print(f"conv mma3 {tag:>12}: {us:6.1f} us/conv, max abs err vs "
                  f"the f64 plain version {err:.2e}")

        from ..entry import entry

        _, (params, _) = entry(device="cuda", batch=args.batch)
        wts = prepare(params["odefunc"], (7, 7))
        rng = np.random.default_rng(1)
        b = args.batch
        h = torch.from_numpy((rng.normal(size=(b, 7, 7, 64)) * 0.3)
                             .astype(np.float32)).to(dev)
        t0 = torch.from_numpy(rng.uniform(0, 0.5, b).astype(np.float32)).to(dev)
        dt = torch.from_numpy(rng.uniform(0.05, 0.2, b)
                              .astype(np.float32)).to(dev)
        y0 = h.reshape(b, -1)
        f0 = odefunc_plain(wts, t0, h, 32).reshape(b, -1)
        for tag, edits in RK_VARIANTS.items():
            lib = (_build_variant(edits, "rk_step", tmp, f"rk_{tag}")
                   if edits else None)
            us = _with_library("rk_step", lib, lambda: device_us(
                lambda: rk_step_mod.dopri5_step(
                    wts, DOPRI5, t0, dt, y0, f0, hw=(7, 7), groups=32,
                    rtol=1e-3, atol=1e-3),
                ("rk_step_kernel",), reps=20)["rk_step_kernel"])
            out["rk_step_ms"][tag] = us / 1e3
            print(f"rk_step {tag:>14}: {us / 1e3:.4f} ms per launch")
    return out


if __name__ == "__main__":
    main()
