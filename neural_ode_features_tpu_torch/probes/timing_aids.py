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

``shipped``, ``no_conv`` (no tap loops in its twelve convs, on either
tensor-core stage: ``mma3``'s, and ``wgmma3``'s with its first copies) and
``no_conv_no_gn`` (also no GroupNorm statistics).

With ``--bwd-only``, in place of the two above, the backward's per-sample
pass (7×7×64, device ms per launch at each ``--bwd-batch`` and in each
build of ``--bwd-precision``, ``f32`` and/or ``bf16``; ``BWD_VARIANTS``,
edits of ``csrc/odefunc_bwd.cu``; 11 builds, each timed in every build),
each variant of the cluster pass (``bwd_sample_kernel_cluster``, what both
builds run there) beside the same variant of the one-CTA pass
(``bwd_sample_kernel``, the cluster gate switched off):

``shipped``        the pass as it is.
``no_igrad_conv``  no input-gradient convs (neither tap loop).
``no_conv``        no conv at all: neither the forward recompute's two nor
                   the input gradients.
``no_gn_bwd``      no GroupNorm backward reductions (the per-channel sums
                   over the pixels and the group means; the elementwise dx
                   stays).
``no_writes``      no global stores of the residuals r1, r2, gu, gv.
``no_remote``      (the cluster pass only) no stores into the peer CTA's
                   shared memory: each conv reads half its input.

    python -m neural_ode_features_tpu_torch.probes.timing_aids --bwd-only \
        [--bwd-batch 128,16] [--bwd-precision f32,bf16]

With ``--im2col``, in place of all of the above, the probe's
``im2col_bf16`` (``I2W_VARIANTS``, edits of ``csrc/conv_probe.cu``; device
µs per conv by CUDA events behind a spin kernel, ``conv_probe.queued_us``,
at B = 256 in 128-row tiles and B = 128 in 64-row tiles, the tiles the
wrapper takes there, 7×7×64; each variant's error against the f64 conv of
the rounded operands at B = 256):

``shipped``      the kernel as it is.
``chain``        one tensor-core chain over all of K = 9C, no f32 adds
                 (right values, less exact).
``no_weights``   the producer's copies of w fetch nothing (zero-filled);
                 its conversion and stores stay.
``no_patch``     the consumers' patch slices read nothing from the window
                 (zeros); their stores stay.
``no_products``  no ``wgmma``.
``no_store``     no stores to y.
``empty``        no stage loop: the window, the first patch slice and the
                 epilogue.

    python -m neural_ode_features_tpu_torch.probes.timing_aids --im2col

With ``--tap9``, in place of all of the above, the probe's ``tap9_bf16``
the same way (``TAP9_VARIANTS``: ``shipped``; ``chain``, one tensor-core
chain a stage in place of one per k half, right values), beside the fused
bf16 builds' FFMA conv
stage alone (``tap9_kernel<true>``, what ``tap9_bf16`` ran before; device
µs at B = 256 and 128, its error at B = 256) and ``F.conv2d`` on bf16
tensors (2 builds):

    python -m neural_ode_features_tpu_torch.probes.timing_aids --tap9

With ``--weights``, in place of all of the above, the backward's
weight-gradient launch alone (``bwd_weight_kernel``, device ms by CUDA
events behind a spin kernel, at 7×7×512 and 7×7×64, B = 128, both builds,
beside the ``mma.sync`` kernel; ``WEIGHT_VARIANTS``, edits of
``csrc/odefunc_bwd.cu``, built in parallel):

``shipped``       the kernel as it is.
``no_products``   no ``wgmma`` (the chains' fences, commits and waits stay).
``no_g_staging``  no loads or transposing stores of g after the first
                  sample's.
``no_copies``     neither those nor the copies of r's map.

    python -m neural_ode_features_tpu_torch.probes.timing_aids --weights

Prints the card's name and power limit and one line per variant; writes no
file.  Needs a CUDA card and ``nvcc``.

Readings of kept kernels that no path runs any more, each the yardstick
of what replaced it: :func:`odefunc_cta_bf16` (the bf16 ODEfunc on one CTA
per sample, replaced by the rows build at C = 96 to 512),
:func:`odefunc_bwd_cta_bf16` (the bf16 backward on the per-sample passes,
replaced by the rows backward there), :func:`odefunc_bwd_mma_weights`
(either build's backward with its weight gradients on the ``mma.sync``
kernel, replaced by ``bwd_weight_kernel`` on ``wgmma`` at C ≥ 64) and
:func:`bwd_weight_partials` (either weight kernel alone, for their times
in turns).
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

__all__ = ["VARIANTS", "RK_VARIANTS", "BWD_VARIANTS", "I2W_VARIANTS",
           "TAP9_VARIANTS", "WEIGHT_VARIANTS", "patched_sources", "tap9_ffma_bf16",
           "odefunc_cta_bf16", "odefunc_bwd_cta_bf16",
           "odefunc_bwd_mma_weights", "bwd_weight_partials", "main"]

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

# wgmma3 (conv3x3_wgmma): no tile is copied in and no tile loop runs.
_WG_EMPTY = [
    ("    mbar_expect_tx(full, kBytes);\n"
     "    bulk_copy(raw_s, tile(0), kBytes, full);\n", ""),
    ("  for (int tap = 0; tap < 9; ++tap) {\n"
     "    mbar_wait(full, tap & 1);  // the f32 tile has landed\n",
     "  for (int tap = 0; tap < 0; ++tap) {\n"
     "    mbar_wait(full, tap & 1);  // the f32 tile has landed\n"),
]

_GN_FIRST_PASS = ("  float acc = 0.f;\n"
                  "  if (on)\n"
                  "    for (int p = pg; p < hw; p += npg) acc += x[p * C + c];\n")
RK_VARIANTS = {
    "shipped": [],
    "no_conv": VARIANTS["empty"] + _WG_EMPTY,
    "no_conv_no_gn": VARIANTS["empty"] + _WG_EMPTY + [
        (_GN_FIRST_PASS,
         "  float acc = 0.f;\n"
         "  if (hw > 0) { Stat none; none.mean = x[tid] * 0.f; none.inv = 1.f;"
         " return none; }\n")],
}

# The backward's per-sample pass at 7×7×64 (csrc/odefunc_bwd.cu): the
# cluster pass, bwd_sample_kernel_cluster, which both builds run there, and
# the one-CTA pass, bwd_sample_kernel, run there by switching the cluster
# gate off (its "shipped" is the one-CTA pass that the build ran at C = 64
# before its cluster: bit for bit in f32).
_BWD = "odefunc_bwd.cu"
_PAIR_IGRAD = [
    (_BWD, f"  pair_conv<true, kPrec>(m, s, p.{w}, rank, to_sx);  // conv{w[1]} input "
           f"gradient\n", "") for w in ("w2", "w1")]
_PAIR_FWD_CONV = [
    (_BWD, f"  pair_conv<false, kPrec>(m, s, p.{w}, rank, [&](int q, int cl, "
           f"float acc) {{\n",
     f"  if (false) pair_conv<false, kPrec>(m, s, p.{w}, rank, [&](int q, "
     f"int cl, float acc) {{\n") for w in ("w1", "w2")]
_PAIR_GN = [
    (_BWD, "    for (int el = tid; el < n; el += kPairThreads) {\n"
           "      a1 = a1f(el, a1);\n",
     "    if (false) for (int el = tid; el < n; el += kPairThreads) {\n"
     "      a1 = a1f(el, a1);\n"),
    (_BWD, "  if (tid < (s.G >> 1)) {  // the group means of this CTA's groups\n",
     "  if (false) {  // the group means of this CTA's groups\n"),
]
_PAIR_WRITES = [
    *((_BWD, f"    {r}[at(el)] = y;\n", "") for r in ("r1", "r2")),
    *((_BWD, f"                            {r}[at(el)] = v;\n", "")
      for r in ("gv", "gu")),
]
_CTA = [(_BWD, "  if (pair_ok(H, W, C, G)) {", "  if (false) {")]
_CTA_IGRAD = [
    (_BWD, f"  if (s.mma) mma_stage<kB ? kPassBf16 : 3, true, kWide>(m, s, "
           f"p.{w}, to_sx);\n  else conv3x3<kB>(m, s, {w}bt, to_sx);\n", "")
    for w in ("w2", "w1")]
_CTA_FWD_CONV = [
    (_BWD, "  conv_stage<kWide, kPrec>(m, s, p.w1, [&](int q, int co, float "
           "acc) {\n",
     "  if (false) conv_stage<kWide, kPrec>(m, s, p.w1, [&](int q, int co, "
     "float acc) {\n"),
    (_BWD, "  conv3x3_to_sx<kWide, kPrec>(m, s, p.w2, p.b2, p.m2, tb);\n", ""),
]
_CTA_GN = [
    (_BWD, "  channel_sums<WIDE>(\n      m, sred2, chan, s,\n",
     "  if (false) channel_sums<WIDE>(\n      m, sred2, chan, s,\n"),
    (_BWD, "  if (tid < s.G) {\n    const float n = (float)(hw * gs);\n",
     "  if (false) {\n    const float n = (float)(hw * gs);\n"),
]
_CTA_WRITES = [
    *((_BWD, f"  each_element<kWide>(s, [&](const auto& w) {{ {r}[off + w.e]"
             f" = m.spad[pad_at(s, w.q(s), w.c(s))]; }});\n", "")
      for r in ("r1", "r2")),
    *((_BWD, f"                              {r}[off + w.e] = v;\n", "")
      for r in ("gv", "gu")),
]
# pass -> variant -> substitutions.
BWD_VARIANTS = {
    "cluster": {
        "shipped": [],
        "no_igrad_conv": _PAIR_IGRAD,
        "no_conv": _PAIR_IGRAD + _PAIR_FWD_CONV,
        "no_gn_bwd": _PAIR_GN,
        "no_writes": _PAIR_WRITES,
        "no_remote": [(_BWD, "    st_peer(d, peer, v);\n", "")],
    },
    "cta": {
        "shipped": _CTA,
        "no_igrad_conv": _CTA + _CTA_IGRAD,
        "no_conv": _CTA + _CTA_IGRAD + _CTA_FWD_CONV,
        "no_gn_bwd": _CTA + _CTA_GN,
        "no_writes": _CTA + _CTA_WRITES,
    },
}


# The probe's im2col_bf16 and tap9_bf16 (csrc/conv_probe.cu
# rows_wgmma_conv, the body of both kernels: every edit edits both).
_I2W = "conv_probe.cu"
_I2W_PRODUCTS = ("      wgmma_ss_bf16(a0, da, db, 0);\n"
                 "      wgmma_ss_bf16(a0, da + 2, db + 2, 1);\n"
                 "      wgmma_ss_bf16(a1, da + 4, db + 4, 0);\n"
                 "      wgmma_ss_bf16(a1, da + 6, db + 6, 1);\n")
_I2W_RUNS = ("        run[0][nb][i] += a0[i];\n"
             "        run[1][nb][i] += a1[i];\n")
_I2W_LOOPS = [(_I2W, f"  {ind}for (int kc = 0; kc < nk; ++kc) {{  // the {who} "
                     f"stages\n",
               f"  {ind}for (int kc = 0; kc < 0; ++kc) {{  // the {who} "
               f"stages\n")
              for ind, who in (("  ", "producer's"), ("", "consumers'"))]
I2W_VARIANTS = {
    "shipped": [],
    "chain": [
        (_I2W, _I2W_PRODUCTS,
         _I2W_PRODUCTS.replace("(a0, da, db, 0)", "(a0, da, db, kc > 0)")
         .replace("(a1, da + 4, db + 4, 0)", "(a0, da + 4, db + 4, 1)")
         .replace("(a1, da + 6", "(a0, da + 6")),
        (_I2W, _I2W_RUNS, "        run[0][nb][i] = a0[i];\n")],
    "no_weights": [(_I2W, "            const bool ok = c_row[m] < rows_left;\n",
                    "            const bool ok = false;\n")],
    "no_patch": [(_I2W, "      bit[h] = live ? 1u << tap : 0u;\n",
                  "      bit[h] = 0u;\n")],
    "no_products": [(_I2W, _I2W_PRODUCTS, "")],
    "no_store": [(_I2W, "        if (co < C)\n"
                        "          *reinterpret_cast<float2*>(y + (size_t)r * C"
                        " + co) =\n",
                  "        if (co < 0)\n"
                  "          *reinterpret_cast<float2*>(y + (size_t)r * C"
                  " + co) =\n")],
    "empty": _I2W_LOOPS,
}
# tap9_bf16: the kernel as it is (per stage and k half a chain of two k16
# steps), and one chain of the four k16 steps a stage (a tap's block of 64
# channels) into one running sum (right values).
TAP9_VARIANTS = {
    "shipped": [],
    "chain": [
        (_I2W, _I2W_PRODUCTS,
         _I2W_PRODUCTS.replace("(a1, da + 4, db + 4, 0)",
                               "(a0, da + 4, db + 4, 1)")
         .replace("(a1, da + 6", "(a0, da + 6")),
        (_I2W, _I2W_RUNS, "        run[0][nb][i] += a0[i];\n")],
}


# The weight-gradient launch alone (csrc/odefunc_bwd.cu bwd_weight_kernel,
# wgmma): the parts of a sample's work taken out one at a time.
_W_CHAIN = ("        wgmma_tf32_n64(acc, al[ks], d_hi + step, ks > 0);\n"
            "        wgmma_tf32_n64(acc, ah[ks], d_lo + step, 1);\n")
_W_LAST = ("      wgmma_tf32_n64(acc, ah[ks], d_hi + step, kExact ? ks > 0 : 1);"
           "\n")
_W_G = "      store_g(buf ^ 1);\n      if (b + 2 < b1) load_g(b + 2);\n"
WEIGHT_VARIANTS = {
    "shipped": [],
    "no_products": [(_BWD, _W_CHAIN, ""), (_BWD, _W_LAST, "")],
    "no_g_staging": [(_BWD, _W_G, "")],
    "no_copies": [(_BWD, _W_G, ""),
                  (_BWD, "    if (b + 1 < b1) stage_r(b + 1, buf ^ 1);\n", "")],
}


def patched_sources(edits, dest: Path, csrc: Path = _build.CSRC) -> Path:
    """Copy ``csrc`` to ``dest`` and apply ``edits``: ``(old, new)`` to the
    shared header, ``(file, old, new)`` to that file of ``csrc``; each
    ``old`` must occur exactly once in its file."""
    shutil.copytree(csrc, dest)
    for edit in edits:
        name, old, new = edit if len(edit) == 3 else (HEADER, *edit)
        text = (dest / name).read_text()
        if text.count(old) != 1:
            raise ValueError(f"timing aid: expected exactly one occurrence "
                             f"of {old!r} in {name}")
        (dest / name).write_text(text.replace(old, new))
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


def bwd_times(tmp: Path, dev, batches, precisions=("f32",),
              reps: int = 20) -> dict:
    """Device ms per launch of the per-sample pass (the kernel named
    ``bwd_sample_kernel*``) under each of ``BWD_VARIANTS`` at 7×7×64, each
    batch of ``batches`` and each build of ``precisions`` (the entry
    model's ODEfunc, seed 7; numpy-seeded state and cotangent):
    ``{precision: {pass: {variant: {batch: ms}}}}``, the passes in turns
    variant by variant, each variant's library built once for every
    build."""
    from ..kernels.odefunc_bwd import odefunc_bwd
    from ..models import ModelConfig, init_odenet

    cfg = ModelConfig(in_channels=3, hidden=64, groups=32)
    wts = prepare(init_odenet(7, cfg, device=dev)["odefunc"], (7, 7))
    rng = np.random.default_rng(1)
    nb = max(batches)

    def arr(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    h = arr(rng.normal(size=(nb, 7, 7, 64)) * 0.3)
    t = arr(rng.uniform(0, 0.5, nb))
    g = arr(rng.normal(size=(nb, 7, 7, 64)))
    out = {prec: {name: {} for name in BWD_VARIANTS} for prec in precisions}
    for tag in BWD_VARIANTS["cluster"]:
        for name, variants in BWD_VARIANTS.items():
            if tag not in variants:
                continue
            edits = variants[tag]
            lib = (_build_variant(edits, "odefunc_bwd", tmp,
                                  f"bwd_{name}_{tag}") if edits else None)
            for prec in precisions:
                ms = out[prec][name][tag] = {}
                for b in batches:
                    args = (t[:b].contiguous(), h[:b].contiguous(),
                            g[:b].contiguous())
                    us = _with_library("odefunc_bwd", lib, lambda: device_us(
                        lambda: odefunc_bwd(wts, *args, groups=32,
                                            precision=prec),
                        ("bwd_sample_kernel",), reps))["bwd_sample_kernel"]
                    ms[b] = us / 1e3
                print(f"bwd_sample {prec:>4} {name:>7} {tag:>14}: "
                      + ", ".join(f"B={b} {v:.4f} ms" for b, v in ms.items())
                      + " per launch")
    return out


def weight_times(tmp: Path, dev, shapes=((7, 7, 512), (7, 7, 64)),
                 batch: int = 128, reps: int = 20) -> dict:
    """Device ms of the weight-gradient launch alone (``bwd_weight_kernel``,
    :func:`bwd_weight_partials`; CUDA events behind a spin kernel) under
    each of ``WEIGHT_VARIANTS`` at each H×W×C of ``shapes``, B = ``batch``,
    in both builds, on the residuals of one backward call (the entry
    model's ODEfunc at that width, seed 7; numpy-seeded state and
    cotangent), beside the ``mma.sync`` kernel:
    ``{shape: {precision: {variant: ms}}}``.  The variants' libraries are
    built in parallel, one ``nvcc`` each."""
    from ..kernels.odefunc_bwd import odefunc_bwd
    from ..models import ModelConfig, init_odenet
    from .conv_probe import queued_us

    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    jobs = {}
    for tag, edits in WEIGHT_VARIANTS.items():
        if edits:
            src = patched_sources(edits, tmp / f"weight_{tag}")
            jobs[tag] = (src / "libodefunc_bwd.so", subprocess.Popen(
                [_build._nvcc(), *flags, "-o", str(src / "libodefunc_bwd.so"),
                 str(src / "odefunc_bwd.cu")]))
    libs = {tag: None for tag in WEIGHT_VARIANTS}
    for tag, (path, proc) in jobs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the weight variant {tag}")
        libs[tag] = ctypes.CDLL(str(path))
        libs[tag].nodef_error_string.argtypes = [ctypes.c_int]
        libs[tag].nodef_error_string.restype = ctypes.c_char_p
    out = {}
    for hh, ww, c in shapes:
        cfg = ModelConfig(in_channels=3, hidden=c, groups=32)
        wts = prepare(init_odenet(7, cfg, device=dev)["odefunc"], (hh, ww))
        rng = np.random.default_rng(1)
        h = torch.from_numpy((rng.normal(size=(batch, hh, ww, c)) * 0.3)
                             .astype(np.float32)).to(dev)
        t = torch.from_numpy(rng.uniform(0, 0.5, batch)
                             .astype(np.float32)).to(dev)
        g = torch.from_numpy(rng.normal(size=(batch, hh, ww, c))
                             .astype(np.float32)).to(dev)
        row = out[f"{hh}x{ww}x{c}"] = {}
        for prec in ("f32", "bf16"):
            res = {}
            odefunc_bwd(wts, t, h, g, groups=32, precision=prec,
                        residuals=res)
            part = bwd_weight_partials(res, prec, "wgmma")
            ms = row[prec] = {"mma": queued_us(lambda: bwd_weight_partials(
                res, prec, "mma", out=part), reps) / 1e3}
            for tag, lib in libs.items():
                ms[tag] = _with_library("odefunc_bwd", lib, lambda: queued_us(
                    lambda: bwd_weight_partials(res, prec, "wgmma", out=part),
                    reps)) / 1e3
            print(f"bwd_weight {hh}x{ww}x{c} {prec:>4}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in ms.items()) + " ms per launch")
    return out


def rows_times(tmp: Path, dev, strategy: str = "im2col_bf16",
               variants: dict = I2W_VARIANTS) -> dict:
    """Device µs per conv of ``strategy`` (``im2col_bf16`` or
    ``tap9_bf16``) under each of ``variants`` at 7×7×64 (the probe's
    inputs), B = 256 in 128-row tiles and B = 128 in 64-row tiles, and each
    variant's max abs error at B = 256 against the f64 conv of the rounded
    operands: ``{variant: {"us": {batch: us}, "err_f64": err}}``."""
    from ..kernels.odefunc import bf16_round
    from .conv_probe import queued_us

    cases = {256: probe_inputs(256, dev), 128: probe_inputs(128, dev)}
    tiles = {256: 128, 128: 64}
    x, w = cases[256]
    exact = conv3x3_plain(bf16_round(x).double(), bf16_round(w).double())
    out = {}
    for tag, edits in variants.items():
        lib = (_build_variant(edits, "conv_probe", tmp, f"{strategy}_{tag}")
               if edits else None)

        def run():
            err = float((conv3x3(x, w, strategy, tile_rows=tiles[256])
                         .double() - exact).abs().max())
            us = {b: queued_us(lambda b=b: conv3x3(
                *cases[b], strategy, tile_rows=tiles[b]), reps=100)
                for b in cases}
            return err, us

        err, us = _with_library("conv_probe", lib, run)
        out[tag] = {"us": us, "err_f64": err}
        print(f"{strategy} {tag:>12}: " + ", ".join(
            f"B={b} {v:6.2f} us/conv" for b, v in us.items())
            + f"; max abs err vs the f64 conv of the rounded operands "
              f"{err:.2e}")
    return out


def tap9_ffma_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The fused bf16 builds' FFMA conv stage alone (``conv3x3<true>`` of
    ``csrc/odefunc_common.cuh``, one CTA per sample: ``tap9_kernel<true>``,
    the C entry ``conv_probe_tap9_ffma_bf16``) on CUDA tensors x (B, H, W,
    C) and w (3, 3, C, C) f32, at the shapes of ``tap9``'s gate.  A reading
    of that stage, which the fused bf16 kernels run at C = 32 and on maps
    with H·(W+2) > 64; no strategy of the probe, no launch counter."""
    from ..kernels.conv3x3 import supported
    from ..kernels.odefunc import ptr, stream

    b, hh, ww, c = x.shape
    if not (x.is_cuda and supported((hh, ww), c, "tap9")
            and x.is_contiguous() and w.is_contiguous()
            and tuple(w.shape) == (3, 3, c, c)):
        raise ValueError(f"tap9_ffma_bf16 takes contiguous CUDA tensors of "
                         f"tap9's gate, got {tuple(x.shape)} on {x.device}")
    lib = _build.load("conv_probe")
    fn = lib.conv_probe_tap9_ffma_bf16
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    y = torch.empty_like(x)
    _build.check(lib, fn(ptr(x), ptr(w), ptr(y), b, hh, ww, c, stream()),
                 "conv_probe_tap9_ffma_bf16")
    return y


def odefunc_cta_bf16(params, t: torch.Tensor, h: torch.Tensor,
                     groups: int = 32) -> torch.Tensor:
    """The bf16 dynamics f(t, h) on the per-sample kernel (``odefunc_kernel``
    with ``kBf16``, one CTA per sample: the C entry
    ``odefunc_forward_bf16_cta``) on CUDA tensors, at every shape of the
    kernels' gate.  At C = 96 to 512 on 7×7 and 6×6 maps the path runs the
    rows build in its place (``kernels.odefunc.stage`` gives
    ``'rows_bf16'``); this is that build's yardstick, bit for bit and by
    time.  No launch counter: nothing on a path calls it."""
    from ..kernels.odefunc import (
        _lib,
        check_cuda_inputs,
        ptr,
        stream,
        weight_pointers,
    )

    w = prepare(params, tuple(h.shape[1:3]))
    b, hh, ww, c = h.shape
    check_cuda_inputs(w, {"h": h, "t": t}, (hh, ww), c, groups)
    if tuple(t.shape) != (b,):
        raise ValueError(f"t: expected shape ({b},), got {tuple(t.shape)}")
    lib = _lib()
    out = torch.empty_like(h)
    _build.check(lib, lib.odefunc_forward_bf16_cta(
        ptr(t), ptr(h), *weight_pointers(w), ptr(out), b, hh, ww, c, groups,
        stream()), "odefunc_forward_bf16_cta")
    return out


def odefunc_bwd_cta_bf16(params, t, h: torch.Tensor, g: torch.Tensor,
                         groups: int = 32, with_f: bool = False,
                         residuals: dict | None = None):
    """The bf16 VJP on the per-sample passes (the C entry
    ``odefunc_backward_bf16_cta``: ``bwd_sample_kernel`` with ``kBf16``,
    or the cluster pass at C = 64) on CUDA tensors, at every shape of the
    backward's gate: ``(dparams, dt, dh)`` and f where ``with_f``, as
    ``odefunc_bwd(..., precision='bf16')`` gives them.  At C = 96 to 512 on
    7×7 and 6×6 maps the path runs the rows backward in its place
    (``kernels.odefunc_bwd.sample_pass`` gives ``'rows'``); this is that
    build's yardstick, bit for bit and by time.  No launch counter: nothing
    on a path calls it."""
    from ..kernels import odefunc_bwd as bwd_mod

    b, hh, ww, _ = h.shape
    if h.device.type != "cuda":
        raise ValueError("odefunc_bwd_cta_bf16 takes CUDA tensors")
    out = bwd_mod.launch(prepare(params, (hh, ww)), t, h, g, groups,
                         bwd_mod._CTA_BF16, residuals)
    return out if with_f else out[:3]


def odefunc_bwd_mma_weights(params, t, h: torch.Tensor, g: torch.Tensor,
                            groups: int = 32, precision: str = "f32",
                            with_f: bool = False,
                            residuals: dict | None = None):
    """The backward of ``precision`` with its weight gradients on the
    ``mma.sync`` kernel (``bwd_weight_kernel_mma``; the C entries
    ``odefunc_backward_mma_weights``, ``odefunc_backward_bf16_mma_weights``)
    on CUDA tensors, at every shape of the backward's gate:
    ``(dparams, dt, dh)`` and f where ``with_f``, as ``odefunc_bwd`` gives
    them.  At C ≥ 64 the path runs ``bwd_weight_kernel`` (``wgmma``) in its
    place (``kernels.odefunc_bwd.weight_kernel``); this is that kernel's
    yardstick, bit for bit.  No launch counter: nothing on a path calls
    it."""
    from ..kernels import odefunc_bwd as bwd_mod

    b, hh, ww, _ = h.shape
    if h.device.type != "cuda":
        raise ValueError("odefunc_bwd_mma_weights takes CUDA tensors")
    out = bwd_mod.launch(prepare(params, (hh, ww)), t, h, g, groups,
                         bwd_mod._MMA_WEIGHTS[precision], residuals)
    return out if with_f else out[:3]


_WEIGHT_KERNELS = ("path", "mma", "wgmma")  # csrc nodef::WeightKernel


def bwd_weight_partials(res: dict, precision: str = "f32",
                        kernel: str = "path", groups: int = 32,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """The weight-gradient launch alone (the C entry
    ``odefunc_bwd_weight_grads``) on the residuals a backward call
    contracted (``res``: ``r1``, ``r2``, ``gu``, ``gv``, (B, H, W, C) on the
    card, as ``odefunc_bwd(..., residuals=res)`` fills it): the row chunks'
    partial sums (splits, 2, 9, C, C), ``weight_splits`` chunks, in the
    build of ``precision`` ('bf16': one exact TF32 pass) on ``kernel``:
    ``'path'``, the one the backward runs (``kernels.odefunc_bwd.
    weight_kernel``), ``'mma'``, ``bwd_weight_kernel_mma``, or ``'wgmma'``,
    ``bwd_weight_kernel`` wherever it can run (``wgmma_weights_ok``: C ≥ 64,
    at C % 64 == 32 too, where the path keeps the ``mma.sync`` kernel);
    into ``out`` where given: the kernels' bits and device time in turns.
    No launch counter: nothing on a path calls it."""
    from ..kernels import odefunc_bwd as bwd_mod
    from ..kernels.odefunc import ptr, stream

    if kernel not in _WEIGHT_KERNELS or precision not in ("f32", "bf16"):
        raise ValueError(f"kernel one of {_WEIGHT_KERNELS} and precision "
                         f"'f32' or 'bf16', got {kernel!r}, {precision!r}")
    r1 = res["r1"]
    b, hh, ww, c = r1.shape
    ns = bwd_mod.weight_splits(b, c)
    if out is None:
        out = torch.empty((ns, 2, 9, c, c), dtype=torch.float32,
                          device=r1.device)
    lib = bwd_mod._lib()
    _build.check(lib, getattr(lib, bwd_mod._WEIGHT_GRADS)(
        *(ptr(res[k].contiguous()) for k in ("r1", "r2", "gu", "gv")),
        ptr(out), b, hh, ww, c, groups, ns, precision == "bf16",
        _WEIGHT_KERNELS.index(kernel), stream()), bwd_mod._WEIGHT_GRADS)
    return out


def tap9_times(tmp: Path, dev) -> dict:
    """``tap9_bf16`` under each of ``TAP9_VARIANTS`` (:func:`rows_times`),
    beside the fused bf16 builds' FFMA stage, which the strategy was before
    (:func:`tap9_ffma_bf16`: device µs by CUDA events behind a spin kernel
    at B = 256 and 128, and its error at B = 256), and ``F.conv2d`` on bf16
    tensors, timed the same way."""
    from ..kernels.odefunc import bf16_round
    from .conv_probe import library_conv, queued_us

    out = rows_times(tmp, dev, "tap9_bf16", TAP9_VARIANTS)
    x, w = probe_inputs(256, dev)
    exact = conv3x3_plain(bf16_round(x).double(), bf16_round(w).double())
    ffma = {"err_f64": float((tap9_ffma_bf16(x, w).double() - exact)
                             .abs().max()), "us": {}}
    lib = {}
    for b in (256, 128):
        xb, wb = probe_inputs(b, dev)
        ffma["us"][b] = queued_us(lambda: tap9_ffma_bf16(xb, wb), reps=100)
        x16, w16 = xb.bfloat16(), wb.bfloat16()
        lib[b] = queued_us(lambda: library_conv(x16, w16), reps=100)
    out["ffma_stage"] = ffma
    out["library_bf16_us"] = lib
    print("tap9_bf16's old FFMA stage (tap9_kernel<true>): " + ", ".join(
        f"B={b} {v:6.2f} us/conv" for b, v in ffma["us"].items())
        + f"; max abs err {ffma['err_f64']:.2e}; F.conv2d bf16: "
        + ", ".join(f"B={b} {v:6.2f} us/conv" for b, v in lib.items()))
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--bwd-batch", default="128",
                   help="comma-separated batches of the backward variants")
    p.add_argument("--bwd-only", action="store_true",
                   help="time the backward's per-sample pass (BWD_VARIANTS) "
                        "in place of the probe and rk_step")
    p.add_argument("--bwd-precision", default="f32",
                   help="comma-separated builds of the backward variants "
                        "(f32, bf16)")
    p.add_argument("--im2col", action="store_true",
                   help="time the probe's im2col_bf16 (I2W_VARIANTS) in "
                        "place of the probe's mma3 and rk_step")
    p.add_argument("--weights", action="store_true",
                   help="time the backward's weight-gradient launch alone "
                        "(WEIGHT_VARIANTS) in place of the probe and "
                        "rk_step")
    p.add_argument("--tap9", action="store_true",
                   help="time the probe's tap9_bf16 (TAP9_VARIANTS) and the "
                        "fused bf16 builds' FFMA stage in place of the "
                        "probe's mma3 and rk_step")
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
        if args.im2col:
            return {"im2col_bf16": rows_times(tmp, dev)}
        if args.tap9:
            return {"tap9_bf16": tap9_times(tmp, dev)}
        if args.weights:
            return {"bwd_weight_ms": weight_times(tmp, dev)}
        if args.bwd_only:
            return {"bwd_sample_ms": bwd_times(
                tmp, dev, [int(b) for b in args.bwd_batch.split(",")],
                args.bwd_precision.split(","))}
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
