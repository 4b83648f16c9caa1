"""How far each bf16 build of the fused kernels lies from its plain version,
beside how far its f32 build lies from the same plain version: the readings
behind the bf16 bars, and the check that holds a build to them.

    python -m neural_ode_features_tpu_torch.probes.bf16_distances \\
        [--shapes 7x7x32,7x7x64,7x7x128,7x7x512,6x6x64] [--batch 5,32,256]

Units.  u = 2^-8, one bf16 rounding.  A bf16 build and its plain version
round alike except where their f32 sums, taken in other orders, straddle a
bf16 boundary; there they land one bf16 ulp apart.  A max over a row is set
by one such step, so it cannot tell a bf16 build from an f32 one (both read
2–3 u per row); a relative L2 over the whole output counts every element.

- ``odefunc`` with ``compute_dtype=bfloat16`` against ``odefunc_plain(...,
  'bf16')``: ``u_per_row`` (largest |Δ| per row over u of the row's
  max-norm) and ``rel_u`` (relative L2 over u), the kernel's and the f32
  build's.
- ``rk_step`` with ``conv_precision='bf16'`` against ``dopri5_step_plain(...,
  conv_precision='bf16')``: per output (y1, f1, y_mid, ratio) the relative
  L2 of the bf16 build and of the f32 build.  These cannot hold the bf16
  build tightly: a flipped rounding in one evaluation moves the next stage's
  input, the next evaluation flips more, and by f1 the bf16 build lies a
  third to two thirds as far from the plain step as the f32 build.  So the
  bars hold the attempt one evaluation at a time, from the kernel's own
  stages (its scratch, read back): ``stages``, each of the six evaluations
  against the plain bf16-conv evaluation at the stage input that the
  build's own earlier stages give (no cascade: one evaluation's flips), and
  ``combined``, y1, y_mid and the ratio against the tableau's combinations
  of those stages (f32 reassociation).
- ``odefunc_bwd`` with ``precision='bf16'`` against ``odefunc_bwd_plain(...,
  precision='bf16')`` (autograd through the plain bf16 f): per output (dh,
  dt and each parameter leaf) the relative L2 of the bf16 build and of the
  f32 build, in u; and whether the bf16 build's f is the bf16 ODEfunc
  kernel's bit for bit and two launches give the same bits.  GroupNorm's
  backward widens a flipped rounding, so the f32 build lies 10–30 u from
  the plain bf16 VJP on dh, dt and the leaves of GN1, conv1 and GN2's bias
  (:data:`BWD_EARLY`), where the bar is held beside it; on the late leaves
  (GN2's scale, conv2, GN3) bf16 and f32 read alike (0.5–2.2 u), and the
  bar there is absolute.  The bars come from a card run (NVIDIA H100 80GB
  HBM3, 700 W): the bf16 build read at most 0.77 u at 7×7×64 (B = 2 to
  128), 6×6×64, 7×7×32 and 7×7×96 and 1.8 u at the widest maps (7×7×128
  and 7×7×512 at B = 32, 6×6×512 at B = 16) on the early outputs, at most
  0.62 u on the late leaves; the f32 build read 4.1–19.6 u on the early
  outputs.  Where each GroupNorm group is one channel (C =
  groups) the conv biases have no gradient (the GroupNorm after each conv
  removes a per-channel constant): both sides read rounding noise, and
  those two outputs are left out.

:func:`check` holds readings to :data:`BARS` and to their f32 controls:
the bf16 build lies within each bar and the f32 build beyond it (the
``odefunc`` per-row bar, which both builds meet, and the backward's late
leaves excepted), and each output of the bf16 step lies nearer to the plain
bf16 step than the f32 build's.
Prints the card's name and power limit, then one JSON line per shape and
batch, with what breaks a bar under ``fails``.  The inputs are seeded (the
ODEfunc of ``init_odenet`` at each width, seed 11).
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from .. import _device
from ..kernels import odefunc as odefunc_mod
from ..kernels import rk_step
from ..kernels.odefunc import (
    PARAM_KEYS,
    bf16_round,
    odefunc,
    odefunc_plain,
    prepare,
)
from ..kernels.odefunc_bwd import odefunc_bwd, odefunc_bwd_plain
from ..kernels.rk_step import dopri5_step_plain
from ..models import ModelConfig, init_odenet
from ..rk_attempt import _rk_attempt, _rms, _tol_column
from ..tableau import DOPRI5

U = 2.0 ** -8
STEP_KEYS = ("y1", "f1", "y_mid", "ratio")
BARS = {
    "f_u_per_row": 4.0,   # odefunc: u of the plain f's max-norm per row
    "f_rel_u": 0.5,       # odefunc: relative L2
    "stage_u": 0.25,      # rk_step: each evaluation given its stage input
    "combined_u": 0.001,  # rk_step: y1, y_mid, ratio given the stages
    "bwd_u": 2.5,         # odefunc_bwd: relative L2 of dh, dt, early leaves
    "bwd_late_u": 1.0,    # odefunc_bwd: the late leaves, absolute
}
# The backward's outputs where the f32 build lies far from the plain bf16
# VJP (the module docstring): the bar is held below the f32 build there.
BWD_EARLY = ("dh", "dt", "norm1.scale", "norm1.bias", "conv1.kernel",
             "conv1.bias", "norm2.bias")


def rel_u(got: torch.Tensor, want: torch.Tensor) -> float:
    """Relative L2 of ``got`` against ``want``, in u."""
    d = (got.double() - want.double()).norm() / want.double().norm()
    return float(d) / U


def u_per_row(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got − want| per row in u of the row's max-norm."""
    d = (got - want).abs().flatten(1).amax(1)
    return float((d / (U * want.abs().flatten(1).amax(1))).max())


def _bias_apart(conv2d):
    """``conv2d`` that rounds the conv's output before it adds the bias
    (the JAX jnp path's order), where one call rounds their sum."""
    def apart(params, x, **kw):
        out = conv2d({"kernel": params["kernel"],
                      "bias": torch.zeros_like(params["bias"])}, x, **kw)
        return out + params["bias"].to(out.dtype)
    return apart


def odefunc_readings(w, t, h, groups: int) -> dict:
    """The bf16 ODEfunc build and the f32 build against the plain bf16 f;
    ``kernel_rel_u_bias_apart``: the kernel against the plain bf16 f with
    each conv's bias added after the conv's rounding (which of the two
    orders the plain version's library takes)."""
    want = odefunc_plain(w, t, h, groups, "bf16")
    got = odefunc(w, t, h, groups=groups, compute_dtype=torch.bfloat16)
    f32 = odefunc(w, t, h, groups=groups)
    real = odefunc_mod.conv2d
    odefunc_mod.conv2d = _bias_apart(real)
    try:
        apart = odefunc_plain(w, t, h, groups, "bf16")
    finally:
        odefunc_mod.conv2d = real
    return {"bf16_values": bool(torch.equal(got, bf16_round(got))),
            "max_abs_err": float((got - want).abs().max()),
            **{f"{name}_{k}": fn(out, want)
               for name, out in (("kernel", got), ("f32", f32))
               for k, fn in (("u_per_row", u_per_row), ("rel_u", rel_u))},
            "kernel_rel_u_bias_apart": rel_u(got, apart)}


def _attempt(w, t0, dt, y0, f0, *, hw, groups: int, rtol, atol,
             precision: str):
    """One dopri5 attempt of the fused step's build ``precision`` ('f32',
    'bf16'): ``(y1, f1, y_mid, ratio)`` and its seven stage derivatives
    k1 = f0, k2..k6, k7 = f1.  On a CUDA tensor one launch of the kernel,
    its scratch read back; on a CPU tensor the plain version."""
    b, n = y0.shape
    if y0.is_cuda:
        ks = torch.empty((DOPRI5.stages - 2, b, n), dtype=y0.dtype,
                         device=y0.device)
        out = rk_step.launch(w, t0, dt, y0, f0,
                             rk_step.tolerance_rows(rtol, y0),
                             rk_step.tolerance_rows(atol, y0), hw, groups,
                             precision, ks=ks)
        return out, [f0, *ks.unbind(0), out[1]]
    ks = [f0]
    conv = "bf16_conv" if precision == "bf16" else "f32"

    def func(t, y):
        ks.append(odefunc_plain(w, t, y.reshape(b, *hw, -1), groups,
                                conv).reshape(b, n))
        return ks[-1]
    return _combine(func, t0, dt, y0, f0, rtol, atol), ks


def _combine(func, t0, dt, y0, f0, rtol, atol):
    """``(y1, f1, y_mid, ratio)`` of one dopri5 attempt whose stages are
    ``func``'s, combined as the plain version combines them."""
    b = y0.shape[0]
    y1, err, f1, _, y_mid = _rk_attempt(DOPRI5, func, t0, dt, y0, f0)
    scale = (_tol_column(atol, b, y0.dtype, y0.device)
             + _tol_column(rtol, b, y0.dtype, y0.device)
             * torch.maximum(y0.abs(), y1.abs()))
    return y1, f1, y_mid, _rms(err / scale)


def step_readings(w, t0, dt, y0, f0, *, hw, groups: int, rtol,
                  atol) -> dict:
    """The bf16 fused step and its f32 build against the plain bf16 step,
    per output in u; ``stages``: each build's six evaluations against the
    plain bf16-conv evaluation at the stage input its own earlier stages
    give; ``combined``: the bf16 build's outputs against the tableau's
    combinations of its own stages (module docstring)."""
    kw = dict(hw=hw, groups=groups, rtol=rtol, atol=atol)
    want = dopri5_step_plain(w, DOPRI5, t0, dt, y0, f0,
                             conv_precision="bf16", **kw)
    out = {"stages": {}}
    for name, precision in (("kernel", "bf16"), ("f32", "f32")):
        got, ks = _attempt(w, t0, dt, y0, f0, precision=precision, **kw)
        for k, g, r in zip(STEP_KEYS, got, want):
            out.setdefault(k, {})[name] = rel_u(g, r)
        rest, evals = iter(ks[1:]), []

        def given(t, y):
            evals.append(odefunc_plain(w, t, y.reshape(y0.shape[0], *hw, -1),
                                       groups, "bf16_conv"))
            return next(rest)
        combined = _combine(given, t0, dt, y0, f0, rtol, atol)
        out["stages"][name] = [rel_u(k.reshape(e.shape), e)
                               for k, e in zip(ks[1:], evals)]
        if name == "kernel":
            out["max_abs_err"] = float((got[0] - want[0]).abs().max())
            out["combined"] = {k: rel_u(g, c) for k, g, c in
                               zip(STEP_KEYS, got, combined) if k != "f1"}
    return out


def _bwd_outputs(res) -> dict:
    """``odefunc_bwd``'s ``(dparams, dt, dh, f)`` by output name."""
    dparams, dt, dh, _ = res
    return {"dh": dh, "dt": dt,
            **{f"{a}.{b}": dparams[a][b] for a, b in PARAM_KEYS}}


def bwd_readings(w, t, h, g, groups: int) -> dict:
    """The bf16 backward build and the f32 build against the plain bf16
    VJP at ``(w, t, h)`` and cotangent ``g``, per output in u; ``f_equal``:
    the bf16 build's f is the bf16 ODEfunc kernel's bit for bit;
    ``repeatable``: a second launch gives the same bits;
    ``bf16_values``: f, dh, dt and every leaf but the conv kernels' time
    column hold bf16 values."""
    want = _bwd_outputs(odefunc_bwd_plain(w, t, h, g, groups, True, "bf16"))
    runs = [odefunc_bwd(w, t, h, g, groups=groups, with_f=True,
                        precision=p) for p in ("bf16", "bf16", "f32")]
    got, again = _bwd_outputs(runs[0]), _bwd_outputs(runs[1])
    f32 = _bwd_outputs(runs[2])
    if h.shape[-1] == groups:  # zero in exact arithmetic (docstring)
        for k in ("conv1.bias", "conv2.bias"):
            del want[k], got[k], again[k], f32[k]
    fwd = odefunc(w, t, h, groups=groups, compute_dtype=torch.bfloat16)
    values = [runs[0][3], *(v[:, :, 1:] if k.endswith("kernel") else v
                            for k, v in got.items())]
    return {"f_equal": bool(torch.equal(runs[0][3], fwd)),
            "repeatable": all(torch.equal(got[k], again[k]) for k in got)
            and torch.equal(runs[0][3], runs[1][3]),
            "bf16_values": all(torch.equal(v, bf16_round(v))
                               for v in values),
            "max_abs_err": max(float((got[k] - want[k]).abs().max())
                               for k in got),
            "outputs": {k: {"kernel": rel_u(got[k], want[k]),
                            "f32": rel_u(f32[k], want[k])} for k in got}}


def check(readings: dict) -> list[str]:
    """What in ``readings`` (of :func:`odefunc_readings` or
    :func:`step_readings`) breaks :data:`BARS` or its control; empty if
    nothing does.  A NaN reading breaks its bar."""
    bad = []

    def hold(name, kernel, bar, f32):
        if not kernel <= bar < f32:
            bad.append(f"{name}: bf16 build {kernel:.4g} u, bar {bar:.4g} u, "
                       f"f32 build {f32:.4g} u (want bf16 <= bar < f32)")

    if "outputs" in readings:
        for k in ("f_equal", "repeatable", "bf16_values"):
            if not readings[k]:
                bad.append(f"odefunc_bwd: {k} is false")
        for k, r in readings["outputs"].items():
            if k in BWD_EARLY:
                hold(f"odefunc_bwd {k}", r["kernel"], BARS["bwd_u"], r["f32"])
            elif not r["kernel"] <= BARS["bwd_late_u"]:
                bad.append(f"odefunc_bwd {k}: bf16 build {r['kernel']:.4g} "
                           f"u, bar {BARS['bwd_late_u']} u")
        return bad
    if "kernel_rel_u" in readings:
        if not readings["bf16_values"]:
            bad.append("odefunc: the bf16 build's values are not bf16")
        if not readings["kernel_u_per_row"] <= BARS["f_u_per_row"]:
            bad.append(f"odefunc: {readings['kernel_u_per_row']:.4g} u per "
                       f"row, bar {BARS['f_u_per_row']}")
        hold("odefunc rel-L2", readings["kernel_rel_u"], BARS["f_rel_u"],
             readings["f32_rel_u"])
        return bad
    st = readings["stages"]
    hold("rk_step stages", max(st["kernel"]), BARS["stage_u"], min(st["f32"]))
    for k, v in readings["combined"].items():
        if not v <= BARS["combined_u"]:
            bad.append(f"rk_step {k}: {v:.4g} u from the combination of its "
                       f"own stages, bar {BARS['combined_u']}")
    for k in STEP_KEYS:
        if not readings[k]["kernel"] < readings[k]["f32"]:
            bad.append(f"rk_step {k}: the bf16 build {readings[k]['kernel']:.4g}"
                       f" u from the plain bf16 step, the f32 build "
                       f"{readings[k]['f32']:.4g} u (want it nearer)")
    return bad


def shape_inputs(hh: int, ww: int, c: int, batch: int, device, seed=11):
    """The laid-out ODEfunc weights at hidden ``c`` and seeded ``h``, ``t``
    (U(0, 0.5)) and ``dt`` (U(0.05, 0.2)), B = ``batch``."""
    cfg = ModelConfig(in_channels=3, hidden=c, groups=32)
    w = prepare(init_odenet(seed, cfg, device=device)["odefunc"], (hh, ww))
    rng = np.random.default_rng(seed)

    def arr(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    h = arr(rng.normal(size=(batch, hh, ww, c)) * 0.3)
    return w, h, arr(rng.uniform(0.0, 0.5, batch)), arr(
        rng.uniform(0.05, 0.2, batch))


def readings_at(hh: int, ww: int, c: int, batch: int, device,
                tol: float = 1e-3) -> dict:
    """Both builds' readings at one shape and batch (groups 32)."""
    w, h, t, dt = shape_inputs(hh, ww, c, batch, device)
    f0 = odefunc_plain(w, t, h, 32).reshape(batch, -1)
    g = torch.from_numpy(np.random.default_rng(12).normal(
        size=tuple(h.shape)).astype(np.float32)).to(h.device)
    return {"shape": f"{hh}x{ww}x{c}", "batch": batch,
            "odefunc": odefunc_readings(w, t, h, 32),
            "odefunc_bwd": bwd_readings(w, t, h, g, 32),
            "rk_step": step_readings(w, t, dt, h.reshape(batch, -1), f0,
                                     hw=(hh, ww), groups=32, rtol=tol,
                                     atol=tol)}


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--shapes", default="7x7x32,7x7x64,7x7x128,7x7x512,6x6x64",
                   help="comma-separated HxWxC")
    p.add_argument("--batch", default="5,32,256",
                   help="comma-separated batch sizes")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the plain versions: every kernel "
                        "distance reads 0)")
    args = p.parse_args(argv)
    dev = _device.strict_f32("cpu" if args.cpu else "cuda")
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip()
        print(f"=== bf16_distances on {smi} ===")
    rows = []
    for shape in filter(None, args.shapes.split(",")):
        hh, ww, c = (int(v) for v in shape.split("x"))
        for batch in (int(v) for v in args.batch.split(",")):
            row = readings_at(hh, ww, c, batch, dev)
            row["fails"] = (check(row["odefunc"]) + check(row["rk_step"])
                            + check(row["odefunc_bwd"]))
            rows.append(row)
            print(json.dumps(row))
    return rows


if __name__ == "__main__":
    main()
