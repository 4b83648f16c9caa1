"""Port parity, the bf16 builds of the kernels on the CPU: the plain
versions of the fused step's ``conv_precision='bf16'``, of the conv probe's
``*_bf16`` strategies and of the bf16 VJP against the JAX package, the
arithmetic of the bf16 conv stage and of the ``compute_dtype='bfloat16'``
ODEfunc kernel and its backward emulated in plain PyTorch against the plain
bf16 path, and the routes of the bf16 paths to the bf16 builds on the card.
The kernels themselves run only on the card (``tests/test_torch_cuda.py``).

Units.  bf16 keeps an 8-bit significand: one rounding is off by up to
u = 2^-8 of its value.  Two computations of the same bf16 function that
differ only in f32 summation order round alike almost everywhere; where an
f32 value lies within its reassociation error of a bf16 rounding boundary
the two round it to neighbouring bf16 values, one ulp apart, and GroupNorm
carries that step on.  So the bf16 comparisons are in units of u of the
compared value's size (its max-norm per row, or its L2 norm), not at the f32
reassociation tolerance, and each bar is set from what the packages showed
on these seeded inputs.
"""

import collections
import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from torch.utils import _pytree as pytree

from neural_ode_features_tpu.kernels.rk_step_pallas import (
    make_fused_dopri5_step as jax_make_fused_step,
)
from neural_ode_features_tpu.models import ModelConfig as JaxConfig
from neural_ode_features_tpu.models import init_odenet as jax_init_odenet
from neural_ode_features_tpu.models.odenet import odefunc_apply as jax_odefunc
from neural_ode_features_tpu.solver.tableau import DOPRI5 as JAX_DOPRI5
from neural_ode_features_tpu_torch import export_model, serve
from neural_ode_features_tpu_torch.entry import ENTRY_CONFIG
from neural_ode_features_tpu_torch.kernels import odefunc as odefunc_mod
from neural_ode_features_tpu_torch.kernels.conv3x3 import (
    BF16_STRATEGIES,
    conv3x3,
    conv3x3_plain,
)
from neural_ode_features_tpu_torch.kernels.odefunc import (
    bf16_round,
    odefunc,
    odefunc_plain,
    prepare,
)
from neural_ode_features_tpu_torch.kernels import odefunc_bwd as bwd_mod
from neural_ode_features_tpu_torch.kernels.odefunc_bwd import (
    _raw_grads,
    odefunc_bwd,
    odefunc_bwd_plain,
)
from neural_ode_features_tpu_torch.kernels.rk_step import (
    dopri5_step,
    dopri5_step_plain,
    make_fused_dopri5_step,
)
from neural_ode_features_tpu_torch.models import (
    ModelConfig,
    fused_rk_eligible,
    init_odenet,
    odefunc_apply,
    odenet_logits,
)
from neural_ode_features_tpu_torch.ops import layers
from neural_ode_features_tpu_torch.probes import bf16_distances, conv_probe
from neural_ode_features_tpu_torch.solver import DOPRI5
from neural_ode_features_tpu_torch.training import TrainConfig, Trainer
from neural_ode_features_tpu_torch.utils import checkpoint as checkpoint_mod
from neural_ode_features_tpu_torch.utils import (
    from_jax_params,
    save_checkpoint,
)

torch.set_num_threads(2)

U = 2.0 ** -8
RTOL = ATOL = 1e-3
CONV_TOL = dict(rtol=1e-5, atol=1e-6)   # sums of 576 exact products, reordered
# The bf16 step against another ordering of its f32 sums (the JAX bf16 step
# here, the kernel on the card), relative L2 per output (module docstring).
# The operand roundings make the step's outputs jump where a reassociated
# f32 value straddles a bf16 boundary, and the jumps cascade over its six
# evaluations, the more the wider the map: chip_smoke.py [bf16] prints the
# plain step's own jump when each GroupNorm output moves by one f32 ulp
# beside the kernel's distance.  y1 and y_mid take the jumps through
# h·Σ b_j k_j, f1 = f(y1) its own evaluation's, the ratio is the small
# difference of two orders; the bf16 and the f32 step lie further apart
# than each bar.
STEP_BARS = {"y1": U / 4, "f1": U / 2, "y_mid": U / 8, "ratio": U}
ODEFUNC_U_BAR = 4.0   # kernel arithmetic vs the plain bf16 f, u per row
NFE_SHARE = 1.0       # per-sample NFE equal to the plain path's, B = 256


@pytest.fixture(scope="module")
def odefunc_params():
    cfg = JaxConfig(in_channels=3)
    pj = jax_init_odenet(jax.random.PRNGKey(0), cfg)["odefunc"]
    return cfg, pj, from_jax_params(pj, device="cpu")


def _state(seed, b, side, scale=0.3):
    return (np.random.default_rng(seed).normal(size=(b, side, side, 64))
            * scale).astype(np.float32)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---- (a) the fused step, conv_precision='bf16' ------------------------------


@pytest.mark.parametrize("batch,side", [(4, 7), (3, 6), (2, 7)])
def test_bf16_step_plain_matches_jax(odefunc_params, batch, side):
    """``dopri5_step_plain(conv_precision='bf16')`` against the JAX fused
    step with ``conv_precision='bf16'`` (rollS, interpret mode) within
    ``STEP_BARS``; the JAX step's f32 and bf16 outputs differ by more than
    each bar, so the test tells the two modes apart."""
    cfg, pj, pt = odefunc_params
    h = _state(3, batch, side)
    rng = np.random.default_rng(4)
    t0 = rng.uniform(0.0, 0.5, batch).astype(np.float32)
    dt = rng.uniform(0.05, 0.2, batch).astype(np.float32)
    f0 = np.array(jax_odefunc(pj, jnp.asarray(t0), jnp.asarray(h), cfg))
    args = (t0, dt, h.reshape(batch, -1), f0.reshape(batch, -1))

    def jax_step(precision):
        return [np.asarray(o).reshape(batch, -1) for o in jax_make_fused_step(
            pj, JAX_DOPRI5, (side, side), groups=cfg.groups, rtol=RTOL,
            atol=ATOL, interpret=True, conv_strategy="rollS", tile=batch,
            conv_precision=precision)(*(jnp.asarray(a) for a in args))]

    want, want32 = jax_step("bf16"), jax_step("f32")
    w = prepare(pt, (side, side))
    targs = [torch.from_numpy(a) for a in args]
    got = dopri5_step_plain(w, DOPRI5, *targs, hw=(side, side),
                            groups=cfg.groups, rtol=RTOL, atol=ATOL,
                            conv_precision="bf16")
    for name, g, wb, w32 in zip(STEP_BARS, got, want, want32):
        g = g.numpy().reshape(batch, -1)
        assert _rel_l2(g, wb) <= STEP_BARS[name], (name, _rel_l2(g, wb))
        assert _rel_l2(w32, wb) > STEP_BARS[name], (name, _rel_l2(w32, wb))
    # make_fused_dopri5_step and the wrapper take the same plain version.
    fused = make_fused_dopri5_step(pt, DOPRI5, (side, side), rtol=RTOL,
                                   atol=ATOL, conv_precision="bf16")
    wrapped = dopri5_step(w, DOPRI5, *targs, hw=(side, side),
                          groups=cfg.groups, rtol=RTOL, atol=ATOL,
                          conv_precision="bf16")
    for a, b, c in zip(fused(*targs), wrapped, got):
        assert torch.equal(a, c) and torch.equal(b, c)


# ---- (b) the probe's bf16 twins ---------------------------------------------


@pytest.mark.parametrize("batch,side,c", [(5, 7, 64), (3, 6, 64), (2, 7, 32)])
def test_bf16_conv_plain_matches_jax(batch, side, c):
    """``conv3x3_plain(passes="bf16")``, the plain version of the bf16
    strategies, against the JAX probe's ``_bf16`` arithmetic:
    ``lax.conv_general_dilated`` on bf16 operands with
    ``preferred_element_type=float32`` (``probes/conv_probe.py`` xla_conv).
    The operands round alike, so the bar is f32 reassociation; the f32 conv
    lies far outside it."""
    x, w = conv_probe.probe_inputs(batch, "cpu", (side, side), c)
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(x.numpy()).astype(jnp.bfloat16),
        jnp.asarray(w.numpy()).astype(jnp.bfloat16), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32))
    got = conv3x3_plain(x, w, passes="bf16")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **CONV_TOL)
    assert not np.allclose(conv3x3_plain(x, w).numpy(), want, **CONV_TOL)
    for strategy in BF16_STRATEGIES:  # the wrapper on the CPU
        assert torch.equal(conv3x3(x, w, strategy), got)


# ---- (c) the kernels' bf16 arithmetic, emulated -----------------------------


def _kernel_conv2d(original, bias_rounding: str):
    """``ops.layers.conv2d`` with each bf16 3×3 C → C conv (the ODEfunc's
    two) computed as the bf16 conv stage computes it: operands rounded to
    bf16 (they are), the nine taps' exact products summed in f32, then the
    conv output rounded before a bf16 bias add (``bias_rounding=
    'separate'``: the kernel's epilogue, where cuDNN's bf16 conv and the
    bias add round on the card and the JAX jnp path rounds), or the bias
    added in f32 before one rounding (``'fused'``: where the CPU library's
    bf16 conv rounds, so that only the summation order differs from the CPU
    plain version, as between the kernel and its plain version on the
    card)."""

    def conv2d(params, x, *, stride=1, padding="SAME"):
        k = params["kernel"]
        if (tuple(k.shape[:2]) == (3, 3) and k.shape[2] == k.shape[3]
                == x.shape[-1] and stride == 1 and padding == 1
                and x.dtype == torch.bfloat16):
            conv2d.calls += 1
            acc = conv3x3_plain(x.float(), bf16_round(k.float()))
            if bias_rounding == "separate":
                acc = bf16_round(acc)
            return (acc + bf16_round(params["bias"].float())).to(x.dtype)
        return original(params, x, stride=stride, padding=padding)

    conv2d.calls = 0
    return conv2d


def _u_per_row(got, want) -> float:
    """Largest |got − want| per row in units of u of the row's max-norm."""
    d = (got - want).abs().flatten(1).amax(1)
    return float((d / (U * want.abs().flatten(1).amax(1))).max())


@pytest.mark.parametrize("bias_rounding,bar", [
    ("fused", ODEFUNC_U_BAR), ("separate", 2 * ODEFUNC_U_BAR)])
def test_bf16_kernel_arithmetic_against_the_plain_path(odefunc_params,
                                                       monkeypatch,
                                                       bias_rounding, bar):
    """The bf16 ODEfunc kernel's arithmetic (``_kernel_conv2d`` in the
    plain bf16 path, whose other roundings are the kernel's) against the
    CPU's plain bf16 f, in u of each row's max-norm: with the CPU's own
    rounding points within ``ODEFUNC_U_BAR`` (the card's bar, where kernel
    and plain version round at the same points), with the kernel's within
    twice that (a rounding point apart).  Then a solve of the entry model at
    B = 256 through it: per-sample NFE equal to the plain path's on
    ``NFE_SHARE`` of the rows (the card's NFE bar), top-1 equal."""
    cfg, pj, pt = odefunc_params
    h = torch.from_numpy(_state(5, 16, 7, scale=1.0))
    t = torch.from_numpy(
        np.random.default_rng(6).uniform(0, 1, 16).astype(np.float32))
    w = prepare(pt, (7, 7))
    want = odefunc_plain(w, t, h, cfg.groups, "bf16")
    emulated = _kernel_conv2d(layers.conv2d, bias_rounding)
    monkeypatch.setattr(odefunc_mod, "conv2d", emulated)
    got = odefunc_plain(w, t, h, cfg.groups, "bf16")
    assert emulated.calls == 2
    err_u = _u_per_row(got, want)
    assert 0.0 < err_u <= bar, err_u
    monkeypatch.undo()

    cfg16 = dataclasses.replace(ENTRY_CONFIG, compute_dtype="bfloat16")
    params = from_jax_params(jax_init_odenet(jax.random.PRNGKey(7),
                                             JaxConfig(in_channels=3)),
                             device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(256, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        logits, stats = odenet_logits(params, x, cfg16)
        monkeypatch.setattr(layers, "conv2d",
                            _kernel_conv2d(layers.conv2d, bias_rounding))
        logits_k, stats_k = odenet_logits(params, x, cfg16)
    share = float((stats_k.nfe == stats.nfe).float().mean())
    assert share >= NFE_SHARE, share
    assert torch.equal(logits_k.argmax(1), logits.argmax(1))
    assert bool(stats.success.all() and stats_k.success.all())


def test_bf16_plain_is_the_model_path(odefunc_params):
    """The plain version of the bf16 ODEfunc kernel (the CPU side of
    ``nodef::odefunc_bf16``) is the model's CPU bf16 dynamics bit for bit,
    on raw or laid-out weights, and differs from the f32 f.  It rounds the
    weights itself (as the kernel does), so weights rounded beforehand give
    the same f: both builds take the one f32 layout."""
    cfg, _, pt = odefunc_params
    cfg16 = ModelConfig(in_channels=3, compute_dtype="bfloat16")
    h = torch.from_numpy(_state(7, 4, 6, scale=1.0))
    t = torch.tensor([0.0, 0.3, 0.61, 1.0])
    want = odefunc_apply(pt, t, h, cfg16)
    w = prepare(pt, (6, 6))
    rounded = type(w)(*(bf16_round(a) for a in w))
    for w_ in (w, rounded):
        assert torch.equal(odefunc_plain(w_, t, h, cfg.groups, "bf16"), want)
    wrapped = odefunc(pt, t, h, groups=cfg.groups,
                      compute_dtype=torch.bfloat16)
    assert torch.equal(wrapped, want) and wrapped.dtype == torch.float32
    assert torch.equal(wrapped, bf16_round(wrapped))  # bf16 values in f32
    f32 = odefunc(pt, t, h, groups=cfg.groups)
    assert float((f32 - want).abs().max()) > U * float(want.abs().max()) / 8


def _kernel_vjp(w, t, h, g, groups, bias_rounding):
    """The bf16 backward kernel's arithmetic in plain PyTorch: the forward
    recomputed at the bf16 ODEfunc kernel's rounding points (each conv's
    bias added after its rounding, ``bias_rounding='separate'``, or before
    it, ``'fused'``: where the CPU library's bf16 conv rounds), then the
    kernel's backward: the cotangent rounded; per GroupNorm dscale = Σ
    bf16(dy·bf16(x̂)), dbias = Σ dy, dy·scale rounded per element, the f32
    statistics backward, dx rounded; the ReLU masks of the bf16 outputs;
    each input-gradient conv's f32 sum of exact bf16 products, rounded; the
    time-map products g·bf16(M) and g·t rounded; each sum over the batch in
    f32 and rounded once (the time column's not).  Returns
    ``(dparams raw, dt, dh, f)``."""
    b, hh, ww, c = h.shape
    shp = (b, hh, ww, groups, c // groups)
    t16 = bf16_round(t.reshape(-1).expand(b)).reshape(b, 1, 1, 1)

    def gn(x, scale, bias):
        d = x.reshape(shp) - x.reshape(shp).mean(dim=(1, 2, 4), keepdim=True)
        inv = torch.rsqrt((d * d).mean(dim=(1, 2, 4), keepdim=True) + 1e-5)
        xh = (d * inv).reshape(x.shape)
        y = bf16_round(bf16_round(bf16_round(xh) * bf16_round(scale))
                       + bf16_round(bias))
        return y, xh, inv

    def conv(x, k, bias, m):
        acc = conv3x3_plain(x, bf16_round(k))
        if bias_rounding == "separate":
            acc = bf16_round(acc)
        acc = bf16_round(acc + bf16_round(bias))
        return bf16_round(acc + bf16_round(t16 * bf16_round(m)))

    def gn_bwd(dy, xh, inv, scale):
        dscale = bf16_round(bf16_round(dy * bf16_round(xh)).sum((0, 1, 2)))
        dbias = bf16_round(dy.sum((0, 1, 2)))
        dys = bf16_round(dy * bf16_round(scale)).reshape(shp)
        xg = xh.reshape(shp)
        dx = inv * (dys - dys.mean(dim=(1, 2, 4), keepdim=True)
                    - xg * (dys * xg).mean(dim=(1, 2, 4), keepdim=True))
        return bf16_round(dx.reshape(dy.shape)), dscale, dbias

    def conv_bwd(gout, r, k, m):
        nchw = gout.permute(0, 3, 1, 2)
        dw = torch.nn.grad.conv2d_weight(r.permute(0, 3, 1, 2), (c, c, 3, 3),
                                         nchw, padding=1)
        gin = torch.nn.grad.conv2d_input(
            nchw.shape, bf16_round(k).permute(3, 2, 0, 1), nchw, padding=1)
        return (bf16_round(gin.permute(0, 2, 3, 1)),
                bf16_round(dw.permute(2, 3, 1, 0)),
                bf16_round(gout.sum((0, 1, 2))),
                bf16_round(gout * t16).sum(0),
                bf16_round(bf16_round(gout * bf16_round(m)).sum((1, 2, 3))))

    y1, xh1, inv1 = gn(bf16_round(h), w.n1s, w.n1b)
    r1 = torch.relu(y1)
    y2, xh2, inv2 = gn(conv(r1, w.w1, w.b1, w.m1), w.n2s, w.n2b)
    r2 = torch.relu(y2)
    f, xh3, inv3 = gn(conv(r2, w.w2, w.b2, w.m2), w.n3s, w.n3b)
    gv, d3s, d3b = gn_bwd(bf16_round(g), xh3, inv3, w.n3s)
    gr2, dw2, db2, dm2, dt2 = conv_bwd(gv, r2, w.w2, w.m2)
    gu, d2s, d2b = gn_bwd(torch.where(y2 > 0, gr2, 0.0), xh2, inv2, w.n2s)
    gr1, dw1, db1, dm1, dt1 = conv_bwd(gu, r1, w.w1, w.m1)
    dh, d1s, d1b = gn_bwd(torch.where(y1 > 0, gr1, 0.0), xh1, inv1, w.n1s)
    d = odefunc_mod.OdefuncWeights(d1s, d1b, dw1, db1, dm1, d2s, d2b, dw2,
                                   db2, dm2, d3s, d3b)
    return _raw_grads(d), bf16_round(dt2 + dt1), dh, f


def _vjp_outputs(res) -> dict:
    """``(dparams, dt, dh[, f])`` by output name (leaves ``norm1.scale``
    ...)."""
    dparams, dt, dh = res[:3]
    return {"dh": dh, "dt": dt, **{f"{a}.{k}": v for a, d in dparams.items()
                                  for k, v in d.items()}}


@pytest.mark.parametrize("bias_rounding,side,batch", [
    ("fused", 7, 16), ("separate", 6, 5)])
def test_bf16_backward_arithmetic_against_the_plain_path(odefunc_params,
                                                         monkeypatch,
                                                         bias_rounding,
                                                         side, batch):
    """The bf16 backward kernel's arithmetic (:func:`_kernel_vjp`) against
    the plain bf16 VJP (autograd through ``odefunc_plain(..., 'bf16')``),
    each output in u of relative L2, at the conv bias's rounding point of
    the plain version's library: the CPU's (``'fused'``), and the card's
    (``'separate'``, the plain version with the bias added after the conv's
    rounding, ``bf16_distances._bias_apart``).  Every output lies within the
    card's early-output bar (``bf16_distances.BARS['bwd_u']``), f within
    the bf16 ODEfunc kernel's (``'f_rel_u'``), and the f32 VJP lies beyond
    the bar on dh and the early leaves."""
    cfg, _, pt = odefunc_params
    rng = np.random.default_rng(8)
    h = torch.from_numpy(_state(8, batch, side))
    g = torch.from_numpy(rng.normal(size=h.shape).astype(np.float32))
    t = torch.from_numpy(rng.uniform(0, 1, batch).astype(np.float32))
    w = prepare(pt, (side, side))
    f32 = _vjp_outputs(odefunc_bwd_plain(w, t, h, g, cfg.groups))
    if bias_rounding == "separate":
        monkeypatch.setattr(odefunc_mod, "conv2d",
                            bf16_distances._bias_apart(layers.conv2d))
    want = odefunc_bwd_plain(w, t, h, g, cfg.groups, True, "bf16")
    got = _kernel_vjp(w, t, h, g, cfg.groups, bias_rounding)
    assert (bf16_distances.rel_u(got[3], want[3])
            <= bf16_distances.BARS["f_rel_u"])
    bar = bf16_distances.BARS["bwd_u"]
    want, got = _vjp_outputs(want), _vjp_outputs(got)
    for k in want:
        err = bf16_distances.rel_u(got[k], want[k])
        assert err <= bar, (k, err)
        if k in bf16_distances.BWD_EARLY:
            assert bf16_distances.rel_u(f32[k], want[k]) > bar, k


# The plain bf16 VJP against JAX's jax.vjp of the jnp bf16 dynamics, per
# output in u of relative L2 (the entry ODEfunc at PRNGKey(0); h ~
# 0.3·N(0, 1), g ~ N(0, 1), numpy seed 1; t = 0.37).  The packages round
# at other points (XLA keeps f32 inside a fusion) and GroupNorm's backward
# widens that to several u: each bar is about 1.4 times this draw's
# reading, and on dh and the early leaves below the f32 VJP's distance
# from the same JAX VJP (asserted), which is 1.3–2.2 times the bf16
# reading; on the late leaves the two read alike, and the bar is absolute.
JAX_VJP_BARS = {
    (4, 7): {"dh": 11.6, "norm1.scale": 16.3, "norm1.bias": 18.2,
             "conv1.kernel": 12.9, "conv1.bias": 20.3, "norm2.bias": 15.1,
             "norm2.scale": 4.1, "conv2.kernel": 1.9, "conv2.bias": 6.3,
             "norm3.scale": 6.6, "norm3.bias": 5.4},
    (3, 6): {"dh": 8.0, "norm1.scale": 8.2, "norm1.bias": 9.1,
             "conv1.kernel": 8.3, "conv1.bias": 11.4, "norm2.bias": 10.5,
             "norm2.scale": 4.7, "conv2.kernel": 1.8, "conv2.bias": 4.6,
             "norm3.scale": 5.0, "norm3.bias": 4.0},
}
JAX_VJP_EARLY = ("dh", "norm1.scale", "norm1.bias", "conv1.kernel",
                 "conv1.bias", "norm2.bias")


@pytest.mark.parametrize("batch,side", [(4, 7), (3, 6)])
def test_bf16_plain_vjp_matches_jax(batch, side):
    """``odefunc_bwd_plain(..., precision='bf16')``, the plain version of
    the bf16 backward kernel, against ``jax.vjp`` of the JAX jnp bf16
    dynamics within :data:`JAX_VJP_BARS`, each early bar below the f32
    VJP's distance."""
    jcfg = JaxConfig(in_channels=3, compute_dtype="bfloat16")
    pj = jax_init_odenet(jax.random.PRNGKey(0), jcfg)["odefunc"]
    pt = from_jax_params(pj, device="cpu")
    rng = np.random.default_rng(1)
    h = (rng.normal(size=(batch, side, side, 64)) * 0.3).astype(np.float32)
    g = rng.normal(size=h.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda p, x: jax_odefunc(p, jnp.float32(0.37), x, jcfg),
                     pj, jnp.asarray(h))
    dpj, dhj = vjp(jnp.asarray(g))
    want = {"dh": torch.from_numpy(np.asarray(dhj)),
            **{f"{a}.{k}": torch.from_numpy(np.asarray(v))
               for a, d in dpj.items() for k, v in d.items()}}
    w = prepare(pt, (side, side))
    args = (w, torch.tensor(0.37), torch.from_numpy(h), torch.from_numpy(g),
            32, False)
    got = _vjp_outputs(odefunc_bwd_plain(*args, "bf16"))
    f32 = _vjp_outputs(odefunc_bwd_plain(*args, "f32"))
    for k, bar in JAX_VJP_BARS[(batch, side)].items():
        err = bf16_distances.rel_u(got[k], want[k])
        assert err <= bar, (k, err, bar)
        if k in JAX_VJP_EARLY:
            assert bar < bf16_distances.rel_u(f32[k], want[k]), k


# ---- the card's bf16 bars and their f32 controls ---------------------------


@pytest.mark.parametrize("side,c,batch", [(7, 64, 4), (6, 32, 3)])
def test_bf16_bars_reject_the_f32_builds(side, c, batch):
    """``probes/bf16_distances.py`` on the CPU, where each build runs its
    plain version: the bf16 readings are 0 (the plain step's own stages
    give back its outputs exactly), each f32 control lies beyond its bar
    and :func:`check` passes; readings with the f32 build in the bf16
    build's place break the odefunc rel-L2 bar, the stage bar, the
    "nearer" rule for every step output (the per-row bar, which both
    builds meet, does not tell them apart) and the backward's bar on dh, dt
    and the early leaves."""
    check = bf16_distances.check
    r = bf16_distances.readings_at(side, side, c, batch, "cpu")
    f, s = r["odefunc"], r["rk_step"]
    assert f["kernel_rel_u"] == f["kernel_u_per_row"] == 0.0
    assert f["f32_rel_u"] > bf16_distances.BARS["f_rel_u"]
    assert max(s["stages"]["kernel"]) == 0.0
    assert min(s["stages"]["f32"]) > bf16_distances.BARS["stage_u"]
    assert not any(s["combined"].values())
    assert check(f) == [] and check(s) == []

    f_as_f32 = dict(f, kernel_rel_u=f["f32_rel_u"],
                    kernel_u_per_row=f["f32_u_per_row"])
    s_as_f32 = dict(s, stages={"kernel": s["stages"]["f32"],
                               "f32": s["stages"]["f32"]},
                    **{k: {"kernel": s[k]["f32"], "f32": s[k]["f32"]}
                       for k in bf16_distances.STEP_KEYS})
    assert [m.split(":")[0] for m in check(f_as_f32)] == ["odefunc rel-L2"]
    assert [m.split(":")[0] for m in check(s_as_f32)] == [
        "rk_step stages",
        *(f"rk_step {k}" for k in bf16_distances.STEP_KEYS)]
    # The backward: the bf16 readings 0, f bit-equal, repeatable, bf16
    # values; the f32 build in the bf16 build's place breaks the bar on dh,
    # dt and every early leaf.
    b = r["odefunc_bwd"]
    assert b["f_equal"] and b["repeatable"] and b["bf16_values"]
    assert max(v["kernel"] for v in b["outputs"].values()) == 0.0
    assert check(b) == []
    b_as_f32 = dict(b, outputs={k: {"kernel": v["f32"], "f32": v["f32"]}
                                for k, v in b["outputs"].items()})
    broken = {m.split(":")[0] for m in check(b_as_f32)}
    assert {f"odefunc_bwd {k}" for k in bf16_distances.BWD_EARLY
            if k in b["outputs"]} <= broken
    # A NaN reading breaks its bar, a late leaf's and the per-row bar's
    # among them.
    nan = float("nan")
    late = next(k for k in b["outputs"] if k not in bf16_distances.BWD_EARLY)
    b_nan = dict(b, outputs={**b["outputs"], late: {"kernel": nan,
                                                    "f32": nan}})
    assert [m.split(":")[0] for m in check(b_nan)] == [f"odefunc_bwd {late}"]
    assert [m.split(":")[0] for m in check(
        dict(f, kernel_u_per_row=nan))] == ["odefunc"]


# ---- (d) the routes to the bf16 builds ---------------------------------------


@pytest.fixture
def builds(monkeypatch):
    """The build each kernel wrapper is asked for, counted by (kernel,
    precision): the precision that picks the C entry point on the card
    (``odefunc_forward_bf16``, ``odefunc_backward_bf16``) picks the plain
    version's precision on the CPU, where the calls below run."""
    seen = collections.Counter()
    plain, bwd_plain = odefunc_mod.odefunc_plain, bwd_mod.odefunc_bwd_plain

    def forward(w, t, h, groups, precision="f32"):
        seen["odefunc", precision] += 1
        return plain(w, t, h, groups, precision)

    def backward(w, t, h, g, groups, with_f=False, precision="f32"):
        seen["odefunc_bwd", precision] += 1
        return bwd_plain(w, t, h, g, groups, with_f, precision)

    monkeypatch.setattr(odefunc_mod, "odefunc_plain", forward)
    monkeypatch.setattr(bwd_mod, "odefunc_bwd_plain", backward)
    return seen


@pytest.fixture(scope="module")
def bf16_run(tmp_path_factory):
    """A bf16 run directory (hidden 32, synthetic MNIST shapes) and its
    ``export-compiled`` artifact, exported on the CPU."""
    root = tmp_path_factory.mktemp("bf16_run")
    cfg = ModelConfig(in_channels=1, hidden=32, tol=1e-2,
                      compute_dtype="bfloat16")
    save_checkpoint(root / "run" / "ckpt_best.pt",
                    init_odenet(3, cfg, device="cpu"), cfg,
                    {"model": "odenet"})
    art = export_model.main(["export-compiled", "--run", str(root / "run"),
                             "--batch", "2", "--cpu", "--out",
                             str(root / "a.npexec")])
    return root / "run", art


class _Library:
    """Stands in for a kernel's shared library: records the C entry points
    called and returns success."""

    def __init__(self):
        self.called = []

    def __getattr__(self, name):
        def entry(*args):
            self.called.append(name)
            return 0
        entry.argtypes = None
        return entry


def test_bf16_inference_passes_the_card_gate(monkeypatch):
    """bf16 dynamics off the CPU pass no gate: the ODEfunc kernel's launch
    and the backward's, asked for the bf16 build, run the kernels' gate and
    call the C entry points ``odefunc_forward_bf16`` and
    ``odefunc_backward_bf16`` (on meta tensors, which stand in for CUDA
    tensors here, the libraries recorders) and count in ``launches_bf16``,
    the f32 counters unmoved; inference takes no fused step."""
    cfg16 = ModelConfig(in_channels=1, compute_dtype="bfloat16")
    assert not fused_rk_eligible(cfg16, (4, 6, 6, 64), torch.float32)
    libs = {"odefunc": _Library(), "odefunc_bwd": _Library()}
    gated = []

    def check_cuda_inputs(w, states, hw, c, groups):
        odefunc_mod.check_device(hw, c, groups, torch.device("cuda"))
        gated.append(sorted(states))

    for mod in (odefunc_mod, bwd_mod):
        monkeypatch.setattr(mod, "_lib", lambda m=mod: libs[m.__name__.split(
            ".")[-1]])
        monkeypatch.setattr(mod, "stream", lambda: ctypes.c_void_p(0))
        monkeypatch.setattr(mod, "check_cuda_inputs", check_cuda_inputs)
    dev = torch.device("meta")
    w = odefunc_mod.OdefuncWeights(*(x.to(dev) for x in prepare(init_odenet(
        0, ModelConfig(in_channels=1), device="cpu")["odefunc"], (6, 6))))
    h = torch.empty((4, 6, 6, 64), device=dev)
    t = torch.empty((4,), device=dev)
    before = (odefunc.launches, odefunc.launches_bf16, odefunc_bwd.launches,
              odefunc_bwd.launches_bf16)
    f = odefunc_mod.launch(w, t, h, 32, "bf16")
    dp, dt, dh, f2 = odefunc_bwd(w, t, h, torch.empty_like(h), groups=32,
                                 with_f=True, precision="bf16")
    assert libs["odefunc"].called == ["odefunc_forward_bf16"]
    assert libs["odefunc_bwd"].called == ["odefunc_backward_bf16"]
    assert gated == [["h"], ["g", "h"]]
    assert f.device == dh.device == f2.device == dev and dt.shape == (4,)
    assert dp["conv1"]["kernel"].shape == (3, 3, 65, 64)
    assert (odefunc.launches, odefunc.launches_bf16, odefunc_bwd.launches,
            odefunc_bwd.launches_bf16) == (before[0], before[1] + 1,
                                           before[2], before[3] + 1)


@pytest.mark.parametrize("what", ["adjoint", "direct", "trainer"])
def test_bf16_training_on_the_card_raises_before_any_launch(builds, what):
    """The adjoint, direct backprop and a ``Trainer`` step in bf16 no longer
    raise: every evaluation of f asks for the ODEfunc kernel's bf16 build
    and every VJP for the backward's bf16 build, none for an f32 build
    (``train --bf16``: ``test_torch_train_cli.py``).  They run on the CPU
    here; ``test_bf16_inference_passes_the_card_gate`` shows those builds
    reaching their C entry points on CUDA tensors."""
    from neural_ode_features_tpu_torch import training

    cfg16 = ModelConfig(in_channels=1, hidden=32, tol=1e-2,
                        compute_dtype="bfloat16")
    params = init_odenet(0, cfg16, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 28, 28, 1)).astype(np.float32))

    def grads(logits_fn):
        ps = pytree.tree_map(lambda p: p.clone().requires_grad_(), params)
        logits, _ = logits_fn(ps)
        return torch.autograd.grad(logits.sum(), pytree.tree_leaves(ps))

    if what == "adjoint":
        out = grads(lambda ps: odenet_logits(ps, x, cfg16, adjoint=True))
    elif what == "direct":
        out = grads(lambda ps: training._direct_diff_logits(ps, x, cfg16))
    else:
        trainer = Trainer(TrainConfig(dataset="synthetic-mnist", hidden=32,
                                      tol=1e-2, batch_size=4,
                                      compute_dtype="bfloat16"),
                          steps_per_epoch=1, device="cpu")
        m = trainer.train_batch(
            torch.from_numpy(np.random.default_rng(1).integers(
                0, 256, (4, 28, 28, 1), dtype=np.uint8)),
            torch.arange(4) % 10)
        out = [torch.tensor(float(m["loss"]))]
    assert all(bool(torch.isfinite(g).all()) for g in out)
    assert builds["odefunc", "bf16"] > 0 and builds["odefunc_bwd", "bf16"] > 0
    assert builds["odefunc", "f32"] == builds["odefunc_bwd", "f32"] == 0


class _Reached(Exception):
    """Raised by a recorder where a path on the card reaches the model."""


@pytest.mark.parametrize("mode", ["export-compiled", "export", "serve"])
def test_bf16_export_and_serving_on_the_card_exit(bf16_run, monkeypatch,
                                                  capsys, mode):
    """``export``, ``export-compiled`` and ``serve`` of a bf16 run aimed at
    the card no longer exit: each loads the bf16 run (the weights are read
    to the CPU here: this machine has no card) and reaches the model with
    its bf16 configuration and the card as device: the first solve
    (``export-compiled``), the traced program (``export``), the served
    function after ``load_artifact`` (``serve``), where a recorder stops
    it.  On the CPU the artifact was exported (the fixture) and serves."""
    run, art = bf16_run
    assert serve.main([str(art), "--selftest", "--cpu"]) == 0
    capsys.readouterr()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    load = checkpoint_mod.load_checkpoint
    monkeypatch.setattr(checkpoint_mod, "load_checkpoint",
                        lambda path, *a, device=None, **k: load(
                            path, *a, device="cpu", **k))
    reached = {}

    def logits_fn(params, cfg, model, chain=1):
        reached["cfg"] = cfg
        if mode == "serve":  # the host's first execute comes next
            raise _Reached()
        return lambda x: (_ for _ in ()).throw(_Reached())

    def run_(fn, x, dev):
        reached["device"] = dev
        fn(x)

    class Program:
        def __init__(self, params, cfg, model):
            reached["cfg"] = cfg
            raise _Reached()

    real_load = export_model.load_artifact

    def load_artifact(art_, meta, device):
        reached["device"] = device
        return real_load(art_, meta, torch.device("cpu"))

    out = run.parent / f"{mode}.out"
    with pytest.raises(_Reached):
        if mode == "serve":
            monkeypatch.setattr(serve, "load_artifact", load_artifact)
            monkeypatch.setattr(serve, "logits_fn", logits_fn)
            serve.main([str(art), "--selftest"])
        else:
            monkeypatch.setattr(export_model, "logits_fn", logits_fn)
            monkeypatch.setattr(export_model, "_run", run_)
            monkeypatch.setattr(export_model, "LogitsProgram", Program)
            export_model.main([mode, "--run", str(run), "--batch", "2",
                               "--out", str(out)])
    assert reached["cfg"].compute_dtype == "bfloat16"
    if mode != "export":
        assert reached["device"].type == "cuda"
    assert not out.exists()
