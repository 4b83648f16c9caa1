"""Port parity, the bf16 builds of the kernels on the CPU: the plain
versions of the fused step's ``conv_precision='bf16'`` and of the conv
probe's ``*_bf16`` strategies against the JAX package, the arithmetic of the
bf16 conv stage and of the ``compute_dtype='bfloat16'`` ODEfunc kernel
emulated in plain PyTorch against the plain bf16 path, and the gates of the
bf16 paths on the card.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).

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

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

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
from neural_ode_features_tpu_torch.kernels.odefunc_bwd import odefunc_bwd
from neural_ode_features_tpu_torch.kernels.rk_step import (
    dopri5_step,
    dopri5_step_plain,
    make_fused_dopri5_step,
)
from neural_ode_features_tpu_torch.models import (
    ModelConfig,
    check_compute_dtype,
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


# ---- the card's bf16 bars and their f32 controls ---------------------------


@pytest.mark.parametrize("side,c,batch", [(7, 64, 4), (6, 32, 3)])
def test_bf16_bars_reject_the_f32_builds(side, c, batch):
    """``probes/bf16_distances.py`` on the CPU, where each build runs its
    plain version: the bf16 readings are 0 (the plain step's own stages
    give back its outputs exactly), each f32 control lies beyond its bar
    and :func:`check` passes; readings with the f32 build in the bf16
    build's place break the odefunc rel-L2 bar, the stage bar and the
    "nearer" rule for every step output (the per-row bar, which both
    builds meet, does not tell them apart)."""
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


# ---- (d) the gates ------------------------------------------------------------


@pytest.fixture
def no_launch():
    def counts():
        return (odefunc.launches, odefunc.launches_bf16, odefunc_bwd.launches,
                dopri5_step.launches, dopri5_step.launches_bf16,
                conv3x3.launches)
    before = counts()
    yield
    assert counts() == before


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


def test_bf16_inference_passes_the_card_gate(monkeypatch, no_launch):
    """Inference with bf16 dynamics aimed at the card is no longer refused
    (it runs the ODEfunc kernel's bf16 build, ``tests/test_torch_cuda.py``)
    and takes no fused step; training there still raises, naming 5b."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg16 = ModelConfig(in_channels=1, compute_dtype="bfloat16")
    cuda = torch.device("cuda")
    check_compute_dtype(cfg16, cuda)
    check_compute_dtype(cfg16, "cpu", training=True)
    with pytest.raises(NotImplementedError, match="Queue 2 item 5b"):
        check_compute_dtype(cfg16, cuda, training=True)
    assert not fused_rk_eligible(cfg16, (4, 6, 6, 64), torch.float32)


@pytest.mark.parametrize("what", ["adjoint", "direct", "trainer"])
def test_bf16_training_on_the_card_raises_before_any_launch(monkeypatch,
                                                             no_launch,
                                                             what):
    """The adjoint, direct backprop and ``Trainer`` in bf16 aimed at the
    card raise naming Queue 2 item 5b before any launch (``train --bf16``:
    ``test_torch_train_cli.py``).  The input stands in for a CUDA tensor
    by its ``device`` alone: each gate reads nothing else first."""
    from neural_ode_features_tpu_torch import training

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg16 = ModelConfig(in_channels=1, hidden=32, compute_dtype="bfloat16")
    params = {"stem": {}, "odefunc": {}, "head": {}}
    x = types.SimpleNamespace(device=torch.device("cuda"))
    calls = {
        "adjoint": lambda: odenet_logits(params, x, cfg16, adjoint=True),
        "direct": lambda: training._direct_diff_logits(params, x, cfg16),
        "trainer": lambda: Trainer(TrainConfig(
            dataset="synthetic-mnist", hidden=32,
            compute_dtype="bfloat16"), steps_per_epoch=1, device="cuda"),
    }
    with pytest.raises(NotImplementedError, match="Queue 2 item 5b"):
        calls[what]()


@pytest.mark.parametrize("mode", ["export-compiled", "export", "serve"])
def test_bf16_export_and_serving_on_the_card_exit(bf16_run, monkeypatch,
                                                  no_launch, capsys, mode):
    """``export``, ``export-compiled`` and ``serve`` of a bf16 run aimed at
    the card exit naming Queue 2 item 5c before any launch (the weights are
    read to the CPU here: this machine has no card).  On the CPU the
    artifact was exported (the fixture) and serves."""
    run, art = bf16_run
    assert serve.main([str(art), "--selftest", "--cpu"]) == 0
    capsys.readouterr()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    load = checkpoint_mod.load_checkpoint
    monkeypatch.setattr(checkpoint_mod, "load_checkpoint",
                        lambda path, *a, device=None, **k: load(
                            path, *a, device="cpu", **k))
    out = run.parent / f"{mode}.out"
    if mode == "serve":
        assert serve.main([str(art), "--selftest"]) == 1
        assert "Queue 2 item 5c" in capsys.readouterr().err
    else:
        argv = [mode, "--run", str(run), "--batch", "2", "--out", str(out)]
        with pytest.raises(SystemExit, match="Queue 2 item 5c"):
            export_model.main(argv)
        assert not out.exists()
