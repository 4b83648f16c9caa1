"""The port's CUDA kernels on the card, against their plain PyTorch
versions.  No JAX here: the card's machine has none.  Every test needs a
CUDA card and ``nvcc`` and skips without them.  On the card:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py -q
"""

import contextlib
import ctypes
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from neural_ode_features_tpu_torch.entry import (
    ENTRY_CONFIG,
    entry,
    extract_entry,
    train_entry,
)
from neural_ode_features_tpu_torch.kernels.conv3x3 import (
    STRATEGIES,
    conv3x3,
    conv3x3_plain,
)
from neural_ode_features_tpu_torch.kernels.odefunc import (
    PARAM_KEYS,
    odefunc,
    odefunc_plain,
    odefunc_vjp,
    prepare,
    stage,
)
from neural_ode_features_tpu_torch.kernels.odefunc_bwd import (
    PAIR_THREADS,
    cluster_smem_bytes,
    odefunc_bwd,
    odefunc_bwd_plain,
    sample_pass,
)
from neural_ode_features_tpu_torch.kernels.rk_step import (
    dopri5_step,
    dopri5_step_plain,
)
from neural_ode_features_tpu_torch.models import (
    head_apply,
    init_odenet,
    odenet_trajectory,
    pool_features,
    stem_apply,
)
from neural_ode_features_tpu_torch.ops import normalize
from neural_ode_features_tpu_torch.probes import bf16_distances
from neural_ode_features_tpu_torch.probes.conv_probe import probe_inputs
from neural_ode_features_tpu_torch.solver import DOPRI5, odeint

pytestmark = pytest.mark.cuda

TOL = 1e-3
STATE_TOL = dict(rtol=2e-4, atol=2e-5)  # f32 reassociation
RATIO_TOL = dict(rtol=2e-3, atol=1e-6)


@pytest.fixture
def dev(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc to build the kernels")
    # The plain versions' cuDNN convs must be strict f32, as on the main path.
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


def _inputs(dev, batch, side):
    rng = np.random.default_rng(3)
    arr = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    h = arr(rng.normal(size=(batch, side, side, 64)) * 0.3)
    t0 = arr(rng.uniform(0.0, 0.5, batch))
    dt = arr(rng.uniform(0.05, 0.2, batch))
    return h, t0, dt


@pytest.mark.parametrize("batch,side", [(16, 7), (5, 7), (9, 6)])
def test_kernels_match_plain(dev, batch, side):
    params = init_odenet(1, ENTRY_CONFIG, device=dev)
    w = prepare(params["odefunc"], (side, side))
    h, t0, dt = _inputs(dev, batch, side)
    before = odefunc.launches
    got = odefunc(w, t0, h, groups=32)
    assert odefunc.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               odefunc_plain(w, t0, h, 32).cpu().numpy(),
                               **STATE_TOL)

    y0 = h.reshape(batch, -1)
    f0 = odefunc_plain(w, t0, h, 32).reshape(batch, -1)
    kw = dict(hw=(side, side), groups=32, rtol=TOL, atol=TOL)
    before = dopri5_step.launches
    got = dopri5_step(w, DOPRI5, t0, dt, y0, f0, **kw)
    assert dopri5_step.launches == before + 1
    want = dopri5_step_plain(w, DOPRI5, t0, dt, y0, f0, **kw)
    for g, r in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   **STATE_TOL)
    np.testing.assert_allclose(got[3].cpu().numpy(), want[3].cpu().numpy(),
                               **RATIO_TOL)


def test_main_path_runs_the_kernels(dev):
    fwd, (params, x) = entry(device="cuda", batch=16)
    odefunc.launches = dopri5_step.launches = 0
    logits, nfe = fwd(params, x)
    assert odefunc.launches == 2
    assert dopri5_step.launches == int(((nfe - 2) // 6).max())

    cfg = ENTRY_CONFIG
    w = prepare(params["odefunc"], (7, 7))
    h0 = stem_apply(params["stem"], x, cfg)
    traj, stats = odeint(lambda t, y: odefunc_plain(w, t, y, 32), h0,
                         torch.tensor([0.0, 1.0], device=dev), rtol=TOL,
                         atol=TOL, error_control="per_sample")
    np.testing.assert_array_equal(nfe.cpu().numpy(), stats.nfe.cpu().numpy())
    np.testing.assert_allclose(
        logits.cpu().numpy(),
        head_apply(params["head"], traj[-1], cfg).cpu().numpy(),
        rtol=1e-3, atol=1e-3)


def test_refusals(dev):
    params = init_odenet(1, ENTRY_CONFIG, device=dev)["odefunc"]
    with pytest.raises(ValueError, match="do not take"):
        odefunc(params, 0.5, torch.zeros((2, 28, 28, 64), device=dev))
    with pytest.raises(ValueError, match="float32"):
        odefunc(params, 0.5, torch.zeros((2, 7, 7, 64), device=dev,
                                         dtype=torch.float64))
    h = torch.zeros((2, 7, 7, 64), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        odefunc(params, 0.5, h.transpose(1, 2))


DP_TOL = dict(rtol=3e-4, atol=3e-4)  # dθ sums B·H·W products (test_pallas.py)


def _flat(dp):
    return torch.cat([dp[a][b].reshape(-1) for a, b in PARAM_KEYS])


@pytest.mark.parametrize("batch,side", [(16, 7), (5, 7), (1, 7), (9, 6)])
def test_backward_kernel_matches_plain(dev, batch, side):
    params = init_odenet(2, ENTRY_CONFIG, device=dev)
    w = prepare(params["odefunc"], (side, side))
    h, t, _ = _inputs(dev, batch, side)
    g = torch.randn(h.shape, generator=torch.Generator().manual_seed(4)).to(dev)
    before = odefunc_bwd.launches
    dp, dt, dh, f = odefunc_bwd(w, t, h, g, groups=32, with_f=True)
    assert odefunc_bwd.launches == before + 1
    # The recomputed forward it writes is the ODEfunc kernel's, bit for bit.
    assert torch.equal(f, odefunc(w, t, h, groups=32))
    # The plain version in float64: in f32 its cuDNN weight-gradient convs
    # are further from the exact result than the kernel (PERF.md).
    w64 = type(w)(*(x.double() for x in w))
    dp_p, dt_p, dh_p = odefunc_bwd_plain(w64, t.double(), h.double(),
                                         g.double(), 32)
    np.testing.assert_allclose(dh.cpu().numpy(), dh_p.cpu().numpy(),
                               **STATE_TOL)
    np.testing.assert_allclose(dt.cpu().numpy(), dt_p.cpu().numpy(),
                               **STATE_TOL)
    np.testing.assert_allclose(_flat(dp).cpu().numpy(),
                               _flat(dp_p).cpu().numpy(), **DP_TOL)
    # No atomics: a second launch gives the same bits.
    assert torch.equal(_flat(odefunc_bwd(w, t, h, g, groups=32)[0]), _flat(dp))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("c,side,batch", [
    (64, 7, 128), (64, 7, 5), (64, 6, 64), (32, 7, 16), (96, 6, 16),
    (64, 8, 16), (512, 7, 16), (128, 7, 128), (256, 6, 128),
    (512, 7, 128)])
def test_weight_gradients_match_the_emulation(dev, precision, c, side,
                                              batch):
    """The weight-gradient kernels (tensor cores: ``wgmma`` at C ≥ 64,
    ``mma.sync`` at C = 32) against their arithmetic in
    plain PyTorch, ``weight_grad_emulated``, on the very r1, r2, gu, gv it
    contracted (the kernel's scratch), at the tile shapes (64, three taps a
    CTA; 7×7×32, nine taps of 32×32 on ``mma.sync``; 6×6×96, the last
    64-channel tile zero-filled), an FFMA-stage map (8×8×64), the widest
    (7×7×512), the widths' training shapes at B = 128 (7×7×128, 6×6×256,
    7×7×512) and B = 128, 64, 5, 16.  f32 (3×TF32): within 2e-6 of the
    sum of |products| per entry: each lies within 2.1e-7 of it from the f64
    sum (the emulation, on the CPU), and the tensor core's truncating
    accumulation over a 32-row step adds at most 12 ulps of the step's
    partial sums; one plain TF32 pass lies 1e-3 of it away.  bf16 (exact
    products, the sum rounded once): within one bf16 ulp (2^-7 of the
    larger), where the two f32 sums straddle a rounding, plus the same 2e-6
    of the sum of |products| (under cancellation an entry is small beside
    the sums' f32 rounding).  dθ bit-identical across two launches; one
    launch on the build's counter."""
    from neural_ode_features_tpu_torch.kernels.odefunc import bf16_round
    from neural_ode_features_tpu_torch.kernels.odefunc_bwd import (
        weight_grad_emulated,
        weight_grad_f64,
    )

    cfg = dataclasses.replace(ENTRY_CONFIG, hidden=c)
    w = prepare(init_odenet(2, cfg, device=dev)["odefunc"], (side, side))
    rng = np.random.default_rng(c + side + batch)
    arr = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    h = arr(rng.normal(size=(batch, side, side, c)) * 0.3)
    g = arr(rng.normal(size=h.shape))
    t = arr(rng.uniform(0.0, 0.5, batch))
    counter = "launches_bf16" if precision == "bf16" else "launches"
    before = getattr(odefunc_bwd, counter)
    res = {}
    dp = odefunc_bwd(w, t, h, g, groups=32, precision=precision,
                     residuals=res)[0]
    assert getattr(odefunc_bwd, counter) == before + 1
    for conv, (r, gg) in enumerate(((res["r1"], res["gu"]),
                                    (res["r2"], res["gv"]))):
        got = dp[f"conv{conv + 1}"]["kernel"][:, :, 1:, :]
        want = weight_grad_emulated(r, gg, precision)
        scale = weight_grad_f64(r, gg, True)
        if precision == "bf16":
            assert torch.equal(r, bf16_round(r)) and torch.equal(
                gg, bf16_round(gg))
            bound = (2.0 ** -7 * torch.maximum(got.abs(), want.abs()).double()
                     + 2e-6 * scale)
            assert bool(((got - want).abs().double() <= bound).all())
        else:
            err = float(((got.double() - want.double()).abs() / scale).max())
            assert err <= 2e-6, (conv, err)
    dp2 = odefunc_bwd(w, t, h, g, groups=32, precision=precision)[0]
    assert torch.equal(_flat(dp), _flat(dp2))
    if precision == "f32":
        w64 = type(w)(*(x.double() for x in w))
        dp_p = odefunc_bwd_plain(w64, t.double(), h.double(), g.double(),
                                 32)[0]
        np.testing.assert_allclose(_flat(dp).cpu().numpy(),
                                   _flat(dp_p).cpu().numpy(), **DP_TOL)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("c,side,batch", [(64, 7, 128), (64, 7, 5),
                                          (96, 6, 128), (512, 7, 128)])
def test_wgmma_weight_kernel_is_the_mma_kernel(dev, precision, c, side,
                                               batch):
    """``bwd_weight_kernel`` (``wgmma.mma_async`` TF32, what the path runs
    where C % 64 == 0) sums every weight gradient in the ``mma.sync``
    kernel's order: dθ and every other output equal, bit for bit, those of
    the reading with the weight gradients on ``bwd_weight_kernel_mma``
    (``probes.timing_aids.odefunc_bwd_mma_weights``), in both builds, at
    7×7×64 (B = 128, 5), 6×6×96 and 7×7×512; the weight launch alone
    (``bwd_weight_partials``) gives each kernel's row chunks bit for bit
    too, at 6×6×96 (where the path keeps the ``mma.sync`` kernel) the
    ``wgmma`` kernel's with its last 64-channel tile zero-filled past C."""
    from neural_ode_features_tpu_torch.kernels.odefunc_bwd import (
        weight_kernel,
    )
    from neural_ode_features_tpu_torch.probes.timing_aids import (
        bwd_weight_partials,
        odefunc_bwd_mma_weights,
    )

    assert weight_kernel((side, side), c) == ("wgmma" if c % 64 == 0
                                              else "mma")
    cfg = dataclasses.replace(ENTRY_CONFIG, hidden=c)
    w = prepare(init_odenet(2, cfg, device=dev)["odefunc"], (side, side))
    rng = np.random.default_rng(c + side + batch + 1)
    arr = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    h = arr(rng.normal(size=(batch, side, side, c)) * 0.3)
    g = arr(rng.normal(size=h.shape))
    t = arr(rng.uniform(0.0, 0.5, batch))
    res = {}
    got = odefunc_bwd(w, t, h, g, groups=32, precision=precision,
                      with_f=True, residuals=res)
    want = odefunc_bwd_mma_weights(w, t, h, g, 32, precision, with_f=True)
    assert torch.equal(_flat(got[0]), _flat(want[0]))
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
    assert torch.isfinite(_flat(got[0])).all()
    parts = {k: bwd_weight_partials(res, precision, k) for k in ("wgmma",
                                                                 "mma")}
    assert torch.equal(parts["wgmma"], parts["mma"])


@pytest.mark.parametrize("splits", [0, 6])
def test_backward_refuses_a_split_count_out_of_range(dev, monkeypatch,
                                                      splits):
    """The C entry takes the weight gradient's row chunks from the wrapper
    and refuses a count outside 1..B (here B = 5) with
    ``cudaErrorInvalidValue``, before any launch: no chunk of a sample
    range can be empty, and none is written past the scratch."""
    from neural_ode_features_tpu_torch.kernels import odefunc_bwd as mod

    w = prepare(init_odenet(2, ENTRY_CONFIG, device=dev)["odefunc"], (7, 7))
    h, t, _ = _inputs(dev, 5, 7)
    g = torch.ones_like(h)
    monkeypatch.setattr(mod, "weight_splits", lambda b, c: splits)
    before = odefunc_bwd.launches
    with pytest.raises(RuntimeError, match="odefunc_backward: CUDA error"):
        odefunc_bwd(w, t, h, g, groups=32)
    assert odefunc_bwd.launches == before


def test_vjp_is_one_backward_call(dev):
    """``odefunc_vjp`` on the card: one call of the backward kernel, which
    writes f itself, and no launch of the ODEfunc kernel."""
    params = init_odenet(2, ENTRY_CONFIG, device=dev)
    w = prepare(params["odefunc"], (7, 7))
    h, t, _ = _inputs(dev, 8, 7)
    a = torch.randn(h.shape, generator=torch.Generator().manual_seed(5)).to(dev)
    odefunc.launches = odefunc_bwd.launches = 0
    f, dp, dt, dh = odefunc_vjp(w, t, h, a, groups=32)
    assert (odefunc.launches, odefunc_bwd.launches) == (0, 1)
    np.testing.assert_allclose(f.cpu().numpy(),
                               odefunc_plain(w, t, h, 32).cpu().numpy(),
                               **STATE_TOL)
    assert dt.shape == t.shape and dh.shape == h.shape


def test_training_step_runs_the_kernels(dev):
    """The adjoint forward takes no fused step (2 + 6 per attempt ODEfunc
    launches); each augmented eval is one call of the backward kernel,
    which writes f itself, and the observation-time gradient one more
    ODEfunc launch."""
    trainer, (images, labels) = train_entry(device="cuda", batch=8)
    trainer.train_batch(images, labels)  # builds and warms up
    odefunc.launches = odefunc_bwd.launches = dopri5_step.launches = 0
    m = trainer.train_batch(images, labels)
    attempts = int(((trainer.last_stats.nfe - 2) // 6).max())
    assert dopri5_step.launches == 0
    assert odefunc_bwd.launches == m["nfe_b"] - 1
    assert odefunc.launches == 2 + 6 * attempts + 1
    assert np.isfinite(m["loss"])


CONV_TOL = dict(rtol=1e-4, atol=1e-5)  # f32 sums of 9·C products, reordered
# mma1 alone: plain TF32 keeps 11 bits per operand, about 1e-3 relative per
# product; over sums of 576 products of mixed sign 2e-3 relative, 2e-4 absolute.
TF32_TOL = dict(rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("batch,side", [(1, 7), (5, 7), (256, 7), (1, 6),
                                        (5, 6), (256, 6)])
def test_conv_kernels_match_plain(dev, strategy, batch, side):
    x, w = probe_inputs(batch, dev, (side, side))
    tol = TF32_TOL if strategy == "mma1" else CONV_TOL
    before = conv3x3.launches
    got = conv3x3(x, w, strategy)
    torch.cuda.synchronize()
    assert conv3x3.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               conv3x3_plain(x, w).cpu().numpy(), **tol)
    # ... and the plain version in float64 on the same inputs.
    np.testing.assert_allclose(
        got.cpu().numpy(),
        conv3x3_plain(x.double(), w.double()).cpu().numpy(), **tol)


def test_conv_kernel_refusals(dev):
    x, w = probe_inputs(2, dev)
    with pytest.raises(ValueError, match="does not take"):
        conv3x3(torch.zeros((2, 28, 28, 64), device=dev), w)
    with pytest.raises(ValueError, match="float32"):
        conv3x3(x.double(), w.double())
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3(x.transpose(1, 2), w)
    with pytest.raises(ValueError, match="float32 on"):
        conv3x3(x, w.cpu())
    # The tensor-core stage takes C = 64, 128 or 256 and H·(W+2) <= 64
    # only; the FFMA kernels take these shapes.
    for strategy in ("mma3", "mma1"):
        with pytest.raises(ValueError, match="does not take"):
            conv3x3(torch.zeros((2, 8, 8, 64), device=dev), w, strategy)
        x32, w32 = probe_inputs(2, dev, (7, 7), 32)
        with pytest.raises(ValueError, match="does not take"):
            conv3x3(x32, w32, strategy)
    conv3x3(torch.zeros((2, 8, 8, 64), device=dev), w, "tap9")


def test_fused_kernels_off_the_tensor_core_stage(dev):
    """A shape the tensor-core stage does not take (C = 32; 8×8×64) runs the
    FFMA stage in the same kernels, decided from the shape alone."""
    for side, c, g in ((7, 32, 16), (8, 64, 32)):
        cfg = dataclasses.replace(ENTRY_CONFIG, hidden=c, groups=g)
        params = init_odenet(3, cfg, device=dev)
        w = prepare(params["odefunc"], (side, side))
        rng = np.random.default_rng(6)
        h = torch.from_numpy((rng.normal(size=(4, side, side, c)) * 0.3)
                             .astype(np.float32)).to(dev)
        t = torch.from_numpy(rng.uniform(0, 1, 4).astype(np.float32)).to(dev)
        assert stage((side, side), c) == "ffma"
        np.testing.assert_allclose(
            odefunc(w, t, h, groups=g).cpu().numpy(),
            odefunc_plain(w, t, h, g).cpu().numpy(), **STATE_TOL)
    # The backward kernel at 8×8×64: its input-gradient convs take the
    # rearranged weights that the wrapper builds for the FFMA stage.
    gg = torch.from_numpy(rng.normal(size=h.shape).astype(np.float32)).to(dev)
    dp, dt, dh, f = odefunc_bwd(w, t, h, gg, groups=g, with_f=True)
    w64 = type(w)(*(x.double() for x in w))
    dp_p, dt_p, dh_p = odefunc_bwd_plain(w64, t.double(), h.double(),
                                         gg.double(), g)
    assert torch.equal(f, odefunc(w, t, h, groups=g))
    np.testing.assert_allclose(dh.cpu().numpy(), dh_p.cpu().numpy(),
                               **STATE_TOL)
    np.testing.assert_allclose(_flat(dp).cpu().numpy(),
                               _flat(dp_p).cpu().numpy(), **DP_TOL)


def test_extraction_path_runs_the_kernels(dev):
    """One extraction batch: two ODEfunc launches, one fused step per
    attempt whatever the number of output times, the backward kernel never;
    the features' ends are the pooled stem output and the pooled state the
    classifier's solve reaches."""
    fwd, params, x_u8 = extract_entry(device="cuda", batch=16, timestamps=11)
    fwd(params, x_u8)  # builds and warms up
    odefunc.launches = odefunc_bwd.launches = dopri5_step.launches = 0
    feats, stats = fwd(params, x_u8)
    assert tuple(feats.shape) == (11, 16, 64)
    assert odefunc.launches == 2 and odefunc_bwd.launches == 0
    assert dopri5_step.launches == int(((stats.nfe - 2) // 6).max())

    cfg = ENTRY_CONFIG
    x = normalize(x_u8, "synthetic-cifar10")
    h0 = stem_apply(params["stem"], x, cfg)
    np.testing.assert_allclose(feats[0].cpu().numpy(),
                               pool_features(h0).cpu().numpy(), rtol=1e-5,
                               atol=1e-5)
    ends, stats2 = odenet_trajectory(params, x, [0.0, 1.0], cfg)
    np.testing.assert_array_equal(stats.nfe.cpu().numpy(),
                                  stats2.nfe.cpu().numpy())
    np.testing.assert_allclose(feats[-1].cpu().numpy(),
                               pool_features(ends[-1]).cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    # Against the plain path on the card.
    w = prepare(params["odefunc"], (7, 7))
    traj, stats_p = odeint(lambda t, y: odefunc_plain(w, t, y, 32), h0,
                           torch.linspace(0, 1, 11, device=dev), rtol=TOL,
                           atol=TOL, error_control="per_sample")
    np.testing.assert_array_equal(stats.nfe.cpu().numpy(),
                                  stats_p.nfe.cpu().numpy())
    np.testing.assert_allclose(feats.cpu().numpy(),
                               pool_features(traj).cpu().numpy(), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("side,c,g", [(7, 64, 32), (6, 64, 32), (8, 64, 32),
                                      (7, 32, 16)])
def test_rk_step_per_row_tolerance(dev, side, c, g):
    """``rtol``/``atol`` as ``(B,)`` arrays, on the tensor-core stage (7×7×64,
    6×6×64) and the FFMA stage: against the plain version, and every row
    bit-identical to a launch at that row's tolerance as a float."""
    cfg = dataclasses.replace(ENTRY_CONFIG, hidden=c, groups=g)
    params = init_odenet(2, cfg, device=dev)
    w = prepare(params["odefunc"], (side, side))
    batch = 12
    rng = np.random.default_rng(8)
    arr = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    h = arr(rng.normal(size=(batch, side, side, c)) * 0.3)
    t0, dt = arr(rng.uniform(0.0, 0.5, batch)), arr(rng.uniform(0.05, 0.2,
                                                                 batch))
    y0 = h.reshape(batch, -1)
    f0 = odefunc_plain(w, t0, h, g).reshape(batch, -1)
    tols = arr(np.array([1e-1, 1e-2, 1e-3, 1e-4] * 3))
    kw = dict(hw=(side, side), groups=g)
    before = dopri5_step.launches
    got = dopri5_step(w, DOPRI5, t0, dt, y0, f0, rtol=tols, atol=tols, **kw)
    assert dopri5_step.launches == before + 1
    want = dopri5_step_plain(w, DOPRI5, t0, dt, y0, f0, rtol=tols, atol=tols,
                             **kw)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   **STATE_TOL)
    np.testing.assert_allclose(got[3].cpu().numpy(), want[3].cpu().numpy(),
                               **RATIO_TOL)
    for tol in (1e-1, 1e-2, 1e-3, 1e-4):
        one = dopri5_step(w, DOPRI5, t0, dt, y0, f0, rtol=tol, atol=tol, **kw)
        sel = tols == torch.tensor(tol, dtype=torch.float32, device=dev)
        assert int(sel.sum()) == 3
        for a, b in zip(got, one):
            assert torch.equal(a[sel], b[sel])
    with pytest.raises(ValueError, match="per-row tolerance"):
        dopri5_step(w, DOPRI5, t0, dt, y0, f0, rtol=tols[:5], atol=tols, **kw)


@pytest.mark.parametrize("variant", [
    dict(adjoint_seminorm=True), dict(adjoint_mode="interpolated")])
def test_adjoint_variants_match_plain(dev, variant):
    """One seminorm and one interpolated backward through the kernel pair
    against the plain path (``odefunc_plain`` under autograd) on the card:
    B = 8, tol 1e-5, global control; loss at rtol 1e-5, gradients at rel-L2
    < 1e-2 and cosine > 0.9999; the backward kernel is what ran."""
    from neural_ode_features_tpu_torch.models import odenet_logits
    from neural_ode_features_tpu_torch.solver import odeint_adjoint

    trainer, (images, labels) = train_entry(device="cuda", batch=8)
    tp = trainer.params
    cfg = dataclasses.replace(trainer.model_cfg, tol=1e-5,
                              error_control="global", max_steps=512,
                              **variant)
    x = normalize(torch.from_numpy(images).to(dev), trainer.cfg.dataset)
    y = torch.from_numpy(labels).to(dev)
    leaves = torch.utils._pytree.tree_leaves(tp)

    def loss_and_grads(logits):
        loss = torch.nn.functional.cross_entropy(logits, y)
        grads = torch.autograd.grad(loss, leaves)
        return (float(loss.detach()),
                torch.cat([g.reshape(-1) for g in grads]).double())

    odefunc_bwd.launches = 0
    logits, stats = odenet_logits(tp, x, cfg, adjoint=True)
    loss_k, grads_k = loss_and_grads(logits)
    assert odefunc_bwd.launches == int(stats.nfe_b) - 1 > 0

    h0 = stem_apply(tp["stem"], x, cfg)
    traj, stats_p = odeint_adjoint(
        lambda p, t, yy: odefunc_plain(prepare(p, (7, 7)), t, yy, 32),
        tp["odefunc"], h0, torch.tensor([0.0, 1.0], device=dev),
        rtol=cfg.tol, atol=cfg.tol, error_control="global",
        max_steps=cfg.max_steps, **variant)
    loss_p, grads_p = loss_and_grads(head_apply(tp["head"], traj[-1], cfg))
    np.testing.assert_allclose(loss_k, loss_p, rtol=1e-5)
    rel = float((grads_k - grads_p).norm() / grads_p.norm())
    cos = float(grads_k @ grads_p / (grads_k.norm() * grads_p.norm()))
    assert rel < 1e-2 and cos > 0.9999, (rel, cos)


def test_adams_inference_runs_the_odefunc_kernel(dev):
    """``method='adams'`` at B = 16: one ODEfunc launch per dynamics
    evaluation, 2 + 2·attempts, no fused step; per-sample NFE and logits
    against the plain path on the card."""
    from neural_ode_features_tpu_torch.models import odenet_logits

    fwd, (params, x) = entry(device="cuda", batch=16)
    cfg = dataclasses.replace(ENTRY_CONFIG, method="adams")
    odenet_logits(params, x, cfg)  # builds and warms up
    odefunc.launches = dopri5_step.launches = odefunc_bwd.launches = 0
    logits, stats = odenet_logits(params, x, cfg)
    attempts = int(((stats.nfe - 2) // 2).max())
    assert (odefunc.launches, dopri5_step.launches,
            odefunc_bwd.launches) == (2 + 2 * attempts, 0, 0)
    w = prepare(params["odefunc"], (7, 7))
    h0 = stem_apply(params["stem"], x, cfg)
    traj, stats_p = odeint(lambda t, y: odefunc_plain(w, t, y, 32), h0,
                           torch.tensor([0.0, 1.0], device=dev), rtol=TOL,
                           atol=TOL, method="adams",
                           error_control="per_sample")
    same = stats.nfe == stats_p.nfe
    assert float(same.float().mean()) >= 0.9
    np.testing.assert_allclose(
        logits[same].cpu().numpy(),
        head_apply(params["head"], traj[-1], cfg)[same].cpu().numpy(),
        rtol=1e-3, atol=1e-3)


def _width_inputs(dev, c, side, batch, seed=11):
    cfg = dataclasses.replace(ENTRY_CONFIG, hidden=c)
    w = prepare(init_odenet(seed, cfg, device=dev)["odefunc"], (side, side))
    rng = np.random.default_rng(seed)
    arr = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    h = arr(rng.normal(size=(batch, side, side, c)) * 0.3)
    return (w, h, arr(rng.uniform(0.0, 0.5, batch)),
            arr(rng.uniform(0.05, 0.2, batch)), arr(rng.normal(size=h.shape)))


@pytest.mark.parametrize("c", [32, 128, 256])
@pytest.mark.parametrize("side", [7, 6])
def test_fused_kernels_at_other_widths(dev, c, side):
    """The three fused kernels at hidden 32 (FFMA stage; the backward's
    32-wide weight tile), 128 and 256 (tensor-core stage, 64-channel
    blocks; at 7×7×256 the backward keeps u in global scratch) against
    their plain versions, the backward in float64 and bit-identical from
    call to call."""
    _check_fused_kernels(dev, c, side)


@pytest.mark.parametrize("c,side", [(96, 7), (192, 7), (512, 7), (512, 6)])
def test_fused_kernels_at_the_jax_widths(dev, c, side):
    """The widths the JAX kernels take beyond the powers of two: 96 and 192
    (the tensor-core stage's last channel block padded; the backward's
    32-wide weight tile at 96) and 512 (the state in global scratch, a ring
    of two weight buffers at 7×7), each kernel against its plain version
    as at the other widths."""
    assert stage((side, side), c) == "mma3"
    _check_fused_kernels(dev, c, side)


def _check_fused_kernels(dev, c, side):
    batch = 9
    w, h, t, dt, g = _width_inputs(dev, c, side, batch)
    assert stage((side, side), c) == ("ffma" if c == 32 else "mma3")
    f = odefunc(w, t, h, groups=32)
    np.testing.assert_allclose(f.cpu().numpy(),
                               odefunc_plain(w, t, h, 32).cpu().numpy(),
                               **STATE_TOL)
    y0, f0 = h.reshape(batch, -1), odefunc_plain(w, t, h, 32).reshape(batch, -1)
    kw = dict(hw=(side, side), groups=32, rtol=TOL, atol=TOL)
    got = dopri5_step(w, DOPRI5, t, dt, y0, f0, **kw)
    want = dopri5_step_plain(w, DOPRI5, t, dt, y0, f0, **kw)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   **STATE_TOL)
    np.testing.assert_allclose(got[3].cpu().numpy(), want[3].cpu().numpy(),
                               **RATIO_TOL)
    dp, dtk, dh, f_b = odefunc_bwd(w, t, h, g, groups=32, with_f=True)
    assert torch.equal(f_b, f)
    w64 = type(w)(*(x.double() for x in w))
    dp_p, dt_p, dh_p = odefunc_bwd_plain(w64, t.double(), h.double(),
                                         g.double(), 32)
    np.testing.assert_allclose(dh.cpu().numpy(), dh_p.cpu().numpy(),
                               **STATE_TOL)
    np.testing.assert_allclose(dtk.cpu().numpy(), dt_p.cpu().numpy(),
                               **STATE_TOL)
    np.testing.assert_allclose(_flat(dp).cpu().numpy(),
                               _flat(dp_p).cpu().numpy(), **DP_TOL)
    assert torch.equal(_flat(odefunc_bwd(w, t, h, g, groups=32)[0]), _flat(dp))


@pytest.mark.parametrize("c", [128, 256, 96, 512])
def test_conv_probe_tensor_cores_at_other_widths(dev, c):
    """``mma3`` and ``mma1`` at 7×7×128, 256, 96 (the padded last block)
    and 512 against the conv in float64: ``mma3`` f32-grade, ``mma1`` plain
    TF32, whose error grows as the root of the 9·C products it sums
    (TF32_TOL is for 576)."""
    x, w = probe_inputs(16, dev, (7, 7), c)
    want = conv3x3_plain(x.double(), w.double())
    grow = (c / 64) ** 0.5
    tf32 = {k: v * grow for k, v in TF32_TOL.items()}
    for strategy, tol in (("mma3", CONV_TOL), ("mma1", tf32)):
        got = conv3x3(x, w, strategy)
        np.testing.assert_allclose(got.double().cpu().numpy(),
                                   want.cpu().numpy(), **tol)


def test_hidden_128_trains_on_the_card(dev):
    """``train --hidden 128``'s step on the card runs the kernels: the
    ODEfunc kernel 2 + 6·attempts + 1 times, the backward kernel
    NFE-b − 1 times, the fused step never; loss and gradients finite."""
    _check_train_step(128)


def test_hidden_512_trains_on_the_card(dev):
    """``train --hidden 512``, the JAX package's widest width, under the
    same launch rule: no plain version runs in a kernel's place."""
    _check_train_step(512)


def _check_train_step(hidden):
    from neural_ode_features_tpu_torch.training import TrainConfig, Trainer

    trainer = Trainer(TrainConfig(dataset="synthetic-cifar10", hidden=hidden,
                                  batch_size=8), steps_per_epoch=1,
                      device="cuda")
    _, (images, labels) = train_entry(device="cuda", batch=8)
    odefunc.launches = odefunc_bwd.launches = dopri5_step.launches = 0
    m = trainer.train_batch(images, labels)
    attempts = int(((trainer.last_stats.nfe - 2) // 6).max())
    assert (odefunc.launches, odefunc_bwd.launches, dopri5_step.launches) == (
        2 + 6 * attempts + 1, m["nfe_b"] - 1, 0)
    assert np.isfinite(m["loss"])
    assert all(bool(torch.isfinite(p.grad).all()) for p in trainer._leaves)


def test_serving_host_on_the_card(dev, tmp_path):
    """The serving host holds the entry() model (seed 7) on the card at
    B = 256: its full batch runs the kernels and equals the exported
    expected logits; a burst of ragged requests returns the same rows of
    the full batch, bit for bit; the shutdown frame ends it with exit 0."""
    import json
    import re
    import socket
    import subprocess
    import sys
    from pathlib import Path

    from neural_ode_features_tpu_torch import export_model
    from neural_ode_features_tpu_torch.serving import SocketClient
    from neural_ode_features_tpu_torch.utils import save_checkpoint

    root = Path(__file__).resolve().parent.parent
    save_checkpoint(tmp_path / "run" / "ckpt_best.pt",
                    init_odenet(7, ENTRY_CONFIG, device=dev), ENTRY_CONFIG,
                    {"model": "odenet"})
    art = export_model.main(["export-compiled", "--run", str(tmp_path / "run"),
                             "--batch", "256", "--out", str(tmp_path / "a")])
    assert json.loads((art / "meta.json").read_text())["rowwise"] is True
    x = np.load(art / "sample_input.npy")
    sock = str(tmp_path / "s.sock")
    if len(sock.encode()) > 100:  # AF_UNIX paths: 107 bytes at most
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            sock = f"tcp:127.0.0.1:{probe.getsockname()[1]}"
    host = subprocess.Popen(
        [sys.executable, "-m", "neural_ode_features_tpu_torch.serve", str(art),
         "--listen", sock], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=root)
    try:
        assert host.stdout.readline().strip() == f"READY {sock}"
        client = SocketClient(sock)
        full = client.infer(x)
        np.testing.assert_array_equal(full,
                                      np.load(art / "expected_logits.npy"))
        rng = np.random.default_rng(5)
        spans = [(int(o), int(o) + int(r)) for r, o in
                 ((r, rng.integers(0, 257 - r))
                  for r in rng.integers(1, 33, size=24))]
        outs = client.infer_burst([x[a:b] for a, b in spans])
        for (a, b), y in zip(spans, outs):
            np.testing.assert_array_equal(y, full[a:b])
        client.close(shutdown_server=True)
        assert host.wait(timeout=120) == 0
        err = host.stderr.read()
    finally:
        if host.poll() is None:
            host.kill()
            host.wait(timeout=30)
    launches = json.loads(re.search(r" stats (\{.*\})", err).group(1))[
        "launches"]
    assert launches["odefunc"] >= 2 and launches["rk_step"] >= 1


# -- training across devices ---------------------------------------------------
def _parallel_case(devices, **changes):
    """Two steps of the JAX ``TrainConfig`` defaults on
    ``synthetic-cifar10`` (B = 32, augment off) on ranks at ``devices``,
    against the solo ``Trainer`` on the first card, at the JAX bars
    (tests/test_training.py:73-99), with each rank's launches."""
    from neural_ode_features_tpu_torch.data import load_dataset
    from neural_ode_features_tpu_torch.entry import TRAIN_CONFIG
    from neural_ode_features_tpu_torch.parallel import launch
    from neural_ode_features_tpu_torch.parallel.tasks import train_steps
    from neural_ode_features_tpu_torch.training import Trainer

    cfg = dataclasses.replace(TRAIN_CONFIG, batch_size=32, augment=False)
    x, y = load_dataset(cfg.dataset, "train", limit=64)
    batches = [(x[:32], y[:32]), (x[32:], y[32:])]
    ranks = launch(train_steps, len(devices),
                   dataclasses.replace(cfg, num_devices=len(devices),
                                       **changes), batches,
                   devices=devices, device="cuda", timeout=300)
    solo = Trainer(cfg, steps_per_epoch=4, device=devices[0])
    want = [solo.train_batch(*b) for b in batches]
    got = ranks[0]["metrics"]
    assert all(r["metrics"] == got for r in ranks)
    np.testing.assert_allclose(got[0]["loss"], want[0]["loss"], rtol=1e-6)
    assert got[0]["nfe"] == want[0]["nfe"]
    np.testing.assert_allclose(got[1]["loss"], want[1]["loss"], rtol=3e-4)
    assert got[1]["nfe"] == want[1]["nfe"]
    assert abs(got[1]["nfe_b"] - want[1]["nfe_b"]) <= 1.0
    for r in ranks:
        for launches, att, m in zip(r["launches"], r["attempts"],
                                    r["metrics"]):
            assert launches == {"odefunc": 2 + 6 * att + 1,
                                "odefunc_bwd": m["nfe_b"] - 1, "rk_step": 0}
    return ranks


def test_two_ranks_share_one_card_through_gloo(dev):
    """``devices`` naming one card twice: gloo, sums through the host."""
    ranks = _parallel_case(["cuda:0", "cuda:0"])
    assert "data=2" in ranks[0]["mesh"]


@pytest.fixture
def two_cards(dev):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (NCCL refuses two ranks on one)")
    return dev


@pytest.mark.parametrize("model_shards", [1, 2])
def test_nccl_ranks_on_two_cards(two_cards, model_shards):
    """Data parallel and a (1, 2) FSDP mesh over NCCL, one rank per card."""
    ranks = _parallel_case(["cuda:0", "cuda:1"], model_shards=model_shards)
    if model_shards > 1:
        assert any(tuple(a) != tuple(b) for a, b in ranks[0]["shapes"])


# -- the attempt loop as a CUDA graph ------------------------------------------
@pytest.fixture
def host_loop(monkeypatch):
    """A context in which every 'while' solve takes the private host loop
    (``runge_kutta._host_loop``), the graph route's reference."""
    from neural_ode_features_tpu_torch.solver import runge_kutta

    @contextlib.contextmanager
    def ctx():
        with monkeypatch.context() as m:
            m.setattr(runge_kutta, "_while_loop",
                      lambda body, carry, n, capturable, key=None:
                      runge_kutta._host_loop(body, carry, n))
            yield
    return ctx


def test_graph_replays_one_odefunc_launch(dev):
    """The ctypes-loaded kernel (its own static CUDA runtime) launches onto
    PyTorch's capturing stream: a captured launch, replayed, gives the
    eager launch's bits."""
    params = init_odenet(7, ENTRY_CONFIG, device=dev)["odefunc"]
    w = prepare(params, (7, 7))
    h, t, _ = _inputs(dev, 5, 7)
    want = odefunc(w, t, h, groups=32)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        got = odefunc(w, t, h, groups=32)
        graph.capture_end()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _solve_both(host_loop, solve):
    """``solve()`` through the graph route and through the host loop, each
    with the launch counters from 0: ``(result, counts)`` twice."""
    out = []
    for ctx in (contextlib.nullcontext(), host_loop()):
        with ctx:
            odefunc.launches = odefunc_bwd.launches = dopri5_step.launches = 0
            res = solve()
            torch.cuda.synchronize()
            out.append((res, (odefunc.launches, odefunc_bwd.launches,
                              dopri5_step.launches)))
    return out


@pytest.mark.parametrize("side", [7, 6])
def test_graph_route_matches_host_loop(dev, host_loop, side):
    """A per-sample dopri5 solve at B = 5 (7×7×64 and 6×6×64, T = 4):
    the graph route bit-identical to the host loop in values, NFE, accepts
    and rejects, with the host loop's launch counts (2 ``odefunc``, one
    ``rk_step`` per attempt)."""
    from neural_ode_features_tpu_torch.models import odenet_solve

    cfg = ENTRY_CONFIG
    params = init_odenet(7, cfg, device=dev)
    h0 = _inputs(dev, 5, side)[0]
    ts = torch.linspace(0.0, 1.0, 4, device=dev)
    (g, g_n), (p, p_n) = _solve_both(
        host_loop, lambda: odenet_solve(params, h0, ts, cfg))
    assert torch.equal(g[0], p[0])
    for a, b in zip(g[1], p[1]):
        assert torch.equal(a, b)
    attempts = int((g[1].naccept + g[1].nreject).max())
    assert attempts > 1 and g_n == p_n == (2, 0, attempts)


def test_graph_route_train_step_matches_host_loop(dev, host_loop):
    """One adjoint train step (B = 8): the forward and the backward solve
    take the graph route; loss, NFE, NFE-b and every gradient bit-identical
    to the host loop's, launches by the training rule."""
    from neural_ode_features_tpu_torch.models import odenet_logits
    from neural_ode_features_tpu_torch.training import _deterministic_cudnn

    trainer, (images, labels) = train_entry(device="cuda", batch=8)
    cfg = trainer.model_cfg
    x = normalize(torch.from_numpy(images).to(dev), trainer.cfg.dataset)
    y = torch.from_numpy(labels).to(dev)

    def step():
        # cuDNN's default stem weight gradients vary from run to run; the
        # trainer's step runs its deterministic algorithms, and so does this.
        p = torch.utils._pytree.tree_map(
            lambda v: v.detach().requires_grad_(), trainer.params)
        with _deterministic_cudnn():
            logits, st = odenet_logits(p, x, cfg, adjoint=True)
            loss = torch.nn.functional.cross_entropy(logits, y)
            grads = torch.autograd.grad(loss,
                                        torch.utils._pytree.tree_leaves(p))
        return loss.detach(), st, grads

    (g, g_n), (h, h_n) = _solve_both(host_loop, step)
    assert torch.equal(g[0], h[0])
    for a, b in zip(g[1], h[1]):
        assert torch.equal(a, b)
    for a, b in zip(g[2], h[2]):
        assert torch.equal(a, b)
    attempts = int(((g[1].nfe - 2) // 6).max())
    assert g_n == h_n == (2 + 6 * attempts + 1, int(g[1].nfe_b) - 1, 0)


def test_graph_capture_failure_raises(dev):
    """Dynamics that read a value on the host cannot be captured: the
    solve raises, and does not fall back to the host loop.  The capture
    stream's allocations go back to the caching allocator (the private
    entry point ``attempt_graph._end_allocation`` calls), and the card works
    on afterwards."""
    from neural_ode_features_tpu_torch.solver import attempt_graph

    y0 = torch.ones((4, 8), device=dev)
    ts = torch.tensor([0.0, 1.0], device=dev)

    def reads(t, y):
        return -y * float(y.abs().max())

    with pytest.raises(RuntimeError):
        odeint(reads, y0, ts, rtol=1e-6, atol=1e-8,
               error_control="per_sample")
    side = attempt_graph._stream(y0.device)
    with torch.cuda.stream(side):
        block = torch.empty(16 << 20, device=dev)  # 64 MiB: its own segment
    torch.cuda.synchronize()
    seg = [s for s in torch.cuda.memory_snapshot()
           if s["address"] <= block.data_ptr() < s["address"]
           + s["total_size"]]
    assert len(seg) == 1 and tuple(seg[0]["segment_pool_id"]) == (0, 0)
    del block
    ys, st = odeint(lambda t, y: -y, y0, ts, rtol=1e-6, atol=1e-8,
                    error_control="per_sample")
    np.testing.assert_allclose(ys[-1].cpu().numpy(), np.exp(-1.0), rtol=1e-5)


def test_graph_launch_outside_capture_raises(dev, monkeypatch):
    """A wrapper whose kernel went to another stream during the capture
    (it ran once, outside the graph) is caught by counting the graph's
    kernel nodes: the solve raises."""
    from neural_ode_features_tpu_torch.kernels import rk_step as rk_mod
    from neural_ode_features_tpu_torch.models import odenet_solve

    params = init_odenet(7, ENTRY_CONFIG, device=dev)
    h0 = _inputs(dev, 5, 7)[0]
    ts = torch.linspace(0.0, 1.0, 4, device=dev)
    other = torch.cuda.Stream()
    real = rk_mod.stream
    monkeypatch.setattr(rk_mod, "stream", lambda: (
        ctypes.c_void_p(other.cuda_stream)
        if torch.cuda.is_current_stream_capturing() else real()))
    with pytest.raises(RuntimeError, match="outside the graph"):
        odenet_solve(params, h0, ts, ENTRY_CONFIG)
    torch.cuda.synchronize()


# -- the graph cache: one captured attempt per shape -------------------------
@pytest.fixture
def captures(monkeypatch):
    """The captures made while a test runs (a list that grows by one per
    capture), from an empty cache."""
    from neural_ode_features_tpu_torch.solver import attempt_graph

    attempt_graph.clear_cache()
    made = []
    real = attempt_graph._capture

    def counting(*args):
        made.append(1)
        return real(*args)
    monkeypatch.setattr(attempt_graph, "_capture", counting)
    yield made
    attempt_graph.clear_cache()


def _entry_solve(dev, batch=5, tol=None):
    from neural_ode_features_tpu_torch.models import odenet_solve

    params = init_odenet(7, ENTRY_CONFIG, device=dev)
    h0 = _inputs(dev, batch, 7)[0]
    ts = torch.linspace(0.0, 1.0, 4, device=dev)
    return params, lambda: odenet_solve(params, h0, ts, ENTRY_CONFIG,
                                        tol=tol)


def test_graph_cache_hit_matches_host_loop(dev, host_loop, captures):
    """A fixed-weight solve captures once: the second solve replays every
    attempt of the cached graph (the first included), bit-identical to the
    host loop in values and stats, with its launch counts."""
    _, solve = _entry_solve(dev)
    (g1, n1), (p, p_n) = _solve_both(host_loop, solve)
    assert len(captures) == 1
    (g2, n2), _ = _solve_both(host_loop, solve)
    assert len(captures) == 1
    for g, n in ((g1, n1), (g2, n2)):
        assert torch.equal(g[0], p[0])
        for a, b in zip(g[1], p[1]):
            assert torch.equal(a, b)
        assert n == p_n
    assert p_n[0] == 2 and p_n[2] == int((p[1].naccept + p[1].nreject).max())


@pytest.mark.parametrize("change", ["weight", "tolerance"])
def test_graph_cache_misses_on_a_change(dev, host_loop, captures, change):
    """An in-place weight update (its version counter moves) or another
    tolerance misses the cache and captures anew: never a stale replay."""
    from neural_ode_features_tpu_torch.models import odenet_solve

    params, solve = _entry_solve(dev)
    solve()
    solve()
    assert len(captures) == 1
    if change == "weight":
        with torch.no_grad():
            params["odefunc"]["conv2"]["bias"].add_(0.05)
        again = solve
    else:
        h0 = _inputs(dev, 5, 7)[0]
        ts = torch.linspace(0.0, 1.0, 4, device=dev)
        again = lambda: odenet_solve(params, h0, ts, ENTRY_CONFIG,  # noqa
                                     tol=3e-4)
    (g, _), (p, _) = _solve_both(host_loop, again)
    assert len(captures) == 2
    assert torch.equal(g[0], p[0])
    assert torch.equal(g[1].nfe, p[1].nfe)


def test_graph_cache_stays_within_its_bound(dev, captures):
    """Solves of more shapes than the cache holds, in turn for four rounds:
    every solve misses and captures, the oldest entries are evicted, at
    most ``CACHE_ENTRIES`` are kept, each with a pool; a miss captures into
    the evicted entry's pool, so the reserved memory after the last round
    is that after the first (within 1%)."""
    from neural_ode_features_tpu_torch.solver import attempt_graph

    n = attempt_graph.CACHE_ENTRIES + 2
    solves = [_entry_solve(dev, batch)[1] for batch in range(1, n + 1)]
    reserved = []
    for _ in range(4):
        for solve in solves:
            solve()
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved(dev))
        info = attempt_graph.cache_info(dev)
        assert len(info) == attempt_graph.CACHE_ENTRIES
        assert [e["batch"] for e in info] == list(range(3, n + 1))
        assert all(e["pool_bytes"] > 0 for e in info)
    assert len(captures) == 4 * n
    assert abs(reserved[-1] - reserved[0]) <= 0.01 * reserved[0]


def test_exported_program_launches_by_rule(dev, tmp_path):
    """``export_model export`` on the card: the program runs the kernels as
    operators, 2 ``odefunc`` and one ``rk_step`` per attempt, and its
    logits equal the live model's argmax for argmax."""
    from neural_ode_features_tpu_torch import export_model
    from neural_ode_features_tpu_torch.models import odenet_logits
    from neural_ode_features_tpu_torch.utils import save_checkpoint

    params = init_odenet(7, ENTRY_CONFIG, device=dev)
    save_checkpoint(tmp_path / "ckpt_best.pt", params, ENTRY_CONFIG,
                    {"model": "odenet"})
    art = export_model.main(["export", "--run", str(tmp_path), "--batch",
                             "8"])
    module, meta = export_model.load_program(art, dev)
    assert meta["platforms"] == ["cuda"]
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(8, 32, 32, 3)).astype(np.float32)).to(dev)
    odefunc.launches = dopri5_step.launches = 0
    with torch.no_grad():
        got = module(x)
    torch.cuda.synchronize()
    counts = (odefunc.launches, dopri5_step.launches)
    with torch.no_grad():
        want, st = odenet_logits(params, x, ENTRY_CONFIG)
    assert counts == (2, int((st.naccept + st.nreject).max()))
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    assert float((got - want).abs().max()) <= 1e-3


# -- the bf16 builds ------------------------------------------------------------
# bf16 comparisons are in units of u = 2^-8 of the compared value's size, each
# bar held beside the f32 build's distance from the same plain version
# (neural_ode_features_tpu_torch/probes/bf16_distances.py).
U = bf16_distances.U


@pytest.mark.parametrize("c,side", [(32, 7), (64, 7), (128, 7), (512, 7),
                                    (64, 6)])
def test_bf16_builds_match_plain(dev, c, side):
    """Each bf16 build against its plain version on the card, beside its f32
    build (``probes/bf16_distances.py``: the bars and their f32 controls):
    the ODEfunc kernel's ``compute_dtype='bfloat16'`` build, the fused
    step's ``conv_precision='bf16'`` one evaluation at a time from its own
    stages, the backward's bf16 build per output (its f the bf16 ODEfunc
    kernel's bit for bit, dθ bit-identical over two launches), each launch
    on its build's own counter; the probe's bf16 twins (f32 reassociation:
    their operands round alike), apart from the f32 conv."""
    from neural_ode_features_tpu_torch.kernels.conv3x3 import (
        BF16_STRATEGIES,
        supported,
    )

    counters = (odefunc, "launches"), (odefunc, "launches_bf16"), (
        dopri5_step, "launches"), (dopri5_step, "launches_bf16"), (
        odefunc_bwd, "launches"), (odefunc_bwd, "launches_bf16")
    before = [getattr(*c_) for c_ in counters]
    readings = bf16_distances.readings_at(side, side, c, 32, dev)
    # odefunc: the f32 and the bf16 build beside the plain f, then the bf16
    # build beside the backward's f; the backward: bf16 twice, f32 once.
    assert [getattr(*c_) - b for c_, b in zip(counters, before)] == [
        1, 2, 1, 1, 1, 2]
    assert bf16_distances.check(readings["odefunc"]) == []
    assert bf16_distances.check(readings["rk_step"]) == []
    assert bf16_distances.check(readings["odefunc_bwd"]) == []

    x, wc = probe_inputs(32, dev, (side, side), c)
    plain = conv3x3_plain(x, wc, passes="bf16")
    for strategy in BF16_STRATEGIES:
        if not supported((side, side), c, strategy):
            continue
        got = conv3x3(x, wc, strategy)
        np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(),
                                   **CONV_TOL)
        assert not torch.allclose(got, conv3x3_plain(x, wc), **CONV_TOL)


def test_bf16_inference_runs_the_bf16_build(dev, captures):
    """``compute_dtype='bfloat16'`` inference on the card: one launch of
    the ODEfunc kernel's bf16 build per evaluation (2 + 6·attempts), no
    fused step; per-sample NFE, logits and top-1 against the plain bf16
    dynamics on the card; the trajectory's end equal to the solve's; a bf16
    and an f32 solve of the same weights are two entries of the graph
    cache."""
    from neural_ode_features_tpu_torch.models import (
        odenet_logits,
        odenet_solve,
    )
    from neural_ode_features_tpu_torch.solver import attempt_graph

    cfg16 = dataclasses.replace(ENTRY_CONFIG, compute_dtype="bfloat16")
    params = init_odenet(7, ENTRY_CONFIG, device=dev)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(16, 32, 32, 3)).astype(np.float32)).to(dev)
    odefunc.launches = dopri5_step.launches = 0
    odefunc.launches_bf16 = dopri5_step.launches_bf16 = 0
    with torch.no_grad():
        logits, stats = odenet_logits(params, x, cfg16)
    torch.cuda.synchronize()
    attempts = int((stats.naccept + stats.nreject).max())
    assert (odefunc.launches_bf16, odefunc.launches, dopri5_step.launches,
            dopri5_step.launches_bf16) == (2 + 6 * attempts, 0, 0, 0)

    w = prepare(params["odefunc"], (7, 7))
    h0 = stem_apply(params["stem"], x, cfg16)
    ts = torch.tensor([0.0, 1.0], device=dev)
    with torch.no_grad():
        traj, st_p = odeint(lambda t, y: odefunc_plain(w, t, y, 32, "bf16"),
                            h0, ts, rtol=TOL, atol=TOL,
                            error_control="per_sample")
        want = head_apply(params["head"], traj[-1], cfg16)
        f32, _ = odenet_logits(params, x, ENTRY_CONFIG)
    np.testing.assert_array_equal(stats.nfe.cpu().numpy(),
                                  st_p.nfe.cpu().numpy())
    assert torch.equal(logits.argmax(1), want.argmax(1))
    np.testing.assert_allclose(logits.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=4 * U)
    assert bf16_distances.rel_u(logits, want) < bf16_distances.rel_u(logits,
                                                                     f32)

    with torch.no_grad():
        feats, _ = odenet_trajectory(params, x, [0.0, 0.5, 1.0], cfg16)
        np.testing.assert_allclose(
            head_apply(params["head"], feats[-1], cfg16).cpu().numpy(),
            logits.cpu().numpy(), rtol=0, atol=1e-5)
        attempt_graph.clear_cache()
        captures.clear()
        for cfg in (cfg16, ENTRY_CONFIG, cfg16, ENTRY_CONFIG):
            odenet_solve(params, h0, ts, cfg)
    assert len(captures) == 2 and len(attempt_graph.cache_info(dev)) == 2


def test_bf16_adjoint_step_counts_through_the_graph_route(dev, host_loop):
    """One bf16 adjoint train step (B = 8) on the graph route and on the
    host loop: loss, NFE, NFE-b and every gradient bit-identical; launches
    by the training rule in the bf16 builds alone (2 + 6·attempts + 1
    ``odefunc_bf16``, NFE-b − 1 ``odefunc_bwd_bf16``), the graph route's
    counted from the captured graph's kernel nodes of the bf16 build
    (``bwd_sample_kernel``'s last template argument)."""
    from neural_ode_features_tpu_torch.models import odenet_logits
    from neural_ode_features_tpu_torch.training import _deterministic_cudnn

    trainer, (images, labels) = train_entry(device="cuda", batch=8)
    cfg16 = dataclasses.replace(trainer.model_cfg, compute_dtype="bfloat16")
    x = normalize(torch.from_numpy(images).to(dev), trainer.cfg.dataset)
    y = torch.from_numpy(labels).to(dev)
    counters = ((odefunc, "launches_bf16"), (odefunc_bwd, "launches_bf16"),
                (odefunc, "launches"), (odefunc_bwd, "launches"),
                (dopri5_step, "launches"), (dopri5_step, "launches_bf16"))

    def step():
        p = torch.utils._pytree.tree_map(
            lambda v: v.detach().requires_grad_(), trainer.params)
        with _deterministic_cudnn():
            logits, st = odenet_logits(p, x, cfg16, adjoint=True)
            loss = torch.nn.functional.cross_entropy(logits, y)
            grads = torch.autograd.grad(loss,
                                        torch.utils._pytree.tree_leaves(p))
        return loss.detach(), st, grads

    out = []
    for ctx in (contextlib.nullcontext(), host_loop()):
        with ctx:
            for c_ in counters:
                setattr(*c_, 0)
            res = step()
            torch.cuda.synchronize()
            out.append((res, tuple(getattr(*c_) for c_ in counters)))
    (g, g_n), (h, h_n) = out
    assert torch.equal(g[0], h[0]) and bool(torch.isfinite(g[0]))
    for a, b in zip(g[1], h[1]):
        assert torch.equal(a, b)
    for a, b in zip(g[2], h[2]):
        assert torch.equal(a, b)
    attempts = int(((g[1].nfe - 2) // 6).max())
    assert g_n == h_n == (2 + 6 * attempts + 1, int(g[1].nfe_b) - 1,
                          0, 0, 0, 0)


# ---- wgmma3: the f32 conv stage on warpgroup products ----------------------


@pytest.mark.parametrize("c,side", [(64, 7), (64, 6), (128, 7), (96, 7)])
def test_wgmma_stage_matches_plain(dev, c, side):
    """``wgmma3`` alone (the probe's kernel, the f32 fused kernels' stage)
    at 7×7×64, 6×6×64 and wider: within the conv tolerance of the plain
    version and of the f64 conv, its error against the f64 conv at most
    ``WGMMA_BAR`` times ``mma3``'s on the same inputs.  Where the gate
    gives a width to ``mma3``, ``wgmma3`` refuses it and the fused kernels
    still run ``mma3`` there (their own tests hold them to the plain
    version)."""
    from neural_ode_features_tpu_torch.probes.conv_probe import WGMMA_BAR

    x, w = probe_inputs(64, dev, (side, side), c)
    if stage((side, side), c) != "wgmma3":
        assert stage((side, side), c) == "mma3"
        with pytest.raises(ValueError, match="does not take"):
            conv3x3(x, w, "wgmma3")
        return
    want64 = conv3x3_plain(x.double(), w.double())
    got = conv3x3(x, w, "wgmma3")
    np.testing.assert_allclose(got.cpu().numpy(),
                               conv3x3_plain(x, w).cpu().numpy(), **CONV_TOL)
    np.testing.assert_allclose(got.double().cpu().numpy(),
                               want64.cpu().numpy(), **CONV_TOL)
    err = float((got.double() - want64).abs().max())
    err_mma = float((conv3x3(x, w, "mma3").double() - want64).abs().max())
    assert err <= WGMMA_BAR * err_mma, (err, err_mma)


@pytest.mark.parametrize("side", [7, 6])
def test_wgmma_rows_do_not_depend_on_the_batch(dev, side):
    """One CTA per sample: the rows of a B = 5 launch are bit-identical to
    the same rows of a B = 256 launch, for the probe's ``wgmma3``, the
    ODEfunc kernel and the fused step (the served ragged batch's rule)."""
    assert stage((side, side), 64) == "wgmma3"
    x, w = probe_inputs(256, dev, (side, side))
    full = conv3x3(x, w, "wgmma3")
    assert torch.equal(conv3x3(x[:5].contiguous(), w, "wgmma3"), full[:5])
    params = init_odenet(1, ENTRY_CONFIG, device=dev)
    wt = prepare(params["odefunc"], (side, side))
    h, t0, dt = _inputs(dev, 256, side)
    f = odefunc(wt, t0, h, groups=32)
    assert torch.equal(odefunc(wt, t0[:5], h[:5].contiguous(), groups=32),
                       f[:5])
    y0, f0 = h.reshape(256, -1), f.reshape(256, -1)
    kw = dict(hw=(side, side), groups=32, rtol=TOL, atol=TOL)
    full = dopri5_step(wt, DOPRI5, t0, dt, y0, f0, **kw)
    part = dopri5_step(wt, DOPRI5, t0[:5], dt[:5], y0[:5].contiguous(),
                       f0[:5].contiguous(), **kw)
    for a, b in zip(part, full):
        assert torch.equal(a, b[:5])


def test_wgmma_weights_changed_in_place_reach_the_next_launch(dev):
    """The stage splits the f32 weights in shared memory at every launch:
    a weight updated in place (as the optimizer does) changes the next
    launch's output, on the host loop and on a graph replay, which then
    equals an eager launch on the new weights bit for bit."""
    params = init_odenet(1, ENTRY_CONFIG, device=dev)
    wt = prepare(params["odefunc"], (7, 7))
    h, t0, dt = _inputs(dev, 16, 7)
    y0 = h.reshape(16, -1)
    f0 = odefunc_plain(wt, t0, h, 32).reshape(16, -1)
    kw = dict(hw=(7, 7), groups=32, rtol=TOL, atol=TOL)
    launch = {"odefunc": lambda: odefunc(wt, t0, h, groups=32),
              "rk_step": lambda: dopri5_step(wt, DOPRI5, t0, dt, y0, f0,
                                             **kw)[0]}
    for name, fn in launch.items():
        before = fn().clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            out = fn()
            graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, before), name
        for k in (wt.w1, wt.w2):
            with torch.no_grad():
                k.mul_(1.25)       # in place: same buffers, new values
            eager = fn().clone()   # the host loop's next launch
            assert not torch.equal(eager, before), name
            np.testing.assert_allclose(
                eager.cpu().numpy(),
                (odefunc_plain(wt, t0, h, 32) if name == "odefunc" else
                 dopri5_step_plain(wt, DOPRI5, t0, dt, y0, f0, **kw)[0])
                .cpu().numpy(), **STATE_TOL)
            graph.replay()         # the captured launch, same buffers
            torch.cuda.synchronize()
            assert torch.equal(out, eager), name
            before = eager


# ---- the backward's per-sample pass as a two-CTA cluster -------------------


def _bwd_inputs(dev, batch, side):
    h, t, _ = _inputs(dev, batch, side)
    g = np.random.default_rng(5).normal(size=tuple(h.shape))
    return t, h, torch.from_numpy(g.astype(np.float32)).to(dev)


def _bwd_outputs(w, t, h, g, groups=32, precision="f32"):
    """One backward call's every output: (dθ flat, dt, dh, f, r1, r2, gu,
    gv)."""
    res = {}
    dp, dt, dh, f = odefunc_bwd(w, t, h, g, groups=groups, with_f=True,
                                residuals=res, precision=precision)
    return (_flat(dp), dt, dh, f, *(res[k] for k in ("r1", "r2", "gu", "gv")))


def _held_to_f64(w, t, h, g, got, groups=32):
    w64 = type(w)(*(x.double() for x in w))
    dp_p, dt_p, dh_p = odefunc_bwd_plain(w64, t.double(), h.double(),
                                         g.double(), groups)
    np.testing.assert_allclose(got[2].cpu().numpy(), dh_p.cpu().numpy(),
                               **STATE_TOL)
    np.testing.assert_allclose(got[1].cpu().numpy(), dt_p.cpu().numpy(),
                               **STATE_TOL)
    np.testing.assert_allclose(got[0].cpu().numpy(),
                               _flat(dp_p).cpu().numpy(), **DP_TOL)


@pytest.mark.parametrize("batch,side", [(128, 7), (16, 7), (5, 7), (1, 7),
                                        (128, 6), (16, 6)])
def test_cluster_pass_matches_plain(dev, batch, side):
    """The f32 backward at 7×7×64 and 6×6×64 runs the cluster pass (two
    CTAs a sample): within the bars of the float64 plain version, f the
    ODEfunc kernel's bit for bit, every output (dθ, dt, dh, f and the
    residuals r1, r2, gu, gv) bit-identical from launch to launch, one
    launch counted per call."""
    assert sample_pass((side, side), 64, 32) == "cluster"
    params = init_odenet(2, ENTRY_CONFIG, device=dev)
    w = prepare(params["odefunc"], (side, side))
    t, h, g = _bwd_inputs(dev, batch, side)
    before = odefunc_bwd.launches
    got = _bwd_outputs(w, t, h, g)
    assert odefunc_bwd.launches == before + 1
    assert torch.equal(got[3], odefunc(w, t, h, groups=32))
    _held_to_f64(w, t, h, g, got)
    again = _bwd_outputs(w, t, h, g)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("side", [7, 6])
def test_cluster_pass_rows_do_not_depend_on_the_batch(dev, side):
    """A sample's cluster computes its rows alone: the rows of a B = 16, 5
    and 1 launch (dt, dh, f and the residuals) are bit-identical to the
    same rows of a B = 128 launch."""
    params = init_odenet(2, ENTRY_CONFIG, device=dev)
    w = prepare(params["odefunc"], (side, side))
    t, h, g = _bwd_inputs(dev, 128, side)
    full = _bwd_outputs(w, t, h, g)
    for nb in (16, 5, 1):
        part = _bwd_outputs(w, *(a[:nb].contiguous() for a in (t, h, g)))
        for a, b in zip(part[1:], full[1:]):
            assert torch.equal(a, b[:nb]), nb


@pytest.mark.parametrize("hw,groups", [((5, 5), 32), ((3, 8), 32),
                                       ((7, 7), 16), ((7, 7), 64),
                                       ((7, 7), 1)])
def test_cluster_gate_at_other_maps_and_groups(dev, hw, groups):
    """The gate's other shapes at C = 64: any map the tensor cores take
    with an even group count runs the cluster pass, an odd count (G = 1: a
    group over both halves) the one-CTA pass; each within the bars of the
    float64 plain version."""
    want = "cluster" if groups % 2 == 0 else "cta"
    assert sample_pass(hw, 64, groups) == want
    params = init_odenet(2, ENTRY_CONFIG, device=dev)
    w = prepare(params["odefunc"], hw)
    rng = np.random.default_rng(6)
    arr = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    h = arr(rng.normal(size=(9, *hw, 64)) * 0.3)
    t = arr(rng.uniform(0.0, 0.5, 9))
    g = arr(rng.normal(size=(9, *hw, 64)))
    _held_to_f64(w, t, h, g, _bwd_outputs(w, t, h, g, groups), groups)


def test_graph_counts_the_cluster_pass(dev):
    """A backward call captured in a CUDA graph: its kernel nodes hold the
    cluster pass once, launched as two CTAs of ``PAIR_THREADS`` threads a
    sample with ``cluster_smem_bytes`` of dynamic shared memory, which the
    graph route counts as one ``odefunc_bwd`` launch of the f32 build (and
    none of the bf16 build); a replay gives the eager call's bits."""
    from neural_ode_features_tpu_torch.solver import attempt_graph

    params = init_odenet(2, ENTRY_CONFIG, device=dev)
    w = prepare(params["odefunc"], (7, 7))
    t, h, g = _bwd_inputs(dev, 16, 7)
    want = _bwd_outputs(w, t, h, g)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        got = _bwd_outputs(w, t, h, g)
        graph.capture_end()
    nodes = attempt_graph.kernel_nodes(graph.raw_cuda_graph())
    launches = [k[1:] for k in attempt_graph.kernel_launches(
        graph.raw_cuda_graph()) if "bwd_sample_kernel_cluster" in k[0]]
    graph.instantiate()
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert sum(c for n, c in nodes.items()
               if "bwd_sample_kernel_cluster" in n) == 1
    assert launches == [((2 * 16, 1, 1), (PAIR_THREADS, 1, 1),
                         cluster_smem_bytes((7, 7), 64, 32))]
    rules = {(fn.__name__, attr): k for fn, attr, k
             in attempt_graph._kernel_wrappers()}
    assert attempt_graph._count(nodes, rules[("odefunc_bwd",
                                              "launches")]) == 1
    assert attempt_graph._count(nodes, rules[("odefunc_bwd",
                                              "launches_bf16")]) == 0


# ---- the bf16 build: its per-sample pass as a cluster, its convs on wgmma --


def _captured_sample_passes(fn):
    """The per-sample kernel nodes of ``fn()`` captured into a CUDA graph
    (not run): ``(mangled name, grid, block, dynamic shared memory)``."""
    from neural_ode_features_tpu_torch.solver import attempt_graph

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    try:
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                fn()
            finally:
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        return [k for k in attempt_graph.kernel_launches(
            graph.raw_cuda_graph()) if "bwd_sample_kernel" in k[0]]
    finally:
        graph.reset()


@pytest.mark.parametrize("batch,side", [(128, 7), (16, 7), (5, 7), (128, 6)])
def test_bf16_cluster_pass_matches_plain(dev, batch, side):
    """The bf16 backward at 7×7×64 and 6×6×64 runs the cluster pass, read
    from a CUDA-graph kernel node (``bwd_sample_kernel_cluster``'s kBf16
    build, two CTAs of ``PAIR_THREADS`` a sample with the bf16
    ``cluster_smem_bytes``): each output within ``bf16_distances.BARS`` of
    the plain bf16 VJP (dh, dt and the early leaves below the f32 build's
    distance), f the bf16 ODEfunc kernel's bit for bit, every output and dθ
    bit-identical over two launches, one ``launches_bf16`` per call."""
    assert sample_pass((side, side), 64, 32, "bf16") == "cluster"
    params = init_odenet(2, ENTRY_CONFIG, device=dev)
    w = prepare(params["odefunc"], (side, side))
    t, h, g = _bwd_inputs(dev, batch, side)
    ran = _captured_sample_passes(
        lambda: odefunc_bwd(w, t, h, g, groups=32, precision="bf16"))
    assert [(("bwd_sample_kernel_clusterILi2EE" in k[0]), *k[1:])
            for k in ran] == [(True, (2 * batch, 1, 1), (PAIR_THREADS, 1, 1),
                               cluster_smem_bytes((side, side), 64, 32,
                                                  "bf16"))]
    before = (odefunc_bwd.launches, odefunc_bwd.launches_bf16)
    readings = bf16_distances.bwd_readings(w, t, h, g, 32)
    # bwd_readings: two launches of the bf16 build, one of the f32 build
    assert (odefunc_bwd.launches, odefunc_bwd.launches_bf16) == (
        before[0] + 1, before[1] + 2)
    assert readings["f_equal"] and readings["repeatable"], readings
    assert readings["bf16_values"], readings
    assert not bf16_distances.check(readings), readings
    got = _bwd_outputs(w, t, h, g, precision="bf16")
    again = _bwd_outputs(w, t, h, g, precision="bf16")
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("side", [7, 6])
def test_bf16_cluster_pass_rows_do_not_depend_on_the_batch(dev, side):
    """A sample's cluster computes its rows alone in the bf16 build too:
    the rows of a B = 16, 5 and 1 launch (dt, dh, f and the residuals) are
    bit-identical to the same rows of a B = 128 launch."""
    params = init_odenet(2, ENTRY_CONFIG, device=dev)
    w = prepare(params["odefunc"], (side, side))
    t, h, g = _bwd_inputs(dev, 128, side)
    full = _bwd_outputs(w, t, h, g, precision="bf16")
    for nb in (16, 5, 1):
        part = _bwd_outputs(w, *(a[:nb].contiguous() for a in (t, h, g)),
                            precision="bf16")
        for a, b in zip(part[1:], full[1:]):
            assert torch.equal(a, b[:nb]), nb


@pytest.mark.parametrize("side", [7, 6])
def test_bf16_odefunc_on_the_wgmma_stage(dev, side):
    """The bf16 ODEfunc kernel at 7×7×64 and 6×6×64 runs ``wgmma_bf16``
    (the gate): within ``bf16_distances.BARS`` of the plain bf16 f at
    B = 256 and 5, its rows independent of the batch, and a weight changed
    in place reaches the next launch and a graph replay (the stage converts
    the f32 weights at every launch), bit for bit."""
    assert stage((side, side), 64, "bf16") == "wgmma_bf16"
    params = init_odenet(1, ENTRY_CONFIG, device=dev)
    wt = prepare(params["odefunc"], (side, side))
    h, t0, _ = _inputs(dev, 256, side)
    for nb in (256, 5):
        readings = bf16_distances.odefunc_readings(
            wt, t0[:nb].contiguous(), h[:nb].contiguous(), 32)
        assert not bf16_distances.check(readings), readings

    def fn(b=256):
        return odefunc(wt, t0[:b].contiguous(), h[:b].contiguous(),
                       groups=32, compute_dtype=torch.bfloat16)

    full = fn()
    assert torch.equal(fn(5), full[:5])
    side_s = torch.cuda.Stream()
    side_s.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side_s):
        graph.capture_begin(capture_error_mode="thread_local")
        out = fn()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side_s)
    with torch.no_grad():
        wt.w2.mul_(1.25)
    eager = fn().clone()
    assert not torch.equal(eager, full)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)



@pytest.mark.parametrize("side,c", [(7, 96), (7, 128), (6, 256), (7, 512)])
def test_bf16_rows_build_is_the_per_sample_build(dev, side, c):
    """At C = 96 to 512 the bf16 ODEfunc runs the rows build (``stage``
    ``'rows_bf16'``: seven launches a call, each conv one bf16 ``wgmma``
    GEMM over the rows of every sample): bit for bit the per-sample kernel
    it replaced (``probes/timing_aids.py`` ``odefunc_cta_bf16``) at B = 256
    and 5, a row independent of its batch, within ``bf16_distances.BARS``
    of the plain bf16 f, one ``launches_bf16`` a call, and a captured call
    counted once by the graph route (its last kernel), replayed after an
    in-place weight change bit for bit the eager call's."""
    from neural_ode_features_tpu_torch.probes.timing_aids import (
        odefunc_cta_bf16,
    )
    from neural_ode_features_tpu_torch.solver import attempt_graph

    assert stage((side, side), c, "bf16") == "rows_bf16"
    cfg = dataclasses.replace(ENTRY_CONFIG, hidden=c)
    params = init_odenet(2, cfg, device=dev)
    wt = prepare(params["odefunc"], (side, side))
    rng = np.random.default_rng(c)
    h = torch.from_numpy((rng.normal(size=(256, side, side, c)) * 0.3)
                         .astype(np.float32)).to(dev)
    t0 = torch.from_numpy(rng.uniform(0, 1, 256).astype(np.float32)).to(dev)

    def fn(b=256):
        return odefunc(wt, t0[:b].contiguous(), h[:b].contiguous(),
                       groups=32, compute_dtype=torch.bfloat16)

    before = odefunc.launches_bf16
    full = fn()
    torch.cuda.synchronize()
    assert odefunc.launches_bf16 == before + 1
    assert torch.equal(full, odefunc_cta_bf16(wt, t0, h, 32))
    assert torch.equal(fn(5), full[:5])
    assert torch.equal(odefunc_cta_bf16(wt, t0[:5].contiguous(),
                                        h[:5].contiguous(), 32), full[:5])
    readings = bf16_distances.odefunc_readings(wt, t0, h, 32)
    assert not bf16_distances.check(readings), readings
    side_s = torch.cuda.Stream()
    side_s.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.stream(side_s):
        graph.capture_begin(capture_error_mode="thread_local")
        out = fn()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side_s)
    rules = {(w.__name__, a): k for w, a, k
             in attempt_graph._kernel_wrappers()}
    nodes = attempt_graph.kernel_nodes(graph.raw_cuda_graph())
    assert attempt_graph._count(nodes, rules[("odefunc", "launches_bf16")]) == 1
    assert attempt_graph._count(nodes, rules[("odefunc", "launches")]) == 0
    graph.instantiate()
    with torch.no_grad():
        wt.w1.mul_(1.25)
    eager = fn().clone()
    assert not torch.equal(eager, full)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.parametrize("side,c", [(7, 96), (7, 128), (6, 256), (7, 512),
                                    (6, 512)])
def test_bf16_rows_backward_is_the_per_sample_pass(dev, side, c):
    """At C = 96 to 512 the bf16 backward runs the rows backward
    (``sample_pass`` ``'rows'``: its four convs ``rows_conv_kernel``
    launches, two of each packing, and no ``bwd_sample_kernel``, read from
    a captured call's kernel nodes): every output (dθ, dt, dh, f and the
    residuals r1, r2, gu, gv) bit for bit the one-CTA pass it replaced
    (``probes/timing_aids.py`` ``odefunc_bwd_cta_bf16``) at B = 128 and 5,
    a B = 5 batch's rows those of the B = 128 batch, dθ bit-identical
    across two launches, within ``bf16_distances.BARS`` of the plain bf16
    VJP, one ``launches_bf16`` a call, and the captured call counted once by
    the graph route and, replayed after an in-place weight change, the
    eager call's bits."""
    from neural_ode_features_tpu_torch.probes.timing_aids import (
        odefunc_bwd_cta_bf16,
    )
    from neural_ode_features_tpu_torch.solver import attempt_graph

    assert sample_pass((side, side), c, 32, "bf16") == "rows"
    cfg = dataclasses.replace(ENTRY_CONFIG, hidden=c)
    wt = prepare(init_odenet(3, cfg, device=dev)["odefunc"], (side, side))
    rng = np.random.default_rng(c + side)
    arr = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    h = arr(rng.normal(size=(128, side, side, c)) * 0.3)
    g = arr(rng.normal(size=h.shape))
    t = arr(rng.uniform(0, 1, 128))

    def outs(res, extra):
        dp, dt, dh, f = res
        return [*(dp[a][b] for a in sorted(dp) for b in sorted(dp[a])), dt,
                dh, f, *(extra[k] for k in sorted(extra))]

    def fn(b=128, residuals=None):
        return odefunc_bwd(wt, t[:b].contiguous(), h[:b].contiguous(),
                           g[:b].contiguous(), groups=32, with_f=True,
                           precision="bf16", residuals=residuals)

    for b in (128, 5):
        before = odefunc_bwd.launches_bf16, odefunc_bwd.launches
        res, res_cta = {}, {}
        got = outs(fn(b, res), res)
        torch.cuda.synchronize()
        assert (odefunc_bwd.launches_bf16, odefunc_bwd.launches) == (
            before[0] + 1, before[1])
        want = outs(odefunc_bwd_cta_bf16(
            wt, t[:b].contiguous(), h[:b].contiguous(), g[:b].contiguous(),
            32, with_f=True, residuals=res_cta), res_cta)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        assert all(torch.equal(x, y) for x, y in zip(outs(fn(b), {}), got))
        if b == 128:
            full = got
            f128 = got[-5]  # f, before the four residuals
    assert all(torch.equal(x[:5], y[:5]) for x, y in zip(
        full[-7:], got[-7:]))  # dt, dh, f and the residuals, per row
    readings = bf16_distances.bwd_readings(wt, t, h, g, 32)
    assert not bf16_distances.check(readings), readings
    side_s = torch.cuda.Stream()
    side_s.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.stream(side_s):
        graph.capture_begin(capture_error_mode="thread_local")
        out = fn()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side_s)
    names = [k[0] for k in attempt_graph.kernel_launches(
        graph.raw_cuda_graph())]
    assert sum("rows_conv_kernel" in n for n in names) == 4
    assert sum("rows_pack_kernelILb1ELb1E" in n for n in names) == 2
    assert sum("rows_pack_kernelILb1ELb0E" in n for n in names) == 2
    assert not any("bwd_sample_kernel" in n for n in names)
    rules = {(w.__name__, a): k for w, a, k
             in attempt_graph._kernel_wrappers()}
    nodes = attempt_graph.kernel_nodes(graph.raw_cuda_graph())
    assert attempt_graph._count(
        nodes, rules[("odefunc_bwd", "launches_bf16")]) == 1
    for key in (("odefunc_bwd", "launches"), ("odefunc", "launches_bf16")):
        assert attempt_graph._count(nodes, rules[key]) == 0
    graph.instantiate()
    with torch.no_grad():
        wt.w2.mul_(1.25)
    eager = [x.clone() for x in outs(fn(), {})]
    assert not torch.equal(eager[-1], f128)  # f moved with w2
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(outs(out, {}), eager))


@pytest.mark.parametrize("batch,hh,ww,c", [
    (256, 7, 7, 256), (256, 7, 7, 512), (5, 6, 6, 512), (5, 7, 7, 160),
    (3, 14, 14, 96), (5, 7, 7, 72)])
def test_rows_kernel_strategies_are_mma_bf16(dev, batch, hh, ww, c):
    """Past C = 64 at C % 8 == 0 the probe's ``tap9_bf16`` runs the rows
    kernel (``csrc/rows_conv.cuh``): bit for bit ``mma_bf16`` where that
    runs, ``im2col_bf16`` too where C % 64 == 0; both tiles alike; a slice
    of the batch gives the same rows; within the f32 reassociation of the
    plain bf16 conv; one launch a call."""
    from neural_ode_features_tpu_torch.kernels.conv3x3 import supported

    x, w = probe_inputs(batch, dev, (hh, ww), c)
    before = conv3x3.launches
    got = conv3x3(x, w, "tap9_bf16")
    torch.cuda.synchronize()
    assert conv3x3.launches == before + 1
    np.testing.assert_allclose(
        got.cpu().numpy(),
        conv3x3_plain(x, w, passes="bf16").cpu().numpy(), **CONV_TOL)
    for rows in (64, 128):
        assert torch.equal(conv3x3(x, w, "tap9_bf16", tile_rows=rows), got)
    if supported((hh, ww), c, "mma_bf16"):
        assert torch.equal(conv3x3(x, w, "mma_bf16"), got)
    if c % 64 == 0:
        assert torch.equal(conv3x3(x, w, "im2col_bf16"), got)
    if batch > 3:
        assert torch.equal(conv3x3(x[1:4].contiguous(), w, "tap9_bf16"),
                           got[1:4])


# ---- the probe's im2col_bf16 on bf16 wgmma, and its wgmma_bf16 strategy ----


@pytest.mark.parametrize("batch,hh,ww,c", [
    (256, 7, 7, 64), (128, 7, 7, 64), (5, 7, 7, 64), (256, 6, 6, 64),
    (5, 6, 6, 64), (5, 5, 5, 128), (5, 9, 8, 64), (5, 7, 7, 36),
    (3, 7, 7, 4), (3, 32, 32, 4), (5, 7, 7, 96), (2, 14, 14, 16)])
def test_im2col_bf16_matches_plain(dev, batch, hh, ww, c):
    """The bf16 ``wgmma`` GEMM over flattened rows against the plain bf16
    conv (f32 reassociation of exact products), apart from the f32 conv,
    at shapes of the old gate and beyond it (5×5×128, 9×8×64, C % 16 !=
    0); against the f64 conv of the rounded operands within the probe's
    bar of ``mma_bf16``'s where that runs."""
    from neural_ode_features_tpu_torch.kernels.conv3x3 import supported
    from neural_ode_features_tpu_torch.kernels.odefunc import bf16_round
    from neural_ode_features_tpu_torch.probes.conv_probe import WGMMA_BAR

    x, w = probe_inputs(batch, dev, (hh, ww), c)
    before = conv3x3.launches
    got = conv3x3(x, w, "im2col_bf16")
    torch.cuda.synchronize()
    assert conv3x3.launches == before + 1
    plain = conv3x3_plain(x, w, passes="bf16")
    np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(),
                               **CONV_TOL)
    assert not torch.allclose(got, conv3x3_plain(x, w), **CONV_TOL)
    if supported((hh, ww), c, "mma_bf16"):
        exact = conv3x3_plain(bf16_round(x).double(), bf16_round(w).double())
        err = float((got.double() - exact).abs().max())
        err_mma = float((conv3x3(x, w, "mma_bf16").double() - exact)
                        .abs().max())
        assert err <= WGMMA_BAR * err_mma, (err, err_mma)


def test_im2col_bf16_rows_do_not_depend_on_the_batch_or_tile(dev):
    """A row's sums are its own: 64- and 128-row tiles give the same bits,
    and the first 5 samples alone (a partial last tile) give the B = 256
    launch's rows, whose tiles cross sample boundaries."""
    x, w = probe_inputs(256, dev)
    full = conv3x3(x, w, "im2col_bf16", tile_rows=64)
    assert torch.equal(conv3x3(x, w, "im2col_bf16", tile_rows=128), full)
    assert torch.equal(conv3x3(x[:5].contiguous(), w, "im2col_bf16"),
                       full[:5])
    assert torch.equal(conv3x3(x[3:9].contiguous(), w, "im2col_bf16"),
                       full[3:9])


@pytest.mark.parametrize("side", [7, 6])
def test_wgmma_bf16_strategy_matches_plain(dev, side):
    """The bf16 ``odefunc``'s conv stage alone (x rounded as it is copied
    in) against the plain bf16 conv; the shapes it refuses raise."""
    x, w = probe_inputs(256, dev, (side, side))
    got = conv3x3(x, w, "wgmma_bf16")
    np.testing.assert_allclose(
        got.cpu().numpy(),
        conv3x3_plain(x, w, passes="bf16").cpu().numpy(), **CONV_TOL)
    x32, w32 = probe_inputs(2, dev, (7, 7), 32)
    with pytest.raises(ValueError, match="does not take"):
        conv3x3(x32, w32, "wgmma_bf16")


# ---- the probe's tap9_bf16 on bf16 wgmma, and the fused step's bf16 stage --


@pytest.mark.parametrize("batch,hh,ww,c", [
    (256, 7, 7, 64), (128, 7, 7, 64), (5, 7, 7, 64), (256, 6, 6, 64),
    (256, 8, 8, 64), (256, 7, 7, 32), (5, 4, 4, 128), (5, 7, 7, 128),
    (3, 32, 32, 4), (5, 7, 7, 36), (2, 14, 14, 16)])
def test_tap9_bf16_matches_plain(dev, batch, hh, ww, c):
    """Nine per-tap bf16 ``wgmma`` products over the rows of every sample
    against the plain bf16 conv (f32 reassociation of exact products),
    apart from the f32 conv, at shapes of the old FFMA gate (7×7×32, 8×8×64,
    4×4×128) and beyond it; against the f64 conv of the rounded operands
    within the probe's bar of ``mma_bf16``'s where that runs; one launch a
    call."""
    from neural_ode_features_tpu_torch.kernels.conv3x3 import supported
    from neural_ode_features_tpu_torch.kernels.odefunc import bf16_round
    from neural_ode_features_tpu_torch.probes.conv_probe import WGMMA_BAR

    x, w = probe_inputs(batch, dev, (hh, ww), c)
    before = conv3x3.launches
    got = conv3x3(x, w, "tap9_bf16")
    torch.cuda.synchronize()
    assert conv3x3.launches == before + 1
    np.testing.assert_allclose(
        got.cpu().numpy(),
        conv3x3_plain(x, w, passes="bf16").cpu().numpy(), **CONV_TOL)
    assert not torch.allclose(got, conv3x3_plain(x, w), **CONV_TOL)
    if supported((hh, ww), c, "mma_bf16"):
        exact = conv3x3_plain(bf16_round(x).double(), bf16_round(w).double())
        err = float((got.double() - exact).abs().max())
        err_mma = float((conv3x3(x, w, "mma_bf16").double() - exact)
                        .abs().max())
        assert err <= WGMMA_BAR * err_mma, (err, err_mma)


def test_tap9_bf16_rows_do_not_depend_on_the_batch_or_tile(dev):
    """A row's sums are its own: 64- and 128-row tiles give the same bits,
    and a slice of the batch gives the B = 256 launch's rows.  At C = 64 a
    stage is one tap, summed as ``im2col_bf16`` sums one: its bits."""
    x, w = probe_inputs(256, dev)
    full = conv3x3(x, w, "tap9_bf16", tile_rows=64)
    assert torch.equal(conv3x3(x, w, "im2col_bf16"), full)
    assert torch.equal(conv3x3(x, w, "tap9_bf16", tile_rows=128), full)
    assert torch.equal(conv3x3(x[3:9].contiguous(), w, "tap9_bf16"),
                       full[3:9])


def test_tap9_ffma_reading_matches_plain(dev):
    """The fused bf16 builds' FFMA stage alone (``probes/timing_aids.py``
    ``tap9_ffma_bf16``, no strategy of the probe) against the plain bf16
    conv at 7×7×64 and 7×7×32; it counts no probe launch."""
    from neural_ode_features_tpu_torch.probes.timing_aids import (
        tap9_ffma_bf16,
    )

    for c in (64, 32):
        x, w = probe_inputs(64, dev, (7, 7), c)
        before = conv3x3.launches
        got = tap9_ffma_bf16(x, w)
        torch.cuda.synchronize()
        assert conv3x3.launches == before
        np.testing.assert_allclose(
            got.cpu().numpy(),
            conv3x3_plain(x, w, passes="bf16").cpu().numpy(), **CONV_TOL)


@pytest.mark.parametrize("side", [7, 6])
def test_bf16_step_conv_stage_is_the_bf16_odefunc_stage(dev, side):
    """At 7×7×64 and 6×6×64 the fused step's bf16 convs run ``wgmma_bf16``
    (the gate); each of its six evaluations stays within the bars of the
    plain bf16-conv evaluation at the stage input its own stages give."""
    assert stage((side, side), 64, "bf16_conv") == "wgmma_bf16"
    readings = bf16_distances.readings_at(side, side, 64, 32, dev)
    assert not bf16_distances.check(readings["rk_step"])
