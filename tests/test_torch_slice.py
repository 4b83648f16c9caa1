"""Port parity, the slice as a whole: CIFAR-10 ODE-Net inference with
per-sample dopri5 at tol 1e-3, full width (hidden 64), B = 8, on the CPU.

The JAX reference runs both with its kernels (``use_pallas=use_fused_rk=
True``, Pallas in interpret mode; the fused step's JAX gate needs B >= 8)
and with the plain config.  The port, on the same weights and input, must
give exactly the same per-sample NFE and logits within rtol = atol = 1e-3."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.models import ModelConfig as JaxConfig
from neural_ode_features_tpu.models import init_odenet as jax_init_odenet
from neural_ode_features_tpu.models import odefunc_apply as jax_odefunc
from neural_ode_features_tpu.models import odenet_logits as jax_logits
from neural_ode_features_tpu.kernels.odefunc_pallas import (
    pallas_supported as jax_pallas_supported,
)
from neural_ode_features_tpu.models.odenet import (
    fused_rk_eligible as jax_fused_eligible,
)
from neural_ode_features_tpu_torch.entry import ENTRY_CONFIG, entry
from neural_ode_features_tpu_torch.kernels.odefunc import (
    WGMMA_C,
    odefunc,
    stage,
    supported,
)
from neural_ode_features_tpu_torch.kernels.odefunc_bwd import (
    bwd_supported,
    odefunc_bwd,
)
from neural_ode_features_tpu_torch.models import (
    ModelConfig,
    fused_rk_eligible,
    init_odenet,
    odefunc_apply,
    odenet_logits,
)
from neural_ode_features_tpu_torch.training import TrainConfig, Trainer
from neural_ode_features_tpu_torch.utils import from_jax_params

torch.set_num_threads(2)

B = 8


@pytest.fixture(scope="module")
def slice_inputs():
    cfg_j = JaxConfig(in_channels=3, tol=1e-3, error_control="per_sample")
    params_j = jax_init_odenet(jax.random.PRNGKey(7), cfg_j)
    x = np.random.default_rng(0).normal(size=(B, 32, 32, 3)).astype(np.float32)
    logits, stats = odenet_logits(from_jax_params(params_j, device="cpu"),
                                  torch.from_numpy(x), ENTRY_CONFIG)
    return cfg_j, params_j, x, logits.numpy(), stats


@pytest.mark.parametrize("jax_kernels", [True, False])
def test_slice_matches_jax(slice_inputs, jax_kernels):
    cfg_j, params_j, x, logits, stats = slice_inputs
    cfg_j = dataclasses.replace(cfg_j, use_pallas=jax_kernels,
                                use_fused_rk=jax_kernels)
    assert jax_fused_eligible(cfg_j, (B, 7, 7, 64), jnp.float32) == jax_kernels
    logits_j, stats_j = jax_logits(params_j, jnp.asarray(x), cfg_j)
    np.testing.assert_array_equal(stats.nfe.numpy(), np.asarray(stats_j.nfe))
    np.testing.assert_array_equal(stats.naccept.numpy(),
                                  np.asarray(stats_j.naccept))
    assert bool(stats.success.all())
    np.testing.assert_allclose(logits, np.asarray(logits_j), rtol=1e-3,
                               atol=1e-3)


def test_hidden_128_matches_jax():
    """The widest common width the kernels newly take, on the CPU plain
    path: hidden 128, 7×7, B = 2.  f(t, h) within 1e-5 of the JAX
    package's; one dopri5 solve's per-sample NFE equal and logits within
    rtol = atol = 1e-3."""
    cfg_j = JaxConfig(in_channels=3, hidden=128, tol=1e-3,
                      error_control="per_sample")
    params_j = jax_init_odenet(jax.random.PRNGKey(8), cfg_j)
    params = from_jax_params(params_j, device="cpu")
    cfg = ModelConfig(in_channels=3, hidden=128)
    rng = np.random.default_rng(2)
    h = (rng.normal(size=(2, 7, 7, 128)) * 0.5).astype(np.float32)
    t = np.float32(0.3)
    want = np.asarray(jax_odefunc(params_j["odefunc"], jnp.float32(t),
                                  jnp.asarray(h), cfg_j))
    got = odefunc_apply(params["odefunc"], torch.tensor(t),
                        torch.from_numpy(h), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    logits_j, stats_j = jax_logits(params_j, jnp.asarray(x), cfg_j)
    logits, stats = odenet_logits(params, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(stats.nfe.numpy(), np.asarray(stats_j.nfe))
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                               rtol=1e-3, atol=1e-3)


def test_entry_on_cpu():
    fwd, (params, x) = entry(device="cpu", batch=2)
    assert x.shape == (2, 32, 32, 3) and x.dtype == torch.float32
    logits, nfe = fwd(params, x)
    assert logits.shape == (2, 10) and bool(torch.isfinite(logits).all())
    assert nfe.shape == (2,) and bool((nfe >= 8).all())
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_fused_eligibility_and_refusals():
    cfg = ModelConfig(in_channels=3)
    assert fused_rk_eligible(cfg, (4, 7, 7, 64), torch.float32)
    for change in ({"method": "bosh3"}, {"error_control": "global"},
                   {"compute_dtype": "bfloat16"}):
        assert not fused_rk_eligible(dataclasses.replace(cfg, **change),
                                     (4, 7, 7, 64), torch.float32)
    params = {"stem": {}, "odefunc": {}, "head": {}}
    x = torch.zeros(1, 32, 32, 3)
    # The adjoint variants run now; what stays refused is a combination
    # with no meaning, where the caller passed it.
    with pytest.raises(ValueError, match="seminorm.*fixed-grid"):
        odenet_logits(params, x, dataclasses.replace(
            cfg, adjoint_seminorm=True, method="rk4"), adjoint=True)
    with pytest.raises(ValueError, match="interpolated.*adaptive RK"):
        odenet_logits(params, x, dataclasses.replace(
            cfg, adjoint_mode="interpolated", method="euler"), adjoint=True)
    # The adjoint path takes one float tol (tests/test_torch_training.py),
    # not a per-row grid.
    with pytest.raises(ValueError, match="inference path"):
        odenet_logits(params, x, cfg, adjoint=True,
                      tol=torch.tensor([1e-2, 1e-3]))
    assert Trainer(TrainConfig(model="resnet", hidden=32), steps_per_epoch=1,
                   device="cpu").cfg.model == "resnet"
    with pytest.raises(ValueError, match="unknown downsampling"):
        init_odenet(0, dataclasses.replace(cfg, downsampling="pool"),
                    device="cpu")


@pytest.mark.parametrize("c", [*range(32, 577, 32), 16, 48, 80, 100])
def test_widths_outside_the_kernels_gate_are_refused(c):
    """The kernels' gate is the JAX kernels' gate: on 7×7 (CIFAR-10) and
    6×6 (MNIST) maps with groups 32, ``supported``, ``bwd_supported`` and
    ``stage`` accept exactly the widths JAX ``pallas_supported`` accepts
    (every multiple of 32 up to 512; C = 32 on the FFMA stage, the rest on
    the tensor cores: ``wgmma3`` at the widths of ``WGMMA_C`` in the f32
    builds, ``mma3`` at the rest and in the bf16 builds).  Off the CPU a wrapper launches its kernel or
    raises; a refused shape raises before anything is launched, naming the
    JAX gate's clause.  Meta tensors stand in for the card's: they get past
    the CPU branch and fail the device check, so only the shape gate can
    refuse first."""
    for hw in ((7, 7), (6, 6)):
        ok = jax_pallas_supported(np.zeros((2, *hw, c), np.float32), 32)
        assert ok == (c % 32 == 0 and c <= 512)
        assert supported(hw, c, 32) == bwd_supported(hw, c, 32) == ok
        tc = ok and c >= 64
        assert stage(hw, c, "bf16") == ("mma3" if tc else "ffma")
        assert stage(hw, c) == (("wgmma3" if c in WGMMA_C else "mma3") if tc
                                else "ffma")
    cfg = ModelConfig(in_channels=3, hidden=c)
    p = init_odenet(0, cfg, device="cpu")["odefunc"]
    p = torch.utils._pytree.tree_map(lambda t: t.to("meta"), p)
    h = torch.zeros(2, 7, 7, c, device="meta")
    clause = "C % groups != 0" if c % 32 else "C > 512"
    for fn, what in ((lambda: odefunc(p, 0.5, h), "kernels do not take"),
                     (lambda: odefunc_bwd(p, 0.5, h, h),
                      "backward kernel does not take")):
        with pytest.raises(ValueError) as err:
            fn()
        msg = str(err.value)
        if ok:
            assert "expected CUDA" in msg
        else:
            assert what in msg and clause in msg and "Queue" not in msg
