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
from neural_ode_features_tpu.models import odenet_logits as jax_logits
from neural_ode_features_tpu.models.odenet import (
    fused_rk_eligible as jax_fused_eligible,
)
from neural_ode_features_tpu_torch.entry import ENTRY_CONFIG, entry
from neural_ode_features_tpu_torch.models import (
    ModelConfig,
    fused_rk_eligible,
    odenet_logits,
)
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
    with pytest.raises(NotImplementedError, match="adjoint"):
        odenet_logits(params, torch.zeros(1, 32, 32, 3), cfg, adjoint=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        odenet_logits(params, torch.zeros(1, 32, 32, 3),
                      dataclasses.replace(cfg, downsampling="res"))
