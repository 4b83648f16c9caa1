"""The port's copy of the torch oracle (``oracle/torch_ref.py``, the bench's
CPU denominator) against the JAX package's: on the same weights, carried
across with ``utils.checkpoint.from_jax_params``, bit-identical logits and
equal NFE."""

import jax
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.models import ModelConfig as JaxConfig
from neural_ode_features_tpu.models import init_odenet as jax_init_odenet
from neural_ode_features_tpu.oracle.torch_ref import (
    build_torch_odenet as jax_build_torch_odenet,
)
from neural_ode_features_tpu.oracle.torch_ref import (
    load_jax_params_into_torch,
)
from neural_ode_features_tpu.oracle.torch_ref import (
    torch_odeint as jax_torch_odeint,
)
from neural_ode_features_tpu_torch.models import (
    ModelConfig,
    init_odenet,
    init_resnet,
)
from neural_ode_features_tpu_torch.oracle import (
    build_torch_odenet,
    load_params_into_torch,
    torch_odeint,
)
from neural_ode_features_tpu_torch.utils import from_jax_params

B, HIDDEN, TOL = 4, 32, 1e-2


@pytest.mark.parametrize("in_channels,side", [(3, 32), (1, 28)])
def test_oracle_matches_jax_oracle_bit_for_bit(in_channels, side):
    jcfg = JaxConfig(in_channels=in_channels, hidden=HIDDEN)
    jparams = jax.tree.map(lambda a: np.asarray(a, np.float32),
                           jax_init_odenet(jax.random.PRNGKey(3), jcfg))
    x = np.random.default_rng(0).normal(
        size=(B, side, side, in_channels)).astype(np.float32)
    xc = torch.from_numpy(x.transpose(0, 3, 1, 2))

    want_model = jax_build_torch_odenet(in_channels=in_channels,
                                        hidden=HIDDEN)
    load_jax_params_into_torch(want_model, jparams)
    got_model = build_torch_odenet(in_channels=in_channels, hidden=HIDDEN)
    load_params_into_torch(got_model, from_jax_params(jparams, device="cpu"))
    with torch.no_grad():
        want, want_nfe = want_model.eval()(xc, rtol=TOL, atol=TOL)
        got, got_nfe = got_model.eval()(xc, rtol=TOL, atol=TOL)
    assert got.shape == (B, 10) and bool(torch.isfinite(got).all())
    assert got_nfe == want_nfe and got_nfe >= 8
    assert torch.equal(got, want)


def test_odeint_matches_jax_oracle_on_a_closed_form():
    """Both host loops on y' = -λy over [0, 0.5, 1]: the same steps, the
    same values, and the closed form within the tolerance."""
    lam = torch.tensor([[0.5, 2.0, 8.0]], dtype=torch.float64)
    y0 = torch.ones_like(lam)
    ts = torch.tensor([0.0, 0.5, 1.0], dtype=torch.float64)
    ys, nfe = torch_odeint(lambda t, y: -lam * y, y0, ts, 1e-6, 1e-8)
    ys_j, nfe_j = jax_torch_odeint(lambda t, y: -lam * y, y0, ts, 1e-6,
                                   1e-8)
    assert nfe == nfe_j and torch.equal(ys, ys_j)
    exact = torch.exp(-lam * ts[:, None])
    np.testing.assert_allclose(ys[:, 0].numpy(), exact.numpy(), rtol=1e-4)


def test_loader_refuses_models_it_lacks():
    res = ModelConfig(in_channels=3, hidden=HIDDEN, downsampling="res")
    with pytest.raises(ValueError, match="'conv' downsampling stem"):
        load_params_into_torch(build_torch_odenet(in_channels=3,
                                                  hidden=HIDDEN),
                               init_odenet(0, res, device="cpu"))
    resnet = ModelConfig(in_channels=3, hidden=HIDDEN)
    with pytest.raises(ValueError, match="no torch-oracle counterpart"):
        load_params_into_torch(build_torch_odenet(in_channels=3,
                                                  hidden=HIDDEN),
                               init_resnet(0, resnet, device="cpu"))
