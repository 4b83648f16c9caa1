"""Port parity, kernel modules: the plain PyTorch versions of the CUDA
kernels against the JAX Pallas kernels (interpret mode, as
tests/test_pallas.py and tests/test_fused_rk.py run them) and the JAX jnp
path, on the CPU.  The kernels themselves run only on a CUDA card, in
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.kernels.odefunc_pallas import odefunc_pallas
from neural_ode_features_tpu.kernels.rk_step_pallas import (
    make_fused_dopri5_step as jax_make_fused_step,
)
from neural_ode_features_tpu.models import ModelConfig as JaxConfig
from neural_ode_features_tpu.models import init_odenet as jax_init_odenet
from neural_ode_features_tpu.models.odenet import odefunc_apply as jax_odefunc
from neural_ode_features_tpu.solver.runge_kutta import _error_ratio, _rk_attempt
from neural_ode_features_tpu.solver.tableau import DOPRI5 as JAX_DOPRI5
from neural_ode_features_tpu_torch.kernels.odefunc import (
    odefunc,
    odefunc_plain,
    prepare,
    supported,
)
from neural_ode_features_tpu_torch.kernels.rk_step import (
    CONV_STRATEGIES,
    dopri5_step_plain,
    make_fused_dopri5_step,
)
from neural_ode_features_tpu_torch.models import ModelConfig, odefunc_apply
from neural_ode_features_tpu_torch.solver import DOPRI5
from neural_ode_features_tpu_torch.utils import from_jax_params

torch.set_num_threads(2)

RTOL = ATOL = 1e-3
STATE_TOL = dict(rtol=2e-4, atol=2e-5)
RATIO_TOL = dict(rtol=2e-3, atol=1e-6)


@pytest.fixture(scope="module")
def odefunc_params():
    cfg = JaxConfig(in_channels=3)
    pj = jax_init_odenet(jax.random.PRNGKey(0), cfg)["odefunc"]
    return cfg, pj, from_jax_params(pj, device="cpu")


def _state(seed, b, side, scale=0.3):
    return (np.random.default_rng(seed).normal(size=(b, side, side, 64))
            * scale).astype(np.float32)


@pytest.mark.parametrize("side,batch,t_kind", [
    (7, 8, "per_sample"), (6, 8, "per_sample"), (7, 5, "scalar")])
def test_odefunc_plain_matches_jax(odefunc_params, side, batch, t_kind):
    cfg, pj, pt = odefunc_params
    h = _state(1, batch, side, scale=1.0)
    t = (np.float32(0.37) if t_kind == "scalar" else
         np.random.default_rng(2).uniform(0, 1, batch).astype(np.float32))
    want_kernel = odefunc_pallas(pj, jnp.asarray(t), jnp.asarray(h),
                                 groups=cfg.groups, interpret=True)
    want_jnp = jax_odefunc(pj, jnp.asarray(t), jnp.asarray(h), cfg)
    got = odefunc_plain(prepare(pt, (side, side)), torch.as_tensor(t),
                        torch.from_numpy(h), cfg.groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel),
                               **STATE_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_jnp), **STATE_TOL)
    # The CPU wrapper and the model's dynamics take the same plain path.
    wrapped = odefunc(pt, torch.as_tensor(t), torch.from_numpy(h),
                      groups=cfg.groups)
    np.testing.assert_allclose(wrapped.numpy(), got.numpy(), rtol=0, atol=0)
    model = odefunc_apply(pt, torch.as_tensor(t), torch.from_numpy(h),
                          ModelConfig(in_channels=3))
    np.testing.assert_allclose(model.numpy(), got.numpy(), **STATE_TOL)


def _step_inputs(pj, cfg, b, side):
    h = _state(3, b, side)
    rng = np.random.default_rng(4)
    t0 = rng.uniform(0.0, 0.5, b).astype(np.float32)
    dt = rng.uniform(0.05, 0.2, b).astype(np.float32)
    f0 = np.array(jax_odefunc(pj, jnp.asarray(t0), jnp.asarray(h), cfg))
    return t0, dt, h.reshape(b, -1), f0.reshape(b, -1)


@pytest.mark.parametrize("batch,side", [(8, 7), (5, 7), (8, 6)])
def test_step_plain_matches_jax(odefunc_params, batch, side):
    """Against the JAX fused step (rollS, interpret; a ragged B=5 gets a
    tile of 5) and against JAX ``_rk_attempt`` + ``_error_ratio``."""
    cfg, pj, pt = odefunc_params
    t0, dt, y0, f0 = _step_inputs(pj, cfg, batch, side)

    def jfunc(t, y):
        return jax_odefunc(pj, t, y.reshape(batch, side, side, 64),
                           cfg).reshape(batch, -1)

    args = [jnp.asarray(a) for a in (t0, dt, y0, f0)]
    y1_r, err_r, f1_r, _, parts = _rk_attempt(JAX_DOPRI5, jfunc, *args,
                                              jnp.float32)
    ratio_r = _error_ratio(err_r, args[2], y1_r, RTOL, ATOL)
    fused_j = jax_make_fused_step(pj, JAX_DOPRI5, (side, side),
                                  groups=cfg.groups, rtol=RTOL, atol=ATOL,
                                  interpret=True, conv_strategy="rollS",
                                  tile=batch)(*args)

    got = dopri5_step_plain(
        prepare(pt, (side, side)), DOPRI5, *(torch.from_numpy(a) for a in
                                             (t0, dt, y0, f0)),
        hw=(side, side), groups=cfg.groups, rtol=RTOL, atol=ATOL)
    for want in ((y1_r, f1_r, parts()[2], ratio_r), fused_j):
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **STATE_TOL)
        np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                                   **RATIO_TOL)


def test_fused_step_builder(odefunc_params):
    cfg, pj, pt = odefunc_params
    with pytest.raises(ValueError, match="atol > 0"):
        make_fused_dopri5_step(pt, DOPRI5, (7, 7), rtol=1e-3, atol=0.0)
    with pytest.raises(NotImplementedError):
        make_fused_dopri5_step(pt, DOPRI5, (7, 7), rtol=1e-3, atol=1e-3,
                               conv_precision="bf16")
    with pytest.raises(ValueError, match="conv strategy"):
        make_fused_dopri5_step(pt, DOPRI5, (7, 7), rtol=1e-3, atol=1e-3,
                               conv_strategy="nope")
    # Every JAX strategy is the one kernel (on the CPU: its plain version).
    t0, dt, y0, f0 = (torch.from_numpy(a) for a in
                      _step_inputs(pj, cfg, 2, 7))
    outs = [make_fused_dopri5_step(pt, DOPRI5, (7, 7), rtol=1e-3, atol=1e-3,
                                   conv_strategy=s)(t0, dt, y0, f0)
            for s in CONV_STRATEGIES]
    for out in outs[1:]:
        for a, b in zip(out, outs[0]):
            assert torch.equal(a, b)


def test_gate():
    assert supported((7, 7), 64, 32)  # CIFAR-10
    assert supported((6, 6), 64, 32)  # MNIST
    assert supported((7, 7), 32, 32)
    assert not supported((7, 7), 128, 32)  # 13 conv pixels per thread
    assert not supported((7, 7), 48, 32)  # C % groups
    assert not supported((28, 28), 64, 32)  # shared memory
