"""Port parity, ``solver/fixed_grid.py``: each of the five fixed-grid
methods against the JAX ``fixed_grid_odeint`` on the analytic problems of
``tests/problems.py`` (float64, rtol 1e-12: the same arithmetic in the same
order), plain autograd through a solve as the direct-backprop oracle, and
``odenet_logits`` with ``method='rk4'`` on carried weights (f32, atol
1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.models import ModelConfig as JaxConfig
from neural_ode_features_tpu.models import init_odenet as jax_init_odenet
from neural_ode_features_tpu.models import odenet_logits as jax_logits
from neural_ode_features_tpu.solver import odeint as jax_odeint
from neural_ode_features_tpu.solver.fixed_grid import (
    FIXED_GRID_METHODS as JAX_METHODS,
)
from neural_ode_features_tpu.solver.fixed_grid import (
    fixed_grid_odeint as jax_fixed_grid,
)
from neural_ode_features_tpu_torch.models import ModelConfig, odenet_logits
from neural_ode_features_tpu_torch.solver import (
    FIXED_GRID_METHODS,
    SOLVERS,
    fixed_grid_odeint,
    odeint,
    odeint_adjoint,
)
from neural_ode_features_tpu_torch.utils import from_jax_params
from problems import ALL_PROBLEMS

torch.set_num_threads(2)

_LAMBDA = torch.tensor([-0.5, -1.0, -2.0, -4.0], dtype=torch.float64)
_OMEGA = 3.0


def _col(t):
    return t[..., None] if t.ndim else t


# The problems' dynamics once more, on tensors.
TORCH_FUNCS = {
    "exponential": lambda t, y: _LAMBDA[: y.shape[0], None] * y,
    "sine": lambda t, y: torch.stack([y[..., 1],
                                      -(_OMEGA**2) * y[..., 0]], dim=-1),
    "nonautonomous": lambda t, y: y * torch.cos(_col(t)),
    "polynomial": lambda t, y: (5.0 * _col(t) ** 4).expand(y.shape),
}


def test_method_names_match_jax():
    assert FIXED_GRID_METHODS == JAX_METHODS
    assert set(FIXED_GRID_METHODS) < set(SOLVERS) and "adams" in SOLVERS


@pytest.mark.parametrize("problem", ALL_PROBLEMS, ids=lambda p: p.name)
@pytest.mark.parametrize("method", JAX_METHODS)
def test_fixed_grid_matches_jax(problem, method):
    ts = np.linspace(0.0, 1.5, 7)
    for spi in (1, 3):
        ys_j, st_j = jax_fixed_grid(problem.func, jnp.asarray(problem.y0),
                                    jnp.asarray(ts), method,
                                    steps_per_interval=spi)
        ys, st = fixed_grid_odeint(TORCH_FUNCS[problem.name],
                                   torch.from_numpy(problem.y0),
                                   torch.from_numpy(ts), method,
                                   steps_per_interval=spi)
        for name in ("nfe", "naccept", "nreject", "success"):
            np.testing.assert_array_equal(getattr(st, name).numpy(),
                                          np.asarray(getattr(st_j, name)))
        np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), rtol=1e-12,
                                   atol=1e-14)
    # ... and the solver converges on the closed form (spi = 3, 4th order).
    if method in ("rk4", "fixed_adams"):
        np.testing.assert_allclose(ys.numpy(), problem.exact(ts, problem.y0),
                                   rtol=2e-2 * problem.hardness, atol=1e-3)


@pytest.mark.parametrize("error_control", ["global", "per_sample"])
def test_front_door_runs_fixed_grid(error_control):
    problem = ALL_PROBLEMS[1]
    ts = np.linspace(0.0, 1.0, 5)
    ys_j, st_j = jax_odeint(problem.func, jnp.asarray(problem.y0),
                            jnp.asarray(ts), method="rk4",
                            error_control=error_control,
                            steps_per_interval=4)
    ys, st = odeint(TORCH_FUNCS["sine"], torch.from_numpy(problem.y0),
                    torch.from_numpy(ts), method="rk4",
                    error_control=error_control, steps_per_interval=4)
    np.testing.assert_array_equal(st.nfe.numpy(), np.asarray(st_j.nfe))
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), rtol=1e-12,
                               atol=1e-14)


def test_direct_backprop_is_the_adjoints_oracle():
    """Plain autograd through an rk4 solve against the adjoint's gradients
    at a tight tolerance: rel 1e-4 (rk4 at 64 substeps is the coarser)."""
    rng = np.random.default_rng(0)
    a0 = rng.normal(size=(3, 3)) * 0.5
    y0 = torch.from_numpy(rng.normal(size=(4, 3)))
    ts = torch.tensor([0.0, 1.0], dtype=torch.float64)

    def func(p, t, y):
        return torch.tanh(y @ p["A"]) * (1.0 + _col(t))

    grads = []
    for solve in ("direct", "adjoint"):
        p = {"A": torch.tensor(a0, requires_grad=True)}
        if solve == "direct":
            ys, _ = odeint(lambda t, y: func(p, t, y), y0, ts, method="rk4",
                           error_control="per_sample", steps_per_interval=64)
        else:
            ys, _ = odeint_adjoint(func, p, y0, ts, rtol=1e-9, atol=1e-10,
                                   error_control="per_sample")
        ys[-1].square().sum().backward()
        grads.append(p["A"].grad.numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-4, atol=1e-7)


def test_odenet_logits_rk4_matches_jax():
    """The model path with ``method='rk4'`` (4 NFE per sample, no error
    control) on the JAX package's weights: logits at atol 1e-5."""
    kw = dict(in_channels=1, hidden=32, method="rk4")
    cfg_j = JaxConfig(**kw)
    params_j = jax_init_odenet(jax.random.PRNGKey(3), cfg_j)
    x = np.random.default_rng(1).normal(size=(4, 28, 28, 1)).astype(np.float32)
    logits_j, stats_j = jax_logits(params_j, jnp.asarray(x), cfg_j)
    logits, stats = odenet_logits(from_jax_params(params_j, device="cpu"),
                                  torch.from_numpy(x), ModelConfig(**kw))
    np.testing.assert_array_equal(stats.nfe.numpy(), np.asarray(stats_j.nfe))
    assert int(stats.nfe[0]) == 4
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                               rtol=1e-5, atol=1e-5)
