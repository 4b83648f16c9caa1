"""Port parity: ``solver/dense.py`` (solve once, evaluate y(t) anywhere)
against the JAX ``odeint_dense`` on the analytic problems of
``tests/problems.py``, same inputs, explicit dtypes (``conftest`` enables
x64).  Tolerance 1e-5: both packages run the same step sequence, so the
states differ by float rounding only."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.solver import odeint_dense as jax_odeint_dense
from neural_ode_features_tpu_torch.solver import odeint, odeint_dense
from problems import _EXP_LAMBDA, _OMEGA, EXPONENTIAL, SINE, STIFF_LAMBDA

TOL = dict(rtol=1e-5, atol=1e-5)


def _exp_func(t, y):
    lam = torch.as_tensor(_EXP_LAMBDA, dtype=y.dtype)[: y.shape[0], None]
    return lam * y


def _sine_func(t, y):
    return torch.stack([y[..., 1], -(_OMEGA**2) * y[..., 0]], dim=-1)


FUNCS = {"exponential": _exp_func, "sine": _sine_func}
QUERY = np.array([0.0, 0.123, 0.5, 0.777, 1.31, 2.0])


@pytest.mark.parametrize("error_control", ["global", "per_sample"])
@pytest.mark.parametrize("problem", [EXPONENTIAL, SINE], ids=lambda p: p.name)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dense_matches_jax(problem, error_control, dtype):
    tol = dict(rtol=1e-5, atol=1e-7) if dtype == "float32" else dict(
        rtol=1e-8, atol=1e-10)
    kw = dict(error_control=error_control, max_steps=128, **tol)
    y0 = problem.y0.astype(dtype)
    y_at_j, stats_j = jax_odeint_dense(problem.func, jnp.asarray(y0), 0.0,
                                       2.0, **kw)
    y_at, stats = odeint_dense(FUNCS[problem.name], torch.from_numpy(y0),
                               0.0, 2.0, **kw)
    for name in ("nfe", "naccept", "nreject", "success"):
        np.testing.assert_array_equal(getattr(stats, name).numpy(),
                                      np.asarray(getattr(stats_j, name)), name)
    got = y_at(torch.from_numpy(QUERY))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.numpy(), np.asarray(y_at_j(QUERY)), **TOL)
    np.testing.assert_allclose(y_at(0.777).numpy(),
                               np.asarray(y_at_j(0.777)), **TOL)
    if dtype == "float32":
        # In f32 the embedded error at this tolerance is a difference of
        # nearly equal sums, so the two packages' step sizes drift apart by
        # rounding while the solutions agree; the record is held in f64.
        return
    sol, sol_j = y_at.__wrapped_sol__, y_at_j.__wrapped_sol__
    # The port's buffer grows with the attempts; JAX's holds max_steps slots.
    assert int(stats.naccept.max()) <= sol.t0s.shape[0] <= kw["max_steps"]
    for name in ("t0s", "dts", "coeffs"):
        got_rec = getattr(sol, name).numpy()
        np.testing.assert_allclose(got_rec,
                                   np.asarray(getattr(sol_j, name))[:len(got_rec)],
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_dense_matches_exact_and_grid_solve():
    y0 = torch.from_numpy(SINE.y0)
    kw = dict(rtol=1e-9, atol=1e-11)
    y_at, stats = odeint_dense(_sine_func, y0, 0.0, 2.0, max_steps=256, **kw)
    assert bool(stats.success.all())
    np.testing.assert_allclose(y_at(QUERY).numpy(),
                               SINE.exact(QUERY, SINE.y0), rtol=1e-5,
                               atol=1e-7)
    ts = torch.linspace(0.0, 2.0, 9, dtype=torch.float64)
    ys_grid, _ = odeint(_sine_func, y0, ts, **kw)
    np.testing.assert_allclose(y_at(ts).numpy(), ys_grid.numpy(), rtol=1e-6,
                               atol=1e-9)


def test_dense_scalar_eval_and_clamp():
    y0 = torch.from_numpy(EXPONENTIAL.y0)
    y_at, _ = odeint_dense(_exp_func, y0, 0.0, 1.0, rtol=1e-8, atol=1e-10)
    y_half = y_at(0.5)
    assert tuple(y_half.shape) == EXPONENTIAL.y0.shape
    exact = lambda t: EXPONENTIAL.exact(np.asarray([t]), EXPONENTIAL.y0)[0]
    np.testing.assert_allclose(y_half.numpy(), exact(0.5), rtol=1e-6)
    # out-of-span queries clamp to the endpoints
    np.testing.assert_allclose(y_at(-3.0).numpy(), exact(0.0), rtol=1e-6)
    np.testing.assert_allclose(y_at(9.0).numpy(), exact(1.0), rtol=1e-5)


def test_dense_per_sample_and_reverse():
    lam = torch.as_tensor(STIFF_LAMBDA)[:, None]
    func = lambda t, y: lam * y
    y0 = torch.ones((4, 1), dtype=torch.float64)
    y_at, stats = odeint_dense(func, y0, 0.0, 1.0, rtol=1e-6, atol=1e-8,
                               error_control="per_sample", max_steps=512)
    # per-sample control: the stiff row takes more steps than the slow one
    assert int(stats.naccept[3]) > int(stats.naccept[0])
    q = np.array([0.1, 0.45, 0.9])
    want = np.exp(STIFF_LAMBDA[None, :, None] * q[:, None, None])
    np.testing.assert_allclose(y_at(q).numpy(), want, rtol=1e-4, atol=1e-7)
    # reverse-time span
    y1 = torch.from_numpy(EXPONENTIAL.exact(np.asarray([1.0]),
                                            EXPONENTIAL.y0)[0])
    y_back, stats_b = odeint_dense(_exp_func, y1, 1.0, 0.0, rtol=1e-8,
                                   atol=1e-10, error_control="per_sample")
    assert bool(stats_b.success.all())
    np.testing.assert_allclose(y_back(0.0).numpy(), EXPONENTIAL.y0,
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(
        y_back(np.array([0.6, 0.2])).numpy(),
        EXPONENTIAL.exact(np.array([0.6, 0.2]), EXPONENTIAL.y0), rtol=1e-5)


def test_dense_restores_state_structure():
    y0 = {"a": torch.ones((3, 2), dtype=torch.float64),
          "b": (torch.full((3,), 2.0, dtype=torch.float64),)}
    func = lambda t, y: {"a": -y["a"], "b": (0.5 * y["b"][0],)}
    y_at, _ = odeint_dense(func, y0, 0.0, 1.0, rtol=1e-8, atol=1e-10,
                           error_control="per_sample")
    ys = y_at(np.array([0.25, 1.0]))
    assert ys["a"].shape == (2, 3, 2) and ys["b"][0].shape == (2, 3)
    np.testing.assert_allclose(ys["a"][1].numpy(), np.exp(-1.0) * np.ones((3, 2)),
                               rtol=1e-6)
    np.testing.assert_allclose(y_at(1.0)["b"][0].numpy(),
                               2.0 * np.exp(0.5) * np.ones(3), rtol=1e-6)


def test_dense_step_budget_and_refusals():
    y0 = torch.from_numpy(SINE.y0)
    _, stats = odeint_dense(_sine_func, y0, 0.0, 2.0, rtol=1e-9, atol=1e-11,
                            max_steps=3)
    assert not bool(stats.success.any())
    assert int((stats.naccept + stats.nreject).max()) == 3
    with pytest.raises(ValueError, match="adaptive RK"):
        odeint_dense(_sine_func, y0, 0.0, 1.0, method="rk4")
    with pytest.raises(ValueError, match="error_control"):
        odeint_dense(_sine_func, y0, 0.0, 1.0, error_control="rows")
    with pytest.raises(ValueError, match="controller"):
        odeint_dense(_sine_func, y0, 0.0, 1.0, controller="pid")


@pytest.mark.parametrize("method,controller", [("bosh3", "i"), ("tsit5", "pi")])
def test_dense_other_tableaus_match_jax(method, controller):
    """A cubic-fit tableau (no ``c_mid``) and the PI controller."""
    kw = dict(rtol=1e-6, atol=1e-8, method=method, controller=controller,
              error_control="per_sample", max_steps=256)
    y0 = EXPONENTIAL.y0
    y_at_j, stats_j = jax_odeint_dense(EXPONENTIAL.func, jnp.asarray(y0),
                                       0.0, 1.0, **kw)
    y_at, stats = odeint_dense(_exp_func, torch.from_numpy(y0), 0.0, 1.0,
                               **kw)
    np.testing.assert_array_equal(stats.naccept.numpy(),
                                  np.asarray(stats_j.naccept))
    q = np.linspace(0.0, 1.0, 7)
    np.testing.assert_allclose(y_at(q).numpy(), np.asarray(y_at_j(q)), **TOL)
