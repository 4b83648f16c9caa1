"""Port parity, ``solver/adams.py``: the adaptive Adams solver against the
JAX package's ``odeint(method='adams')`` on the problems of
``tests/problems.py`` and the cases of ``tests/test_adams.py``, then the
ODE-Net with ``method='adams'`` against the JAX model, on the CPU.

Float64: per-sample ``nfe``, ``naccept`` and ``nreject`` equal, values
within ``F64_TOL``.  That bar is 1e-8, not the RK path's 1e-10: in the first
steps of the order ramp the predictor and the corrector differ by about
1e-12 of the state, so the Milne ratios there are rounding, and the order
the solver picks follows it.  The port rounds as XLA does where it can (the
combines are fused multiply-add chains in node order, as XLA's CPU dot),
but XLA's ``pow`` (the step controller's ratio**(-1/k)) differs from
PyTorch's by an ulp on a few per cent of arguments, so a trajectory may
take other orders in its first steps: values agree to 1e-8, far inside the
solves' own error.  At order 12 (``test_order12_no_longer_oversteps``) the
step counts themselves may differ by a few per cent.  Float32: values
within ``F32_TOL``.

The JAX solves are jitted once per problem, control, order and mask, with
the tolerances as traced arguments, so the tests that solve one problem at
several tolerances share one compile (bit-identical to the unjitted solves
on these problems but the per-sample stiff one, 1e-11 off).  The ODE-Net
runs at ``max_order=4`` on both sides and the JAX model jitted whole, to
bound JAX's compile time.
"""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.models import ModelConfig as JaxConfig
from neural_ode_features_tpu.models import init_odenet as jax_init_odenet
from neural_ode_features_tpu.models import odenet_logits as jax_logits
from neural_ode_features_tpu.models import odenet_trajectory as jax_trajectory
from neural_ode_features_tpu.models import odenet as jax_odenet_module
from neural_ode_features_tpu.solver import odeint as jax_odeint
from neural_ode_features_tpu_torch.models import (
    ModelConfig,
    odenet_logits,
    odenet_trajectory,
)
from neural_ode_features_tpu_torch.models import odenet as odenet_module
from neural_ode_features_tpu_torch.solver import odeint
from neural_ode_features_tpu_torch.utils import from_jax_params

sys.path.insert(0, str(Path(__file__).resolve().parent))
import problems as P  # noqa: E402

torch.set_num_threads(2)

F64_TOL = 1e-8
F32_TOL = 1e-5
STATS = ("nfe", "naccept", "nreject", "success")


def _col(t):
    return t[..., None] if t.ndim else t


# The problems of tests/problems.py, written in torch.
TORCH_FUNCS = {
    "exponential": lambda t, y: torch.as_tensor(
        np.array([-0.5, -1.0, -2.0, -4.0])[:y.shape[0]],
        dtype=y.dtype)[:, None] * y,
    "sine": lambda t, y: torch.stack([y[..., 1], -9.0 * y[..., 0]], dim=-1),
    "nonautonomous": lambda t, y: y * torch.cos(_col(t)),
    "polynomial": lambda t, y: (5.0 * _col(t) ** 4).expand(y.shape).to(
        y.dtype),
    "stiff": lambda t, y: torch.as_tensor(P.STIFF_LAMBDA,
                                          dtype=y.dtype)[:, None] * y,
    "cubic": lambda t, y: (4.0 * _col(t) ** 3).expand(y.shape).to(y.dtype),
}


def _jax_cubic(t, y):
    return jnp.broadcast_to(4.0 * _col(jnp.asarray(t)) ** 3,
                            y.shape).astype(y.dtype)


JAX_FUNCS = {p.name: p.func for p in P.ALL_PROBLEMS}
JAX_FUNCS.update(stiff=P.stiff_func_for(P.STIFF_LAMBDA), cubic=_jax_cubic)
Y0 = {p.name: p.y0 for p in P.ALL_PROBLEMS}
Y0.update(stiff=P.STIFF_Y0, cubic=np.zeros((1, 1)))


@functools.lru_cache(maxsize=None)
def _jax_solver(name, error_control, max_order, masked):
    """The JAX solve of one problem, jitted with the tolerances traced."""
    def solve(y0, ts, rtol, atol, mask):
        return jax_odeint(JAX_FUNCS[name], y0, ts, rtol=rtol, atol=atol,
                          method="adams", error_control=error_control,
                          max_order=max_order,
                          error_mask=mask if masked else None)
    return jax.jit(solve)


def _jax_solve(y0, ts, rtol, atol, mask=None, *, name, error_control,
               max_order):
    solve = _jax_solver(name, error_control, max_order, mask is not None)
    return solve(y0, ts, jnp.asarray(rtol, y0.dtype),
                 jnp.asarray(atol, y0.dtype),
                 jnp.zeros(()) if mask is None else mask)


def _both(name, ts, rtol, atol, *, error_control="global", max_order=8,
          dtype=np.float64, mask=None):
    y0 = Y0[name].astype(dtype)
    ts = np.asarray(ts, dtype)
    ys_j, st_j = _jax_solve(jnp.asarray(y0), jnp.asarray(ts), rtol, atol,
                            None if mask is None else jnp.asarray(mask),
                            name=name, error_control=error_control,
                            max_order=max_order)
    ys, st = odeint(TORCH_FUNCS[name], torch.from_numpy(y0),
                    torch.from_numpy(ts), rtol=rtol, atol=atol,
                    method="adams", error_control=error_control,
                    max_order=max_order,
                    error_mask=None if mask is None else torch.from_numpy(
                        mask))
    assert ys.dtype == torch.from_numpy(y0).dtype
    return ys.numpy(), st, np.asarray(ys_j), st_j


def _assert_stats_equal(st, st_j):
    for name in STATS:
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(st_j, name)), name)


@pytest.mark.parametrize("problem", P.ALL_PROBLEMS, ids=lambda p: p.name)
def test_adams_matches_jax(problem):
    ts = np.linspace(0.0, 2.0, 7)
    ys, st, ys_j, st_j = _both(problem.name, ts, 1e-6, 1e-8)
    _assert_stats_equal(st, st_j)
    np.testing.assert_allclose(ys, ys_j, rtol=0, atol=F64_TOL)
    # ... and tests/test_adams.py's accuracy bar on the port's own values.
    exact = problem.exact(ts, problem.y0)
    err = np.max(np.abs(ys - exact))
    assert err < 1e4 * 1e-6 * (np.max(np.abs(exact)) + 1.0) * problem.hardness


def test_two_evaluations_per_attempt():
    _, st = odeint(TORCH_FUNCS["sine"], torch.from_numpy(Y0["sine"]),
                   torch.tensor([0.0, 2.0], dtype=torch.float64), rtol=1e-6,
                   atol=1e-8, method="adams")
    # f0, the initial-step probe, then two per attempt.
    assert int(st.nfe[0]) == 2 + 2 * int(st.naccept[0] + st.nreject[0])


def test_reverse_time():
    """From t = 1 back to 0 (seven output times): the JAX solve's steps and
    values; and the port's round trip 0 → 1 → 0 returns to y0."""
    ys, st, ys_j, st_j = _both("exponential", np.linspace(1.0, 0.0, 7), 1e-7,
                               1e-9)
    _assert_stats_equal(st, st_j)
    np.testing.assert_allclose(ys, ys_j, rtol=0, atol=F64_TOL)
    y0 = torch.from_numpy(Y0["exponential"])
    fwd, _ = odeint(TORCH_FUNCS["exponential"], y0,
                    torch.tensor([0.0, 1.0], dtype=torch.float64), rtol=1e-7,
                    atol=1e-9, method="adams")
    back, _ = odeint(TORCH_FUNCS["exponential"], fwd[-1],
                     torch.tensor([1.0, 0.0], dtype=torch.float64),
                     rtol=1e-7, atol=1e-9, method="adams")
    np.testing.assert_allclose(back[-1].numpy(), Y0["exponential"],
                               rtol=1e-4, atol=1e-6)


def test_per_sample_control():
    ys, st, ys_j, st_j = _both("stiff", [0.0, 1.0], 1e-6, 1e-8,
                               error_control="per_sample")
    _assert_stats_equal(st, st_j)
    np.testing.assert_allclose(ys, ys_j, rtol=0, atol=F64_TOL)
    assert int(st.nfe[3]) > int(st.nfe[0])


def test_polynomial_unbounded_step_edge():
    """Cubic dynamics make the order-4 predictor exact, so dt grows without
    bound; the order-matched dense output stays exact."""
    ts = np.linspace(0.0, 2.0, 7)
    ys, st, ys_j, st_j = _both("cubic", ts, 1e-6, 1e-8)
    _assert_stats_equal(st, st_j)
    assert bool(st.success.all())
    assert np.abs(ys[:, 0, 0] - ts ** 4).max() < 1e-8
    np.testing.assert_allclose(ys, ys_j, rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("rtol", [1e-6, 1e-10])
def test_high_order_beats_order4_at_tight_tolerance(rtol):
    exact = P.SINE.exact(np.array([0.0, 2.0]), P.SINE.y0)[-1]
    nfe = {}
    for k in (4, 8):
        ys, st, ys_j, st_j = _both("sine", [0.0, 2.0], rtol, rtol * 1e-2,
                                   max_order=k)
        _assert_stats_equal(st, st_j)
        np.testing.assert_allclose(ys, ys_j, rtol=0, atol=F64_TOL)
        assert np.max(np.abs(ys[-1] - exact)) < 1e4 * rtol
        nfe[k] = int(st.nfe[0])
    assert nfe[8] < 0.6 * nfe[4], nfe


def test_order12_no_longer_oversteps():
    """Order 12 at least as step-efficient as order 8 at tight tolerance.
    Here the step counts follow rounding (module docstring): within 5% of
    the JAX solver's, values within 1e-10."""
    nfe = {}
    for k in (8, 12):
        ys, st, ys_j, st_j = _both("sine", [0.0, 2.0], 1e-10, 1e-10,
                                   max_order=k)
        assert bool(st.success.all())
        nfe[k] = int(st.nfe[0])
        assert abs(nfe[k] - int(st_j.nfe[0])) <= 0.05 * int(st_j.nfe[0])
        np.testing.assert_allclose(ys, ys_j, rtol=0, atol=1e-10)
    assert nfe[12] <= nfe[8] * 1.1, nfe


def test_float32_values():
    """Björck–Pereyra keeps order 8 stable in f32: values within F32_TOL of
    the JAX solver's and within 1e-3 of the exact solution."""
    ts = np.array([0.0, 2.0])
    ys, st, ys_j, _ = _both("sine", ts, 1e-5, 1e-7, dtype=np.float32)
    assert ys.dtype == np.float32 and bool(st.success.all())
    np.testing.assert_allclose(ys, ys_j, rtol=0, atol=F32_TOL)
    exact = P.SINE.exact(ts, P.SINE.y0)[-1]
    assert np.max(np.abs(ys[-1] - exact)) < 1e-3


def test_error_mask_matches_jax():
    """Seminorm control: the error norm on the positions only."""
    m = np.broadcast_to(np.asarray([1.0, 0.0]), Y0["sine"].shape).copy()
    ys, st, ys_j, st_j = _both("sine", np.linspace(0.0, 2.0, 4), 1e-5, 1e-5,
                               error_control="per_sample", mask=m,
                               max_order=4)
    _assert_stats_equal(st, st_j)
    np.testing.assert_allclose(ys, ys_j, rtol=0, atol=F64_TOL)


def test_per_row_tolerance_equals_per_row_solves():
    """A ``(B,)`` tolerance gives each row the solve it has alone at its own
    tolerance (``sweep --fused --method adams``)."""
    y0 = torch.from_numpy(Y0["exponential"])
    ts = torch.tensor([0.0, 1.0, 2.0], dtype=torch.float64)
    tols = torch.tensor([1e-2, 1e-4, 1e-6, 1e-8], dtype=torch.float64)
    ys, st = odeint(TORCH_FUNCS["exponential"], y0, ts, rtol=tols,
                    atol=tols, method="adams", error_control="per_sample")
    lam = [-0.5, -1.0, -2.0, -4.0]
    for i, tol in enumerate(tols.tolist()):
        ys_i, st_i = odeint(lambda t, y, i=i: lam[i] * y, y0[i:i + 1], ts,
                            rtol=tol, atol=tol, method="adams",
                            error_control="per_sample")
        assert int(st.nfe[i]) == int(st_i.nfe[0])
        np.testing.assert_allclose(ys[:, i].numpy(), ys_i[:, 0].numpy(),
                                   rtol=1e-12, atol=0)
    assert int(st.nfe[0]) < int(st.nfe[-1])


def test_max_order_validation():
    y0 = torch.from_numpy(Y0["sine"])
    for bad in (1, 13):
        with pytest.raises(ValueError, match="max_order"):
            odeint(TORCH_FUNCS["sine"], y0, torch.tensor([0.0, 1.0]),
                   method="adams", max_order=bad)


@pytest.fixture(scope="module")
def odenet_inputs():
    cfg_j = JaxConfig(in_channels=1, hidden=32, method="adams", tol=1e-3)
    params_j = jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float32),
        jax.jit(lambda k: jax_init_odenet(k, cfg_j))(jax.random.PRNGKey(3)))
    x = np.random.default_rng(0).normal(size=(6, 28, 28, 1)).astype(
        np.float32)
    cfg = ModelConfig(in_channels=1, hidden=32, method="adams", tol=1e-3)
    return cfg_j, params_j, cfg, from_jax_params(params_j, device="cpu"), x


def test_odenet_logits_and_trajectory_match_jax(odenet_inputs, monkeypatch):
    """The ODE-Net (hidden 32, 6×6 maps) with ``method='adams'`` at
    ``max_order=4`` on the JAX model's weights: per-sample NFE equal, logits
    at 1e-5, the trajectory at four times at 1e-4 (f32)."""
    cfg_j, params_j, cfg, params, x = odenet_inputs
    monkeypatch.setattr(jax_odenet_module, "odeint",
                        functools.partial(jax_odeint, max_order=4))
    monkeypatch.setattr(odenet_module, "odeint",
                        functools.partial(odeint, max_order=4))
    logits_j, st_j = jax.jit(lambda p, x_: jax_logits(p, x_, cfg_j))(
        params_j, jnp.asarray(x))
    logits, st = odenet_logits(params, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(st.nfe.numpy(), np.asarray(st_j.nfe))
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                               rtol=1e-5, atol=1e-5)
    ts = np.array([0.0, 0.3, 0.7, 1.0], np.float32)
    traj_j, st_j = jax.jit(lambda p, x_, t: jax_trajectory(p, x_, t, cfg_j))(
        params_j, jnp.asarray(x), jnp.asarray(ts))
    traj, st = odenet_trajectory(params, torch.from_numpy(x),
                                 torch.from_numpy(ts), cfg)
    np.testing.assert_array_equal(st.nfe.numpy(), np.asarray(st_j.nfe))
    np.testing.assert_allclose(traj.numpy(), np.asarray(traj_j), rtol=1e-4,
                               atol=1e-4)
    # Adams solves per sample at two evaluations per attempt.
    assert bool((((st.nfe - 2) % 2) == 0).all())
