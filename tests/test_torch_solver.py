"""Port parity, solver core: neural_ode_features_tpu_torch.solver against
the JAX package's adaptive_odeint/odeint on analytic problems (same
accept/reject sequence, NFE and solution), on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.solver import odeint as jax_odeint
from neural_ode_features_tpu.solver import tableau as jax_tableau
from neural_ode_features_tpu.solver.runge_kutta import (
    adaptive_odeint as jax_adaptive_odeint,
)
from neural_ode_features_tpu_torch import tableau
from neural_ode_features_tpu_torch.solver import odeint
from neural_ode_features_tpu_torch.solver.ravel import ravel_batched, ravel_full
from neural_ode_features_tpu_torch.solver.runge_kutta import (
    _error_ratio,
    adaptive_odeint,
)

torch.set_num_threads(2)

_LAMBDA = np.array([-0.5, -1.0, -2.0, -4.0])
_Y0 = np.array([[1.0, 2.0], [1.0, -1.0], [0.5, 1.5], [2.0, 0.25]])
_OMEGA = 3.0


def _exp_jax(t, y):
    return jnp.asarray(_LAMBDA, y.dtype)[:, None] * y


def _exp_torch(t, y):
    return torch.as_tensor(_LAMBDA, dtype=y.dtype)[:, None] * y


def _sine_jax(t, y):
    return jnp.stack([y[..., 1], -(_OMEGA**2) * y[..., 0]], axis=-1)


def _sine_torch(t, y):
    return torch.stack([y[..., 1], -(_OMEGA**2) * y[..., 0]], dim=-1)


@pytest.mark.parametrize("tol", [1e-2, 1e-3, 1e-4, 1e-5])
@pytest.mark.parametrize("method,controller", [
    ("dopri5", "i"), ("bosh3", "i"), ("dopri5", "pi")])
def test_adaptive_matches_jax(tol, method, controller):
    ts = np.linspace(0.0, 2.0, 5)
    ys_j, st_j = jax_adaptive_odeint(
        _exp_jax, jnp.asarray(_Y0), jnp.asarray(ts), tol, tol,
        jax_tableau.ADAPTIVE_TABLEAUS[method], controller=controller)
    ys, st = adaptive_odeint(
        _exp_torch, torch.from_numpy(_Y0), torch.from_numpy(ts), tol, tol,
        tableau.ADAPTIVE_TABLEAUS[method], controller=controller)
    for name in ("nfe", "naccept", "nreject", "success"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(st_j, name)), name)
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("tol", [1e-3, 1e-5])
@pytest.mark.parametrize("mask", [[1.0, 0.0], [0.0, 1.0]])
def test_error_mask_matches_jax(tol, mask):
    """Seminorm control: with a 0/1 ``error_mask`` the accept/reject
    sequence, the NFE and the solution equal the JAX solver's (float64, so
    every decision is the same), and differ from the unmasked solve's."""
    ts = np.linspace(0.0, 2.0, 4)
    y0 = np.array([[1.0, 0.0], [0.0, 3.0], [1.0, 1.0]])
    m = np.broadcast_to(np.asarray(mask), y0.shape)
    ys_j, st_j = jax_adaptive_odeint(
        _sine_jax, jnp.asarray(y0), jnp.asarray(ts), tol, tol,
        jax_tableau.DOPRI5, error_mask=jnp.asarray(m))
    ys, st = adaptive_odeint(
        _sine_torch, torch.from_numpy(y0), torch.from_numpy(ts), tol, tol,
        tableau.DOPRI5, error_mask=torch.from_numpy(m.copy()))
    for name in ("nfe", "naccept", "nreject", "success"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(st_j, name)), name)
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), rtol=1e-10,
                               atol=1e-12)
    # The front door takes the mask as a state-like tree.
    ys_f, st_f = odeint(_sine_torch, torch.from_numpy(y0),
                        torch.from_numpy(ts), rtol=tol, atol=tol,
                        error_control="per_sample",
                        error_mask=torch.from_numpy(m.copy()))
    np.testing.assert_array_equal(st_f.nfe.numpy(), st.nfe.numpy())
    assert torch.equal(ys_f, ys)
    with pytest.raises(ValueError, match="no error_mask"):
        adaptive_odeint(_sine_torch, torch.from_numpy(y0),
                        torch.from_numpy(ts), tol, tol, tableau.DOPRI5,
                        error_mask=torch.from_numpy(m.copy()),
                        fused_step=lambda *a: None)


def test_masked_ratio_runs_over_the_unmasked_count():
    err = torch.tensor([[3e-3, 7.0, 4e-3]])
    y = torch.zeros((1, 3))
    mask = torch.tensor([[True, False, True]])
    r = _error_ratio(err, y, y, 0.0, 1e-3, mask)
    np.testing.assert_allclose(r.numpy(), [np.sqrt((9 + 16) / 2)], rtol=1e-6)
    # An excluded inf (atol = 0 at a zero-scale entry) does not poison it.
    r0 = _error_ratio(torch.tensor([[1e-3, 1.0]]), torch.tensor([[1.0, 0.0]]),
                      torch.tensor([[1.0, 0.0]]), 1e-3, 0.0,
                      torch.tensor([[True, False]]))
    np.testing.assert_allclose(r0.numpy(), [1.0], rtol=1e-6)


def test_per_row_tolerance_equals_per_row_solves():
    """A ``(B,)`` tolerance gives every row the solve it would have had
    alone at its own tolerance: same NFE, the same solution to rounding
    (rtol 1e-12: a one-row call takes the CPU's scalar code paths)."""
    ts = torch.tensor([0.0, 1.0, 2.0], dtype=torch.float64)
    y0 = torch.from_numpy(_Y0)
    tols = torch.tensor([1e-2, 1e-3, 1e-4, 1e-6], dtype=torch.float64)
    ys, st = odeint(_exp_torch, y0, ts, rtol=tols, atol=tols,
                    error_control="per_sample")
    for i, tol in enumerate(tols.tolist()):
        def row(t, y, i=i):
            return float(_LAMBDA[i]) * y
        ys_i, st_i = odeint(row, y0[i:i + 1], ts, rtol=tol, atol=tol,
                            error_control="per_sample")
        assert int(st.nfe[i]) == int(st_i.nfe[0])
        np.testing.assert_allclose(ys[:, i].numpy(), ys_i[:, 0].numpy(),
                                   rtol=1e-12, atol=0)
    assert int(st.nfe[0]) < int(st.nfe[-1])
    with pytest.raises(ValueError, match="per-row tolerance"):
        odeint(_exp_torch, y0, ts, rtol=tols[:2], atol=1e-3,
               error_control="per_sample")


@pytest.mark.parametrize("error_control", ["global", "per_sample"])
def test_odeint_front_door_matches_jax(error_control):
    y0 = np.array([[1.0, 0.0], [0.0, 3.0], [1.0, 1.0]])
    ts = np.array([0.0, 0.5, 1.0])
    ys_j, st_j = jax_odeint(_sine_jax, jnp.asarray(y0), jnp.asarray(ts),
                            rtol=1e-5, atol=1e-6, error_control=error_control)
    ys, st = odeint(_sine_torch, torch.from_numpy(y0), torch.from_numpy(ts),
                    rtol=1e-5, atol=1e-6, error_control=error_control)
    np.testing.assert_array_equal(st.nfe.numpy(), np.asarray(st_j.nfe))
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), rtol=1e-10,
                               atol=1e-12)


def test_reverse_time():
    ts = np.array([1.0, 0.25])
    ys_j, st_j = jax_odeint(_exp_jax, jnp.asarray(_Y0), jnp.asarray(ts),
                            rtol=1e-4, atol=1e-4, error_control="per_sample")
    ys, st = odeint(_exp_torch, torch.from_numpy(_Y0), torch.from_numpy(ts),
                    rtol=1e-4, atol=1e-4, error_control="per_sample")
    np.testing.assert_array_equal(st.nfe.numpy(), np.asarray(st_j.nfe))
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), rtol=1e-10,
                               atol=1e-12)


def test_odeint_refuses():
    y0 = torch.ones((4, 2))
    # adams runs (tests/test_torch_adams.py), with the JAX front door's
    # refusals: no PI controller, no fused step, max_order in 2..12.
    with pytest.raises(ValueError, match="controller"):
        odeint(_exp_torch, y0, torch.tensor([0.0, 1.0]), method="adams",
               controller="pi")
    with pytest.raises(ValueError, match="fused_step"):
        odeint(_exp_torch, y0, torch.tensor([0.0, 1.0]), method="adams",
               fused_step=lambda *a: None)
    with pytest.raises(ValueError, match="max_order"):
        odeint(_exp_torch, y0, torch.tensor([0.0, 1.0]), method="adams",
               max_order=13)
    for kw in (dict(error_mask=torch.ones((4, 2))), dict(controller="pi"),
               dict(fused_step=lambda *a: None)):
        with pytest.raises(ValueError, match="rk4|adaptive"):
            odeint(_exp_torch, y0, torch.tensor([0.0, 1.0]), method="rk4",
                   error_control="per_sample", **kw)
    with pytest.raises(ValueError, match="uniformly spaced"):
        odeint(_exp_torch, y0, torch.tensor([0.0, 0.5, 2.0]),
               method="fixed_adams", error_control="per_sample")
    with pytest.raises(ValueError, match="disables error control"):
        odeint(_exp_torch, y0, torch.tensor([0.0, 1.0]),
               error_control="per_sample", error_mask=torch.zeros((4, 2)))
    with pytest.raises(ValueError, match="monotonic"):
        odeint(_exp_torch, y0, torch.tensor([0.0, 1.0, 0.5]))
    with pytest.raises(ValueError, match="unknown method"):
        odeint(_exp_torch, y0, torch.tensor([0.0, 1.0]), method="nope")


def test_error_ratio_zero_atol_guard():
    err = torch.tensor([[0.0, 1e-3]])
    y = torch.tensor([[0.0, 1.0]])
    r = _error_ratio(err, y, y, 1e-3, 0.0)
    assert torch.isfinite(r).all()
    np.testing.assert_allclose(r.numpy(), [np.sqrt(0.5)], rtol=1e-6)
    bad = _error_ratio(torch.tensor([[1e-3, 0.0]]), y, y, 1e-3, 0.0)
    assert torch.isinf(bad).all()


def test_tableau_copy_matches_jax():
    for name, tab in tableau.ADAPTIVE_TABLEAUS.items():
        ref = jax_tableau.ADAPTIVE_TABLEAUS[name]
        for field in ("c", "a", "b", "b_err"):
            np.testing.assert_array_equal(getattr(tab, field),
                                          getattr(ref, field))
        assert (tab.order, tab.fsal) == (ref.order, ref.fsal)
    np.testing.assert_array_equal(tableau.DOPRI5.c_mid, jax_tableau.DOPRI5.c_mid)
    np.testing.assert_array_equal(tableau.QUARTIC_FIT, jax_tableau.QUARTIC_FIT)
    np.testing.assert_array_equal(tableau.CUBIC_FIT, jax_tableau.CUBIC_FIT)


def test_ravel_round_trips():
    g = torch.Generator().manual_seed(0)
    state = {"b": torch.randn(3, 2, 2, generator=g),
             "a": (torch.randn(3, generator=g), torch.randn(3, 4, generator=g))}
    flat, unravel, flatten = ravel_batched(state)
    assert flat.shape == (3, 4 + 1 + 4)
    back = unravel(torch.stack([flat, 2 * flat]))
    assert torch.equal(back["b"][1], 2 * state["b"])
    assert torch.equal(back["a"][1][0], state["a"][1])
    assert torch.equal(flatten(state), flat)

    flat, unravel, _ = ravel_full(state)
    assert flat.shape == (1, 12 + 3 + 12)
    assert torch.equal(unravel(flat)["a"][0], state["a"][0])
    with pytest.raises(ValueError, match="leading batch axis"):
        ravel_batched((torch.ones(3, 2), torch.ones(4)))
