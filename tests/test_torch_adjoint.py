"""Port parity, ``solver/adjoint.py``: ``odeint_adjoint`` on a small
parametrised problem, dy/dt = tanh(y·A) + b·t with (B, 4) states, written in
both frameworks.  Float64 on both sides, so that every accept/reject
decision is the same and the backward NFE can be compared exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.solver import odeint_adjoint as jax_adjoint
from neural_ode_features_tpu_torch.solver import odeint_adjoint

B, D = 3, 4
TS = np.array([0.0, 0.5, 1.2])
GRAD_TOL = dict(rtol=1e-6, atol=1e-9)


def _inputs():
    rng = np.random.default_rng(0)
    return dict(A=rng.normal(size=(D, D)) * 0.8, b=rng.normal(size=(D,)),
                y0=rng.normal(size=(B, D)), w=rng.normal(size=(3, B, D)))


def _jax_func(p, t, y):
    return jnp.tanh(y @ p["A"]) + p["b"] * jnp.reshape(t, (-1, 1))


def _torch_func(p, t, y):
    return torch.tanh(y @ p["A"]) + p["b"] * t.reshape(-1, 1)


def _jax_grads(inp, **kw):
    def loss(p, y0, ts, sink):
        ys, _ = jax_adjoint(_jax_func, p, y0, ts, nfe_sink=sink, **kw)
        return jnp.sum(ys * inp["w"])

    p = {"A": jnp.asarray(inp["A"]), "b": jnp.asarray(inp["b"])}
    return jax.grad(loss, argnums=(0, 1, 2, 3))(
        p, jnp.asarray(inp["y0"]), jnp.asarray(TS), jnp.zeros(()))


def _torch_grads(inp, **kw):
    p = {"A": torch.tensor(inp["A"], requires_grad=True),
         "b": torch.tensor(inp["b"], requires_grad=True)}
    y0 = torch.tensor(inp["y0"], requires_grad=True)
    ts = torch.tensor(TS, requires_grad=True)
    ys, stats = odeint_adjoint(_torch_func, p, y0, ts, **kw)
    assert int(stats.nfe_b) == 0  # filled in by .backward()
    (ys * torch.from_numpy(inp["w"])).sum().backward()
    return p, y0, ts, stats


@pytest.mark.parametrize("kw", [
    dict(error_control="per_sample"),
    dict(error_control="global"),
    dict(error_control="per_sample", adjoint_rtol=1e-4, adjoint_atol=1e-6),
    dict(error_control="per_sample", adjoint_seminorm=True),
    dict(error_control="global", adjoint_seminorm=True),
    dict(error_control="per_sample", adjoint_mode="interpolated"),
    dict(error_control="global", adjoint_mode="interpolated"),
    dict(error_control="per_sample", adjoint_mode="interpolated",
         adjoint_seminorm=True),
    dict(error_control="per_sample", method="rk4", steps_per_interval=8),
])
def test_gradients_and_backward_nfe_match_jax(kw):
    kw = dict(rtol=1e-6, atol=1e-8, **kw)
    inp = _inputs()
    gp, gy0, gts, nfe_b = _jax_grads(inp, **kw)
    p, y0, ts, stats = _torch_grads(inp, **kw)
    for name in ("A", "b"):
        np.testing.assert_allclose(p[name].grad.numpy(), np.asarray(gp[name]),
                                   **GRAD_TOL)
    np.testing.assert_allclose(y0.grad.numpy(), np.asarray(gy0), **GRAD_TOL)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(gts), **GRAD_TOL)
    assert int(stats.nfe_b) == int(nfe_b) > len(TS) - 1
    assert bool(stats.success.all())


def test_seminorm_cuts_backward_nfe():
    """The seminorm's point: no more backward NFE than the full norm at the
    same tolerance, and gradients within the solve's own accuracy."""
    inp = _inputs()
    kw = dict(rtol=1e-6, atol=1e-8, error_control="per_sample")
    p0, y0_0, _, st0 = _torch_grads(inp, **kw)
    p1, y0_1, _, st1 = _torch_grads(inp, adjoint_seminorm=True, **kw)
    assert 0 < int(st1.nfe_b) <= int(st0.nfe_b)
    for name in ("A", "b"):
        np.testing.assert_allclose(p1[name].grad.numpy(),
                                   p0[name].grad.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(y0_1.grad.numpy(), y0_0.grad.numpy(),
                               rtol=1e-4, atol=1e-6)


def _flat_grads(inp, scale, **kw):
    p = {"A": torch.tensor(inp["A"], requires_grad=True),
         "b": torch.tensor(inp["b"], requires_grad=True)}
    y0 = torch.tensor(inp["y0"], requires_grad=True)
    ys, _ = odeint_adjoint(_torch_func, p, y0, torch.tensor(TS), **kw)
    (scale * (ys * torch.from_numpy(inp["w"])).sum()).backward()
    return torch.cat([p["A"].grad.reshape(-1), p["b"].grad.reshape(-1),
                      y0.grad.reshape(-1)])


def test_variants_lose_accuracy_at_small_cotangents():
    """At rtol = atol the backward solve holds a_y to atol + rtol·|a_y|.
    With O(1) cotangents every variant is within 1e-4 (rel-L2) of a tight
    reference at tol 1e-5.  With cotangents of size 1e-3 the reintegrating
    adjoint still is (y, O(1), keeps the steps short), while the
    interpolated adjoint, whose error norm sees a_y alone, is more than 20
    times further off than it was: a property of the method at rtol = atol,
    not of its arithmetic (float64 throughout)."""
    inp = _inputs()
    variants = {"full": {}, "seminorm": dict(adjoint_seminorm=True),
                "interpolated": dict(adjoint_mode="interpolated")}
    rel = {}
    for scale in (1.0, 1e-3):
        ref = _flat_grads(inp, scale, rtol=1e-11, atol=1e-13 * scale)
        for tag, kw in variants.items():
            got = _flat_grads(inp, scale, rtol=1e-5, atol=1e-5,
                              error_control="global", **kw)
            rel[tag, scale] = float((got - ref).norm() / ref.norm())
    assert all(rel[tag, 1.0] < 1e-4 for tag in variants), rel
    assert rel["full", 1e-3] < 1e-4, rel
    assert rel["interpolated", 1e-3] > 20 * rel["interpolated", 1.0], rel


def test_truncated_dense_forward_poisons_gradients():
    inp = _inputs()
    p, y0, ts, stats = _torch_grads(inp, rtol=1e-6, atol=1e-8,
                                    adjoint_mode="interpolated",
                                    dense_max_steps=2)
    assert not bool(stats.success.all())
    for g in (p["A"].grad, p["b"].grad, y0.grad):
        assert bool(torch.isnan(g).all())


def test_per_sample_time_contract():
    """With per-sample control the func sees t of shape (B,) in the forward
    and in the backward, where the augmented solve itself is global."""
    seen = set()

    def func(p, t, y):
        seen.add(tuple(t.shape))
        return y * t[:, None] * p["k"]

    p = {"k": torch.tensor(0.5, dtype=torch.float64, requires_grad=True)}
    y0 = torch.ones((B, D), dtype=torch.float64)
    ys, _ = odeint_adjoint(func, p, y0, torch.tensor([0.0, 1.0]),
                           rtol=1e-6, atol=1e-8, error_control="per_sample")
    ys[-1].sum().backward()
    assert seen == {(B,)}
    # y(1) = exp(k / 2): d/dk sum = B·D·exp(k/2)/2.
    np.testing.assert_allclose(float(p["k"].grad),
                               B * D * np.exp(0.25) / 2, rtol=1e-5)


def test_failed_backward_solve_poisons_gradients():
    inp = _inputs()
    p, y0, ts, stats = _torch_grads(inp, rtol=1e-6, atol=1e-8,
                                    adjoint_max_steps=1)
    for g in (p["A"].grad, p["b"].grad, y0.grad, ts.grad):
        assert bool(torch.isnan(g).all())
    assert int(stats.nfe_b) > 0  # still readable


def test_refusals():
    p = {"A": torch.zeros((D, D))}
    y0 = torch.zeros((B, D))
    with pytest.raises(ValueError, match="fixed-grid"):
        odeint_adjoint(_torch_func, p, y0, TS, adjoint_seminorm=True,
                       method="rk4")
    with pytest.raises(ValueError, match="adaptive RK methods only"):
        odeint_adjoint(_torch_func, p, y0, TS, adjoint_mode="interpolated",
                       method="euler")
    with pytest.raises(ValueError, match="adjoint_mode"):
        odeint_adjoint(_torch_func, p, y0, TS, adjoint_mode="nope")


def test_truncated_dense_forward_matches_jax():
    """A dense forward that runs out of ``dense_max_steps`` is an
    unsuccessful solve in both packages, and both poison the gradients."""
    inp = _inputs()
    kw = dict(rtol=1e-6, atol=1e-8, adjoint_mode="interpolated",
              dense_max_steps=2, error_control="per_sample")

    def loss(pj, y0j):  # the stats of the differentiated (dense) forward
        ys, st = jax_adjoint(_jax_func, pj, y0j, jnp.asarray(TS), **kw)
        return jnp.sum(ys * inp["w"]), st

    (_, st_j), (gp, gy0) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
            {"A": jnp.asarray(inp["A"]), "b": jnp.asarray(inp["b"])},
            jnp.asarray(inp["y0"]))
    p, y0, _, stats = _torch_grads(inp, **kw)
    np.testing.assert_array_equal(stats.success.numpy(),
                                  np.asarray(st_j.success))
    assert not bool(stats.success.all())
    for got, want in ((p["A"].grad, gp["A"]), (p["b"].grad, gp["b"]),
                      (y0.grad, gy0)):
        np.testing.assert_array_equal(np.isfinite(got.numpy()),
                                      np.isfinite(np.asarray(want)))
        assert not np.isfinite(got.numpy()).any()
