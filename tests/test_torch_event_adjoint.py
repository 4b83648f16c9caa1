"""Port parity, ``solver/event_adjoint.py``: ``odeint_event_adjoint``
against the JAX package's on the cases of ``tests/test_event_adjoint.py``
(all but the ``vmap`` one), float64 on the CPU: t* and y* and their
gradients in the parameters and the initial state (dt*/dξ, dy*/dξ) within
``GRAD_TOL``, and each case's analytic value on the port."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.solver import odeint_event_adjoint as jax_eva
from neural_ode_features_tpu_torch.kernels.odefunc import odefunc
from neural_ode_features_tpu_torch.models import (
    ModelConfig,
    block_dynamics,
    init_odenet,
    stem_apply,
)
from neural_ode_features_tpu_torch.solver import (
    odeint,
    odeint_event_adjoint,
)

torch.set_num_threads(2)

TOLS = dict(rtol=1e-10, atol=1e-12)
GRAD_TOL = dict(rtol=1e-6, atol=1e-9)
F64 = torch.float64


def _decay(p, t, y):
    return -p["k"] * y


def _velocity(p, t, y):
    return y * 0.0 + p["v"]


def _osc(p, t, s):
    return {"y": s["v"], "v": -p["w"] ** 2 * s["y"]}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# Each case: (func, params, y0, event_fn(t, y, torch_side), kwargs).  The
# dynamics are written once: the same arithmetic acts on both sides.
CASES = {
    "decay": (_decay, {"k": 1.3}, [2.0], lambda t, y, ts_: y[0] - 0.5,
              dict(t_max=10.0)),
    "constant_velocity": (_velocity, {"v": 0.7}, [0.0],
                          lambda t, y, ts_: y[0] - 1.0, dict(t_max=10.0)),
    "oscillator": (_osc, {"w": 1.7}, {"y": 1.0, "v": 0.0},
                   lambda t, s, ts_: s["y"], dict(t_max=10.0, direction=-1)),
    "per_sample": (_decay, {"k": 1.1}, [[1.0], [2.0], [4.0]],
                   lambda t, y, ts_: y[:, 0] - 0.5,
                   dict(t_max=20.0, error_control="per_sample")),
    "per_sample_unfired_row": (
        _decay, {"k": 1.0}, [[2.0], [2.0]],
        lambda t, y, ts_: y[:, 0] - (torch.tensor([1.0, 1e-6], dtype=F64)
                                     if ts_ else jnp.asarray([1.0, 1e-6])),
        dict(t_max=2.0, error_control="per_sample")),
    "unfired_y_event": (_decay, {"k": 0.9}, [2.0],
                        lambda t, y, ts_: y[0] - 1e-6, dict(t_max=1.5)),
}


def _arrays(y0):
    """A case's state as numpy leaves (a list is one array)."""
    if isinstance(y0, dict):
        return {k: np.asarray(v) for k, v in y0.items()}
    return np.asarray(y0)


def _tree(x, torch_side):
    if isinstance(x, dict):
        return {k: _tree(v, torch_side) for k, v in x.items()}
    return (torch.tensor(x, dtype=F64, requires_grad=True) if torch_side
            else jnp.asarray(x, jnp.float64))


def _cotangents(y0):
    """Fixed weights for the scalar functionals Σ w·t* and Σ w·y*."""
    rng = np.random.default_rng(0)
    y0 = _arrays(y0)
    leaves = jax.tree.leaves(y0)
    w_y = jax.tree.map(lambda a: rng.normal(size=np.shape(a)), y0)
    n_rows = np.shape(leaves[0])[0] if np.ndim(leaves[0]) == 2 else None
    w_t = rng.normal(size=(n_rows,)) if n_rows else rng.normal()
    return w_t, w_y


def _jax_side(case):
    """t*, y* and both pullbacks, jitted as one program (one compile in
    place of the many of an eager solve and its two pullbacks)."""
    func, p, y0, event, kw = CASES[case]
    w_t, w_y = _cotangents(y0)

    def solve(p_, y0_):
        sol = jax_eva(func, p_, y0_, 0.0, lambda t, y: event(t, y, False),
                      **kw, **TOLS)
        return sol.t_event, sol.y_event

    @jax.jit
    def run(p_, y0_, w_t, w_y):
        (t_s, y_s), pull = jax.vjp(solve, p_, y0_)
        grads_t = pull((w_t, jax.tree.map(jnp.zeros_like, y_s)))
        grads_y = pull((jnp.zeros_like(t_s), w_y))
        return t_s, y_s, grads_t, grads_y

    return _np(run(_tree(p, False), _tree(_arrays(y0), False),
                   jnp.asarray(w_t), jax.tree.map(jnp.asarray, w_y)))


def _torch_side(case):
    func, p, y0, event, kw = CASES[case]
    w_t, w_y = _cotangents(y0)
    p_t, y0_t = _tree(p, True), _tree(_arrays(y0), True)
    sol = odeint_event_adjoint(func, p_t, y0_t, 0.0,
                               lambda t, y: event(t, y, True), **kw, **TOLS)
    wrt = jax.tree.leaves(p_t) + jax.tree.leaves(y0_t)
    loss_t = (sol.t_event * torch.as_tensor(w_t, dtype=F64)).sum()
    loss_y = sum((a * torch.as_tensor(w, dtype=F64)).sum() for a, w in zip(
        jax.tree.leaves(sol.y_event), jax.tree.leaves(w_y)))
    g_t = torch.autograd.grad(loss_t, wrt, retain_graph=True,
                              allow_unused=True)
    g_y = torch.autograd.grad(loss_y, wrt, allow_unused=True)
    as_np = lambda g: [np.zeros(()) if x is None else x.numpy() for x in g]
    return sol, as_np(g_t), as_np(g_y)


@pytest.mark.parametrize("case", list(CASES))
def test_event_adjoint_matches_jax(case):
    t_j, y_j, gt_j, gy_j = _jax_side(case)
    sol, g_t, g_y = _torch_side(case)
    np.testing.assert_allclose(sol.t_event.detach().numpy(), t_j, rtol=1e-9,
                               atol=1e-12)
    for a, b in zip(jax.tree.leaves(sol.y_event), jax.tree.leaves(y_j)):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-9,
                                   atol=1e-12)
    # dt*/dξ and dy*/dξ (ξ: every parameter and initial-state leaf).
    for got, want in ((g_t, jax.tree.leaves(gt_j)),
                      (g_y, jax.tree.leaves(gy_j))):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(np.broadcast_to(a, np.shape(b)), b,
                                       **GRAD_TOL)
    assert bool(sol.stats.success.all())


def test_analytic_gradients_on_the_port():
    """The closed forms of tests/test_event_adjoint.py on the port alone:
    decay (t* = ln(a/c)/k, dt*/dk = −t*/k, dt*/da = 1/(ka), y* pinned to
    c), constant velocity (y* constant, dt*/dv = −1/v²) and the oscillator
    (dt*/dw = −π/(2w²), dv*/dw = −1)."""
    k, a, c = 1.3, 2.0, 0.5
    p = {"k": torch.tensor(k, dtype=F64, requires_grad=True)}
    y0 = torch.tensor([a], dtype=F64, requires_grad=True)
    sol = odeint_event_adjoint(_decay, p, y0, 0.0, lambda t, y: y[0] - c,
                               t_max=10.0, **TOLS)
    t_true = math.log(a / c) / k
    g_k, g_a = torch.autograd.grad(sol.t_event, [p["k"], y0],
                                   retain_graph=True)
    np.testing.assert_allclose(float(sol.t_event), t_true, rtol=1e-8)
    np.testing.assert_allclose(float(g_k), -t_true / k, rtol=1e-6)
    np.testing.assert_allclose(float(g_a[0]), 1.0 / (k * a), rtol=1e-6)
    y_k, y_a = torch.autograd.grad(sol.y_event[0], [p["k"], y0])
    assert abs(float(y_k)) < 1e-7 and abs(float(y_a[0])) < 1e-7

    pv = {"v": torch.tensor(0.7, dtype=F64, requires_grad=True)}
    sol = odeint_event_adjoint(_velocity, pv, torch.zeros(1, dtype=F64), 0.0,
                               lambda t, y: y[0] - 1.0, t_max=10.0, **TOLS)
    np.testing.assert_allclose(float(sol.t_event), 1 / 0.7, rtol=1e-9)
    (g_v,) = torch.autograd.grad(sol.t_event, [pv["v"]], retain_graph=True)
    np.testing.assert_allclose(float(g_v), -1 / 0.49, rtol=1e-6)
    (g_yv,) = torch.autograd.grad(sol.y_event[0], [pv["v"]])
    assert abs(float(g_yv)) < 1e-12

    w = 1.7
    pw = {"w": torch.tensor(w, dtype=F64, requires_grad=True)}
    s0 = {"y": torch.tensor(1.0, dtype=F64), "v": torch.tensor(0.0,
                                                              dtype=F64)}
    sol = odeint_event_adjoint(_osc, pw, s0, 0.0, lambda t, s: s["y"],
                               t_max=10.0, direction=-1, **TOLS)
    (g_w,) = torch.autograd.grad(sol.t_event, [pw["w"]], retain_graph=True)
    np.testing.assert_allclose(float(g_w), -math.pi / (2 * w ** 2),
                               rtol=1e-6)
    (g_vw,) = torch.autograd.grad(sol.y_event["v"], [pw["w"]])
    np.testing.assert_allclose(float(g_vw), -1.0, rtol=1e-6)


def test_train_parameter_to_target_hitting_time():
    """Learn k so that decay from 2 crosses 0.5 at T = 2 (k* = ln(4)/2) by
    plain gradient descent on (t*(k) − T)²."""
    a0, c, T = 2.0, 0.5, 2.0
    k = torch.tensor(0.4, dtype=F64, requires_grad=True)
    losses = []
    for _ in range(30):
        t_s = odeint_event_adjoint(
            _decay, {"k": k}, torch.tensor([a0], dtype=F64), 0.0,
            lambda t, y: y[0] - c, t_max=20.0, rtol=1e-8,
            atol=1e-10).t_event
        loss = (t_s - T) ** 2
        (g,) = torch.autograd.grad(loss, [k])
        losses.append(float(loss))
        with torch.no_grad():
            k -= 0.03 * g
    assert losses[-1] < 1e-8 < losses[0]
    np.testing.assert_allclose(float(k), math.log(a0 / c) / T, rtol=1e-3)


def test_odenet_block_through_the_kernel_pair_vjp():
    """The ODE-Net block (hidden 32 on 6×6 maps) with ``vjp=`` from
    ``models.block_dynamics`` (on the CPU: the kernels' plain versions):
    d(Σ t*)/dθ equals autograd through the same dynamics, per sample, each
    row crossing the midpoint of its own mean(h²) between t = 0 and 1."""
    cfg = ModelConfig(in_channels=1, hidden=32)
    params = init_odenet(1, cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(3, 28, 28, 1)).astype(np.float32))
    with torch.no_grad():
        h0 = stem_apply(params["stem"], x, cfg)
    dyn, vjp = block_dynamics(params["odefunc"], h0, cfg)
    with torch.no_grad():
        traj, _ = odeint(lambda t, y: dyn(None, t, y), h0,
                         torch.tensor([0.0, 1.0]), rtol=1e-6, atol=1e-6,
                         error_control="per_sample")
    energy = lambda h: (h * h).mean(dim=(1, 2, 3))
    mid = 0.5 * (energy(traj[0]) + energy(traj[-1]))

    def grads(use_vjp):
        ps = {k: {kk: v.detach().requires_grad_() for kk, v in d.items()}
              for k, d in params["odefunc"].items()}
        if use_vjp:
            dyn_, vjp_ = block_dynamics(ps, h0, cfg)
        else:  # autograd through the same function of the raw parameters
            dyn_, vjp_ = (lambda p, t, h: odefunc(p, t, h,
                                                   groups=cfg.groups)), None
        sol = odeint_event_adjoint(
            dyn_, ps, h0, 0.0, lambda t, h: energy(h) - mid, t_max=1.0,
            rtol=1e-5, atol=1e-5, error_control="per_sample", vjp=vjp_)
        leaves = jax.tree.leaves(ps)
        return sol, torch.cat([g.reshape(-1) for g in torch.autograd.grad(
            sol.t_event.sum(), leaves)])

    sol_k, g_k = grads(True)
    sol_a, g_a = grads(False)
    assert bool(sol_k.fired.all())
    np.testing.assert_allclose(sol_k.t_event.detach().numpy(),
                               sol_a.t_event.detach().numpy(), rtol=1e-6)
    rel = float((g_k - g_a).norm() / g_a.norm())
    assert rel < 1e-4, rel
