"""Port parity, the solver's loop modes (``unroll='while'|'scan'|
'scan_remat'``) against the JAX package, on the CPU.

* ``'scan'`` runs exactly ``max_steps`` attempts; a done row no longer
  changes, so ys and every stat are bit-identical to ``'while'``'s.
* ``'scan'`` and ``'scan_remat'`` are reverse-differentiable and give the
  same values and gradients (JAX ``test_scan_remat_matches_scan_gradients``:
  value rtol 1e-12, gradients 1e-9, f64); the port's gradients agree with
  JAX's at 1e-8.
* Adams in scan mode: finite gradients in f64 and f32 (JAX
  ``tests/test_adams.py``), values against JAX at the Adams bar, 1e-8.
* One attempt makes no host read: run on ``device="meta"`` tensors, where
  ``bool()``, ``float()`` and ``.item()`` raise.  That is the CPU's proxy
  for "capturable as a CUDA graph" (the graph route itself is tested on the
  card, ``tests/test_torch_cuda.py``).

The JAX sides are jitted whole with ``max_steps`` <= 48; arrays are made
with numpy in an explicit dtype (``tests/conftest.py`` enables x64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.ops import layers as jax_layers
from neural_ode_features_tpu.solver import odeint as jax_odeint
from neural_ode_features_tpu_torch.kernels.odefunc import odefunc_plain, prepare
from neural_ode_features_tpu_torch.kernels.rk_step import dopri5_step_plain
from neural_ode_features_tpu_torch.ops import layers
from neural_ode_features_tpu_torch.solver import (
    DOPRI5,
    adams_odeint,
    odeint,
    odeint_adjoint,
)
from neural_ode_features_tpu_torch.solver.runge_kutta import adaptive_odeint

torch.set_num_threads(2)

STATS = ("nfe", "naccept", "nreject", "success")
_LAMBDA = np.array([-0.5, -1.0, -3.0, -6.0])
_Y0 = np.array([[1.0, 2.0], [1.0, -1.0], [0.5, 1.5], [2.0, 0.25]])


def _decay(t, y):
    lam = torch.as_tensor(_LAMBDA, dtype=y.dtype, device=y.device)
    return lam[:, None] * y + torch.sin(3.0 * y.flip(-1))


def _assert_same(a, b):
    (ys_a, st_a), (ys_b, st_b) = a, b
    assert torch.equal(ys_a, ys_b)
    for name in STATS:
        assert torch.equal(getattr(st_a, name), getattr(st_b, name)), name


_ROWS = torch.tensor([1e-3, 1e-5, 1e-4, 1e-6], dtype=torch.float64)
LOOP_CASES = {
    "dopri5-per_sample-i": dict(method="dopri5", error_control="per_sample"),
    "bosh3-per_sample-i": dict(method="bosh3", error_control="per_sample",
                               rtol=1e-3, atol=1e-5),
    "tsit5-global-i": dict(method="tsit5"),
    "dopri5-global-pi": dict(method="dopri5", controller="pi"),
    "tsit5-per_sample-pi": dict(method="tsit5", error_control="per_sample",
                                controller="pi"),
    "error_mask": dict(method="dopri5", error_control="per_sample",
                       error_mask=np.array([1.0, 0.0])),
    "row_tolerances": dict(method="dopri5", error_control="per_sample",
                           rtol=_ROWS, atol=_ROWS),
}


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_scan_equals_while(case):
    """Every adaptive tableau, per-sample and global control, both
    controllers, a seminorm mask and per-row tolerances: 'scan' (and
    'scan_remat') bit-identical to 'while' in values and stats."""
    kw = dict(rtol=1e-4, atol=1e-6, max_steps=48)
    kw.update(LOOP_CASES[case])
    ts = torch.linspace(0.0, 1.5, 4, dtype=torch.float64)
    y0 = torch.from_numpy(_Y0)
    runs = {mode: odeint(_decay, y0, ts, unroll=mode, **kw)
            for mode in ("while", "scan", "scan_remat")}
    assert bool(runs["while"][1].success.all())
    assert int(runs["while"][1].naccept.min()) > 1
    _assert_same(runs["while"], runs["scan"])
    _assert_same(runs["while"], runs["scan_remat"])


def _fused_block(hw=(3, 3), c=8, groups=4, batch=3, seed=0):
    """A small ODE-Net block as the fused step's plain version sees it."""
    rng = np.random.default_rng(seed)

    def arr(*shape, scale=0.3):
        return torch.from_numpy((rng.normal(size=shape) * scale)
                                .astype(np.float32))

    params = {f"norm{i}": {"scale": 1.0 + arr(c, scale=0.1),
                           "bias": arr(c, scale=0.1)} for i in (1, 2, 3)}
    for name in ("conv1", "conv2"):
        params[name] = {"kernel": arr(3, 3, c + 1, c), "bias": arr(c)}
    w = prepare(params, hw)
    n = hw[0] * hw[1] * c
    y0 = arr(batch, n, scale=1.0)

    def func(t, y):
        return odefunc_plain(w, t, y.reshape(-1, *hw, c), groups).reshape(
            y.shape)

    def fused(t0, dt, y, f, rtol=1e-3, atol=1e-3):
        return dopri5_step_plain(w, DOPRI5, t0, dt, y, f, hw=hw,
                                 groups=groups, rtol=rtol, atol=atol)

    return func, fused, y0


def test_scan_equals_while_fused_step():
    """The fused step's plain version (the CPU side of ``rk_step``) in the
    attempt: 'scan' bit-identical to 'while', dense output at T = 4."""
    func, fused, y0 = _fused_block()
    ts = torch.linspace(0.0, 1.0, 4)
    runs = [adaptive_odeint(func, y0, ts, 1e-3, 1e-3, DOPRI5, max_steps=24,
                            fused_step=fused, unroll=mode)
            for mode in ("while", "scan")]
    assert bool(runs[0][1].success.all())
    _assert_same(*runs)


def _gn64(gn, x, groups, mean_var):
    """GroupNorm with f64 statistics (both packages' ``group_norm`` take
    them in f32), the same formula on each side.  The ConcatConv is the
    packages' ``conv2d`` of ``concat_time_channel`` (their split lowering
    builds its time map in f32)."""
    b, h, w, c = x.shape
    xg = x.reshape(b, h, w, groups, c // groups)
    mean, var = mean_var(xg)
    return ((xg - mean) / (var + 1e-5) ** 0.5).reshape(b, h, w, c) * gn[
        "scale"] + gn["bias"]


def _block_params(c=8, seed=3):
    rng = np.random.default_rng(seed)
    p = {f"norm{i}": {"scale": 1.0 + 0.1 * rng.normal(size=c),
                      "bias": 0.1 * rng.normal(size=c)} for i in (1, 2, 3)}
    for name in ("conv1", "conv2"):
        p[name] = {"kernel": 0.3 * rng.normal(size=(3, 3, c + 1, c)),
                   "bias": 0.1 * rng.normal(size=c)}
    return p


def _torch_block(p, groups):
    def mv(xg):
        m = xg.mean(dim=(1, 2, 4), keepdim=True)
        return m, ((xg - m) ** 2).mean(dim=(1, 2, 4), keepdim=True)

    def f(t, h):
        out = torch.relu(_gn64(p["norm1"], h, groups, mv))
        out = layers.conv2d(p["conv1"], layers.concat_time_channel(t, out),
                             padding=1)
        out = torch.relu(_gn64(p["norm2"], out, groups, mv))
        out = layers.conv2d(p["conv2"], layers.concat_time_channel(t, out),
                             padding=1)
        return _gn64(p["norm3"], out, groups, mv)
    return f


def _jax_block(p, groups):
    def mv(xg):
        m = jnp.mean(xg, axis=(1, 2, 4), keepdims=True)
        return m, jnp.mean((xg - m) ** 2, axis=(1, 2, 4), keepdims=True)

    def f(t, h):
        out = jax.nn.relu(_gn64(p["norm1"], h, groups, mv))
        out = jax_layers.conv2d(p["conv1"], jax_layers.concat_time_channel(t, out),
                                 padding=1)
        out = jax.nn.relu(_gn64(p["norm2"], out, groups, mv))
        out = jax_layers.conv2d(p["conv2"], jax_layers.concat_time_channel(t, out),
                                 padding=1)
        return _gn64(p["norm3"], out, groups, mv)
    return f


def test_scan_matches_jax_odenet_block():
    """The ODE-Net block (hidden 8, 4×4 maps, f64), per-sample dopri5 in
    scan mode: values within 1e-10 of JAX's, per-sample stats equal."""
    p = _block_params()
    h0 = np.random.default_rng(4).normal(size=(3, 4, 4, 8))
    ts = np.array([0.0, 0.5, 1.0])
    kw = dict(rtol=1e-4, atol=1e-6, error_control="per_sample",
              max_steps=24, unroll="scan")
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    ys_j, st_j = jax.jit(lambda h: jax_odeint(_jax_block(jp, 4), h,
                                              jnp.asarray(ts), **kw))(
        jnp.asarray(h0))
    tp = jax.tree_util.tree_map(torch.from_numpy, p)
    ys, st = odeint(_torch_block(tp, 4), torch.from_numpy(h0),
                    torch.from_numpy(ts), **kw)
    assert bool(st.success.all()) and int(st.naccept.min()) > 2
    for name in STATS:
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(st_j, name)), name)
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), rtol=1e-10,
                               atol=1e-10)


_TOL = dict(rtol=1e-9, atol=1e-11)


def _mlp(lib, p, t, y):
    return lib.tanh(y @ p["w"] + p["b"]) * p["freq"] - 0.3 * y


def _grad_params(seed=5, dim=3):
    rng = np.random.default_rng(seed)
    return ({"w": rng.normal(size=(dim, dim)) / np.sqrt(dim),
             "b": 0.1 * rng.normal(size=dim), "freq": np.float64(1.3)},
            rng.normal(size=(4, dim)), np.array([0.0, 0.4, 1.0]))


def _port_value_grad(p_np, y0, ts, mode):
    p = {k: torch.tensor(v, requires_grad=True) for k, v in p_np.items()}
    ys, _ = odeint(lambda t, y: _mlp(torch, p, t, y), torch.from_numpy(y0),
                   torch.from_numpy(ts), unroll=mode, max_steps=32, **_TOL)
    loss = (ys ** 2).sum()
    grads = torch.autograd.grad(loss, [p[k] for k in sorted(p)])
    return float(loss.detach()), np.concatenate([g.reshape(-1).numpy()
                                        for g in grads])


def test_scan_remat_matches_scan_gradients():
    """The port's counterpart of JAX ``test_scan_remat_matches_scan_
    gradients`` (global control, f64): 'scan_remat' gives 'scan''s value
    (rtol 1e-12) and gradients (rtol 1e-9); both against JAX's gradients
    through its own 'scan' at 1e-8."""
    p_np, y0, ts = _grad_params()
    va, ga = _port_value_grad(p_np, y0, ts, "scan")
    vb, gb = _port_value_grad(p_np, y0, ts, "scan_remat")
    np.testing.assert_allclose(va, vb, rtol=1e-12)
    np.testing.assert_allclose(ga, gb, rtol=1e-9)

    def loss(p):
        ys, _ = jax_odeint(lambda t, y: _mlp(jnp, p, t, y), jnp.asarray(y0),
                           jnp.asarray(ts), unroll="scan", max_steps=32,
                           **_TOL)
        return jnp.sum(ys ** 2)

    vj, gj = jax.jit(jax.value_and_grad(loss))(
        jax.tree_util.tree_map(jnp.asarray, p_np))
    gj = np.concatenate([np.asarray(gj[k]).reshape(-1) for k in sorted(gj)])
    np.testing.assert_allclose(va, float(vj), rtol=1e-10)
    np.testing.assert_allclose(ga, gj, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_adams_scan_gradients_finite(dtype):
    """JAX ``tests/test_adams.py`` scan-mode cases: the order ramp's
    history columns would make the Vandermonde solves singular, and in f32
    sqrt'(0) would turn the controller's zero cotangents into NaN; neither
    reaches the gradient, which is 2·exp(-2) per entry."""
    y0 = torch.ones((2, 3), dtype=dtype, requires_grad=True)
    ys, st = odeint(lambda t, y: -y, y0, torch.tensor([0.0, 1.0], dtype=dtype),
                    rtol=1e-5, atol=1e-7, method="adams", unroll="scan",
                    max_steps=24)
    assert bool(st.success.all())
    (g,) = torch.autograd.grad((ys[-1] ** 2).sum(), [y0])
    assert g.dtype == dtype and bool(torch.isfinite(g).all()), g
    np.testing.assert_allclose(g.detach().numpy(), 2 * np.exp(-2.0),
                               rtol=1e-3)


def test_adams_scan_matches_while_and_jax():
    """Adams in scan mode: 'scan' and 'scan_remat' bit-identical to the
    port's 'while', values within 1e-8 of JAX's 'scan' (the Adams bar)
    with equal stats, f64."""
    ts = np.array([0.0, 0.3, 0.7])
    kw = dict(rtol=1e-4, atol=1e-6, method="adams",
              error_control="per_sample", max_steps=48)
    y0 = torch.from_numpy(_Y0)
    runs = {mode: odeint(_decay, y0, torch.from_numpy(ts), unroll=mode, **kw)
            for mode in ("while", "scan", "scan_remat")}
    assert bool(runs["while"][1].success.all())
    _assert_same(runs["while"], runs["scan"])
    _assert_same(runs["while"], runs["scan_remat"])

    def jax_decay(t, y):
        return (jnp.asarray(_LAMBDA)[:, None] * y
                + jnp.sin(3.0 * jnp.flip(y, -1)))

    ys_j, st_j = jax.jit(lambda y: jax_odeint(
        jax_decay, y, jnp.asarray(ts), unroll="scan", **kw))(
        jnp.asarray(_Y0))
    ys, st = runs["scan"]
    for name in STATS:
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(st_j, name)), name)
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), rtol=1e-8,
                               atol=1e-10)


def test_adjoint_scan_equals_while():
    """``odeint_adjoint(unroll='scan')``: the forward and the backward solve
    in scan mode give the values, stats, backward NFE and gradients of
    'while', bit for bit."""
    p_np, y0, ts = _grad_params(seed=6)

    def run(mode):
        p = {k: torch.tensor(v, requires_grad=True) for k, v in p_np.items()}
        y = torch.tensor(y0, requires_grad=True)
        ys, st = odeint_adjoint(lambda pp, t, yy: _mlp(torch, pp, t, yy), p,
                                y, torch.from_numpy(ts), rtol=1e-6,
                                atol=1e-8, error_control="per_sample",
                                max_steps=16, unroll=mode)
        (ys ** 2).sum().backward()
        return ys.detach(), st, [p[k].grad for k in sorted(p)] + [y.grad]

    ys_w, st_w, g_w = run("while")
    ys_s, st_s, g_s = run("scan")
    assert torch.equal(ys_w, ys_s)
    for name in (*STATS, "nfe_b"):
        assert torch.equal(getattr(st_w, name), getattr(st_s, name)), name
    assert int(st_w.nfe_b) > 0
    for a, b in zip(g_w, g_s):
        assert torch.equal(a, b)


@pytest.mark.parametrize("method", ["dopri5", "adams"])
def test_unknown_unroll_raises_like_jax(method):
    y0, ts = np.ones((1, 2)), np.array([0.0, 1.0])
    with pytest.raises(ValueError, match="unknown unroll mode 'bogus'") as e:
        odeint(lambda t, y: -y, torch.from_numpy(y0), torch.from_numpy(ts),
               method=method, unroll="bogus")
    with pytest.raises(ValueError) as ej:  # raised while tracing
        jax.jit(lambda y: jax_odeint(lambda t, yy: -yy, y, jnp.asarray(ts),
                                     method=method, unroll="bogus"))(
            jnp.asarray(y0))
    assert str(e.value) == str(ej.value)


def _meta(*shape):
    return torch.empty(shape, device="meta")


def _meta_solve(func, **kw):
    return adaptive_odeint(func, _meta(3, 72), _meta(4), 1e-3, 1e-3, DOPRI5,
                           unroll="scan", max_steps=1, **kw)


def _meta_fused_step(t0, dt, y, f):
    """The fused step's plain version on meta weights (3×3×8, groups 4)."""
    c = 8
    params = {f"norm{i}": {"scale": _meta(c), "bias": _meta(c)}
              for i in (1, 2, 3)}
    for name in ("conv1", "conv2"):
        params[name] = {"kernel": _meta(3, 3, c + 1, c), "bias": _meta(c)}
    return dopri5_step_plain(prepare(params, (3, 3)), DOPRI5, t0, dt, y, f,
                             hw=(3, 3), groups=4, rtol=1e-3, atol=1e-3)


def _meta_dynamics(t, y):
    return -y * t[:, None]


@pytest.mark.parametrize("path", ["tableau", "tableau-pi-mask", "fused",
                                  "adams"])
def test_attempt_makes_no_host_read(path):
    """One attempt on ``device="meta"`` tensors, whose ``bool()``,
    ``float()`` and ``.item()`` raise: the tableau path (also with the PI
    controller and a seminorm mask), the fused step's plain version, and
    an Adams attempt.  A read in the dynamics does raise there (the
    control)."""
    if path == "tableau":
        ys, st = _meta_solve(_meta_dynamics)
    elif path == "tableau-pi-mask":
        ys, st = _meta_solve(_meta_dynamics, controller="pi",
                             error_mask=_meta(3, 72))
    elif path == "fused":
        ys, st = _meta_solve(_meta_dynamics, fused_step=_meta_fused_step)
    else:
        ys, st = adams_odeint(_meta_dynamics, _meta(3, 72), _meta(4), 1e-3,
                              1e-3, unroll="scan", max_steps=1)
    assert ys.device.type == "meta" and tuple(ys.shape) == (4, 3, 72)
    assert all(x.device.type == "meta" for x in st)
    with pytest.raises(RuntimeError, match="meta"):
        _meta_solve(lambda t, y: -y * float(y.sum()))


def test_graph_cache_key_sees_every_weight_update():
    """The graph cache's key (``attempt_graph.cache_key``) takes a tensor by
    address and version counter: an optimizer step, an in-place write and a
    copy into the weights each give a new key (a replay can never read old
    weights), the same unchanged tensors the same key, and the key holds
    the tensors it names."""
    from neural_ode_features_tpu_torch.solver.attempt_graph import cache_key

    w = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.SGD([w], lr=0.1, momentum=0.9)
    keys = [cache_key(("odenet_solve", 1e-3, (w,)))[0]]
    assert cache_key(("odenet_solve", 1e-3, (w,)))[0] == keys[0]
    w.grad = torch.ones(3)
    opt.step()
    keys.append(cache_key(("odenet_solve", 1e-3, (w,)))[0])
    with torch.no_grad():
        w.mul_(2.0)
    keys.append(cache_key(("odenet_solve", 1e-3, (w,)))[0])
    with torch.no_grad():
        w.copy_(torch.zeros(3))
    key, keep = cache_key(("odenet_solve", 1e-3, (w,)))
    keys.append(key)
    assert len(set(keys)) == 4
    assert keep == [w]
