"""Port parity, the ODEfunc VJP: the plain PyTorch version of the fused
backward kernel (``odefunc_bwd_plain``) and autograd through the port's
kernel pair (``odefunc_autograd``, plain versions on the CPU) against the JAX
fused backward kernel (``odefunc_pallas_vjp`` in interpret mode, as
tests/test_pallas.py runs it) and ``jax.vjp`` of the jnp ``odefunc_apply``.
The backward kernel itself runs only on a CUDA card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.kernels.odefunc_pallas import (
    _jnp_odefunc,
    odefunc_pallas_vjp,
)
from neural_ode_features_tpu.models import ModelConfig as JaxConfig
from neural_ode_features_tpu.models import init_odenet as jax_init_odenet
from neural_ode_features_tpu.models.odenet import odefunc_apply as jax_odefunc
from neural_ode_features_tpu_torch.kernels.odefunc import (
    PARAM_KEYS,
    odefunc,
    odefunc_autograd,
    odefunc_vjp,
    prepare,
)
from neural_ode_features_tpu_torch.kernels.odefunc_bwd import (
    bwd_supported,
    odefunc_bwd,
    odefunc_bwd_plain,
    tap_contract,
)
from neural_ode_features_tpu_torch.ops.layers import time_map
from neural_ode_features_tpu_torch.utils import from_jax_params

torch.set_num_threads(2)

# tests/test_pallas.py:71-77 and :103-104.
DH_TOL = dict(rtol=2e-4, atol=2e-5)
DT_TOL = dict(rtol=2e-4, atol=1e-5)
DT_PER_SAMPLE_TOL = dict(rtol=5e-3, atol=5e-5)
DP_TOL = dict(rtol=3e-4, atol=3e-4)
F_TOL = dict(rtol=2e-5, atol=2e-5)  # the forward, tests/test_pallas.py:29-30


@pytest.fixture(scope="module")
def odefunc_params():
    cfg = JaxConfig(in_channels=3)
    pj = jax_init_odenet(jax.random.PRNGKey(5), cfg)["odefunc"]
    pj = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), pj)
    return cfg, pj, from_jax_params(pj, device="cpu")


def _flat_jax(tree):
    return np.concatenate([np.asarray(tree[a][b]).reshape(-1)
                           for a, b in PARAM_KEYS])


def _flat_torch(tree):
    return np.concatenate([tree[a][b].detach().numpy().reshape(-1)
                           for a, b in PARAM_KEYS])


@pytest.mark.parametrize("batch,side", [(8, 6), (4, 7)])
@pytest.mark.parametrize("t_kind", ["scalar", "per_sample"])
def test_vjp_matches_jax(odefunc_params, batch, side, t_kind):
    cfg, pj, pt = odefunc_params
    rng = np.random.default_rng(side * 10 + batch)
    h = rng.normal(size=(batch, side, side, 64)).astype(np.float32)
    g = rng.normal(size=h.shape).astype(np.float32)
    t = (np.float32(0.43) if t_kind == "scalar"
         else rng.uniform(0.1, 0.9, batch).astype(np.float32))
    hj, gj, tj = jnp.asarray(h), jnp.asarray(g), jnp.asarray(t)

    def loss_pallas(p, tt, hh):
        return jnp.sum(odefunc_pallas_vjp(p, tt, hh, 32, True) * gj)

    def loss_jnp(p, tt, hh):
        return jnp.sum(jax_odefunc(p, tt, hh, cfg) * gj)

    refs = [jax.grad(f, argnums=(0, 1, 2))(pj, tj, hj)
            for f in (loss_pallas, loss_jnp)]

    # The plain version of the backward kernel: per-sample dt, raw dθ.
    dp, dt_b, dh = odefunc_bwd_plain(prepare(pt, (side, side)),
                                     torch.as_tensor(t), torch.from_numpy(h),
                                     torch.from_numpy(g), 32)
    assert dt_b.shape == (batch,)
    assert dp["conv1"]["kernel"].shape == (3, 3, 65, 64)
    dt = dt_b.sum() if t_kind == "scalar" else dt_b

    # Autograd through the kernel pair (its plain versions on the CPU).
    leaves = {k: {kk: v.clone().requires_grad_() for kk, v in d.items()}
              for k, d in pt.items()}
    ta = torch.tensor(t, requires_grad=True)
    ha = torch.from_numpy(h).requires_grad_()
    out = odefunc_autograd(leaves, ta, ha, groups=32)
    out.backward(torch.from_numpy(g))
    assert ta.grad.shape == ta.shape
    pair_dp = {k: {kk: v.grad for kk, v in d.items()} for k, d in leaves.items()}

    dt_tol = DT_TOL if t_kind == "scalar" else DT_PER_SAMPLE_TOL
    for gp, gt, gh in refs:
        for got_dp, got_dt, got_dh in ((dp, dt, dh),
                                       (pair_dp, ta.grad, ha.grad)):
            np.testing.assert_allclose(got_dh.detach().numpy(),
                                       np.asarray(gh), **DH_TOL)
            np.testing.assert_allclose(got_dt.detach().numpy(),
                                       np.asarray(gt), **dt_tol)
            np.testing.assert_allclose(_flat_torch(got_dp), _flat_jax(gp),
                                       **DP_TOL)


@pytest.mark.parametrize("c", [96, 512])
def test_new_widths_match_jax(c):
    """The widths the kernels take since the tensor-core stage pads its
    last channel block (96) and keeps the state in global scratch (512), on
    6×6 maps, B = 2: the port's ``odefunc`` and ``odefunc_vjp`` (their plain
    versions on the CPU) against the JAX ``odefunc_pallas`` and its VJP.
    The Pallas pair runs in interpret mode at 96; at 512 the JAX side is
    its ``_jnp_odefunc`` mirror, to keep the run short."""
    cfg = JaxConfig(in_channels=1, hidden=c)
    pj = jax_init_odenet(jax.random.PRNGKey(c), cfg)["odefunc"]
    pj = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), pj)
    pt = from_jax_params(pj, device="cpu")
    rng = np.random.default_rng(c)
    h = (rng.normal(size=(2, 6, 6, c)) * 0.5).astype(np.float32)
    g = rng.normal(size=h.shape).astype(np.float32)
    t = rng.uniform(0.1, 0.9, 2).astype(np.float32)
    hj, gj, tj = jnp.asarray(h), jnp.asarray(g), jnp.asarray(t)

    if c == 96:
        def fj(p, tt, hh):
            return odefunc_pallas_vjp(p, tt, hh, 32, True)
    else:
        def fj(p, tt, hh):
            return _jnp_odefunc(p, tt, hh, 32)

    f_j, pullback = jax.vjp(fj, pj, tj, hj)
    gp, gt, gh = pullback(gj)
    f, dp, dt, dh = odefunc_vjp(pt, torch.from_numpy(t), torch.from_numpy(h),
                                torch.from_numpy(g), groups=32)
    np.testing.assert_allclose(odefunc(pt, torch.from_numpy(t),
                                       torch.from_numpy(h)).numpy(),
                               np.asarray(f_j), **F_TOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_j), **F_TOL)
    np.testing.assert_allclose(dh.numpy(), np.asarray(gh), **DH_TOL)
    np.testing.assert_allclose(dt.numpy(), np.asarray(gt),
                               **DT_PER_SAMPLE_TOL)
    np.testing.assert_allclose(_flat_torch(dp), _flat_jax(gp), **DP_TOL)


def test_wrapper_and_vjp_take_the_plain_path_on_cpu(odefunc_params):
    _, _, pt = odefunc_params
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.normal(size=(3, 7, 7, 64)).astype(np.float32))
    a = torch.from_numpy(rng.normal(size=h.shape).astype(np.float32))
    t = torch.tensor([0.3])
    before = odefunc_bwd.launches
    dp, dt_b, dh = odefunc_bwd(pt, t, h, a, groups=32)
    assert odefunc_bwd.launches == before  # no kernel launch on the CPU
    want = odefunc_bwd_plain(prepare(pt, (7, 7)), t, h, a, 32)
    assert torch.equal(dh, want[2]) and torch.equal(dt_b, want[1])
    f, dp2, dt, dh2 = odefunc_vjp(pt, t, h, a, groups=32)
    assert f.shape == h.shape and dt.shape == (1,)
    assert torch.allclose(dt, dt_b.sum().reshape(1))
    assert torch.equal(dh2, dh)
    np.testing.assert_array_equal(_flat_torch(dp2), _flat_torch(dp))


def test_tap_contract_is_the_adjoint_of_time_map():
    """<time_map(k), dm> = <k_t, tap_contract(dm)> for every kernel and
    cotangent (time_map computes in f32, hence the tolerance): the
    time-column gradient is exact, border taps included."""
    rng = np.random.default_rng(0)
    k = torch.from_numpy(rng.normal(size=(3, 3, 5, 4)))
    dm = torch.from_numpy(rng.normal(size=(6, 7, 4)))
    lhs = (time_map(k, 6, 7).double() * dm).sum()
    rhs = (k[:, :, :1, :] * tap_contract(dm)).sum()
    assert torch.allclose(lhs, rhs, rtol=1e-6, atol=0)
    # A corner tap reads inside the map on (H-1)×(W-1) pixels only.
    ones = tap_contract(torch.ones((6, 7, 1)))
    assert float(ones[0, 0, 0, 0]) == 30.0 and float(ones[1, 1, 0, 0]) == 42.0


def test_backward_gate():
    assert bwd_supported((7, 7), 64, 32)  # CIFAR-10
    assert bwd_supported((6, 6), 64, 32)  # MNIST
    # 32, 96: the 32-wide weight tile; 512: u and x in global scratch.
    for c in (32, 96, 128, 256, 512):
        assert bwd_supported((7, 7), c, 32) and bwd_supported((6, 6), c, 32)
    assert not bwd_supported((7, 7), 16, 16)  # below the weight tile
    assert not bwd_supported((7, 7), 544, 32)  # C > 512, as in JAX
    assert not bwd_supported((28, 28), 64, 32)  # shared memory
