"""Port parity, the backward kernel's weight gradients: the plain-PyTorch
emulation of the kernel's tensor-core arithmetic
(``kernels.odefunc_bwd.weight_grad_emulated``: 3×TF32 products, each 32-row
step of a sample summed from zero, the batch in ``weight_splits`` chunks
added in order; bf16: exact products, the sum rounded once) against the
float64 plain VJP and against the JAX fused backward kernel
(``odefunc_bwd_rows`` in interpret mode), on inputs from a numpy seed.  The
kernel itself runs only on a CUDA card (tests/test_torch_cuda.py,
chip_smoke.py), where it is held against this emulation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.kernels.odefunc_bwd_rows import odefunc_bwd_rows
from neural_ode_features_tpu.models import ModelConfig as JaxConfig
from neural_ode_features_tpu.models import init_odenet as jax_init_odenet
from neural_ode_features_tpu_torch.kernels.conv3x3 import tf32_split
from neural_ode_features_tpu_torch.kernels.odefunc import (
    MAX_SMEM,
    bf16_round,
    prepare,
    refusal,
)
from neural_ode_features_tpu_torch.kernels.odefunc_bwd import (
    bwd_refusal,
    bwd_residuals_plain,
    odefunc_bwd,
    odefunc_bwd_plain,
    weight_grad_emulated,
    weight_grad_f64,
    weight_smem_bytes,
    weight_splits,
)
from neural_ode_features_tpu_torch.utils import from_jax_params

torch.set_num_threads(2)

SHAPES = [(c, side, batch) for c in (32, 64) for side in (6, 7)
          for batch in (5, 16)]


def _problem(c, side, batch, seed=0):
    """The JAX-initialised ODEfunc at hidden ``c`` (raw JAX params and the
    port's laid-out weights) and seeded t, h, g."""
    pj = jax_init_odenet(jax.random.PRNGKey(c + side),
                         JaxConfig(in_channels=3, hidden=c))["odefunc"]
    pj = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), pj)
    w = prepare(from_jax_params(pj, device="cpu"), (side, side))
    rng = np.random.default_rng(seed + 100 * c + 10 * side + batch)
    h = (rng.normal(size=(batch, side, side, c)) * 0.3).astype(np.float32)
    g = rng.normal(size=h.shape).astype(np.float32)
    t = rng.uniform(0.1, 0.9, batch).astype(np.float32)
    return pj, w, t, h, g


def _f64(w, t, h, g):
    return (type(w)(*(x.double() for x in w)),
            *(torch.from_numpy(a).double() for a in (t, h, g)))


@pytest.mark.parametrize("c,side,batch", SHAPES)
def test_emulation_against_the_f64_vjp(c, side, batch):
    """f32: the emulation on the float64 path's activations and cotangents
    (cast to f32) lies within 1e-6 of the sum of |products| per entry from
    the f64 plain VJP's conv-kernel gradients (measured: at most 2.1e-7;
    3×TF32 carries about 2^-21 per product, the f32 casts 2^-24 per
    operand).  One TF32 pass lies beyond 1e-4 (2^-11 per operand), so the
    bound tells the compensated products from plain TF32."""
    _, w, t, h, g = _problem(c, side, batch)
    args64 = _f64(w, t, h, g)
    dp64 = odefunc_bwd_plain(*args64, 32)[0]
    r1, r2, gu, gv = bwd_residuals_plain(*args64, 32)
    for conv, (r, gg) in enumerate(((r1, gu), (r2, gv))):
        want = dp64[f"conv{conv + 1}"]["kernel"][:, :, 1:, :]
        scale = weight_grad_f64(r, gg, True)
        got = weight_grad_emulated(r, gg)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert float(((got.double() - want).abs() / scale).max()) <= 1e-6
        one_pass = weight_grad_emulated(tf32_split(r)[0], tf32_split(gg)[0],
                                        "bf16", splits=1)
        assert float(((one_pass.double() - want).abs() / scale).max()) > 1e-4


@pytest.mark.parametrize("c,side,batch", SHAPES)
def test_bf16_emulation_rounds_the_exact_sum_once(c, side, batch):
    """bf16: the plain bf16 path's activations and cotangents hold bf16
    values, so the emulation's products are exact and its f32 sum lies
    within 1e-6 of the sum of |products| of the f64 sum; rounded once, it
    lies within half a bf16 ulp of that (at most 2^-8 of its size) plus
    that error.  Against the plain bf16 VJP's conv-kernel gradients (autograd
    in bf16, a sum rounded once by the library): within one bf16 ulp
    (2^-7 of the larger), where the two f32 sums straddle a rounding."""
    _, w, t, h, g = _problem(c, side, batch)
    tt, hh, gg_ = (torch.from_numpy(a) for a in (t, h, g))
    r1, r2, gu, gv = bwd_residuals_plain(w, tt, hh, gg_, 32, "bf16")
    dp16 = odefunc_bwd_plain(w, tt, hh, gg_, 32, precision="bf16")[0]
    for conv, (r, gg) in enumerate(((r1, gu), (r2, gv))):
        assert torch.equal(r, bf16_round(r)) and torch.equal(gg, bf16_round(gg))
        got = weight_grad_emulated(r, gg, "bf16")
        assert torch.equal(got, bf16_round(got))
        exact = weight_grad_f64(r, gg)
        scale = weight_grad_f64(r, gg, True)
        assert bool(((got.double() - exact).abs()
                     <= 2.0 ** -8 * exact.abs() + 1e-6 * scale).all())
        plain = dp16[f"conv{conv + 1}"]["kernel"][:, :, 1:, :].float()
        assert bool(((got - plain).abs()
                     <= 2.0 ** -7 * torch.maximum(got.abs(), plain.abs()))
                    .all())


@pytest.mark.parametrize("c,side,batch", [(32, 6, 5), (64, 7, 16),
                                          (64, 6, 16), (32, 7, 5)])
def test_emulation_against_the_jax_kernel(c, side, batch):
    """The JAX fused backward kernel (``odefunc_bwd_rows``, interpret mode,
    its weight gradients one f32 (9C × rows)·(rows × C) product at HIGHEST
    precision) against the emulation on the port's plain f32 activations
    and cotangents: within 1e-5 of the sum of |products| per entry (each
    side's r and g carry its own f32 forward, about 1e-6 of it apart)."""
    pj, w, t, h, g = _problem(c, side, batch, seed=1)
    dpj = odefunc_bwd_rows(pj, jnp.asarray(t), jnp.asarray(h), jnp.asarray(g),
                           groups=32, hw=(side, side), interpret=True)[0]
    r1, r2, gu, gv = bwd_residuals_plain(
        w, *(torch.from_numpy(a) for a in (t, h, g)), 32)
    for conv, (r, gg) in enumerate(((r1, gu), (r2, gv))):
        want = torch.from_numpy(np.asarray(
            dpj[f"conv{conv + 1}"]["kernel"])[:, :, 1:, :]).double()
        got = weight_grad_emulated(r, gg).double()
        assert float(((got - want).abs() / weight_grad_f64(r, gg, True)).max()
                     ) <= 1e-5


def test_residuals_are_what_the_vjp_contracts():
    """In float64 the contraction of ``bwd_residuals_plain``'s r and g is
    the plain VJP's conv-kernel gradient (the same autograd graph), and the
    splits do not change the emulation beyond f32 rounding."""
    _, w, t, h, g = _problem(64, 7, 5)
    args64 = _f64(w, t, h, g)
    dp64 = odefunc_bwd_plain(*args64, 32)[0]
    r1, r2, gu, gv = bwd_residuals_plain(*args64, 32)
    assert r1.shape == (5, 7, 7, 64) and r1.dtype == torch.float32
    for conv, (r, gg) in enumerate(((r1, gu), (r2, gv))):
        want = dp64[f"conv{conv + 1}"]["kernel"][:, :, 1:, :]
        scale = weight_grad_f64(r, gg, True)
        ones = [weight_grad_emulated(r, gg, splits=ns) for ns in (1, 2, 5)]
        for a in ones:
            assert float(((a.double() - want).abs() / scale).max()) <= 1e-6
    with pytest.raises(ValueError, match="precision"):
        bwd_residuals_plain(*args64, 32, precision="f16")
    with pytest.raises(ValueError, match="float32"):
        weight_grad_emulated(r1.double(), gu)


def test_weight_splits():
    """The row chunks: at least one sample each, at most 64; B = 128 at
    C = 64 fills the 132 SMs with one wave (22 chunks × 6 CTAs); the
    scratch (splits, 2, 9, C, C) at every width to 512 and B up to 1,024
    stays under the 151 MB the FFMA kernel's fixed 8 chunks took at
    C = 512; a ragged B = 5 runs."""
    assert weight_splits(128, 64) == 22
    assert weight_splits(128, 512) == 1
    assert weight_splits(5, 64) == 5
    assert weight_splits(1, 32) == 1
    for c in range(32, 513, 32):
        for b in (1, 5, 64, 128, 256, 1024):
            ns = weight_splits(b, c)
            assert 1 <= ns <= min(b, 64)
            assert 4 * ns * 2 * 9 * c * c <= 8 * 2 * 9 * 512 * 512 * 4


def test_weight_stage_fits_every_shape_the_forward_takes():
    """The weight-gradient staging (two buffers of a bordered r map and g
    rows) fits shared memory at every shape the forward kernels take with
    C ≥ 32, so its clause in ``bwd_refusal`` refuses nothing more."""
    for c in range(32, 513, 32):
        for hh in range(1, 17):
            for ww in range(1, 130):
                if refusal((hh, ww), c, 32) is None:
                    assert weight_smem_bytes((hh, ww), c) <= MAX_SMEM
                    why = bwd_refusal((hh, ww), c, 32)
                    assert why is None or "weight-gradient" not in why


def test_residuals_keyword_is_for_the_kernel():
    """On the CPU the wrapper takes the plain version and leaves a
    ``residuals`` dict untouched (only a kernel launch has scratch)."""
    _, w, t, h, g = _problem(32, 6, 5)
    res = {}
    out = odefunc_bwd(w, torch.from_numpy(t), torch.from_numpy(h),
                      torch.from_numpy(g), groups=32, residuals=res)
    assert res == {} and len(out) == 3


def test_bwd_kernel_work():
    """The backward's three launches' work at 7×7×64, B = 128: the weight
    gradients are two convs' operations (0.925 GFLOP) over the four
    residuals (6.4 MB) and one (2, 9, 64, 64) result, whatever the chunks
    (so its bound, 2.0 µs by bytes, does not move with the split count);
    the per-sample pass four convs; the reduction only bytes, the chunks
    among them."""
    from neural_ode_features_tpu_torch.utils.flops import (
        bwd_kernel_bounds,
        bwd_kernel_work,
    )

    work = bwd_kernel_work((7, 7), 64, 128, weight_splits(128, 64))
    assert set(work) == {"bwd_sample_kernel", "bwd_weight_kernel",
                         "bwd_reduce_kernel"}
    conv = 2 * 49 * 9 * 64 * 64 * 128
    assert work["bwd_weight_kernel"] == (
        2 * conv, 4 * 4 * 128 * 49 * 64 + 4 * 2 * 9 * 64 * 64)
    assert work["bwd_sample_kernel"][0] == 4 * conv
    assert abs(work["bwd_weight_kernel"][0] - 0.925e9) < 1e6
    ops, nbytes = work["bwd_reduce_kernel"]
    assert ops < 1e-2 * conv and nbytes > 4 * 22 * 2 * 9 * 64 * 64

    kb = bwd_kernel_bounds((7, 7), 64, 128, weight_splits(128, 64))
    assert set(kb) == set(work)
    weight = kb["bwd_weight_kernel"]
    assert weight["bound_by"] == "bytes"
    assert abs(weight["bound_ms"] - 6717440 / 3.35e9) < 1e-9
    assert weight == bwd_kernel_bounds((7, 7), 64, 128, 1)["bwd_weight_kernel"]
    assert (kb["bwd_reduce_kernel"]["bound_ms"]
            > bwd_kernel_bounds((7, 7), 64, 128, 1)["bwd_reduce_kernel"]
            ["bound_ms"])
