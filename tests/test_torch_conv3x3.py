"""The 3×3 conv probe on the CPU: the plain version of the conv kernels
against ``jax.lax.conv_general_dilated`` (the JAX probe's reference) and the
library conv, the wrapper's gates, and the probe entry point's control flow.
The kernels themselves run only on the card (``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from neural_ode_features_tpu_torch.kernels import conv3x3 as conv_mod
from neural_ode_features_tpu_torch.kernels.conv3x3 import (
    BF16_STRATEGIES,
    STRATEGIES,
    conv3x3,
    conv3x3_padded_pitch,
    conv3x3_plain,
    conv_bytes,
    conv_flops,
    smem_bytes,
    supported,
    tf32_split,
)
from neural_ode_features_tpu_torch.kernels.odefunc import WGMMA_C
from neural_ode_features_tpu_torch.ops.layers import conv2d
from neural_ode_features_tpu_torch.probes import conv_probe


def _jax_conv(x, w):
    return np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32))


@pytest.mark.parametrize("batch,side,c", [(5, 7, 64), (3, 6, 64), (2, 5, 8),
                                          (1, 1, 4)])
def test_plain_matches_jax_conv(batch, side, c):
    x, w = conv_probe.probe_inputs(batch, "cpu", (side, side), c)
    got = conv3x3_plain(x, w)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax_conv(x.numpy(), w.numpy()),
                               rtol=1e-5, atol=1e-6)
    # ... and the port's own library conv (ops/layers.py, no bias).
    np.testing.assert_allclose(got.numpy(),
                               conv2d({"kernel": w}, x, padding=1).numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(),
                               conv_probe.library_conv(x, w).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_probe_inputs_are_the_jax_probe_draws():
    x, w = conv_probe.probe_inputs(256, "cpu")
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        x.numpy(), rng.normal(size=(256, 7, 7, 64)).astype(np.float32) * 0.1)
    np.testing.assert_array_equal(
        w.numpy(), rng.normal(size=(3, 3, 64, 64)).astype(np.float32) * 0.05)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_wrapper_on_cpu_runs_the_plain_version(strategy):
    x, w = conv_probe.probe_inputs(3, "cpu")
    before = conv3x3.launches
    assert torch.equal(conv3x3(x, w, strategy), conv3x3_plain(x, w))
    assert conv3x3.launches == before  # no kernel was launched
    # float64 goes through the plain version too (the checks' reference).
    got = conv3x3(x.double(), w.double(), strategy)
    np.testing.assert_allclose(got.numpy(), conv3x3_plain(x, w).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_wrapper_refusals():
    """What the wrapper refuses; the bf16 twins, refused before their
    kernels existed, run their own plain version on the CPU (no launch)."""
    x, w = conv_probe.probe_inputs(2, "cpu")
    before = conv3x3.launches
    for strategy in BF16_STRATEGIES:
        assert torch.equal(conv3x3(x, w, strategy),
                           conv3x3_plain(x, w, passes="bf16"))
    assert conv3x3.launches == before
    for strategy in ("rollS", "mma3_bf16", "roll9_bf16"):
        with pytest.raises(ValueError, match="unknown strategy"):
            conv3x3(x, w, strategy)
    with pytest.raises(ValueError, match=r"w \(3, 3, C, C\)"):
        conv3x3(x, w[:, :, :32], "tap9")
    with pytest.raises(ValueError, match="x \\(B, H, W, C\\)"):
        conv3x3(x[0], w, "tap9")


def test_shape_gates():
    for hw in ((7, 7), (6, 6)):
        assert supported(hw, 64, "tap9") and supported(hw, 64, "im2col")
    assert not supported((28, 28), 64, "tap9")
    assert not supported((7, 7), 6, "tap9")  # C must divide the 512 threads
    # im2col: at most 4 pixels on each of its 256 / (C/4) pixel groups (the
    # same 4096 / C pixels as tap9) ...
    assert supported((8, 8), 64, "im2col")
    assert not supported((9, 8), 64, "im2col")
    # ... and the patch matrix within the 227 KB of shared memory.
    assert supported((5, 5), 128, "tap9")
    assert not supported((5, 5), 128, "im2col")
    assert smem_bytes((7, 7), 64) == 4 * (49 * 580 + 2 * 64 * 64) == 146448
    assert smem_bytes((7, 7), 64) <= conv_mod.MAX_SMEM


def test_bound_inputs():
    """The numbers PERF.md's bound for the probe is computed from."""
    assert conv_flops(256, (7, 7), 64) == 924_844_032
    assert conv_bytes(256, (7, 7), 64) == 4 * (2 * 256 * 3136 + 36864)
    us, by = conv_probe.bound_us(256)
    assert by == "operations" and us == pytest.approx(13.80, abs=0.01)


def test_probe_entry_point_on_cpu(capsys):
    out = conv_probe.main(["--cpu", "--batch", "2"])
    assert set(out) == {"bound_us", "bound_by", "tensor_bound_us",
                        "tensor_bound_by", "library_us", "library_bf16_us",
                        "library_device_us", "library_bf16_device_us",
                        "batches", *STRATEGIES, *BF16_STRATEGIES}
    assert out["tap9"]["err_plain"] == 0.0 and out["im2col"]["us"] > 0
    # On the CPU there is no device time, and none is reported.
    assert out["mma3"]["device_us"] is None
    assert out["library_device_us"] is out["library_bf16_device_us"] is None
    # A bf16 twin is also read against the f64 conv of its rounded operands.
    assert out["im2col_bf16"]["err_f64_bf16"] < 1e-6 < out["im2col_bf16"][
        "err_f64"]
    text = capsys.readouterr().out
    assert "bound:" in text and "tap9:" in text and "F.conv2d" in text
    assert "mma3:" in text and "dev " not in text
    # Two batch sizes race in turns; the first is the top-level result.
    out = conv_probe.main(["--cpu", "--batch", "2,1", "mma3", "tap9"])
    assert list(out["batches"]) == [2, 1]
    assert out["mma3"] == out["batches"][2]["mma3"]
    assert "im2col" not in out["batches"][1]
    out = conv_probe.main(["--cpu", "--batch", "1", "im2col"])
    assert "tap9" not in out and "im2col" in out
    # A bf16 twin alone, held to its own plain version.
    out = conv_probe.main(["--cpu", "--batch", "1", "tap9_bf16"])
    assert set(out) & {*STRATEGIES, *BF16_STRATEGIES} == {"tap9_bf16"}
    assert out["tap9_bf16"]["err_plain"] == 0.0


# ---- the tensor-core stage's arithmetic and row mapping, emulated ----------


def _bits(x):
    return x.contiguous().view(torch.int32)


def test_tf32_split():
    rng = np.random.default_rng(11)
    x = torch.from_numpy(np.concatenate([
        rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, 4096),
        [0.0, -0.0, 1.0, -1.0, 1.0e-30, 1.0e30]]).astype(np.float32))
    hi, lo = tf32_split(x)
    # Head and tail are TF32 values: 13 zero low mantissa bits.
    assert int((_bits(hi) & 0x1FFF).abs().max()) == 0
    assert int((_bits(lo) & 0x1FFF).abs().max()) == 0
    # hi is x to 2^-11 (round to nearest of 10 mantissa bits), hi + lo is x
    # to 2^-21: the tail's own 11 bits, cut off as the tensor core cuts them.
    xd, mag = x.double(), x.double().abs()
    assert bool(((hi.double() - xd).abs() <= 2.0 ** -11 * mag).all())
    assert bool(((hi.double() + lo.double() - xd).abs() <= 2.0 ** -21 * mag).all())
    # Ties round away from zero: 1 + 2^-11 lies halfway between the TF32
    # neighbours 1 and 1 + 2^-10, and so does its negative.
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                        1.0 + 2.0 ** -11 - 2.0 ** -23])
    hi_t, lo_t = tf32_split(tie)
    np.testing.assert_array_equal(
        hi_t.numpy(), np.float32([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]))
    np.testing.assert_array_equal((hi_t + lo_t)[:2].numpy(), tie[:2].numpy())
    with pytest.raises(ValueError, match="float32"):
        tf32_split(x.double())


# Inputs of the size the ODEfunc's convs see (unit-variance activations,
# weights of a few percent), from a numpy seed.
def _conv_inputs(batch, hw, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(batch, *hw, 64)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(3, 3, 64, 64)) * 0.05)
                         .astype(np.float32))
    return x, w


@pytest.mark.parametrize("batch,hw", [(4, (7, 7)), (4, (6, 6)), (5, (7, 7))])
def test_emulated_passes_against_f64(batch, hw):
    """Three compensated TF32 products are f32-grade: within 5e-6 of the f64
    conv on outputs of size about 1 (an f32 sum of 576 products is itself
    about 1e-6 off).  One product is plain TF32: further than 1e-5 off, and
    within 5e-3 (2^-11 per operand over sums of 576 products)."""
    x, w = _conv_inputs(batch, hw, 20 + batch + hw[0])
    exact = conv3x3_plain(x.double(), w.double())
    err3 = float((conv3x3_plain(x, w, passes=3).double() - exact).abs().max())
    err1 = float((conv3x3_plain(x, w, passes=1).double() - exact).abs().max())
    err32 = float((conv3x3_plain(x, w).double() - exact).abs().max())
    assert err3 < 5e-6 and err32 < 5e-6
    assert 1e-5 < err1 < 5e-3
    with pytest.raises(ValueError, match="passes"):
        conv3x3_plain(x, w, passes=2)


@pytest.mark.parametrize("hw", [(7, 7), (6, 6), (5, 9), (1, 62), (9, 5)])
@pytest.mark.parametrize("passes", [None, 3])
def test_padded_pitch_rows_are_the_conv(hw, passes):
    """The tensor-core stage's row mapping: shifted contiguous rows of the
    flattened zero-bordered map, border columns dropped.  The same products
    in the same tap order as ``conv3x3_plain``, so the same bits."""
    x, w = _conv_inputs(3, hw, 31)
    got = conv3x3_padded_pitch(x, w, passes)
    assert got.shape == x.shape
    assert torch.equal(got, conv3x3_plain(x, w, passes))


def test_padded_pitch_tile_limit():
    x, w = _conv_inputs(1, (8, 8), 32)  # 8 * 10 = 80 positions > 64
    with pytest.raises(ValueError, match="64-row tile"):
        conv3x3_padded_pitch(x, w)


def test_tensor_core_stage_gates():
    # mma3 and mma1: C a multiple of 32 from 64 to 512 and H * (W + 2) <= 64.
    for strategy in ("mma3", "mma1"):
        assert supported((7, 7), 64, strategy)      # 63 positions
        assert supported((6, 6), 64, strategy)      # 48
        assert supported((1, 62), 64, strategy)     # 64
        assert not supported((8, 8), 64, strategy)  # 80
        assert not supported((7, 8), 64, strategy)  # 70
        assert not supported((7, 7), 32, strategy)
        for c in (96, 128, 256, 512):
            assert supported((7, 7), c, strategy)
            assert supported((6, 6), c, strategy)
        assert not supported((7, 7), 544, strategy)
        assert not supported((7, 7), 80, strategy)
    # wgmma3: where the f32 fused kernels run it (kernels.odefunc.stage).
    assert supported((7, 7), 64, "wgmma3") and supported((6, 6), 64, "wgmma3")
    assert supported((1, 62), 64, "wgmma3")
    for hw, c in (((8, 8), 64), ((7, 8), 64), ((7, 7), 32), ((7, 7), 544),
                  ((7, 7), 80)):
        assert not supported(hw, c, "wgmma3")
    for c in range(64, 513, 32):
        assert supported((7, 7), c, "wgmma3") == (c in WGMMA_C)
    # ... while the FFMA kernels still take those shapes.
    assert supported((8, 8), 64, "tap9") and supported((7, 7), 32, "tap9")
    assert set(STRATEGIES) == {"tap9", "im2col", "mma3", "mma1", "wgmma3"}
