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
    STRATEGIES,
    conv3x3,
    conv3x3_plain,
    conv_bytes,
    conv_flops,
    smem_bytes,
    supported,
)
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
    x, w = conv_probe.probe_inputs(2, "cpu")
    for strategy in ("tap9_bf16", "im2col_bf16"):
        with pytest.raises(NotImplementedError, match="Queue 2 item 5"):
            conv3x3(x, w, strategy)
    with pytest.raises(ValueError, match="unknown strategy"):
        conv3x3(x, w, "rollS")
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
    assert set(out) == {"bound_us", "bound_by", "library_us", "tap9", "im2col"}
    assert out["tap9"]["err_plain"] == 0.0 and out["im2col"]["us"] > 0
    text = capsys.readouterr().out
    assert "bound:" in text and "tap9:" in text and "F.conv2d" in text
    out = conv_probe.main(["--cpu", "--batch", "1", "im2col"])
    assert "tap9" not in out and "im2col" in out
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        conv_probe.main(["--cpu", "--batch", "1", "tap9_bf16"])
