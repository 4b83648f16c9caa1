"""The port's FLOP accounting (``utils/flops.py``) equals the JAX
package's key for key and exactly, each package reading its own
``ModelConfig``; the card's peaks."""

import itertools

import pytest

from neural_ode_features_tpu.models import ModelConfig as JaxConfig
from neural_ode_features_tpu.utils.flops import (
    odenet_flops_per_image as jax_flops,
)
from neural_ode_features_tpu.utils.flops import (
    odenet_train_flops_per_image as jax_train_flops,
)
from neural_ode_features_tpu_torch.models import ModelConfig
from neural_ode_features_tpu_torch.utils import (
    odenet_flops_per_image,
    odenet_train_flops_per_image,
    peak_flops_per_chip,
)
from neural_ode_features_tpu_torch.utils.flops import (
    H100_BF16_FLOPS,
    H100_F32_FLOPS,
    H100_HBM_BYTES_PER_S,
    H100_TF32_FLOPS,
)

HIDDEN = (32, 64, 128, 512)
DOWNSAMPLING = ("conv", "res")
SIDES = (28, 32)


def _configs(hidden, downsampling, side):
    kw = dict(in_channels=1 if side == 28 else 3, hidden=hidden,
              downsampling=downsampling)
    return ModelConfig(**kw), JaxConfig(**kw)


@pytest.mark.parametrize(
    "hidden,downsampling,side,nfe",
    list(itertools.product(HIDDEN, DOWNSAMPLING, SIDES, (0.0, 14, 32.375))))
def test_forward_flops_equal_jax(hidden, downsampling, side, nfe):
    cfg, jcfg = _configs(hidden, downsampling, side)
    got = odenet_flops_per_image(cfg, side, nfe)
    want = jax_flops(jcfg, side, nfe)
    assert list(got) == list(want)
    assert got == want  # exactly: the same arithmetic in the same order
    assert got["total"] > 0 and got["feature_side"] == (6 if side == 28
                                                        else 7)


@pytest.mark.parametrize(
    "hidden,downsampling,side,nfe",
    list(itertools.product(HIDDEN, DOWNSAMPLING, SIDES,
                           ((26, 38), (32.5, 61.25)))))
def test_train_flops_equal_jax(hidden, downsampling, side, nfe):
    cfg, jcfg = _configs(hidden, downsampling, side)
    got = odenet_train_flops_per_image(cfg, side, *nfe)
    want = jax_train_flops(jcfg, side, *nfe)
    assert list(got) == list(want)
    assert got == want
    fwd = odenet_flops_per_image(cfg, side, nfe[0])
    assert got["forward_dyn"] == nfe[0] * fwd["odefunc_per_eval"]


def test_entry_model_flops_per_image():
    """The entry model (CIFAR-10, hidden 64) at its measured NFE of 32:
    276.86 MFLOP an image (stem 39.60 M, 7.41 M per evaluation)."""
    got = odenet_flops_per_image(ModelConfig(in_channels=3), 32, 32)
    assert round(got["stem"] / 1e6, 2) == 39.60
    assert round(got["odefunc_per_eval"] / 1e6, 2) == 7.41
    assert round(got["total"] / 1e6, 2) == 276.86


@pytest.mark.parametrize("kind,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12),
    ("NVIDIA H100", 989e12),
    ("cpu", None),
    ("NVIDIA H100 PCIe", None),
    ("NVIDIA H100 NVL", None),
    ("NVIDIA A100-SXM4-80GB", None),
])
def test_peak_flops_per_chip(kind, peak):
    assert peak_flops_per_chip(kind) == peak


def test_h100_constants():
    assert (H100_BF16_FLOPS, H100_TF32_FLOPS, H100_F32_FLOPS,
            H100_HBM_BYTES_PER_S) == (989e12, 495e12, 67e12, 3.35e12)


def test_rows_sample_bounds_at_7x7x512():
    """The rows builds' per-sample GroupNorm launches at 7×7×512: at B = 128
    the backward's five move the state-sized tensors of the table (MB: the
    recompute's GroupNorms 32.1 each, gv 57.8, gu 45.0, dh 38.5; 205.5 in
    all, 0.061 ms at 3.35 TB/s) and their partial rows, statistics and t
    sums, 213.7 MB, 0.0638 ms, bound by bytes; at B = 256 the forward's
    three 128.5 MB, 0.0383 ms."""
    from neural_ode_features_tpu_torch.utils.flops import (
        rows_sample_bounds,
        rows_sample_bytes,
    )

    n = 128 * 49 * 512
    state = {"gn_relu_h": 8 * n + 2 * n, "gn_relu_u": 8 * n + 2 * n,
             "gv": 16 * n + 2 * n, "gu": 12 * n + 2 * n, "dh": 12 * n}
    assert [round(v / 1e6, 1) for v in state.values()] == [
        32.1, 32.1, 57.8, 45.0, 38.5]
    assert round(sum(state.values()) / 1e6, 1) == 205.5
    got = rows_sample_bytes((7, 7), 512, 128)["bwd"]
    assert list(got) == list(state)
    for k, v in got.items():  # plus the small outputs and inputs
        assert state[k] <= v <= state[k] + 5e6, k
    bwd = rows_sample_bounds((7, 7), 512, 128)["bwd"]
    assert round(bwd["bytes"] / 1e6, 1) == 213.7
    assert bwd["bound_by"] == "bytes"
    assert round(bwd["bound_ms"], 4) == 0.0638
    assert bwd["bound_ms"] == 1e3 * (bwd["bytes"] / H100_HBM_BYTES_PER_S)
    fwd = rows_sample_bounds((7, 7), 512, 256)["fwd"]
    assert round(fwd["bytes"] / 1e6, 1) == 128.5
    assert round(fwd["bound_ms"], 4) == 0.0383
