"""The probe's ``tap9_bf16`` (nine per-tap bf16 ``wgmma`` products over the
rows of every sample, ``csrc/conv_probe.cu`` ``tap9_wgmma_kernel``) on the
CPU: the port's CPU path against the TPU kernels themselves (the JAX
probe's ``seq9_bf16``, ``tree9_bf16``, ``fori9_bf16`` and ``roll9_bf16``
kernels run by ``pl.pallas_call`` in interpret mode), a plain emulation of
the kernel's stages and order of sums against the float64 conv, and the
gate and constants against the C++ ones read from ``csrc/conv_probe.cu``.
The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from neural_ode_features_tpu_torch.kernels.conv3x3 import (
    ROWS_STRATEGIES,
    conv3x3,
    conv3x3_plain,
    conv3x3_wgmma_emulated,
    im2col_wgmma_emulated,
    supported,
    tap9_wgmma_emulated,
)
from neural_ode_features_tpu_torch.kernels.odefunc import bf16_round
from neural_ode_features_tpu_torch.probes import conv_probe

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "neural_ode_features_tpu_torch" / "csrc"
# The conv against its plain bf16 version: f32 reassociation of sums of
# 576 exact products (chip_smoke.py CONV_TOL).
CONV_TOL = dict(rtol=1e-4, atol=1e-5)
# The TPU kernels against the port's CPU path: both sum exact products of
# the same bf16 operands in f32 (tests/test_torch_im2col_wgmma.py).
JAX_ATOL = 1e-6
WGMMA_BAR = conv_probe.WGMMA_BAR


def _draw(batch, hw, c, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, *hw, c)).astype(np.float32) * 0.1
    w = rng.normal(size=(3, 3, c, c)).astype(np.float32) * 0.05
    return torch.from_numpy(x), torch.from_numpy(w)


def _f64(x, w):
    """The float64 conv of the bf16-rounded operands: their products are
    exact, so what is left is each order of sums."""
    return conv3x3_plain(bf16_round(x).double(), bf16_round(w).double())


# ---- the TPU kernels, interpreted, against the port's CPU path ------------


def _jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_conv_probe_for_tap9_tests", ROOT / "probes" / "conv_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_tpu_kernel(kind, tb, x, w):
    """One of the JAX probe's bf16 per-tap kernels over x (B, 7, 7, 64) in
    grid steps of ``tb`` samples, as ``pallas_conv``/``pallas_conv_2d``
    launch them, in interpret mode; the arrays explicit float32 (the test
    suite runs JAX with x64 on)."""
    mod = _jax_probe()
    b, hh, ww, c = x.shape
    assert (hh, ww, c) == (mod.H, mod.W, mod.C)
    vmem = dict(memory_space=pltpu.VMEM)
    xj = jnp.asarray(x.numpy(), dtype=jnp.float32)
    if kind == "roll9_bf16":
        kern, scratch = mod.make_roll_kernel(kind, tb)
        m = tb * hh * ww
        out = pl.pallas_call(
            kern,
            out_shape=jax.ShapeDtypeStruct((b * hh * ww, c), jnp.float32),
            grid=(b // tb,),
            in_specs=[pl.BlockSpec((m, c), lambda g: (g, 0), **vmem),
                      pl.BlockSpec(**vmem)],
            out_specs=pl.BlockSpec((m, c), lambda g: (g, 0), **vmem),
            scratch_shapes=scratch, interpret=True,
        )(xj.reshape(-1, c),
          jnp.asarray(w.numpy().reshape(9 * c, c), dtype=jnp.float32))
        return np.asarray(out).reshape(b, hh, ww, c)
    spec = pl.BlockSpec((tb, hh, ww, c), lambda g: (g, 0, 0, 0), **vmem)
    out = pl.pallas_call(
        mod.make_kernel(kind, tb),
        out_shape=jax.ShapeDtypeStruct((b, hh, ww, c), jnp.float32),
        grid=(b // tb,), in_specs=[spec, pl.BlockSpec(**vmem)],
        out_specs=spec, interpret=True,
    )(xj, jnp.asarray(w.numpy(), dtype=jnp.float32))
    return np.asarray(out)


@pytest.mark.parametrize("tb", [1, 2])
@pytest.mark.parametrize("kind", ["seq9_bf16", "tree9_bf16", "fori9_bf16",
                                  "roll9_bf16"])
def test_tpu_kernels_match_the_port(kind, tb):
    """``probes/conv_probe.py``'s bf16 per-tap kernels (nine (tb·H·W, C) @
    (C, C) bf16 dots per grid step, f32 accumulation, summed in order, as a
    tree or in a loop) against ``conv3x3(x, w, "tap9_bf16")`` on the CPU,
    the port's plain version: the same rounded operands, exact products
    summed in f32; the f32 conv lies far outside that.  ``fori9_bf16``
    casts only the weights (its ``dynamic_slice`` patch stays f32, which
    the TPU's MXU rounds to bf16 at the default precision, and interpret
    mode on the CPU does not), so it is handed x rounded to bf16, the port
    the same x unrounded."""
    x, w = _draw(4, (7, 7), 64)
    got = conv3x3(x, w, "tap9_bf16")
    want = _run_tpu_kernel(kind, tb, bf16_round(x) if kind == "fori9_bf16"
                           else x, w)
    assert want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=JAX_ATOL)
    assert float(np.abs(conv3x3_plain(x, w).numpy() - want).max()) > 1e-4


# ---- the kernel's stages and order of sums, emulated ----------------------


@pytest.mark.parametrize("c", [32, 64])
@pytest.mark.parametrize("hw", [(6, 6), (7, 7), (8, 8)])
def test_emulated_order_within_the_bar(hw, c):
    """The kernel's arithmetic (:func:`tap9_wgmma_emulated`: each tap's 64
    channels a stage, zero past C, summed in the shipped order) against the
    f64 conv of the same rounded operands: within ``WGMMA_BAR`` of
    ``mma_bf16``'s order (``conv3x3_wgmma_emulated(precision='bf16')``, its
    bits; at C = 32, where ``mma_bf16`` does not run, the plain bf16 conv's
    tap order), within f32 reassociation of the plain bf16 conv, and
    outside it of the f32 conv.  The tile height and the batch change no
    row's sums."""
    x, w = _draw(4, hw, c, seed=5)
    exact = _f64(x, w)

    def err(a):
        return float((a.double() - exact).abs().max())

    got = tap9_wgmma_emulated(x, w)
    assert got.shape == x.shape and got.dtype == torch.float32
    beside = (conv3x3_wgmma_emulated(x, w, precision="bf16")
              if c == 64 and hw != (8, 8) else conv3x3_plain(x, w, "bf16"))
    assert err(got) <= WGMMA_BAR * err(beside)
    np.testing.assert_allclose(got.numpy(), conv3x3_plain(
        x, w, passes="bf16").numpy(), **CONV_TOL)
    assert not torch.allclose(got, conv3x3_plain(x, w), **CONV_TOL)
    assert torch.equal(got[1:3], tap9_wgmma_emulated(x[1:3], w))


@pytest.mark.parametrize("c", [32, 64, 128])
def test_emulated_stages_against_im2col(c):
    """Both strategies sum a stage alike (per k half a chain from zero);
    where C is a multiple of 64 a stage of each covers the same 64 k (one
    tap's block), so the two give the same bits; at C = 32 a ``tap9_bf16``
    stage is one tap padded with zeros, ``im2col_bf16``'s spans two taps,
    and the bits differ."""
    x, w = _draw(3, (5, 5), c, seed=7)
    got = tap9_wgmma_emulated(x, w)
    assert torch.equal(got, im2col_wgmma_emulated(x, w)) == (c % 64 == 0)
    with pytest.raises(ValueError, match="float32"):
        tap9_wgmma_emulated(x.double(), w.double())


# ---- the gate and the constants --------------------------------------------


def test_gate_takes_every_old_shape_and_more():
    """Every shape the old ``tap9_bf16`` took (the FFMA stage's gate,
    ``tap9``'s) at maps up to 32×32, 7×7×32, 7×7×64, 6×6×64 and 8×8×64
    among them, and the wider gate of ``im2col_bf16`` (one template):
    C a multiple of 4 up to 128 on any map whose window fits."""
    old = [(hh, ww, c) for hh in range(1, 33) for ww in range(1, 33)
           for c in range(4, 129, 4) if supported((hh, ww), c, "tap9")]
    assert len(old) > 2000
    for hh, ww, c in old:
        assert supported((hh, ww), c, "tap9_bf16")
    for hw, c in (((7, 7), 32), ((7, 7), 64), ((6, 6), 64), ((8, 8), 64),
                  ((4, 4), 128), ((7, 7), 128), ((7, 7), 96), ((9, 8), 64),
                  ((7, 7), 36)):
        assert supported(hw, c, "tap9_bf16")
    for hh in range(1, 40):
        for ww in range(1, 40):
            for c in (4, 36, 64, 100, 128, 132, 256):
                assert (supported((hh, ww), c, "tap9_bf16")
                        == supported((hh, ww), c, "im2col_bf16"))
    # Past C = 128 the rows kernel (C % 8 == 0, to 512) takes the width.
    assert supported((7, 7), 256, "tap9_bf16")
    assert not supported((7, 7), 260, "tap9_bf16")
    assert not supported((7, 7), 520, "tap9_bf16")
    assert set(ROWS_STRATEGIES) == {"im2col_bf16", "tap9_bf16"}


def test_the_entries_are_mirrored():
    """The two kernels are one template with the stage kind as its
    argument; the C entry takes ``im2col_bf16``'s gate and tile argument,
    and the old FFMA kernel stays behind its own entry."""
    flat = " ".join((CSRC / "conv_probe.cu").read_text().split())
    assert ('extern "C" int conv_probe_tap9_bf16(const float* x, const float* '
            'w, float* y, int B, int H, int W, int C, void* stream, int '
            'tile_rows) { return launch_rows_strategy<true>(') in flat
    assert ('extern "C" int conv_probe_tap9_ffma_bf16(const float* x, const '
            'float* w, float* y, int B, int H, int W, int C, void* stream) { '
            'return launch_tap9<true>(') in flat
    assert "rows_wgmma_conv<true, MW, NB>(x, w, rows, H, W, C, y)" in flat
    assert "rows_wgmma_conv<false, MW, NB>(x, w, rows, H, W, C, y)" in flat


def test_cpu_path_tiles_and_refusals():
    """On the CPU ``tap9_bf16`` is the plain bf16 conv with no launch;
    ``tile_rows`` takes 64 or 128 as for ``im2col_bf16``, and the strategy
    keeps the probe's kernel-name map and bar."""
    x, w = _draw(2, (7, 7), 64)
    before = conv3x3.launches
    want = conv3x3_plain(x, w, passes="bf16")
    for rows in (None, 64, 128):
        assert torch.equal(conv3x3(x, w, "tap9_bf16", tile_rows=rows), want)
    assert conv3x3.launches == before
    with pytest.raises(ValueError, match="tile_rows"):
        conv3x3(x, w, "tap9_bf16", tile_rows=96)
    assert conv_probe.KERNEL_NAMES["tap9_bf16"] == "tap9_wgmma_kernel<"
    assert conv_probe.BARRED["tap9_bf16"] == "mma_bf16"
