"""The ``wgmma3`` conv stage on the CPU: its arithmetic, emulated step by
step (``conv3x3_wgmma_emulated``), against the float64 conv and the JAX
package's ConcatConv on the same numpy-seeded inputs; the layout of its
split weight tiles (``wgmma_k_order``, ``wgmma_tile_offset``,
``wgmma_pack``); and the Python gate (``stage``, ``layout``, ``refusal``)
against the C++ one, read from ``csrc/odefunc_common.cuh``.  The kernel
itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.ops import layers as jl
from neural_ode_features_tpu_torch.kernels import odefunc as odefunc_mod
from neural_ode_features_tpu_torch.kernels.conv3x3 import (
    conv3x3,
    conv3x3_plain,
    conv3x3_wgmma_emulated,
    supported,
    tf32_split,
    wgmma_k_order,
    wgmma_pack,
    wgmma_tile_offset,
)
from neural_ode_features_tpu_torch.kernels.odefunc import (
    MAX_SMEM,
    WG_FLOATS,
    WGMMA_C,
    layout,
    refusal,
    stage,
)
from neural_ode_features_tpu_torch.kernels.odefunc_bwd import (
    bwd_refusal,
    u_global,
)
from neural_ode_features_tpu_torch.ops.layers import time_map
from neural_ode_features_tpu_torch.probes import conv_probe

torch.set_num_threads(2)

HEADER = (Path(__file__).resolve().parent.parent
          / "neural_ode_features_tpu_torch" / "csrc" / "odefunc_common.cuh")
# The emulation against the f64 conv: f32-grade, as the probe's bar for the
# kernels (chip_smoke.py CONV_TOL: sums of 576 products, relative 1e-4,
# absolute 1e-5 at these scales); it reads 6e-8 to 8e-8.
CONV_TOL = dict(rtol=1e-4, atol=1e-5)
# Its distance to the f64 conv, at most this multiple of the 3xTF32 plain
# emulation's (conv3x3_plain(passes=3)) on the same inputs: the probe's
# bar between wgmma3 and mma3 on the card.
WGMMA_BAR = conv_probe.WGMMA_BAR


def _draw(batch, hw, c, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, *hw, c)).astype(np.float32) * 0.1
    w = rng.normal(size=(3, 3, c, c)).astype(np.float32) * 0.05
    return torch.from_numpy(x), torch.from_numpy(w)


# ---- where the split weight tiles lie ------------------------------------


def test_k_order_is_the_fragment_permutation():
    """Lane t's one 8-byte load of channels 2t, 2t+1 is the instruction's
    k = t and k = t + 4; the order is a permutation and inverts."""
    order = wgmma_k_order()
    assert order == [0, 2, 4, 6, 1, 3, 5, 7]
    assert sorted(order) == list(range(8))
    inverse = [order.index(p) for p in range(8)]
    for t in range(4):
        assert inverse[2 * t] == t and inverse[2 * t + 1] == t + 4
    assert [order[i] for i in inverse] == list(range(8))


def test_tile_offsets_are_the_descriptor_walk():
    """Every (n, k) of a (64, 64) tile has its own 4-byte slot in 16 KB,
    and the slot is where the descriptor of the warpgroup (n half nh, k
    half kh) at k8 step ks reads its logical element: start 2048·(4·nh) +
    128·(8·kh + 2·ks), then core matrix (n // 8 within the half, k half of
    the step) at SBO 2048 and LBO 128, row n % 8 of 16 bytes, column k % 4."""
    seen = set()
    order = wgmma_k_order()
    for n in range(64):
        for k in range(64):
            off = wgmma_tile_offset(n, k)
            assert off % 4 == 0 and 0 <= off < 16384
            seen.add(off)
    assert len(seen) == 64 * 64
    for nh in range(2):
        for kh in range(2):
            for ks in range(4):
                start = 2048 * 4 * nh + 128 * (8 * kh + 2 * ks)
                for nl in range(32):
                    for lk in range(8):
                        n = 32 * nh + nl
                        k = 32 * kh + 8 * ks + order[lk]
                        walk = (start + 2048 * (nl // 8) + 128 * (lk // 4)
                                + 16 * (nl % 8) + 4 * (lk % 4))
                        assert wgmma_tile_offset(n, k) == walk


@pytest.mark.parametrize("scale", [0.05, 3.0])
def test_pack_splits_exactly_and_inverts(scale):
    """The head is the tile rounded to TF32 (its low 13 mantissa bits zero),
    head + tail is the tile exactly, and reading each slot back by
    ``wgmma_tile_offset`` gives the tile again."""
    rng = np.random.default_rng(7)
    tile = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32)
                            * scale)
    head, tail = wgmma_pack(tile)
    slots = torch.tensor([[wgmma_tile_offset(n, k) // 4 for n in range(64)]
                          for k in range(64)])
    hi, lo = head[slots], tail[slots]
    assert torch.equal(hi + lo, tile)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    want_hi, want_lo = tf32_split(tile)
    assert torch.equal(hi, want_hi)
    # the tensor cores read the tail's TF32 part
    assert torch.equal(lo.view(torch.int32) & -0x2000,
                       want_lo.view(torch.int32))


# ---- the arithmetic --------------------------------------------------------


@pytest.mark.parametrize("batch,hw", [(3, (7, 7)), (3, (6, 6)), (2, (5, 5)),
                                      (1, (1, 62))])
def test_emulation_matches_the_f64_conv(batch, hw):
    """Three products per k8 step in the instruction's k order, each tap's
    chain from zero per k half, the halves added last: f32-grade against
    the f64 conv, and within the probe's bar of the mma.sync 3xTF32
    emulation, on every map the stage takes (H·(W+2) ≤ 64; 1×62 fills the
    64 rows)."""
    x, w = _draw(batch, hw, 64)
    got = conv3x3_wgmma_emulated(x, w)
    exact = conv3x3_plain(x.double(), w.double())
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.double().numpy(), exact.numpy(),
                               **CONV_TOL)
    err = float((got.double() - exact).abs().max())
    err_mma = float((conv3x3_plain(x, w, passes=3).double() - exact)
                    .abs().max())
    assert err <= WGMMA_BAR * err_mma
    assert err < 2e-7


@pytest.mark.parametrize("hw", [(7, 7), (6, 6)])
def test_emulation_against_the_jax_concat_conv(hw):
    """The split ConcatConv with the stage's conv, conv(x, W[:, :, 1:]) + b
    + t·M, against the JAX package's ``concat_conv2d`` on the same weights,
    per-sample t and inputs (f32 reassociation: relative 1e-4, absolute
    2e-5, the port's layer test's bar)."""
    rng = np.random.default_rng(4)
    b, c = 3, 64
    x = rng.normal(size=(b, *hw, c)).astype(np.float32)
    t = rng.uniform(0, 1, b).astype(np.float32)
    p = jl.init_conv(jax.random.PRNGKey(5), 3, 3, c + 1, c)
    p = {k: np.array(v) for k, v in p.items()}
    want = np.asarray(jl.concat_conv2d(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(t),
        jnp.asarray(x)))
    kernel = torch.from_numpy(p["kernel"])
    conv = conv3x3_wgmma_emulated(torch.from_numpy(x),
                                  kernel[:, :, 1:, :].contiguous())
    got = (conv + torch.from_numpy(p["bias"])) + torch.from_numpy(t).reshape(
        -1, 1, 1, 1) * time_map(kernel, *hw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-5)


def test_emulation_takes_only_the_stage_shapes():
    for hw, c in (((7, 7), 96), ((8, 8), 64), ((7, 7), 32)):
        x, w = _draw(1, hw, c)
        with pytest.raises(ValueError, match="C = 64"):
            conv3x3_wgmma_emulated(x, w)


def test_the_cpu_wrapper_runs_the_plain_version():
    x, w = _draw(2, (7, 7), 64)
    assert torch.equal(conv3x3(x, w, "wgmma3"), conv3x3_plain(x, w))


# ---- the gate: Python against the C++ --------------------------------------


def _cpp_function(name):
    """The return expression of ``inline bool <name>(int H, int W, int C)``
    in the header."""
    src = HEADER.read_text()
    m = re.search(rf"inline bool {name}\(int H, int W, int C\) \{{\s*"
                  r"return (.*?);\s*\}", src, re.S)
    assert m, f"{name} not found in {HEADER.name}"
    return " ".join(m.group(1).split())


def _cpp_constant(name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", HEADER.read_text())
    assert m, f"{name} not found in {HEADER.name}"
    return m.group(1).strip()


def _evaluate(expr, env):
    py = expr.replace("&&", " and ").replace("||", " or ")
    assert re.fullmatch(r"[\w\s()+*/%<>=,.!-]+", py.replace(" and ", " ")
                        .replace(" or ", " ")), py
    return eval(py, {"__builtins__": {}}, env)  # noqa: S307


def _cpp_wgmma_ok(hh, ww, c):
    consts = {"kMmaC": 64, "kMaxC": 512, "kMmaStep": 32, "kMmaM": 64}
    env = dict(consts, H=hh, W=ww, C=c)
    env["mma_ok"] = lambda H, W, C: bool(_evaluate(  # noqa: N803
        _cpp_function("mma_ok"), dict(consts, H=H, W=W, C=C)))
    return bool(_evaluate(_cpp_function("wgmma_ok"), env))


def test_the_header_constants_are_mirrored():
    tile = 64 * 64
    assert _evaluate(_cpp_constant("kTileF"), {"kMmaC": 64}) == tile
    assert _evaluate(_cpp_constant("kWgFloats"), {"kTileF": tile}) == WG_FLOATS
    assert int(_cpp_constant("kWgN")) == 32
    assert "C % kMmaStep == 0" in _cpp_function("mma_ok")


@pytest.mark.parametrize("hw", [(7, 7), (6, 6)])
def test_stage_layout_and_refusal_follow_the_cpp_gate(hw):
    """At every C from 32 to 512 on 7×7 and 6×6 maps: ``stage`` gives
    ``'wgmma3'`` to the f32 builds exactly where ``wgmma_ok`` (read from
    the header) holds, ``'mma3'`` to the bf16 builds at every tensor-core
    shape; the layout holds the larger of wgmma3's area and the ring; every
    width is taken, forward and backward, under that layout."""
    hh, ww = hw
    for c in range(32, 513, 32):
        cpp = _cpp_wgmma_ok(hh, ww, c)
        assert (stage(hw, c) == "wgmma3") == cpp
        assert (c in WGMMA_C) == cpp
        assert stage(hw, c, "bf16") == ("ffma" if c == 32 else "mma3")
        assert stage(hw, c, "bf16_conv") == stage(hw, c, "bf16")
        if c > 32 and not cpp:
            assert stage(hw, c) == "mma3"
        assert supported(hw, c, "wgmma3") == cpp
        lay, lay_mma = layout(hw, c, 32), layout(hw, c, 32, "mma3")
        assert lay.stage == stage(hw, c)
        if cpp:
            grow = max(WG_FLOATS - lay.ring * 64 * 72, 0)
            assert lay.smem == lay_mma.smem + 4 * grow
            assert (lay.ring, lay.x_global) == (lay_mma.ring, lay_mma.x_global)
        else:
            assert lay == lay_mma or lay.stage == "ffma"
        assert lay.smem <= MAX_SMEM
        assert refusal(hw, c, 32) is None and bwd_refusal(hw, c, 32) is None
        bwd = layout(hw, c, 32, backward=True)
        assert bwd.smem <= MAX_SMEM and u_global(hw, c, 32) == bwd.u_global
    # 7×7×64 and 6×6×64, the main path and the MNIST block, run wgmma3.
    assert stage(hw, 64) == "wgmma3"


def test_wgmma3_keeps_two_ctas_per_sm_at_the_main_shape():
    """The area holds wgmma3's two split tiles, its f32 tile and mbarrier in
    the ring's 13,824 floats, so 7×7×64's shared memory (96,384 bytes) and
    the backward's (110,720) are those of the mma.sync stage: two CTAs per
    SM, each with 1 KB reserved (and the fused step's static tableau), in
    228 KB."""
    assert WG_FLOATS == 3 * 4096 + 4 <= 3 * 64 * 72
    fwd = layout((7, 7), 64, 32)
    bwd = layout((7, 7), 64, 32, backward=True)
    assert (fwd.stage, fwd.smem, bwd.smem) == ("wgmma3", 96384, 110720)
    for nbytes in (fwd.smem + 1024, bwd.smem):
        assert 2 * (nbytes + 1024) <= 228 * 1024
    assert odefunc_mod.smem_bytes((6, 6), 64, 32) == 92480
