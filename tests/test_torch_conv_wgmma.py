"""The ``wgmma3`` conv stage and its bf16 build ``wgmma_bf16`` on the CPU:
their arithmetic, emulated step by step (``conv3x3_wgmma_emulated``,
``precision='bf16'`` for the bf16 build), against the float64 conv, the
plain bf16 conv and the JAX package's ConcatConv on the same numpy-seeded
inputs; the layout of their weight tiles (``wgmma_k_order``,
``wgmma_tile_offset``, ``wgmma_pack``; ``wgmma_bf16_offset``,
``wgmma_pack_bf16`` and the conversion ``bf16_bits``); and the Python gate
(``stage``, ``layout``, ``refusal``) against the C++ one, read from
``csrc/odefunc_common.cuh``.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

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
    bf16_bits,
    conv3x3,
    conv3x3_plain,
    conv3x3_wgmma_emulated,
    supported,
    tf32_split,
    wgmma_bf16_offset,
    wgmma_k_order,
    wgmma_pack,
    wgmma_pack_bf16,
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
    ``'wgmma3'`` to the f32 builds and ``'wgmma_bf16'`` to the bf16 builds
    and the fused step's ``'bf16_conv'`` exactly where ``wgmma_ok`` (read
    from the header, as ``make_shape`` sets it for every precision) holds,
    ``'mma3'`` at the other tensor-core shapes (the bf16 dynamics there:
    ``'rows_bf16'``, the rows build); the layout holds the larger
    of wgmma3's area and the ring; every width is taken, forward and
    backward, under that layout."""
    hh, ww = hw
    header = " ".join(HEADER.read_text().split())
    assert "s.wg = wgmma_ok(H, W, C);" in header
    for c in range(32, 513, 32):
        cpp = _cpp_wgmma_ok(hh, ww, c)
        assert (stage(hw, c) == "wgmma3") == cpp
        assert (c in WGMMA_C) == cpp
        assert (stage(hw, c, "bf16") == "wgmma_bf16") == cpp
        assert stage(hw, c, "bf16") == ("ffma" if c == 32 else
                                        "wgmma_bf16" if cpp else "rows_bf16")
        assert stage(hw, c, "bf16_conv") == ("ffma" if c == 32 else
                                             "wgmma_bf16" if cpp else "mma3")
        if stage(hw, c, "bf16") == "wgmma_bf16":
            assert (layout(hw, c, 32, "wgmma_bf16")
                    == layout(hw, c, 32)._replace(stage="wgmma_bf16"))
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


# ---- wgmma_bf16: the bf16 tile, its conversion and its arithmetic ---------


def _cpp_bf16_offset():
    """``wg_bf16_offset`` of the header as a Python function of (n, k)."""
    m = re.search(r"constexpr int wg_bf16_offset\(int n, int k\) \{\s*"
                  r"return (.*?);\s*\}", HEADER.read_text(), re.S)
    assert m, "wg_bf16_offset not found"
    expr = " ".join(m.group(1).split())
    assert re.fullmatch(r"[\w\s()+*&>]+", expr), expr
    return lambda n, k: eval(expr, {"__builtins__": {}},  # noqa: S307
                             {"n": n, "k": k})


def test_bf16_tile_offsets_are_the_descriptor_walk():
    """Every (n, k) of a (64, 64) bf16 tile has its own 2-byte slot in 8 KB
    (the header's ``wg_bf16_offset`` and its Python mirror agree), and the
    slot is where the K-major, unswizzled descriptor of the warpgroup
    (output half nh, k half kh) at k16 step ks reads it: start
    ``wgmma_bf16_offset(32·nh, 32·kh)`` + 256·ks, then core matrix (n // 8
    within the half, k // 8 of the step) at SBO 1,024 and LBO 128, row
    n % 8 of 16 bytes, column k % 8 of 2."""
    cpp = _cpp_bf16_offset()
    seen = set()
    for n in range(64):
        for k in range(64):
            off = wgmma_bf16_offset(n, k)
            assert off == cpp(n, k) and off % 2 == 0 and 0 <= off < 8192
            seen.add(off)
    assert len(seen) == 64 * 64
    for nh in range(2):
        for kh in range(2):
            for ks in range(2):
                start = wgmma_bf16_offset(32 * nh, 32 * kh) + 256 * ks
                for nl in range(32):
                    for lk in range(16):
                        walk = (start + 1024 * (nl // 8) + 128 * (lk // 8)
                                + 16 * (nl % 8) + 2 * (lk % 8))
                        assert wgmma_bf16_offset(
                            32 * nh + nl, 32 * kh + 16 * ks + lk) == walk
    header = " ".join(HEADER.read_text().split())
    assert ("kB ? wgmma_desc(smem_addr(head) + wg_bf16_offset(kWgN * nh, "
            "32 * kh), 1024)") in header
    assert "wgmma_bf16(acc, a16[1], b_head + kStep, 1);" in header


@pytest.mark.parametrize("scale", [0.05, 3.0, 1e-30])
def test_bf16_conversion_is_to_bfloat16(scale):
    """``bf16_bits`` (``cvt.rn.bf16x2.f32``'s rounding in integers, to
    nearest, ties to even) is ``.to(torch.bfloat16)`` on random values,
    subnormals (at 1e-30) and exact ties of either parity; the packed tile
    read back slot by slot is the tile converted."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32)
                         * np.float32(scale))
    ties = torch.tensor([0x3F808000, 0x3F818000, 0xBF808000, 0x00018000],
                        dtype=torch.int64).to(torch.int32).view(torch.float32)
    for v in (x.reshape(-1), ties):
        want = v.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF
        assert torch.equal(bf16_bits(v), want)
    packed = wgmma_pack_bf16(x)
    slots = torch.tensor([[wgmma_bf16_offset(n, k) // 2 for n in range(64)]
                          for k in range(64)])
    want = x.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF
    assert int(packed.min()) >= 0
    assert torch.equal(packed[slots], want)


def test_bf16_conversion_walk_is_conflict_free():
    """Per warpgroup, thread wt converts n = 32·nh + wt % 32 and the k octet
    wt // 32 of its k half: every slot of the warpgroup's quarter once; a
    warp's 32 lanes read 32 consecutive floats of one (k, n) row per load
    (no bank conflict), and each quarter-warp stores 8 consecutive 16-byte
    core-matrix rows (one 128-byte wavefront)."""
    for nh in range(2):
        for kh in range(2):
            items = [(32 * nh + (wt & 31), 32 * kh + 8 * (wt >> 5))
                     for wt in range(128)]
            assert sorted(items) == sorted(
                (32 * nh + n, 32 * kh + 8 * o)
                for n in range(32) for o in range(4))
            for q0 in range(0, 128, 8):
                rows = {wgmma_bf16_offset(*items[wt]) // 16
                        for wt in range(q0, q0 + 8)}
                assert len(rows) == 8 and max(rows) - min(rows) == 7
            for w0 in range(0, 128, 32):
                ns = [items[wt][0] for wt in range(w0, w0 + 32)]
                assert ns == list(range(ns[0], ns[0] + 32))


@pytest.mark.parametrize("batch,hw", [(3, (7, 7)), (3, (6, 6)), (2, (5, 5)),
                                      (1, (1, 62))])
def test_bf16_emulation_matches_the_plain_bf16_conv(batch, hw):
    """Two bf16 k16 steps per tap and k half from zero, each tap's chain
    added in f32, the halves last: within f32 reassociation of
    ``conv3x3_plain(passes='bf16')`` (both sum exact products of the same
    rounded operands), f32-grade against the f64 conv of those operands,
    and outside that tolerance of the f32 conv (the operands are rounded).
    ``precision='bf16_conv'`` (the fused step's bf16 convs on this stage)
    is the same arithmetic bit for bit, on x and on x rounded already (its
    conv input, rounded by its writer)."""
    x, w = _draw(batch, hw, 64)
    got = conv3x3_wgmma_emulated(x, w, precision="bf16")
    plain = conv3x3_plain(x, w, passes="bf16")
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **CONV_TOL)
    exact = conv3x3_plain(odefunc_mod.bf16_round(x).double(),
                          odefunc_mod.bf16_round(w).double())
    assert float((got.double() - exact).abs().max()) < 2e-7
    assert not torch.allclose(got, conv3x3_plain(x, w), **CONV_TOL)
    assert torch.equal(conv3x3_wgmma_emulated(x, w, precision="bf16_conv"),
                       got)
    assert torch.equal(conv3x3_wgmma_emulated(
        odefunc_mod.bf16_round(x), w, precision="bf16_conv"), got)
    with pytest.raises(ValueError, match="precision"):
        conv3x3_wgmma_emulated(x, w, precision="fp16")


@pytest.mark.parametrize("hw", [(7, 7), (6, 6)])
def test_bf16_emulation_against_the_jax_concat_conv(hw):
    """The split ConcatConv with the bf16 stage's conv, at the kernels'
    rounding points (``concat_out``: the conv's sum, its sum with the bias,
    t·M and the last sum each rounded), against the JAX package's
    ``concat_conv2d`` on bf16 weights, t and inputs (the jnp bf16
    dynamics' conv).  Units: u = 2^-8 of each sample's max-norm.  The two
    round alike but where f32 reassociation puts a sum on the other side of
    a rounding boundary (2 of 9,408 elements at 7×7, 0.032 u); the bar is
    0.25 u, which rounding the time map's sum in with the bias (one
    rounding point moved, about 1 u) and the f32 ConcatConv break."""
    rng = np.random.default_rng(4)
    b, c = 3, 64
    x = rng.normal(size=(b, *hw, c)).astype(np.float32)
    t = rng.uniform(0, 1, b).astype(np.float32)
    p = jl.init_conv(jax.random.PRNGKey(5), 3, 3, c + 1, c)
    p = {k: np.array(v) for k, v in p.items()}
    kernel = torch.from_numpy(p["kernel"])
    conv = conv3x3_wgmma_emulated(torch.from_numpy(x),
                                  kernel[:, :, 1:, :].contiguous(),
                                  precision="bf16")
    want = np.asarray(jl.concat_conv2d(
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()},
        jnp.asarray(t, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16)
    ).astype(jnp.float32))
    bias = torch.from_numpy(p["bias"])
    tm = time_map(odefunc_mod.bf16_round(kernel), *hw)
    tb = odefunc_mod.bf16_round(torch.from_numpy(t)).reshape(-1, 1, 1, 1)
    r = odefunc_mod.bf16_round
    def u_per_row(a):
        d = np.abs(a - want).reshape(b, -1).max(1)
        return d / (2.0 ** -8 * np.abs(want).reshape(b, -1).max(1))

    got = r(r(r(conv) + r(bias)) + r(tb * r(tm))).numpy()
    assert float(u_per_row(got).max()) <= 0.25
    moved = r(r(conv) + r(bias) + r(tb * r(tm))).numpy()
    want32 = np.asarray(jl.concat_conv2d(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(t),
        jnp.asarray(x)))
    assert float(u_per_row(moved).max()) > 0.25
    assert float(u_per_row(want32).max()) > 0.25
