"""The probe's ``im2col_bf16`` (one bf16 ``wgmma`` GEMM over the rows of
every sample) and its ``wgmma_bf16`` strategy on the CPU: the port's CPU
path against the TPU kernels themselves (the JAX probe's ``im2col_bf16``,
``im2colS_bf16`` and ``rollS_bf16`` kernels run by ``pl.pallas_call`` in
interpret mode), the 128-byte swizzled tile layout against the descriptor
walk and the header's offset, a plain emulation of the kernel's tiling and
order of sums against the float64 conv, and the gates against the C++ ones
read from ``csrc/conv_probe.cu``.  The kernels themselves run only on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from neural_ode_features_tpu_torch.kernels import conv3x3 as conv_mod
from neural_ode_features_tpu_torch.kernels.conv3x3 import (
    BF16_STRATEGIES,
    I2W_K,
    I2W_MAX_C,
    I2W_MAX_WINDOW,
    I2W_STAGES,
    STRATEGIES,
    conv3x3,
    conv3x3_plain,
    conv3x3_wgmma_emulated,
    im2col_patches,
    im2col_smem_bytes,
    im2col_tile_rows,
    im2col_wgmma_emulated,
    im2col_window_bytes,
    supported,
    sw128_offset,
)
from neural_ode_features_tpu_torch.kernels.odefunc import bf16_round, stage
from neural_ode_features_tpu_torch.probes import conv_probe

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "neural_ode_features_tpu_torch" / "csrc"
# The conv against its plain bf16 version: f32 reassociation of sums of
# 576 exact products (chip_smoke.py CONV_TOL).
CONV_TOL = dict(rtol=1e-4, atol=1e-5)
# The TPU kernels against the port's CPU path: both sum exact products of
# the same bf16 operands in f32; they read 8.9e-8 at B = 4, 7×7×64.
JAX_ATOL = 1e-6
WGMMA_BAR = conv_probe.WGMMA_BAR


def _draw(batch, hw, c, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, *hw, c)).astype(np.float32) * 0.1
    w = rng.normal(size=(3, 3, c, c)).astype(np.float32) * 0.05
    return torch.from_numpy(x), torch.from_numpy(w)


def _f64(x, w):
    """The float64 conv of the bf16-rounded operands: their products are
    exact, so what is left is each kernel's order of sums."""
    return conv3x3_plain(bf16_round(x).double(), bf16_round(w).double())


# ---- the TPU kernels, interpreted, against the port's CPU path ------------


def _jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_conv_probe_for_tests", ROOT / "probes" / "conv_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_tpu_kernel(kind, tb, x, w):
    """One of the JAX probe's bf16 im2col kernels over x (B, 7, 7, 64) in
    grid steps of ``tb`` samples, as ``pallas_conv``/``pallas_conv_2d``
    launch them, in interpret mode."""
    mod = _jax_probe()
    b, hh, ww, c = x.shape
    assert (hh, ww, c) == (mod.H, mod.W, mod.C)
    vmem = dict(memory_space=pltpu.VMEM)
    if kind == "rollS_bf16":
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
        )(jnp.asarray(x.numpy().reshape(-1, c)),
          jnp.asarray(w.numpy().reshape(9 * c, c)))
        return np.asarray(out).reshape(b, hh, ww, c)
    if kind == "im2colS_bf16":
        kern, scratch = mod.make_scratch_kernel(kind, tb)
    else:
        kern, scratch = mod.make_kernel(kind, tb), []
    spec = pl.BlockSpec((tb, hh, ww, c), lambda g: (g, 0, 0, 0), **vmem)
    out = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((b, hh, ww, c), jnp.float32),
        grid=(b // tb,), in_specs=[spec, pl.BlockSpec(**vmem)],
        out_specs=spec, scratch_shapes=scratch, interpret=True,
    )(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()))
    return np.asarray(out)


@pytest.mark.parametrize("tb", [1, 2])
@pytest.mark.parametrize("kind", ["im2col_bf16", "im2colS_bf16", "rollS_bf16"])
def test_tpu_kernels_match_the_port(kind, tb):
    """``probes/conv_probe.py``'s bf16 im2col kernels (one (tb·H·W, 9C) @
    (9C, C) bf16 dot per grid step, f32 accumulation) against
    ``conv3x3(x, w, "im2col_bf16")`` on the CPU, the port's plain version:
    the same rounded operands, exact products summed in f32."""
    x, w = _draw(4, (7, 7), 64)
    got = conv3x3(x, w, "im2col_bf16")
    want = _run_tpu_kernel(kind, tb, x, w)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=JAX_ATOL)
    # ... and the f32 conv lies far outside that.
    assert float(np.abs(conv3x3_plain(x, w).numpy() - want).max()) > 1e-4


# ---- the 128-byte swizzled tiles -----------------------------------------


def _cpp_sw128_offset():
    """``sw128_offset`` of the header as a Python function of (r, k)."""
    m = re.search(r"constexpr int sw128_offset\(int r, int k\) \{\s*"
                  r"return (.*?);\s*\}",
                  (CSRC / "odefunc_common.cuh").read_text(), re.S)
    assert m, "sw128_offset not found"
    expr = " ".join(m.group(1).split())
    assert re.fullmatch(r"[\w\s()+*&>^<]+", expr), expr
    return lambda r, k: eval(expr, {"__builtins__": {}},  # noqa: S307
                             {"r": r, "k": k})


def _swizzled(addr):
    """Where the tensor cores read the 16-byte chunk they compute at byte
    address ``addr`` of a 128-byte-swizzled operand (atoms 1,024-byte
    aligned): address bits 4-6 XOR bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


@pytest.mark.parametrize("rows", [64, 128])
def test_swizzled_offset_is_a_bijection_onto_the_tile(rows):
    """Every (row, k) of a (rows, 64) bf16 tile has its own 2-byte slot in
    rows·128 bytes, the header's offset and its Python mirror agree, and a
    chunk of 8 k starts on 16 bytes."""
    cpp = _cpp_sw128_offset()
    seen = set()
    for r in range(rows):
        for k in range(64):
            off = sw128_offset(r, k)
            assert off == cpp(r, k) and off % 2 == 0 and 0 <= off < 128 * rows
            assert (off % 16 == 0) == (k % 8 == 0)
            seen.add(off)
    assert len(seen) == 64 * rows


@pytest.mark.parametrize("tile_rows", [64, 128])
def test_swizzled_offset_is_the_descriptor_walk(tile_rows):
    """The slot of (row, k) is where the descriptor of consumer warpgroup
    wc (A: start at row 64·wc; B: start at row 64·nb) at k16 step ks reads
    it: start + 32·ks, then 8-row group m // 8 at SBO 1,024, row m % 8 of
    128 bytes, element 2·k, all under the 128-byte swizzle of the address."""
    for wc in range(tile_rows // 64):
        for ks in range(I2W_K // 16):
            start = 64 * wc * 128 + 32 * ks
            for m in range(64):
                for k in range(16):
                    walk = start + 1024 * (m // 8) + 128 * (m % 8) + 2 * k
                    assert sw128_offset(64 * wc + m, 16 * ks + k) == _swizzled(walk)


def _banks(offsets):
    return {(off // 16) % 8 for off in offsets}


@pytest.mark.parametrize("tile_rows,c", [(64, 64), (128, 64), (128, 128)])
def test_producer_stores_are_conflict_free(tile_rows, c):
    """The producer's thread pt stores 16 bytes per item: of the patch, row
    pt // 8 + 16·j at k chunk pt % 8; of the weights, rows n0 .. n0 + 3
    (n0 = 4·(pt // 8 + 16·jn)) at k chunk pt % 8.  Each quarter-warp (8
    consecutive threads: one 128-byte wavefront) hits 8 distinct 16-byte
    bank groups, and together the items fill the stage once."""
    patch, weights = [], []
    for pt in range(128):
        g, r0 = pt & 7, pt >> 3
        patch.append([sw128_offset(r0 + 16 * j, 8 * g)
                      for j in range(tile_rows // 16)])
        weights.append([[sw128_offset(4 * (r0 + 16 * jn) + e, 8 * g)
                         for e in range(4)] for jn in range(-(-c // 64))])
    for q0 in range(0, 128, 8):
        quarter = range(q0, q0 + 8)
        for j in range(tile_rows // 16):
            assert len(_banks(patch[pt][j] for pt in quarter)) == 8
        for jn in range(-(-c // 64)):
            for e in range(4):
                assert len(_banks(weights[pt][jn][e] for pt in quarter)) == 8
    assert sorted(o for item in patch for o in item) == list(
        range(0, 128 * tile_rows, 16))
    assert sorted(o for item in weights for jn in item for o in jn) == list(
        range(0, 128 * 64 * -(-c // 64), 16))


# ---- the kernel's tiling and order of sums, emulated ----------------------


def test_patch_matrix_is_the_conv():
    """Rows (b, y, x) flattened across samples, columns (tap, channel): the
    patch matrix times the weights is the conv."""
    x, w = _draw(3, (5, 6), 8)
    a = im2col_patches(x.double())
    assert a.shape == (3 * 5 * 6, 9 * 8)
    got = (a @ w.double().reshape(72, 8)).reshape(x.shape)
    np.testing.assert_allclose(got.numpy(), conv3x3_plain(
        x.double(), w.double()).numpy(), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("batch,hw,c", [(5, (7, 7), 64), (3, (6, 6), 64),
                                        (2, (5, 5), 128), (3, (9, 8), 64),
                                        (4, (7, 7), 36), (2, (7, 7), 4),
                                        (2, (7, 7), 96)])
def test_emulation_tiles_rows_across_samples(batch, hw, c):
    """Rows cross sample boundaries and the last tile is partial (B = 5 at
    7×7: 245 rows, 3 whole tiles of 64 and 53 rows; 117 rows of a 128-row
    tile): every row's sums are its own, so the tile height and the batch
    change no bit, and a sample alone gives its rows of the batch."""
    x, w = _draw(batch, hw, c, seed=3)
    got = im2col_wgmma_emulated(x, w)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert torch.equal(got, im2col_wgmma_emulated(x, w, tile_rows=128))
    assert torch.equal(got[-1:], im2col_wgmma_emulated(x[-1:], w))
    np.testing.assert_allclose(got.numpy(), conv3x3_plain(
        x, w, passes="bf16").numpy(), **CONV_TOL)
    assert not torch.allclose(got, conv3x3_plain(x, w), **CONV_TOL)


@pytest.mark.parametrize("batch,hw", [(5, (7, 7)), (4, (6, 6))])
def test_emulated_order_within_the_bar(batch, hw):
    """The kernel's order of sums (per 64-k stage and k half a chain of two
    k16 steps from zero, added to that half's running f32 sum, the halves
    added last) is, at C = 64, the order of ``mma_bf16`` and
    ``wgmma_bf16`` (``conv3x3_wgmma_emulated(precision='bf16')``: per tap
    and k half): the same bits, so within ``WGMMA_BAR`` of their error
    against the f64 conv of the same rounded operands, and f32-grade."""
    x, w = _draw(batch, hw, 64, seed=5)
    exact = _f64(x, w)

    def err(a):
        return float((a.double() - exact).abs().max())

    emulated = im2col_wgmma_emulated(x, w)
    assert torch.equal(emulated, conv3x3_wgmma_emulated(x, w,
                                                        precision="bf16"))
    got = err(emulated)
    assert got <= WGMMA_BAR * err(conv3x3_plain(x, w, passes="bf16"))
    assert got < 2e-7
    with pytest.raises(ValueError, match="float32"):
        im2col_wgmma_emulated(x.double(), w.double())


# ---- the gates -------------------------------------------------------------


def _cpp(name):
    src = (CSRC / "conv_probe.cu").read_text()
    m = re.search(rf"constexpr int {name} = ([^;]+);", src)
    assert m, name
    return int(m.group(1))


def _cpp_return(signature, source="conv_probe.cu"):
    m = re.search(re.escape(signature) + r" \{\s*return (.*?);\s*\}",
                  (CSRC / source).read_text(), re.S)
    assert m, f"{signature} not found"
    return (" ".join(m.group(1).split()).replace("&&", " and ")
            .replace("(long long)", "").replace("1LL", "1"))


def _cpp_window_bytes(mw, w, c):
    expr = _cpp_return("__host__ __device__ constexpr int i2w_window_bytes("
                       "int mw, int W, int C)").replace("/", "//")
    return eval(expr, {"__builtins__": {}},  # noqa: S307
                {"mw": mw, "W": w, "C": c})


def _cpp_shape_ok(b, hh, ww, c):
    """The probe's C++ gate of the rows strategies: the window kernel's
    (``i2w_shape_ok``) or the rows kernel's (csrc/rows_conv.cuh
    ``rows_ok``)."""
    env = {"B": b, "H": hh, "W": ww, "C": c}
    expr = _cpp_return("inline bool i2w_shape_ok(int B, int H, int W, int C)")
    window = bool(eval(expr, {"__builtins__": {}},  # noqa: S307
                       {**env, "kI2wMaxC": _cpp("kI2wMaxC"),
                        "kI2wMaxWindow": _cpp("kI2wMaxWindow"),
                        "i2w_window_bytes": _cpp_window_bytes}))
    expr = _cpp_return("inline bool rows_ok(int B, int H, int W, int C)",
                       "rows_conv.cuh")
    return window or bool(eval(expr, {"__builtins__": {}},  # noqa: S307
                               {**env, "kMmaC": 64, "kMaxC": 512}))


def test_the_constants_are_mirrored():
    assert (_cpp("kI2wK"), _cpp("kI2wStages"), _cpp("kI2wMaxC"),
            _cpp("kI2wMaxWindow")) == (I2W_K, I2W_STAGES, I2W_MAX_C,
                                       I2W_MAX_WINDOW)
    for rows, w, c in ((64, 7, 64), (128, 7, 64), (64, 5, 128), (64, 7, 36),
                       (64, 1, 4), (128, 300, 64)):
        assert im2col_window_bytes(rows, w, c) == _cpp_window_bytes(
            rows // 64, w, c)
    # At 7×7×64: 4 stages of the (64, 64) patch and weight slices, four
    # staging slots of 64 rows of 256 bytes, and the window's 80 (144) rows
    # of 128 bytes; the widest and the tallest in reach.
    assert im2col_window_bytes(64, 7, 64) == 80 * 128
    assert im2col_smem_bytes(64, 64, 7) == (1024 + 4 * 16384 + 4 * 16384
                                            + 10240 + 64)
    assert im2col_smem_bytes(128, 64, 7) == (1024 + 4 * 24576 + 4 * 16384
                                             + 18432 + 64)
    assert im2col_smem_bytes(64, 128, 95) <= conv_mod.MAX_SMEM
    assert im2col_smem_bytes(128, 64, 191) <= conv_mod.MAX_SMEM


def test_gate_takes_every_old_shape_and_more():
    """Every shape the FFMA ``im2col`` gate takes (the old
    ``im2col_bf16``'s, its twin) at maps up to 32×32, and C a multiple of 4
    up to 128 at any map: 5×5×128 and 9×8×64, beyond the old per-sample
    patch, among them.  The Python gate is the C++ one at B = 1."""
    old = [(hh, ww, c) for hh in range(1, 33) for ww in range(1, 33)
           for c in range(4, 129, 4) if supported((hh, ww), c, "im2col")]
    assert len(old) > 1000
    for hh, ww, c in old:
        assert supported((hh, ww), c, "im2col_bf16")
    for hw, c in (((5, 5), 128), ((9, 8), 64), ((7, 7), 96), ((6, 6), 36),
                  ((28, 28), 64), ((7, 7), 100)):
        assert supported(hw, c, "im2col_bf16")
        assert not supported(hw, c, "im2col")
    for hw, c in (((7, 7), 132), ((7, 7), 6), ((7, 7), 0), ((0, 7), 64),
                  ((2, 224), 64), ((2, 300), 124), ((7, 7), 260),
                  ((7, 7), 520)):
        assert not supported(hw, c, "im2col_bf16")
    assert supported((2, 95), 128, "im2col_bf16")
    assert supported((2, 223), 64, "im2col_bf16")
    # Past the window, at C % 8 == 0 from 72 to 512, the rows kernel.
    assert supported((7, 7), 256, "im2col_bf16")
    assert supported((2, 96), 128, "im2col_bf16")
    for hh, ww, c in [(7, 7, 64), (5, 5, 128), (9, 8, 64), (1, 1, 4),
                      (7, 7, 132), (7, 7, 6), (0, 7, 64), (3, 3, 2),
                      (2, 95, 128), (2, 96, 128), (1, 1024, 4),
                      (2, 300, 124), (7, 7, 256), (7, 7, 512), (7, 7, 520),
                      (2, 96, 128), (7, 7, 160), (1, 1024, 72)]:
        assert _cpp_shape_ok(1, hh, ww, c) == supported((hh, ww), c,
                                                        "im2col_bf16")
    assert not _cpp_shape_ok(2 ** 20, 64, 64, 64)


def test_tile_rows_rule():
    """64-row tiles where they fit one wave of the card (a CTA an SM), at
    C > 64, or where the 128-row window does not fit; else 128: at B = 128,
    7×7 on 132 SMs, 98 tiles of 64, so 64; at B = 256, 196 > 132, so 128."""
    assert im2col_tile_rows(128 * 49, 132, 64, 7) == 64
    assert im2col_tile_rows(256 * 49, 132, 64, 7) == 128
    assert im2col_tile_rows(5 * 49, 132, 64, 7) == 64
    assert im2col_tile_rows(132 * 64, 132, 32, 7) == 64
    assert im2col_tile_rows(132 * 64 + 1, 132, 32, 7) == 128
    assert im2col_tile_rows(256 * 49, 132, 128, 7) == 64
    # ... and where the 128-row tile's window of x fits.
    assert im2col_tile_rows(1024 * 49, 132, 64, 191) == 128
    assert im2col_tile_rows(1024 * 49, 132, 64, 192) == 64


def test_wgmma_bf16_strategy_gate_and_cpu_path():
    """``wgmma_bf16`` runs where the bf16 ODEfunc kernel runs that stage
    and nowhere else; on the CPU it is the plain bf16 conv, as every twin;
    ``tile_rows`` belongs to ``im2col_bf16`` alone."""
    assert set(BF16_STRATEGIES) == {"mma_bf16", "tap9_bf16", "im2col_bf16",
                                    "wgmma_bf16"}
    assert set(STRATEGIES) == {"tap9", "im2col", "mma3", "mma1", "wgmma3"}
    for hh, ww in ((7, 7), (6, 6), (1, 62), (8, 8)):
        for c in (32, 64, 96, 128):
            assert supported((hh, ww), c, "wgmma_bf16") == (
                stage((hh, ww), c, "bf16") == "wgmma_bf16")
    x, w = _draw(2, (7, 7), 64)
    before = conv3x3.launches
    want = conv3x3_plain(x, w, passes="bf16")
    assert torch.equal(conv3x3(x, w, "wgmma_bf16"), want)
    assert torch.equal(conv3x3(x, w, "im2col_bf16", tile_rows=128), want)
    assert conv3x3.launches == before
    for strategy, rows in (("mma_bf16", 64), ("im2col_bf16", 96)):
        with pytest.raises(ValueError, match="tile_rows"):
            conv3x3(x, w, strategy, tile_rows=rows)
    # 128-row tiles on the window kernel only at C <= 64 (C = 100: the
    # window kernel, C % 8 != 0); the rows kernel takes 64 or 128 at any
    # width.
    x100, w100 = _draw(1, (5, 5), 100)
    with pytest.raises(ValueError, match="tile_rows"):
        conv3x3(x100, w100, "im2col_bf16", tile_rows=128)
    x128, w128 = _draw(1, (5, 5), 128)
    assert torch.equal(conv3x3(x128, w128, "im2col_bf16", tile_rows=128),
                       conv3x3_plain(x128, w128, passes="bf16"))


def test_graph_route_counts_the_probe_kernels():
    """A captured graph's kernel nodes of the probe count as ``conv3x3``
    launches, the new kernel and the ``wgmma`` strategies' included, each
    once (``solver/attempt_graph.py`` matches the mangled names)."""
    import collections

    from neural_ode_features_tpu_torch.solver import attempt_graph

    nodes = collections.Counter({
        "_ZN5nodef19im2col_wgmma_kernelILi2ELi1EEEvPKfS2_iiiiPf": 2,
        "_ZN5nodef19im2col_wgmma_kernelILi1ELi2EEEvPKfS2_iiiiPf": 1,
        "_ZN5nodef12wgmma_kernelILi2EEEvPKfS2_NS_5ShapeEPf": 3,
        "_ZN5nodef12wgmma_kernelILi0EEEvPKfS2_NS_5ShapeEPf": 4,
        "_ZN5nodef13im2col_kernelEPKfS1_NS_5ShapeEPf": 5,
        "_ZN5nodef13odefunc_kernelILb0ELb0ELi2EEEvPKfS2_S2_NS_7OdefuncE": 7,
    })
    rules = {(w.__name__, attr): kernels for w, attr, kernels
             in attempt_graph._kernel_wrappers()}
    assert attempt_graph._count(nodes, rules[("conv3x3", "launches")]) == 15
