"""The backward's per-sample pass as a two-CTA cluster (both builds at
C = 64, ``csrc/odefunc_bwd.cu`` ``bwd_sample_kernel_cluster``) on the CPU:
its input-gradient conv on the ``wgmma`` stage, emulated step by step
(``conv3x3_wgmma_emulated(..., transposed=True)``: tap 8 − k's tile
transposed, the instruction's k order, three TF32 products per k8 step;
with ``precision='bf16'``, two bf16 k16 steps) against the float64 input
gradient and ``jax.vjp`` of the JAX package's ``concat_conv2d`` (in f32,
and in bf16 for the bf16 build); the split (conversion) of a CTA's half
tile (``wgmma_pack_rows``, ``wgmma_pack_rows_bf16``); and the Python gate
and shared-memory formula (``sample_pass``, ``cluster_smem_bytes``)
against the C++ ones, read from the source.  The kernel itself runs only
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.ops import layers as jl
from neural_ode_features_tpu_torch.kernels.conv3x3 import (
    conv3x3_plain,
    conv3x3_wgmma_emulated,
    wgmma_bf16_offset,
    wgmma_pack,
    wgmma_pack_bf16,
    wgmma_pack_rows,
    wgmma_pack_rows_bf16,
    wgmma_rows_item,
    wgmma_tile_offset,
)
from neural_ode_features_tpu_torch.kernels.odefunc import (
    MAX_SMEM,
    layout,
    stage,
)
from neural_ode_features_tpu_torch.kernels.odefunc_bwd import (
    PAIR_C,
    PAIR_THREADS,
    bwd_smem_bytes,
    cluster_smem_bytes,
    odefunc_bwd,
    odefunc_bwd_plain,
    pair_area_floats,
    sample_pass,
)
from neural_ode_features_tpu_torch.kernels.odefunc import bf16_round, prepare
from neural_ode_features_tpu_torch.probes import conv_probe

torch.set_num_threads(2)

CSRC = Path(__file__).resolve().parent.parent / (
    "neural_ode_features_tpu_torch") / "csrc"
SOURCE = CSRC / "odefunc_bwd.cu"
# The emulation against the f64 input gradient: f32-grade, the bar of the
# forward stage's emulation (tests/test_torch_conv_wgmma.py CONV_TOL: sums
# of 576 products, relative 1e-4, absolute 1e-5 at these scales).
CONV_TOL = dict(rtol=1e-4, atol=1e-5)
# Against jax.vjp of concat_conv2d: f32 reassociation, relative 1e-4,
# absolute 2e-5 (the same file's bar against the JAX ConcatConv).
JAX_TOL = dict(rtol=1e-4, atol=2e-5)
WGMMA_BAR = conv_probe.WGMMA_BAR


def _draw(batch, hw, c=64, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(batch, *hw, c)).astype(np.float32) * 0.1
    w = rng.normal(size=(3, 3, c, c)).astype(np.float32) * 0.05
    return torch.from_numpy(g), torch.from_numpy(w)


def _flipped_transposed(w):
    """Tap (ky, kx) of the input-gradient conv: tap (2 − ky, 2 − kx) of
    ``w`` transposed."""
    return w.flip(0).flip(1).transpose(2, 3).contiguous()


# ---- the arithmetic --------------------------------------------------------


@pytest.mark.parametrize("batch,hw", [(3, (7, 7)), (3, (6, 6)), (2, (5, 5)),
                                      (1, (1, 62))])
def test_transposed_emulation_matches_the_f64_input_gradient(batch, hw):
    """Tap 8 − k's tile transposed, three products per k8 step in the
    instruction's k order, each tap's chain from zero per k half, the
    halves added last: f32-grade against the f64 input gradient, and
    within the probe's bar of the mma.sync 3xTF32 emulation of the same
    conv (the one-CTA pass's input-gradient stage), on every map the stage
    takes."""
    g, w = _draw(batch, hw)
    wbt = _flipped_transposed(w)
    got = conv3x3_wgmma_emulated(g, w, transposed=True)
    exact = conv3x3_plain(g.double(), wbt.double())
    assert got.shape == g.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.double().numpy(), exact.numpy(),
                               **CONV_TOL)
    err = float((got.double() - exact).abs().max())
    err_mma = float((conv3x3_plain(g, wbt, passes=3).double() - exact)
                    .abs().max())
    assert err <= WGMMA_BAR * err_mma
    assert err < 2e-7
    # the forward stage on the rearranged weights is the same function
    assert torch.equal(got, conv3x3_wgmma_emulated(g, wbt))


@pytest.mark.parametrize("hw", [(7, 7), (6, 6)])
def test_transposed_emulation_against_jax_vjp(hw):
    """The input gradient of the JAX package's ConcatConv
    (``jax.vjp`` of ``concat_conv2d`` with respect to its input, per-sample
    t) against the emulation on the same numpy-seeded weights and
    cotangent: the time channel carries none of it, so it is the transposed
    conv with the state part ``W[:, :, 1:]``."""
    rng = np.random.default_rng(4)
    b, c = 3, 64
    x = rng.normal(size=(b, *hw, c)).astype(np.float32)
    g = rng.normal(size=(b, *hw, c)).astype(np.float32)
    t = rng.uniform(0, 1, b).astype(np.float32)
    p = jl.init_conv(jax.random.PRNGKey(5), 3, 3, c + 1, c)
    p = {k: jnp.asarray(np.array(v)) for k, v in p.items()}
    _, vjp = jax.vjp(lambda xx: jl.concat_conv2d(p, jnp.asarray(t), xx),
                     jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    kernel = torch.from_numpy(np.array(p["kernel"]))
    got = conv3x3_wgmma_emulated(torch.from_numpy(g),
                                 kernel[:, :, 1:, :].contiguous(),
                                 transposed=True)
    np.testing.assert_allclose(got.numpy(), want, **JAX_TOL)


@pytest.mark.parametrize("batch,hw", [(3, (7, 7)), (3, (6, 6)), (1, (1, 62))])
def test_bf16_transposed_emulation_matches_the_plain_bf16_input_gradient(
        batch, hw):
    """The bf16 cluster pass's input-gradient conv (``wgmma_bf16`` on tap
    8 − k's tile transposed, two k16 steps per tap and k half): within f32
    reassociation of the plain bf16 conv with the flipped, transposed
    weights, f32-grade against the f64 conv of the rounded operands, and
    the forward bf16 stage on the rearranged weights bit for bit."""
    g, w = _draw(batch, hw)
    wbt = _flipped_transposed(w)
    got = conv3x3_wgmma_emulated(g, w, transposed=True, precision="bf16")
    np.testing.assert_allclose(
        got.numpy(), conv3x3_plain(g, wbt, passes="bf16").numpy(), **CONV_TOL)
    exact = conv3x3_plain(bf16_round(g).double(), bf16_round(wbt).double())
    assert float((got.double() - exact).abs().max()) < 2e-7
    assert torch.equal(got, conv3x3_wgmma_emulated(g, wbt, precision="bf16"))


@pytest.mark.parametrize("hw", [(7, 7), (6, 6)])
def test_bf16_transposed_emulation_against_jax_vjp(hw):
    """The input gradient of the JAX package's ConcatConv in bf16 (``jax.vjp``
    of ``concat_conv2d`` on bf16 weights, t, input and cotangent, the jnp
    bf16 dynamics' VJP: its sum rounded once) against the emulation rounded
    once, as the bf16 cluster pass rounds it (``to_sx``), on the same
    numpy-seeded weights and cotangent.  Units: u = 2^-8 of each sample's
    max-norm; the two round alike but where f32 reassociation crosses a
    rounding boundary, so the bar is 0.25 u, which the f32 VJP breaks."""
    rng = np.random.default_rng(4)
    b, c = 3, 64
    x = rng.normal(size=(b, *hw, c)).astype(np.float32)
    g = rng.normal(size=(b, *hw, c)).astype(np.float32)
    t = rng.uniform(0, 1, b).astype(np.float32)
    p = jl.init_conv(jax.random.PRNGKey(5), 3, 3, c + 1, c)

    def vjp_x(dtype):
        pp = {k: jnp.asarray(np.array(v), dtype) for k, v in p.items()}
        _, vjp = jax.vjp(lambda xx: jl.concat_conv2d(pp, jnp.asarray(t, dtype),
                                                     xx), jnp.asarray(x, dtype))
        return np.asarray(vjp(jnp.asarray(g, dtype))[0].astype(jnp.float32))

    want, want32 = vjp_x(jnp.bfloat16), vjp_x(jnp.float32)
    kernel = torch.from_numpy(np.array(p["kernel"]))
    got = bf16_round(conv3x3_wgmma_emulated(
        torch.from_numpy(g), kernel[:, :, 1:, :].contiguous(),
        transposed=True, precision="bf16")).numpy()

    def u_per_row(a):
        d = np.abs(a - want).reshape(b, -1).max(1)
        return d / (2.0 ** -8 * np.abs(want).reshape(b, -1).max(1))

    assert float(u_per_row(got).max()) <= 0.25
    assert float(u_per_row(want32).max()) > 0.25


# ---- the split of a CTA's half tile ---------------------------------------


def test_rows_walk_covers_every_item_once_without_bank_conflicts():
    """Per warpgroup, thread wt takes one (row, k octet) item, every item
    once; each quarter-warp (8 consecutive lanes) reads 8 distinct 16-byte
    bank groups with its first load (rows 256 bytes apart, octets 32, the
    second half first on lanes 4..7) and stores to 8 consecutive 16-byte
    core-matrix rows."""
    items = [wgmma_rows_item(wt) for wt in range(128)]
    assert sorted(items) == [(n, o) for n in range(32) for o in range(4)]
    for q0 in range(0, 128, 8):
        loads, stores = set(), set()
        for wt in range(q0, q0 + 8):
            n, o = items[wt]
            first = (wt & 7) >> 2
            loads.add((n * 256 + 32 * o + 16 * first) % 128 // 16)
            stores.add(wgmma_tile_offset(n, 8 * o) % 128 // 16)
        assert len(loads) == 8 and len(stores) == 8


@pytest.mark.parametrize("rank", [0, 1])
def test_half_tile_split_is_the_whole_tiles_half(rank):
    """A CTA's split of its 32 rows of tap 8 − k's weights (as copied:
    8 KB, 64 floats a row) is, slot for slot, the output-channel half
    ``rank`` of the forward stage's split of the transposed tile
    (``wgmma_pack``): heads TF32, heads + tails the weights exactly."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))
    head, tail = wgmma_pack_rows(w[32 * rank:32 * rank + 32].contiguous())
    full_head, full_tail = wgmma_pack(w.T.contiguous())
    assert torch.equal(head, full_head[2048 * rank:2048 * (rank + 1)])
    assert torch.equal(tail, full_tail[2048 * rank:2048 * (rank + 1)])


@pytest.mark.parametrize("rank", [0, 1])
def test_bf16_half_tile_conversion_is_the_whole_tiles_half(rank):
    """The bf16 cluster pass's conversion of its 32 rows of tap 8 − k's
    weights (``wgmma_pack_rows_bf16``, the rotated walk of the TF32 split,
    eight k into one core-matrix row) is, slot for slot, the output-channel
    half ``rank`` of the forward stage's conversion of the transposed tile
    (``wgmma_pack_bf16``); each quarter-warp stores 8 rows of distinct
    banks."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))
    half = wgmma_pack_rows_bf16(w[32 * rank:32 * rank + 32].contiguous())
    full = wgmma_pack_bf16(w.T.contiguous())
    assert int(half.min()) >= 0
    assert torch.equal(half, full[2048 * rank:2048 * (rank + 1)])
    for kh in range(2):
        for q0 in range(0, 128, 8):
            banks = set()
            for wt in range(q0, q0 + 8):
                n, o = wgmma_rows_item(wt)
                banks.add(wgmma_bf16_offset(n, 32 * kh + 8 * o) % 128 // 16)
            assert len(banks) == 8


def test_the_split_walk_is_the_kernels():
    """The walk of ``wgmma_rows_item`` read against the transposed split
    of ``wgmma_conv<2, true>`` (``csrc/odefunc_common.cuh``), which
    ``pair_conv<true>`` runs."""
    header = " ".join((CSRC / "odefunc_common.cuh").read_text().split())
    assert ("const int l = wt & 7, o = ((wt >> 3) + l) & 3, sw = l >> 2;"
            in header)
    assert "const int n = 8 * (wt >> 5) + l, k0 = 32 * kh + 8 * o;" in header
    assert "const float* row = raw + n * kMmaC + k0;" in header
    src = " ".join(SOURCE.read_text().split())
    assert ("wgmma_conv<2, BT, PREC>(m.spad, s, m.head, w, (int)rank * kPairC, "
            "epi);") in src


# ---- the gate and the layout: Python against the C++ ----------------------


def _cpp(pattern):
    m = re.search(pattern, SOURCE.read_text(), re.S)
    assert m, pattern
    return " ".join(m.group(1).split())


def _cpp_pair_ok(hh, ww, c, g):
    expr = _cpp(r"inline bool pair_ok\(int H, int W, int C, int G\) \{\s*"
                r"return (.*?);\s*\}")
    py = (expr.replace("&&", " and ")
          .replace("wgmma_ok(H, W, C)", "(stage((H, W), C) == 'wgmma3')"))
    assert re.fullmatch(r"[\w\s()+*/%<>=,.!'-]+", py), py
    return bool(eval(py, {"__builtins__": {}},  # noqa: S307
                     {"stage": stage, "H": hh, "W": ww, "C": c, "G": g}))


def _cpp_constant(name, env):
    value = _cpp(rf"constexpr int {name} = ([^;]+);")
    return eval(value, {"__builtins__": {}}, env)  # noqa: S307


@pytest.mark.parametrize("hw", [(7, 7), (6, 6), (5, 5), (3, 8)])
def test_sample_pass_follows_pair_ok(hw):
    """At every C from 32 to 512 and every group count dividing it, both
    builds run the cluster exactly where ``pair_ok`` (read from the source,
    where the launcher takes it for either build) holds: C = 64 with an
    even group count."""
    for c in range(32, 513, 32):
        for g in (d for d in range(1, c + 1) if c % d == 0):
            cpp = _cpp_pair_ok(*hw, c, g)
            assert (sample_pass(hw, c, g) == "cluster") == cpp, (hw, c, g)
            assert (sample_pass(hw, c, g, "bf16") == "cluster") == cpp
    for precision in ("f32", "bf16"):
        assert sample_pass(hw, 64, 32, precision) == "cluster"
        assert sample_pass(hw, 64, 1, precision) == "cta"  # odd groups
        assert sample_pass(hw, 128, 32, precision) == "cta"  # C != 64
        assert sample_pass((8, 8), 64, 32, precision) == "cta"  # H·(W+2) > 64
    src = " ".join(SOURCE.read_text().split())
    assert "if (pair_ok(H, W, C, G)) { // the cluster pass" in src
    assert "const auto pass = bwd_sample_kernel_cluster<kPrec>;" in src
    with pytest.raises(ValueError, match="precision"):
        sample_pass(hw, 64, 32, "bf16_conv")


def test_no_group_crosses_the_halves():
    """At C = 64 a CTA owns channels 32r..32r+31; a GroupNorm group of C/G
    consecutive channels lies within one half exactly where G is even, and
    the gate takes exactly those group counts (G = 32, the main path's:
    groups of two channels, 16 a CTA)."""
    for g in (d for d in range(1, 65) if 64 % d == 0):
        gs = 64 // g
        crosses = any(len({ch // PAIR_C for ch in range(j * gs, (j + 1) * gs)})
                      > 1 for j in range(g))
        assert crosses == (g % 2 == 1)
        assert (sample_pass((7, 7), 64, g) == "cluster") == (not crosses)
    assert 64 // 32 == 2 and PAIR_C // (64 // 32) == 16


def test_the_constants_are_mirrored():
    env = {"kMmaC": 64}
    assert _cpp_constant("kPairThreads", env) == PAIR_THREADS == 256
    assert _cpp_constant("kPairC", env) == PAIR_C == 32
    env.update(kPairC=PAIR_C, kPairThreads=PAIR_THREADS)
    assert _cpp_constant("kPairGroups", env) == 8
    # the one-CTA pass's pixel groups at C = 64 (512 threads / 64 channels)
    assert 512 // 64 == PAIR_THREADS // PAIR_C


def _cpp_ternary(expr, env):
    """A C++ expression with at most one ``a ? b : c`` at its top, as
    Python (integer division) evaluated in ``env``."""
    expr = expr.replace(" / ", " // ")
    m = re.fullmatch(r"(.+?) \? (.+?) : (.+)", expr)
    py = f"(({m.group(2)}) if ({m.group(1)}) else ({m.group(3)}))" if m else expr
    return eval(py, {"__builtins__": {}}, env)  # noqa: S307


def _cpp_pair_area(prec):
    """``pair_area_floats(prec)`` of the source (with ``wg_operand_floats``
    of the header), evaluated at ``prec`` (0 kF32, 2 kBf16)."""
    consts = {"kHalfTileF": 32 * 64, "kTileF": 64 * 64, "kF32": 0}
    header = (CSRC / "odefunc_common.cuh").read_text()
    m = re.search(r"constexpr int wg_operand_floats\(int nwg, int prec\) "
                  r"\{\s*return (.*?);\s*\}", header, re.S)
    operand = " ".join(m.group(1).split())
    expr = _cpp(r"constexpr int pair_area_floats\(int prec\) \{\s*"
                r"return (.*?);\s*\}")
    env = dict(consts, prec=prec, wg_operand_floats=lambda nwg, p: (
        _cpp_ternary(operand, dict(consts, nwg=nwg, prec=p))))
    return _cpp_ternary(expr, env)


@pytest.mark.parametrize("hw,precision", [
    pytest.param((7, 7), "f32", id="hw0"), pytest.param((6, 6), "f32", id="hw1"),
    pytest.param((5, 5), "f32", id="hw2"),
    pytest.param((7, 7), "bf16", id="hw0-bf16"),
    pytest.param((6, 6), "bf16", id="hw1-bf16")])
def test_cluster_smem_follows_pair_smem_bytes(hw, precision):
    """``cluster_smem_bytes`` is ``pair_smem_bytes`` of the source,
    evaluated on the shape's rows and pitch (the tensor-core stage's) and
    the build's weight area (``pair_area_floats``: the TF32 heads and tails,
    or the bf16 tile, beside the f32 tile and two mbarriers)."""
    expr = _cpp(r"inline size_t pair_smem_bytes\(const Shape& s, int prec\) "
                r"\{\s*return (.*?);\s*\}")
    py = re.sub(r"\(size_t\)", "", expr).replace("sizeof(float)", "4")
    py = py.replace("s.", "s_")
    prec = {"f32": 0, "bf16": 2}[precision]
    area = _cpp_pair_area(prec)
    assert area == pair_area_floats(precision) == (
        {"f32": 2 * 2048, "bf16": 1024}[precision] + 4096 + 4)
    hh, ww = hw
    for g in (2, 4, 8, 16, 32, 64):
        env = {"kPairThreads": 256, "kPairC": 32, "prec": prec,
               "pair_area_floats": lambda p: _cpp_pair_area(p),
               "s_R": 64 + 2 * (ww + 2) + 2, "s_P": 72,
               "s_H": hh, "s_W": ww, "s_G": g, "s_C": 64}
        assert eval(py, {"__builtins__": {}}, env) == cluster_smem_bytes(  # noqa: S307
            hw, 64, g, precision)


def test_two_or_more_ctas_fit_per_sm():
    """At 7×7×64 and 6×6×64 a cluster CTA's shared memory (72,976 and
    69,072 bytes; the bf16 build's 60,688 and 56,784, its weight area a
    bf16 tile in place of the TF32 heads and tails; against the one-CTA
    pass's 110,720 and 103,488) and its reserved kilobyte fit two CTAs in an
    SM's 228 KB (three by shared memory alone), and the launch bounds ask
    for two CTAs of 256 threads: at most 128 registers a thread of the SM's
    65,536."""
    sizes = {hw: cluster_smem_bytes(hw, 64, 32) for hw in ((7, 7), (6, 6))}
    assert sizes == {(7, 7): 72976, (6, 6): 69072}
    sizes16 = {hw: cluster_smem_bytes(hw, 64, 32, "bf16")
               for hw in ((7, 7), (6, 6))}
    assert sizes16 == {(7, 7): 60688, (6, 6): 56784}
    for hw, nbytes in (*sizes.items(), *sizes16.items()):
        assert 3 * (nbytes + 1024) <= 228 * 1024
        assert nbytes <= MAX_SMEM
    assert (bwd_smem_bytes((7, 7), 64, 32), bwd_smem_bytes((6, 6), 64, 32)) == (
        layout((7, 7), 64, 32, backward=True).smem, 103488) == (110720, 103488)
    src = " ".join(SOURCE.read_text().split())
    assert "__cluster_dims__(2, 1, 1) __launch_bounds__(kPairThreads, 2)" in src
    assert 65536 // (2 * PAIR_THREADS) == 128


def test_the_cpu_wrapper_runs_the_plain_version():
    """On CPU tensors the backward is its plain version, whatever pass the
    card would run."""
    from neural_ode_features_tpu_torch.models import ModelConfig, init_odenet

    params = init_odenet(7, ModelConfig(in_channels=3, hidden=64, groups=32),
                         device="cpu")["odefunc"]
    w = prepare(params, (7, 7))
    rng = np.random.default_rng(2)
    h = torch.from_numpy(rng.normal(size=(2, 7, 7, 64)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 7, 7, 64)).astype(np.float32))
    got = odefunc_bwd(w, 0.3, h, g, groups=32)
    want = odefunc_bwd_plain(w, 0.3, h, g, 32)
    assert torch.equal(got[2], want[2]) and torch.equal(got[1], want[1])


def test_graph_route_counts_either_pass():
    """On the graph route a replay counts ``odefunc_bwd`` launches from the
    captured graph's kernel nodes by mangled name and build: one per node
    of either per-sample pass, each pass's build read from its precision
    template argument (``...25bwd_sample_kernel_clusterILi0EE...`` the f32
    build, ``ILi2EE`` the bf16 build's, counted in ``launches_bf16``), none
    of the weight and reduction kernels."""
    import collections

    from neural_ode_features_tpu_torch.solver import attempt_graph

    nodes = collections.Counter({
        "_ZN5nodef25bwd_sample_kernel_clusterILi0EEEvPKfS2_S2_NS_7OdefuncE": 3,
        "_ZN5nodef25bwd_sample_kernel_clusterILi2EEEvPKfS2_S2_NS_7OdefuncE": 11,
        "_ZN5nodef17bwd_sample_kernelILb0ELb0ELi0EEEvPKfS2_S2_NS_7OdefuncE": 2,
        "_ZN5nodef17bwd_sample_kernelILb0ELb0ELi2EEEvPKfS2_S2_NS_7OdefuncE": 7,
        "_ZN5nodef17bwd_weight_kernelILi64ELb0EEEvPKfS2_S2_S2_NS_5ShapeEiiPf": 5,
        "_ZN5nodef17bwd_weight_kernelILi64ELb1EEEvPKfS2_S2_S2_NS_5ShapeEiiPf": 5,
        "_ZN5nodef17bwd_reduce_kernelILb0EEEvPKfS2_NS_5ShapeEiiPfS3_S3_": 5,
    })
    rules = {(w.__name__, attr): kernels for w, attr, kernels
             in attempt_graph._kernel_wrappers()}
    f32 = rules[("odefunc_bwd", "launches")]
    bf16 = rules[("odefunc_bwd", "launches_bf16")]
    assert attempt_graph._count(nodes, f32) == 5
    assert attempt_graph._count(nodes, bf16) == 18
    src = " ".join(SOURCE.read_text().split())
    assert ("__global__ void __cluster_dims__(2, 1, 1) "
            "__launch_bounds__(kPairThreads, 2) bwd_sample_kernel_cluster(") in src
