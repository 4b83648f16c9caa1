"""The bf16 ODEfunc at C = 96 to 512 on the rows conv (``csrc/rows_conv.cuh``,
the ``'rows_bf16'`` build of ``csrc/odefunc.cu``) and the probe's rows
strategies past C = 128, on the CPU: the kernel's order of sums emulated
tile by tile against the per-sample bf16 stage's (``mma_bf16``) bit for
bit, the Python mirrors of the C++ gates, shared memory, scratch and tile
rule read from the sources, the stage names, a plain mirror of the rows
build's launch sequence against the plain bf16 path, the graph route's
count of the build, and a bf16 solve at hidden 96 against the JAX package.
The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import collections
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.models import ModelConfig as JaxModelConfig
from neural_ode_features_tpu.models import init_odenet as jax_init_odenet
from neural_ode_features_tpu.models import odenet_logits as jax_odenet_logits
from neural_ode_features_tpu_torch.kernels import conv3x3 as conv_mod
from neural_ode_features_tpu_torch.kernels import odefunc as odefunc_mod
from neural_ode_features_tpu_torch.kernels.conv3x3 import (
    conv3x3,
    conv3x3_plain,
    conv3x3_wgmma_emulated,
    im2col_wgmma_emulated,
    rows_pack_bytes,
    rows_scratch_bytes,
    rows_smem_bytes,
    rows_tile_rows,
    rows_wgmma_emulated,
    rows_wide,
    supported,
    tap9_wgmma_emulated,
)
from neural_ode_features_tpu_torch.kernels.odefunc import (
    bf16_round,
    mma_ok,
    odefunc,
    odefunc_plain,
    prepare,
    rows_gn_smem_bytes,
    rows_slice_threads,
    rows_slices,
    stage,
)
from neural_ode_features_tpu_torch.models import ModelConfig, init_odenet
from neural_ode_features_tpu_torch.models import odenet_logits
from neural_ode_features_tpu_torch.probes.timing_aids import odefunc_cta_bf16
from neural_ode_features_tpu_torch.solver import attempt_graph
from neural_ode_features_tpu_torch.utils import from_jax_params

torch.set_num_threads(2)

CSRC = Path(odefunc_mod.__file__).resolve().parent.parent / "csrc"
U = 2.0 ** -8
# The rows build's plain mirror against the CPU's plain bf16 f, in u of each
# row's max-norm: the kernel's rounding points (the conv output rounded
# before the bias add), twice tests/test_torch_bf16_kernels.py's
# ODEFUNC_U_BAR, as that file's 'separate' case.
ROWS_U_BAR = 2 * 4.0
LOGIT_ATOL = 5e-3   # tests/test_torch_bf16.py: about u at |logits| < 1
EPS = 1e-5          # GroupNorm's epsilon (csrc/odefunc_common.cuh kEps)
WIDE = (96, 128, 192, 512)


def _draw(b, hw, c, seed=0):
    rng = np.random.default_rng(seed + c)
    x = rng.normal(size=(b, *hw, c)).astype(np.float32)
    w = (rng.normal(size=(3, 3, c, c)) / np.sqrt(9 * c)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


# ---- the order of sums ------------------------------------------------------


@pytest.mark.parametrize("hw", [(7, 7), (6, 6)])
@pytest.mark.parametrize("c", WIDE)
def test_rows_order_is_the_per_sample_stages(hw, c):
    """The rows conv's arithmetic (per stage, one tap's 64 input channels,
    and k half a chain of two k16 steps from zero, the halves' running sums
    added last) equals ``conv3x3_wgmma_emulated(precision='bf16')``, the
    per-sample ``mma_bf16`` stage's order, bit for bit; neither the M tile
    (64 or 128 rows, or 49: one sample) nor the N tile (64 or 128 columns)
    changes a sum."""
    x, w = _draw(2, hw, c)
    want = conv3x3_wgmma_emulated(x, w, precision="bf16")
    for tile_rows, tile_cols in ((64, 128), (128, 128), (128, 64), (49, 64)):
        assert torch.equal(rows_wgmma_emulated(x, w, True, tile_rows,
                                               tile_cols), want)
    assert torch.equal(tap9_wgmma_emulated(x, w), want)
    close = conv3x3_plain(x, w, passes="bf16")
    assert torch.allclose(want, close, rtol=1e-5, atol=1e-6)
    assert not torch.equal(want, conv3x3_plain(x, w))  # the bf16 operands


@pytest.mark.parametrize("c", [128, 192, 512])
def test_im2col_stages_are_the_taps_at_whole_blocks(c):
    """At C % 64 == 0 a stage of 64 k of K = 9C is one tap's 64-channel
    block: ``im2col_bf16`` on the rows kernel gives ``tap9_bf16``'s bits,
    and ``im2col_wgmma_emulated``'s."""
    x, w = _draw(2, (7, 7), c, seed=1)
    want = rows_wgmma_emulated(x, w, True)
    assert torch.equal(rows_wgmma_emulated(x, w, False), want)
    assert torch.equal(im2col_wgmma_emulated(x, w), want)


def test_im2col_stages_span_taps_past_whole_blocks():
    """At C = 96 a stage of ``im2col_bf16`` spans two taps: the rows
    kernel's im2col order is ``im2col_wgmma_emulated``'s, at every tile."""
    x, w = _draw(2, (7, 7), 96, seed=2)
    want = im2col_wgmma_emulated(x, w)
    for tile_rows in (64, 128):
        assert torch.equal(rows_wgmma_emulated(x, w, False, tile_rows), want)


# ---- the C++ mirrors --------------------------------------------------------


def _cpp_function(source: str, signature: str):
    """The ``return`` expression of a one-line C++ function of ``source``
    as a Python expression (integer division, ``&&``, one ternary)."""
    text = (CSRC / source).read_text()
    m = re.search(re.escape(signature) + r"\s*\{\s*return (.*?);\s*\}", text,
                  re.S)
    assert m, f"{signature} not found in {source}"
    expr = " ".join(m.group(1).split())
    expr = re.sub(r"\((long long|size_t)\)", "", expr).replace("nodef::", "")
    expr = (expr.replace("&&", " and ").replace("||", " or ")
            .replace("1LL", "1").replace("2LL", "2").replace("/", "//"))
    if "?" in expr:
        cond, rest = expr.split("?", 1)
        a, b = rest.split(":", 1)
        expr = f"(({a}) if ({cond}) else ({b}))"
    return expr


def _cpp_namespace():
    """The rows kernel's C++ helpers, evaluated from their sources."""
    ns = {"kMmaC": 64, "kMaxC": 512}
    for name in ("kRowsK", "kRowsNB", "kRowsPerSlot"):
        ns[name] = int(re.search(rf"constexpr int {name} = (\d+);",
                                 (CSRC / "rows_conv.cuh").read_text())
                       .group(1))
    slice_expr = re.search(r"constexpr int kRowsSlice = ([^;]+);",
                           (CSRC / "rows_conv.cuh").read_text()).group(1)
    ns["kRowsSlice"] = eval(slice_expr, {}, dict(ns))  # noqa: S307
    funcs = {
        "rows_stages": ("rows_conv.cuh", "constexpr int rows_stages(bool tap, "
                        "int C)", "tap, C"),
        "rows_ntiles": ("rows_conv.cuh", "constexpr int rows_ntiles(int C)",
                        "C"),
        "rows_ring": ("rows_conv.cuh", "constexpr int rows_ring(int mw)",
                      "mw"),
        "rows_pack_bytes": ("rows_conv.cuh", "inline size_t rows_pack_bytes("
                            "bool tap, int C)", "tap, C"),
        "rows_smem_bytes": ("rows_conv.cuh", "inline size_t rows_smem_bytes("
                            "int mw)", "mw"),
        "rows_tile_rows": ("rows_conv.cuh", "inline int rows_tile_rows(int "
                           "rows, int C, int sms)", "rows, C, sms"),
        "rows_ok": ("rows_conv.cuh", "inline bool rows_ok(int B, int H, int "
                    "W, int C)", "B, H, W, C"),
        "rows_scratch_bytes": ("rows_conv.cuh", "inline size_t "
                               "rows_scratch_bytes(int B, int H, int W, int "
                               "C, bool tap)", "B, H, W, C, tap"),
    }
    for name, (source, signature, args) in funcs.items():
        ns[name] = eval(  # noqa: S307
            f"lambda {args}: {_cpp_function(source, signature)}", ns)
    ns["true"] = True
    return ns


def test_the_constants_are_mirrored():
    """kernels/odefunc.py and kernels/conv3x3.py against the C++ of
    ``csrc/rows_conv.cuh``: the stage depth, N tile and slice, the ring and
    shared memory of both tiles, the packed weights and a call's scratch of
    both stage kinds, the tile rule and the gate; and the ODEfunc build's
    and the probe's entries size their scratch by it."""
    cpp = _cpp_namespace()
    assert (cpp["kRowsK"], cpp["kRowsNB"], cpp["kRowsSlice"],
            cpp["kRowsPerSlot"]) == (odefunc_mod.ROWS_K, odefunc_mod.ROWS_NB,
                                     odefunc_mod.ROWS_SLICE,
                                     conv_mod.ROWS_PER_SLOT)
    for tile in (64, 128):
        assert cpp["rows_ring"](tile // 64) == conv_mod.ROWS_RING[tile]
        assert cpp["rows_smem_bytes"](tile // 64) == rows_smem_bytes(tile)
        assert rows_smem_bytes(tile) <= odefunc_mod.MAX_SMEM
    # Two 64-row CTAs share an SM (228 KB, 1 KB reserved a CTA).
    assert 2 * (rows_smem_bytes(64) + 1024) <= 228 * 1024
    for c in range(72, 513, 8):
        for tap in (True, False):
            assert cpp["rows_pack_bytes"](tap, c) == rows_pack_bytes(tap, c)
            for b in (1, 5, 128, 256):
                for hw in ((7, 7), (6, 6)):
                    assert cpp["rows_scratch_bytes"](b, *hw, c, tap) == (
                        rows_scratch_bytes(b, hw, c, tap))
        for b in (1, 5, 128, 256):
            for sms in (132, 114):
                rows = b * 49
                assert cpp["rows_tile_rows"](rows, c, sms) == rows_tile_rows(
                    rows, sms, c)
    for c in list(range(4, 600, 4)) + [0, 1]:
        for hw in ((7, 7), (1, 1), (32, 32), (2, 300)):
            assert (bool(cpp["rows_ok"](3, *hw, c))
                    == (rows_wide(c) and hw[0] >= 1)), (hw, c)
    assert not cpp["rows_ok"](2 ** 20, 64, 64, 64 + 8)
    # At 7x7x512, B = 256: four N tiles of 72 stages of 16 KB each; the
    # 128-row tile on 132 SMs.
    assert rows_pack_bytes(True, 512) == 4 * 72 * 16384
    assert odefunc_mod.rows_scratch_bytes is rows_scratch_bytes
    src = " ".join((CSRC / "odefunc.cu").read_text().split())
    assert "rows_scratch_bytes(B, H, W, C, true)" in src
    src = " ".join((CSRC / "conv_probe.cu").read_text().split())
    assert "rows_scratch_bytes(B, H, W, C, tap)" in src
    assert rows_tile_rows(256 * 49, 132, 512) == 128
    assert rows_tile_rows(256 * 49, 132, 96) == 128
    assert rows_tile_rows(128 * 49, 132, 96) == 64
    assert rows_tile_rows(5 * 49, 132, 512) == 64


def test_rows_build_gate_is_the_stage_name():
    """``stage(hw, c, 'bf16')`` names the rows build exactly where the C++
    ``rows_build_ok`` (a tensor-core shape past C = 64) holds; the f32
    builds and the fused step's ``'bf16_conv'`` keep their stages."""
    src = " ".join((CSRC / "odefunc.cu").read_text().split())
    assert ("inline bool rows_build_ok(int H, int W, int C, int G) { return "
            "shape_ok(H, W, C, G) && wide_shape(make_shape(H, W, C, G)); }"
            ) in src
    assert ("if (nodef::rows_build_ok(H, W, C, G)) return nodef::launch_rows("
            ) in src
    for hw in ((7, 7), (6, 6), (5, 5), (1, 62), (8, 8)):
        for c in range(32, 545, 32):
            rows = mma_ok(hw, c) and c > 64
            assert (stage(hw, c, "bf16") == "rows_bf16") == rows, (hw, c)
            # Where the kernels refuse the shape (1x62 past C = 192: the
            # per-sample layout does not fit) the wrapper raises first.
            rows = rows and odefunc_mod.supported(hw, c, 32)
            assert stage(hw, c, "f32") != "rows_bf16"
            assert stage(hw, c, "bf16_conv") != "rows_bf16"
            if rows:
                assert stage(hw, c, "bf16_conv") == stage(hw, c) == "mma3"
                assert rows_wide(c)
    assert stage((7, 7), 64, "bf16") == "wgmma_bf16"
    assert stage((7, 7), 32, "bf16") == "ffma"


def test_probe_gate_widens_to_512():
    """The probe's rows strategies take C = 72 to 512 at C % 8 == 0 on the
    rows kernel, beside the window kernel's shapes, and nothing past 512."""
    for strategy in ("tap9_bf16", "im2col_bf16"):
        for c in (96, 136, 256, 320, 480, 512):
            assert supported((7, 7), c, strategy)
            assert supported((6, 6), c, strategy)
            assert supported((14, 14), c, strategy)
        for c in (516, 520, 132, 260):
            assert not supported((7, 7), c, strategy)
        assert supported((7, 7), 100, strategy)   # the window kernel


# ---- the ODEfunc build ------------------------------------------------------


def _gn_bf16(x, scale, bias, groups):
    """The bf16 dynamics' GroupNorm as the kernels compute it: statistics of
    the f32 values (the centred variance), then the normalised value, its
    scale product and its bias sum each rounded to bf16."""
    b, hh, ww, c = x.shape
    xg = x.reshape(b, hh * ww, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    inv = 1.0 / torch.sqrt(var + EPS)
    hat = bf16_round(((xg - mean) * inv).reshape(x.shape))
    return bf16_round(bf16_round(hat * bf16_round(scale)) + bf16_round(bias))


def _rows_build_mirror(w, t, h, groups, conv_sums=rows_wgmma_emulated):
    """The rows build's launch sequence in plain PyTorch: (a) h rounded, GN1
    → ReLU, the conv input in bf16; (b) conv1 in the rows order
    (``rows_wgmma_emulated``), its epilogue the bf16 ``concat_out`` (the
    conv output, its bias sum, t·M and the last sum rounded, t rounded); (c)
    GN2 → ReLU; (d) conv2; (e) GN3.  ``conv_sums``: the conv's order of
    sums."""
    tb = bf16_round(t.float()).reshape(-1, 1, 1, 1)

    def conv(x, k, bias, tmap):
        acc = conv_sums(x, k)
        return bf16_round(bf16_round(bf16_round(acc) + bf16_round(bias))
                          + bf16_round(tb * bf16_round(tmap)))

    x = torch.relu(_gn_bf16(bf16_round(h), w.n1s, w.n1b, groups))
    u1 = conv(x, w.w1, w.b1, w.m1)
    x = torch.relu(_gn_bf16(u1, w.n2s, w.n2b, groups))
    u2 = conv(x, w.w2, w.b2, w.m2)
    return _gn_bf16(u2, w.n3s, w.n3b, groups)


@pytest.mark.parametrize("hw", [(7, 7), (6, 6)])
def test_the_rows_sequence_is_the_bf16_dynamics(hw):
    """The plain mirror of the rows build's seven launches against the CPU's
    plain bf16 f (``odefunc_plain(precision='bf16')``) within ``ROWS_U_BAR``
    u of each row's max-norm at hidden 96, B = 3; and equal, bit for bit,
    to the same sequence with the per-sample build's conv order
    (``conv3x3_wgmma_emulated(precision='bf16')``: the rows build gives the
    per-sample build's f)."""
    cfg = ModelConfig(in_channels=3, hidden=96)
    w = prepare(init_odenet(3, cfg, device="cpu")["odefunc"], hw)
    rng = np.random.default_rng(4)
    h = torch.from_numpy((rng.normal(size=(3, *hw, 96)) * 0.5).astype(
        np.float32))
    t = torch.from_numpy(rng.uniform(0, 1, 3).astype(np.float32))

    def u_per_row(got, want):
        d = (got - want).abs().flatten(1).amax(1)
        return float((d / (U * want.abs().flatten(1).amax(1))).max())

    got = _rows_build_mirror(w, t, h, cfg.groups)
    err = u_per_row(got, odefunc_plain(w, t, h, cfg.groups, "bf16"))
    assert 0.0 < err <= ROWS_U_BAR, err
    per_sample = _rows_build_mirror(
        w, t, h, cfg.groups,
        lambda x, k: conv3x3_wgmma_emulated(x, k, precision="bf16"))
    assert torch.equal(got, per_sample)


def test_cpu_calls_take_the_plain_versions():
    """On CPU tensors the bf16 ``odefunc`` at a rows-build width is the plain
    bf16 f and the probe's rows strategies at C = 256 the plain bf16 conv,
    nothing launched; their tile argument on the rows kernel is 64 or 128;
    the per-sample reading refuses a CPU tensor."""
    cfg = ModelConfig(in_channels=3, hidden=128)
    p = init_odenet(5, cfg, device="cpu")["odefunc"]
    h = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 7, 7, 128)).astype(np.float32))
    t = torch.tensor([0.25, 0.5])
    before = odefunc.launches_bf16, conv3x3.launches
    got = odefunc(p, t, h, compute_dtype=torch.bfloat16)
    assert torch.equal(got, odefunc_plain(prepare(p, (7, 7)), t, h, 32,
                                          "bf16"))
    x, w = _draw(1, (7, 7), 256, seed=3)
    want = conv3x3_plain(x, w, passes="bf16")
    for strategy in ("tap9_bf16", "im2col_bf16"):
        for tile_rows in (None, 64, 128):
            assert torch.equal(conv3x3(x, w, strategy, tile_rows=tile_rows),
                               want)
        with pytest.raises(ValueError, match="tile_rows"):
            conv3x3(x, w, strategy, tile_rows=96)
    assert (odefunc.launches_bf16, conv3x3.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        odefunc_cta_bf16(p, t, h)


def test_graph_route_counts_one_launch_a_rows_call():
    """A captured graph holds seven kernel nodes per call of the rows build
    (two weight packs, two ReLU GroupNorms, two convs, the last GroupNorm);
    the route counts the call once, by its last kernel, in
    ``odefunc.launches_bf16``, beside the per-sample bf16 kernel's nodes,
    and nothing of it in the f32 counter."""
    per_call = {
        "_ZN5nodef16rows_pack_kernelILb1EEEvPKfiPh": 2,
        "_ZN5nodef19rows_gn_relu_kernelEPKfS1_S1_NS_5ShapeEPt": 2,
        "_ZN5nodef16rows_conv_kernelILb1ELi2ENS_9ConcatEpiEEEvPKtPKhiiiiT1_":
            2,
        "_ZN5nodef18rows_gn_out_kernelEPKfS1_S1_NS_5ShapeEPf": 1,
    }
    nodes = collections.Counter({k: 3 * v for k, v in per_call.items()})
    nodes["_ZN5nodef14odefunc_kernelILb0ELb0ELi2EEEvPKfS2_NS_7OdefuncENS_5"
          "ShapeEPf"] = 4
    nodes["_ZN5nodef14odefunc_kernelILb0ELb0ELi0EEEvPKfS2_NS_7OdefuncENS_5"
          "ShapeEPf"] = 5
    rules = {(w.__name__, attr): kernels for w, attr, kernels
             in attempt_graph._kernel_wrappers()}
    assert attempt_graph._count(nodes, rules[("odefunc", "launches_bf16")]) == 7
    assert attempt_graph._count(nodes, rules[("odefunc", "launches")]) == 5
    src = (CSRC / "odefunc.cu").read_text()
    assert src.count("rows_gn_out_kernel<<<") == 1


# ---- the per-sample GroupNorm launches, a sample over several CTAs ---------


def _rows_shapes():
    """Every shape of the rows build on 7x7 and 6x6 maps with 32 groups."""
    return [(hw, c) for hw in ((7, 7), (6, 6)) for c in range(96, 513, 32)
            if stage(hw, c, "bf16") == "rows_bf16"
            and odefunc_mod.supported(hw, c, 32)]


def test_slices_hold_whole_groups_and_the_one_cta_slots():
    """At every rows-build shape (7x7 and 6x6, C = 96 to 512, 32 groups)
    the launches' slices (``rows_slices``: 4 CTAs a sample) each hold whole
    GroupNorm groups, start on a 16-byte boundary, and give their CTA's
    threads the one-CTA map's (pixel group, channel) slots restricted to
    their channels (thread j: ``(j // cs, c0 + j % cs)``), one a thread;
    the slices cover the channels once."""
    shapes = _rows_shapes()
    assert len(shapes) == 2 * 14
    for hw, c in shapes:
        n, threads = rows_slices(32), rows_slice_threads(32)
        assert (n, threads) == (4, 128)
        cs, gs, npg = c // n, c // 32, odefunc_mod.THREADS // c
        full = {(t // c, t % c) for t in range(npg * c)}  # pg < npg
        seen = []
        for k in range(n):
            c0 = k * cs
            assert c0 % gs == 0 and cs % gs == 0  # whole groups
            assert (4 * c0) % 16 == 0 and cs % 4 == 0  # 16-byte vectors
            slots = [(j // cs, c0 + j % cs) for j in range(npg * cs)]
            assert len(slots) <= threads
            assert set(slots) == {(pg, ch) for pg, ch in full
                                  if c0 <= ch < c0 + cs}
            seen += range(c0, c0 + cs)
        assert seen == list(range(c))
    # Fewer slices where the group count does not split in four.
    assert [rows_slices(g) for g in (32, 16, 8, 4, 6, 2, 3, 1)] == [
        4, 4, 4, 4, 2, 2, 1, 1]


def _bf16(x):
    """x rounded to bf16 (to nearest even), as float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _fma(a, b, c):
    """fmaf(a, b, c) in numpy: a·b exact in float64, the sum rounded to
    float32 (both orders below take the same function)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _chain(step, pg, ch, npg, hw):
    """Per slot (pg, ch) the sum ``acc = step(acc, p, ch)`` over the pixels
    p = pg, pg + npg, ... in order, from 0 (float32)."""
    acc = np.zeros(len(pg), np.float32)
    for k in range(-(-hw // npg)):
        p = pg + k * npg
        m = p < hw
        acc[m] = step(acc[m], p[m], ch[m])
    return acc


def _stats(x, c, groups, order):
    """GroupNorm's mean and inv of one sample x (H*W, C), x rounded to bf16
    as the launches read it, by gn_stats' sums: ``order`` 'cta', the
    one-CTA map (thread pg*C + c, partials at q*C + g*gs + j), or 'sliced',
    each slice's CTA (thread j = pg*cs + cl, partials at q*cs + gl*gs + j)
    with its groups' results placed by channel."""
    hw, gs = x.shape[0], c // groups
    npg, n = odefunc_mod.THREADS // c, np.float32(hw * gs)
    xb = _bf16(x)
    parts = [(0, c)] if order == "cta" else [
        (k * (c // rows_slices(groups)), c // rows_slices(groups))
        for k in range(rows_slices(groups))]
    mean = np.zeros(groups, np.float32)
    inv = np.zeros(groups, np.float32)
    for c0, cs in parts:
        j = np.arange(npg * cs)
        pg, ch = j // cs, c0 + j % cs
        ng, g0 = cs // gs, c0 // gs

        def tot(red):
            out = np.zeros(ng, np.float32)
            for q in range(npg):
                for jj in range(gs):
                    out = out + red[q * cs + np.arange(ng) * gs + jj]
            return out

        red = _chain(lambda a, p, cc: a + xb[p, cc], pg, ch, npg, hw)
        mu = tot(red) / n
        red2 = _chain(lambda a, p, cc: _fma(xb[p, cc] - mu[cc // gs - g0],
                                            xb[p, cc] - mu[cc // gs - g0], a),
                      pg, ch, npg, hw)
        iv = np.float32(1) / np.sqrt(tot(red2) / n + np.float32(EPS))
        mean[g0:g0 + ng], inv[g0:g0 + ng] = mu, iv
    return mean, inv


@pytest.mark.parametrize("hw,c", [((7, 7), 96), ((7, 7), 160), ((6, 6), 192),
                                  ((7, 7), 320), ((6, 6), 512),
                                  ((7, 7), 512)])
def test_sliced_statistics_are_the_one_cta_order(hw, c):
    """A numpy float32 emulation of the GroupNorm statistics (the rows
    forward's three launches and the backward's recompute and GN3): the
    slices' sums equal the one-CTA map's bit for bit on seeded inputs,
    also where C does not divide 512 (96, 160, 320: npg 5, 3, 1), and lie
    near float64's."""
    rng = np.random.default_rng(c + hw[0])
    x = (rng.normal(size=(hw[0] * hw[1], c)) * 0.7 + 0.2).astype(np.float32)
    want = _stats(x, c, 32, "cta")
    got = _stats(x, c, 32, "sliced")
    for a, b in zip(got, want):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    xg = _bf16(x).astype(np.float64).reshape(-1, 32, c // 32)
    np.testing.assert_allclose(want[0], xg.mean(axis=(0, 2)), rtol=1e-5,
                               atol=1e-6)


def test_the_emulated_statistics_order_is_the_sources():
    """The order ``_stats`` emulates is the one the sources hold, so that a
    kernel edit that changes it fails here: the one-CTA ``gn_stats``
    (``odefunc_common.cuh``: a slot's chain over its pixels at partial
    ``pg * C + c``, then q-major over the group's channels) and the
    slices' ``slice_stats`` (``rows_conv.cuh``: the full map's npg, slot
    ``tid = pg * cs + cl``, the same chain, partials at ``q * cs + j0 +
    j`` q-major), each for the mean and the variance."""
    common = (CSRC / "odefunc_common.cuh").read_text()
    assert ("    for (int p = pg; p < hw; p += npg) acc += x[p * C + c];\n"
            "  m.sred[tid] = acc;  // tid == pg * C + c\n") in common
    for red in ("m.sred", "red2"):
        assert ("    for (int q = 0; q < npg; ++q)\n"
                f"      for (int j = 0; j < gs; ++j) tot += {red}[q * C + g0"
                " + j];\n") in common
    rows = (CSRC / "rows_conv.cuh").read_text()
    body = rows[rows.index("__device__ void slice_stats("):]
    body = body[:body.index("\n}\n")]
    assert "const int tid = threadIdx.x, npg = s.npg, cs = sl.cs;" in body
    assert ("  sl.pg = div_magic(tid << ln, s.cmagic);  // tid / cs\n"
            "  sl.cl = tid - sl.pg * sl.cs;\n") in rows
    assert "const int gl = div_magic(sl.cl, s.gmagic), j0 = gl * s.gs;" in body
    assert body.count("    for (int p = sl.pg; p < sl.hw; p += npg) {\n") == 2
    assert "      acc += xs[p * cs + sl.cl];\n" in body
    assert "      acc = fmaf(d, d, acc);\n" in body
    assert "  red[tid] = acc;\n" in body and "  red2[tid] = acc;\n" in body
    for red in ("red", "red2"):
        assert ("    for (int q = 0; q < npg; ++q)\n"
                f"      for (int j = 0; j < s.gs; ++j) tot += {red}[q * cs + "
                "j0 + j];\n") in body


def test_the_slice_launches_are_mirrored():
    """``csrc/rows_conv.cuh``'s slice count, its rule, the CTA's threads and
    a GroupNorm launch's shared memory against ``kernels/odefunc.py``; the
    rows build launches its three GroupNorms on that grid (B times the
    slices, the slice's threads) and shared memory."""
    src = (CSRC / "rows_conv.cuh").read_text()
    assert int(re.search(r"constexpr int kRowsSlices = (\d+);", src)
               .group(1)) == odefunc_mod.ROWS_SLICES
    assert ("  int n = kRowsSlices;\n  while (n > 1 && G % n) n >>= 1;\n"
            "  return n;\n") in src
    ns = {"kThreads": odefunc_mod.THREADS, "rows_slices": rows_slices}
    threads = eval("lambda G: " + _cpp_function(  # noqa: S307
        "rows_conv.cuh", "inline int rows_slice_threads(int G)"), ns)
    smem = eval("lambda H, W, C, G: " + _cpp_function(  # noqa: S307
        "rows_conv.cuh", "inline size_t rows_gn_smem_bytes(const Shape& s)")
        .replace("sizeof(float)", "4").replace("s.", ""),
        {**ns, "rows_slice_threads": rows_slice_threads})
    for groups in (32, 16, 6, 3):
        assert threads(groups) == rows_slice_threads(groups)
    for hw, c in _rows_shapes():
        for groups in (32, 16, c // 3 if c % 3 == 0 else 32):
            assert smem(*hw, c, groups) == rows_gn_smem_bytes(hw, c, groups)
            assert rows_gn_smem_bytes(hw, c, groups) <= odefunc_mod.MAX_SMEM
    assert rows_gn_smem_bytes((7, 7), 512, 32) == 26_176
    assert 8 * (26_176 + 1024) <= 228 * 1024  # eight CTAs an SM
    body = " ".join((CSRC / "odefunc.cu").read_text().split())
    assert ("const int gb = B * rows_slices(G), gt = rows_slice_threads(G);"
            in body)
    assert body.count("<<<gb, gt, gsm, st>>>") == 2  # in a loop of two, and GN3


# ---- against the JAX package ------------------------------------------------


def test_bf16_solve_at_hidden_96_matches_jax():
    """A bf16 block solve at hidden 96 (the MNIST model's 6×6×96, where the
    card runs the rows build) through the JAX jnp path and the port on the
    CPU, the same parameters and input: equal per-sample NFE, logits within
    ``LOGIT_ATOL`` (tests/test_torch_bf16.py's bar: about u at |logits| <
    1)."""
    jcfg = JaxModelConfig(in_channels=1, hidden=96, tol=1e-2,
                          compute_dtype="bfloat16")
    params_j = jax.device_get(jax_init_odenet(jax.random.PRNGKey(2), jcfg))
    x = np.random.default_rng(1).normal(size=(4, 28, 28, 1)).astype(
        np.float32)
    logits_j, stats_j = jax.jit(
        lambda p, xx: jax_odenet_logits(p, xx, jcfg))(params_j, x)
    cfg = ModelConfig(in_channels=1, hidden=96, tol=1e-2,
                      compute_dtype="bfloat16")
    logits, stats = odenet_logits(from_jax_params(params_j, device="cpu"),
                                  torch.from_numpy(x), cfg)
    assert stage((6, 6), 96, "bf16") == "rows_bf16"
    np.testing.assert_array_equal(stats.nfe.numpy(), np.asarray(stats_j.nfe))
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), rtol=0,
                               atol=LOGIT_ATOL)
