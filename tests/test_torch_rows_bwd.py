"""The bf16 ODEfunc backward at C = 96 to 512 on the rows conv (the rows
backward of ``csrc/odefunc_bwd.cu``: the recompute's two convs and both
input-gradient convs as bf16 ``wgmma`` GEMMs over the rows of every sample,
``csrc/rows_conv.cuh`` with its transposed packing) on the CPU: the
transposed packing's order of sums emulated tile by tile against the
per-sample pass's transposed ``mma_bf16`` stage bit for bit, a plain mirror
of the rows backward's launch sequence against the plain bf16 VJP, the
port's bf16 VJP at hidden 96 against ``jax.vjp`` of the JAX jnp bf16
dynamics, the Python mirrors of the C++ gate, shared memory and scratch
read from the source, and the graph route's count of a call.  The kernels
themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import collections
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.models import ModelConfig as JaxConfig
from neural_ode_features_tpu.models import init_odenet as jax_init_odenet
from neural_ode_features_tpu.models.odenet import (
    odefunc_apply as jax_odefunc,
)
from neural_ode_features_tpu_torch.kernels import odefunc as odefunc_mod
from neural_ode_features_tpu_torch.kernels import odefunc_bwd as bwd_mod
from neural_ode_features_tpu_torch.kernels.conv3x3 import (
    conv3x3_wgmma_emulated,
    rows_wgmma_emulated,
)
from neural_ode_features_tpu_torch.kernels.odefunc import (
    MAX_SMEM,
    OdefuncWeights,
    bf16_round,
    prepare,
    rows_scratch_bytes,
    rows_slice_threads,
    rows_slices,
    stage,
    supported,
)
from neural_ode_features_tpu_torch.kernels.odefunc_bwd import (
    _raw_grads,
    bwd_supported,
    odefunc_bwd,
    odefunc_bwd_plain,
    rows_bwd_scratch_bytes,
    rows_bwd_slice_smem_bytes,
    rows_bwd_smem_bytes,
    sample_pass,
)
from neural_ode_features_tpu_torch.models import ModelConfig, init_odenet
from neural_ode_features_tpu_torch.ops import layers
from neural_ode_features_tpu_torch.probes import bf16_distances
from neural_ode_features_tpu_torch.probes.timing_aids import (
    odefunc_bwd_cta_bf16,
)
from neural_ode_features_tpu_torch.solver import attempt_graph
from neural_ode_features_tpu_torch.utils import from_jax_params

torch.set_num_threads(2)

CSRC = Path(odefunc_mod.__file__).resolve().parent.parent / "csrc"
EPS = 1e-5  # GroupNorm's epsilon (csrc/odefunc_common.cuh kEps)
# One input-gradient conv against the f32 conv of its rounded operands: the
# same exact products, summed in another order.
CONV_TOL = dict(rtol=1e-5, atol=1e-6)


def _draw(b, hw, c, seed=0):
    rng = np.random.default_rng(seed + c)
    x = rng.normal(size=(b, *hw, c)).astype(np.float32)
    w = (rng.normal(size=(3, 3, c, c)) / np.sqrt(9 * c)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


# ---- the transposed packing's order of sums --------------------------------


@pytest.mark.parametrize("hw", [(7, 7), (6, 6)])
@pytest.mark.parametrize("c", [96, 128, 512])
def test_transposed_rows_order_is_the_per_sample_stage(hw, c):
    """The rows conv with the transposed packing (stage (tap k, 64-channel
    block) from tap 8 − k's (C, C) tile transposed; per stage and k half a
    chain of two k16 steps from zero, the halves' running sums added last)
    equals ``conv3x3_wgmma_emulated(transposed=True, precision='bf16')``,
    the one-CTA pass's input-gradient stage (``mma_bf16`` with BT), bit for
    bit at every M and N tile (a k half past C adds a zero chain where
    ``mma_bf16`` skips it); it is the input gradient of the conv with the
    rounded weights, and not the forward packing's conv."""
    x, w = _draw(2, hw, c)
    want = conv3x3_wgmma_emulated(x, w, transposed=True, precision="bf16")
    tiles = ((64, 128), (128, 64)) if c == 512 else (
        (64, 128), (128, 128), (128, 64), (hw[0] * hw[1], 64))
    for tile_rows, tile_cols in tiles:
        assert torch.equal(rows_wgmma_emulated(
            x, w, True, tile_rows, tile_cols, transposed=True), want)
    nchw = bf16_round(x).permute(0, 3, 1, 2)
    grad = torch.nn.grad.conv2d_input(
        nchw.shape, bf16_round(w).permute(3, 2, 0, 1), nchw,
        padding=1).permute(0, 2, 3, 1)
    assert torch.allclose(want, grad, **CONV_TOL)
    assert not torch.equal(want, rows_wgmma_emulated(x, w))


def test_the_transposed_packing_has_one_tap_a_stage():
    """The transposed packing exists for the ODEfunc's stages (one tap's 64
    channels), not for the probe's stages of 64 k of K = 9C."""
    x, w = _draw(1, (7, 7), 96, seed=1)
    with pytest.raises(ValueError, match="one tap a stage"):
        rows_wgmma_emulated(x, w, tap=False, transposed=True)
    src = (CSRC / "rows_conv.cuh").read_text()
    assert ('static_assert(kTap || !kTrans, "the transposed packing has one '
            'tap a stage");') in src
    assert "w[((size_t)(8 - tap) * C + co) * C + ci]" in src


# ---- a plain mirror of the rows backward ------------------------------------


def _gn(x, scale, bias, groups):
    """The bf16 GroupNorm as the kernels compute it (statistics of the f32
    values, the centred variance; the normalised value, its scale product
    and its bias sum rounded): ``(y, x̂, inv)``."""
    b, hh, ww, c = x.shape
    shp = (b, hh, ww, groups, c // groups)
    d = x.reshape(shp) - x.reshape(shp).mean(dim=(1, 2, 4), keepdim=True)
    inv = torch.rsqrt((d * d).mean(dim=(1, 2, 4), keepdim=True) + EPS)
    xh = (d * inv).reshape(x.shape)
    y = bf16_round(bf16_round(bf16_round(xh) * bf16_round(scale))
                   + bf16_round(bias))
    return y, xh, inv


def _gn_bwd(dy, xh, inv, scale, groups):
    """One sample's GroupNorm backward at the bf16 build's rounding points
    (``gn_backward<kBf16>``): per sample dscale = Σ bf16(dy·bf16(x̂)), dbias
    = Σ dy; dy·scale rounded per element, the f32 statistics backward, dx
    rounded.  Returns dx and the per-sample partials (B, C)."""
    b, hh, ww, c = dy.shape
    shp = (b, hh, ww, groups, c // groups)
    dscale = bf16_round(dy * bf16_round(xh)).sum((1, 2))
    dbias = dy.sum((1, 2))
    dys = bf16_round(dy * bf16_round(scale)).reshape(shp)
    xg = xh.reshape(shp)
    dx = inv * (dys - dys.mean(dim=(1, 2, 4), keepdim=True)
                - xg * (dys * xg).mean(dim=(1, 2, 4), keepdim=True))
    return bf16_round(dx.reshape(dy.shape)), dscale, dbias


def _rows_bwd_mirror(w, t, h, g, groups, fwd=rows_wgmma_emulated,
                     igrad=lambda x, k: rows_wgmma_emulated(
                         x, k, transposed=True)):
    """The rows backward's launches in plain PyTorch: (1) h rounded, GN1 →
    ReLU: r1; (2) conv1 in the rows order (``fwd``) with the bf16
    ``concat_out`` epilogue: u; (3) GN2 → ReLU: r2; (4) conv2: v; (5) GN3
    of v: f, its backward under the rounded cotangent: gv, conv2's
    partials (bias Σ gv, time column Σ bf16(gv·t), dt's part
    bf16(Σ bf16(gv·bf16(M2)))); (6) the conv2 input gradient (``igrad``),
    each sum rounded; (7) ReLU2 + GN2 backward: gu, conv1's partials, dt =
    bf16(dt2 + dt1); (8) the conv1 input gradient; (9) ReLU1 + GN1
    backward: dh.  Then the weight gradients (the library's order) and
    every sum over the batch of per-sample partials in f32, rounded once
    (the time column not).  Returns ``(dparams raw, dt, dh, f)``."""
    b = h.shape[0]
    t16 = bf16_round(t.reshape(-1).expand(b)).reshape(b, 1, 1, 1)

    def conv(x, k, bias, m):
        acc = fwd(x, k)
        return bf16_round(bf16_round(bf16_round(acc) + bf16_round(bias))
                          + bf16_round(t16 * bf16_round(m)))

    def params(gout, r, m):
        nchw = gout.permute(0, 3, 1, 2)
        dw = torch.nn.grad.conv2d_weight(r.permute(0, 3, 1, 2),
                                         (r.shape[-1],) * 2 + (3, 3), nchw,
                                         padding=1)
        dt_ = bf16_round(bf16_round(gout * bf16_round(m)).sum((1, 2, 3)))
        return (bf16_round(dw.permute(2, 3, 1, 0)),
                bf16_round(gout.sum((1, 2)).sum(0)),
                bf16_round(gout * t16).sum(0), dt_)

    y1, xh1, inv1 = _gn(bf16_round(h), w.n1s, w.n1b, groups)
    r1 = torch.relu(y1)
    y2, xh2, inv2 = _gn(conv(r1, w.w1, w.b1, w.m1), w.n2s, w.n2b, groups)
    r2 = torch.relu(y2)
    f, xh3, inv3 = _gn(conv(r2, w.w2, w.b2, w.m2), w.n3s, w.n3b, groups)
    gv, d3s, d3b = _gn_bwd(bf16_round(g), xh3, inv3, w.n3s, groups)
    dw2, db2, dm2, dt2 = params(gv, r2, w.m2)
    sx = bf16_round(igrad(gv, w.w2))
    gu, d2s, d2b = _gn_bwd(torch.where(y2 > 0, sx, 0.0), xh2, inv2, w.n2s,
                           groups)
    dw1, db1, dm1, dt1 = params(gu, r1, w.m1)
    sx = bf16_round(igrad(gu, w.w1))
    dh, d1s, d1b = _gn_bwd(torch.where(y1 > 0, sx, 0.0), xh1, inv1, w.n1s,
                           groups)
    batch = [bf16_round(p.sum(0)) for p in (d1s, d1b, d2s, d2b, d3s, d3b)]
    d = OdefuncWeights(batch[0], batch[1], dw1, db1, dm1, batch[2],
                       batch[3], dw2, db2, dm2, batch[4], batch[5])
    return _raw_grads(d), bf16_round(dt2 + dt1), dh, f


def _outputs(res) -> dict:
    dparams, dt, dh = res[:3]
    return {"dh": dh, "dt": dt, **{f"{a}.{k}": v for a, d in dparams.items()
                                  for k, v in d.items()}}


@pytest.mark.parametrize("hw", [(7, 7), (6, 6)])
def test_the_rows_backward_sequence_is_the_bf16_vjp(hw, monkeypatch):
    """The plain mirror of the rows backward's launches at hidden 96, B = 3,
    against the plain bf16 VJP with each conv's bias added after the conv's
    rounding (the card's rounding point, ``bf16_distances._bias_apart``):
    every output within ``BARS['bwd_u']`` u of relative L2, f within the
    bf16 ODEfunc's ``'f_rel_u'``, and the f32 VJP beyond the bar on dh and
    the early leaves; and the mirror equal, bit for bit, to the same
    sequence on the one-CTA pass's conv orders
    (``conv3x3_wgmma_emulated(..., precision='bf16')``, ``transposed``)."""
    cfg = ModelConfig(in_channels=3, hidden=96)
    w = prepare(init_odenet(6, cfg, device="cpu")["odefunc"], hw)
    rng = np.random.default_rng(9)
    h = torch.from_numpy((rng.normal(size=(3, *hw, 96)) * 0.3).astype(
        np.float32))
    g = torch.from_numpy(rng.normal(size=h.shape).astype(np.float32))
    t = torch.from_numpy(rng.uniform(0, 1, 3).astype(np.float32))
    f32 = _outputs(odefunc_bwd_plain(w, t, h, g, cfg.groups))
    monkeypatch.setattr(odefunc_mod, "conv2d",
                        bf16_distances._bias_apart(layers.conv2d))
    want = odefunc_bwd_plain(w, t, h, g, cfg.groups, True, "bf16")
    got = _rows_bwd_mirror(w, t, h, g, cfg.groups)
    assert (bf16_distances.rel_u(got[3], want[3])
            <= bf16_distances.BARS["f_rel_u"])
    bar = bf16_distances.BARS["bwd_u"]
    want_o, got_o = _outputs(want), _outputs(got)
    for k in want_o:
        err = bf16_distances.rel_u(got_o[k], want_o[k])
        assert err <= bar, (k, err)
        if k in bf16_distances.BWD_EARLY:
            assert bf16_distances.rel_u(f32[k], want_o[k]) > bar, k
    per_sample = _rows_bwd_mirror(
        w, t, h, g, cfg.groups,
        lambda x, k: conv3x3_wgmma_emulated(x, k, precision="bf16"),
        lambda x, k: conv3x3_wgmma_emulated(x, k, transposed=True,
                                            precision="bf16"))
    for a, b in zip(_outputs(per_sample).values(), got_o.values()):
        assert torch.equal(a, b)
    assert torch.equal(per_sample[3], got[3])


# ---- against the JAX package ------------------------------------------------

# The port's bf16 VJP at hidden 96 (on the CPU its plain version, autograd
# through the plain bf16 f; on the card the rows backward) against jax.vjp
# of the JAX jnp bf16 dynamics, per output in u of relative L2 (PRNGKey(3),
# h ~ 0.3·N(0, 1), g ~ N(0, 1), t ~ U(0, 1) per sample, numpy seed 5).  The
# packages round at other points (XLA keeps f32 inside a fusion) and
# GroupNorm's backward widens that: each bar is 1.4 times this draw's
# reading, and on dh and the early leaves below the f32 VJP's distance from
# the same JAX VJP (asserted, 1.2–12 times the bf16 reading); on dt and the
# late leaves the two read alike, and the bar is absolute.
JAX_VJP_BARS = {
    7: {"dh": 9.8, "dt": 19.3, "norm1.scale": 10.3, "norm1.bias": 10.1,
        "conv1.kernel": 10.0, "conv1.bias": 12.6, "norm2.bias": 10.5,
        "norm2.scale": 4.1, "conv2.kernel": 1.9, "conv2.bias": 5.4,
        "norm3.scale": 5.3, "norm3.bias": 4.9},
    6: {"dh": 2.0, "dt": 7.7, "norm1.scale": 4.1, "norm1.bias": 3.6,
        "conv1.kernel": 2.0, "conv1.bias": 5.9, "norm2.bias": 3.5,
        "norm2.scale": 3.7, "conv2.kernel": 1.9, "conv2.bias": 5.0,
        "norm3.scale": 4.0, "norm3.bias": 4.1},
}
JAX_VJP_EARLY = ("dh", "norm1.scale", "norm1.bias", "conv1.kernel",
                 "conv1.bias", "norm2.bias")


@pytest.mark.parametrize("side", [7, 6])
def test_bf16_vjp_at_hidden_96_matches_jax(side):
    """``odefunc_bwd(..., precision='bf16')`` at hidden 96, where the card
    runs the rows backward (``sample_pass`` ``'rows'``), against
    ``jax.vjp`` of the JAX ``odefunc_apply`` with
    ``compute_dtype='bfloat16'`` with respect to its parameters, t (B,) and
    h, the same numpy-seeded inputs and the JAX weights carried by
    ``from_jax_params``: each output within :data:`JAX_VJP_BARS`, each
    early bar below the f32 VJP's distance."""
    assert sample_pass((side, side), 96, 32, "bf16") == "rows"
    jcfg = JaxConfig(in_channels=3, hidden=96, compute_dtype="bfloat16")
    pj = jax_init_odenet(jax.random.PRNGKey(3), jcfg)["odefunc"]
    pt = from_jax_params(pj, device="cpu")
    rng = np.random.default_rng(5)
    h = (rng.normal(size=(3, side, side, 96)) * 0.3).astype(np.float32)
    g = rng.normal(size=h.shape).astype(np.float32)
    t = rng.uniform(0, 1, 3).astype(np.float32)
    _, vjp = jax.vjp(lambda p, tt, x: jax_odefunc(p, tt, x, jcfg), pj,
                     jnp.asarray(t), jnp.asarray(h))
    dpj, dtj, dhj = vjp(jnp.asarray(g))
    want = {"dh": torch.from_numpy(np.asarray(dhj)),
            "dt": torch.from_numpy(np.asarray(dtj)),
            **{f"{a}.{k}": torch.from_numpy(np.asarray(v))
               for a, d in dpj.items() for k, v in d.items()}}
    w = prepare(pt, (side, side))
    args = (w, torch.from_numpy(t), torch.from_numpy(h), torch.from_numpy(g))
    before = odefunc_bwd.launches_bf16
    got = _outputs(odefunc_bwd(*args, groups=32, precision="bf16"))
    assert odefunc_bwd.launches_bf16 == before  # the CPU: the plain version
    f32 = _outputs(odefunc_bwd(*args, groups=32))
    assert set(got) == set(want) == set(JAX_VJP_BARS[side])
    for k, bar in JAX_VJP_BARS[side].items():
        err = bf16_distances.rel_u(got[k], want[k])
        assert err <= bar, (k, err, bar)
        if k in JAX_VJP_EARLY:
            assert bar < bf16_distances.rel_u(f32[k], want[k]), k


# ---- the C++ gate, shared memory and scratch --------------------------------


def _cpp_return(source: str, signature: str) -> str:
    """The ``return`` expression of a C++ function of ``source``, its
    whitespace collapsed."""
    text = (CSRC / source).read_text()
    m = re.search(re.escape(signature) + r"\s*\{\s*return (.*?);\s*\}", text,
                  re.S)
    assert m, f"{signature} not found in {source}"
    return " ".join(m.group(1).split())


def _as_python(expr: str) -> str:
    expr = re.sub(r"\((size_t)\)", "", expr).replace("sizeof(float)", "4")
    return expr.replace("/", "//")


def test_sample_pass_is_the_cpp_gate():
    """``rows_bwd_ok`` in ``csrc/odefunc_bwd.cu`` is the backward's gate, the
    forward's, the rows build's shapes (``wide_shape``: the tensor-core
    shapes past C = 64) and the bordered map's shared memory; the bf16
    entries (the path's and the ``mma.sync`` weight kernel's reading) run
    the rows backward exactly there; ``sample_pass`` gives
    ``'rows'`` for the bf16 build exactly where those four Python mirrors
    hold, at every width from 32 to 544 on five maps, never for f32, and
    the cluster pass keeps C = 64."""
    assert _cpp_return("odefunc_bwd.cu", "inline bool rows_bwd_ok(int H, int "
                       "W, int C, int G)") == (
        "bwd_shape_ok(H, W, C, G) && shape_ok(H, W, C, G) && "
        "wide_shape(make_shape(H, W, C, G)) && rows_bwd_smem_bytes(H, W, C, "
        "G) <= kMaxSmem")
    src = " ".join((CSRC / "odefunc_bwd.cu").read_text().split())
    assert ("wpart, ug, dk1, dk2, dvec, B, H, W, C, G, ns, "
            "nodef::rows_bwd_ok(H, W, C, G), scratch, stream);") in src
    # The other bf16 entry, the reading with the weight gradients on the
    # mma.sync kernel, runs the same per-sample pass.
    assert ("wpart, ug, dk1, dk2, dvec, B, H, W, C, G, ns, "
            "nodef::rows_bwd_ok(H, W, C, G), scratch, stream, true);") in src
    assert src.count("nodef::rows_bwd_ok(H, W, C, G)") == 2
    assert "} else if (rows) {" in src
    for hw in ((7, 7), (6, 6), (5, 5), (1, 62), (8, 8)):
        for c in range(32, 545, 32):
            rows = (stage(hw, c, "bf16") == "rows_bf16"
                    and supported(hw, c, 32) and bwd_supported(hw, c, 32)
                    and rows_bwd_smem_bytes(hw, c, 32) <= MAX_SMEM)
            assert (sample_pass(hw, c, 32, "bf16") == "rows") == rows
            assert sample_pass(hw, c, 32) != "rows"
            if hw in ((7, 7), (6, 6)):
                assert rows == (96 <= c <= 512), (hw, c)
        assert sample_pass(hw, 64, 32, "bf16") == (
            "cluster" if hw != (8, 8) else "cta")
    # A 1x62 map's bordered cotangent outgrows shared memory past C = 192.
    assert [c for c in range(96, 513, 32)
            if sample_pass((1, 62), c, 32, "bf16") == "rows"] == [
        96, 128, 160, 192]


def test_shared_memory_and_scratch_are_mirrored():
    """``rows_bwd_smem_bytes`` and ``rows_bwd_scratch_bytes`` evaluated from
    the C++ source against the Python mirrors at every width from 96 to 512
    and several batches and group counts; the scratch starts with the rows
    conv's (``rows_scratch_bytes``: the bf16 conv input, one conv's
    packing), which the launch sequence takes apart in that order."""
    smem = eval("lambda H, W, C, G: " + _as_python(_cpp_return(  # noqa: S307
        "odefunc_bwd.cu", "inline size_t rows_bwd_smem_bytes(int H, int W, "
        "int C, int G)")), {"kThreads": odefunc_mod.THREADS})
    scratch_expr = _cpp_return("odefunc_bwd.cu", "inline size_t "
                               "rows_bwd_scratch_bytes(int B, int H, int W, "
                               "int C, int G)")
    assert scratch_expr.startswith("rows_scratch_bytes(B, H, W, C, true) + ")
    scratch = eval("lambda B, H, W, C, G: " + _as_python(  # noqa: S307
        scratch_expr.replace("rows_scratch_bytes(B, H, W, C, true)",
                             "rsb(B, (H, W), C)")),
                   {"rsb": rows_scratch_bytes})
    for c in range(96, 513, 32):
        for hw in ((7, 7), (6, 6)):
            for groups in (32, 16, c):
                assert smem(*hw, c, groups) == rows_bwd_smem_bytes(
                    hw, c, groups)
                for b in (1, 5, 128, 256):
                    assert scratch(b, *hw, c, groups) == (
                        rows_bwd_scratch_bytes(b, hw, c, groups))
    assert rows_bwd_smem_bytes((7, 7), 512, 32) == 178_432 <= MAX_SMEM
    src = " ".join((CSRC / "odefunc_bwd.cu").read_text().split())
    assert ("float* stats = reinterpret_cast<float*>(base + "
            "rows_scratch_bytes(B, H, W, C, true));") in src
    assert ("uint8_t* wp = base + rows_scratch_bytes(B, H, W, C, true) - "
            "rows_pack_bytes(true, C);") in src


def test_the_launch_sequence_in_the_source():
    """The rows backward's launches in order: two recompute GroupNorms and
    forward convs, then per conv in reverse its GroupNorm backward and its
    transposed input-gradient conv, then GN1's backward; the transposed
    convs round each sum once (``RowsBwdEpi`` without a bias), into dh.
    The five per-sample launches run a slice of whole groups a CTA (grid B
    times ``rows_slices``, ``rows_slice_threads`` threads), the
    recompute's on ``rows_gn_smem_bytes``, the backwards on
    ``rows_bwd_slice_smem_bytes``; dt's per-channel sums sit after GN1's
    and GN2's statistics in the scratch."""
    src = (CSRC / "odefunc_bwd.cu").read_text()
    body = src[src.index("int launch_rows_bwd("):]
    body = body[:body.index("\n}\n")]
    order = re.findall(r"(rows_bwd_\w+_kernel)<<<|rows_conv<(true(?:, true)?)>",
                       body)
    assert [a or b for a, b in order] == [
        "rows_bwd_gn_relu_kernel", "true", "rows_bwd_gn_relu_kernel", "true",
        "rows_bwd_gv_kernel", "true, true", "rows_bwd_gu_kernel",
        "true, true", "rows_bwd_dh_kernel"]
    flat = " ".join(body.split())
    assert ("const int gb = B * rows_slices(G), gt = rows_slice_threads(G);"
            in flat)
    grids = re.findall(r"(rows_bwd_\w+_kernel)<<<([^>]*)>>>", flat)
    assert grids == [(k, "gb, gt, gsm, st") for k in (
        "rows_bwd_gn_relu_kernel",) * 2] + [(k, "gb, gt, bsm, st") for k in (
            "rows_bwd_gv_kernel", "rows_bwd_gu_kernel", "rows_bwd_dh_kernel")]
    assert ("const size_t gsm = rows_gn_smem_bytes(s), bsm = "
            "rows_bwd_slice_smem_bytes(H, W, C, G);") in flat
    assert "float* chan_t = stats + 4 * (size_t)B * G;" in flat
    assert body.count(", rounded, st)") == 2
    assert ("const RowsBwdEpi rounded{{nullptr, nullptr, nullptr, dh, H * W, "
            "C}};") in body
    assert "make_float2(bf16_round(v0), bf16_round(v1))" in src


def test_slice_shared_memory_is_mirrored():
    """``rows_bwd_slice_smem_bytes`` (the sliced GroupNorm backwards) from
    the C++ source against the Python mirror at every rows shape and
    several group counts; a CTA's share at 7x7x512 lets four share an
    SM."""
    smem = eval("lambda H, W, C, G: " + _as_python(_cpp_return(  # noqa: S307
        "odefunc_bwd.cu", "inline size_t rows_bwd_slice_smem_bytes(int H, "
        "int W, int C, int G)")), {"rows_slices": rows_slices,
                                   "rows_slice_threads": rows_slice_threads})
    for c in range(96, 513, 32):
        for hw in ((7, 7), (6, 6)):
            for groups in (32, 16, c // 32):
                assert smem(*hw, c, groups) == rows_bwd_slice_smem_bytes(
                    hw, c, groups)
    assert rows_bwd_slice_smem_bytes((7, 7), 512, 32) == 55_424
    assert 4 * (55_424 + 1024) <= 228 * 1024


def _bf16(x):
    """x rounded to bf16 (to nearest even), as float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _fma(a, b, c):
    """fmaf in numpy: a·b exact in float64, the sum rounded to float32
    (both orders below take the same function)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _chain(step, pg, ch, npg, hw):
    """Per slot (pg, ch) ``acc = step(acc, p, ch)`` over the pixels p = pg,
    pg + npg, ... in order, from 0 (float32)."""
    acc = np.zeros(len(pg), np.float32)
    for k in range(-(-hw // npg)):
        p = pg + k * npg
        m = p < hw
        acc[m] = step(acc[m], p[m], ch[m])
    return acc


def _bwd_sums(x, dy, gv, tmap, t, hw, c, groups, order):
    """The rows backward's sums of one sample, emulated in float32: the
    GroupNorm backward's channel sums (dscale, dbias, then the bf16 pass's
    dy·scale·x-hat and dy·scale) and group means, one ConcatConv's bias
    gradient, time-map sums, time columns and its t gradient, dt = bf16(dt2
    + dt1) of two such convs (``gv`` (2, H*W, C)).  ``order`` 'cta': the
    one-CTA map (thread pg*C + c, partials at q*C + c, dt by thread 0 over
    the channels, each time column a loop over its tap's window); 'sliced':
    each slice's CTA (thread j = pg*cs + cl, partials at q*cs + cl; the
    time columns nine chains over the pixels; dt gathered over the
    slices' per-channel sums in channel order)."""
    (hh, ww), gs = hw, c // groups
    npix, npg = hh * ww, odefunc_mod.THREADS // c
    n = np.float32(npix * gs)
    mean, inv, scale = (x.mean(0).reshape(groups, gs).mean(1),
                        np.float32(1.3) + 0 * x[0, ::gs], x[1] * 0.5 + 1)
    mean, inv, scale = (np.float32(mean), np.float32(inv), _bf16(scale))
    xh = (_bf16(x) - mean[np.arange(c) // gs]) * inv[np.arange(c) // gs]
    dys = _bf16(dy * scale)
    parts = [(0, c)] if order == "cta" else [
        (k * (c // rows_slices(groups)), c // rows_slices(groups))
        for k in range(rows_slices(groups))]
    out = {k: np.zeros(c, np.float32) for k in
           ("dscale", "dbias", "sb1", "sb2", "db")}
    out.update(gm1=np.zeros(groups, np.float32),
               gm2=np.zeros(groups, np.float32),
               tsum=np.zeros((2, c), np.float32),
               dwt=np.zeros((2, 9, c), np.float32))
    for c0, cs in parts:
        j = np.arange(npg * cs)
        pg, ch = j // cs, c0 + j % cs
        cl = np.arange(cs)

        def per_channel(red):  # over the pixel groups, per channel
            acc = np.zeros(cs, np.float32)
            for q in range(npg):
                acc = acc + red[q * cs + cl]
            return acc

        sl = slice(c0, c0 + cs)
        out["dscale"][sl] = per_channel(_chain(
            lambda a, p, cc: a + _bf16(dy[p, cc] * _bf16(xh[p, cc])),
            pg, ch, npg, npix))
        out["dbias"][sl] = per_channel(_chain(
            lambda a, p, cc: a + dy[p, cc], pg, ch, npg, npix))
        out["sb1"][sl] = per_channel(_chain(
            lambda a, p, cc: _fma(dys[p, cc], xh[p, cc], a), pg, ch, npg,
            npix))
        out["sb2"][sl] = per_channel(_chain(
            lambda a, p, cc: a + dys[p, cc], pg, ch, npg, npix))
        for gl in range(cs // gs):
            g = c0 // gs + gl
            s1 = s2 = np.float32(0)
            for jj in range(gs):
                s1 = s1 + out["sb1"][g * gs + jj]
                s2 = s2 + out["sb2"][g * gs + jj]
            out["gm1"][g], out["gm2"][g] = s2 / n, s1 / n
        for conv in range(2):
            v = gv[conv]
            if conv == 0:
                out["db"][sl] = per_channel(_chain(
                    lambda a, p, cc: a + v[p, cc], pg, ch, npg, npix))
            out["tsum"][conv, sl] = per_channel(_chain(
                lambda a, p, cc: a + _bf16(v[p, cc] * _bf16(tmap[p, cc])),
                pg, ch, npg, npix))
            term = _bf16(v * t).reshape(hh, ww, c)
            for k in range(9):
                ky, kx = divmod(k, 3)
                acc = np.zeros(cs, np.float32)
                if order == "cta":  # its window, y-major
                    for y in range(max(0, 1 - ky), min(hh, hh + 1 - ky)):
                        for xx in range(max(0, 1 - kx), min(ww, ww + 1 - kx)):
                            acc = acc + term[y, xx, sl]
                else:  # every pixel in order, the window's added
                    for y in range(hh):
                        for xx in range(ww):
                            if 1 - ky <= y < hh + 1 - ky and (
                                    1 - kx <= xx < ww + 1 - kx):
                                acc = acc + term[y, xx, sl]
                out["dwt"][conv, k, sl] = acc
    # dt: each conv's per-channel sums added over the channels in order, by
    # one thread (the one-CTA pass) or gathered from the slices' scratch.
    dts = []
    for conv in range(2):
        acc = np.float32(0)
        for cc in range(c):
            acc = acc + out["tsum"][conv, cc]
        dts.append(_bf16(acc))
    out["dt"] = _bf16(dts[0] + dts[1])
    return out


def _body(source: str, start: str) -> str:
    """The text of ``source`` from ``start`` to the end of that function."""
    text = (CSRC / source).read_text()
    body = text[text.index(start):]
    return body[:body.index("\n}\n")]


def test_the_emulated_backward_order_is_the_sources():
    """The order ``_bwd_sums`` emulates is the one the sources hold, so that
    a kernel edit that changes it fails here.  One-CTA
    (``odefunc_bwd.cu``): ``channel_sums`` and ``conv_param_grads`` chain
    a slot's pixels and add the pixel groups q in order at ``q * C +
    tid``, the time columns over their tap's window y-major, dt by one
    thread over the channels in order.  Slices: ``slice_gn_backward``
    and ``slice_conv_param_grads`` chain the slot's pixels with the full
    map's npg and add q in order at ``q * cs + tid``, the group means
    over the group's channels in order, the time columns over every
    pixel y-major; ``rows_bwd_dt`` adds the gathered per-channel sums in
    channel order and the dx launch adds conv1's to conv2's."""
    cs_ = _body("odefunc_bwd.cu", "__device__ __forceinline__ void "
                "channel_sums(")
    assert "    for (int p = pg; p < hw; p += npg) {\n" in cs_
    assert ("    for (int q = 0; q < npg; ++q) {\n"
            "      s1 += m.sred[q * C + tid];\n"
            "      s2 += sred2[q * C + tid];\n") in cs_
    cpg = _body("odefunc_bwd.cu", "__device__ float conv_param_grads(")
    assert ("    for (int y = y0; y < y1; ++y)\n"
            "      for (int x = x0; x < x1; ++x)\n") in cpg
    assert ("  if (tid == 0)\n"
            "    for (int cc = 0; cc < C; ++cc) dt += chan[cc];\n") in cpg
    gnb = _body("odefunc_bwd.cu", "__device__ void slice_gn_backward(")
    assert "    for (int p = sl.pg; p < sl.hw; p += s.npg) {\n" in gnb
    assert "".join(f"      s{k + 1} += m.red[{pre}q * cs + tid];\n"
                   for k, pre in enumerate(
                       ("", "nt + ", "2 * nt + ", "3 * nt + "))) in gnb
    assert ("    for (int j = 0; j < s.gs; ++j) {\n"
            "      s1 += m.ch1[tid * s.gs + j];\n"
            "      s2 += m.ch2[tid * s.gs + j];\n") in gnb
    spg = _body("odefunc_bwd.cu", "__device__ void slice_conv_param_grads(")
    assert "    for (int p = sl.pg; p < sl.hw; p += s.npg) {\n" in spg
    assert ("      s1 += red[q * cs + tid];\n"
            "      s2 += red[blockDim.x + q * cs + tid];\n") in spg
    assert ("    for (int y = 0; y < s.H; ++y)\n"
            "      for (int x = 0; x < s.W; ++x) {\n") in spg
    dt = _body("odefunc_bwd.cu", "__device__ __forceinline__ float "
               "rows_bwd_dt(")
    assert "  for (int cc = 0; cc < C; ++cc) dt += chan_t[cc];\n" in dt
    src = (CSRC / "odefunc_bwd.cu").read_text()
    assert ("dt[sl.b] = bf16_round(dt[sl.b] + rows_bwd_dt(m.dtc, s.C));"
            in src)


@pytest.mark.parametrize("hw,c", [((7, 7), 96), ((7, 7), 160),
                                  ((6, 6), 224), ((7, 7), 320),
                                  ((7, 7), 512)])
def test_sliced_backward_sums_are_the_one_cta_order(hw, c):
    """A numpy float32 emulation of the rows backward's per-sample sums
    (``rows_bwd_gv``, ``_gu``, ``_dh``: the GroupNorm backward's channel
    sums and group means, the conv parameter gradients and dt's gather):
    the slices' order equals the one-CTA pass's bit for bit on seeded
    inputs, also where C does not divide 512 (96, 160, 224, 320), and dt
    and dθ's partials lie near float64's."""
    rng = np.random.default_rng(c + 3 * hw[0])
    npix = hw[0] * hw[1]
    x = (rng.normal(size=(npix, c)) * 0.6).astype(np.float32)
    dy = _bf16(rng.normal(size=(npix, c)))
    gv = _bf16(rng.normal(size=(2, npix, c)))
    tmap = rng.normal(size=(npix, c)).astype(np.float32)
    t = _bf16(np.float32(0.375))
    want = _bwd_sums(x, dy, gv, tmap, t, hw, c, 32, "cta")
    got = _bwd_sums(x, dy, gv, tmap, t, hw, c, 32, "sliced")
    assert list(got) == list(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]).view(np.uint32),
                              np.asarray(want[k]).view(np.uint32)), k
    np.testing.assert_allclose(want["dbias"], dy.astype(np.float64).sum(0),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(want["db"], gv[0].astype(np.float64).sum(0),
                               rtol=1e-5, atol=1e-4)


def test_graph_route_counts_one_launch_a_rows_backward():
    """A captured rows backward holds fifteen kernel nodes a call (four
    weight packings, four convs, five per-sample launches, the weight
    gradients and the reduction); the route counts the call once, by
    ``rows_bwd_dh_kernel``, in ``odefunc_bwd.launches_bf16``, and none of
    its nodes in the f32 counter or in the bf16 ``odefunc``'s (which counts
    its rows build by ``rows_gn_out_kernel``, which the backward does not
    launch)."""
    per_call = {
        "_ZN5nodef16rows_pack_kernelILb1ELb0EEEvPKfiPh": 2,
        "_ZN5nodef16rows_pack_kernelILb1ELb1EEEvPKfiPh": 2,
        "_ZN5nodef23rows_bwd_gn_relu_kernelEPKfS1_S1_NS_5ShapeEPfPtS3_i": 2,
        "_ZN5nodef16rows_conv_kernelILb1ELi2ENS_10RowsBwdEpiEEEvPKtPKhiiiiT1_":
            4,
        "_ZN5nodef18rows_bwd_gv_kernelEPKfS1_NS_7OdefuncENS_5ShapeES1_PfS4_"
        "PtS4_S4_": 1,
        "_ZN5nodef18rows_bwd_gu_kernelEPKfNS_7OdefuncENS_5ShapeES1_S1_S1_Pf"
        "PtS4_S4_S4_": 1,
        "_ZN5nodef18rows_bwd_dh_kernelEPKfNS_7OdefuncENS_5ShapeES1_PfS1_S4_"
        "S4_": 1,
        "_ZN5nodef17bwd_weight_kernelILi64ELb1EEEvPKfS2_S2_S2_NS_5ShapeEiiPf":
            1,
        "_ZN5nodef17bwd_reduce_kernelILb1EEEvPKfS2_NS_5ShapeEiiPfS4_S4_": 1,
    }
    assert sum(per_call.values()) == 15
    nodes = collections.Counter({k: 3 * v for k, v in per_call.items()})
    rules = {(w.__name__, attr): kernels for w, attr, kernels
             in attempt_graph._kernel_wrappers()}
    assert attempt_graph._count(
        nodes, rules[("odefunc_bwd", "launches_bf16")]) == 3
    for key in (("odefunc_bwd", "launches"), ("odefunc", "launches_bf16"),
                ("odefunc", "launches")):
        assert attempt_graph._count(nodes, rules[key]) == 0, key
    src = (CSRC / "odefunc_bwd.cu").read_text()
    assert src.count("rows_bwd_dh_kernel<<<") == 1


def test_cpu_calls_take_the_plain_version():
    """On CPU tensors the bf16 backward at a rows width is the plain bf16
    VJP, nothing launched; the one-CTA reading refuses a CPU tensor."""
    cfg = ModelConfig(in_channels=3, hidden=128)
    p = init_odenet(5, cfg, device="cpu")["odefunc"]
    rng = np.random.default_rng(5)
    h = torch.from_numpy(rng.normal(size=(2, 7, 7, 128)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=h.shape).astype(np.float32))
    t = torch.tensor([0.25, 0.5])
    before = odefunc_bwd.launches, odefunc_bwd.launches_bf16
    got = odefunc_bwd(p, t, h, g, precision="bf16", with_f=True)
    want = odefunc_bwd_plain(prepare(p, (7, 7)), t, h, g, 32, True, "bf16")
    for a, b in zip(_outputs(got).values(), _outputs(want).values()):
        assert torch.equal(a, b)
    assert torch.equal(got[3], want[3])
    assert (odefunc_bwd.launches, odefunc_bwd.launches_bf16) == before
    with pytest.raises(ValueError, match="CUDA"):
        odefunc_bwd_cta_bf16(p, t, h, g)
    assert bwd_mod._CTA_BF16 == "odefunc_backward_bf16_cta"
    assert 'extern "C" int odefunc_backward_bf16_cta(NODEF_BACKWARD_ARGS)' in (
        CSRC / "odefunc_bwd.cu").read_text()
