"""Port parity, kernel modules: the plain PyTorch versions of the CUDA
kernels against the JAX Pallas kernels (interpret mode, as
tests/test_pallas.py and tests/test_fused_rk.py run them) and the JAX jnp
path, on the CPU.  The kernels themselves run only on a CUDA card, in
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.kernels.odefunc_pallas import (
    odefunc_pallas,
    odefunc_pallas_vjp,
)
from neural_ode_features_tpu.kernels.rk_step_pallas import (
    make_fused_dopri5_step as jax_make_fused_step,
)
from neural_ode_features_tpu.models import ModelConfig as JaxConfig
from neural_ode_features_tpu.models import init_odenet as jax_init_odenet
from neural_ode_features_tpu.models import odenet_logits as jax_logits
from neural_ode_features_tpu.models.odenet import odefunc_apply as jax_odefunc
from neural_ode_features_tpu.solver.runge_kutta import _error_ratio, _rk_attempt
from neural_ode_features_tpu.solver.tableau import DOPRI5 as JAX_DOPRI5
from neural_ode_features_tpu_torch.entry import ENTRY_CONFIG
from neural_ode_features_tpu_torch.kernels import odefunc as odefunc_mod
from neural_ode_features_tpu_torch.kernels.conv3x3 import conv3x3_plain
from neural_ode_features_tpu_torch.kernels.odefunc import (
    MAX_SMEM,
    PARAM_KEYS,
    WGMMA_C,
    odefunc,
    odefunc_plain,
    odefunc_vjp,
    layout,
    prepare,
    smem_bytes,
    stage,
    supported,
)
from neural_ode_features_tpu_torch.kernels.odefunc_bwd import (
    bwd_smem_bytes,
    bwd_supported,
    odefunc_bwd_plain,
    u_global,
)
from neural_ode_features_tpu_torch.kernels.rk_step import (
    CONV_STRATEGIES,
    dopri5_step_plain,
    make_fused_dopri5_step,
)
from neural_ode_features_tpu_torch.models import (
    ModelConfig,
    odefunc_apply,
    odenet_logits,
)
from neural_ode_features_tpu_torch.ops import layers
from neural_ode_features_tpu_torch.solver import DOPRI5
from neural_ode_features_tpu_torch.utils import from_jax_params

torch.set_num_threads(2)

RTOL = ATOL = 1e-3
STATE_TOL = dict(rtol=2e-4, atol=2e-5)
RATIO_TOL = dict(rtol=2e-3, atol=1e-6)


@pytest.fixture(scope="module")
def odefunc_params():
    cfg = JaxConfig(in_channels=3)
    pj = jax_init_odenet(jax.random.PRNGKey(0), cfg)["odefunc"]
    return cfg, pj, from_jax_params(pj, device="cpu")


def _state(seed, b, side, scale=0.3):
    return (np.random.default_rng(seed).normal(size=(b, side, side, 64))
            * scale).astype(np.float32)


@pytest.mark.parametrize("side,batch,t_kind", [
    (7, 8, "per_sample"), (6, 8, "per_sample"), (7, 5, "scalar")])
def test_odefunc_plain_matches_jax(odefunc_params, side, batch, t_kind):
    cfg, pj, pt = odefunc_params
    h = _state(1, batch, side, scale=1.0)
    t = (np.float32(0.37) if t_kind == "scalar" else
         np.random.default_rng(2).uniform(0, 1, batch).astype(np.float32))
    want_kernel = odefunc_pallas(pj, jnp.asarray(t), jnp.asarray(h),
                                 groups=cfg.groups, interpret=True)
    want_jnp = jax_odefunc(pj, jnp.asarray(t), jnp.asarray(h), cfg)
    got = odefunc_plain(prepare(pt, (side, side)), torch.as_tensor(t),
                        torch.from_numpy(h), cfg.groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel),
                               **STATE_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_jnp), **STATE_TOL)
    # The CPU wrapper and the model's dynamics take the same plain path.
    wrapped = odefunc(pt, torch.as_tensor(t), torch.from_numpy(h),
                      groups=cfg.groups)
    np.testing.assert_allclose(wrapped.numpy(), got.numpy(), rtol=0, atol=0)
    model = odefunc_apply(pt, torch.as_tensor(t), torch.from_numpy(h),
                          ModelConfig(in_channels=3))
    np.testing.assert_allclose(model.numpy(), got.numpy(), **STATE_TOL)


def _step_inputs(pj, cfg, b, side):
    h = _state(3, b, side)
    rng = np.random.default_rng(4)
    t0 = rng.uniform(0.0, 0.5, b).astype(np.float32)
    dt = rng.uniform(0.05, 0.2, b).astype(np.float32)
    f0 = np.array(jax_odefunc(pj, jnp.asarray(t0), jnp.asarray(h), cfg))
    return t0, dt, h.reshape(b, -1), f0.reshape(b, -1)


@pytest.mark.parametrize("batch,side", [(8, 7), (5, 7), (8, 6)])
def test_step_plain_matches_jax(odefunc_params, batch, side):
    """Against the JAX fused step (rollS, interpret; a ragged B=5 gets a
    tile of 5) and against JAX ``_rk_attempt`` + ``_error_ratio``."""
    cfg, pj, pt = odefunc_params
    t0, dt, y0, f0 = _step_inputs(pj, cfg, batch, side)

    def jfunc(t, y):
        return jax_odefunc(pj, t, y.reshape(batch, side, side, 64),
                           cfg).reshape(batch, -1)

    args = [jnp.asarray(a) for a in (t0, dt, y0, f0)]
    y1_r, err_r, f1_r, _, parts = _rk_attempt(JAX_DOPRI5, jfunc, *args,
                                              jnp.float32)
    ratio_r = _error_ratio(err_r, args[2], y1_r, RTOL, ATOL)
    fused_j = jax_make_fused_step(pj, JAX_DOPRI5, (side, side),
                                  groups=cfg.groups, rtol=RTOL, atol=ATOL,
                                  interpret=True, conv_strategy="rollS",
                                  tile=batch)(*args)

    got = dopri5_step_plain(
        prepare(pt, (side, side)), DOPRI5, *(torch.from_numpy(a) for a in
                                             (t0, dt, y0, f0)),
        hw=(side, side), groups=cfg.groups, rtol=RTOL, atol=ATOL)
    for want in ((y1_r, f1_r, parts()[2], ratio_r), fused_j):
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **STATE_TOL)
        np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                                   **RATIO_TOL)


def test_fused_step_builder(odefunc_params):
    cfg, pj, pt = odefunc_params
    with pytest.raises(ValueError, match="atol > 0"):
        make_fused_dopri5_step(pt, DOPRI5, (7, 7), rtol=1e-3, atol=0.0)
    # conv_precision='bf16' builds the bf16 step (on the CPU its plain
    # version, tests/test_torch_bf16_kernels.py); other values are refused.
    with pytest.raises(ValueError, match="conv_precision"):
        make_fused_dopri5_step(pt, DOPRI5, (7, 7), rtol=1e-3, atol=1e-3,
                               conv_precision="tf32")
    with pytest.raises(ValueError, match="conv strategy"):
        make_fused_dopri5_step(pt, DOPRI5, (7, 7), rtol=1e-3, atol=1e-3,
                               conv_strategy="nope")
    # Every JAX strategy is the one kernel (on the CPU: its plain version).
    t0, dt, y0, f0 = (torch.from_numpy(a) for a in
                      _step_inputs(pj, cfg, 2, 7))
    outs = [make_fused_dopri5_step(pt, DOPRI5, (7, 7), rtol=1e-3, atol=1e-3,
                                   conv_strategy=s)(t0, dt, y0, f0)
            for s in CONV_STRATEGIES]
    for out in outs[1:]:
        for a, b in zip(out, outs[0]):
            assert torch.equal(a, b)


def test_gate():
    assert supported((7, 7), 64, 32)  # CIFAR-10
    assert supported((6, 6), 64, 32)  # MNIST
    assert supported((7, 7), 32, 32)
    # The tensor-core stage, 64-channel blocks (96: the last one padded;
    # 512: the state in global scratch, a ring of two weight buffers).
    for c in (96, 128, 256, 512):
        assert supported((7, 7), c, 32) and supported((6, 6), c, 32)
    assert not supported((7, 7), 544, 32)  # C > 512, as in JAX
    assert not supported((7, 7), 48, 32)  # C % groups
    assert not supported((7, 7), 80, 16)  # FFMA: C must divide 512 threads
    assert not supported((28, 28), 64, 32)  # shared memory


# ---- the tensor-core conv stage: gates, mirrors, arithmetic, the f output --


def test_stage_is_decided_by_the_shape():
    # The f32 builds: wgmma3 at C = 64 (and the other widths of WGMMA_C).
    assert stage((7, 7), 64) == "wgmma3"    # 7 * 9 = 63 padded-pitch positions
    assert stage((6, 6), 64) == "wgmma3"    # 48
    assert stage((1, 62), 64) == "wgmma3"   # exactly 64
    assert stage((1, 63), 64) == "ffma"     # 65
    assert stage((8, 8), 64) == "ffma"      # 80
    assert stage((7, 7), 32) == "ffma" and stage((8, 8), 128) == "ffma"
    for c in (96, 128, 192, 256, 288, 512):  # multiples of 32 up to 512
        want = "wgmma3" if c in WGMMA_C else "mma3"
        assert stage((7, 7), c) == stage((6, 6), c) == stage((5, 5), c) == want
        # The bf16 builds keep the mma.sync stage at every tensor-core shape.
        assert stage((7, 7), c, "bf16") == stage((6, 6), c, "bf16") == "mma3"
    assert stage((7, 7), 64, "bf16") == stage((7, 7), 64, "bf16_conv") == "mma3"
    for c in (80, 544):  # not a multiple of 32; over 512
        assert stage((7, 7), c) == "ffma"


def test_smem_mirrors_by_hand():
    # 7×7×64, 32 groups, the mma.sync layout (the bf16 builds'), in floats:
    # state 49·64; conv input (64 + 2·9 + 2 = 84 rows) × (64 + 8); ring 3 ×
    # 64 × 72; two partial-sum buffers of 512; 2 × 32 statistics.
    assert smem_bytes((7, 7), 64, 32, "mma3") == 4 * (
        3136 + 84 * 72 + 3 * 64 * 72 + 1024 + 64) == 96384
    # 6×6×64: 36·64; (64 + 2·8 + 2 = 82 rows) × 72.
    assert smem_bytes((6, 6), 64, 32, "mma3") == 4 * (
        2304 + 82 * 72 + 13824 + 1024 + 64) == 92480
    # The f32 builds' wgmma3 layout: its weight area (two split tiles, an
    # f32 tile and an mbarrier, 3 · 4096 + 4 floats) fits in the ring's.
    assert smem_bytes((7, 7), 64, 32) == smem_bytes((7, 7), 64, 32,
                                                    "mma3") == 96384
    assert smem_bytes((6, 6), 64, 32) == 92480
    # The FFMA layout at 7×7×64 (the probe's tap9): 81 rows × 64, two
    # (64, 64) weight buffers.
    assert smem_bytes((7, 7), 64, 32, "ffma") == 4 * (3136 + 81 * 64
                                                      + 2 * 4096 + 1024
                                                      + 64) == 70400
    # The backward's per-sample pass adds u (49·64), 6 × 32 statistics and
    # 4 × 64 channel sums.
    assert bwd_smem_bytes((7, 7), 64, 32) == 96384 + 4 * (3136 + 192
                                                          + 256) == 110720
    # Two CTAs per SM: 228 KB of shared memory, 1 KB reserved per CTA.
    for nbytes in (smem_bytes((7, 7), 64, 32) + 1024,  # + the static tableau
                   bwd_smem_bytes((7, 7), 64, 32)):
        assert 2 * (nbytes + 1024) <= 228 * 1024
    assert supported((7, 7), 64, 32, "ffma") and supported((1, 62), 64, 32)


@pytest.mark.parametrize("c", [32, 64, 128, 256, 512, 96, 160, 320, 480])
def test_gate_mirrors_at_every_width(c):
    """``stage``, ``smem_bytes``, ``supported`` and ``bwd_supported`` on the
    7×7 and 6×6 maps: C = 32 on the FFMA stage, every multiple of 32 from
    64 to 512 on the tensor cores (a 64·⌈C/64⌉ + 8-float conv-input pitch).
    By hand, the layout (``layout``): x in shared memory and a ring of three
    (64, 72) weight buffers where they fit; else x in global scratch, then
    a ring of two.  The backward first moves u to global scratch (on 7×7
    maps from C = 224, where C % 64 == 32 pads the conv input less)."""
    for hw in ((7, 7), (6, 6)):
        hh, ww = hw
        hwc = hh * ww * c
        assert stage(hw, c, "bf16") == ("ffma" if c == 32 else "mma3")
        assert stage(hw, c) in (("ffma",) if c == 32 else ("mma3", "wgmma3"))
        assert supported(hw, c, 32) and bwd_supported(hw, c, 32)
        fwd, bwd = layout(hw, c, 32), layout(hw, c, 32, backward=True)
        assert u_global(hw, c, 32) == bwd.u_global and not fwd.u_global
        if stage(hw, c) == "ffma":
            conv = (hh + 2) * (ww + 2) * c + 2 * c * c
            assert fwd == bwd[:4] + (fwd.smem,) == ("ffma", 3, False, False,
                                                    fwd.smem)
        else:
            rows, pitch = 64 + 2 * (ww + 2) + 2, 64 * -(-c // 64) + 8

            def weights(lay):
                # wgmma3's area (3 · 4096 + 4) where it outgrows the ring
                ring = lay.ring * 64 * 72
                return ring if lay.stage != "wgmma3" else max(ring, 12292)

            conv = rows * pitch + weights(fwd)

            def fits(*floats):
                return 4 * (sum(floats) + 1088) <= MAX_SMEM

            assert fwd.x_global == (not fits(hwc, rows * pitch, 3 * 64 * 72))
            assert (fwd.ring == 2) == (not fits(rows * pitch, 3 * 64 * 72))
            extra = 192 + 4 * c
            assert bwd.u_global == (not fits(2 * hwc, rows * pitch,
                                             3 * 64 * 72, extra))
            assert bwd.x_global == (not fits(hwc, rows * pitch, 3 * 64 * 72,
                                             extra))
            assert (bwd.ring == 2) == (not fits(rows * pitch, 3 * 64 * 72,
                                                extra))
        assert smem_bytes(hw, c, 32) == 4 * (
            (0 if fwd.x_global else hwc) + conv + 1088) <= MAX_SMEM
        bconv = conv
        if stage(hw, c) != "ffma":
            bconv = rows * pitch + weights(bwd)
        assert bwd_smem_bytes(hw, c, 32) == 4 * (
            (0 if bwd.x_global else hwc) + bconv + 1088 + 192 + 4 * c
            + (0 if bwd.u_global else hwc)) <= MAX_SMEM
    assert u_global((7, 7), c, 32) == (c >= 224)
    assert layout((7, 7), c, 32).x_global == (c >= 320)
    assert layout((7, 7), c, 32).ring == (2 if c >= 480 else 3)
    # By hand at 7×7×256: state 12,544 floats, conv input 84 × 264, ring
    # 13,824, partial sums 1,024, statistics 64: 198,528 bytes; with u the
    # backward would need 253,568, over the 231,424 a CTA may use.
    if c == 256:
        assert smem_bytes((7, 7), 256, 32) == 198528
        assert bwd_smem_bytes((7, 7), 256, 32) == 198528 + 4 * (192 + 1024)
        assert 198528 + 4 * (12544 + 192 + 1024) == 253568 > MAX_SMEM


def _gate_before_the_tensor_core_stage(hw, c, groups):
    """``supported`` as it was when the kernels had the FFMA stage alone."""
    hh, ww = hw
    if hh < 1 or ww < 1 or c < 4 or c % 4 or 512 % c or c % groups:
        return False, 0
    nbytes = 4 * (hh * ww * c + (hh + 2) * (ww + 2) * c + 2 * c * c + 512
                  + 2 * groups)
    return -(-hh * ww // (512 // c)) <= 8 and nbytes <= MAX_SMEM, nbytes


def test_gates_did_not_shrink():
    """Every shape the kernels took with the FFMA stage alone they still
    take, forward and backward."""
    taken = taken_bwd = 0
    sides = list(range(1, 13)) + [16, 31, 32, 62, 64, 128]
    for c in (4, 8, 16, 32, 64, 128, 256, 512):
        for groups in {1, 2, c // 4, c // 2, c, 32}:
            for hh in sides:
                for ww in sides:
                    was, nbytes = _gate_before_the_tensor_core_stage(
                        (hh, ww), c, groups)
                    if not was:
                        continue
                    taken += 1
                    assert supported((hh, ww), c, groups), (hh, ww, c, groups)
                    was_bwd = (c % 64 == 0 and nbytes + 4 * (
                        hh * ww * c + 512 + 6 * groups + 4 * c) <= MAX_SMEM)
                    if was_bwd:
                        taken_bwd += 1
                        assert bwd_supported((hh, ww), c, groups), (hh, ww, c,
                                                                    groups)
    assert taken > 1000 and taken_bwd > 100


def _tensor_core_conv2d(original):
    """``ops.layers.conv2d`` with every 3×3 C → C SAME conv (the ODEfunc's
    two) computed as the tensor-core stage computes it: three TF32 products
    per tap (``conv3x3_plain(passes=3)``).  Everything else as it was."""

    def conv2d(params, x, *, stride=1, padding="SAME"):
        k = params["kernel"]
        if (tuple(k.shape[:2]) == (3, 3) and k.shape[2] == k.shape[3]
                == x.shape[-1] and stride == 1 and padding == 1
                and x.dtype == torch.float32):
            conv2d.calls += 1
            return conv3x3_plain(x, k.float(), passes=3) + params["bias"]
        return original(params, x, stride=stride, padding=padding)

    conv2d.calls = 0
    return conv2d


def test_slice_matches_jax_under_the_tensor_core_arithmetic(monkeypatch):
    """The slice as a whole with the ODEfunc's convs in 3×TF32: per-sample
    NFE and the accept/reject counts equal the JAX package's exactly, logits
    within rtol = atol = 1e-3 (the slice's existing tolerance: the solver's
    own), on the same numpy-seeded input and JAX-initialised weights through
    the converter."""
    patched = _tensor_core_conv2d(layers.conv2d)
    monkeypatch.setattr(layers, "conv2d", patched)          # odefunc_apply
    monkeypatch.setattr(odefunc_mod, "conv2d", patched)     # odefunc_plain
    b = 4
    cfg_j = JaxConfig(in_channels=3, tol=1e-3, error_control="per_sample")
    params_j = jax_init_odenet(jax.random.PRNGKey(7), cfg_j)
    x = np.random.default_rng(0).normal(size=(b, 32, 32, 3)).astype(np.float32)
    logits, stats = odenet_logits(from_jax_params(params_j, device="cpu"),
                                  torch.from_numpy(x), ENTRY_CONFIG)
    # f0, the initial-step probe and 12 convs per fused attempt.
    assert patched.calls == 2 * 2 + 12 * int(((stats.nfe - 2) // 6).max())
    logits_j, stats_j = jax_logits(params_j, jnp.asarray(x), cfg_j)
    np.testing.assert_array_equal(stats.nfe.numpy(), np.asarray(stats_j.nfe))
    np.testing.assert_array_equal(stats.naccept.numpy(),
                                  np.asarray(stats_j.naccept))
    np.testing.assert_array_equal(stats.nreject.numpy(),
                                  np.asarray(stats_j.nreject))
    assert bool(stats.success.all())
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("batch,side", [(4, 7), (3, 6)])
def test_backward_f_output_matches_jax(odefunc_params, batch, side):
    """``odefunc_bwd_plain(with_f=True)`` and ``odefunc_vjp``: the f they
    return against the JAX fused kernel pair's forward (interpret mode) at
    the f(t, h) tolerance, and the VJP beside it against ``jax.grad``
    through that pair at the tolerances of tests/test_pallas.py (dh 2e-4 /
    2e-5, dθ 3e-4 / 3e-4: sums over B·H·W products)."""
    cfg, pj, pt = odefunc_params
    pj32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), pj)
    rng = np.random.default_rng(50 + side)
    h = rng.normal(size=(batch, side, side, 64)).astype(np.float32)
    g = rng.normal(size=h.shape).astype(np.float32)
    t = rng.uniform(0.1, 0.9, batch).astype(np.float32)
    hj, gj, tj = jnp.asarray(h), jnp.asarray(g), jnp.asarray(t)
    f_j = odefunc_pallas_vjp(pj32, tj, hj, 32, True)
    gp, gh = jax.grad(
        lambda p, hh: jnp.sum(odefunc_pallas_vjp(p, tj, hh, 32, True) * gj),
        argnums=(0, 1))(pj32, hj)

    w = prepare(pt, (side, side))
    args = (torch.from_numpy(t), torch.from_numpy(h), torch.from_numpy(g))
    dp, dt_b, dh, f = odefunc_bwd_plain(w, *args, 32, with_f=True)
    assert len(odefunc_bwd_plain(w, *args, 32)) == 3
    f_v, dp_v, dt_v, dh_v = odefunc_vjp(pt, *args, groups=32)
    assert torch.equal(f_v, f) and torch.equal(dh_v, dh)
    assert torch.equal(f, odefunc_plain(w, args[0], args[1], 32))
    assert not f.requires_grad and dt_v.shape == (batch,)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_j), **STATE_TOL)
    np.testing.assert_allclose(dh.numpy(), np.asarray(gh), rtol=2e-4,
                               atol=2e-5)
    flat_t = np.concatenate([dp[a][b].numpy().reshape(-1)
                             for a, b in PARAM_KEYS])
    flat_j = np.concatenate([np.asarray(gp[a][b]).reshape(-1)
                             for a, b in PARAM_KEYS])
    np.testing.assert_allclose(flat_t, flat_j, rtol=3e-4, atol=3e-4)
