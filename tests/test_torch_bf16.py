"""Port parity, bfloat16 dynamics on the CPU: ``compute_dtype='bfloat16'``
runs where the JAX package runs it, on its jnp path (the dynamics in bf16,
the solver state in f32), for inference, the adjoint, direct backprop, the
``Trainer`` and ``train --bf16 --cpu``.  On the card the same calls run
the bf16 builds of the ODEfunc kernel and of its backward
(``tests/test_torch_bf16_kernels.py``, ``tests/test_torch_cuda.py``).

The tolerance against the JAX package.  bf16 keeps an 8-bit significand,
so one rounding is off by up to u = 2^-8 ≈ 3.9e-3 of its value.  The two
packages round in different places: XLA may keep f32 inside a fusion
(``xla_allow_excess_precision``), PyTorch rounds after every op.  So each
evaluation of f differs by a few u·|f| between them.  Over [0, 1] and
through the f32 head, logits of magnitude below 1 differ by about u: the
bar is 5e-3 (1.3 u).  A cross-entropy moves by at most twice the largest
logit change, and four SGD steps add a little: the losses' bar is 1e-2.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from neural_ode_features_tpu.models import ModelConfig as JaxModelConfig
from neural_ode_features_tpu.models import init_odenet as jax_init_odenet
from neural_ode_features_tpu.models import odenet_logits as jax_odenet_logits
from neural_ode_features_tpu_torch import train as port_train
from neural_ode_features_tpu_torch import training
from neural_ode_features_tpu_torch.kernels import odefunc as odefunc_mod
from neural_ode_features_tpu_torch.kernels.odefunc import (
    odefunc_plain,
    prepare,
)
from neural_ode_features_tpu_torch.kernels.odefunc_bwd import (
    odefunc_bwd_plain,
)
from neural_ode_features_tpu_torch.models import (
    ModelConfig,
    block_dynamics,
    init_odenet,
    odefunc_apply,
    odenet_logits,
)
from neural_ode_features_tpu_torch.training import TrainConfig, Trainer
from neural_ode_features_tpu_torch.utils import from_jax_params

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import train as jax_train  # noqa: E402  (the root CLI)

torch.set_num_threads(2)

LOGIT_ATOL = 5e-3   # about u = 2^-8 at |logits| < 1 (module docstring)
LOSS_ATOL = 1e-2    # twice the logits' bar, and four SGD steps
CFG16 = ModelConfig(in_channels=1, tol=1e-2, compute_dtype="bfloat16")
CFG32 = ModelConfig(in_channels=1, tol=1e-2)


def _x(b: int) -> np.ndarray:
    return np.random.default_rng(0).normal(size=(b, 28, 28, 1)).astype(
        np.float32)


def _grads(params, x, cfg, direct: bool):
    ps = pytree.tree_map(lambda p: p.clone().requires_grad_(), params)
    if direct:
        logits, _ = training._direct_diff_logits(ps, x, cfg)
    else:
        logits, _ = odenet_logits(ps, x, cfg, adjoint=True)
    grads = torch.autograd.grad(logits.sum(), pytree.tree_leaves(ps))
    return torch.cat([g.reshape(-1) for g in grads])


def test_bfloat16_compute_path():
    """JAX ``tests/test_models.py`` ``test_bfloat16_compute_path``: f32
    logits, all finite; and the dynamics did compute in bf16."""
    params = init_odenet(0, CFG16, device="cpu")
    x = torch.from_numpy(_x(2))
    logits, stats = odenet_logits(params, x, CFG16)
    assert logits.dtype == torch.float32  # the solver state stays f32
    assert torch.isfinite(logits).all() and logits.shape == (2, 10)
    assert (stats.nfe > 0).all()
    logits32, _ = odenet_logits(params, x, CFG32)
    assert float((logits - logits32).abs().max()) > 1e-5


@pytest.mark.parametrize("direct", [False, True], ids=["adjoint", "direct"])
def test_bfloat16_adjoint_training_grads(direct):
    """JAX ``test_bfloat16_adjoint_training_grads``: gradients finite, the
    bf16 gradient norm within 15% of f32's; also by direct backprop."""
    params = init_odenet(0, CFG32, device="cpu")
    x = torch.from_numpy(_x(4))
    g16, g32 = (_grads(params, x, cfg, direct) for cfg in (CFG16, CFG32))
    assert torch.isfinite(g16).all() and torch.isfinite(g32).all()
    n16, n32 = float(g16.norm()), float(g32.norm())
    assert abs(n16 - n32) / n32 < 0.15, (n16, n32)


def test_bfloat16_logits_match_jax():
    """The same params and input through the JAX jnp path and the port,
    both in bf16: equal NFE, logits within ``LOGIT_ATOL``."""
    jcfg = JaxModelConfig(in_channels=1, tol=1e-2, compute_dtype="bfloat16")
    params_j = jax.device_get(jax_init_odenet(jax.random.PRNGKey(0), jcfg))
    x = _x(8)
    logits_j, stats_j = jax.jit(
        lambda p, xx: jax_odenet_logits(p, xx, jcfg))(params_j,
                                                     jnp.asarray(x))
    logits, stats = odenet_logits(from_jax_params(params_j, device="cpu"),
                                  torch.from_numpy(x), CFG16)
    np.testing.assert_array_equal(stats.nfe.numpy(), np.asarray(stats_j.nfe))
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                               rtol=0, atol=LOGIT_ATOL)


def test_train_bf16_cpu_matches_the_jax_cli(tmp_path, monkeypatch):
    """``train --bf16 --cpu`` for one short epoch from the JAX initial
    weights (carried by ``from_jax_params``), augment off so both packages
    see the same batches: the JAX CLI's run directory name and
    ``params.json`` bytes, the same NFE and test accuracy, and the losses
    within ``LOSS_ATOL``."""
    def carried(seed, cfg, *, device="cuda"):
        jcfg = JaxModelConfig(**dataclasses.asdict(cfg))
        return from_jax_params(jax.device_get(jax_init_odenet(
            jax.random.PRNGKey(seed), jcfg)), device=device)

    monkeypatch.setattr(training, "init_odenet", carried)
    argv = ["--cpu", "--bf16", "--dataset", "synthetic-mnist", "--hidden",
            "32", "--limit", "64", "--batch-size", "16", "--tol", "1e-2",
            "--epochs", "1", "--no-augment"]
    jax_dir = Path(jax_train.main([*argv, "--runs-dir",
                                   str(tmp_path / "jax")]))
    port_dir = Path(port_train.main([*argv, "--runs-dir",
                                     str(tmp_path / "port")]))
    assert "bf16_True" in port_dir.name and port_dir.name == jax_dir.name
    assert ((port_dir / "params.json").read_bytes()
            == (jax_dir / "params.json").read_bytes())
    rows = [(d / "log.csv").read_text().splitlines() for d in (port_dir,
                                                                jax_dir)]
    assert rows[0][0] == rows[1][0]
    got, want = (dict(zip(r[0].split(","), r[1].split(","))) for r in rows)
    for k in ("epoch", "nfe_f", "nfe_b", "test_acc"):
        assert got[k] == want[k], (k, got, want)
    for k in ("train_loss", "test_loss"):
        assert abs(float(got[k]) - float(want[k])) <= LOSS_ATOL, (k, got,
                                                                   want)


def test_bf16_on_the_card_raises_before_any_launch(monkeypatch):
    """A bf16 ``Trainer`` step aimed at the card is no longer refused: the
    trainer takes the card (``torch.cuda.is_available`` patched true, the
    device then swapped for the CPU, where this machine computes) and its
    step's every evaluation asks for the ODEfunc kernel's bf16 build, none
    for the f32 build; the adjoint's VJPs are the backward's bf16 build
    (``test_block_dynamics_honours_compute_dtype``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    asked = []
    resolve = training.resolve_device

    def resolve_device(device):
        asked.append(resolve(device).type)
        return torch.device("cpu")

    monkeypatch.setattr(training, "resolve_device", resolve_device)
    seen = []
    plain = odefunc_mod.odefunc_plain

    def forward(w, t, h, groups, precision="f32"):
        seen.append(precision)
        return plain(w, t, h, groups, precision)

    monkeypatch.setattr(odefunc_mod, "odefunc_plain", forward)
    trainer = Trainer(TrainConfig(dataset="synthetic-mnist", hidden=32,
                                  tol=1e-2, batch_size=4,
                                  compute_dtype="bfloat16"),
                      steps_per_epoch=1, device="cuda")
    m = trainer.train_batch(
        torch.from_numpy(np.random.default_rng(2).integers(
            0, 256, (4, 28, 28, 1), dtype=np.uint8)), torch.arange(4))
    assert asked == ["cuda"] and np.isfinite(float(m["loss"]))
    assert seen and set(seen) == {"bf16"}


def test_block_dynamics_honours_compute_dtype():
    """``block_dynamics`` (the adjoint's and the event adjoint's dynamics)
    with a bf16 configuration gives the plain bf16 f and the plain bf16
    VJP (the bf16 builds' plain versions on the CPU), not f32's."""
    params = init_odenet(0, CFG16, device="cpu")["odefunc"]
    rng = np.random.default_rng(3)
    h = torch.from_numpy((rng.normal(size=(3, 6, 6, 64)) * 0.3).astype(
        np.float32))
    a = torch.from_numpy(rng.normal(size=h.shape).astype(np.float32))
    t = torch.tensor(0.37)
    w = prepare(params, (6, 6))
    for cfg, precision in ((CFG16, "bf16"), (CFG32, "f32")):
        dyn, vjp = block_dynamics(params, h, cfg)
        f = dyn(params, t, h)
        assert torch.equal(f, odefunc_apply(params, t, h, cfg))
        assert torch.equal(f, odefunc_plain(w, t, h, cfg.groups, precision))
        f2, dp, dt, dh = vjp(params, t, h, a)
        dp_w, dt_w, dh_w, f_w = odefunc_bwd_plain(w, t, h, a, cfg.groups,
                                                  True, precision)
        assert torch.equal(f2, f) and torch.equal(f_w, f)
        assert torch.equal(dh, dh_w) and torch.equal(dt, dt_w.sum())
        assert all(torch.equal(dp[k][n], dp_w[k][n]) for k in dp
                   for n in dp[k])
        if precision == "bf16":
            f16, dh16 = f, dh
    assert float((f16 - f).abs().max()) > 1e-3
    assert float((dh16 - dh).abs().max()) > 1e-3
