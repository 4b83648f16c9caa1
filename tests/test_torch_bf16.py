"""Port parity, bfloat16 dynamics on the CPU: ``compute_dtype='bfloat16'``
runs where the JAX package runs it, on its jnp path (the dynamics in bf16,
the solver state in f32), for inference, the adjoint, direct backprop, the
``Trainer`` and ``train --bf16 --cpu``; on the card every one of them
raises before any launch, naming ROADMAP.md Queue 2 item 5.

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
from neural_ode_features_tpu_torch.kernels.odefunc import odefunc
from neural_ode_features_tpu_torch.kernels.odefunc_bwd import odefunc_bwd
from neural_ode_features_tpu_torch.models import (
    ModelConfig,
    check_compute_dtype,
    init_odenet,
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


def test_bf16_on_the_card_raises_before_any_launch(monkeypatch, tmp_path):
    """A bf16 request aimed at the card raises naming Queue 2 item 5, and
    neither launch counter moves."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    before = odefunc.launches, odefunc_bwd.launches
    with pytest.raises(NotImplementedError, match="Queue 2 item 5"):
        check_compute_dtype(CFG16, torch.device("cuda"))
    check_compute_dtype(CFG32, "cuda")
    check_compute_dtype(CFG16, "cpu")
    with pytest.raises(NotImplementedError, match="Queue 2 item 5"):
        Trainer(TrainConfig(dataset="synthetic-mnist",
                            compute_dtype="bfloat16"),
                steps_per_epoch=1, device="cuda")
    assert (odefunc.launches, odefunc_bwd.launches) == before
