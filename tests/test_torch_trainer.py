"""Port parity, the training step at the JAX ``TrainConfig`` defaults
(tol 1e-3, per-sample forward control, SGD with momentum) on
``synthetic-cifar10``, B = 4, full width, on the CPU: the per-sample forward
NFE, the backward NFE and one whole ``Trainer.train_batch`` against the JAX
``Trainer.train_batch`` from the same parameters; and the port's trainer on
its own (a few steps, direct backprop, the refusals)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.training import TrainConfig as JaxTrainConfig
from neural_ode_features_tpu.training import Trainer as JaxTrainer
from neural_ode_features_tpu_torch.data import Batches, load_dataset
from neural_ode_features_tpu_torch.entry import TRAIN_CONFIG, train_entry
from neural_ode_features_tpu_torch.training import TrainConfig, Trainer
from neural_ode_features_tpu_torch.utils import from_jax_params
from test_torch_training import (  # noqa: F401  (a fixture)
    BASE,
    _assert_gradient_bar,
    _flat_jax,
    _flat_torch,
    _jax_loss_and_grads,
    _port_loss,
    slice_inputs,
)

torch.set_num_threads(2)


def test_train_step_matches_jax_trainer(slice_inputs):
    params_j, images, labels = slice_inputs
    jcfg = JaxTrainConfig(**BASE, num_devices=1)
    tcfg = TrainConfig(**BASE)

    # The forward and backward NFE at the training defaults.
    _, _, stats_j, nfe_b_j = _jax_loss_and_grads(
        params_j, images, labels, jcfg.model_config())
    _, _, stats_t, _ = _port_loss(params_j, images, labels,
                                  tcfg.model_config())
    np.testing.assert_array_equal(stats_t.nfe.numpy(), np.asarray(stats_j.nfe))
    # A reverse accept decision within f32 roundoff of ratio 1 could flip
    # between the two frameworks and change nfe_b by one attempt (6
    # evaluations); with these weights and this batch none does.
    assert int(stats_t.nfe_b) == int(nfe_b_j)

    # One whole train_batch from the same parameters.
    jt = JaxTrainer(jcfg, steps_per_epoch=10)
    jt.params = jax.tree.map(jnp.array, params_j)  # the step donates them
    jt.opt_state = jt.tx.init(jt.params)
    mj = jax.device_get(jt.train_batch(images, labels.astype(np.int32),
                                       jax.random.PRNGKey(0)))
    tt = Trainer(tcfg, steps_per_epoch=10, device="cpu",
                 params=from_jax_params(params_j, device="cpu"))
    mt = tt.train_batch(images, labels)

    np.testing.assert_allclose(mt["loss"], float(mj["loss"]), rtol=1e-5)
    assert mt["nfe"] == float(mj["nfe"])
    assert mt["nfe_b"] == float(mj["nfe_b"])
    assert mt["acc"] == float(mj["acc"])
    trace_j = jt.opt_state[1][0].trace
    momentum = jax.tree.map(
        lambda q: tt.optimizer.state[q]["momentum_buffer"], tt.params)
    _assert_gradient_bar(_flat_torch(momentum), _flat_jax(trace_j))
    step_j = _flat_jax(jt.params) - _flat_jax(params_j)
    step_t = _flat_torch(tt.params) - _flat_jax(params_j)
    _assert_gradient_bar(step_t, step_j)
    np.testing.assert_allclose(_flat_torch(tt.params), _flat_jax(jt.params),
                               rtol=1e-3, atol=1e-4)


def test_train_entry_and_loss_decreases():
    """Six steps on one fixed batch lower the loss (the JAX
    tests/test_training.py:60 check), at the entry's configuration with
    augment on."""
    trainer, (images, labels) = train_entry(device="cpu", batch=8)
    assert trainer.cfg == dataclasses.replace(TRAIN_CONFIG, batch_size=8)
    assert images.shape == (8, 32, 32, 3) and images.dtype == np.uint8
    assert labels.dtype == np.int64
    assert trainer.steps_per_epoch == 50_000 // 8
    losses = []
    for _ in range(6):
        m = trainer.train_batch(images, labels)
        assert m["nfe"] >= 8 and m["nfe_b"] > 0
        losses.append(m["loss"])
    assert losses[-1] < losses[0], losses


def test_direct_backprop_and_epoch():
    """``adjoint=False`` backpropagates through the host-loop solve (no
    backward solve, so nfe_b is 0); ``train_epoch`` and ``evaluate`` run."""
    cfg = TrainConfig(dataset="synthetic-mnist", batch_size=4, tol=1e-2,
                      adjoint=False, optimizer="adam", weight_decay=1e-4,
                      hidden=32, augment=True)
    images, labels = load_dataset("synthetic-mnist", "train", limit=8)
    trainer = Trainer(cfg, steps_per_epoch=2, device="cpu")
    before = [p.detach().clone() for p in trainer._leaves]
    m = trainer.train_epoch(images, labels, epoch=0)
    assert m["loss"].shape == (2,) and bool(np.isfinite(m["loss"]).all())
    assert (m["nfe_b"] == 0).all()
    assert all(not torch.equal(a, b) for a, b in zip(before, trainer._leaves))
    ev = trainer.evaluate(Batches(images[:6], labels[:6], 4, shuffle=False,
                                  drop_remainder=False))
    assert 0.0 <= ev["acc"] <= 1.0 and ev["nfe"] > 0


def test_step_scopes_deterministic_cudnn(monkeypatch):
    """A step runs cuDNN's deterministic algorithms with no autotuning
    (bit-reproducible training on the card) and leaves the process's flags
    as it found them: building a ``Trainer`` sets nothing global."""
    cudnn = torch.backends.cudnn
    monkeypatch.setattr(cudnn, "deterministic", False)
    monkeypatch.setattr(cudnn, "benchmark", True)
    trainer = Trainer(TrainConfig(dataset="synthetic-mnist", model="resnet",
                                  hidden=32, batch_size=2),
                      steps_per_epoch=1, device="cpu")
    assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
    seen = []
    inner = trainer._loss_and_logits

    def watched(*args):
        seen.append((cudnn.deterministic, cudnn.benchmark))
        return inner(*args)

    monkeypatch.setattr(trainer, "_loss_and_logits", watched)
    images, labels = load_dataset("synthetic-mnist", "train", limit=2)
    trainer.train_batch(images, labels)
    assert seen == [(True, False)]
    assert (cudnn.deterministic, cudnn.benchmark) == (False, True)


def test_schedule_is_optax_piecewise_constant():
    trainer = Trainer(TrainConfig(dataset="synthetic-mnist", hidden=32,
                                  lr_decay_epochs=(1, 3)),
                      steps_per_epoch=5, device="cpu")
    assert [trainer.schedule(s) for s in (0, 4, 5, 14, 15)] == pytest.approx(
        [0.1, 0.1, 0.01, 0.01, 0.001])


@pytest.mark.parametrize("change", [
    dict(model="densenet"), dict(num_devices=2), dict(model_shards=2),
    dict(compute_dtype="bfloat16")])
def test_trainer_refusals(change, monkeypatch):
    """What is not ported names its ROADMAP.md item; ``model='resnet'``
    trains now (``test_torch_train_cli.py``), an unknown model is an
    error; a mesh (``num_devices`` or ``model_shards`` > 1) needs the ranks
    of a process group (``parallel.launch``, ``test_torch_parallel.py``),
    which this test process has not.  bfloat16 is refused no more: aimed
    at the card, the trainer takes the card (the device it is given is
    then the CPU, which this machine has) with the bf16 dynamics, which it
    trains in the kernels' bf16 builds (``test_torch_bf16.py``)."""
    if "compute_dtype" in change:
        from neural_ode_features_tpu_torch import training

        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        asked, resolve = [], training.resolve_device
        monkeypatch.setattr(training, "resolve_device", lambda d: (
            asked.append(resolve(d).type), torch.device("cpu"))[1])
        trainer = Trainer(TrainConfig(**change), steps_per_epoch=1,
                          device="cuda")
        assert asked == ["cuda"]
        assert trainer.model_cfg.cdtype == torch.bfloat16
        return
    if "model" in change:
        exc, match = ValueError, "unknown model"
    else:
        exc, match = RuntimeError, "parallel.launch"
    with pytest.raises(exc, match=match):
        Trainer(TrainConfig(**change), steps_per_epoch=1, device="cpu")


def test_state_files_refused():
    """The orbax pair stays unported; the ``torch.save`` state file is
    covered by ``test_state_file_round_trip``."""
    trainer = Trainer(TrainConfig(dataset="synthetic-mnist", hidden=32),
                      steps_per_epoch=1, device="cpu")
    for fn in (trainer.save_state_orbax, trainer.load_state_orbax):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn("state")


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_state_file_round_trip(tmp_path, optimizer):
    """``save_state`` → ``load_state`` into a fresh trainer: parameters,
    optimizer state and step count come back, so the next step is the same
    to the bit."""
    cfg = TrainConfig(dataset="synthetic-mnist", hidden=8, adjoint=False,
                      augment=False, batch_size=4, optimizer=optimizer,
                      lr=0.01, lr_decay_epochs=(1,))
    images, labels = load_dataset("synthetic-mnist", "train", limit=4)
    a = Trainer(cfg, steps_per_epoch=2, device="cpu")
    fresh = tmp_path / "fresh.pt"
    a.save_state(fresh)  # before any step: no optimizer tensors yet
    a.train_batch(images, labels)
    a.train_batch(images, labels)
    a.save_state(tmp_path / "state.pt")
    state = torch.load(tmp_path / "state.pt", weights_only=True)
    assert all(isinstance(v, torch.Tensor) for v in state.values())

    b = Trainer(dataclasses.replace(cfg, seed=5), steps_per_epoch=2,
                device="cpu")
    b.load_state(tmp_path / "state.pt")
    assert b.step_count == 2
    for p, q in zip(a._leaves, b._leaves):
        assert torch.equal(p, q)
    ma, mb = a.train_batch(images, labels), b.train_batch(images, labels)
    assert ma == mb
    for p, q in zip(a._leaves, b._leaves):
        assert torch.equal(p, q)
    b.load_state(fresh)
    assert b.step_count == 0 and not b.optimizer.state[b._leaves[0]]
