"""Port parity, the slice as a whole: the ODE-Net adjoint training step on
``synthetic-cifar10`` at full width (hidden 64), B = 4, on the CPU, from the
same weights and batch as the JAX package, augment off.

* At tol 1e-5 with global control, the loss and the adjoint gradients
  against the JAX plain (jnp) adjoint path, at the bar of
  tests/test_pallas.py:142-145.
* At the training defaults: tests/test_torch_trainer.py."""

import dataclasses

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from neural_ode_features_tpu.data import load_dataset as jax_load_dataset
from neural_ode_features_tpu.models import init_odenet as jax_init_odenet
from neural_ode_features_tpu.models import odenet_logits as jax_logits
from neural_ode_features_tpu.ops.preprocess import normalize as jax_normalize
from neural_ode_features_tpu.training import TrainConfig as JaxTrainConfig
from neural_ode_features_tpu_torch.data import load_dataset
from neural_ode_features_tpu_torch.models import odenet_logits
from neural_ode_features_tpu_torch.ops import normalize
from neural_ode_features_tpu_torch.training import TrainConfig
from neural_ode_features_tpu_torch.utils import from_jax_params

torch.set_num_threads(2)

B = 4
BASE = dict(dataset="synthetic-cifar10", batch_size=B, augment=False)


def _flat_jax(tree):
    return np.asarray(jax.flatten_util.ravel_pytree(tree)[0], np.float64)


def _flat_torch(tree):
    """Flatten in the JAX order (dict keys sorted, leaves in sequence)."""
    if isinstance(tree, dict):
        return np.concatenate([_flat_torch(tree[k]) for k in sorted(tree)])
    return tree.detach().double().numpy().reshape(-1)


def _assert_gradient_bar(got, want):
    """tests/test_pallas.py:142-145: direction and magnitude."""
    rel_l2 = np.linalg.norm(got - want) / np.linalg.norm(want)
    cos = float(np.dot(got, want)
                / (np.linalg.norm(got) * np.linalg.norm(want)))
    assert rel_l2 < 1e-2, rel_l2
    assert cos > 0.9999, cos


@pytest.fixture(scope="module")
def slice_inputs():
    cfg = JaxTrainConfig(**BASE).model_config()
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                          jax_init_odenet(jax.random.PRNGKey(11), cfg))
    images, labels = load_dataset("synthetic-cifar10", "train", limit=B)
    return params, images, labels.astype(np.int64)


def _port_loss(params_j, images, labels, cfg):
    params = from_jax_params(params_j, device="cpu")
    leaves = [p.requires_grad_() for p in jax.tree.leaves(params)]
    x = normalize(torch.from_numpy(images), "synthetic-cifar10")
    logits, stats = odenet_logits(params, x, cfg, adjoint=True)
    loss = F.cross_entropy(logits, torch.from_numpy(labels))
    loss.backward()
    return float(loss.detach()), params, stats, leaves


def _jax_loss_and_grads(params, images, labels, cfg):
    x = jax_normalize(jnp.asarray(images), "synthetic-cifar10")

    def loss(p, sink):
        logits, stats = jax_logits(p, x, cfg, adjoint=True, nfe_sink=sink)
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean()
        return ce, stats

    (val, stats), (grads, nfe_b) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.zeros(()))
    return float(val), grads, stats, float(nfe_b)


def test_data_matches_jax(slice_inputs):
    _, images, labels = slice_inputs
    want_x, want_y = jax_load_dataset("synthetic-cifar10", "train", limit=B)
    np.testing.assert_array_equal(images, want_x)
    np.testing.assert_array_equal(labels, want_y)


def test_adjoint_gradients_match_jax_at_tight_tol(slice_inputs):
    params_j, images, labels = slice_inputs
    cfg_j = dataclasses.replace(JaxTrainConfig(**BASE).model_config(),
                                tol=1e-5, error_control="global",
                                max_steps=512)
    cfg_t = dataclasses.replace(TrainConfig(**BASE).model_config(),
                                tol=1e-5, error_control="global",
                                max_steps=512)
    loss_j, grads_j, _, _ = _jax_loss_and_grads(params_j, images, labels,
                                                cfg_j)
    loss_t, params_t, stats, _ = _port_loss(params_j, images, labels, cfg_t)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    grads_t = jax.tree.map(lambda p: p.grad, params_t)
    _assert_gradient_bar(_flat_torch(grads_t), _flat_jax(grads_j))
    assert int(stats.nfe_b) > 0


class _Stop(Exception):
    pass


@pytest.mark.parametrize("max_steps", [4096, 100])
def test_interpolated_forward_has_the_jax_bound(monkeypatch, max_steps):
    """The ODE-Net's interpolated adjoint bounds its dense forward as the
    JAX ``_solve`` does: ``min(cfg.max_steps, 256)`` attempts."""
    import neural_ode_features_tpu.models.odenet as jax_odenet
    import neural_ode_features_tpu_torch.models.odenet as port_odenet

    seen = {}
    for tag, mod in (("jax", jax_odenet), ("port", port_odenet)):
        def spy(*args, tag=tag, **kw):
            seen[tag] = kw["dense_max_steps"]
            raise _Stop
        monkeypatch.setattr(mod, "odeint_adjoint", spy)
    base = dict(in_channels=1, hidden=32, adjoint_mode="interpolated",
                max_steps=max_steps)
    params_j = jax_init_odenet(jax.random.PRNGKey(0),
                               JaxTrainConfig(dataset="synthetic-mnist",
                                              hidden=32).model_config())
    x = np.zeros((2, 28, 28, 1), np.float32)
    from neural_ode_features_tpu.models import ModelConfig as JaxModelConfig
    from neural_ode_features_tpu_torch.models import ModelConfig
    with pytest.raises(_Stop):
        jax_logits(params_j, jnp.asarray(x), JaxModelConfig(**base),
                   adjoint=True)
    with pytest.raises(_Stop):
        odenet_logits(from_jax_params(params_j, device="cpu"),
                      torch.from_numpy(x), ModelConfig(**base), adjoint=True)
    assert seen["port"] == seen["jax"] == min(max_steps, 256)


def test_adjoint_path_takes_a_tol_override():
    """``odenet_logits(adjoint=True, tol=1e-4)`` solves both directions at
    that tolerance, as the JAX ``_solve``: the same per-sample NFE as the
    JAX function (more than at ``cfg.tol``), the loss at rtol 1e-5 and the
    gradients at the bar above (hidden 32, 6×6 maps, B = 4, compared in
    float64)."""
    base = dict(dataset="synthetic-mnist", batch_size=B, augment=False,
                hidden=32)
    cfg_j = JaxTrainConfig(**base).model_config()
    cfg_t = TrainConfig(**base).model_config()
    params_j = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                            jax_init_odenet(jax.random.PRNGKey(5), cfg_j))
    images, labels = load_dataset("synthetic-mnist", "train", limit=B)
    labels = labels.astype(np.int64)
    x_j = jax_normalize(jnp.asarray(images), "synthetic-mnist")

    def loss_j(p):
        logits, stats = jax_logits(p, x_j, cfg_j, adjoint=True, tol=1e-4)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean(), stats

    (val_j, st_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(
        params_j)
    params = from_jax_params(params_j, device="cpu")
    leaves = [p.requires_grad_() for p in jax.tree.leaves(params)]
    x = normalize(torch.from_numpy(images), "synthetic-mnist")
    logits, stats = odenet_logits(params, x, cfg_t, adjoint=True, tol=1e-4)
    loss = F.cross_entropy(logits, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_array_equal(stats.nfe.numpy(), np.asarray(st_j.nfe))
    _, stats_default = odenet_logits(params, x, cfg_t, adjoint=True)
    assert int(stats.nfe.sum()) > int(stats_default.nfe.sum())
    np.testing.assert_allclose(float(loss.detach()), float(val_j), rtol=1e-5)
    _assert_gradient_bar(_flat_torch(jax.tree.map(lambda p: p.grad, params)),
                         _flat_jax(grads_j))
    assert len(leaves) == len(jax.tree.leaves(params_j))
