"""Port parity, the training slice's data side: ``augment`` (fed the JAX
package's own random draws), the synthetic twins' bytes, the ``Batches``
shuffle and the meters, against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.data import Batches as JaxBatches
from neural_ode_features_tpu.data import load_dataset as jax_load_dataset
from neural_ode_features_tpu.ops.preprocess import augment as jax_augment
from neural_ode_features_tpu.ops.preprocess import (
    normalized_black as jax_normalized_black,
)
from neural_ode_features_tpu.utils.meters import (
    AverageMeter as JaxAverageMeter,
)
from neural_ode_features_tpu.utils.meters import (
    RunningAverageMeter as JaxRunningAverageMeter,
)
from neural_ode_features_tpu_torch.data import Batches, load_dataset
from neural_ode_features_tpu_torch.ops import (
    augment,
    crop_and_flip,
    normalize,
    normalized_black,
)
from neural_ode_features_tpu_torch.utils import (
    AverageMeter,
    RunningAverageMeter,
    count_parameters,
)


@pytest.mark.parametrize("dataset,flip", [("synthetic-cifar10", True),
                                          ("synthetic-mnist", False)])
def test_augment_matches_jax_exactly(dataset, flip):
    images, _ = load_dataset(dataset, "train", limit=16)
    x = normalize(torch.from_numpy(images), dataset)
    key = jax.random.PRNGKey(3)
    fill_j = jax_normalized_black(dataset, jnp.float32)
    want = jax_augment(key, jnp.asarray(x.numpy()), pad=4, flip=flip,
                       fill=fill_j)
    # The draws of preprocess.py:61-75, made the same way.
    k_crop, k_flip = jax.random.split(key)
    offs = np.array(jax.random.randint(k_crop, (16, 2), 0, 9))
    flips = (np.array(jax.random.bernoulli(k_flip, 0.5, (16,)))
             if flip else None)
    fill = normalized_black(dataset)
    np.testing.assert_array_equal(fill.numpy(), np.asarray(fill_j))
    got = crop_and_flip(x, torch.from_numpy(offs),
                        None if flips is None else torch.from_numpy(flips),
                        pad=4, fill=fill)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_augment_draws_from_the_generator():
    x = torch.arange(2 * 4 * 4 * 3, dtype=torch.float32).reshape(2, 4, 4, 3)
    a = augment(x, torch.Generator().manual_seed(1), pad=2, fill=-1.0)
    b = augment(x, torch.Generator().manual_seed(1), pad=2, fill=-1.0)
    assert torch.equal(a, b) and a.shape == x.shape
    # Every output pixel is an input pixel or the fill.
    assert bool(torch.isin(a, torch.cat([x.reshape(-1),
                                         torch.tensor([-1.0])])).all())
    centred = crop_and_flip(x, torch.full((2, 2), 2), None, pad=2)
    assert torch.equal(centred, x)


@pytest.mark.parametrize("name", ["synthetic-cifar10", "synthetic-mnist"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_synthetic_bytes_match_jax(name, split):
    got = load_dataset(name, split, limit=64)
    want = jax_load_dataset(name, split, limit=64)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_raw_loaders_refused(tmp_path):
    """Without the raw files the loaders raise as the JAX loader does, with
    the same message; the files themselves: tests/test_torch_foreign.py."""
    for name in ("cifar10", "mnist"):
        with pytest.raises(FileNotFoundError) as mine:
            load_dataset(name, "train", str(tmp_path))
        with pytest.raises(FileNotFoundError) as ref:
            jax_load_dataset(name, "train", str(tmp_path))
        assert str(mine.value) == str(ref.value)
    with pytest.raises(ValueError, match="unknown dataset"):
        load_dataset("imagenet", "train")


def test_batches_order_matches_jax():
    images = np.arange(23)[:, None].astype(np.uint8)
    labels = np.arange(23)
    for kw in (dict(seed=4), dict(shuffle=False, drop_remainder=False)):
        mine, ref = Batches(images, labels, 5, **kw), JaxBatches(
            images, labels, 5, **kw)
        assert len(mine) == len(ref)
        for _ in range(2):  # two epochs: the permutation changes
            for (a, la), (b, lb) in zip(mine, ref, strict=True):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(la, lb)
        for got, want in zip(mine.padded_batches(), ref.padded_batches(),
                             strict=True):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_meters_match_jax():
    vals = [3.0, 1.0, 4.0, 1.5]
    pairs = [(RunningAverageMeter(0.9), JaxRunningAverageMeter(0.9)),
             (AverageMeter(), JaxAverageMeter())]
    for mine, ref in pairs:
        for v in vals:
            mine.update(v)
            ref.update(v)
        assert mine.avg == ref.avg
    params = {"a": torch.zeros(3, 4), "b": [torch.zeros(5)]}
    assert count_parameters(params) == 17
