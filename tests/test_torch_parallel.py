"""Port parity, training across devices: ``parallel/`` and the trainer on a
mesh of gloo ranks spawned on the CPU (``parallel.launch``), against the
port's one-device run and the JAX ``Trainer(num_devices=2)``.

The configuration is the JAX test's ``_cfg`` (tests/test_training.py:26-38:
``synthetic-mnist``, B = 16, tol 1e-2, lr 0.05, augment off, hidden 64) and
the bars are its (:73-99): the step-1 loss at rtol 1e-6 with the forward NFE
equal; the step-2 loss at rtol 3e-4 with the forward NFE equal and ``nfe_b``
within 1.  Each mesh is one launch that runs every case of it in turn
(``parallel.tasks.in_turn``), with a time limit, so that a hang fails its
tests instead of the run.  ``param_spec`` / ``param_shardings`` and the
blocks that ``local_part`` takes need no ranks."""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard
from torch.utils import _pytree as pytree

from neural_ode_features_tpu.models import ModelConfig as JaxModelConfig
from neural_ode_features_tpu.models import init_odenet as jax_init_odenet
from neural_ode_features_tpu.models import init_resnet as jax_init_resnet
from neural_ode_features_tpu.parallel import param_shardings as jax_shardings
from neural_ode_features_tpu.parallel import param_spec as jax_param_spec
from neural_ode_features_tpu.training import TrainConfig as JaxTrainConfig
from neural_ode_features_tpu.training import Trainer as JaxTrainer
from neural_ode_features_tpu_torch.data import load_dataset
from neural_ode_features_tpu_torch.models import ModelConfig
from neural_ode_features_tpu_torch.models import init_odenet, init_resnet
from neural_ode_features_tpu_torch.parallel import (
    launch,
    local_part,
    param_shardings,
    param_spec,
    population_sharding,
    shard_batch,
)
from neural_ode_features_tpu_torch.parallel.tasks import in_turn, train_steps
from neural_ode_features_tpu_torch.training import TrainConfig, Trainer
from neural_ode_features_tpu_torch.utils import from_jax_params

torch.set_num_threads(2)

LAUNCH_S = 120  # one mesh's launch, every case of it


def _cfg(**kw):
    base = dict(dataset="synthetic-mnist", model="odenet", tol=1e-2,
                adjoint=True, batch_size=16, lr=0.05, augment=False,
                epochs=1)
    base.update(kw)
    return TrainConfig(**base)


@pytest.fixture(scope="module")
def data():
    x, y = load_dataset("synthetic-mnist", "train", limit=64)
    return x, y.astype(np.int64)


def _batches(x, y, n_steps=2, bs=16):
    return [(x[(i * bs) % len(x):(i * bs) % len(x) + bs],
             y[(i * bs) % len(x):(i * bs) % len(x) + bs])
            for i in range(n_steps)]


def _solo(cfg, batches, params=None):
    trainer = Trainer(dataclasses.replace(cfg, num_devices=1,
                                          model_shards=1),
                      steps_per_epoch=4, device="cpu", params=params)
    return trainer, [trainer.train_batch(*b) for b in batches]


def _assert_jax_bars(got, want):
    """tests/test_training.py:73-99 on two steps' metrics."""
    np.testing.assert_allclose(got[0]["loss"], want[0]["loss"], rtol=1e-6)
    assert got[0]["nfe"] == want[0]["nfe"]
    np.testing.assert_allclose(got[1]["loss"], want[1]["loss"], rtol=3e-4)
    assert got[1]["nfe"] == want[1]["nfe"]
    assert abs(got[1]["nfe_b"] - want[1]["nfe_b"]) <= 1.0


def _jax_params():
    cfg = JaxTrainConfig(dataset="synthetic-mnist").model_config()
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                        jax_init_odenet(jax.random.PRNGKey(3), cfg))


# -- two ranks ---------------------------------------------------------------
TWO = {
    "base": dict(),
    "global": dict(error_control="global"),
    "seminorm": dict(adjoint_seminorm=True),
    "interpolated": dict(adjoint_mode="interpolated"),
    "adams_global": dict(solver="adams", error_control="global"),
    "direct_global": dict(adjoint=False, max_steps=64,
                          error_control="global"),
}


@pytest.fixture(scope="module")
def two_ranks(data):
    """One launch of 2 ranks: the JAX configuration, its global-control and
    seminorm variants, the JAX weights, the norm case at tol 1e-3."""
    x, y = data
    jobs = [(train_steps, (_cfg(num_devices=2, **kw), _batches(x, y)),
             {"device": "cpu"}) for kw in TWO.values()]
    jobs.append((train_steps, (_cfg(num_devices=2), _batches(x, y)),
                 {"device": "cpu",
                  "params": from_jax_params(_jax_params(), device="cpu")}))
    jobs.append((train_steps, (_cfg(num_devices=2, tol=1e-3),
                               _batches(x, y, 1)), {"device": "cpu"}))
    res = launch(in_turn, 2, jobs, devices=["cpu", "cpu"], timeout=LAUNCH_S)
    names = [*TWO, "jax", "norm"]
    return {name: [r[i] for r in res] for i, name in enumerate(names)}


@pytest.mark.parametrize("case", list(TWO))
def test_dp_two_ranks_matches_one_device(data, two_ranks, case):
    """Every rank reports the whole batch's metrics, the same on each; they
    meet JAX's bars against the one-device run: per-sample and global
    forward control, the seminorm and interpolated adjoints, the Adams
    solver's norm across ranks, and direct backprop through a global solve
    (autograd through the sum across ranks)."""
    x, y = data
    ranks = two_ranks[case]
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    assert "data=2" in ranks[0]["mesh"]
    _, want = _solo(_cfg(**TWO[case]), _batches(x, y))
    _assert_jax_bars(ranks[0]["metrics"], want)


def test_dp_two_ranks_matches_jax_trainer(data, two_ranks):
    """The port on 2 gloo ranks against the JAX ``Trainer(num_devices=2)``
    on two of the conftest's virtual CPU devices, from the same weights."""
    x, y = data
    jt = JaxTrainer(JaxTrainConfig(**{**dataclasses.asdict(_cfg()),
                                      "num_devices": 2}), steps_per_epoch=4)
    assert jt.mesh.devices.size == 2
    jt.params = jax.device_put(_jax_params(), jt._psh)
    jt.opt_state = jax.device_put(jt.tx.init(jt.params), jt._osh)
    rng = jax.random.PRNGKey(0)
    want = []
    for images, labels in _batches(x, y):
        rng, sub = jax.random.split(rng)
        m = jax.device_get(jt.train_batch(images, labels.astype(np.int32),
                                          sub))
        want.append({k: float(v) for k, v in m.items()})
    _assert_jax_bars(two_ranks["jax"][0]["metrics"], want)


def test_norm_spans_the_ranks(data, two_ranks):
    """At tol 1e-3 the two half-batches, each solved alone, take another
    backward NFE than the whole batch; the 2-rank step takes the whole
    batch's: its backward norm spans both ranks (no option selects it)."""
    x, y = data
    cfg = _cfg(tol=1e-3)
    trainer = Trainer(cfg, steps_per_epoch=4, device="cpu")
    images, labels = _batches(x, y, 1)[0]
    xs, ys = trainer._preprocess(images, False), trainer._labels(labels)

    def nfe_b(rows):
        return float(trainer._grads(trainer.params, xs[rows], ys[rows],
                                    16)[4])

    whole = nfe_b(slice(0, 16))
    halves = [nfe_b(slice(0, 8)), nfe_b(slice(8, 16))]
    assert all(h != whole for h in halves), (whole, halves)
    for rank in two_ranks["norm"]:
        assert rank["metrics"][0]["nfe_b"] == whole


def test_per_sample_forward_ends_with_the_ranks_rows(data, two_ranks):
    """The per-sample forward holds no collective: each rank stops after the
    attempts its own rows need, the most of the one-device solve's
    per-sample attempts over those rows (step 1, the same weights)."""
    x, y = data
    trainer, _ = _solo(_cfg(), _batches(x, y, 1))
    st = trainer.last_stats
    per_row = (st.naccept + st.nreject).tolist()
    for rank, rows in zip(two_ranks["base"], (slice(0, 8), slice(8, 16))):
        assert rank["attempts"][0] == max(per_row[rows])


# -- four ranks --------------------------------------------------------------
@pytest.fixture(scope="module")
def four_ranks(data, tmp_path_factory):
    """One launch of 4 ranks: data parallel (4,) and FSDP (2, 2), the FSDP
    run saving its training state."""
    x, y = data
    state = tmp_path_factory.mktemp("fsdp") / "state.pt"
    jobs = [(train_steps, (_cfg(num_devices=4), _batches(x, y)),
             {"device": "cpu"}),
            (train_steps, (_cfg(num_devices=4, model_shards=2),
                           _batches(x, y)),
             {"device": "cpu", "save_path": str(state)})]
    res = launch(in_turn, 4, jobs, devices=["cpu"] * 4, timeout=LAUNCH_S)
    return {"dp": [r[0] for r in res], "fsdp": [r[1] for r in res],
            "state": state}


@pytest.mark.parametrize("case", ["dp", "fsdp"])
def test_four_ranks_match_one_device(data, four_ranks, case):
    x, y = data
    ranks = four_ranks[case]
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    assert ("data=2, model=2" if case == "fsdp" else "data=4") in (
        ranks[0]["mesh"])
    _, want = _solo(_cfg(), _batches(x, y))
    _assert_jax_bars(ranks[0]["metrics"], want)


def test_fsdp_shards_every_divisible_leaf(four_ranks):
    """Each rank holds its ``param_spec`` shard: the leaf halved along the
    spec's dimension, whole where the spec replicates; every rank gathers
    the same whole parameters."""
    for rank in four_ranks["fsdp"]:
        for local, whole in rank["shapes"]:
            spec = param_spec(whole, 2)
            want = list(whole)
            if isinstance(spec, Shard):
                want[spec.dim] //= 2
            assert tuple(local) == tuple(want)
        assert any(tuple(loc) != tuple(w) for loc, w in rank["shapes"])
    p0 = pytree.tree_leaves(four_ranks["fsdp"][0]["params"])
    for rank in four_ranks["fsdp"][1:]:
        assert all(torch.equal(a, b) for a, b in
                   zip(p0, pytree.tree_leaves(rank["params"])))


def test_fsdp_state_resumes_on_one_device(data, four_ranks):
    """``save_state`` on the (2, 2) mesh writes the one-device format: a
    one-rank ``Trainer`` loads the whole weights bit for bit and goes on,
    and its next step meets the step-2 bar against the one-device run
    continued from its own state."""
    x, y = data
    trainer = Trainer(_cfg(num_devices=1), steps_per_epoch=4, device="cpu")
    trainer.load_state(four_ranks["state"])
    assert trainer.step_count == 2
    assert all(torch.equal(a.detach(), b) for a, b in zip(
        pytree.tree_leaves(trainer.params),
        pytree.tree_leaves(four_ranks["fsdp"][0]["params"])))
    nxt = _batches(x, y, 3)[2]
    got = trainer.train_batch(*nxt)
    solo, _ = _solo(_cfg(), _batches(x, y))
    want = solo.train_batch(*nxt)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=3e-4)
    assert np.isfinite(got["loss"])


# -- the sharding rule ---------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _both_inits(model, hidden):
    """The model's parameters from both packages (their values differ,
    their shapes match)."""
    jinit, tinit = ((jax_init_odenet, init_odenet) if model == "odenet"
                    else (jax_init_resnet, init_resnet))
    return (jinit(jax.random.PRNGKey(0),
                  JaxModelConfig(in_channels=3, hidden=hidden)),
            tinit(0, ModelConfig(in_channels=3, hidden=hidden),
                  device="cpu"))


def _raw(path):
    """A key path of either package as a tuple of dict keys and indices."""
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


def _as_placement(spec, axis="model"):
    """A JAX ``PartitionSpec`` as the port's placement on ``axis``."""
    for d, name in enumerate(tuple(spec)):
        if name == axis:
            return Shard(d)
    return Replicate()


def test_param_spec_rule():
    """The JAX rule's cases (tests/test_training.py:102-116)."""
    assert param_spec((3, 3, 64, 64), 2) == Shard(3)
    assert param_spec((64,), 2) == Shard(0)
    assert param_spec((64, 10), 4) == Shard(0)
    assert param_spec((), 2) == Replicate()
    assert param_spec((3, 5), 2) == Replicate()
    assert param_spec((8,), 1) == Replicate()


@pytest.mark.parametrize("model,hidden", [("odenet", 64), ("odenet", 256),
                                          ("resnet", 64)])
@pytest.mark.parametrize("shards", [2, 4])
def test_param_spec_and_shardings_match_jax(model, hidden, shards):
    """Every leaf of the model, at the same HWIO shapes in both packages,
    gets the JAX package's dimension; ``param_shardings`` on a (data,
    model) mesh places it there and replicates it over ``data``."""
    jparams, tparams = _both_inits(model, hidden)
    jleaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tleaves = {_raw(p): v for p, v in
               pytree.tree_flatten_with_path(tparams)[0]}
    placed = {_raw(p): v for p, v in pytree.tree_flatten_with_path(
        param_shardings(types.SimpleNamespace(
            mesh_dim_names=("data", "model"), shape=(2, shards)), tparams),
        is_leaf=lambda s: isinstance(s, tuple))[0]}
    assert len(jleaves) == len(tleaves)
    devices = np.asarray(jax.devices()[:2 * shards]).reshape(2, shards)
    jsh = jax_shardings(Mesh(devices, ("data", "model")), jparams)
    for (path, leaf), jsharding in zip(jleaves, jax.tree.leaves(
            jsh, is_leaf=lambda s: hasattr(s, "spec"))):
        key = _raw(path)
        tleaf = tleaves[key]
        assert tuple(tleaf.shape) == tuple(leaf.shape), key
        want = _as_placement(jax_param_spec(tuple(leaf.shape), shards))
        assert param_spec(tuple(tleaf.shape), shards) == want, key
        assert _as_placement(jsharding.spec) == want, key
        assert placed[key] == (Replicate(), want), key
    one_axis = types.SimpleNamespace(mesh_dim_names=("data",), shape=(4,))
    assert all(p == (Replicate(),) for p in pytree.tree_leaves(
        param_shardings(one_axis, tparams),
        is_leaf=lambda s: isinstance(s, tuple)))


def test_local_part_takes_this_ranks_block():
    """The rank at (data 1, model 0) of a (2, 2) mesh: its rows of a batch,
    its shard of a parameter leaf (replicated over ``data``), and its block
    of a population that divides the data axis; a population that does not
    replicates, and a batch that does not divide raises naming both
    sizes."""
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(2, 2), get_coordinate=lambda: [1, 0])
    x, y = np.arange(16).reshape(8, 2), torch.arange(8)
    rows = shard_batch(mesh, x, y)
    np.testing.assert_array_equal(rows[0], x[4:])
    assert torch.equal(rows[1], y[4:])
    assert shard_batch(None, x) == (x,)
    leaf = torch.arange(3 * 3 * 5 * 4).reshape(3, 3, 5, 4)
    placements = param_shardings(mesh, {"k": leaf})["k"]
    assert placements == (Replicate(), Shard(3))
    assert torch.equal(local_part(mesh, leaf, placements), leaf[..., :2])
    assert population_sharding(mesh, 4) == (Shard(0), Replicate())
    np.testing.assert_array_equal(
        local_part(mesh, np.arange(4), population_sharding(mesh, 4)), [2, 3])
    assert population_sharding(mesh, 3) == (Replicate(), Replicate())
    np.testing.assert_array_equal(
        local_part(mesh, np.arange(3), population_sharding(mesh, 3)),
        [0, 1, 2])
    with pytest.raises(ValueError, match="a dimension of 7 does not divide "
                       "over the 2 ranks of the 'data' axis"):
        shard_batch(mesh, np.arange(7))
