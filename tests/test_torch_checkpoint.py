"""Weights carried across: the port's copy of the torch name/layout map
equals the JAX package's ``utils/checkpoint`` converters key for key and
array for array, in both naming styles, and round-trips; the port's ``.pt``
checkpoint round-trips and crosses to the JAX package and back."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.models import ModelConfig as JaxConfig
from neural_ode_features_tpu.models import init_odenet as jax_init_odenet
from neural_ode_features_tpu.models import init_resnet as jax_init_resnet
from neural_ode_features_tpu.utils.checkpoint import (
    from_torch_state_dict as jax_from_torch,
)
from neural_ode_features_tpu.utils.checkpoint import (
    to_torch_state_dict as jax_to_torch,
)
from neural_ode_features_tpu_torch.models import (
    ModelConfig,
    init_odenet,
    init_resnet,
)
from neural_ode_features_tpu_torch.utils import (
    from_jax_params,
    from_torch_state_dict,
    load_checkpoint,
    resolve_checkpoint,
    save_checkpoint,
    to_torch_state_dict,
)


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_odenet(jax.random.PRNGKey(1), JaxConfig(in_channels=3))


@pytest.mark.parametrize("style", ["internal", "reference"])
def test_state_dict_matches_jax(jax_params, style):
    want = jax_to_torch(jax_params, style=style)
    got = to_torch_state_dict(from_jax_params(jax_params, device="cpu"),
                              style=style)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        assert got[k].is_contiguous()


@pytest.mark.parametrize("style", ["internal", "reference"])
def test_round_trip(jax_params, style):
    params = from_jax_params(jax_params, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    for path, leaf in flat_j:
        node = params
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))

    template = init_odenet(0, ModelConfig(in_channels=3), device="cpu")
    sd = to_torch_state_dict(params, style=style)
    back = from_torch_state_dict(template, sd)
    # numpy values (as the JAX converter exports) are accepted too.
    back_np = from_torch_state_dict(template, jax_to_torch(jax_params, style))
    for other in (back, back_np):
        assert to_torch_state_dict(other).keys() == to_torch_state_dict(params).keys()
        for k, v in to_torch_state_dict(params).items():
            assert torch.equal(to_torch_state_dict(other)[k], v), k


SMALL = dict(in_channels=3, hidden=8, groups=4, num_blocks=2)
FAMILIES = {"odenet": (jax_init_odenet, init_odenet),
            "resnet": (jax_init_resnet, init_resnet)}


def _assert_trees_equal(a, b):
    sa, sb = to_torch_state_dict(a), to_torch_state_dict(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("stem", ["conv", "res"])
@pytest.mark.parametrize("model", ["odenet", "resnet"])
def test_state_dict_of_every_family_matches_jax(model, stem):
    """The 'res' stem's blocks and the ResNet's ``blocks`` list carry
    across, key for key."""
    cfg_j = JaxConfig(downsampling=stem, **SMALL)
    params_j = FAMILIES[model][0](jax.random.PRNGKey(4), cfg_j)
    params = from_jax_params(params_j, device="cpu")
    want = jax_to_torch(params_j)
    got = to_torch_state_dict(params)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    if stem == "res":
        assert "stem.block2.shortcut.weight" in got
    if model == "resnet":
        assert "blocks.1.conv2.weight" in got
        assert to_torch_state_dict(params, "reference")[
            "feature_layers.1.conv2.weight"].shape == (8, 8, 3, 3)


@pytest.mark.parametrize("stem", ["conv", "res"])
@pytest.mark.parametrize("model", ["odenet", "resnet"])
def test_pt_checkpoint_round_trip(tmp_path, model, stem):
    cfg = ModelConfig(downsampling=stem, tol=1e-4, **SMALL)
    params = FAMILIES[model][1](3, cfg, device="cpu")
    extra = {"model": model, "train": {"dataset": "synthetic-cifar10"}}
    path = tmp_path / "run" / "ckpt_best.pt"
    save_checkpoint(path, params, cfg, extra)
    # The file is a flat dict of tensors: it loads with weights_only=True.
    state = torch.load(path, weights_only=True)
    assert all(isinstance(k, str) and isinstance(v, torch.Tensor)
               for k, v in state.items())
    assert json.loads((tmp_path / "run" / "ckpt_best.pt.json").read_text()) == {
        "config": dataclasses.asdict(cfg), "extra": extra}
    loaded, cfg2, extra2 = load_checkpoint(path, device="cpu")
    assert cfg2 == cfg and extra2 == extra
    _assert_trees_equal(loaded, params)
    assert isinstance(loaded.get("blocks", []), list)


@pytest.mark.parametrize("model", ["odenet", "resnet"])
def test_jax_to_pt_to_port_to_jax(tmp_path, model):
    """JAX params → ``.pt`` (through the JAX package's own torch surface) →
    the port's ``load_checkpoint`` → ``save_checkpoint`` → back into JAX
    params through ``from_torch_state_dict``: every array survives."""
    jax_init = FAMILIES[model][0]
    cfg_j = JaxConfig(downsampling="res", **SMALL)
    params_j = jax_init(jax.random.PRNGKey(9), cfg_j)
    path = tmp_path / "ckpt_last.pt"
    torch.save({k: torch.from_numpy(v.copy())
                for k, v in jax_to_torch(params_j).items()}, path)
    (tmp_path / "ckpt_last.pt.json").write_text(json.dumps(
        {"config": dataclasses.asdict(cfg_j), "extra": {"model": model}}))
    params, cfg, extra = load_checkpoint(path, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    _assert_trees_equal(params, from_jax_params(params_j, device="cpu"))

    back_path = tmp_path / "back.pt"
    save_checkpoint(back_path, params, cfg, extra)
    template = jax_init(jax.random.PRNGKey(0), cfg_j)
    back = jax_from_torch(template, torch.load(back_path, weights_only=True))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params_j),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_resolve_checkpoint_and_msgpack_refusal(tmp_path):
    cfg = ModelConfig(**SMALL)
    params = init_odenet(0, cfg, device="cpu")
    assert resolve_checkpoint(tmp_path) == tmp_path / "ckpt_last.pt"
    save_checkpoint(tmp_path / "ckpt_last.pt", params, cfg)
    assert resolve_checkpoint(tmp_path) == tmp_path / "ckpt_last.pt"
    save_checkpoint(tmp_path / "ckpt_best.pt", params, cfg)
    assert resolve_checkpoint(tmp_path) == tmp_path / "ckpt_best.pt"
    assert resolve_checkpoint(tmp_path, name="ckpt_e3.pt") == (
        tmp_path / "ckpt_last.pt")
    assert resolve_checkpoint(tmp_path / "x.pt") == tmp_path / "x.pt"
    # extra defaults to {} and the family to the ODE-Net
    assert load_checkpoint(tmp_path / "ckpt_best.pt", device="cpu")[2] == {}
    # The port reads .msgpack (tests/test_torch_foreign.py) but writes .pt.
    with pytest.raises(NotImplementedError, match="writing a JAX .msgpack"):
        save_checkpoint(tmp_path / "ckpt_best.msgpack", params, cfg)
    with pytest.raises(FileNotFoundError):
        load_checkpoint(tmp_path / "ckpt_best.msgpack", device="cpu")
    # A JAX run directory: best, else last; the port's .pt first.
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    (jax_dir / "ckpt_last.msgpack").write_bytes(b"")
    assert resolve_checkpoint(jax_dir) == jax_dir / "ckpt_last.msgpack"
    (jax_dir / "ckpt_best.msgpack").write_bytes(b"")
    assert resolve_checkpoint(jax_dir) == jax_dir / "ckpt_best.msgpack"
    (jax_dir / "ckpt_last.pt").write_bytes(b"")
    assert resolve_checkpoint(jax_dir) == jax_dir / "ckpt_last.pt"
