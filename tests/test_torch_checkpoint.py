"""Weights carried across: the port's copy of the torch name/layout map
equals the JAX package's ``utils/checkpoint`` converters key for key and
array for array, in both naming styles, and round-trips."""

import jax
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.models import ModelConfig as JaxConfig
from neural_ode_features_tpu.models import init_odenet as jax_init_odenet
from neural_ode_features_tpu.utils.checkpoint import (
    to_torch_state_dict as jax_to_torch,
)
from neural_ode_features_tpu_torch.models import ModelConfig, init_odenet
from neural_ode_features_tpu_torch.utils import (
    from_jax_params,
    from_torch_state_dict,
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
