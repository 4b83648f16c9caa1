"""Port parity, layers and model pieces: neural_ode_features_tpu_torch.ops /
models.common against the JAX package on the same weights and inputs
(numpy, seeded, f32), on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.models import ModelConfig as JaxConfig
from neural_ode_features_tpu.models import init_odenet as jax_init_odenet
from neural_ode_features_tpu.models.common import head_apply as jax_head
from neural_ode_features_tpu.models.common import stem_apply as jax_stem
from neural_ode_features_tpu.ops import layers as jl
from neural_ode_features_tpu.ops.preprocess import normalize as jax_normalize
from neural_ode_features_tpu_torch.models import ModelConfig, head_apply, stem_apply
from neural_ode_features_tpu_torch.ops import layers as tl
from neural_ode_features_tpu_torch.ops.preprocess import normalize
from neural_ode_features_tpu_torch.utils import from_jax_params

torch.set_num_threads(2)


def f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def tt(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


@pytest.mark.parametrize("groups", [32, 16])
def test_group_norm(groups):
    rng = np.random.default_rng(0)
    x = f32(rng, 4, 7, 7, 64, scale=3.0) + 2.0
    p = {"scale": f32(rng, 64), "bias": f32(rng, 64)}
    want = jl.group_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), groups=groups)
    got = tl.group_norm({k: tt(v) for k, v in p.items()}, tt(x),
                        groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("t_kind", ["scalar", "per_sample"])
def test_concat_conv2d(t_kind):
    rng = np.random.default_rng(1)
    b = 3
    x = f32(rng, b, 7, 7, 64)
    p = jl.init_conv(jax.random.PRNGKey(2), 3, 3, 65, 64)
    t = 0.37 if t_kind == "scalar" else rng.uniform(0, 1, b).astype(np.float32)
    want = jl.concat_conv2d(p, jnp.asarray(t, jnp.float32), jnp.asarray(x))
    got = tl.concat_conv2d(from_jax_params(p, device="cpu"),
                           torch.as_tensor(t, dtype=torch.float32), tt(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=2e-5)


@pytest.mark.parametrize("padding,stride", [("VALID", 1), (1, 2), ("SAME", 1)])
def test_conv2d(padding, stride):
    rng = np.random.default_rng(3)
    x = f32(rng, 2, 9, 9, 5)
    k = 3 if padding != 1 else 4
    p = jl.init_conv(jax.random.PRNGKey(4), k, k, 5, 6)
    want = jl.conv2d(p, jnp.asarray(x), stride=stride, padding=padding)
    got = tl.conv2d(from_jax_params(p, device="cpu"), tt(x), stride=stride,
                    padding=padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("in_ch,side", [(3, 32), (1, 28)])
def test_stem_and_head(in_ch, side):
    cfg_j = JaxConfig(in_channels=in_ch)
    cfg = ModelConfig(in_channels=in_ch)
    params_j = jax_init_odenet(jax.random.PRNGKey(5), cfg_j)
    params = from_jax_params(params_j, device="cpu")
    x = f32(np.random.default_rng(6), 4, side, side, in_ch)

    h_j = jax_stem(params_j["stem"], jnp.asarray(x), cfg_j)
    h = stem_apply(params["stem"], tt(x), cfg)
    assert tuple(h.shape) == h_j.shape == (4, side // 4 - 1, side // 4 - 1, 64)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), rtol=1e-4,
                               atol=1e-5)

    logits_j = jax_head(params_j["head"], h_j, cfg_j)
    logits = head_apply(params["head"], tt(np.asarray(h_j)), cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                               rtol=1e-5, atol=1e-5)


def test_normalize():
    x = np.random.default_rng(7).integers(0, 256, (2, 4, 4, 3), np.uint8)
    want = jax_normalize(jnp.asarray(x), "cifar10")
    got = normalize(torch.from_numpy(x), "cifar10")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_init_matches_torch_default_bounds():
    gen = torch.Generator().manual_seed(0)
    p = tl.init_conv(gen, 3, 3, 65, 64)
    bound = 1.0 / np.sqrt(3 * 3 * 65)
    assert p["kernel"].shape == (3, 3, 65, 64) and p["bias"].shape == (64,)
    assert float(p["kernel"].abs().max()) <= bound
    assert float(p["kernel"].abs().max()) > 0.9 * bound
    again = tl.init_conv(torch.Generator().manual_seed(0), 3, 3, 65, 64)
    assert torch.equal(p["kernel"], again["kernel"])
