"""Port parity, the serving export: ``export_model export-compiled --cpu`` on
the committed JAX run directory (MNIST ODE-Net, hidden 64, 6×6×64 state)
writes the JAX tool's artifact layout and keys, and its expected logits
agree with the JAX package's ``odenet_logits`` on the same ``.msgpack``
weights and the same ``sample_input.npy`` within rtol = atol = 1e-3 (the
split ConcatConv's f32 reassociation is about 1e-4), with per-sample NFE
equal.  The row-independence probe says true under per-sample error control
and false under global control.  (``export``, ``run`` and
``export-mock`` are tested in ``test_torch_export_program.py``.)  On the
CPU; JAX is imported here only."""

import dataclasses
import hashlib
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.models import odenet_logits as jax_logits
from neural_ode_features_tpu.utils import load_checkpoint as jax_load
from neural_ode_features_tpu_torch import export_model
from neural_ode_features_tpu_torch.models import (
    ModelConfig,
    init_resnet,
    odenet_logits,
    resnet_logits,
)
from neural_ode_features_tpu_torch.utils import load_checkpoint, save_checkpoint

torch.set_num_threads(2)

RUN = Path(__file__).resolve().parent / "fixtures_torch" / "jax_run_mnist"
B = 8
JAX_KEYS = {"inputs", "outputs", "chain", "model", "rowwise", "sha256",
            "bytes", "config"}


def _export(run, out, *extra):
    return export_model.main(["export-compiled", "--run", str(run), "--cpu",
                              "--out", str(out), *extra])


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    return _export(RUN, tmp_path_factory.mktemp("export") / "a.npexec",
                   "--batch", str(B))


def _meta(art):
    return json.loads((art / "meta.json").read_text())


def test_meta_has_the_jax_keys(artifact):
    meta = _meta(artifact)
    assert JAX_KEYS <= meta.keys()
    assert meta["inputs"] == [{"shape": [B, 28, 28, 1], "dtype": "float32"}]
    assert meta["outputs"] == [{"shape": [B, 10], "dtype": "float32"}]
    assert (meta["chain"], meta["model"]) == (1, "odenet")
    assert (meta["format"], meta["platform"]) == ("torch-state-dict", "cpu")
    assert meta["torch_version"] == torch.__version__
    blob = (artifact / meta["weights"]).read_bytes()
    assert meta["sha256"] == hashlib.sha256(blob).hexdigest()
    assert meta["bytes"] == len(blob)
    stored = json.loads((RUN / "ckpt_best.msgpack.json").read_text())
    assert meta["config"] == stored["config"]
    # The JAX tool's sample: numpy seed 0, f32, C order.
    x = np.load(artifact / "sample_input.npy")
    np.testing.assert_array_equal(
        x, np.random.default_rng(0).normal(size=(B, 28, 28, 1))
        .astype(np.float32))
    assert x.flags.c_contiguous and x.dtype == np.float32


def test_expected_logits_match_the_jax_package(artifact):
    x = np.load(artifact / "sample_input.npy")
    params_j, cfg_j, _ = jax_load(str(RUN / "ckpt_best.msgpack"))
    want, stats_j = jax_logits(params_j, jnp.asarray(x), cfg_j, adjoint=False)
    got = np.load(artifact / "expected_logits.npy")
    assert got.shape == (B, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(got.argmax(-1), np.asarray(want).argmax(-1))

    # The artifact's own weights reproduce its logits, bit for bit, and
    # take the JAX solve's per-sample NFE.
    params, cfg, model = export_model.load_artifact(
        artifact, _meta(artifact), torch.device("cpu"))
    with torch.no_grad():
        logits, stats = odenet_logits(params, torch.from_numpy(x), cfg,
                                      adjoint=False)
    np.testing.assert_array_equal(logits.numpy(), got)
    np.testing.assert_array_equal(stats.nfe.numpy(), np.asarray(stats_j.nfe))


@pytest.mark.parametrize("control,rowwise", [("per_sample", True),
                                             ("global", False)])
def test_rowwise_probe(artifact, tmp_path, control, rowwise):
    if control == "per_sample":
        assert _meta(artifact)["rowwise"] is True
        return
    params, cfg, extra = load_checkpoint(RUN / "ckpt_best.msgpack",
                                         device="cpu")
    run = tmp_path / "run"
    save_checkpoint(run / "ckpt_best.pt", params,
                    dataclasses.replace(cfg, error_control=control), extra)
    art = _export(run, tmp_path / "g.npexec", "--batch", "4")
    assert _meta(art)["rowwise"] is rowwise
    assert _meta(art)["config"]["error_control"] == control


def test_chained_resnet_artifact(tmp_path):
    """``--chain 2``: a (2, B, ...) input, each batch solved on its own; a
    ResNet run directory exports too (no kernel on its path)."""
    cfg = ModelConfig(in_channels=1, hidden=8, groups=4, num_blocks=2)
    params = init_resnet(3, cfg, device="cpu")
    save_checkpoint(tmp_path / "run" / "ckpt_best.pt", params, cfg,
                    {"model": "resnet"})
    art = _export(tmp_path / "run", tmp_path / "r.npexec", "--batch", "3",
                  "--chain", "2")
    meta = _meta(art)
    assert meta["inputs"][0]["shape"] == [2, 3, 28, 28, 1]
    assert meta["outputs"][0]["shape"] == [2, 3, 10]
    assert (meta["model"], meta["chain"], meta["rowwise"]) == ("resnet", 2,
                                                              True)
    x = torch.from_numpy(np.load(art / "sample_input.npy"))
    with torch.no_grad():
        want = torch.stack([resnet_logits(params, xi, cfg) for xi in x])
    np.testing.assert_array_equal(np.load(art / "expected_logits.npy"),
                                  want.numpy())


def test_export_needs_cuda_unless_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_model.main(["export-compiled", "--run", str(RUN), "--batch",
                           "2", "--out", str(tmp_path / "a")])
    assert not (tmp_path / "a").exists()
