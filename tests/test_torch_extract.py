"""Port parity, the extraction slice: ``odenet_trajectory``, the ``'res'``
stem, the ResNet taps, the object API, ``extract`` and ``evaluate`` against
the JAX package on the CPU at a small size (hidden 8, groups 4), same
weights through ``from_jax_params`` or a ``.pt`` checkpoint, inputs from
numpy seeds, explicit f32 on the JAX side (``conftest`` enables x64)."""

import csv
import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.models import ModelConfig as JaxConfig
from neural_ode_features_tpu.models import init_odenet as jax_init_odenet
from neural_ode_features_tpu.models import init_resnet as jax_init_resnet
from neural_ode_features_tpu.models import odenet_trajectory as jax_trajectory
from neural_ode_features_tpu.models import (
    resnet_block_states as jax_block_states,
)
from neural_ode_features_tpu.models import resnet_logits as jax_resnet_logits
from neural_ode_features_tpu.models.common import stem_apply as jax_stem_apply
from neural_ode_features_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from neural_ode_features_tpu.utils.checkpoint import (
    to_torch_state_dict as jax_to_torch,
)
from neural_ode_features_tpu_torch import evaluate as port_evaluate
from neural_ode_features_tpu_torch import extract as port_extract
from neural_ode_features_tpu_torch.data import load_dataset
from neural_ode_features_tpu_torch.entry import extract_entry
from neural_ode_features_tpu_torch.features_io import (
    load_features,
    save_features,
)
from neural_ode_features_tpu_torch.models import (
    ModelConfig,
    ODEBlock,
    ODENet,
    ResNet,
    odenet_logits,
    odenet_trajectory,
    pool_features,
    resnet_block_states,
    resnet_logits,
    stem_apply,
)
from neural_ode_features_tpu_torch.utils import from_jax_params

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import evaluate as jax_evaluate  # noqa: E402  (the JAX CLIs at the repo root)
import extract as jax_extract  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(in_channels=3, hidden=8, groups=4, tol=1e-3)
B, T = 4, 5
SIDE = {"conv": 3, "res": 4}  # the state's side from a 16×16 input


def _x(seed=0, b=B):
    return np.random.default_rng(seed).normal(
        size=(b, 16, 16, 3)).astype(np.float32)


@pytest.mark.parametrize("stem", ["conv", "res"])
def test_trajectory_matches_jax(stem):
    cfg_j = JaxConfig(downsampling=stem, **SMALL)
    cfg = ModelConfig(downsampling=stem, **SMALL)
    params_j = jax_init_odenet(jax.random.PRNGKey(3), cfg_j)
    params = from_jax_params(params_j, device="cpu")
    x = _x()
    ts = np.linspace(0.0, 1.0, T).astype(np.float32)
    traj_j, stats_j = jax_trajectory(params_j, jnp.asarray(x),
                                     jnp.asarray(ts), cfg_j)
    traj, stats = odenet_trajectory(params, torch.from_numpy(x), ts, cfg)
    side = SIDE[stem]
    assert traj.shape == (T, B, side, side, 8)
    assert traj.dtype == torch.float32
    for name in ("nfe", "naccept", "nreject", "success"):
        np.testing.assert_array_equal(getattr(stats, name).numpy(),
                                      np.asarray(getattr(stats_j, name)), name)
    # Per t against the JAX trajectory (0.25 and 0.75 are exact in f32 here,
    # but a grid like linspace(0, 1, 11) is not: no closed form to hold to).
    for i in range(T):
        np.testing.assert_allclose(traj[i].numpy(), np.asarray(traj_j[i]),
                                   rtol=1e-4, atol=1e-5, err_msg=f"t[{i}]")
    # The trajectory's ends are the stem output and the state the
    # classifier reaches.
    np.testing.assert_array_equal(
        traj[0].numpy(), stem_apply(params["stem"], torch.from_numpy(x),
                                    cfg).numpy())
    feats = pool_features(traj)
    assert feats.shape == (T, B, 8)
    logits, stats_l = odenet_logits(params, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(stats_l.nfe.numpy(), stats.nfe.numpy())


@pytest.mark.parametrize("jax_kernels", [True, False])
def test_extraction_slice_matches_jax_at_full_width(jax_kernels):
    """The slice as a whole at the ``entry()`` model's width (hidden 64,
    CIFAR-10 input, B = 8, the JAX fused step's smallest batch): with the
    JAX kernels on, the JAX trajectory goes through the Pallas fused step in
    interpret mode, whose ``y_mid`` feeds the dense output as the CUDA
    kernel's does on the card."""
    cfg_j = JaxConfig(in_channels=3, tol=1e-3, use_pallas=jax_kernels,
                      use_fused_rk=jax_kernels)
    params_j = jax_init_odenet(jax.random.PRNGKey(7), cfg_j)
    x = np.random.default_rng(0).normal(size=(8, 32, 32, 3)).astype(
        np.float32)
    ts = np.linspace(0.0, 1.0, T).astype(np.float32)
    traj_j, stats_j = jax_trajectory(params_j, jnp.asarray(x),
                                     jnp.asarray(ts), cfg_j)
    traj, stats = odenet_trajectory(from_jax_params(params_j, device="cpu"),
                                    torch.from_numpy(x), ts,
                                    ModelConfig(in_channels=3, tol=1e-3))
    np.testing.assert_array_equal(stats.nfe.numpy(), np.asarray(stats_j.nfe))
    np.testing.assert_array_equal(stats.naccept.numpy(),
                                  np.asarray(stats_j.naccept))
    np.testing.assert_allclose(traj.numpy(), np.asarray(traj_j), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(pool_features(traj).numpy(),
                               np.asarray(traj_j).mean(axis=(2, 3)),
                               rtol=1e-3, atol=1e-3)


def test_res_stem_matches_jax():
    cfg_j = JaxConfig(downsampling="res", **SMALL)
    params_j = jax_init_odenet(jax.random.PRNGKey(5), cfg_j)["stem"]
    assert sorted(params_j) == ["block1", "block2", "conv0"]
    x = _x(1)
    want = jax_stem_apply(params_j, jnp.asarray(x), cfg_j)
    got = stem_apply(from_jax_params(params_j, device="cpu"),
                     torch.from_numpy(x), ModelConfig(downsampling="res",
                                                      **SMALL))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("stem", ["conv", "res"])
def test_resnet_matches_jax(stem):
    kw = dict(downsampling=stem, num_blocks=3, **SMALL)
    cfg_j, cfg = JaxConfig(**kw), ModelConfig(**kw)
    params_j = jax_init_resnet(jax.random.PRNGKey(2), cfg_j)
    params = from_jax_params(params_j, device="cpu")
    assert isinstance(params["blocks"], list) and len(params["blocks"]) == 3
    x = _x(2)
    states = resnet_block_states(params, torch.from_numpy(x), cfg)
    assert states.shape == (4, B, SIDE[stem], SIDE[stem], 8)
    np.testing.assert_allclose(
        states.numpy(), np.asarray(jax_block_states(params_j, jnp.asarray(x),
                                                    cfg_j)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        resnet_logits(params, torch.from_numpy(x), cfg).numpy(),
        np.asarray(jax_resnet_logits(params_j, jnp.asarray(x), cfg_j)),
        rtol=1e-5, atol=1e-5)


def test_object_api():
    x = torch.from_numpy(_x(3, 2))
    net = ODENet.create(0, device="cpu", **SMALL)
    assert net.config == ModelConfig(**SMALL)
    again = ODENet.create(0, net.config, device="cpu")
    assert torch.equal(net.params["head"]["fc"]["kernel"],
                       again.params["head"]["fc"]["kernel"])
    logits, stats = net(x)
    assert logits.shape == (2, 10) and stats.nfe.shape == (2,)
    feats, _ = net.features(x, [0.0, 0.5, 1.0])
    traj, _ = net.trajectory(x, [0.0, 0.5, 1.0])
    assert feats.shape == (3, 2, 8)
    assert torch.equal(feats, pool_features(traj))

    block = ODEBlock(net.params["odefunc"], net.config)
    h0 = traj[0]
    h1, _ = block(h0)
    np.testing.assert_allclose(h1.numpy(), traj[-1].numpy(), rtol=1e-5,
                               atol=1e-6)
    full, _ = block(h0, [0.0, 1.0])
    assert full.shape == (2, *h0.shape)

    res = ResNet.create(1, device="cpu", num_blocks=2, **SMALL)
    assert res(x).shape == (2, 10)
    assert res.block_states(x).shape == (3, 2, 3, 3, 8)
    assert torch.equal(res.features(x), pool_features(res.block_states(x)))


# ---------------------------------------------------------------------------
# The CLIs.
# ---------------------------------------------------------------------------
MNIST = dict(in_channels=1, hidden=8, groups=4, tol=1e-3)


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    """The same trained-like weights as a JAX run directory (msgpack) and a
    port run directory (``.pt`` written from the JAX package's own
    ``to_torch_state_dict``), for the ODE-Net and the ResNet."""
    out = {}
    for model, init in (("odenet", jax_init_odenet),
                        ("resnet", jax_init_resnet)):
        cfg_j = JaxConfig(num_blocks=2, **MNIST)
        params_j = init(jax.random.PRNGKey(11), cfg_j)
        extra = {"model": model, "train": {"dataset": "synthetic-mnist"}}
        root = tmp_path_factory.mktemp(model)
        jax_dir, port_dir = root / "jax", root / "port"
        jax_save_checkpoint(jax_dir / "ckpt_best.msgpack", params_j, cfg_j,
                            extra)
        port_dir.mkdir()
        torch.save({k: torch.from_numpy(v.copy())
                    for k, v in jax_to_torch(params_j).items()},
                   port_dir / "ckpt_last.pt")  # no "best": the fallback
        (port_dir / "ckpt_last.pt.json").write_text(
            (jax_dir / "ckpt_best.msgpack.json").read_text())
        out[model] = (jax_dir, port_dir)
    return out


@pytest.mark.parametrize("model,flags", [
    ("odenet", []), ("odenet", ["--nfe-sort"]), ("odenet", ["--fused"]),
    ("resnet", [])], ids=["plain", "nfe-sort", "fused", "resnet"])
def test_extract_cli_matches_jax(run_dirs, tmp_path, model, flags):
    jax_dir, port_dir = run_dirs[model]
    common = ["--cpu", "--timestamps", str(T), "--limit", "24",
              "--batch-size", "10", *flags]  # 24 = 10 + 10 + a ragged 4
    want_path = jax_extract.main(["--run", str(jax_dir), "--output",
                                  str(tmp_path / "jax.h5"), *common])
    got_path = port_extract.main(["--run", str(port_dir), "--output",
                                  str(tmp_path / "port.h5"), *common])
    want, got = load_features(want_path), load_features(got_path)
    n_t = T if model == "odenet" else 3
    assert got["features"].shape == (n_t, 24, 8)
    for key in ("t", "labels", "nfe"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key], key)
    np.testing.assert_allclose(got["features"], want["features"], rtol=1e-4,
                               atol=1e-4)
    assert got["attrs"] == want["attrs"] == {
        "dataset": "synthetic-mnist", "model": model, "tol": 1e-3}
    if model == "odenet":
        assert (got["nfe"] >= 8).all()  # no padded row's count, no zeros


def test_extract_default_output_and_padding(run_dirs):
    """The default file is ``features_<split>.npz`` in the run directory,
    and a row does not depend on what shares or pads its batch."""
    _, port_dir = run_dirs["odenet"]
    common = ["--run", str(port_dir), "--cpu", "--timestamps", "3",
              "--limit", "12"]
    path = port_extract.main([*common, "--batch-size", "8"])
    assert path == port_dir / "features_test.npz"
    ragged = load_features(path)
    whole = load_features(port_extract.main(
        [*common, "--batch-size", "12", "--output",
         str(port_dir / "whole.npz")]))
    np.testing.assert_array_equal(ragged["nfe"], whole["nfe"])
    np.testing.assert_allclose(ragged["features"], whole["features"],
                               rtol=1e-6, atol=1e-6)
    images, labels = load_dataset("synthetic-mnist", "test", limit=12)
    np.testing.assert_array_equal(ragged["labels"], labels.astype(np.int32))


def test_feature_file_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    data = dict(t=np.linspace(0, 1, 3), features=rng.normal(size=(3, 5, 4)),
                labels=rng.integers(0, 10, 5), nfe=rng.integers(8, 40, 5))
    attrs = dict(dataset="synthetic-mnist", model="odenet", tol=1e-3)
    loaded = {s: load_features(save_features(tmp_path / f"f{s}", **data,
                                             **attrs))
              for s in (".npz", ".h5")}
    for got in loaded.values():
        assert got["attrs"] == attrs
        assert got["t"].dtype == got["features"].dtype == np.float32
        assert got["labels"].dtype == got["nfe"].dtype == np.int32
        np.testing.assert_array_equal(got["features"],
                                      data["features"].astype(np.float32))
        np.testing.assert_array_equal(got["nfe"], data["nfe"])
    with pytest.raises(ValueError, match=".h5 or .npz"):
        save_features(tmp_path / "f.csv", **data, **attrs)
    with pytest.raises(ValueError, match="shapes disagree"):
        save_features(tmp_path / "g.npz", **{**data, "nfe": data["nfe"][:2]},
                      **attrs)


@pytest.fixture(scope="module")
def feature_files(tmp_path_factory):
    """Seeded class-clustered features at 3 times, as ``.h5`` (both CLIs
    read it) and ``.npz``, with a train split."""
    root = tmp_path_factory.mktemp("features")
    rng = np.random.default_rng(4)
    centres = rng.normal(size=(10, 12))
    files = {}
    for split, n in (("test", 160), ("train", 200)):
        labels = rng.integers(0, 10, n)
        feats = np.stack([centres[labels] * s + rng.normal(size=(n, 12))
                          for s in (0.3, 0.8, 1.5)])
        for suffix in (".h5", ".npz"):
            files[split, suffix] = save_features(
                root / f"features_{split}{suffix}", t=[0.0, 0.5, 1.0],
                features=feats, labels=labels, nfe=np.full(n, 32),
                dataset="synthetic-mnist", model="odenet", tol=1e-3)
    return files


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("with_train", [False, True])
def test_evaluate_cli_matches_jax(feature_files, tmp_path, with_train):
    extra = (["--train-features", str(feature_files["train", ".h5"])]
             if with_train else [])
    want = _rows(jax_evaluate.main(
        ["--features", str(feature_files["test", ".h5"]), "--output",
         str(tmp_path / "jax.csv"), *extra]))
    got = _rows(port_evaluate.main(
        ["--cpu", "--features", str(feature_files["test", ".h5"]),
         "--output", str(tmp_path / "port.csv"), *extra]))
    n_probe = 160 if with_train else 80
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert list(g) == list(w) == ["t", "linear_acc", "knn_acc",
                                      "retrieval_map"]
        assert g["t"] == w["t"] and g["knn_acc"] == w["knn_acc"]
        assert abs(float(g["retrieval_map"])
                   - float(w["retrieval_map"])) <= 1e-4
        assert abs(float(g["linear_acc"])
                   - float(w["linear_acc"])) <= 2 / n_probe + 1e-4
    # The .npz default gives the same rows.
    again = _rows(port_evaluate.main(
        ["--cpu", "--features", str(feature_files["test", ".npz"]),
         "--metrics", "knn,map", "--limit", "100"]))
    assert list(again[0]) == ["t", "knn_acc", "retrieval_map"]
    assert (feature_files["test", ".npz"].parent / "metrics_vs_t.csv").exists()


def test_evaluate_cli_refusals(feature_files, tmp_path):
    other = save_features(tmp_path / "other.npz", t=[0.0, 0.4, 1.0],
                          features=np.zeros((3, 6, 2)), labels=np.zeros(6),
                          nfe=np.zeros(6), dataset="d", model="odenet",
                          tol=1e-3)
    test = str(feature_files["test", ".npz"])
    with pytest.raises(SystemExit, match="t-grid"):
        port_evaluate.main(["--cpu", "--features", test, "--train-features",
                            str(other)])
    with pytest.raises(SystemExit, match="unknown metric"):
        port_evaluate.main(["--cpu", "--features", test, "--metrics",
                            "linear,auc"])


def test_extract_entry_on_cpu():
    fwd, params, x = extract_entry(device="cpu", batch=2, timestamps=3)
    assert x.dtype == torch.uint8 and tuple(x.shape) == (2, 32, 32, 3)
    feats, stats = fwd(params, x)
    assert feats.shape == (3, 2, 64) and bool(torch.isfinite(feats).all())
    assert stats.nfe.shape == (2,) and bool(stats.success.all())
    assert not torch.backends.cudnn.allow_tf32
    images, _ = load_dataset("synthetic-cifar10", "test", limit=2)
    np.testing.assert_array_equal(x.numpy(), images)


def test_port_checkpoint_config_is_the_jax_sidecar(run_dirs):
    jax_dir, port_dir = run_dirs["odenet"]
    meta = json.loads((port_dir / "ckpt_last.pt.json").read_text())
    assert meta["config"] == dataclasses.asdict(JaxConfig(num_blocks=2,
                                                          **MNIST))
    assert ModelConfig(**meta["config"]) == ModelConfig(num_blocks=2, **MNIST)
