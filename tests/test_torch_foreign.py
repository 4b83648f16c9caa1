"""Port parity, what the JAX package writes and what users bring: the raw
MNIST/CIFAR-10 files, flax ``.msgpack`` checkpoints and JAX run
directories, the converter's torch pickle, and ``eval_ckpt``.

Files are written here from the synthetic twins (no dataset can be
fetched): ``tools/reference_protocol.py`` ``fabricate`` and the writers of
``tests/test_real_loaders.py``.  The JAX run directory under
``tests/fixtures_torch/`` was written by the JAX ``train.py`` (the
command is in ``CHANGES.md``); the JSON beside it is what ``tools/eval_ckpt.py
--cpu`` printed for it on the fabricated MNIST test files, which
``chip_smoke.py`` holds the port to on the card."""

import dataclasses
import gzip
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_real_loaders import _write_idx_images, _write_idx_labels

from neural_ode_features_tpu.data import load_dataset as jax_load_dataset
from neural_ode_features_tpu.models import ModelConfig as JaxConfig
from neural_ode_features_tpu.models import init_odenet as jax_init_odenet
from neural_ode_features_tpu.models import init_resnet as jax_init_resnet
from neural_ode_features_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
)
from neural_ode_features_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from neural_ode_features_tpu.utils.checkpoint import (
    to_torch_state_dict as jax_to_torch,
)
from neural_ode_features_tpu_torch import eval_ckpt
from neural_ode_features_tpu_torch.data import load_dataset
from neural_ode_features_tpu_torch.utils import (
    from_jax_params,
    load_checkpoint,
    resolve_checkpoint,
    to_torch_state_dict,
)
from neural_ode_features_tpu_torch.utils.flax_msgpack import unpackb
from tools import convert_checkpoint
from tools import eval_ckpt as jax_eval_ckpt
from tools.reference_protocol import fabricate

FIXTURE = Path(__file__).parent / "fixtures_torch" / "jax_run_mnist"
FIXTURE_EVAL = FIXTURE.with_name("jax_run_mnist.eval.json")
SMALL = dict(in_channels=1, hidden=8, groups=4, num_blocks=2)


def _same_tree(got, want):
    """Port params ``got`` equal, bit for bit, to numpy/JAX params ``want``."""
    sg, sw = to_torch_state_dict(got), jax_to_torch(want)
    assert sorted(sg) == sorted(sw)
    for k, v in sw.items():
        assert sg[k].dtype == torch.float32
        np.testing.assert_array_equal(sg[k].numpy(), v, err_msg=k)


# ---- the msgpack decoder against flax --------------------------------------


@pytest.mark.parametrize("model,hidden", [("odenet", 32), ("odenet", 128),
                                          ("resnet", 32)])
def test_decoder_matches_flax(model, hidden):
    serialization = pytest.importorskip("flax.serialization")
    init = jax_init_odenet if model == "odenet" else jax_init_resnet
    params = init(jax.random.PRNGKey(3),
                  JaxConfig(in_channels=3, hidden=hidden, num_blocks=2))
    data = serialization.to_bytes(params)
    got, want = unpackb(data), serialization.msgpack_restore(data)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(jax.tree_util.tree_leaves(got)) == len(flat)
    for path, leaf in flat:
        node = got
        for p in path:
            node = node[p.key]
        assert node.dtype == leaf.dtype and node.shape == leaf.shape
        assert node.tobytes() == leaf.tobytes()


def test_decoder_types_and_refusals():
    serialization = pytest.importorskip("flax.serialization")
    msgpack = pytest.importorskip("msgpack")
    tree = {"f": np.float32(1.5), "z": 1 - 2j, "i": np.arange(3, dtype="<i8"),
            "u": np.arange(4, dtype=np.uint8).reshape(2, 2),
            "d": np.linspace(0, 1, 5), "l": [1, -40, 2 ** 40, None, True,
                                             "s" * 40, b"b", 0.25]}
    got = unpackb(serialization.msgpack_serialize(tree))
    assert got["f"] == np.float32(1.5) and got["z"] == 1 - 2j
    assert got["l"] == tree["l"]
    for k in ("i", "u", "d"):
        assert got[k].dtype == tree[k].dtype
        np.testing.assert_array_equal(got[k], tree[k])
    for bad, match in (
            (msgpack.packb(msgpack.ExtType(7, b"x")), "extension type 7"),
            (msgpack.packb({1: 2}), "not a string"),
            (msgpack.packb({"__msgpack_chunked_array__": True}), "chunked"),
            (msgpack.packb([1, 2])[:-1], "truncated"),
            (msgpack.packb(1) + b"\x00", "trailing"),
            (serialization.msgpack_serialize(np.zeros(2, np.float16)),
             "float16"),
            (b"\xc1", "0xc1")):
        with pytest.raises(ValueError, match=match):
            unpackb(bad)


# ---- the raw loaders against the JAX loader -------------------------------


def _write_cifar_bin(root: Path, x: np.ndarray, y: np.ndarray):
    """CIFAR-10's binary batches: per record the label byte, then the image
    CHW."""
    bindir = root / "cifar-10-batches-bin"
    bindir.mkdir(parents=True)
    rec = np.concatenate([y[:, None], x.transpose(0, 3, 1, 2).reshape(
        len(x), -1)], axis=1).astype(np.uint8)
    parts = np.array_split(rec, 5)
    for i, part in enumerate(parts):
        (bindir / f"data_batch_{i + 1}.bin").write_bytes(part.tobytes())
    (bindir / "test_batch.bin").write_bytes(rec[:7].tobytes())


@pytest.mark.parametrize("layout", ["pickles", "bin", "idx", "idx-gz"])
def test_loaders_match_jax(tmp_path, layout):
    if layout == "pickles":
        fabricate("cifar10", tmp_path, 40)
    elif layout == "bin":
        x, y = load_dataset("synthetic-cifar10", "train", limit=23)
        _write_cifar_bin(tmp_path, x, y)
    elif layout == "idx":
        fabricate("mnist", tmp_path, 30)
    else:  # MNIST/raw/ with the images plain and the labels gzipped
        sub = tmp_path / "MNIST" / "raw"
        sub.mkdir(parents=True)
        for split, prefix in (("train", "train"), ("test", "t10k")):
            x, y = load_dataset("synthetic-mnist", split, limit=17)
            _write_idx_images(sub / f"{prefix}-images-idx3-ubyte", x[..., 0])
            _write_idx_labels(sub / f"{prefix}-labels-idx1-ubyte", y, gz=True)
    name = "cifar10" if layout in ("pickles", "bin") else "mnist"
    for split in ("train", "test"):
        got = load_dataset(name, split, str(tmp_path), limit=None)
        want = jax_load_dataset(name, split, str(tmp_path))
        for a, b in zip(got, want, strict=True):
            assert a.dtype == b.dtype == np.uint8 and a.flags.c_contiguous
            np.testing.assert_array_equal(a, b)
        # ... and the images are the synthetic twin's, in its order.
        twin = load_dataset(f"synthetic-{name}", split, limit=len(got[0]))
        if layout != "bin":
            np.testing.assert_array_equal(got[0], twin[0])
            np.testing.assert_array_equal(got[1], twin[1])
    assert load_dataset(name, "train", str(tmp_path), limit=5)[0].shape[0] == 5


def test_data_dir_from_the_environment(tmp_path, monkeypatch):
    fabricate("mnist", tmp_path, 8)
    monkeypatch.setenv("NODE_TPU_DATA", str(tmp_path))
    np.testing.assert_array_equal(load_dataset("mnist", "test")[0],
                                  jax_load_dataset("mnist", "test")[0])


# ---- checkpoints: .msgpack run directories and the converter's pickle ----


@pytest.mark.parametrize("model", ["odenet", "resnet"])
def test_load_a_jax_msgpack_run_directory(tmp_path, model):
    cfg_j = JaxConfig(downsampling="res", tol=1e-4, **SMALL)
    init = jax_init_odenet if model == "odenet" else jax_init_resnet
    params_j = init(jax.random.PRNGKey(5), cfg_j)
    extra = {"model": model, "train": {"dataset": "synthetic-mnist"}}
    jax_save_checkpoint(tmp_path / "ckpt_last.msgpack", params_j, cfg_j, extra)
    path = resolve_checkpoint(tmp_path)
    assert path == tmp_path / "ckpt_last.msgpack"
    params, cfg, extra2 = load_checkpoint(path, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    assert extra2 == extra
    _same_tree(params, params_j)
    assert isinstance(params.get("blocks", []), list)
    # The tree must be the model's: another width is refused by name.
    wide = dataclasses.replace(cfg_j, hidden=16, groups=8)
    jax_save_checkpoint(tmp_path / "w" / "ckpt_best.msgpack",
                        init(jax.random.PRNGKey(5), wide), cfg_j, extra)
    with pytest.raises(ValueError, match="expected an array of shape"):
        load_checkpoint(tmp_path / "w" / "ckpt_best.msgpack", device="cpu")


def test_load_the_committed_jax_run_directory():
    params_j, cfg_j, extra_j = jax_load_checkpoint(
        resolve_checkpoint(FIXTURE, "ckpt_best.msgpack"))
    path = resolve_checkpoint(FIXTURE)
    assert path == FIXTURE / "ckpt_best.msgpack"
    params, cfg, extra = load_checkpoint(path, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    assert extra == extra_j and cfg.hidden == 64
    _same_tree(params, params_j)


@pytest.mark.parametrize("style", ["internal", "reference"])
def test_load_the_converters_torch_pickle(tmp_path, style):
    cfg_j = JaxConfig(**SMALL)
    params_j = jax_init_odenet(jax.random.PRNGKey(6), cfg_j)
    jax_save_checkpoint(tmp_path / "ckpt_best.msgpack", params_j, cfg_j,
                        {"model": "odenet"})
    out = tmp_path / "out.pt"
    convert_checkpoint.main(["to-torch", str(tmp_path / "ckpt_best.msgpack"),
                             str(out)])
    if style == "reference":
        blob = torch.load(out, weights_only=True)
        blob["state_dict"] = {k: torch.from_numpy(v.copy()) for k, v in
                              jax_to_torch(params_j, "reference").items()}
        assert "fc_layers.4.weight" in blob["state_dict"]
        torch.save(blob, out)
    params, cfg, extra = load_checkpoint(out, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    assert extra == {"model": "odenet"}
    _same_tree(params, params_j)


# ---- eval_ckpt against the JAX tool ---------------------------------------


@pytest.fixture(scope="module")
def mnist_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    fabricate("mnist", root, 64)
    with open(root / "mnist" / "t10k-labels-idx1-ubyte", "rb") as f:
        raw = f.read()
    with gzip.open(root / "mnist" / "t10k-labels-idx1-ubyte.gz", "wb") as f:
        f.write(raw)  # the loaders take either; the plain one is read first
    return root


@pytest.mark.parametrize("rung", [[], ["--solver", "rk4", "--steps", "4"]],
                         ids=["dopri5", "rk4"])
def test_eval_ckpt_matches_the_jax_tool(mnist_files, capsys, rung):
    argv = ["--run", str(FIXTURE), "--dataset", "mnist", "--data-dir",
            str(mnist_files), "--limit", "48", "--batch-size", "32", "--cpu",
            *rung]
    want = jax_eval_ckpt.main(argv)
    got = eval_ckpt.main(argv)
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == got and json.loads(printed[-2]) == want
    assert got["n"] == want["n"] == 32  # whole batches only
    assert got["top1"] == want["top1"]
    assert abs(got["mean_nfe"] - want["mean_nfe"]) <= 0.01
    assert {k: v for k, v in got.items() if k not in ("top1", "mean_nfe")} \
        == {k: v for k, v in want.items() if k not in ("top1", "mean_nfe")}


def test_the_fixtures_stored_numbers():
    """The JSON beside the fixture is the JAX tool's line on the fabricated
    MNIST test split at chip_smoke.py's size."""
    stored = json.loads(FIXTURE_EVAL.read_text())
    assert set(stored) == {"argv", "result"}
    assert set(stored["result"]) == {"top1", "mean_nfe", "solver", "tol",
                                     "steps", "n"}
    assert stored["result"]["n"] == 512 and stored["result"]["top1"] > 0.5
    assert (FIXTURE / "params.json").exists()
