"""Port parity, checkpoint conversion: the port's ``convert_checkpoint``
against the JAX tool ``tools/convert_checkpoint.py``.  ``to-torch`` of the
committed JAX run directory gives the JAX tool's own pickle (names, layouts,
config, extra), which the JAX tool's ``from-torch`` turns back into params
bit-equal to the ``.msgpack``; a port ``.pt`` survives ``to-torch`` then
``from-torch`` bit for bit; ``.msgpack`` output is refused.  On the CPU."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.utils import load_checkpoint as jax_load
from neural_ode_features_tpu_torch import convert_checkpoint
from neural_ode_features_tpu_torch.models import (
    ModelConfig,
    init_odenet,
    init_resnet,
)
from neural_ode_features_tpu_torch.utils import load_checkpoint, save_checkpoint

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tools import convert_checkpoint as jax_tool  # noqa: E402

FIXTURE = (Path(__file__).resolve().parent / "fixtures_torch"
           / "jax_run_mnist" / "ckpt_best.msgpack")


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def test_to_torch_is_the_jax_tools_pickle(tmp_path, capsys):
    convert_checkpoint.main(["to-torch", str(FIXTURE),
                             str(tmp_path / "port.pt")])
    assert "wrote torch checkpoint" in capsys.readouterr().out
    jax_tool.main(["to-torch", str(FIXTURE), str(tmp_path / "jax.pt")])
    ours = torch.load(tmp_path / "port.pt", weights_only=True)
    theirs = torch.load(tmp_path / "jax.pt", weights_only=False)
    assert ours["config"] == theirs["config"]
    assert ours["extra"] == theirs["extra"]
    assert ours["state_dict"].keys() == theirs["state_dict"].keys()
    for k, v in theirs["state_dict"].items():
        assert torch.equal(ours["state_dict"][k], v), k


def test_jax_from_torch_reads_the_port_pickle_bit_equal(tmp_path):
    """The port's ``to-torch`` → the JAX tool's ``from-torch`` → a
    ``.msgpack`` whose params equal the fixture's bit for bit."""
    convert_checkpoint.to_torch(FIXTURE, tmp_path / "port.pt")
    jax_tool.main(["from-torch", str(tmp_path / "port.pt"),
                   str(tmp_path / "back.msgpack")])
    want, cfg_w, extra_w = jax_load(str(FIXTURE))
    got, cfg_g, extra_g = jax_load(str(tmp_path / "back.msgpack"))
    assert cfg_g == cfg_w and extra_g == extra_w
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(_leaves(got), _leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("model", ["odenet", "resnet"])
def test_port_pt_round_trip_is_exact(tmp_path, model):
    cfg = ModelConfig(in_channels=1, hidden=32)
    init = init_odenet if model == "odenet" else init_resnet
    params = init(3, cfg, device="cpu")
    extra = {"epoch": 4, "test_acc": 0.5, "model": model}
    save_checkpoint(tmp_path / "a.pt", params, cfg, extra=extra)
    convert_checkpoint.main(["to-torch", str(tmp_path / "a.pt"),
                             str(tmp_path / "t.pt")])
    convert_checkpoint.main(["from-torch", str(tmp_path / "t.pt"),
                             str(tmp_path / "b.pt")])
    pa, ca, ea = load_checkpoint(tmp_path / "a.pt", device="cpu")
    pb, cb, eb = load_checkpoint(tmp_path / "b.pt", device="cpu")
    assert cb == ca and eb == ea
    la, lb = (torch.utils._pytree.tree_leaves(p) for p in (pa, pb))
    assert len(la) == len(lb)
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    # A bare state dict with the sidecar as --config: the same checkpoint.
    torch.save(torch.load(tmp_path / "t.pt", weights_only=True)
               ["state_dict"], tmp_path / "bare.pt")
    convert_checkpoint.main(["from-torch", str(tmp_path / "bare.pt"),
                             str(tmp_path / "c.pt"), "--config",
                             str(tmp_path / "a.pt.json")])
    pc, cc, _ = load_checkpoint(tmp_path / "c.pt", device="cpu")
    assert cc == ca and all(torch.equal(a, c) for a, c in zip(
        la, torch.utils._pytree.tree_leaves(pc)))


def test_msgpack_output_is_refused(tmp_path):
    convert_checkpoint.to_torch(FIXTURE, tmp_path / "t.pt")
    for argv in (["from-torch", str(tmp_path / "t.pt"),
                  str(tmp_path / "x.msgpack")],
                 ["to-torch", str(FIXTURE), str(tmp_path / "y.msgpack")]):
        with pytest.raises(SystemExit, match="does not write .msgpack"):
            convert_checkpoint.main(argv)
    assert not list(tmp_path.glob("*.msgpack*"))
    # A bare state dict needs the architecture from somewhere.
    torch.save(torch.load(tmp_path / "t.pt", weights_only=True)
               ["state_dict"], tmp_path / "bare.pt")
    with pytest.raises(SystemExit, match="--config"):
        convert_checkpoint.main(["from-torch", str(tmp_path / "bare.pt"),
                                 str(tmp_path / "z.pt")])
