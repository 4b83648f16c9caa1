"""Port parity, the ``train`` CLI: the same command line through the root
``train.main`` (JAX) and ``neural_ode_features_tpu_torch.train.main`` gives
the same run directory name, ``params.json``, ``log.csv`` header and
checkpoint ``extra`` keys; a resumed run logs what an uninterrupted run
logs; every unported flag exits before a run directory exists; every
adjoint variant, the ResNet and a fixed-grid solver train through the CLI;
the run directory feeds the port's ``extract``, ``evaluate`` and ``sweep``
with no further argument; one ResNet ``train_batch`` equals the JAX
``Trainer``'s on carried weights.  Small sizes (hidden 32, ``--limit`` 64),
on the CPU."""

import csv
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.training import TrainConfig as JaxTrainConfig
from neural_ode_features_tpu.training import Trainer as JaxTrainer
from neural_ode_features_tpu_torch import evaluate, extract, sweep
from neural_ode_features_tpu_torch import train as port_train
from neural_ode_features_tpu_torch.data import load_dataset
from neural_ode_features_tpu_torch.training import TrainConfig, Trainer
from neural_ode_features_tpu_torch.utils import Experiment, from_jax_params

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import train as jax_train  # noqa: E402  (the root CLI)

torch.set_num_threads(2)

SMALL = ["--cpu", "--dataset", "synthetic-mnist", "--hidden", "32",
         "--limit", "64", "--batch-size", "16", "--tol", "1e-2"]
COLUMNS = ["epoch", "train_loss", "train_acc", "nfe_f", "nfe_b", "time_s",
           "test_loss", "test_acc", "test_nfe"]


def _rows(run_dir, drop=("time_s",)):
    with open(Path(run_dir) / "log.csv") as f:
        return [{k: v for k, v in r.items() if k not in drop}
                for r in csv.DictReader(f)]


def _as_stopped_run(run_dir: Path, argv: list[str]) -> Path:
    """``run_dir`` is a finished run of fewer epochs.  ``--epochs`` is part
    of the run identity (as in the JAX CLI), so give the directory the
    identity of the longer run ``argv``: the state that run is in after it
    was stopped at the shorter run's last epoch."""
    ident = port_train.run_identity(port_train.parse_args(argv))
    new = run_dir.parent / Experiment.name_from_params(ident)
    run_dir.rename(new)
    for name in ("params.json", "ckpt_last.pt", "ckpt_last.pt.json"):
        (new / name).unlink()
    return Experiment(run_dir.parent, ident).create().path


def test_same_command_line_same_run_identity_as_jax(tmp_path):
    argv = [*SMALL, "--epochs", "1", "--lr", "0.05", "--seed", "3"]
    jax_dir = Path(jax_train.main([*argv, "--runs-dir",
                                   str(tmp_path / "jax")]))
    port_dir = Path(port_train.main([*argv, "--runs-dir",
                                     str(tmp_path / "port")]))
    assert port_dir.name == jax_dir.name
    assert ((port_dir / "params.json").read_bytes()
            == (jax_dir / "params.json").read_bytes())
    header = (port_dir / "log.csv").read_text().splitlines()[0]
    assert header == (jax_dir / "log.csv").read_text().splitlines()[0]
    assert header.split(",") == COLUMNS
    for which in ("ckpt_best", "ckpt_last"):
        meta_p = json.loads((port_dir / f"{which}.pt.json").read_text())
        meta_j = json.loads((jax_dir / f"{which}.msgpack.json").read_text())
        assert set(meta_p["extra"]) == set(meta_j["extra"]) == {
            "epoch", "test_acc", "train", "model"}
        assert meta_p["extra"]["train"] == meta_j["extra"]["train"]
        assert meta_p["extra"]["model"] == meta_j["extra"]["model"]
        assert meta_p["config"] == meta_j["config"]
    assert (port_dir / "train_state.pt").exists()
    row_p, row_j = _rows(port_dir)[0], _rows(jax_dir)[0]
    assert row_p["epoch"] == row_j["epoch"] == "0"
    assert float(row_p["nfe_f"]) > 0 and float(row_p["nfe_b"]) > 0


@pytest.mark.parametrize("argv", [
    ["--epochs", "5"],
    ["--solver", "adams", "--tol", "1e-4"],
    ["--controller", "pi", "--adjoint-seminorm", "--no-augment"],
    ["--model", "resnet", "--no-adjoint", "--max-steps", "7", "--eval-every",
     "3", "--no-fused-epoch", "--no-resume", "--profile", "2"],
])
def test_identity_drops_the_jax_keys(argv):
    """The identity without running anything: the port's ``run_identity``
    against the JAX CLI's own dict comprehension on its own parser."""
    ours = port_train.run_identity(port_train.parse_args(argv))
    theirs = {k: v for k, v in vars(jax_train.parse_args(argv)).items()
              if k not in ("runs_dir", "data_dir", "cpu", "eval_every",
                           "profile", "resume", "tensorboard", "max_steps",
                           "state_format", "seeds", "num_devices",
                           "model_shards")}
    if theirs.get("controller") == "i":
        del theirs["controller"]
    assert ours == theirs
    assert vars(port_train.parse_args([])) == vars(jax_train.parse_args([]))


def test_resumed_run_equals_uninterrupted_run(tmp_path, capsys):
    """1 + 1 epochs against 2 epochs: the same ``log.csv`` apart from
    ``time_s`` (the data order, the augmentation draws, the optimizer state
    and the running averages all carry over)."""
    two = [*SMALL, "--epochs", "2"]
    straight = port_train.main([*two, "--runs-dir", str(tmp_path / "a")])
    first = Path(port_train.main([*SMALL, "--epochs", "1", "--runs-dir",
                                  str(tmp_path / "b")]))
    stopped = _as_stopped_run(first, two)
    capsys.readouterr()
    resumed = Path(port_train.main([*two, "--runs-dir", str(tmp_path / "b")]))
    assert resumed == stopped and resumed.name == Path(straight).name
    assert "at epoch 1" in capsys.readouterr().out
    assert _rows(resumed) == _rows(straight) and len(_rows(resumed)) == 2
    for name in ("ckpt_best.pt", "ckpt_last.pt"):
        a = torch.load(Path(straight) / name, weights_only=True)
        b = torch.load(resumed / name, weights_only=True)
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    # Launched once more, the finished run trains nothing and logs nothing.
    port_train.main([*two, "--runs-dir", str(tmp_path / "b")])
    assert len(_rows(resumed)) == 2
    # --no-resume starts over, which the fixed log header still accepts.
    port_train.main([*two, "--runs-dir", str(tmp_path / "b"), "--no-resume"])
    assert [r["epoch"] for r in _rows(resumed)] == ["0", "1", "0", "1"]


@pytest.mark.parametrize("flags,match", [
    (["--num-devices", "0"], "at least one"),
    (["--num-devices", "3"], "does not divide over the 3 ranks"),
    (["--model-shards", "2"], "does not divide 1 devices"),
    (["--bf16"], "Queue 2 item 5"),
    (["--state-format", "orbax"], "Queue 1 item 5"),
    (["--tensorboard"], "clu"),
    (["--hidden", "48"], "multiple of 32"),
    (["--seeds", "0,1", "--num-devices", "2", "--model-shards", "2"],
     "data parallelism only"),
    (["--seeds", "3,3"], "duplicate seeds"),
    (["--seeds", "0,1", "--no-fused-epoch"], "incompatible with --seeds"),
])
def test_unported_flags_exit_before_a_run_directory(tmp_path, flags, match,
                                                   monkeypatch):
    runs = tmp_path / "runs"
    argv = SMALL
    if flags == ["--bf16"]:
        # bf16 runs with --cpu (tests/test_torch_bf16.py); aimed at a card
        # it exits before any device use.
        argv = [a for a in SMALL if a != "--cpu"]
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

        def no_device_use(*args, **kwargs):
            raise AssertionError("the card was used before the exit")
        monkeypatch.setattr(torch.cuda, "device_count", no_device_use)
        monkeypatch.setattr(port_train, "strict_f32", no_device_use)
    with pytest.raises(SystemExit, match=match):
        port_train.main([*argv, "--epochs", "1", "--runs-dir", str(runs),
                         *flags])
    assert not runs.exists()


def test_no_card_is_an_error_not_a_cpu_run(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in SMALL if a != "--cpu"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_train.main([*argv, "--epochs", "1", "--runs-dir",
                         str(tmp_path / "runs")])
    assert not (tmp_path / "runs").exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sweep.main(["--tols", "1e-1", "--output", str(tmp_path / "s.csv")])


@pytest.mark.parametrize("flags,nfe_b", [
    (["--adjoint-seminorm"], True),
    (["--adjoint-mode", "interpolated"], True),
    (["--adjoint-mode", "interpolated", "--adjoint-seminorm",
      "--error-control", "global"], True),
    (["--solver", "rk4", "--no-adjoint"], False),
    (["--solver", "tsit5", "--controller", "pi", "--no-fused-epoch",
      "--profile", "1"], True),
    (["--model", "resnet", "--optimizer", "adam", "--lr", "0.001"], False),
], ids=lambda v: "-".join(x.strip("-") for x in v) if isinstance(v, list)
   else None)
def test_variants_train_through_the_cli(tmp_path, flags, nfe_b):
    run = Path(port_train.main([*SMALL, "--epochs", "1", "--runs-dir",
                                str(tmp_path), *flags]))
    (row,) = _rows(run)
    assert list(row) == [c for c in COLUMNS if c != "time_s"]
    assert np.isfinite(float(row["train_loss"]))
    assert np.isfinite(float(row["test_loss"]))
    assert (float(row["nfe_b"]) > 0) == nfe_b
    resnet = "resnet" in flags
    assert (float(row["nfe_f"]) == 0) == resnet
    assert (float(row["test_nfe"]) == 0) == resnet
    if "rk4" in flags:
        assert float(row["nfe_f"]) == 4.0
    if "--profile" in flags:
        assert (run / "profile" / "trace.json").stat().st_size > 0
    meta = json.loads((run / "ckpt_last.pt.json").read_text())
    assert meta["extra"]["model"] == ("resnet" if resnet else "odenet")


def test_run_directory_feeds_extract_evaluate_sweep(tmp_path):
    """What ``train`` wrote is read by the port's other CLIs with no further
    argument: the model and the dataset come from the sidecar."""
    run = Path(port_train.main([*SMALL, "--epochs", "1", "--runs-dir",
                                str(tmp_path)]))
    feats = extract.main(["--run", str(run), "--cpu", "--limit", "24",
                          "--timestamps", "3", "--batch-size", "16"])
    assert feats == run / "features_test.npz"
    metrics = evaluate.main(["--features", str(feats), "--cpu"])
    assert Path(metrics).exists()
    common = ["--run", str(run), "--cpu", "--limit", "32", "--batch-size",
              "16", "--tols", "1e-1,1e-3"]
    loop = sweep.main([*common, "--output", str(tmp_path / "loop.csv")])
    fused = sweep.main([*common, "--fused", "--output",
                        str(tmp_path / "fused.csv")])
    assert list(loop[0]) == ["tol", "top1", "ips", "nfe_mean", "nfe_min",
                             "nfe_max"]
    for a, b in zip(loop, fused):
        assert {k: a[k] for k in a if k != "ips"} == {
            k: b[k] for k in b if k != "sweep_s"}
    assert loop[1]["nfe_mean"] >= loop[0]["nfe_mean"]
    # A ResNet run has no tolerance to sweep.
    rrun = port_train.main([*SMALL, "--epochs", "1", "--model", "resnet",
                            "--runs-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="ODE-Net checkpoint"):
        sweep.main(["--run", str(rrun), "--cpu", "--output",
                    str(tmp_path / "r.csv")])
    rfeats = extract.main(["--run", str(rrun), "--cpu", "--limit", "8"])
    assert np.load(rfeats)["features"].shape[0] == 7  # num_blocks + 1 taps


def test_resnet_train_batch_matches_jax_trainer():
    """One SGD step of the ResNet on the JAX package's weights, augment
    off: loss at rtol 1e-5, NFE 0 on both sides, the updated parameters at
    rtol 1e-4 / atol 1e-6 (f32 convs summed in another order)."""
    kw = dict(dataset="synthetic-mnist", model="resnet", hidden=32,
              batch_size=8, augment=False, lr=0.05)
    images, labels = load_dataset("synthetic-mnist", "train", limit=8)
    jt = JaxTrainer(JaxTrainConfig(**kw, num_devices=1), steps_per_epoch=4)
    params_j = jax.device_get(jt.params)
    tt = Trainer(TrainConfig(**kw), steps_per_epoch=4, device="cpu",
                 params=from_jax_params(params_j, device="cpu"))
    mj = jax.device_get(jt.train_batch(images, labels.astype(np.int32),
                                       jax.random.PRNGKey(0)))
    mt = tt.train_batch(images, labels)
    np.testing.assert_allclose(mt["loss"], float(mj["loss"]), rtol=1e-5)
    assert mt["acc"] == float(mj["acc"])
    assert mt["nfe"] == float(mj["nfe"]) == 0.0
    assert mt["nfe_b"] == float(mj["nfe_b"]) == 0.0
    assert tt.last_stats is None
    new_j = jax.tree.leaves(jax.device_get(jt.params))
    new_t = jax.tree.leaves(jax.tree.map(lambda p: p.detach().numpy(),
                                         tt.params))
    moved = 0.0
    for a, b, old in zip(new_t, new_j, jax.tree.leaves(params_j)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
        moved = max(moved, float(np.abs(b - old).max()))
    assert moved > 1e-4
    ev = tt.evaluate_fused(images[:6], labels[:6])
    assert ev["nfe"] == 0.0 and 0.0 <= ev["acc"] <= 1.0
    assert jnp.isfinite(mj["loss"])


def test_adams_trains_and_sweeps_through_the_cli(tmp_path):
    """``train --solver adams``: the JAX CLI's run directory name and
    ``params.json`` (``solver=adams`` in them), two evaluations per attempt
    in the logged NFE; then ``sweep --method adams`` writes the JAX CLI's
    columns, per tolerance and with ``--fused``, with equal rows."""
    from neural_ode_features_tpu.utils.expman import (
        Experiment as JaxExperiment,
    )

    argv = [*SMALL, "--epochs", "1", "--solver", "adams"]
    run = Path(port_train.main([*argv, "--runs-dir", str(tmp_path)]))
    ident = {k: v for k, v in vars(jax_train.parse_args(argv)).items()
             if k not in ("runs_dir", "data_dir", "cpu", "eval_every",
                          "profile", "resume", "tensorboard", "max_steps",
                          "state_format", "seeds", "num_devices",
                          "model_shards", "controller")}
    assert run.name == JaxExperiment.name_from_params(ident)
    assert json.loads((run / "params.json").read_text())["solver"] == "adams"
    (row,) = _rows(run)
    assert float(row["nfe_b"]) > 0 and np.isfinite(float(row["train_loss"]))
    common = ["--run", str(run), "--cpu", "--limit", "32", "--batch-size",
              "16", "--tols", "1e-1,1e-3", "--method", "adams"]
    loop = sweep.main([*common, "--output", str(tmp_path / "loop.csv")])
    fused = sweep.main([*common, "--fused", "--output",
                        str(tmp_path / "fused.csv")])
    assert list(loop[0]) == ["tol", "top1", "ips", "nfe_mean", "nfe_min",
                             "nfe_max"]
    for a, b in zip(loop, fused):
        assert {k: a[k] for k in a if k != "ips"} == {
            k: b[k] for k in b if k != "sweep_s"}
        assert (a["nfe_min"] - 2) % 2 == 0  # two evaluations per attempt
    assert loop[1]["nfe_mean"] > loop[0]["nfe_mean"]
    # An Adams run directory extracts through the Adams dense output.
    feats = extract.main(["--run", str(run), "--cpu", "--limit", "16",
                          "--timestamps", "3"])
    data = np.load(feats)
    assert data["features"].shape == (3, 16, 32)
    assert np.isfinite(data["features"]).all()
    assert ((data["nfe"] - 2) % 2 == 0).all()
