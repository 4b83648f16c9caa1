"""Training across devices through the port's command lines and entry
points, on gloo ranks spawned on the CPU: ``train --num-devices`` (alone
and with ``--seeds``), ``entry.dryrun_multichip``, the FSDP example,
``multiseed``, and the launcher's own contract (backends, devices, a rank
that fails).  Small sizes (hidden 32, ``--limit`` 32 or 64)."""

import csv
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from neural_ode_features_tpu_torch import multiseed
from neural_ode_features_tpu_torch import train as port_train
from neural_ode_features_tpu_torch.entry import dryrun_multichip
from neural_ode_features_tpu_torch.examples import fsdp_training
from neural_ode_features_tpu_torch.parallel import (
    backend_for,
    launch,
    rank_devices,
)
from neural_ode_features_tpu_torch.parallel.tasks import train_steps
from neural_ode_features_tpu_torch.training import TrainConfig
from test_torch_population import _same_run

torch.set_num_threads(2)

LAUNCH_S = 120
SMALL = ["--cpu", "--dataset", "synthetic-mnist", "--hidden", "32",
         "--limit", "64", "--batch-size", "32", "--tol", "1e-2",
         "--epochs", "1"]


def _solo(tmp_path, seed, argv=SMALL):
    return Path(port_train.main([*argv, "--seed", str(seed), "--runs-dir",
                                 str(tmp_path / f"solo{seed}")]))


def test_seeds_on_two_ranks_write_the_solo_runs(tmp_path, capfd):
    """``--seeds 0,1 --num-devices 2``: each rank builds, trains and
    writes one member, whose run directory is bit-identical to its solo
    run."""
    pop = port_train.main([*SMALL, "--seeds", "0,1", "--num-devices", "2",
                           "--runs-dir", str(tmp_path / "pop")])
    out = capfd.readouterr().out
    assert out.count("backend gloo on cpu") == 2
    assert "population: 2 seeds" in out
    for seed, run in zip((0, 1), pop):
        _same_run(run, _solo(tmp_path, seed))


def test_seeds_that_do_not_divide_the_ranks_replicate(tmp_path, capfd):
    """Three seeds on two ranks: the JAX warning, and every rank trains
    every member; the runs are still the solo runs."""
    pop = port_train.main([*SMALL, "--seeds", "0,1,2", "--num-devices",
                           "2", "--runs-dir", str(tmp_path / "pop")])
    err = capfd.readouterr().err
    assert "population of 3 seeds does not divide the 2-device mesh" in err
    assert "the seed axis replicates" in err
    assert len(pop) == 3
    _same_run(pop[2], _solo(tmp_path, 2))


def _log(run_dir):
    with open(Path(run_dir) / "log.csv") as f:
        return list(csv.DictReader(f))


def test_num_devices_keeps_the_run_identity(tmp_path, capfd):
    """``--num-devices 2``: the solo run's directory name and
    ``params.json``; rank 0 alone writes it.  One epoch of two steps at
    B = 16 (augment on): the training columns at the JAX bars of the
    second step (tests/test_training.py:73-99), the evaluation after it
    at the step-2 loss bar."""
    argv = [*SMALL]
    argv[argv.index("--limit") + 1] = "32"
    argv[argv.index("--batch-size") + 1] = "16"
    dp = Path(port_train.main([*argv, "--num-devices", "2", "--runs-dir",
                               str(tmp_path / "dp")]))
    assert capfd.readouterr().out.count("backend gloo on cpu") == 2
    solo = _solo(tmp_path, 0, argv)
    assert dp.name == solo.name
    assert (dp / "params.json").read_bytes() == (
        solo / "params.json").read_bytes()
    for name in ("ckpt_best.pt", "ckpt_last.pt", "train_state.pt"):
        assert (dp / name).exists()
    (got,), (want,) = _log(dp), _log(solo)
    for key in ("train_loss", "test_loss"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=3e-4)
    assert got["nfe_f"] == want["nfe_f"]
    assert abs(float(got["nfe_b"]) - float(want["nfe_b"])) <= 1.0
    assert got["train_acc"] == want["train_acc"]


def test_num_devices_without_enough_cards_exits(tmp_path, monkeypatch):
    """More ranks than cards on ``cuda`` exits before a run directory,
    naming both counts; so does ``dryrun_multichip``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in SMALL if a != "--cpu"]
    runs = tmp_path / "runs"
    with pytest.raises(SystemExit, match="--num-devices 2: 0 CUDA device"):
        port_train.main([*argv, "--num-devices", "2", "--runs-dir",
                         str(runs)])
    assert not runs.exists()
    with pytest.raises(ValueError, match="2 ranks need 2 CUDA devices, 0"):
        dryrun_multichip(2)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_cpu(n, capfd):
    """The JAX ``dryrun_multichip``'s two lines: one step on n ranks (an
    FSDP (2, 2) mesh at n = 4), then a population of n seeds sharded over
    them whose member 0 equals the solo seed-0 epoch."""
    out = dryrun_multichip(n, device="cpu")
    lines = capfd.readouterr().out
    assert f"dryrun_multichip({n}): loss=" in lines
    assert f"dryrun_multichip({n}) population(K={n})" in lines
    assert ("data=2, model=2" if n == 4 else "data=2") in out["mesh"]
    assert np.isfinite(out["loss"])
    assert out["population"]["metrics"]["loss"].shape == (n, 1)
    # Rank 0 builds only the member it owns.
    assert out["population"]["owned"] == [0]
    assert list(out["population"]["params"]) == [0]


def test_fsdp_example_runs_on_cpu(capfd):
    out = fsdp_training.main(["--cpu"])
    text = capfd.readouterr().out
    assert "parameter leaves sharded over 'model': " in text
    assert "OK — same state across topologies" in text
    assert np.isfinite(out["continued"]["loss"])


def test_launch_contract():
    """Backends follow the devices and nothing else; a rank that raises
    ends the launch with its traceback."""
    assert backend_for(["cpu", "cpu"]) == "gloo"
    assert backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert backend_for(["cuda:0", "cuda:0"]) == "gloo"
    with pytest.raises(ValueError, match="mixed"):
        backend_for(["cpu", "cuda:0"])
    assert rank_devices(3, "cpu") == ["cpu"] * 3
    cfg = TrainConfig(dataset="synthetic-mnist", hidden=32, batch_size=15,
                      num_devices=2)
    with pytest.raises(RuntimeError, match="does not divide over the 2 "
                                           "ranks"):
        launch(train_steps, 2, cfg, [], devices=["cpu", "cpu"],
               device="cpu", timeout=LAUNCH_S)


def test_multiseed_records_and_summary(tmp_path, monkeypatch, capsys):
    """The campaign's JSONL records and ``--summarize``: a population cell
    parses the per-seed banners of ``train --seeds`` (the flags passed
    through), its records carry the JAX tool's keys, and the summary is
    mean ± std per cell."""
    runs = tmp_path / "runs"
    seen = {}

    def fake_run(module, argv, timeout):
        seen.setdefault(module, []).append(argv)
        lines = []
        for s in argv[argv.index("--seeds") + 1].split(","):
            d = runs / f"s{s}"
            d.mkdir(parents=True, exist_ok=True)
            with open(d / "log.csv", "w") as f:
                f.write(f"epoch,test_acc\n0,0.{s}\n1,0.{int(s) + 5}\n")
            lines.append(f"run dir (seed {s}): {d}")
        return "\n".join(lines)

    monkeypatch.setattr(multiseed, "_run", fake_run)
    multiseed.main(["--phase", "flagship", "--seeds", "0,1", "--population",
                    "--runs-dir", str(runs), "--cpu", "--num-devices", "2"])
    argv = seen["train"][0]
    assert argv[:2] == ["--dataset", "synthetic-cifar10"]
    assert "--cpu" in argv and argv[argv.index("--num-devices") + 1] == "2"
    recs = [json.loads(line) for line in
            (runs / "multiseed.jsonl").read_text().splitlines()]
    assert [r["key"] for r in recs] == ["flagship-seed0", "flagship-seed1"]
    assert [r["top1"] for r in recs] == [0.5, 0.6]
    assert all(r["population"] for r in recs)
    # Done cells are skipped.
    multiseed.main(["--phase", "flagship", "--seeds", "0,1", "--population",
                    "--runs-dir", str(runs)])
    assert len(seen["train"]) == 1
    capsys.readouterr()
    multiseed.main(["--summarize", "--runs-dir", str(runs)])
    table = capsys.readouterr().out.splitlines()
    assert table[1].split()[:4] == ["flagship", "2", "0.5500", "0.0707"]
