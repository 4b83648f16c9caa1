"""Population training through the ``train`` CLI: ``--seeds 3,4`` writes
one run directory per seed, each the one the port's solo ``--seed 3`` and
``--seed 4`` runs write: the same name and ``params.json``, ``log.csv`` rows
equal but ``time_s``, bit-identical checkpoints and training states; a
population stopped after one epoch resumes both members to what the solo
two-epoch runs hold.  ``multi.PopulationTrainer``'s surface on its own.
Small sizes (hidden 32, ``--limit`` 64), on the CPU."""

import csv
from pathlib import Path

import numpy as np
import pytest
import torch

from neural_ode_features_tpu_torch import train as port_train
from neural_ode_features_tpu_torch.data import load_dataset
from neural_ode_features_tpu_torch.multi import PopulationTrainer
from neural_ode_features_tpu_torch.training import TrainConfig, Trainer
from neural_ode_features_tpu_torch.utils import Experiment

torch.set_num_threads(2)

SMALL = ["--cpu", "--dataset", "synthetic-mnist", "--hidden", "32",
         "--limit", "64", "--batch-size", "32", "--tol", "1e-2"]
FILES = ("ckpt_best.pt", "ckpt_last.pt", "train_state.pt")


def _rows(run_dir):
    with open(Path(run_dir) / "log.csv") as f:
        return [{k: v for k, v in r.items() if k != "time_s"}
                for r in csv.DictReader(f)]


def _same_run(a: Path, b: Path) -> None:
    assert a.name == b.name
    assert (a / "params.json").read_bytes() == (b / "params.json").read_bytes()
    assert _rows(a) == _rows(b)
    for name in FILES:
        sa = torch.load(a / name, weights_only=True)
        sb = torch.load(b / name, weights_only=True)
        assert sa.keys() == sb.keys(), name
        assert all(torch.equal(sa[k], sb[k]) for k in sa), name
        if name != "train_state.pt":
            assert ((a / f"{name}.json").read_bytes()
                    == (b / f"{name}.json").read_bytes())


def _solo(tmp_path, seed, epochs):
    return Path(port_train.main([*SMALL, "--epochs", str(epochs), "--seed",
                                 str(seed), "--runs-dir",
                                 str(tmp_path / f"solo{epochs}")]))


def test_seeds_write_the_solo_runs(tmp_path, capsys):
    pop = [Path(d) for d in port_train.main(
        [*SMALL, "--epochs", "1", "--seeds", "3,4", "--runs-dir",
         str(tmp_path / "pop")])]
    assert "population: 2 seeds" in capsys.readouterr().out
    assert len(pop) == 2
    for seed, run in zip((3, 4), pop):
        _same_run(run, _solo(tmp_path, seed, 1))


def test_population_resumes_every_member(tmp_path, capsys):
    """One epoch, then the directories given the two-epoch identity (the
    state a two-epoch population is in when stopped there) and the
    two-epoch command again: both members resume at epoch 1 and end where
    the solo two-epoch runs end."""
    two = [*SMALL, "--epochs", "2", "--seeds", "3,4", "--runs-dir",
           str(tmp_path / "pop")]
    first = port_train.main([*SMALL, "--epochs", "1", "--seeds", "3,4",
                             "--runs-dir", str(tmp_path / "pop")])
    for seed, run in zip((3, 4), map(Path, first)):
        ident = port_train.run_identity(port_train.parse_args(
            [*SMALL, "--epochs", "2", "--seed", str(seed)]))
        new = run.parent / Experiment.name_from_params(ident)
        run.rename(new)
        for name in ("params.json", "ckpt_last.pt", "ckpt_last.pt.json"):
            (new / name).unlink()
        Experiment(run.parent, ident).create()
    capsys.readouterr()
    resumed = [Path(d) for d in port_train.main(two)]
    assert capsys.readouterr().out.count("at epoch 1") == 2
    for seed, run in zip((3, 4), resumed):
        _same_run(run, _solo(tmp_path, seed, 2))
    # A member missing its state stops the population before it trains.
    (resumed[1] / "train_state.pt").unlink()
    with pytest.raises(SystemExit, match="partial population state"):
        port_train.main(two)


def test_population_trainer_surface(tmp_path):
    cfg = TrainConfig(dataset="synthetic-mnist", hidden=32, batch_size=32,
                      tol=1e-2)
    x, y = load_dataset("synthetic-mnist", "train", limit=64)
    pop = PopulationTrainer(cfg, [5, 6], steps_per_epoch=2, device="cpu")
    solo = Trainer(TrainConfig(**{**cfg.__dict__, "seed": 6}),
                   steps_per_epoch=2, device="cpu")
    em = pop.train_epoch(x, y, 0)
    assert em["loss"].shape == (2, 2)
    em_solo = solo.train_epoch(x, y, 0)
    np.testing.assert_array_equal(em["loss"][1], em_solo["loss"])
    evs = pop.evaluate_fused(x, y)
    assert len(evs) == 2 and evs[1] == solo.evaluate_fused(x, y)
    p1 = pop.params_for(1)
    assert all(torch.equal(a, b) for a, b in zip(
        torch.utils._pytree.tree_leaves(p1),
        torch.utils._pytree.tree_leaves(solo.params)))
    paths = [tmp_path / f"s{i}.pt" for i in range(2)]
    for i, path in enumerate(paths):
        pop.save_state_for(i, path, extra={"loss_avg": float(i)})
    fresh = PopulationTrainer(cfg, [5, 6], steps_per_epoch=2, device="cpu")
    assert fresh.load_states(paths) == [{"loss_avg": 0.0}, {"loss_avg": 1.0}]
    assert fresh.members[1].step_count == 2
    with pytest.raises(ValueError, match="duplicate seeds"):
        PopulationTrainer(cfg, [1, 1], steps_per_epoch=2, device="cpu")
    with pytest.raises(ValueError, match="states for"):
        fresh.load_states(paths[:1])
