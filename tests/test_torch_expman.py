"""Port parity, ``utils/expman.py``: the port's own ``Experiment`` against
the JAX package's, over the cases of ``tests/test_expman.py``: the same dict
gives the same directory name and the same ``params.json`` bytes, the same
header enforcement and the same mismatch refusal, and either package opens
a run directory the other made."""

import pytest

from neural_ode_features_tpu.utils.expman import Experiment as JaxExperiment
from neural_ode_features_tpu_torch.utils import Experiment

WIDE = {f"flag_number_{i}": i * 0.5 for i in range(40)}  # a very long name
CASES = [
    {"lr": 0.1, "seed": 3, "tol": 1e-3},
    {"tol": 1e-3, "seed": 3, "lr": 0.1},
    WIDE,
    dict(WIDE, zzz_seed=0),
    dict(WIDE, zzz_seed=1),
    {"dataset": "synthetic-mnist", "adjoint": True, "bf16": False,
     "lr_decay_epochs": "60,100,140", "limit": None, "tol": 0.001,
     "error_control": "per_sample", "lr": 1e-05},
]


@pytest.mark.parametrize("params", CASES)
def test_name_and_params_json_equal_jax(tmp_path, params):
    assert (Experiment.name_from_params(params)
            == JaxExperiment.name_from_params(params))
    e = Experiment(tmp_path / "port", params).create()
    j = JaxExperiment(tmp_path / "jax", params).create()
    assert e.name == j.name and len(e.name) <= 200
    assert ((e.path / "params.json").read_bytes()
            == (j.path / "params.json").read_bytes())
    assert e.exists and Experiment.from_dir(e.path).params == \
        JaxExperiment.from_dir(j.path).params


def test_truncated_names_do_not_collide():
    n1 = Experiment.name_from_params(dict(WIDE, zzz_seed=0))
    n2 = Experiment.name_from_params(dict(WIDE, zzz_seed=1))
    assert len(n1) == len(n2) <= 200 and n1 != n2 and n1[:50] == n2[:50]
    assert len(n1.encode()) < 255


def test_run_directory_is_shared_between_the_packages(tmp_path):
    """A directory the JAX ``Experiment`` made resumes under the port's with
    the same params and refuses different ones, and the other way round."""
    params = {"lr": 0.1, "seed": 3}
    j = JaxExperiment(tmp_path, params).create()
    e = Experiment(tmp_path, params).create()
    assert e.path == j.path
    for cls in (Experiment, JaxExperiment):
        with pytest.raises(ValueError, match="DIFFERENT experiment"):
            cls(tmp_path, {"lr": 0.2, "seed": 4}, name=j.name).create()


def test_log_schema_enforced_as_in_jax(tmp_path):
    e = Experiment(tmp_path / "port", {"lr": 0.1}).create()
    j = JaxExperiment(tmp_path / "jax", {"lr": 0.1}).create()
    for exp in (e, j):
        exp.log({"epoch": 0, "loss": 1.5})
        with pytest.raises(ValueError, match="schema mismatch"):
            exp.log({"epoch": 1, "loss": 1.2, "val_acc": 0.3})
        exp.log({"epoch": 1, "loss": 1.2})
    assert e.read_log() == j.read_log()
    assert ((e.path / "log.csv").read_bytes()
            == (j.path / "log.csv").read_bytes())
    assert e.file("x.pt") == e.path / "x.pt"
    assert Experiment(tmp_path, {"a": 1}).read_log() == []
