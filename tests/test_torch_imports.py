"""The port stands alone: it imports with ``jax`` blocked, its sources and
``chip_smoke.py`` reference neither JAX nor the JAX package, and its entry
points refuse to run without CUDA unless asked for the CPU."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import neural_ode_features_tpu_torch as port
from neural_ode_features_tpu_torch import (
    eval_ckpt,
    evaluate,
    export_model,
    extract,
    reference_protocol,
    straggler_bench,
)
from neural_ode_features_tpu_torch.entry import (
    entry,
    extract_entry,
    train_entry,
)
from neural_ode_features_tpu_torch.evaluation import evaluate_features
from neural_ode_features_tpu_torch.examples import (
    continuous_features,
    solver_playground,
)
from neural_ode_features_tpu_torch.models import (
    ModelConfig,
    ODENet,
    ResNet,
    init_odenet,
    init_resnet,
)
from neural_ode_features_tpu_torch.probes import conv_probe
from neural_ode_features_tpu_torch.utils import (
    from_jax_params,
    load_checkpoint,
    save_checkpoint,
)

ROOT = Path(__file__).resolve().parent.parent
PORT = Path(port.__file__).parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PORT)],
                                                        prefix=f"{port.__name__}."))


def test_imports_with_jax_blocked():
    mods = _modules()
    assert len(mods) >= 48
    for name in ("solver.adams", "solver.event", "solver.event_adjoint",
                 "train", "sweep", "utils.expman", "solver.fixed_grid",
                 "extract", "evaluate", "features_io", "solver.dense",
                 "models.resnet", "models.api", "evaluation.probes",
                 "kernels.conv3x3", "probes.conv_probe", "utils.checkpoint",
                 "eval_ckpt", "utils.flax_msgpack", "serving", "serve",
                 "export_model", "serve_client", "examples.native_serving",
                 "examples.deploy_artifact", "probes.serve_probe",
                 "parallel", "parallel.mesh", "parallel.launch",
                 "parallel.tasks", "multiseed", "examples.fsdp_training",
                 "probes.parallel_probe", "straggler_bench",
                 "reference_protocol", "examples.solver_playground",
                 "examples.continuous_features", "kernels.ops"):
        assert f"{port.__name__}.{name}" in mods
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['neural_ode_features_tpu'] = None\n"
        "sys.modules['flax'] = sys.modules['msgpack'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v]\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|msgpack|neural_ode_features_tpu)\b"
    r"(?!_torch)"
    r"|neural_ode_features_tpu\.(?!_torch)|import_module\(['\"]jax",
    re.MULTILINE)


def test_no_jax_references_in_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 49
    names = {f.name for f in files}
    assert {"train.py", "sweep.py", "expman.py", "fixed_grid.py", "adams.py",
            "event.py", "event_adjoint.py", "serving.py", "serve.py",
            "export_model.py", "serve_client.py", "native_serving.py",
            "deploy_artifact.py", "serve_probe.py", "mesh.py", "launch.py",
            "tasks.py", "multiseed.py", "fsdp_training.py",
            "parallel_probe.py", "straggler_bench.py", "reference_protocol.py",
            "solver_playground.py", "continuous_features.py",
            "ops.py"} <= names
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f}: references JAX or the JAX package: {hits}"


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(in_channels=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_odenet(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        from_jax_params({"w": np.zeros(2, np.float32)})
    params = init_odenet(0, cfg, device="cpu")
    assert params["odefunc"]["conv1"]["kernel"].shape == (3, 3, 65, 64)
    assert from_jax_params({"w": np.ones(2, np.float32)},
                           device="cpu")["w"].dtype == torch.float32
    fwd, (params, x) = entry(device="cpu", batch=1)
    assert x.device.type == "cpu"
    trainer, (images, labels) = train_entry(device="cpu", batch=2)
    assert trainer.device.type == "cpu" and images.shape == (2, 32, 32, 3)


def test_new_entry_points_need_cuda_unless_cpu(monkeypatch, tmp_path):
    """Every entry point of the extraction slice defaults to the card and
    raises without one; none carries on on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(in_channels=3, hidden=8, groups=4)
    params = init_odenet(0, cfg, device="cpu")
    ckpt = tmp_path / "ckpt_best.pt"
    save_checkpoint(ckpt, params, cfg,
                    {"train": {"dataset": "synthetic-cifar10"}})
    feats = np.zeros((8, 4), np.float32)
    labels = np.arange(8) % 2
    images = np.zeros((2, 32, 32, 3), np.uint8)
    calls = [
        lambda: extract_entry(),
        lambda: init_resnet(0, cfg),
        lambda: ODENet.create(0, cfg),
        lambda: ResNet.create(0, cfg),
        lambda: load_checkpoint(ckpt),
        lambda: evaluate_features(None, None, feats, labels),
        lambda: extract.extract_features(params, cfg, images, labels[:2],
                                         dataset="synthetic-cifar10"),
        lambda: extract.main(["--run", str(tmp_path), "--limit", "2"]),
        lambda: evaluate.main(["--features", str(tmp_path / "f.npz")]),
        lambda: conv_probe.main(["--batch", "1"]),
        lambda: eval_ckpt.main(["--run", str(tmp_path), "--limit", "2"]),
    ]
    out = extract.main(["--run", str(tmp_path), "--limit", "2", "--cpu",
                        "--timestamps", "2", "--output",
                        str(tmp_path / "f.npz")])
    assert out == tmp_path / "f.npz"
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_tools_and_examples_need_cuda_unless_cpu(monkeypatch, tmp_path):
    """The straggler bench, the reference protocol and both examples
    default to the card and raise without one, before they write or
    compute anything; with ``--cpu`` (or ``device="cpu"``) they run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: straggler_bench.main(["--pool", "8", "--batch-size", "4"]),
        lambda: straggler_bench.run_bench(pool=8, batch_size=4),
        lambda: reference_protocol.main(["--fabricate", "--data-dir",
                                         str(tmp_path)]),
        lambda: solver_playground.main([]),
        lambda: solver_playground.pendulums(),
        lambda: continuous_features.main([]),
        lambda: continuous_features.run(n_train=8, n_test=8, batch_size=8),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not any(tmp_path.iterdir())
    ys, stats = solver_playground.pendulums("cpu")
    assert ys.device.type == "cpu" and stats.nfe.shape == (4,)
    got = straggler_bench.main(["--pool", "4", "--batch-size", "4", "--dim",
                                "1", "--reps", "1", "--cpu"])
    assert got["backend"] == "cpu" and got["pool"] == 4


def test_code_free_export_needs_cuda_unless_cpu(monkeypatch, tmp_path):
    """``export_model export`` and ``run`` (the program whose kernels are
    the operators of ``kernels/ops.py``) default to the card and raise
    without one, before they write anything; with ``--cpu`` they run, and
    the operators take their plain versions."""
    cfg = ModelConfig(in_channels=1, hidden=8, groups=4, tol=1e-2)
    save_checkpoint(tmp_path / "ckpt_best.pt", init_odenet(0, cfg,
                                                           device="cpu"),
                    cfg, {"model": "odenet"})
    art = tmp_path / "model_b2.nodeexport"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["export", "--run", str(tmp_path), "--batch", "2"],
                 ["run", "--artifact", str(art)]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            export_model.main(argv)
    assert not art.exists()
    assert export_model.main(["export", "--run", str(tmp_path), "--batch",
                              "2", "--cpu"]) == art
    res = export_model.main(["run", "--artifact", str(art), "--reps", "1",
                             "--cpu"])
    assert res["out_shape"] == (2, 10)
