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
from neural_ode_features_tpu_torch.entry import entry, train_entry
from neural_ode_features_tpu_torch.models import ModelConfig, init_odenet
from neural_ode_features_tpu_torch.utils import from_jax_params

ROOT = Path(__file__).resolve().parent.parent
PORT = Path(port.__file__).parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PORT)],
                                                        prefix=f"{port.__name__}."))


def test_imports_with_jax_blocked():
    mods = _modules()
    assert len(mods) >= 15
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['neural_ode_features_tpu'] = None\n"
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
    r"^\s*(import|from)\s+(jax|neural_ode_features_tpu)\b(?!_torch)"
    r"|neural_ode_features_tpu\.(?!_torch)|import_module\(['\"]jax",
    re.MULTILINE)


def test_no_jax_references_in_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 15
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
