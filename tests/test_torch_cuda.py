"""The port's CUDA kernels on the card, against their plain PyTorch
versions.  No JAX here: the card's machine has none.  Every test needs a
CUDA card and ``nvcc`` and skips without them.  On the card:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py -q
"""

import os
import shutil

import numpy as np
import pytest
import torch

from neural_ode_features_tpu_torch.entry import ENTRY_CONFIG, entry
from neural_ode_features_tpu_torch.kernels.odefunc import (
    odefunc,
    odefunc_plain,
    prepare,
)
from neural_ode_features_tpu_torch.kernels.rk_step import (
    dopri5_step,
    dopri5_step_plain,
)
from neural_ode_features_tpu_torch.models import head_apply, init_odenet, stem_apply
from neural_ode_features_tpu_torch.solver import DOPRI5, odeint

pytestmark = pytest.mark.cuda

TOL = 1e-3
STATE_TOL = dict(rtol=2e-4, atol=2e-5)  # f32 reassociation
RATIO_TOL = dict(rtol=2e-3, atol=1e-6)


@pytest.fixture
def dev(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc to build the kernels")
    # The plain versions' cuDNN convs must be strict f32, as on the main path.
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


def _inputs(dev, batch, side):
    rng = np.random.default_rng(3)
    arr = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    h = arr(rng.normal(size=(batch, side, side, 64)) * 0.3)
    t0 = arr(rng.uniform(0.0, 0.5, batch))
    dt = arr(rng.uniform(0.05, 0.2, batch))
    return h, t0, dt


@pytest.mark.parametrize("batch,side", [(16, 7), (5, 7), (9, 6)])
def test_kernels_match_plain(dev, batch, side):
    params = init_odenet(1, ENTRY_CONFIG, device=dev)
    w = prepare(params["odefunc"], (side, side))
    h, t0, dt = _inputs(dev, batch, side)
    before = odefunc.launches
    got = odefunc(w, t0, h, groups=32)
    assert odefunc.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               odefunc_plain(w, t0, h, 32).cpu().numpy(),
                               **STATE_TOL)

    y0 = h.reshape(batch, -1)
    f0 = odefunc_plain(w, t0, h, 32).reshape(batch, -1)
    kw = dict(hw=(side, side), groups=32, rtol=TOL, atol=TOL)
    before = dopri5_step.launches
    got = dopri5_step(w, DOPRI5, t0, dt, y0, f0, **kw)
    assert dopri5_step.launches == before + 1
    want = dopri5_step_plain(w, DOPRI5, t0, dt, y0, f0, **kw)
    for g, r in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   **STATE_TOL)
    np.testing.assert_allclose(got[3].cpu().numpy(), want[3].cpu().numpy(),
                               **RATIO_TOL)


def test_main_path_runs_the_kernels(dev):
    fwd, (params, x) = entry(device="cuda", batch=16)
    odefunc.launches = dopri5_step.launches = 0
    logits, nfe = fwd(params, x)
    assert odefunc.launches == 2
    assert dopri5_step.launches == int(((nfe - 2) // 6).max())

    cfg = ENTRY_CONFIG
    w = prepare(params["odefunc"], (7, 7))
    h0 = stem_apply(params["stem"], x, cfg)
    traj, stats = odeint(lambda t, y: odefunc_plain(w, t, y, 32), h0,
                         torch.tensor([0.0, 1.0], device=dev), rtol=TOL,
                         atol=TOL, error_control="per_sample")
    np.testing.assert_array_equal(nfe.cpu().numpy(), stats.nfe.cpu().numpy())
    np.testing.assert_allclose(
        logits.cpu().numpy(),
        head_apply(params["head"], traj[-1], cfg).cpu().numpy(),
        rtol=1e-3, atol=1e-3)


def test_refusals(dev):
    params = init_odenet(1, ENTRY_CONFIG, device=dev)["odefunc"]
    with pytest.raises(ValueError, match="do not take"):
        odefunc(params, 0.5, torch.zeros((2, 28, 28, 64), device=dev))
    with pytest.raises(ValueError, match="float32"):
        odefunc(params, 0.5, torch.zeros((2, 7, 7, 64), device=dev,
                                         dtype=torch.float64))
    h = torch.zeros((2, 7, 7, 64), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        odefunc(params, 0.5, h.transpose(1, 2))
