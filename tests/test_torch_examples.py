"""Port parity, the two examples against the JAX package's
(``examples/solver_playground.py``, ``examples/continuous_features.py``)
on the CPU: the pendulums' per-sample NFE, the fitted damping after three
gradient steps, and the continuous features at 9 times after a few
training steps from carried weights.  The whole scripts at their own sizes
run as subprocesses, marked ``slow`` as ``tests/test_examples.py`` marks
the JAX ones.

The damping after three steps.  The example runs in float32 at rtol 1e-8,
atol 1e-10, below f32's unit roundoff (6e-8), and XLA's ``sin`` differs
from PyTorch's by an ulp on about 5% of f32 inputs; so the two packages'
step sequences follow their own rounding.  The γ = 0.7 trajectories differ
by 4.2e-7, the first gradient by 1.6e-6 of itself, and three steps at
learning rate 2 leave γ 1.3e-6 apart: the float32 bar is 5e-6.  In float64
the tolerances lie above the rounding, and γ is held to 1e-6 of JAX's.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.evaluation import retrieval_map as jax_map
from neural_ode_features_tpu.models import ModelConfig as JaxModelConfig
from neural_ode_features_tpu.models import ODENet as JaxODENet
from neural_ode_features_tpu.models import init_odenet as jax_init_odenet
from neural_ode_features_tpu.ops.preprocess import normalize as jax_normalize
from neural_ode_features_tpu.solver import odeint as jax_odeint
from neural_ode_features_tpu.solver import odeint_adjoint as jax_adjoint
from neural_ode_features_tpu.utils.checkpoint import (
    from_torch_state_dict as jax_from_torch,
)
from neural_ode_features_tpu_torch.data import load_dataset
from neural_ode_features_tpu_torch.examples import (
    continuous_features,
    solver_playground,
)
from neural_ode_features_tpu_torch.training import TrainConfig
from neural_ode_features_tpu_torch.utils import (
    from_jax_params,
    to_torch_state_dict,
)

ROOT = Path(__file__).resolve().parent.parent

torch.set_num_threads(2)

GAMMA_ATOL = {"float32": 5e-6, "float64": 1e-6}  # module docstring


def _jax_pendulum(gammas):
    def pendulum(t, y):
        theta, omega = y[:, 0], y[:, 1]
        return jnp.stack([omega, -jnp.sin(theta) - gammas * omega], axis=1)
    return pendulum


def test_pendulums_per_sample_nfe_match_jax():
    f32 = jnp.float32
    y0 = jnp.tile(jnp.asarray([[2.0, 0.0]], f32), (4, 1))
    ts = jnp.linspace(0.0, 10.0, 11, dtype=f32)
    pendulum = _jax_pendulum(jnp.asarray(solver_playground.GAMMAS, f32))
    ys_j, stats_j = jax.jit(lambda y: jax_odeint(
        pendulum, y, ts, rtol=1e-6, atol=1e-8,
        error_control="per_sample"))(y0)
    ys, stats = solver_playground.pendulums("cpu")
    np.testing.assert_array_equal(stats.nfe.numpy(), np.asarray(stats_j.nfe))
    assert len(set(stats.nfe.tolist())) == 4  # one step sequence per row
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fitted_damping_after_three_steps_matches_jax(dtype):
    """Three gradient steps through ``odeint_adjoint`` over a params dict,
    the JAX side one jitted gradient, from γ = 2.5."""
    jdt = jnp.dtype(dtype)

    def dyn(params, t, y):
        theta, omega = y[:, 0], y[:, 1]
        return jnp.stack(
            [omega, -jnp.sin(theta) - params["gamma"] * omega], axis=1)

    y0 = jnp.asarray([[2.0, 0.0]], jdt)
    obs_ts = jnp.linspace(0.0, 5.0, 6, dtype=jdt)
    target, _ = jax_adjoint(dyn, {"gamma": jnp.asarray(0.7, jdt)}, y0,
                            obs_ts, rtol=1e-8, atol=1e-10)

    def loss(p):
        ys, _ = jax_adjoint(dyn, p, y0, obs_ts, rtol=1e-8, atol=1e-10)
        return jnp.mean((ys - target) ** 2)

    grad = jax.jit(jax.grad(loss))
    p = {"gamma": jnp.asarray(2.5, jdt)}
    for _ in range(3):
        p = {"gamma": p["gamma"] - 2.0 * grad(p)["gamma"]}
    got = solver_playground.fit_damping(3, "cpu", getattr(torch, dtype))
    assert abs(got - float(p["gamma"])) < GAMMA_ATOL[dtype], (
        got, float(p["gamma"]))
    assert abs(got - 2.5) > 1.0  # the steps moved it toward 0.7


def test_continuous_features_match_jax():
    """Two adjoint steps of B = 8 from the JAX initial weights, then the
    features of 16 test images at 9 times from one solve, against the JAX
    ``ODENet.features`` on the port's trained weights: NFE equal, features
    at 1e-3, and each t's retrieval mAP."""
    mcfg = TrainConfig(dataset="synthetic-mnist", tol=1e-2).model_config()
    jcfg = JaxModelConfig(**dataclasses.asdict(mcfg))
    p0 = jax.device_get(jax_init_odenet(jax.random.PRNGKey(0), jcfg))
    logs = []
    out = continuous_features.run(
        n_train=16, n_test=16, batch_size=8, steps_per_epoch=2, epochs=1,
        device="cpu", params=from_jax_params(p0, device="cpu"),
        log=logs.append)
    assert len(logs) == 1 + 1 + 9
    trained = jax_from_torch(p0, {
        k: v.numpy() for k, v in
        to_torch_state_dict(out["trainer"].full_params()).items()})
    x, y = load_dataset("synthetic-mnist", "test", limit=16)
    feats_j, stats_j = JaxODENet(trained, jcfg).features(
        jax_normalize(jnp.asarray(x), "synthetic-mnist"),
        jnp.asarray(out["ts"].numpy()))
    feats = out["features"].numpy()
    assert feats.shape == (9, 16, 64)
    np.testing.assert_array_equal(out["stats"].nfe.numpy(),
                                  np.asarray(stats_j.nfe))
    np.testing.assert_allclose(feats, np.asarray(feats_j), rtol=1e-3,
                               atol=1e-3)
    want = [jax_map(np.asarray(f, np.float64), y) for f in feats_j]
    np.testing.assert_allclose(out["maps"], want, atol=1e-3)


def _run_example(name: str) -> str:
    proc = subprocess.run(
        [sys.executable, "-m",
         f"neural_ode_features_tpu_torch.examples.{name}", "--cpu"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert proc.returncode == 0, (
        f"{name} failed (rc={proc.returncode})\n--- stdout ---\n"
        f"{proc.stdout}\n--- stderr ---\n{proc.stderr}")
    return proc.stdout


@pytest.mark.slow
def test_solver_playground_script():
    out = _run_example("solver_playground")
    assert "per-sample NFE" in out and "fitted damping:" in out


@pytest.mark.slow
def test_continuous_features_script():
    out = _run_example("continuous_features")
    assert "from one solve" in out
    assert out.count("retrieval mAP=") == 9
