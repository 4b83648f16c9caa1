"""Example: the solver library as a general ODE toolbox (counterpart of the
JAX package's ``examples/solver_playground.py``).

    python -m neural_ode_features_tpu_torch.examples.solver_playground [--cpu]

1. A batch of damped pendulums, each row with its own damping γ, solved in
   one ``odeint`` call with per-sample adaptive stepping: each row gets its
   own step sequence and NFE.
2. The damping of one pendulum fitted from observations by gradient
   descent through ``odeint_adjoint`` over a params dict (40 steps from
   γ = 2.5 to the true 0.7, within 1e-3).

Runs on the card unless ``--cpu`` is given; no card is an error.  No
hand-written kernel is on this path.
"""

from __future__ import annotations

import argparse

import torch

from .._device import strict_f32
from ..solver import odeint, odeint_adjoint

GAMMAS = (0.05, 0.5, 2.0, 8.0)  # light to heavily damped
TRUE_GAMMA = 0.7


def _y0(rows: int, dev, dtype) -> torch.Tensor:
    return torch.tensor([[2.0, 0.0]], dtype=dtype, device=dev).repeat(rows, 1)


def pendulums(device="cuda", dtype=torch.float32):
    """``(ys (11, 4, 2), stats)``: the four pendulums over t = 0, 1, …, 10
    at rtol 1e-6, atol 1e-8, per-sample control."""
    dev = strict_f32(device)
    gammas = torch.tensor(GAMMAS, dtype=dtype, device=dev)

    def pendulum(t, y):  # y = (B, 2): angle, angular velocity
        theta, omega = y[:, 0], y[:, 1]
        return torch.stack([omega, -torch.sin(theta) - gammas * omega], dim=1)

    ts = torch.linspace(0.0, 10.0, 11, dtype=dtype, device=dev)
    return odeint(pendulum, _y0(len(GAMMAS), dev, dtype), ts, rtol=1e-6,
                  atol=1e-8, error_control="per_sample")


def fit_damping(steps: int = 40, device="cuda",
                dtype=torch.float32) -> float:
    """γ after ``steps`` gradient steps (learning rate 2.0) from 2.5 on the
    mean squared error against the γ = 0.7 trajectory at t = 0, 1, …, 5
    (rtol 1e-8, atol 1e-10)."""
    dev = strict_f32(device)

    def dyn(params, t, y):
        theta, omega = y[:, 0], y[:, 1]
        return torch.stack(
            [omega, -torch.sin(theta) - params["gamma"] * omega], dim=1)

    y0 = _y0(1, dev, dtype)
    obs_ts = torch.linspace(0.0, 5.0, 6, dtype=dtype, device=dev)
    with torch.no_grad():
        target, _ = odeint_adjoint(
            dyn, {"gamma": torch.tensor(TRUE_GAMMA, dtype=dtype, device=dev)},
            y0, obs_ts, rtol=1e-8, atol=1e-10)

    gamma = torch.tensor(2.5, dtype=dtype, device=dev)
    for _ in range(steps):
        p = {"gamma": gamma.clone().requires_grad_()}
        ys, _ = odeint_adjoint(dyn, p, y0, obs_ts, rtol=1e-8, atol=1e-10)
        grad, = torch.autograd.grad(((ys - target) ** 2).mean(), p["gamma"])
        gamma = gamma - 2.0 * grad
    return float(gamma)


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    ys, stats = pendulums(device)
    print("per-sample NFE (γ=0.05, 0.5, 2, 8):", stats.nfe.cpu().numpy())
    print("θ(10):", ys[-1, :, 0].cpu().numpy().round(4), "\n")

    gamma = fit_damping(device=device)
    print(f"fitted damping: {gamma:.5f} (true {TRUE_GAMMA})")
    assert abs(gamma - TRUE_GAMMA) < 1e-3
    return gamma


if __name__ == "__main__":
    main()
