"""Torch-CPU oracle: an independent dopri5 + ODE-Net, the denominator of the
headline bench's ``vs_baseline`` (the port's own copy of the JAX package's
``oracle/torch_ref.py``: its ``torch_odeint`` and ``build_torch_odenet``,
and a loader that takes the port's parameter tree).

It is the reference's execution model, torchdiffeq's semantics written
afresh from the published algorithm and architecture: Dormand–Prince 5(4)
with Hairer's initial step and batch-global RMS error control, stepped by a
host loop, on an NCHW Chen et al. ODE-Net, on the CPU.  ``BASELINE.json``'s
"≥10x images/sec/chip vs CPU torchdiffeq" is measured against it, so it
stays that model and not the port's plain path: the ratio keeps the JAX
bench's meaning.  The JAX package's copy stays the JAX tests' oracle;
``tests/test_torch_oracle.py`` holds this one bit for bit against it.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..utils.checkpoint import to_torch_state_dict

__all__ = ["TorchODENet", "torch_odeint", "build_torch_odenet",
           "load_params_into_torch"]

# Dormand–Prince tableau (the published constants, as ``tableau.py``).
_C = [0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0]
_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_B = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0]
_BHAT = [
    5179 / 57600, 0.0, 7571 / 16695, 393 / 640,
    -92097 / 339200, 187 / 2100, 1 / 40,
]
_E = [b - bh for b, bh in zip(_B, _BHAT)]


def torch_odeint(func, y0, ts, rtol, atol, max_steps=100_000):
    """Host-driven adaptive dopri5 with batch-global error control.

    func(t, y) -> dy; y0 any-shape tensor; ts 1-D ascending.  Returns
    (ys stacked over ts, nfe).  Output times are hit by *stepping exactly
    to them* (clamped steps) — simpler than dense output and equally
    accurate; NFE parity with the interpolating solver is approximate.
    """
    nfe = 0

    def f(t, y):
        nonlocal nfe
        nfe += 1
        return func(t, y)

    t0 = float(ts[0])
    y = y0.clone()
    f0 = f(t0, y)

    def err_norm(err, y_a, y_b):
        scale = atol + rtol * torch.maximum(y_a.abs(), y_b.abs())
        return float(torch.sqrt(torch.mean((err / scale) ** 2)))

    # Hairer initial step.
    scale = atol + rtol * y.abs()
    d0 = float(torch.sqrt(torch.mean((y / scale) ** 2)))
    d1 = float(torch.sqrt(torch.mean((f0 / scale) ** 2)))
    h0 = 1e-6 if (d0 < 1e-5 or d1 < 1e-5) else 0.01 * d0 / d1
    y1g = y + h0 * f0
    f1g = f(t0 + h0, y1g)
    d2 = float(torch.sqrt(torch.mean(((f1g - f0) / scale) ** 2))) / h0
    if max(d1, d2) <= 1e-15:
        h1 = max(1e-6, h0 * 1e-3)
    else:
        h1 = (0.01 / max(d1, d2)) ** 0.2
    dt = min(100 * h0, h1)

    outs = [y0.clone()]
    t = t0
    for t_target in [float(x) for x in ts[1:]]:
        while t < t_target:
            dt = min(dt, t_target - t)
            ks = [f0]
            for i in range(1, 7):
                yi = y + dt * sum(a * k for a, k in zip(_A[i], ks))
                ks.append(f(t + _C[i] * dt, yi))
            y_new = y + dt * sum(b * k for b, k in zip(_B, ks) if b)
            err = dt * sum(e * k for e, k in zip(_E, ks) if e)
            ratio = err_norm(err, y, y_new)
            if ratio <= 1.0:
                t, y, f0 = t + dt, y_new, ks[-1]
                factor = min(10.0, max(1.0, 0.9 * ratio ** -0.2 if ratio > 0 else 10.0))
            else:
                factor = max(0.2, min(1.0, 0.9 * ratio ** -0.2))
            dt *= factor
            max_steps -= 1
            if max_steps <= 0:
                raise RuntimeError("torch oracle: max_steps exceeded")
        outs.append(y.clone())
    return torch.stack(outs), nfe


def build_torch_odenet(in_channels=1, hidden=64, groups=32, num_classes=10):
    """Same architecture as ``models/odenet.py``, in torch NCHW."""

    class ConcatConv(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2d(hidden + 1, hidden, 3, padding=1)

        def forward(self, t, x):
            tt = torch.full_like(x[:, :1], float(t))
            return self.conv(torch.cat([tt, x], dim=1))

    class ODEFunc(nn.Module):
        def __init__(self):
            super().__init__()
            self.norm1 = nn.GroupNorm(groups, hidden)
            self.conv1 = ConcatConv()
            self.norm2 = nn.GroupNorm(groups, hidden)
            self.conv2 = ConcatConv()
            self.norm3 = nn.GroupNorm(groups, hidden)

        def forward(self, t, x):
            out = torch.relu(self.norm1(x))
            out = self.conv1(t, out)
            out = torch.relu(self.norm2(out))
            out = self.conv2(t, out)
            return self.norm3(out)

    class TorchODENetImpl(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv0 = nn.Conv2d(in_channels, hidden, 3)
            self.norm1 = nn.GroupNorm(groups, hidden)
            self.conv1 = nn.Conv2d(hidden, hidden, 4, stride=2, padding=1)
            self.norm2 = nn.GroupNorm(groups, hidden)
            self.conv2 = nn.Conv2d(hidden, hidden, 4, stride=2, padding=1)
            self.odefunc = ODEFunc()
            self.head_norm = nn.GroupNorm(groups, hidden)
            self.fc = nn.Linear(hidden, num_classes)

        def stem(self, x):
            x = self.conv0(x)
            x = self.conv1(torch.relu(self.norm1(x)))
            x = self.conv2(torch.relu(self.norm2(x)))
            return x

        def forward(self, x, rtol=1e-3, atol=1e-3):
            h0 = self.stem(x)
            ts = torch.tensor([0.0, 1.0])
            traj, nfe = torch_odeint(
                lambda t, y: self.odefunc(t, y), h0, ts, rtol, atol
            )
            h = torch.relu(self.head_norm(traj[-1]))
            return self.fc(h.mean(dim=(2, 3))), nfe

    return TorchODENetImpl()


TorchODENet = build_torch_odenet

# The port's internal state-dict prefixes → the oracle's module names.
_NAME_MAP = {
    "stem.conv0": "conv0", "stem.norm1": "norm1", "stem.conv1": "conv1",
    "stem.norm2": "norm2", "stem.conv2": "conv2",
    "odefunc.norm1": "odefunc.norm1", "odefunc.conv1": "odefunc.conv1.conv",
    "odefunc.norm2": "odefunc.norm2", "odefunc.conv2": "odefunc.conv2.conv",
    "odefunc.norm3": "odefunc.norm3",
    "head.norm": "head_norm", "head.fc": "fc",
}


def load_params_into_torch(torch_model, params):
    """Fill the oracle from a port parameter tree (``models.init_odenet``,
    ``utils.load_checkpoint``; any device) through the port's checkpoint
    name map (``utils.checkpoint.to_torch_state_dict``).  Only the
    conv-stem ODE-Net has a counterpart: a 'res' stem or a ResNet raises."""
    if "block1" in params.get("stem", {}):
        raise ValueError(
            "the torch oracle only implements the 'conv' downsampling stem; "
            "checkpoints trained with --downsampling res cannot be loaded "
            "into it (use --skip-baseline or a conv-stem checkpoint)"
        )
    out = {}
    for k, v in to_torch_state_dict(params).items():
        prefix, leaf = k.rsplit(".", 1)
        if prefix not in _NAME_MAP:
            raise ValueError(
                f"checkpoint key '{k}' has no torch-oracle counterpart — "
                "the oracle only implements the conv-stem ODE-Net "
                "(use --skip-baseline or an odenet/conv checkpoint)"
            )
        out[f"{_NAME_MAP[prefix]}.{leaf}"] = v
    torch_model.load_state_dict(out)
    return torch_model
