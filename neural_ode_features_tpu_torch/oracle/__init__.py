"""The CPU reference execution model the headline bench's ``vs_baseline``
is measured against (the port's own copy of the JAX package's torch
oracle)."""

from .torch_ref import (
    TorchODENet,
    build_torch_odenet,
    load_params_into_torch,
    torch_odeint,
)

__all__ = ["TorchODENet", "build_torch_odenet", "load_params_into_torch",
           "torch_odeint"]
