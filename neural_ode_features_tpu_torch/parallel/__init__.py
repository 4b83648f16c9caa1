"""Training across devices: the mesh and sharding rules
(``mesh.py``, port of ``neural_ode_features_tpu/parallel/``) and the
one-process-per-device launcher (``launch.py``)."""

from .launch import backend_for, launch, rank_devices
from .mesh import (
    all_gather_parts,
    all_reduce_sum,
    data_sharding,
    differentiable_sum,
    local_part,
    make_mesh,
    param_shardings,
    param_spec,
    population_sharding,
    replicate,
    shard_batch,
)

__all__ = ["make_mesh", "shard_batch", "replicate", "data_sharding",
           "param_spec", "param_shardings", "population_sharding",
           "local_part", "all_reduce_sum",
           "differentiable_sum", "all_gather_parts", "launch",
           "rank_devices", "backend_for"]
