"""Device mesh and sharding rules (port of
``neural_ode_features_tpu/parallel/mesh.py``).

The JAX module builds one ``Mesh`` over the local devices of one process and
lets GSPMD place the collectives.  Here one process runs per device
(``launch.py``), and the mesh is a ``torch.distributed`` ``DeviceMesh`` over
those ranks with the JAX axis names:

* ``("data",)``: data parallelism.  Each rank takes its rows of every global
  batch; gradients are summed over ``data``.
* ``("data", "model")``: and FSDP-style parameter sharding.  Every parameter
  and optimizer-state leaf is split along its largest divisible dimension
  over ``model`` (:func:`param_spec`, the JAX rule verbatim).  Adjacent
  ranks lie on ``model``, as adjacent device ids do in JAX.

The sharding helpers return DTensor placements, one per mesh dimension
(``Shard(d)`` for ``P(..., axis, ...)`` at position d, ``Replicate()`` for an
axis the spec does not name), and :func:`local_part` takes this rank's block
of a plain tensor or array under them: the trainer's parameter and
optimizer shards (:func:`param_shardings`), its rows of each batch
(:func:`shard_batch` under :func:`data_sharding`) and a population's owned
members (:func:`population_sharding`).  The tensors stay plain, since the
kernels take whole weights.  The collectives the trainer needs are at the
end: sums and gathers that go through the host where the group's backend is
gloo and the tensor lies on a card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard
from torch.utils import _pytree as pytree

__all__ = [
    "make_mesh",
    "shard_batch",
    "replicate",
    "data_sharding",
    "param_spec",
    "param_shardings",
    "population_sharding",
    "local_part",
    "all_reduce_sum",
    "differentiable_sum",
    "all_gather_parts",
]


def make_mesh(num_devices: int | None = None, *, axis: str = "data",
              model_size: int = 1, model_axis: str = "model") -> DeviceMesh:
    """Mesh over the ranks of the default process group (one device each).

    ``num_devices``: the mesh size, ``None`` for every rank; it must equal
    the group's size, since every rank runs the same program.
    ``model_size == 1`` gives the 1-D ``(data,)`` mesh, ``model_size > 1``
    the 2-D ``(data, model)`` mesh with adjacent ranks on ``model``."""
    if not dist.is_initialized():
        raise RuntimeError(
            "a device mesh spans the ranks of a torch.distributed process "
            "group; start them with parallel.launch")
    world = dist.get_world_size()
    n = world if num_devices is None else num_devices
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    if n != world:
        raise ValueError(f"requested {n} devices, but the process group has "
                         f"{world} ranks: the mesh spans every rank")
    backend = dist.get_backend()
    device_type = "cuda" if backend == "nccl" else "cpu"
    if model_size <= 1:
        return init_device_mesh(device_type, (n,), mesh_dim_names=(axis,))
    if n % model_size:
        raise ValueError(
            f"model_size {model_size} does not divide {n} devices")
    return init_device_mesh(device_type, (n // model_size, model_size),
                            mesh_dim_names=(axis, model_axis))


def _axis_size(mesh: DeviceMesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh.shape[names.index(axis)] if axis in names else 1


def param_spec(shape: tuple[int, ...], shards: int):
    """FSDP sharding rule for one parameter/optimizer leaf: shard the
    largest dimension divisible by ``shards`` (ties → the trailing one, so
    conv HWIO kernels shard output channels); replicate anything that has
    no divisible dimension (scalars, odd shapes).  ``Shard(d)`` or
    ``Replicate()``."""
    if shards <= 1 or not shape:
        return Replicate()
    best = None
    for d, size in enumerate(shape):
        if size % shards == 0 and size >= shards:
            if best is None or size >= shape[best]:
                best = d
    return Replicate() if best is None else Shard(best)


def _placements(mesh: DeviceMesh, axis: str, placement) -> tuple:
    return tuple(placement if name == axis else Replicate()
                 for name in (mesh.mesh_dim_names or ()))


def param_shardings(mesh: DeviceMesh, tree, *, axis: str = "model"):
    """A tree like ``tree`` of placements (one per mesh dimension) for FSDP
    over ``axis``; replicated everywhere if the mesh has no such axis or it
    has size 1.  Shape-based, so the same function shards the params and
    any params-shaped optimizer state."""
    shards = _axis_size(mesh, axis)
    return pytree.tree_map(
        lambda leaf: _placements(
            mesh, axis, param_spec(tuple(np.shape(leaf)), shards)), tree)


def population_sharding(mesh: DeviceMesh, population: int, *,
                        axis: str = "data") -> tuple:
    """Placements of a population (seed) axis: sharded over ``axis`` when
    its size divides the population, replicated otherwise (every rank then
    trains every member)."""
    size = _axis_size(mesh, axis)
    if axis in (mesh.mesh_dim_names or ()) and population % size == 0:
        return _placements(mesh, axis, Shard(0))
    return replicate(mesh)


def data_sharding(mesh: DeviceMesh, axis: str = "data") -> tuple:
    """Shard the leading (batch) axis over ``axis``."""
    return _placements(mesh, axis, Shard(0))


def replicate(mesh: DeviceMesh) -> tuple:
    return tuple(Replicate() for _ in (mesh.mesh_dim_names or ()))


def local_part(mesh: DeviceMesh | None, a, placements: tuple):
    """This rank's block of ``a`` (numpy or tensor) under ``placements``:
    for each ``Shard(d)``, the contiguous chunk of its coordinate on that
    mesh dimension.  Raises when the dimension does not divide, naming
    both sizes.  ``mesh=None`` (one device): ``a`` itself."""
    if mesh is None:
        return a
    coords = mesh.get_coordinate()
    for name, size, coord, pl in zip(mesh.mesh_dim_names, mesh.shape,
                                     coords, placements):
        if not isinstance(pl, Shard) or size == 1:
            continue
        n = a.shape[pl.dim]
        if n % size:
            raise ValueError(f"a dimension of {n} does not divide over the "
                             f"{size} ranks of the '{name}' axis")
        per = n // size
        a = a[(slice(None),) * pl.dim
              + (slice(coord * per, (coord + 1) * per),)]
    return a


def shard_batch(mesh: DeviceMesh | None, *arrays, axis: str = "data"
                ) -> tuple:
    """This rank's rows of each array (numpy or tensor), whose leading axis
    is the global batch.  Always returns a tuple (even for one array)."""
    if mesh is None:
        return arrays
    placements = data_sharding(mesh, axis)
    return tuple(local_part(mesh, a, placements) for a in arrays)


# -- collectives -------------------------------------------------------------
def _through_host(t: torch.Tensor, group) -> bool:
    """gloo on tensors that lie on a card: the collective runs on a host
    copy (two ranks that share one card run gloo; ``launch.py``)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``'s ranks, as a new tensor on ``t``'s
    device (the same value on every rank)."""
    host = _through_host(t, group)
    out = t.detach().cpu() if host else t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(t.device) if host else out


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


def differentiable_sum(group):
    """``fn(t)``: :func:`all_reduce_sum` over ``group`` that autograd goes
    through (its vector–Jacobian product is the same sum), for a
    batch-global error norm inside a differentiated solve."""
    def fn(t: torch.Tensor) -> torch.Tensor:
        return _Sum.apply(t, group)
    return fn


def all_gather_parts(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` (equal shapes) in rank order of ``group``."""
    host = _through_host(t, group)
    src = t.detach().cpu() if host else t.detach().contiguous()
    outs = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(outs, src, group=group)
    return [o.to(t.device) for o in outs] if host else outs
