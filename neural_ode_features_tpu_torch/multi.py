"""Population training: several seeds of one configuration trained side by
side (port of ``neural_ode_features_tpu/multi.py``).

Design: K member :class:`training.Trainer` s, one per seed.  The kernels take
one weight set per launch, so member i runs exactly the launches of a solo
run with ``seed = seeds[i]``: the same init, shuffle and augmentation
streams, and weights, metrics and training states bit-identical to that
solo run's.  The JAX package stacks the members on a leading axis under one
``vmap``; the counterpart here, one launch for all K weight sets (a member
axis in the kernels), is later performance work (ROADMAP.md, Queue 2).

Across ranks (``cfg.num_devices`` > 1, one process per device,
``parallel.launch``) the seed axis is sharded over ``data`` as the JAX
``P("data")`` (``parallel.population_sharding``): rank r builds and owns
the contiguous block of K / ranks members, steps them in turn on its
device and writes their training states, with no collective until the
epoch's metrics are gathered for every rank.  K not divisible by the rank
count replicates, as in JAX: every rank trains every member, and rank 0
writes.  FSDP (``model_shards`` > 1) stays refused, as in JAX.  The surface
is the JAX class's: ``train_epoch`` and ``evaluate_fused`` per population,
``params_for``, ``save_state_for`` and ``load_states`` per owned seed in the
solo state format.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch.distributed as dist
from torch.distributed.tensor import Shard
from torch.utils import _pytree as pytree

from .parallel.mesh import local_part, make_mesh, population_sharding
from .training import TrainConfig, Trainer

__all__ = ["PopulationTrainer"]


class PopulationTrainer:
    """K independent seeds, one :class:`Trainer` each; results carry a
    leading seed axis or come as per-seed lists.  ``owned``: the member
    indices this rank builds and steps (all of them on one device);
    ``members``: their trainers by index."""

    def __init__(self, cfg: TrainConfig, seeds, steps_per_epoch: int, *,
                 device="cuda"):
        if cfg.model_shards > 1:
            raise ValueError(
                "population training composes with data parallelism only; "
                "FSDP (model_shards > 1) shards params over 'model' while "
                "the population shards them over 'data' — pick one")
        self.seeds = [int(s) for s in seeds]
        if not self.seeds:
            raise ValueError("need at least one seed")
        if len(set(self.seeds)) != len(self.seeds):
            raise ValueError(f"duplicate seeds {self.seeds}")
        self.cfg = cfg
        self.model_cfg = cfg.model_config()
        k = len(self.seeds)
        n_dev = cfg.num_devices
        if n_dev is None:
            n_dev = dist.get_world_size() if dist.is_initialized() else 1
        self.mesh = make_mesh(n_dev) if n_dev > 1 else None
        if n_dev > 1 and k % n_dev != 0:
            warnings.warn(
                f"population of {k} seeds does not divide the {n_dev}-device "
                f"mesh: the seed axis replicates, so EVERY device computes "
                f"the full population (no parallel speedup on this "
                f"topology). Pick a seed count that is a multiple of the "
                f"device count to shard members across chips.",
                stacklevel=2)
        self.sharded = self.mesh is not None and isinstance(
            population_sharding(self.mesh, k)[0], Shard)
        self.owned = [int(i) for i in local_part(
            self.mesh, np.arange(k),
            population_sharding(self.mesh, k) if self.mesh else ())]
        # Members are one-device trainers whatever the mesh.
        self.members = {i: Trainer(dataclasses.replace(
            cfg, seed=self.seeds[i], num_devices=1, model_shards=1),
            steps_per_epoch, device=device) for i in self.owned}
        if self.sharded:  # an owner writes its members' states
            for m in self.members.values():
                m.is_writer = True

    def _gather(self, per_member: dict) -> list:
        """``{i: value}`` for the owned members → the list over all K, on
        every rank."""
        if not self.sharded:
            return [per_member[i] for i in range(len(self.seeds))]
        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, per_member)
        merged = {i: v for part in parts for i, v in part.items()}
        return [merged[i] for i in range(len(self.seeds))]

    def _member(self, i: int) -> Trainer:
        if i not in self.members:
            raise ValueError(f"seed {self.seeds[i]} (member {i}) is trained "
                             f"on another rank; this one owns {self.owned}")
        return self.members[i]

    def train_epoch(self, images_u8, labels, epoch: int) -> dict:
        """One epoch of every member; per-step metrics of shape
        ``(K, steps)`` per key."""
        ms = self._gather({i: m.train_epoch(images_u8, labels, epoch)
                           for i, m in self.members.items()})
        return {k: np.stack([m[k] for m in ms]) for k in ms[0]}

    def evaluate_fused(self, images_u8, labels) -> list[dict[str, float]]:
        """The whole split for every member: per-seed dicts as
        ``Trainer.evaluate_fused`` returns."""
        return self._gather({i: m.evaluate_fused(images_u8, labels)
                             for i, m in self.members.items()})

    def params_for(self, i: int):
        """Owned seed ``i``'s parameters, detached copies on the host."""
        return pytree.tree_map(lambda p: p.detach().cpu().clone(),
                               self._member(i).params)

    def save_state_for(self, i: int, path, extra=None) -> None:
        """Owned seed ``i``'s training state in the format of
        ``Trainer.save_state``: a solo run resumes it."""
        self._member(i).save_state(path, extra=extra)

    def load_states(self, paths) -> list[dict[str, float]]:
        """Restore the owned seeds from solo-format states (one path per
        seed, all K); returns each owned state's ``extra`` floats."""
        if len(paths) != len(self.seeds):
            raise ValueError(f"{len(paths)} states for {len(self.seeds)} "
                             "seeds")
        return [m.load_state(paths[i]) for i, m in self.members.items()]
