"""Population training: several seeds of one configuration trained side by
side in one process (port of ``neural_ode_features_tpu/multi.py``).

Design: K member :class:`training.Trainer` s, one per seed, stepped in turn
on the one card.  The kernels take one weight set per launch, so member i
runs exactly the launches of a solo run with ``seed = seeds[i]``: the same
init, shuffle and augmentation streams, and weights, metrics and training
states bit-identical to that solo run's.  The JAX package stacks the
members on a leading axis under one ``vmap``; the counterpart here, one
launch for all K weight sets (a member axis in the kernels), is later
performance work (ROADMAP.md, Queue 2).  The surface is the JAX class's:
``train_epoch`` and ``evaluate_fused`` per population, ``params_for``,
``save_state_for`` and ``load_states`` per seed in the solo state format.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from torch.utils import _pytree as pytree

from .training import TrainConfig, Trainer

__all__ = ["PopulationTrainer"]


class PopulationTrainer:
    """K independent seeds trained in turn, one :class:`Trainer` each
    (``members``); results carry a leading seed axis or come as per-seed
    lists."""

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
        self.members = [Trainer(dataclasses.replace(cfg, seed=s),
                                steps_per_epoch, device=device)
                        for s in self.seeds]
        self.model_cfg = self.members[0].model_cfg

    def train_epoch(self, images_u8, labels, epoch: int) -> dict:
        """One epoch of every member; per-step metrics of shape
        ``(K, steps)`` per key."""
        ms = [m.train_epoch(images_u8, labels, epoch) for m in self.members]
        return {k: np.stack([m[k] for m in ms]) for k in ms[0]}

    def evaluate_fused(self, images_u8, labels) -> list[dict[str, float]]:
        """The whole split for every member: per-seed dicts as
        ``Trainer.evaluate_fused`` returns."""
        return [m.evaluate_fused(images_u8, labels) for m in self.members]

    def params_for(self, i: int):
        """Seed ``i``'s parameters, detached copies on the host."""
        return pytree.tree_map(lambda p: p.detach().cpu().clone(),
                               self.members[i].params)

    def save_state_for(self, i: int, path, extra=None) -> None:
        """Seed ``i``'s training state in the format of
        ``Trainer.save_state``: a solo run resumes it."""
        self.members[i].save_state(path, extra=extra)

    def load_states(self, paths) -> list[dict[str, float]]:
        """Restore every seed from solo-format states (one path per seed);
        returns each state's ``extra`` floats."""
        if len(paths) != len(self.seeds):
            raise ValueError(f"{len(paths)} states for {len(self.seeds)} "
                             "seeds")
        return [m.load_state(p) for m, p in zip(self.members, paths)]
