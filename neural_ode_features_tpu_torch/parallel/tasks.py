"""What one rank runs for ``entry.dryrun_multichip``, ``chip_smoke.py``
``[parallel]`` and the tests: a few train steps, or a population epoch, on
this rank's device, returning what a check holds against the one-device run.

Each function runs inside a ``launch`` rank (the process group is up) and
returns plain values and host tensors, which ``launch`` hands back per rank.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from .._device import strict_f32
from ..kernels.odefunc import odefunc
from ..kernels.odefunc_bwd import odefunc_bwd
from ..kernels.rk_step import dopri5_step

__all__ = ["train_steps", "population_epoch", "in_turn", "launch_counts",
           "reset_launch_counts"]


def reset_launch_counts() -> None:
    odefunc.launches = odefunc_bwd.launches = dopri5_step.launches = 0


def launch_counts() -> dict[str, int]:
    """This process's kernel launch counters."""
    return {"odefunc": odefunc.launches, "odefunc_bwd": odefunc_bwd.launches,
            "rk_step": dopri5_step.launches}


def train_steps(cfg, batches, *, device: str, params=None,
                steps_per_epoch: int = 4, save_path=None,
                evaluate=None) -> dict:
    """Build ``Trainer(cfg)`` on this rank's ``device`` and step it once per
    ``(images_u8, labels)`` global batch of ``batches``.

    Returns ``metrics`` (one dict per step, the whole batch's), per step
    this rank's kernel ``launches`` (counters from 0 before each step) and
    forward ``attempts`` (its own rows), ``step_s`` (seconds, after a
    synchronise on the card), the local and whole ``shapes`` of every
    parameter leaf, the whole parameters after the last step
    (``params``, host tensors), the ``mesh`` and, with ``evaluate``
    (``(images_u8, labels)``), ``Trainer.evaluate_fused`` on it
    (``eval``) and its launches (``eval_launches``).
    ``save_path``: ``save_state`` there after the steps (rank 0 writes)."""
    from ..training import Trainer

    dev = strict_f32(device)
    trainer = Trainer(cfg, steps_per_epoch=steps_per_epoch, device=dev,
                      params=params)
    out = {"metrics": [], "launches": [], "attempts": [], "step_s": [],
           "mesh": str(trainer.mesh), "rank": dist.get_rank(),
           "shapes": [(tuple(p.shape), s) for p, s in
                      zip(trainer._leaves, trainer._full_shapes)]}
    for images, labels in batches:
        reset_launch_counts()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_batch(images, labels)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        out["metrics"].append(m)
        out["launches"].append(launch_counts())
        st = trainer.last_stats
        out["attempts"].append(0 if st is None else int(
            (st.naccept + st.nreject).max()))
    out["params"] = pytree.tree_map(lambda p: p.detach().cpu(),
                                    trainer.full_params())
    if evaluate is not None:
        reset_launch_counts()
        out["eval"] = trainer.evaluate_fused(*evaluate)
        out["eval_launches"] = launch_counts()
    if save_path is not None:
        trainer.save_state(save_path)
    return out


def population_epoch(cfg, seeds, images_u8, labels, *, device: str,
                     epochs: int = 1) -> dict:
    """A ``PopulationTrainer`` over every rank: ``epochs`` epochs of every
    member.  Returns the per-step metrics (``(K, steps)`` arrays per key,
    the last epoch's), the members this rank owns (``owned``), and each
    owned member's parameters after the last epoch (``params``, by member
    index, host tensors)."""
    from ..multi import PopulationTrainer

    dev = strict_f32(device)
    steps = len(images_u8) // cfg.batch_size
    pop = PopulationTrainer(cfg, seeds, steps_per_epoch=steps, device=dev)
    reset_launch_counts()
    for epoch in range(epochs):
        em = pop.train_epoch(images_u8, labels, epoch)
    return {"metrics": em, "owned": pop.owned, "launches": launch_counts(),
            "params": {i: pop.params_for(i) for i in pop.owned}}



def in_turn(jobs) -> list:
    """Several rank functions in one launch: ``jobs`` is a list of ``(fn,
    args, kwargs)``, run in order on every rank; returns their results."""
    return [fn(*args, **kwargs) for fn, args, kwargs in jobs]
