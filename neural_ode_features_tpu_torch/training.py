"""Training engine (port of ``neural_ode_features_tpu/training.py``).

One train step: uint8 batch → ``normalize`` → ``augment`` (normalised-black
fill) → logits → cross-entropy → gradients → SGD with momentum (or Adam)
under a piecewise-constant learning rate.  The ODE-Net's logits go through
the adjoint (``odenet_logits(adjoint=True)``, every variant of
``solver/adjoint.py``; the augmented dynamics run the ODEfunc kernel pair on
the card) or direct backprop through the host-loop solve (adaptive or
fixed-grid); the ResNet's through plain autograd (cuDNN convs, no
hand-written kernel, as the JAX ResNet reaches no Pallas kernel).
NFE-forward and NFE-backward come back with every step; ``nfe_b`` is what
the adjoint's ``.backward()`` counted, and both read 0 for a ResNet.

The JAX step is one compiled device program; here it is eager PyTorch with
host loops in the solver (one device→host sync per attempt).

Across devices (``num_devices``, ``model_shards``) the JAX step is one SPMD
program over a global batch.  Here one process runs per device
(``parallel.launch``), each with a :class:`Trainer` on the same
configuration, and the mesh is ``parallel.make_mesh``'s ``(data,)`` or
``(data, model)`` with adjacent ranks on ``model``.  Every rank is given the
same global batch and computes what the one-device step computes, up to
reduction order:

* the rank at data coordinate d takes rows ``[d·b, (d+1)·b)``, b = B / data,
  and draws the whole batch's crops and flips from the shared generator,
  keeping its rows;
* the loss is the sum over its rows divided by the global B, so that the
  cotangents, and the backward solve's tolerance against them, are the
  one-device step's; gradients, loss, accuracy and the forward NFE are
  summed over ``data`` in one all-reduce per step;
* every batch-global error norm (the adjoint's backward solve, a
  ``'global'`` forward) spans the whole batch through
  ``solver.RankNorm``: each rank integrates its own partial a_θ with the
  shared steps, so ``nfe_b`` is the one-device step's on every rank.  A
  per-sample forward holds no collective, and each rank stops when its own
  rows are done.  GroupNorm normalises each sample alone, so no statistic
  crosses ranks (there is no batch norm to synchronise);
* with ``model_shards > 1`` each rank holds only its ``param_spec`` shard of
  every parameter leaf and of the SGD momentum or Adam moments.  The whole
  weights are gathered over ``model`` for each step (the kernels take whole
  weights), the gradient is summed over ``data``, and each rank keeps and
  updates its own shard;
* :meth:`save_state` writes the one-device format from rank 0 (the JAX
  msgpack holds whole arrays too); :meth:`load_state` reads it on every
  rank and shards it, so a state moves between world sizes.

``compute_dtype='bfloat16'`` trains on the CPU (the dynamics in bfloat16,
as the JAX jnp path); on the card it raises before any launch.  Not ported
yet (each raises ``NotImplementedError`` naming ROADMAP.md): bfloat16 on the
card and the orbax training-state directory.  The training state file is a
``torch.save`` of one flat dict of tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard
from torch.utils import _pytree as pytree

from ._device import resolve_device
from .data import Batches
from .kernels.odefunc import odefunc_autograd, prepare
from .models import (
    ModelConfig,
    check_compute_dtype,
    head_apply,
    init_odenet,
    init_resnet,
    odefunc_apply,
    odenet_logits,
    resnet_logits,
    stem_apply,
)
from .ops.preprocess import (
    augment_draws,
    crop_and_flip,
    normalize,
    normalized_black,
)
from .parallel.mesh import (
    all_gather_parts,
    all_reduce_sum,
    differentiable_sum,
    local_part,
    make_mesh,
    param_shardings,
    shard_batch,
)
from .solver import odeint
from .utils.checkpoint import from_torch_state_dict, to_torch_state_dict

__all__ = ["TrainConfig", "Trainer", "epoch_generator"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX ``TrainConfig``, field for field (the CLI surface persisted
    to params.json)."""

    dataset: str = "mnist"
    model: str = "odenet"  # 'odenet' | 'resnet'
    tol: float = 1e-3
    solver: str = "dopri5"
    controller: str = "i"
    adjoint: bool = True
    adjoint_seminorm: bool = False
    adjoint_mode: str = "reintegrate"
    error_control: str = "per_sample"
    downsampling: str = "conv"
    hidden: int = 64
    epochs: int = 160
    batch_size: int = 128
    optimizer: str = "sgd"  # 'sgd' | 'adam'
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 0.0
    lr_decay_epochs: tuple[int, ...] = (60, 100, 140)
    lr_decay_gamma: float = 0.1
    seed: int = 0
    augment: bool = True  # random crop (+flip for 3-channel data)
    num_devices: int | None = None
    model_shards: int = 1
    compute_dtype: str = "float32"
    max_steps: int = 1024

    def model_config(self) -> ModelConfig:
        in_ch = 3 if "cifar" in self.dataset else 1
        return ModelConfig(
            in_channels=in_ch,
            hidden=self.hidden,
            tol=self.tol,
            method=self.solver,
            controller=self.controller,
            error_control=self.error_control,
            downsampling=self.downsampling,
            adjoint=self.adjoint,
            adjoint_seminorm=self.adjoint_seminorm,
            adjoint_mode=self.adjoint_mode,
            compute_dtype=self.compute_dtype,
            max_steps=self.max_steps,
        )


def _direct_diff_logits(params, x: torch.Tensor, cfg: ModelConfig,
                        batch_sum=None):
    """Gradients by direct backprop through the host-loop adaptive solve
    (the reference's default semantics): autograd records every attempt,
    and each f goes through the ODEfunc kernel pair, or, for
    reduced-precision dynamics (CPU only), through autograd of the plain
    :func:`odefunc_apply` in ``cfg.cdtype``.  No fused step.
    ``batch_sum``: see ``solver.odeint`` (autograd goes through it)."""
    h0 = stem_apply(params["stem"], x, cfg)
    ts = torch.tensor([0.0, 1.0], dtype=h0.dtype, device=h0.device)
    if cfg.compute_dtype == "float32":
        with torch.no_grad():
            w = prepare(params["odefunc"], tuple(h0.shape[1:3]))

        def dyn(t, y):
            return odefunc_autograd(params["odefunc"], t, y,
                                    groups=cfg.groups, weights=w)
    else:
        def dyn(t, y):
            return odefunc_apply(params["odefunc"], t, y, cfg)

    traj, stats = odeint(dyn, h0, ts, rtol=cfg.tol, atol=cfg.tol,
                         method=cfg.method, error_control=cfg.error_control,
                         max_steps=cfg.max_steps, controller=cfg.controller,
                         batch_sum=batch_sum)
    return head_apply(params["head"], traj[-1], cfg), stats


def epoch_generator(seed: int, epoch: int) -> torch.Generator:
    """The augmentation draws of one epoch, derived from ``(seed + 1,
    epoch)`` and from nothing an earlier epoch left behind (torch's
    generators are stateful where the JAX keys are folded from the epoch),
    so a resumed epoch k sees what an uninterrupted run saw."""
    return torch.Generator().manual_seed(int(
        np.random.default_rng((seed + 1, epoch)).integers(2**62)))


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms and no autotuning inside the block;
    the process's own flags again after it."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md, {item})")


class Trainer:
    """Owns the parameters, the optimizer and the step.

    ``params``: start from these parameters (a port param tree, e.g. from
    ``utils.from_jax_params``) instead of the model's initialiser at
    ``cfg.seed``.
    ``device``: the card by default; ``"cpu"`` runs the plain versions of
    the kernels.  A step runs cuDNN's deterministic algorithms (and no
    autotuning) and restores the flags after it, so that the same run gives
    the same bits: cuDNN's default weight-gradient convolutions of the stem
    may sum in another order from call to call.

    ``cfg.num_devices`` > 1 or ``cfg.model_shards`` > 1: this trainer is one
    rank of a mesh (module docstring) and must be built on every rank of a
    ``torch.distributed`` process group of that size (``parallel.launch``);
    ``None`` means every rank of the group, or one device outside a group.
    Every rank then calls the same methods with the same global batches:
    steps, evaluations, :meth:`full_params`, :meth:`save_state` and
    :meth:`load_state` are collective.  ``params`` holds this rank's shards
    under ``model_shards`` > 1 (:meth:`full_params` gathers them)."""

    def __init__(self, train_cfg: TrainConfig, steps_per_epoch: int, *,
                 device="cuda", params=None):
        if steps_per_epoch < 1:
            raise ValueError(
                f"steps_per_epoch={steps_per_epoch}: the training set is "
                f"smaller than batch_size={train_cfg.batch_size}")
        if train_cfg.model not in ("odenet", "resnet"):
            raise ValueError(f"unknown model {train_cfg.model!r}")
        if train_cfg.optimizer not in ("sgd", "adam"):
            raise ValueError(f"unknown optimizer {train_cfg.optimizer!r}")
        self.cfg = train_cfg
        self.model_cfg = train_cfg.model_config()
        self.steps_per_epoch = steps_per_epoch
        self.device = resolve_device(device)
        check_compute_dtype(self.model_cfg, self.device)
        self._init_mesh(train_cfg)

        if params is None:
            init_fn = (init_odenet if train_cfg.model == "odenet"
                       else init_resnet)
            params = init_fn(train_cfg.seed, self.model_cfg,
                             device=self.device)
        full = [p.detach().to(self.device, torch.float32)
                for p in pytree.tree_leaves(params)]
        self._treedef = pytree.tree_structure(params)
        self._full_shapes = [tuple(p.shape) for p in full]
        # Each leaf's placements on the mesh, and its shard dim over
        # 'model' (Replicate() for a leaf kept whole).
        self._placements = ([() for _ in full] if self.mesh is None else
                            pytree.tree_leaves(
                                param_shardings(self.mesh, full),
                                is_leaf=lambda pl: isinstance(pl, tuple)))
        self._specs = [next((pl for pl in pls if isinstance(pl, Shard)),
                            Replicate()) for pls in self._placements]
        self._leaves = [self._shard(p, i).clone().requires_grad_()
                        for i, p in enumerate(full)]
        self.params = pytree.tree_unflatten(self._leaves, self._treedef)
        self.boundaries = {e * steps_per_epoch: train_cfg.lr_decay_gamma
                           for e in train_cfg.lr_decay_epochs}
        # optax.chain(add_decayed_weights, sgd | adam): the decay is added
        # to the gradient before the momentum, which is torch's weight_decay.
        # Both are elementwise, so a shard's update is the shard of the
        # whole update.
        if train_cfg.optimizer == "sgd":
            self.optimizer = torch.optim.SGD(
                self._leaves, lr=train_cfg.lr, momentum=train_cfg.momentum,
                nesterov=False, weight_decay=train_cfg.weight_decay)
        else:
            self.optimizer = torch.optim.Adam(
                self._leaves, lr=train_cfg.lr,
                weight_decay=train_cfg.weight_decay)
        self.step_count = 0
        self.last_stats = None  # the forward solve's stats of the last step
        self.generator = torch.Generator().manual_seed(train_cfg.seed + 1)

    # -- the mesh --------------------------------------------------------
    def _init_mesh(self, cfg: TrainConfig) -> None:
        n = cfg.num_devices
        if n is None:
            n = dist.get_world_size() if dist.is_initialized() else 1
        self.mesh = None
        self.data_size = self.model_size = 1
        self.data_group = self.model_group = None
        if n > 1 or cfg.model_shards > 1:
            self.mesh = make_mesh(n, model_size=cfg.model_shards)
            names = self.mesh.mesh_dim_names
            self.data_size = self.mesh.shape[0]
            self.data_group = self.mesh.get_group("data")
            if "model" in names:
                self.model_size = self.mesh.shape[1]
                self.model_group = self.mesh.get_group("model")
        if cfg.batch_size % self.data_size:
            raise ValueError(
                f"batch_size={cfg.batch_size} does not divide over the "
                f"{self.data_size} ranks of the 'data' axis")
        # The error norms' sum across the ranks that share a batch (autograd
        # goes through it: direct backprop with global control).
        self._batch_sum = (differentiable_sum(self.data_group)
                           if self.data_size > 1 else None)
        # Rank 0 alone writes files (save_state); a population makes each
        # member's owner its writer (multi.py).
        self.is_writer = not dist.is_initialized() or dist.get_rank() == 0

    def _shard(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's shard of leaf ``i``'s whole tensor."""
        return local_part(self.mesh, t, self._placements[i])

    def _gather(self, items: list[tuple[int, torch.Tensor]]
                ) -> list[torch.Tensor]:
        """Whole tensors from this rank's shards: ``items`` pairs a leaf
        index (whose spec applies) with a shard shaped like that leaf's;
        one all-gather over ``model`` for all of them."""
        if self.model_size == 1:
            return [t for _, t in items]
        sharded = [k for k, (i, _) in enumerate(items)
                   if isinstance(self._specs[i], Shard)]
        out = [t.detach() for _, t in items]
        if not sharded:
            return out
        flat = torch.cat([out[k].reshape(-1) for k in sharded])
        parts = all_gather_parts(flat, self.model_group)
        sizes = [out[k].numel() for k in sharded]
        pieces = [torch.split(part, sizes) for part in parts]
        for j, k in enumerate(sharded):
            i, t = items[k]
            out[k] = torch.cat([pc[j].reshape(t.shape) for pc in pieces],
                               dim=self._specs[i].dim)
        return out

    def full_params(self):
        """The whole parameters (a detached tree): this trainer's own
        outside FSDP, gathered over ``model`` under it (collective)."""
        full = self._gather(list(enumerate(self._leaves)))
        return pytree.tree_unflatten(full, self._treedef)

    def _step_params(self):
        """The parameters a step differentiates: the leaves themselves, or
        under FSDP gathered whole copies that require grad."""
        if self.model_size == 1:
            return self.params
        return pytree.tree_unflatten(
            [p.requires_grad_() for p in pytree.tree_leaves(
                self.full_params())], self._treedef)

    def schedule(self, count: int) -> float:
        """optax ``piecewise_constant_schedule``: the learning rate scaled by
        every factor whose boundary ``count`` has reached."""
        lr = self.cfg.lr
        for boundary, scale in sorted(self.boundaries.items()):
            if count >= boundary:
                lr *= scale
        return lr

    # -- step bodies -----------------------------------------------------
    def _preprocess(self, images_u8, train: bool,
                    generator: torch.Generator | None = None):
        """This rank's rows of a global uint8 batch, normalised (and
        augmented with the whole batch's draws)."""
        images_u8 = np.asarray(images_u8)
        n = len(images_u8)
        rows, = shard_batch(self.mesh, images_u8)
        x = normalize(torch.as_tensor(rows).to(self.device), self.cfg.dataset)
        if train and self.cfg.augment:
            fill = normalized_black(self.cfg.dataset, x.dtype, x.device)
            offsets, flips = augment_draws(n, generator or self.generator,
                                           pad=4, flip=x.shape[-1] == 3)
            offsets, = shard_batch(self.mesh, offsets)
            if flips is not None:
                flips, = shard_batch(self.mesh, flips)
            x = crop_and_flip(x, offsets, flips, pad=4, fill=fill)
        return x

    def _labels(self, labels) -> torch.Tensor:
        rows, = shard_batch(self.mesh, np.asarray(labels))
        return torch.as_tensor(rows).to(self.device, torch.long)

    def _logits(self, params, x: torch.Tensor, train: bool):
        """``(logits, stats)`` of the training path (the adjoint, or direct
        backprop) or of inference; a ResNet has no solve and no stats."""
        if self.cfg.model == "resnet":
            return resnet_logits(params, x, self.model_cfg), None
        if train and not self.cfg.adjoint:
            return _direct_diff_logits(params, x, self.model_cfg,
                                       self._batch_sum)
        return odenet_logits(params, x, self.model_cfg,
                             adjoint=train and self.cfg.adjoint,
                             batch_sum=self._batch_sum)

    def _nfe_sum(self, stats, rows: int) -> torch.Tensor:
        """This rank's rows' share of the NFE summed over the batch: the
        per-sample counts' sum, or a global solve's one count (the same on
        every rank) times the rows."""
        nfe = stats.nfe.float()
        if nfe.shape[0] != rows:  # global control: one (1,) count
            return nfe[0] * rows
        return nfe.sum()

    def _loss_and_logits(self, params, x: torch.Tensor, labels: torch.Tensor,
                         n_global: int | None = None):
        """Forward: ``(loss, logits, nfe, stats)``.  ``loss`` and ``nfe``
        are this rank's rows' sums over ``n_global`` (default: these rows,
        the batch's mean at one rank); a ResNet has no solve, so NFE 0 and
        no stats."""
        n_global = x.shape[0] if n_global is None else n_global
        logits, stats = self._logits(params, x, train=True)
        nfe = (torch.zeros((), device=x.device) if stats is None
               else self._nfe_sum(stats, x.shape[0]) / n_global)
        loss = F.cross_entropy(logits, labels, reduction="sum") / n_global
        return loss, logits, nfe, stats

    def _grads(self, params, x: torch.Tensor, labels: torch.Tensor,
               n_global: int | None = None):
        """Loss, logits, NFE, gradients (a tree like ``params``) and the
        backward NFE (0 for a ResNet and for direct backprop, which replays
        the forward's graph instead of solving again), for this rank's rows
        of a batch of ``n_global`` (default: these rows alone)."""
        with _deterministic_cudnn():
            loss, logits, nfe, stats = self._loss_and_logits(
                params, x, labels, n_global)
            grads = torch.autograd.grad(loss, pytree.tree_leaves(params))
        self.last_stats = stats
        nfe_b = (stats.nfe_b.float() if hasattr(stats, "nfe_b")
                 else torch.zeros((), device=loss.device))
        return (loss.detach(), logits.detach(), nfe,
                pytree.tree_unflatten(list(grads), pytree.tree_structure(
                    params)), nfe_b)

    # -- public API ------------------------------------------------------
    def train_batch(self, images_u8, labels,
                    generator: torch.Generator | None = None) -> dict:
        """One step on a raw uint8 NHWC batch (the global batch; a rank
        takes its rows); returns ``loss``, ``acc``, ``nfe`` and ``nfe_b``
        as floats, the whole batch's.  ``generator``: the augmentation draws
        (default: the trainer's own, seeded from ``cfg.seed + 1``)."""
        n = len(labels)
        x = self._preprocess(images_u8, train=True, generator=generator)
        y = self._labels(labels)
        loss, logits, nfe, grads, nfe_b = self._grads(self._step_params(),
                                                      x, y, n)
        correct = (logits.argmax(-1) == y).float().sum() / n
        grads = pytree.tree_leaves(grads)
        if self.data_size > 1:
            # One all-reduce per step: the gradient and the three metrics.
            flat = all_reduce_sum(torch.cat(
                [g.reshape(-1) for g in grads]
                + [torch.stack([loss, correct, nfe.float()])]),
                self.data_group)
            *grads, metrics = torch.split(
                flat, [g.numel() for g in grads] + [3])
            grads = [g.reshape(s) for g, s in zip(grads, self._full_shapes)]
            loss, correct, nfe = metrics.unbind()
        for i, (p, g) in enumerate(zip(self._leaves, grads)):
            p.grad = self._shard(g, i).contiguous()
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step_count)
        self.optimizer.step()
        self.step_count += 1
        return {"loss": float(loss), "acc": float(correct), "nfe": float(nfe),
                "nfe_b": float(nfe_b)}

    def train_epoch(self, images_u8, labels, epoch: int) -> dict:
        """One epoch over the ``(seed, epoch)`` numpy permutation of the
        JAX trainer (drop-remainder batches); returns per-step metrics as
        arrays."""
        n = len(images_u8)
        bs = self.cfg.batch_size
        steps = n // bs
        perm = np.random.default_rng((self.cfg.seed, epoch)).permutation(n)
        perm = perm[: steps * bs].reshape(steps, bs)
        gen = epoch_generator(self.cfg.seed, epoch)
        rows = [self.train_batch(images_u8[idx], labels[idx], gen)
                for idx in perm]
        return {k: np.asarray([r[k] for r in rows]) for k in
                ("loss", "acc", "nfe", "nfe_b")}

    @torch.no_grad()
    def _eval_sums(self, params, images_u8, labels, valid) -> torch.Tensor:
        """This rank's rows' ``[correct, loss_sum, count, nfe_sum]`` over
        the valid samples of a padded batch."""
        x = self._preprocess(images_u8, train=False)
        y = self._labels(labels)
        v = self._labels(valid).float()
        logits, stats = self._logits(params, x, train=False)
        nfe = (torch.zeros((), device=x.device) if stats is None
               else (stats.nfe.float().expand(v.shape[0]) * v).sum())
        correct = ((logits.argmax(-1) == y).float() * v).sum()
        ce = F.cross_entropy(logits, y, reduction="none")
        return torch.stack([correct, (ce * v).sum(), v.sum(), nfe])

    def _sum_over_data(self, sums: torch.Tensor) -> torch.Tensor:
        return (all_reduce_sum(sums, self.data_group) if self.data_size > 1
                else sums)

    def eval_batch(self, images_u8, labels, valid, *, params=None) -> dict:
        """Sums over the valid samples of a padded batch: ``correct``,
        ``loss_sum``, ``count``, ``nfe_sum`` (the whole batch's).
        ``params``: the whole parameters (default :meth:`full_params`)."""
        sums = self._sum_over_data(self._eval_sums(
            self.full_params() if params is None else params, images_u8,
            labels, valid))
        return dict(zip(("correct", "loss_sum", "count", "nfe_sum"),
                        map(float, sums)))

    def evaluate(self, batches) -> dict[str, float]:
        """Per-valid-sample means over ``batches.padded_batches()``."""
        params = self.full_params()
        total = {"correct": 0.0, "loss_sum": 0.0, "count": 0.0,
                 "nfe_sum": 0.0}
        for img, lab, valid in batches.padded_batches():
            for k, v in self.eval_batch(img, lab, valid,
                                        params=params).items():
                total[k] += v
        count = max(total["count"], 1)
        return {"acc": total["correct"] / count,
                "loss": total["loss_sum"] / count,
                "nfe": total["nfe_sum"] / count}

    def evaluate_fused(self, images_u8, labels) -> dict[str, float]:
        """Evaluate a whole split held as arrays: the tail batch zero-padded
        and masked, so the coverage is :meth:`evaluate`'s.  (The JAX method
        of this name folds the split into one device dispatch; eager
        PyTorch on a local card has no per-dispatch cost to save, so this is
        the per-batch loop.)"""
        return self.evaluate(Batches(
            np.asarray(images_u8), np.asarray(labels), self.cfg.batch_size,
            shuffle=False, drop_remainder=False))

    def save_state(self, path, extra: dict[str, float] | None = None) -> None:
        """Full training state for a resume, as one flat ``dict[str,
        Tensor]`` under ``torch.save``: ``params.<name>`` (the 'internal'
        state dict of ``utils/checkpoint.py``), ``opt.<i>.<key>`` (the
        optimizer's tensors for parameter leaf i), ``step_count`` and
        ``extra.<key>`` (the caller's own floats, e.g. the CLI's running
        averages, kept in float64).  Whole tensors at any world size
        (collective under FSDP: one all-gather over ``model``), written by
        :attr:`is_writer` alone."""
        opt = [(i, key, val) for i, p in enumerate(self._leaves)
               for key, val in self.optimizer.state.get(p, {}).items()
               if isinstance(val, torch.Tensor)]
        # Param-shaped optimizer tensors (momentum, moments) shard as their
        # parameter does; a scalar (Adam's step) is every rank's own.
        whole = self._gather(list(enumerate(self._leaves))
                             + [(i, val) for i, _, val in opt if val.ndim])
        params = pytree.tree_unflatten(whole[:len(self._leaves)],
                                       self._treedef)
        state = {f"params.{k}": v
                 for k, v in to_torch_state_dict(params).items()}
        for key, val in (extra or {}).items():
            state[f"extra.{key}"] = torch.tensor(val, dtype=torch.float64)
        gathered = iter(whole[len(self._leaves):])
        for i, key, val in opt:
            state[f"opt.{i}.{key}"] = (next(gathered) if val.ndim
                                       else val).detach().cpu()
        state["step_count"] = torch.tensor(self.step_count)
        if self.is_writer:
            torch.save(state, path)

    def load_state(self, path) -> dict[str, float]:
        """Restore what :meth:`save_state` wrote, in place, on every rank
        (each takes its shards), whatever world size wrote it: the
        parameter leaves keep their identity, so the optimizer goes on
        owning them.  Returns the ``extra`` floats."""
        state = torch.load(path, map_location="cpu", weights_only=True)
        loaded = pytree.tree_leaves(from_torch_state_dict(
            self._params_template(),
            {k[len("params."):]: v for k, v in state.items()
             if k.startswith("params.")}))
        with torch.no_grad():
            for i, (p, q) in enumerate(zip(self._leaves, loaded)):
                p.copy_(self._shard(q.to(p.device), i))
        for i, p in enumerate(self._leaves):
            prefix = f"opt.{i}."
            self.optimizer.state[p] = {
                k[len(prefix):]: (self._shard(v.to(p.device), i).clone()
                                  if v.ndim else v)
                for k, v in state.items() if k.startswith(prefix)}
        self.step_count = int(state["step_count"])
        return {k[len("extra."):]: float(v) for k, v in state.items()
                if k.startswith("extra.")}

    def _params_template(self):
        """A tree like the whole parameters (shapes only matter), for
        ``from_torch_state_dict``."""
        return pytree.tree_unflatten(
            [torch.empty(s) for s in self._full_shapes], self._treedef)

    def save_state_orbax(self, path) -> None:
        _not_ported("the orbax training state", "Queue 1 item 5")

    def load_state_orbax(self, path) -> None:
        _not_ported("the orbax training state", "Queue 1 item 5")
