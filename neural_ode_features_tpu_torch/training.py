"""Training engine, single device (port of
``neural_ode_features_tpu/training.py``).

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
host loops in the solver (one device→host sync per attempt).  Not ported yet
(each raises ``NotImplementedError`` naming ROADMAP.md): a device mesh
(``num_devices``/``model_shards`` > 1), bfloat16 compute, and the orbax
training-state directory.  The training state file
is a ``torch.save`` of one flat dict of tensors (``save_state``).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from ._device import resolve_device
from .data import Batches
from .kernels.odefunc import odefunc_autograd, prepare
from .models import (
    ModelConfig,
    head_apply,
    init_odenet,
    init_resnet,
    odenet_logits,
    resnet_logits,
    stem_apply,
)
from .ops.preprocess import augment, normalize, normalized_black
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


def _direct_diff_logits(params, x: torch.Tensor, cfg: ModelConfig):
    """Gradients by direct backprop through the host-loop adaptive solve
    (the reference's default semantics): autograd records every attempt,
    and each f goes through the ODEfunc kernel pair.  No fused step."""
    h0 = stem_apply(params["stem"], x, cfg)
    ts = torch.tensor([0.0, 1.0], dtype=h0.dtype, device=h0.device)
    with torch.no_grad():
        w = prepare(params["odefunc"], tuple(h0.shape[1:3]))

    def dyn(t, y):
        return odefunc_autograd(params["odefunc"], t, y, groups=cfg.groups,
                                weights=w)

    traj, stats = odeint(dyn, h0, ts, rtol=cfg.tol, atol=cfg.tol,
                         method=cfg.method, error_control=cfg.error_control,
                         max_steps=cfg.max_steps, controller=cfg.controller)
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
    may sum in another order from call to call."""

    def __init__(self, train_cfg: TrainConfig, steps_per_epoch: int, *,
                 device="cuda", params=None):
        if steps_per_epoch < 1:
            raise ValueError(
                f"steps_per_epoch={steps_per_epoch}: the training set is "
                f"smaller than batch_size={train_cfg.batch_size}")
        if train_cfg.model not in ("odenet", "resnet"):
            raise ValueError(f"unknown model {train_cfg.model!r}")
        if train_cfg.num_devices not in (None, 1) or train_cfg.model_shards != 1:
            _not_ported("training on a device mesh", "Queue 1 item 8")
        if train_cfg.compute_dtype != "float32":
            _not_ported(f"compute_dtype={train_cfg.compute_dtype!r}",
                        "Queue 2 item 5")
        if train_cfg.optimizer not in ("sgd", "adam"):
            raise ValueError(f"unknown optimizer {train_cfg.optimizer!r}")
        self.cfg = train_cfg
        self.model_cfg = train_cfg.model_config()
        self.steps_per_epoch = steps_per_epoch
        self.device = resolve_device(device)

        if params is None:
            init_fn = (init_odenet if train_cfg.model == "odenet"
                       else init_resnet)
            params = init_fn(train_cfg.seed, self.model_cfg,
                             device=self.device)
        self.params = pytree.tree_map(
            lambda p: p.detach().to(self.device, torch.float32).clone()
            .requires_grad_(), params)
        self._leaves = pytree.tree_leaves(self.params)
        self.boundaries = {e * steps_per_epoch: train_cfg.lr_decay_gamma
                           for e in train_cfg.lr_decay_epochs}
        # optax.chain(add_decayed_weights, sgd | adam): the decay is added
        # to the gradient before the momentum, which is torch's weight_decay.
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
        x = torch.as_tensor(np.asarray(images_u8)).to(self.device)
        x = normalize(x, self.cfg.dataset)
        if train and self.cfg.augment:
            fill = normalized_black(self.cfg.dataset, x.dtype, x.device)
            x = augment(x, generator or self.generator, pad=4,
                        flip=x.shape[-1] == 3, fill=fill)
        return x

    def _labels(self, labels) -> torch.Tensor:
        return torch.as_tensor(np.asarray(labels)).to(self.device,
                                                      torch.long)

    def _loss_and_logits(self, params, x: torch.Tensor, labels: torch.Tensor):
        """Forward: ``(loss, logits, mean NFE, stats)``; a ResNet has no
        solve, so NFE 0 and no stats."""
        cfg = self.model_cfg
        if self.cfg.model == "resnet":
            logits, stats = resnet_logits(params, x, cfg), None
            nfe = torch.zeros((), device=x.device)
        else:
            if self.cfg.adjoint:
                logits, stats = odenet_logits(params, x, cfg, adjoint=True)
            else:
                logits, stats = _direct_diff_logits(params, x, cfg)
            nfe = stats.nfe.float().mean()
        loss = F.cross_entropy(logits, labels)
        return loss, logits, nfe, stats

    def _grads(self, params, x: torch.Tensor, labels: torch.Tensor):
        """Loss, logits, NFE, gradients (a tree like ``params``) and the
        backward NFE (0 for a ResNet and for direct backprop, which replays
        the forward's graph instead of solving again)."""
        with _deterministic_cudnn():
            loss, logits, nfe, stats = self._loss_and_logits(params, x,
                                                             labels)
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
        """One step on a raw uint8 NHWC batch; returns ``loss``, ``acc``,
        ``nfe`` and ``nfe_b`` as floats.  ``generator``: the augmentation
        draws (default: the trainer's own, seeded from ``cfg.seed + 1``)."""
        x = self._preprocess(images_u8, train=True, generator=generator)
        y = self._labels(labels)
        loss, logits, nfe, grads, nfe_b = self._grads(self.params, x, y)
        for p, g in zip(self._leaves, pytree.tree_leaves(grads)):
            p.grad = g
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step_count)
        self.optimizer.step()
        self.step_count += 1
        acc = (logits.argmax(-1) == y).float().mean()
        return {"loss": float(loss), "acc": float(acc), "nfe": float(nfe),
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
    def eval_batch(self, images_u8, labels, valid) -> dict:
        """Sums over the valid samples of a padded batch: ``correct``,
        ``loss_sum``, ``count``, ``nfe_sum``."""
        x = self._preprocess(images_u8, train=False)
        y = self._labels(labels)
        v = torch.as_tensor(np.asarray(valid)).to(self.device, torch.float32)
        if self.cfg.model == "resnet":
            logits = resnet_logits(self.params, x, self.model_cfg)
            nfe = torch.zeros_like(v)
        else:
            logits, stats = odenet_logits(self.params, x, self.model_cfg,
                                          adjoint=False)
            nfe = stats.nfe.float()
            if nfe.shape[0] != v.shape[0]:  # global control: one (1,) count
                nfe = nfe.expand(v.shape[0])
        correct = (logits.argmax(-1) == y).float() * v
        ce = F.cross_entropy(logits, y, reduction="none")
        return {"correct": float(correct.sum()), "loss_sum": float((ce * v)
                                                                   .sum()),
                "count": float(v.sum()), "nfe_sum": float((nfe * v).sum())}

    def evaluate(self, batches) -> dict[str, float]:
        """Per-valid-sample means over ``batches.padded_batches()``."""
        total = {"correct": 0.0, "loss_sum": 0.0, "count": 0.0,
                 "nfe_sum": 0.0}
        for img, lab, valid in batches.padded_batches():
            for k, v in self.eval_batch(img, lab, valid).items():
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
        averages, kept in float64)."""
        state = {f"params.{k}": v
                 for k, v in to_torch_state_dict(self.params).items()}
        for key, val in (extra or {}).items():
            state[f"extra.{key}"] = torch.tensor(val, dtype=torch.float64)
        for i, p in enumerate(self._leaves):
            for key, val in self.optimizer.state.get(p, {}).items():
                if isinstance(val, torch.Tensor):
                    state[f"opt.{i}.{key}"] = val.detach().cpu()
        state["step_count"] = torch.tensor(self.step_count)
        torch.save(state, path)

    def load_state(self, path) -> dict[str, float]:
        """Restore what :meth:`save_state` wrote, in place: the parameter
        leaves keep their identity, so the optimizer goes on owning them.
        Returns the ``extra`` floats."""
        state = torch.load(path, map_location="cpu", weights_only=True)
        loaded = from_torch_state_dict(
            self.params, {k[len("params."):]: v for k, v in state.items()
                          if k.startswith("params.")})
        with torch.no_grad():
            for p, q in zip(self._leaves, pytree.tree_leaves(loaded)):
                p.copy_(q)
        for i, p in enumerate(self._leaves):
            prefix = f"opt.{i}."
            self.optimizer.state[p] = {
                k[len(prefix):]: v.to(p.device if v.ndim else v.device)
                for k, v in state.items() if k.startswith(prefix)}
        self.step_count = int(state["step_count"])
        return {k[len("extra."):]: float(v) for k, v in state.items()
                if k.startswith("extra.")}

    def save_state_orbax(self, path) -> None:
        _not_ported("the orbax training state", "Queue 1 item 5")

    def load_state_orbax(self, path) -> None:
        _not_ported("the orbax training state", "Queue 1 item 5")
