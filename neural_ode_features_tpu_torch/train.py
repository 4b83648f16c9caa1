"""Train an ODE-Net or ResNet on MNIST / CIFAR-10 or their synthetic twins
(port of the JAX CLI ``train.py``).

    python -m neural_ode_features_tpu_torch.train --dataset synthetic-mnist \\
        --model odenet --tol 1e-3 --epochs 3 --batch-size 128 --runs-dir runs

``--dataset mnist|cifar10`` reads the raw files under ``--data-dir``
(default ``./data`` or ``$NODE_TPU_DATA``; layout: ``data/datasets.py``),
which stays outside the run identity.

Every flag of the JAX CLI is accepted under its name with its default, and
the run identity is the same: the same command line gives the same run
directory name and the same ``params.json`` under both packages.  The run
directory holds ``params.json``, the per-epoch ``log.csv`` (nine fixed
columns), ``ckpt_best.pt`` / ``ckpt_last.pt`` with their ``.json`` sidecars
(read by ``extract``, ``evaluate`` and ``sweep`` of this package) and
``train_state.pt`` for a resume.  A resumed epoch sees the data order and
the augmentation draws of an uninterrupted run and, since the state file
also carries the loss and NFE running averages, logs the same row.

``--seeds S0,S1,...`` trains a population (``multi.PopulationTrainer``):
one run directory per seed, each the one a solo ``--seed S`` run makes (the
same name, ``params.json``, ``log.csv`` rows, checkpoints and training
state; ``seeds`` stays out of the identity), resumed when every member left
a state at the same epoch.

``--num-devices N`` trains on N ranks, one process per card (NCCL), or N
gloo processes on the CPU with ``--cpu`` (``parallel.launch``); the default
is every visible card on ``cuda`` (one: the solo path) and one process with
``--cpu``.  The batch is sharded over the ranks; ``--model-shards M`` adds
FSDP-style sharding of the parameters and optimizer state over M adjacent
ranks (``training.py``), and ``--seeds`` shards the population's members
over the ranks (``multi.py``).  This command makes the run directories,
then starts the ranks; one rank alone writes a run's ``log.csv``,
checkpoints and training state (rank 0, or under ``--seeds`` the member's
owner), in the one-device format, so a run resumes at any number of
devices.  Neither flag is part of the run identity.

Runs on the card unless ``--cpu`` is given; no card is an error, and so are
more ranks than cards.  Flags whose machinery is not ported exit with a
message naming their ROADMAP.md item before any run directory is made.
``--bf16`` trains the bf16 dynamics on the card (the bf16 builds of the
ODEfunc kernel and of its backward) and with ``--cpu`` (their plain
versions).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ._device import strict_f32
from .data import Batches, load_dataset
from .parallel import launch, rank_devices
from .training import TrainConfig, Trainer, epoch_generator
from .utils import (
    Experiment,
    RunningAverageMeter,
    count_parameters,
    save_checkpoint,
)

__all__ = ["parse_args", "main", "run_identity"]

# Execution knobs, not hyperparameters: identical hyperparameters resume the
# same directory whatever these say (the JAX CLI's list).
_NOT_IDENTITY = ("runs_dir", "data_dir", "cpu", "eval_every", "profile",
                 "resume", "tensorboard", "max_steps", "state_format",
                 "seeds", "num_devices", "model_shards")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", default="mnist",
                   choices=["mnist", "cifar10", "synthetic-mnist",
                            "synthetic-cifar10"])
    p.add_argument("--model", default="odenet", choices=["odenet", "resnet"])
    p.add_argument("--tol", type=float, default=1e-3,
                   help="rtol=atol for the adaptive solver")
    p.add_argument("--solver", default="dopri5",
                   help="dopri5, tsit5, bosh3, fehlberg2, adams (adaptive "
                        "order), or a fixed-grid method: euler, midpoint, "
                        "heun2, rk4, fixed_adams")
    p.add_argument("--controller", default="i", choices=["i", "pi"],
                   help="adaptive step-size controller: 'i' (integral) or "
                        "'pi' (proportional-integral: fewer rejected steps); "
                        "applies to the forward and the adjoint solve")
    p.add_argument("--adjoint", action="store_true", default=True,
                   help="adjoint gradients (default; O(1) memory)")
    p.add_argument("--no-adjoint", dest="adjoint", action="store_false",
                   help="direct backprop through the host-loop solve")
    p.add_argument("--adjoint-seminorm", action="store_true",
                   help="seminorm backward error control (Kidger et al. "
                        "2020): fewer backward NFE, same gradient quality")
    p.add_argument("--adjoint-mode", default="reintegrate",
                   choices=["reintegrate", "interpolated"],
                   help="'interpolated': the backward reads y(t) from the "
                        "forward's dense solution (Daulbaev et al. 2020)")
    p.add_argument("--hidden", type=int, default=64,
                   help="ODEfunc channel width (a multiple of the GroupNorm "
                        "group count 32)")
    p.add_argument("--downsampling", default="conv", choices=["conv", "res"],
                   help="stem variant")
    p.add_argument("--error-control", default="per_sample",
                   choices=["per_sample", "global"])
    p.add_argument("--epochs", type=int, default=160)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--optimizer", default="sgd", choices=["sgd", "adam"])
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--lr-decay-epochs", default="60,100,140")
    p.add_argument("--lr-decay-gamma", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seeds", default=None, metavar="S0,S1,...",
                   help="population training: one member (and one run "
                        "directory) per seed, trained in turn on each "
                        "device, the members sharded over --num-devices")
    p.add_argument("--no-augment", dest="augment", action="store_false",
                   default=True)
    p.add_argument("--max-steps", type=int, default=None,
                   help="solver iteration bound (default: 1024 for the "
                        "adjoint path, 64 for --no-adjoint)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 dynamics compute (solver control stays "
                        "f32): on the card through the kernels' bf16 "
                        "builds, with --cpu through their plain versions")
    p.add_argument("--num-devices", type=int, default=None,
                   help="data-parallel ranks, one process per card (with "
                        "--cpu: gloo processes on the CPU); default every "
                        "visible card, one process with --cpu")
    p.add_argument("--model-shards", type=int, default=1,
                   help="parameter-sharding factor: params and optimizer "
                        "state shard FSDP-style over this many adjacent "
                        "ranks; must divide --num-devices")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--runs-dir", default="runs")
    p.add_argument("--limit", type=int, default=None,
                   help="truncate the dataset (smoke tests)")
    p.add_argument("--eval-every", type=int, default=1)
    p.add_argument("--no-fused-epoch", dest="fused_epoch",
                   action="store_false", default=True,
                   help="one train_batch call per batch from the CLI's own "
                        "loop, in place of Trainer.train_epoch")
    p.add_argument("--no-resume", dest="resume", action="store_false",
                   default=True,
                   help="ignore an existing train_state.pt in the run "
                        "directory (default: resume it)")
    p.add_argument("--state-format", choices=("msgpack", "orbax"),
                   default="msgpack",
                   help="accepted for the JAX CLI's sake: the training state "
                        "is train_state.pt (torch.save) whatever 'msgpack' "
                        "says; 'orbax' is not ported (ROADMAP.md, Queue 1 "
                        "item 5)")
    p.add_argument("--tensorboard", action="store_true",
                   help="not ported: clu is not installed where the port "
                        "runs")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="write a torch.profiler trace of N train steps to "
                        "<run_dir>/profile")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain PyTorch path on the CPU")
    return p.parse_args(argv)


def _refuse_unported(args) -> None:
    """Exit, before a run directory exists, on a flag whose machinery the
    port does not have."""
    def stop(flag, item):
        raise SystemExit(f"{flag} is not ported yet (ROADMAP.md, {item})")

    if args.state_format == "orbax":
        stop("--state-format orbax", "Queue 1 item 5")
    if args.tensorboard:
        raise SystemExit("--tensorboard needs clu.metric_writers, which is "
                         "not installed where the port runs; the per-epoch "
                         "scalars are in log.csv")


def _num_ranks(args) -> int:
    """The ranks this command trains on; exits, before a run directory
    exists, when the cards, the shards or the batch do not fit them."""
    n = args.num_devices
    if n is None:
        n = (1 if args.cpu or not torch.cuda.is_available()
             else torch.cuda.device_count())
    if n < 1:
        raise SystemExit(f"--num-devices {n}: need at least one")
    if n > 1 and not args.cpu:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > have:
            raise SystemExit(
                f"--num-devices {n}: {have} CUDA device(s) visible; a rank "
                "runs on a card of its own (--cpu runs gloo ranks on the "
                "CPU)")
    m = args.model_shards
    if m < 1 or n % m:
        raise SystemExit(f"--model-shards {m} does not divide {n} devices")
    if args.seeds is not None and m > 1:
        raise SystemExit(
            "population training composes with data parallelism only; "
            "FSDP (--model-shards > 1) shards params over 'model' while "
            "the population shards them over 'data' — pick one")
    if args.seeds is None and args.batch_size % (n // m):
        raise SystemExit(
            f"--batch-size {args.batch_size} does not divide over the "
            f"{n // m} ranks of the 'data' axis")
    return n


def run_identity(args) -> dict:
    """The hyperparameters that name the run directory and fill
    ``params.json``: every flag but the execution knobs, and the default
    controller dropped so that run names predate that flag."""
    exp_params = {k: v for k, v in vars(args).items()
                  if k not in _NOT_IDENTITY}
    if exp_params.get("controller") == "i":
        del exp_params["controller"]
    return exp_params


class _Record:
    """The run directory's side of training one model: the running
    averages, the ``log.csv`` rows, the checkpoints and the training state.
    A solo run keeps one; ``--seeds`` one per member, so that a member's
    directory is the one its solo run writes.  ``prefix`` starts its
    printed lines."""

    def __init__(self, exp: Experiment, exp_params: dict, model: str,
                 prefix: str = "", writer: bool = True):
        self.exp, self.exp_params, self.model = exp, exp_params, model
        self.prefix = prefix
        self.writer = writer  # the one rank that writes and prints
        self.state_path = exp.file("train_state.pt")
        self.loss_m, self.nfe_m = RunningAverageMeter(), RunningAverageMeter()
        self.nfe_b_m = RunningAverageMeter()
        self.best_acc = 0.0
        self.tr_acc_sum = self.tr_count = 0.0

    def logged_epochs(self) -> int:
        """The epoch a resume starts at: one past the last logged."""
        rows = self.exp.read_log()
        return (int(rows[-1]["epoch"]) + 1) if rows else 0

    def say(self, line: str) -> None:
        if self.writer:
            print(self.prefix + line, flush=True)

    def resume(self, trainer: Trainer) -> int:
        averages = trainer.load_state(self.state_path)
        for meter, key in ((self.loss_m, "loss_avg"), (self.nfe_m, "nfe_avg")):
            if key in averages:  # the running averages go on where they were
                meter.update(averages[key])
        self.best_acc = max(
            (float(r["test_acc"]) for r in self.exp.read_log()
             if r.get("test_acc")), default=0.0)
        start = self.logged_epochs()
        self.say(f"resumed {self.state_path} at epoch {start} "
                 f"(best so far {self.best_acc:.4f})")
        return start

    def begin_epoch(self) -> None:
        self.nfe_b_m.reset()
        self.tr_acc_sum = self.tr_count = 0.0

    def add_step(self, m: dict, n: int) -> None:
        self.loss_m.update(m["loss"])
        self.nfe_m.update(m["nfe"])
        self.nfe_b_m.update(m["nfe_b"])
        self.tr_acc_sum += m["acc"] * n
        self.tr_count += n

    def add_epoch(self, em: dict, batch_size: int) -> None:
        """The per-step arrays of ``Trainer.train_epoch``."""
        for i in range(len(em["loss"])):
            self.loss_m.update(float(em["loss"][i]))
            self.nfe_m.update(float(em["nfe"][i]))
            self.nfe_b_m.update(float(em["nfe_b"][i]))
        self.tr_count = batch_size * len(em["acc"])
        self.tr_acc_sum = float(np.mean(em["acc"])) * self.tr_count

    def end_epoch(self, epoch: int, trainer: Trainer, train_time: float,
                  ev: dict | None) -> None:
        """Log the epoch (with its evaluation ``ev`` where there was one),
        keep the best checkpoint and the training state.  Every rank calls
        it (the trainer's gathers are collective); the writer writes."""
        # Fixed column schema: the eval columns are always present (blank
        # when the epoch is not evaluated), so log.csv's header holds for
        # any --eval-every.
        row = {
            "epoch": epoch,
            "train_loss": round(self.loss_m.avg, 6),
            "train_acc": round(self.tr_acc_sum / max(self.tr_count, 1), 6),
            "nfe_f": round(self.nfe_m.avg, 2),
            "nfe_b": round(self.nfe_b_m.avg, 2),
            "time_s": round(train_time, 2),
            "test_loss": "",
            "test_acc": "",
            "test_nfe": "",
        }
        if ev is not None:
            row.update(test_loss=round(ev["loss"], 6),
                       test_acc=round(ev["acc"], 6),
                       test_nfe=round(ev["nfe"], 2))
            if ev["acc"] >= self.best_acc:
                self.best_acc = ev["acc"]
                params = trainer.full_params()
                if self.writer:
                    save_checkpoint(
                        self.exp.file("ckpt_best.pt"), params,
                        trainer.model_cfg,
                        extra={"epoch": epoch, "test_acc": ev["acc"],
                               "train": self.exp_params,
                               "model": self.model})
        # State first, log second: a stop between the two runs the epoch
        # again on resume instead of resuming stale weights.
        trainer.save_state(self.state_path, extra={"loss_avg": self.loss_m.avg,
                                                   "nfe_avg": self.nfe_m.avg})
        if self.writer:
            self.exp.log(row)
        self.say(" | ".join(f"{k}={v}" for k, v in row.items()))

    def finish(self, trainer: Trainer, epochs: int) -> None:
        params = trainer.full_params()
        if self.writer:
            save_checkpoint(self.exp.file("ckpt_last.pt"), params,
                            trainer.model_cfg,
                            extra={"epoch": epochs - 1,
                                   "test_acc": self.best_acc,
                                   "train": self.exp_params,
                                   "model": self.model})
        self.say(f"best test acc: {self.best_acc:.4f}; run dir: "
                 f"{self.exp.path}")


def _datasets(args):
    x_train, y_train = load_dataset(args.dataset, "train", args.data_dir,
                                    limit=args.limit)
    x_test, y_test = load_dataset(args.dataset, "test", args.data_dir,
                                  limit=args.limit)
    return x_train, y_train, x_test, y_test


def _evaluates(args, epoch: int) -> bool:
    return (epoch + 1) % args.eval_every == 0 or epoch == args.epochs - 1


def _config(args, n: int) -> TrainConfig:
    return TrainConfig(
        dataset=args.dataset,
        model=args.model,
        tol=args.tol,
        solver=args.solver,
        controller=args.controller,
        adjoint=args.adjoint,
        adjoint_seminorm=args.adjoint_seminorm,
        adjoint_mode=args.adjoint_mode,
        error_control=args.error_control,
        downsampling=args.downsampling,
        hidden=args.hidden,
        epochs=args.epochs,
        batch_size=args.batch_size,
        optimizer=args.optimizer,
        lr=args.lr,
        momentum=args.momentum,
        weight_decay=args.weight_decay,
        lr_decay_epochs=tuple(
            int(e) for e in args.lr_decay_epochs.split(",") if e),
        lr_decay_gamma=args.lr_decay_gamma,
        seed=args.seed,
        augment=args.augment,
        num_devices=n,
        model_shards=args.model_shards,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        max_steps=args.max_steps or (1024 if args.adjoint else 64),
    )


def _ranks(fn, n: int, args, *fn_args):
    """``fn(args, *fn_args, device)`` in this process for one rank, else on
    ``n`` ranks (``parallel.launch``; the devices are the cards or, with
    ``--cpu``, the CPU)."""
    kind = "cpu" if args.cpu else "cuda"
    if n == 1:
        return fn(args, *fn_args, strict_f32(kind))
    launch(_on_rank, n, fn, args, *fn_args,
           devices=rank_devices(n, kind), timeout=None)
    return None


def _on_rank(fn, args, *fn_args):
    return fn(args, *fn_args, strict_f32("cpu" if args.cpu else "cuda"))


def main(argv=None):
    args = parse_args(argv)
    if args.hidden <= 0 or args.hidden % 32 != 0:
        raise SystemExit(
            f"--hidden {args.hidden}: must be a positive multiple of 32 "
            "(GroupNorm groups=32 in the reference architecture)")
    _refuse_unported(args)
    n = _num_ranks(args)
    if n == 1:
        strict_f32("cpu" if args.cpu else "cuda")  # no card is an error
    cfg = _config(args, n)
    exp_params = run_identity(args)
    if args.seeds is not None:
        return main_population(args, cfg, exp_params, n)
    exp = Experiment(args.runs_dir, exp_params).create()
    print(f"run dir: {exp.path}")
    _ranks(_train_solo, n, args, cfg, exp_params, str(exp.path))
    return exp.path


def _train_solo(args, cfg: TrainConfig, exp_params: dict, run_dir: str,
                device: torch.device) -> None:
    """The training loop of one model, on every rank of its mesh."""
    writer = not dist.is_initialized() or dist.get_rank() == 0
    exp = Experiment(Path(run_dir).parent, exp_params,
                     name=Path(run_dir).name)
    x_train, y_train, x_test, y_test = _datasets(args)
    train_b = Batches(x_train, y_train, args.batch_size, seed=args.seed)
    test_b = Batches(x_test, y_test, args.batch_size, shuffle=False,
                     drop_remainder=False)
    trainer = Trainer(cfg, steps_per_epoch=len(train_b), device=device)
    n_params = count_parameters(trainer.full_params())
    rec = _Record(exp, exp_params, args.model, writer=writer)
    rec.say(f"train {len(x_train)} / test {len(x_test)} images; "
            f"{len(train_b)} steps/epoch; device: {device}"
            + (f"; mesh {trainer.mesh}" if trainer.mesh is not None else ""))
    rec.say(f"model parameters: {n_params:,}")

    start_epoch = 0
    if args.resume and rec.state_path.exists():
        start_epoch = rec.resume(trainer)

    # Batches keys its shuffle on its own epoch counter, which starts at 0 in
    # a new process: align it with the true epoch, so that a resumed epoch
    # sees the data order an uninterrupted run would have.
    train_b.epoch = start_epoch

    profiler = None
    profile_left = args.profile if writer else 0
    step_idx = 0
    use_fused = args.fused_epoch and not args.profile
    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        rec.begin_epoch()
        if use_fused:
            rec.add_epoch(trainer.train_epoch(x_train, y_train, epoch),
                          args.batch_size)
        else:
            gen = epoch_generator(args.seed, epoch)
            for images, labels in train_b:
                if profile_left and profiler is None and step_idx == 2:
                    profiler = _start_profile(device)  # past the warm-up
                m = trainer.train_batch(images, labels, gen)
                step_idx += 1
                if profiler is not None:
                    profile_left -= 1
                    if profile_left == 0:
                        _stop_profile(profiler, exp, device)
                        profiler = None
                rec.add_step(m, len(labels))
        if device.type == "cuda":
            torch.cuda.synchronize()
        train_time = time.time() - t0
        ev = None
        if _evaluates(args, epoch):
            ev = (trainer.evaluate_fused(x_test, y_test) if use_fused
                  else trainer.evaluate(test_b))
        rec.end_epoch(epoch, trainer, train_time, ev)

    if profiler is not None:  # the run ended before N profiled steps
        _stop_profile(profiler, exp, device)
    rec.finish(trainer, args.epochs)


def main_population(args, cfg: TrainConfig, exp_params: dict, n: int):
    """``--seeds``: one run directory per seed, each exactly what a solo
    ``--seed S`` run writes (``multi.PopulationTrainer``: the members
    trained in turn on each of ``n`` ranks).  Returns the run
    directories."""
    if args.profile:
        raise SystemExit("--profile is per-run; use a solo --seed run")
    if not args.fused_epoch:
        raise SystemExit(
            "--no-fused-epoch is incompatible with --seeds: a member trains "
            "through Trainer.train_epoch, and the per-batch path has other "
            "shuffle and augmentation streams")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    if len(set(seeds)) != len(seeds):
        raise SystemExit(f"duplicate seeds in --seeds {args.seeds}")

    dirs = []
    for s in seeds:
        exp = Experiment(args.runs_dir, {**exp_params, "seed": s}).create()
        dirs.append(str(exp.path))
        print(f"run dir (seed {s}): {exp.path}")

    # Resume only when every member left a state at the same epoch: a mixed
    # population would train its members different step counts.
    resume_at = None
    have = [(Path(d) / "train_state.pt").exists() for d in dirs]
    if args.resume and any(have):
        if not all(have):
            raise SystemExit(
                "partial population state: some run dirs have "
                "train_state.pt and some don't; finish the stragglers with "
                "solo --seed runs or pass --no-resume")
        starts = [_Record(Experiment.from_dir(d), exp_params,
                          args.model).logged_epochs() for d in dirs]
        if len(set(starts)) != 1:
            raise SystemExit(
                f"population members resume at different epochs {starts}; "
                "finish them solo or --no-resume")
        resume_at = starts[0]
    _ranks(_train_population, n, args, cfg, exp_params, seeds, dirs,
           resume_at)
    return [Path(d) for d in dirs]


def _train_population(args, cfg: TrainConfig, exp_params: dict, seeds, dirs,
                      resume_at: int | None, device: torch.device) -> None:
    """The population's loop, on every rank, over the members it owns."""
    from .multi import PopulationTrainer

    writer = not dist.is_initialized() or dist.get_rank() == 0
    x_train, y_train, x_test, y_test = _datasets(args)
    steps_per_epoch = len(Batches(x_train, y_train, args.batch_size))
    if writer:
        print(f"train {len(x_train)} / test {len(x_test)} images; "
              f"{steps_per_epoch} steps/epoch; device: {device}; population: "
              f"{len(seeds)} seeds", flush=True)
    pop = PopulationTrainer(cfg, seeds, steps_per_epoch, device=device)
    # A member's run directory is written by the trainer that writes its
    # state: its owner, or rank 0 where every rank trains every member.
    recs = {i: _Record(Experiment(Path(dirs[i]).parent,
                                  {**exp_params, "seed": seeds[i]},
                                  name=Path(dirs[i]).name),
                       {**exp_params, "seed": seeds[i]}, args.model,
                       prefix=f"seed {seeds[i]} | ", writer=m.is_writer)
            for i, m in pop.members.items()}

    start_epoch = 0
    if resume_at is not None:
        for i, r in recs.items():
            r.resume(pop.members[i])
        start_epoch = resume_at

    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        em = pop.train_epoch(x_train, y_train, epoch)
        if device.type == "cuda":
            torch.cuda.synchronize()
        train_time = time.time() - t0  # the population's epoch, as in JAX
        evs = (pop.evaluate_fused(x_test, y_test) if _evaluates(args, epoch)
               else [None] * len(seeds))
        for i, r in recs.items():
            r.begin_epoch()
            r.add_epoch({k: v[i] for k, v in em.items()}, args.batch_size)
            r.end_epoch(epoch, pop.members[i], train_time, evs[i])
    for i, r in recs.items():
        r.finish(pop.members[i], args.epochs)


def _start_profile(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof, exp: Experiment, device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()
    prof.stop()
    out = exp.file("profile")
    out.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
    print(f"profile written to {out}")


if __name__ == "__main__":
    main()
