"""Example: FSDP training on a (data, model) mesh, then a one-device restore
(counterpart of the JAX package's ``examples/fsdp_training.py``).

    python -m neural_ode_features_tpu_torch.examples.fsdp_training [--cpu]

1. start 4 ranks (``parallel.launch``: one per card with NCCL, or gloo
   processes with ``--cpu``) on a 2×2 (data, model) mesh;
2. train an ODE-Net for a few adjoint steps with every parameter and
   optimizer-state leaf sharded over ``model``: the whole weights are
   gathered for each step (the kernels take whole weights) and each rank
   updates its own shard;
3. save the training state (``Trainer.save_state``: whole tensors, written
   by rank 0; the JAX example writes an orbax directory, which the port has
   not: ROADMAP.md, Queue 1 item 5);
4. restore it onto one device and show that the evaluation loss is the
   mesh's and that training goes on from there.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
from pathlib import Path

import numpy as np

from .._device import strict_f32
from ..data import load_dataset
from ..parallel import launch, rank_devices
from ..training import TrainConfig, Trainer

CFG = TrainConfig(dataset="synthetic-mnist", model="odenet", tol=1e-2,
                  adjoint=True, batch_size=16, lr=0.01, augment=False,
                  epochs=1, num_devices=4, model_shards=2)
STEPS = 4


def _batch(x, y, step: int):
    lo = (step * CFG.batch_size) % len(x)
    return x[lo:lo + CFG.batch_size], y[lo:lo + CFG.batch_size]


def _eval_loss(trainer: Trainer, x, y) -> float:
    m = trainer.eval_batch(x[:16], y[:16], np.ones(16, bool))
    return m["loss_sum"] / m["count"]


def _rank(state_path: str, kind: str) -> dict:
    """One rank of the mesh: the steps, the evaluation, the saved state."""
    trainer = Trainer(CFG, steps_per_epoch=STEPS, device=strict_f32(kind))
    x, y = load_dataset("synthetic-mnist", "train", limit=64)
    sharded = sum(tuple(p.shape) != s for p, s in
                  zip(trainer._leaves, trainer._full_shapes))
    steps = [trainer.train_batch(*_batch(x, y, s)) for s in range(STEPS)]
    loss = _eval_loss(trainer, x, y)
    trainer.save_state(state_path)
    return {"mesh": str(trainer.mesh), "sharded": sharded,
            "leaves": len(trainer._leaves), "steps": steps,
            "eval_loss": loss}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cpu", action="store_true",
                   help="gloo ranks on the CPU (default: one card each)")
    args = p.parse_args(argv)
    kind = "cpu" if args.cpu else "cuda"
    devices = rank_devices(CFG.num_devices, kind)
    with tempfile.TemporaryDirectory() as tmp:
        state = str(Path(tmp) / "fsdp_state.pt")
        r0 = launch(_rank, CFG.num_devices, state, kind, devices=devices)[0]
        print(f"mesh: {r0['mesh']}")
        print(f"parameter leaves sharded over 'model': "
              f"{r0['sharded']}/{r0['leaves']}")
        for s, m in enumerate(r0["steps"]):
            print(f"step {s}: loss {m['loss']:.6f} nfe_f {m['nfe']:.1f}")
        print(f"saved the training state (whole tensors, rank 0): {state}")

        # Restore onto one device: the same state, whole.
        single = Trainer(dataclasses.replace(CFG, num_devices=1,
                                             model_shards=1),
                         steps_per_epoch=STEPS, device=strict_f32(kind))
        single.load_state(state)
    x, y = load_dataset("synthetic-mnist", "train", limit=64)
    restored = _eval_loss(single, x, y)
    print(f"eval loss — 2×2 FSDP mesh: {r0['eval_loss']:.6f}, restored on "
          f"one device: {restored:.6f}")
    if abs(r0["eval_loss"] - restored) >= 1e-4:
        raise SystemExit("the restore changed the state")
    cont = single.train_batch(*_batch(x, y, STEPS))
    print(f"step {STEPS} on one device: loss {cont['loss']:.6f}")
    print("OK — same state across topologies")
    return {"mesh": r0, "restored_loss": restored, "continued": cont}


if __name__ == "__main__":
    main()
