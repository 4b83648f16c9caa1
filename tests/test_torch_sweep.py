"""Port parity, the tolerance sweep: a checkpoint trained by the JAX
``Trainer`` (a few steps, hidden 32, ``synthetic-mnist``), converted with
the JAX package's ``to_torch_state_dict``, through the root ``sweep.main``
and through ``neural_ode_features_tpu_torch.sweep.main``: ``top1`` and the
three NFE columns equal per tolerance, ``--fused`` (the grid stacked on the
batch axis) equal to the per-tolerance loop, the speed-only mode, and a
``(B,)`` tolerance through the plain fused step equal to scalar calls bit
for bit.  On the CPU."""

import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.training import TrainConfig as JaxTrainConfig
from neural_ode_features_tpu.training import Trainer as JaxTrainer
from neural_ode_features_tpu.utils import save_checkpoint as jax_save
from neural_ode_features_tpu.utils import to_torch_state_dict as jax_to_torch
from neural_ode_features_tpu_torch import sweep
from neural_ode_features_tpu_torch.data import load_dataset
from neural_ode_features_tpu_torch.kernels.odefunc import prepare
from neural_ode_features_tpu_torch.kernels.rk_step import (
    dopri5_step_plain,
    make_fused_dopri5_step,
)
from neural_ode_features_tpu_torch.models import (
    ModelConfig,
    init_odenet,
    odenet_logits,
    stem_apply,
)
from neural_ode_features_tpu_torch.solver import DOPRI5

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import sweep as jax_sweep  # noqa: E402  (the root CLI)

torch.set_num_threads(2)

DATASET = "synthetic-mnist"
TOLS = "1e-1,1e-2,1e-3"
EXACT = ("tol", "top1", "nfe_mean", "nfe_min", "nfe_max")


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    """A run directory per package holding the same trained weights: the
    JAX one as ``ckpt_best.msgpack``, the port's as ``ckpt_best.pt``."""
    root = tmp_path_factory.mktemp("sweep")
    cfg = JaxTrainConfig(dataset=DATASET, hidden=32, batch_size=16, tol=1e-2,
                         lr=0.05, num_devices=1)
    images, labels = load_dataset(DATASET, "train", limit=16)
    jt = JaxTrainer(cfg, steps_per_epoch=4)
    for i in range(3):
        jt.train_batch(images, labels.astype(np.int32),
                       jax.random.PRNGKey(i))
    params = jax.device_get(jt.params)
    extra = {"model": "odenet", "train": {"dataset": DATASET}}
    jax_save(root / "jax" / "ckpt_best.msgpack", params, jt.model_cfg, extra)
    (root / "port").mkdir()
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in jax_to_torch(params).items()},
               root / "port" / "ckpt_best.pt")
    shutil.copy(root / "jax" / "ckpt_best.msgpack.json",
                root / "port" / "ckpt_best.pt.json")
    return root / "jax", root / "port"


def _common(run, out):
    return ["--run", str(run), "--cpu", "--limit", "64", "--batch-size", "32",
            "--tols", TOLS, "--output", str(out)]


def test_sweep_matches_jax_per_tolerance(run_dirs, tmp_path):
    jax_dir, port_dir = run_dirs
    rows_j = jax_sweep.main(_common(jax_dir, tmp_path / "j.csv"))
    rows = sweep.main(_common(port_dir, tmp_path / "p.csv"))
    assert [list(r) for r in rows] == [list(r) for r in rows_j]
    for r, j in zip(rows, rows_j):
        assert {k: r[k] for k in EXACT} == {k: j[k] for k in EXACT}
        assert r["ips"] > 0
    nfe = [r["nfe_mean"] for r in rows]
    assert nfe == sorted(nfe) and nfe[0] < nfe[-1]
    assert ((tmp_path / "p.csv").read_text().splitlines()[0]
            == (tmp_path / "j.csv").read_text().splitlines()[0])


def test_fused_sweep_equals_the_loop_and_jax(run_dirs, tmp_path,
                                             monkeypatch):
    jax_dir, port_dir = run_dirs
    loop = sweep.main(_common(port_dir, tmp_path / "l.csv"))
    fused = sweep.main([*_common(port_dir, tmp_path / "f.csv"), "--fused",
                        "--pallas"])
    fused_j = jax_sweep.main([*_common(jax_dir, tmp_path / "fj.csv"),
                              "--fused"])
    assert [list(r) for r in fused] == [list(r) for r in fused_j]
    for f, u, j in zip(fused, loop, fused_j):
        assert {k: f[k] for k in EXACT} == {k: u[k] for k in EXACT}
        assert {k: f[k] for k in EXACT} == {k: j[k] for k in EXACT}
        assert f["sweep_s"] > 0 and "ips" not in f
    with pytest.raises(SystemExit, match="per_sample"):
        sweep.main([*_common(port_dir, tmp_path / "g.csv"), "--fused",
                    "--error-control", "global"])
    # --bf16 runs with --cpu (test_bf16_sweep_matches_jax); aimed at a card
    # it exits before any device use.
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)

        def no_device_use(*args, **kwargs):
            raise AssertionError("the card was used before the exit")
        m.setattr(sweep, "strict_f32", no_device_use)
        m.setattr(sweep, "load_checkpoint", no_device_use)
        with pytest.raises(SystemExit, match="Queue 2 item 5"):
            sweep.main([a for a in _common(port_dir, tmp_path / "b.csv")
                        if a != "--cpu"] + ["--bf16"])
    assert not (tmp_path / "b.csv").exists()


@pytest.mark.parametrize("fused", [False, True])
def test_speed_only_and_one_channel_random_init(tmp_path, fused):
    extra = ["--fused"] if fused else []
    rows = sweep.main(["--cpu", "--tols", "1e-1,1e-2", "--batch-size", "4",
                       "--iters", "2", "--output", str(tmp_path / "s.csv"),
                       *extra])
    assert [r["tol"] for r in rows] == [1e-1, 1e-2]
    assert list(rows[0]) == (["tol", "nfe_mean", "sweep_s"] if fused
                             else ["tol", "ips", "nfe_mean"])
    assert rows[1]["nfe_mean"] >= rows[0]["nfe_mean"] >= 8
    # Random init on a one-channel dataset rebuilds the model at 1 channel.
    rows = sweep.main(["--cpu", "--dataset", DATASET, "--limit", "16",
                       "--batch-size", "8", "--tols", "1e-1", "--output",
                       str(tmp_path / "m.csv"), *extra])
    assert 0.0 <= rows[0]["top1"] <= 1.0


def test_per_row_tolerance_through_the_plain_fused_step():
    """``rtol``/``atol`` as ``(B,)`` tensors: every row of the plain fused
    step equals, bit for bit, the same row of a call at that row's
    tolerance as a float; and a whole solve with the per-row fused step has
    each row's NFE and logits of the solve at its own tolerance."""
    cfg = ModelConfig(in_channels=1, hidden=32)
    params = init_odenet(5, cfg, device="cpu")
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(6, 28, 28, 1)).astype(np.float32))
    h0 = stem_apply(params["stem"], x, cfg)
    b, hw = h0.shape[0], tuple(h0.shape[1:3])
    w = prepare(params["odefunc"], hw)
    y0 = h0.reshape(b, -1)
    f0 = torch.from_numpy(rng.normal(size=y0.shape).astype(np.float32))
    t0 = torch.zeros(b)
    dt = torch.full((b,), 0.3)
    tols = torch.tensor([1e-1, 1e-2, 1e-3, 1e-1, 1e-4, 1e-2])
    kw = dict(hw=hw, groups=cfg.groups)
    rows = dopri5_step_plain(w, DOPRI5, t0, dt, y0, f0, rtol=tols, atol=tols,
                             **kw)
    for tol in sorted(set(tols.tolist())):
        one = dopri5_step_plain(w, DOPRI5, t0, dt, y0, f0, rtol=tol, atol=tol,
                                **kw)
        sel = tols == tol
        for got, want in zip(rows, one):
            assert torch.equal(got[sel], want[sel])
    assert len(set(rows[3].tolist())) >= 4  # the ratio does depend on tol
    with pytest.raises(ValueError, match="atol > 0"):
        make_fused_dopri5_step(params["odefunc"], DOPRI5, hw,
                               groups=cfg.groups, rtol=tols,
                               atol=torch.tensor([1e-3, 0.0]))

    logits, stats = odenet_logits(params, x, cfg, tol=tols)
    for tol in sorted(set(tols.tolist())):
        sel = tols == tol
        logits_1, stats_1 = odenet_logits(params, x, cfg, tol=tol)
        assert torch.equal(stats.nfe[sel], stats_1.nfe[sel])
        assert torch.equal(logits[sel], logits_1[sel])
    assert int(stats.nfe.min()) < int(stats.nfe.max())
    with pytest.raises(ValueError, match="per_sample"):
        odenet_logits(params, x, ModelConfig(in_channels=1, hidden=32,
                                             error_control="global"),
                      tol=tols)


def test_bf16_sweep_matches_jax(run_dirs, tmp_path, monkeypatch):
    """``sweep --bf16 --cpu``: the dynamics in bf16 on both sides.  The
    NFE columns equal per tolerance; top-1 within one image of the 64, as
    a bf16 rounding (2^-8 of a logit) can flip an argmax whose two largest
    logits are that close."""
    jax_dir, port_dir = run_dirs
    dtypes = set()
    logits_fn = sweep.odenet_logits

    def recorded(params, x, cfg, **kw):
        dtypes.add(cfg.compute_dtype)
        return logits_fn(params, x, cfg, **kw)
    monkeypatch.setattr(sweep, "odenet_logits", recorded)
    common = ["--bf16", "--tols", "1e-1,1e-2"]
    rows_j = jax_sweep.main([*_common(jax_dir, tmp_path / "j.csv"), *common])
    rows = sweep.main([*_common(port_dir, tmp_path / "p.csv"), *common])
    assert dtypes == {"bfloat16"}
    assert [list(r) for r in rows] == [list(r) for r in rows_j]
    for r, j in zip(rows, rows_j):
        assert r["tol"] == j["tol"]
        assert {k: r[k] for k in EXACT[2:]} == {k: j[k] for k in EXACT[2:]}
        assert abs(r["top1"] - j["top1"]) <= 1 / 64 + 1e-4, (r, j)
