"""Port parity, the accuracy-parity tool: ``parity_eval`` (the counterpart
of the JAX ``tools/parity_eval.py``) on the committed JAX run directory with
``--device cpu`` (both of its sides the plain path) agrees with itself and
exits 0; the port's plain logits on 256 of the fixture's test images agree
in top-1 with the JAX package's logits for the same weights.  On the CPU;
JAX is imported here only."""

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.models import odenet_logits as jax_logits
from neural_ode_features_tpu.ops.preprocess import normalize as jax_normalize
from neural_ode_features_tpu.utils import load_checkpoint as jax_load
from neural_ode_features_tpu_torch import parity_eval
from neural_ode_features_tpu_torch.data import load_dataset
from neural_ode_features_tpu_torch.utils import load_checkpoint

torch.set_num_threads(2)

RUN = Path(__file__).resolve().parent / "fixtures_torch" / "jax_run_mnist"
N = 256


def test_tool_on_the_fixture_run_directory(capsys):
    rc = parity_eval.main(["--run", str(RUN), "--device", "cpu", "--limit",
                           str(N), "--batch-size", "128"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert out["n"] == N and out["dataset"] == "synthetic-mnist"
    assert out["pred_agreement"] == 1.0 and out["within_0.2pct"]
    assert out["top1_kernels"] == out["top1_plain"]
    assert out["max_abs_logit_diff"] == 0.0


def test_cpu_flag_is_device_cpu(capsys):
    assert parity_eval.main(["--run", str(RUN), "--cpu", "--limit", "64",
                             "--batch-size", "64"]) == 0
    assert json.loads(capsys.readouterr().out)["device"] == "cpu"


def test_plain_logits_agree_with_jax_in_top1():
    params_j, cfg_j, _ = jax_load(str(RUN / "ckpt_best.msgpack"))
    cfg_j = dataclasses.replace(cfg_j, adjoint=False,
                                error_control="per_sample")
    params, cfg, _ = load_checkpoint(RUN / "ckpt_best.msgpack", device="cpu")
    cfg = dataclasses.replace(cfg, adjoint=False, error_control="per_sample")
    images, _ = load_dataset("synthetic-mnist", "test", limit=N)
    got = parity_eval.logits_over(params, images, "synthetic-mnist", cfg,
                                  128, torch.device("cpu"))
    want = np.concatenate([
        np.asarray(jax_logits(params_j, jax_normalize(
            jnp.asarray(images[lo:lo + 128]), "synthetic-mnist"), cfg_j)[0])
        for lo in range(0, N, 128)])
    assert got.shape == want.shape == (N, 10)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_run_is_required():
    with pytest.raises(SystemExit):
        parity_eval.parse_args([])
