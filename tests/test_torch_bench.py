"""The port's headline bench, ``python -m neural_ode_features_tpu_torch.bench``
(the counterparts of ``tests/test_bench_capture.py``'s three tests, with
``--cpu``, and its other modes): a parseable JSON line with the JAX bench's
keys on every exit path but bad flags; no card and no ``--cpu`` is a
failure, never a CPU fallback."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from neural_ode_features_tpu_torch.models import (
    ModelConfig,
    init_odenet,
    odenet_logits,
)

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures_torch" / "jax_run_mnist"
SMALL = ["--iters", "2", "--repeats", "2", "--tol", "1e-2",
         "--batch-size", "8", "--cpu-batches", "2", "--cpu-batch-size", "8"]
# The JAX bench's record (bench.py:734-761) and what the port adds: the
# card that ran it and the CUDA-event figure.
JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "value_best",
            "value_band", "repeats", "mean_nfe", "batch_size", "backend",
            "compute_dtype", "pallas", "fused_rk", "method", "controller",
            "tflops", "mfu", "cpu_ips", "cpu_ips_median", "cpu_ips_spread",
            "host_load_1min"}
PORT_KEYS = {"device_kind", "power_limit_w", "value_cuda_events"}
POOL_KEYS = {"pool", "pool_ips_unsorted", "pool_ips_sorted",
             "pool_ips_sorted_with_probe", "probe_s", "probe_nfe_spread"}


def _run_bench(args, env_extra=None, timeout=120, cpu=True):
    env = dict(os.environ, OMP_NUM_THREADS="2", **(env_extra or {}))
    proc = subprocess.run(
        [sys.executable, "-m", "neural_ode_features_tpu_torch.bench",
         *(["--cpu"] if cpu else []), *args],
        cwd=str(ROOT), env=env, capture_output=True, text=True,
        timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.strip().startswith("{")]
    return (json.loads(lines[-1]) if lines else None), proc


def _complete(result, proc):
    assert result is not None and proc.returncode == 0, (
        f"rc={proc.returncode}\n{proc.stdout[-1500:]}\n{proc.stderr[-1500:]}")
    assert not result.get("incomplete") and "error" not in result
    assert result["value_band"][0] <= result["value"] <= result["value_best"]
    assert result["value_best"] == result["value_band"][1]
    assert result["repeats"] == 2
    return result


def test_complete_run_json_contract():
    result = _complete(*_run_bench([*SMALL, "--hidden", "32"],
                                   {"BENCH_DEADLINE_S": "200"}))
    assert JAX_KEYS | PORT_KEYS <= set(result)
    assert not POOL_KEYS & set(result)
    assert result["metric"] == ("images_per_sec_per_chip_cifar10_odenet_"
                                "inference_rtol1e-3_hidden32")
    assert result["unit"] == "img/s/chip" and result["value"] > 0
    assert result["backend"] == "cpu" and result["device_kind"] == "cpu"
    assert result["mfu"] is None and result["power_limit_w"] is None
    assert result["value_cuda_events"] is None
    assert result["pallas"] is False and result["fused_rk"] is True
    assert result["compute_dtype"] == "float32"
    assert result["cpu_ips"] and result["cpu_ips_spread"]
    assert len(result["host_load_1min"]) == 2
    assert (result["vs_baseline"] is not None) != ("baseline_note" in result)
    # The bench's NFE is the model's: one solve of the same weights (seed
    # 7) and input (numpy seed 0) in this process.
    cfg = ModelConfig(in_channels=3, hidden=32, tol=1e-2)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(8, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        _, stats = odenet_logits(init_odenet(7, cfg, device="cpu"), x, cfg)
    assert result["mean_nfe"] == round(float(stats.nfe.float().mean()), 1)


def test_deadline_emits_partial_json():
    """A deadline far below the runtime still yields a parseable line,
    flagged incomplete with its stage, and a nonzero exit."""
    result, proc = _run_bench(
        ["--iters", "64", "--repeats", "30", "--tol", "1e-5",
         "--batch-size", "16", "--hidden", "32", "--cpu-batches", "2"],
        {"BENCH_DEADLINE_S": "22"}, timeout=90)
    assert proc.returncode == 3, proc.stderr[-1500:]
    assert result["incomplete"] is True and "stage" in result
    assert "error" not in result


def test_inner_direct_invocation_still_works():
    """BENCH_NO_SUPERVISOR=1 runs the measurement in-process (no child)."""
    result, proc = _run_bench([*SMALL, "--hidden", "32", "--skip-baseline"],
                              {"BENCH_NO_SUPERVISOR": "1"})
    _complete(result, proc)
    assert "attempt 1" not in proc.stderr  # no supervisor, no child
    assert result["value"] > 0
    assert result["vs_baseline"] is None and result["cpu_ips"] is None


def test_pool_nfe_sort_keys():
    result = _complete(*_run_bench([*SMALL, "--hidden", "32", "--pool",
                                    "12", "--nfe-sort"]))
    assert POOL_KEYS <= set(result)
    assert result["pool"] == 16  # rounded up to whole batches
    assert result["metric"].endswith("_hidden32_pool16_nfesort")
    assert result["pool_ips_sorted_with_probe"] < result["pool_ips_sorted"]
    lo, hi = result["probe_nfe_spread"]
    assert 0 < lo <= hi


def test_jax_run_directory_gives_the_mnist_metric():
    result = _complete(*_run_bench([*SMALL, "--run", str(FIXTURE)]))
    assert result["metric"] == ("images_per_sec_per_chip_mnist_odenet_"
                                "inference_rtol1e-3")
    assert result["fused_rk"] is True and result["mean_nfe"] > 0


def test_bad_hidden_exits_2_without_json():
    result, proc = _run_bench([*SMALL, "--hidden", "48"], timeout=60)
    assert proc.returncode == 2 and result is None
    assert "positive multiple of 32" in proc.stderr


def test_without_cpu_and_without_a_card_fails():
    """No card and no --cpu: a nonzero exit and a record with an error and
    no value (no CPU fallback, no retry)."""
    result, proc = _run_bench([*SMALL, "--hidden", "32"],
                              {"CUDA_VISIBLE_DEVICES": ""}, timeout=60,
                              cpu=False)
    assert proc.returncode == 1
    assert result["incomplete"] is True and result.get("value") is None
    assert "CUDA is not available" in result["error"]
    assert "baseline-start" not in proc.stderr  # failed before measuring
    assert "attempt 2" not in proc.stderr
