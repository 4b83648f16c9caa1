"""Port parity, the other tools: ``ops.concat_time_channel``, the straggler
bench (``tools/straggler_bench.py``) and the reference protocol
(``tools/reference_protocol.py``: its fabricated files and its verdict),
each against the JAX side on the CPU.

The straggler pool's per-sample NFE.  At the size of
``tests/test_straggler.py`` the JAX tool and the port agree on the NFE
spread and on the three lane-work sums that take each batch's largest NFE,
and in float64 on every row's NFE.  In float32 three of the 512 rows take
one attempt more or less (6 evaluations; sample 306, λ ≈ 16.8: JAX 146, the
port 140; samples 203 and 466, λ ≈ 2.8: JAX 62, the port 68), so
``lane_work_useful`` differs by 6.  On these easy rows the early steps'
error estimates lie below the f32 rounding of |y| ≈ 1, so rounding steers
the step sizes, and whether the tenth step ends before or after t = 1
decides an eleventh (sample 466: t = 1.0027 in JAX, 0.9995 in the port).
JAX's own count of such a row changes with how XLA compiles the solve:
sample 306 takes 146 evaluations in the tool's batch scan and 140 alone
(the port's, in a batch or alone), sample 203 takes 62 jitted and 68 eager
(the port's).  The test shows each row that differs and holds it to that
cause: in float32 either package's count for it differs from its own
float64 count, where rounding decides nothing and the two packages agree.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.ops import concat_time_channel as jax_concat
from neural_ode_features_tpu.solver import odeint as jax_odeint
from neural_ode_features_tpu_torch import reference_protocol, straggler_bench
from neural_ode_features_tpu_torch.ops import concat_time_channel
from tools import reference_protocol as jax_protocol

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import straggler_bench as jax_straggler  # noqa: E402

torch.set_num_threads(2)

# tests/test_straggler.py's size.
BENCH = dict(pool=512, batch_size=64, dim=8, lambda_max=200.0, tol=1e-6,
             reps=1)
DEVICE_KEYS = {"device_time_shuffled_ms", "device_time_nfe_sorted_ms",
               "device_time_global_shuffled_ms", "device_probe_ms"}
# The worst error in tolerance units: one f32 ulp of |y| ≈ 1 (6e-8 to
# 1.2e-7) over atol + rtol·|y| ≈ 2e-6 is about 0.06 units; the bar is
# four ulps.
ERR_UNITS_ATOL = 0.25


@pytest.mark.parametrize("t", [0.375, np.array([0.25, -1.5, 3.0],
                                                np.float32)],
                         ids=["scalar", "per_sample"])
def test_concat_time_channel_matches_jax(t):
    x = np.random.default_rng(0).normal(size=(3, 4, 5, 6)).astype(np.float32)
    want = np.asarray(jax_concat(jnp.asarray(t, jnp.float32),
                                 jnp.asarray(x)))
    got = concat_time_channel(torch.as_tensor(t), torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 4, 5, 7)
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_pool_nfe(lam, y0, order, dtype):
    """Per-sample NFE of the JAX tool's per-sample solve of the pool, its
    scan over batches as written there, in ``dtype``."""
    lam_d, y0_d = jnp.asarray(lam, dtype), jnp.asarray(y0, dtype)
    ts = (jnp.asarray([0.0, 1.0]) if dtype == jnp.float32
          else jnp.asarray([0.0, 1.0], dtype))
    tol = BENCH["tol"]

    def pool(idx):
        def body(acc, sel):
            lam_b = lam_d[sel][:, None]
            _, stats = jax_odeint(lambda t, y: -lam_b * y, y0_d[sel], ts,
                                  rtol=tol, atol=tol,
                                  error_control="per_sample", max_steps=4096)
            return acc, jnp.broadcast_to(stats.nfe, (sel.shape[0],))
        return jax.lax.scan(body, 0.0, idx)[1].reshape(-1)

    idx = jnp.asarray(order.reshape(-1, BENCH["batch_size"]).astype(np.int32))
    return np.asarray(jax.jit(pool)(idx))


@pytest.fixture(scope="module")
def bench():
    """The JAX tool's ``run_bench`` and the port's, at the same arguments;
    then each row's NFE in the shuffled per-sample mode from both packages
    in float32 and float64."""
    want = jax_straggler.run_bench(**BENCH)
    got = straggler_bench.run_bench(**BENCH, device="cpu")
    lam, y0, rng = straggler_bench.make_pool(BENCH["pool"],
                                             BENCH["batch_size"],
                                             BENCH["dim"],
                                             BENCH["lambda_max"])
    order = rng.permutation(len(lam))
    nfe = {}
    for name, jdt, tdt in (("f32", jnp.float32, torch.float32),
                           ("f64", jnp.float64, torch.float64)):
        port, _, _ = straggler_bench.solve_pool(
            torch.from_numpy(lam).to(tdt), torch.from_numpy(y0).to(tdt),
            order, BENCH["batch_size"], tol=BENCH["tol"],
            error_control="per_sample", controller="i")
        nfe[name] = (_jax_pool_nfe(lam, y0, order, jdt), port)
    return want, got, nfe, lam, order


def test_straggler_bench_keys_and_lane_work_match_jax(bench):
    want, got, _, _, _ = bench
    assert set(got) == set(want) | DEVICE_KEYS | {"backend"}
    assert got["backend"] == "cpu"
    assert all(got[k] is None for k in DEVICE_KEYS)
    for k in ("metric", "pool", "batch_size", "dim", "tol", "controller",
              "nfe_spread", "lane_work_shuffled", "lane_work_sorted",
              "lane_work_global"):
        assert got[k] == want[k], (k, got[k], want[k])
    for k in ("err_units_shuffled", "err_units_sorted", "err_units_global"):
        assert abs(got[k] - want[k]) <= ERR_UNITS_ATOL, (k, got, want)
    # tests/test_straggler.py's bars, on the port.
    lo, hi = got["nfe_spread"]
    assert hi > 2 * lo
    assert got["lane_work_sorted"] < got["lane_work_shuffled"]
    assert (got["lane_work_sorted"] / got["lane_work_useful"]
            < 0.7 * got["lane_work_shuffled"] / got["lane_work_useful"])
    assert got["err_units_global"] > 2 * got["err_units_sorted"]
    assert got["time_global_shuffled_s"] > 0


def test_straggler_per_sample_nfe_matches_jax(bench):
    """Every row's NFE equal in float64; in float32 equal but on the rows
    that rounding decides (module docstring), each shown with its cause,
    and ``lane_work_useful`` made of these rows' counts."""
    want, got, nfe, lam, order = bench
    jax64, port64 = nfe["f64"]
    np.testing.assert_array_equal(port64, jax64)
    jax32, port32 = nfe["f32"]
    # The replica is the tool's solve: its counts sum to the tool's, and
    # the port's solve_pool to the port's bench.
    assert int(jax32.sum()) == want["lane_work_useful"]
    assert int(port32.sum()) == got["lane_work_useful"]
    rows = np.nonzero(port32 != jax32)[0]
    for r in rows:
        print(f"row {r}: sample {order[r]}, lambda {lam[order[r]]:.4f}: "
              f"NFE in f32 JAX {jax32[r]}, port {port32[r]}; in f64 JAX "
              f"{jax64[r]}, port {port64[r]}")
        assert jax32[r] != jax64[r] or port32[r] != port64[r], r
        assert abs(int(port32[r]) - int(jax32[r])) == 6  # one attempt
    assert len(rows) <= 0.01 * len(order)


def test_straggler_bench_cli(capsys):
    got = straggler_bench.main(["--pool", "8", "--batch-size", "4", "--dim",
                                "2", "--reps", "1", "--controller", "pi",
                                "--cpu"])
    assert json.loads(capsys.readouterr().out) == got
    assert got["pool"] == 8 and got["controller"] == "pi"
    assert (vars(straggler_bench.parse_args([]))
            == vars(jax_straggler.parse_args([])))


@pytest.mark.parametrize("dataset", ["mnist", "cifar10"])
def test_fabricate_is_byte_identical_to_jax(tmp_path, dataset):
    jax_protocol.fabricate(dataset, tmp_path / "jax", 20)
    reference_protocol.fabricate(dataset, tmp_path / "port", 20)
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert len(files) == (4 if dataset == "mnist" else 6)
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*")
                           if p.is_file())
    for f in files:
        assert ((tmp_path / "port" / f).read_bytes()
                == (tmp_path / "jax" / f).read_bytes()), f


def _fake_sub(parity: dict | None, run_dir: str, calls: list):
    """A stand-in for the protocol's ``_sub``: records each command and
    prints what each tool prints last (``parity=None``: parity fails)."""
    def sub(cmd, timeout):
        calls.append(cmd)
        prog = cmd[2] if cmd[1] == "-m" else cmd[1]
        if prog.endswith(("train", "train.py")):
            out = f"train 64 / test 64 images\nrun dir: {run_dir}\n"
        elif "eval_ckpt" in prog:
            out = json.dumps({"top1": 0.5, "mean_nfe": 26.0}) + "\n"
        elif parity is None:
            raise RuntimeError("step failed rc=1: CUDA is not available")
        else:
            out = json.dumps(parity) + "\n"
        return type("Proc", (), {"stdout": out})()
    return sub


@pytest.mark.parametrize("parity_ok", [True, False],
                         ids=["parity", "parity_fails"])
def test_verdict_has_the_jax_keys(tmp_path, monkeypatch, parity_ok):
    """Both packages' ``run_protocol`` on fabricated files with the steps
    stubbed: the same verdict keys (also those of the JAX tool's committed
    ``runs_protocol/mnist_verdict.json``), the same command lines but the
    program, a parity failure recorded and not gating.  Nothing is written
    under the repository."""
    data = tmp_path / "data"
    reference_protocol.fabricate("mnist", data, 16)
    jax_calls, calls = [], []
    (tmp_path / "jax_root").mkdir()
    monkeypatch.setattr(sys, "path", list(sys.path))  # the JAX tool adds ROOT
    monkeypatch.setattr(jax_protocol, "ROOT", tmp_path / "jax_root")
    monkeypatch.setattr(jax_protocol, "_sub", _fake_sub(
        {"top1_jax": 0.5, "top1_torch": 0.5} if parity_ok else None,
        "r", jax_calls))
    monkeypatch.setattr(reference_protocol, "_sub", _fake_sub(
        {"top1_kernels": 0.5, "top1_plain": 0.5} if parity_ok else None,
        "r", calls))
    before = sorted(p.name for p in ROOT.iterdir())
    want = jax_protocol.run_protocol("mnist", data, epochs=3, limit=16,
                                     cpu=True, fabricated=True)
    got = reference_protocol.run_protocol(
        "mnist", data, epochs=3, limit=16, cpu=True, fabricated=True,
        runs_root=tmp_path / "runs")
    assert sorted(p.name for p in ROOT.iterdir()) == before
    committed = json.loads((ROOT / "runs_protocol" /
                            "mnist_verdict.json").read_text())
    assert list(got) == list(want) == list(committed)
    assert json.loads((tmp_path / "runs" / "mnist_verdict.json")
                      .read_text()) == got
    assert got["data"] == "fabricated" and got["meets_target"] is None
    assert got["top1"] == 0.5 and got["run_dir"] == "r"
    assert got["parity_within_0.2pct"] is (True if parity_ok else None)
    assert ("error" in got["parity"]) is not parity_ok
    assert {k: got[k] for k in ("target", "epochs")} == {
        k: want[k] for k in ("target", "epochs")}
    # The same steps: the port's module in place of the JAX script, and
    # its runs root in place of runs_protocol/.
    assert [c[:3] for c in calls] == [
        [sys.executable, "-m", f"neural_ode_features_tpu_torch.{tool}"]
        for tool in ("train", "eval_ckpt", "parity_eval")]
    def steps(cmds, program_args):
        out = []
        for c in cmds:
            args = c[program_args:]
            if "--runs-dir" in args:
                i = args.index("--runs-dir")
                args = args[:i] + args[i + 2:]
            out.append(args)
        return out
    assert steps(calls, 3) == steps(jax_calls, 2)
    assert len(calls) == 3
