"""Port parity, the code-free export: ``export_model export`` writes a
``torch.export`` program (the kernels as the operators of ``kernels/ops.py``,
the attempt loop as PyTorch's ``while_loop``) and ``run`` executes it with
no model code, against the live model.  Small: hidden 32, groups 8, B = 4,
MNIST shapes (as ``tests/test_export.py``'s ``tiny_run``), on the CPU, where
the operators run their plain versions.  The exported logits agree with the
JAX package's ``odenet_logits`` on the same weights at rtol = atol = 1e-3
and with the live port bit for bit; ``export-mock`` writes the JAX tool's
files byte for byte; the serving host answers a mock artifact.  JAX is
imported here only."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_features_tpu.models import init_odenet as jax_init
from neural_ode_features_tpu.models import odenet_logits as jax_logits
from neural_ode_features_tpu.models.common import ModelConfig as JaxConfig
from neural_ode_features_tpu.utils import load_checkpoint as jax_load
from neural_ode_features_tpu.utils.checkpoint import (
    save_checkpoint as jax_save,
)
from neural_ode_features_tpu_torch import export_model, serve
from neural_ode_features_tpu_torch.kernels import ops  # noqa: F401
from neural_ode_features_tpu_torch.kernels.odefunc import prepare
from neural_ode_features_tpu_torch.kernels.rk_step import tolerance_rows
from neural_ode_features_tpu_torch.models import (
    ModelConfig,
    init_odenet,
    init_resnet,
    odenet_logits,
    resnet_logits,
)
from neural_ode_features_tpu_torch.solver import odeint
from neural_ode_features_tpu_torch.utils import load_checkpoint, save_checkpoint

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tools import export_model as jax_tool  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
B = 4
CFG = dict(in_channels=1, hidden=32, groups=8, tol=1e-2)


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A JAX run directory (``ckpt_best.msgpack``), as the JAX test's."""
    run = tmp_path_factory.mktemp("run")
    cfg = JaxConfig(**CFG)
    jax_save(run / "ckpt_best.msgpack", jax_init(jax.random.PRNGKey(0), cfg),
             cfg, extra={"model": "odenet"})
    return run


@pytest.fixture(scope="module")
def artifact(tiny_run):
    return export_model.main(["export", "--run", str(tiny_run), "--batch",
                              str(B), "--cpu"])


def _x(shape=(B, 28, 28, 1)):
    return np.random.default_rng(0).normal(size=shape).astype(np.float32)


def _program(art):
    return export_model.load_program(art, torch.device("cpu"))[0]


def test_export_then_run_parity(tiny_run, artifact, capsys):
    assert artifact == tiny_run / f"model_b{B}.nodeexport"
    meta = json.loads(Path(str(artifact) + ".json").read_text())
    assert meta["input_shape"] == [B, 28, 28, 1]
    assert meta["input_dtype"] == "float32"
    assert (meta["model"], meta["platforms"]) == ("odenet", ["cpu"])
    assert meta["bytes"] == artifact.stat().st_size
    assert meta["config"]["hidden"] == 32
    capsys.readouterr()
    res = export_model.main(["run", "--artifact", str(artifact), "--run",
                             str(tiny_run), "--reps", "1", "--cpu"])
    out = capsys.readouterr().out
    assert "artifact runs: out shape (4, 10)" in out
    assert "argmax agreement=1.0000" in out
    assert res["agreement"] == 1.0


def test_exported_logits_match_the_jax_package(tiny_run, artifact):
    params_j, cfg_j, _ = jax_load(str(tiny_run / "ckpt_best.msgpack"))
    x = _x()
    want, _ = jax_logits(params_j, jnp.asarray(x), cfg_j, adjoint=False)
    with torch.no_grad():
        got = _program(artifact)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(got.argmax(-1), np.asarray(want).argmax(-1))


def test_exported_logits_equal_the_live_port(tiny_run, artifact):
    params, cfg, _ = load_checkpoint(tiny_run / "ckpt_best.msgpack",
                                     device="cpu")
    x = torch.from_numpy(_x())
    with torch.no_grad():
        got = _program(artifact)(x)
        want, _ = odenet_logits(params, x, cfg, adjoint=False)
    assert torch.equal(got, want)


def test_resnet_export(tmp_path):
    cfg = ModelConfig(in_channels=1, hidden=8, groups=4, num_blocks=2)
    params = init_resnet(3, cfg, device="cpu")
    save_checkpoint(tmp_path / "ckpt_best.pt", params, cfg,
                    {"model": "resnet"})
    art = export_model.main(["export", "--run", str(tmp_path), "--batch",
                             "3", "--cpu"])
    meta = json.loads(Path(str(art) + ".json").read_text())
    assert (meta["model"], meta["input_shape"]) == ("resnet", [3, 28, 28, 1])
    x = torch.from_numpy(_x((3, 28, 28, 1)))
    with torch.no_grad():
        assert torch.equal(_program(art)(x), resnet_logits(params, x, cfg))
    res = export_model.main(["run", "--artifact", str(art), "--run",
                             str(tmp_path), "--reps", "1", "--cpu"])
    assert res["agreement"] == 1.0 and res["max_diff"] == 0.0


def test_run_is_code_free(artifact):
    """``run`` without ``--run`` loads the program with the operators alone:
    no model, solver or training module is imported (the counterpart of
    ``tests/test_export.py`` ``test_export_is_code_free``)."""
    code = (
        "import sys, json\n"
        "sys.modules['jax'] = None\n"
        "from neural_ode_features_tpu_torch import export_model\n"
        f"res = export_model.main(['run', '--artifact', {str(artifact)!r},"
        " '--reps', '1', '--cpu'])\n"
        "pre = 'neural_ode_features_tpu_torch.'\n"
        "print(json.dumps({'shape': list(res['out_shape']), 'loaded': "
        "sorted(k for k in sys.modules if k.startswith(pre))}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"OMP_NUM_THREADS": "2", "PATH": "/usr/bin:/bin",
                              "HOME": str(artifact.parent)})
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["shape"] == [B, 10]
    loaded = {m.split(".")[1] for m in res["loaded"]}
    assert not loaded & {"models", "solver", "training"}
    assert "neural_ode_features_tpu_torch.kernels.ops" in res["loaded"]


def test_artifact_for_another_device_raises(artifact, tmp_path):
    meta = json.loads(Path(str(artifact) + ".json").read_text())
    other = tmp_path / artifact.name
    other.write_bytes(artifact.read_bytes())
    Path(str(other) + ".json").write_text(
        json.dumps({**meta, "platforms": ["cuda"]}))
    with pytest.raises(RuntimeError, match=r"\['cuda'\].*on cpu"):
        export_model.load_program(other, torch.device("cpu"))


@pytest.mark.parametrize("mode", ["flat", "rowwise"])
@pytest.mark.parametrize("layout", ["reversed", "rowmajor"])
def test_export_mock_is_byte_identical(tmp_path, mode, layout):
    """The port's mock artifact equals the JAX tool's, file by file; through
    the CLI for the flat mode (as the JAX tool's CLI writes it)."""
    kw = dict(in_shape=(4, 3, 5), out_shape=(4, 10), scale=1.5, shift=-0.25,
              layout=layout, mode=mode)
    want = jax_tool.write_mock_artifact(tmp_path / "jax", **kw)
    got = export_model.write_mock_artifact(tmp_path / "port", **kw)
    if mode == "flat":
        export_model.main(["export-mock", "--out", str(tmp_path / "cli"),
                           "--in-shape", "4,3,5", "--out-shape", "4,10",
                           "--scale", "1.5", "--shift", "-0.25", "--layout",
                           layout])
        got_cli = tmp_path / "cli"
    else:
        got_cli = got
    names = sorted(p.name for p in want.iterdir())
    assert names == sorted(p.name for p in got.iterdir()) == [
        "executable.bin", "expected_logits.npy", "meta.json",
        "sample_input.npy"]
    for name in names:
        assert (got / name).read_bytes() == (want / name).read_bytes(), name
        assert (got_cli / name).read_bytes() == (want / name).read_bytes()


def test_serve_answers_a_mock_artifact(tmp_path, capsys):
    """The port's host serves ``format: mock-pjrt-descriptor``: its
    ``--selftest`` holds the mock compute against ``expected_logits.npy``."""
    art = export_model.write_mock_artifact(tmp_path / "m.npexec",
                                           mode="rowwise", layout="reversed")
    assert serve.main([str(art), "--selftest", "--cpu"]) == 0
    assert "SELFTEST OK max_diff=0.000e+00 batch=4" in capsys.readouterr().out
    x = np.load(art / "sample_input.npy")
    fn = serve.mock_fn(json.loads((art / "meta.json").read_text()))
    np.testing.assert_array_equal(
        fn(torch.from_numpy(x)).numpy(),
        jax_tool.mock_expected(x, (4, 10), 2.0, 1.0, "rowwise"))


def _op_inputs():
    cfg = ModelConfig(**CFG)
    w = prepare(init_odenet(1, cfg, device="cpu")["odefunc"], (6, 6))
    rng = np.random.default_rng(4)
    h = torch.from_numpy(rng.normal(size=(B, 6, 6, 32)).astype(np.float32))
    t0 = torch.from_numpy(rng.uniform(0, 0.5, B).astype(np.float32))
    dt = torch.from_numpy(rng.uniform(0.05, 0.2, B).astype(np.float32))
    return w, h, t0, dt


@pytest.mark.parametrize("name", ["odefunc", "dopri5_step"])
def test_opcheck(name):
    """``torch.library.opcheck``: schema, fake implementation, dispatch."""
    w, h, t0, dt = _op_inputs()
    y = h.reshape(B, -1)
    if name == "odefunc":
        args = (t0, h, list(w), 8)
    else:
        tol = tolerance_rows(1e-2, y)
        args = (t0, dt, y, torch.flip(y, (0,)).contiguous(), list(w), tol,
                tol.clone(), 6, 6, 8)
    torch.library.opcheck(getattr(torch.ops.nodef, name).default, args)


class _Solve(torch.nn.Module):
    """A per-sample solve returning its per-sample stats (for export)."""

    def __init__(self, kind):
        super().__init__()
        self.kind = kind
        cfg = ModelConfig(**CFG)
        self.cfg = cfg
        self.params = init_odenet(2, cfg, device="cpu")
        self.register_buffer("k", torch.tensor([0.5, 3.0, 20.0, 80.0]))

    def forward(self, x):
        if self.kind == "odenet":
            _, st = odenet_logits(self.params, x, self.cfg, adjoint=False)
            return st.nfe, st.naccept, st.nreject
        ys, st = odeint(lambda t, y: -self.k[:, None] * y + torch.sin(
            4.0 * t)[:, None], x.reshape(B, -1)[:, :6], torch.tensor(
                [0.0, 0.5, 1.0]), rtol=1e-5, atol=1e-7,
            error_control="per_sample", method="dopri5")
        return st.nfe, st.naccept, st.nreject, ys


@pytest.mark.parametrize("kind", ["odenet", "linear"])
def test_while_loop_route_matches_the_host_loop(kind):
    """Under ``torch.export`` the attempt loop is ``while_loop``: its NFE,
    accepts, rejects (and the linear problem's states) equal the host
    loop's, with every sample's count its own."""
    module = _Solve(kind)
    x = torch.from_numpy(_x())
    with torch.no_grad():
        want = module(x)
        program = torch.export.export(module, (x,), strict=False)
        got = program.module()(x)
    code = program.graph_module.code
    assert "while_loop" in code
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(want[0].min()) < int(want[0].max()) or kind == "odenet"
