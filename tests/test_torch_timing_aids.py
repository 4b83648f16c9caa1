"""The timing aids of ``probes/timing_aids.py`` on the CPU: every variant's
text substitutions still apply to the sources they edit
(``csrc/odefunc_common.cuh``; for the backward's per-sample pass,
``csrc/odefunc_bwd.cu``, and for its weight-gradient kernel; for the
probe's ``im2col_bf16`` and
``tap9_bf16``, ``csrc/conv_probe.cu``; for the rows builds' per-sample
GroupNorm launches, ``csrc/rows_conv.cuh`` and ``csrc/odefunc_bwd.cu``;
each pattern exactly once), so the script cannot
rot silently when a source changes.  The variants are built and timed only
on the card."""

import pytest

from neural_ode_features_tpu_torch.kernels import _build
from neural_ode_features_tpu_torch.probes import timing_aids


def _edited(edits):
    return {e[0] if len(e) == 3 else timing_aids.HEADER for e in edits}


@pytest.mark.parametrize("name,edits", [
    *((f"conv-{k}", v) for k, v in timing_aids.VARIANTS.items()),
    *((f"rk_step-{k}", v) for k, v in timing_aids.RK_VARIANTS.items()),
    *((f"bwd-{p}-{k}", v) for p, vs in timing_aids.BWD_VARIANTS.items()
      for k, v in vs.items()),
    *((f"im2col-{k}", v) for k, v in timing_aids.I2W_VARIANTS.items()),
    *((f"tap9-{k}", v) for k, v in timing_aids.TAP9_VARIANTS.items()),
    *((f"weight-{k}", v) for k, v in timing_aids.WEIGHT_VARIANTS.items()),
    *((f"rows_gn-{k}", v) for k, v in timing_aids.ROWS_GN_VARIANTS.items())])
def test_variant_applies_to_the_header(tmp_path, name, edits):
    dest = timing_aids.patched_sources(edits, tmp_path / "csrc")
    edited = _edited(edits)
    if name.startswith("bwd-"):  # the one-CTA pass has the cluster's but one
        assert set(timing_aids.BWD_VARIANTS["cta"]) == set(
            timing_aids.BWD_VARIANTS["cluster"]) - {"no_remote"}
    # Every file a variant names is changed; every other one is a copy.
    for src in _build.CSRC.iterdir():
        same = (dest / src.name).read_text() == src.read_text()
        assert same == (src.name not in edited), src.name


def test_a_stale_pattern_is_refused(tmp_path):
    with pytest.raises(ValueError, match="exactly one occurrence"):
        timing_aids.patched_sources([("no such line\n", "")], tmp_path / "c")
    with pytest.raises(ValueError, match="odefunc_bwd.cu"):
        timing_aids.patched_sources(
            [("odefunc_bwd.cu", "no such line\n", "")], tmp_path / "d")
