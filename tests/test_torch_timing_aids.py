"""The timing aids of ``probes/timing_aids.py`` on the CPU: every variant's
text substitutions still apply to ``csrc/odefunc_common.cuh`` (each pattern
exactly once), so the script cannot rot silently when the header changes.
The variants are built and timed only on the card."""

import pytest

from neural_ode_features_tpu_torch.kernels import _build
from neural_ode_features_tpu_torch.probes import timing_aids


@pytest.mark.parametrize("name,edits", [
    *((f"conv-{k}", v) for k, v in timing_aids.VARIANTS.items()),
    *((f"rk_step-{k}", v) for k, v in timing_aids.RK_VARIANTS.items())])
def test_variant_applies_to_the_header(tmp_path, name, edits):
    dest = timing_aids.patched_sources(edits, tmp_path / "csrc")
    shipped = (_build.CSRC / timing_aids.HEADER).read_text()
    patched = (dest / timing_aids.HEADER).read_text()
    assert (patched == shipped) == (not edits)
    # Only the shared header is edited; the kernels' sources are copies.
    for src in _build.CSRC.glob("*.cu"):
        assert (dest / src.name).read_text() == src.read_text()


def test_a_stale_pattern_is_refused(tmp_path):
    with pytest.raises(ValueError, match="exactly one occurrence"):
        timing_aids.patched_sources([("no such line\n", "")], tmp_path / "c")
