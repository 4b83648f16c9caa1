"""Hand-written CUDA kernels for Hopper (sources in ``../csrc``), each with
its plain PyTorch version and a launch counter beside its wrapper.  Nothing
here builds or imports a kernel at import time; importing the package
registers the operators of ``ops.py`` (``torch.ops.nodef``), which the
wrappers of ``odefunc.py`` and ``rk_step.py`` call."""

from . import ops  # noqa: F401
