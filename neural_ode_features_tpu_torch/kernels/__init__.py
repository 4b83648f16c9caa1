"""Hand-written CUDA kernels for Hopper (sources in ``../csrc``), each with
its plain PyTorch version and a launch counter beside its wrapper.  Nothing
here builds or imports a kernel at import time."""
