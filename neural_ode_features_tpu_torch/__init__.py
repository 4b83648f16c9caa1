"""PyTorch/CUDA port of ``neural_ode_features_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here mirrors
the module of the same name there, with the same public NHWC/HWIO layouts so
that tests compare like with like.  This package imports ``torch`` and never
``jax`` nor anything of the JAX package.

Entry points (``entry.entry``, ``models.init_odenet``,
``utils.checkpoint.from_jax_params``) default to ``device="cuda"`` and raise
when CUDA is absent; pass ``device="cpu"`` to run the plain PyTorch versions
of the kernels on the CPU.  On a CUDA tensor the hand-written kernels in
``kernels/`` (sources in ``csrc/``) always run.
"""

__version__ = "0.1.0"
