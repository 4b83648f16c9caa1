"""PyTorch/CUDA port of ``neural_ode_features_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here mirrors
the module of the same name there, with the same public NHWC/HWIO layouts so
that tests compare like with like.  This package imports ``torch`` and never
``jax`` nor anything of the JAX package.

Entry points (``entry.entry``, ``entry.train_entry``, ``entry.extract_entry``,
``models.init_odenet``, ``utils.checkpoint.load_checkpoint``,
``extract.extract_features``, ``evaluation.evaluate_features`` …) default to
``device="cuda"`` and raise when CUDA is absent; pass ``device="cpu"`` (the
CLIs: ``--cpu``) to run the plain PyTorch versions of the kernels on the CPU.
Command lines: ``python -m neural_ode_features_tpu_torch.train``,
``.extract``, ``.evaluate``, ``.sweep``, ``.probes.conv_probe``, and for
deployment ``.export_model`` and ``.serve`` (the serving host; clients:
``serving.SocketClient`` and ``.serve_client``).  On a CUDA tensor the hand-written kernels in
``kernels/`` (sources in ``csrc/``) always run.
"""

__version__ = "0.1.0"
