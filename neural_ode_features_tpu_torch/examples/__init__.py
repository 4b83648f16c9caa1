"""Runnable examples of the port (``python -m
neural_ode_features_tpu_torch.examples.<name> [--cpu]``)."""
