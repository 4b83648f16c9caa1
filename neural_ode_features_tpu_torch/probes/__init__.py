"""Measurement probes that run on the card (``python -m
neural_ode_features_tpu_torch.probes.<name>``)."""
