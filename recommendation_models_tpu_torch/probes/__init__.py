"""Measurement probes of the port, run as modules
(``python -m recommendation_models_tpu_torch.probes.<name>``)."""
