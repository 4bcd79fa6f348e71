"""Examples of the port, run as modules (`python -m gbp_tpu_torch.examples.<name>`)."""
