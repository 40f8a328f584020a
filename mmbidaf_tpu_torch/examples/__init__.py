"""Examples of the port that run as modules (``python -m mmbidaf_tpu_torch.examples.quickstart``)."""
