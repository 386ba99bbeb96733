"""Runnable studies on the port (``python -m ratilqr_tpu_torch.examples.<name>``)."""
