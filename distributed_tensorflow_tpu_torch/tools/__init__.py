"""Command-line tools of the port (``python -m
distributed_tensorflow_tpu_torch.tools.<name>``)."""
