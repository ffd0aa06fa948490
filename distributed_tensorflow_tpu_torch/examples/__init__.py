"""Runnable examples of the port (``python -m
distributed_tensorflow_tpu_torch.examples.<name>``), each the counterpart
of the JAX package's file of the same name under ``examples/``."""
