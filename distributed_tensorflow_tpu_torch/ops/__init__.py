"""Attention and decode ops of the port: plain PyTorch versions beside the
hand-written CUDA kernels that replace the JAX package's Pallas kernels."""
