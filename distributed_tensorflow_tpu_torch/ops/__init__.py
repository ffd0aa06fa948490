"""Ops of the port: plain PyTorch versions beside the hand-written CUDA
kernels that replace the JAX package's Pallas kernels (attention, decode,
the fused MLP step and epoch), and the losses and the optimizer."""
