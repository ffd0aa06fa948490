"""Ops of the port: plain PyTorch versions beside the hand-written CUDA
kernels that replace the JAX package's Pallas kernels (attention, decode
over the slab and the paged pool, the speculation verify, the fused MLP
step and epoch), the paged-cache primitives, and the losses and the
optimizer."""
