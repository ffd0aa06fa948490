"""Ops of the port: plain PyTorch versions beside the hand-written CUDA
kernels that replace the JAX package's Pallas kernels (flash attention
forward and backward, decode over the slab and the paged pool, the
speculation verify, the fused MLP step and epoch), the paged-cache
primitives, the MoE FFN, the quantized products and KV caches, the ring
collectives and sequence-parallel attention, the losses and the
optimizers."""
