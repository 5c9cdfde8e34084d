"""PyTorch and CUDA port of telluride_decoding_tpu.

The JAX package ``telluride_decoding_tpu`` is the reference; each file
here pairs with the file of the same path there. This package imports
neither JAX nor the JAX package. Its kernels are hand-written CUDA for
Hopper under ``csrc/``; beside each sits a plain PyTorch version, which
runs for tensors on the CPU.
"""
