"""Hand-written Hopper kernels (sources in ``csrc/``) and their dispatch.

Each kernel module keeps a plain PyTorch version beside its wrapper: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel or raises.
``ops.fused`` mirrors the JAX package's dispatch functions.
"""
