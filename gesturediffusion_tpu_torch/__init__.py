"""PyTorch / CUDA port of gesturediffusion_tpu for NVIDIA Hopper (H100).

The JAX package beside it is the reference.  This package imports nothing
of it and no JAX.  Entry points run on the CUDA card unless the caller asks
for the CPU; the CUDA kernels under csrc/ are built with nvcc at first use.
"""
