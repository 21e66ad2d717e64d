"""cat_tpu_torch: the PyTorch and CUDA port of cat_tpu for NVIDIA Hopper.

The JAX package `cat_tpu` stays the reference; this package imports
nothing of it and nothing of JAX. Its fused operators run hand-written
CUDA kernels (`csrc/`, built at the first CUDA call by `_build`) on CUDA
tensors and plain PyTorch versions on CPU tensors. Entry points run on
the card unless the caller asks for the CPU.
"""
